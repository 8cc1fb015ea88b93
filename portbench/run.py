"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as setup_s from the process's start): the t=0 atoms from the
seed, the cell's engine of mdbench_tpu_torch built once, one warm-up run.
With --trace 0 the window then calls the engine's run back to back until
--seconds have passed and the cell's end-to-end metrics are printed; with
--trace 1 the workload's traced runs go under torch.profiler and its
per-layer metrics are printed (the window runs first only where one of
them reads its run times). Either way the outputs are judged against
the plain reference afterwards, each number compared is printed beside its
limit as the last lines of standard error, and the last line of standard
output is the result's JSON object.

Exits 2, printing no result, without a CUDA device (or fewer than the cell
asks for), and 3 if jax, jaxlib, flax or mdbench_tpu were loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches at fixed paths inside the checkout (the program's own
    # CUDA library lands in mdbench_tpu_torch/_build/, inside it too)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

    from portbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA device(s); torch finds "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        harness.log(f"refused: the run loaded {', '.join(loaded)}")
        return 3
    for line in harness.check_lines(result):
        harness.log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the repository, not portbench/, on the path
    sys.exit(main())
