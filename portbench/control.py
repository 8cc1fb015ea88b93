"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... --control-seeds 7 8 9

For each of --seeds, the program: the cell's engine built from the seed's
t=0 atoms, its warm-up run, then one run of the window's entry, judged as
run.py judges it; and force_rel again with one pair inside the cutoff left
out of the run's last forces (`drop_edge_pair`: the fault of a neighbour
rebuild that loses a pair). For each of --control-seeds, the control: the plain
reference put in the program's place and computed one step of precision
below the configuration's (state and sums in float32, the LJ pair term in
bfloat16: the step a faster force would tempt), judged the same way.
Prints one JSON line per seed: {"side", "seed", <each number compared>,
and for the program "force_rel_drop1" and the number of pairs within the
band at that atom, which the judge excuses}.
It does not run inside the benchmark's runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_outputs(cfg, x0, v0, device):
    """(thermo, Outputs) of the control from the t=0 atoms."""
    import torch

    from portbench.reference import md
    from portbench.reference.judge import Outputs
    from portbench.reference.lattice import box_lengths

    box = torch.tensor(box_lengths(cfg), dtype=torch.float32, device=device)
    x = torch.tensor(x0, dtype=torch.float64, device=device)
    v = torch.tensor(v0, dtype=torch.float64, device=device)
    tr = md.trajectory(x, v, box, cfg, cfg["ntimes"], dtype=torch.float32,
                       pair_dtype=torch.bfloat16)
    lists = md.build_lists(tr.x, box, cfg["cutforce"] + 0.05)
    f = md.lj_forces(tr.x, lists, box, cfg, pair_dtype=torch.bfloat16)
    ids = torch.arange(tr.x.shape[0], device=device)
    thermo = [(tr.temps.double().cpu().numpy(), tr.press.double().cpu().numpy())]
    return thermo, Outputs(tr.x, tr.v, f, ids)


def drop_edge_pair(x, f, box, cfg):
    """(f less one pair's force on one atom, that atom's row): of the pairs
    inside cutforce and outside the band the judge excuses (md.CUT_BAND),
    the one nearest the cutoff, whose force is the least a lost pair takes
    away. x, f: (N, 3) local atoms; float64 pair force at x."""
    import torch

    from portbench.reference import md

    x, box = x.double(), box.double()
    cutsq = cfg["cutforce"] ** 2
    best = (-1.0, 0, None)
    for s, nbr, ok in md.build_lists(x, box, cfg["cutforce"]):
        d = md.min_image(x[s:s + nbr.shape[0], None, :] - x[nbr], box)
        r2 = (d * d).sum(-1)
        r2 = torch.where(ok & (r2 < cutsq * (1 - 2 * md.CUT_BAND)), r2, torch.zeros_like(r2))
        k = int(r2.argmax())
        i, j = divmod(k, r2.shape[1])
        if float(r2[i, j]) > best[0]:
            best = (float(r2[i, j]), s + i, d[i, j])
    r2, i, d = best
    sr6 = r2 ** -3 * cfg["sigma"] ** 6
    fpair = 48.0 * cfg["epsilon"] * sr6 * (sr6 - 0.5) / r2
    f = f.clone()
    f[i] -= (fpair * d).to(f.dtype)
    return f, i


def readings(cell, seed: int, side: str, device) -> dict:
    """The numbers compared for one seed of the program or the control."""
    import torch

    from portbench.engines import Engine
    from portbench.reference import md
    from portbench.reference.judge import force_gap, judge
    from portbench.reference.lattice import box_lengths, fcc_atoms

    cfg = cell.cfg
    x0, v0 = fcc_atoms(cfg, seed)
    t0 = time.perf_counter()
    if side == "program":
        eng = Engine(cfg, cell.work, x0, v0, device)
        eng.run()
        thermo = [eng.run()]
        sample = eng.outputs()
        eng.release()
    else:
        thermo, sample = control_outputs(cfg, x0, v0, device)
    t1 = time.perf_counter()
    checks, _ = judge(cfg, cell.work["limits"], x0, v0, thermo, sample, 0, device)
    out = {"side": side, "seed": seed, **{k: v for k, (v, _) in checks.items()},
           "side_s": t1 - t0, "ref_s": time.perf_counter() - t1}
    if side == "program":
        box = torch.tensor(box_lengths(cfg), dtype=torch.float64, device=device)
        f, i = drop_edge_pair(sample.x, sample.f, box, cfg)
        out["force_rel_drop1"] = force_gap(sample._replace(f=f), box, cfg)
        # the pairs within the band at that atom, which the judge excuses
        out["drop1_atom_band_pairs"] = int(md.forces_at(sample.x, box, cfg)[1].n[i])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        harness.log("control.py reads the card: no CUDA device")
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, args.workload)
    device = torch.device("cuda", 0)
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            print(json.dumps(readings(cell, seed, side, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
