"""The bf16 derive's A/B at the benchmark's 131,072 atoms (the port of
tools/r3_derive16.py's measurement; chip_smoke.py phase 49 prints the
rule's verdict):

    python -m mdbench_tpu_torch.probes.derive [PAIRS]

Runs the 200-step SP cluster benchmark with the exact derive and with
Params.derive_bf16 (run_bench, golden-gated), then on the exact run's
final state times ops/cluster.derive_ilists both ways in turns (f32,
bf16, bf16, f32, three times: each turn the median of 11 event-fenced
calls, as the eager run pays it; then two turns each from a CUDA graph,
the device alone), profiles one call of each by op (torch.profiler: the
host's time beside the device's), takes measure_phases' FORCE and NEIGH
of both engines three times, runs PAIRS (default 4) pairs of
run_bench(repeats=1, chain=1) in turns (f32, bf16, bf16, f32, ...) for
their TOTALs, and profiles one timed region of each engine by op. The
timing lines carry the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mdbench_tpu_torch.probes import card_line, event_ms, graph_ms


def turns(fns: dict, order, timer) -> dict:
    """{name: [timer(fns[name]) for each turn of `name` in `order`]}."""
    out = {name: [] for name in fns}
    for name in order:
        out[name].append(timer(fns[name]))
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probes.derive needs a CUDA card")
    from mdbench_tpu_torch.bench import run_bench
    from mdbench_tpu_torch.engine_cluster import GROUP
    from mdbench_tpu_torch.ops.cluster import derive_ilists

    argv = sys.argv[1:] if argv is None else argv
    pairs = int(argv[0]) if argv else 4
    smi = card_line()
    runs = {name: run_bench(repeats=1, chain=1, derive_bf16=name == "bf16")[:2]
            for name in ("f32", "bf16")}
    sim, out = runs["f32"]
    st, p = out.state, sim.params
    width = st.pairs.jlist.shape[1]
    derive = {name: (lambda b=name == "bf16": derive_ilists(
        st.clusters, st.pairs, sim.n_clusters_pad, GROUP, p.cutneigh, width,
        share=sim.ishare, bf16=b)) for name in ("f32", "bf16")}
    order = ("f32", "bf16", "bf16", "f32")
    ev = turns(derive, order * 3, lambda fn: event_ms(fn, 1, batches=11, warm=2))
    dev = turns(derive, order, lambda fn: graph_ms(fn, 3))
    print(f"derive_ilists at 131k (the exact run's final state, {width} wide): "
          f"event-fenced f32 {np.median(ev['f32']):.4f} ms, bf16 "
          f"{np.median(ev['bf16']):.4f} ms (turns' medians of 11: {ev}); from a CUDA "
          f"graph f32 {np.median(dev['f32']):.4f} ms, bf16 {np.median(dev['bf16']):.4f} "
          f"ms ({dev}); on {smi}", flush=True)
    for name, fn in derive.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        print(f"derive_ilists {name}, one call by op:", flush=True)
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=10,
                                        max_name_column_width=60), flush=True)
    for rep in range(3):
        line = []
        for name, (s_, o_) in runs.items():
            t_force, t_neigh = s_.measure_phases(o_.state)
            line.append(f"{name} FORCE {t_force * 1e3:.4f} ms, NEIGH {t_neigh * 1e3:.4f} ms")
        print(f"measure_phases {rep}: " + "; ".join(line), flush=True)
    totals = {"f32": [], "bf16": []}
    for name in order * ((pairs + 1) // 2):
        if len(totals[name]) < pairs:
            totals[name].append(run_bench(repeats=1, chain=1,
                                          derive_bf16=name == "bf16")[1].total_time)
    print(f"run_bench TOTAL in turns ({pairs} pairs): f32 median "
          f"{np.median(totals['f32']):.6f} s, bf16 {np.median(totals['bf16']):.6f} s "
          f"({totals}); on {smi}", flush=True)
    for name, (s_, _o) in runs.items():
        state = s_.initial_state()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            s_._run_steps(state, p.ntimes)
            torch.cuda.synchronize()
        print(f"one timed region ({p.ntimes} steps) {name}, buckets {s_.buckets}, by op:",
              flush=True)
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12,
                                        max_name_column_width=60), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
