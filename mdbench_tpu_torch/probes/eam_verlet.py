"""The verlet EAM passes K5 and K6 (csrc/eam_verlet.cu) at the benchmark's
131,072 atoms.

    python -m mdbench_tpu_torch.probes.eam_verlet [--check] [CSRC_DIR ...]

Runs the 60-step SP verlet EAM run once on chip_smoke.py's stand-in
potential (one timed region; eam_eval auto takes the polynomials), then
times K5 and K6 on its final lists, float32 and float64, poly and spline,
back to back (CUDA events) and on the device alone (CUDA graph). Each
line gives a fingerprint of the output bits, the listed int64 entries'
rate (the list stream, TB/s) and the share of the pass's bound
(chip_smoke.eam_verlet_bounds); the blocks an SM holds of each kernel
come first, with the kernels' -Xptxas -v lines and the card's name and
power limit.

Each CSRC_DIR is another copy of mdbench_tpu_torch/csrc/ with the same C
entry points (an earlier checkout's, or an edited variant): its library
is built beside the package's, and both kernels are timed with each
library in turns (this one first, then the others, then back in reverse
order), in one process on one card, on the same lists; equal
fingerprints mean equal output bits.

--check: build, print the -Xptxas -v lines, launch K5 and K6 once each on
the 131k lattice's first lists (no run) in every form against their
plain versions, synchronise, print the errors and stop.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import torch

from mdbench_tpu_torch.probes import card_line, event_ms, graph_ms

REPS = 50
FORMS = ("poly", "spline")
NAMES = {"K5": "eam_rho_nlist", "K6": "eam_force_nlist"}


def bits(out) -> str:
    """A fingerprint of the output tensors' bits."""
    h = hashlib.sha1()
    for t in out:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def eam_sim(device, **kw):
    """The verlet EAM SP simulation of run_bench_eam(scheme="verlet") on
    chip_smoke.py's stand-in potential (written under the build directory),
    with `kw` overriding its Params."""
    import chip_smoke
    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.config import FF_EAM, Params
    from mdbench_tpu_torch.engine import Simulation

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    eam_file = str(_build.BUILD_DIR / "standin_cu.eam")
    chip_smoke.write_standin_funcfl(eam_file)
    p = dict(precision="sp", scheme="verlet", dense_thermo=False, force_field=FF_EAM,
             eam_file=eam_file, ntimes=60)
    return Simulation(Params(**{**p, **kw}), device=device)


def eam_calls(sim, x, nlist, border_map, dtype, form: str) -> dict:
    """K5 and K6 (their wrappers: the kernels on the card, the plain
    versions on the CPU) on one set of lists in `dtype` and `form`, each
    returning its outputs; K6 takes the plain pass 1's fp with its ghost
    rows refreshed. Also "plain K5" and "plain K6"."""
    from mdbench_tpu_torch.models.eam_tables import fit_eam_poly
    from mdbench_tpu_torch.ops import eam as ev

    npad, cutsq = sim.caps.nlocal_pad, sim.params.cutforce**2
    nb, nn = nlist.neighbors, nlist.numneigh
    x = x.to(dtype).contiguous()
    eam = ev.EamDevice.from_tables(sim.eam_tables, x.device, dtype)
    poly = (sim.eam_poly or fit_eam_poly(sim.eam_tables)) if form == "poly" else None
    fp_r, _ = ev.eam_rho_nlist_ref(x, nb, nn, npad, cutsq, eam, poly)
    fp = ev.ghost_fp_refresh(fp_r, border_map, npad)
    return {
        "K5": lambda: ev.eam_rho_nlist(x, nb, nn, npad, cutsq, eam, poly, want_rho=True),
        "K6": lambda: (ev.eam_force_nlist(x, nb, nn, fp[:npad], fp, cutsq, eam, poly),),
        "plain K5": lambda: ev.eam_rho_nlist_ref(x, nb, nn, npad, cutsq, eam, poly),
        "plain K6": lambda: (ev.eam_force_nlist_ref(x, nb, nn, fp[:npad], fp, cutsq, eam,
                                                    poly),),
    }


def occupancy_lines() -> list:
    """The blocks of 8 warps an SM holds, by pass, dtype and form (the
    occupancy API on the current card); the kernels use no shared memory
    and read the spline tables through the read-only cache."""
    from mdbench_tpu_torch.ops import eam as ev

    return [f"{kid} {str(dtype)[6:]} {form}: "
            f"{ev.nlist_blocks_per_sm(name, dtype, form == 'poly')} blocks of 8 warps an SM"
            for kid, name in NAMES.items() for dtype in (torch.float32, torch.float64)
            for form in FORMS]


def check(sim) -> int:
    """--check: K5 and K6 once each on the first 131k lists in every form
    against their plain versions (error 0 expected: the same sums)."""
    x, _, halo, nlist, _ = sim._reneighbor(sim.x0, sim.types0)
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for form in FORMS:
            calls = eam_calls(sim, x, nlist, halo.border_map, dtype, form)
            for kid in NAMES:
                got, want = calls[kid](), calls[f"plain {kid}"]()
                torch.cuda.synchronize()
                err = max(float((g.double() - w.double()).abs().max())
                          for g, w in zip(got, want) if g is not None)
                worst = max(worst, err)
                print(f"check {kid} {str(dtype)[6:]} {form}: max abs error against the "
                      f"plain version {err:.3e}; bits {bits(got)}", flush=True)
    return 0 if worst == 0.0 else 1


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probes.eam_verlet needs a CUDA card")
    import chip_smoke
    from mdbench_tpu_torch import _build

    do_check = "--check" in argv
    variants = [("this", _build.SRC_DIR), *((d, Path(d)) for d in argv if d != "--check")]
    smi = card_line()
    for name, src in variants:  # build every library before the runs
        _build.load(src)
        for kernel in ("eam_rho_nlist_kernel", "eam_force_nlist_kernel"):
            for line in chip_smoke.kernel_ptxas_lines(kernel, src):
                print(f"{name}: {line}")
    _build.load(_build.SRC_DIR)
    sim = eam_sim("cuda")
    if do_check:
        print(f"on {smi}", flush=True)
        return check(sim)
    out = sim.run(repeats=1, chain=1)
    st = out.state
    print(f"verlet EAM SP run: TOTAL {out.total_time:.6f} s, K {st.nlist.neighbors.shape[1]}"
          f"; on {smi}", flush=True)
    for line in occupancy_lines():
        print(line, flush=True)
    calls, bounds = {}, {}
    for dtype in (torch.float32, torch.float64):
        for form in FORMS:
            calls[dtype, form] = eam_calls(sim, st.x, st.nlist, st.halo.border_map, dtype,
                                           form)
            b5, b6, _, listed, inside = chip_smoke.eam_verlet_bounds(
                torch, sim, st, dtype, form == "poly")
            bounds[dtype, form] = {"K5": b5, "K6": b6, "listed": listed}
    print(f"lists: {bounds[torch.float32, 'poly']['listed']} listed pairs, {inside} "
          f"inside", flush=True)
    order = variants + variants[::-1] if len(variants) > 1 else variants
    for name, src in order:
        _build.load(src)
        for (dtype, form), fns in calls.items():
            for kid in NAMES:
                fn = fns[kid]
                out_bits = bits(fn())
                ms, ms_dev = event_ms(fn, REPS), graph_ms(fn, REPS)
                b = bounds[dtype, form]
                rate = b["listed"] * 8 / (ms_dev * 1e-3) / 1e12
                print(f"{name} {str(dtype)[6:]} {form} {kid}: {ms:.4f} ms back to back, "
                      f"{ms_dev:.4f} ms on the device; list stream {rate:.3f} TB/s; bound "
                      f"{b[kid][0]:.4f} ms ({b[kid][1]}), {b[kid][0] / ms_dev:.1%} of it on "
                      f"the device; bits {out_bits}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
