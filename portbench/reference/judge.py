"""The comparison that decides `correct`: the program's outputs against the
plain reference (md.py), worked out again from the same t=0 atoms.

Four numbers, each with a limit of its cell (the workload file's
"limits"):

- thermo_rel: the largest relative gap of the program's temperature or
  pressure after any step of any run checked, against the reference's
  trajectory (the integrator and the thermo, and through them every force
  of the run);
- pos_abs: the largest distance (minimum image) between an atom of the
  sampled run's last state and the same atom of the reference's;
- vel_rel: the largest gap of an atom's velocity there, over the largest
  reference speed;
- force_rel: the largest gap of an atom's force in that state, over the
  largest force, against float64 forces at the program's own positions
  (the force kernels on the lists of the run's last rebuild). A pair
  within rounding of the cutoff (md.CUT_BAND) may count or not: an atom
  with one such pair is judged by the nearer of its gaps with and without
  that pair's force, an atom with more by its gap less the sum of their
  forces' magnitudes.

Where the program keeps atoms in an order of its own and gives no ids,
each of its atoms is matched to the nearest reference atom; a match that
is not one to one reads as infinite.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference import md

CHECKS = ("thermo_rel", "pos_abs", "vel_rel", "force_rel")


class Outputs(NamedTuple):
    """The local atoms of a run's last state, (N, 3) tensors; ids[i] is the
    t=0 row of atom i, or None where the program keeps no ids."""
    x: torch.Tensor
    v: torch.Tensor
    f: torch.Tensor
    ids: Optional[torch.Tensor]


def _finite(value: float) -> float:
    return value if math.isfinite(value) else math.inf


def thermo_rel(temps, press, ref: md.Trajectory) -> float:
    rt = ref.temps.double().cpu().numpy()
    rp = ref.press.double().cpu().numpy()
    t = np.asarray(temps, np.float64)
    p = np.asarray(press, np.float64)
    if t.shape != rt.shape or p.shape != rp.shape:
        return math.inf
    gap = max(np.max(np.abs(t - rt) / np.abs(rt)), np.max(np.abs(p - rp) / np.abs(rp)))
    return _finite(float(gap))


def match(xp: torch.Tensor, xr: torch.Tensor, box: torch.Tensor):
    """For each program atom the nearest reference atom (periodic), or
    None if two program atoms share one."""
    from scipy.spatial import cKDTree

    b = box.double().cpu().numpy()

    def wrap(a):
        return np.mod(a.double().cpu().numpy(), b) % b  # in [0, b) exactly

    _, idx = cKDTree(wrap(xr), boxsize=b).query(wrap(xp))
    if len(np.unique(idx)) != len(idx):
        return None
    return torch.as_tensor(idx, device=xr.device)


def state_gaps(out: Outputs, ref: md.Trajectory, box: torch.Tensor):
    """(pos_abs, vel_rel) of a run's last state against the reference's."""
    n = ref.x.shape[0]
    if out.x.shape[0] != n or not bool(torch.isfinite(out.x).all()):
        return math.inf, math.inf
    xp, vp = out.x.double(), out.v.double()
    rows = out.ids if out.ids is not None else match(xp, ref.x, box)
    if rows is None:
        return math.inf, math.inf
    dx = md.min_image(xp - ref.x[rows], box.double())
    pos = float(dx.norm(dim=1).max())
    vel = float((vp - ref.v[rows]).norm(dim=1).max() / ref.v.norm(dim=1).max())
    return _finite(pos), _finite(vel)


def force_gap(out: Outputs, box: torch.Tensor, cfg: dict) -> float:
    if not bool(torch.isfinite(out.x).all()):
        return math.inf
    fr, band = md.forces_at(out.x, box, cfg)
    delta = out.f.double() - fr
    gap = delta.norm(dim=1)
    gap = torch.where(band.n == 1, torch.minimum(gap, (delta - band.vec).norm(dim=1)),
                      torch.where(band.n > 1, (gap - band.mag).clamp(min=0), gap))
    return _finite(float(gap.max() / fr.norm(dim=1).max()))


def judge(cfg: dict, limits: dict, x0, v0, thermo: list, sample: Outputs,
          sample_run: int, device):
    """The reference's trajectory from the t=0 atoms (x0, v0: float64
    arrays) on `device`, and against it: checks {name: (value, limit)} and
    the number of runs that failed, each run whose thermo trace is off and
    the sampled run (thermo[sample_run]) if its state is."""
    from portbench.reference.lattice import box_lengths

    box = torch.tensor(box_lengths(cfg), dtype=torch.float64, device=device)
    ref = md.trajectory(torch.tensor(x0, dtype=torch.float64, device=device),
                        torch.tensor(v0, dtype=torch.float64, device=device),
                        box, cfg, cfg["ntimes"])
    per_run = [thermo_rel(t, p, ref) for t, p in thermo]
    pos, vel = state_gaps(sample, ref, box)
    values = {
        "thermo_rel": max(per_run),
        "pos_abs": pos,
        "vel_rel": vel,
        "force_rel": force_gap(sample, box, cfg),
    }
    checks = {k: (values[k], float(limits[k])) for k in CHECKS}
    state_bad = any(not checks[k][0] <= checks[k][1] for k in CHECKS[1:])
    failed = sum(not g <= limits["thermo_rel"] or (i == sample_run and state_bad)
                 for i, g in enumerate(per_run))
    return checks, failed
