"""The system under test: `mdbench_tpu_torch`'s engines, driven through
their normal entry, `run(repeats=0)`. This is the one module of the
harness that imports the program.

A workload's "scheme" names the engine (the cluster-pair scheme,
`engine_cluster.ClusterSimulation`, or the verlet scheme,
`engine.Simulation`) and its "kernel" the force kernel axis; the
configuration gives every other setting. The engine is built once
from the seeded t=0 atoms (`adjust=False`: the harness made the
velocities), so each `run(repeats=0)` is one checked trajectory from those
atoms: the t=0 neighbour build, the steps, the overflow flags and the
thermo trace on the host. The verlet engine calibrates its capacities in
the first call, which is set-up; the cluster engine calibrates again in
every call, so a trajectory that outgrew the calibration grows and runs
again in each.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.judge import Outputs

# configuration keys that are settings of the program (its Params fields)
PARAM_KEYS = ("nx", "ny", "nz", "rho", "temp", "epsilon", "sigma", "mass",
              "dt", "cutforce", "skin", "reneigh_every", "ntimes", "precision")


class Engine:
    """One engine of the program for one cell, with the outputs of its last
    run."""

    def __init__(self, cfg: dict, work: dict, x0: np.ndarray, v0: np.ndarray,
                 device):
        from mdbench_tpu_torch.config import Params

        params = Params(**{k: cfg[k] for k in PARAM_KEYS},
                        scheme=work["scheme"], kernel=work["kernel"])
        if work["scheme"] == "cluster":
            from mdbench_tpu_torch.engine_cluster import ClusterSimulation

            self.sim = ClusterSimulation(params, x=x0, v=v0, adjust=False,
                                         device=device)
        elif work["scheme"] == "verlet":
            from mdbench_tpu_torch.engine import Simulation

            self.sim = Simulation(params, x=x0, v=v0, adjust=False, device=device)
        else:
            raise ValueError(f"unknown scheme {work['scheme']!r}")
        self.scheme = work["scheme"]
        self.last = None

    def run(self):
        """One run(repeats=0): (temps, press) on the host, float64."""
        self.last = self.sim.run(repeats=0)
        return (np.asarray(self.last.temps, np.float64),
                np.asarray(self.last.press, np.float64))

    def outputs(self) -> Outputs:
        """Copies of the last run's local atoms: positions, velocities and
        forces after its last step; ids where the engine keeps the t=0
        order."""
        st = self.last.state
        if self.scheme == "cluster":
            npad = self.sim.n_clusters_pad
            inv = st.clusters.inv_map  # t=0 row -> cluster * 8 + slot

            def atoms(planes):
                return torch.stack([q[:npad].reshape(-1)[inv] for q in planes], 1)

            cl = st.clusters
            x = atoms((cl.xc, cl.yc, cl.zc))
            v = atoms((st.vxc, st.vyc, st.vzc))
            f = atoms((st.fxc, st.fyc, st.fzc))
            ids = torch.arange(x.shape[0], device=x.device)
            return Outputs(x, v, f, ids)
        n = self.sim.nlocal  # the verlet engine keeps bin-sorted atoms
        return Outputs(st.x[:n].clone(), st.v[:n].clone(), st.f[:n].clone(), None)

    def notes(self) -> str:
        """The capacities the engine settled on, and its grows."""
        s = self.sim
        if self.scheme == "cluster":
            return (f"engine: grows {s.grows}, list_cap {s.list_cap}, icap {s.icap}, "
                    f"buckets {s.buckets is not None}")
        return (f"engine: rcap {s.rcap}, ccap {s.ccap}, caps {tuple(s.caps)}, "
                f"buckets {s.rbuckets is not None}")

    def release(self):
        self.sim = self.last = None
