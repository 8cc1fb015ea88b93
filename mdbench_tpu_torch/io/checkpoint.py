"""Binary checkpoint and resume of a simulation's state (the port of
``mdbench_tpu.io.checkpoint``, with the same npz layout: x, v, types and a
JSON `meta` with the step and the run's identity). The reference's closest
facility is the `-w` atom file (atom.c:564-588)."""

from __future__ import annotations

import json

import numpy as np

from mdbench_tpu_torch.io.writers import local_atoms


def save_checkpoint(path: str, sim, state, step: int) -> None:
    """Save the local atoms of either engine's `state` at `step`."""
    x, v, types = local_atoms(sim, state)
    p = sim.params
    meta = dict(step=step, natoms=sim.natoms, scheme=p.scheme,
                force_field=p.force_field, ntypes=p.ntypes, eam_file=p.eam_file,
                xprd=p.xprd, yprd=p.yprd, zprd=p.zprd)
    np.savez(path, x=x, v=v, types=types, meta=json.dumps(meta))


def load_checkpoint(path: str):
    """Returns (x, v, types, meta). Resume with Simulation(params, x=x, v=v,
    types=types, adjust=False); an EAM run's params must name the eam_file
    of meta again (the tables are rebuilt from it, not saved)."""
    d = np.load(path, allow_pickle=False)
    meta = json.loads(str(d["meta"]))
    types = d["types"] if "types" in d.files else None
    return d["x"], d["v"], types, meta
