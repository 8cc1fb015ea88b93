"""Atom state writers (the port of ``mdbench_tpu.io.writers``; reference
writeAtom, src/verletlist/atom.c:564-588), and the host copy of a state's
local atoms that every writer takes."""

from __future__ import annotations

import numpy as np


def local_atoms(sim, state):
    """(x, v, types) of the local atoms as float64 / int32 numpy arrays that
    own their memory: for the verlet engine in its (sorted) row order, for
    the cluster engine in the original atom order (through its inverse
    map; types all 0 on an untyped run)."""
    n = sim.nlocal
    if hasattr(state, "clusters"):
        x, v = (t[:n].double().cpu().numpy() for t in sim._flatten(state))
        tf = sim.types_flat0
        types = (np.zeros(n, np.int32) if tf is None
                 else tf[:n].cpu().numpy().astype(np.int32))
        return x, v, types
    return sim._snapshot(state)


def write_atom(path: str, sim, state) -> None:
    """CSV lines `type,mass,x,y,z,vx,vy,vz,0`, exactly as writeAtom."""
    x, v, types = local_atoms(sim, state)
    with open(path, "w") as fp:
        for i in range(sim.nlocal):
            fp.write("%d,%f,%f,%f,%f,%f,%f,%f,0\n" % (
                types[i], 1.0, x[i, 0], x[i, 1], x[i, 2], v[i, 0], v[i, 1], v[i, 2]))
    print("Wrote input data to %s, grid size: %f, %f, %f"
          % (path, sim.params.xprd, sim.params.yprd, sim.params.zprd))
