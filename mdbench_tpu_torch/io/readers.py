"""Atom file readers: LAMMPS .dmp dumps, GROMACS .gro, PDB and the native
.in restart format, dispatched by extension (the port of
``mdbench_tpu.io.readers``; reference src/verletlist/atom.c:199-562).

Each reader returns `ReadResult(x, v, types, box, ntypes)`; `read_atom`
writes the box into the `Params` it is given. Types are 0-based and
contiguous, as in mdbench_tpu (the reference's .dmp reader keeps the
file's 1-based types).

Pure Python. mdbench_tpu parses .dmp files with a g++-built loader
(native/fast_readers.cpp, strtod) where it can; Python's float() rounds
correctly as strtod does, so both give the same arrays bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from mdbench_tpu_torch.config import Params


class ReadResult(NamedTuple):
    x: np.ndarray  # (N, 3) float64
    v: np.ndarray  # (N, 3)
    types: np.ndarray  # (N,) int32, 0-based
    box: Optional[tuple]  # (xprd, yprd, zprd) or None
    ntypes: int


_TYPE_NAMES = {"Ar": 0}  # reference type_str2int (atom.c:189-197)


def _type_str2int(name: str) -> int:
    key = name[:2]
    if key in _TYPE_NAMES:
        return _TYPE_NAMES[key]
    raise ValueError(f"Invalid atom type: {name}")


def read_atom_dmp(path: str) -> ReadResult:
    """LAMMPS dump: 'ITEM: ATOMS id type x y z vx vy vz' with
    'BOX BOUNDS pp pp pp' (reference atom.c:393-488); atoms land at
    row id - 1, types become 0-based."""
    natoms = 0
    box = [0.0, 0.0, 0.0]
    x = v = types = None
    with open(path) as fp:
        lines = iter(fp)
        for line in lines:
            if not line.startswith("ITEM: "):
                continue
            item = line[6:]
            if item.startswith("TIMESTEP"):
                next(lines)
            elif item.startswith("NUMBER OF ATOMS"):
                natoms = int(next(lines))
                x = np.zeros((natoms, 3))
                v = np.zeros((natoms, 3))
                types = np.zeros(natoms, np.int32)
            elif item.startswith("BOX BOUNDS pp pp pp"):
                for d in range(3):
                    lo, hi = map(float, next(lines).split()[:2])
                    box[d] = hi - lo
            elif item.startswith("ATOMS id type x y z vx vy vz"):
                for _ in range(natoms):
                    t = next(lines).split()
                    aid = int(t[0]) - 1
                    types[aid] = int(t[1]) - 1
                    x[aid] = [float(t[2]), float(t[3]), float(t[4])]
                    v[aid] = [float(t[5]), float(t[6]), float(t[7])]
                break
    if x is None or natoms == 0:
        raise ValueError(f"Input error: no atoms read from {path}")
    print(f"Read {natoms} atoms from {path}")
    return ReadResult(x, v, types, tuple(box), int(types.max()) + 1)


def read_atom_gro(path: str) -> ReadResult:
    """GROMACS .gro, whitespace-tokenised like the reference
    (atom.c:307-391): label type id x y z vx vy vz, the box on the last
    line."""
    with open(path) as fp:
        desc = fp.readline().rstrip("\n")
        n = int(fp.readline().split()[0])
        print(f"System: {desc} with {n} atoms")
        x = np.zeros((n, 3))
        v = np.zeros((n, 3))
        types = np.zeros(n, np.int32)
        for i in range(n):
            t = fp.readline().split()
            types[i] = _type_str2int(t[1])
            x[i] = [float(t[3]), float(t[4]), float(t[5])]
            v[i] = [float(t[6]), float(t[7]), float(t[8])]
        box = None
        tail = fp.readline().split()
        if len(tail) >= 3:
            box = (float(tail[0]), float(tail[1]), float(tail[2]))
    print(f"Read {n} atoms from {path}")
    return ReadResult(x, v, types, box, int(types.max()) + 1)


def read_atom_pdb(path: str) -> ReadResult:
    """PDB subset: the CRYST1 box and ATOM records, zero velocities
    (reference atom.c:221-305)."""
    xs, ts = [], []
    box = None
    with open(path) as fp:
        for line in fp:
            tok = line.split()
            if not tok:
                continue
            if tok[0].startswith("CRYST1"):
                box = (float(tok[1]), float(tok[2]), float(tok[3]))
            elif tok[0].startswith("ATOM"):
                ts.append(_type_str2int(tok[2]))
                xs.append([float(tok[5]), float(tok[6]), float(tok[7])])
            elif (tok[0][:6] in ("HEADER", "REMARK", "ENDMDL")
                  or tok[0][:5] == "MODEL" or tok[0][:3] == "TER"):
                continue
            else:
                raise ValueError(f"Invalid item: {tok[0]}")
    if not xs:
        raise ValueError("Input error: No atoms read!")
    x = np.asarray(xs, np.float64)
    types = np.asarray(ts, np.int32)
    print(f"Read {len(xs)} atoms from {path}")
    return ReadResult(x, np.zeros_like(x), types, box, int(types.max()) + 1)


def read_atom_in(path: str) -> ReadResult:
    """Native restart: a header 'natoms xlo xhi ylo yhi zlo zhi', then one
    atom per line, either the reference reader's space-separated
    'mass x y z vx vy vz' (atom.c:490-562) or writeAtom's CSV
    'type,mass,x,y,z,vx,vy,vz,0' (atom.c:564-588)."""
    with open(path) as fp:
        head = fp.readline().split()
        n = int(head[0])
        box = (
            float(head[2]) - float(head[1]),
            float(head[4]) - float(head[3]),
            float(head[6]) - float(head[5]),
        ) if len(head) >= 7 else None
        x = np.zeros((n, 3))
        v = np.zeros((n, 3))
        types = np.zeros(n, np.int32)
        for i in range(n):
            t = fp.readline().replace(",", " ").split()
            if len(t) >= 9:  # CSV: type,mass,x,y,z,vx,vy,vz,flag
                types[i] = int(float(t[0]))
                vals = list(map(float, t[2:8]))
            else:  # mass x y z vx vy vz
                vals = list(map(float, t[1:7]))
            x[i] = vals[0:3]
            v[i] = vals[3:6]
    print(f"Read {n} atoms from {path}")
    return ReadResult(x, v, types, box, int(types.max()) + 1)


def read_atom(params: Params) -> ReadResult:
    """Read `params.input_file` by its extension (reference readAtom,
    atom.c:199-219); the file's box, where it has one, replaces the
    params' box, and params.ntypes becomes at least the file's count."""
    path = params.input_file
    if path.endswith(".pdb"):
        res = read_atom_pdb(path)
    elif path.endswith(".gro"):
        res = read_atom_gro(path)
    elif path.endswith(".dmp"):
        res = read_atom_dmp(path)
    elif path.endswith(".in"):
        res = read_atom_in(path)
    else:
        raise ValueError(
            f"Invalid input file extension: {path}\n"
            "Valid choices are: pdb, gro, dmp, in"
        )
    if res.box is not None:
        params.xprd, params.yprd, params.zprd = res.box
    params.ntypes = max(params.ntypes, res.ntypes)
    return res
