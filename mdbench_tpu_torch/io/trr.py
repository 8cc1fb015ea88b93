"""GROMACS TRR trajectory writer/reader (XDR, uncompressed): the port of
``mdbench_tpu.io.trr``, the same bytes.

The reference writes GROMACS XTC via libgromacs, gated behind an
optional build flag (src/clusterpair/xtc.c:13-65, XTC_OUTPUT). Here the
equivalent capability is self-contained: TRR is GROMACS's uncompressed
trajectory format — same toolchain compatibility (VMD, gmx, MDAnalysis
all read it) without libgromacs or the lossy XTC integer compression.
A reader is included so the writer is round-trip verifiable in tests.

Frame layout (GROMACS trnio semantics, all big-endian XDR):
  int   magic = 1993
  int   len+1 = 13, int len = 12, bytes "GMX_trn_file"
  int   ir_size, e_size, box_size, vir_size, pres_size, top_size,
        sym_size, x_size, v_size, f_size
  int   natoms, step, nre
  float t, lambda
  box (3x3 floats if box_size), x (natoms x 3), v (natoms x 3)
"""

from __future__ import annotations

import struct

import numpy as np

from mdbench_tpu_torch.io.xtc import write_xtc_frame

_MAGIC = 1993
_VERSION = b"GMX_trn_file"


def _w_int(fp, v):
    fp.write(struct.pack(">i", v))


def _w_float(fp, v):
    fp.write(struct.pack(">f", v))


def write_trr_frame(
    fp,
    x: np.ndarray,  # (N, 3)
    box,  # (xprd, yprd, zprd) orthorhombic
    step: int,
    time: float,
    v: np.ndarray = None,
) -> None:
    n = x.shape[0]
    box_size = 9 * 4
    x_size = n * 3 * 4
    v_size = n * 3 * 4 if v is not None else 0

    _w_int(fp, _MAGIC)
    _w_int(fp, len(_VERSION) + 1)
    _w_int(fp, len(_VERSION))
    fp.write(_VERSION)
    for sz in (0, 0, box_size, 0, 0, 0, 0, x_size, v_size, 0):
        _w_int(fp, sz)
    _w_int(fp, n)
    _w_int(fp, step)
    _w_int(fp, 0)  # nre
    _w_float(fp, time)
    _w_float(fp, 0.0)  # lambda

    bm = np.zeros((3, 3), np.float32)
    bm[0, 0], bm[1, 1], bm[2, 2] = box
    fp.write(bm.astype(">f4").tobytes())
    fp.write(np.asarray(x, np.float32).astype(">f4").tobytes())
    if v is not None:
        fp.write(np.asarray(v, np.float32).astype(">f4").tobytes())


def read_trr(path: str):
    """Minimal reader (for tests/round-trip). Returns list of frames
    (step, time, box, x, v-or-None)."""
    frames = []
    with open(path, "rb") as fp:
        while True:
            head = fp.read(4)
            if len(head) < 4:
                break
            magic = struct.unpack(">i", head)[0]
            assert magic == _MAGIC, f"bad magic {magic}"
            (slen,) = struct.unpack(">i", fp.read(4))
            (slen2,) = struct.unpack(">i", fp.read(4))
            fp.read(slen2)
            sizes = struct.unpack(">10i", fp.read(40))
            (_, _, box_size, _, _, _, _, x_size, v_size, _) = sizes
            natoms, step, _nre = struct.unpack(">3i", fp.read(12))
            t, _lam = struct.unpack(">2f", fp.read(8))
            box = None
            if box_size:
                bm = np.frombuffer(fp.read(36), ">f4").reshape(3, 3)
                box = (float(bm[0, 0]), float(bm[1, 1]), float(bm[2, 2]))
            x = np.frombuffer(fp.read(x_size), ">f4").reshape(natoms, 3)
            v = None
            if v_size:
                v = np.frombuffer(fp.read(v_size), ">f4").reshape(natoms, 3)
            frames.append((step, t, box, x.astype(np.float64),
                           None if v is None else v.astype(np.float64)))
    return frames


class TrajectoryWriter:
    """Reference xtc.h-compatible API: xtc_init / xtc_write / xtc_end
    (src/clusterpair/xtc.{c,h}). Format by extension: `.trr` ->
    uncompressed TRR (this module); anything else (incl. `.xtc`, the
    reference's format) -> real XTC via the XDR 3dfcoord codec in
    io/xtc.py."""

    def __init__(self, path: str, box):
        if "." not in path.rsplit("/", 1)[-1]:
            path = path + ".xtc"
        self.path = path
        self.box = box
        self.is_trr = path.endswith(".trr")
        self.fp = open(path, "wb")

    def write(self, x, step: int, time: float, v=None):
        if self.is_trr:
            write_trr_frame(self.fp, np.asarray(x), self.box, step, time, v)
        else:
            write_xtc_frame(self.fp, np.asarray(x), self.box, step, time)

    def end(self):
        self.fp.close()


def xtc_init(path: str, box) -> TrajectoryWriter:
    return TrajectoryWriter(path, box)


def xtc_write(writer: TrajectoryWriter, x, step: int, time: float):
    writer.write(x, step, time)


def xtc_end(writer: TrajectoryWriter):
    writer.end()
