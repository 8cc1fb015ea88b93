"""ctypes bindings for the native host readers and writers (the port's copy
of ``mdbench_tpu.io.native``): native/fast_readers.cpp (.dmp and .in
parsers) and native/fast_writers.cpp (VTK and tracer dumps), compiled on
first use with g++ into mdbench_tpu_torch/_build/native/ and loaded with
ctypes.

Where no library can be built or loaded, every function here says so
(None or False) and the caller runs its pure-Python version, which
produces the same arrays and the same bytes. This fallback concerns host
file parsing and writing only, never the device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
LIB_DIR = Path(__file__).resolve().parents[1] / "_build" / "native"

_lock = threading.Lock()
_libs: dict = {}


def _build(src: Path, so: Path) -> None:
    """g++ `src` into `so` unless `so` is newer. The library is written to a
    temporary name and renamed, so a process that loads it meanwhile never
    sees a partial file."""
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=so.parent, suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(src)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare_readers(lib) -> None:
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    for fn in (lib.parse_dmp, lib.parse_in):
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_char_p, f64, f64, i32, f64, ctypes.c_long]


def _declare_writers(lib) -> None:
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    lng = ctypes.c_long
    lib.write_atoms_vtk.restype = ctypes.c_int
    lib.write_atoms_vtk.argtypes = [ctypes.c_char_p, f64, lng]
    lib.write_index_trace.restype = ctypes.c_int
    lib.write_index_trace.argtypes = [ctypes.c_char_p, i32, i32, lng, lng, lng]
    lib.write_mem_trace.restype = ctypes.c_int
    lib.write_mem_trace.argtypes = [ctypes.c_char_p, i32, i32, lng, lng, lng, lng]


_SOURCES = {
    "read": ("fast_readers.cpp", "libfastread.so", _declare_readers),
    "write": ("fast_writers.cpp", "libfastwrite.so", _declare_writers),
}


def _load(kind: str):
    """The library `kind` ("read" or "write"), or None when it cannot be
    built or loaded (tried once per process)."""
    with _lock:
        if kind not in _libs:
            src, so, declare = _SOURCES[kind]
            try:
                _build(NATIVE_DIR / src, LIB_DIR / so)
                lib = ctypes.CDLL(str(LIB_DIR / so))
                declare(lib)
            except (OSError, subprocess.SubprocessError, AttributeError):
                lib = None
            _libs[kind] = lib
        return _libs[kind]


def available() -> bool:
    """True if the native readers load."""
    return _load("read") is not None


def write_atoms_vtk(path: str, x: np.ndarray) -> bool:
    """The VTK atom dump of io/vtk.py; False: the caller writes it."""
    lib = _load("write")
    if lib is None:
        return False
    xc = np.ascontiguousarray(x, np.float64)
    return lib.write_atoms_vtk(path.encode(), xc.reshape(-1), len(xc)) == 0


def write_index_trace(path: str, neighbors, numneigh, vw: int) -> bool:
    lib = _load("write")
    if lib is None:
        return False
    nb = np.ascontiguousarray(neighbors, np.int32)
    nn = np.ascontiguousarray(numneigh, np.int32)
    return lib.write_index_trace(path.encode(), nb, nn, nb.shape[0], nb.shape[1],
                                 vw) == 0


def write_mem_trace(path: str, neighbors, numneigh, nlocal: int, nrows: int,
                    float_size: int) -> bool:
    lib = _load("write")
    if lib is None:
        return False
    nb = np.ascontiguousarray(neighbors, np.int32)
    nn = np.ascontiguousarray(numneigh, np.int32)
    return lib.write_mem_trace(path.encode(), nb, nn, nlocal, nb.shape[1], nrows,
                               float_size) == 0


def _count_atoms(path: str, kind: str) -> int:
    with open(path) as fp:
        if kind != "dmp":
            return int(fp.readline().split()[0])
        for line in fp:
            if line.startswith("ITEM: NUMBER OF ATOMS"):
                return int(fp.readline())
    raise ValueError("no NUMBER OF ATOMS item")


def parse(path: str, kind: str):
    """Parse a .dmp (`kind` "dmp") or .in file natively. Returns (x, v,
    types, box), or None when the library is unavailable or the parse
    fails (the caller then reads the file in Python)."""
    lib = _load("read")
    if lib is None:
        return None
    try:
        n = _count_atoms(path, kind)
    except (OSError, ValueError, IndexError):
        return None
    x = np.zeros((n, 3), np.float64)
    v = np.zeros((n, 3), np.float64)
    types = np.zeros(n, np.int32)
    box = np.zeros(3, np.float64)
    fn = lib.parse_dmp if kind == "dmp" else lib.parse_in
    if fn(path.encode(), x.reshape(-1), v.reshape(-1), types, box, n) != n:
        return None
    return x, v, types, tuple(box)
