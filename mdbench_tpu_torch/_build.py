"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``. The library lands in
``mdbench_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads the
cached file. The build runs at first use (the first launch on a CUDA
tensor), never at import: the CPU path needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "lj_cluster_ilist_f32": (
        [_P] * 8 + [_I] * 3 + [ctypes.c_float] * 3 + [_P], ctypes.c_int),
    "lj_cluster_ilist_f64": (
        [_P] * 8 + [_I] * 3 + [ctypes.c_double] * 3 + [_P], ctypes.c_int),
}

_lib = None  # the loaded library, once per process


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "mdbench_tpu_torch are built from csrc/ at first use"
        )
    return found


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmdbench_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them already exists.
    Raises with nvcc's output if the compile fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with argtypes declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib
