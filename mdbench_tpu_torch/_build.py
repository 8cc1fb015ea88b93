"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` process, all
started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
``mdbench_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads the
cached file; the compilers' output (``-Xptxas -v``: registers, shared
memory, spills per kernel) is kept beside it in a ``.log`` file. The
build runs at first use (the first launch on a CUDA tensor), never at
import: the CPU path needs neither nvcc nor a card.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "lj_cluster_ilist_f32": (
        [_P] * 8 + [_I] * 3 + [ctypes.c_float] * 3 + [_P], ctypes.c_int),
    "lj_cluster_ilist_f64": (
        [_P] * 8 + [_I] * 3 + [ctypes.c_double] * 3 + [_P], ctypes.c_int),
    # (xc, yc, zc, jlist, ranges, fx, fy, fz, ng, L, cutforcesq, sigma6,
    #  epsilon, stream)
    "lj_cluster_stream_f32": (
        [_P] * 8 + [_I] * 2 + [ctypes.c_float] * 3 + [_P], ctypes.c_int),
    "lj_cluster_stream_f64": (
        [_P] * 8 + [_I] * 2 + [ctypes.c_double] * 3 + [_P], ctypes.c_int),
    # (xc, yc, zc, ijlist, nji, rho, n_units, icap, share, coefs, stream)
    "eam_rho_ilist_f32": ([_P] * 6 + [_I] * 3 + [_P] * 2, ctypes.c_int),
    "eam_rho_ilist_f64": ([_P] * 6 + [_I] * 3 + [_P] * 2, ctypes.c_int),
    # (xc, yc, zc, fp, ijlist, nji, fx, fy, fz, n_units, icap, share,
    #  coefs, stream)
    "eam_force_ilist_f32": ([_P] * 9 + [_I] * 3 + [_P] * 2, ctypes.c_int),
    "eam_force_ilist_f64": ([_P] * 9 + [_I] * 3 + [_P] * 2, ctypes.c_int),
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
    """Compile the sources, one nvcc each in parallel, and link them,
    unless the library for them already exists. Raises with nvcc's
    output if a step fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    jobs = []
    for src, obj in zip(sources(), objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, proc in jobs:
        text = proc.communicate()[0]
        logs.append(f"$ {' '.join(cmd)}\n{text}")
        if proc.returncode != 0:
            failed.append(proc.returncode)
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    try:
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n" + "\n".join(logs))
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}"
            )
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
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
