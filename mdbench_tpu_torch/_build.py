"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` process, all
started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``. The library lands in
``mdbench_tpu_torch/_build/`` under a name keyed by a hash of the sources,
the headers they include (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one loads the
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
    # (xc, yc, zc, ijlist, nji, fx, fy, fz, n_units, icap, share,
    #  cutforcesq, sigma6, epsilon, approx_rcp, stream)
    "lj_cluster_ilist_f32": (
        [_P] * 8 + [_I] * 3 + [ctypes.c_float] * 3 + [_I, _P], ctypes.c_int),
    "lj_cluster_ilist_f64": (
        [_P] * 8 + [_I] * 3 + [ctypes.c_double] * 3 + [_I, _P], ctypes.c_int),
    # (xc, yc, zc, jlist, ranges, fx, fy, fz, ng, L, cutforcesq, sigma6,
    #  epsilon, stream)
    "lj_cluster_stream_f32": (
        [_P] * 8 + [_I] * 2 + [ctypes.c_float] * 3 + [_P], ctypes.c_int),
    "lj_cluster_stream_f64": (
        [_P] * 8 + [_I] * 2 + [ctypes.c_double] * 3 + [_P], ctypes.c_int),
    # typed forms: (xc, yc, zc, tc, ijlist, nji, eps, sig6, cutsq, fx, fy,
    #  fz, n_units, icap, share, ntypes, approx_rcp, stream) and (xc, yc, zc,
    #  tc, jlist, ranges, eps, sig6, cutsq, fx, fy, fz, ng, L, ntypes, stream)
    "lj_cluster_ilist_typed_f32": ([_P] * 12 + [_I] * 5 + [_P], ctypes.c_int),
    "lj_cluster_ilist_typed_f64": ([_P] * 12 + [_I] * 5 + [_P], ctypes.c_int),
    "lj_cluster_stream_typed_f32": ([_P] * 12 + [_I] * 3 + [_P], ctypes.c_int),
    "lj_cluster_stream_typed_f64": ([_P] * 12 + [_I] * 3 + [_P], ctypes.c_int),
    # (xc, yc, zc, ijlist, nji, rho, n_units, icap, share, coefs, stream)
    "eam_rho_ilist_f32": ([_P] * 6 + [_I] * 3 + [_P] * 2, ctypes.c_int),
    "eam_rho_ilist_f64": ([_P] * 6 + [_I] * 3 + [_P] * 2, ctypes.c_int),
    # (xc, yc, zc, fp, ijlist, nji, fx, fy, fz, n_units, icap, share,
    #  coefs, stream)
    "eam_force_ilist_f32": ([_P] * 9 + [_I] * 3 + [_P] * 2, ctypes.c_int),
    "eam_force_ilist_f64": ([_P] * 9 + [_I] * 3 + [_P] * 2, ctypes.c_int),
    # bucketed forms: (xc, yc, zc, bijlist, bcrows, nji, fx, fy, fz, n_rows,
    #  icap, n_units, share, nbuckets, ends, caps, cutforcesq, sigma6,
    #  epsilon, approx_rcp, stream)
    "lj_cluster_ilist_buckets_f32": (
        [_P] * 9 + [_I] * 5 + [_P] * 2 + [ctypes.c_float] * 3 + [_I, _P],
        ctypes.c_int),
    "lj_cluster_ilist_buckets_f64": (
        [_P] * 9 + [_I] * 5 + [_P] * 2 + [ctypes.c_double] * 3 + [_I, _P],
        ctypes.c_int),
    # (xc, yc, zc, bijlist, bcrows, nji, rho, n_rows, icap, n_units, share,
    #  nbuckets, ends, caps, coefs, stream)
    "eam_rho_buckets_f32": ([_P] * 7 + [_I] * 5 + [_P] * 4, ctypes.c_int),
    "eam_rho_buckets_f64": ([_P] * 7 + [_I] * 5 + [_P] * 4, ctypes.c_int),
    # (xc, yc, zc, fp, bijlist, bcrows, nji, fx, fy, fz, n_rows, icap,
    #  n_units, share, nbuckets, ends, caps, coefs, stream)
    "eam_force_buckets_f32": ([_P] * 10 + [_I] * 5 + [_P] * 4, ctypes.c_int),
    "eam_force_buckets_f64": ([_P] * 10 + [_I] * 5 + [_P] * 4, ctypes.c_int),
    # the verlet EAM passes (K5, K6): (x, neighbors, numneigh, rhor, frho,
    #  fp, rho, nrows, nlocal_pad, k, nr, nrho, poly, scalars, stream) and
    #  (x, neighbors, numneigh, rhor, z2r, fp_local, fp, f, nrows,
    #  nlocal_pad, k, nr, nrho, poly, scalars, stream); and the blocks of
    #  one of them an SM holds, (pass, f64, poly)
    "eam_rho_nlist_f32": ([_P] * 7 + [_I] * 6 + [_P] * 2, ctypes.c_int),
    "eam_rho_nlist_f64": ([_P] * 7 + [_I] * 6 + [_P] * 2, ctypes.c_int),
    "eam_force_nlist_f32": ([_P] * 8 + [_I] * 6 + [_P] * 2, ctypes.c_int),
    "eam_force_nlist_f64": ([_P] * 8 + [_I] * 6 + [_P] * 2, ctypes.c_int),
    "eam_nlist_blocks_per_sm": ([_I] * 3, ctypes.c_int),
    # the bf16 probe (T2): (xc, yc, zc, ijlist, nji, fx, fy, fz, n_units,
    #  icap, share, cutforcesq rounded up to bfloat16, sigma6 and
    #  48*epsilon rounded to bfloat16, stream)
    "lj_cluster_ilist_bf16": (
        [_P] * 8 + [_I] * 3 + [ctypes.c_float] * 3 + [_P], ctypes.c_int),
    # the row-fetch probe (T1): (table, ids, out, n_ids, n_table_rows,
    #  rows_per_id, mode, stream)
    "row_fetch_f32": ([_P] * 3 + [_I] * 4 + [_P], ctypes.c_int),
    # the verlet row lists' exact prune: (x, cand, validu, rows, numrows,
    #  nu, cc, rcap, sent16, n16, cutsq, stream)
    "verlet_prune_f32": ([_P] * 5 + [_I] * 5 + [ctypes.c_float, _P], ctypes.c_int),
    "verlet_prune_f64": ([_P] * 5 + [_I] * 5 + [ctypes.c_double, _P], ctypes.c_int),
    # the verlet ranges build's candidate stage: (x, bins, starts_l,
    #  starts_g, cand, counts, stats, nu, nlocal, ucol, kcap, ccap, d0, d1,
    #  d2, sent16, bs0, bs1, cutsq, stream)
    "verlet_ranges_f32": (
        [_P] * 7 + [_I] * 9 + [ctypes.c_float] * 3 + [_P], ctypes.c_int),
    "verlet_ranges_f64": (
        [_P] * 7 + [_I] * 9 + [ctypes.c_double] * 3 + [_P], ctypes.c_int),
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


def sources(src_dir: Path | None = None) -> list[Path]:
    return sorted(Path(src_dir or SRC_DIR).glob("*.cu"))


def library_path(src_dir: Path | None = None) -> Path:
    """Where the library for the sources and headers in `src_dir` (the
    package's csrc/ by default) and the flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(Path(src_dir or SRC_DIR).glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmdbench_kernels_{h.hexdigest()[:16]}.so"


def build(src_dir: Path | None = None) -> Path:
    """Compile the sources of `src_dir`, one nvcc each in parallel, and
    link them, unless the library for them already exists. Raises with
    nvcc's output if a step fails."""
    out = library_path(src_dir)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources(src_dir)]
    jobs = []
    for src, obj in zip(sources(src_dir), objs):
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


def load(src_dir: Path | None = None) -> ctypes.CDLL:
    """The kernel library, built if needed, with argtypes declared. With
    `src_dir`, another copy of csrc/ with the same entry points (an
    earlier checkout's or an edited one, for an A/B on the card), the
    library built from it becomes the one every wrapper launches. An
    entry point that such a copy lacks is left undeclared; the package's
    own library (no `src_dir`, or `src_dir` the package's csrc/) must have
    every entry point of _SIGNATURES, or load raises naming the missing
    ones."""
    global _lib
    if _lib is None or src_dir is not None:
        own = src_dir is None or Path(src_dir).resolve() == SRC_DIR.resolve()
        path = build(src_dir)
        lib = ctypes.CDLL(str(path))
        missing = []
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is None:  # an earlier checkout's library may lack it
                missing.append(name)
                continue
            fn.argtypes = argtypes
            fn.restype = restype
        if own and missing:
            raise RuntimeError(
                f"the kernel library {path.name} lacks entry points of "
                f"_SIGNATURES: {', '.join(missing)}")
        _lib = lib
    return _lib
