"""The kernel build of mdbench_tpu_torch/_build.py with a stand-in nvcc (a
shell script): one compile per csrc/*.cu source, then one link of the
objects into the library; the compilers' output kept beside the
library; the objects removed; a failed compile raising with its output;
the C entry points of csrc/*.cu against their ctypes signatures; and
load() with a stand-in library: strict for the package's own library,
skipping what another checkout's lacks. The real nvcc runs only on a
machine with the CUDA toolkit."""

import ctypes
import re
import stat
import types

import pytest

from mdbench_tpu_torch import _build

FAKE_NVCC = """#!/bin/sh
# record the call, then write the -o target (exit 3 for a marked source)
echo "$@" >> "{calls}"
out=""
prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
  case "$a" in *broken.cu) echo "error: broken source"; exit 3;; esac
done
echo "ptxas info    : Used 32 registers"
touch "$out"
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    calls = tmp_path / "calls.txt"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(calls=calls))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return src, calls


def test_build_compiles_each_source_then_links(fake_toolkit):
    src, calls = fake_toolkit
    for name in ("a.cu", "b.cu"):
        (src / name).write_text(f"// {name}\n")
    lib = _build.build()
    assert lib == _build.library_path() and lib.exists()
    lines = calls.read_text().splitlines()
    assert len(lines) == 3
    # the compiles run in parallel and log in the order they finish
    compiles, link = sorted(lines[:2], key=lambda line: line.split()[-1]), lines[2]
    for line, name in zip(compiles, ("a.cu", "b.cu")):
        assert " -c " in f" {line} " and line.endswith(name)
        assert "arch=compute_90a,code=sm_90a" in line
    assert "-shared" in link and link.count(".o") == 2
    log = lib.with_suffix(".log").read_text()
    assert log.count("ptxas info") == 2
    assert sorted(p.suffix for p in lib.parent.iterdir()) == [".log", ".so"]
    assert _build.build() == lib  # cached: no new call
    assert len(calls.read_text().splitlines()) == 3
    # an edited source is another library
    (src / "b.cu").write_text("// b, edited\n")
    assert _build.library_path() != lib


def test_build_raises_with_the_compiler_output(fake_toolkit):
    src, _ = fake_toolkit
    (src / "a.cu").write_text("// a\n")
    (src / "broken.cu").write_text("// broken\n")
    with pytest.raises(RuntimeError, match="error: broken source"):
        _build.build()
    assert not _build.library_path().exists()
    assert not list(_build.BUILD_DIR.glob("*.o"))


def test_headers_are_hashed_not_compiled(fake_toolkit):
    """csrc/*.cuh are headers the sources include: an edited header is
    another library, and a build compiles the sources alone."""
    src, calls = fake_toolkit
    (src / "a.cu").write_text('#include "h.cuh"\n')
    (src / "h.cuh").write_text("// h\n")
    lib = _build.library_path()
    (src / "h.cuh").write_text("// h, edited\n")
    assert _build.library_path() != lib
    _build.build()
    compiles, link = calls.read_text().splitlines()
    assert compiles.endswith("a.cu") and "-shared" in link


def test_build_from_another_source_dir(fake_toolkit, tmp_path):
    """build(src_dir) compiles another copy of csrc/ (an A/B's variant)
    into a library of its own beside the package's, and leaves the
    package's sources alone."""
    src, calls = fake_toolkit
    (src / "a.cu").write_text("// a\n")
    other = tmp_path / "variant"
    other.mkdir()
    (other / "a.cu").write_text("// a, a variant\n")
    mine, theirs = _build.build(), _build.build(other)
    assert mine == _build.library_path() and theirs == _build.library_path(other)
    assert mine != theirs and mine.exists() and theirs.exists()
    compiled = [line.split()[-1] for line in calls.read_text().splitlines()
                if " -c " in f" {line} "]
    assert compiled == [str(src / "a.cu"), str(other / "a.cu")]


def _c_argtype(decl: str):
    """The ctypes type of one C parameter declaration of an entry point."""
    decl = decl.strip()
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.split()[-2]
    return {"int": ctypes.c_int, "float": ctypes.c_float,
            "double": ctypes.c_double}[kind]


def test_signatures_match_the_sources():
    """Every extern "C" entry point of csrc/*.cu has its ctypes signature in
    _build._SIGNATURES, argument by argument (a pointer, int, float or
    double each), and every signature there names an entry point: a
    mismatch would pass arguments the kernel reads as something else."""
    found = {}
    for src in _build.sources():
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[m.group(1)] = [_c_argtype(a) for a in m.group(2).split(",")]
    assert {"lj_cluster_ilist_bf16", "row_fetch_f32"} <= set(found)
    assert set(found) == set(_build._SIGNATURES)
    for name, args in found.items():
        assert _build._SIGNATURES[name] == (args, ctypes.c_int), name


class _StandInLib:
    """What ctypes.CDLL returns for a library that has every entry point of
    _SIGNATURES except those in `lacks`."""

    def __init__(self, lacks=()):
        for name in _build._SIGNATURES:
            if name not in lacks:
                setattr(self, name, types.SimpleNamespace())


@pytest.fixture
def stand_in(monkeypatch, tmp_path):
    """load() with no library loaded yet, build() a no-op and ctypes.CDLL
    returning a stand-in; the fixture's value sets what the stand-in
    lacks and records the paths CDLL was given."""
    opened = []
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda src_dir=None: tmp_path / "libstandin.so")

    def use(lacks=()):
        def cdll(path):
            opened.append(path)
            return _StandInLib(lacks)
        monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
        return opened
    return use


@pytest.mark.parametrize("lacks", [("row_fetch_f32",),
                                   ("lj_cluster_ilist_bf16", "eam_nlist_blocks_per_sm")])
def test_load_raises_when_the_own_library_lacks_an_entry(stand_in, lacks):
    """The package's own library (no src_dir, or src_dir its own csrc/)
    must hold every entry point of _SIGNATURES: load raises at once,
    naming each missing one, and keeps no library."""
    stand_in(lacks)
    for args in ((), (_build.SRC_DIR,)):
        with pytest.raises(RuntimeError) as err:
            _build.load(*args)
        for name in lacks:
            assert name in str(err.value)
        assert _build._lib is None


def test_load_from_another_source_dir_skips_a_missing_entry(stand_in, tmp_path):
    """Another checkout's csrc/ (an A/B's) may lack a newer entry point:
    its library loads, the entry stays undeclared, the others get their
    signatures, and it becomes the library the wrappers launch."""
    opened = stand_in(("row_fetch_f32",))
    lib = _build.load(tmp_path / "earlier_csrc")
    assert _build._lib is lib and opened == [str(tmp_path / "libstandin.so")]
    assert not hasattr(lib, "row_fetch_f32")
    argtypes, restype = _build._SIGNATURES["lj_cluster_ilist_bf16"]
    assert lib.lj_cluster_ilist_bf16.argtypes == argtypes
    assert lib.lj_cluster_ilist_bf16.restype == restype
    assert _build.load() is lib  # loaded once per process


def test_load_declares_every_entry_of_a_whole_library(stand_in):
    opened = stand_in()
    lib = _build.load()
    for name, (argtypes, restype) in _build._SIGNATURES.items():
        fn = getattr(lib, name)
        assert (fn.argtypes, fn.restype) == (argtypes, restype), name
    assert _build.load() is lib and len(opened) == 1
