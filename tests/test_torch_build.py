"""The kernel build of mdbench_tpu_torch/_build.py with a stand-in nvcc (a
shell script): one compile per csrc/*.cu source, then one link of the
objects into the library; the compilers' output kept beside the
library; the objects removed; a failed compile raising with its output.
The real nvcc runs only on a machine with the CUDA toolkit."""

import stat

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
    compiles, link = lines[:2], lines[2]
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
