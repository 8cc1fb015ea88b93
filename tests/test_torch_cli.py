"""The port's command line against mdbench_tpu's, on the CPU: parse_args
gives mdbench_tpu's Params; 4^3 float64 CLI runs (verlet LJ, verlet EAM,
cluster LJ) print mdbench_tpu's thermo rows (rel 1e-9) in the same line
structure (numbers masked; the port's device line aside); --timers diff;
the checkpoint round trip; the trajectory and tracer outputs at
mdbench_tpu's cadence; a profiled run's trace names the force and
rebuild spans; without a card the default device raises; and the CLI
imports no jax. The writers themselves: tests/test_torch_io.py."""

import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import write_standin_funcfl
from mdbench_tpu import cli as jcli
from mdbench_tpu_torch import cli as tcli
from mdbench_tpu_torch import tracing as ttracing
from mdbench_tpu_torch.io import checkpoint
from mdbench_tpu_torch.io import xtc as txtc

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
ROW = re.compile(r"^(\d+)\t(\S+)\t(\S+)$")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    (d / "nstat.conf").write_text("nstat 20\n")
    write_standin_funcfl(d / "standin.eam")
    return d


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _rows(out: str) -> np.ndarray:
    return np.array([[float(g) for g in m.groups()]
                     for m in map(ROW.match, out.splitlines()) if m])


def _shape(out: str) -> list:
    """The output's lines with every number masked, without the port's
    device line and the timing-dependent note."""
    return [re.sub(r"[-+]?\d[\d.]*(e[-+]?\d+)?", "#", line)
            for line in out.splitlines()
            if not line.startswith(("Device: ", "(note: "))]


@pytest.mark.parametrize("argv", [
    "-f lj -n 50 -nx 4 -ny 5 -nz 6 -half 1 -r 3.0 -s 0.4 --freq 3.0",
    "--scheme cluster --precision sp --kernel pallas",
    "-f eam -e Cu_u3.eam --eam-eval poly --timers diff --trace-index t_ --trace-mem m_",
    "-i atoms.dmp --vtk v --xtc x.xtc -w out.in --profile prof --checkpoint c.npz "
    "--restore r.npz --nsteps 7 --radius 2.0 --skin 0.2 --bogus",
    "PARAMS -n 30",
])
def test_parse_args_matches_jax(argv, files):
    argv = argv.replace("PARAMS", f"-p {files / 'nstat.conf'}").split()
    j, t = jcli.parse_args(argv), tcli.parse_args(argv)
    assert vars(t) == vars(j)


def test_split_device():
    assert tcli.split_device(["-n", "5"]) == ("cuda", ["-n", "5"])
    assert tcli.split_device(["--device", "cpu", "-n", "5"]) == ("cpu", ["-n", "5"])
    with pytest.raises(SystemExit):
        tcli.split_device(["--device", "tpu"])


RUNS = {
    # the verlet LJ run on the row lists (mdbench_tpu takes them on the CPU
    # only by name), verlet EAM on the splines, cluster LJ
    "verlet_lj": "--kernel rowlist",
    "verlet_eam": "-f eam -e EAM",
    "cluster_lj": "--scheme cluster",
}


@pytest.fixture(scope="module", params=list(RUNS))
def cli_pair(request, files):
    argv = (f"-p {files / 'nstat.conf'} -nx 4 -ny 4 -nz 4 -n 40 --precision dp "
            + RUNS[request.param].replace("EAM", str(files / "standin.eam"))).split()
    return request.param, _run(jcli.main, argv), _run(tcli.main, argv + ["--device", "cpu"])


def test_cli_output_matches_jax(cli_pair):
    name, out_j, out_t = cli_pair
    rows_j, rows_t = _rows(out_j), _rows(out_t)
    assert rows_t.shape == (3, 3) and list(rows_t[:, 0]) == [0, 20, 40]
    np.testing.assert_array_equal(rows_t[:, 0], rows_j[:, 0])
    np.testing.assert_allclose(rows_t[:, 1:], rows_j[:, 1:], rtol=1e-9)
    assert _shape(out_t) == _shape(out_j)
    assert "Device: cpu, force: plain torch" in out_t
    assert "million atom updates per second" in out_t


def test_cli_timers_diff(files):
    out = _run(tcli.main, "-nx 4 -ny 4 -nz 4 -n 10 --timers diff --device cpu".split())
    assert "(timers: diff — in-loop differential measurement)" in out
    assert re.search(r"TOTAL \S+s FORCE \S+s NEIGH \S+s REST \S+s", out)


@pytest.mark.parametrize("scheme", ["verlet", "cluster"])
def test_checkpoint_round_trip(tmp_path, scheme):
    """10 steps, checkpoint, 10 restored steps: the last row equals an
    uninterrupted 20-step run's (float64; the restore rebuilds the lists,
    so only the summation order differs)."""
    ck = str(tmp_path / "state.npz")
    base = f"-nx 4 -ny 4 -nz 4 --precision dp --scheme {scheme} --device cpu".split()
    out1 = _run(tcli.main, base + ["-n", "10", "--checkpoint", ck])
    assert f"checkpoint -> {ck}" in out1
    x, v, types, meta = checkpoint.load_checkpoint(ck)
    assert x.shape == (256, 3) and v.shape == (256, 3) and types.dtype == np.int32
    assert meta["step"] == 10 and meta["scheme"] == scheme and meta["natoms"] == 256
    out2 = _run(tcli.main, base + ["-n", "10", "--restore", ck])
    assert f"restored 256 atoms at step 10 from {ck}" in out2
    out3 = _run(tcli.main, base + ["-n", "20"])
    assert _rows(out2)[-1, 1] == pytest.approx(_rows(out3)[-1, 1], rel=1e-9)


def test_profiled_run_names_the_force_span(tmp_path):
    logdir = tmp_path / "prof"
    out = _run(tcli.main, f"-nx 4 -ny 4 -nz 4 -n 4 --profile {logdir} --device cpu"
               .split())
    assert f"profile trace -> {logdir}" in out
    trace = json.loads((logdir / ttracing.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"force", "reneighbor"} <= names


@pytest.mark.parametrize("scheme", ["verlet", "cluster"])
def test_trajectory_and_trace_outputs(tmp_path, scheme):
    """--vtk, --xtc, -w, --trace-index and --trace-mem each write their
    files at the cadence of mdbench_tpu's CLI."""
    pre = str(tmp_path / "o")
    out = _run(tcli.main, (f"-nx 4 -ny 4 -nz 4 -n 10 --scheme {scheme} --device cpu "
                           f"--vtk {pre} --xtc {pre}.xtc -w {pre}.in").split())
    assert "Wrote input data to" in out
    # x_out_every 20 > 10 steps: the frames of step 0 and of the tail's end
    assert [f["step"] for f in txtc.read_xtc(pre + ".xtc")] == [0, 10]
    vtk = sorted(p.name for p in tmp_path.glob("*.vtk"))
    names = (["o"] if scheme == "verlet" else
             ["o_ghost", "o_ghost_edges", "o_local", "o_local_edges"])
    assert vtk == sorted(f"{n}_{s}.vtk" for n in names for s in (0, 10))
    assert len((tmp_path / "o.in").read_text().splitlines()) == 256
    (tmp_path / "re5.conf").write_text("reneigh_every 5\n")
    _run(tcli.main, (f"-nx 4 -ny 4 -nz 4 -n 10 --scheme {scheme} --device cpu "
                     f"-p {tmp_path / 're5.conf'} --trace-index {pre}i_ "
                     f"--trace-mem {pre}m_").split())
    got = sorted(p.name for p in tmp_path.glob("o?_*tracer_*.out"))
    assert got == sorted(f"o{k}_{w}_tracer_{s}.out" for k, w in (("i", "index"),
                                                                 ("m", "mem"))
                         for s in (0, 5, 10))


def test_cuda_default_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(tcli.main, "-nx 4 -ny 4 -nz 4 -n 2".split())


def test_cli_imports_no_jax():
    code = (
        "import sys\n"
        "from mdbench_tpu_torch.cli import main\n"
        "main(['-nx', '4', '-ny', '4', '-nz', '4', '-n', '2', '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mdbench_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
