"""The judge against broken programs and against the control, on the CPU
at a size a test run holds (8^3 cells, 2,048 atoms, 40 steps), under the
limits of the cells of BENCHMARK.json.

Each fault breaks the program underneath the harness, which runs as in a
benchmark run but without the look for a card: a step that returns its
state unchanged, half of the atoms' forces left out, an answer (one
atom's force) altered where it is produced, and (on the verlet scheme) one
pair inside the cutoff left out of every force, as a neighbour rebuild
that loses a pair near the cutoff would. One card holds every cell, so
no exchange between chips can be left out. The control is the reference
in the program's place, one step of precision lower (the pair term in
bfloat16)."""

import json
import time

import pytest
import torch

from portbench import control, harness
from portbench.reference.lattice import box_lengths

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


# the cells' traffic, and the cluster scheme's engine on the same limits
TRAFFIC = [(name, {}) for name in CELLS] + [
    (CELLS[0], {"scheme": "cluster", "kernel": "auto"})]


def tiny(name, **traffic):
    cell = harness.find_cell(BENCH, name)
    return cell._replace(cfg=dict(cell.cfg, nx=8, ny=8, nz=8, ntimes=40, name="tiny"),
                         work=dict(cell.work, **traffic))


def run(cell):
    return harness.run_cell(cell, 2**31 + 5, 0.5, False, "cpu", time.perf_counter())


def halve(f3):
    return tuple(torch.cat([f[: f.shape[0] // 2], torch.zeros_like(f[f.shape[0] // 2:])])
                 for f in f3)


def alter(f3):
    f3 = tuple(f.clone() for f in f3)
    f3[0].view(-1)[3] += 0.01 * float(f3[0].abs().max())
    return f3


def break_program(monkeypatch, scheme, fault, cfg):
    from mdbench_tpu_torch import engine, engine_cluster

    if scheme == "cluster":
        cls = engine_cluster.ClusterSimulation
        if fault == "unchanged":
            monkeypatch.setattr(cls, "_kick_drift", lambda self, state: None)
            monkeypatch.setattr(cls, "_kick", lambda self, state, f3: state)
            return
        force = cls._force_from
        wrap = halve if fault == "half" else alter
        monkeypatch.setattr(cls, "_force_from", lambda self, *a: wrap(force(self, *a)))
        return
    if fault == "unchanged":
        monkeypatch.setattr(engine, "initial_integrate", lambda x, v, *a: (x, v))
        monkeypatch.setattr(engine, "final_integrate", lambda v, *a: v)
        return
    force = engine.Simulation._force
    if fault == "pair":
        box = torch.tensor(box_lengths(cfg), dtype=torch.float64)

        def dropped(self, x, *a):
            f, n = force(self, x, *a), self.nlocal
            f[:n] = control.drop_edge_pair(x[:n], f[:n], box, cfg)[0]
            return f

        monkeypatch.setattr(engine.Simulation, "_force", dropped)
        return
    wrap = halve if fault == "half" else alter
    monkeypatch.setattr(engine.Simulation, "_force",
                        lambda self, *a: torch.stack(wrap(force(self, *a).unbind(1)), 1))


@pytest.mark.parametrize("name,traffic", TRAFFIC)
def test_sound_program_is_correct(name, traffic):
    r = run(tiny(name, **traffic))
    assert r["correct"] and r["failed"] == 0, r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name,traffic", TRAFFIC)
def test_broken_program_is_not_correct(monkeypatch, name, traffic, fault):
    cell = tiny(name, **traffic)
    break_program(monkeypatch, cell.work["scheme"], fault, cell.cfg)
    r = run(cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_a_lost_pair_fails_force_rel(monkeypatch, name):
    cell = tiny(name)
    break_program(monkeypatch, cell.work["scheme"], "pair", cell.cfg)
    r = run(cell)
    force = r["checks"]["force_rel"]
    assert not r["correct"] and force["value"] > force["limit"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny(name)
    got = control.readings(cell, 17, "control", torch.device("cpu"))
    limits = cell.work["limits"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cells_on_the_card(card, name):
    r = harness.run_cell(tiny(name), 3, 0.5, False, card, time.perf_counter())
    assert r["correct"], r["checks"]
    got = control.readings(tiny(name), 3, "control", card)
    assert any(got[k] > v for k, v in tiny(name).work["limits"].items()), got
