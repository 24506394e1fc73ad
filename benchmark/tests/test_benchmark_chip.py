"""On the card (marked `chip`; skips without one): a short run of a cell
comes out correct; its control, the reference in the program's place
with TF32 products, comes out as not correct; and so does a run of the
sweep cell with a fault planted in its loop, at the cell's own size."""
import os

import pytest

from benchmark import control, run
from benchmark.tests import test_benchmark_runs as runs

pytestmark = pytest.mark.chip
CELLS = [w["name"] for w in run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))["workloads"]]


def _limits(cell):
    return run.load_json(os.path.join(run.HERE, "limits", cell + ".json"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    r = run.run_cell(cell, 2**31 + 4242, 5.0, False, device=card)
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(card, cell):
    numbers = control.control_numbers(cell, 2**31 + 4243, "tf32", device=card)
    assert any(numbers[k] > v["limit"] for k, v in _limits(cell).items()), numbers


@pytest.mark.parametrize("where,fault", [
    ("sim.world.sim_control_period", runs._sim_off),
    ("planner.gait.planner_step", runs._planner_stale),
    ("sim.rollout.tree_where", runs._loop_half),
])
def test_a_planted_sweep_fault_is_not_correct(card, where, fault, monkeypatch):
    runs.plant(monkeypatch, where, fault)
    r = run.run_cell("sweep.walk", 2**31 + 4244, 1.0, False, device=card)
    assert not r["correct"], r["compared"]
