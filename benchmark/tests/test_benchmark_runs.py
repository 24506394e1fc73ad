"""A run of each cell on the CPU at a tiny batch (the port's plain
kernels): its result line has the contract's keys and comes out correct;
and with the timed path broken underneath, as each fault the cell can
have, `correct` comes out false."""
import json

import pytest
import torch

from benchmark import run
from benchmark.entries import sweep as sweep_entry

PORT = "quadrupedwholebodycontroller_tpu_torch"
SEED = 2**31 + 977
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def small_sweep(monkeypatch):
    """Sweep episodes short enough for the CPU."""
    monkeypatch.setattr(sweep_entry, "REF_LEAD", 4)
    monkeypatch.setattr(sweep_entry, "CHECKED", 2)
    spec = run.cell_spec

    def short(root, name):
        bench, cell, entry, config, traffic = spec(root, name)
        if config["entry"] == "sweep":
            traffic = dict(traffic, episode_steps=8, speed_from_step=1)
            config = dict(config, warmup_steps=2)
        return bench, cell, entry, config, traffic
    monkeypatch.setattr(run, "cell_spec", short)


def _run(cell, trace=False):
    return run.run_cell(cell, SEED, 0.2, trace, device="cpu", batch=2)


@pytest.mark.parametrize("cell", ["step.walk", "sweep.walk"])
def test_a_sound_run_is_correct(cell, small_sweep):
    r = _run(cell)
    assert list(r)[:5] == KEYS and list(r)[-1] == "compared"
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] >= 0
    assert "setup_s" in r["metrics"] and "scenario_steps_per_s" in r["metrics"]
    json.dumps(r)


def test_a_traced_run_reports_per_layer_metrics(small_sweep):
    r = _run("step.walk", trace=True)
    assert "step_ms_median" in r["metrics"] and "host_syncs_per_step" in r["metrics"]
    assert "busy_s" in r["device"] and "window_s" in r["device"] and "breakdown" in r


def test_a_traced_sweep_run_traces_after_the_window(small_sweep):
    r = _run("sweep.walk", trace=True)
    assert r["correct"], r["compared"]
    assert "host_syncs_per_step" in r["metrics"] and r["device"]["window_s"] > 0
    assert "scenario_steps_per_s" not in r["metrics"]


def _stale(step):
    """A step that returns its state unchanged: the first answer, again."""
    first = {}

    def broken(model, cp, qpp, obs, ref, carry, *a, **kw):
        if "out" not in first:
            first["out"] = step(model, cp, qpp, obs, ref, carry, *a, **kw)
            return first["out"]
        out = first["out"]
        return (out[0], carry) + tuple(out[2:])
    return broken


def _half(step):
    """Half of the batch left out: its answers are zeros."""
    def broken(*a, **kw):
        out = step(*a, **kw)
        o, c = out[0], out[1]
        h = o.tau.shape[0] // 2
        zero = lambda t: torch.cat([t[:h], torch.zeros_like(t[h:])])
        o = o._replace(tau=zero(o.tau), qp_x=zero(o.qp_x))
        c = c._replace(qp_warm=c.qp_warm._replace(x=zero(c.qp_warm.x), y=zero(c.qp_warm.y)))
        return (o, c) + tuple(out[2:])
    return broken


def _altered(step):
    """An answer altered where it is produced: one torque off by 5 N m."""
    def broken(*a, **kw):
        out = step(*a, **kw)
        tau = out[0].tau.clone()
        tau[0, 0] += 5.0
        return (out[0]._replace(tau=tau),) + tuple(out[1:])
    return broken


def _sim_stale(sim):
    return lambda model, state, *a, **kw: state


def _sim_half(sim):
    def broken(model, state, *a, **kw):
        new = sim(model, state, *a, **kw)
        h = state.q.shape[0] // 2
        return type(new)(*(torch.cat([n[:h], s[h:]]) for n, s in zip(new, state)))
    return broken


def _sim_off(sim):
    """The simulator's velocities off by 1%."""
    def broken(*a, **kw):
        new = sim(*a, **kw)
        return new._replace(u=new.u * 1.01)
    return broken


def _planner_stale(plan):
    """A planner that returns its state unchanged."""
    def broken(params, state, cmd):
        return (state,) + tuple(plan(params, state, cmd)[1:])
    return broken


def _loop_half(tree_where):
    """A loop that stops carrying half of the batch forward: the second
    half keeps its state and controller carry, as if it had fallen."""
    def broken(mask, new, old):
        if type(new).__name__ in ("SimState", "WBCCarry"):
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = False
        return tree_where(mask, new, old)
    return broken


FAULTS = [
    ("step.walk", "control.wbc.wbc_step_batched", _stale),
    ("step.walk", "control.wbc.wbc_step_batched", _half),
    ("step.walk", "control.wbc.wbc_step_batched", _altered),
    ("sweep.walk", "sim.world.sim_control_period", _sim_stale),
    ("sweep.walk", "sim.world.sim_control_period", _sim_half),
    ("sweep.walk", "sim.world.sim_control_period", _sim_off),
    ("sweep.walk", "control.wbc.wbc_step_batched", _altered),
    ("sweep.walk", "control.wbc.wbc_step_batched", _half),
    ("sweep.walk", "planner.gait.planner_step", _planner_stale),
    ("sweep.walk", "sim.rollout.tree_where", _loop_half),
]


def plant(monkeypatch, where, fault):
    import importlib

    mod_name, attr = where.rsplit(".", 1)
    mod = importlib.import_module(f"{PORT}.{mod_name}")
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))


@pytest.mark.parametrize("cell,where,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, where, fault, small_sweep, monkeypatch):
    plant(monkeypatch, where, fault)
    r = _run(cell)
    assert not r["correct"], r["compared"]


def test_the_trot_episode_runs_through_the_sweep_entry(small_sweep):
    """The trot traffic, which no cell runs until the trot's non-finite
    torques are mended, still drives the sweep entry and its check."""
    _, _, _, config, _ = run.cell_spec(run.ROOT, "sweep.walk")
    traffic = dict(run.load_json(f"{run.HERE}/traffic/episode_trot.json"), episode_steps=8,
                   speed_from_step=1)
    c = sweep_entry.Cell(dict(config, batch=2, warmup_steps=2), traffic, SEED, "cpu")
    record = c.window(0.2, lambda: None)
    c.release()
    numbers = c.check()
    assert record["control_steps"] >= 1 and numbers["freeze_mismatch"] == 0
    assert numbers["planner_gap"] < 1e-5 and numbers["sim_gap_q99"] < 1e-4
