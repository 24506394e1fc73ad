"""The port's batched planners against the JAX package's jitted, vmapped
steps on the same commands, B = 3, every state leaf, the reference and the
`published` flag after every tick.

Static walk (`planner/gait.planner_step`), 40 ticks with a shortened step
(5 ticks a phase) so that the window covers every branch the JAX function
takes with `lax.cond` / `lax.switch`: standing, a cycle start, publishing
and transition ticks, a cycle's end, the gap tick, a restart and a return to
standing after the command drops to zero (scenario 0 starts at tick 8,
scenario 1 walks throughout with a yaw rate, scenario 2 stops at tick 15).

Trot (`planner/trot.trot_step`), 120 ticks with its 100-tick phase and a
5-tick settle: the settle, a phase change with its new footholds, and a stop
(scenario 2 at tick 60).

float64 to 1e-10, float32 to 1e-5 of each leaf's scale (the same
arithmetic in another order); integers and flags exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import PlannerParams as JaxPlannerParams
from quadrupedwholebodycontroller_tpu.planner import gait as jgait
from quadrupedwholebodycontroller_tpu.planner import trot as jtrot
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import PlannerParams
from quadrupedwholebodycontroller_tpu_torch.planner import gait, trot
from tests._torch_port_util import scaled_err

B = 3
WALK = dict(step_duration=0.05)
TROT = dict(stand_ticks=5)
TICKS = {"walk": 40, "trot": 120}
STOP = {"walk": 15, "trot": 60}
TOL = {"float64": 1e-10, "float32": 1e-5}


def _commands(kind):
    cmd = np.zeros((TICKS[kind], B, 3))
    cmd[8:, 0, 0] = 0.3
    cmd[:, 1] = (0.4, 0.1, 0.3)
    cmd[:STOP[kind], 2, 0] = 0.5
    return cmd


def _leaves(tree, prefix=""):
    """{path: numpy array} over a (nested) NamedTuple."""
    out = {}
    for k, v in zip(tree._fields, tree):
        if hasattr(v, "_fields"):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


_RUNS = {}


def _run(kind, dtype):
    if (kind, dtype) in _RUNS:
        return _RUNS[kind, dtype]
    torch.set_num_threads(1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if kind == "walk":
        jp, tp = JaxPlannerParams(**WALK), PlannerParams(**WALK)
        jstate = jgait.init_planner_state(jp, jdt)
        tstate = gait.init_planner_state(tp, B, tdt, "cpu")
        jstep = jax.jit(jax.vmap(lambda s, c: jgait.planner_step(jp, s, c)))
        tstep = lambda s, c: gait.planner_step(tp, s, c)
    else:
        jp, tp = jtrot.TrotParams(**TROT), trot.TrotParams(**TROT)
        jstate = jtrot.init_trot_state(jp, jdt)
        tstate = trot.init_trot_state(tp, B, tdt, "cpu")
        jstep = jax.jit(jax.vmap(lambda s, c: jtrot.trot_step(jp, s, c)))
        tstep = lambda s, c: trot.trot_step(tp, s, c)
    jstate = jax.tree.map(lambda x: jnp.stack([x] * B), jstate)
    rows = [(_leaves(jstate), _leaves(tstate), None, None)]
    for cmd in _commands(kind):
        jstate, jref, jpub = jstep(jstate, jnp.asarray(cmd, jdt))
        tstate, tref, tpub = tstep(tstate, torch.as_tensor(cmd).to(tdt))
        rows.append(({**_leaves(jstate), **_leaves(jref, "out.")},
                     {**_leaves(tstate), **_leaves(tref, "out.")},
                     np.asarray(jpub), tpub.numpy()))
    _RUNS[kind, dtype] = rows
    return rows


CASES = [(k, d) for k in ("walk", "trot") for d in ("float64", "float32")]


@pytest.mark.parametrize("kind,dtype", CASES)
def test_planner_matches_jax_tick_by_tick(kind, dtype):
    for tick, (want, got, jpub, tpub) in enumerate(_run(kind, dtype)):
        assert set(got) == set(want), tick
        for key, w in want.items():
            g = got[key]
            assert g.shape == w.shape, (tick, key)
            if w.dtype.kind in "iub":
                assert np.array_equal(g, w), (tick, key)
            else:
                assert scaled_err(g, w) <= TOL[dtype], (tick, key, scaled_err(g, w))
        if jpub is not None:
            assert np.array_equal(tpub, jpub), tick


def test_walk_window_covers_every_branch():
    rows = _run("walk", "float64")
    modes = np.stack([got["mode"] for _, got, _, _ in rows])          # (ticks + 1, B)
    pub = np.stack([p for _, _, _, p in rows[1:]])
    cycles = rows[-1][1]["cycle_counter"]
    assert (modes[:9, 0] == gait.IDLE).all() and (modes[9:, 0] != gait.IDLE).any()
    assert (modes == gait.CYCLE_GAP).any(axis=0).all()                # every gait ends a cycle
    assert cycles[1] >= 1 and not pub.all() and pub.any(axis=0).all()
    assert (modes[-1, 2] == gait.IDLE) and rows[-1][1]["ref.contacts"][2].all()


def test_trot_window_covers_settle_and_phase_changes():
    rows = _run("trot", "float64")
    phases = np.stack([got["phase"] for _, got, _, _ in rows])
    contacts = np.stack([got["out.contacts"] for _, got, _, _ in rows[1:]])
    assert contacts[:5].all()                                        # the settle
    assert (np.diff(phases[:, 1]) != 0).sum() >= 1                   # a phase change
    assert not np.array_equal(rows[-1][1]["pf_foot"][1], rows[0][1]["pf_foot"][1])
    assert contacts[-1, 2].all()                                     # stopped: all feet down


def test_planner_state_crosses_through_convert():
    """A JAX state carried across gives the port's state, leaf by leaf."""
    jp = JaxPlannerParams(**WALK)
    js = jax.tree.map(lambda x: np.stack([np.asarray(x)] * B), jgait.init_planner_state(jp, jnp.float64))
    ts = convert.planner_state_from_numpy(js, torch.float64, "cpu")
    want = gait.init_planner_state(PlannerParams(**WALK), B, torch.float64, "cpu")
    for k, v in _leaves(want).items():
        assert np.array_equal(_leaves(ts)[k], v), k
    tt = jtrot.init_trot_state(jtrot.TrotParams(**TROT), jnp.float64)
    tt = jax.tree.map(lambda x: np.stack([np.asarray(x)] * B), tt)
    got = convert.trot_state_from_numpy(tt, torch.float64, "cpu")
    want = trot.init_trot_state(trot.TrotParams(**TROT), B, torch.float64, "cpu")
    assert all(np.array_equal(_leaves(got)[k], v) for k, v in _leaves(want).items())
    assert dataclasses.asdict(trot.TrotParams()) == dataclasses.asdict(jtrot.TrotParams())
    assert dataclasses.asdict(PlannerParams()) == dataclasses.asdict(JaxPlannerParams())
