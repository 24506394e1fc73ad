"""The single robot's closed loops of the port against the JAX package's:

  * `sim.rollout.closed_loop_rollout` (static walk, planner every 4 control
    steps) on B = 2 against `jax.vmap(closed_loop_rollout)`, T = 12:
    scenario 0 stands, scenario 1 is commanded to walk at 0.5 m/s;
  * `trot_rollout` (planner every control step) on B = 2 against
    `jax.vmap(trot_rollout)`, T = 8: scenario 0 stands, scenario 1 is
    commanded to trot at 0.3 m/s;
  * the port's `batched_rollout(qp_backend="torch")` against its `rollout`
    over the static-walk window, in which nothing falls and no rescue
    fires: the batch-level and the single-sample rescue then do the same
    work, and the two loops give the same trace.

float64, both sides from the same start (the JAX carry carried across
through `convert`); every trace leaf and the final simulator state to 1e-8
absolute (the same algorithm in another summation order).  Each JAX loop is
traced once a module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.config import PlannerParams as JaxPlannerParams
from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQPSolverParams
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.planner import trot as jtrot
from quadrupedwholebodycontroller_tpu.sim import SimParams as JaxSimParams
from quadrupedwholebodycontroller_tpu.sim import rollout as jrollout
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import kernels
from quadrupedwholebodycontroller_tpu_torch.planner import gait, trot
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams, rollout

B = 2
T = {"walk": 12, "trot": 8}
SPEED = {"walk": 0.5, "trot": 0.3}
ATOL = 1e-8
LEAVES = ["com_pos", "com_pose", "base_p", "q", "tau", "grf", "foot_pos", "ref_com_pose",
          "ref_swing_pos", "contacts", "qp_kkt"]
_RUN = {}


def _commands(loop):
    cmds = np.zeros((B, T[loop], 3))
    cmds[1, :, 0] = SPEED[loop]
    return cmds


def _run(loop):
    if loop in _RUN:
        return _RUN[loop]
    torch.set_num_threads(1)
    jdt = jnp.float64
    jm, jcp, jq, jsp = jax_model(dtype=jdt), JaxControllerParams(), JaxQPSolverParams(), \
        JaxSimParams()
    tm, tcp, tq, tsp = anymal_d_model(torch.float64, "cpu"), ControllerParams(), \
        QPSolverParams(), SimParams()
    if loop == "walk":
        jpp, pp = JaxPlannerParams(), PlannerParams()
        jcarry = jrollout.init_rollout_carry(jm, jcp, jpp, dtype=jdt)
        jfn = lambda c, x: jrollout.closed_loop_rollout(jm, jcp, jpp, jq, jsp, c, x)
        tfn = lambda c, x: rollout.closed_loop_rollout(tm, tcp, pp, tq, tsp, c, x)
    else:
        jtp, tp = jtrot.TrotParams(), trot.TrotParams()
        jcarry = jrollout.init_rollout_carry(jm, jcp, dtype=jdt,
                                             planner_state=jtrot.init_trot_state(jtp, jdt))
        jfn = lambda c, x: jrollout.trot_rollout(jm, jcp, jtp, jq, jsp, c, x)
        tfn = lambda c, x: rollout.trot_rollout(tm, tcp, tp, tq, tsp, c, x)
    carry0 = jax.tree.map(lambda x: jnp.stack([x] * B), jcarry)
    jout = jax.jit(jax.vmap(jfn))(carry0, jnp.asarray(_commands(loop)))
    start = convert.rollout_carry_from_numpy(jax.tree.map(np.asarray, carry0),
                                             torch.float64, "cpu")
    kernels.reset_counts()
    tout = tfn(start, torch.as_tensor(_commands(loop)))
    _RUN[loop] = dict(jax=jax.tree.map(np.asarray, jout), port=convert.to_numpy(tout),
                      start=start, plain=kernels.plain_counts())
    return _RUN[loop]


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("loop", list(T))
def test_trace_matches_jax(loop, leaf):
    r = _run(loop)
    want, got = getattr(r["jax"][1], leaf), getattr(r["port"][1], leaf)
    assert got.shape == want.shape, (leaf, got.shape, want.shape)
    assert np.abs(got - want).max() <= ATOL, (leaf, np.abs(got - want).max())


@pytest.mark.parametrize("loop", list(T))
def test_final_state_matches_jax(loop):
    r = _run(loop)
    for leaf in ("base_R", "base_p", "q", "u", "anchor"):
        want, got = getattr(r["jax"][0].sim, leaf), getattr(r["port"][0].sim, leaf)
        assert np.abs(got - want).max() <= ATOL, (leaf, np.abs(got - want).max())
    want, got = r["jax"][0].wbc.qp_warm.x, r["port"][0].wbc.qp_warm.x
    assert np.abs(got - want).max() <= ATOL


@pytest.mark.parametrize("loop", list(T))
def test_the_loop_is_tensor_code_and_certifies(loop):
    """No kernel's plain version ran (the single robot's loop launches no
    kernel); the QPs certify, the robots stay up, and the walking scenario
    of the static walk lifts a leg."""
    r = _run(loop)
    assert not any(r["plain"].values()), r["plain"]
    trace = r["port"][1]
    assert trace.qp_kkt.max() < 1e-6 and (trace.com_pos[..., 2] > 0.4).all()
    if loop == "walk":
        assert (trace.contacts[1] == 0).any() and (trace.contacts[0] == 1).all()


def test_batched_rollout_on_the_torch_backend_equals_the_single_robot_loop():
    r = _run("walk")
    tm, tcp, tq, pp = anymal_d_model(torch.float64, "cpu"), ControllerParams(), \
        QPSolverParams(), PlannerParams()
    cmds = torch.as_tensor(_commands("walk"))
    _, batched = rollout.batched_rollout(
        tm, tcp, tq, SimParams(), lambda s, c: gait.planner_step(pp, s, c), 4, r["start"],
        cmds, qp_backend="torch")
    single = r["port"][1]
    # nothing fell (a frozen scenario would record a zero torque) and no
    # rescue fired
    assert (np.abs(single.tau).max(-1) > 0).all() and single.qp_kkt.max() < 3e-3
    for leaf in LEAVES:
        got = getattr(batched, leaf).numpy()
        assert np.abs(got - getattr(single, leaf)).max() <= 1e-12, leaf
