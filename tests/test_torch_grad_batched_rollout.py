"""The gradient through the port's batched closed loop on its tensor-code
backend, `sim.rollout.batched_rollout(qp_backend="torch")`, against
`jax.grad` through the JAX package's `batched_rollout(qp_backend="xla")`,
which carries one: B = 2 scenarios of the static walk (scenario 1
commanded to 0.5 m/s), T = 6 control steps (the planner ticks at steps 0
and 4), float64, both from the same start (the JAX carry carried across
through `convert`).  The loss is sum(tau^2) + 1e4 sum(com error^2) over
the trace; its value is held to 1e-10 relative and d/d kp, d/d kd_swing to
1e-8 relative.  Shipped solver parameters with the rescue off (its
gradient is held by `tests/test_torch_grad_qp.py`; its trace would take
most of the JAX compile).  The JAX function is traced once."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.config import PlannerParams as JaxPlannerParams
from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQPSolverParams
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.planner import gait as jgait
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
from quadrupedwholebodycontroller_tpu_torch.planner import gait
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams, rollout

B, T = 2, 6
QP = dict(rescue_threshold=0.0)
GAINS = ("kp", "kd_swing")
_RUN = {}


def _commands():
    cmds = np.zeros((B, T, 3))
    cmds[1, :, 0] = 0.5
    return cmds


def _loss(tau, com_pose, ref_com_pose, xp):
    return xp.sum(tau ** 2) + 1e4 * xp.sum((com_pose[..., :3] - ref_com_pose[..., :3]) ** 2)


def _run():
    if _RUN:
        return _RUN
    torch.set_num_threads(1)
    jm, jpp, d = jax_model(dtype=jnp.float64), JaxPlannerParams(), JaxControllerParams()
    carry0 = jax.tree.map(lambda x: jnp.stack([x] * B),
                          jrollout.init_rollout_carry(jm, d, jpp, dtype=jnp.float64))
    cmds = jnp.asarray(_commands())

    def jloss(kp, kd_swing):
        cp = dataclasses.replace(d, kp=kp, kd_swing=kd_swing)
        _, tr = jrollout.batched_rollout(
            jm, cp, JaxQPSolverParams(**QP), JaxSimParams(),
            lambda s, c: jgait.planner_step(jpp, s, c), 4, carry0, cmds, qp_backend="xla")
        return _loss(tr.tau, tr.com_pose, tr.ref_com_pose, jnp)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        *(jnp.asarray(getattr(d, g)) for g in GAINS))

    f64 = dict(dtype=torch.float64, device="cpu")
    gains = [torch.tensor(getattr(ControllerParams(), g), requires_grad=True, **f64)
             for g in GAINS]
    cp = dataclasses.replace(ControllerParams(), **dict(zip(GAINS, gains)))
    pp = PlannerParams()
    start = convert.rollout_carry_from_numpy(jax.tree.map(np.asarray, carry0), **f64)
    kernels.reset_counts()
    _, tr = rollout.batched_rollout(
        anymal_d_model(**f64), cp, QPSolverParams(**QP), SimParams(),
        lambda s, c: gait.planner_step(pp, s, c), 4, start, torch.as_tensor(_commands()),
        qp_backend="torch")
    val = _loss(tr.tau, tr.com_pose, tr.ref_com_pose, torch)
    grads = torch.autograd.grad(val, gains)
    _RUN.update(
        value=(val.item(), float(jval)),
        grads={g: (got.item(), float(want)) for g, got, want in zip(GAINS, grads, jgrads)},
        counts=(kernels.launch_counts(), kernels.plain_counts()))
    return _RUN


def test_value_matches_jax():
    got, want = _run()["value"]
    assert abs(got - want) <= 1e-10 * abs(want), (got, want)


@pytest.mark.parametrize("gain", GAINS)
def test_gradient_matches_jax(gain):
    got, want = _run()["grads"][gain]
    assert want != 0.0
    assert abs(got - want) <= 1e-8 * abs(want), (got, want)


def test_the_loop_is_tensor_code():
    launches, plain = _run()["counts"]
    assert not any(launches.values()) and not any(plain.values())
