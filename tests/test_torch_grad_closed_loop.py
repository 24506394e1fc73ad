"""The gradient through the port's single-robot closed loop against
`jax.grad` through the JAX package's: the tracking cost of
`tests/test_differentiability.py` (the static walk standing still:
`closed_loop_rollout`, `QPSolverParams(iterations=40, polish=False)`,
`SimParams(substeps=4)`, float64) as a function of log kp, from kp = 600,
against `jax.value_and_grad`'s.

At T = 10 the value is held to 1e-10 and d/d log kp to 1e-6 relative
(they read 1e-12 and 3e-10).  At T = 16 the value is held to 1e-7 and the
derivative to 2e-4 relative (they read 1.2e-8 and 6.5e-5): the feet
chatter on the normal force's clamp max(fz, 0) (a foot is clamped in
about half the substeps) and the loop amplifies rounding (d tau / d log kp
grows about tenfold a step, to 2e8 N m at step 15), so from step 10 on
the JAX package's own value moves by 7.5e-9 relative and its derivative
by 4e-5 when log kp moves by 1e-13, and two implementations that round
differently part by as much.  Both horizons come from one 16-step rollout
a side: the first 10 steps of the trace are the 10-step rollout's.

One sign step of log kp lowers the cost on the port, as the JAX test
asserts; at T = 30 the port's derivative is finite.  One control step's
gradients are held in `tests/test_torch_grad_control_step.py`.  The JAX
function is traced once a module."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.config import PlannerParams as JaxPlannerParams
from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQPSolverParams
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.sim import SimParams as JaxSimParams
from quadrupedwholebodycontroller_tpu.sim import closed_loop_rollout as jax_closed_loop
from quadrupedwholebodycontroller_tpu.sim.rollout import init_rollout_carry as jax_init
from quadrupedwholebodycontroller_tpu_torch.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import kernels
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams, rollout

F64 = dict(dtype=torch.float64, device="cpu")
LOG_KP0 = float(np.log(600.0))
HORIZONS = (10, 16)
VALUE_TOL = {10: 1e-10, 16: 1e-7}
GRAD_TOL = {10: 1e-6, 16: 2e-4}
CLOSED_LOOP_QP = dict(iterations=40, polish=False)
_RUN = {}


def _port_costs(log_kp, T):
    """The tracking cost of the first t control steps, for t in HORIZONS
    (or for T alone when T is not the longest of them)."""
    model, pp = anymal_d_model(**F64), PlannerParams()
    cp = ControllerParams(kp=torch.exp(log_kp))
    carry = rollout.init_rollout_carry(model, cp, 1, pp, **F64)
    _, tr = rollout.closed_loop_rollout(model, cp, pp, QPSolverParams(**CLOSED_LOOP_QP),
                                        SimParams(substeps=4), carry,
                                        torch.zeros((1, T, 3), **F64))
    err2 = (tr.com_pose[0, :, :3] - tr.ref_com_pose[0, :, :3]) ** 2
    horizons = HORIZONS if T == max(HORIZONS) else (T,)
    return [torch.mean(err2[:t]) for t in horizons]


def _closed_loop():
    if "loop" not in _RUN:
        torch.set_num_threads(1)
        log_kp = torch.tensor(LOG_KP0, requires_grad=True, **F64)
        kernels.reset_counts()
        costs = _port_costs(log_kp, max(HORIZONS))
        grads = [torch.autograd.grad(c, log_kp, retain_graph=True)[0].item() for c in costs]
        port = ([c.item() for c in costs], grads, kernels.plain_counts())

        jm, jpp = jax_model(dtype=jnp.float64), JaxPlannerParams()

        def jcosts(lk):
            cp = JaxControllerParams(kp=jnp.exp(lk))
            carry = jax_init(jm, cp, jpp, dtype=jnp.float64)
            _, tr = jax_closed_loop(jm, cp, jpp, JaxQPSolverParams(**CLOSED_LOOP_QP),
                                    JaxSimParams(substeps=4), carry,
                                    jnp.zeros((max(HORIZONS), 3), jnp.float64))
            err = tr.com_pose[:, :3] - tr.ref_com_pose[:, :3]
            c = jnp.stack([jnp.mean(err[:t] ** 2) for t in HORIZONS])
            return c, c

        jgrad, jval = jax.jit(jax.jacrev(jcosts, has_aux=True))(jnp.asarray(LOG_KP0))
        _RUN["loop"] = (port, (np.asarray(jval), np.asarray(jgrad)))
    return _RUN["loop"]


def test_closed_loop_cost_matches_jax():
    (vals, grads, plain), (jvals, jgrads) = _closed_loop()
    assert not any(plain.values()), plain
    for i, t in enumerate(HORIZONS):
        assert abs(vals[i] - jvals[i]) <= VALUE_TOL[t] * abs(jvals[i]), (t, vals, jvals)
        assert np.isfinite(grads[i]) and grads[i] != 0.0
        rel = abs(grads[i] - jgrads[i]) / abs(jgrads[i])
        assert rel <= GRAD_TOL[t], (t, grads[i], jgrads[i], rel)


def test_one_sign_step_lowers_the_cost():
    (vals, grads, _), _ = _closed_loop()
    i16 = HORIZONS.index(16)
    with torch.no_grad():
        step = torch.tensor(LOG_KP0 - 0.3 * np.sign(grads[i16]), **F64)
        val2 = _port_costs(step, 16)[i16].item()
    assert val2 < vals[i16], (vals[i16], val2, grads[i16])


def test_gradient_finite_long_horizon():
    log_kp = torch.tensor(LOG_KP0, requires_grad=True, **F64)
    (cost,) = _port_costs(log_kp, 30)
    (grad,) = torch.autograd.grad(cost, log_kp)
    assert np.isfinite(grad.item()) and grad.item() != 0.0
