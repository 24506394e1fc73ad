"""The gradient through one control step of the port, `control.wbc.wbc_step`,
against `jax.grad` through the JAX package's (under `vmap`): B = 2, the
recorded walk's step 40 (its contact switch), the carry of the port's step
39, with exact derivatives off and on.  The derivative of sum(tau^2) with
respect to each of the nine float gains of `ControllerParams`, each a 0-d
tensor, to 1e-8 relative (kp and kd_swing non-zero; max_torque and
friction reach no active row here, and their derivatives are 0 on both
sides), the torques to 1e-9 N m.  Shipped solver parameters with the
rescue off: `tests/test_torch_grad_qp.py` holds the rescue's gradient.
float64; each JAX function is traced once a module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_util import load_walk, make_offsets, step_arrays

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQPSolverParams
from quadrupedwholebodycontroller_tpu.control import wbc as jwbc
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.ops import qp as jqp
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import kernels

F64 = dict(dtype=torch.float64, device="cpu")
GRAD_TOL = 1e-8
QP = dict(rescue_threshold=0.0)
# every float gain of ControllerParams, each a 0-d tensor that requires grad
GAINS = ("kp", "kp_z", "kd", "ki", "kp_swing", "kd_swing", "max_torque", "slack_weight",
         "friction")
MODES = {"finite_differences": False, "exact": True}
_RUN = {}


def _step_inputs(B=2, t=40):
    """numpy (obs, ref, ref_is_new, carry) of recorded step t, per-scenario
    offsets, with the carry the port's step t - 1 leaves (a valid
    finite-difference memory and the previous contacts)."""
    if "inputs" not in _RUN:
        traj, off = load_walk(), make_offsets(np.random.default_rng(4), B)
        model = anymal_d_model(**F64)
        carry = wbc.init_carry(B, **F64)
        with torch.no_grad():
            obs, ref, rin = step_arrays(traj, t - 1, B, off)
            _, carry = wbc.wbc_step(model, ControllerParams(), QPSolverParams(**QP),
                                    convert.obs_from_numpy(obs, **F64),
                                    convert.ref_from_numpy(ref, **F64), carry, rin)
        obs, ref, rin = step_arrays(traj, t, B, off)
        assert rin and (ref["contacts"] != convert.to_numpy(carry.prev_contacts)).any()
        _RUN["inputs"] = (obs, ref, rin, convert.to_numpy(carry))
    return _RUN["inputs"]


def _step_port(exact):
    obs, ref, rin, carry = _step_inputs()
    gains = [torch.tensor(getattr(ControllerParams(), g), requires_grad=True, **F64)
             for g in GAINS]
    cp = ControllerParams(exact_derivatives=exact, **dict(zip(GAINS, gains)))
    kernels.reset_counts()
    out, _ = wbc.wbc_step(anymal_d_model(**F64), cp, QPSolverParams(**QP),
                          convert.obs_from_numpy(obs, **F64), convert.ref_from_numpy(ref, **F64),
                          convert.carry_from_numpy(carry._asdict(), **F64), rin)
    grads = torch.autograd.grad(torch.sum(out.tau ** 2), gains)
    return out.tau.detach().numpy(), [g.item() for g in grads], kernels.plain_counts()


def _step_jax(exact):
    obs, ref, rin, carry = _step_inputs()
    jm = jax_model(dtype=jnp.float64)
    a = lambda x: jnp.asarray(x)
    jobs = jwbc.RobotObservation(**{k: a(obs[k]) for k in jwbc.RobotObservation._fields})
    jref = jwbc.Reference(**{k: a(ref[k]) for k in jwbc.Reference._fields})
    c = carry._asdict()
    jcarry = jwbc.WBCCarry(**{k: a(c[k]) for k in jwbc.WBCCarry._fields if k != "qp_warm"},
                           qp_warm=jqp.QPState(*(a(v) for v in c["qp_warm"])))
    d = JaxControllerParams()

    def loss(*gains):
        cp = dataclasses.replace(d, exact_derivatives=exact, **dict(zip(GAINS, gains)))
        out, _ = jax.vmap(lambda o, r, cc: jwbc.wbc_step(
            jm, cp, JaxQPSolverParams(**QP), o, r, cc, rin))(jobs, jref, jcarry)
        return jnp.sum(out.tau ** 2), out.tau

    (_, tau), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(GAINS))), has_aux=True))(*(a(getattr(d, g)) for g in GAINS))
    return np.asarray(tau), [float(g) for g in grads]


def _run(mode):
    if mode not in _RUN:
        torch.set_num_threads(1)
        _RUN[mode] = (_step_port(MODES[mode]), _step_jax(MODES[mode]))
    return _RUN[mode]


@pytest.mark.parametrize("mode", list(MODES))
def test_torques_match_jax(mode):
    (tau, _, plain), (jtau, _) = _run(mode)
    assert not any(plain.values()), plain
    assert np.abs(tau - jtau).max() <= 1e-9, np.abs(tau - jtau).max()


@pytest.mark.parametrize("gain", GAINS)
@pytest.mark.parametrize("mode", list(MODES))
def test_gradient_matches_jax(mode, gain):
    (_, grads, _), (_, jgrads) = _run(mode)
    got, want = grads[GAINS.index(gain)], jgrads[GAINS.index(gain)]
    if gain in ("kp", "kd_swing"):
        assert want != 0.0
    # a derivative that is 0 in JAX (a gain that reaches no active row) is
    # held to 1e-6 of the largest one
    scale = max(abs(g) for g in jgrads)
    assert abs(got - want) <= GRAD_TOL * max(abs(want), 1e-6 * scale), (got, want)
