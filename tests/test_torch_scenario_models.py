"""Per-scenario payload models (one simulated model per scenario, the
robustness sweep's physics) in the port against the JAX package:

  * the batched `sim.scenario.apply_payload` (payload_mass (B,), payload_com
    (B, 3)) against `jax.vmap(apply_payload)`, B = 4: mass, com and inertia
    to 1e-12, every other leaf the shared model's;
  * one control period of `sim.world.sim_control_period` with those models
    (carried across by `convert.model_from_numpy`, which takes the vmapped
    model's batched leaves) against the JAX package's `sim_control_period`
    vmapped over the same model arrays, with per-scenario friction and a
    push, feet in contact: every state leaf to 1e-10 of its scale;
  * a per-scenario model whose rows all equal the nominal model against the
    shared nominal model: 1e-12 of scale.

float64 on the CPU; one JAX run for the module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.sim import scenario as jscenario
from quadrupedwholebodycontroller_tpu.sim import world as jworld
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller_tpu_torch.ops import kinematics as K
from quadrupedwholebodycontroller_tpu_torch.ops import spatial
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams, scenario, world
from tests._torch_port_util import scaled_err

B = 4
PAYLOAD_TOL = 1e-12
SIM_TOL = 1e-10
_RUN = {}


def _inputs():
    """float64 numpy: payloads, friction, a push, and a state with the feet
    2 mm in the ground (in contact), a tilted base and a velocity."""
    rng = np.random.default_rng(13)
    payload = rng.uniform(0.0, 10.0, B)
    com = np.stack([rng.uniform(-0.15, 0.15, B), np.zeros(B), np.full(B, 0.1)], axis=1)
    friction = rng.uniform(0.5, 1.2, B)
    push = np.zeros((B, 6))
    push[:, :2] = 60.0 * rng.standard_normal((B, 2))
    R = spatial.rpy_to_matrix(torch.as_tensor(0.05 * rng.standard_normal((B, 3)))).numpy()
    q = np.asarray(INITIAL_JOINT_POS) + 0.05 * rng.standard_normal((B, 12))
    feet = K.forward_kinematics(anymal_d_model(torch.float64, "cpu"), torch.as_tensor(R),
                                torch.zeros(B, 3, dtype=torch.float64),
                                torch.as_tensor(q)).frame_p.numpy()
    p = np.zeros((B, 3))
    p[:, :2] = 0.01 * rng.standard_normal((B, 2))
    p[:, 2] = -feet[:, :, 2].mean(axis=1) - 0.002
    u = 0.2 * rng.standard_normal((B, 18))
    anchor = feet[:, :, :2] + p[:, None, :2]
    tau = 30.0 * rng.standard_normal((B, 12))
    state = dict(base_R=R, base_p=p, q=q, u=u, anchor=anchor)
    return dict(payload=payload, com=com, friction=friction, push=push, state=state, tau=tau)


def _run():
    if _RUN:
        return _RUN
    torch.set_num_threads(1)
    x = _inputs()
    jm = jax_model(dtype=jnp.float64)
    jsim = jax.vmap(lambda m, c: jscenario.apply_payload(jm, m, c))(
        jnp.asarray(x["payload"]), jnp.asarray(x["com"]))
    jstate = jworld.SimState(**{k: jnp.asarray(v) for k, v in x["state"].items()})
    jnext = jax.jit(jax.vmap(lambda m, s, t, f, p: jworld.sim_control_period(
        m, s, t, jworld.SimParams(), f, p)))(
        jsim, jstate, jnp.asarray(x["tau"]), jnp.asarray(x["friction"]), jnp.asarray(x["push"]))
    jsim_np = {f.name: getattr(jsim, f.name) if f.metadata.get("static")
               else np.asarray(getattr(jsim, f.name)) for f in dataclasses.fields(jsim)}
    _RUN.update(x=x, jsim=jsim_np, jnext=jax.tree.map(np.asarray, jnext))
    return _RUN


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _state(x):
    return world.SimState(**{k: _t(v) for k, v in x["state"].items()})


def test_batched_apply_payload_matches_vmap():
    r = _run()
    tm = anymal_d_model(torch.float64, "cpu")
    got = scenario.apply_payload(tm, _t(r["x"]["payload"]), _t(r["x"]["com"]))
    assert got.per_scenario and not tm.per_scenario
    shapes = dict(mass=(B, 13), com=(B, 13, 3), inertia=(B, 13, 3, 3))
    for k, shape in shapes.items():
        leaf = getattr(got, k)
        assert leaf.shape == shape, k
        assert np.abs(leaf.numpy() - r["jsim"][k]).max() <= PAYLOAD_TOL, k
    assert float((got.total_mass - tm.total_mass - _t(r["x"]["payload"])).abs().max()) < 1e-12
    for k in ("joint_R", "joint_p", "joint_axis", "frame_R", "frame_p", "joint_effort"):
        assert torch.equal(getattr(got, k), getattr(tm, k)), k
    # the vmapped model (every leaf batched) carried across keeps only the
    # payload leaves per scenario
    back = convert.model_from_numpy(r["jsim"], torch.float64, "cpu")
    for k in shapes:
        assert torch.equal(getattr(back, k), _t(r["jsim"][k])), k
    assert torch.equal(back.joint_R, tm.joint_R) and back.parent == tm.parent
    bad = dict(r["jsim"], joint_p=r["jsim"]["joint_p"] + np.arange(B)[:, None, None])
    with pytest.raises(ValueError, match="joint_p"):
        convert.model_from_numpy(bad, torch.float64, "cpu")


@pytest.mark.parametrize("leaf", world.SimState._fields)
def test_sim_control_period_per_scenario_matches_vmap(leaf):
    r = _run()
    x = r["x"]
    model = convert.model_from_numpy(r["jsim"], torch.float64, "cpu")
    got = world.sim_control_period(model, _state(x), _t(x["tau"]), SimParams(),
                                   _t(x["friction"]), _t(x["push"]))
    want = getattr(r["jnext"], leaf)
    assert scaled_err(getattr(got, leaf).numpy(), want) <= SIM_TOL, leaf
    if leaf == "anchor":   # the case: the payloads move the robot
        shared = world.sim_control_period(anymal_d_model(torch.float64, "cpu"), _state(x),
                                          _t(x["tau"]), SimParams(), _t(x["friction"]),
                                          _t(x["push"]))
        assert float((shared.u - got.u).abs().max()) > 1e-3


def test_nominal_rows_equal_the_shared_model():
    x = _inputs()
    tm = anymal_d_model(torch.float64, "cpu")
    rows = dataclasses.replace(tm, mass=tm.mass.expand(B, -1), com=tm.com.expand(B, -1, -1),
                               inertia=tm.inertia.expand(B, -1, -1, -1))
    assert rows.per_scenario
    args = (_t(x["tau"]), SimParams(), _t(x["friction"]), _t(x["push"]))
    got = world.sim_control_period(rows, _state(x), *args)
    want = world.sim_control_period(tm, _state(x), *args)
    for k in world.SimState._fields:
        assert scaled_err(getattr(got, k).numpy(), getattr(want, k).numpy()) <= PAYLOAD_TOL, k
