"""The port's rigid-body additions and simulator against the JAX package on
the same seeded numpy inputs, B = 3: `state_flow`, `orthonormalize`, the
quaternion maps, `mass_matrix` (from parts and from the Jacobian stack),
`kinetic_energy` against u^T M u / 2, the velocities, `forward_dynamics`
(the port's batched Cholesky against the JAX package's CPU path, LAPACK's),
`_contact_forces` with feet in and out of contact, sticking and sliding, one
`sim_control_period` with per-scenario friction and a push wrench,
`apply_payload`, and `coriolis_bias_full_jvp` (forward-mode AD through the
port's rigid-body code) against the closed-form recursion and against the
JAX package's jvp.

float64, to 1e-10 of each output's scale (max(1, max |JAX|)): the same
arithmetic in another order.  The JAX side of each comparison is vmapped
over the batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.ops import dynamics as jD
from quadrupedwholebodycontroller_tpu.ops import kinematics as jK
from quadrupedwholebodycontroller_tpu.ops import linalg as jlinalg
from quadrupedwholebodycontroller_tpu.ops import spatial as jspatial
from quadrupedwholebodycontroller_tpu.sim import scenario as jscenario
from quadrupedwholebodycontroller_tpu.sim import world as jworld
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller_tpu_torch.ops import dynamics as D
from quadrupedwholebodycontroller_tpu_torch.ops import kinematics as K
from quadrupedwholebodycontroller_tpu_torch.ops import linalg, spatial
from quadrupedwholebodycontroller_tpu_torch.sim import scenario, world
from tests._torch_port_util import scaled_err

B = 3
TOL = 1e-10


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    return jax_model(dtype=jnp.float64), anymal_d_model(torch.float64, "cpu")


def _state(seed=0, z=None):
    """(R, p, q, u) float64 numpy: a tilted base, perturbed joints, a
    non-zero velocity.  With z, the base height puts the feet about z below
    (z > 0) or above the ground."""
    rng = np.random.default_rng(seed)
    R = spatial.rpy_to_matrix(torch.as_tensor(0.1 * rng.standard_normal((B, 3)))).numpy()
    q = np.asarray(INITIAL_JOINT_POS) + 0.1 * rng.standard_normal((B, 12))
    p = np.array([0.0, 0.0, 0.55]) + 0.02 * rng.standard_normal((B, 3))
    if z is not None:
        tm = anymal_d_model(torch.float64, "cpu")
        feet = K.forward_kinematics(tm, torch.as_tensor(R), torch.zeros(B, 3),
                                    torch.as_tensor(q)).frame_p.numpy()
        p[:, 2] = -feet[:, :, 2].mean(axis=1) - z
    u = 0.3 * rng.standard_normal((B, 18))
    return R, p, q, u


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _hold(got, want, what):
    err = scaled_err(got.numpy() if torch.is_tensor(got) else got, want)
    assert err <= TOL, (what, err)


def test_state_flow_and_orthonormalize():
    R, p, q, u = _state(1)
    got = K.state_flow(*_t(R, p, q, u))
    want = jax.vmap(jK.state_flow)(*_j(R, p, q, u))
    for g, w, k in zip(got, want, ("Rdot", "pdot", "qdot")):
        _hold(g, np.asarray(w), k)
    bent = R + 1e-3 * np.random.default_rng(2).standard_normal((B, 3, 3))
    got = spatial.orthonormalize(torch.as_tensor(bent))
    _hold(got, np.asarray(jspatial.orthonormalize(jnp.asarray(bent))), "orthonormalize")
    eye = (got.transpose(-1, -2) @ got).numpy()
    assert np.abs(eye - np.eye(3)).max() < 1e-14


def test_quaternion_maps():
    R = _state(3)[0]
    got_q = spatial.matrix_to_quat(torch.as_tensor(R))
    _hold(got_q, np.asarray(jspatial.matrix_to_quat(jnp.asarray(R))), "matrix_to_quat")
    _hold(spatial.quat_to_matrix(got_q), R, "quat_to_matrix round trip")
    qs = np.random.default_rng(4).standard_normal((B, 4))
    _hold(spatial.quat_to_matrix(torch.as_tensor(qs)),
          np.asarray(jspatial.quat_to_matrix(jnp.asarray(qs))), "quat_to_matrix")


def test_mass_matrix_both_forms_and_kinetic_energy(models):
    jm, tm = models
    R, p, q, u = _state(5)
    kin = K.forward_kinematics(tm, *_t(R, p, q))
    M = D.mass_matrix(tm, kin)
    M_J = D.mass_matrix(tm, kin, J=K.body_com_jacobians(tm, kin))
    jkin = jax.vmap(lambda a, b, c: jK.forward_kinematics(jm, a, b, c))(*_j(R, p, q))
    want = jax.vmap(lambda k: jD.mass_matrix(jm, k))(jkin)
    want_J = jax.vmap(lambda k: jD.mass_matrix(jm, k, J=jK.body_com_jacobians(jm, k)))(jkin)
    _hold(M, np.asarray(want), "mass_matrix (parts)")
    _hold(M_J, np.asarray(want_J), "mass_matrix (J)")
    _hold(M_J, M.numpy(), "the two forms")
    ke = D.kinetic_energy(tm, kin, torch.as_tensor(u))
    uMu = 0.5 * torch.einsum("bi,bij,bj->b", torch.as_tensor(u), M, torch.as_tensor(u))
    _hold(ke, uMu.numpy(), "kinetic energy vs u^T M u / 2")
    _hold(ke, np.asarray(jax.vmap(lambda k, v: jD.kinetic_energy(jm, k, v))(
        jkin, jnp.asarray(u))), "kinetic energy")
    _hold(D.potential_energy(tm, kin), np.asarray(jax.vmap(
        lambda k: jD.potential_energy(jm, k))(jkin)), "potential energy")


def test_velocities_and_gravity(models):
    jm, tm = models
    R, p, q, u = _state(6)
    kin = K.forward_kinematics(tm, *_t(R, p, q))
    jkin = jax.vmap(lambda a, b, c: jK.forward_kinematics(jm, a, b, c))(*_j(R, p, q))
    ju = jnp.asarray(u)
    tu = torch.as_tensor(u)
    pairs = [
        (K.body_velocities(tm, *_t(R, p, q, u)),
         jax.vmap(lambda a, b, c, d: jK.body_velocities(jm, a, b, c, d))(*_j(R, p, q, u))),
        ((K.frame_velocities(tm, kin, tu),),
         (jax.vmap(lambda k, v: jK.frame_velocities(jm, k, v))(jkin, ju),)),
        ((K.com_velocity(tm, kin, tu),),
         (jax.vmap(lambda k, v: jK.com_velocity(jm, k, v))(jkin, ju),)),
        ((D.gravity_force(tm, kin, (0.0, 0.0, -9.81)),),
         (jax.vmap(lambda k: jD.gravity_force(jm, k, jnp.array([0.0, 0.0, -9.81])))(jkin),)),
        ((D.coriolis_bias(tm, *_t(R, p, q, u)),),
         (jax.vmap(lambda a, b, c, d: jD.coriolis_bias(jm, a, b, c, d))(*_j(R, p, q, u)),)),
    ]
    for i, (got, want) in enumerate(pairs):
        for g, w in zip(got, want):
            _hold(g, np.asarray(w), i)


def test_spd_solve_and_forward_dynamics(models):
    jm, tm = models
    R, p, q, u = _state(7)
    tau = 20.0 * np.random.default_rng(8).standard_normal((B, 18))
    got = D.forward_dynamics(tm, *_t(R, p, q, u, tau))
    want = jax.vmap(lambda a, b, c, d, e: jD.forward_dynamics(jm, a, b, c, d, e))(
        *_j(R, p, q, u, tau))
    _hold(got, np.asarray(want), "forward_dynamics")
    kin = K.forward_kinematics(tm, *_t(R, p, q))
    M = D.mass_matrix(tm, kin)
    rhs = torch.as_tensor(tau)
    x = linalg.spd_solve(M, rhs)
    _hold(x, np.asarray(jlinalg.spd_solve(jnp.asarray(M.numpy()), jnp.asarray(tau))),
          "spd_solve")
    _hold((M @ x[..., None])[..., 0], tau, "M x = b")
    X = linalg.spd_solve(M, torch.eye(18, dtype=M.dtype).expand(B, 18, 18))
    _hold(X @ M, np.broadcast_to(np.eye(18), (B, 18, 18)), "matrix right-hand side")


def test_coriolis_bias_full_jvp(models):
    jm, tm = models
    R, p, q, u = _state(9)
    closed = D.coriolis_bias_full(tm, *_t(R, p, q, u))
    with torch.no_grad():          # forward-mode AD is not switched off by no_grad
        by_jvp = D.coriolis_bias_full_jvp(tm, *_t(R, p, q, u))
    want = jax.vmap(lambda a, b, c, d: jD.coriolis_bias_full_jvp(jm, a, b, c, d))(
        *_j(R, p, q, u))
    _hold(by_jvp[0], closed[0].numpy(), "jvp vs the closed-form recursion")
    _hold(by_jvp[0], np.asarray(want[0]), "jvp vs JAX's jvp")
    _hold(by_jvp[3], np.asarray(want[3]), "body CoM velocities")
    assert float(closed[0].abs().max()) > 1.0       # a bias worth comparing


def _contact_case(seed=10):
    """A state with the feet 2 mm into the ground (tilted, so not all of
    them) and anchors that make some feet stick and some slide."""
    R, p, q, u = _state(seed, z=0.002)
    rng = np.random.default_rng(seed)
    tm = anymal_d_model(torch.float64, "cpu")
    feet = K.forward_kinematics(tm, *_t(R, p, q)).frame_p.numpy()
    anchor = feet[:, :, :2] + np.array([1e-4, 0.05])[rng.integers(0, 2, (B, 4))][..., None] \
        * rng.standard_normal((B, 4, 2))
    return R, p, q, u, anchor


def test_contact_forces(models):
    jm, tm = models
    R, p, q, u, anchor = _contact_case()
    sp, jsp = world.SimParams(), jworld.SimParams()
    fr = np.array([0.5, 1.0, 0.8])
    kin = K.forward_kinematics(tm, *_t(R, p, q))
    f, a = world._contact_forces(tm, kin, torch.as_tensor(u), torch.as_tensor(anchor), sp,
                                 torch.as_tensor(fr))
    jkin = jax.vmap(lambda x, y, z: jK.forward_kinematics(jm, x, y, z))(*_j(R, p, q))
    jf, ja = jax.vmap(lambda k, v, an, mu: jworld._contact_forces(jm, k, v, an, jsp, mu))(
        jkin, *_j(u, anchor, fr))
    _hold(f, np.asarray(jf), "forces")
    _hold(a, np.asarray(ja), "anchors")
    fz = f[..., 2].numpy()
    tangential = np.linalg.norm(f[..., :2].numpy(), axis=-1)
    assert (fz > 0).any() and (fz == 0).any()                      # in and out of contact
    sliding = np.isclose(tangential, fr[:, None] * fz) & (fz > 0)
    assert sliding.any() and ((tangential < fr[:, None] * fz - 1e-9) & (fz > 0)).any()


def test_sim_control_period(models):
    jm, tm = models
    R, p, q, u, anchor = _contact_case(11)
    u = 0.1 * u
    rng = np.random.default_rng(12)
    tau = 10.0 * rng.standard_normal((B, 12))
    fr = np.array([0.5, 1.0, 0.8])
    push = np.zeros((B, 6))
    push[1, :2] = (40.0, -20.0)
    state = world.SimState(*_t(R, p, q, u, anchor))
    got = world.sim_control_period(tm, state, torch.as_tensor(tau), world.SimParams(),
                                   torch.as_tensor(fr), torch.as_tensor(push))
    jstate = jworld.SimState(*_j(R, p, q, u, anchor))
    want = jax.jit(jax.vmap(lambda s, t, f, w: jworld.sim_control_period(
        jm, s, t, jworld.SimParams(), f, w)))(jstate, *_j(tau, fr, push))
    for k in world.SimState._fields:
        _hold(getattr(got, k), np.asarray(getattr(want, k)), k)
    obs = world.observe(got)
    assert torch.equal(obs.qd, got.u[:, 6:]) and torch.equal(obs.base_vel, got.u[:, :6])
    assert all(t.is_contiguous() for t in obs)          # as the setup kernel takes them
    start = world.init_sim_state(tm, torch.as_tensor(p), torch.as_tensor(q))
    jstart = jax.vmap(lambda a, b: jworld.init_sim_state(jm, a, b, jnp.float64))(*_j(p, q))
    for k in world.SimState._fields:
        _hold(getattr(start, k), np.asarray(getattr(jstart, k)), f"init {k}")
    back = convert.sim_state_from_numpy(jax.tree.map(np.asarray, want), torch.float64, "cpu")
    assert all(torch.equal(getattr(back, k), torch.as_tensor(np.array(getattr(want, k))))
               for k in world.SimState._fields)


def test_apply_payload(models):
    jm, tm = models
    got = scenario.apply_payload(tm, torch.tensor(7.5, dtype=torch.float64),
                                 torch.tensor([0.1, -0.05, 0.1], dtype=torch.float64))
    want = jscenario.apply_payload(jm, jnp.asarray(7.5), jnp.array([0.1, -0.05, 0.1]))
    for k in ("mass", "com", "inertia"):
        _hold(getattr(got, k), np.asarray(getattr(want, k)), k)
    assert torch.equal(got.joint_R, tm.joint_R) and got.parent == tm.parent
    sc = scenario.Scenario.random_batch(torch.Generator().manual_seed(0), 16, 100,
                                        torch.float64, "cpu")
    assert sc.push_wrench.shape == (16, 100, 6)
    assert ((sc.push_wrench[..., :2].norm(dim=-1) > 0).sum(1) == 40).all()
    assert (sc.sim_friction >= 0.5).all() and (sc.sim_friction <= 1.2).all()
    nom = scenario.Scenario.nominal(4, 10, dtype=torch.float64, device="cpu")
    assert (nom.sim_friction == 1.0).all() and not nom.push_wrench.any()
    back = convert.scenario_from_numpy(convert.to_numpy(sc), torch.float64, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, sc))
