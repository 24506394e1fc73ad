"""Rigid-body ops of the PyTorch port against the JAX functions, float64.

Eight random floating-base states made with numpy go through the JAX
single-sample functions (vmapped) and the port's batched ones.  Tolerance
1e-10 absolute: both sides do the same float64 arithmetic in another
summation order, on quantities of magnitude <= ~1e2 (masses, inertias,
Coriolis forces)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.ops import centroidal as JC
from quadrupedwholebodycontroller_tpu.ops import dynamics as JD
from quadrupedwholebodycontroller_tpu.ops import kinematics as JK
from quadrupedwholebodycontroller_tpu.ops import spatial as JS
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller_tpu_torch.ops import centroidal as C
from quadrupedwholebodycontroller_tpu_torch.ops import dynamics as D
from quadrupedwholebodycontroller_tpu_torch.ops import kinematics as K
from quadrupedwholebodycontroller_tpu_torch.ops import spatial as S

ATOL = 1e-10
NS = 8


@pytest.fixture(scope="module")
def states():
    torch.set_num_threads(1)
    rng = np.random.default_rng(11)
    rpy = 0.3 * rng.standard_normal((NS, 3))
    R = np.asarray(JS.rpy_to_matrix(jnp.asarray(rpy)))
    p = np.array([0.0, 0.0, 0.55]) + 0.1 * rng.standard_normal((NS, 3))
    q = np.asarray(INITIAL_JOINT_POS) + 0.3 * rng.standard_normal((NS, 12))
    u = 0.5 * rng.standard_normal((NS, 18))
    tdi = 0.1 * rng.standard_normal((NS, 18, 18))
    return dict(R=R, p=p, q=q, u=u, tdi=tdi, rpy=rpy)


@pytest.fixture(scope="module")
def both(states):
    """Everything computed once on both sides."""
    jm = jax_model(dtype=jnp.float64)
    tm = anymal_d_model(torch.float64, "cpu")
    s = states

    def jax_all(R, p, q, u, tdi):
        h, kin, parts, v_c = JD.coriolis_bias_full(jm, R, p, q, u)
        M = JD.mass_matrix_from_parts(jm, kin, parts)
        com = JK.robot_com(jm, kin)
        tf = JC.centroidal_transform(M, com, p)
        v, w = JK.parts_velocities(parts, u)
        return dict(
            body_R=kin.body_R, body_p=kin.body_p, body_com_w=kin.body_com_w,
            joint_axis_w=kin.joint_axis_w, joint_origin_w=kin.joint_origin_w,
            frame_R=kin.frame_R, frame_p=kin.frame_p,
            r=parts.r, jq=parts.jq, jw=parts.jw, v=v, w=w, h=h, v_c=v_c, M=M,
            com=com, T=tf.T, T_inv=tf.T_inv, Mc=JC.centroidal_mass_matrix(M, tf),
            h_c=JC.centroidal_bias(h, M, tdi, u, tf),
            tdot_inv=JC.tdot_inverse(tf, tdi),
            J_frames=JK.frame_jacobians(jm, kin), Iw=JD.world_inertias(jm, kin),
        )

    jout = jax.jit(jax.vmap(jax_all))(*(jnp.asarray(s[k]) for k in ("R", "p", "q", "u", "tdi")))
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in s.items()}
    h, kin, parts, v_c = D.coriolis_bias_full(tm, t["R"], t["p"], t["q"], t["u"])
    M = D.mass_matrix_from_parts(tm, kin, parts)
    com = K.robot_com(tm, kin)
    tf = C.centroidal_transform(M, com, t["p"])
    v, w = K.parts_velocities(parts, t["u"])
    tout = dict(
        body_R=kin.body_R, body_p=kin.body_p, body_com_w=kin.body_com_w,
        joint_axis_w=kin.joint_axis_w, joint_origin_w=kin.joint_origin_w,
        frame_R=kin.frame_R, frame_p=kin.frame_p,
        r=parts.r, jq=parts.jq, jw=parts.jw, v=v, w=w, h=h, v_c=v_c, M=M,
        com=com, T=tf.T, T_inv=tf.T_inv, Mc=C.centroidal_mass_matrix(M, tf),
        h_c=C.centroidal_bias(h, M, t["tdi"], t["u"], tf),
        tdot_inv=C.tdot_inverse(tf, t["tdi"]),
        J_frames=K.frame_jacobians(tm, kin), Iw=D.world_inertias(tm, kin),
    )
    return jout, tout


GROUPS = {
    "forward_kinematics": ("body_R", "body_p", "body_com_w", "joint_axis_w",
                           "joint_origin_w", "frame_R", "frame_p"),
    "jacobian_parts": ("r", "jq", "jw"),
    "parts_velocities": ("v", "w"),
    "frame_jacobians": ("J_frames",),
    "world_inertias": ("Iw",),
    "coriolis_bias_full": ("h", "v_c"),
    "mass_matrix_from_parts": ("M",),
    "robot_com": ("com",),
    "centroidal_transform": ("T", "T_inv"),
    "centroidal_mass_matrix": ("Mc",),
    "centroidal_bias": ("h_c",),
    "tdot_inverse": ("tdot_inv",),
}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_matches_jax(both, group):
    jout, tout = both
    for key in GROUPS[group]:
        want = np.asarray(jout[key])
        got = tout[key].numpy()
        assert got.shape == want.shape, key
        assert np.abs(got - want).max() <= ATOL, (key, np.abs(got - want).max())


def test_spatial_matches_jax(states):
    rpy = states["rpy"]
    R = S.rpy_to_matrix(torch.as_tensor(rpy))
    assert np.abs(R.numpy() - np.asarray(JS.rpy_to_matrix(jnp.asarray(rpy)))).max() <= 1e-14
    assert np.abs(S.matrix_to_rpy(R).numpy() - rpy).max() <= 1e-12
    v = torch.as_tensor(states["p"])
    assert np.abs(S.skew(v).numpy() - np.asarray(JS.skew(jnp.asarray(states["p"])))).max() == 0.0


def test_model_copy_matches_the_reference_model():
    """The port's own anymal_d.json and loader give the JAX model's leaves."""
    jm = jax_model(dtype=jnp.float64)
    tm = anymal_d_model(torch.float64, "cpu")
    assert tm.parent == jm.parent and tm.frame_body == jm.frame_body
    assert tm.joint_names == jm.joint_names and tm.frame_names == jm.frame_names
    for f in ("joint_R", "joint_p", "joint_axis", "mass", "com", "inertia",
              "frame_R", "frame_p", "joint_lower", "joint_upper", "joint_effort",
              "joint_velocity"):
        assert np.array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f))), f


def test_model_from_numpy_carries_the_jax_model_across():
    """convert.model_from_numpy on the JAX model's leaves (as numpy) and
    static tuples gives the port's packaged model."""
    import dataclasses

    from quadrupedwholebodycontroller_tpu_torch import convert

    jm = jax_model(dtype=jnp.float64)
    d = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}
    d = {k: (v if isinstance(v, (str, tuple)) else np.asarray(v)) for k, v in d.items()}
    got = convert.model_from_numpy(d, torch.float64, "cpu")
    want = anymal_d_model(torch.float64, "cpu")
    assert (got.name, got.parent, got.frame_body, got.joint_names, got.frame_names) == (
        want.name, want.parent, want.frame_body, want.joint_names, want.frame_names)
    for f in ("joint_R", "joint_p", "joint_axis", "mass", "com", "inertia", "frame_R",
              "frame_p", "joint_lower", "joint_upper", "joint_effort", "joint_velocity"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.num_bodies == 13 and got.num_joints == 12 and got.nv == 18
