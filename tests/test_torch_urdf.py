"""The port's URDF loading (`models.urdf.parse_urdf`, `RobotModel.from_urdf`)
against the JAX package's, and the port's rendering of
`tests/test_generic_robot.py` on the toy quadruped of
`tests/data/toy_quadruped.urdf` (2-DoF legs, y-axis joints, a fixed imu
link lumped into the trunk):

  * the spec dict equals the JAX package's key for key, exactly, and the
    model's tensors equal the JAX model's arrays carried across by
    `convert`, exactly;
  * structure and masses; M symmetric positive definite; the kinetic
    energy 1/2 u^T M u; the feet's Jacobians against `torch.func.jvp` of
    the forward kinematics along the state flow;
  * the mass matrix and the Coriolis bias against the JAX package's on the
    same states, to 1e-12 of their scale, and against the C++ Featherstone
    oracle (`runtime.native`) as the JAX test holds them (skipped where
    make or g++ is missing);
  * the setup kernel refuses the toy: it is compiled for ANYmal-D's 13
    bodies, on either device.

float64, B = 3 random states from a numpy seed."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_util import ROOT

from quadrupedwholebodycontroller_tpu.models import urdf as jurdf
from quadrupedwholebodycontroller_tpu.models.robot_model import RobotModel as JaxRobotModel
from quadrupedwholebodycontroller_tpu.ops import dynamics as JD
from quadrupedwholebodycontroller_tpu.ops import kinematics as JK
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import RobotModel, urdf
from quadrupedwholebodycontroller_tpu_torch.models.robot_model import _TENSOR_FIELDS
from quadrupedwholebodycontroller_tpu_torch.ops import dynamics as D
from quadrupedwholebodycontroller_tpu_torch.ops import kinematics as K
from quadrupedwholebodycontroller_tpu_torch.ops import spatial
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup

URDF = f"{ROOT}/tests/data/toy_quadruped.urdf"
JOINTS = ("FL_hip", "FL_knee", "FR_hip", "FR_knee",
          "RL_hip", "RL_knee", "RR_hip", "RR_knee")
FEET = ("FL_foot", "FR_foot", "RL_foot", "RR_foot")
STATIC = ("name", "joint_names", "frame_names", "parent", "frame_body")
F64 = dict(dtype=torch.float64, device="cpu")
B = 3


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)
    return RobotModel.from_urdf(URDF, JOINTS, FEET, **F64)


@pytest.fixture(scope="module")
def state():
    """(base_R, base_p, q, u) of B random states."""
    rng = np.random.default_rng(0)
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return (spatial.quat_to_matrix(torch.as_tensor(quat)), torch.as_tensor(rng.normal(size=(B, 3))),
            torch.as_tensor(rng.uniform(-0.8, 0.3, size=(B, 8))),
            torch.as_tensor(rng.normal(size=(B, 14))))


def test_spec_equals_the_jax_parser():
    got = urdf.parse_urdf(URDF, JOINTS, FEET)
    want = jurdf.parse_urdf(URDF, JOINTS, FEET)
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key


def test_model_equals_the_jax_model(model):
    jm = JaxRobotModel.from_urdf(URDF, JOINTS, FEET, dtype=jnp.float64)
    d = {k: getattr(jm, k) for k in STATIC}
    d.update({k: np.asarray(getattr(jm, k)) for k in _TENSOR_FIELDS})
    carried = convert.model_from_numpy(d, **F64)
    for k in STATIC:
        assert getattr(model, k) == getattr(carried, k), k
    for k in _TENSOR_FIELDS:
        assert torch.equal(getattr(model, k), getattr(carried, k)), k


def test_model_structure(model):
    assert model.num_bodies == 9 and model.num_joints == 8 and model.nv == 14
    assert model.frame_names == FEET
    # the trunk lumps the imu link (8.0 + 0.05)
    assert np.isclose(float(model.mass[0]), 8.05)
    assert np.isclose(float(model.total_mass), 8.05 + 4 * (0.7 + 0.25))


def test_dynamics_identities(model, state):
    base_R, base_p, q, u = state
    kin = K.forward_kinematics(model, base_R, base_p, q)
    M = D.mass_matrix(model, kin).numpy()
    assert np.allclose(M, np.swapaxes(M, 1, 2), atol=1e-11)
    assert (np.linalg.eigvalsh(M) > 0).all()
    ke = D.kinetic_energy(model, kin, u).numpy()
    assert np.allclose(0.5 * np.einsum("bi,bij,bj->b", u.numpy(), M, u.numpy()), ke,
                       rtol=1e-12)
    # the feet's Jacobians against forward-mode AD along the state flow
    flow = K.state_flow(base_R, base_p, q, u)
    _, dp = torch.func.jvp(lambda R, p, qq: K.forward_kinematics(model, R, p, qq).frame_p,
                           (base_R, base_p, q), flow)
    v = torch.einsum("bfij,bj->bfi", K.frame_jacobians(model, kin)[:, :, :3, :], u)
    assert np.allclose(dp.numpy(), v.numpy(), atol=1e-10)


def test_mass_matrix_and_bias_match_jax(model, state):
    jm = JaxRobotModel.from_urdf(URDF, JOINTS, FEET, dtype=jnp.float64)
    base_R, base_p, q, u = state
    M = D.mass_matrix(model, K.forward_kinematics(model, base_R, base_p, q)).numpy()
    h = D.coriolis_bias(model, base_R, base_p, q, u).numpy()
    a = lambda t: jnp.asarray(t.numpy())
    jM = np.asarray(jax.vmap(lambda R, p, qq: JD.mass_matrix(jm, JK.forward_kinematics(
        jm, R, p, qq)))(a(base_R), a(base_p), a(q)))
    jh = np.asarray(jax.vmap(lambda R, p, qq, uu: JD.coriolis_bias(jm, R, p, qq, uu))(
        a(base_R), a(base_p), a(q), a(u)))
    assert np.abs(M - jM).max() <= 1e-12 * np.abs(jM).max()
    assert np.abs(h - jh).max() <= 1e-12 * max(1.0, np.abs(jh).max())


def test_cpp_oracle_agrees(model, state):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("make or g++ missing: the native library cannot be built")
    from quadrupedwholebodycontroller_tpu_torch.runtime import native

    base_R, base_p, q, u = state
    M = D.mass_matrix(model, K.forward_kinematics(model, base_R, base_p, q)).numpy()
    h = D.coriolis_bias(model, base_R, base_p, q, u).numpy()
    for b in range(B):
        M_cpp, h_cpp = native.oracle_mass_and_bias(model, base_R[b], q[b], u[b])
        assert np.abs(M[b] - M_cpp).max() <= 1e-10 * np.abs(M_cpp).max()
        assert np.abs(h[b] - h_cpp).max() <= 1e-9 * max(1.0, np.abs(h_cpp).max())


def test_setup_kernel_refuses_the_toy(model):
    obs = wbc.RobotObservation(
        base_R=torch.eye(3, **F64).expand(B, 3, 3).contiguous(),
        base_p=torch.zeros((B, 3), **F64), base_vel=torch.zeros((B, 6), **F64),
        q=torch.zeros((B, 8), **F64), qd=torch.zeros((B, 8), **F64))
    cp = ControllerParams()
    with pytest.raises(ValueError, match="compiled for 13 bodies, 12 joints and 4 feet, "
                                         "got 9, 8, 4"):
        setup.setup_batched(model, cp, obs, wbc.Reference.standing(cp, B, **F64),
                            wbc.init_carry(B, **F64), True, QPSolverParams())
