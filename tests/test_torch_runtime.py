"""The port's runtime: checkpoint / resume and the native library's bindings.

  * `runtime.checkpoint`: the single robot's closed loop
    (`closed_loop_rollout`, float64, B = 1, walking from step 4) run 12
    control steps, saved, loaded and run 12 more, bit for bit the 24
    straight; a loaded tree takes the dtype and device of `like`; a tree of
    another structure or leaf shape is rejected;
  * `runtime.native` (the first-party C++ library in native/, built with
    make and g++, skipped only where either is missing): the port's
    `mass_matrix` and Coriolis bias against the C++ Featherstone oracle on
    five random states (1e-10 and 1e-9 of scale, as tests/test_native_oracle.py
    holds the JAX package), the port's `wbc_setup` against the C++ QP
    assembly (1e-9 of scale, finite entries), and a `TrajLog` round trip."""
import shutil

import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu_torch.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import dynamics as D
from quadrupedwholebodycontroller_tpu_torch.ops import kinematics as K
from quadrupedwholebodycontroller_tpu_torch.ops import spatial
from quadrupedwholebodycontroller_tpu_torch.runtime import checkpoint
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams, closed_loop_rollout
from quadrupedwholebodycontroller_tpu_torch.sim.rollout import init_rollout_carry

F64 = torch.float64


def _walk(carry, cmds):
    model, cp, pp = anymal_d_model(F64, "cpu"), ControllerParams(), PlannerParams()
    return closed_loop_rollout(model, cp, pp, QPSolverParams(), SimParams(), carry, cmds)


def test_checkpoint_resume_bit_exact(tmp_path):
    torch.set_num_threads(1)
    carry0 = init_rollout_carry(anymal_d_model(F64, "cpu"), ControllerParams(), 1,
                                PlannerParams(), F64, "cpu")
    cmds = torch.zeros((1, 24, 3), dtype=F64)
    cmds[:, 4:, 0] = 0.4
    carry_mid, _ = _walk(carry0, cmds[:, :12])
    path = str(tmp_path / "sweep.ckpt.npz")
    checkpoint.save_pytree(path, carry_mid, meta=dict(step=12))
    restored = checkpoint.load_pytree(path, carry_mid)
    assert checkpoint.load_meta(path) == {"step": 12}
    end_b, tr_b = _walk(restored, cmds[:, 12:])
    end_full, tr_full = _walk(carry0, cmds)
    for leaf in ("com_pos", "tau", "qp_kkt", "q"):
        assert torch.equal(getattr(tr_b, leaf), getattr(tr_full, leaf)[:, 12:]), leaf
    assert all(torch.equal(a, b) for a, b in zip(end_b.sim, end_full.sim))
    assert float(tr_full.com_pos[0, -1, 2]) > 0.4


def test_loaded_tree_takes_the_dtype_and_device_of_like(tmp_path):
    tree = {"a": torch.arange(6, dtype=F64).reshape(2, 3), "b": (torch.tensor([True, False]),)}
    path = str(tmp_path / "x.npz")
    checkpoint.save_pytree(path, tree)
    like = {"a": torch.zeros(2, 3, dtype=torch.float32), "b": (torch.zeros(2, dtype=torch.bool),)}
    back = checkpoint.load_pytree(path, like)
    assert back["a"].dtype == torch.float32 and back["a"].device == like["a"].device
    assert torch.equal(back["a"], tree["a"].float()) and torch.equal(back["b"][0], tree["b"][0])
    assert checkpoint.load_meta(path) == {}


@pytest.mark.parametrize("other", ["key", "shape", "type"])
def test_structure_mismatch_rejected(tmp_path, other):
    tree = {"a": torch.zeros(3), "b": torch.ones(2)}
    path = str(tmp_path / "x.npz")
    checkpoint.save_pytree(path, tree)
    like = {"key": {"a": torch.zeros(3), "c": torch.ones(2)},
            "shape": {"a": torch.zeros(4), "b": torch.ones(2)},
            "type": {"a": torch.zeros(3), "b": (torch.ones(2),)}}[other]
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.load_pytree(path, like)


@pytest.fixture(scope="module")
def native():
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("make or g++ missing: the native library cannot be built")
    from quadrupedwholebodycontroller_tpu_torch.runtime import native

    native.load()
    return native


def _random_state(rng):
    quat = rng.normal(size=4)
    R = spatial.quat_to_matrix(torch.as_tensor(quat / np.linalg.norm(quat)))
    return (R, torch.as_tensor(rng.normal(size=3)), torch.as_tensor(rng.uniform(-0.7, 0.7, 12)),
            torch.as_tensor(rng.normal(size=18)))


def test_mass_matrix_and_bias_match_the_oracle(native):
    torch.set_num_threads(1)
    model = anymal_d_model(F64, "cpu")
    rng = np.random.default_rng(0)
    for _ in range(5):
        R, p, q, u = _random_state(rng)
        M = D.mass_matrix(model, K.forward_kinematics(model, R[None], p[None], q[None]))[0]
        h = D.coriolis_bias(model, R[None], p[None], q[None], u[None])[0]
        M_cpp, h_cpp = native.oracle_mass_and_bias(model, R, q, u)
        assert np.abs(M.numpy() - M_cpp).max() <= 1e-10 * np.abs(M_cpp).max()
        assert np.abs(h.numpy() - h_cpp).max() <= 1e-9 * max(1.0, np.abs(h_cpp).max())


@pytest.mark.parametrize("contacts", [(1, 1, 1, 1), (1, 0, 1, 1), (0, 1, 1, 0)])
def test_wbc_setup_matches_the_oracle_assembly(native, contacts):
    torch.set_num_threads(1)
    model, params = anymal_d_model(F64, "cpu"), ControllerParams()
    rng = np.random.default_rng(sum(contacts))
    R, p, q, u = _random_state(rng)
    obs = wbc.RobotObservation(base_R=R[None], base_p=p[None], base_vel=u[None, :6],
                               q=q[None], qd=u[None, 6:])
    t = lambda n: torch.as_tensor(rng.normal(size=(1, n)))
    ref = wbc.Reference(com_pose=t(6), com_vel=t(6), com_acc=t(6), swing_pos=t(12),
                        swing_vel=t(12), swing_acc=t(12),
                        contacts=torch.tensor([contacts], dtype=F64))
    carry = wbc.init_carry(1, F64, "cpu")._replace(prev_contacts=ref.contacts)
    setup = wbc.wbc_setup(model, params, obs, ref, carry, torch.ones(1, dtype=torch.bool))
    row = lambda tree: type(tree)(*(x[0] for x in tree))
    orc = native.oracle_qp_assembly(model, params, row(obs), row(ref), row(carry), False, False)
    cu = setup.carry_updates
    pairs = dict(H=setup.qp_data.H, g=setup.qp_data.g, A=setup.qp_data.A, l=setup.qp_data.l,
                 u=setup.qp_data.u, h_c=setup.h_c, T=cu["old_T"], Jc_st=cu["old_J_st"],
                 Jc_sw=cu["old_J_sw"], tdot_inv=cu["tdot_inv"],
                 integral_error=cu["integral_error"])
    for name, got in pairs.items():
        a, b = got[0].numpy(), orc[name]
        finite = np.abs(b) < 1e19          # not the one-sided QP_INF bounds
        err = np.abs(a - b)[finite].max()
        assert err <= 1e-9 * max(1.0, np.abs(b[finite]).max()), (name, err)


def test_trajlog_roundtrip(native, tmp_path):
    log = native.TrajLog(frame_doubles=7)
    frames = np.arange(21.0).reshape(3, 7)
    log.append(torch.as_tensor(frames))
    assert len(log) == 3
    with pytest.raises(ValueError, match="whole frames"):
        log.append(np.zeros(5))
    path = str(tmp_path / "run.qlog")
    log.flush(path)
    log.close()
    back = native.TrajLog.read(path)
    assert back.shape == (3, 7) and np.array_equal(back, frames)
