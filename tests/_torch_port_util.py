"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
inputs are made with numpy from a seed and handed to both frameworks."""
import os

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OBS_KEYS = ("base_R", "base_p", "base_vel", "q", "qd")
REF_KEYS = ("com_pose", "com_vel", "com_acc", "swing_pos", "swing_vel",
            "swing_acc", "contacts")


def load_walk():
    return np.load(os.path.join(ROOT, "data", "walk_traj_400hz.npz"))


def step_arrays(traj, t, B, offsets=None):
    """(obs dict, ref dict, ref_is_new) of recorded step t as float64 numpy
    arrays broadcast to B scenarios, plus per-scenario observation offsets."""
    bc = lambda k: np.broadcast_to(traj[k][t], (B,) + traj[k][t].shape).astype(np.float64)
    obs = {k: bc(k).copy() for k in OBS_KEYS}
    if offsets is not None:
        for k, v in offsets.items():
            obs[k] = obs[k] + v
    ref = {k: bc(k).copy() for k in REF_KEYS}
    return obs, ref, bool(traj["ref_is_new"][t])


def make_offsets(rng, B):
    return {
        "base_p": 0.01 * rng.standard_normal((B, 3)),
        "base_vel": 0.02 * rng.standard_normal((B, 6)),
        "q": 0.02 * rng.standard_normal((B, 12)),
        "qd": 0.05 * rng.standard_normal((B, 12)),
    }


def scaled_err(got, want):
    """max |got - want| / max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# the scenario sweep's inputs (tests/test_torch_parallel.py, test_torch_distributed.py)

def scenarios(B: int, T: int, seed: int = 5) -> dict:
    """numpy float64 Scenario fields: friction 0.5-1.2, payload 0-10 kg at
    x in +-0.15 m, 0.1 m up; one 60 N push of T // 3 control steps from an
    onset in [T // 4, T // 2) in a random direction."""
    rng = np.random.default_rng(seed)
    push = np.zeros((B, T, 6))
    onset = rng.integers(T // 4, T // 2, B)
    theta = rng.uniform(0.0, 2 * np.pi, B)
    t = np.arange(T)[None, :]
    window = (t >= onset[:, None]) & (t < onset[:, None] + T // 3)
    push[:, :, 0] = 60.0 * np.cos(theta)[:, None] * window
    push[:, :, 1] = 60.0 * np.sin(theta)[:, None] * window
    com = np.stack([rng.uniform(-0.15, 0.15, B), np.zeros(B), np.full(B, 0.1)], axis=1)
    return dict(sim_friction=rng.uniform(0.5, 1.2, B), payload_mass=rng.uniform(0.0, 10.0, B),
                payload_com=com, push_wrench=push)


def commands(B: int, T: int) -> np.ndarray:
    cmds = np.zeros((B, T, 3))
    cmds[1::2, 4:, 0] = 0.5          # alternate scenarios walk
    return cmds


def flagship_inputs(B: int, dtype=None, seed: int = 3):
    """Perturbed standing observations, the standing reference, a fresh
    carry and QPCache (numpy-made, `seed`), on the CPU, float32 unless
    `dtype` says otherwise: (model, cp, qpp, obs, ref, carry, cache)."""
    import torch

    from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
    from quadrupedwholebodycontroller_tpu_torch.control import wbc
    from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
    from quadrupedwholebodycontroller_tpu_torch.models.anymal import INITIAL_JOINT_POS
    from quadrupedwholebodycontroller_tpu_torch.ops import qp

    dtype = torch.float32 if dtype is None else dtype
    rng = np.random.default_rng(seed)
    kw = dict(dtype=dtype, device="cpu")
    t = lambda a: torch.as_tensor(np.array(a), **kw)
    obs = wbc.RobotObservation(
        base_R=torch.eye(3, **kw).expand(B, 3, 3).contiguous(),
        base_p=t(np.array([0.0, 0.0, 0.55]) + 0.01 * rng.standard_normal((B, 3))),
        base_vel=t(0.01 * rng.standard_normal((B, 6))),
        q=t(np.broadcast_to(INITIAL_JOINT_POS, (B, 12))),
        qd=t(0.02 * rng.standard_normal((B, 12))))
    cp, qpp = ControllerParams(), QPSolverParams()
    ref = wbc.Reference.standing(cp, B, dtype, "cpu")
    return (anymal_d_model(dtype, "cpu"), cp, qpp, obs, ref, wbc.init_carry(B, dtype, "cpu"),
            qp.make_cache(B, 42, 70, qpp, dtype, "cpu"))
