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
