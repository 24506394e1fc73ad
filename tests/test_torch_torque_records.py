"""The port's control step on its torch QP backend reproduces the repo's two
float64 torque records, with no JAX at test time.

`data/torque_cpu64.npz` and `data/torque_cpu64_diverse.npz` were written by
`tools/measure_torque_err.py --stage cpu64`: the JAX package's
`wbc_step_batched(qp_backend="xla")` in float64 without a cache, B = 8,
over the 200 recorded steps of the walk (8 identical scenarios, scenario 0
recorded) and of the 4-gait diverse replay (scenario b replays gait b % 4,
scenarios 0..3 recorded), each with its per-step max KKT residual over the
batch.  The port's `wbc_step_batched(qp_backend="torch")` (tensor-code
setup, `ops.qp.solve_batched(backend="torch")`) replays the same steps from
the same start: every torque to 1e-8 N.m, every step's max KKT residual to
5e-12 absolute (the records' are 1e-11 to 5e-9, rounding-level values of
the polished solutions).  Measured on an x86 CPU: 1.08e-11 N.m on both
records, KKT 7.4e-13 (walk) and 4.4e-13 (diverse).  The files are only
read."""
import os

import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import kernels

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
B = 8
TAU_TOL = 1e-8   # N.m
KKT_TOL = 5e-12
TRAJS = {"walk": ("walk_traj_400hz.npz", "torque_cpu64.npz"),
         "diverse": ("diverse_traj_400hz.npz", "torque_cpu64_diverse.npz")}
_RUN = {}


def _replay(name):
    """(tau (T, ...), per-step max KKT (T,), plain calls, kernel launches)."""
    if name in _RUN:
        return _RUN[name]
    torch.set_num_threads(1)
    traj = np.load(os.path.join(ROOT, "data", TRAJS[name][0]))
    dt = torch.float64
    model = anymal_d_model(dt, "cpu")
    cp, qpp = ControllerParams(), QPSolverParams()
    carry = wbc.init_carry(B, dt, "cpu")
    if name == "walk":          # one profile, broadcast to the batch
        at = lambda k, t: np.broadcast_to(traj[k][t], (B,) + traj[k][t].shape)
        new = lambda t: bool(traj["ref_is_new"][t])
        keep = lambda tau: tau[0]
    else:                       # (P, T, ...) profiles: scenario b replays gait b % P
        prof = np.arange(B) % traj["base_R"].shape[0]
        at = lambda k, t: traj[k][prof, t]
        new = lambda t: torch.as_tensor(traj["ref_is_new"][prof, t])
        keep = lambda tau: tau[:traj["base_R"].shape[0]]
    kernels.reset_counts()
    taus, kkts = [], []
    for t in range(traj["base_R"].shape[1 if name == "diverse" else 0]):
        obs = convert.obs_from_numpy({k: at(k, t) for k in wbc.RobotObservation._fields},
                                     dt, "cpu")
        ref = convert.ref_from_numpy({k: at(k, t) for k in wbc.Reference._fields}, dt, "cpu")
        out, carry = wbc.wbc_step_batched(model, cp, qpp, obs, ref, carry, new(t), "torch")
        taus.append(keep(out.tau).numpy())
        kkts.append(float(out.qp_info.kkt_residual.max()))
    _RUN[name] = (np.stack(taus), np.asarray(kkts), kernels.plain_counts(),
                  kernels.launch_counts())
    return _RUN[name]


def _record(name):
    return np.load(os.path.join(ROOT, "data", TRAJS[name][1]))


@pytest.mark.parametrize("name", list(TRAJS))
def test_torques_reproduce_the_float64_record(name):
    tau, _, _, _ = _replay(name)
    want = _record(name)["tau"]
    assert tau.shape == want.shape
    err = np.abs(tau - want).max()
    assert err <= TAU_TOL, err


@pytest.mark.parametrize("name", list(TRAJS))
def test_kkt_residuals_reproduce_the_float64_record(name):
    _, kkt, _, _ = _replay(name)
    want = _record(name)["kkt"]
    assert kkt.shape == want.shape and want.max() < 1e-8
    assert np.abs(kkt - want).max() <= KKT_TOL, np.abs(kkt - want).max()


@pytest.mark.parametrize("name", list(TRAJS))
def test_the_replay_runs_no_kernel(name):
    """The torch backend with its tensor-code setup: no kernel and no
    kernel's plain version ran."""
    _, _, plain, launches = _replay(name)
    assert not any(plain.values()) and not any(launches.values())
