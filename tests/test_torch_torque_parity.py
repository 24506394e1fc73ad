"""Torque parity of the port's plain path, no JAX: all 200 steps of the
recorded walk `data/walk_traj_400hz.npz`, unperturbed, at B = 2 in float32
from `init_carry` (cache invalid on step 0, carry and cache threaded),
against the float64 torque record `data/torque_cpu64.npz`.

Two configurations:

  * certificate: `rescue_threshold = 1e-5`.  The staged rescue then fires
    on every step the two polish rounds leave above 1e-5, and scenario 0's
    torque stays within 1e-3 N.m of the record at EVERY step (measured max
    1.5e-4 N.m, max relative KKT 1.3e-7).
  * shipped defaults: `rescue_threshold = 3e-3`.  Steps whose polish
    candidate is rejected keep the ADMM iterate (relative KKT up to ~2e-3,
    under the rescue threshold), which is up to 0.34 N.m from the record;
    the JAX package's kernel path does the same on the CPU
    (`tests/test_torch_wbc_step.py` holds that; see ROADMAP Queue 3).  What holds here: max KKT <= 3e-3 at every step, and every
    step the solver certifies (KKT < 1e-5) is within 1e-3 N.m."""
import os

import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu_torch import replay
from quadrupedwholebodycontroller_tpu_torch.config import QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import kernels
from tests._torch_port_util import ROOT, load_walk

B = 2
BAR_NM = 1e-3


def _replay(qpp):
    torch.set_num_threads(1)
    traj = load_walk()
    model = anymal_d_model(torch.float32, "cpu")
    taus, kkts = [], []

    def on_step(t, out, ms):
        taus.append(out.tau[0].double().numpy())
        kkts.append(float(out.qp_info.kkt_residual[0]))

    replay.replay(model, traj, range(traj["base_R"].shape[0]), B, qpp, on_step=on_step)
    ref_tau = np.load(os.path.join(ROOT, "data", "torque_cpu64.npz"))["tau"]
    err = np.abs(np.stack(taus) - ref_tau).max(axis=1)
    return err, np.asarray(kkts), np.stack(taus)


@pytest.fixture(scope="module")
def certificate():
    return _replay(QPSolverParams(rescue_threshold=1e-5))


@pytest.fixture(scope="module")
def defaults():
    kernels.reset_counts()
    out = _replay(QPSolverParams())
    return out + (kernels.launch_counts(), kernels.plain_counts())


def test_certificate_config_holds_the_torque_bar_at_every_step(certificate):
    err, kkt, tau = certificate
    assert err.shape == (200,) and np.isfinite(tau).all()
    assert err.max() <= BAR_NM, (int(err.argmax()), err.max())
    assert np.percentile(err, 99) <= 5e-4
    assert kkt.max() <= 1e-5


def test_defaults_hold_the_kkt_gate_at_every_step(defaults):
    err, kkt, tau, _, _ = defaults
    assert np.isfinite(tau).all()
    assert kkt.max() <= 3e-3, kkt.max()


def test_defaults_certified_steps_hold_the_torque_bar(defaults):
    err, kkt, _, _, _ = defaults
    cert = kkt < 1e-5
    assert cert.sum() >= 4          # the standing steps before the gait starts
    assert err[cert].max() <= BAR_NM
    # the measured envelope of the uncertified steps (ADMM accuracy): a
    # regression of the solver shows here first
    assert np.median(err) <= 2e-2 and err.max() <= 0.5


def test_cpu_replay_ran_on_the_plain_versions(defaults):
    _, _, _, launches, plain = defaults
    assert all(v == 0 for v in launches.values())
    assert plain["prepare_scaled"] == 200
    assert plain["admm_zy_iterations_res"] >= 200
    assert plain["polish_solve_compact"] >= 200
