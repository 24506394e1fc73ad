"""Batched torch `wbc_setup` against `jax.vmap(wbc_setup)` in float64 over
consecutive recorded walking steps that include `ref_is_new` false ticks and
a contact switch (steps 38..42; the switch is published at step 40), carry
threaded on each side independently.  Every QPData leaf, h_c, the torque-map
inputs and every carry update are held to 1e-9 absolute: the two sides do
the same float64 arithmetic in another summation order on entries of
magnitude <= ~1e4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.control import wbc as jwbc
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from tests._torch_port_util import load_walk, make_offsets, step_arrays

B = 3
STEPS = (38, 39, 40, 41, 42)
ATOL = 1e-9


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    traj = load_walk()
    rng = np.random.default_rng(31)
    offsets = make_offsets(rng, B)
    jm = jax_model(dtype=jnp.float64)
    tm = anymal_d_model(torch.float64, "cpu")
    jcp, tcp = JaxControllerParams(), ControllerParams()
    jsetup = jax.jit(jax.vmap(lambda o, r, c, n: jwbc.wbc_setup(jm, jcp, o, r, c, n)))
    jc = jax.tree.map(lambda x: jnp.stack([x] * B), jwbc.init_carry(jnp.float64))
    tc = wbc.init_carry(B, torch.float64, "cpu")
    out = []
    for t in STEPS:
        obs, ref, new = step_arrays(traj, t, B, offsets)
        js = jsetup(jwbc.RobotObservation(**{k: jnp.asarray(v) for k, v in obs.items()}),
                    jwbc.Reference(**{k: jnp.asarray(v) for k, v in ref.items()}),
                    jc, jnp.full((B,), new))
        ts = wbc.wbc_setup(tm, tcp, convert.obs_from_numpy(obs, torch.float64, "cpu"),
                           convert.ref_from_numpy(ref, torch.float64, "cpu"), tc,
                           torch.full((B,), new))
        out.append((t, new, js, ts))
        jc = jwbc.WBCCarry(qp_warm=jc.qp_warm, **js.carry_updates)
        tc = wbc.WBCCarry(qp_warm=tc.qp_warm, **ts.carry_updates)
    return out


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b.double().numpy()).max())


@pytest.mark.parametrize("i", range(len(STEPS)), ids=[f"step{t}" for t in STEPS])
def test_setup_matches_jax(runs, i):
    t, new, js, ts = runs[i]
    for leaf in ("H", "g", "A", "l", "u"):
        assert _err(getattr(js.qp_data, leaf), getattr(ts.qp_data, leaf)) <= ATOL, (t, leaf)
    for f in ("h_c", "Mc_jj", "Jc_st_j", "com", "current_pose", "foot_pos"):
        assert _err(getattr(js, f), getattr(ts, f)) <= ATOL, (t, f)
    assert set(js.carry_updates) == set(ts.carry_updates)
    for k, v in js.carry_updates.items():
        got = ts.carry_updates[k]
        assert tuple(got.shape) == tuple(np.shape(v)), (t, k)
        assert _err(np.asarray(v).astype(np.float64), got) <= ATOL, (t, k)


def test_the_window_exercises_switch_and_held_flag(runs):
    """Guards the test itself: the window holds a not-new tick, the
    switch edge, the held switch flag after it, and live FD derivatives."""
    flags = {t: bool(ts.carry_updates["switch_flag"][0]) for t, _, _, ts in runs}
    news = {t: new for t, new, _, _ in runs}
    assert news == {38: False, 39: False, 40: True, 41: False, 42: False}
    assert flags == {38: False, 39: False, 40: True, 41: True, 42: True}
    _, _, _, ts39 = runs[1]
    assert float(ts39.carry_updates["tdot_inv"].abs().max()) > 0.0   # FD gate open
    _, _, _, ts40 = runs[2]
    assert float(ts40.carry_updates["tdot_inv"].abs().max()) == 0.0  # zeroed on switch
    A40 = ts40.qp_data.A[0]
    assert int((A40.abs().sum(-1) == 0).sum()) > 0                   # masked friction rows
