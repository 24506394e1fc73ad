"""Non-finite inputs through the fused setup kernel's prepare tail.

`csrc/prepare_tail.cuh` holds H as its diagonal and its 12 x 12 block and
skips the structural zeros, which the dense chain of `prepare_scaled_plain`
multiplies as 0 * d_j * d_i: +0 while the scalings are finite, NaN where
one is not.  The tail keeps that NaN with its own branches (`sweep_flags`,
the early NaN of a diagonal or block column, the A column's max scaled
once).  Here `csrc/setup.cu` compiled as plain C++ (`setup_batched_host`,
fused, B = 4, the problem of `test_torch_setup_kernel.py`) runs on planted
NaN and inf, and its d, e, sH and sA have the same non-finite entries as
`prepare_scaled_plain` on the kernel's own H, A, g, l, u and warm start:

* one scenario's base rotation or joint angle NaN or inf: the other three
  scenarios' outputs stay bit for bit those of the unplanted run;
* the slack weight (H's diagonal outside the block) or the friction
  coefficient (A's columns of the block) inf or NaN, after 1, 2 and 3 Ruiz
  sweeps: the first sweeps leave the scalings non-finite in part (outside
  the block, or inside it alone), so the next sweep runs each branch."""
import dataclasses
import shutil

import pytest
import torch

from quadrupedwholebodycontroller_tpu_torch.config import QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import prepare
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup as tsetup
from tests.test_torch_setup_kernel import _torch_problem

CHECKED = {"sH": 0, "sA": 1, "d": 9, "e": 10}   # their places in `prepared`
RN = torch.tensor([True, True, False, True])
NAN, INF = float("nan"), float("inf")
PLANTED = 2   # the scenario a per-scenario plant goes into


@pytest.fixture(scope="module")
def host_build():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("needs a C++ compiler to build csrc/setup.cu for the CPU")
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build

    return build.host_lib()


def _plant_obs(field, index, value):
    def plant(cp, obs):
        t = getattr(obs, field).clone()
        t[(PLANTED, *index)] = value
        return cp, obs._replace(**{field: t})
    return plant


def _plant_gain(name, value):
    return lambda cp, obs: (dataclasses.replace(cp, **{name: value}), obs)


def _run(dtype, sweeps, plant=None):
    """The host build's result and the plain prepare of its H and A."""
    model, cp, obs, ref, carry = _torch_problem(dtype, seed=3)
    if plant is not None:
        cp, obs = plant(cp, obs)
    qpp = QPSolverParams(scaling_iters=sweeps)
    r = tsetup.setup_batched_host(model, cp, obs, ref, carry, RN, qp_params=qpp)
    warm = wbc._switch_masked_warm(carry, r["carry_updates"]["switch_flag"])
    plain = prepare.prepare_scaled_plain(
        r["H"], r["A"], r["g"], r["l"], r["u"], warm.x, warm.z, warm.y, sweeps=sweeps,
        rho0=qpp.rho, rho_eq_scale=qpp.rho_eq_scale)
    return r, plain


def _hold_masks(r, plain, scenarios):
    for name, k in CHECKED.items():
        got, want = r["prepared"][k][scenarios], plain[k][scenarios]
        assert torch.equal(~torch.isfinite(got), ~torch.isfinite(want)), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("field,index,value", [
    ("base_R", (0, 1), NAN), ("base_R", (0, 1), INF),
    ("q", (4,), NAN), ("q", (4,), INF)], ids=["R_nan", "R_inf", "q_nan", "q_inf"])
def test_one_planted_scenario_keeps_the_dense_chains_non_finite_entries(
        host_build, dtype, field, index, value):
    r, plain = _run(dtype, 4, _plant_obs(field, index, value))
    _hold_masks(r, plain, [PLANTED])
    assert not bool(torch.isfinite(plain[CHECKED["d"]][PLANTED]).all())
    clean, _ = _run(dtype, 4)
    others = [b for b in range(4) if b != PLANTED]
    for k in CHECKED.values():
        assert torch.equal(r["prepared"][k][others], clean["prepared"][k][others]), k


@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("name,value", [
    ("slack_weight", INF), ("slack_weight", NAN), ("friction", INF), ("friction", NAN)])
def test_a_non_finite_gain_keeps_the_dense_chains_non_finite_entries(
        host_build, name, value, sweeps):
    r, plain = _run("float32", sweeps, _plant_gain(name, value))
    _hold_masks(r, plain, slice(None))


def test_the_gains_leave_the_scalings_non_finite_in_part(host_build):
    """Guards the cases above: after these sweeps the scalings d are
    non-finite outside the block alone, or inside it alone, so the sweep
    after them reads a partly non-finite d."""
    bad = lambda plain: set((~torch.isfinite(plain[CHECKED["d"]][0])).nonzero()
                            .flatten().tolist())
    _, slack = _run("float32", 2, _plant_gain("slack_weight", INF))
    assert bad(slack) == set(range(30, 42))
    _, friction = _run("float32", 1, _plant_gain("friction", NAN))
    assert bad(friction) and bad(friction) <= set(range(18, 30))
