"""The section probes of the fused setup kernel (`setup_batched(...,
stop_after=...)`, the port of the JAX kernel's `stop_after`), run through
`csrc/setup.cu` compiled as plain C++ (`setup_batched_host`): B = 4
perturbed scenarios in float32, a carry advanced two cycles, a contact
switch in scenario 0 (the problem of `test_torch_setup_kernel.py`).

Each probe writes the sum of its section's live values into `com`, three
copies.  Every section's sum is held against the JAX package's Pallas
kernel cut at the same section (`setup_batched(..., stop_after=...)`,
interpret mode, finite differences, the same float32 inputs; one Pallas
trace a section, 1-11 s each): within 1e-6 of max(1, |sum|), float32 sums
of the same terms added in another order; the `fd` sum within 1e-4, since
its finite differences multiply the roundings of both Jacobians by
1/dt = 400.  The `inputs` and `fk` sums are also formed here again from the
inputs and from the port's tensor-code kinematics (`ops.kinematics`), in
float64; they may differ from the kernel's float32 sums by float32
roundings of the terms and of the sum: 1e-5 of the sum of the terms'
magnitudes."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.control import wbc as jwbc
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.ops import qp as jqp
from quadrupedwholebodycontroller_tpu.ops.pallas import setup_kernel as jsetup
from quadrupedwholebodycontroller_tpu_torch.ops import kinematics
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup as tsetup
from tests.test_torch_setup_kernel import B, _flat, _torch_problem

TOL = 1e-5
TOL_JAX = {"fd": 1e-4}   # 1e-6 for every other section


@pytest.fixture(scope="module")
def host_build():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("needs a C++ compiler to build csrc/setup.cu for the CPU")
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build

    return build.host_lib()


@pytest.fixture(scope="module")
def problem():
    model, cp, obs, ref, carry = _torch_problem("float32", seed=5)
    return model, cp, obs, ref, carry, torch.tensor([True, True, False, True])


def _probe(problem, section, exact=False):
    com = tsetup.setup_batched_host(*problem, exact_mode=exact, stop_after=section)["com"]
    assert torch.equal(com[:, 0], com[:, 1]) and torch.equal(com[:, 0], com[:, 2])
    return com[:, 0].double()


def _hold(got, terms):
    want = sum(t.double().reshape(B, -1).sum(-1) for t in terms)
    scale = sum(t.double().abs().reshape(B, -1).sum(-1) for t in terms)
    assert bool(((got - want).abs() <= TOL * scale).all()), (got, want)


@pytest.mark.parametrize("exact", [False, True], ids=["fd", "exact"])
@pytest.mark.parametrize("section", tsetup.SECTIONS)
def test_every_section_writes_a_finite_checksum(host_build, problem, section, exact):
    com = _probe(problem, section, exact)
    assert bool(torch.isfinite(com).all()) and bool((com != 0).any())


@pytest.fixture(scope="module")
def jax_problem(problem):
    """The same float32 problem as the JAX package's arguments."""
    _, _, obs, ref, carry, rn = problem
    jn = lambda t: jnp.asarray(t.numpy())
    jcarry = jwbc.WBCCarry(
        **{k: jn(getattr(carry, k)) for k in carry._fields if k != "qp_warm"},
        qp_warm=jqp.QPState(*(jn(getattr(carry.qp_warm, k)) for k in "xzy")))
    return (jax_model(dtype=jnp.float32), JaxControllerParams(),
            jwbc.RobotObservation(*(jn(t) for t in obs)),
            jwbc.Reference(*(jn(t) for t in ref)), jcarry, jn(rn))


@pytest.mark.parametrize("section", tsetup.SECTIONS)
def test_section_checksum_matches_the_pallas_kernel(host_build, problem, jax_problem,
                                                    section):
    com = np.asarray(jsetup.setup_batched(*jax_problem, interpret=True,
                                          stop_after=section)["com"])
    assert np.array_equal(com[:, 0], com[:, 1]) and np.array_equal(com[:, 0], com[:, 2])
    want = com[:, 0].astype(np.float64)
    got = _probe(problem, section).numpy()
    tol = TOL_JAX.get(section, 1e-6) * np.maximum(1.0, np.abs(want))
    assert bool((np.abs(got - want) <= tol).all()), (section, got, want)


def test_inputs_checksum_is_the_sum_of_the_inputs(host_build, problem):
    _, _, obs, ref, carry, rn = problem
    contacts = torch.where(rn[:, None], ref.contacts, carry.prev_contacts)
    changed = (ref.contacts != carry.prev_contacts).any(-1)
    switch = torch.where(rn, changed, carry.switch_flag).to(obs.q.dtype)
    q = obs.q.double()
    _hold(_probe(problem, "inputs"), [obs.base_R, obs.base_p, obs.base_vel, obs.qd,
                                      torch.sin(q), torch.cos(q), contacts, switch])


def test_fk_checksum_is_the_sum_of_the_tensor_code_kinematics(host_build, problem):
    model, _, obs, *_ = problem
    kin = kinematics.forward_kinematics(model, obs.base_R, obs.base_p, obs.q)
    _hold(_probe(problem, "fk"), [kin.body_R[:, 1:], kin.body_p, kin.body_com_w,
                                  kin.joint_axis_w])


def test_no_stop_after_leaves_every_output_as_it_was(host_build, problem):
    """A probe run leaves no state behind, and without `stop_after` the
    kernel is whole: the same outputs bit for bit, com the centre of mass."""
    full = _flat(tsetup.setup_batched_host(*problem))
    _probe(problem, "fd")
    again = _flat(tsetup.setup_batched_host(*problem, stop_after=None))
    for k in full:
        assert torch.equal(torch.as_tensor(full[k]), torch.as_tensor(again[k])), k
    plain = tsetup.setup_batched_plain(*problem)
    assert torch.allclose(torch.as_tensor(full["com"]), plain["com"], atol=1e-5, rtol=0)


def test_stop_after_refuses_what_it_does_not_take(host_build, problem):
    with pytest.raises(ValueError, match="none of"):
        tsetup.setup_batched_host(*problem, stop_after="wrench")
    model, cp, obs, ref, carry = _torch_problem("float64", seed=5)
    with pytest.raises(ValueError, match="float32"):
        tsetup.setup_batched_host(model, cp, obs, ref, carry, True, stop_after="fk")
    with pytest.raises(ValueError, match="CUDA"):
        tsetup.setup_batched(*problem, stop_after="fk")
