"""`csrc/setup.cu` compiled as plain C++ (`setup_batched_host`) with every
stage's items run in rising and in falling order gives the same outputs BIT
FOR BIT: no item of a stage reads what another item of the same stage
writes, whichever order the threads of a block take.  Plain and fused
variants, finite differences and exact mode, float32 and float64, and the
float32 section probes; B = 4, the problem of `test_torch_setup_kernel.py`
(a carry advanced two cycles, a contact switch in scenario 0, `ref_is_new`
False in scenario 2, `deriv_valid` False in scenario 3)."""
import shutil

import pytest
import torch

from quadrupedwholebodycontroller_tpu_torch.config import QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup as tsetup
from tests.test_torch_setup_kernel import _flat, _torch_problem


@pytest.fixture(scope="module")
def host_build():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("needs a C++ compiler to build csrc/setup.cu for the CPU")
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build

    return build.host_lib()


def _problem(dtype):
    model, cp, obs, ref, carry = _torch_problem(dtype, seed=7)
    carry = carry._replace(deriv_valid=torch.tensor([True, True, True, False]))
    return model, cp, obs, ref, carry, torch.tensor([True, True, False, True])


def _both_orders(problem, **kw):
    rising = _flat(tsetup.setup_batched_host(*problem, reverse=False, **kw))
    falling = _flat(tsetup.setup_batched_host(*problem, reverse=True, **kw))
    return rising, falling


@pytest.mark.parametrize("fused", [False, True], ids=["plain_variant", "fused"])
@pytest.mark.parametrize("exact", [False, True], ids=["fd", "exact"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rising_and_falling_item_order_agree_bit_for_bit(host_build, dtype, exact, fused):
    rising, falling = _both_orders(_problem(dtype), exact_mode=exact,
                                   qp_params=QPSolverParams() if fused else None)
    assert set(rising) == set(falling)
    for k in rising:
        a, b = torch.as_tensor(rising[k]), torch.as_tensor(falling[k])
        assert torch.equal(a, b), (k, float((a.double() - b.double()).abs().max()))


@pytest.mark.parametrize("exact", [False, True], ids=["fd", "exact"])
def test_section_probes_agree_bit_for_bit_in_both_orders(host_build, exact):
    problem = _problem("float32")
    for section in tsetup.SECTIONS:
        rising, falling = (tsetup.setup_batched_host(
            *problem, exact_mode=exact, stop_after=section, reverse=r)["com"]
            for r in (False, True))
        assert torch.equal(rising, falling), section
