"""The x-space ADMM kernels' own source, `csrc/admm.cu`, compiled as plain
C++ (one emulated thread per block, the threads of every stage in rising
and in falling order: `admm.admm_iterations_res_host` for K5,
`admm.admm_iterations_host` for K6) against `admm.admm_iterations_res_plain`
/ `admm.admm_iterations_plain`, which `tests/test_torch_admm_x.py` holds to
the JAX package's Pallas functions.

Cases, each in float64 and float32, at sigma = 1e-6 (the sigma path's),
with K^-1 the inverse of the scaled sH + sigma I + A^T diag(rho) A:
  * "walk": the ADMM inputs of recorded walking step 60 as the main path
    hands them to the kernel (the warm start of
    `tests/test_torch_admm_zy_host.py`), B = 3, 40 iterations;
  * "resolving": the same problems from the cold start, 3 iterations: pr,
    du and sv are far from the rounding floor;
  * "odd": a random QP batch of odd sizes (B = 2, n = 9, m = 15) inside the
    register instantiation's maxima;
  * "above": a random QP batch above them (B = 2, n = 46, m = 75), which
    takes the shared-memory instantiation (as float64 does at every shape);
  * "walk_k6": K6 on the walk case.
Tolerances as in `tests/test_torch_admm_zy_host.py`, in share of each
output's scale, max(1, max |plain|): float64 within 1e-10 of the plain
version (they sum in other orders, and the kernel fuses the update's
products as the card does); float32 no further from the float64 plain
version (on the same float32-rounded inputs) than 4 times the float32 plain
version is, plus 1e-6.  Except for the residual outputs pr, du and sv of
the converged "walk" case in float32: there they are cancellations at
float32's rounding floor (as `chip_smoke.py`'s tolerance table says), two
valid float32 roundings of the 40 iterations give residuals that differ by
their own size, and the ratio of two such draws holds nothing (over eight
other draws of the step's offsets, the host build's du was 0.33 to 10
times as far from the float64 plain version as the float32 plain
version's; the constraint-space kernel's 0.37 to 2.2).  So in every case
the residuals are also held as the certificate of the output's own
iterate: pr, du and sv of the float32 output against the float64 plain
epilogue on the same x and y, within 4 times the float32 plain version's
own such distance, plus 1e-6.  The two stage orders must agree bit for
bit: no thread of a stage reads what another thread of the same stage
writes.  Also: the wrapper refuses a shape that neither instantiation
takes.  Needs a C++ compiler."""
import shutil

import pytest
import torch

from quadrupedwholebodycontroller_tpu_torch.ops.kernels import admm, build
from quadrupedwholebodycontroller_tpu_torch.ops.kernels.admm_zy import (
    _BIG,
    _mv,
    _mvt,
    kkt_epilogue,
)
from tests._torch_port_util import scaled_err
from tests.test_torch_admm_zy_host import _random_case, _walk_inputs

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="needs a C++ compiler to build csrc/admm.cu for the CPU")

SIGMA = 1e-6
TOL64 = 1e-10
GUARD, GUARD_ATOL = 4.0, 1e-6


def _with_sigma(args):
    """The kernel's arguments with K^-1 of the scaled matrix plus sigma I."""
    sA, rho, sH = args[1], args[5], args[9]
    K = sH + SIGMA * torch.eye(sH.shape[-1], dtype=sH.dtype) \
        + (sA.transpose(-1, -2) * rho[:, None, :]) @ sA
    return (torch.linalg.inv(K), *args[1:])


@pytest.fixture(scope="module")
def cases():
    torch.set_num_threads(1)
    cold, warm, qpp = _walk_inputs()
    kw = dict(iters=qpp.iterations, sigma=SIGMA, alpha=qpp.alpha)
    walk = (_with_sigma(warm), kw)
    return {
        "walk": walk,
        "resolving": (_with_sigma(cold), dict(kw, iters=3)),
        "odd": (_with_sigma(_random_case(2, 9, 15, 72)), kw),
        "above": (_with_sigma(_random_case(2, 46, 75, 73)), kw),
        "walk_k6": walk,
    }


def _cast(args, dtype):
    return tuple(a.to(dtype).contiguous() for a in args)


def _certificate64(args, x, y):
    """pr, du, sv of the iterate (x, y) by the plain epilogue in float64."""
    _, A, g, _, _, _, _, _, _, Hs, lo, uo, d, e = _cast(args, torch.float64)
    x, y = x.double(), y.double()
    lo, uo = torch.clamp(lo, -_BIG, _BIG), torch.clamp(uo, -_BIG, _BIG)
    return kkt_epilogue(_mv(A, x) / e, _mv(Hs, x) / d, _mvt(A, y) / d, g / d, e * y,
                        lo, uo)


@pytest.mark.parametrize("reverse", [False, True], ids=["rising", "falling"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["walk", "resolving", "odd", "above", "walk_k6"])
def test_admm_x_source_compiled_for_the_cpu_matches_plain(cases, case, dtype, reverse):
    args, kw = cases[case]
    if case == "walk_k6":
        args, host, plain = args[:9], admm.admm_iterations_host, admm.admm_iterations_plain
    else:
        host, plain = admm.admm_iterations_res_host, admm.admm_iterations_res_plain
    args = _cast(args, dtype)
    n, m = args[1].shape[-1], args[1].shape[-2]
    in_registers = build.host_lib().qwbc_admm_zy_in_registers(n, m, args[1].element_size())
    assert in_registers == (case != "above" and dtype == torch.float32)
    want = plain(*args, **kw)
    got = host(*args, **kw, reverse=reverse)
    want64 = plain(*_cast(args, torch.float64), **kw)
    assert len(got) == len(want) == (3 if case == "walk_k6" else 6)
    for name, g_, w_, w64 in zip("x z y pr du sv".split(), got, want, want64):
        assert g_.shape == w_.shape and g_.dtype == dtype, name
        if dtype == torch.float64:
            err = scaled_err(g_.numpy(), w_.numpy())
            assert err <= TOL64, (case, name, err)
        elif not (case == "walk" and name in ("pr", "du", "sv")):
            far = scaled_err(g_.numpy(), w64.numpy())
            bound = GUARD * scaled_err(w_.numpy(), w64.numpy()) + GUARD_ATOL
            assert far <= bound, (case, name, far, bound)
    if len(want) == 6 and dtype == torch.float32:   # the certificate of its own iterate
        own, plain_own = _certificate64(args, got[0], got[2]), _certificate64(args, want[0],
                                                                             want[2])
        for name, g_, c_, w_, cw in zip(("pr", "du", "sv"), got[3:], own, want[3:],
                                        plain_own):
            far = scaled_err(g_.numpy(), c_.numpy())
            bound = GUARD * scaled_err(w_.numpy(), cw.numpy()) + GUARD_ATOL
            assert far <= bound, (case, name, "own iterate", far, bound)
    if len(want) == 6:
        pr, du = (w_.double() for w_ in want[3:5])
        if case == "resolving":    # far from converged: the residuals are held
            assert float(torch.maximum(pr, du).min()) > 1e-3
        elif case == "walk":       # converged: an iteration that did nothing fails
            assert float(torch.maximum(pr, du).max()) < 1e-2
    if reverse:                    # the stages read nothing their own threads write
        again = host(*args, **kw, reverse=False)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_host_wrapper_refuses_a_shape_neither_instantiation_takes():
    n, m, B = 42, 1000, 1           # m + 2n threads: more than a block has
    z = lambda *s: torch.zeros(s, dtype=torch.float64)
    one = lambda *s: torch.ones(s, dtype=torch.float64)
    args = (z(B, n, n), z(B, m, n), z(B, n), z(B, m), z(B, m), one(B, m), z(B, n),
            z(B, m), z(B, m), z(B, n, n), z(B, m), z(B, m), one(B, n), one(B, m))
    with pytest.raises(ValueError, match="threads"):
        admm.admm_iterations_res_host(*args, iters=1, sigma=SIGMA, alpha=1.6)
    with pytest.raises(ValueError, match="threads"):
        admm.admm_iterations_host(*args[:9], iters=1, sigma=SIGMA, alpha=1.6)
