"""The x-space ADMM kernels' plain versions (K5 `admm_iterations_res_plain`,
K6 `admm_iterations_plain`) against the JAX package's Pallas functions
`qp_kernel.admm_iterations_res` / `admm_iterations` in interpret mode, on the
WBC QP shape n = 42, m = 70 with B = 5 scenarios (equality rows, +-1e20
one-sided bounds, an all-zero row of A), 10 iterations from a non-zero warm
start, at sigma = 1e-6 (the tuned setting) and sigma = 0.1 (where the
proximal term moves the path visibly).

Tolerances on max |a - b| / max(1, max |b|): float64 1e-9; float32 as for
the constraint-space kernel K1: 1e-3 on x and z, 1e-2 on y (chained
iterations with a clip amplify the rounding noise, and the dual update
multiplies it by rho = 500 on equality rows), 5e-3 absolute on the residual
outputs pr, du, sv (cancellations at float32's noise floor)."""
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.ops.pallas import qp_kernel as jqk
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import admm, prepare
from tests._torch_port_util import scaled_err
from tests.test_torch_kernels_plain import _problem

ITERS, ALPHA = 10, 1.6
DT = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}


@pytest.fixture(scope="module", params=[(dt, s) for dt in DT for s in (1e-6, 0.1)],
                ids=lambda p: f"{p[0]}-sigma{p[1]:g}")
def case(request):
    """(args, sigma, npdt): the scaled problem, K^-1 of sH + sigma I +
    A^T diag(rho) A, the unscaled bounds and the scalings, as numpy."""
    import jax.numpy as jnp

    torch.set_num_threads(1)
    name, sigma = request.param
    npdt, tdt = DT[name]
    p = _problem(np.float64)
    t = lambda a: torch.as_tensor(np.array(a))
    prep = prepare.prepare_scaled_plain(
        *(t(p[k]) for k in ("H", "A", "g", "l", "u", "wx", "wz", "wy")),
        sweeps=4, rho0=0.5, rho_eq_scale=1000.0)
    sH, sA, sg, sl, su, rho, wxs, wzs, wys, d, e = (a.numpy() for a in prep)
    K = sH + sigma * np.eye(sH.shape[-1]) + np.einsum("bmn,bm,bmk->bnk", sA, rho, sA)
    c = lambda a: np.ascontiguousarray(a, npdt)
    args = tuple(c(a) for a in (np.linalg.inv(K), sA, sg, sl, su, rho, wxs, wzs, wys,
                                sH, p["l"], p["u"], d, e))
    jdt = jnp.float64 if name == "float64" else jnp.float32
    j = lambda a: jnp.asarray(a, jdt)
    kw = dict(iters=ITERS, sigma=sigma, alpha=ALPHA)
    want_res = [np.asarray(a) for a in jqk.admm_iterations_res(*(j(a) for a in args), **kw)]
    want = [np.asarray(a) for a in jqk.admm_iterations(*(j(a) for a in args[:9]), **kw)]
    return dict(args=args, kw=kw, want_res=want_res, want=want, f32=npdt == np.float32)


def _tol(f32, name):
    if not f32:
        return 1e-9
    return 1e-2 if name == "y" else 1e-3


def test_admm_iterations_res_plain_matches_pallas(case):
    t = lambda a: torch.as_tensor(a)
    got = admm.admm_iterations_res(*(t(a) for a in case["args"]), **case["kw"])
    for name, g_, w_ in zip("x z y".split(), got, case["want_res"]):
        assert scaled_err(g_.numpy(), w_) <= _tol(case["f32"], name), name
    for name, g_, w_ in zip("pr du sv".split(), got[3:], case["want_res"][3:]):
        assert g_.shape == (5,)
        tol = 5e-3 if case["f32"] else 1e-9
        assert np.abs(g_.numpy() - w_).max() <= tol, name
    # the iterate moved off the warm start and the residuals are live
    assert scaled_err(got[0].numpy(), case["args"][6]) > 1e-3
    assert float(got[3].max()) > 1e-6


def test_admm_iterations_plain_matches_pallas(case):
    t = lambda a: torch.as_tensor(a)
    got = admm.admm_iterations(*(t(a) for a in case["args"][:9]), **case["kw"])
    assert len(got) == 3
    for name, g_, w_ in zip("x z y".split(), got, case["want"]):
        assert scaled_err(g_.numpy(), w_) <= _tol(case["f32"], name), name
    # K6 is K5's loop: the same iterates
    res = admm.admm_iterations_res(*(t(a) for a in case["args"]), **case["kw"])
    for a, b in zip(got, res):
        assert torch.equal(a, b)


def test_cpu_tensors_count_plain_calls_only(case):
    from quadrupedwholebodycontroller_tpu_torch.ops import kernels

    kernels.reset_counts()
    t = lambda a: torch.as_tensor(a)
    admm.admm_iterations_res(*(t(a) for a in case["args"]), **case["kw"])
    admm.admm_iterations(*(t(a) for a in case["args"][:9]), **case["kw"])
    assert admm.PLAIN_CALLS == {"admm_iterations_res": 1, "admm_iterations": 1}
    assert admm.LAUNCHES == {"admm_iterations_res": 0, "admm_iterations": 0}
