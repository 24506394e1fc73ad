"""Linear algebra and compensated arithmetic of the PyTorch port against the
JAX functions.

Tolerances: float64 1e-10 absolute (same arithmetic, other summation
order); float32 1e-5 relative to the largest entry (Newton-Schulz on
matrices of condition ~1e2 plateaus near cond * eps on either side)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.ops import compensated as jcomp
from quadrupedwholebodycontroller_tpu.ops import linalg as jla
from quadrupedwholebodycontroller_tpu_torch.ops import compensated as comp
from quadrupedwholebodycontroller_tpu_torch.ops import linalg as la

DT = {"float64": (np.float64, jnp.float64, torch.float64, 1e-10),
      "float32": (np.float32, jnp.float32, torch.float32, 1e-5)}


def _spd(rng, B, n, npdt):
    M = rng.standard_normal((B, n, n))
    return (M @ np.swapaxes(M, 1, 2) / n + 0.5 * np.eye(n)).astype(npdt)


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = got.double().numpy()
    return np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [12, 42])
def test_ns_inverse_cold(dtype, n):
    npdt, jdt, tdt, tol = DT[dtype]
    A = _spd(np.random.default_rng(n), 5, n, npdt)
    want = jla.ns_inverse(jnp.asarray(A, jdt), 30)
    got = la.ns_inverse(torch.as_tensor(A), 30, body_prec="high", tail=10)
    assert _close(got, want, tol)
    # and it is an inverse
    eye = np.eye(n)
    assert np.abs(A.astype(np.float64) @ got.double().numpy() - eye).max() < (
        1e-9 if dtype == "float64" else 5e-4)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ns_inverse_warm_and_guard(dtype):
    """Warm restart, a NaN-poisoned warm start and a wildly divergent one
    (||I - A W|| >= 1e3): the two bad ones fall back to the cold start."""
    npdt, jdt, tdt, tol = DT[dtype]
    rng = np.random.default_rng(3)
    A = _spd(rng, 6, 20, npdt)
    W = np.linalg.inv(A.astype(np.float64)).astype(npdt)
    A2 = (A * (1.0 + 0.01 * rng.standard_normal((6, 1, 1)))).astype(npdt)
    W[1] = np.nan
    W[4] = W[4] * 1e9
    for wi in (0, 2):
        want = jla.ns_inverse(jnp.asarray(A2, jdt), 30, warm=jnp.asarray(W, jdt), warm_iters=wi)
        got = la.ns_inverse(torch.as_tensor(A2), 30, warm=torch.as_tensor(W), warm_iters=wi)
        assert torch.isfinite(got).all()
        assert _close(got, want, tol), wi


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ns_inverse_warm_shared(dtype):
    npdt, jdt, tdt, tol = DT[dtype]
    rng = np.random.default_rng(4)
    A = _spd(rng, 6, 20, npdt)
    W = np.linalg.inv(A.astype(np.float64)).astype(npdt)
    A2 = (A * (1.0 + 0.01 * rng.standard_normal((6, 1, 1)))).astype(npdt)
    W[2] = np.inf
    W[5] = W[5] * 1e9
    want = jla.ns_inverse_warm_shared(jnp.asarray(A2, jdt), jnp.asarray(W, jdt), 2)
    got = la.ns_inverse_warm_shared(torch.as_tensor(A2), torch.as_tensor(W), 2)
    assert torch.isfinite(got).all()
    assert _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_closed_form_inverses(dtype):
    npdt, jdt, tdt, tol = DT[dtype]
    rng = np.random.default_rng(5)
    for n, jf, tf in ((3, jla.inv3, la.inv3), (6, jla.spd_inv6, la.spd_inv6),
                      (12, jla.spd_inv12, la.spd_inv12)):
        A = _spd(rng, 7, n, npdt)
        assert _close(tf(torch.as_tensor(A)), jf(jnp.asarray(A, jdt)), tol), n
    A = _spd(rng, 7, 9, npdt)
    assert _close(la._cold_init(torch.as_tensor(A)), jla._cold_init(jnp.asarray(A, jdt)), tol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_compensated_matches_jax(dtype):
    npdt, jdt, tdt, tol = DT[dtype]
    rng = np.random.default_rng(6)
    M = (1e3 * rng.standard_normal((4, 30, 50))).astype(npdt)
    x = rng.standard_normal((4, 50)).astype(npdt)
    b = (M.astype(np.float64) @ x.astype(np.float64)[..., None])[..., 0].astype(npdt)
    d = rng.standard_normal((4, 30)).astype(npdt)
    v = rng.standard_normal((4, 30)).astype(npdt)
    j = lambda a: jnp.asarray(a, jdt)
    t = torch.as_tensor
    # the compensated results are accurate to ~eps * |result|, so the two
    # sides agree far more tightly than a plain matvec would: hold them
    # to the plain tolerance of the RESULT's magnitude
    assert _close(comp.comp_matvec(t(M), t(x)), jcomp.comp_matvec(j(M), j(x)), tol)
    want = np.asarray(jcomp.comp_residual(j(b), j(M), j(x)), np.float64)
    got = comp.comp_residual(t(b), t(M), t(x)).double().numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(b).max() * (1 if dtype == "float32" else 1e-8)
    want = np.asarray(jcomp.comp_residual_chain(
        j(b), mat_terms=((j(M), j(x)),), diag_terms=((j(d), j(v)),)), np.float64)
    got = comp.comp_residual_chain(
        t(b), mat_terms=((t(M), t(x)),), diag_terms=((t(d), t(v)),)).double().numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(b).max() * (1 if dtype == "float32" else 1e-8)


def test_two_sum_and_two_prod_are_error_free_in_float32():
    """TwoSum / TwoProd on float32 CPU tensors: s + e == a + b and
    p + e == a * b EXACTLY, checked in float64 (which holds the sum of two
    float32 of nearby exponents and the 48-bit product of two float32
    exactly).  Fails if PyTorch ever fuses the steps into an FMA."""
    rng = np.random.default_rng(7)
    a = torch.as_tensor((rng.standard_normal(20000) * 10.0 ** rng.integers(-3, 4, 20000)).astype(np.float32))
    b = torch.as_tensor((rng.standard_normal(20000) * 10.0 ** rng.integers(-3, 4, 20000)).astype(np.float32))
    s, e = comp._two_sum(a, b)
    assert s.dtype == torch.float32 and e.dtype == torch.float32
    assert torch.equal(s.double() + e.double(), a.double() + b.double())
    assert (e != 0).any()
    p, e = comp._two_prod(a, b)
    assert torch.equal(p.double() + e.double(), a.double() * b.double())
    assert (e != 0).any()


def test_compensated_residual_beats_plain_float32():
    """The point of the module: r = b - M x with ~1e4-magnitude terms and a
    tiny true residual is noise in plain float32 and accurate compensated."""
    rng = np.random.default_rng(8)
    M = (1e4 * rng.standard_normal((3, 40, 60))).astype(np.float32)
    x = rng.standard_normal((3, 60)).astype(np.float32)
    exact = (M.astype(np.float64) @ x.astype(np.float64)[..., None])[..., 0]
    b = exact.astype(np.float32)
    true_r = b.astype(np.float64) - exact
    t = torch.as_tensor
    plain = (t(b) - torch.einsum("bij,bj->bi", t(M), t(x))).double().numpy()
    compd = comp.comp_residual(t(b), t(M), t(x)).double().numpy()
    assert np.abs(compd - true_r).max() < 1e-2 * np.abs(plain - true_r).max()
