"""The dense-H polish (kernel K7) through `polish.polish_solve_plain`:

  * against the JAX package's Pallas `polish_kernel.polish_solve` with dense
    H and H^-1 (interpret mode) on a generic QP batch at n = 42, m = 70,
    B = 5: a dense SPD H, an active set with equality rows, +-1e20 one-sided
    bounds and an all-zero row of A, the Schur inverse from the active set;
    max |a - b| / max(1, max |b|) <= 1e-9 in float64, 1e-4 in float32 on
    x, y, z and 5e-3 absolute on pr, du, sv (as for the compact kernel K2);
  * against the compact variant on a block-diagonal H, in float64: the
    dense matvec only adds exact zeros, so the two agree to 1e-12;
  * the wrapper refuses H and H^-1 of different forms."""
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.ops.pallas import polish_kernel as jpk
from quadrupedwholebodycontroller_tpu_torch.ops import kernels
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import polish
from tests._torch_port_util import scaled_err
from tests.test_torch_kernels_plain import _problem

B, N, M, K, START, REG = 5, 42, 70, 12, 18, 1e-9


def _active(p, seed):
    rng = np.random.default_rng(seed)
    da = (rng.random((B, M)) < 0.4).astype(np.float64)
    da[:, :6] = 1.0
    da[:, 20] = 0.0
    b = np.where(da > 0, np.where(np.abs(p["u"]) < 1e19, p["u"], p["l"]), 0.0)
    return da, b


def _schur_inv(A, Hinv, da):
    Bm = da[:, :, None] * A
    S = Bm @ Hinv @ np.swapaxes(Bm, 1, 2)
    S[:, np.arange(M), np.arange(M)] += REG * da + (1.0 - da)
    return np.linalg.inv(S)


def _dense_problem():
    """A generic dense SPD H (not block diagonal) beside the WBC problem's
    A, g and bounds."""
    p = _problem(np.float64)
    rng = np.random.default_rng(23)
    L = rng.standard_normal((B, N, N))
    H = L @ np.swapaxes(L, 1, 2) / N + np.eye(N)
    H_reg = H + REG * np.eye(N)
    Hinv = np.linalg.inv(H_reg)
    da, b = _active(p, 24)
    return p, H_reg, Hinv, _schur_inv(p["A"], Hinv, da), da, b


@pytest.mark.parametrize("name", ["float64", "float32"])
def test_dense_polish_plain_matches_pallas(name):
    import jax.numpy as jnp

    torch.set_num_threads(1)
    npdt = np.float64 if name == "float64" else np.float32
    jdt = jnp.float64 if name == "float64" else jnp.float32
    p, H_reg, Hinv, Sinv, da, b = _dense_problem()
    c = lambda a: np.ascontiguousarray(a, npdt)
    args = tuple(c(a) for a in (H_reg, Hinv, Sinv, p["A"], da, p["g"], b, p["l"], p["u"]))
    want = jpk.polish_solve(*(jnp.asarray(a, jdt) for a in args), refine=5, reg=REG)
    kernels.reset_counts()
    got = polish.polish_solve(*(torch.as_tensor(a) for a in args), refine=5, reg=REG)
    assert polish.PLAIN_CALLS == {"polish_solve_compact": 0, "polish_solve_dense": 1}
    tol = 1e-9 if npdt == np.float64 else 1e-4
    for o, g_, w_ in zip("x y z".split(), got, want):
        assert scaled_err(g_.numpy(), np.asarray(w_)) <= tol, o
    for o, g_, w_ in zip("pr du sv".split(), got[3:], want[3:]):
        assert g_.shape == (B,)
        assert np.abs(g_.numpy() - np.asarray(w_)).max() <= (
            1e-9 if npdt == np.float64 else 5e-3), o
    # a converged polish: the certificate is small, so zeros would not pass
    assert float(got[0].abs().max()) > 1e-2 and float(got[4].max()) < 1e-6


def test_dense_plain_equals_compact_plain_on_block_diagonal_h():
    torch.set_num_threads(1)
    p = _problem(np.float64)
    diag_reg = np.where(p["diag"] != 0, p["diag"] + REG, 0.0)
    blk_reg = p["blk"] + REG * np.eye(K)
    hi_diag = np.where(diag_reg != 0, 1.0 / np.where(diag_reg != 0, diag_reg, 1.0), 0.0)
    hi_blk = np.linalg.inv(blk_reg)
    dense = lambda dg, bk: np.stack([np.diag(dg[i]) for i in range(B)]) + np.pad(
        bk, ((0, 0), (START, N - START - K), (START, N - START - K)))
    H_reg, Hinv = dense(diag_reg, blk_reg), dense(hi_diag, hi_blk)
    da, b = _active(p, 25)
    t = lambda a: torch.as_tensor(np.array(a))
    rest = (t(_schur_inv(p["A"], Hinv, da)), t(p["A"]), t(da), t(p["g"]), t(b),
            t(p["l"]), t(p["u"]))
    got_d = polish.polish_solve_plain(t(H_reg), t(Hinv), *rest, refine=3, reg=REG)
    got_c = polish.polish_solve_plain((t(diag_reg), t(blk_reg), START),
                                      (t(hi_diag), t(hi_blk), START), *rest,
                                      refine=3, reg=REG)
    for o, a_, b_ in zip("x y z pr du sv".split(), got_d, got_c):
        assert scaled_err(a_.numpy(), b_.numpy()) <= 1e-12, o


def test_mixed_forms_raise():
    p, H_reg, Hinv, Sinv, da, b = _dense_problem()
    t = lambda a: torch.as_tensor(np.array(a))
    compact = (t(np.ones((B, N))), t(np.ones((B, K, K))), START)
    rest = (t(Sinv), t(p["A"]), t(da), t(p["g"]), t(b), t(p["l"]), t(p["u"]))
    for H, Hi in ((t(H_reg), compact), (compact, t(Hinv))):
        with pytest.raises(ValueError, match="must both be dense or both compact"):
            polish.polish_solve(H, Hi, *rest, refine=1, reg=REG)
