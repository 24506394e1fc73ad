"""Each kernel's plain PyTorch version against the real JAX Pallas function
in interpret mode (how the JAX package's own tests run the TPU kernels on
the CPU), on the WBC QP shape n = 42, m = 70 with B = 5 scenarios (no
multiple of any tile), equality rows, +-1e20 one-sided bounds and an
all-zero row in A.

Tolerances on max |a - b| / max(1, max |b|): float64 1e-9; float32 1e-4 for
the scalings and the polish (other summation order); for the ADMM
iterates 1e-3 on x, z and 1e-2 on y (40 chained iterations with a clip
amplify the rounding noise, and the dual update multiplies it by the
penalty rho = 500 on equality rows; measured 3e-4 and 3e-3 here).  The float32 residual outputs (pr, du, sv) are
cancellations at float32's noise floor, where two summation orders differ
by about the value itself: they are held to 5e-3, the size of the
residuals they report."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.ops.pallas import polish_kernel as jpk
from quadrupedwholebodycontroller_tpu.ops.pallas import prepare_kernel as jprk
from quadrupedwholebodycontroller_tpu.ops.pallas import qp_kernel as jqk
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import admm_zy, polish, prepare
from tests._torch_port_util import scaled_err

B, N, M, K, START = 5, 42, 70, 12, 18
DT = {"float64": (np.float64, jnp.float64, torch.float64, 1e-9, 1e-9),
      "float32": (np.float32, jnp.float32, torch.float32, 1e-4, 5e-3)}


def _problem(npdt):
    """A WBC-structured QP batch: H = I(18) + SPD 12x12 + 1000 I(12)."""
    rng = np.random.default_rng(21)
    J = rng.standard_normal((B, K, 6))
    blk = J @ np.swapaxes(J, 1, 2) + np.eye(K)
    diag = np.concatenate([np.ones((B, START)), np.zeros((B, K)),
                           1000.0 * np.ones((B, N - START - K))], axis=1)
    H = np.zeros((B, N, N))
    H[:, np.arange(N), np.arange(N)] = diag
    H[:, START:START + K, START:START + K] = blk
    A = rng.standard_normal((B, M, N)) * rng.uniform(0.5, 4.0, (B, M, 1))
    A[:, 20, :] = 0.0                                    # a contact-masked row
    g = 5.0 * rng.standard_normal((B, N))
    x0 = 0.3 * rng.standard_normal((B, N))
    ax = np.einsum("bij,bj->bi", A, x0)
    l = ax - rng.uniform(0.1, 1.0, (B, M))
    u = ax + rng.uniform(0.1, 1.0, (B, M))
    l[:, :6] = ax[:, :6]
    u[:, :6] = ax[:, :6]                                 # equality rows
    l[:, 30:42] = -1e20
    u[:, 50:60] = 1e20                                   # one-sided rows
    warm = (0.1 * rng.standard_normal((B, N)), 0.1 * rng.standard_normal((B, M)),
            0.1 * rng.standard_normal((B, M)))
    c = lambda a: np.ascontiguousarray(a, npdt)
    return dict(H=c(H), A=c(A), g=c(g), l=c(l), u=c(u), wx=c(warm[0]), wz=c(warm[1]),
                wy=c(warm[2]), diag=c(diag), blk=c(blk))


@pytest.fixture(scope="module", params=["float64", "float32"])
def case(request):
    torch.set_num_threads(1)
    npdt, jdt, tdt, tol, tol_res = DT[request.param]
    p = _problem(npdt)
    j = lambda a: jnp.asarray(a, jdt)
    t = lambda a: torch.as_tensor(np.array(a))
    kw = dict(sweeps=4, rho0=0.5, rho_eq_scale=1000.0)
    keys = ("H", "A", "g", "l", "u", "wx", "wz", "wy")
    jprep = jprk.prepare_scaled(*(j(p[k]) for k in keys), **kw)
    tprep = prepare.prepare_scaled(*(t(p[k]) for k in keys), **kw)
    return dict(p=p, j=j, t=t, tol=tol, tol_res=tol_res, npdt=npdt,
                jprep=[np.asarray(a) for a in jprep], tprep=tprep)


PREP_NAMES = "sH sA sg sl su rho wxs wzs wys d e".split()


def test_prepare_scaled_plain_matches_pallas(case):
    assert len(case["tprep"]) == len(case["jprep"]) == 11
    for name, got, want in zip(PREP_NAMES, case["tprep"], case["jprep"]):
        assert got.shape == want.shape, name
        assert scaled_err(got.numpy(), want) <= case["tol"], (name, scaled_err(got.numpy(), want))
    rho = case["tprep"][5].numpy()
    assert np.all(rho[:, :6] == 500.0) and np.all(rho[:, 6:] == 0.5)


def test_admm_zy_plain_matches_pallas(case):
    j, t, npdt = case["j"], case["t"], case["npdt"]
    sH, sA, sg, sl, su, rho, wxs, wzs, wys, d, e = case["jprep"]
    K_ = sH.astype(np.float64) + np.einsum(
        "bmn,bm,bmk->bnk", sA.astype(np.float64), rho.astype(np.float64), sA.astype(np.float64))
    Kinv = np.linalg.inv(K_).astype(npdt)
    p = case["p"]
    args = (Kinv, sA, sg, sl, su, rho, wxs, wzs, wys, sH, p["l"], p["u"], d, e)
    want = jqk.admm_zy_iterations_res(*(j(a) for a in args), iters=40, alpha=1.6)
    got = admm_zy.admm_zy_iterations_res(*(t(a) for a in args), iters=40, alpha=1.6)
    f32 = npdt == np.float32
    for name, g_, w_ in zip("x z y".split(), got, want):
        # float32: 40 chained iterations amplify rounding noise, and the
        # dual update multiplies it by rho = 500 on the equality rows
        tol = case["tol"] if not f32 else (1e-2 if name == "y" else 1e-3)
        assert scaled_err(g_.numpy(), np.asarray(w_)) <= tol, name
    for name, g_, w_ in zip("pr du sv".split(), got[3:], want[3:]):
        assert g_.shape == (B,)
        assert np.abs(g_.numpy() - np.asarray(w_)).max() <= case["tol_res"], name


def test_polish_plain_matches_pallas(case):
    j, t, npdt, p = case["j"], case["t"], case["npdt"], case["p"]
    rng = np.random.default_rng(22)
    reg = 1e-9
    da = (rng.random((B, M)) < 0.4).astype(np.float64)
    da[:, :6] = 1.0
    da[:, 20] = 0.0
    da[:, 30:42] = np.where(da[:, 30:42] > 0, 1.0, 0.0)
    b = np.where(da > 0, np.where(np.abs(p["u"]) < 1e19, p["u"], p["l"]), 0.0)
    diag_reg = np.where(p["diag"] != 0, p["diag"].astype(np.float64) + reg, 0.0)
    blk_reg = p["blk"].astype(np.float64) + reg * np.eye(K)
    hi_diag = np.where(diag_reg != 0, 1.0 / np.where(diag_reg != 0, diag_reg, 1.0), 0.0)
    hi_blk = np.linalg.inv(blk_reg)
    Hinv = np.zeros((B, N, N))
    Hinv[:, np.arange(N), np.arange(N)] = hi_diag
    Hinv[:, START:START + K, START:START + K] = hi_blk
    Bm = da[:, :, None] * p["A"].astype(np.float64)
    S = Bm @ Hinv @ np.swapaxes(Bm, 1, 2)
    S[:, np.arange(M), np.arange(M)] += reg * da + (1.0 - da)
    Sinv = np.linalg.inv(S)
    c = lambda a: np.ascontiguousarray(a, npdt)
    Hc = (c(diag_reg), c(blk_reg))
    Hic = (c(hi_diag), c(hi_blk))
    rest = (c(Sinv), p["A"], c(da), p["g"], c(b), p["l"], p["u"])
    want = jpk.polish_solve(
        (j(Hc[0]), j(Hc[1]), START), (j(Hic[0]), j(Hic[1]), START),
        *(j(a) for a in rest), refine=5, reg=reg)
    got = polish.polish_solve(
        (t(Hc[0]), t(Hc[1]), START), (t(Hic[0]), t(Hic[1]), START),
        *(t(a) for a in rest), refine=5, reg=reg)
    for name, g_, w_ in zip("x y z".split(), got, want):
        assert scaled_err(g_.numpy(), np.asarray(w_)) <= case["tol"], name
    for name, g_, w_ in zip("pr du sv".split(), got[3:], want[3:]):
        assert g_.shape == (B,)
        assert np.abs(g_.numpy() - np.asarray(w_)).max() <= case["tol_res"], name
