"""The compact-H polish kernel's source, `csrc/polish.cu` in its compact
form, compiled as plain C++ (one emulated thread per block, the items of every
stage in rising and in falling order: `polish.polish_solve_host`) against
`polish.polish_solve_plain`, which `tests/test_torch_kernels_plain.py`
holds to the JAX package's Pallas kernel.

Three cases, each in float64 and float32:
  * "walk": the polish inputs of recorded walking step 60 (one leg in
    swing: masked friction rows, equality rows and +-1e20 bounds), built
    with the port's tensor code and plain versions from a warm ADMM iterate
    as the control step builds them, B = 3 perturbed scenarios (no multiple
    of any tile), block at start 18, five refinement passes;
  * "resolving": the same problems far from converged (H^-1 and the Schur
    inverse scaled by 0.7, one refinement pass), where pr, du and sv are
    1e-2..1 and not at the rounding floor;
  * "synthetic": the WBC-structured QP batch of
    `tests/test_torch_kernels_plain.py` (B = 5, an all-zero row of A);
  * "odd": a random QP batch of odd sizes (B = 2, n = 9, m = 15, a 3 x 3
    block at start 2), where the kernel takes no paired loads.
Every output is held to max |host - plain| <= tol * max(1, max |plain|):
1e-12 in float64, 1e-5 in float32 (the two sum the same terms in another
order).  Also: the wrapper refuses a problem whose block would not fit.
Needs a C++ compiler."""
import shutil

import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu_torch import replay
from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import qp
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import admm_zy, polish, prepare
from quadrupedwholebodycontroller_tpu_torch.ops.linalg import ns_inverse
from tests._torch_port_util import load_walk, scaled_err
from tests.test_torch_kernels_plain import K, START, _problem

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="needs a C++ compiler to build csrc/polish.cu for the CPU")

B_WALK = 3
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _walk_inputs():
    """(H, Hinv, Sinv, A, da, g, b, l, u) float64 of walking step 60, and the
    solver parameters."""
    dt, dev = torch.float64, "cpu"
    model = anymal_d_model(dt, dev)
    cp, qpp = ControllerParams(), QPSolverParams()
    rng = np.random.default_rng(61)
    obs, ref, _ = replay.step_inputs(load_walk(), 60, B_WALK, dt,
                                     replay.make_offsets(B_WALK, dt, rng, dev), dev)
    carry = wbc.init_carry(B_WALK, dt, dev)
    carry = carry._replace(prev_contacts=ref.contacts.clone())
    d = wbc.wbc_setup(model, cp, obs, ref, carry,
                      torch.ones(B_WALK, dtype=torch.bool)).qp_data
    n, m = d.A.shape[-1], d.A.shape[-2]
    z = qp.QPState.zeros(B_WALK, n, m, dt, dev)
    pk = dict(sweeps=qpp.scaling_iters, rho0=qpp.rho, rho_eq_scale=qpp.rho_eq_scale)
    sH, sA, sg, sl, su, rho, _, _, _, ds, es = prepare.prepare_scaled_plain(
        d.H, d.A, d.g, d.l, d.u, z.x, z.z, z.y, **pk)
    Kinv = ns_inverse(sH + (sA.transpose(-1, -2) * rho[:, None, :]) @ sA, qpp.ns_iters)
    x, zz, y, *_ = admm_zy.admm_zy_iterations_res_plain(
        Kinv, sA, sg, sl, su, rho, z.x, z.z, z.y, sH, d.l, d.u, ds, es,
        iters=qpp.cold_iterations, alpha=qpp.alpha)
    warm = qp.QPState(x=ds * x, z=zz / es, y=es * y)
    Hinv = wbc._wbc_polish_hinv(d.H, qpp.polish_reg)
    start, k = Hinv[2], Hinv[1].shape[-1]
    diag = torch.diagonal(d.H, dim1=-2, dim2=-1) + qpp.polish_reg
    diag = torch.cat([diag[:, :start], torch.zeros_like(diag[:, :k]),
                      diag[:, start + k:]], dim=1)
    H = (diag, d.H[:, start:start + k, start:start + k]
         + qpp.polish_reg * torch.eye(k, dtype=dt), start)
    da, b = qp._assemble_active(d, warm)
    S = da[:, :, None] * da[:, None, :] * (d.A @ qp._blockdiag_dense(Hinv)
                                           @ d.A.transpose(-1, -2)) \
        + torch.diag_embed(qpp.polish_reg * da + (1.0 - da))
    Sinv = ns_inverse(S, qpp.ns_iters)
    return (H, Hinv, Sinv, d.A, da, d.g, b, d.l, d.u), qpp


def _synthetic_inputs():
    """The QP batch of tests/test_torch_kernels_plain.py with its active set."""
    p = _problem(np.float64)
    reg, (B, M, N) = 1e-9, p["A"].shape
    rng = np.random.default_rng(22)
    da = (rng.random((B, M)) < 0.4).astype(np.float64)
    da[:, :6] = 1.0
    da[:, 20] = 0.0
    b = np.where(da > 0, np.where(np.abs(p["u"]) < 1e19, p["u"], p["l"]), 0.0)
    diag_reg = np.where(p["diag"] != 0, p["diag"] + reg, 0.0)
    blk_reg = p["blk"] + reg * np.eye(K)
    hi_diag = np.where(diag_reg != 0, 1.0 / np.where(diag_reg != 0, diag_reg, 1.0), 0.0)
    hi_blk = np.linalg.inv(blk_reg)
    Hinv = np.zeros((B, N, N))
    Hinv[:, np.arange(N), np.arange(N)] = hi_diag
    Hinv[:, START:START + K, START:START + K] = hi_blk
    Bm = da[:, :, None] * p["A"]
    S = Bm @ Hinv @ np.swapaxes(Bm, 1, 2)
    S[:, np.arange(M), np.arange(M)] += reg * da + (1.0 - da)
    t = torch.as_tensor
    return ((t(diag_reg), t(blk_reg), START), (t(hi_diag), t(hi_blk), START),
            t(np.linalg.inv(S)), t(p["A"]), t(da), t(p["g"]), t(b), t(p["l"]),
            t(p["u"])), reg


def _odd_inputs():
    """A random strictly convex QP batch with n, m and k odd."""
    rng = np.random.default_rng(23)
    B, n, m, k, start, reg = 2, 9, 15, 3, 2, 1e-9
    J = rng.standard_normal((B, k, 2))
    blk = J @ np.swapaxes(J, 1, 2) + np.eye(k) + reg * np.eye(k)
    diag = np.where((np.arange(n) >= start) & (np.arange(n) < start + k), 0.0,
                    rng.uniform(0.5, 3.0, (B, n)) + reg)
    hi_diag = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1.0), 0.0)
    hi_blk = np.linalg.inv(blk)
    Hinv = np.zeros((B, n, n))
    Hinv[:, np.arange(n), np.arange(n)] = hi_diag
    Hinv[:, start:start + k, start:start + k] = hi_blk
    A = rng.standard_normal((B, m, n))
    da = (rng.random((B, m)) < 0.5).astype(np.float64)
    l, u = -rng.uniform(0.1, 1.0, (B, m)), rng.uniform(0.1, 1.0, (B, m))
    u[:, 3] = 1e20
    b = np.where(da > 0, u, 0.0)
    b[:, 3] = np.where(da[:, 3] > 0, l[:, 3], 0.0)
    Bm = da[:, :, None] * A
    S = Bm @ Hinv @ np.swapaxes(Bm, 1, 2)
    S[:, np.arange(m), np.arange(m)] += reg * da + (1.0 - da)
    t = torch.as_tensor
    return ((t(diag), t(blk), start), (t(hi_diag), t(hi_blk), start),
            t(np.linalg.inv(S)), t(A), t(da), t(rng.standard_normal((B, n))), t(b),
            t(l), t(u)), reg


@pytest.fixture(scope="module")
def cases():
    torch.set_num_threads(1)
    walk, qpp = _walk_inputs()
    H, Hinv, Sinv, *tail = walk
    scaled = (Hinv[0] * 0.7, Hinv[1] * 0.7, Hinv[2])
    synth, reg = _synthetic_inputs()
    return {
        "walk": (walk, dict(refine=qpp.polish_refine, reg=qpp.polish_reg)),
        "resolving": ((H, scaled, 0.7 * Sinv, *tail), dict(refine=1, reg=qpp.polish_reg)),
        "synthetic": (synth, dict(refine=5, reg=reg)),
        "odd": (_odd_inputs()[0], dict(refine=3, reg=1e-9)),
    }


def _cast(args, dtype):
    cast = lambda a: a.to(dtype).contiguous() if isinstance(a, torch.Tensor) else a
    return tuple(tuple(cast(x) for x in a) if isinstance(a, tuple) else cast(a)
                 for a in args)


@pytest.mark.parametrize("reverse", [False, True], ids=["rising", "falling"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["walk", "resolving", "synthetic", "odd"])
def test_compact_source_compiled_for_the_cpu_matches_plain(cases, case, dtype, reverse):
    args, kw = cases[case]
    args = _cast(args, dtype)
    want = polish.polish_solve_plain(*args, **kw)
    got = polish.polish_solve_host(*args, **kw, reverse=reverse)
    for name, g_, w_ in zip("x y z pr du sv".split(), got, want):
        assert g_.shape == w_.shape and g_.dtype == dtype, name
        err = scaled_err(g_.numpy(), w_.numpy())
        assert err <= TOL[dtype], (case, name, err)
    pr, du, sv = (w_.double() for w_ in want[3:])
    if case == "resolving":        # far from converged: the residuals are held
        assert float(torch.maximum(pr, du).min()) > 1e-3
    else:                          # converged: a polish that did nothing fails
        assert float(want[0].abs().max()) > 1e-2 and float(du.max()) < 1e-4


def test_host_wrapper_refuses_what_shared_memory_cannot_hold():
    n, m, k, B = 42, 200, 12, 1
    z = lambda *s: torch.zeros(s, dtype=torch.float64)
    H = (z(B, n), z(B, k, k), 18)
    with pytest.raises(ValueError, match="shared memory"):
        polish.polish_solve_host(H, H, z(B, m, m), z(B, m, n), z(B, m), z(B, n), z(B, m),
                                 z(B, m), z(B, m), refine=1, reg=1e-9)
