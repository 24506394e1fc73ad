"""The dense-H polish kernel's source, `csrc/polish.cu` in its dense form
(kernel K7), compiled as plain C++ (one emulated thread per block, the
items of every stage in rising and in falling order:
`polish.polish_solve_host`) against `polish.polish_solve_plain`, which
`tests/test_torch_polish_dense.py` holds to the JAX package's Pallas kernel.

Four cases, each in float64 and float32:
  * "generic": the QP batch of `tests/test_torch_polish_dense.py` (a dense
    SPD H, B = 5, an all-zero row of A, +-1e20 one-sided bounds, equality
    rows), five refinement passes;
  * "resolving": the same problems far from converged (H^-1 and the Schur
    inverse scaled by 0.7, one refinement pass), where pr, du and sv are
    not at the rounding floor;
  * "odd": a random QP batch of odd sizes (B = 2, n = 9, m = 15), where the
    dot products end inside their last batch of eight;
  * "bounds": the generic batch with bounds beyond the +-1e20 clamp: on
    inactive rows, free rows at +-inf and at +-1e30, a row below -1e30
    (u = -1e30) and one above 1e30 (l = 1e30), where z is -1e20 and 1e20
    once u is clipped; and an active row (a multiplier y != 0) with both
    bounds below -1e20, which reads as an equality row only once l is
    clipped too (the sign violation takes no distance there).  These rows
    show that the kernel clips l and u itself.
Every output is held to max |host - plain| <= tol * max(1, max |plain|):
1e-12 in float64, 1e-5 in float32 (the two sum the same terms in another
order).  Also: the wrapper refuses a problem that shared memory cannot hold.
Needs a C++ compiler."""
import shutil

import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu_torch.ops.kernels import polish
from tests._torch_port_util import scaled_err
from tests.test_torch_polish_dense import REG, _dense_problem, _schur_inv

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="needs a C++ compiler to build csrc/polish.cu for the CPU")

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# row: (l, u, active); an active row is held at its generic bound b
BEYOND = {7: (-np.inf, np.inf, 0), 8: (-1e30, 1e30, 0), 9: (-np.inf, -1e30, 0),
          10: (1e30, np.inf, 0), 11: (-1e30, -np.inf, 1)}


def _generic():
    p, H_reg, Hinv, Sinv, da, b = _dense_problem()
    return [H_reg, Hinv, Sinv, p["A"], da, p["g"], b, p["l"], p["u"]]


def _beyond_the_clamp():
    """The generic batch with the rows of BEYOND set beyond +-1e20."""
    H_reg, Hinv, _, A, da, g, b, l, u = _generic()
    da, b, l, u = da.copy(), b.copy(), l.copy(), u.copy()
    for r, (lo, hi, active) in BEYOND.items():
        b[:, r] = np.where(active, u[:, r], 0.0)
        da[:, r], l[:, r], u[:, r] = active, lo, hi
    return [H_reg, Hinv, _schur_inv(A, Hinv, da), A, da, g, b, l, u]


def _odd():
    """A random strictly convex QP batch with n and m odd."""
    rng = np.random.default_rng(26)
    B, n, m = 2, 9, 15
    L = rng.standard_normal((B, n, n))
    H = L @ np.swapaxes(L, 1, 2) / n + np.eye(n) + REG * np.eye(n)
    Hinv = np.linalg.inv(H)
    A = rng.standard_normal((B, m, n))
    da = (rng.random((B, m)) < 0.5).astype(np.float64)
    l, u = -rng.uniform(0.1, 1.0, (B, m)), rng.uniform(0.1, 1.0, (B, m))
    u[:, 3] = 1e20
    b = np.where(da > 0, u, 0.0)
    b[:, 3] = np.where(da[:, 3] > 0, l[:, 3], 0.0)
    Bm = da[:, :, None] * A
    S = Bm @ Hinv @ np.swapaxes(Bm, 1, 2)
    S[:, np.arange(m), np.arange(m)] += REG * da + (1.0 - da)
    return [H, Hinv, np.linalg.inv(S), A, da, rng.standard_normal((B, n)), b, l, u]


@pytest.fixture(scope="module")
def cases():
    torch.set_num_threads(1)
    generic = _generic()
    resolving = list(generic)
    resolving[1], resolving[2] = 0.7 * generic[1], 0.7 * generic[2]
    return {"generic": (generic, 5), "resolving": (resolving, 1), "odd": (_odd(), 3),
            "bounds": (_beyond_the_clamp(), 5)}


@pytest.mark.parametrize("reverse", [False, True], ids=["rising", "falling"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["generic", "resolving", "odd", "bounds"])
def test_dense_source_compiled_for_the_cpu_matches_plain(cases, case, dtype, reverse):
    arrays, refine = cases[case]
    args = [torch.as_tensor(np.ascontiguousarray(a)).to(dtype) for a in arrays]
    want = polish.polish_solve_plain(*args, refine=refine, reg=REG)
    got = polish.polish_solve_host(*args, refine=refine, reg=REG, reverse=reverse)
    for name, g_, w_ in zip("x y z pr du sv".split(), got, want):
        assert g_.shape == w_.shape and g_.dtype == dtype, name
        err = scaled_err(g_.numpy(), w_.numpy())
        assert err <= TOL[dtype], (case, name, err)
    pr, du, sv = (w_.double() for w_ in want[3:])
    if case == "resolving":        # far from converged: the residuals are held
        assert float(torch.maximum(pr, du).min()) > 1e-3
    else:                          # converged: a polish that did nothing fails
        assert float(want[0].abs().max()) > 1e-2 and float(du.max()) < 1e-4
    if case == "bounds":           # the rows beyond the clamp, clipped
        big = torch.tensor(1e20, dtype=dtype)
        assert bool((want[2][:, 9] == -big).all()) and bool((want[2][:, 10] == big).all())
        assert float(want[1][:, 11].abs().min()) > 1e-3


def test_host_wrapper_refuses_what_shared_memory_cannot_hold():
    n, m, B = 42, 200, 1
    z = lambda *s: torch.zeros(s, dtype=torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        polish.polish_solve_host(z(B, n, n), z(B, n, n), z(B, m, m), z(B, m, n), z(B, m),
                                 z(B, n), z(B, m), z(B, m), z(B, m), refine=1, reg=1e-9)
