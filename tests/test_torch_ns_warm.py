"""The safeguarded warm Newton-Schulz inverse (kernel K8):

  * `ns_inverse_warm_plain` against the JAX package's Pallas
    `ns_kernel.ns_inverse_warm_pallas` (interpret mode) at n = 42 and 70,
    B = 5, warm_iters = 2, float64, <= 1e-12 of each matrix's largest
    entry.  The five matrices: an accepted warm start, another accepted one
    of a perturbed problem, a NaN warm start and a 1e9-scaled one (both
    rejected by ||I - A W||_inf < 1e3: the un-iterated Jacobi start X0
    comes back iterated), and a warm start W = -500 A^-1 of a matrix scaled
    by 1e-20, accepted (||I - A W|| = 501) but whose iterate passes 1e30
    (|X_2| ~ 501^4 |A^-1|): X0 comes back as it is;
  * `csrc/ns_warm.cu` compiled as plain C++ (one emulated thread per block,
    the items of every stage in rising and in falling order) against the
    plain version on the same matrices, 1e-12 (needs a C++ compiler);
  * the wrapper refuses what its shared memory cannot hold."""
import shutil

import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.ops.pallas.ns_kernel import ns_inverse_warm_pallas
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import ns_warm

B = 5


def _matrices(n):
    """(A, W) float64 numpy, the five cases above."""
    rng = np.random.default_rng(31 + n)
    M = rng.standard_normal((B, n, 42))
    A = M @ np.swapaxes(M, 1, 2) / 42 + 0.5 * np.eye(n)
    A[1] *= 1.001
    A[4] *= 1e-20
    Ainv = np.linalg.inv(A)
    W = Ainv.copy()
    W[1] = np.linalg.inv(A[1] / 1.001)          # the unperturbed problem's inverse
    W[2, 3, 5] = np.nan
    W[3] *= 1e9
    W[4] = -500.0 * Ainv[4]
    return A, W


def _rel(got, want):
    """Per matrix: max |got - want| / max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return (np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))).max()


@pytest.fixture(scope="module", params=[42, 70])
def case(request):
    import jax.numpy as jnp

    torch.set_num_threads(1)
    A, W = _matrices(request.param)
    want = np.asarray(ns_inverse_warm_pallas(jnp.asarray(A), jnp.asarray(W),
                                             warm_iters=2, interpret=True))
    return A, W, want


def test_plain_matches_pallas(case):
    A, W, want = case
    got = ns_warm.ns_inverse_warm(torch.as_tensor(A), torch.as_tensor(W), 2)
    assert _rel(got.numpy(), want) <= 1e-12
    # the three guarded cases really took their fallback
    x0 = ns_warm._cold_x0(torch.as_tensor(A)).numpy()
    eye = np.eye(A.shape[-1])
    assert np.abs(A[0] @ got[0].numpy() - eye).max() < 1e-8        # converged
    for b in (2, 3):                                                 # rejected warm
        assert np.isfinite(got[b].numpy()).all()
        assert _rel(got[b:b + 1].numpy(), x0[b:b + 1]) > 1e-3       # iterated from X0
    assert np.array_equal(got[4].numpy(), x0[4])                     # blown up -> X0
    assert np.abs(want[4]).max() < 1e30


@pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++") is None,
                    reason="needs a C++ compiler to build csrc/ns_warm.cu for the CPU")
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_source_compiled_for_the_cpu_matches_plain(case, reverse):
    A, W, _ = case
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        a, w = torch.as_tensor(A).to(dtype), torch.as_tensor(W).to(dtype)
        got = ns_warm.ns_inverse_warm_host(a, w, 2, reverse=reverse)
        want = ns_warm.ns_inverse_warm_plain(a, w, 2)
        assert _rel(got.double().numpy(), want.double().numpy()) <= tol


def test_too_large_raises():
    n = 120                                            # 4 n (n|1) doubles > 227 KB
    A = torch.eye(n, dtype=torch.float64).expand(1, n, n).contiguous()
    with pytest.raises(ValueError, match="shared memory"):
        ns_warm.ns_inverse_warm_host(A, A, 2)
