"""The register-tiled warm Newton-Schulz kernel (`csrc/ns_warm.cu`, K8)
compiled as plain C++ (`ns_warm.ns_inverse_warm_host`: one emulated thread
a block, the items of every stage in rising or in falling order), without
the JAX package:

  * against `ns_inverse_warm_plain` at n = 42 and 70 (the output padded in
    i and j to the 4 x 4 tiles: 44 and 72) and at n = 44 and 56 (the tiles
    divide n; at 56 the row stride has four words more), float64 within
    1e-12 and float32 within 1e-5 of each matrix's largest entry;
  * a batch that mixes the accepted, the rejected (NaN, 1e9-scaled) and the
    blown-up cases gives each matrix bit for bit what it gives alone: the
    block-uniform branch that reuses the check's A W stays in its block;
  * the blown-up case returns the kernel's own X0 bit for bit (the X0 of a
    rejected warm start with no steps).

Needs a C++ compiler; once the host library is built the module takes a few
seconds."""
import shutil

import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu_torch.ops.kernels import ns_warm

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="needs a C++ compiler to build csrc/ns_warm.cu for the CPU")

DTYPES = ((torch.float64, 1e-12), (torch.float32, 1e-5))


def _matrices(n):
    """(A, W) float64 numpy, five cases: an accepted warm start; another of a
    perturbed problem; a NaN warm start and a 1e9-scaled one (both rejected
    by ||I - A W||_inf < 1e3); W = -500 A^-1 of a matrix scaled by 1e-20,
    accepted (||I - A W|| = 501) but whose iterate passes 1e30."""
    rng = np.random.default_rng(57 + n)
    M = rng.standard_normal((5, n, 42))
    A = M @ np.swapaxes(M, 1, 2) / 42 + 0.5 * np.eye(n)
    A[1] *= 1.001
    A[4] *= 1e-20
    Ainv = np.linalg.inv(A)
    W = Ainv.copy()
    W[1] = np.linalg.inv(A[1] / 1.001)
    W[2, 3, 5] = np.nan
    W[3] *= 1e9
    W[4] = -500.0 * Ainv[4]
    return A, W


def _rel(got, want):
    """Per matrix: max |got - want| / max |want|."""
    got, want = got.double().numpy(), want.double().numpy()
    return (np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))).max()


@pytest.fixture(scope="module", params=[42, 44, 56, 70])
def case(request):
    torch.set_num_threads(1)
    return _matrices(request.param)


@pytest.mark.parametrize("reverse", [False, True])
def test_host_matches_plain(case, reverse):
    A, W = case
    for dtype, tol in DTYPES:
        a, w = torch.as_tensor(A).to(dtype), torch.as_tensor(W).to(dtype)
        got = ns_warm.ns_inverse_warm_host(a, w, 2, reverse=reverse)
        want = ns_warm.ns_inverse_warm_plain(a, w, 2)
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= tol


@pytest.mark.parametrize("reverse", [False, True])
def test_mixed_batch_is_each_matrix_alone(case, reverse):
    A, W = case
    # accepted, rejected (NaN), blown up, rejected (far), accepted
    order = [0, 2, 4, 3, 1]
    for dtype, _ in DTYPES:
        a = torch.as_tensor(A[order]).to(dtype)
        w = torch.as_tensor(W[order]).to(dtype)
        batch = ns_warm.ns_inverse_warm_host(a, w, 2, reverse=reverse)
        for q in range(len(order)):
            alone = ns_warm.ns_inverse_warm_host(a[q:q + 1].contiguous(),
                                                 w[q:q + 1].contiguous(), 2,
                                                 reverse=not reverse)
            assert torch.equal(batch[q:q + 1], alone), (dtype, order[q])


def test_blowup_returns_its_x0(case):
    A, W = case
    for dtype, _ in DTYPES:
        a = torch.as_tensor(A[4:]).to(dtype)
        got = ns_warm.ns_inverse_warm_host(a, torch.as_tensor(W[4:]).to(dtype), 2)
        # a NaN warm start is rejected: with no step the kernel returns X0
        x0 = ns_warm.ns_inverse_warm_host(a, torch.full_like(a, float("nan")), 0)
        assert torch.equal(got, x0)
        assert _rel(x0, ns_warm._cold_x0(a)) <= 1e-6
