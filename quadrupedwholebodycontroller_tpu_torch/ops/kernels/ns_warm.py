"""Safeguarded warm Newton-Schulz inverse of SPD matrices (kernel K8).

`ns_inverse_warm` replaces the JAX package's Pallas kernel
`ops/pallas/ns_kernel.py::ns_inverse_warm_pallas` (`_ns_warm_kernel`):

  * start from W unless ||I - A W||_inf < 1e3 fails (false for NaN), then
    from the Jacobi-scaled cold start X0 (`_cold_x0` there);
  * `warm_iters` steps X <- X (2I - A X);
  * where max |X| < 1e30 fails (a blown-up or NaN iterate), return X0.

As in the JAX package, nothing on the control step calls it: the solver's
warm updates go through `ops.linalg.ns_inverse_warm_shared`, whose final
guard is `isfinite` where this one is 1e30.

On a CUDA tensor the wrapper launches `csrc/ns_warm.cu`; on a CPU tensor it
takes `ns_inverse_warm_plain`.  `ns_inverse_warm_host` runs the same CUDA
source compiled as plain C++ (tests only).
"""
from __future__ import annotations

import ctypes

import torch

from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build

LAUNCHES = {"ns_inverse_warm": 0}
PLAIN_CALLS = {"ns_inverse_warm": 0}


def _smem_bytes(n: int, itemsize: int) -> int:
    """The kernel's shared memory (csrc/ns_warm.cu ns_warm_words): four
    n x ld matrices and four vectors of n; ld is n rounded up to 4, four
    more where a quarter of it is even."""
    width = -(-n // 4) * 4
    ld = width if (width // 4) % 2 else width + 4
    return itemsize * (4 * n * ld + 4 * n + 4)


def _cold_x0(A):
    """Jacobi-scaled X0 with ||I - A X0|| < 1, in the Pallas kernel's order:
    (A o dd) o dd / (r1 c1), dd = d d^T, d = |diag A|^-1/2."""
    d = torch.rsqrt(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)) + 1e-30)
    dd = d[:, :, None] * d[:, None, :]
    As = A * dd
    r1 = torch.amax(torch.sum(torch.abs(As), dim=-1), dim=-1)   # inf-norm
    c1 = torch.amax(torch.sum(torch.abs(As), dim=-2), dim=-1)   # 1-norm
    return As * dd / (r1 * c1)[:, None, None]


def ns_inverse_warm_plain(A, warm, warm_iters: int = 2):
    """Plain PyTorch version, in the kernel's operation order."""
    PLAIN_CALLS["ns_inverse_warm"] += 1
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    err = torch.amax(torch.sum(torch.abs(eye - A @ warm), dim=-1), dim=-1)
    X0 = _cold_x0(A)
    X = torch.where((err < 1e3)[:, None, None], warm, X0)
    for _ in range(warm_iters):
        X = X @ (2.0 * eye - A @ X)
    big = torch.amax(torch.abs(X), dim=(-2, -1))
    # amax propagates NaN, and NaN < 1e30 is False
    return torch.where((big < 1e30)[:, None, None], X, X0)


def _check(A, warm, device_type):
    B, n, _ = A.shape
    suffix = build.check_inputs(A, {"A": (A, (B, n, n)), "warm": (warm, (B, n, n))},
                                device_type)
    if _smem_bytes(n, A.element_size()) > build.SMEM_BYTES:
        raise ValueError(
            f"ns_inverse_warm kernel holds four n x ld matrices in shared memory: "
            f"n={n} in {A.dtype} needs {_smem_bytes(n, A.element_size())} bytes, "
            f"more than {build.SMEM_BYTES}")
    return suffix


def ns_inverse_warm(A, warm, warm_iters: int = 2):
    """A, warm (B, n, n), A symmetric positive definite (the product A W is
    taken as written; the Pallas kernel contracts A's leading axis, the same
    for symmetric A).  Returns X (B, n, n).  Refuses an input that requires
    grad (`build.refuse_grad`)."""
    build.refuse_grad("ns_inverse_warm", A, warm)
    if A.device.type == "cpu":
        return ns_inverse_warm_plain(A, warm, warm_iters)
    suffix = _check(A, warm, "cuda")
    X = torch.empty_like(A)
    if A.shape[0] == 0:
        return X
    build.launch("ns_warm", suffix, A.data_ptr(), warm.data_ptr(), X.data_ptr(),
                 A.shape[0], A.shape[-1], int(warm_iters),
                 torch.cuda.current_stream(A.device).cuda_stream)
    LAUNCHES["ns_inverse_warm"] += 1
    return X


def ns_inverse_warm_host(A, warm, warm_iters: int = 2, reverse: bool = False):
    """`csrc/ns_warm.cu` compiled as plain C++ and run on CPU tensors, one
    emulated thread per block (`build.host_lib`); `reverse` runs every
    stage's items in falling order.  Needs a C++ compiler; counts as no
    launch."""
    suffix = _check(A, warm, "cpu")
    lib = build.host_lib()
    X = torch.empty_like(A)
    ctypes.c_int.in_dll(lib, "qwbc_host_reverse").value = int(reverse)
    err = getattr(lib, f"qwbc_ns_warm_{suffix}")(
        A.data_ptr(), warm.data_ptr(), X.data_ptr(), A.shape[0], A.shape[-1],
        int(warm_iters), None)
    if err != 0:
        raise RuntimeError(f"host build of the ns_warm kernel failed ({err})")
    return X
