"""Constraint-space (sigma = 0) ADMM loop + residual epilogue (kernel K1).

`admm_zy_iterations_res` replaces the JAX package's Pallas pair
`ops/pallas/qp_kernel.py::admm_zy_iterations_res` (`_admm_zy_kernel` +
`_zy_epilogue_kernel`).  With sigma = 0 the (z, y) recursion closes over
A K^-1 A^T, applied as three chained matvecs on the scenario's resident
(A, K^-1); the relaxed x is recovered exactly from the accumulator
V_{k+1} = (1-alpha) V_k + alpha (rho z_k - y_k):

    x_K = (1-alpha)^K x_0 + K^-1 A^T V_K - (1 - (1-alpha)^K) K^-1 g.

The epilogue scores the UNSCALED pair against the unscaled bounds: relative
primal / dual residuals (OSQP normalization) and the sign violation sv.

On a CUDA tensor the wrapper launches `csrc/admm_zy.cu` (one launch for
loop and epilogue); on a CPU tensor it takes `admm_zy_iterations_res_plain`.
`admm_zy_iterations_res_host` runs the same source compiled as plain C++
(tests only).
"""
from __future__ import annotations

import ctypes

import torch

from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build

LAUNCHES = {"admm_zy_iterations_res": 0}
PLAIN_CALLS = {"admm_zy_iterations_res": 0}
# launches of each instantiation of csrc/admm_zy.cu (see the wrapper)
VARIANT_LAUNCHES = {"registers": 0, "shared_memory": 0}

THREADS_MAX = 1024

_BIG = 1e20   # one-sided bounds are clipped to +-1e20; finite is |.| < 1e19


def _mv(M, v):
    return torch.einsum("bij,bj->bi", M, v)


def _mvt(M, w):
    return torch.einsum("bij,bi->bj", M, w)


def kkt_epilogue(ax, hx, aty, gu, y_u, lo, uo):
    """Relative primal / dual residuals and sign violation of an unscaled
    pair from its products (shared by the ADMM and polish plain versions;
    bounds already clipped to +-1e20)."""
    fin_l = torch.where(torch.abs(lo) < 1e19, torch.abs(lo), torch.zeros_like(lo))
    fin_u = torch.where(torch.abs(uo) < 1e19, torch.abs(uo), torch.zeros_like(uo))
    finite_b = torch.maximum(torch.amax(fin_l, dim=-1), torch.amax(fin_u, dim=-1))
    one = torch.ones_like(finite_b)
    pscale = torch.maximum(
        one, torch.maximum(torch.amax(torch.abs(ax), dim=-1), finite_b))
    dscale = torch.maximum(
        one,
        torch.maximum(
            torch.amax(torch.abs(hx), dim=-1),
            torch.maximum(torch.amax(torch.abs(aty), dim=-1),
                          torch.amax(torch.abs(gu), dim=-1)),
        ),
    )
    clipped = torch.minimum(torch.maximum(ax, lo), uo)
    pr = torch.amax(torch.abs(ax - clipped), dim=-1) / pscale
    du = torch.amax(torch.abs(hx + gu + aty), dim=-1) / dscale
    big = torch.full_like(ax, _BIG)
    zero = torch.zeros_like(ax)
    eqr = (uo - lo) <= 1e-9
    d_up = torch.where(torch.abs(uo) < 1e19, torch.clamp_min(uo - ax, 0.0), big)
    d_lo = torch.where(torch.abs(lo) < 1e19, torch.clamp_min(ax - lo, 0.0), big)
    dist = torch.where(eqr, zero, torch.where(y_u > 0, d_up, d_lo))
    sv = torch.amax(
        torch.minimum(torch.abs(y_u) / dscale[:, None], dist / pscale[:, None]),
        dim=-1,
    )
    return pr, du, sv


def admm_zy_iterations_res_plain(Kinv, A, g, l, u, rho, x0, z0, y0,
                                 Hs, l_orig, u_orig, d, e,
                                 *, iters: int, alpha: float):
    """Plain PyTorch version, in the kernel's operation order."""
    PLAIN_CALLS["admm_zy_iterations_res"] += 1
    l = torch.clamp(l, -_BIG, _BIG)
    u = torch.clamp(u, -_BIG, _BIG)
    lo = torch.clamp(l_orig, -_BIG, _BIG)
    uo = torch.clamp(u_orig, -_BIG, _BIG)
    inv_rho = 1.0 / rho
    kg = _mv(Kinv, g)
    c = -_mv(A, kg)
    z, y, V = z0, y0, torch.zeros_like(z0)
    for _ in range(iters):
        t = rho * z - y
        z_t = _mv(A, _mv(Kinv, _mvt(A, t))) + c
        z_rel = alpha * z_t + (1.0 - alpha) * z
        z_n = torch.minimum(torch.maximum(z_rel + y * inv_rho, l), u)
        y = y + rho * (z_rel - z_n)
        V = (1.0 - alpha) * V + alpha * t
        z = z_n
    w0 = (1.0 - alpha) ** iters
    x = w0 * x0 + _mv(Kinv, _mvt(A, V)) - (1.0 - w0) * kg
    pr, du, sv = kkt_epilogue(
        _mv(A, x) / e, _mv(Hs, x) / d, _mvt(A, y) / d, g / d, e * y, lo, uo)
    return x, z, y, pr, du, sv


def _kernel_args(Kinv, A, g, l, u, rho, x0, z0, y0, Hs, l_orig, u_orig, d, e,
                 lib, device_type):
    """Check the kernel's inputs (device and host builds, `lib` the loaded
    library); returns (dtype suffix, pointer tensors in the launcher's
    order, the instantiation's name)."""
    B, m, n = A.shape
    # the kernel clips the bounds to +-1e20 itself (no launch here); a
    # strided view of them is copied
    l, u, lo, uo = (t.contiguous() for t in (l, u, l_orig, u_orig))
    ins = (Kinv, A, g, l, u, rho, x0, z0, y0, Hs, lo, uo, d, e)
    suffix = build.check_inputs(A, dict(zip(
        ("Kinv", "A", "g", "l", "u", "rho", "x0", "z0", "y0", "Hs", "l_orig",
         "u_orig", "d", "e"), zip(ins, (
            (B, n, n), (B, m, n), (B, n), (B, m), (B, m), (B, m), (B, n), (B, m),
            (B, m), (B, n, n), (B, m), (B, m), (B, n), (B, m))))), device_type)
    threads = lib.qwbc_admm_zy_threads(n, m)
    smem = lib.qwbc_admm_zy_words(n, m, A.element_size()) * A.element_size()
    if threads > THREADS_MAX or smem > build.SMEM_BYTES:
        raise ValueError(
            f"admm_zy kernel: n={n}, m={m} in {A.dtype} needs {threads} threads "
            f"(at most {THREADS_MAX}) and {smem} bytes of shared memory (at most "
            f"{build.SMEM_BYTES})")
    variant = ("registers" if lib.qwbc_admm_zy_in_registers(n, m, A.element_size())
               else "shared_memory")
    return suffix, ins, variant


def _scalars(alpha, iters):
    alpha = float(alpha)
    w0 = (1.0 - alpha) ** int(iters)
    return int(iters), alpha, 1.0 - alpha, w0, 1.0 - w0


def admm_zy_iterations_res(Kinv, A, g, l, u, rho, x0, z0, y0,
                           Hs, l_orig, u_orig, d, e,
                           *, iters: int, alpha: float):
    """Kinv (B,n,n) = K^-1 in SCALED space; A/g/l/u/rho scaled; Hs the
    scaled H; l_orig/u_orig the unscaled bounds; d/e the Ruiz scalings.
    Returns (x, z, y, pr, du, sv), x/z/y in scaled space.

    The kernel has two instantiations, chosen by shape and dtype alone: in
    float32 up to n = 44 variables and m = 72 rows (the WBC's 42 and 70)
    every thread keeps its matrix words in registers ("registers"); above
    that, and in float64, the same stages read them from shared memory
    ("shared_memory").  Both sum in the same order.  A shape neither takes
    (more than 1024 threads, i.e. m + 2n > 1024, or more shared memory than
    a block has) raises ValueError.  Refuses an input that requires grad
    (`build.refuse_grad`)."""
    build.refuse_grad("admm_zy_iterations_res", Kinv, A, g, l, u, rho, x0, z0, y0,
                      Hs, l_orig, u_orig, d, e)
    if A.device.type == "cpu":
        return admm_zy_iterations_res_plain(
            Kinv, A, g, l, u, rho, x0, z0, y0, Hs, l_orig, u_orig, d, e,
            iters=iters, alpha=alpha,
        )
    B, m, n = A.shape
    suffix, ins, variant = _kernel_args(Kinv, A, g, l, u, rho, x0, z0, y0, Hs,
                                        l_orig, u_orig, d, e, build.lib(), "cuda")
    new = lambda *shape: torch.empty(shape, dtype=A.dtype, device=A.device)
    outs = (new(B, n), new(B, m), new(B, m), new(B), new(B), new(B))
    if B == 0:
        return outs
    build.launch(
        "admm_zy", suffix,
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        B, n, m, *_scalars(alpha, iters),
        torch.cuda.current_stream(A.device).cuda_stream,
    )
    LAUNCHES["admm_zy_iterations_res"] += 1
    VARIANT_LAUNCHES[variant] += 1
    return outs


def admm_zy_iterations_res_host(Kinv, A, g, l, u, rho, x0, z0, y0,
                                Hs, l_orig, u_orig, d, e,
                                *, iters: int, alpha: float, reverse: bool = False):
    """`csrc/admm_zy.cu` compiled as plain C++ and run on CPU tensors, one
    emulated thread per block (`build.host_lib`), in the instantiation the
    shape selects; `reverse` runs every stage's threads in falling order.
    Needs a C++ compiler; counts as no launch."""
    B, m, n = A.shape
    lib = build.host_lib()
    suffix, ins, _ = _kernel_args(Kinv, A, g, l, u, rho, x0, z0, y0, Hs,
                                  l_orig, u_orig, d, e, lib, "cpu")
    new = lambda *shape: torch.empty(shape, dtype=A.dtype)
    outs = (new(B, n), new(B, m), new(B, m), new(B), new(B), new(B))
    ctypes.c_int.in_dll(lib, "qwbc_host_reverse").value = int(reverse)
    err = getattr(lib, f"qwbc_admm_zy_{suffix}")(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        B, n, m, *_scalars(alpha, iters), None)
    if err != 0:
        raise RuntimeError(f"host build of the admm_zy kernel failed ({err})")
    return outs
