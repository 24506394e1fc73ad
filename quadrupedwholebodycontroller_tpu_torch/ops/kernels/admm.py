"""x-space ADMM loop with the proximal term sigma (kernel K5 with its
residual epilogue, K6 without it).

`admm_iterations_res` and `admm_iterations` replace the JAX package's Pallas
functions `ops/pallas/qp_kernel.py::admm_iterations_res` (`_admm_res_kernel`)
and `::admm_iterations` (`_admm_kernel`).  Each iteration, on the scaled
problem with K^-1 = (H + sigma I + A^T diag(rho) A)^-1:

    t = rho z - y          x~ = K^-1 (sigma x - g + A^T t)      z~ = A x~
    x = alpha x~ + (1-alpha) x          z_rel = alpha z~ + (1-alpha) z
    z = clip(z_rel + y / rho, l, u)     y = y + rho (z_rel - z)

The epilogue is the constraint-space kernel's: relative primal / dual
residuals (OSQP normalization) and the sign violation sv of the UNSCALED
pair against the unscaled bounds.

On a CUDA tensor the wrappers launch `csrc/admm.cu` (one template, the
epilogue on or off; the constraint-space kernel's register design); on a
CPU tensor they take the `*_plain` versions.  `admm_iterations_res_host` and
`admm_iterations_host` run the same source compiled as plain C++ (tests
only).
"""
from __future__ import annotations

import ctypes

import torch

from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build
from quadrupedwholebodycontroller_tpu_torch.ops.kernels.admm_zy import (
    _BIG,
    THREADS_MAX,
    _mv,
    _mvt,
    kkt_epilogue,
)

LAUNCHES = {"admm_iterations_res": 0, "admm_iterations": 0}
PLAIN_CALLS = {"admm_iterations_res": 0, "admm_iterations": 0}
# launches of each instantiation of csrc/admm.cu, K5 and K6 together
VARIANT_LAUNCHES = {"registers": 0, "shared_memory": 0}


def _clip(v):
    return torch.clamp(v, -_BIG, _BIG)


def _loop_plain(Kinv, A, g, l, u, rho, x, z, y, iters, sigma, alpha):
    inv_rho = 1.0 / rho
    for _ in range(iters):
        t = rho * z - y
        x_t = _mv(Kinv, sigma * x - g + _mvt(A, t))
        z_t = _mv(A, x_t)
        x = alpha * x_t + (1.0 - alpha) * x
        z_rel = alpha * z_t + (1.0 - alpha) * z
        z_n = torch.minimum(torch.maximum(z_rel + y * inv_rho, l), u)
        y = y + rho * (z_rel - z_n)
        z = z_n
    return x, z, y


def admm_iterations_plain(Kinv, A, g, l, u, rho, x0, z0, y0,
                          *, iters: int, sigma: float, alpha: float):
    """Plain PyTorch version of K6, in the kernel's operation order."""
    PLAIN_CALLS["admm_iterations"] += 1
    return _loop_plain(Kinv, A, g, _clip(l), _clip(u), rho, x0, z0, y0,
                       iters, sigma, alpha)


def admm_iterations_res_plain(Kinv, A, g, l, u, rho, x0, z0, y0,
                              Hs, l_orig, u_orig, d, e,
                              *, iters: int, sigma: float, alpha: float):
    """Plain PyTorch version of K5, in the kernel's operation order."""
    PLAIN_CALLS["admm_iterations_res"] += 1
    lo, uo = _clip(l_orig), _clip(u_orig)
    x, z, y = _loop_plain(Kinv, A, g, _clip(l), _clip(u), rho, x0, z0, y0,
                          iters, sigma, alpha)
    pr, du, sv = kkt_epilogue(
        _mv(A, x) / e, _mv(Hs, x) / d, _mvt(A, y) / d, g / d, e * y, lo, uo)
    return x, z, y, pr, du, sv


_IN_NAMES = ("Kinv", "A", "g", "l", "u", "rho", "x0", "z0", "y0",
             "Hs", "l_orig", "u_orig", "d", "e")


def _kernel_args(ins, lib, device_type):
    """Check the kernel's inputs, the first nine or (with the epilogue) all
    fourteen of `_IN_NAMES` (device and host builds, `lib` the loaded
    library); returns (dtype suffix, the fourteen inputs in the launcher's
    order with None for the epilogue's where it is off, the instantiation's
    name)."""
    A = ins[1]
    B, m, n = A.shape
    res = len(ins) > 9
    # the kernel clips the bounds to +-1e20 itself (no launch here); a
    # strided view of them is copied
    ins = tuple(t.contiguous() if k in ("l", "u", "l_orig", "u_orig") else t
                for k, t in zip(_IN_NAMES, ins))
    shapes = ((B, n, n), (B, m, n), (B, n), (B, m), (B, m), (B, m), (B, n), (B, m),
              (B, m), (B, n, n), (B, m), (B, m), (B, n), (B, m))
    suffix = build.check_inputs(A, dict(zip(_IN_NAMES, zip(ins, shapes))), device_type)
    size = A.element_size()
    threads = lib.qwbc_admm_zy_threads(n, m)        # the constraint-space kernel's design
    smem = lib.qwbc_admm_words(n, m, size, int(res)) * size
    if threads > THREADS_MAX or smem > build.SMEM_BYTES:
        raise ValueError(
            f"admm kernel: n={n}, m={m} in {A.dtype} needs {threads} threads "
            f"(at most {THREADS_MAX}) and {smem} bytes of shared memory (at most "
            f"{build.SMEM_BYTES})")
    variant = ("registers" if lib.qwbc_admm_zy_in_registers(n, m, size)
               else "shared_memory")
    return suffix, ins + (None,) * (14 - len(ins)), variant


def _outputs(A, res, device):
    B, m, n = A.shape
    new = lambda *shape: torch.empty(shape, dtype=A.dtype, device=device)
    outs = (new(B, n), new(B, m), new(B, m))
    return outs + ((new(B), new(B), new(B)) if res else ())


def _pointers(ins, outs):
    ptr = lambda t: None if t is None else t.data_ptr()
    return [ptr(t) for t in ins] + [ptr(t) for t in outs] + [None] * (6 - len(outs))


def _scalars(iters, res, sigma, alpha):
    alpha = float(alpha)
    return int(iters), int(res), float(sigma), alpha, 1.0 - alpha


def _launch(name, ins, iters, sigma, alpha):
    """`ins`: the nine loop inputs (K6), or the fourteen with the epilogue's
    (K5).  A CUDA tensor launches the kernel or raises."""
    res = len(ins) > 9
    suffix, ins, variant = _kernel_args(ins, build.lib(), "cuda")
    A = ins[1]
    B, m, n = A.shape
    outs = _outputs(A, res, A.device)
    if B == 0:
        return outs
    build.launch(
        "admm", suffix, *_pointers(ins, outs), B, n, m,
        *_scalars(iters, res, sigma, alpha),
        torch.cuda.current_stream(A.device).cuda_stream,
    )
    LAUNCHES[name] += 1
    VARIANT_LAUNCHES[variant] += 1
    return outs


def _host(ins, iters, sigma, alpha, reverse):
    """`csrc/admm.cu` compiled as plain C++ and run on CPU tensors, one
    emulated thread per block (`build.host_lib`), in the instantiation the
    shape selects; `reverse` runs every stage's threads in falling order."""
    res = len(ins) > 9
    lib = build.host_lib()
    suffix, ins, _ = _kernel_args(ins, lib, "cpu")
    A = ins[1]
    B, m, n = A.shape
    outs = _outputs(A, res, "cpu")
    ctypes.c_int.in_dll(lib, "qwbc_host_reverse").value = int(reverse)
    err = getattr(lib, f"qwbc_admm_{suffix}")(
        *_pointers(ins, outs), B, n, m, *_scalars(iters, res, sigma, alpha), None)
    if err != 0:
        raise RuntimeError(f"host build of the admm kernel failed ({err})")
    return outs


def admm_iterations_res(Kinv, A, g, l, u, rho, x0, z0, y0,
                        Hs, l_orig, u_orig, d, e,
                        *, iters: int, sigma: float, alpha: float):
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
    build.refuse_grad("admm_iterations_res", Kinv, A, g, l, u, rho, x0, z0, y0,
                      Hs, l_orig, u_orig, d, e)
    if A.device.type == "cpu":
        return admm_iterations_res_plain(
            Kinv, A, g, l, u, rho, x0, z0, y0, Hs, l_orig, u_orig, d, e,
            iters=iters, sigma=sigma, alpha=alpha)
    return _launch("admm_iterations_res",
                   (Kinv, A, g, l, u, rho, x0, z0, y0, Hs, l_orig, u_orig, d, e),
                   iters, sigma, alpha)


def admm_iterations(Kinv, A, g, l, u, rho, x0, z0, y0,
                    *, iters: int, sigma: float, alpha: float):
    """K6: the same loop without the epilogue (and its instantiations).
    Returns (x, z, y)."""
    build.refuse_grad("admm_iterations", Kinv, A, g, l, u, rho, x0, z0, y0)
    if A.device.type == "cpu":
        return admm_iterations_plain(Kinv, A, g, l, u, rho, x0, z0, y0,
                                     iters=iters, sigma=sigma, alpha=alpha)
    return _launch("admm_iterations", (Kinv, A, g, l, u, rho, x0, z0, y0),
                   iters, sigma, alpha)


def admm_iterations_res_host(Kinv, A, g, l, u, rho, x0, z0, y0,
                             Hs, l_orig, u_orig, d, e,
                             *, iters: int, sigma: float, alpha: float,
                             reverse: bool = False):
    """K5's source compiled as plain C++ (see `_host`); needs a C++
    compiler; counts as no launch."""
    return _host((Kinv, A, g, l, u, rho, x0, z0, y0, Hs, l_orig, u_orig, d, e),
                 iters, sigma, alpha, reverse)


def admm_iterations_host(Kinv, A, g, l, u, rho, x0, z0, y0,
                         *, iters: int, sigma: float, alpha: float,
                         reverse: bool = False):
    """K6's source compiled as plain C++ (see `_host`); needs a C++
    compiler; counts as no launch."""
    return _host((Kinv, A, g, l, u, rho, x0, z0, y0), iters, sigma, alpha, reverse)
