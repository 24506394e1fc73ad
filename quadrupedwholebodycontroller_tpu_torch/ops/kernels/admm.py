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
epilogue on or off); on a CPU tensor they take the `*_plain` versions.
"""
from __future__ import annotations

import torch

from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build
from quadrupedwholebodycontroller_tpu_torch.ops.kernels.admm_zy import (
    _BIG,
    _mv,
    _mvt,
    kkt_epilogue,
)

LAUNCHES = {"admm_iterations_res": 0, "admm_iterations": 0}
PLAIN_CALLS = {"admm_iterations_res": 0, "admm_iterations": 0}


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


def _launch(name, Kinv, A, g, l, u, rho, x0, z0, y0, res, iters, sigma, alpha):
    """`res`: None (K6) or (Hs, lo, uo, d, e) with the bounds clipped (K5)."""
    B, m, n = A.shape
    shapes = {
        "Kinv": (Kinv, (B, n, n)), "A": (A, (B, m, n)), "g": (g, (B, n)),
        "l": (l, (B, m)), "u": (u, (B, m)), "rho": (rho, (B, m)),
        "x0": (x0, (B, n)), "z0": (z0, (B, m)), "y0": (y0, (B, m)),
    }
    if res is not None:
        Hs, lo, uo, d, e = res
        shapes.update({"Hs": (Hs, (B, n, n)), "l_orig": (lo, (B, m)),
                       "u_orig": (uo, (B, m)), "d": (d, (B, n)), "e": (e, (B, m))})
    suffix = build.check_inputs(A, shapes)
    if max(n, m) > 1024:
        raise ValueError(f"admm kernel takes n, m <= 1024, got {n}, {m}")
    new = lambda *shape: torch.empty(shape, dtype=A.dtype, device=A.device)
    outs = (new(B, n), new(B, m), new(B, m))
    if res is not None:
        outs += (new(B), new(B), new(B))
    if B == 0:
        return outs
    ptrs = [t.data_ptr() for t in (Kinv, A, g, l, u, rho, x0, z0, y0)]
    ptrs += [t.data_ptr() for t in res] if res is not None else [0] * 5
    ptrs += [t.data_ptr() for t in outs] + [0] * (6 - len(outs))
    alpha = float(alpha)
    build.launch(
        "admm", suffix, *ptrs, B, n, m, int(iters), int(res is not None),
        float(sigma), alpha, 1.0 - alpha,
        torch.cuda.current_stream(A.device).cuda_stream,
    )
    LAUNCHES[name] += 1
    return outs


def admm_iterations_res(Kinv, A, g, l, u, rho, x0, z0, y0,
                        Hs, l_orig, u_orig, d, e,
                        *, iters: int, sigma: float, alpha: float):
    """Kinv (B,n,n) = K^-1 in SCALED space; A/g/l/u/rho scaled; Hs the
    scaled H; l_orig/u_orig the unscaled bounds; d/e the Ruiz scalings.
    Returns (x, z, y, pr, du, sv), x/z/y in scaled space."""
    if A.device.type == "cpu":
        return admm_iterations_res_plain(
            Kinv, A, g, l, u, rho, x0, z0, y0, Hs, l_orig, u_orig, d, e,
            iters=iters, sigma=sigma, alpha=alpha)
    res = (Hs, _clip(l_orig), _clip(u_orig), d, e)
    return _launch("admm_iterations_res", Kinv, A, g, _clip(l), _clip(u), rho,
                   x0, z0, y0, res, iters, sigma, alpha)


def admm_iterations(Kinv, A, g, l, u, rho, x0, z0, y0,
                    *, iters: int, sigma: float, alpha: float):
    """K6: the same loop without the epilogue.  Returns (x, z, y)."""
    if A.device.type == "cpu":
        return admm_iterations_plain(Kinv, A, g, l, u, rho, x0, z0, y0,
                                     iters=iters, sigma=sigma, alpha=alpha)
    return _launch("admm_iterations", Kinv, A, g, _clip(l), _clip(u), rho,
                   x0, z0, y0, None, iters, sigma, alpha)
