"""Active-set polish solve + refinement with compact H, H^-1 (kernel K2).

`polish_solve` replaces the JAX package's Pallas kernel
`ops/pallas/polish_kernel.py::polish_solve` (`_polish_kernel_compact`):

    y  = Sinv (-(da*b + B Hinv g))          x = Hinv (-g - B^T y)
    `refine` passes of preconditioned Richardson on the coupled KKT system:
        r1 = -g - H x - B^T y               r2 = da*b - B x - D y
        dy = Sinv (B Hinv r1 - r2)          dx = Hinv (r1 - B^T dy)
    z  = clip(A x, l, u), relative KKT residuals pr, du, sign violation sv

with B = da * A never formed (B v = da*(A v), B^T w = A^T (da*w)) and
H, H^-1 given as (diag (B, n) with zeros on the block rows, blk (B, k, k),
start): a diagonal plus one dense block at rows start:start+k.

On a CUDA tensor the wrapper launches `csrc/polish.cu`; on a CPU tensor it
takes `polish_solve_plain`.
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

LAUNCHES = 0
PLAIN_CALLS = 0


def blockdiag_apply(compact, v):
    """(diag + blk) @ v for a compact block-diagonal matrix (batched)."""
    diag, blk, start = compact
    k = blk.shape[-1]
    dv = diag * v
    bv = _mv(blk, v[:, start:start + k])
    return torch.cat([dv[:, :start], bv, dv[:, start + k:]], dim=1)


def polish_solve_plain(H, Hinv, Sinv, A, da, g, b, l, u,
                       *, refine: int, reg: float):
    """Plain PyTorch version, in the kernel's operation order."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    l = torch.clamp(l, -_BIG, _BIG)
    u = torch.clamp(u, -_BIG, _BIG)
    apply_H = lambda v: blockdiag_apply(H, v)
    apply_Hinv = lambda v: blockdiag_apply(Hinv, v)
    bv = lambda v: da * _mv(A, v)          # B v
    btw = lambda w: _mvt(A, da * w)        # B^T w

    D = (1.0 - da) - reg * da
    dab = da * b
    y = _mv(Sinv, -(dab + bv(apply_Hinv(g))))
    x = apply_Hinv(-g - btw(y))
    for _ in range(refine):
        r1 = -g - apply_H(x) - btw(y)
        r2 = dab - bv(x) - D * y
        dy = _mv(Sinv, bv(apply_Hinv(r1)) - r2)
        dx = apply_Hinv(r1 - btw(dy))
        x = x + dx
        y = y + dy
    ax = _mv(A, x)
    z = torch.minimum(torch.maximum(ax, l), u)
    pr, du, sv = kkt_epilogue(ax, apply_H(x), _mvt(A, y), g, y, l, u)
    return x, y, z, pr, du, sv


def polish_solve(H, Hinv, Sinv, A, da, g, b, l, u, *, refine: int, reg: float):
    """H, Hinv: compact (diag, blk, start) tuples of the REGULARIZED polish
    Hessian and its inverse; Sinv (B, m, m) the (approximate) inverse of
    the polish Schur complement; da (B, m) the 0/1 active-row mask; b the
    active bounds.  Any B >= 1.  Returns (x, y, z, pr, du, sv)."""
    global LAUNCHES
    if not (isinstance(H, tuple) and isinstance(Hinv, tuple)):
        raise NotImplementedError(
            "dense-H polish kernel: a later slice of the port")
    if A.device.type == "cpu":
        return polish_solve_plain(H, Hinv, Sinv, A, da, g, b, l, u,
                                  refine=refine, reg=reg)
    hd, hblk, start = H
    hid, hiblk, istart = Hinv
    if start != istart or hblk.shape != hiblk.shape:
        raise ValueError("H and Hinv must share one block layout")
    B, m, n = A.shape
    k = hblk.shape[-1]
    l = torch.clamp(l, -_BIG, _BIG)
    u = torch.clamp(u, -_BIG, _BIG)
    suffix = build.check_inputs(A, {
        "H.diag": (hd, (B, n)), "H.blk": (hblk, (B, k, k)),
        "Hinv.diag": (hid, (B, n)), "Hinv.blk": (hiblk, (B, k, k)),
        "Sinv": (Sinv, (B, m, m)), "A": (A, (B, m, n)), "da": (da, (B, m)),
        "g": (g, (B, n)), "b": (b, (B, m)), "l": (l, (B, m)), "u": (u, (B, m)),
    })
    if max(n, m) > 1024 or not (0 <= start and start + k <= n):
        raise ValueError(
            f"polish kernel takes n, m <= 1024 and a block inside n; got "
            f"n={n}, m={m}, start={start}, k={k}")
    new = lambda *shape: torch.empty(shape, dtype=A.dtype, device=A.device)
    outs = (new(B, n), new(B, m), new(B, m), new(B), new(B), new(B))
    if B == 0:
        return outs
    build.launch(
        "polish", suffix,
        *(t.data_ptr() for t in (hd, hblk, hid, hiblk, Sinv, A, da, g, b, l, u)),
        *(t.data_ptr() for t in outs),
        B, n, m, k, int(start), int(refine), float(reg),
        torch.cuda.current_stream(A.device).cuda_stream,
    )
    LAUNCHES += 1
    return outs
