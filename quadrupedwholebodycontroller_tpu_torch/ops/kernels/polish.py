"""Active-set polish solve + refinement (kernels K2, compact H, and K7,
dense H).

`polish_solve` replaces the JAX package's Pallas kernel
`ops/pallas/polish_kernel.py::polish_solve` in both its forms
(`_polish_kernel_compact` and `_polish_kernel`):

    y  = Sinv (-(da*b + B Hinv g))          x = Hinv (-g - B^T y)
    `refine` passes of preconditioned Richardson on the coupled KKT system:
        r1 = -g - H x - B^T y               r2 = da*b - B x - D y
        dy = Sinv (B Hinv r1 - r2)          dx = Hinv (r1 - B^T dy)
    z  = clip(A x, l, u), relative KKT residuals pr, du, sign violation sv

with B = da * A never formed (B v = da*(A v), B^T w = A^T (da*w)).  H and
H^-1 come either both dense (B, n, n) or both compact: (diag (B, n) with
zeros on the block rows, blk (B, k, k), start), a diagonal plus one dense
block at rows start:start+k.

On a CUDA tensor the wrapper launches `csrc/polish.cu`, one body
instantiated for each form, which clips l and u to +-1e20 itself; on a CPU
tensor it takes `polish_solve_plain`.  `polish_solve_host` runs the same
source compiled as plain C++ (tests only).
"""
from __future__ import annotations

import ctypes

import torch

from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build
from quadrupedwholebodycontroller_tpu_torch.ops.kernels.admm_zy import (
    _BIG,
    _mv,
    _mvt,
    kkt_epilogue,
)

LAUNCHES = {"polish_solve_compact": 0, "polish_solve_dense": 0}
PLAIN_CALLS = {"polish_solve_compact": 0, "polish_solve_dense": 0}


def blockdiag_apply(compact, v):
    """(diag + blk) @ v for a compact block-diagonal matrix (batched)."""
    diag, blk, start = compact
    k = blk.shape[-1]
    dv = diag * v
    bv = _mv(blk, v[:, start:start + k])
    return torch.cat([dv[:, :start], bv, dv[:, start + k:]], dim=1)


def _form(H, Hinv):
    """ "compact" or "dense"; raises unless H and Hinv share one form."""
    compact = isinstance(H, tuple)
    if compact != isinstance(Hinv, tuple):
        raise ValueError("H and Hinv must both be dense or both compact")
    return "compact" if compact else "dense"


def polish_solve_plain(H, Hinv, Sinv, A, da, g, b, l, u,
                       *, refine: int, reg: float):
    """Plain PyTorch version, in the kernel's operation order."""
    form = _form(H, Hinv)
    PLAIN_CALLS["polish_solve_" + form] += 1
    l = torch.clamp(l, -_BIG, _BIG)
    u = torch.clamp(u, -_BIG, _BIG)
    if form == "compact":
        apply_H = lambda v: blockdiag_apply(H, v)
        apply_Hinv = lambda v: blockdiag_apply(Hinv, v)
    else:
        apply_H = lambda v: _mv(H, v)
        apply_Hinv = lambda v: _mv(Hinv, v)
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


def _kernel_args(H, Hinv, Sinv, A, da, g, b, l, u, lib, device_type):
    """Check the kernel's inputs (device and host builds, `lib` the loaded
    library); returns (launcher name, dtype suffix, pointer tensors in the
    launcher's order, shape args)."""
    B, m, n = A.shape
    common = {"Sinv": (Sinv, (B, m, m)), "A": (A, (B, m, n)), "da": (da, (B, m)),
              "g": (g, (B, n)), "b": (b, (B, m)), "l": (l, (B, m)), "u": (u, (B, m))}
    if _form(H, Hinv) == "dense":
        suffix = build.check_inputs(A, {"H": (H, (B, n, n)), "Hinv": (Hinv, (B, n, n)),
                                        **common}, device_type)
        words, what = lib.qwbc_polish_dense_words(n, m), f"n={n}, m={m}"
        name, ins, shape_args = "polish_dense", (H, Hinv), (B, n, m)
    else:
        hd, hblk, start = H
        hid, hiblk, istart = Hinv
        if start != istart or hblk.shape != hiblk.shape:
            raise ValueError("H and Hinv must share one block layout")
        k = hblk.shape[-1]
        suffix = build.check_inputs(A, {
            "H.diag": (hd, (B, n)), "H.blk": (hblk, (B, k, k)),
            "Hinv.diag": (hid, (B, n)), "Hinv.blk": (hiblk, (B, k, k)), **common},
            device_type)
        if not (0 <= start and start + k <= n):
            raise ValueError(f"polish kernel takes a block inside n; got "
                             f"n={n}, start={start}, k={k}")
        words, what = lib.qwbc_polish_compact_words(n, m, k), f"n={n}, m={m}, k={k}"
        name, ins, shape_args = "polish", (hd, hblk, hid, hiblk), (B, n, m, k, int(start))
    smem = words * A.element_size()
    if smem > build.SMEM_BYTES:
        raise ValueError(
            f"polish kernel holds Sinv, A, H, H^-1 and its vectors in shared "
            f"memory: {what} in {A.dtype} needs {smem} bytes, more than "
            f"{build.SMEM_BYTES}")
    return name, suffix, (*ins, Sinv, A, da, g, b, l, u), shape_args


def polish_solve(H, Hinv, Sinv, A, da, g, b, l, u, *, refine: int, reg: float):
    """H, Hinv: the REGULARIZED polish Hessian and its inverse, both dense
    (B, n, n) or both compact (diag, blk, start) tuples; Sinv (B, m, m) the
    (approximate) inverse of the polish Schur complement; da (B, m) the 0/1
    active-row mask; b the active bounds.  Any B >= 1.  Returns
    (x, y, z, pr, du, sv).  Refuses an input that requires grad
    (`build.refuse_grad`)."""
    build.refuse_grad("polish_solve", H, Hinv, Sinv, A, da, g, b, l, u)
    form = _form(H, Hinv)
    if A.device.type == "cpu":
        return polish_solve_plain(H, Hinv, Sinv, A, da, g, b, l, u,
                                  refine=refine, reg=reg)
    B, m, n = A.shape
    name, suffix, ins, shape_args = _kernel_args(H, Hinv, Sinv, A, da, g, b, l, u,
                                                 build.lib(), "cuda")
    new = lambda *shape: torch.empty(shape, dtype=A.dtype, device=A.device)
    outs = (new(B, n), new(B, m), new(B, m), new(B), new(B), new(B))
    if B == 0:
        return outs
    build.launch(
        name, suffix, *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        *shape_args, int(refine), float(reg),
        torch.cuda.current_stream(A.device).cuda_stream,
    )
    LAUNCHES["polish_solve_" + form] += 1
    return outs


def polish_solve_host(H, Hinv, Sinv, A, da, g, b, l, u, *, refine: int, reg: float,
                      reverse: bool = False):
    """`csrc/polish.cu` compiled as plain C++ and run on CPU tensors
    (compact or dense H and H^-1), one emulated thread per block
    (`build.host_lib`); `reverse` runs every stage's items in falling
    order.  Needs a C++ compiler; counts as no launch."""
    B, m, n = A.shape
    lib = build.host_lib()
    name, suffix, ins, shape_args = _kernel_args(H, Hinv, Sinv, A, da, g, b, l, u, lib,
                                                 "cpu")
    new = lambda *shape: torch.empty(shape, dtype=A.dtype)
    outs = (new(B, n), new(B, m), new(B, m), new(B), new(B), new(B))
    ctypes.c_int.in_dll(lib, "qwbc_host_reverse").value = int(reverse)
    err = getattr(lib, f"qwbc_{name}_{suffix}")(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        *shape_args, int(refine), float(reg), None)
    if err != 0:
        raise RuntimeError(f"host build of the polish kernel failed ({err})")
    return outs
