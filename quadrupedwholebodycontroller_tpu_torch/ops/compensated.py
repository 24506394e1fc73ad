"""Error-free-transformation (double-float32) arithmetic for residuals.

Dekker/Veltkamp error-free transformations recover the exact rounding error
of each float32 multiply and add, and a TwoSum-tree reduction sums products
to ~|result|*eps accuracy instead of ~eps*sum|terms|.  Used where float32
accuracy dies: the refinement residuals of the active-set polish
(r = b - K x cancels catastrophically once x is a few digits accurate and
the terms are ~1e4).  Preconditioner applications stay plain products.

The transformations are exact only if every multiply and add is rounded on
its own.  Each arithmetic step below is therefore a separate eager PyTorch
op (one kernel each on the card): nothing here may go through
`torch.compile`, `addcmul`/`addcdiv` or any other fused multiply-add, which
would keep the unrounded product and break TwoProd.
"""
from __future__ import annotations

import torch

# Veltkamp splitting constant for binary32 (24-bit significand, s = 12)
_SPLIT = 4097.0  # 2**12 + 1


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (s = fl(a+b))."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _split(a):
    c = _SPLIT * a
    h = c - (c - a)
    return h, a - h


def _two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (p = fl(a*b)); FMA-free."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _comp_sum_last(P):
    """Compensated sum along the last axis via a TwoSum binary tree.

    Returns (s, c) with s + c accurate to O(eps^2 * n * sum|P|): each tree
    level is an error-free TwoSum of vectorized halves; the per-pair
    rounding errors are recovered exactly and summed plainly."""
    c_tot = torch.zeros(P.shape[:-1], dtype=P.dtype, device=P.device)
    while P.shape[-1] > 1:
        k = P.shape[-1]
        half = k // 2
        s, e = _two_sum(P[..., :half], P[..., half: 2 * half])
        c_tot = c_tot + torch.sum(e, dim=-1)
        P = s if k % 2 == 0 else torch.cat([s, P[..., -1:]], dim=-1)
    return P[..., 0], c_tot


def comp_matvec(M, v):
    """Compensated batched matvec: (..., m, n) @ (..., n) -> (..., m)."""
    p, e = _two_prod(M, v[..., None, :])
    s, c = _comp_sum_last(p)
    return s + (c + torch.sum(e, dim=-1))


def comp_residual_chain(bias, mat_terms=(), diag_terms=()):
    """r = bias - sum_i M_i @ x_i - sum_j d_j * v_j in ONE compensated chain.

    Block form of comp_residual for structured operators: each block's
    TwoProd partials are concatenated along the contraction axis only and
    reduced once, so cancellation BETWEEN blocks stays inside the
    compensated accumulation.  mat_terms: iterable of
    (M (..., rows, n_i), x (..., n_i)); diag_terms: iterable of
    (d (..., rows), v (..., rows)) elementwise products."""
    ps, errs = [], []
    for M, x in mat_terms:
        p, e = _two_prod(M, x[..., None, :])
        ps.append(-p)
        errs.append(torch.sum(e, dim=-1))
    for d, v in diag_terms:
        p, e = _two_prod(d, v)
        ps.append(-p[..., None])
        errs.append(e)
    bias_col = (bias * torch.ones_like(ps[0][..., 0]))[..., None]
    P = torch.cat([bias_col] + ps, dim=-1)
    s, c = _comp_sum_last(P)
    etot = errs[0]
    for e in errs[1:]:
        etot = etot + e
    return s + (c - etot)


def comp_residual(b, M, x, scale=1.0):
    """r = b - M x with compensated products/sums: the refinement residual."""
    mx_p, mx_e = _two_prod(M, x[..., None, :])
    bias_col = (b * torch.ones_like(mx_p[..., 0]) * scale)[..., None]
    s, c = _comp_sum_last(torch.cat([bias_col, -mx_p], dim=-1))
    return s + (c - torch.sum(mx_e, dim=-1))
