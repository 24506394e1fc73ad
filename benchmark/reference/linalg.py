"""Dense linear algebra of the benchmark's reference: frozen copies of the
port's `ops/linalg.py` functions that the reference's setup, simulator and
control solver use.  Unlike the port, nothing here pins the matmul
precision: the control (`benchmark/control.py`) runs these functions with
TF32 products on purpose."""
from __future__ import annotations

import torch


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _cold_init(A):
    """Safe Newton-Schulz start: Jacobi-scaled X0 with ||I - A X0|| < 1."""
    d = torch.rsqrt(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)) + 1e-30)
    dd = d[..., :, None] * d[..., None, :]
    As = A * d[..., :, None] * d[..., None, :]
    absA = torch.abs(As)
    r1 = torch.amax(torch.sum(absA, dim=-1), dim=-1)
    c1 = torch.amax(torch.sum(absA, dim=-2), dim=-1)
    return As * dd / (r1 * c1)[..., None, None]


def ns_inverse(A, iters: int = 30):
    """Inverse of a batched SPD matrix by cold Newton-Schulz, X <- X(2I - AX)."""
    eye2 = 2.0 * _eye(A.shape[-1], A)
    X = _cold_init(A)
    for _ in range(iters):
        X = X @ (eye2 - A @ X)
    return X


def solve_kkt_schur(H, B, da, g, b, reg: float = 1e-8, iters: int = 30,
                    refine: int = 2, Hinv=None):
    """The active-set KKT system H x + B^T y = -g, B x + D y = da b
    (D = diag(1 - da) - reg diag(da)) through its Schur complement with
    Newton-Schulz inverses and `refine` coupled refinement passes."""
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    if Hinv is None:
        Hinv = ns_inverse(H, iters)
    Bt = B.transpose(-1, -2)
    S = B @ Hinv @ Bt + torch.diag_embed(reg * da + (1.0 - da))
    Sinv = ns_inverse(S, iters)
    D = (1.0 - da) - reg * da
    y = mv(Sinv, -(da * b + mv(B, mv(Hinv, g))))
    x = mv(Hinv, -g - mv(Bt, y))
    for _ in range(refine):
        r1 = -g - mv(H, x) - mv(Bt, y)
        r2 = da * b - mv(B, x) - D * y
        dy = mv(Sinv, mv(B, mv(Hinv, r1)) - r2)
        dx = mv(Hinv, r1 - mv(Bt, dy))
        x = x + dx
        y = y + dy
    return x, y


def inv3(A):
    """Closed-form inverse of batched (..., 3, 3) matrices (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00, co01, co02 = e * i - f * h, c * h - b * i, b * f - c * e
    co10, co11, co12 = f * g - d * i, a * i - c * g, c * d - a * f
    co20, co21, co22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = torch.stack([torch.stack([co00, co01, co02], dim=-1),
                       torch.stack([co10, co11, co12], dim=-1),
                       torch.stack([co20, co21, co22], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def spd_inv6(M):
    """Closed-form inverse of batched SPD (..., 6, 6) by 3x3 block Schur."""
    A, B, D = M[..., :3, :3], M[..., :3, 3:], M[..., 3:, 3:]
    Ainv = inv3(A)
    W = Ainv @ B
    Sinv = inv3(D - B.transpose(-1, -2) @ W)
    WS = W @ Sinv
    top = torch.cat([Ainv + WS @ W.transpose(-1, -2), -WS], dim=-1)
    bot = torch.cat([-WS.transpose(-1, -2), Sinv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def spd_solve(A, b):
    """Solve A x = b for batched SPD A by a Cholesky factorization."""
    vec = b.ndim == A.ndim - 1
    L, _ = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[..., None] if vec else b, L)
    return x[..., 0] if vec else x
