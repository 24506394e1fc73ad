"""Dense linear algebra for the hot path, matmul-only apart from the
simulator's Cholesky solve.

Everything is batched matrix products and elementwise ops (`torch.matmul`),
the part of the solve that is plain library code on either framework:

  * ns_inverse             Jacobi-preconditioned Newton-Schulz SPD inverse
                           (X <- X(2I - A X)), cold or warm-started
  * ns_inverse_warm_shared warm update sharing A @ W between the divergence
                           check and the first iteration
  * solve_kkt_schur        the active-set polish system via a Schur
                           complement with Newton-Schulz inverses
  * inv3 / spd_inv6 / spd_inv12   closed-form block-Schur inverses
  * spd_solve              batched Cholesky solve (the simulator's M^-1)

float32 products must run at full precision: Newton-Schulz, the refinement
passes and the KKT residuals are meaningless at TF32 accuracy (reduced
precision matmuls pushed this solver's relative KKT residual from 1e-3 to
1e2 in the reference's record).  The module checks it at import.
"""
from __future__ import annotations

import torch

if torch.backends.cuda.matmul.allow_tf32:
    raise RuntimeError(
        "float32 matmuls must stay full precision: "
        "torch.backends.cuda.matmul.allow_tf32 must be False"
    )


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _cold_init(A):
    """Safe NS start: Jacobi-scaled X0 with ||I - A X0|| < 1 guaranteed."""
    d = torch.rsqrt(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)) + 1e-30)
    dd = d[..., :, None] * d[..., None, :]
    As = A * d[..., :, None] * d[..., None, :]
    absA = torch.abs(As)
    r1 = torch.amax(torch.sum(absA, dim=-1), dim=-1)  # inf-norm
    c1 = torch.amax(torch.sum(absA, dim=-2), dim=-1)  # 1-norm
    # expressed in UNSCALED coordinates: inv(A) = d inv(As) d
    return As * dd / (r1 * c1)[..., None, None]


def ns_inverse(A, iters: int = 30, warm=None, warm_iters: int = 12,
               body_prec=None, tail: int = 6):
    """Inverse of a batched SPD matrix (..., n, n) by Newton-Schulz.

    With `warm` (an approximate inverse of a nearby problem, the carried
    control-cycle hotstart) only `warm_iters` iterations run.  The caller
    gates warm use across structural changes (contact switches); here only
    true blowups (non-finite, or ||I - A W||_inf >= 1e3) fall back to the
    cold start.

    body_prec / tail are accepted for signature parity with the JAX
    package, where they select a cheaper matmul mode for the first
    `iters - tail` cold iterations.  No Hopper mode matches that mode, so
    every iteration here runs at full float32."""
    del body_prec, tail
    n = A.shape[-1]
    eye = _eye(n, A)
    eye2 = 2.0 * eye
    X = _cold_init(A)
    if warm is not None:
        E = eye - A @ warm
        err = torch.amax(torch.sum(torch.abs(E), dim=-1), dim=-1)
        ok = (torch.isfinite(err) & (err < 1e3))[..., None, None]
        X = torch.where(ok, warm, X)
        iters = warm_iters
    for _ in range(iters):
        X = X @ (eye2 - A @ X)
    if warm is not None:
        # never let a blown-up iterate poison the carried cache
        finite = torch.isfinite(X).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
        X = torch.where(finite, X, _cold_init(A))
    return X


def ns_inverse_warm_shared(A, warm, warm_iters: int):
    """Warm Newton-Schulz update sharing A @ warm between the divergence
    check and the first iteration: 2*wi matmuls instead of 2*wi + 1.

    Semantics vs ns_inverse(A, warm=..., warm_iters=wi): accepted warm
    starts give the same matmul sequence; rejected ones (non-finite or
    ||I - A W||_inf >= 1e3) fall back to the UN-ITERATED Jacobi-scaled X0.
    warm_iters must be >= 1 (use ns_inverse for 0)."""
    if warm_iters < 1:
        raise ValueError("warm_iters must be >= 1")
    n = A.shape[-1]
    eye = _eye(n, A)
    X0 = _cold_init(A)
    M = A @ warm
    err = torch.amax(torch.sum(torch.abs(eye - M), dim=-1), dim=-1)
    ok = (torch.isfinite(err) & (err < 1e3))[..., None, None]
    X = warm @ (2.0 * eye - M)
    for _ in range(warm_iters - 1):
        X = X @ (2.0 * eye - A @ X)
    X = torch.where(ok, X, X0)
    finite = torch.isfinite(X).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    return torch.where(finite, X, X0)


def solve_kkt_schur(H, B, da, g, b, reg: float = 1e-8, iters: int = 30,
                    refine: int = 2, Hinv=None):
    """Solve the active-set KKT system matmul-only:

        (1)  H x + B^T y = -g
        (2)  B x + D y   = da * b,   D = diag(1-da) - reg*diag(da)

    B is the row-masked constraint matrix (da_i * A_i), so active rows
    (B_i x - reg y_i = b_i) and inactive rows (y_i = 0) decouple exactly.
    Eliminating x = H^-1(-g - B^T y) gives the SPD Schur system
        S y = -(da*b + B H^-1 g),  S = B H^-1 B^T + reg diag(da) + diag(1-da)
    solved with a cold Newton-Schulz inverse of S; `refine` coupled
    refinement passes knock the residual of the full system down after.
    Returns (x, y)."""
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    if Hinv is None:
        Hinv = ns_inverse(H, iters)
    Bt = B.transpose(-1, -2)
    diag_S = reg * da + (1.0 - da)
    S = B @ Hinv @ Bt + torch.diag_embed(diag_S)
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
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], dim=-1),
            torch.stack([co10, co11, co12], dim=-1),
            torch.stack([co20, co21, co22], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _schur_inv(M, k, inv_top, inv_schur):
    """Block-Schur SPD inverse: M = [[A (k,k), B], [B^T, D]] with the two
    sub-inverses supplied (closed-form or recursive):

        S = D - B^T A^{-1} B,  W = A^{-1} B
        M^{-1} = [[A^{-1} + W S^{-1} W^T, -W S^{-1}], [-S^{-1} W^T, S^{-1}]]
    """
    A = M[..., :k, :k]
    B = M[..., :k, k:]
    D = M[..., k:, k:]
    Ainv = inv_top(A)
    W = Ainv @ B
    S = D - B.transpose(-1, -2) @ W
    Sinv = inv_schur(S)
    WS = W @ Sinv
    top = torch.cat([Ainv + WS @ W.transpose(-1, -2), -WS], dim=-1)
    bot = torch.cat([-WS.transpose(-1, -2), Sinv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def spd_inv6(M):
    """Closed-form inverse of batched SPD (..., 6, 6) via 3x3 block Schur."""
    return _schur_inv(M, 3, inv3, inv3)


def spd_inv12(M):
    """Closed-form-composed inverse of batched SPD (..., 12, 12): 6+6 block
    Schur over spd_inv6."""
    return _schur_inv(M, 6, spd_inv6, spd_inv6)


def spd_solve(A, b):
    """Solve A x = b for batched SPD A (..., n, n), b (..., n) or (..., n, k),
    by a Cholesky factorization (`torch.linalg.cholesky_ex`, which never
    syncs with the host: a matrix that is not SPD gives non-finite x, not an
    exception).  The simulator's mass-matrix solve; one code path on every
    device."""
    vec = b.ndim == A.ndim - 1
    L, _ = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[..., None] if vec else b, L)
    return x[..., 0] if vec else x
