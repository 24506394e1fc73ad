"""Batched dense convex QP solver (OSQP-style ADMM + active-set polish).

Replaces qpOASES' hot-started SQProblem of the reference controller
(42 variables x 70 two-sided constraints) with a fixed-budget batched
design:

  * Ruiz scaling of every problem (kernel `prepare_scaled`),
  * one SPD inverse K^-1 per problem by Newton-Schulz, warm-started from a
    carried cache and re-inverted cold only for scenarios whose contact set
    switched,
  * the ADMM loop with its residual epilogue: the constraint-space kernel
    `admm_zy_iterations_res` at sigma = 0, the x-space kernel
    `admm_iterations_res` at sigma > 0,
  * two rounds of active-set polish with the drop rule (kernel
    `polish_solve`, with H and H^-1 compact when the caller supplies a
    block-diagonal closed form, dense otherwise), the second compacted to
    the scenarios that failed the first; without a carried cache, the
    plain Schur polish (`_polish`) instead,
  * a staged, compacted tail rescue with compensated refinement.

The "torch" backend is the other algorithm, the JAX package's single-sample
`solve` (its "xla" backend): per-problem Ruiz scaling, a cold K^-1, the
x-space ADMM loop in tensor code at every sigma, dense Newton-Schulz polish
rounds with the drop rule, and its own tail rescue.  `solve` runs it on a
batch, scenario by scenario the same as the JAX function under `vmap`;
`solve_batched(backend="torch")` runs it with the batch-level rescue
(`_rescue_batched`) instead.  It launches no kernel.

Problem form:  min 1/2 x^T H x + g^T x   s.t.  l <= A x <= u.
Every leaf carries the scenario batch as its leading dimension.

Control flow: where the JAX package branches on device values with
`lax.cond` / `while_loop`, this module branches on the host
(`if _host(...)`), one device-to-host sync each.  `HOST_SYNCS` counts
them.

Gradients: the "torch" backend (`solve`, `solve_batched(backend="torch")`)
runs in the caller's grad mode, as `jax.grad` runs through the JAX
package's "xla" backend.  Its rescues run under `torch.no_grad()` on
detached inputs (`_sg`) and are merged value only (`_ad_passthrough`): the
gradient flows through the pre-rescue iterate, as in the JAX package.  The
kernel backend refuses an input that requires grad, as `jax.grad` through
a `pl.pallas_call` raises, and otherwise runs under `torch.no_grad()`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from quadrupedwholebodycontroller_tpu_torch.config import QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.ops import compensated as comp
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import (
    admm,
    admm_zy,
    build,
    polish,
    prepare,
)
from quadrupedwholebodycontroller_tpu_torch.ops.linalg import (
    ns_inverse,
    ns_inverse_warm_shared,
    solve_kkt_schur,
)

HOST_SYNCS = 0   # device-to-host reads made to decide a branch


def _sg(tree):
    """Detach the tensor leaves of a (nested) tuple or NamedTuple; other
    leaves (a compact block's `start` index, None) pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, tuple):
        leaves = [_sg(t) for t in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return tree


def _ad_passthrough(before, after):
    """Value `after`, gradient the identity on `before`, leaf by leaf: a
    float leaf becomes a + (b - a).detach(); a bool or int leaf (`polished`)
    is `b`.  The rescues run under `torch.no_grad()` and are merged so, and
    the gradient flows through the pre-rescue iterate (the JAX package's
    `_ad_passthrough`)."""
    if isinstance(before, torch.Tensor):
        if not before.is_floating_point():
            return after
        return before + (after - before).detach()
    leaves = [_ad_passthrough(a, b) for a, b in zip(before, after)]
    return type(before)(*leaves) if hasattr(before, "_fields") else tuple(leaves)


def _host(t):
    """Read a 0-d tensor on the host to decide a branch (one sync)."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return t.item()


def _host_nonzero(mask):
    """The indices (k,) where the (B,) bool `mask` is set: their count is
    read on the host (one sync)."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return torch.nonzero(mask).flatten()


class QPData(NamedTuple):
    H: torch.Tensor  # (B, n, n) symmetric PD
    g: torch.Tensor  # (B, n)
    A: torch.Tensor  # (B, m, n)
    l: torch.Tensor  # (B, m)
    u: torch.Tensor  # (B, m)


class QPState(NamedTuple):
    """Warm-startable iterate (the hotstart carry)."""

    x: torch.Tensor  # (B, n)
    z: torch.Tensor  # (B, m)
    y: torch.Tensor  # (B, m)

    @classmethod
    def zeros(cls, B: int, n: int, m: int, dtype=torch.float32,
              device="cuda") -> "QPState":
        kw = dict(dtype=dtype, device=device)
        return cls(x=torch.zeros((B, n), **kw), z=torch.zeros((B, m), **kw),
                   y=torch.zeros((B, m), **kw))


class QPInfo(NamedTuple):
    primal_residual: torch.Tensor  # (B,) relative max |clip(Ax) - Ax|
    dual_residual: torch.Tensor    # (B,) relative max |Hx + g + A^T y|
    kkt_residual: torch.Tensor     # (B,) max of the two
    polished: torch.Tensor         # (B,) bool: a polish candidate was accepted


class QPCache(NamedTuple):
    """Carried factorization cache: the control-cycle hotstart extended to
    the matmul-only inverses.  Always batch-major."""

    kinv: torch.Tensor  # (B, n, n) inverse of the scaled ADMM matrix K
    hinv: torch.Tensor  # (B, n, n) dense polish H^-1 (carried through when
                        # the caller supplies a compact closed form)
    sinv: torch.Tensor  # (B, m, m) inverse of the last polish Schur complement

    @classmethod
    def zeros(cls, B: int, n: int, m: int, dtype=torch.float32,
              device="cuda") -> "QPCache":
        kw = dict(dtype=dtype, device=device)
        return cls(kinv=torch.zeros((B, n, n), **kw),
                   hinv=torch.zeros((B, n, n), **kw),
                   sinv=torch.zeros((B, m, m), **kw))


def make_cache(B: int, n: int, m: int, params: QPSolverParams,
               dtype=torch.float32, device="cuda") -> QPCache:
    """A zero cache for `solve_batched` (`params.solve_layout` is ignored:
    the port is batch-major)."""
    del params
    return QPCache.zeros(B, n, m, dtype, device)


def _mv(M, v):
    return torch.einsum("bij,bj->bi", M, v)


def _mvt(M, w):
    return torch.einsum("bij,bi->bj", M, w)


def _take(a, idx):
    return a.index_select(0, idx)


def _put(a, idx, v):
    """Out-of-place a[idx] = v (idx unique)."""
    out = a.clone()
    out[idx] = v
    return out


def _take_state(s: QPState, idx) -> QPState:
    return QPState(x=_take(s.x, idx), z=_take(s.z, idx), y=_take(s.y, idx))


def _where_state(mask, a: QPState, b: QPState) -> QPState:
    """Per scenario: `a` where the (B,) bool mask is set, `b` elsewhere."""
    mk = mask[:, None]
    return QPState(*(torch.where(mk, p, q) for p, q in zip(a, b)))


def _take_h(t, idx):
    """Gather scenarios of a polish H or H^-1: dense (B, n, n), compact
    (diag, blk, start), or None (no polish)."""
    if isinstance(t, tuple):
        return (_take(t[0], idx), _take(t[1], idx), t[2])
    return None if t is None else _take(t, idx)


def _bound_finite(x):
    """A bound is "real" when |x| < 1e19 (the finite QP_INF = 1e20 convention)."""
    return torch.abs(x) < 1e19


def _blockdiag_dense(compact):
    """Densify a compact block-diagonal (diag (B, n), blk (B, k, k), start)
    matrix; diag is zero on the block rows."""
    diag, blk, start = compact
    k = blk.shape[-1]
    out = torch.diag_embed(diag)
    out[:, start:start + k, start:start + k] = blk
    return out


def _dense_h(t):
    """A polish H or H^-1 as a dense (B, n, n) tensor."""
    return _blockdiag_dense(t) if isinstance(t, tuple) else t


def _hinv_mv(Hinv, v):
    """Apply the polish H^-1 (compact (diag, blk, start) or dense) as a
    batched matvec; the compact form is never densified."""
    if isinstance(Hinv, tuple):
        diag, blk, start = Hinv
        k = blk.shape[-1]
        return torch.cat([diag[:, :start] * v[:, :start],
                          _mv(blk, v[:, start:start + k]),
                          diag[:, start + k:] * v[:, start + k:]], dim=1)
    return _mv(Hinv, v)


def _finite_bound_scale(data: QPData):
    zero = torch.zeros_like(data.l)
    return torch.maximum(
        torch.amax(torch.where(_bound_finite(data.l), torch.abs(data.l), zero), dim=-1),
        torch.amax(torch.where(_bound_finite(data.u), torch.abs(data.u), zero), dim=-1),
    )


def _kkt_scales(data: QPData, x, y):
    ax = _mv(data.A, x)
    hx = _mv(data.H, x)
    aty = _mvt(data.A, y)
    one = torch.ones_like(ax[:, 0])
    primal_scale = torch.maximum(
        one, torch.maximum(torch.amax(torch.abs(ax), dim=-1), _finite_bound_scale(data)))
    dual_scale = torch.maximum(
        one,
        torch.maximum(
            torch.amax(torch.abs(hx), dim=-1),
            torch.maximum(torch.amax(torch.abs(aty), dim=-1),
                          torch.amax(torch.abs(data.g), dim=-1)),
        ),
    )
    return ax, hx, aty, primal_scale, dual_scale


def kkt_residual(data: QPData, x, y):
    """Relative KKT primal/dual residuals (B,) of a primal/dual pair, OSQP
    normalization: the WBC problem's data spans ~1 (acceleration rows) to
    ~1e4 (stiff-gain wrench terms), so absolute residuals are not
    comparable across a batch.  Complementary slackness is not scored
    (see _sign_violation)."""
    ax, hx, aty, primal_scale, dual_scale = _kkt_scales(data, x, y)
    clipped = torch.minimum(torch.maximum(ax, data.l), data.u)
    primal = torch.amax(torch.abs(ax - clipped), dim=-1) / primal_scale
    dual = torch.amax(torch.abs(hx + data.g + aty), dim=-1) / dual_scale
    return primal, dual


def _sign_violation(data: QPData, x, y):
    """Relative complementarity/sign residual (B,) of a primal/dual pair.

    An active-set refinement can converge to the saddle of a WRONG active
    set: zero primal and dual residual, wrong-signed multipliers.  For each
    row, y_i > 0 must push on a nearby upper bound and y_i < 0 on a lower
    one; the violation is min(|y_i|/dual_scale, dist/primal_scale)."""
    ax, _, _, primal_scale, dual_scale = _kkt_scales(data, x, y)
    inf = torch.full_like(ax, float("inf"))
    d_up = torch.where(_bound_finite(data.u), torch.clamp_min(data.u - ax, 0.0), inf)
    d_lo = torch.where(_bound_finite(data.l), torch.clamp_min(ax - data.l, 0.0), inf)
    eq = (data.u - data.l) <= 1e-9   # equality rows: y is sign-free
    dist = torch.where(eq, torch.zeros_like(ax), torch.where(y > 0, d_up, d_lo))
    v = torch.minimum(torch.abs(y) / dual_scale[:, None], dist / primal_scale[:, None])
    return torch.amax(v, dim=-1)


def _active_tols(data: QPData, ax):
    """Activation tolerances (B,), RELATIVE to the problem scale: an
    absolute 1e-6 is sound in double precision but far below float32 dual
    noise on ~1e4-magnitude data, where it activates rows on noise."""
    eps = torch.finfo(ax.dtype).eps
    one = torch.ones_like(ax[:, 0])
    primal_scale = torch.maximum(
        one, torch.maximum(torch.amax(torch.abs(ax), dim=-1), _finite_bound_scale(data)))
    dual_scale = torch.maximum(one, torch.amax(torch.abs(data.g), dim=-1))
    tol_p = torch.clamp_min(256.0 * eps * primal_scale, 1e-6)
    tol_d = torch.clamp_min(256.0 * eps * dual_scale, 1e-6)
    return tol_p, tol_d


def _assemble_active(data: QPData, state: QPState):
    """Active-set estimate da (B, m) in {0, 1} and active-bound vector b."""
    ax = _mv(data.A, state.x)
    eq = (data.u - data.l) <= 1e-9
    tol_p, tol_d = _active_tols(data, ax)
    tol_p, tol_d = tol_p[:, None], tol_d[:, None]
    # a bound can only be active if it is finite
    low = _bound_finite(data.l) & ((ax - data.l <= tol_p) | (state.y < -tol_d))
    upp = _bound_finite(data.u) & ((data.u - ax <= tol_p) | (state.y > tol_d))
    # all-zero rows (contact-masked constraints) stay inactive: they would
    # put a zero row into the KKT system
    nz = torch.sum(torch.abs(data.A), dim=-1) > 1e-12
    active = (eq | low | upp) & nz
    b = torch.where(upp & ~low, data.u, data.l)
    b = torch.where(eq, data.u, b)
    b = torch.where(active, b, torch.zeros_like(b))
    return active.to(ax.dtype), b


def _masked(data: QPData, state: QPState, banned):
    """Active-set estimate from `state` minus the banned rows."""
    da, b = _assemble_active(data, state)
    da = da * (1.0 - banned.to(da.dtype))
    b = torch.where(banned, torch.zeros_like(b), b)
    return da, b


def _wrong_signed(data: QPData, da, b, y, eq_rows, tol_drop):
    """Rows whose candidate multiplier came out wrong-signed (next round's
    drops): forced at the upper bound needs y >= -tol, at the lower bound
    y <= tol; equality rows are sign-free."""
    side_up = (b == data.u) & ~eq_rows
    return (da > 0.5) & ~eq_rows & torch.where(side_up, y < -tol_drop, y > tol_drop)


def _tol_drop(data: QPData):
    eps = torch.finfo(data.g.dtype).eps
    scale = torch.clamp_min(torch.amax(torch.abs(data.g), dim=-1), 1.0)
    return torch.clamp_min(256.0 * eps * scale, 1e-6)[:, None]


def _finite_or_inf(pr, du):
    tot = torch.maximum(pr, du)
    return torch.where(torch.isfinite(tot), tot, torch.full_like(tot, float("inf")))


def _accept_better(best, pr_b, du_b, res_b, polished, cand, pr_c, du_c,
                   res_c, data, cand_polished=None, sv_cand=None):
    """Per-scenario merge: keep `cand` wherever its SIGN-AUGMENTED residual
    max(res, sign_violation) improves, so a wrong-active-set saddle can
    never displace an honest iterate.  The carried pr/du/res stay the plain
    OSQP-convention certificates."""
    svc = sv_cand if sv_cand is not None else _sign_violation(data, cand.x, cand.y)
    ok = torch.maximum(res_c, svc) <= torch.maximum(
        res_b, _sign_violation(data, best.x, best.y))
    merged = _where_state(ok, cand, best)
    pol = polished | ok if cand_polished is None else polished | (ok & cand_polished)
    return (merged, torch.where(ok, pr_c, pr_b), torch.where(ok, du_c, du_b),
            torch.where(ok, res_c, res_b), pol)


def _polish_comp(data: QPData, state: QPState, params: QPSolverParams, Hinv=None,
                 passes=None):
    """Compensated (double-float32) active-set polish candidate.

    Re-estimate the active set from `state`, solve the regularized KKT
    system with the plain Schur pipeline, then run `passes` refinement
    passes (default max(rescue_comp_refine, 1)) whose residuals are
    computed with error-free transformations (ops/compensated.py): once
    the iterate is a few digits accurate a plain float32 residual is
    cancellation noise, while the compensated residual is exact to
    ~eps * |r|.  Preconditioner
    applications stay plain products.  Hinv: the polish H^-1 (dense or
    compact); None: a cold Newton-Schulz inverse of H + reg I.  Returns
    (candidate, pr, du)."""
    dtype = data.H.dtype
    n = data.H.shape[-1]
    eye_n = torch.eye(n, dtype=dtype, device=data.H.device)
    da, b = _assemble_active(data, state)
    Hreg = data.H + params.polish_reg * eye_n
    Hinv_d = ns_inverse(Hreg, params.ns_iters) if Hinv is None else _dense_h(Hinv)
    Bm = da[:, :, None] * data.A
    Bt = Bm.transpose(-1, -2)
    diag_S = params.polish_reg * da + (1.0 - da)
    S = Bm @ Hinv_d @ Bt + torch.diag_embed(diag_S)
    Sinv = ns_inverse(S, params.ns_iters)
    D = (1.0 - da) - params.polish_reg * da
    y = _mv(Sinv, -(da * b + _mv(Bm, _mv(Hinv_d, data.g))))
    x = _mv(Hinv_d, -data.g - _mv(Bt, y))
    # full KKT operator for the compensated residual: K w = rhs,
    # K = [[H+reg I, B^T], [B, diag(D)]], w = [x; y]
    Kfull = torch.cat(
        [torch.cat([Hreg, Bt], dim=-1), torch.cat([Bm, torch.diag_embed(D)], dim=-1)],
        dim=-2,
    )
    rhs = torch.cat([-data.g, da * b], dim=-1)
    for _ in range(max(params.rescue_comp_refine, 1) if passes is None else passes):
        r = comp.comp_residual(rhs, Kfull, torch.cat([x, y], dim=-1))
        r1, r2 = r[..., :n], r[..., n:]
        dy = _mv(Sinv, _mv(Bm, _mv(Hinv_d, r1)) - r2)
        dx = _mv(Hinv_d, r1 - _mv(Bt, dy))
        x = x + dx
        y = y + dy
    ax = _mv(data.A, x)
    pol = QPState(x=x, z=torch.minimum(torch.maximum(ax, data.l), data.u), y=y)
    pr, du = kkt_residual(data, pol.x, pol.y)
    return pol, pr, du


def _comp_refine_final(data: QPData, state: QPState, params: QPSolverParams, Hinv, sinv):
    """`comp_final_refine` compensated refinement passes on the final
    iterate, with the preconditioners already in hand: the polish H^-1
    (compact or dense, applied by `_hinv_mv`) and the last polish round's
    Schur inverse `sinv` (B, m, m); no new Newton-Schulz inverse.  Each
    pass re-estimates the active set from the current iterate (a
    mis-classified row shows up as a wrong-signed multiplier and drops
    out) and computes r1 = -g - (H + reg I) x - B^T y and
    r2 = da b - B x - D y, each in one compensated accumulation (the
    cancellation at stationarity is between blocks).  Returns
    (candidate, pr, du); the caller accepts it on the sign-augmented
    residual."""
    reg = torch.full_like(state.x, params.polish_reg)
    x, y = state.x, state.y
    for _ in range(params.comp_final_refine):
        da, b = _assemble_active(data, QPState(x=x, z=state.z, y=y))
        Bm = da[:, :, None] * data.A
        Bt = Bm.transpose(-1, -2)
        D = (1.0 - da) - params.polish_reg * da
        r1 = comp.comp_residual_chain(-data.g, mat_terms=((data.H, x), (Bt, y)),
                                      diag_terms=((reg, x),))
        r2 = comp.comp_residual_chain(da * b, mat_terms=((Bm, x),), diag_terms=((D, y),))
        dy = _mv(sinv, _mv(Bm, _hinv_mv(Hinv, r1)) - r2)
        dx = _hinv_mv(Hinv, r1 - _mv(Bt, dy))
        x = x + dx
        y = y + dy
    ax = _mv(data.A, x)
    pol = QPState(x=x, z=torch.minimum(torch.maximum(ax, data.l), data.u), y=y)
    pr, du = kkt_residual(data, pol.x, pol.y)
    return pol, pr, du


def _merge_final(data: QPData, pre, cand, pr_c, du_c):
    """Merge a final-refinement candidate into `pre` = (best, pr, du, res,
    polished), per scenario where its sign-augmented residual is no worse
    (`_accept_better`), value only (`_ad_passthrough`)."""
    with torch.no_grad():
        post = _accept_better(*_sg(pre), cand, pr_c, du_c, _finite_or_inf(pr_c, du_c),
                              _sg(data))
    return _ad_passthrough(pre, post)


def _polish(data: QPData, state: QPState, params: QPSolverParams, Hinv, banned=None,
            return_active: bool = False):
    """Active-set KKT solve from `state`'s active-set estimate, minus the
    `banned` rows, with the plain Schur pipeline (`linalg.solve_kkt_schur`,
    a cold Schur inverse) and the dense round-invariant H^-1: the polish of
    `solve` and of a solve without a carried cache (the JAX package's
    single-sample `_polish`, batched).  With `return_active`, returns
    (state, da, b): the active set it solved and its bound vector."""
    n = data.H.shape[-1]
    da, b = _assemble_active(data, state) if banned is None else _masked(data, state, banned)
    x, y = solve_kkt_schur(
        data.H + params.polish_reg * torch.eye(n, dtype=data.H.dtype, device=data.H.device),
        da[:, :, None] * data.A, da, data.g, b, reg=params.polish_reg,
        iters=params.ns_iters, refine=params.polish_refine, Hinv=Hinv,
    )
    pol = QPState(x=x, z=torch.minimum(torch.maximum(_mv(data.A, x), data.l), data.u), y=y)
    return (pol, da, b) if return_active else pol


def _polish_hinv(data: QPData, params: QPSolverParams):
    """The round-invariant dense polish H^-1: a cold Newton-Schulz inverse
    of H + reg I."""
    n = data.H.shape[-1]
    eye_n = torch.eye(n, dtype=data.H.dtype, device=data.H.device)
    return ns_inverse(data.H + params.polish_reg * eye_n, params.ns_iters)


def _rho_vec(data: QPData, params: QPSolverParams):
    """ADMM penalty per row (B, m): boosted on the equality rows."""
    eq = (data.u - data.l) <= 1e-9
    rho = torch.full_like(data.l, params.rho)
    return torch.where(eq, rho * params.rho_eq_scale, rho)


def _ruiz_equilibrate(data: QPData, iters: int):
    """Ruiz equilibration of each problem's KKT matrix [[H, A^T], [A, 0]]:
    diagonal scalings d (B, n) and e (B, m), one sweep dividing every
    column and row by the square root of its largest entry.  The WBC QP
    mixes wrench rows (~5e2 N) with acceleration rows (~1)."""
    B, m, n = data.A.shape
    d = torch.ones((B, n), dtype=data.H.dtype, device=data.H.device)
    e = torch.ones((B, m), dtype=data.H.dtype, device=data.H.device)
    for _ in range(iters):
        Hs = torch.abs(d[:, :, None] * data.H * d[:, None, :])
        As = torch.abs(e[:, :, None] * data.A * d[:, None, :])
        cx = torch.maximum(torch.amax(Hs, dim=1), torch.amax(As, dim=1))  # per variable
        rz = torch.amax(As, dim=2)                                        # per row
        d = d * torch.rsqrt(torch.clamp_min(cx, 1e-8))
        e = e * torch.rsqrt(torch.clamp_min(rz, 1e-8))
    return d, e


def _rescue_solver_params(params: QPSolverParams) -> QPSolverParams:
    """Settings of the rescue's re-solve: the rescue's ADMM and polish
    budgets, and no rescue of its own."""
    return dataclasses.replace(params, iterations=params.rescue_iterations,
                               polish_rounds=params.rescue_polish_rounds,
                               rescue_threshold=0.0)


def solve(data: QPData, warm: QPState, params: QPSolverParams = QPSolverParams()):
    """Solve a batch of QPs, each as the JAX package's single-sample `solve`
    does (its result equals that function under `vmap`, scenario by
    scenario; B = 1 is the single robot).  Returns (state, info).  Tensor
    code only, in the caller's grad mode: the gradient flows through the
    ADMM and polish rounds, not through the rescue (merged value only).

    Scaled problem -> a cold K^-1 of K = sH + sigma I + A^T diag(rho) A ->
    `params.iterations` x-space ADMM iterations from the scaled warm start
    (`cold_iterations` in all for a scenario whose warm start is all zero)
    -> `polish_rounds` dense Schur polish rounds with the drop rule, each
    candidate accepted on the sign-augmented residual -> with
    `rescue_threshold` > 0, the single-sample rescue: while a scenario's
    relative KKT is above the threshold and its last stage improved it, up
    to `rescue_stages` times, re-solve it warm from its best iterate with
    the rescue's budgets and keep the result where the plain KKT residual
    is no worse.  Each stage runs on the scenarios still in it.

    As in the JAX package, this function reads none of `comp_final_refine`
    and the drop round's options (`drop_*`, `cond_hoist`)."""
    B, m, n = data.A.shape
    dtype, dev = data.H.dtype, data.H.device
    eye_n = torch.eye(n, dtype=dtype, device=dev)

    # ---- scaling ----
    if params.scaling_iters > 0:
        d, e = _ruiz_equilibrate(data, params.scaling_iters)
    else:
        d = torch.ones((B, n), dtype=dtype, device=dev)
        e = torch.ones((B, m), dtype=dtype, device=dev)
    sH = d[:, :, None] * data.H * d[:, None, :]
    sg = d * data.g
    sA = e[:, :, None] * data.A * d[:, None, :]
    sl, su = e * data.l, e * data.u
    rho = _rho_vec(QPData(sH, sg, sA, sl, su), params)
    sigma, alpha = params.sigma, params.alpha
    sAt = sA.transpose(-1, -2)
    K = sH + sigma * eye_n + (sAt * rho[:, None, :]) @ sA
    Kinv = ns_inverse(K, params.ns_iters)

    def admm_loop(x, z, y, iters):
        for _ in range(iters):
            rhs = sigma * x - sg + _mv(sAt, rho * z - y)
            x_t = _mv(Kinv, rhs)
            z_t = _mv(sA, x_t)
            x_n = alpha * x_t + (1.0 - alpha) * x
            z_pre = alpha * z_t + (1.0 - alpha) * z + y / rho
            z_n = torch.minimum(torch.maximum(z_pre, sl), su)
            y = y + rho * (alpha * z_t + (1.0 - alpha) * z - z_n)
            x, z = x_n, z_n
        return x, z, y

    # the warm start mapped into the scaled space (x = d xs, y = e ys, z = zs / e)
    x, z, y = admm_loop(warm.x / d, warm.z * e, warm.y / e, params.iterations)
    # cold start (an all-zero warm state): spend the init budget, the
    # qpOASES init/hotstart asymmetry; run for the batch when any scenario
    # is cold and kept only where it is
    extra = max(0, params.cold_iterations - params.iterations)
    if extra:
        cold = ~((warm.x != 0).any(-1) | (warm.z != 0).any(-1) | (warm.y != 0).any(-1))
        if _host(cold.any()):
            xc, zc, yc = admm_loop(x, z, y, extra)
            ck = cold[:, None]
            x, z, y = (torch.where(ck, xc, x), torch.where(ck, zc, z),
                       torch.where(ck, yc, y))
    best = QPState(x=d * x, z=z / e, y=e * y)

    pr_b, du_b = kkt_residual(data, best.x, best.y)
    res_b = _finite_or_inf(pr_b, du_b)
    sv_b = _sign_violation(data, best.x, best.y)
    polished = torch.zeros_like(res_b, dtype=torch.bool)
    Hinv_polish = _polish_hinv(data, params) if params.polish else None
    # polish rounds with the DROP rule: each round re-estimates the active
    # set from the working candidate chain (through rejections), minus the
    # rows whose candidate multiplier came out wrong-signed
    eq_rows = (data.u - data.l) <= 1e-9
    tol_drop = _tol_drop(data)
    banned = torch.zeros_like(eq_rows)
    w_pol = best
    for _ in range(params.polish_rounds if params.polish else 0):
        pol, da, b = _polish(data, w_pol, params, Hinv_polish, banned=banned,
                             return_active=True)
        banned = banned | _wrong_signed(data, da, b, pol.y, eq_rows, tol_drop)
        w_pol = pol
        pr_p, du_p = kkt_residual(data, pol.x, pol.y)
        res_p = _finite_or_inf(pr_p, du_p)
        sv_p = _sign_violation(data, pol.x, pol.y)
        ok = torch.maximum(res_p, sv_p) <= torch.maximum(res_b, sv_b)
        best = _where_state(ok, pol, best)
        pr_b, du_b = torch.where(ok, pr_p, pr_b), torch.where(ok, du_p, du_b)
        res_b, sv_b = torch.where(ok, res_p, res_b), torch.where(ok, sv_p, sv_b)
        polished = polished | ok

    if params.rescue_threshold > 0:
        # the rescue runs under torch.no_grad() on detached inputs and is
        # merged value only: the gradient flows through the pre-rescue
        # iterate, as in the JAX package
        before = (best, QPInfo(pr_b, du_b, res_b, polished))
        data, (best, (pr_b, du_b, res_b, polished)) = _sg(data), _sg(before)
        with torch.no_grad():
            rparams = _rescue_solver_params(params)
            improved = torch.ones_like(polished)
            for _ in range(params.rescue_stages):
                idx = _host_nonzero((res_b > params.rescue_threshold) & improved)
                if idx.numel() == 0:
                    break
                res_i = _take(res_b, idx)
                st, ri = solve(QPData(*(_take(leaf, idx) for leaf in data)),
                               _take_state(best, idx), rparams)
                ok = ri.kkt_residual <= res_i
                kept = _where_state(ok, st, _take_state(best, idx))
                best = QPState(*(_put(a, idx, k) for a, k in zip(best, kept)))
                pr_b = _put(pr_b, idx, torch.where(ok, ri.primal_residual, _take(pr_b, idx)))
                du_b = _put(du_b, idx, torch.where(ok, ri.dual_residual, _take(du_b, idx)))
                res_b = _put(res_b, idx, torch.where(ok, ri.kkt_residual, res_i))
                polished = _put(polished, idx, _take(polished, idx) | (ok & ri.polished))
                improved = _put(improved, idx, ok & (ri.kkt_residual < res_i))
        return _ad_passthrough(before, (best, QPInfo(pr_b, du_b, res_b, polished)))
    return best, QPInfo(pr_b, du_b, res_b, polished)


def _rescue_batched(data: QPData, best: QPState, info: QPInfo, params: QPSolverParams,
                    hinv_fn=None):
    """The batch-level tail rescue of the "torch" backend: while ANY
    scenario's relative KKT exceeds rescue_threshold (up to rescue_stages
    times, and while the last stage improved some scenario), re-solve the
    whole batch warm from its best iterates with the rescue's budgets
    (`solve_batched(backend="torch")`), add a compensated-refinement polish
    candidate (`_polish_comp`, with `hinv_fn`'s H^-1 when given, else its
    own Newton-Schulz inverse), and accept each candidate per scenario on
    the sign-augmented residual.  Runs under `torch.no_grad()` on detached
    inputs; its result is merged value only (`_ad_passthrough`)."""
    before = (best, info)
    data, (best, (pr_b, du_b, res_b, pol)) = _sg(data), _sg(before)
    with torch.no_grad():
        rparams = _rescue_solver_params(params)
        stage, improved = 0, True
        while (stage < params.rescue_stages and improved
               and _host((res_b > params.rescue_threshold).any())):
            st, ri = solve_batched(data, best, rparams, "torch", hinv_fn=hinv_fn)
            merged, pr_m, du_m, res_m, pol = _accept_better(
                best, pr_b, du_b, res_b, pol, st, ri.primal_residual, ri.dual_residual,
                ri.kkt_residual, data, cand_polished=ri.polished)
            if params.rescue_comp_refine > 0 and params.polish:
                Hinv = hinv_fn(data.H, params.polish_reg) if hinv_fn is not None else None
                cand, pr_c, du_c = _polish_comp(data, merged, params, Hinv)
                merged, pr_m, du_m, res_m, pol = _accept_better(
                    merged, pr_m, du_m, res_m, pol, cand, pr_c, du_c,
                    _finite_or_inf(pr_c, du_c), data)
            improved = bool(_host((res_m < res_b).any()))
            best, pr_b, du_b, res_b = merged, pr_m, du_m, res_m
            stage += 1
    return _ad_passthrough(before, (best, QPInfo(pr_b, du_b, res_b, pol)))


def _polish_batched_kernel(data: QPData, params: QPSolverParams, H_reg, Hinv,
                           sinv_fn, da_b):
    """One polish round: plain tensor code assembles the Schur matrix (only
    when `sinv_fn` asks for it) and inverts it by Newton-Schulz; the kernel
    does the solve, the refinement and the residual cascade in one pass.
    Returns (pol, sinv, pr, du, sv).

    sinv_fn receives a THUNK that assembles the polish Schur matrix
    S = (da da^T) * (A Hinv A^T) + diag(reg*da + (1-da)), optionally for a
    sub-batch of scenario indices, so pass-through implementations skip
    the assembly entirely."""
    da, b = da_b

    def S_thunk(idx=None):
        if idx is None:
            da_, A_, Hinv_ = da, data.A, Hinv
        else:
            da_, A_, Hinv_ = _take(da, idx), _take(data.A, idx), _take_h(Hinv, idx)
        diag_S = params.polish_reg * da_ + (1.0 - da_)
        G2 = A_ @ _dense_h(Hinv_) @ A_.transpose(-1, -2)
        return da_[:, :, None] * da_[:, None, :] * G2 + torch.diag_embed(diag_S)

    sinv = sinv_fn(S_thunk)
    x, y, z, pr, du, sv = polish.polish_solve(
        H_reg, Hinv, sinv, data.A, da, data.g, b, data.l, data.u,
        refine=params.polish_refine, reg=params.polish_reg,
    )
    return QPState(x=x, z=z, y=y), sinv, pr, du, sv


def _admm_res(params: QPSolverParams, *args, iters: int):
    """The ADMM kernel with its residual epilogue that `params.sigma` picks:
    the constraint-space iteration at sigma = 0, the x-space one above."""
    if params.sigma == 0.0:
        return admm_zy.admm_zy_iterations_res(*args, iters=iters, alpha=params.alpha)
    return admm.admm_iterations_res(*args, iters=iters, sigma=params.sigma,
                                    alpha=params.alpha)


def solve_batched(
    data: QPData,
    warm: QPState,
    params: QPSolverParams = QPSolverParams(),
    backend: str = "kernel",
    cache: "QPCache | None" = None,
    use_warm=None,
    hinv_fn=None,
    prepared=None,
):
    """Batched solve; returns (state, info, new_cache) with a cache, else
    (state, info).

    backend: "kernel" (the solver kernels, below) or "torch": `solve` with
    its rescue off, then `comp_final_refine` compensated passes (a
    `_polish_comp` candidate), then the batch-level rescue
    `_rescue_batched`, the JAX package's "xla" backend.  The torch backend
    keeps no factorizations (a given cache comes back as it went in),
    ignores `use_warm` and `prepared`, and reads `hinv_fn` only for the
    compensated candidates.  It runs in the caller's grad mode (the
    gradient of the JAX package's "xla" backend).  The kernel backend has no backward, as
    the JAX package's Pallas backend has none: with grad mode on, an input
    that requires grad raises before anything launches
    (`kernels.build.refuse_grad`); otherwise it runs under
    `torch.no_grad()`.

    cache / use_warm: carried QPCache of last cycle's inverses and the warm
    gate, a scalar or a (B,) bool mask.  With a mask (and
    0 < cold_batch < B) the warm update runs for the whole batch and the
    cold scenarios are re-inverted on a compacted top-k sub-batch; more
    cold scenarios than cold_batch fall back to the full-batch cold
    inverse.  Pass False on the first cycle.  Without a cache every inverse
    is cold and the polish rounds run the plain Schur polish (`_polish`).

    hinv_fn: callable (H (B, n, n), reg) -> COMPACT block-diagonal inverse
    (diag (B, n), blk (B, k, k), start) of the regularized polish Hessian.
    None: the dense regularized H^-1 comes from the same gated inverse as
    K^-1, warm-started from `cache.hinv`, and is carried in the new cache.

    prepared: the 11 tensors of `prepare.prepare_scaled` for this `data` and
    `warm`, already computed (the fused setup kernel's tail): the prepare
    stage is skipped and they are taken as they are."""
    if backend not in ("kernel", "torch"):
        raise ValueError(f"backend={backend!r}: 'kernel' (the solver kernels) or "
                         "'torch' (the single-sample algorithm, tensor code)")
    if backend == "torch":
        st, info = solve(data, warm, dataclasses.replace(params, rescue_threshold=0.0))
        if params.comp_final_refine > 0 and params.polish:
            # the compensated final refinement, before the rescue as on the
            # kernel path; no carried inverses here: _polish_comp derives
            # its own (H^-1 from hinv_fn where one is given)
            with torch.no_grad():
                data_sg = _sg(data)
                Hinv = hinv_fn(data_sg.H, params.polish_reg) if hinv_fn is not None else None
                cand, pr_c, du_c = _polish_comp(data_sg, _sg(st), params, Hinv,
                                                passes=params.comp_final_refine)
            st, *rest = _merge_final(data, (st, *info), cand, pr_c, du_c)
            info = QPInfo(*rest)
        if params.rescue_threshold > 0:
            st, info = _rescue_batched(data, st, info, params, hinv_fn)
        return (st, info) if cache is None else (st, info, cache)
    build.refuse_grad('solve_batched(backend="kernel")', data, warm, cache, use_warm,
                      prepared, hint='backend="torch" carries a gradient')
    with torch.no_grad():
        B, m, n = data.A.shape
        dtype, dev = data.H.dtype, data.H.device
        eye_n = torch.eye(n, dtype=dtype, device=dev)

        if prepared is None:
            prepared = prepare.prepare_scaled(
                data.H, data.A, data.g, data.l, data.u, warm.x, warm.z, warm.y,
                sweeps=params.scaling_iters, rho0=params.rho,
                rho_eq_scale=params.rho_eq_scale,
            )
        sH, sA, sg, sl, su, rho, wxs, wzs, wys, dscale, escale = prepared
        K = sH + params.sigma * eye_n if params.sigma else sH
        K = K + (sA.transpose(-1, -2) * rho[:, None, :]) @ sA
        wi_polish = (params.ns_warm_iters_polish if params.ns_warm_iters_polish >= 0
                     else params.ns_warm_iters)

        # ---- warm-cache gate ----
        # per-scenario: a (B,) mask with 0 < cold_batch < B; else batch-level;
        # no cache: every inverse is cold
        kcold = params.cold_batch
        warm_mask = cold_idx = None
        n_cold = 0
        warm_all = False
        if cache is not None and use_warm is not None:
            use_warm = torch.as_tensor(use_warm, device=dev)
            if use_warm.ndim >= 1 and 0 < kcold < use_warm.shape[0]:
                warm_mask = use_warm
                n_cold = int(_host((~warm_mask).sum()))
                if 0 < n_cold <= kcold:
                    cold_idx = torch.topk((~warm_mask).to(torch.float32), kcold).indices
            else:
                warm_all = bool(_host(use_warm.all()))

        def cold_fix(X, M_cold):
            """Overwrite the cold scenarios' rows of X with fresh cold NS
            inverses of the gathered top-k sub-batch.  topk returns exactly
            kcold indices: when fewer scenarios are cold the extras are warm
            ones, whose rows are kept (so which extras are picked is
            immaterial)."""
            Xc = ns_inverse(M_cold, params.ns_iters, body_prec=params.ns_cold_prec or None,
                            tail=params.ns_cold_tail)
            sel = _take(warm_mask, cold_idx)
            Xc = torch.where(sel[:, None, None], _take(X, cold_idx), Xc)
            return _put(X, cold_idx, Xc)

        def make_inv(warm_arr, wi):
            """The inverse of M gated on the warm mask or the scalar gate:
            warm scenarios restart from `warm_arr` (wi >= 1 Newton-Schulz
            iterations, or its safeguarded pass-through at wi = 0), cold ones
            get a cold inverse."""
            def warm_update(M):
                if wi >= 1:
                    return ns_inverse_warm_shared(M, warm_arr, wi)
                return ns_inverse(M, params.ns_iters, warm=warm_arr, warm_iters=0)

            def inv(M):
                if warm_mask is not None and n_cold <= kcold:
                    X = warm_update(M)
                    return cold_fix(X, _take(M, cold_idx)) if n_cold > 0 else X
                if warm_mask is None and warm_all:
                    return warm_update(M)
                return ns_inverse(M, params.ns_iters)

            return inv

        Kinv = make_inv(None if cache is None else cache.kinv, params.ns_warm_iters)(K)

        def run_admm(x0, z0, y0, iters):
            return _admm_res(params, Kinv, sA, sg, sl, su, rho, x0, z0, y0, sH,
                             data.l, data.u, dscale, escale, iters=iters)

        x, z, y, pr_b, du_b, sv_b = run_admm(wxs, wzs, wys, params.iterations)
        # cold start (any scenario with an all-zero warm state): spend the init
        # budget batch-wide, the qpOASES init/hotstart asymmetry
        extra = max(0, params.cold_iterations - params.iterations)
        if extra:
            per_cold = ~((warm.x != 0).any(-1) | (warm.z != 0).any(-1)
                         | (warm.y != 0).any(-1))
            if _host(per_cold.any()):
                x, z, y, pr_b, du_b, sv_b = run_admm(x, z, y, extra)
        best = QPState(x=dscale * x, z=z / escale, y=escale * y)

        # ---- polish inputs: the regularized H and its inverse, compact from
        # the caller's closed form or dense ----
        H_polish = Hinv_polish = None
        if params.polish and hinv_fn is not None:
            Hinv_polish = hinv_fn(data.H, params.polish_reg)
            _, hblk, hstart = Hinv_polish
            k_ = hblk.shape[-1]
            diag_reg = torch.diagonal(data.H, dim1=-2, dim2=-1) + params.polish_reg
            diag_reg = torch.cat(
                [diag_reg[:, :hstart], torch.zeros_like(diag_reg[:, :k_]),
                 diag_reg[:, hstart + k_:]], dim=1)
            blk_reg = data.H[:, hstart:hstart + k_, hstart:hstart + k_] \
                + params.polish_reg * torch.eye(k_, dtype=dtype, device=dev)
            H_polish = (diag_reg, blk_reg, hstart)
        elif params.polish:
            H_polish = data.H + params.polish_reg * eye_n
            Hinv_polish = make_inv(None if cache is None else cache.hinv,
                                   wi_polish)(H_polish)

        def sinv_cold(S_thunk):
            return ns_inverse(S_thunk(), params.ns_iters)

        def sinv_round1(S_thunk):
            """With wi_polish = 0, round 1 takes the carried Schur inverse as it
            is on warm scenarios (a stale-but-finite cache is caught by the
            polish acceptance residuals) and never assembles S for them; cold
            scenarios are assembled and re-inverted compactly.  Otherwise the
            Schur matrix is inverted through the gated warm update."""
            if wi_polish != 0:
                return make_inv(cache.sinv, wi_polish)(S_thunk())
            if warm_mask is not None:
                if n_cold > kcold:
                    return sinv_cold(S_thunk)
                if n_cold > 0:
                    return cold_fix(cache.sinv, S_thunk(cold_idx))
                return cache.sinv
            return cache.sinv if warm_all else sinv_cold(S_thunk)

        # pr_b/du_b/sv_b came from the ADMM kernel's epilogue
        res_b = _finite_or_inf(pr_b, du_b)
        polished = torch.zeros_like(res_b, dtype=torch.bool)
        sinv_last = None if cache is None else cache.sinv
        # active-set DROP rule across polish rounds: the working iterate w_pol
        # follows the candidate chain even through rejections, and rows whose
        # candidate multiplier came out wrong-signed are banned from the next
        # round's estimate (a stale warm-start dual otherwise pins a row at a
        # bound it left)
        eq_rows = (data.u - data.l) <= 1e-9
        tol_drop = _tol_drop(data)
        banned = torch.zeros_like(eq_rows)
        w_pol = best
        ok_prev = wrong_any_prev = None
        inf_r = torch.full_like(pr_b, float("inf"))
        k2 = params.drop_batch
        for round_i in range(params.polish_rounds if params.polish else 0):
            if cache is None:
                # no carried Schur inverse to thread through: each round is the
                # plain Schur polish from the best iterate
                pol = _polish(data, best, params, _dense_h(Hinv_polish))
                pr_p, du_p = kkt_residual(data, pol.x, pol.y)
                sv_p = _sign_violation(data, pol.x, pol.y)
            else:
                compact2 = round_i > 0 and 0 < k2 < B
                if not compact2:
                    da, b = _masked(data, w_pol, banned)
                if round_i == 0:
                    pol, sinv_last, pr_p, du_p, sv_p = _polish_batched_kernel(
                        data, params, H_polish, Hinv_polish, sinv_round1, (da, b))
                else:
                    # round 2+ runs only for the scenarios the PREVIOUS round
                    # failed: a drop fired (wrong-signed candidate multiplier)
                    # or the candidate was rejected outright.  Their active set
                    # differs from round 1's, so the carried inverse is an
                    # inverse of the wrong Schur matrix: pay the cold inverse
                    # (or, with wi_polish > 0, warm it from round 1's).
                    # `cond_hoist` only routes the JAX package's lax.cond
                    # buffers (every output bitwise the same for 0, 1, 2);
                    # host branches have none to route, so it is not read.
                    sinv_prev = sinv_last
                    changed_i = wrong_any_prev | ~ok_prev
                    if params.drop_fire_tol > 0:
                        # only scenarios whose current best sign-augmented
                        # residual still exceeds the bar enter the round
                        changed_i = changed_i & (torch.maximum(res_b, sv_b)
                                                 > params.drop_fire_tol)
                    fire = _host(changed_i.any())
                    if not fire:
                        pol, pr_p, du_p, sv_p = best, inf_r, inf_r, inf_r
                        if compact2:
                            wrong_any_prev = torch.zeros_like(changed_i)
                    elif compact2:
                        # COMPACTED: rank the failed scenarios by severity and
                        # take the k2 worst, a hard cap with no full-batch
                        # fallback; scenarios beyond it keep round-1 results and
                        # the staged rescue remains the guarantee.  With
                        # `drop_approx_rank` the JAX package ranks with
                        # lax.approx_max_k (about 0.95 recall on a TPU, top_k's
                        # indices on a CPU); the exact topk stands in for it.
                        score = torch.where(changed_i, torch.maximum(res_b, sv_b), -inf_r)
                        idx2 = torch.topk(score, k2).indices
                        data_c = QPData(*(_take(leaf, idx2) for leaf in data))
                        w_c = _take_state(w_pol, idx2)
                        banned_c = _take(banned, idx2)
                        da_c, b_c = _masked(data_c, w_c, banned_c)
                        if params.drop_warm_iters > 0:
                            # warm from the carried rows; ns_inverse's
                            # divergence guard falls back to the cold start
                            warm_c = _take(sinv_prev, idx2)

                            def sinv_drop(S_thunk):
                                return ns_inverse(S_thunk(), params.ns_iters, warm=warm_c,
                                                  warm_iters=params.drop_warm_iters)
                        else:
                            def sinv_drop(S_thunk):
                                return ns_inverse(S_thunk(),
                                                  params.drop_ns_iters or params.ns_iters,
                                                  body_prec=params.ns_cold_prec or None,
                                                  tail=params.ns_cold_tail)
                        pol_c, sinv_c, pr_c, du_c, sv_c = _polish_batched_kernel(
                            data_c, params, _take_h(H_polish, idx2),
                            _take_h(Hinv_polish, idx2), sinv_drop, (da_c, b_c))
                        # topk pads with unchanged rows when fewer than k2
                        # scenarios changed: mask their candidates out
                        sel = _take(changed_i, idx2)
                        inf_c = torch.full_like(pr_c, float("inf"))
                        pr_c = torch.where(sel, pr_c, inf_c)
                        du_c = torch.where(sel, du_c, inf_c)
                        sv_c = torch.where(sel, sv_c, inf_c)
                        pol = QPState(x=_put(best.x, idx2, pol_c.x),
                                      z=_put(best.z, idx2, pol_c.z),
                                      y=_put(best.y, idx2, pol_c.y))
                        if params.drop_sinv_refresh:
                            # the re-solved scenarios carry their fresh
                            # Schur inverses into the cache
                            sinv_last = _put(sinv_prev, idx2, torch.where(
                                sel[:, None, None], sinv_c, _take(sinv_prev, idx2)))
                        wrong_c = sel[:, None] & _wrong_signed(
                            data_c, da_c, b_c, pol_c.y, _take(eq_rows, idx2),
                            _take(tol_drop, idx2))
                        banned = _put(banned, idx2, banned_c | wrong_c)
                        wrong_any_prev = _put(torch.zeros_like(changed_i), idx2,
                                              wrong_c.any(-1))
                        pr_p, du_p, sv_p = (_put(inf_r, idx2, pr_c), _put(inf_r, idx2, du_c),
                                            _put(inf_r, idx2, sv_c))
                    else:
                        def sinv_round2(S_thunk):
                            if wi_polish == 0:
                                return sinv_cold(S_thunk)
                            return ns_inverse(S_thunk(), params.ns_iters, warm=sinv_prev,
                                              warm_iters=wi_polish)

                        pol, sinv_last, pr_p, du_p, sv_p = _polish_batched_kernel(
                            data, params, H_polish, Hinv_polish, sinv_round2, (da, b))
                if not compact2:
                    wrong = _wrong_signed(data, da, b, pol.y, eq_rows, tol_drop)
                    banned = banned | wrong
                    wrong_any_prev = wrong.any(-1)
                w_pol = pol
            res_p = _finite_or_inf(pr_p, du_p)
            ok = torch.maximum(res_p, sv_p) <= torch.maximum(res_b, sv_b)
            best = _where_state(ok, pol, best)
            pr_b = torch.where(ok, pr_p, pr_b)
            du_b = torch.where(ok, du_p, du_b)
            res_b = torch.where(ok, res_p, res_b)
            sv_b = torch.where(ok, sv_p, sv_b)
            polished = polished | ok
            ok_prev = ok

        if (params.comp_final_refine > 0 and params.polish and Hinv_polish is not None
                and sinv_last is not None):
            # compensated refinement of the final iterate with the polish
            # preconditioners in hand, before the rescue so that tightened
            # scenarios need it less
            cand, pr_c, du_c = _comp_refine_final(data, best, params, Hinv_polish,
                                                  sinv_last)
            # as in the JAX package, the rescue's first fire flag pairs the
            # merged residual with the incumbent's sign violation
            sv_b = _sign_violation(data, best.x, best.y)
            best, pr_b, du_b, res_b, polished = _merge_final(
                data, (best, pr_b, du_b, res_b, polished), cand, pr_c, du_c)

        if params.rescue_threshold > 0:
            best, pr_b, du_b, res_b, polished = _rescue_staged(
                data, params, best, pr_b, du_b, res_b, polished, sv_b,
                (K, sA, sg, sl, su, rho, sH, dscale, escale), H_polish, Hinv_polish)

        info = QPInfo(pr_b, du_b, res_b, polished)
        if cache is None:
            return best, info
        # a compact closed-form H^-1 is recomputed per step and never read back
        # from the cache: carry the slot through
        hinv = Hinv_polish if isinstance(Hinv_polish, torch.Tensor) else cache.hinv
        return best, info, QPCache(kinv=Kinv, hinv=hinv, sinv=sinv_last)


def _rescue_core(params, best, pr_b, du_b, res_b, polished, scaled, data, H_pol,
                 Hinv_pol):
    """One rescue pass over a (sub-)batch whose problem is ALREADY scaled:
    a cold K^-1, the ADMM recursion (the kernel `params.sigma` picks)
    continued from the best iterate, and, with `params.polish`, cold-Schur
    polish rounds with the drop rule (round 2+ compacted to the scenarios
    still above threshold) and a compensated-refinement candidate.  Every
    candidate is accepted per scenario only where the sign-augmented
    residual improves.

    The cold chains run at full float32 precision whatever
    params.ns_cold_prec says: the rescue is the tail guarantee."""
    K_, sA_, sg_, sl_, su_, rho_, sH_, d_, e_ = scaled
    Kinv_cold = ns_inverse(K_, params.ns_iters)
    x, z, y, pr_c, du_c, sv_c = _admm_res(
        params, Kinv_cold, sA_, sg_, sl_, su_, rho_,
        best.x / d_, best.z * e_, best.y / e_,
        sH_, data.l, data.u, d_, e_, iters=params.rescue_iterations,
    )
    cand = QPState(x=d_ * x, z=z / e_, y=e_ * y)
    best, pr_b, du_b, res_b, polished = _accept_better(
        best, pr_b, du_b, res_b, polished, cand, pr_c, du_c,
        _finite_or_inf(pr_c, du_c), data,
        cand_polished=torch.zeros_like(polished), sv_cand=sv_c,
    )
    if not params.polish:
        return best, pr_b, du_b, res_b, polished

    def sinv_cold(S_thunk):
        return ns_inverse(S_thunk(), params.ns_iters)

    eqr = (data.u - data.l) <= 1e-9
    tol_dr = _tol_drop(data)
    banned = torch.zeros_like(eqr)
    # the working iterate `w` follows the CANDIDATE chain even through
    # rejections; `best` only collects certified improvements
    w = best
    nB = res_b.shape[0]
    k3 = params.rescue_round2_batch
    for r_i in range(params.rescue_polish_rounds):
        if r_i == 0 or not (0 < k3 < nB):
            da_r, b_r = _masked(data, w, banned)
            pol, _, pr_p, du_p, sv_p = _polish_batched_kernel(
                data, params, H_pol, Hinv_pol, sinv_cold, (da_r, b_r))
            banned = banned | _wrong_signed(data, da_r, b_r, pol.y, eqr, tol_dr)
            w = pol
            best, pr_b, du_b, res_b, polished = _accept_better(
                best, pr_b, du_b, res_b, polished, pol, pr_p, du_p,
                _finite_or_inf(pr_p, du_p), data, sv_cand=sv_p,
            )
            continue
        # COMPACTED round 2+: only the scenarios STILL above the threshold
        # after the previous round need it; run it on the top-k3 worst
        flag_now = torch.maximum(res_b, _sign_violation(data, best.x, best.y))
        still = flag_now > params.rescue_threshold
        if not _host(still.any()):
            continue
        neg_inf = torch.full_like(flag_now, float("-inf"))
        idx3 = torch.topk(torch.where(still, flag_now, neg_inf), k3).indices
        data_s = QPData(*(_take(leaf, idx3) for leaf in data))
        w_s = _take_state(w, idx3)
        banned_s = _take(banned, idx3)
        da_r, b_r = _masked(data_s, w_s, banned_s)
        pol_s, _, pr_s, du_s, sv_s = _polish_batched_kernel(
            data_s, params, _take_h(H_pol, idx3),
            _take_h(Hinv_pol, idx3), sinv_cold, (da_r, b_r))
        # topk pads with below-threshold rows when fewer than k3 are still
        # flagged: mask their candidates out
        sel = _take(still, idx3)
        inf_s = torch.full_like(pr_s, float("inf"))
        pr_s = torch.where(sel, pr_s, inf_s)
        du_s = torch.where(sel, du_s, inf_s)
        sv_s = torch.where(sel, sv_s, inf_s)
        wrong_s = sel[:, None] & _wrong_signed(
            data_s, da_r, b_r, pol_s.y, _take(eqr, idx3), _take(tol_dr, idx3))
        best_s, prb_s, dub_s, resb_s, pols_s = _accept_better(
            _take_state(best, idx3), _take(pr_b, idx3), _take(du_b, idx3),
            _take(res_b, idx3), _take(polished, idx3),
            pol_s, pr_s, du_s, _finite_or_inf(pr_s, du_s), data_s, sv_cand=sv_s,
        )
        selc = sel[:, None]
        w = QPState(x=_put(w.x, idx3, torch.where(selc, pol_s.x, w_s.x)),
                    z=_put(w.z, idx3, torch.where(selc, pol_s.z, w_s.z)),
                    y=_put(w.y, idx3, torch.where(selc, pol_s.y, w_s.y)))
        best = QPState(x=_put(best.x, idx3, best_s.x), z=_put(best.z, idx3, best_s.z),
                       y=_put(best.y, idx3, best_s.y))
        pr_b, du_b, res_b = (_put(pr_b, idx3, prb_s), _put(du_b, idx3, dub_s),
                             _put(res_b, idx3, resb_s))
        polished = _put(polished, idx3, pols_s)
        banned = _put(banned, idx3, banned_s | wrong_s)
    if params.rescue_comp_refine > 0:
        # compensated (double-float32) refinement candidate: the precision
        # lever once the plain polish plateaus
        cand, pr_c, du_c = _polish_comp(data, best, params, Hinv_pol)
        best, pr_b, du_b, res_b, polished = _accept_better(
            best, pr_b, du_b, res_b, polished, cand, pr_c, du_c,
            _finite_or_inf(pr_c, du_c), data,
        )
    return best, pr_b, du_b, res_b, polished


def _rescue_staged(data, params, best, pr_b, du_b, res_b, polished, sv_b, scaled,
                   H_pol, Hinv_pol):
    """Staged tail rescue (the batched analogue of qpOASES setToReliable):
    re-fires until no scenario's sign-augmented residual exceeds
    rescue_threshold, rescue_stages passes ran, or a stage improved no
    scenario.  With 0 < rescue_batch < B each stage runs on the gathered
    top-k worst scenarios and scatters accepted improvements back.

    The fire flag is SIGN-AUGMENTED, max(res, sign_violation): a scenario
    whose certificate looks converged but whose multipliers are
    wrong-signed is exactly one the drop-rule rescue can fix."""
    kres = params.rescue_batch
    compact = 0 < kres < res_b.shape[0]
    flag = torch.maximum(res_b, sv_b)
    stage, improved = 0, True
    while (stage < params.rescue_stages and improved
           and _host((flag > params.rescue_threshold).any())):
        if compact:
            idx = torch.topk(flag, kres).indices
            data_c = QPData(*(_take(leaf, idx) for leaf in data))
            best_c, pr_c, du_c, res_c, pol_c = _rescue_core(
                params, _take_state(best, idx), _take(pr_b, idx), _take(du_b, idx),
                _take(res_b, idx), _take(polished, idx),
                tuple(_take(a, idx) for a in scaled), data_c,
                _take_h(H_pol, idx), _take_h(Hinv_pol, idx),
            )
            best = QPState(x=_put(best.x, idx, best_c.x), z=_put(best.z, idx, best_c.z),
                           y=_put(best.y, idx, best_c.y))
            pr_b, du_b, res_b = (_put(pr_b, idx, pr_c), _put(du_b, idx, du_c),
                                 _put(res_b, idx, res_c))
            polished = _put(polished, idx, pol_c)
            new_flag = _put(flag, idx, torch.maximum(
                res_c, _sign_violation(data_c, best_c.x, best_c.y)))
        else:
            best, pr_b, du_b, res_b, polished = _rescue_core(
                params, best, pr_b, du_b, res_b, polished, scaled, data,
                H_pol, Hinv_pol)
            new_flag = torch.maximum(res_b, _sign_violation(data, best.x, best.y))
        # a stage that improves NO scenario's flag has hit this step's
        # fixable floor: re-firing would repeat it bit for bit
        improved = bool(_host((new_flag < flag).any()))
        flag = new_flag
        stage += 1
    return best, pr_b, du_b, res_b, polished
