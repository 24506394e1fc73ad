"""The control's QP solver: a frozen copy of the port's single-sample
algorithm (`ops/qp.solve`, the JAX package's "xla" backend): per-problem
Ruiz scaling, a cold Newton-Schulz K^-1, x-space ADMM, dense Schur polish
rounds with the drop rule and its own tail rescue, all tensor code.

The benchmark runs it only as the control of its comparison (see
`benchmark/control.py`): put in the program's place with TF32 products, the
precision step below the configuration's float32, it has to come out as not
correct.  Gradient plumbing and host-sync counters of the original are left
out; the arithmetic is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from benchmark.reference.linalg import ns_inverse, solve_kkt_schur


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """The port's shipped `QPSolverParams` values that `solve` reads."""

    iterations: int = 40
    cold_iterations: int = 200
    rho: float = 0.5
    rho_eq_scale: float = 1000.0
    sigma: float = 0.0
    alpha: float = 1.6
    scaling_iters: int = 4
    ns_iters: int = 30
    polish: bool = True
    polish_rounds: int = 2
    polish_reg: float = 1e-9
    polish_refine: int = 5
    rescue_threshold: float = 3e-3
    rescue_iterations: int = 40
    rescue_polish_rounds: int = 2
    rescue_stages: int = 3


def _host(t) -> bool:
    return bool(t)


def _host_nonzero(mask):
    return torch.nonzero(mask).flatten()


def _rescue_solver_params(params: SolverParams) -> SolverParams:
    return dataclasses.replace(params, iterations=params.rescue_iterations,
                               polish_rounds=params.rescue_polish_rounds,
                               rescue_threshold=0.0)


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


def _bound_finite(x):
    """A bound is "real" when |x| < 1e19 (the finite QP_INF = 1e20 convention)."""
    return torch.abs(x) < 1e19


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


def _polish(data: QPData, state: QPState, params: SolverParams, Hinv, banned=None,
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


def _polish_hinv(data: QPData, params: SolverParams):
    """The round-invariant dense polish H^-1: a cold Newton-Schulz inverse
    of H + reg I."""
    n = data.H.shape[-1]
    eye_n = torch.eye(n, dtype=data.H.dtype, device=data.H.device)
    return ns_inverse(data.H + params.polish_reg * eye_n, params.ns_iters)


def _rho_vec(data: QPData, params: SolverParams):
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


def solve(data: QPData, warm: QPState, params: SolverParams = SolverParams()):
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
        return best, QPInfo(pr_b, du_b, res_b, polished)
    return best, QPInfo(pr_b, du_b, res_b, polished)


