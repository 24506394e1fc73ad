"""The single-sample solver path of the port, the "torch" backend, against
the JAX package's "xla" backend on the same problems:

  * `ops.qp.solve` on a batch against `jax.vmap(qp.solve)`, scenario by
    scenario (its single-sample rescue included);
  * `ops.qp.solve_batched(backend="torch")` against the JAX package's
    `solve_batched(backend="xla")` (the batch-level `_rescue_batched`);
  * `_ruiz_equilibrate` against the JAX function under `vmap`.

Seeded random QPs made with numpy, B = 6, n = 8, m = 12: two equality rows,
one row with both bounds at the QP_INF convention (1e20) and two one-sided
rows, as `tests/test_qp.py` builds them plus the infinite bounds.  Cold and
warm starts in one batch, the starved case of `tests/test_qp.py` in which
each rescue fires, and a case that enters the batch-level rescue with its
compensated candidate, at sigma > 0.  float64, x, y and z to 1e-9 of
max(1, max |JAX value|), the relative KKT residuals to 1e-9 absolute.
Each JAX trace runs once a module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQPSolverParams
from quadrupedwholebodycontroller_tpu.ops import qp as jqp
from quadrupedwholebodycontroller_tpu_torch.config import QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.ops import kernels, qp

B, N, M = 6, 8, 12
TOL = 1e-9
# the cases: solver parameters, the warm start, and the functions compared
STARVED = dict(iterations=3, cold_iterations=3, polish=False)
CASES = {
    # shipped parameters; scenarios 0-2 start cold, 3-5 warm
    "mixed": (dict(), "mixed", ("solve", "solve_batched")),
    # a starved ADMM without polish: each rescue re-solves with its budget
    "starved_rescue": (dict(STARVED, rescue_threshold=1e-3, rescue_iterations=150), "cold",
                       ("solve", "solve_batched")),
    # sigma > 0 and inexact inverses (12 Newton-Schulz iterations) with an
    # unrefined polish: the batch-level rescue fires, and its compensated
    # candidate (two refinement passes) is what brings scenarios 2 and 4
    # under the threshold
    "tight_rescue": (dict(sigma=1e-6, ns_iters=12, polish_refine=0, rescue_threshold=1e-6,
                          rescue_stages=2), "warm", ("solve_batched",)),
}
_JAX, _PORT = {}, {}


def _problems(seed=0):
    rng = np.random.default_rng(seed)
    H, g, A, l, u = [], [], [], [], []
    for _ in range(B):
        L = rng.normal(size=(N, N))
        A_ = rng.normal(size=(M, N))
        ax = A_ @ (0.3 * rng.normal(size=N))
        lo = ax - rng.uniform(0.1, 1.0, size=M)
        up = ax + rng.uniform(0.1, 1.0, size=M)
        lo[:2] = up[:2] = ax[:2]                  # equality rows
        lo[2], up[2] = -1e20, 1e20                # a free row
        lo[3] = -1e20                             # one-sided rows
        up[4] = 1e20
        H.append(L @ L.T + N * np.eye(N))
        g.append(rng.normal(size=N))
        A.append(A_)
        l.append(lo)
        u.append(up)
    return tuple(np.stack(a) for a in (H, g, A, l, u))


def _warm(kind, data):
    """All-zero ("cold"), a nearby point ("warm": the 400 Hz carry), or
    the first half cold and the second warm ("mixed")."""
    rng = np.random.default_rng(1)
    x = 0.3 * rng.normal(size=(B, N))
    z = np.clip(np.einsum("bij,bj->bi", data[2], x), data[3], data[4])
    warm = (x, z, 0.1 * rng.normal(size=(B, M)))
    if kind == "warm":
        return warm
    n_cold = B if kind == "cold" else B // 2
    for a in warm:
        a[:n_cold] = 0.0
    return warm


def _inputs(case):
    data = _problems()
    return data, _warm(CASES[case][1], data)


def _jax_run(case, fn):
    key = (case, fn)
    if key not in _JAX:
        data, warm = _inputs(case)
        p = JaxQPSolverParams(**CASES[case][0])
        d = jqp.QPData(*(jnp.asarray(a) for a in data))
        w = jqp.QPState(*(jnp.asarray(a) for a in warm))
        if fn == "solve":
            st, info = jax.jit(jax.vmap(lambda dd, ww: jqp.solve(dd, ww, p)))(d, w)
        else:
            st, info = jax.jit(lambda dd, ww: jqp.solve_batched(dd, ww, p, "xla"))(d, w)
        _JAX[key] = jax.tree.map(np.asarray, (st, info))
    return _JAX[key]


def _port_run(case, fn, **kw):
    key = (case, fn, tuple(sorted(kw)))
    if key not in _PORT:
        data, warm = _inputs(case)
        p = QPSolverParams(**CASES[case][0])
        d = qp.QPData(*(torch.as_tensor(a) for a in data))
        w = qp.QPState(*(torch.as_tensor(a) for a in warm))
        kernels.reset_counts()
        qp.HOST_SYNCS = 0
        if fn == "solve":
            out = qp.solve(d, w, p)
        else:
            out = qp.solve_batched(d, w, p, "torch", **kw)
        _PORT[key] = (tuple(tuple(t.numpy() for t in o) for o in out[:2]),
                      qp.HOST_SYNCS, kernels.launch_counts(), kernels.plain_counts(), out)
    return _PORT[key]


def _share(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("case,fn", [(c, f) for c, v in CASES.items() for f in v[2]])
def test_matches_jax(case, fn):
    (st, info), _, launches, plain, _ = _port_run(case, fn)
    jst, jinfo = _jax_run(case, fn)
    for name, got, want in zip("xzy", st, jst):
        assert _share(got, want) <= TOL, (name, _share(got, want))
    for name, got, want in zip(("primal", "dual", "kkt"), info[:3], jinfo[:3]):
        assert np.abs(got - want).max() <= TOL, (name, got, want)
    assert (info[3] == jinfo[3]).all()
    # tensor code only: no kernel and no kernel's plain version ran
    assert not any(launches.values()) and not any(plain.values())


def test_each_rescue_fires_and_helps():
    """Guards the cases: without its rescue the starved solve leaves every
    scenario above the threshold, and the single-sample rescue of `solve`
    and the batch-level one both bring them under it (a rescue that does
    not fire reads the host once; the mixed case's cold start once more);
    in the tight case the batch-level rescue cuts two scenarios' residuals
    tenfold or more and brings one under its threshold (its compensated
    candidate does it: without it none moves); the mixed case holds cold
    and warm scenarios, and certifies without a rescue."""
    def rescue_off(case):
        data, warm = _inputs(case)
        p = QPSolverParams(**dict(CASES[case][0], rescue_threshold=0.0))
        _, info = qp.solve(qp.QPData(*(torch.as_tensor(a) for a in data)),
                           qp.QPState(*(torch.as_tensor(a) for a in warm)), p)
        return info.kkt_residual.numpy()

    off = rescue_off("starved_rescue")
    assert (off > 1e-3).all()
    for fn in ("solve", "solve_batched"):
        (_, on), syncs, *_ = _port_run("starved_rescue", fn)
        assert (on[2] < 1e-3).all() and (on[2] <= off).all()
        assert syncs >= 2, (fn, syncs)
    off = rescue_off("tight_rescue")
    (_, tight), syncs, *_ = _port_run("tight_rescue", "solve_batched")
    assert ((off > 1e-6) & (tight[2] < 1e-6)).any() and syncs >= 2, (off, tight[2])
    assert (tight[2] < 0.1 * off).sum() >= 2, (off, tight[2])
    (_, mixed), syncs, *_ = _port_run("mixed", "solve")
    assert (mixed[2] < 1e-6).all() and syncs == 2, syncs
    assert not _inputs("mixed")[1][0][:B // 2].any() and _inputs("mixed")[1][0][B // 2:].all()


def test_hinv_fn_feeds_the_compensated_candidate_and_the_cache_passes_through():
    """With `hinv_fn` the rescue's compensated candidates use its H^-1 (a
    compact form covering the whole H here); with a cache the torch backend
    returns it as it came."""
    data, warm = _inputs("tight_rescue")
    p = QPSolverParams(**CASES["tight_rescue"][0])

    def hinv_fn(H, reg):
        inv = torch.linalg.inv(H + reg * torch.eye(H.shape[-1], dtype=H.dtype))
        return torch.zeros(H.shape[:2], dtype=H.dtype), inv, 0

    d = qp.QPData(*(torch.as_tensor(a) for a in data))
    w = qp.QPState(*(torch.as_tensor(a) for a in warm))
    cache = qp.make_cache(B, N, M, p, torch.float64, "cpu")
    st, info, back = qp.solve_batched(d, w, p, "torch", cache=cache, hinv_fn=hinv_fn)
    assert back is cache
    jp = JaxQPSolverParams(**CASES["tight_rescue"][0])

    def jhinv_fn(H, reg):
        inv = jnp.linalg.inv(H + reg * jnp.eye(H.shape[-1], dtype=H.dtype))
        return jnp.zeros(H.shape[:2], H.dtype), inv, 0

    jst, jinfo = jax.jit(lambda dd, ww: jqp.solve_batched(dd, ww, jp, "xla", hinv_fn=jhinv_fn))(
        jqp.QPData(*(jnp.asarray(a) for a in data)), jqp.QPState(*(jnp.asarray(a) for a in warm)))
    assert _share(st.x.numpy(), np.asarray(jst.x)) <= TOL
    assert np.abs(info.kkt_residual.numpy() - np.asarray(jinfo.kkt_residual)).max() <= TOL


def test_ruiz_equilibrate_matches_jax():
    data = _problems(3)
    d, e = qp._ruiz_equilibrate(qp.QPData(*(torch.as_tensor(a) for a in data)), 4)
    jd, je = jax.vmap(lambda dd: jqp._ruiz_equilibrate(dd, 4))(
        jqp.QPData(*(jnp.asarray(a) for a in data)))
    assert np.abs(d.numpy() / np.asarray(jd) - 1.0).max() <= 1e-12
    assert np.abs(e.numpy() / np.asarray(je) - 1.0).max() <= 1e-12


def test_options_of_the_torch_backend():
    """`comp_final_refine` runs (the JAX xla path reads it): a scenario
    whose compensated candidate is not accepted keeps the result of the
    run without it bit for bit, an accepted one takes the candidate; the
    kernel-only knobs are not read; an unknown backend is a ValueError."""
    data, warm = _inputs("mixed")
    d = qp.QPData(*(torch.as_tensor(a) for a in data))
    w = qp.QPState(*(torch.as_tensor(a) for a in warm))
    base = qp.solve_batched(d, w, QPSolverParams(), "torch")
    refined = qp.solve_batched(d, w, QPSolverParams(comp_final_refine=1), "torch")
    cand, pr_c, du_c = qp._polish_comp(d, base[0], QPSolverParams(), passes=1)
    res_c = torch.maximum(pr_c, du_c)
    ok = torch.maximum(res_c, qp._sign_violation(d, cand.x, cand.y)) <= torch.maximum(
        base[1].kkt_residual, qp._sign_violation(d, base[0].x, base[0].y))
    assert ok.any() and not ok.all(), ok
    for got, kept, new in zip(refined[0], base[0], cand):
        assert torch.equal(got[~ok], kept[~ok])
        assert torch.equal(got[ok], new[ok])
    assert torch.equal(refined[1].kkt_residual[~ok], base[1].kkt_residual[~ok])
    knobs = qp.solve_batched(d, w, dataclasses.replace(
        QPSolverParams(), drop_warm_iters=4, cond_hoist=1, drop_batch=1), "torch")
    assert torch.equal(base[0].x, knobs[0].x)
    with pytest.raises(ValueError, match="backend"):
        qp.solve_batched(d, w, QPSolverParams(), "xla")
