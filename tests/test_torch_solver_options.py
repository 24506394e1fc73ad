"""The solver options that ship off (`comp_final_refine`, `drop_fire_tol`,
`drop_warm_iters`, `drop_sinv_refresh`, `drop_ns_iters`, `cond_hoist`,
`drop_approx_rank`) on the port's kernel and torch backends, against the
JAX package on the same numpy inputs.

  * The generic batch: `tests/test_qp._poisoned_batch` (B = 8, n = 8,
    m = 12, dense H, so the dense polish's plain version runs), its warm
    duals of scenarios 2 and 6 poisoned so that round 1 solves a wrong
    active set and the drop round fires.  A cold step (warm mask all
    False), then a step under the mixed warm mask of
    `test_qp.py::test_cond_hoist_bitwise` from each side's own solution,
    poisoned again, the cache threaded on each side; against JAX
    `solve_batched(backend="pallas")` in interpret mode, `solve_layout=
    "major"`.  Every case takes `cold_batch` = 3, so the mixed step runs
    the compacted cold fix and the carried Schur inverse passes through
    for warm scenarios.  float64: x, y and the KKT residual within 1e-6
    absolute, the carried inverses (K^-1, H^-1, the Schur inverse) within
    1e-6, the polished flags exactly.  float32 as
    `tests/test_torch_generic_qp.py` holds it: relative KKT <= 1e-3 on
    both sides, x within 1e-3 of max(1, |x|) where both certify (relative
    KKT < 1e-5), 5e-2 elsewhere.
  * The JAX package's own checks of the options, on the port alone:
    `drop_fire_tol` = 1e9 is bitwise `polish_rounds` = 1; `cond_hoist`
    0, 1 and 2 are bitwise equal in every output and in the cache;
    `drop_warm_iters` = 8 is never worse than no drop round, scenario by
    scenario, in max(KKT, sign violation).
  * `_comp_refine_final` alone on the WBC's own QP (n = 42, m = 70, a
    recorded walking step, B = 4), with the compact and the dense H^-1:
    float64 within 1e-9 of max(1, |x|) (the residuals 1e-9 absolute),
    float32 within 1e-4 (the two sides' matvecs sum in different orders;
    the compensated residuals are exact to ~eps |r| on both).
  * The torch backend with `comp_final_refine` = 2 against JAX
    `backend="xla"` on `tests/test_torch_qp_solve.py`'s "mixed" inputs,
    float64, with and without `hinv_fn`, to that file's 1e-9; its
    gradient is bitwise the gradient with the option off (the merge is
    value only).
  * Three control steps across the walk's first contact switch with
    `comp_final_refine` = 2, `drop_sinv_refresh` = 1 and `drop_batch` = 2
    (at B = 4 the drop round is compacted only below 4) against JAX
    `wbc_step_batched(..., "pallas", setup_backend="xla")`, float64, tau
    within 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQPSolverParams
from quadrupedwholebodycontroller_tpu.control import wbc as jwbc
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.ops import qp as jqp
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import kernels, qp
from tests._torch_port_util import load_walk, make_offsets, scaled_err, step_arrays
from tests.test_qp import _poisoned_batch
from tests.test_torch_qp_solve import _problems, _warm

B, N, M = 8, 8, 12
REFRESH_FIRE_COMP = dict(drop_batch=3, drop_sinv_refresh=1, drop_fire_tol=1e-5,
                         comp_final_refine=2)
# the drop round's options do not reach the rescue: their float64 cases run
# without it, as the JAX package's tests of them do (it halves a JAX trace);
# the refinement's cases keep it (their first fire flag follows the merge)
NO_RESCUE = dict(rescue_threshold=0.0)
CASES = {
    "refresh_fire_comp": ("float64", REFRESH_FIRE_COMP),
    "warm_rank_hoist": ("float64", dict(drop_batch=3, drop_warm_iters=8, drop_approx_rank=1,
                                        cond_hoist=2, **NO_RESCUE)),
    "budget_hoist": ("float64", dict(drop_batch=3, drop_ns_iters=15, cond_hoist=1,
                                     **NO_RESCUE)),
    "fire_full": ("float64", dict(drop_batch=0, drop_fire_tol=1e-5, **NO_RESCUE)),
    "f32_refresh_fire_comp": ("float32", REFRESH_FIRE_COMP),
}
# per step: the warm mask (False = the scenario's cached inverses are cold)
MASKS = (np.zeros(B, bool), np.array([True, True, False, True, True, False, True, True]))
POISON = ((2, 5, 300.0), (6, 7, -250.0))


def _batch(dtype):
    data, _ = _poisoned_batch(np.random.default_rng(11), B, N, M, jnp.float64)
    npdt = np.float64 if dtype == "float64" else np.float32
    return {k: np.asarray(getattr(data, k)).astype(npdt) for k in jqp.QPData._fields}


def _poison_jax(st):
    y = st.y
    for b, i, v in POISON:
        y = y.at[b, i].set(v)
    return st._replace(y=y)


def _poison_torch(st):
    y = st.y.clone()
    for b, i, v in POISON:
        y[b, i] = v
    return st._replace(y=y)


def _run(name):
    torch.set_num_threads(1)
    dtype, over = CASES[name]
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    jq = JaxQPSolverParams(solve_layout="major", cold_batch=3, **over)
    tq = QPSolverParams(cold_batch=3, **over)
    jsolve = jax.jit(lambda d, w, c, uw: jqp.solve_batched(
        d, w, jq, backend="pallas", cache=c, use_warm=uw))
    data = _batch(dtype)
    jd = jqp.QPData(**{k: jnp.asarray(v) for k, v in data.items()})
    td = convert.qpdata_from_numpy(data, tdt, "cpu")
    jw = _poison_jax(jqp.QPState(x=jnp.zeros((B, N), jdt), z=jnp.zeros((B, M), jdt),
                                 y=jnp.zeros((B, M), jdt)))
    tw = _poison_torch(qp.QPState.zeros(B, N, M, tdt, "cpu"))
    jc = jqp.make_cache(B, N, M, jq, jdt)
    tc = qp.make_cache(B, N, M, tq, tdt, "cpu")
    kernels.reset_counts()
    rows = []
    for mask in MASKS:
        jst, jinf, jc = jsolve(jd, jw, jc, jnp.asarray(mask))
        tst, tinf, tc = qp.solve_batched(td, tw, tq, cache=tc, use_warm=torch.as_tensor(mask))
        rows.append((jax.tree.map(np.asarray, (jst, jinf, jc)),
                     convert.to_numpy((tst, tinf, tc))))
        jw, tw = _poison_jax(jst), _poison_torch(tst)
    return dict(rows=rows, plain=kernels.plain_counts(), launches=kernels.launch_counts())


@pytest.fixture(scope="module")
def results():
    return {}


def _case(results, name):
    if name not in results:
        results[name] = _run(name)
    return results[name]


def _d(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("name", [k for k, v in CASES.items() if v[0] == "float64"])
def test_float64_options_match_jax(results, name):
    r = _case(results, name)
    for step, ((jst, jinf, jc), (tst, tinf, tc)) in enumerate(r["rows"]):
        assert _d(jst.x, tst.x) <= 1e-6, (step, _d(jst.x, tst.x))
        assert _d(jst.y, tst.y) <= 1e-6, (step, _d(jst.y, tst.y))
        assert _d(jinf.kkt_residual, tinf.kkt_residual) <= 1e-6, step
        assert np.array_equal(jinf.polished, tinf.polished), step
        for f in ("kinv", "hinv", "sinv"):
            assert _d(getattr(jc, f), getattr(tc, f)) <= 1e-6, (step, f)
    # only plain versions ran, the dense polish among them
    assert not any(r["launches"].values())
    assert r["plain"]["polish_solve_dense"] > 0 and r["plain"]["polish_solve_compact"] == 0


def test_float32_options_match_jax(results):
    r = _case(results, "f32_refresh_fire_comp")
    for step, ((jst, jinf, _), (tst, tinf, _)) in enumerate(r["rows"]):
        jk, tk = jinf.kkt_residual, tinf.kkt_residual
        assert jk.max() <= 1e-3 and tk.max() <= 1e-3, (step, jk.max(), tk.max())
        err = np.abs(jst.x.astype(np.float64) - tst.x.astype(np.float64)).max(axis=1)
        scale = np.maximum(1.0, np.abs(jst.x).max(axis=1))
        cert = (jk < 1e-5) & (tk < 1e-5)
        assert (err[cert] <= 1e-3 * scale[cert]).all(), (step, err)
        assert (err <= 5e-2 * scale).all(), (step, err)
        assert cert.any(), step


def test_sinv_refresh_moves_the_carried_inverse(results):
    """The refresh case's carried Schur inverse (held to JAX's above) is
    not the one a run without the refresh carries: on the mixed step the
    drop round fired (on the cold step the fire bar holds it back) and its
    fresh inverses went into the cache, on those rows only.  The final
    refinement preconditions with them, so the mixed step's solution moves
    by rounding only."""
    r = _case(results, "refresh_fire_comp")
    data = convert.qpdata_from_numpy(_batch("float64"), torch.float64, "cpu")
    p = QPSolverParams(cold_batch=3, **dict(REFRESH_FIRE_COMP, drop_sinv_refresh=0))
    c = qp.make_cache(B, N, M, p, torch.float64, "cpu")
    w = _poison_torch(qp.QPState.zeros(B, N, M, torch.float64, "cpu"))
    for step, mask in enumerate(MASKS):
        st, _, c = qp.solve_batched(data, w, p, cache=c, use_warm=torch.as_tensor(mask))
        w = _poison_torch(st)
        refreshed = r["rows"][step][1]
        assert _d(st.x, refreshed[0].x) <= (0.0, 1e-6)[step]
        moved = np.abs(refreshed[2].sinv - c.sinv.numpy()).max(axis=(1, 2)) > 1e-6
        assert moved.sum() == (0, 2)[step], (step, moved)


# ---------------------------------------------------------------------------
# the JAX package's own checks of the options (tests/test_qp.py), on the port
# ---------------------------------------------------------------------------

def _f32_batch(seed):
    data, warm = _poisoned_batch(np.random.default_rng(seed), B, N, M, jnp.float32)
    return (qp.QPData(*(torch.as_tensor(np.array(a)) for a in data)),
            qp.QPState(*(torch.as_tensor(np.array(a)) for a in warm)))


def _port_solve(data, warm, p, masks=(False,)):
    """Steps of the f32 batch, each warm from the last, the cache threaded:
    a list of (state, info, cache)."""
    cache = qp.make_cache(B, N, M, p, torch.float32, "cpu")
    outs = []
    for use_warm in masks:
        st, info, cache = qp.solve_batched(data, warm, p, cache=cache, use_warm=use_warm)
        outs.append((st, info, cache))
        warm = st
    return outs


def test_drop_fire_tol_semantics():
    """(a) the poisoned scenarios cross a meaningful bar and come out
    sign-clean, as without the bar; (b) an unreachable bar is bitwise
    `polish_rounds` = 1."""
    data, warm = _f32_batch(5)
    base = QPSolverParams(rescue_threshold=0.0, drop_batch=3)
    run = lambda **kw: _port_solve(data, warm, dataclasses.replace(base, **kw))[0]
    st0, _, _ = run()
    st1, _, _ = run(drop_fire_tol=1e-5)
    assert float(qp._sign_violation(data, st1.x, st1.y).max()) < 1e-4
    assert float((st1.x - st0.x).abs().max()) <= 1e-5
    st2, inf2, _ = run(drop_fire_tol=1e9)
    st3, inf3, _ = run(polish_rounds=1)
    assert torch.equal(st2.x, st3.x) and torch.equal(inf2.kkt_residual, inf3.kkt_residual)


def test_cond_hoist_bitwise():
    """Every output and the cache, over a cold step and a mixed warm step,
    bitwise the same for cond_hoist 0, 1 and 2."""
    data, warm = _f32_batch(6)
    uw = torch.as_tensor(MASKS[1])
    outs = {}
    for ch in (0, 1, 2):
        p = QPSolverParams(rescue_threshold=0.0, drop_batch=3, cold_batch=3, cond_hoist=ch)
        outs[ch] = _port_solve(data, warm, p, masks=(False, uw))
    flat = lambda o: [t for step in o for part in step for t in part]
    for ch in (1, 2):
        for a, b in zip(flat(outs[0]), flat(outs[ch])):
            assert torch.equal(a, b)


def test_drop_warm_iters_is_guarded_not_equivalent():
    """The cold drop round fixes the poisoned scenarios; the warm one is,
    scenario by scenario, never worse than no drop round in
    max(KKT, sign violation) (acceptance is monotone)."""
    data, warm = _f32_batch(1234)
    base = dict(rescue_threshold=0.0, drop_batch=3)
    (st_c, _, _), = _port_solve(data, warm, QPSolverParams(**base))
    (st_w, inf_w, _), = _port_solve(data, warm, QPSolverParams(**base, drop_warm_iters=8))
    (st_1, inf_1, _), = _port_solve(data, warm, QPSolverParams(**base, polish_rounds=1))
    assert float(qp._sign_violation(data, st_c.x, st_c.y).max()) < 1e-4
    aug_w = torch.maximum(inf_w.kkt_residual, qp._sign_violation(data, st_w.x, st_w.y))
    aug_1 = torch.maximum(inf_1.kkt_residual, qp._sign_violation(data, st_1.x, st_1.y))
    assert (aug_w <= aug_1 * (1 + 1e-6) + 1e-7).all(), (aug_w, aug_1)


# ---------------------------------------------------------------------------
# _comp_refine_final on the WBC's own QP
# ---------------------------------------------------------------------------

WBC_B = 4


@pytest.fixture(scope="module")
def wbc_refine_inputs():
    """A recorded walking step's QPs (float64, B = 4), a perturbed solution
    of them, the WBC's closed-form polish H^-1 and the Schur inverse the
    solve carried, all as numpy."""
    traj = load_walk()
    obs, ref, new = step_arrays(traj, 41, WBC_B, make_offsets(np.random.default_rng(3), WBC_B))
    dt = torch.float64
    setup = wbc.wbc_setup(anymal_d_model(dt, "cpu"), ControllerParams(),
                          convert.obs_from_numpy(obs, dt, "cpu"),
                          convert.ref_from_numpy(ref, dt, "cpu"),
                          wbc.init_carry(WBC_B, dt, "cpu"),
                          torch.full((WBC_B,), new))
    data = setup.qp_data
    p = QPSolverParams()
    cache = qp.make_cache(WBC_B, 42, 70, p, dt, "cpu")
    st, _, cache = qp.solve_batched(data, qp.QPState.zeros(WBC_B, 42, 70, dt, "cpu"), p,
                                    cache=cache, use_warm=False, hinv_fn=wbc._wbc_polish_hinv)
    rng = np.random.default_rng(4)
    state = convert.to_numpy(st)
    state = type(state)(x=state.x * (1 + 1e-4 * rng.standard_normal(state.x.shape)),
                        z=state.z, y=state.y * (1 + 1e-4 * rng.standard_normal(state.y.shape)))
    hinv = convert.to_numpy(wbc._wbc_polish_hinv(data.H, p.polish_reg)[:2])
    return convert.to_numpy(data), state, hinv, cache.sinv.numpy()


@pytest.mark.parametrize("dtype,form", [(d, f) for d in ("float64", "float32")
                                        for f in ("compact", "dense")])
def test_comp_refine_final_matches_jax(wbc_refine_inputs, dtype, form):
    data, state, (diag, blk), sinv = wbc_refine_inputs
    npdt = np.float64 if dtype == "float64" else np.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    cast = lambda a: np.asarray(a).astype(npdt)
    p = QPSolverParams(comp_final_refine=2)
    jp = JaxQPSolverParams(comp_final_refine=2)
    if form == "compact":
        jH = (jnp.asarray(cast(diag)), jnp.asarray(cast(blk)))
        tH = (torch.as_tensor(cast(diag)), torch.as_tensor(cast(blk)), 18)
        jref = jax.jit(lambda d, s, h, si: jqp._comp_refine_final(d, s, jp, h + (18,), si))
    else:
        dense = qp._blockdiag_dense(tuple(torch.as_tensor(cast(a)) for a in (diag, blk))
                                    + (18,))
        jH, tH = jnp.asarray(dense.numpy()), dense
        jref = jax.jit(lambda d, s, h, si: jqp._comp_refine_final(d, s, jp, h, si))
    jst, jpr, jdu = jref(
        jqp.QPData(*(jnp.asarray(cast(a)) for a in data)),
        jqp.QPState(*(jnp.asarray(cast(a)) for a in state)), jH, jnp.asarray(cast(sinv)))
    tst, tpr, tdu = qp._comp_refine_final(
        qp.QPData(*(torch.as_tensor(cast(a)) for a in data)),
        qp.QPState(*(torch.as_tensor(cast(a)) for a in state)), p, tH,
        torch.as_tensor(cast(sinv)))
    assert tst.x.dtype == tdt
    tol = 1e-9 if dtype == "float64" else 1e-4
    for name, got, want in zip("xzy", tst, jst):
        assert scaled_err(got.numpy(), np.asarray(want)) <= tol, (name, form)
    assert _d(tpr, jpr) <= tol and _d(tdu, jdu) <= tol
    # the refinement did work: the perturbed iterate's residual falls
    pr0, du0 = qp.kkt_residual(qp.QPData(*(torch.as_tensor(cast(a)) for a in data)),
                               torch.as_tensor(cast(state.x)), torch.as_tensor(cast(state.y)))
    assert (torch.maximum(tpr, tdu) < torch.maximum(pr0, du0)).all()


# ---------------------------------------------------------------------------
# the torch backend
# ---------------------------------------------------------------------------

TB, TN = 6, 8    # the "mixed" inputs: scenarios, variables


def _mixed():
    data = _problems()
    return data, _warm("mixed", data)


def _hinv_torch(H, reg):
    inv = torch.linalg.inv(H + reg * torch.eye(H.shape[-1], dtype=H.dtype))
    return torch.zeros(H.shape[:2], dtype=H.dtype), inv, 0


def _hinv_jax(H, reg):
    inv = jnp.linalg.inv(H + reg * jnp.eye(H.shape[-1], dtype=H.dtype))
    return jnp.zeros(H.shape[:2], H.dtype), inv, 0


@pytest.mark.parametrize("with_hinv", [False, True])
def test_torch_backend_comp_final_refine_matches_jax(with_hinv):
    data, warm = _mixed()
    p = QPSolverParams(comp_final_refine=2)
    jp = JaxQPSolverParams(comp_final_refine=2)
    st, info = qp.solve_batched(qp.QPData(*(torch.as_tensor(a) for a in data)),
                                qp.QPState(*(torch.as_tensor(a) for a in warm)), p, "torch",
                                hinv_fn=_hinv_torch if with_hinv else None)
    jst, jinfo = jax.jit(lambda d, w: jqp.solve_batched(
        d, w, jp, "xla", hinv_fn=_hinv_jax if with_hinv else None))(
        jqp.QPData(*(jnp.asarray(a) for a in data)), jqp.QPState(*(jnp.asarray(a) for a in warm)))
    for name, got, want in zip("xzy", st, jst):
        assert scaled_err(got.numpy(), np.asarray(want)) <= 1e-9, name
    for got, want in zip(info[:3], jinfo[:3]):
        assert _d(got.numpy(), want) <= 1e-9
    assert np.array_equal(info.polished.numpy(), np.asarray(jinfo.polished))


def test_torch_backend_gradient_ignores_comp_final_refine():
    """The final refinement is merged value only: the gradient of a linear
    function of the solution is bitwise that with the option off, while
    the values move."""
    data, warm = _mixed()
    w = torch.as_tensor(np.random.default_rng(9).standard_normal((TB, TN)))
    grads, xs = [], []
    for passes in (0, 2):
        g = torch.as_tensor(data[1]).requires_grad_()
        d = qp.QPData(torch.as_tensor(data[0]), g, *(torch.as_tensor(a) for a in data[2:]))
        st, _ = qp.solve_batched(d, qp.QPState(*(torch.as_tensor(a) for a in warm)),
                                 QPSolverParams(comp_final_refine=passes), "torch")
        grads.append(torch.autograd.grad((w * st.x).sum(), g)[0])
        xs.append(st.x.detach())
    assert torch.equal(grads[0], grads[1])
    assert not torch.equal(xs[0], xs[1])


# ---------------------------------------------------------------------------
# the control step
# ---------------------------------------------------------------------------

STEP_B, STEPS = 4, (39, 40, 41)


def test_control_step_with_options_matches_jax():
    torch.set_num_threads(1)
    traj = load_walk()
    offsets = make_offsets(np.random.default_rng(44), STEP_B)
    over = dict(comp_final_refine=2, drop_sinv_refresh=1, drop_batch=2)
    jm, jcp = jax_model(dtype=jnp.float64), JaxControllerParams()
    jq = JaxQPSolverParams(solve_layout="major", **over)
    jstep = jax.jit(lambda o, r, c, new, cache, valid: jwbc.wbc_step_batched(
        jm, jcp, jq, o, r, c, new, "pallas", cache, valid, setup_backend="xla"))
    tm, tcp, tq = anymal_d_model(torch.float64, "cpu"), ControllerParams(), QPSolverParams(**over)
    jc = jax.tree.map(lambda x: jnp.stack([x] * STEP_B), jwbc.init_carry(jnp.float64))
    jcache = jqp.make_cache(STEP_B, 42, 70, jq, jnp.float64)
    tc = wbc.init_carry(STEP_B, torch.float64, "cpu")
    tcache = qp.make_cache(STEP_B, 42, 70, tq, torch.float64, "cpu")
    twin_q = dataclasses.replace(tq, drop_sinv_refresh=0)
    nc, ncache, moved = tc, tcache, []
    kernels.reset_counts()
    valid = False
    for t in STEPS:
        obs, ref, new = step_arrays(traj, t, STEP_B, offsets)
        mask = np.full((STEP_B,), new)
        jo = jwbc.RobotObservation(**{k: jnp.asarray(v) for k, v in obs.items()})
        jr = jwbc.Reference(**{k: jnp.asarray(v) for k, v in ref.items()})
        jout, jc, jcache = jstep(jo, jr, jc, jnp.asarray(mask), jcache, valid)
        tout, tc, tcache = wbc.wbc_step_batched(
            tm, tcp, tq, convert.obs_from_numpy(obs, torch.float64, "cpu"),
            convert.ref_from_numpy(ref, torch.float64, "cpu"), tc, torch.as_tensor(mask),
            "kernel", tcache, valid)
        valid = True
        assert _d(jout.tau, tout.tau) <= 1e-6, (t, _d(jout.tau, tout.tau))
        assert _d(jout.qp_x, tout.qp_x) <= 1e-6, t
        assert np.array_equal(np.asarray(jout.qp_info.polished), tout.qp_info.polished.numpy())
        assert scaled_err(tcache.sinv.numpy(), np.asarray(jcache.sinv)) <= 1e-8, t
        # a twin run without the refresh, to show that it acted
        _, nc, ncache = wbc.wbc_step_batched(
            tm, tcp, twin_q, convert.obs_from_numpy(obs, torch.float64, "cpu"),
            convert.ref_from_numpy(ref, torch.float64, "cpu"), nc, torch.as_tensor(mask),
            "kernel", ncache, t != STEPS[0])
        moved.append(not torch.equal(ncache.sinv, tcache.sinv))
    # the drop round fired on a new active set and refreshed the carried
    # inverse (on the cold first step round 2 may re-solve round 1's set)
    assert any(moved), moved
    plain = kernels.plain_counts()
    assert plain["polish_solve_compact"] > 0 and plain["polish_solve_dense"] == 0
