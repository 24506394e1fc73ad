"""The generic batched QP path of the port against the JAX package's
`solve_batched(backend="pallas")` (Pallas kernels in interpret mode on the
CPU), on the same numpy inputs.

QPs: `tests/test_qp.random_qp` batches, B = 8, n = 8, m = 12 (two equality
rows each, dense SPD H), with the warm duals of scenarios 2 and 6 poisoned
(the batch of `test_qp.py::test_compact_drop_round_matches_full`) so that
round 1 of the polish solves a wrong active set and the drop round fires.
Every case runs a short sequence, the state and cache threaded on each
side independently: a cold first solve, then warm solves of the same
problems with g perturbed, under a per-scenario warm mask.  No caller
supplies `hinv_fn`, so the polish runs with a dense H and H^-1 (kernel K7
on the card) and, with a cache, the dense H^-1 is carried in it.

Cases, one JAX trace each (a trace takes about 10 s, so knobs share cases):
  * `cache_sigma0`: the defaults (sigma = 0, constraint-space ADMM K1);
  * `compact_sigma_wi1`: sigma = 1e-6 (x-space ADMM K5),
    `ns_warm_iters_polish = 1` (H^-1 and the Schur inverse warm-iterated)
    and the caps shrunk (cold_batch = 2, drop_batch = 2, rescue_batch = 2,
    rescue_round2_batch = 1, rescue_threshold = 1e-9), so the compacted cold
    fix (one cold scenario), the full cold fallback (three), the compacted
    drop round over dense H and the compacted rescue with its compacted
    round 2 all run;
  * `nocache`: no cache (cold inverses, the plain Schur polish `_polish`);
  * `polish_off`: `polish = False` (the rescue runs its ADMM only);
  * `f32_cache_sigma`: float32, sigma = 1e-6.

Tolerances: float64 x, y and the KKT residual to 1e-6 absolute (the two
sides run the same algorithm and differ by summation order: measured
about 1e-12); the polished flags exactly; a carried cache's inverses to
1e-6.  float32: relative KKT <= 1e-3 on both sides, and x within 1e-3 of
max(1, |x|) wherever both sides certify (relative KKT < 1e-5), 5e-2
elsewhere, as for the control step (an uncertified float32 iterate keeps
the ADMM's accuracy).

The control step with `QPSolverParams(sigma=1e-6)` runs four cycles against
JAX `wbc_step_batched(..., "pallas", setup_backend="xla")`, float64, tau to
1e-6.  The port's step without a cache returns (out, carry), keeps the
relative KKT under the rescue threshold and gives the cached step's torques
to 1e-6 wherever both certify to 1e-8."""
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
from tests._torch_port_util import load_walk, make_offsets, step_arrays
from tests.test_qp import random_qp

B, N, M = 8, 8, 12
COMPACT = dict(cold_batch=2, drop_batch=2, rescue_batch=2, rescue_round2_batch=1,
               rescue_threshold=1e-9)
CASES = {
    "cache_sigma0": ("float64", {}, True),
    "compact_sigma_wi1": ("float64", dict(sigma=1e-6, ns_warm_iters_polish=1, **COMPACT),
                          True),
    "nocache": ("float64", {}, False),
    "polish_off": ("float64", dict(polish=False), True),
    "f32_cache_sigma": ("float32", dict(sigma=1e-6), True),
}
# per step: the warm mask (False = the scenario's cached inverses are cold)
MASKS = (np.zeros(B, bool), np.arange(B) != 3, ~np.isin(np.arange(B), (1, 4, 5)))


def _batch():
    rng = np.random.default_rng(7)
    qps = [random_qp(rng, n=N, m=M, n_eq=2) for _ in range(B)]
    data = {k: np.stack([np.asarray(getattr(d, k)) for d in qps]) for k in jqp.QPData._fields}
    warm = {"x": np.zeros((B, N)), "z": np.zeros((B, M)), "y": np.zeros((B, M))}
    warm["y"][2, 5], warm["y"][6, 7] = 300.0, -250.0
    dg = [0.01 * rng.standard_normal((B, N)) for _ in MASKS]
    return data, warm, dg


def _run(name):
    torch.set_num_threads(1)
    dtype, over, with_cache = CASES[name]
    npdt = np.float64 if dtype == "float64" else np.float32
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    jq = JaxQPSolverParams(solve_layout="major", **over)
    tq = QPSolverParams(**over)
    if with_cache:
        jsolve = jax.jit(lambda d, w, c, uw: jqp.solve_batched(
            d, w, jq, backend="pallas", cache=c, use_warm=uw))
    else:
        jsolve = jax.jit(lambda d, w: jqp.solve_batched(d, w, jq, backend="pallas"))
    data, warm, dg = _batch()
    jw = jqp.QPState(**{k: jnp.asarray(v, jdt) for k, v in warm.items()})
    tw = convert.qpstate_from_numpy(warm, tdt, "cpu")
    jc = jqp.make_cache(B, N, M, jq, jdt)
    tc = qp.make_cache(B, N, M, tq, tdt, "cpu")
    hinv0 = tc.hinv
    kernels.reset_counts()
    rows = []
    for step, (mask, dgs) in enumerate(zip(MASKS, dg)):
        d = dict(data, g=data["g"] + (dgs if step else 0.0))
        jd = jqp.QPData(**{k: jnp.asarray(np.asarray(v, npdt)) for k, v in d.items()})
        td = convert.qpdata_from_numpy(d, tdt, "cpu")
        if with_cache:
            jst, jinf, jc = jsolve(jd, jw, jc, jnp.asarray(mask))
            tst, tinf, tc = qp.solve_batched(td, tw, tq, cache=tc, use_warm=torch.as_tensor(mask))
        else:
            jst, jinf = jsolve(jd, jw)
            out = qp.solve_batched(td, tw, tq)
            assert len(out) == 2
            tst, tinf = out
        rows.append((jax.tree.map(np.asarray, (jst, jinf)), convert.to_numpy((tst, tinf))))
        jw, tw = jst, tst
    final = (jax.tree.map(np.asarray, jc), convert.to_numpy(tc)) if with_cache else None
    return dict(rows=rows, final=final, dtype=dtype, plain=kernels.plain_counts(),
                launches=kernels.launch_counts(), hinv_moved=bool(
                    with_cache and not torch.equal(tc.hinv, hinv0)))


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
def test_float64_solve_matches_jax(results, name):
    r = _case(results, name)
    for step, ((jst, jinf), (tst, tinf)) in enumerate(r["rows"]):
        assert _d(jst.x, tst.x) <= 1e-6, (step, _d(jst.x, tst.x))
        assert _d(jst.y, tst.y) <= 1e-6, (step, _d(jst.y, tst.y))
        assert _d(jst.z, tst.z) <= 1e-6, step
        assert _d(jinf.kkt_residual, tinf.kkt_residual) <= 1e-6, step
        assert np.array_equal(jinf.polished, tinf.polished), step
        assert tinf.kkt_residual.max() <= 1e-6, (step, tinf.kkt_residual)
    if r["final"] is not None:
        jc, tc = r["final"]
        for f in ("kinv", "hinv", "sinv"):
            assert _d(getattr(jc, f), getattr(tc, f)) <= 1e-6, f


def test_float32_solve_matches_jax(results):
    r = _case(results, "f32_cache_sigma")
    for step, ((jst, jinf), (tst, tinf)) in enumerate(r["rows"]):
        jk, tk = jinf.kkt_residual, tinf.kkt_residual
        assert jk.max() <= 1e-3 and tk.max() <= 1e-3, (step, jk.max(), tk.max())
        err = np.abs(jst.x.astype(np.float64) - tst.x.astype(np.float64)).max(axis=1)
        scale = np.maximum(1.0, np.abs(jst.x).max(axis=1))
        cert = (jk < 1e-5) & (tk < 1e-5)
        assert (err[cert] <= 1e-3 * scale[cert]).all(), (step, err)
        assert (err <= 5e-2 * scale).all(), (step, err)
        assert cert.any(), step


@pytest.mark.parametrize("name", list(CASES))
def test_each_case_runs_its_kernels_plain_versions(results, name):
    """On CPU tensors only plain versions run; which ones names the path."""
    r = _case(results, name)
    dtype, over, with_cache = CASES[name]
    plain = r["plain"]
    assert not any(r["launches"].values())
    sigma = over.get("sigma", 0.0)
    assert (plain["admm_iterations_res"] > 0) == (sigma > 0)
    assert (plain["admm_zy_iterations_res"] > 0) == (sigma == 0)
    assert plain["polish_solve_compact"] == 0
    # with a cache the polish rounds run the dense polish; without one they
    # run the plain Schur polish, and it runs only in a rescue
    polish_on = over.get("polish", True)
    assert (plain["polish_solve_dense"] > 0) == (polish_on and with_cache)
    # the carried dense H^-1 is refreshed with a cache and polish on
    assert r["hinv_moved"] == (with_cache and over.get("polish", True))


def test_compacted_case_has_distinct_rankings(results):
    """topk breaks ties unlike lax.top_k: the compacted branches rank
    scenarios by residuals, which must be distinct for the comparison."""
    r = _case(results, "compact_sigma_wi1")
    for (_, jinf), _ in r["rows"]:
        res = jinf.kkt_residual
        assert len(np.unique(res)) == B


# ---------------------------------------------------------------------------
# the control step at sigma > 0, and without a cache
# ---------------------------------------------------------------------------

WBC_B, WBC_STEPS = 4, (38, 39, 40, 41)


def test_sigma_control_step_matches_jax():
    torch.set_num_threads(1)
    traj = load_walk()
    offsets = make_offsets(np.random.default_rng(43), WBC_B)
    over = dict(sigma=1e-6)
    jm, jcp = jax_model(dtype=jnp.float64), JaxControllerParams()
    jq = JaxQPSolverParams(solve_layout="major", **over)
    jstep = jax.jit(lambda o, r, c, new, cache, valid: jwbc.wbc_step_batched(
        jm, jcp, jq, o, r, c, new, "pallas", cache, valid, setup_backend="xla"))
    tm, tcp, tq = anymal_d_model(torch.float64, "cpu"), ControllerParams(), QPSolverParams(**over)
    jc = jax.tree.map(lambda x: jnp.stack([x] * WBC_B), jwbc.init_carry(jnp.float64))
    jcache = jqp.make_cache(WBC_B, 42, 70, jq, jnp.float64)
    tc = wbc.init_carry(WBC_B, torch.float64, "cpu")
    tcache = qp.make_cache(WBC_B, 42, 70, tq, torch.float64, "cpu")
    nc = tc                                      # the same step without a cache
    n_both = 0
    kernels.reset_counts()
    valid = False
    for t in WBC_STEPS:
        obs, ref, new = step_arrays(traj, t, WBC_B, offsets)
        mask = np.full((WBC_B,), new)
        jo = jwbc.RobotObservation(**{k: jnp.asarray(v) for k, v in obs.items()})
        jr = jwbc.Reference(**{k: jnp.asarray(v) for k, v in ref.items()})
        to = convert.obs_from_numpy(obs, torch.float64, "cpu")
        tr = convert.ref_from_numpy(ref, torch.float64, "cpu")
        jout, jc, jcache = jstep(jo, jr, jc, jnp.asarray(mask), jcache, valid)
        tout, tc, tcache = wbc.wbc_step_batched(
            tm, tcp, tq, to, tr, tc, torch.as_tensor(mask), "kernel", tcache, valid)
        out = wbc.wbc_step_batched(tm, tcp, tq, to, tr, nc, torch.as_tensor(mask))
        assert len(out) == 2
        nout, nc = out
        valid = True
        assert _d(jout.tau, tout.tau) <= 1e-6, (t, _d(jout.tau, tout.tau))
        assert _d(jout.qp_x, tout.qp_x) <= 1e-6, t
        assert np.array_equal(np.asarray(jout.qp_info.polished), tout.qp_info.polished.numpy())
        # without a cache: the same QPs, solved to the same point where
        # both certify (the plain Schur polish has no drop rule, so at the
        # contact switch it may keep an ADMM iterate)
        nk, tk = nout.qp_info.kkt_residual, tout.qp_info.kkt_residual
        assert float(nk.max()) <= tq.rescue_threshold, t
        both = (nk < 1e-8) & (tk < 1e-8)
        n_both += int(both.sum())
        if bool(both.any()):
            assert _d(nout.tau[both], tout.tau[both]) <= 1e-6, t
    assert n_both >= 2 * WBC_B
    plain = kernels.plain_counts()
    assert plain["admm_iterations_res"] > 0 and plain["admm_zy_iterations_res"] == 0
    assert plain["polish_solve_compact"] > 0 and plain["polish_solve_dense"] == 0
