"""Exact derivatives in the WBC setup, three routes to the same QP:

  * `wbc_setup`'s exact branch (forward-mode AD, `torch.func.jvp`, through
    the port's rigid-body code) against the JAX package's vmapped exact
    `wbc_setup` (XLA, no Pallas), B = 3, over recorded walking steps 38..41
    from a fresh carry (`deriv_valid` False at the first step; the contact
    switch published at step 40): float64 to 1e-10 of each output's scale,
    float32 to 1e-5 (measured at most 7e-7, on h_c);
  * `_exact_epilogue_batched` over the port's finite-difference setup
    (`setup_batched_plain`, prepare stage included) against the same JAX
    exact setup, and its patched scaled bounds against the prepare stage run
    on the exact QP;
  * the setup kernel's exact mode (K3x): `csrc/setup.cu` compiled as plain
    C++ (`setup_batched_host(exact_mode=True)`, stage items in rising and
    in falling order) against `setup_batched_plain(exact_mode=True)`.

The JAX kernel's exact mode equals its XLA exact branch (the JAX package's
`tests/test_exact_derivatives.py`), the port's plain version equals that
branch (here), and the CUDA source equals the plain version (here on the
CPU, on the card in `chip_smoke.py`): no Pallas trace is needed for the
chain.  The control step's dispatch is checked too: which route runs for
which parameters, and that the three give one step."""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.control import wbc as jwbc
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import kernels, qp
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import prepare
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup as tsetup
from tests._torch_port_util import load_walk, make_offsets, scaled_err, step_arrays
from tests.test_torch_setup_kernel import _flat, _hold, _torch_problem

B = 3
STEPS = (38, 39, 40, 41)
EXACT_CP = ControllerParams(exact_derivatives=True)
TOL = {"float64": 1e-10, "float32": 1e-5}
_RUNS = {}


def _replay(dtype):
    """Per step: (obs, ref, carry in, new, JAX exact setup, port exact setup);
    each side threads its own carry."""
    if dtype in _RUNS:
        return _RUNS[dtype]
    torch.set_num_threads(1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    traj = load_walk()
    offsets = make_offsets(np.random.default_rng(17), B)
    jm, tm = jax_model(dtype=jdt), anymal_d_model(tdt, "cpu")
    jcp = JaxControllerParams(exact_derivatives=True)
    jsetup = jax.jit(jax.vmap(lambda o, r, c, n: jwbc.wbc_setup(jm, jcp, o, r, c, n)))
    jc = jax.tree.map(lambda x: jnp.stack([x] * B), jwbc.init_carry(jdt))
    tc = wbc.init_carry(B, tdt, "cpu")
    rows = []
    for t in STEPS:
        obs, ref, new = step_arrays(traj, t, B, offsets)
        js = jsetup(jwbc.RobotObservation(**{k: jnp.asarray(v, jdt) for k, v in obs.items()}),
                    jwbc.Reference(**{k: jnp.asarray(v, jdt) for k, v in ref.items()}),
                    jc, jnp.full((B,), new))
        to, tr = convert.obs_from_numpy(obs, tdt, "cpu"), convert.ref_from_numpy(ref, tdt, "cpu")
        rn = torch.full((B,), new)
        with torch.no_grad():      # as in the control step
            ts = wbc.wbc_setup(tm, EXACT_CP, to, tr, tc, rn)
        rows.append(dict(t=t, obs=to, ref=tr, carry=tc, new=rn, jax=js, port=ts))
        jc = jwbc.WBCCarry(qp_warm=jc.qp_warm, **js.carry_updates)
        tc = wbc.WBCCarry(qp_warm=tc.qp_warm, **ts.carry_updates)
    _RUNS[dtype] = rows
    return rows


def _setup_leaves(s):
    """{name: array} over a WBCSetup of either package."""
    d = s.qp_data
    out = {k: np.asarray(getattr(d, k)) for k in ("H", "g", "A", "l", "u")}
    out.update({k: np.asarray(getattr(s, k)) for k in
                ("h_c", "Mc_jj", "Jc_st_j", "com", "current_pose", "foot_pos")})
    out.update({f"carry.{k}": np.asarray(v) for k, v in s.carry_updates.items()})
    return out


def _close(got, want, tol, what):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if w.dtype == bool or np.asarray(want).dtype == bool:
        assert np.array_equal(np.asarray(got), np.asarray(want)), what
        return
    fin = np.abs(w) < 1e19
    assert np.array_equal(np.abs(g) >= 1e19, ~fin), what
    err = scaled_err(g[fin], w[fin])
    assert err <= tol, (what, err)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("i", range(len(STEPS)), ids=[f"step{t}" for t in STEPS])
def test_exact_wbc_setup_matches_jax(dtype, i):
    row = _replay(dtype)[i]
    want = _setup_leaves(row["jax"])
    got = _setup_leaves(convert.to_numpy(row["port"]))
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w, TOL[dtype], (row["t"], k))


def test_the_window_exercises_switch_first_cycle_and_exact_tangents():
    rows = _replay("float64")
    assert [bool(r["carry"].deriv_valid[0]) for r in rows] == [False, True, True, True]
    switch = [bool(r["port"].carry_updates["switch_flag"][0]) for r in rows]
    assert switch == [False, False, True, True]
    # no finite-difference zeroing: the exact d(T^-1)/dt is live on the first
    # cycle and at the switch, where the finite differences give zero
    for r in rows:
        assert float(r["port"].carry_updates["tdot_inv"].abs().max()) > 1e-3


@pytest.mark.parametrize("i", range(len(STEPS)), ids=[f"step{t}" for t in STEPS])
def test_epilogue_over_the_finite_difference_setup_matches_jax(i):
    row = _replay("float64")[i]
    tm = anymal_d_model(torch.float64, "cpu")
    qpp = QPSolverParams()
    sk = tsetup.setup_batched_plain(tm, EXACT_CP, row["obs"], row["ref"], row["carry"],
                                    row["new"], qp_params=qpp)
    fd = wbc.WBCSetup(qp_data=qp.QPData(H=sk["H"], g=sk["g"], A=sk["A"], l=sk["l"], u=sk["u"]),
                      h_c=sk["h_c"], Mc_jj=sk["Mc_jj"], Jc_st_j=sk["Jc_st_j"], com=sk["com"],
                      current_pose=sk["current_pose"], foot_pos=sk["foot_pos"],
                      carry_updates=sk["carry_updates"])
    with torch.no_grad():
        got, prepared = wbc._exact_epilogue_batched(tm, EXACT_CP, row["obs"], row["carry"],
                                                    fd, sk["prepared"])
    want = _setup_leaves(row["jax"])
    for k, v in _setup_leaves(convert.to_numpy(got)).items():
        _close(v, want[k], TOL["float64"], (row["t"], k))
    # the patched scaled bounds are the prepare stage's on the exact QP
    d = got.qp_data
    warm = wbc._switch_masked_warm(row["carry"], got.carry_updates["switch_flag"])
    ref = prepare.prepare_scaled_plain(d.H, d.A, d.g, d.l, d.u, warm.x, warm.z, warm.y,
                                       sweeps=qpp.scaling_iters, rho0=qpp.rho,
                                       rho_eq_scale=qpp.rho_eq_scale)
    for k, a, b in zip(tsetup.PREPARED, prepared, ref):
        _close(a.numpy(), b.numpy(), TOL["float64"], (row["t"], "prepared", k))


HOST_CASES = {
    # name: (dtype, carry steps, switch in scenario 0, ref_is_new, deriv_valid, fused)
    "warm_switch_f64": ("float64", 2, True, [True] * 4, [True] * 4, True),
    "mixed_f64": ("float64", 2, True, [True, False, True, False],
                  [True, True, False, True], True),
    "held_flag_f64": ("float64", 2, True, [False] * 4, [True] * 4, False),
    "warm_switch_f32": ("float32", 2, True, [True] * 4, [True] * 4, True),
}


@pytest.fixture(scope="module")
def host_build():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("needs a C++ compiler to build csrc/setup.cu for the CPU")
    from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build

    return build.host_lib()


@pytest.mark.parametrize("reverse", [False, True], ids=["rising", "falling"])
@pytest.mark.parametrize("name", HOST_CASES)
def test_cuda_source_exact_mode_on_the_cpu_matches_plain_version(host_build, name, reverse):
    torch.set_num_threads(1)
    dtype, steps, switch, new, valid, fused = HOST_CASES[name]
    model, cp, obs, ref, carry = _torch_problem(dtype, steps, switch, seed=8)
    carry = carry._replace(deriv_valid=torch.tensor(valid))
    rn = torch.tensor(new)
    qpp = QPSolverParams() if fused else None
    with torch.no_grad():
        want = _flat(convert.to_numpy(tsetup.setup_batched_plain(
            model, cp, obs, ref, carry, rn, qpp, exact_mode=True)))
    got = _flat(convert.to_numpy(tsetup.setup_batched_host(
        model, cp, obs, ref, carry, rn, qpp, reverse=reverse, exact_mode=True)))
    fd = _flat(convert.to_numpy(tsetup.setup_batched_host(model, cp, obs, ref, carry, rn, qpp)))
    assert set(got) == set(want)
    tol = 1e-9 if dtype == "float64" else 2e-4
    for key in want:
        _hold(key, got[key], want[key], tol)
    # the exact mode is not the finite-difference one
    assert scaled_err(fd["tdot_inv"], want["tdot_inv"]) > 1e-3


def _step_inputs():
    row = _replay("float64")[1]
    return anymal_d_model(torch.float64, "cpu"), row["obs"], row["ref"], row["carry"]


@pytest.mark.parametrize("route", ["kernel", "epilogue", "torch"])
def test_control_step_routes_give_one_step(route):
    """`wbc_step_batched` with exact derivatives: the setup kernel's exact
    mode (its plain version here), the finite-difference kernel plus the
    epilogue, and the tensor-code setup; each route's counters, and all
    three give the same torques, QP solution and carry (1e-9 in float64:
    the same QP to rounding, then the same solve)."""
    model, obs, ref, carry = _step_inputs()
    qpp = QPSolverParams()
    cp = dataclasses.replace(EXACT_CP, exact_epilogue=route == "epilogue")
    backend = "torch" if route == "torch" else "kernel"
    cache = qp.make_cache(B, 42, 70, qpp, torch.float64, "cpu")
    kernels.reset_counts()
    out, new_carry, _ = wbc.wbc_step_batched(model, cp, qpp, obs, ref, carry, True,
                                             "kernel", cache, False, setup_backend=backend)
    plain = kernels.plain_counts()
    expect = {"kernel": (0, 1), "epilogue": (1, 0), "torch": (0, 0)}[route]
    assert (plain["setup_batched"], plain["setup_batched_exact"]) == expect
    assert not any(kernels.launch_counts().values())
    if route == "kernel":
        _RUNS["step"] = (out, new_carry)
        return
    if "step" not in _RUNS:
        test_control_step_routes_give_one_step("kernel")
    ref_out, ref_carry = _RUNS["step"]
    for a, b, what in ((out.tau, ref_out.tau, "tau"), (out.qp_x, ref_out.qp_x, "qp_x"),
                       (new_carry.tdot_inv, ref_carry.tdot_inv, "tdot_inv")):
        assert float((a - b).abs().max()) <= 1e-9, (route, what)


def test_no_grad_does_not_switch_off_forward_mode_ad():
    model, obs, ref, carry = _step_inputs()
    rn = torch.ones(B, dtype=torch.bool)
    with torch.no_grad():
        a = wbc.wbc_setup(model, EXACT_CP, obs, ref, carry, rn)
    b = wbc.wbc_setup(model, EXACT_CP, obs, ref, carry, rn)
    assert torch.equal(a.carry_updates["tdot_inv"], b.carry_updates["tdot_inv"])
    assert float(a.carry_updates["tdot_inv"].abs().max()) > 1e-3
