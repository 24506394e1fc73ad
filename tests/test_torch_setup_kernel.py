"""The port's fused setup `ops.kernels.setup.setup_batched` against the JAX
package's Pallas kernel `ops/pallas/setup_kernel.setup_batched` (interpret
mode, how the JAX package's own tests run it on the CPU) on the same numpy
inputs: B = 4 perturbed scenarios, scenario 1 and 2 with a swing leg and
non-zero swing references, a carry advanced two steps, a non-zero warm start
and a contact switch in scenario 0.

Three cases, one Pallas trace each (a trace takes tens of seconds):
`fused_f64` (with `qp_params`: the prepare tail too), `notnew_f64`
(`ref_is_new` False, the variant without the tail), `fused_f32`.  Every key
of the result, every carry update and all 11 prepared tensors are held to
max |a - b| <= tol * max(1, max |b|): 1e-9 in float64 and 2e-4 in float32,
the bars of the JAX package's own test of its kernel; `switch_flag`,
`deriv_valid` and `rho` exactly.

On CPU tensors the port's wrapper takes its plain version
(`setup_batched_plain`).  The CUDA source itself, `csrc/setup.cu`, is also
compiled as plain C++ (one emulated thread per block) and held to the plain
version on the same cases and three more (first cycle, `deriv_valid` False
in part of the batch, per-scenario `ref_is_new`), with the items of every
stage run in rising and in falling order; those tests need a C++ compiler
and skip without one.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQPSolverParams
from quadrupedwholebodycontroller_tpu.control import wbc as jwbc
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.ops import qp as jqp
from quadrupedwholebodycontroller_tpu.ops.pallas import setup_kernel as jsetup
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller_tpu_torch.ops import kernels, qp, spatial
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup as tsetup
from tests._torch_port_util import scaled_err

B = 4
RESULT = "H g A l u h_c Mc_jj Jc_st_j com current_pose foot_pos".split()
CARRY = ("old_T old_J_st old_J_sw tdot_inv integral_error prev_contacts "
         "switch_flag deriv_valid").split()
PREPARED = list(tsetup.PREPARED)
EXACT = ("switch_flag", "deriv_valid", "rho", "prev_contacts")
CASES = {
    # name: (dtype, ref_is_new, fused, tolerance)
    "fused_f64": ("float64", True, True, 1e-9),
    "notnew_f64": ("float64", False, False, 1e-9),
    "fused_f32": ("float32", True, True, 2e-4),
}


def _inputs(seed=0):
    """Observation, reference and warm start as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    rpy = 0.1 * rng.standard_normal((B, 3))
    obs = dict(
        base_R=spatial.rpy_to_matrix(torch.as_tensor(rpy)).numpy(),
        base_p=np.array([0.0, 0.0, 0.55]) + 0.02 * rng.standard_normal((B, 3)),
        base_vel=0.2 * rng.standard_normal((B, 6)),
        q=np.asarray(INITIAL_JOINT_POS) + 0.1 * rng.standard_normal((B, 12)),
        qd=0.5 * rng.standard_normal((B, 12)),
    )
    contacts = np.ones((B, 4))
    contacts[1, 1] = 0.0           # scenario 1 swings LF
    contacts[2, 3] = 0.0           # scenario 2 swings RH
    ref = dict(
        com_pose=np.tile(np.asarray(ControllerParams().initial_reference_pose), (B, 1)),
        com_vel=np.zeros((B, 6)), com_acc=0.05 * rng.standard_normal((B, 6)),
        swing_pos=0.1 * rng.standard_normal((B, 12)),
        swing_vel=np.full((B, 12), 0.2), swing_acc=np.full((B, 12), 0.1),
        contacts=contacts,
    )
    warm = dict(x=rng.standard_normal((B, 42)), z=rng.standard_normal((B, 70)),
                y=rng.standard_normal((B, 70)))
    return obs, ref, warm


def _torch_problem(dtype, steps=2, switch=True, seed=0):
    """(model, params, obs, ref, carry) of the port on the CPU: the carry is
    advanced `steps` cycles by the port's tensor-code setup (the observation
    drifts a little each cycle, so the finite differences are live), given
    the warm start, and then scenario 0's reference lifts leg LH."""
    tdt = getattr(torch, dtype)
    obs, ref, warm = _inputs(seed)
    model, cp = anymal_d_model(tdt, "cpu"), ControllerParams()
    carry = wbc.init_carry(B, tdt, "cpu")
    every = torch.ones(B, dtype=torch.bool)
    tref = convert.ref_from_numpy(ref, tdt, "cpu")
    for k in range(steps):
        drift = dict(obs, q=obs["q"] - 0.002 * (steps - k), base_p=obs["base_p"] - 0.001 * (steps - k))
        s = wbc.wbc_setup(model, cp, convert.obs_from_numpy(drift, tdt, "cpu"), tref, carry, every)
        carry = wbc.WBCCarry(qp_warm=carry.qp_warm, **s.carry_updates)
    carry = carry._replace(qp_warm=qp.QPState(
        **{k: torch.as_tensor(v).to(tdt) for k, v in warm.items()}))
    if switch:
        ref = dict(ref, contacts=ref["contacts"].copy())
        ref["contacts"][0, 0] = 0.0
    return (model, cp, convert.obs_from_numpy(obs, tdt, "cpu"),
            convert.ref_from_numpy(ref, tdt, "cpu"), carry)


def _flat(res):
    """{name: numpy array} over the result, the carry updates and the
    prepared tensors of a setup result of either package."""
    out = {k: np.asarray(res[k]) for k in RESULT}
    out.update({k: np.asarray(res["carry_updates"][k]) for k in CARRY})
    if res["prepared"] is not None:
        out.update({k: np.asarray(v) for k, v in zip(PREPARED, res["prepared"])})
    return out


_RUNS = {}


def _case(name):
    """Both packages on one case; computed once per test session."""
    if name in _RUNS:
        return _RUNS[name]
    torch.set_num_threads(1)
    dtype, new, fused, tol = CASES[name]
    jdt = getattr(jnp, dtype)
    model, cp, obs, ref, carry = _torch_problem(dtype)
    rn = torch.full((B,), new)
    got = tsetup.setup_batched(model, cp, obs, ref, carry, rn,
                               qp_params=QPSolverParams() if fused else None)
    jn = lambda t: jnp.asarray(t.numpy())
    jcarry = jwbc.WBCCarry(
        **{k: jn(getattr(carry, k)) for k in carry._fields if k != "qp_warm"},
        qp_warm=jqp.QPState(*(jn(getattr(carry.qp_warm, k)) for k in "xzy")))
    want = jsetup.setup_batched(
        jax_model(dtype=jdt), JaxControllerParams(),
        jwbc.RobotObservation(*(jn(t) for t in obs)), jwbc.Reference(*(jn(t) for t in ref)),
        jcarry, jnp.asarray(rn.numpy()), interpret=True,
        qp_params=JaxQPSolverParams() if fused else None)
    _RUNS[name] = dict(got=_flat(convert.to_numpy(got)), want=_flat(want), tol=tol,
                       problem=(model, cp, obs, ref, carry, rn), fused=fused)
    return _RUNS[name]


def _keys(name):
    return RESULT + CARRY + (PREPARED if CASES[name][2] else [])


def _hold(key, got, want, tol):
    assert got.shape == want.shape, (key, got.shape, want.shape)
    if key in EXACT:
        assert np.array_equal(got, want), key
        return
    g, w = got.astype(np.float64), want.astype(np.float64)
    inf = np.abs(w) >= 1e19            # one-sided bounds, scaled ones included
    assert np.array_equal(np.abs(g) >= 1e19, inf), key
    assert np.array_equal(g[inf] > 0, w[inf] > 0), key
    if (~inf).any():
        assert scaled_err(g[~inf], w[~inf]) <= tol, (key, scaled_err(g[~inf], w[~inf]))


@pytest.mark.parametrize("name,key", [(n, k) for n in CASES for k in _keys(n)])
def test_setup_matches_pallas_kernel(name, key):
    r = _case(name)
    _hold(key, r["got"][key], r["want"][key], r["tol"])


def test_the_cases_exercise_switch_swing_and_live_differences():
    """Guards the cases themselves."""
    r = _case("fused_f64")["want"]
    assert r["switch_flag"].tolist() == [True, False, False, False]
    assert np.abs(r["tdot_inv"][0]).max() == 0.0          # zeroed by the switch
    assert np.abs(r["tdot_inv"][1]).max() > 1e-3          # live finite differences
    assert np.abs(r["wzs"][0]).max() == 0.0 and np.abs(r["wys"][0]).max() == 0.0
    assert np.abs(r["wzs"][1]).max() > 0.0 and np.abs(r["wxs"][0]).max() > 0.0
    assert (np.abs(r["A"]).sum(-1) == 0).any()            # masked friction rows
    assert set(np.unique(r["rho"])) == {0.5, 500.0}
    assert np.array_equal(r["rho"][:, :18], np.full((B, 18), 500.0))
    held = _case("notnew_f64")["want"]
    assert not held["switch_flag"].any()                  # no new reference: flag held
    assert held["prev_contacts"][0].tolist() == [1.0] * 4  # the lifted leg not adopted
    assert r["prev_contacts"][0].tolist() == [0.0, 1.0, 1.0, 1.0]


def test_result_has_the_jax_functions_keys_and_owns_its_memory():
    r = _case("fused_f64")
    model, cp, obs, ref, carry, rn = r["problem"]
    got = tsetup.setup_batched(model, cp, obs, ref, carry, rn, qp_params=QPSolverParams())
    assert set(got) == {"H", "g", "A", "l", "u", "prepared", "h_c", "Mc_jj", "Jc_st_j",
                        "com", "current_pose", "foot_pos", "carry_updates"}
    assert set(got["carry_updates"]) == set(CARRY)
    assert len(got["prepared"]) == 11
    assert tsetup.setup_batched(model, cp, obs, ref, carry, rn)["prepared"] is None


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    model, cp, obs, ref, carry = _torch_problem("float64")
    kernels.reset_counts()
    tsetup.setup_batched(model, cp, obs, ref, carry, True, qp_params=QPSolverParams())
    assert kernels.plain_counts()["setup_batched"] == 1
    assert kernels.launch_counts()["setup_batched"] == 0


def test_exact_derivatives_raise():
    """Nothing raises for exact derivatives any more: `exact_mode` selects
    the exact variant (its own counter), and `params.exact_derivatives` alone
    does not (the control step decides the mode, as in the JAX package)."""
    model, cp, obs, ref, carry = _torch_problem("float64", steps=0)
    kernels.reset_counts()
    exact = tsetup.setup_batched(model, cp, obs, ref, carry, True, exact_mode=True)
    fd = tsetup.setup_batched(model, ControllerParams(exact_derivatives=True), obs, ref,
                              carry, True)
    assert kernels.plain_counts()["setup_batched_exact"] == 1
    assert kernels.plain_counts()["setup_batched"] == 1
    # first cycle: the finite differences are zero, the tangents are not
    assert float(fd["carry_updates"]["tdot_inv"].abs().max()) == 0.0
    assert float(exact["carry_updates"]["tdot_inv"].abs().max()) > 1e-3


def test_pack_constants_layout():
    """The tables the kernel reads: sizes and the entries a slip would move."""
    model = anymal_d_model(torch.float64, "cpu")
    cp = ControllerParams(kp_z=123.0, slack_weight=77.0)
    mc, topo = tsetup.pack_constants(model, cp)
    assert mc.shape == (12 * 33 + 13 * 14 + 4 * 3 + 20,) and mc.dtype == np.float64
    assert topo.shape == (3 * 13 + 4 + 1,) and topo.dtype == np.int32
    m_tot = float(model.mass.numpy().sum())
    sc = mc[12 * 33 + 13 * 14 + 12:]
    assert sc[0] == m_tot and sc[3] == m_tot * 9.81 and sc[4] == 1 / 400 and sc[5] == 400.0
    assert sc[7:13].tolist() == [6000.0, 6000.0, 123.0, 6000.0, 6000.0, 6000.0]
    assert sc[18] == 77.0 and sc[19] == 1e20
    body1 = mc[12 * 33 + 14:12 * 33 + 28]
    assert body1[0] == float(model.mass[1]) and body1[1] == float(model.mass[1]) / m_tot
    assert np.array_equal(body1[2:5], model.com[1].numpy())
    # joint 0 at q = 0 is the joint frame itself: M0 = R_j, and M1 = R_j K
    assert np.array_equal(mc[:9].reshape(3, 3), model.joint_R[0].numpy())
    K = spatial.skew(model.joint_axis[0]).numpy()
    assert np.allclose(mc[9:18].reshape(3, 3), model.joint_R[0].numpy() @ K, atol=0, rtol=0)
    parent, depth, anc = topo[:13], topo[13:26], topo[26:39]
    assert parent[1:].tolist() == list(model.parent[1:])
    assert depth.tolist() == [0] + [1, 2, 3] * 4 and topo[-1] == 3
    assert anc[3] == 0b111 and anc[4] == 0b1000 and anc[12] == 0b111 << 9
    assert topo[39:43].tolist() == list(model.frame_body)
    with pytest.raises(ValueError, match="13 bodies"):
        import dataclasses
        tsetup.pack_constants(dataclasses.replace(model, parent=model.parent[:5]), cp)


def test_solve_batched_with_prepared_is_the_same_solve_bit_for_bit():
    torch.set_num_threads(1)
    r = _case("fused_f64")
    model, cp, obs, ref, carry, rn = r["problem"]
    qpp = QPSolverParams()
    s = tsetup.setup_batched(model, cp, obs, ref, carry, rn, qp_params=qpp)
    data = qp.QPData(H=s["H"], g=s["g"], A=s["A"], l=s["l"], u=s["u"])
    warm = wbc._switch_masked_warm(carry, s["carry_updates"]["switch_flag"])
    cache = qp.make_cache(B, 42, 70, qpp, torch.float64, "cpu")
    kw = dict(cache=cache, use_warm=False, hinv_fn=wbc._wbc_polish_hinv)
    a = qp.solve_batched(data, warm, qpp, "kernel", **kw)
    b = qp.solve_batched(data, warm, qpp, "kernel", prepared=s["prepared"], **kw)
    for x, y in zip(a[0] + tuple(a[1]) + tuple(a[2]), b[0] + tuple(b[1]) + tuple(b[2])):
        assert torch.equal(x, y)


# ---- the CUDA source compiled as plain C++ --------------------------------

HOST_CASES = {
    # name: (dtype, carry steps, switch in scenario 0, ref_is_new, deriv_valid, fused)
    "warm_switch_f64": ("float64", 2, True, [True] * 4, [True] * 4, True),
    "held_flag_f64": ("float64", 2, True, [False] * 4, [True] * 4, False),
    "first_cycle_f64": ("float64", 0, False, [True] * 4, [False] * 4, True),
    "mixed_f64": ("float64", 2, True, [True, False, True, False],
                  [True, True, False, True], True),
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
def test_cuda_source_on_the_cpu_matches_plain_version(host_build, name, reverse):
    torch.set_num_threads(1)
    dtype, steps, switch, new, valid, fused = HOST_CASES[name]
    model, cp, obs, ref, carry = _torch_problem(dtype, steps, switch, seed=5)
    if steps:
        carry = carry._replace(deriv_valid=torch.tensor(valid))
    rn = torch.tensor(new)[::1]
    qpp = QPSolverParams() if fused else None
    want = _flat(convert.to_numpy(tsetup.setup_batched_plain(model, cp, obs, ref, carry, rn, qpp)))
    got = _flat(convert.to_numpy(
        tsetup.setup_batched_host(model, cp, obs, ref, carry, rn, qpp, reverse=reverse)))
    assert set(got) == set(want)
    tol = 1e-9 if dtype == "float64" else 2e-4
    for key in want:
        _hold(key, got[key], want[key], tol)


def test_cuda_source_reads_ref_is_new_at_any_stride(host_build):
    """A Python bool reaches the kernel as a (B,) view of stride 0."""
    model, cp, obs, ref, carry = _torch_problem("float64", seed=6)
    a = tsetup.setup_batched_host(model, cp, obs, ref, carry, True)
    b = tsetup.setup_batched_host(model, cp, obs, ref, carry, torch.ones(B, dtype=torch.bool))
    c = tsetup.setup_batched_host(model, cp, obs, ref, carry,
                                  torch.tensor([True, False] * B)[::2])
    for k in ("A", "l", "u"):
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])
    assert a["carry_updates"]["switch_flag"].tolist() == [True, False, False, False]


def test_cuda_source_refuses_what_it_does_not_take(host_build):
    model, cp, obs, ref, carry = _torch_problem("float64", steps=0)
    with pytest.raises(ValueError, match="contiguous"):
        tsetup.setup_batched_host(model, cp, obs._replace(q=obs.q.t().contiguous().t()),
                                  ref, carry, True)
    with pytest.raises(TypeError):
        tsetup.setup_batched_host(model, cp, obs._replace(qd=obs.qd.float()), ref, carry, True)
    with pytest.raises(ValueError, match="bool"):
        tsetup.setup_batched_host(model, cp, obs, ref,
                                  carry._replace(deriv_valid=carry.deriv_valid.float()), True)
