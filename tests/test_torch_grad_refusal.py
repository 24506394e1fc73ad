"""The kernel path refuses a gradient, as the JAX package's Pallas path
does (`jax.grad` through a `pl.pallas_call` raises, interpret mode
included; the witness below runs it through `prepare_scaled`, B = 8):

  * each kernel wrapper (`prepare_scaled`, `admm_zy_iterations_res`,
    `admm_iterations_res`, `admm_iterations`, `polish_solve` in both forms,
    `ns_inverse_warm`, `setup_batched` in both modes, `pack_constants`)
    raises on the CPU when grad mode is on and an input requires grad,
    before its plain version runs; so do `solve_batched(backend="kernel")`,
    `wbc_step_batched` with either backend a kernel's, and
    `batched_rollout(qp_backend="kernel")`, before any kernel or plain
    version runs.  The message names the function and says that the JAX
    package's Pallas kernels have no backward either; an entry point's also
    names its option that carries a gradient (`backend="torch"`,
    `qp_backend="torch"`);
  * under `torch.no_grad()` the same calls, on the same inputs, give what
    the call gives on inputs that do not require grad, bit for bit, with
    the same plain calls and host syncs;
  * the setup kernel's constants follow a gain given as a tensor by value:
    an update in place is read anew, a fresh tensor of the same value finds
    the cached entry.

float64 inputs made with numpy from a seed, B = 3 (the WBC's n = 42,
m = 70)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_util import flagship_inputs

from quadrupedwholebodycontroller_tpu.ops.pallas import prepare_kernel as jprk
from quadrupedwholebodycontroller_tpu_torch.config import PlannerParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.ops import kernels, qp
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import (
    admm,
    admm_zy,
    ns_warm,
    polish,
    prepare,
    setup,
)
from quadrupedwholebodycontroller_tpu_torch.planner import gait
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams, rollout

B, N, M = 3, 42, 70
PREP = dict(sweeps=4, rho0=0.1, rho_eq_scale=1000.0)


def _qp(seed=0):
    """(H, A, g, l, u, wx, wz, wy) float64 tensors of a WBC-sized batch."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((B, N, N))
    H = L @ np.swapaxes(L, 1, 2) / N + np.eye(N)
    A = rng.standard_normal((B, M, N))
    ax = np.einsum("bij,bj->bi", A, 0.3 * rng.standard_normal((B, N)))
    l, u = ax - rng.uniform(0.1, 1.0, (B, M)), ax + rng.uniform(0.1, 1.0, (B, M))
    l[:, :6] = u[:, :6] = ax[:, :6]
    l[:, 30:40] = -1e20
    arrs = (H, A, 2.0 * rng.standard_normal((B, N)), l, u,
            0.1 * rng.standard_normal((B, N)), 0.1 * rng.standard_normal((B, M)),
            0.1 * rng.standard_normal((B, M)))
    return [torch.as_tensor(a) for a in arrs]


def _admm_inputs():
    H, A, g, l, u, wx, wz, wy = _qp()
    sH, sA, sg, sl, su, rho, wxs, wzs, wys, d, e = prepare.prepare_scaled_plain(
        H, A, g, l, u, wx, wz, wy, **PREP)
    K = sH + 1e-6 * torch.eye(N, dtype=H.dtype) + (sA.transpose(1, 2) * rho[:, None, :]) @ sA
    return [torch.linalg.inv(K), sA, sg, sl, su, rho, wxs, wzs, wys, sH, l, u, d, e], K


def _polish_inputs(form):
    H, A, g, l, u, _, _, _ = _qp()
    Hreg = H + 1e-8 * torch.eye(N, dtype=H.dtype)
    Hinv = torch.linalg.inv(Hreg)
    da = (torch.arange(M) % 3 == 0).to(H.dtype).expand(B, M).contiguous()
    S = da[:, :, None] * da[:, None, :] * (A @ Hinv @ A.transpose(1, 2)) \
        + torch.diag_embed(1e-8 * da + (1.0 - da))
    Hs = (Hreg, Hinv)
    if form == "compact":
        k, s = 12, 18
        diag = torch.ones(B, N, dtype=H.dtype)
        diag[:, s:s + k] = 0.0
        blk = Hreg[:, s:s + k, s:s + k]
        Hs = ((diag, blk, s), (diag, torch.linalg.inv(blk), s))   # diag: ones and zeros
    return [*Hs, torch.linalg.inv(S), A, da, g, torch.where(da > 0, u, 0.0), l, u]


def _with_grad(args, index):
    """A copy of args in which the tensor at `index` (a path into nested
    tuples) is replaced by a copy that requires grad."""
    i, rest = index[0], index[1:]
    out = list(args)
    out[i] = args[i].clone().requires_grad_(True) if not rest else _with_grad(args[i], rest)
    return type(args)(*out) if hasattr(args, "_fields") else out


def _cases():
    """name -> (the function's name in the message, a function of the args,
    the args, the path of the input that is made to require grad)."""
    admm_in, K = _admm_inputs()
    cases = {
        "prepare_scaled": ("prepare_scaled", lambda *a: prepare.prepare_scaled(*a, **PREP),
                           _qp(), (0,)),
        "admm_zy_iterations_res": (
            "admm_zy_iterations_res",
            lambda *a: admm_zy.admm_zy_iterations_res(*a, iters=5, alpha=1.6), admm_in, (0,)),
        "admm_iterations_res": (
            "admm_iterations_res",
            lambda *a: admm.admm_iterations_res(*a, iters=5, sigma=1e-6, alpha=1.6),
            admm_in, (2,)),
        "admm_iterations": (
            "admm_iterations",
            lambda *a: admm.admm_iterations(*a, iters=5, sigma=1e-6, alpha=1.6),
            admm_in[:9], (6,)),
        "polish_solve_dense": (
            "polish_solve", lambda *a: polish.polish_solve(*a, refine=2, reg=1e-8),
            _polish_inputs("dense"), (5,)),
        "polish_solve_compact": (
            "polish_solve", lambda *a: polish.polish_solve(*a, refine=2, reg=1e-8),
            _polish_inputs("compact"), (3,)),
        "ns_inverse_warm": ("ns_inverse_warm",
                            lambda *a: ns_warm.ns_inverse_warm(*a, warm_iters=2),
                            [K, admm_in[0]], (0,)),
    }
    model, cp, qpp, obs, ref, carry, _ = flagship_inputs(B, torch.float64)
    for exact in (False, True):
        cases["setup_batched_" + ("exact" if exact else "fd")] = (
            "setup_batched",
            (lambda x: lambda o, r, c: setup.setup_batched(model, cp, o, r, c, True, qpp,
                                                           exact_mode=x))(exact),
            [obs, ref, carry], (0, 3))
    # a gain given as a tensor, and the model, reach the kernel as data
    cases["setup_batched_gain"] = (
        "setup_batched",
        lambda kp: setup.setup_batched(model, dataclasses.replace(cp, kp=kp), obs, ref,
                                       carry, True, qpp),
        [torch.tensor(cp.kp, dtype=torch.float64)], (0,))
    cases["pack_constants"] = (
        "pack_constants",
        lambda mass: setup.pack_constants(dataclasses.replace(model, mass=mass), cp),
        [model.mass], (0,))
    return cases


CASES = _cases()


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, np.ndarray):
        return [torch.as_tensor(out)]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _flat(v)]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _flat(v)]
    return []


def _refusal(fn, *args, hint=None):
    """Call fn(*args) in grad mode, expecting the refusal (and `hint` in its
    message); returns the message.  Neither a kernel nor a plain version may
    have run."""
    kernels.reset_counts()
    with pytest.raises(RuntimeError) as err:
        fn(*args)
    assert not any(kernels.launch_counts().values())
    assert not any(kernels.plain_counts().values())
    msg = str(err.value)
    assert "requires grad" in msg and "Pallas" in msg, msg
    assert hint is None or f"{hint} carries a gradient" in msg, msg
    return msg


def _same_under_no_grad(fn, args, args_grad):
    """fn under torch.no_grad() on args_grad gives fn(args) in grad mode
    bit for bit, with the same plain calls and host syncs."""
    kernels.reset_counts()
    qp.HOST_SYNCS = 0
    want = _flat(fn(*args))
    counts = (kernels.plain_counts(), qp.HOST_SYNCS)
    kernels.reset_counts()
    qp.HOST_SYNCS = 0
    with torch.no_grad():
        got = _flat(fn(*args_grad))
    assert (kernels.plain_counts(), qp.HOST_SYNCS) == counts
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert not a.requires_grad
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_wrapper_refuses_a_gradient(name):
    fname, fn, args, index = CASES[name]
    args_grad = _with_grad(args, index)
    assert _refusal(fn, *args_grad).startswith(fname + ":")
    _same_under_no_grad(fn, args, args_grad)


def _step_args(qp_backend, setup_backend, kp):
    model, cp, qpp, obs, ref, carry, cache = flagship_inputs(B, torch.float64)
    cp = dataclasses.replace(cp, kp=kp)
    return lambda: wbc.wbc_step_batched(model, cp, qpp, obs, ref, carry, True, qp_backend,
                                        cache, False, setup_backend)


@pytest.mark.parametrize("backends", [("kernel", "auto"), ("kernel", "torch"),
                                      ("torch", "kernel")])
def test_control_step_refuses_where_a_kernel_runs(backends):
    kp = torch.tensor(6000.0, dtype=torch.float64, requires_grad=True)
    msg = _refusal(_step_args(*backends, kp), hint='setup_backend="torch"')
    assert msg.startswith("wbc_step_batched(")
    _same_under_no_grad(lambda step: step(), [_step_args(*backends, 6000.0)],
                        [_step_args(*backends, kp)])


def test_solve_batched_kernel_backend_refuses():
    H, A, g, l, u, wx, wz, wy = _qp()
    data, warm = qp.QPData(H, g, A, l, u), qp.QPState(wx, wz, wy)
    g_grad = g.clone().requires_grad_(True)
    data_grad = data._replace(g=g_grad)
    msg = _refusal(lambda: qp.solve_batched(data_grad, warm, backend="kernel"),
                   hint='backend="torch"')
    assert msg.startswith('solve_batched(backend="kernel")')
    _same_under_no_grad(lambda d: qp.solve_batched(d, warm, backend="kernel"), [data],
                        [data_grad])


def test_batched_rollout_kernel_backend_refuses():
    model, cp, qpp, *_ = flagship_inputs(1, torch.float64)
    cp = dataclasses.replace(cp, kp=torch.tensor(cp.kp, dtype=torch.float64,
                                                 requires_grad=True))
    pp = PlannerParams()
    carry = rollout.init_rollout_carry(model, cp, 1, pp, torch.float64, "cpu")
    _refusal(lambda: rollout.batched_rollout(
        model, cp, qpp, SimParams(), lambda s, c: gait.planner_step(pp, s, c), 4, carry,
        torch.zeros((1, 2, 3), dtype=torch.float64), qp_backend="kernel"),
        hint='qp_backend="torch" with setup_backend="torch"')


def test_setup_constants_follow_a_tensor_gain_by_value():
    """The kernel's constants are cached by the gains' values: `kp` updated
    in place under no_grad (an optimizer's step) is read anew, and a fresh
    tensor of the same value adds no entry."""
    model, cp, *_ = flagship_inputs(1, torch.float64)
    kp = torch.tensor(cp.kp, dtype=torch.float64, requires_grad=True)
    cached = lambda p: setup._device_constants(model, p, torch.float64, "cpu")[0]
    with torch.no_grad():
        before = cached(dataclasses.replace(cp, kp=kp))
        kp.mul_(2.0)
        after = cached(dataclasses.replace(cp, kp=kp))
        entries = len(setup._constants)
        again = cached(dataclasses.replace(cp, kp=kp.detach().clone()))
    want = lambda k: torch.as_tensor(
        setup.pack_constants(model, dataclasses.replace(cp, kp=k))[0])
    assert torch.equal(before, want(cp.kp))
    assert torch.equal(after, want(2.0 * cp.kp)) and not torch.equal(after, before)
    assert torch.equal(again, after) and len(setup._constants) == entries


def test_jax_pallas_path_has_no_reverse_mode():
    """The witness: jax.grad through the Pallas prepare kernel (interpret
    mode on the CPU), B = 8, raises."""
    H, A, g, l, u, wx, wz, wy = (np.concatenate([a.numpy()] * 3)[:8] for a in _qp())
    rest = tuple(jnp.asarray(a) for a in (A, g, l, u, wx, wz, wy))

    def loss(Hj):
        return jnp.sum(jprk.prepare_scaled(Hj, *rest, **PREP)[0])

    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(loss)(jnp.asarray(H))
