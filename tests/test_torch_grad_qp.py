"""Gradients through the port's tensor-code solver against `jax.grad`
through the JAX package's "xla" backend, on the same problems:

  * `ops.qp.solve` against `jax.vmap(qp.solve)`;
  * `ops.qp.solve_batched(backend="torch")` against the JAX package's
    `solve_batched(backend="xla")`.

The loss is a fixed random weighting of the solution, sum(w_x x + w_z z +
w_y y), and the gradient is taken with respect to H, g, l and u.  Three
cases: seeded random QPs (B = 3, n = 6, m = 8: two equality rows, a free
row at the QP_INF convention, two one-sided rows; shipped parameters, warm
start); the WBC's QP of the recorded walk's step 40 (B = 2, per-scenario
offsets, next to the contact switch; cold start, the rescue off); and a
starved ADMM (3
iterations, no polish) whose rescue fires.  There the value is the rescued
one and the gradient the pre-rescue one on both sides: each side's gradient
equals its own gradient with the rescue off, while its value does not.
float64; every gradient to 1e-8 of its largest entry, the values to 1e-9 of
max(1, max |x|).  Each JAX trace runs once a module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_util import load_walk, make_offsets, step_arrays

from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQPSolverParams
from quadrupedwholebodycontroller_tpu.ops import qp as jqp
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import kernels, qp

GRAD_TOL = 1e-8
VALUE_TOL = 1e-9
STARVED = dict(iterations=3, cold_iterations=3, polish=False, rescue_threshold=1e-3,
               rescue_iterations=150)
# the WBC case runs the shipped ADMM and polish with the rescue off: the
# rescue's trace would take 4/5 of the JAX compile, and the other two
# cases hold it (not firing, and firing)
CASES = {"random": dict(), "wbc_walk_step": dict(rescue_threshold=0.0), "rescue": STARVED}
FNS = ("solve", "solve_batched")
INPUTS = ("H", "g", "l", "u")
_DATA, _JAX, _PORT = {}, {}, {}


def _random(seed=0, B=3, n=6, m=8):
    rng = np.random.default_rng(seed)
    H, g, A, l, u = [], [], [], [], []
    for _ in range(B):
        L = rng.normal(size=(n, n))
        A_ = rng.normal(size=(m, n))
        ax = A_ @ (0.3 * rng.normal(size=n))
        lo = ax - rng.uniform(0.1, 1.0, size=m)
        up = ax + rng.uniform(0.1, 1.0, size=m)
        lo[:2] = up[:2] = ax[:2]                  # equality rows
        lo[2], up[2] = -1e20, 1e20                # a free row
        lo[3] = -1e20                             # one-sided rows
        up[4] = 1e20
        H.append(L @ L.T + n * np.eye(n))
        g.append(rng.normal(size=n))
        A.append(A_)
        l.append(lo)
        u.append(up)
    data = tuple(np.stack(a) for a in (H, g, A, l, u))
    x = 0.3 * rng.normal(size=(B, n))
    z = np.clip(np.einsum("bij,bj->bi", data[2], x), data[3], data[4])
    return data, (x, z, 0.1 * rng.normal(size=(B, m)))


def _wbc_walk_step(t=40, B=2):
    """The QP that `wbc_setup` builds from the recorded walk's step t (next
    to its first contact switch), two scenarios with observation offsets."""
    obs, ref, rin = step_arrays(load_walk(), t, B, make_offsets(np.random.default_rng(2), B))
    f64 = dict(dtype=torch.float64, device="cpu")
    s = wbc.wbc_setup(anymal_d_model(**f64), ControllerParams(),
                      convert.obs_from_numpy(obs, **f64), convert.ref_from_numpy(ref, **f64),
                      wbc.init_carry(B, **f64), torch.full((B,), rin))
    data = tuple(a.numpy() for a in s.qp_data)
    B, m, n = data[2].shape
    return data, (np.zeros((B, n)), np.zeros((B, m)), np.zeros((B, m)))


def _case(case):
    if case not in _DATA:
        data, warm = _wbc_walk_step() if case == "wbc_walk_step" else _random()
        rng = np.random.default_rng(7)
        B, m, n = data[2].shape
        weights = (rng.normal(size=(B, n)), rng.normal(size=(B, m)), rng.normal(size=(B, m)))
        _DATA[case] = (data, warm, weights)
    return _DATA[case]


def _jax_run(case, fn, rescue=True):
    """(x, z, y) and the gradient of the weighted loss w.r.t. (H, g, l, u)."""
    key = (case, fn, rescue)
    if key not in _JAX:
        data, warm, weights = _case(case)
        p = JaxQPSolverParams(**CASES[case])
        if not rescue:
            p = dataclasses.replace(p, rescue_threshold=0.0)
        w = jqp.QPState(*(jnp.asarray(a) for a in warm))

        def loss(H, g, l, u):
            d = jqp.QPData(H, g, jnp.asarray(data[2]), l, u)
            if fn == "solve":
                st, _ = jax.vmap(lambda dd, ww: jqp.solve(dd, ww, p))(d, w)
            else:
                st, _ = jqp.solve_batched(d, w, p, "xla")
            return sum(jnp.sum(jnp.asarray(c) * s) for c, s in zip(weights, st)), st

        args = tuple(jnp.asarray(data[i]) for i in (0, 1, 3, 4))
        (_, st), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                                    has_aux=True))(*args)
        _JAX[key] = (tuple(np.asarray(a) for a in st), tuple(np.asarray(a) for a in grads))
    return _JAX[key]


def _port_run(case, fn, rescue=True):
    key = (case, fn, rescue)
    if key not in _PORT:
        data, warm, weights = _case(case)
        p = QPSolverParams(**CASES[case])
        if not rescue:
            p = dataclasses.replace(p, rescue_threshold=0.0)
        H, g, l, u = (torch.tensor(data[i], requires_grad=True) for i in (0, 1, 3, 4))
        d = qp.QPData(H, g, torch.as_tensor(data[2]), l, u)
        w = qp.QPState(*(torch.as_tensor(a) for a in warm))
        kernels.reset_counts()
        st, _ = qp.solve(d, w, p) if fn == "solve" else qp.solve_batched(d, w, p, "torch")
        loss = sum(torch.sum(torch.as_tensor(c) * s) for c, s in zip(weights, st))
        grads = torch.autograd.grad(loss, (H, g, l, u))
        _PORT[key] = (tuple(s.detach().numpy() for s in st), tuple(a.numpy() for a in grads),
                      kernels.launch_counts(), kernels.plain_counts())
    return _PORT[key]


def _share(got, want, floor=1.0):
    return np.abs(got - want).max() / max(floor, np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fn", FNS)
def test_gradient_matches_jax(case, fn):
    st, grads, launches, plain = _port_run(case, fn)
    jst, jgrads = _jax_run(case, fn)
    for name, got, want in zip("xzy", st, jst):
        assert _share(got, want) <= VALUE_TOL, (name, _share(got, want))
    for name, got, want in zip(INPUTS, grads, jgrads):
        assert np.abs(want).max() > 0.0, name
        assert _share(got, want, 0.0) <= GRAD_TOL, (name, _share(got, want, 0.0))
    # tensor code only: no kernel and no kernel's plain version ran
    assert not any(launches.values()) and not any(plain.values())


@pytest.mark.parametrize("fn", FNS)
def test_rescue_gives_the_value_and_not_the_gradient(fn):
    """The rescue fires: the value moves off the pre-rescue iterate, the
    gradient stays the pre-rescue one, in the port and in the JAX package."""
    for run in (_port_run, _jax_run):
        st, grads = run("rescue", fn)[:2]
        st0, grads0 = run("rescue", fn, rescue=False)[:2]
        assert max(_share(a, b) for a, b in zip(st, st0)) > 1e-3, run.__name__
        for name, got, want in zip(INPUTS, grads, grads0):
            assert _share(got, want, 0.0) <= GRAD_TOL, (run.__name__, name)


def test_no_grad_keeps_the_values():
    """Under torch.no_grad() the solve gives the values it gives in grad
    mode, bit for bit."""
    data, warm, _ = _case("rescue")
    p = QPSolverParams(**STARVED)
    d = qp.QPData(*(torch.as_tensor(a) for a in data))
    w = qp.QPState(*(torch.as_tensor(a) for a in warm))
    with torch.no_grad():
        st, info = qp.solve_batched(d, w, p, "torch")
    want = _port_run("rescue", "solve_batched")[0]
    for got, ref in zip(st, want):
        assert np.array_equal(got.numpy(), ref)
