"""The single-robot control step of the port against the JAX package's:

  * `control.wbc.wbc_step` on a batch against `jax.vmap(wbc.wbc_step)`
    (tensor-code setup, `ops.qp.solve` with its single-sample rescue);
  * `wbc_step_batched(qp_backend="torch")` against the JAX package's
    `wbc_step_batched(qp_backend="xla")` (setup "auto", no cache: the
    batch-level rescue `_rescue_batched`);
  * the same step with `setup_backend="kernel"` (the setup kernel's plain
    variant, without the prepare stage, on the CPU) against the torch
    setup's, port against port.

B = 2 perturbed scenarios, float64, recorded walk steps 36..43, which span
the contact switch published at step 40; the carry is threaded on each
side from its own constructor.  Torques and the QP solution to 1e-8 of
max(1, max |JAX value|), the relative KKT residuals to 5e-12 absolute
(both sides run the same algorithm; they differ by summation order).  Each
JAX function is traced once a module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQPSolverParams
from quadrupedwholebodycontroller_tpu.control import wbc as jwbc
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import kernels
from tests._torch_port_util import load_walk, make_offsets, scaled_err, step_arrays

B = 2
STEPS = tuple(range(36, 44))
TOL = 1e-8
KKT_TOL = 5e-12
_RUN = {}


def _jax_steps():
    jm, jcp, jq = jax_model(dtype=jnp.float64), JaxControllerParams(), JaxQPSolverParams()
    single = jax.jit(jax.vmap(lambda o, r, c, n: jwbc.wbc_step(jm, jcp, jq, o, r, c, n)))
    batched = jax.jit(lambda o, r, c, n: jwbc.wbc_step_batched(jm, jcp, jq, o, r, c, n, "xla"))
    return {"wbc_step": single, "batched_torch": batched}


def _runs():
    if _RUN:
        return _RUN
    torch.set_num_threads(1)
    traj = load_walk()
    offsets = make_offsets(np.random.default_rng(7), B)
    tm, tcp, tq = anymal_d_model(torch.float64, "cpu"), ControllerParams(), QPSolverParams()
    port = {
        "wbc_step": lambda o, r, c, n: wbc.wbc_step(tm, tcp, tq, o, r, c, n),
        "batched_torch": lambda o, r, c, n: wbc.wbc_step_batched(tm, tcp, tq, o, r, c, n,
                                                                 "torch"),
        "batched_torch_kernel_setup": lambda o, r, c, n: wbc.wbc_step_batched(
            tm, tcp, tq, o, r, c, n, "torch", setup_backend="kernel"),
    }
    jax_fns = _jax_steps()
    jc0 = jax.tree.map(lambda x: jnp.stack([x] * B), jwbc.init_carry(jnp.float64))
    rows = {k: [] for k in list(port) + [f"jax_{k}" for k in jax_fns]}
    carries = {k: wbc.init_carry(B, torch.float64, "cpu") for k in port}
    carries.update({f"jax_{k}": jc0 for k in jax_fns})
    plain = {}
    for t in STEPS:
        obs, ref, new = step_arrays(traj, t, B, offsets)
        new_b = np.full((B,), new)
        tobs = convert.obs_from_numpy(obs, torch.float64, "cpu")
        tref = convert.ref_from_numpy(ref, torch.float64, "cpu")
        jobs = jwbc.RobotObservation(**{k: jnp.asarray(v) for k, v in obs.items()})
        jref = jwbc.Reference(**{k: jnp.asarray(v) for k, v in ref.items()})
        for k, fn in port.items():
            kernels.reset_counts()
            out, carries[k] = fn(tobs, tref, carries[k], torch.as_tensor(new_b))
            plain[k] = {n: plain.get(k, {}).get(n, 0) + v
                        for n, v in kernels.plain_counts().items()}
            rows[k].append(convert.to_numpy((out.tau, out.qp_x, out.qp_info)))
        for k, fn in jax_fns.items():
            out, carries[f"jax_{k}"] = fn(jobs, jref, carries[f"jax_{k}"], jnp.asarray(new_b))
            rows[f"jax_{k}"].append(jax.tree.map(np.asarray, (out.tau, out.qp_x, out.qp_info)))
    _RUN.update(rows=rows, plain=plain,
                contacts=[step_arrays(traj, t, 1)[1]["contacts"][0] for t in STEPS])
    return _RUN


def _assert_close(got_rows, want_rows):
    for t, (got, want) in zip(STEPS, zip(got_rows, want_rows)):
        for name, g, w in (("tau", got[0], want[0]), ("qp_x", got[1], want[1])):
            assert scaled_err(g, w) <= TOL, (t, name, scaled_err(g, w))
        gi, wi = got[2], want[2]
        for name in ("primal_residual", "dual_residual", "kkt_residual"):
            d = np.abs(getattr(gi, name) - getattr(wi, name)).max()
            assert d <= KKT_TOL, (t, name, d)
        assert (gi.polished == wi.polished).all(), t


@pytest.mark.parametrize("fn", ["wbc_step", "batched_torch"])
def test_matches_jax(fn):
    r = _runs()
    _assert_close(r["rows"][fn], r["rows"][f"jax_{fn}"])


def test_kernel_setup_with_the_torch_solver():
    """`setup_backend="kernel"` with the torch QP backend runs the setup
    kernel's plain variant once a step (on the CPU; on the card the
    kernel, K3) and gives the torch setup's step."""
    r = _runs()
    _assert_close(r["rows"]["batched_torch_kernel_setup"], r["rows"]["batched_torch"])
    assert r["plain"]["batched_torch_kernel_setup"]["setup_batched"] == len(STEPS)
    for k in ("wbc_step", "batched_torch"):
        assert not any(r["plain"][k].values()), (k, r["plain"][k])


def test_the_window_holds_a_contact_switch_and_certifies():
    r = _runs()
    c = np.asarray(r["contacts"])
    assert (c != c[0]).any(), "the window must hold a contact switch"
    for k in ("wbc_step", "batched_torch"):
        kkt = np.stack([row[2].kkt_residual for row in r["rows"][k]])
        assert kkt.max() < 1e-6, (k, kkt.max())
