"""The slice as a whole: the port's closed loop `sim.rollout.batched_rollout`
(static-walk planner -> `wbc_step_batched` with exact derivatives -> physics)
against the JAX package's `batched_rollout(..., qp_backend="pallas")`, whose
Pallas kernels (the setup kernel in its exact mode, the solver's) run in
interpret mode on the CPU, as the JAX package's own tests run them.

B = 2, float64, T = 12 control steps (3 planner ticks), scenario 0 standing,
scenario 1 commanded to walk at 0.5 m/s from the first step; both sides
start from the same state (the JAX carry is carried across through
`convert`).  CoM, torques, KKT residuals and the final simulator state are
held to 1e-8 absolute (the two sides run the same float64 algorithm in
another summation order; one JAX trace, memoised for the module).

On the CPU the port's kernel setup takes its plain version, `wbc_setup`'s
exact branch (forward-mode AD through the rigid-body code), so this also
holds that derivation to the JAX kernel's in-kernel tangents.  The physics
also runs with one model per scenario (`sim_model`), every row nominal,
against the shared model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.config import PlannerParams as JaxPlannerParams
from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQPSolverParams
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.planner import gait as jgait
from quadrupedwholebodycontroller_tpu.sim import SimParams as JaxSimParams
from quadrupedwholebodycontroller_tpu.sim import rollout as jrollout
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.ops import kernels
from quadrupedwholebodycontroller_tpu_torch.planner import gait
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams, rollout

B, T, RATIO = 2, 12, 4
ATOL = 1e-8
_RUN = {}


def _commands():
    cmds = np.zeros((B, T, 3))
    cmds[1, :, 0] = 0.5
    return cmds


def _runs():
    if _RUN:
        return _RUN
    torch.set_num_threads(1)
    jdt = jnp.float64
    jm = jax_model(dtype=jdt)
    jcp, jpp = JaxControllerParams(exact_derivatives=True), JaxPlannerParams()
    jq = JaxQPSolverParams(solve_layout="major")
    carry0 = jax.tree.map(lambda x: jnp.stack([x] * B),
                          jrollout.init_rollout_carry(jm, jcp, jpp, dtype=jdt))
    jcarry, jtrace = jax.jit(lambda c, x: jrollout.batched_rollout(
        jm, jcp, jq, JaxSimParams(), lambda s, cc: jgait.planner_step(jpp, s, cc),
        RATIO, c, x, qp_backend="pallas"))(carry0, jnp.asarray(_commands()))
    tm = anymal_d_model(torch.float64, "cpu")
    tcp = ControllerParams(exact_derivatives=True)
    pp = PlannerParams()
    start = convert.rollout_carry_from_numpy(jax.tree.map(np.asarray, carry0),
                                             torch.float64, "cpu")
    kernels.reset_counts()
    tcarry, ttrace = rollout.batched_rollout(
        tm, tcp, QPSolverParams(), SimParams(), lambda s, c: gait.planner_step(pp, s, c),
        RATIO, start, torch.as_tensor(_commands()))
    _RUN.update(jax=(jax.tree.map(np.asarray, jcarry), jax.tree.map(np.asarray, jtrace)),
                port=(convert.to_numpy(tcarry), convert.to_numpy(ttrace)),
                plain=kernels.plain_counts(), start=start, jstart=carry0)
    return _RUN


@pytest.mark.parametrize("leaf", ["com_pos", "com_pose", "tau", "grf", "qp_kkt",
                                  "foot_pos", "ref_com_pose", "contacts"])
def test_trace_matches_jax(leaf):
    r = _runs()
    want, got = getattr(r["jax"][1], leaf), getattr(r["port"][1], leaf)
    assert got.shape == want.shape, leaf
    assert np.abs(got - want).max() <= ATOL, (leaf, np.abs(got - want).max())


@pytest.mark.parametrize("leaf", ["base_R", "base_p", "q", "u", "anchor"])
def test_final_sim_state_matches_jax(leaf):
    r = _runs()
    want, got = getattr(r["jax"][0].sim, leaf), getattr(r["port"][0].sim, leaf)
    assert np.abs(got - want).max() <= ATOL, (leaf, np.abs(got - want).max())


def test_the_run_exercises_the_exact_path_and_a_walk():
    """Guards the case: the exact setup's plain version ran once a step,
    the finite-difference one never; scenario 1 lifts a leg, scenario 0
    stands; the QPs certify and the robots stay up."""
    r = _runs()
    assert r["plain"]["setup_batched_exact"] == T and r["plain"]["setup_batched"] == 0
    trace = r["port"][1]
    assert (trace.contacts[1] == 0).any() and (trace.contacts[0] == 1).all()
    assert trace.qp_kkt.max() < 3e-3 and (trace.com_pos[:, :, 2] > 0.4).all()


def test_sim_model_waits_for_the_parallel_slice():
    """`batched_rollout(sim_model=...)` with one model per scenario (mass,
    com and inertia with a leading scenario axis), every row the nominal
    model, gives the shared-model run's trace and final state (to 1e-12:
    the per-scenario contractions sum in another order).  The name is kept
    from when the argument raised until the parallel-sweep slice."""
    r = _runs()
    tm = anymal_d_model(torch.float64, "cpu")
    rows = dataclasses.replace(tm, mass=tm.mass.expand(B, -1), com=tm.com.expand(B, -1, -1),
                               inertia=tm.inertia.expand(B, -1, -1, -1))
    pp = PlannerParams()
    carry, trace = rollout.batched_rollout(
        tm, ControllerParams(exact_derivatives=True), QPSolverParams(), SimParams(),
        lambda s, c: gait.planner_step(pp, s, c), RATIO, r["start"],
        torch.as_tensor(_commands()), sim_model=rows)
    want_carry, want_trace = r["port"]
    for leaf in rollout.RolloutTrace._fields:
        got, want = getattr(trace, leaf).numpy(), getattr(want_trace, leaf)
        assert np.abs(got - want).max() <= 1e-12, leaf
    for leaf in ("base_R", "base_p", "q", "u", "anchor"):
        got, want = getattr(carry.sim, leaf).numpy(), getattr(want_carry.sim, leaf)
        assert np.abs(got - want).max() <= 1e-12, leaf
