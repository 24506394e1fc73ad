"""Closed loop of a batch of scenarios: planner -> control step -> physics.

The reference's process graph (motion planner node, controller node,
simulator) as one loop over control steps: the planner ticks every
`planner_ratio` control steps and its references are held in between (last
writer wins, the queue-size-1 semantics of the reference); the control step
solves the batch's QPs; the simulator advances every scenario one control
period.  Two loops: `batched_rollout` solves the whole batch at once with a
carried factorization cache and freezes a fallen scenario (the sweep's
loop); `rollout` runs each scenario as the single robot does
(`control.wbc.wbc_step`), the loop of `closed_loop_rollout` and
`trot_rollout`.

`planner_ratio` is a host integer, so deciding whether the planner ticks
costs no device sync; per-scenario decisions (a published reference, a
fallen robot) are `torch.where` masks.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from quadrupedwholebodycontroller_tpu_torch.config import (
    QP_NUM_CONSTRAINTS,
    QP_NUM_VARS,
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller_tpu_torch.models.robot_model import RobotModel
from quadrupedwholebodycontroller_tpu_torch.ops.qp import make_cache
from quadrupedwholebodycontroller_tpu_torch.planner import gait, trot
from quadrupedwholebodycontroller_tpu_torch.planner.gait import tree_where
from quadrupedwholebodycontroller_tpu_torch.sim import world

# the reset pose's base height above the reference pose
# (resetRobotSimState, cpp:579-606)
Z_OFFSET = 0.05


class RolloutCarry(NamedTuple):
    sim: world.SimState
    wbc: wbc.WBCCarry
    planner: Any               # the planner's state (a tuple of (B, ...) tensors)
    ref: wbc.Reference


class RolloutTrace(NamedTuple):
    """Per-control-step record of the signals the reference's recording
    keeps, each (B, T, ...)."""

    com_pos: torch.Tensor        # (B, T, 3)
    com_pose: torch.Tensor       # (B, T, 6)
    base_p: torch.Tensor         # (B, T, 3)
    q: torch.Tensor              # (B, T, 12)
    tau: torch.Tensor            # (B, T, 12), 0 once a scenario has fallen
    grf: torch.Tensor            # (B, T, 12)
    foot_pos: torch.Tensor       # (B, T, 12)
    ref_com_pose: torch.Tensor   # (B, T, 6)
    ref_swing_pos: torch.Tensor  # (B, T, 12) the planner's swing-foot targets
    contacts: torch.Tensor       # (B, T, 4)
    qp_kkt: torch.Tensor         # (B, T), 0 once a scenario has fallen


def init_rollout_carry(model: RobotModel, cparams: ControllerParams, batch: int,
                       pparams: PlannerParams | None = None, dtype=torch.float32,
                       device="cuda", planner_state: Any = None) -> RolloutCarry:
    """Every scenario at the reference's reset pose: its joint angles, the
    base at the reference height + Z_OFFSET, at rest.  Pass planner_state
    for another planner than the static walk (e.g. the trot)."""
    kw = dict(dtype=dtype, device=device)
    pose = cparams.initial_reference_pose
    base_p = torch.tensor([pose[0], pose[1], pose[2] + Z_OFFSET], **kw).expand(batch, 3)
    q = torch.tensor(INITIAL_JOINT_POS, **kw).expand(batch, len(INITIAL_JOINT_POS))
    if planner_state is None:
        planner_state = gait.init_planner_state(pparams or PlannerParams(), batch, dtype,
                                                device)
    return RolloutCarry(
        sim=world.init_sim_state(model, base_p.contiguous(), q.contiguous()),
        wbc=wbc.init_carry(batch, dtype, device),
        planner=planner_state,
        ref=wbc.Reference.standing(cparams, batch, dtype, device),
    )


def _loop(planner_fn, planner_ratio, carry: RolloutCarry, commands, scenario, control,
          sim_model: RobotModel, sparams: world.SimParams, freeze: bool, mark):
    """T control steps: the planner ticks every `planner_ratio` steps and
    its references are held where it did not publish; `control(obs, ref,
    wbc_carry, ref_is_new)` -> (out, wbc_carry) is the control step; the
    simulator advances every scenario one control period with `sim_model`.
    With `freeze`, a scenario that fell is frozen and its torque and KKT
    residual are recorded as 0 from then on."""
    B, T = commands.shape[0], commands.shape[1]
    device = commands.device
    friction = scenario.sim_friction if scenario is not None else None
    alive = torch.ones(B, dtype=torch.bool, device=device)
    no_tick = torch.zeros(B, dtype=torch.bool, device=device)
    rows = []
    for k in range(T):
        if mark is not None:
            mark(k, "planner")
        cmd = commands[:, k]
        if k % planner_ratio == 0:
            pstate, new_ref, ref_is_new = planner_fn(carry.planner, cmd)
            ref = tree_where(ref_is_new, new_ref, carry.ref)
        else:
            pstate, ref, ref_is_new = carry.planner, carry.ref, no_tick

        if mark is not None:
            mark(k, "control")
        out, wcarry = control(world.observe(carry.sim), ref, carry.wbc, ref_is_new)

        if mark is not None:
            mark(k, "sim")
        push = scenario.push_wrench[:, k] if scenario is not None else None
        sim = world.sim_control_period(sim_model, carry.sim, out.tau, sparams, friction, push)
        tau, kkt = out.tau, out.qp_info.kkt_residual
        if freeze:
            finite = torch.isfinite(sim.u).all(-1) & torch.isfinite(sim.base_p).all(-1)
            com_z = out.com_pos[:, 2]
            sane = (com_z > 0.2) & (com_z < 2.0) & (sim.u.abs().amax(-1) < 50.0)
            alive = alive & sane & finite
            tau, kkt = torch.where(alive[:, None], tau, 0.0), torch.where(alive, kkt, 0.0)
            sim, wcarry = tree_where(alive, sim, carry.sim), tree_where(alive, wcarry, carry.wbc)
        rows.append(RolloutTrace(
            com_pos=out.com_pos, com_pose=out.com_pose, base_p=carry.sim.base_p,
            q=carry.sim.q, tau=tau, grf=out.grf, foot_pos=out.foot_pos,
            ref_com_pose=ref.com_pose, ref_swing_pos=ref.swing_pos, contacts=ref.contacts,
            qp_kkt=kkt))
        carry = RolloutCarry(sim=sim, wbc=wcarry, planner=pstate, ref=ref)
        if mark is not None:
            mark(k, "end")
    trace = RolloutTrace(*(torch.stack(leaf, dim=1) for leaf in zip(*rows)))
    return carry, trace


def batched_rollout(
    model: RobotModel,
    cparams: ControllerParams,
    qparams: QPSolverParams,
    sparams: world.SimParams,
    planner_fn: Callable,     # (state, cmd (B, 3)) -> (state, Reference, published (B,))
    planner_ratio: int,       # control steps per planner tick
    carry: RolloutCarry,
    commands,                 # (B, T, 3) [vx, vy, yaw_rate] per control step
    scenario=None,            # sim.scenario.Scenario or None
    sim_model: RobotModel | None = None,
    mark: Callable[[int, str], None] | None = None,
    qp_backend: str = "kernel",
):
    """T control steps of the batch, the QPs solved batch-wide each step
    (`control.wbc.wbc_step_batched` with a carried cache; `qp_backend`
    "kernel": the kernel setup and solver, "torch": the tensor-code setup
    and solver with the batch-level rescue).  Returns (carry, trace) with
    trace leaves (B, T, ...).

    A scenario that falls (CoM below 0.2 m or above 2 m, a speed above 50)
    or whose state is no longer finite is frozen where it stands, so it
    cannot poison the batch.  The controller uses the nominal `model`; the
    physics runs `sim_model` if given (a model mismatch: one model shared by
    the batch, or one payload model per scenario from
    `scenario.apply_payload`).  `mark(k, stage)`, if given, is called at the
    start of control step k's stages "planner", "control", "sim" and at its
    "end" (for timing; it must not change the state).

    Gradients: with qp_backend="torch" the loop runs in the caller's grad
    mode (the JAX package's `batched_rollout(qp_backend="xla")` carries a
    gradient); with "kernel" an input that requires grad (a tensor gain of
    `cparams`, the carry) raises before the first launch, as the JAX
    package's Pallas path has no reverse mode."""
    cache = make_cache(commands.shape[0], QP_NUM_VARS, QP_NUM_CONSTRAINTS, qparams,
                       commands.dtype, commands.device)
    cache_valid = False

    def control(obs, ref, wcarry, ref_is_new):
        nonlocal cache, cache_valid
        out, wcarry, cache = wbc.wbc_step_batched(
            model, cparams, qparams, obs, ref, wcarry, ref_is_new, qp_backend, cache,
            cache_valid)
        cache_valid = True
        return out, wcarry

    return _loop(planner_fn, planner_ratio, carry, commands, scenario, control,
                 model if sim_model is None else sim_model, sparams, True, mark)


def rollout(
    model: RobotModel,
    cparams: ControllerParams,
    qparams: QPSolverParams,
    sparams: world.SimParams,
    planner_fn: Callable,     # (state, cmd (B, 3)) -> (state, Reference, published (B,))
    planner_ratio: int,       # control steps per planner tick
    carry: RolloutCarry,
    commands,                 # (B, T, 3) [vx, vy, yaw_rate] per control step
    scenario=None,            # sim.scenario.Scenario or None
    sim_model: RobotModel | None = None,
    mark: Callable[[int, str], None] | None = None,
):
    """T control steps of each scenario as the single robot runs them
    (the JAX package's `rollout`; its result equals that function under
    `vmap`, and B = 1 is the single robot): the control step is
    `control.wbc.wbc_step` (tensor code, the single-sample solve), and
    nothing is frozen: a scenario that falls keeps running and its torques
    and KKT residuals are recorded as they come.  The controller uses the
    nominal `model`; `sim_model` (e.g. with a payload,
    `scenario.apply_payload`; shared by the batch or one per scenario)
    simulates a model mismatch.
    Returns (carry, trace) with trace leaves (B, T, ...); `mark` as in
    `batched_rollout`.  Runs in the caller's grad mode: a gain of
    `cparams` may be a 0-d tensor that requires grad, and the gradient
    flows through the control steps and the simulator as `jax.grad` flows
    through the JAX function."""
    def control(obs, ref, wcarry, ref_is_new):
        return wbc.wbc_step(model, cparams, qparams, obs, ref, wcarry, ref_is_new)

    return _loop(planner_fn, planner_ratio, carry, commands, scenario, control,
                 model if sim_model is None else sim_model, sparams, False, mark)


def closed_loop_rollout(model: RobotModel, cparams: ControllerParams, pparams: PlannerParams,
                        qparams: QPSolverParams, sparams: world.SimParams, carry: RolloutCarry,
                        commands, scenario=None, sim_model: RobotModel | None = None,
                        mark: Callable[[int, str], None] | None = None):
    """`rollout` with the static-walk planner (the reference's
    configuration), ticked every round(loop_rate * planner dt) control
    steps."""
    ratio = int(round(cparams.loop_rate * pparams.dt))
    return rollout(model, cparams, qparams, sparams,
                   lambda s, c: gait.planner_step(pparams, s, c), ratio, carry, commands,
                   scenario, sim_model, mark)


def trot_rollout(model: RobotModel, cparams: ControllerParams, tparams: trot.TrotParams,
                 qparams: QPSolverParams, sparams: world.SimParams, carry: RolloutCarry,
                 commands, scenario=None, sim_model: RobotModel | None = None,
                 mark: Callable[[int, str], None] | None = None):
    """`rollout` with the trot planner, ticked every
    max(1, round(loop_rate * trot dt)) control steps (every step by
    default); `carry` must hold a trot state (`trot.init_trot_state`)."""
    ratio = max(1, int(round(cparams.loop_rate * tparams.dt)))
    return rollout(model, cparams, qparams, sparams,
                   lambda s, c: trot.trot_step(tparams, s, c), ratio, carry, commands,
                   scenario, sim_model, mark)
