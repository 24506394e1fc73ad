"""Closed loop of a batch of scenarios: planner -> control step -> physics.

The reference's process graph (motion planner node, controller node,
simulator) as one loop over control steps: the planner ticks every
`planner_ratio` control steps and its references are held in between (last
writer wins, the queue-size-1 semantics of the reference); the control step
solves the whole batch's QPs at once with a carried factorization cache;
the simulator advances every scenario one control period.

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
from quadrupedwholebodycontroller_tpu_torch.planner import gait
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


@torch.no_grad()
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
):
    """T control steps of the batch, the QPs solved batch-wide each step
    (`control.wbc.wbc_step_batched`, kernel setup and solver, with a carried
    cache).  Returns (carry, trace) with trace leaves (B, T, ...).

    A scenario that falls (CoM below 0.2 m or above 2 m, a speed above 50)
    or whose state is no longer finite is frozen where it stands, so it
    cannot poison the batch.  `mark(k, stage)`, if given, is called at the
    start of control step k's stages "planner", "control", "sim" and at its
    "end" (for timing; it must not change the state)."""
    if sim_model is not None:
        raise NotImplementedError(
            "sim_model (per-scenario payload models for the physics): the "
            "parallel-sweep slice of the port")
    B, T = commands.shape[0], commands.shape[1]
    dtype, device = commands.dtype, commands.device
    friction = scenario.sim_friction if scenario is not None else None
    cache = make_cache(B, QP_NUM_VARS, QP_NUM_CONSTRAINTS, qparams, dtype, device)
    cache_valid = False
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
        out, wcarry, cache = wbc.wbc_step_batched(
            model, cparams, qparams, world.observe(carry.sim), ref, carry.wbc, ref_is_new,
            "kernel", cache, cache_valid)
        cache_valid = True

        if mark is not None:
            mark(k, "sim")
        push = scenario.push_wrench[:, k] if scenario is not None else None
        sim = world.sim_control_period(model, carry.sim, out.tau, sparams, friction, push)
        finite = torch.isfinite(sim.u).all(-1) & torch.isfinite(sim.base_p).all(-1)
        com_z = out.com_pos[:, 2]
        sane = (com_z > 0.2) & (com_z < 2.0) & (sim.u.abs().amax(-1) < 50.0)
        alive = alive & sane & finite
        rows.append(RolloutTrace(
            com_pos=out.com_pos, com_pose=out.com_pose, base_p=carry.sim.base_p,
            q=carry.sim.q, tau=torch.where(alive[:, None], out.tau, 0.0), grf=out.grf,
            foot_pos=out.foot_pos, ref_com_pose=ref.com_pose, ref_swing_pos=ref.swing_pos,
            contacts=ref.contacts,
            qp_kkt=torch.where(alive, out.qp_info.kkt_residual, 0.0)))
        carry = RolloutCarry(sim=tree_where(alive, sim, carry.sim),
                             wbc=tree_where(alive, wcarry, carry.wbc),
                             planner=pstate, ref=ref)
        if mark is not None:
            mark(k, "end")
    trace = RolloutTrace(*(torch.stack(leaf, dim=1) for leaf in zip(*rows)))
    return carry, trace
