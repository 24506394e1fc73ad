"""(The benchmark's reference: a frozen copy of the port's `planner/trot.py`.)

Trotting gait generator, batched: alternating diagonal-pair 2-contact
phases.

Built from the static walk's primitives (cubic Bezier swing splines with
quintic time scaling) as a two-beat gait:

  phase A: LF + RH swing  (legs 1, 3 in LH, LF, RF, RH order)
  phase B: LH + RF swing  (legs 0, 2)

with a Raibert-style foothold (the swing target leads the nominal hip
position by v T_step / 2, plus a yaw correction), and a body reference
that advances continuously at the commanded velocity.  Per-scenario
branches are `torch.where` selects over the batch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from benchmark.reference.wbc import Reference
from benchmark.reference.gait import (
    _bezier,
    _mv,
    _planar,
    _quintic,
    _quintic_eval,
    _rotz,
    tree_where,
)

# diagonal pairs: phase 0 swings (LF, RH); phase 1 swings (LH, RF)
PAIR_MASKS = (
    (1.0, 0.0, 1.0, 0.0),  # contacts during phase 0
    (0.0, 1.0, 0.0, 1.0),  # contacts during phase 1
)


@dataclasses.dataclass(frozen=True)
class TrotParams:
    step_duration: float = 0.25     # one swing phase
    height_control_point: float = 0.08
    x_offset: float = 0.36          # nominal foot x (tighter than the walk's stance)
    y_offset: float = 0.28
    body_height: float = 0.50
    dt: float = 0.0025              # the planner ticks at the control rate
    stand_ticks: int = 40           # initial double-stance settle ticks


class TrotState(NamedTuple):
    tick: torch.Tensor         # (B,) int32 global tick
    phase: torch.Tensor        # (B,) int32 0/1
    phase_tick: torch.Tensor   # (B,) int32 tick within the phase
    yaw: torch.Tensor          # (B,)
    body_xy: torch.Tensor      # (B, 2) integrated body position
    foot_ground: torch.Tensor  # (B, 4, 3) current stance location of each foot
    pi_foot: torch.Tensor      # (B, 4, 3) swing start points
    pf_foot: torch.Tensor      # (B, 4, 3) swing targets
    ref: Reference


def _nominal_feet(params: TrotParams, like):
    x, y = params.x_offset, params.y_offset
    return torch.tensor([[-x, y, 0.0], [x, y, 0.0], [x, -y, 0.0], [-x, -y, 0.0]],
                        dtype=like.dtype, device=like.device)   # LH, LF, RF, RH


def init_trot_state(params: TrotParams, batch: int, dtype=torch.float32,
                    device="cuda") -> TrotState:
    kw = dict(dtype=dtype, device=device)
    feet = _nominal_feet(params, torch.zeros((), **kw)).expand(batch, 4, 3).clone()
    z = lambda *s: torch.zeros((batch,) + s, **kw)
    pose = torch.tensor([0, 0, params.body_height, 0, 0, 0], **kw).expand(batch, 6).clone()
    ref = Reference(com_pose=pose, com_vel=z(6), com_acc=z(6),
                    swing_pos=feet.reshape(batch, 12).clone(), swing_vel=z(12),
                    swing_acc=z(12), contacts=torch.ones((batch, 4), **kw))
    i32 = lambda: torch.zeros(batch, dtype=torch.int32, device=device)
    return TrotState(tick=i32(), phase=i32(), phase_tick=i32(), yaw=z(), body_xy=z(2),
                     foot_ground=feet, pi_foot=feet.clone(), pf_foot=feet.clone(), ref=ref)


def trot_step(params: TrotParams, state: TrotState, cmd):
    """One planner tick of every scenario at params.dt.  cmd: (B, 3)
    [vx, vy, yaw_rate].  Returns (new_state, Reference, published): the
    trot publishes on every tick."""
    like = state.yaw
    B = like.shape[0]
    kw = dict(dtype=like.dtype, device=like.device)
    steps_per_phase = int(round(params.step_duration / params.dt))
    trotting = (cmd != 0.0).any(-1) & (state.tick >= params.stand_ticks)
    v_cmd = _planar(cmd, like)
    rot = _rotz(state.yaw)
    v_world = _mv(rot, v_cmd)
    yaw_rate = cmd[:, 2].to(like.dtype)
    pairs = torch.tensor(PAIR_MASKS, **kw)

    # ---- phase boundary: the pair that swung lands at its target; the new
    # swing pair starts from its ground position and aims at a Raibert
    # foothold around the predicted mid-stance body pose ----
    boundary = trotting & (state.phase_tick >= steps_per_phase)
    old_swing = 1.0 - pairs[state.phase.long()]
    ground = torch.where(old_swing[:, :, None] > 0, state.pf_foot, state.foot_ground)
    lead = v_world * params.step_duration
    body_next = torch.cat([state.body_xy + v_world[:, :2] * params.step_duration,
                           torch.zeros((B, 1), **kw)], -1)
    targets = (body_next[:, None, :] + torch.einsum("bij,fj->bfi", rot, _nominal_feet(params, like))
               + lead[:, None, :] * 0.5)
    targets[:, :, 2] = 0.0
    state = tree_where(boundary, state._replace(foot_ground=ground, pi_foot=ground,
                                                pf_foot=targets), state)
    phase = torch.where(boundary, 1 - state.phase, state.phase)
    phase_tick = torch.where(boundary, torch.zeros_like(state.phase_tick), state.phase_tick)

    # ---- swing trajectories ----
    s, sd, sdd = _quintic_eval(_quintic(params.step_duration, 0.0, 0.0, like),
                               phase_tick.to(like.dtype) * params.dt)
    s, sd, sdd = s[:, None, None], sd[:, None, None], sdd[:, None, None]
    pos, d1, d2 = _bezier(s, state.pi_foot, state.pf_foot, params.height_control_point)
    vel = d1 * sd
    acc = d2 * sd * sd + d1 * sdd

    contacts = torch.where(trotting[:, None], pairs[phase.long()], torch.ones((B, 4), **kw))
    swing = (1.0 - contacts).repeat_interleave(3, 1) > 0
    zero12 = torch.zeros((B, 12), **kw)
    swing_pos = torch.where(swing, pos.reshape(B, 12), state.ref.swing_pos)
    swing_vel = torch.where(swing, vel.reshape(B, 12), zero12)
    swing_acc = torch.where(swing, acc.reshape(B, 12), zero12)

    # ---- body reference: continuous velocity tracking ----
    body_xy = torch.where(trotting[:, None], state.body_xy + v_world[:, :2] * params.dt,
                          state.body_xy)
    yaw = torch.where(trotting, state.yaw + yaw_rate * params.dt, state.yaw)
    com_pose = torch.cat([body_xy, torch.full((B, 1), params.body_height, **kw),
                          torch.zeros((B, 2), **kw), yaw[:, None]], -1)
    com_vel = torch.where(
        trotting[:, None],
        torch.cat([v_world, torch.zeros((B, 2), **kw), yaw_rate[:, None]], -1),
        torch.zeros((B, 6), **kw))
    ref = Reference(com_pose=com_pose, com_vel=com_vel, com_acc=torch.zeros((B, 6), **kw),
                    swing_pos=swing_pos, swing_vel=swing_vel, swing_acc=swing_acc,
                    contacts=contacts)
    new_state = TrotState(
        tick=state.tick + 1, phase=phase,
        phase_tick=torch.where(trotting, phase_tick + 1, phase_tick),
        yaw=yaw, body_xy=body_xy, foot_ground=state.foot_ground,
        pi_foot=state.pi_foot, pf_foot=state.pf_foot, ref=ref)
    return new_state, ref, torch.ones(B, dtype=torch.bool, device=like.device)
