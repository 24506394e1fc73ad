"""(The benchmark's reference: a frozen copy of the port's `planner/gait.py`.)

Static-walk gait / reference generator, batched.

The reference motion planner (cubic Bezier swing-foot splines with quintic
time scaling, a linear body path, the LH -> RH -> LF -> RF step cycle) as a
per-tick state machine over a batch of independent gaits: one call is one
100 Hz planner period of every scenario, including the reference's
non-publishing ticks (a phase transition consumes one tick, the cycle
boundary one more), so the reference's message timing is reproduced.

The three modes, and the branches inside them, are computed for the whole
batch and selected per scenario with `torch.where`: never a host branch on
a per-scenario value.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from benchmark.reference.wbc import Reference

# modes
IDLE = 0       # standing still (publishes the stand reference)
WALKING = 1    # inside a 4-phase cycle
CYCLE_GAP = 2  # the outer-loop tick between cycles (no publish)

# step phase -> swinging leg index in LH, LF, RF, RH order (phase order
# LH, RH, LF, RF)
PHASE_LEG = (0, 3, 1, 2)
# contact masks per phase
PHASE_CONTACTS = (
    (0.0, 1.0, 1.0, 1.0),
    (1.0, 1.0, 1.0, 0.0),
    (1.0, 0.0, 1.0, 1.0),
    (1.0, 1.0, 0.0, 1.0),
)


@dataclasses.dataclass(frozen=True)
class PlannerParams:
    """Static-walk gait parameters (the port's `config.PlannerParams`)."""

    step_length: float = 0.1
    height_control_point: float = 0.1
    x_offset: float = 0.50
    y_offset: float = 0.33
    step_duration: float = 0.2
    body_height: float = 0.50
    body_final_velocity: float = 0.40
    dt: float = 0.01

    @property
    def cycle_duration(self) -> float:
        return 4.0 * self.step_duration


class PlannerState(NamedTuple):
    mode: torch.Tensor           # (B,) int32
    phase: torch.Tensor          # (B,) int32 0..3
    step_ticks: torch.Tensor     # (B,) int32 publishes so far in this phase
    cycle_ticks: torch.Tensor    # (B,) int32 publishes so far in this cycle
    cycle_counter: torch.Tensor  # (B,) int32
    yaw: torch.Tensor            # (B,)
    v_rot: torch.Tensor          # (B, 3) rotated velocity captured at cycle start
    pi_body: torch.Tensor        # (B, 3)
    pf_body: torch.Tensor        # (B, 3)
    pi_foot: torch.Tensor        # (B, 4, 3) LH, LF, RF, RH
    pf_foot: torch.Tensor        # (B, 4, 3)
    ref: Reference               # the persistent message contents


def tree_where(mask, new, old):
    """Per-scenario select between two (nested) tuples of (B, ...) tensors:
    `new` where the (B,) bool mask is set, `old` elsewhere."""
    if isinstance(new, tuple):
        return type(new)(*(tree_where(mask, n, o) for n, o in zip(new, old)))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _quintic(T, vi, vf, like):
    """Coefficients (a0..a5) of the reference's quintic time scaling
    s(0) = 0, s(T) = 1, s'(0) = vi, s'(T) = vf, s''(0) = s''(T) = 0."""
    T = torch.tensor(T, dtype=like.dtype, device=like.device)
    a3 = (10.0 - 4.0 * vf * T - 6.0 * vi * T) / T**3
    a4 = (-15.0 + 7.0 * vf * T + 8.0 * vi * T) / T**4
    a5 = (6.0 - 3.0 * vf * T - 3.0 * vi * T) / T**5
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    return zero, zero + vi, zero, a3, a4, a5


def _quintic_eval(coeffs, t):
    a0, a1, a2, a3, a4, a5 = coeffs
    s = a0 + a1 * t + a2 * t**2 + a3 * t**3 + a4 * t**4 + a5 * t**5
    sd = a1 + 2 * a2 * t + 3 * a3 * t**2 + 4 * a4 * t**3 + 5 * a5 * t**4
    sdd = 2 * a2 + 6 * a3 * t + 12 * a4 * t**2 + 20 * a5 * t**3
    return s, sd, sdd


def _bezier(s, pi, pf, h):
    """Cubic Bezier with control points (pi, pi + h z, pf + h z, pf) and its
    s-derivatives; pi, pf (..., 3), s broadcast against them."""
    vert = torch.zeros_like(pi)
    vert[..., 2] = h
    p0, p1, p2, p3 = pi, pi + vert, pf + vert, pf
    om = 1.0 - s
    pos = om**3 * p0 + 3 * om**2 * s * p1 + 3 * om * s**2 * p2 + s**3 * p3
    d1 = 3.0 * (om**2 * (p1 - p0) + 2 * om * s * (p2 - p1) + s**2 * (p3 - p2))
    d2 = 6.0 * (om * (p2 - 2 * p1 + p0) + s * (p3 - 2 * p2 + p1))
    return pos, d1, d2


def _rotz(a):
    """(B,) yaw -> (B, 3, 3)."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _planar(cmd, like):
    """(B, 3) [vx, vy, 0] of a (B, 3) command [vx, vy, yaw_rate]."""
    cmd = cmd.to(like.dtype)
    return torch.stack([cmd[:, 0], cmd[:, 1], torch.zeros_like(cmd[:, 0])], -1)


def init_planner_state(params: PlannerParams, batch: int, dtype=torch.float32,
                       device="cuda") -> PlannerState:
    """Initial state of every scenario (the reference planner's constructor)."""
    kw = dict(dtype=dtype, device=device)
    pi_body = torch.tensor([0.0, 0.0, params.body_height], **kw)
    x, y = params.x_offset, params.y_offset
    lh = torch.tensor([-x, y, 0.0], **kw)
    feet = torch.stack([lh, lh + torch.tensor([2 * x, 0.0, 0.0], **kw),
                        lh + torch.tensor([2 * x, -2 * y, 0.0], **kw),
                        lh + torch.tensor([0.0, -2 * y, 0.0], **kw)])
    rep = lambda t: t.expand((batch,) + t.shape).clone()
    z = lambda *s: torch.zeros((batch,) + s, **kw)
    ref = Reference(
        com_pose=rep(torch.tensor([0, 0, params.body_height, 0, 0, 0], **kw)),
        com_vel=z(6), com_acc=z(6), swing_pos=z(12), swing_vel=z(12), swing_acc=z(12),
        contacts=torch.ones((batch, 4), **kw))
    i32 = lambda v: torch.full((batch,), v, dtype=torch.int32, device=device)
    return PlannerState(
        mode=i32(IDLE), phase=i32(0), step_ticks=i32(0), cycle_ticks=i32(0),
        cycle_counter=i32(0), yaw=z(), v_rot=z(3), pi_body=rep(pi_body),
        pf_body=rep(pi_body), pi_foot=rep(feet), pf_foot=rep(feet), ref=ref)


def _cycle_start(state: PlannerState, cmd, params: PlannerParams) -> PlannerState:
    """Beginning-of-cycle foot-target advance."""
    v_rot = _mv(_rotz(state.yaw), _planar(cmd, state.yaw))
    rot_d = _rotz(cmd[:, 2].to(state.yaw.dtype) * params.cycle_duration)
    flat = torch.tensor([1.0, 1.0, 0.0], dtype=state.yaw.dtype, device=state.yaw.device)
    vec = (state.pi_foot - state.pi_body[:, None, :]) * flat
    direction_new = torch.einsum("bij,bfj->bfi", rot_d, vec) - vec
    pf_foot = state.pf_foot + v_rot[:, None, :] * params.step_length + direction_new
    zero = torch.zeros_like(state.phase)
    return state._replace(v_rot=v_rot, pf_foot=pf_foot, phase=zero, step_ticks=zero,
                          cycle_ticks=zero, mode=zero + WALKING)


def _publish_tick(state: PlannerState, cmd, params: PlannerParams) -> PlannerState:
    """One publishing tick inside a step phase."""
    like = state.yaw
    B = like.shape[0]
    t_step = state.step_ticks.to(like.dtype) * params.dt
    t_cycle = state.cycle_ticks.to(like.dtype) * params.dt

    s, sd, sdd = _quintic_eval(_quintic(params.step_duration, 0.0, 0.0, like), t_step)
    s, sd, sdd = s[:, None, None], sd[:, None, None], sdd[:, None, None]
    # all four Bezier curves; only the active leg's slots update
    pos, d1, d2 = _bezier(s, state.pi_foot, state.pf_foot, params.height_control_point)
    vel = d1 * sd
    acc = d2 * sd * sd + d1 * sdd

    phase = state.phase.long()
    leg = torch.tensor(PHASE_LEG, device=like.device)[phase]
    m12 = (torch.arange(4, device=like.device)[None, :] == leg[:, None]).repeat_interleave(3, 1)
    swing_pos = torch.where(m12, pos.reshape(B, 12), state.ref.swing_pos)
    swing_vel = torch.where(m12, vel.reshape(B, 12), state.ref.swing_vel)
    swing_acc = torch.where(m12, acc.reshape(B, 12), state.ref.swing_acc)
    contacts = torch.tensor(PHASE_CONTACTS, dtype=like.dtype, device=like.device)[phase]

    # body reference: the first cycle starts from rest
    start = _quintic_eval(_quintic(params.cycle_duration, 0.0, params.body_final_velocity,
                                   like), t_cycle)
    cont = _quintic_eval(_quintic(params.cycle_duration, params.body_final_velocity,
                                  params.body_final_velocity, like), t_cycle)
    first = state.cycle_counter == 0
    sb, sbd, sbdd = (torch.where(first, a, b)[:, None] for a, b in zip(start, cont))
    seg = state.pf_body - state.pi_body
    yaw_rate = cmd[:, 2].to(like.dtype)
    z = lambda k: torch.zeros((B, k), dtype=like.dtype, device=like.device)
    ref = Reference(
        com_pose=torch.cat([state.pi_body + sb * seg, z(2), state.yaw[:, None]], -1),
        com_vel=torch.cat([seg * sbd, z(2), yaw_rate[:, None]], -1),
        com_acc=torch.cat([seg * sbdd, z(3)], -1),
        swing_pos=swing_pos, swing_vel=swing_vel, swing_acc=swing_acc, contacts=contacts)
    return state._replace(ref=ref, yaw=state.yaw + yaw_rate * params.dt,
                          step_ticks=state.step_ticks + 1, cycle_ticks=state.cycle_ticks + 1)


def _transition_tick(state: PlannerState, params: PlannerParams) -> PlannerState:
    """Non-publishing phase-advance tick, and the cycle's end after the
    fourth phase."""
    phase = state.phase + 1
    done = phase >= 4
    zero = torch.zeros_like(phase)
    st = state._replace(phase=torch.where(done, state.phase, phase), step_ticks=zero)
    ended = st._replace(
        cycle_counter=st.cycle_counter + 1, phase=zero, cycle_ticks=zero,
        pi_body=st.pf_body, pf_body=st.pf_body + st.v_rot * params.step_length,
        pi_foot=st.pf_foot, mode=zero + CYCLE_GAP)
    return tree_where(done, ended, st)


def planner_step(params: PlannerParams, state: PlannerState, cmd):
    """One 100 Hz planner tick of every scenario.

    cmd: (B, 3) [vx, vy, yaw_rate].  Returns (new_state, Reference,
    published (B,) bool): whether the reference node emitted a message
    this tick."""
    B = cmd.shape[0]
    true = torch.ones(B, dtype=torch.bool, device=cmd.device)
    # IDLE: start a cycle on a non-zero command, else publish the stand
    active = (cmd != 0.0).any(-1)
    start = _publish_tick(_cycle_start(state, cmd, params), cmd, params)
    stand = state._replace(ref=state.ref._replace(contacts=torch.ones_like(state.ref.contacts)))
    idle = tree_where(active, start, stand)
    # WALKING: publish inside a phase, else the transition tick
    publishing = state.step_ticks < int(round(params.step_duration / params.dt))
    walking = tree_where(publishing, _publish_tick(state, cmd, params),
                         _transition_tick(state, params))
    # CYCLE_GAP: no publish; the next tick starts a cycle or stands
    gap = state._replace(mode=torch.full_like(state.mode, IDLE))
    is_idle, is_walking = state.mode == IDLE, state.mode == WALKING
    new = tree_where(is_idle, idle, tree_where(is_walking, walking, gap))
    published = torch.where(is_idle, true, torch.where(is_walking, publishing, ~true))
    return new, new.ref, published
