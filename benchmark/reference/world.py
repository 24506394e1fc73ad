"""(The benchmark's reference: a frozen copy of the port's `sim/world.py`.)

Physics of a batch of worlds: floating-base forward dynamics and ground
contact, the closed-loop scenario simulator.

The same rigid-body code the controller uses, run forward with a penalty
ground contact and a semi-implicit Euler integrator: `sim_control_period`
advances every scenario one control period in `substeps` physics steps, a
Python loop of batched tensor code.

Contact: per foot a spring-damper normal force, and anchored-spring
tangential friction: a foot in contact drags a tangential anchor point, the
spring to the anchor gives true static friction, and the anchor is
re-projected onto the friction cone while the foot slides (the ODE / Gazebo
stick-slip formulation).  A velocity-regularized Coulomb force is not used:
its effective damping would be far too stiff for an explicit integrator at
these steps.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from benchmark.reference.robot_model import RobotModel
from benchmark.reference import dynamics as D
from benchmark.reference import kinematics as K
from benchmark.reference import spatial
from benchmark.reference.wbc import NUM_JOINTS, RobotObservation


@dataclasses.dataclass(frozen=True)
class SimParams:
    substeps: int = 8              # physics substeps per control period
    control_dt: float = 1.0 / 400.0
    contact_stiffness: float = 40000.0     # N/m, normal penalty spring
    contact_damping: float = 1500.0        # N s/m, normal damper
    tangential_stiffness: float = 20000.0  # N/m, anchor spring
    tangential_damping: float = 300.0      # N s/m
    friction: float = 1.0          # the controller's default friction
    joint_damping: float = 0.1     # N m s/rad, actuator back-EMF proxy

    @property
    def dt(self) -> float:
        return self.control_dt / self.substeps


class SimState(NamedTuple):
    base_R: torch.Tensor  # (B, 3, 3)
    base_p: torch.Tensor  # (B, 3)
    q: torch.Tensor       # (B, 12)
    u: torch.Tensor       # (B, 18) mixed velocity [v_base; omega; qdot]
    anchor: torch.Tensor  # (B, 4, 2) tangential friction anchors (world xy)


def init_sim_state(model: RobotModel, base_p, q) -> SimState:
    """At rest with the base level: base_p (B, 3), q (B, 12); the friction
    anchors sit under the feet."""
    B = q.shape[0]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(B, 3, 3).contiguous()
    kin = K.forward_kinematics(model, eye, base_p, q)
    return SimState(base_R=eye, base_p=base_p, q=q,
                    u=torch.zeros((B, 6 + NUM_JOINTS), dtype=q.dtype, device=q.device),
                    anchor=kin.frame_p[..., :2].clone())


def observe(state: SimState) -> RobotObservation:
    """SimState -> RobotObservation (the model_states / joint_states feed);
    every tensor contiguous, as the setup kernel takes them."""
    return RobotObservation(base_R=state.base_R, base_p=state.base_p,
                            base_vel=state.u[:, :6].contiguous(), q=state.q,
                            qd=state.u[:, 6:].contiguous())


def _contact_forces(model, kin, u, anchor, params: SimParams, friction=None, J=None):
    """((B, 4, 3) world ground forces at the feet, (B, 4, 2) new anchors).
    friction: a (B,) tensor, or None for params.friction; J: the feet's
    frame Jacobians if the caller has them."""
    if friction is None:
        friction = params.friction
    elif torch.is_tensor(friction):
        friction = friction[:, None]
    if J is None:
        J = K.frame_jacobians(model, kin)
    foot_p = kin.frame_p                                       # (B, 4, 3)
    foot_v = torch.einsum("...fij,...j->...fi", J[..., :3, :], u)
    pen = -foot_p[..., 2]                 # penetration depth (> 0 below ground)
    in_contact = pen > 0.0
    fz = params.contact_stiffness * pen - params.contact_damping * foot_v[..., 2]
    fz = torch.where(in_contact, torch.clamp_min(fz, 0.0), torch.zeros_like(fz))

    xy = foot_p[..., :2]
    raw = -params.tangential_stiffness * (xy - anchor) \
        - params.tangential_damping * foot_v[..., :2]
    cap = friction * fz
    raw_norm = torch.sqrt(torch.sum(raw * raw, dim=-1) + 1e-12)
    # torch.minimum splits the gradient at a tie as jnp.minimum does (a
    # clamp gives it all to one side); the values are the clamp's
    scale = torch.minimum(torch.ones_like(raw_norm), cap / raw_norm)
    ft = raw * scale[..., None] * in_contact[..., None]
    # anchor update: out of contact it follows the foot; sliding, it is
    # re-projected so that the spring term alone equals the capped force
    slip_anchor = xy + (ft + params.tangential_damping * foot_v[..., :2]) \
        / params.tangential_stiffness
    new_anchor = torch.where(in_contact[..., None],
                             torch.where((scale < 1.0)[..., None], slip_anchor, anchor), xy)
    return torch.cat([ft, fz[..., None]], dim=-1), new_anchor


def _substep(model, state: SimState, tau, params: SimParams, friction=None,
             push_wrench=None) -> SimState:
    kin = K.forward_kinematics(model, state.base_R, state.base_p, state.q)
    J = K.frame_jacobians(model, kin)                          # (B, 4, 6, 18)
    f, anchor = _contact_forces(model, kin, state.u, state.anchor, params, friction, J)
    tau_contact = torch.einsum("bfij,bfi->bj", J[..., :3, :], f)
    # actuator saturation at the URDF effort limits, as the effort interface
    # of the reference's simulator clamps commands
    tau = torch.clamp(tau, -model.joint_effort, model.joint_effort)
    tau_gen = torch.cat([torch.zeros_like(state.u[:, :6]),
                         tau - params.joint_damping * state.u[:, 6:]], dim=-1)
    if push_wrench is not None:
        # an external wrench at the base origin: in mixed coordinates its
        # generalized force is the first six entries
        tau_gen = tau_gen + torch.cat([push_wrench, torch.zeros_like(tau)], dim=-1)
    udot = D.forward_dynamics(model, state.base_R, state.base_p, state.q, state.u,
                              tau_gen + tau_contact)
    # semi-implicit Euler: the velocity first, then the pose with the new u
    u_new = state.u + params.dt * udot
    Rdot, pdot, qdot = K.state_flow(state.base_R, state.base_p, state.q, u_new)
    return SimState(base_R=spatial.orthonormalize(state.base_R + params.dt * Rdot),
                    base_p=state.base_p + params.dt * pdot,
                    q=state.q + params.dt * qdot, u=u_new, anchor=anchor)


def sim_control_period(model: RobotModel, state: SimState, tau, params: SimParams,
                       friction=None, push_wrench=None) -> SimState:
    """Advance every scenario one control period under the zero-order-held
    torques tau (B, 12), in `params.substeps` physics steps.  friction (B,)
    and push_wrench (B, 6) are optional per-scenario perturbations, and the
    model may be one payload model per scenario (sim/scenario.py)."""
    for _ in range(params.substeps):
        state = _substep(model, state, tau, params, friction, push_wrench)
    return state
