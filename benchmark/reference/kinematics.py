"""(The benchmark's reference: a frozen copy of the port's `ops/kinematics.py`.)

Floating-base forward kinematics and geometric Jacobians, batched.

Every function takes tensors with arbitrary leading batch dimensions
(written `...` below; the control cycle uses one, the scenario batch).  The
model's mass, com and inertia may carry the scenario axis too (one payload
model per scenario, `RobotModel.per_scenario`): their contractions then keep
it (`model_axes`), and the shared model's keep their own operations.

Conventions (iDynTree MIXED representation, as the reference uses it):
  * generalized velocity u = [v_base_world (3); omega_world (3); qdot (nj)]
  * a frame Jacobian maps u -> [v_frame_origin_world; omega_frame_world]

The tree is processed by depth level (all four hips in one op, then thighs,
then shanks); tree topology is static Python, resolved while the ops are
issued.  Every Jacobian is one masked cross product over all joints and
all target points at once.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.robot_model import RobotModel
from benchmark.reference import spatial


class KinState(NamedTuple):
    """World-frame kinematic quantities of a batch of configurations."""

    body_R: torch.Tensor        # (..., nb, 3, 3)
    body_p: torch.Tensor        # (..., nb, 3)   body frame origins
    body_com_w: torch.Tensor    # (..., nb, 3)   body CoM positions
    joint_axis_w: torch.Tensor  # (..., nj, 3)   world joint axes
    joint_origin_w: torch.Tensor  # (..., nj, 3) world joint origins
    frame_R: torch.Tensor       # (..., nf, 3, 3)
    frame_p: torch.Tensor       # (..., nf, 3)


@lru_cache(maxsize=None)
def _levels(parent: tuple) -> tuple:
    """Static depth-level schedule: tuple of (body_indices, parent_indices)."""
    nb = len(parent)
    depth = [0] * nb
    for b in range(1, nb):
        depth[b] = depth[parent[b]] + 1
    out = []
    for d in range(1, max(depth) + 1):
        bodies = tuple(b for b in range(1, nb) if depth[b] == d)
        parents = tuple(parent[b] for b in bodies)
        out.append((bodies, parents))
    return tuple(out)


def model_axes(model: RobotModel) -> str:
    """The einsum prefix of the mass, com and inertia leaves: "" for a
    shared model, "..." for one model per scenario."""
    return "..." if model.per_scenario else ""


def forward_kinematics(model: RobotModel, base_R, base_p, q) -> KinState:
    """FK over the whole tree, one batched op-set per depth level.

    base_R: (..., 3, 3), base_p: (..., 3), q: (..., nj)."""
    nb = model.num_bodies
    R_list = [None] * nb
    p_list = [None] * nb
    R_list[0] = base_R
    p_list[0] = base_p
    axis_w_list = [None] * (nb - 1)
    org_w_list = [None] * (nb - 1)

    for bodies, parents in _levels(model.parent):
        jidx = [b - 1 for b in bodies]
        Rp = torch.stack([R_list[p] for p in parents], dim=-3)   # (..., L, 3, 3)
        pp = torch.stack([p_list[p] for p in parents], dim=-2)   # (..., L, 3)
        jR = model.joint_R[jidx]
        jp = model.joint_p[jidx]
        ax = model.joint_axis[jidx]
        R_jf = Rp @ jR                                            # joint frames, world
        p_j = pp + torch.einsum("...lij,lj->...li", Rp, jp)
        ax_w = torch.einsum("...lij,lj->...li", R_jf, ax)
        R_b = R_jf @ spatial.axis_angle_to_matrix(ax, q[..., jidx])
        for i, b in enumerate(bodies):
            R_list[b] = R_b[..., i, :, :]
            p_list[b] = p_j[..., i, :]
            axis_w_list[b - 1] = ax_w[..., i, :]
            org_w_list[b - 1] = p_j[..., i, :]

    body_R = torch.stack(R_list, dim=-3)
    body_p = torch.stack(p_list, dim=-2)
    body_com_w = body_p + torch.einsum(f"...bij,{model_axes(model)}bj->...bi", body_R,
                                       model.com)
    fb = list(model.frame_body)
    frame_R = body_R[..., fb, :, :] @ model.frame_R
    frame_p = body_p[..., fb, :] + torch.einsum(
        "...fij,fj->...fi", body_R[..., fb, :, :], model.frame_p
    )
    return KinState(
        body_R=body_R,
        body_p=body_p,
        body_com_w=body_com_w,
        joint_axis_w=torch.stack(axis_w_list, dim=-2),
        joint_origin_w=torch.stack(org_w_list, dim=-2),
        frame_R=frame_R,
        frame_p=frame_p,
    )


@lru_cache(maxsize=None)
def _ancestor_mask_np(parent: tuple):
    nb, nj = len(parent), len(parent) - 1
    mask = np.zeros((nb, nj))
    for b in range(1, nb):
        mask[b] = mask[parent[b]].copy()
        mask[b, b - 1] = 1.0
    return mask


def _point_mask(model: RobotModel, point_bodies, like: torch.Tensor):
    return torch.as_tensor(
        _ancestor_mask_np(model.parent)[list(point_bodies)],
        dtype=like.dtype, device=like.device,
    )  # (np, nj)


def point_jacobians(model: RobotModel, kin: KinState, points, point_bodies):
    """Mixed Jacobians (..., np, 6, nv) of world points attached to bodies.

    points: (..., np, 3); point_bodies: static tuple of owning body indices."""
    mask = _point_mask(model, point_bodies, points)
    axis = kin.joint_axis_w[..., None, :, :]                        # (..., 1, nj, 3)
    rel = points[..., :, None, :] - kin.joint_origin_w[..., None, :, :]
    jv = torch.linalg.cross(axis.expand_as(rel), rel) * mask[..., None]
    jw = axis.expand_as(rel) * mask[..., None]

    eye3 = torch.eye(3, dtype=points.dtype, device=points.device).expand(
        points.shape[:-1] + (3, 3)
    )
    zero3 = torch.zeros_like(eye3)
    Jv = torch.cat(
        [eye3, -spatial.skew(points - kin.body_p[..., 0:1, :]),
         jv.transpose(-1, -2)], dim=-1,
    )  # (..., np, 3, nv)
    Jw = torch.cat([zero3, eye3, jw.transpose(-1, -2)], dim=-1)
    return torch.cat([Jv, Jw], dim=-2)


class JacobianParts(NamedTuple):
    """The information content of the body-CoM Jacobian stack without the
    (nb, 6, nv) materialization: the mixed Jacobian of body b's CoM is

        Jv_b = [ I3 | -skew(r_b) | jq_b ],   Jw_b = [ 0 | I3 | jw_b ]

    so every J-contraction (velocities, mass matrix, bias projection) is
    assembled block-wise from these parts."""

    r: torch.Tensor    # (..., np, 3)      point - base origin
    jq: torch.Tensor   # (..., np, nj, 3)  translational joint columns (masked)
    jw: torch.Tensor   # (..., np, nj, 3)  rotational joint columns (masked)


def jacobian_parts(model: RobotModel, kin: KinState, points,
                   point_bodies) -> JacobianParts:
    """Jacobian parts of world points attached to bodies (same masked
    cross products as point_jacobians, no assembly)."""
    mask = _point_mask(model, point_bodies, points)
    axis = kin.joint_axis_w[..., None, :, :]
    rel = points[..., :, None, :] - kin.joint_origin_w[..., None, :, :]
    jq = torch.linalg.cross(axis.expand_as(rel), rel) * mask[..., None]
    jw = axis * mask[..., None]
    return JacobianParts(r=points - kin.body_p[..., 0:1, :], jq=jq, jw=jw)


def body_com_jacobian_parts(model: RobotModel, kin: KinState) -> JacobianParts:
    return jacobian_parts(
        model, kin, kin.body_com_w, tuple(range(model.num_bodies))
    )


def parts_velocities(parts: JacobianParts, u):
    """(v (..., np, 3), w (..., np, 3)) point linear / body angular
    velocities from Jacobian parts:
    v = v_base + omega x r + jq qdot, w = omega + jw qdot."""
    qd = u[..., 6:]
    omega = u[..., None, 3:6]
    v = (
        u[..., None, 0:3]
        + torch.linalg.cross(omega.expand_as(parts.r), parts.r)
        + torch.einsum("...pja,...j->...pa", parts.jq, qd)
    )
    w = omega + torch.einsum("...pja,...j->...pa", parts.jw, qd)
    return v, w


def frame_jacobians(model: RobotModel, kin: KinState):
    """(..., nf, 6, nv) mixed Jacobians of the named frames (iDynTree
    getFrameFreeFloatingJacobian in MIXED representation)."""
    return point_jacobians(model, kin, kin.frame_p, model.frame_body)


def robot_com(model: RobotModel, kin: KinState):
    """(..., 3) total CoM."""
    return torch.einsum(f"{model_axes(model)}b,...bi->...i", model.mass,
                        kin.body_com_w) / model.total_mass[..., None]


def state_flow(base_R, base_p, q, u):
    """Time derivative of the configuration (base_R, base_p, q) under the
    mixed velocity u: (Rdot, pdot, qdot) with Rdot = skew(omega_world) R."""
    return spatial.skew(u[..., 3:6]) @ base_R, u[..., 0:3], u[..., 6:]
