"""(The benchmark's reference: a frozen copy of the port's `ops/dynamics.py`.)

Floating-base rigid-body dynamics, batched: mass matrix, Coriolis bias,
gravity force, energies and forward dynamics.

  * M(q) = sum_b m_b Jv_b^T Jv_b + Jw_b^T I_b^w Jw_b over the lumped bodies,
    block-assembled from Jacobian parts.
  * Coriolis bias by virtual work in the world frame:
        h_C = sum_b Jv_b^T (m_b a_b) + Jw_b^T (I_b^w alpha_b + w_b x I_b^w w_b)
    with the velocity-product accelerations (u_dot = 0) from a closed-form
    level recursion.

Leading batch dimensions are written `...`; mass, com and inertia may carry
the scenario axis too (`K.model_axes`).
"""
from __future__ import annotations

import torch

from benchmark.reference.robot_model import RobotModel
from benchmark.reference import kinematics as K
from benchmark.reference.spatial import skew

_cross = torch.linalg.cross


def world_inertias(model: RobotModel, kin: K.KinState):
    """(..., nb, 3, 3) body inertias about their CoM in world axes."""
    return torch.einsum(
        f"...bij,{K.model_axes(model)}bjk,...blk->...bil", kin.body_R, model.inertia,
        kin.body_R
    )


def mass_matrix_from_parts(model: RobotModel, kin: K.KinState,
                           parts: K.JacobianParts):
    """Block assembly of M = sum_b m_b Jv^T Jv + Jw^T Iw Jw with

        Jv_b = [I | -S(r_b) | jq_b],  Jw_b = [0 | I | jw_b]:

      M[0:3,0:3] = m_tot I
      M[0:3,3:6] = -S(sum m_b r_b)
      M[0:3,6:]  = sum m_b jq_b
      M[3:6,3:6] = sum m_b (|r|^2 I - r r^T) + sum Iw_b
      M[3:6,6:]  = sum m_b r_b x jq_b + sum Iw_b jw_b
      M[6:,6:]   = sum m_b jq^T jq + jw^T Iw jw
    """
    m, b = model.mass, K.model_axes(model) + "b"
    r, jq, jw = parts.r, parts.jq, parts.jw
    Iw = world_inertias(model, kin)
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)

    top_mid = -skew(torch.einsum(f"{b},...ba->...a", m, r))
    top_right = torch.einsum(f"{b},...bja->...aj", m, jq)           # (..., 3, nj)
    rot = (
        torch.einsum(f"{b},...b->...", m, torch.sum(r * r, dim=-1))[..., None, None] * eye3
        - torch.einsum(f"{b},...ba,...bc->...ac", m, r, r)
        + torch.sum(Iw, dim=-3)
    )
    rxjq = _cross(r[..., :, None, :].expand_as(jq), jq)             # (..., nb, nj, 3)
    mid_right = (
        torch.einsum(f"{b},...bja->...aj", m, rxjq)
        + torch.einsum("...bac,...bjc->...aj", Iw, jw)
    )
    jj = torch.einsum(f"{b},...bja,...bka->...jk", m, jq, jq) + torch.einsum(
        "...bja,...bac,...bkc->...jk", jw, Iw, jw
    )
    top = torch.cat(
        [(model.total_mass[..., None, None] * eye3).expand_as(top_mid), top_mid, top_right],
        dim=-1
    )
    mid = torch.cat([top_mid.transpose(-1, -2), rot, mid_right], dim=-1)
    bot = torch.cat(
        [top_right.transpose(-1, -2), mid_right.transpose(-1, -2), jj], dim=-1
    )
    return torch.cat([top, mid, bot], dim=-2)


def project_forces_from_parts(parts: K.JacobianParts, F, N):
    """h = sum_b Jv_b^T F_b + Jw_b^T N_b assembled block-wise:

        h[0:3] = sum F,  h[3:6] = sum r x F + sum N,
        h[6:]  = sum jq^T F + jw^T N.
    """
    h_lin = torch.sum(F, dim=-2)
    h_ang = torch.sum(_cross(parts.r, F), dim=-2) + torch.sum(N, dim=-2)
    h_j = torch.einsum("...bja,...ba->...j", parts.jq, F) + torch.einsum(
        "...bja,...ba->...j", parts.jw, N
    )
    return torch.cat([h_lin, h_ang, h_j], dim=-1)


def velocity_product_kinematics(model: RobotModel, kin: K.KinState, u):
    """Per-body angular velocity, angular acceleration, and CoM linear
    acceleration under u_dot = 0 (velocity-product terms only).

    Per level, with the child body origin a material point of the parent
    and the joint axis fixed in the parent frame:

        w_c     = w_p + qdot a_w
        alpha_c = alpha_p + qdot (w_p x a_w)
        a_oc    = a_op + alpha_p x r + w_p x (w_p x r),  r = p_c - p_p

    and per body CoM (d = c_w - p_b):

        a_com = a_o + alpha x d + w x (w x d).

    In the MIXED representation the base seeds are w = u[3:6],
    alpha = a_o = 0.  Returns (w, alpha, a_com), each (..., nb, 3)."""
    nb = model.num_bodies
    zero3 = torch.zeros_like(u[..., 3:6])
    w_list = [None] * nb
    al_list = [None] * nb
    ao_list = [None] * nb
    w_list[0] = u[..., 3:6]
    al_list[0] = zero3
    ao_list[0] = zero3
    qd = u[..., 6:]

    for bodies, parents in K._levels(model.parent):
        jidx = [b - 1 for b in bodies]
        bidx = list(bodies)
        pidx = list(parents)
        wp = torch.stack([w_list[p] for p in parents], dim=-2)      # (..., L, 3)
        alp = torch.stack([al_list[p] for p in parents], dim=-2)
        aop = torch.stack([ao_list[p] for p in parents], dim=-2)
        r = kin.body_p[..., bidx, :] - kin.body_p[..., pidx, :]
        ax = kin.joint_axis_w[..., jidx, :]
        qdj = qd[..., jidx][..., None]
        a_o = aop + _cross(alp, r) + _cross(wp, _cross(wp, r))
        w_c = wp + qdj * ax
        al_c = alp + qdj * _cross(wp, ax)
        for i, b in enumerate(bodies):
            w_list[b] = w_c[..., i, :]
            al_list[b] = al_c[..., i, :]
            ao_list[b] = a_o[..., i, :]

    w = torch.stack(w_list, dim=-2)
    alpha = torch.stack(al_list, dim=-2)
    a_o = torch.stack(ao_list, dim=-2)
    d = kin.body_com_w - kin.body_p
    a_com = a_o + _cross(alpha, d) + _cross(w, _cross(w, d))
    return w, alpha, a_com


def coriolis_bias_full(model: RobotModel, base_R, base_p, q, u):
    """Coriolis bias plus the primal kinematics it computes along the way.

    Returns (h_C (..., nv), kin, parts, v_com (..., nb, 3)): the WBC setup
    reuses kin/parts/body velocities instead of recomputing FK."""
    kin = K.forward_kinematics(model, base_R, base_p, q)
    parts = K.body_com_jacobian_parts(model, kin)
    v_c, _ = K.parts_velocities(parts, u)
    w, alpha, a_c = velocity_product_kinematics(model, kin, u)
    return _bias_from_accelerations(model, kin, parts, a_c, w, alpha), kin, parts, v_c


def _bias_from_accelerations(model, kin, parts, a_c, w, alpha):
    Iw = world_inertias(model, kin)
    F = model.mass[..., None] * a_c
    N = torch.einsum("...bij,...bj->...bi", Iw, alpha) + _cross(
        w, torch.einsum("...bij,...bj->...bi", Iw, w))
    return project_forces_from_parts(parts, F, N)


def gravity_force(model: RobotModel, kin: K.KinState, g_vec, parts=None):
    """(..., nv) generalized force of the acceleration field g_vec (3,):
    sum_b Jv_b^T m_b g_vec."""
    if parts is None:
        parts = K.body_com_jacobian_parts(model, kin)
    g = torch.as_tensor(g_vec, dtype=parts.r.dtype, device=parts.r.device)
    F = (model.mass[..., None] * g).expand_as(parts.r)
    return project_forces_from_parts(parts, F, torch.zeros_like(F))


def forward_dynamics(model: RobotModel, base_R, base_p, q, u, tau_gen):
    """(..., nv) u_dot = M^-1 (tau_gen - h_C + g_gen), gravity pulling -z.

    tau_gen is the full generalized applied force (S^T tau + J_c^T f + ...).
    One forward-kinematics pass serves M, h_C and the gravity force; M is
    solved by a batched Cholesky factorization (`linalg.spd_solve`), the
    same code on every device."""
    from benchmark.reference.linalg import spd_solve

    h, kin, parts, _ = coriolis_bias_full(model, base_R, base_p, q, u)
    M = mass_matrix_from_parts(model, kin, parts)
    grav = gravity_force(model, kin, (0.0, 0.0, -9.81), parts)
    return spd_solve(M, tau_gen - h + grav)
