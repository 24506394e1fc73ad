"""The control step of the benchmark's reference: state -> QP -> torques.

A frozen copy of the finite-difference branch of the port's
`control/wbc.wbc_setup` and of its torque map (`_finish_step`), and the
relative KKT residual by which a QP answer is judged.  It works on plain
tensors in any dtype; the benchmark runs it in float64 on the inputs the
program was given.

QP contract (42 variables, 70 rows):
  x = [u_dot_com (6); qddot (12); F (12); s (12)]
  rows 0-5    equality   M_c,b u_dot_com - J_st,com^T F = -w_gravity
  rows 6-17   equality   J_st,com u_dot_com + J_st,j qddot = -Jdot_st v_c
  rows 18-33  inequality D_fr F <= 0 (friction pyramid, contact-masked)
  rows 34-45  two-sided  -tau_max - h_j <= M_c,jj qddot - J_st,j^T F <= tau_max - h_j
  rows 46-69  swing tracking with slacks s
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import centroidal as C
from benchmark.reference import dynamics as D
from benchmark.reference import kinematics as K
from benchmark.reference import spatial

GRAVITY = 9.81
QP_INF = 1.0e20
NUM_JOINTS, NUM_LEGS = 12, 4
NV = 6 + NUM_JOINTS
N_VARS, N_ROWS = 42, 70


class RobotObservation(NamedTuple):
    base_R: torch.Tensor    # (B, 3, 3)
    base_p: torch.Tensor    # (B, 3)
    base_vel: torch.Tensor  # (B, 6) [linear; angular], world frame
    q: torch.Tensor         # (B, 12)
    qd: torch.Tensor        # (B, 12)


class Reference(NamedTuple):
    com_pose: torch.Tensor   # (B, 6)
    com_vel: torch.Tensor    # (B, 6)
    com_acc: torch.Tensor    # (B, 6)
    swing_pos: torch.Tensor  # (B, 12)
    swing_vel: torch.Tensor  # (B, 12)
    swing_acc: torch.Tensor  # (B, 12)
    contacts: torch.Tensor   # (B, 4) float 0/1

    @classmethod
    def standing(cls, pose, batch: int, dtype=torch.float64, device="cpu") -> "Reference":
        kw = dict(dtype=dtype, device=device)
        z = lambda k: torch.zeros((batch, k), **kw)
        return cls(com_pose=torch.tensor(pose, **kw).expand(batch, 6).clone(),
                   com_vel=z(6), com_acc=z(6), swing_pos=z(12), swing_vel=z(12),
                   swing_acc=z(12), contacts=torch.ones((batch, 4), **kw))


class Carry(NamedTuple):
    """The cross-cycle state the QP depends on (not the solver's warm start)."""

    old_T: torch.Tensor
    old_J_st: torch.Tensor
    old_J_sw: torch.Tensor
    tdot_inv: torch.Tensor
    integral_error: torch.Tensor
    prev_contacts: torch.Tensor
    switch_flag: torch.Tensor
    deriv_valid: torch.Tensor


class QP(NamedTuple):
    H: torch.Tensor  # (B, n, n)
    g: torch.Tensor  # (B, n)
    A: torch.Tensor  # (B, m, n)
    l: torch.Tensor  # (B, m)
    u: torch.Tensor  # (B, m)


class TorqueMap(NamedTuple):
    Mc_jj: torch.Tensor    # (B, 12, 12)
    h_j: torch.Tensor      # (B, 12) joint rows of the centroidal bias
    Jc_st_j: torch.Tensor  # (B, 12, 12)


def init_carry(batch: int, dtype=torch.float64, device="cpu") -> Carry:
    kw = dict(dtype=dtype, device=device)
    return Carry(old_T=torch.eye(NV, **kw).expand(batch, NV, NV).clone(),
                 old_J_st=torch.zeros((batch, 3 * NUM_LEGS, NV), **kw),
                 old_J_sw=torch.zeros((batch, 3 * NUM_LEGS, NV), **kw),
                 tdot_inv=torch.zeros((batch, NV, NV), **kw),
                 integral_error=torch.zeros((batch, 6), **kw),
                 prev_contacts=torch.ones((batch, NUM_LEGS), **kw),
                 switch_flag=torch.zeros(batch, dtype=torch.bool, device=device),
                 deriv_valid=torch.zeros(batch, dtype=torch.bool, device=device))


def _mv(M, v):
    return torch.einsum("bij,bj->bi", M, v)


def _friction_pyramid(friction: float, contacts):
    kw = dict(dtype=contacts.dtype, device=contacts.device)
    tangent = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                            [0.0, -1.0, 0.0]], **kw)
    Dleg = tangent - friction * torch.tensor([0.0, 0.0, 1.0], **kw)
    out = torch.zeros((contacts.shape[0], 4 * NUM_LEGS, 3 * NUM_LEGS), **kw)
    for i in range(NUM_LEGS):
        out[:, 4 * i:4 * i + 4, 3 * i:3 * i + 3] = Dleg * contacts[:, i, None, None]
    return out


def setup(model, gains: dict, obs: RobotObservation, ref: Reference, carry: Carry,
          ref_is_new):
    """One control cycle's state update and QP assembly with the reference's
    one-cycle finite differences.  `gains`: the configuration's controller
    block (friction, loop_rate, max_torque, kp, kp_z, kd, ki, kp_swing,
    kd_swing, slack_weight); ref_is_new (B,) bool.  Returns (QP, TorqueMap,
    the next Carry)."""
    dtype, dev = obs.base_p.dtype, obs.base_p.device
    kw = dict(dtype=dtype, device=dev)
    B = obs.q.shape[0]
    nl = NUM_LEGS
    dt = 1.0 / gains["loop_rate"]
    u = torch.cat([obs.base_vel, obs.qd], dim=-1)

    changed = (ref.contacts != carry.prev_contacts).any(-1)
    switch = torch.where(ref_is_new, changed, carry.switch_flag)
    contacts = torch.where(ref_is_new[:, None], ref.contacts, carry.prev_contacts)

    h_cor, kin, parts, v_bodies = D.coriolis_bias_full(model, obs.base_R, obs.base_p,
                                                       obs.q, u)
    com = K.robot_com(model, kin)
    com_lin_vel = torch.einsum("b,nba->na", model.mass, v_bodies) / model.total_mass
    com_vel6 = torch.cat([com_lin_vel, obs.base_vel[:, 3:6]], dim=-1)
    current_pose = torch.cat([com, spatial.matrix_to_rpy(obs.base_R)], dim=-1)

    M = D.mass_matrix_from_parts(model, kin, parts)
    tf = C.centroidal_transform(M, com, obs.base_p)
    Mc = C.centroidal_mass_matrix(M, tf)
    Mc_base, Mc_jj = Mc[:, :6, :6], Mc[:, 6:, 6:]

    J_feet = K.frame_jacobians(model, kin)[:, :, :3, :]
    J_st = (J_feet * contacts[:, :, None, None]).reshape(B, 3 * nl, NV)
    J_sw = (J_feet * (1.0 - contacts)[:, :, None, None]).reshape(B, 3 * nl, NV)
    Jc_st = C.project_jacobian(J_st, tf)
    Jc_sw = C.project_jacobian(J_sw, tf)
    Jc_st_com, Jc_st_j = Jc_st[:, :, :6], Jc_st[:, :, 6:]
    Jc_sw_com, Jc_sw_j = Jc_sw[:, :, :6], Jc_sw[:, :, 6:]

    # the bias reads the stale d(T^-1)/dt, as the reference's C++ does
    h_c = C.centroidal_bias(h_cor, M, carry.tdot_inv, u, tf)
    gate = torch.where(switch | ~carry.deriv_valid, 0.0, 1.0).to(dtype)[:, None, None]
    T_dot = gate * (tf.T - carry.old_T) / dt
    Jd_st = gate * (Jc_st - carry.old_J_st) / dt
    Jd_sw = gate * (Jc_sw - carry.old_J_sw) / dt

    kp, kp_z = gains["kp"], gains["kp_z"]
    kp_diag = torch.tensor([kp, kp, kp_z, kp, kp, kp], **kw)
    gravity_wrench = torch.zeros((B, 6), **kw)
    gravity_wrench[:, 2] = model.total_mass * GRAVITY
    pose_err = current_pose - ref.com_pose
    w_des = (-kp_diag * pose_err - gains["kd"] * (com_vel6 - ref.com_vel)
             - gains["ki"] * carry.integral_error + gravity_wrench
             + _mv(Mc_base, ref.com_acc))

    foot_pos = kin.frame_p.reshape(B, 3 * nl)
    foot_vel = torch.einsum("bfij,bj->bfi", J_feet, u).reshape(B, 3 * nl)
    a_cmd = (ref.swing_acc + gains["kd_swing"] * (ref.swing_vel - foot_vel)
             + gains["kp_swing"] * (ref.swing_pos - foot_pos))
    a_cmd = (a_cmd.reshape(B, nl, 3) * (1.0 - contacts)[:, :, None]).reshape(B, 3 * nl)

    n, m = N_VARS, N_ROWS
    R_diag = torch.cat([torch.ones(30, **kw), torch.full((n - 30,), gains["slack_weight"], **kw)])
    H = torch.diag_embed(R_diag.expand(B, n)).contiguous()
    H[:, 18:30, 18:30] += Jc_st_com @ Jc_st_com.transpose(-1, -2)
    g = torch.zeros((B, n), **kw)
    g[:, 18:30] = -_mv(Jc_st_com, w_des)

    eye12 = torch.eye(3 * nl, **kw)
    A = torch.zeros((B, m, n), **kw)
    A[:, 0:6, 0:6] = Mc_base
    A[:, 0:6, 18:30] = -Jc_st_com.transpose(-1, -2)
    A[:, 6:18, 0:6] = Jc_st_com
    A[:, 6:18, 6:18] = Jc_st_j
    A[:, 18:34, 18:30] = _friction_pyramid(gains["friction"], contacts)
    A[:, 34:46, 6:18] = Mc_jj
    A[:, 34:46, 18:30] = -Jc_st_j.transpose(-1, -2)
    A[:, 46:58, 0:6] = Jc_sw_com
    A[:, 46:58, 6:18] = Jc_sw_j
    A[:, 46:58, 30:42] = -eye12
    A[:, 58:70, 0:6] = Jc_sw_com
    A[:, 58:70, 6:18] = Jc_sw_j
    A[:, 58:70, 30:42] = eye12

    vel_c = torch.cat([com_vel6, obs.qd], dim=-1)
    stance_rhs = -_mv(Jd_st, vel_c)
    swing_rhs = a_cmd - _mv(Jd_sw, vel_c)
    tau_max = torch.full((B, NUM_JOINTS), gains["max_torque"], **kw)
    inf12 = torch.full((B, 3 * nl), QP_INF, **kw)
    ub = torch.cat([-gravity_wrench, stance_rhs, torch.zeros((B, 4 * nl), **kw),
                    tau_max - h_c[:, 6:], swing_rhs, inf12], dim=-1)
    lb = torch.cat([-gravity_wrench, stance_rhs, torch.full((B, 4 * nl), -QP_INF, **kw),
                    -tau_max - h_c[:, 6:], -inf12, swing_rhs], dim=-1)

    nxt = Carry(old_T=tf.T, old_J_st=Jc_st, old_J_sw=Jc_sw,
                tdot_inv=C.tdot_inverse(tf, T_dot),
                integral_error=carry.integral_error + pose_err / gains["loop_rate"],
                prev_contacts=contacts, switch_flag=switch,
                deriv_valid=torch.ones(B, dtype=torch.bool, device=dev))
    return QP(H, g, A, lb, ub), TorqueMap(Mc_jj, h_c[:, 6:], Jc_st_j), nxt


def torques(tm: TorqueMap, x):
    """tau = M_c,jj qddot + h_j - J_st,j^T F (the reference's computeJointTorques)."""
    return _mv(tm.Mc_jj, x[:, 6:18]) + tm.h_j - torch.einsum("bij,bi->bj", tm.Jc_st_j,
                                                              x[:, 18:30])


def kkt_residual(qp: QP, x, y):
    """Relative KKT residual (B,) of a primal-dual pair, the OSQP
    normalisation the port's certificate uses: max of the primal residual
    max|Ax - clip(Ax)| / max(1, |Ax|, finite bounds) and the dual residual
    max|Hx + g + A^T y| / max(1, |Hx|, |A^T y|, |g|)."""
    ax = _mv(qp.A, x)
    hx = _mv(qp.H, x)
    aty = torch.einsum("bij,bi->bj", qp.A, y)
    finite = lambda b: torch.where(torch.abs(b) < 1e19, torch.abs(b), torch.zeros_like(b))
    one = torch.ones_like(ax[:, 0])
    p_scale = torch.maximum(one, torch.maximum(
        torch.amax(torch.abs(ax), dim=-1),
        torch.maximum(torch.amax(finite(qp.l), dim=-1), torch.amax(finite(qp.u), dim=-1))))
    d_scale = torch.maximum(one, torch.maximum(
        torch.amax(torch.abs(hx), dim=-1),
        torch.maximum(torch.amax(torch.abs(aty), dim=-1), torch.amax(torch.abs(qp.g), dim=-1))))
    primal = torch.amax(torch.abs(ax - torch.minimum(torch.maximum(ax, qp.l), qp.u)), dim=-1)
    dual = torch.amax(torch.abs(hx + qp.g + aty), dim=-1)
    return torch.maximum(primal / p_scale, dual / d_scale)
