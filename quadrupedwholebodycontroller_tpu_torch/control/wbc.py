"""The whole-body controller: one batched control step.

Re-designs the reference's 400 Hz control loop (updateState -> solveQP ->
computeJointTorques) as a function

    wbc_step_batched : (obs, ref, carry, cache) -> (output, carry, cache)

over a scenario batch (the leading dimension of every leaf), and as
`wbc_step`, each scenario solved as the single robot is, with every
cross-cycle member of the reference's C++ class (old jacobians for finite
differences, integral error, QP hotstart memory, contact-switch flag) made
explicit in a WBCCarry.

QP contract (must match the reference exactly):
  x = [u_dot_com (6); qddot (12); F (12); s (12)]  (42 vars)
  rows 0-5    equality   M_c,b u_dot_com - J_st,com^T F = -w_gravity
  rows 6-17   equality   J_st,com u_dot_com + J_st,j qddot = -Jdot_st v_c
  rows 18-33  inequality D_fr F <= 0 (friction pyramid, contact-masked)
  rows 34-45  two-sided  -tau_max - h_j <= M_c,jj qddot - J_st,j^T F <= tau_max - h_j
  rows 46-69  swing tracking with slacks s
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from quadrupedwholebodycontroller_tpu_torch.config import (
    GRAVITY,
    NUM_JOINTS,
    NUM_LEGS,
    NV,
    QP_INF,
    QP_NUM_CONSTRAINTS,
    QP_NUM_VARS,
    ControllerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.models.robot_model import RobotModel
from quadrupedwholebodycontroller_tpu_torch.ops import centroidal as C
from quadrupedwholebodycontroller_tpu_torch.ops import dynamics as D
from quadrupedwholebodycontroller_tpu_torch.ops import kinematics as K
from quadrupedwholebodycontroller_tpu_torch.ops import qp
from quadrupedwholebodycontroller_tpu_torch.ops import spatial
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build as kernel_build
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup as setup_kernel
from quadrupedwholebodycontroller_tpu_torch.ops.linalg import spd_inv12


class RobotObservation(NamedTuple):
    """State intake (the reference's model_states / joint_states callbacks)."""

    base_R: torch.Tensor    # (B, 3, 3)
    base_p: torch.Tensor    # (B, 3)
    base_vel: torch.Tensor  # (B, 6) [linear; angular], world frame
    q: torch.Tensor         # (B, 12)
    qd: torch.Tensor        # (B, 12)


class Reference(NamedTuple):
    """Planner reference (the WbcReferenceMsg contract); leg order LH, LF,
    RF, RH everywhere."""

    com_pose: torch.Tensor   # (B, 6) [xyz, rpy]
    com_vel: torch.Tensor    # (B, 6)
    com_acc: torch.Tensor    # (B, 6)
    swing_pos: torch.Tensor  # (B, 12)
    swing_vel: torch.Tensor  # (B, 12)
    swing_acc: torch.Tensor  # (B, 12)
    contacts: torch.Tensor   # (B, 4) float 0/1

    @classmethod
    def standing(cls, params: ControllerParams, batch: int,
                 dtype=torch.float32, device="cuda") -> "Reference":
        kw = dict(dtype=dtype, device=device)
        pose = torch.tensor(params.initial_reference_pose, **kw).expand(batch, 6).clone()
        z = lambda k: torch.zeros((batch, k), **kw)
        return cls(
            com_pose=pose, com_vel=z(6), com_acc=z(6),
            swing_pos=z(12), swing_vel=z(12), swing_acc=z(12),
            contacts=torch.ones((batch, 4), **kw),
        )


class WBCCarry(NamedTuple):
    """All cross-cycle state of the reference C++ class, made explicit."""

    old_T: torch.Tensor        # (B, 18, 18) previous transformation matrix
    old_J_st: torch.Tensor     # (B, 12, 18) previous centroidal stance jacobian
    old_J_sw: torch.Tensor     # (B, 12, 18)
    tdot_inv: torch.Tensor     # (B, 18, 18) stale d(T^-1)/dt
    integral_error: torch.Tensor  # (B, 6)
    prev_contacts: torch.Tensor   # (B, 4)
    switch_flag: torch.Tensor     # (B,) bool, held between reference updates
    deriv_valid: torch.Tensor     # (B,) bool, False on the first cycle
    qp_warm: qp.QPState           # hotstart memory (B, 42), (B, 70), (B, 70)


class WBCOutput(NamedTuple):
    tau: torch.Tensor        # (B, 12) joint torques (the command)
    grf: torch.Tensor        # (B, 12) desired ground reaction forces
    qp_x: torch.Tensor       # (B, 42) full QP solution
    qp_info: qp.QPInfo
    com_pos: torch.Tensor    # (B, 3)
    com_pose: torch.Tensor   # (B, 6) [com xyz, base rpy]
    foot_pos: torch.Tensor   # (B, 12) world foot positions (LH,LF,RF,RH)


def init_carry(batch: int, dtype=torch.float32, device="cuda") -> WBCCarry:
    kw = dict(dtype=dtype, device=device)
    return WBCCarry(
        old_T=torch.eye(NV, **kw).expand(batch, NV, NV).clone(),
        old_J_st=torch.zeros((batch, 3 * NUM_LEGS, NV), **kw),
        old_J_sw=torch.zeros((batch, 3 * NUM_LEGS, NV), **kw),
        tdot_inv=torch.zeros((batch, NV, NV), **kw),
        integral_error=torch.zeros((batch, 6), **kw),
        prev_contacts=torch.ones((batch, NUM_LEGS), **kw),
        switch_flag=torch.zeros(batch, dtype=torch.bool, device=device),
        deriv_valid=torch.zeros(batch, dtype=torch.bool, device=device),
        qp_warm=qp.QPState.zeros(batch, QP_NUM_VARS, QP_NUM_CONSTRAINTS, dtype, device),
    )


def _friction_pyramid(friction, contacts):
    """D_fr (B, 16, 12): 4 one-sided rows per leg, D = +-(t_i - mu n),
    contact-masked (the reference's computeNonSlidingConstraints).
    friction: a float or a 0-d tensor (a gradient flows to it)."""
    kw = dict(dtype=contacts.dtype, device=contacts.device)
    tangent = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                            [0.0, -1.0, 0.0]], **kw)
    normal = torch.tensor([0.0, 0.0, 1.0], **kw)
    Dleg = tangent - torch.as_tensor(friction, **kw) * normal
    out = torch.zeros((contacts.shape[0], 4 * NUM_LEGS, 3 * NUM_LEGS),
                      dtype=contacts.dtype, device=contacts.device)
    for i in range(NUM_LEGS):
        out[:, 4 * i:4 * i + 4, 3 * i:3 * i + 3] = Dleg * contacts[:, i, None, None]
    return out


class WBCSetup(NamedTuple):
    """Everything the step computes before the QP solve."""

    qp_data: qp.QPData
    h_c: torch.Tensor
    Mc_jj: torch.Tensor
    Jc_st_j: torch.Tensor
    com: torch.Tensor
    current_pose: torch.Tensor
    foot_pos: torch.Tensor
    carry_updates: dict  # fields of WBCCarry computed pre-solve


def _mv(M, v):
    return torch.einsum("bij,bj->bi", M, v)


def _exact_tangents(model: RobotModel, obs: RobotObservation, u, contacts):
    """T and the contact-masked centroidal foot Jacobians J_st T^-1,
    J_sw T^-1 of the configuration, their time derivatives along the state
    flow (Rdot = skew(omega) R, pdot = v, qdot) by forward-mode AD through
    the rigid-body code (`torch.func.jvp`, which `torch.no_grad` does not
    switch off), and (M, tf) as aux:
    ((T, J_st, J_sw), (Tdot, Jdot_st, Jdot_sw), (M, tf))."""
    B = obs.q.shape[0]

    def mats(R, p, qq):
        kin = K.forward_kinematics(model, R, p, qq)
        M = D.mass_matrix(model, kin)
        tf = C.centroidal_transform(M, K.robot_com(model, kin), p)
        J_feet = K.frame_jacobians(model, kin)[:, :, :3, :]
        J_st = (J_feet * contacts[:, :, None, None]).reshape(B, 3 * NUM_LEGS, NV)
        J_sw = (J_feet * (1.0 - contacts)[:, :, None, None]).reshape(B, 3 * NUM_LEGS, NV)
        return (tf.T, J_st @ tf.T_inv, J_sw @ tf.T_inv), (M, tf)

    # dual tensors cannot be built on overlapping memory (an expanded view)
    dense = lambda ts: tuple(t.contiguous() for t in ts)
    flow = K.state_flow(obs.base_R, obs.base_p, obs.q, u)
    return torch.func.jvp(mats, dense((obs.base_R, obs.base_p, obs.q)), dense(flow),
                          has_aux=True)


def wbc_setup(
    model: RobotModel,
    params: ControllerParams,
    obs: RobotObservation,
    ref: Reference,
    carry: WBCCarry,
    ref_is_new,
) -> WBCSetup:
    """State update + QP assembly for a batch (the updateState /
    solveQP-assembly halves of the reference control cycle).  ref_is_new:
    (B,) bool.  Every float gain of `params` (kp, kp_z, kd, ki, kp_swing,
    kd_swing, max_torque, slack_weight, friction) may be a float or a 0-d
    tensor; a gradient flows to a tensor gain.

    Tdot and Jdot are the reference's one-cycle finite differences, or with
    `params.exact_derivatives` their analytic values along the state flow
    (`_exact_tangents`), and the centroidal bias then reads the fresh
    d(T^-1)/dt instead of the carried one."""
    dtype, dev = obs.base_p.dtype, obs.base_p.device
    kw = dict(dtype=dtype, device=dev)
    B = obs.q.shape[0]
    nj, nl = NUM_JOINTS, NUM_LEGS
    dt = 1.0 / params.loop_rate
    u = torch.cat([obs.base_vel, obs.qd], dim=-1)

    # ---- contact bookkeeping (referenceCallback) ----
    changed = (ref.contacts != carry.prev_contacts).any(-1)
    switch = torch.where(ref_is_new, changed, carry.switch_flag)
    prev_contacts = torch.where(ref_is_new[:, None], ref.contacts, carry.prev_contacts)
    contacts = prev_contacts

    # ---- updateState ----
    # one pass computes the Coriolis bias AND the primal kinematics (FK +
    # Jacobian parts + body velocities) that everything else reuses
    h_cor, kin, parts, v_bodies = D.coriolis_bias_full(
        model, obs.base_R, obs.base_p, obs.q, u
    )
    com = K.robot_com(model, kin)
    com_lin_vel = torch.einsum("b,nba->na", model.mass, v_bodies) / model.total_mass
    com_vel6 = torch.cat([com_lin_vel, obs.base_vel[:, 3:6]], dim=-1)
    current_pose = torch.cat([com, spatial.matrix_to_rpy(obs.base_R)], dim=-1)

    M = D.mass_matrix_from_parts(model, kin, parts)
    tf = C.centroidal_transform(M, com, obs.base_p)
    Mc = C.centroidal_mass_matrix(M, tf)
    Mc_base = Mc[:, :6, :6]
    Mc_jj = Mc[:, 6:, 6:]

    J_feet = K.frame_jacobians(model, kin)[:, :, :3, :]           # (B, 4, 3, 18)
    J_st = (J_feet * contacts[:, :, None, None]).reshape(B, 3 * nl, NV)
    J_sw = (J_feet * (1.0 - contacts)[:, :, None, None]).reshape(B, 3 * nl, NV)
    Jc_st = C.project_jacobian(J_st, tf)
    Jc_sw = C.project_jacobian(J_sw, tf)
    Jc_st_com, Jc_st_j = Jc_st[:, :, :6], Jc_st[:, :, 6:]
    Jc_sw_com, Jc_sw_j = Jc_sw[:, :, :6], Jc_sw[:, :, 6:]

    if params.exact_derivatives:
        # analytic Tdot / Jdot: no finite-difference lag and no switch
        # zeroing (contacts are constant within the linearization); the
        # centroidal bias uses the FRESH d(T^-1)/dt
        _, (T_dot, Jd_st, Jd_sw), _ = _exact_tangents(model, obs, u, contacts)
        new_tdot_inv = C.tdot_inverse(tf, T_dot)
        h_c = C.centroidal_bias(h_cor, M, new_tdot_inv, u, tf)
    else:
        # centroidal bias uses the STALE Tdot_inv (the reference reads the
        # member it writes at the end of the previous cycle)
        h_c = C.centroidal_bias(h_cor, M, carry.tdot_inv, u, tf)

        # finite-difference derivatives (computeDerivatives); zeroed on a
        # contact switch AND on the first cycle
        gate = torch.where(switch | ~carry.deriv_valid, 0.0, 1.0).to(dtype)[:, None, None]
        T_dot = gate * (tf.T - carry.old_T) / dt
        Jd_st = gate * (Jc_st - carry.old_J_st) / dt
        Jd_sw = gate * (Jc_sw - carry.old_J_sw) / dt
        new_tdot_inv = C.tdot_inverse(tf, T_dot)

    # ---- desired wrench (computeDesiredWrench) ----
    kp, kp_z = torch.as_tensor(params.kp, **kw), torch.as_tensor(params.kp_z, **kw)
    kp_diag = torch.stack([kp, kp, kp_z, kp, kp, kp])
    gravity_wrench = torch.zeros((B, 6), **kw)
    gravity_wrench[:, 2] = model.total_mass * GRAVITY
    pose_err = current_pose - ref.com_pose
    w_des = (
        -kp_diag * pose_err
        - params.kd * (com_vel6 - ref.com_vel)
        - params.ki * carry.integral_error
        + gravity_wrench
        + _mv(Mc_base, ref.com_acc)
    )
    integral_error = carry.integral_error + pose_err / params.loop_rate

    # ---- swing commanded accelerations ----
    foot_pos = kin.frame_p.reshape(B, 3 * nl)
    foot_vel = torch.einsum("bfij,bj->bfi", J_feet, u).reshape(B, 3 * nl)
    a_cmd = (
        ref.swing_acc
        + params.kd_swing * (ref.swing_vel - foot_vel)
        + params.kp_swing * (ref.swing_pos - foot_pos)
    )
    a_cmd = (a_cmd.reshape(B, nl, 3) * (1.0 - contacts)[:, :, None]).reshape(B, 3 * nl)

    # ---- QP assembly (solveQP) ----
    n, m = QP_NUM_VARS, QP_NUM_CONSTRAINTS
    # H = S_F^T J_st,com Q J_st,com^T S_F + R   (Q = I6)
    R_diag = torch.cat([torch.ones(30, **kw),
                        torch.as_tensor(params.slack_weight, **kw).expand(n - 30)])
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
    A[:, 18:34, 18:30] = _friction_pyramid(params.friction, contacts)
    A[:, 34:46, 6:18] = Mc_jj
    A[:, 34:46, 18:30] = -Jc_st_j.transpose(-1, -2)
    A[:, 46:58, 0:6] = Jc_sw_com
    A[:, 46:58, 6:18] = Jc_sw_j
    A[:, 46:58, 30:42] = -eye12
    A[:, 58:70, 0:6] = Jc_sw_com
    A[:, 58:70, 6:18] = Jc_sw_j
    A[:, 58:70, 30:42] = eye12

    vel_c = torch.cat([com_vel6, obs.qd], dim=-1)  # centroidal-coordinates velocity
    stance_rhs = -_mv(Jd_st, vel_c)
    swing_rhs = a_cmd - _mv(Jd_sw, vel_c)
    tau_max = torch.as_tensor(params.max_torque, **kw).expand(B, nj)
    inf12 = torch.full((B, 3 * nl), QP_INF, **kw)
    ub = torch.cat(
        [-gravity_wrench, stance_rhs, torch.zeros((B, 4 * nl), **kw),
         tau_max - h_c[:, 6:], swing_rhs, inf12], dim=-1)
    lb = torch.cat(
        [-gravity_wrench, stance_rhs, torch.full((B, 4 * nl), -QP_INF, **kw),
         -tau_max - h_c[:, 6:], -inf12, swing_rhs], dim=-1)

    return WBCSetup(
        qp_data=qp.QPData(H=H, g=g, A=A, l=lb, u=ub),
        h_c=h_c,
        Mc_jj=Mc_jj,
        Jc_st_j=Jc_st_j,
        com=com,
        current_pose=current_pose,
        foot_pos=foot_pos,
        carry_updates=dict(
            old_T=tf.T,
            old_J_st=Jc_st,
            old_J_sw=Jc_sw,
            tdot_inv=new_tdot_inv,
            integral_error=integral_error,
            prev_contacts=prev_contacts,
            switch_flag=switch,
            deriv_valid=torch.ones(B, dtype=torch.bool, device=dev),
        ),
    )


def _finish_step(setup: WBCSetup, qp_state, qp_info):
    """Torque mapping + carry assembly (computeJointTorques)."""
    qdd = qp_state.x[:, 6:18]
    grf = qp_state.x[:, 18:30]
    tau = _mv(setup.Mc_jj, qdd) + setup.h_c[:, 6:] - torch.einsum(
        "bij,bi->bj", setup.Jc_st_j, grf)
    out = WBCOutput(
        tau=tau, grf=grf, qp_x=qp_state.x, qp_info=qp_info,
        com_pos=setup.com, com_pose=setup.current_pose, foot_pos=setup.foot_pos,
    )
    return out, WBCCarry(qp_warm=qp_state, **setup.carry_updates)


def _wbc_polish_hinv(H, reg):
    """Exact closed-form inverse of the regularized WBC polish Hessian, in
    the COMPACT (diag, blk, start) form of ops/qp's hinv_fn protocol.

    H is block diagonal: identity on the [u_dot_com; qddot] vars,
    I + J_c,com J_c,com^T on the GRF block (rows 18:30), slack_weight I on
    the slacks.  So the inverse is two reciprocal diagonals plus one 12x12
    SPD closed-form block inverse (ops/linalg.spd_inv12 + one Newton
    step); the dense inverse is never materialized on the hot path."""
    B = H.shape[0]
    eye = torch.eye(12, dtype=H.dtype, device=H.device)
    blk = H[:, 18:30, 18:30] + reg * eye
    blk_inv = spd_inv12(blk)
    blk_inv = blk_inv @ (2.0 * eye - blk @ blk_inv)  # one Newton step on rounding
    diag = torch.cat(
        [
            (1.0 / (H[:, 0:1, 0] + reg)).expand(B, 18),
            torch.zeros((B, 12), dtype=H.dtype, device=H.device),
            (1.0 / (H[:, 30:31, 30] + reg)).expand(B, 12),
        ],
        dim=1,
    )
    return diag, blk_inv, 18


def _exact_correction(model, params, obs, contacts, carry, switch):
    """The changes exact derivatives make to the finite-difference setup,
    for `_exact_epilogue_batched`: the QP rows that read Jdot or Tdot, and
    the centroidal bias

      rows 6-17  (stance):  -(Jd_st_exact - Jd_st_fd) @ vel_c
      rows 34-45 (torque):  -(h_c_exact - h_c_fd)[6:]
      rows 46-69 (swing):   -(Jd_sw_exact - Jd_sw_fd) @ vel_c
      h_c_exact - h_c_fd = T^-T M ((Tdinv_exact - Tdinv_stale) @ u)

    (the bias is linear in d(T^-1)/dt, so the difference needs no Coriolis
    term).  Returns (d_st (B, 12), d_sw (B, 12), dh (B, 18), tdot_inv_exact)."""
    dtype = obs.base_p.dtype
    dt = 1.0 / params.loop_rate
    u = torch.cat([obs.base_vel, obs.qd], dim=-1)
    (T, Jst, Jsw), (T_dot, Jd_st, Jd_sw), (M, tf) = _exact_tangents(model, obs, u, contacts)
    tdot_inv_exact = C.tdot_inverse(tf, T_dot)
    dh = _mv(tf.T_inv.transpose(-1, -2), _mv(M, _mv(tdot_inv_exact - carry.tdot_inv, u)))
    # the reference's velocity convention: CoM linear velocity + BASE
    # angular velocity, not the centroidal average angular velocity
    vel_c = torch.cat([_mv(T, u)[:, :3], obs.base_vel[:, 3:6], obs.qd], dim=-1)
    gate = torch.where(switch | ~carry.deriv_valid, 0.0, 1.0).to(dtype)[:, None, None]
    Jd_st_fd = gate * (Jst - carry.old_J_st) / dt
    Jd_sw_fd = gate * (Jsw - carry.old_J_sw) / dt
    d_st = -_mv(Jd_st - Jd_st_fd, vel_c)
    d_sw = -_mv(Jd_sw - Jd_sw_fd, vel_c)
    return d_st, d_sw, dh, tdot_inv_exact


def _exact_epilogue_batched(model, params, obs, carry, setup: WBCSetup, prepared):
    """Patch a finite-difference setup (the setup kernel's, or
    `wbc_setup`'s) into the exact-derivatives one: the bound rows that read
    Jdot or Tdot, h_c and the carried tdot_inv take their exact values, and
    the scaled bounds of `prepared` (if given) are patched through the
    linear Ruiz row scaling e.  A, H and g do not depend on the
    derivatives.  Returns (setup, prepared)."""
    cu = setup.carry_updates
    d_st, d_sw, dh, tdot_exact = _exact_correction(
        model, params, obs, cu["prev_contacts"], carry, cu["switch_flag"])
    dl = torch.zeros_like(setup.qp_data.l)
    dl[:, 6:18] = d_st
    dl[:, 34:46] = -dh[:, 6:]
    du = dl.clone()
    du[:, 46:58] = d_sw
    dl[:, 58:70] = d_sw
    data = setup.qp_data
    setup = setup._replace(
        qp_data=data._replace(l=data.l + dl, u=data.u + du),
        h_c=setup.h_c + dh,
        carry_updates=dict(cu, tdot_inv=tdot_exact),
    )
    if prepared is not None:
        sH, sA, sg, sl, su, rho, wxs, wzs, wys, dscale, escale = prepared
        prepared = (sH, sA, sg, sl + escale * dl, su + escale * du,
                    rho, wxs, wzs, wys, dscale, escale)
    return setup, prepared


def _switch_masked_warm(carry: WBCCarry, switch):
    """On a contact switch the carried duals refer to re-masked constraint
    rows (a different problem): keep the primal warm start, drop z/y."""
    sw = switch[:, None]
    w = carry.qp_warm
    return qp.QPState(
        x=w.x,
        z=torch.where(sw, torch.zeros_like(w.z), w.z),
        y=torch.where(sw, torch.zeros_like(w.y), w.y),
    )


def wbc_step_batched(
    model: RobotModel,
    params: ControllerParams,
    qp_params: QPSolverParams,
    obs: RobotObservation,
    ref: Reference,
    carry: WBCCarry,
    ref_is_new=True,
    qp_backend: str = "kernel",
    qp_cache: "qp.QPCache | None" = None,
    cache_valid=False,
    setup_backend: str = "auto",
):
    """One batched 400 Hz control cycle; returns (out, carry, cache), or
    (out, carry) without a `qp_cache`.

    The tensors decide the device: CUDA tensors go through the CUDA
    kernels, CPU tensors through their plain versions.

    Gradients: with qp_backend="torch" and setup_backend="torch" the step
    is tensor code and runs in the caller's grad mode (a gain of `params`
    may be a 0-d tensor that requires grad).  Where either backend is a
    kernel's, an input that requires grad (the model, a tensor gain, obs,
    ref, carry, the cache) raises before anything launches, with grad mode
    on: the kernels have no backward, as the JAX package's Pallas path has
    none; otherwise the step runs under `torch.no_grad()`.

    qp_cache: the carried factorization cache (qp.make_cache).  cache_valid
    is the scalar warm gate, False on the first cycle; contact switches
    inside the batch cold-restart only the scenarios that switched.  None:
    every inverse is cold and the solver runs its plain Schur polish.

    qp_backend: "kernel" (the solver kernels) or "torch" (the single-sample
    algorithm in tensor code with the batch-level rescue, the JAX package's
    "xla" backend: `ops.qp.solve_batched(backend="torch")`; it keeps no
    factorizations, so a given cache comes back as it went in).
    setup_backend: "kernel" (the fused setup kernel
    `ops.kernels.setup.setup_batched`; with the kernel QP backend the QP
    prepare stage is fused in and handed to the solver as `prepared=`, with
    the torch one the kernel runs without it), "torch" (`wbc_setup`,
    batched tensor code; with the kernel QP backend the prepare kernel
    follows: the kernel path's oracle) or "auto": the QP backend's name.

    With `params.exact_derivatives` the kernel setup runs its exact mode
    (the tangents propagated in the kernel); with `params.exact_epilogue`
    as well it runs the finite-difference kernel and patches the result
    with `_exact_epilogue_batched` instead: the exact modes' oracle.

    ref_is_new may be a bool or a per-scenario (B,) bool tensor."""
    if qp_backend not in ("kernel", "torch"):
        raise ValueError(f"qp_backend={qp_backend!r}")
    if setup_backend == "auto":
        setup_backend = qp_backend
    if setup_backend not in ("kernel", "torch"):
        raise ValueError(f"setup_backend={setup_backend!r}")
    kernel = "kernel" in (qp_backend, setup_backend)
    if kernel:
        kernel_build.refuse_grad(
            f"wbc_step_batched(qp_backend={qp_backend!r}, setup_backend={setup_backend!r})",
            model, params, obs, ref, carry, ref_is_new, qp_cache,
            hint='qp_backend="torch" with setup_backend="torch" carries a gradient')
    with torch.set_grad_enabled(torch.is_grad_enabled() and not kernel):
        B = obs.q.shape[0]
        dev = obs.q.device
        ref_is_new_b = torch.as_tensor(ref_is_new, dtype=torch.bool, device=dev).expand(B)
        prepared = None
        if setup_backend == "kernel":
            epilogue = params.exact_derivatives and params.exact_epilogue
            sk = setup_kernel.setup_batched(
                model, params, obs, ref, carry, ref_is_new_b,
                qp_params=qp_params if qp_backend == "kernel" else None,
                exact_mode=params.exact_derivatives and not epilogue)
            setup = WBCSetup(
                qp_data=qp.QPData(H=sk["H"], g=sk["g"], A=sk["A"], l=sk["l"], u=sk["u"]),
                h_c=sk["h_c"], Mc_jj=sk["Mc_jj"], Jc_st_j=sk["Jc_st_j"], com=sk["com"],
                current_pose=sk["current_pose"], foot_pos=sk["foot_pos"],
                carry_updates=sk["carry_updates"],
            )
            prepared = sk["prepared"]   # its warm start is already switch-masked
            if epilogue:
                setup, prepared = _exact_epilogue_batched(model, params, obs, carry,
                                                          setup, prepared)
        else:
            setup = wbc_setup(model, params, obs, ref, carry, ref_is_new_b)
        switch = setup.carry_updates["switch_flag"]
        warm = _switch_masked_warm(carry, switch)
        # the closed-form polish H^-1 serves the kernel path; the torch backend
        # derives its own
        hinv_fn = _wbc_polish_hinv if qp_backend == "kernel" else None
        if qp_cache is None:
            qp_state, qp_info = qp.solve_batched(
                setup.qp_data, warm, qp_params, qp_backend, hinv_fn=hinv_fn,
                prepared=prepared)
            return _finish_step(setup, qp_state, qp_info)
        # cache invalidation keys on the switch EDGE (contacts changed at THIS
        # publish tick), not the held switch_flag: the flag stays up until the
        # next planner message (kept for the FD-derivative zeroing), but the
        # cached inverses match the new contact set after ONE cold re-inverse
        switch_edge = ref_is_new_b & (ref.contacts != carry.prev_contacts).any(-1)
        valid_b = torch.as_tensor(cache_valid, dtype=torch.bool, device=dev).expand(B)
        if qp_params.cold_batch > 0:
            # per-scenario warm gate: a contact switch cold-restarts only that
            # scenario's cached inverses
            use_warm = valid_b & ~switch_edge
        else:
            use_warm = (valid_b & ~switch_edge).all()
        qp_state, qp_info, new_cache = qp.solve_batched(
            setup.qp_data, warm, qp_params, qp_backend,
            cache=qp_cache, use_warm=use_warm, hinv_fn=hinv_fn,
            prepared=prepared,
        )
        out, new_carry = _finish_step(setup, qp_state, qp_info)
        return out, new_carry, new_cache


def wbc_step(
    model: RobotModel,
    params: ControllerParams,
    qp_params: QPSolverParams,
    obs: RobotObservation,
    ref: Reference,
    carry: WBCCarry,
    ref_is_new=True,
):
    """One 400 Hz control cycle of each scenario on its own, as the JAX
    package's single-sample `wbc_step` (its result equals that function
    under `vmap`; B = 1 is the single robot): `wbc_setup` -> the
    switch-masked warm start -> `ops.qp.solve` (tensor code, its
    single-sample rescue) -> the torque map.  Returns (out, carry).  Runs
    in the caller's grad mode: a gain of `params` may be a 0-d tensor that
    requires grad, and the gradient flows as `jax.grad` flows through the
    JAX function (not through the rescue).

    ref_is_new mirrors the arrival of a planner message (the contact-switch
    flag is only re-evaluated then): a bool or a (B,) bool tensor."""
    B = obs.q.shape[0]
    ref_is_new_b = torch.as_tensor(ref_is_new, dtype=torch.bool,
                                   device=obs.q.device).expand(B)
    setup = wbc_setup(model, params, obs, ref, carry, ref_is_new_b)
    warm = _switch_masked_warm(carry, setup.carry_updates["switch_flag"])
    qp_state, qp_info = qp.solve(setup.qp_data, warm, qp_params)
    return _finish_step(setup, qp_state, qp_info)
