"""The fused WBC setup (kernel K3): state -> QP, optionally -> scaled QP.

`setup_batched` replaces the JAX package's Pallas kernel
`ops/pallas/setup_kernel.py::setup_batched` (`_setup_call`, body
`_make_kernel`), its plain and its fused-prepare variant: per scenario the
whole of `control.wbc.wbc_setup` (contact bookkeeping, kinematics, dynamics,
centroidal blocks, finite differences, wrench, QP assembly) and, with
`qp_params`, the prepare stage on top (Ruiz sweeps, scaled problem, rho, the
scaled warm start with the duals dropped where contacts switched), in one
launch of `csrc/setup.cu`.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it takes
`setup_batched_plain`, which is built from `wbc_setup` and
`prepare_scaled_plain`: dense 18 x 18 products where the kernel uses block
algebra, so a slip in the kernel's algebra shows far above rounding.

The robot model reaches the kernel as data: `pack_constants` folds the
model and the controller gains into one table of reals (joint rotations
split as M0 + sin(q) M1 + (1 - cos(q)) M2, masses, inertias, gains) and one
of ints (parents, depths, ancestor masks), computed in float64 on the host
and rounded once to the kernel's type.

`exact_mode=True` (kernel K3x, its own launch counter
`setup_batched_exact`) replaces the finite differences of Tdot and Jdot by
their analytic tangents along the state flow, propagated through the same
recursion in the kernel, and the centroidal bias reads the fresh
d(T^-1)/dt; its plain version is `wbc_setup`'s exact branch (forward-mode
AD through the rigid-body code), another derivation of the same numbers.

Not carried over from the JAX function: `interpret`, the batch-minor
`prepared_layout` and `stop_after` (a profiling truncation).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from quadrupedwholebodycontroller_tpu_torch.config import (
    GRAVITY,
    NUM_JOINTS,
    NUM_LEGS,
    NV,
    QP_INF,
    QP_NUM_CONSTRAINTS,
    QP_NUM_VARS,
)
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import build, prepare

LAUNCHES = {"setup_batched": 0, "setup_batched_exact": 0}
PLAIN_CALLS = {"setup_batched": 0, "setup_batched_exact": 0}

NUM_BODIES = 13          # compiled into csrc/setup.cu, with NUM_JOINTS, NUM_LEGS
PREPARED = ("sH", "sA", "sg", "sl", "su", "rho", "wxs", "wzs", "wys", "d", "e")

# the kernel's pointer table, in the order of the enum in csrc/setup.cu
_REAL_IN = ("R0", "p0", "bv", "q", "qd", "rpose", "rvel", "racc", "spos", "svel",
            "sacc", "rcon", "old_T", "old_J_st", "old_J_sw", "tdot_inv", "integ",
            "prevc", "wx", "wz", "wy", "mc")
_OTHER_IN = ("switch_flag", "deriv_valid", "ref_is_new", "topo")
_REAL_OUT = ("A", "g", "l", "u", "H", "h_c", "com", "current_pose", "foot_pos",
             "Mc_jj", "Jc_st_j", "old_T_new", "old_J_st_new", "old_J_sw_new",
             "tdot_inv_new", "integ_new", "prevc_new") + PREPARED
_POINTERS = _REAL_IN + _OTHER_IN + _REAL_OUT + ("switch_flag_new",)

_constants = {}   # (id(model), params, dtype, device) -> (model, mc, topo)


def pack_constants(model, params):
    """(reals float64, ints int32): the model and the controller gains in
    the layout `csrc/setup.cu` reads (MC_* and TP_* there)."""
    nb, nj, nl = model.num_bodies, model.num_joints, len(model.frame_body)
    if (nb, nj, nl) != (NUM_BODIES, NUM_JOINTS, NUM_LEGS):
        raise ValueError(
            f"the setup kernel is compiled for {NUM_BODIES} bodies, {NUM_JOINTS} "
            f"joints and {NUM_LEGS} feet, got {nb}, {nj}, {nl}")
    f64 = lambda t: t.detach().double().cpu().numpy()
    jR, jp, jax_ = f64(model.joint_R), f64(model.joint_p), f64(model.joint_axis)
    mass, com, inertia = f64(model.mass), f64(model.com), f64(model.inertia)
    foot_p = f64(model.frame_p)
    m_tot = float(mass.sum())
    joints = []
    for j in range(nj):
        a = jax_[j]
        K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
        joints.append(np.concatenate([
            jR[j].ravel(), (jR[j] @ K).ravel(), (jR[j] @ (K @ K)).ravel(),
            jp[j], jR[j] @ a]))
    bodies = [np.concatenate([[mass[b], mass[b] / m_tot], com[b], inertia[b].ravel()])
              for b in range(nb)]
    inv_m = 1.0 / m_tot
    scalars = [
        m_tot, inv_m, inv_m * inv_m, m_tot * GRAVITY, 1.0 / params.loop_rate,
        1.0 / (1.0 / params.loop_rate), params.friction,
        params.kp, params.kp, params.kp_z, params.kp, params.kp, params.kp,
        params.kd, params.ki, params.kp_swing, params.kd_swing,
        params.max_torque, params.slack_weight, QP_INF,
    ]
    mc = np.concatenate([*joints, *bodies, foot_p.ravel(), scalars])

    parent = list(model.parent)
    depth, anc = [0] * nb, [0] * nb
    for b in range(1, nb):
        depth[b] = depth[parent[b]] + 1
        anc[b] = anc[parent[b]] | (1 << (b - 1))
    topo = np.array(parent + depth + anc + list(model.frame_body) + [max(depth)],
                    dtype=np.int32)
    topo[0] = 0   # the base has no parent; never read
    return mc, topo


def _device_constants(model, params, dtype, device):
    key = (id(model), params, dtype, str(device))
    if key not in _constants:
        mc, topo = pack_constants(model, params)
        # the model is kept beside its tables so that its id stays its own
        _constants[key] = (model, torch.as_tensor(mc, dtype=dtype, device=device),
                           torch.as_tensor(topo, device=device))
    return _constants[key][1:]


def _result(A, g, l, u, H, prepared, h_c, Mc_jj, Jc_st_j, com, current_pose,
            foot_pos, old_T, old_J_st, old_J_sw, tdot_inv, integral_error,
            prev_contacts, switch_flag):
    return dict(
        H=H, g=g, A=A, l=l, u=u, prepared=prepared,
        h_c=h_c, Mc_jj=Mc_jj, Jc_st_j=Jc_st_j, com=com,
        current_pose=current_pose, foot_pos=foot_pos,
        carry_updates=dict(
            old_T=old_T, old_J_st=old_J_st, old_J_sw=old_J_sw, tdot_inv=tdot_inv,
            integral_error=integral_error, prev_contacts=prev_contacts,
            switch_flag=switch_flag,
            deriv_valid=torch.ones_like(switch_flag),
        ),
    )


def _counter(exact_mode) -> str:
    return "setup_batched_exact" if exact_mode else "setup_batched"


def _ref_is_new(ref_is_new, batch, device):
    rn = torch.as_tensor(ref_is_new, dtype=torch.bool, device=device)
    return rn.expand(batch) if rn.ndim == 0 else rn


def setup_batched_plain(model, params, obs, ref, carry, ref_is_new,
                        qp_params=None, exact_mode=False):
    """Plain PyTorch version: `wbc_setup` (its exact branch with
    `exact_mode`, else its finite differences, whatever
    `params.exact_derivatives` says), then (with `qp_params`) the
    switch-masked warm start through `prepare_scaled_plain`."""
    from quadrupedwholebodycontroller_tpu_torch.control import wbc

    PLAIN_CALLS[_counter(exact_mode)] += 1
    rn = _ref_is_new(ref_is_new, obs.q.shape[0], obs.q.device)
    params = dataclasses.replace(params, exact_derivatives=bool(exact_mode))
    s = wbc.wbc_setup(model, params, obs, ref, carry, rn)
    d, cu = s.qp_data, s.carry_updates
    prepared = None
    if qp_params is not None:
        warm = wbc._switch_masked_warm(carry, cu["switch_flag"])
        prepared = prepare.prepare_scaled_plain(
            d.H, d.A, d.g, d.l, d.u, warm.x, warm.z, warm.y,
            sweeps=qp_params.scaling_iters, rho0=qp_params.rho,
            rho_eq_scale=qp_params.rho_eq_scale)
    return _result(
        d.A, d.g, d.l, d.u, d.H, prepared, s.h_c, s.Mc_jj, s.Jc_st_j, s.com,
        s.current_pose, s.foot_pos, cu["old_T"], cu["old_J_st"], cu["old_J_sw"],
        cu["tdot_inv"], cu["integral_error"], cu["prev_contacts"],
        cu["switch_flag"])


def _run(launch, check, model, params, obs, ref, carry, ref_is_new, qp_params,
         exact_mode):
    """Marshal the tensors into the kernel's pointer table, allocate the
    outputs and call `launch(suffix, *launcher arguments)`."""
    B, dtype, dev = obs.q.shape[0], obs.base_p.dtype, obs.base_p.device
    n, m, nj = QP_NUM_VARS, QP_NUM_CONSTRAINTS, NUM_JOINTS
    rn = _ref_is_new(ref_is_new, B, dev)
    mc, topo = _device_constants(model, params, dtype, dev)
    fused = qp_params is not None
    real_in = {
        "R0": (obs.base_R, (B, 3, 3)), "p0": (obs.base_p, (B, 3)),
        "bv": (obs.base_vel, (B, 6)), "q": (obs.q, (B, nj)), "qd": (obs.qd, (B, nj)),
        "rpose": (ref.com_pose, (B, 6)), "rvel": (ref.com_vel, (B, 6)),
        "racc": (ref.com_acc, (B, 6)), "spos": (ref.swing_pos, (B, 12)),
        "svel": (ref.swing_vel, (B, 12)), "sacc": (ref.swing_acc, (B, 12)),
        "rcon": (ref.contacts, (B, NUM_LEGS)),
        "old_T": (carry.old_T, (B, NV, NV)), "old_J_st": (carry.old_J_st, (B, 12, NV)),
        "old_J_sw": (carry.old_J_sw, (B, 12, NV)),
        "tdot_inv": (carry.tdot_inv, (B, NV, NV)),
        "integ": (carry.integral_error, (B, 6)),
        "prevc": (carry.prev_contacts, (B, NUM_LEGS)),
        "mc": (mc, tuple(mc.shape)),
    }
    if fused:
        real_in.update(wx=(carry.qp_warm.x, (B, n)), wz=(carry.qp_warm.z, (B, m)),
                       wy=(carry.qp_warm.y, (B, m)))
    suffix = check(obs.base_p, real_in)
    flags = {"switch_flag": carry.switch_flag, "deriv_valid": carry.deriv_valid,
             "ref_is_new": rn}
    for name, t in flags.items():
        if t.dtype != torch.bool or t.device != dev or tuple(t.shape) != (B,):
            raise ValueError(f"{name}: expected a ({B},) bool tensor on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    for name in ("switch_flag", "deriv_valid"):
        if not flags[name].is_contiguous():
            raise ValueError(f"{name}: must be contiguous")

    new = lambda *shape: torch.empty(shape, dtype=dtype, device=dev)
    shapes = {
        "A": (B, m, n), "g": (B, n), "l": (B, m), "u": (B, m), "H": (B, n, n),
        "h_c": (B, NV), "com": (B, 3), "current_pose": (B, 6), "foot_pos": (B, 12),
        "Mc_jj": (B, nj, nj), "Jc_st_j": (B, 12, nj), "old_T_new": (B, NV, NV),
        "old_J_st_new": (B, 12, NV), "old_J_sw_new": (B, 12, NV),
        "tdot_inv_new": (B, NV, NV), "integ_new": (B, 6), "prevc_new": (B, NUM_LEGS),
    }
    if fused:
        shapes.update(sH=(B, n, n), sA=(B, m, n), sg=(B, n), sl=(B, m), su=(B, m),
                      rho=(B, m), wxs=(B, n), wzs=(B, m), wys=(B, m), d=(B, n),
                      e=(B, m))
    o = {k: new(*s) for k, s in shapes.items()}
    o["switch_flag_new"] = torch.empty(B, dtype=torch.bool, device=dev)
    if B > 0:
        tensors = {**{k: t for k, (t, _) in real_in.items()}, **flags,
                   "topo": topo, **o}
        table = (ctypes.c_void_p * len(_POINTERS))(
            *(tensors[k].data_ptr() if k in tensors else None for k in _POINTERS))
        qpp = qp_params
        launch(suffix, table, len(_POINTERS), mc.numel(), topo.numel(), B,
               rn.stride(0), int(bool(exact_mode)), int(fused),
               int(qpp.scaling_iters) if fused else 0,
               float(qpp.rho) if fused else 0.0,
               float(qpp.rho * qpp.rho_eq_scale) if fused else 0.0)
    return _result(
        o["A"], o["g"], o["l"], o["u"], o["H"],
        tuple(o[k] for k in PREPARED) if fused else None,
        o["h_c"], o["Mc_jj"], o["Jc_st_j"], o["com"], o["current_pose"],
        o["foot_pos"], o["old_T_new"], o["old_J_st_new"], o["old_J_sw_new"],
        o["tdot_inv_new"], o["integ_new"], o["prevc_new"], o["switch_flag_new"])


def setup_batched(model, params, obs, ref, carry, ref_is_new, qp_params=None,
                  exact_mode=False):
    """The WBC setup of a batch, as a dict with the JAX function's keys:
    the QP (`H, g, A, l, u`), `prepared` (the 11 tensors of
    `prepare.prepare_scaled`, for `ops.qp.solve_batched(prepared=...)`; None
    without `qp_params`), the torque-map inputs (`h_c, Mc_jj, Jc_st_j`),
    `com, current_pose, foot_pos` and `carry_updates`.  Every tensor is
    contiguous and owns its memory (no view of A enters the carry).

    exact_mode: the analytic derivatives (K3x); the finite differences
    otherwise, whatever `params.exact_derivatives` says (the caller
    decides, as `control.wbc.wbc_step_batched` does).

    ref_is_new: a bool or a (B,) bool tensor of any stride."""
    if obs.base_p.device.type == "cpu":
        return setup_batched_plain(model, params, obs, ref, carry, ref_is_new,
                                   qp_params, exact_mode)

    def launch(suffix, *args):
        build.launch("setup", suffix, *args,
                     torch.cuda.current_stream(obs.base_p.device).cuda_stream)

    out = _run(launch, build.check_inputs, model, params, obs, ref, carry,
               ref_is_new, qp_params, exact_mode)
    if obs.q.shape[0] > 0:
        LAUNCHES[_counter(exact_mode)] += 1
    return out


def setup_batched_host(model, params, obs, ref, carry, ref_is_new,
                       qp_params=None, reverse=False, exact_mode=False):
    """`csrc/setup.cu` compiled as plain C++ and run on CPU tensors, one
    emulated thread per block (`build.host_lib`): the kernel's own
    arithmetic without a GPU, for tests.  `reverse` runs every stage's
    items in falling order: a stage whose items depend on each other then
    gives another result.  Needs a C++ compiler; counts as no launch."""
    lib = build.host_lib()

    def check(ref_t, named):
        if ref_t.device.type != "cpu":
            raise ValueError("setup_batched_host takes CPU tensors")
        return build.check_inputs(ref_t, named, device_type="cpu")

    def launch(suffix, *args):
        ctypes.c_int.in_dll(lib, "qwbc_host_reverse").value = int(reverse)
        err = getattr(lib, f"qwbc_setup_{suffix}")(*args, None)
        if err != 0:
            raise RuntimeError(f"host build of the setup kernel refused its arguments ({err})")

    return _run(launch, check, model, params, obs, ref, carry, ref_is_new, qp_params,
                exact_mode)
