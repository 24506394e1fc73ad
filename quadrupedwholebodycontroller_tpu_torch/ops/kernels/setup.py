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

`stop_after` (profiling only, float32 on the card: the section probes of
`csrc/setup.cu`) truncates the kernel after one of `SECTIONS` and writes a
checksum of that section's live values into `com` (three copies); every
other output is left unwritten.  A probe has its own C entry point
(`qwbc_setup_sections_f32`) and counts in no launch counter.
`tools/torch_setup_sections.py` times them.

Not carried over from the JAX function: `interpret` and the batch-minor
`prepared_layout`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

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
# the stop_after sections, in the order of STOP_* in csrc/setup.cu (from 1)
SECTIONS = ("inputs", "fk", "jac", "recursion", "mass", "centroidal", "foot", "fd")
PREPARED = ("sH", "sA", "sg", "sl", "su", "rho", "wxs", "wzs", "wys", "d", "e")

# The kernel's pointer table, in the order of the enum in csrc/setup.cu: the
# caller's inputs of the kernel's type (argument, field, shape after the
# batch), the warm start (fused only), the model table; the flags and the
# topology; the outputs of the kernel's type (name, shape after the batch),
# the prepared tensors (fused only); the two flag outputs.
_N, _M, _NJ = QP_NUM_VARS, QP_NUM_CONSTRAINTS, NUM_JOINTS
_CALLER_IN = (
    ("obs", "base_R", (3, 3)), ("obs", "base_p", (3,)), ("obs", "base_vel", (6,)),
    ("obs", "q", (_NJ,)), ("obs", "qd", (_NJ,)),
    ("ref", "com_pose", (6,)), ("ref", "com_vel", (6,)), ("ref", "com_acc", (6,)),
    ("ref", "swing_pos", (12,)), ("ref", "swing_vel", (12,)), ("ref", "swing_acc", (12,)),
    ("ref", "contacts", (NUM_LEGS,)),
    ("carry", "old_T", (NV, NV)), ("carry", "old_J_st", (12, NV)),
    ("carry", "old_J_sw", (12, NV)), ("carry", "tdot_inv", (NV, NV)),
    ("carry", "integral_error", (6,)), ("carry", "prev_contacts", (NUM_LEGS,)))
_WARM_IN = (("x", (_N,)), ("z", (_M,)), ("y", (_M,)))
_OUT = (("A", (_M, _N)), ("g", (_N,)), ("l", (_M,)), ("u", (_M,)), ("H", (_N, _N)),
        ("h_c", (NV,)), ("com", (3,)), ("current_pose", (6,)), ("foot_pos", (12,)),
        ("Mc_jj", (_NJ, _NJ)), ("Jc_st_j", (12, _NJ)), ("old_T", (NV, NV)),
        ("old_J_st", (12, NV)), ("old_J_sw", (12, NV)), ("tdot_inv", (NV, NV)),
        ("integral_error", (6,)), ("prev_contacts", (NUM_LEGS,)))
_PREPARED_OUT = tuple(zip(PREPARED, ((_N, _N), (_M, _N), (_N,), (_M,), (_M,), (_M,),
                                     (_N,), (_M,), (_M,), (_N,), (_M,))))
_N_PTRS = len(_CALLER_IN) + len(_WARM_IN) + 1 + 4 + len(_OUT) + len(_PREPARED_OUT) + 2
_PTR_TABLE = ctypes.c_void_p * _N_PTRS


@functools.lru_cache(maxsize=None)
def _shapes(B: int, fused: bool):
    """The batch's input shapes (caller inputs, then the warm start) and
    output shapes, in the table's order."""
    ins = tuple((B, *s) for _, _, s in _CALLER_IN)
    warm = tuple((B, *s) for _, s in _WARM_IN) if fused else ()
    outs = tuple((B, *s) for _, s in _OUT + (_PREPARED_OUT if fused else ()))
    return ins, warm, outs

_constants = {}   # (id(model), params, dtype, device) -> (model, mc, topo)
GAINS = ("friction", "kp", "kp_z", "kd", "ki", "kp_swing", "kd_swing", "max_torque",
         "slack_weight")   # the gains of ControllerParams the kernel reads


def _check_model(model):
    nb, nj, nl = model.num_bodies, model.num_joints, len(model.frame_body)
    if (nb, nj, nl) != (NUM_BODIES, NUM_JOINTS, NUM_LEGS):
        raise ValueError(
            f"the setup kernel is compiled for {NUM_BODIES} bodies, {NUM_JOINTS} "
            f"joints and {NUM_LEGS} feet, got {nb}, {nj}, {nl}")


def pack_constants(model, params):
    """(reals float64, ints int32): the model and the controller gains in
    the layout `csrc/setup.cu` reads (MC_* and TP_* there).  A gain may be
    a float or a 0-d tensor that does not require grad."""
    build.refuse_grad("pack_constants", model, params)
    _check_model(model)
    nb, nj = model.num_bodies, model.num_joints
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
    p = {k: float(getattr(params, k)) for k in GAINS}
    scalars = [
        m_tot, inv_m, inv_m * inv_m, m_tot * GRAVITY, 1.0 / params.loop_rate,
        1.0 / (1.0 / params.loop_rate), p["friction"],
        p["kp"], p["kp"], p["kp_z"], p["kp"], p["kp"], p["kp"],
        p["kd"], p["ki"], p["kp_swing"], p["kd_swing"],
        p["max_torque"], p["slack_weight"], QP_INF,
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
    # keyed on the gains' values: a tensor gain hashes by its id, which an
    # update in place keeps and a fresh tensor of the same value does not
    params = dataclasses.replace(params, **{k: float(getattr(params, k)) for k in GAINS})
    key = (id(model), params, dtype, str(device))
    if key not in _constants:
        mc, topo = pack_constants(model, params)
        # the model is kept beside its tables so that its id stays its own
        _constants[key] = (model, torch.as_tensor(mc, dtype=dtype, device=device),
                           torch.as_tensor(topo, device=device))
    return _constants[key][1:]


def _result(outs, fused, switch_flag, deriv_valid):
    """The result dict from the outputs in the table's order."""
    named = dict(zip((k for k, _ in _OUT), outs))
    cu = {k: named.pop(k) for k in ("old_T", "old_J_st", "old_J_sw", "tdot_inv",
                                    "integral_error", "prev_contacts")}
    return dict(**named, prepared=tuple(outs[len(_OUT):]) if fused else None,
                carry_updates=dict(**cu, switch_flag=switch_flag, deriv_valid=deriv_valid))


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
    prepared = ()
    if qp_params is not None:
        warm = wbc._switch_masked_warm(carry, cu["switch_flag"])
        prepared = prepare.prepare_scaled_plain(
            d.H, d.A, d.g, d.l, d.u, warm.x, warm.z, warm.y,
            sweeps=qp_params.scaling_iters, rho0=qp_params.rho,
            rho_eq_scale=qp_params.rho_eq_scale)
    outs = (d.A, d.g, d.l, d.u, d.H, s.h_c, s.com, s.current_pose, s.foot_pos, s.Mc_jj,
            s.Jc_st_j, *(cu[k] for k in ("old_T", "old_J_st", "old_J_sw", "tdot_inv",
                                         "integral_error", "prev_contacts")), *prepared)
    sw = cu["switch_flag"]
    return _result(outs, qp_params is not None, sw, torch.ones_like(sw))


def _stop_index(stop_after, dtype) -> int:
    if stop_after is None:
        return 0
    if stop_after not in SECTIONS:
        raise ValueError(f"stop_after: {stop_after!r} is none of {SECTIONS}")
    if dtype != torch.float32:
        raise ValueError(f"stop_after: the section probes are float32 only, got {dtype}")
    return SECTIONS.index(stop_after) + 1


def _run(launch, check, model, params, obs, ref, carry, ref_is_new, qp_params,
         exact_mode, stop_after=None):
    """Check the caller's tensors, allocate the outputs, fill the kernel's
    pointer table and call `launch(entry, suffix, *launcher arguments)`:
    entry "setup" the whole kernel, "setup_sections" a section probe."""
    B, dtype, dev = obs.q.shape[0], obs.base_p.dtype, obs.base_p.device
    stop = _stop_index(stop_after, dtype)
    rn = _ref_is_new(ref_is_new, B, dev)
    mc, topo = _device_constants(model, params, dtype, dev)
    fused = qp_params is not None
    in_shapes, warm_shapes, out_shapes = _shapes(B, fused)
    args = {"obs": obs, "ref": ref, "carry": carry}
    ins = [getattr(args[a], f) for a, f, _ in _CALLER_IN]
    warm = [getattr(carry.qp_warm, f) for f, _ in _WARM_IN] if fused else []
    named = {f: (t, s) for (_, f, _), t, s in zip(_CALLER_IN, ins, in_shapes)}
    named.update({"qp_warm." + f: (t, s) for (f, _), t, s in zip(_WARM_IN, warm, warm_shapes)})
    named["mc"] = (mc, tuple(mc.shape))
    suffix = check(obs.base_p, named)
    flags = (carry.switch_flag, carry.deriv_valid, rn)
    for name, t in zip(("switch_flag", "deriv_valid", "ref_is_new"), flags):
        if t.dtype != torch.bool or t.device != dev or tuple(t.shape) != (B,):
            raise ValueError(f"{name}: expected a ({B},) bool tensor on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if name != "ref_is_new" and not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")

    outs = [torch.empty(s, dtype=dtype, device=dev) for s in out_shapes]
    switch_flag, deriv_valid = (torch.empty(B, dtype=torch.bool, device=dev)
                                for _ in range(2))
    if B > 0:
        table = _PTR_TABLE(
            *(t.data_ptr() for t in ins),
            *((t.data_ptr() for t in warm) if fused else (None,) * len(_WARM_IN)),
            mc.data_ptr(), *(t.data_ptr() for t in flags), topo.data_ptr(),
            *(t.data_ptr() for t in outs),
            *(() if fused else (None,) * len(_PREPARED_OUT)),
            switch_flag.data_ptr(), deriv_valid.data_ptr())
        head = (table, _N_PTRS, mc.numel(), topo.numel(), B, rn.stride(0),
                int(bool(exact_mode)))
        qpp = qp_params
        if stop:
            launch("setup_sections", suffix, *head, stop)
        else:
            launch("setup", suffix, *head, int(fused),
                   int(qpp.scaling_iters) if fused else 0,
                   float(qpp.rho) if fused else 0.0,
                   float(qpp.rho * qpp.rho_eq_scale) if fused else 0.0)
    return _result(outs, fused, switch_flag, deriv_valid)


def setup_batched(model, params, obs, ref, carry, ref_is_new, qp_params=None,
                  exact_mode=False, stop_after=None):
    """The WBC setup of a batch, as a dict with the JAX function's keys:
    the QP (`H, g, A, l, u`), `prepared` (the 11 tensors of
    `prepare.prepare_scaled`, for `ops.qp.solve_batched(prepared=...)`; None
    without `qp_params`), the torque-map inputs (`h_c, Mc_jj, Jc_st_j`),
    `com, current_pose, foot_pos` and `carry_updates`.  Every tensor is
    contiguous and owns its memory (no view of A enters the carry).

    exact_mode: the analytic derivatives (K3x); the finite differences
    otherwise, whatever `params.exact_derivatives` says (the caller
    decides, as `control.wbc.wbc_step_batched` does).

    ref_is_new: a bool or a (B,) bool tensor of any stride.

    stop_after: a section probe (`SECTIONS`; float32, CUDA tensors; on the
    CPU `setup_batched_host` runs them): only `com` is written.

    Refuses an input that requires grad, the model's tensors and a gain
    given as a tensor included (`build.refuse_grad`)."""
    build.refuse_grad("setup_batched", model, params, obs, ref, carry, ref_is_new)
    _check_model(model)   # on either device, as the kernel is compiled
    if obs.base_p.device.type == "cpu":
        if stop_after is not None:
            raise ValueError("stop_after probes the kernel: CUDA tensors only "
                             "(setup_batched_host runs them on the CPU)")
        return setup_batched_plain(model, params, obs, ref, carry, ref_is_new,
                                   qp_params, exact_mode)

    def launch(entry, suffix, *args):
        build.launch(entry, suffix, *args,
                     torch.cuda.current_stream(obs.base_p.device).cuda_stream)
        if entry == "setup":   # a probe is not K3 and counts as no launch
            LAUNCHES[_counter(exact_mode)] += 1

    return _run(launch, build.check_inputs, model, params, obs, ref, carry,
                ref_is_new, qp_params, exact_mode, stop_after)


def setup_batched_host(model, params, obs, ref, carry, ref_is_new,
                       qp_params=None, reverse=False, exact_mode=False, stop_after=None):
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

    def launch(entry, suffix, *args):
        ctypes.c_int.in_dll(lib, "qwbc_host_reverse").value = int(reverse)
        err = getattr(lib, f"qwbc_{entry}_{suffix}")(*args, None)
        if err != 0:
            raise RuntimeError(f"host build of the setup kernel refused its arguments ({err})")

    return _run(launch, check, model, params, obs, ref, carry, ref_is_new, qp_params,
                exact_mode, stop_after)
