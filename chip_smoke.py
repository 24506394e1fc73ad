#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero without them.  It

  1. builds the CUDA kernels from `quadrupedwholebodycontroller_tpu_torch/csrc`,
  2. holds each of the nine kernels against its plain PyTorch version on the
     card, at the main path's shapes (B = 4096, n = 42, m = 70) on inputs
     from a recorded walking step, each output to its own tolerance, in
     float32 and float64, plus a ragged B = 37 (the setup kernel's exact
     mode, K3x, also on a step far from any contact switch); K1, K2, K7, K3
     and K3x must repeat a launch bit for bit; K1, K2 and K7 are also timed
     at their paths' sub-batches, K1 without iterations (its load and epilogue),
     and K1's row says which instantiation ran and what ptxas made of it;
     the setup kernel's section probes (`stop_after`) time its sections,
  3. drives the paths of the batched 400 Hz control cycle
     (`control.wbc.wbc_step_batched`, B = 4096, float32) over the recorded
     walk, each with the launch counters zeroed before and read after: the
     main path (`setup_backend="kernel"`: fused setup kernel -> ADMM ->
     polish) over all 200 steps, the earlier path (`"torch"`: tensor-code
     setup -> prepare kernel -> ADMM -> polish) and the sigma path
     (`QPSolverParams(sigma=1e-6)`: the x-space ADMM) over steps 0..69, which
     hold a contact switch, each held against the main path's torques; each
     path's polish (K2, K7) and x-space ADMM (K5) launches are counted by
     the solver stage that makes them,
  3b. drives the torch QP backend (`qp_backend="torch"`: the single-sample
     algorithm in tensor code with the batch-level rescue) over steps 0..69
     at B = 4096, held against the main path's torques, with no kernel
     launched, and behind the setup kernel's plain variant for 10 steps;
     the single robot (B = 1) over the 200 recorded steps, `wbc_step`
     beside the kernel path, in ms a step against the 2.5 ms control
     period; and the CLI's walk (400 control steps) and trot (200) through
     `closed_loop_rollout` and `trot_rollout` at B = 1,
  4. solves the walk's QPs of steps 30..69 through the generic solve
     (`ops.qp.solve_batched` without a closed-form H^-1: the dense-H polish)
     with a carried cache at sigma = 0 and 1e-6, against the main path's
     solutions; takes one cold step without a cache; and drives the two
     kernels that no path of the control step runs (the x-space ADMM loop
     without its epilogue, the warm Newton-Schulz update) through their
     entry points over the same QPs,
  5. replays the unperturbed walk at B = 8 through the main path against the
     float64 torque record `data/torque_cpu64.npz`,
  5b. drives the solver options that ship off: the main path over steps
     0..69 under each (`OPTION_CASES`), in lockstep with the defaults, the
     options that only route buffers or pick a ranking bit for bit the
     defaults (outputs and cache, every step), the ones the JAX package's
     record calls safe held to the KKT gates, the others printed; the
     generic path's QPs of steps 30..69 with the Schur-inverse refresh and
     the compensated final refinement (the dense H^-1 applied on the card);
     and the B = 8 torque replay under those two, printed beside the
     defaults,
  6. drives the exact-derivative paths over steps 0..69: the setup kernel's
     exact mode (K3x) under the shipped solver parameters (printed) and with
     `rescue_batch` = 2048 (asserted), and the finite-difference kernel plus
     the forward-mode-AD epilogue (its oracle), held against each other,
  7. runs the closed loop (`sim.rollout.batched_rollout`: static-walk
     planner -> control step -> physics) at B = 4096 for 500 control steps,
     with finite differences, and with exact derivatives at `rescue_batch` =
     2048 (printed, over the first 200 steps, which hold its burst) and with
     the rescue sized to the burst (asserted),
  8. drives the robustness sweep: one control period of the simulator with
     one payload model per scenario at B = 4096, held scenario by scenario
     against each simulated alone; `parallel.sharded_sweep_step` under an
     NCCL process group of one rank (B = 4096, the CLI's scenarios from the
     seed: friction, payload, a push, forward speeds; the walk and the
     trot for 200 control steps each), the kernels launched each step
     and no plain version, its metrics bit for bit those of the same batch
     through `batched_rollout` and `sweep_metrics` without a group;
     `sharded_wbc_step` over two recorded steps, bit for bit
     `wbc_step_batched`; and the CLI's `sweep` in this process,
  9. drives the gradients: the JAX package's differentiability test's
     closed loop (B = 1, float64, 16 control steps) on the card, where one
     sign step of log kp lowers its cost, and its gradient over the first
     10 steps held to the port's own on the CPU; one batched control step at B = 4096 under a gradient on the
     tensor-code backends, next to the walk's contact switch, with no
     kernel launched (its times and peak memory); the kernel path refuses a
     gradient before any launch and runs under `torch.no_grad()`; and the
     toy quadruped loaded from its URDF, its kinematics and dynamics on the
     card against the same calls on the CPU.

Every line it prints is one JSON object; the last is
`{"ok": true, "device": {...}}`.  Any failed check raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from quadrupedwholebodycontroller_tpu_torch import replay  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.cli import main as cli  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.config import (  # noqa: E402
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.control import wbc  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.models.robot_model import RobotModel  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops import kernels, qp  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops import dynamics as D  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops import kinematics, spatial  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import (  # noqa: E402
    admm,
    admm_zy,
    build,
    ns_warm,
    polish,
    prepare,
)
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup as setup_k  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops.linalg import (  # noqa: E402
    ns_inverse,
    ns_inverse_warm_shared,
)
from quadrupedwholebodycontroller_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    shard_batch,
    sharded_sweep_step,
    sharded_wbc_step,
    sweep_metrics,
)
from quadrupedwholebodycontroller_tpu_torch.parallel.sweep import gait_planner  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.planner import gait, trot  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams, rollout, world  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.sim.scenario import (  # noqa: E402
    Scenario,
    apply_payload,
)

DEV = "cuda"
N, M, KBLK = 42, 70, 12
BATCH = 4096
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS = 67e12             # H100 SXM float32 peak outside the tensor cores
TRAJ = np.load(os.path.join(ROOT, "data", "walk_traj_400hz.npz"))
TORQUE_F64 = np.load(os.path.join(ROOT, "data", "torque_cpu64.npz"))["tau"]

# Kernel against its plain version on the card.  Every output of every kernel
# has its own tolerance (rtol, atol): max |kernel - plain| over the output
# must stay within rtol * max |plain| + atol, both maxima over that output
# alone, with no floor under the scale.  Entries with |plain| >= 1e19 are
# scaled "infinite" bounds: there kernel and plain must agree in sign and
# class.  Kernel and plain version sum the same terms in another order, so
# the float32 bounds are float32 roundings times what the chain amplifies;
# each is 4x to 40x what an H100 measured on these inputs:
#   * prepare: maxima, square roots and products only, no sums, so it is
#     held ELEMENTWISE: |kernel - plain| <= 1e-5 |plain| on every entry
#     (measured 5e-7);
#   * ADMM iterates: 40 chained iterations with a clip amplify the noise, and
#     the dual update multiplies it by rho = 500 on equality rows: x, z 1e-4
#     (measured 3e-6), y 5e-3 (measured 5e-4);
#   * polish x, y, z: the refinement passes contract the noise: 1e-5
#     (measured 3e-7); its sign violation sv 1e-4 (measured 5e-6).
# The residual outputs pr, du (and the ADMM's sv) of a CONVERGED iterate are
# cancellations at float32's rounding floor (|Hx + g + A^T y| of ~1e3-sized
# terms): two summation orders differ by about the value itself, so a bound
# on them there would hold nothing.  On the main path's inputs they get FLOOR
# and are held two other ways.  (1) The float64 guard, per output: the
# float32 kernel may be no further from the float64 plain version than
# GUARD times the float32 plain version is, plus GUARD_ATOL.  (2) The
# "resolving" case: the same problems at the same shapes, but far from
# converged (ADMM: cold start, 3 iterations; polish: H^-1 and the Schur
# inverse both scaled by 0.7 and one refinement pass), where pr, du and sv
# are 1e-2..1 and every output is held to a relative bound.  A kernel that
# wrote zeros, or a wrong residual, fails there.
# float64: 1e-9 relative everywhere, plus 1e-10 absolute (pr, du, sv are
# relative quantities, ~1e-12 on a converged float64 iterate).
#
# The setup kernel (both variants, and K3x, its exact mode) against
# `setup_batched_plain`, which is another algebra (dense 18 x 18 products
# against the kernel's blocks; for K3x forward-mode AD against the kernel's
# hand-propagated tangents), on a warmed carry with a contact switch in part
# of the batch, and for K3x also far from any switch (SETUP_TOL_F32, the same
# table for both modes, except K3x's tdot_inv below).
# Each float32 bound is about 20x what an H100 measured on these inputs, in
# share of the output's scale unless it says "elem":
#   * A, the new T and J, the kinematic outputs: sums of a few dozen products
#     of O(1) terms (measured 2e-7 .. 4e-7); H: 1 and 1000 on its diagonal
#     set the scale (5e-10);
#   * the finite-difference outputs divide a float32 rounding by dt = 1/400
#     and map it through T^-1: tdot_inv 4e-3 (measured 2e-4); K3x forms it
#     from analytic tangents: 2e-5 (measured 7.6e-7);
#   * h_c, g, l, u are cancellations of large terms (Coriolis and gravity
#     against M d(T^-1)/dt u; gains of 6000 against pose errors): a bound in
#     share of the scale (measured 4e-6, 2e-6, 4e-7), and the float64 guard
#     on top, as for the solver's residuals: there the kernel measured 0.9x
#     to 1.2x as far from the float64 plain version as the float32 plain one;
#   * the scalings d, e and the scaled warm start are products and square
#     roots of single entries; masked friction rows scale to e = 1e16, so a
#     share of the scale would hold nothing: held elementwise, 1e-5
#     (measured 6e-7);
#   * rho, the contacts and both flags are exact (tolerance 0).
#
# The kernels of the generic path, on the same step's inputs:
#   * x-space ADMM (with and without its epilogue) at sigma = 1e-6: the
#     constraint-space kernel's bounds, for the same reasons (40 chained
#     iterations, rho = 500 on equality rows); its "resolving" case is the
#     cold start with 3 iterations;
#   * dense-H polish: the compact polish's bounds; H^-1 is the Newton-Schulz
#     inverse of the regularized H that the generic path computes;
#   * warm Newton-Schulz at n = 42 on the scaled ADMM matrix K (perturbed
#     by 1e-3 per scenario, warm start the inverse of the unperturbed K) and
#     at n = 70 on well-conditioned SPD matrices, in share of X's scale:
#     1e-5 (an H100 measured 0: each entry is one multiply-add chain in k
#     order, as in cuBLAS's product; a kernel that returned W unchanged is
#     1e-3 off); three guarded cases, each in every scenario: a NaN warm
#     start and a 1e9-scaled one (rejected: X0 iterated), and W = -500 A^-1
#     of A scaled by 1e-20 (accepted, the iterate passes 1e30: X0 itself
#     comes back), 1e-5 (measured 1.2e-6: X0's scalings are taken in
#     another order).
PREP_OUT = "sH sA sg sl su rho wxs wzs wys d e".split()
ADMM_OUT = "x z y pr du sv".split()
POLISH_OUT = "x y z pr du sv".split()
SETUP_RESULT = "H g A l u h_c Mc_jj Jc_st_j com current_pose foot_pos".split()
SETUP_CARRY = ("old_T old_J_st old_J_sw tdot_inv integral_error prev_contacts "
               "switch_flag deriv_valid").split()
SETUP_OUT = SETUP_RESULT + SETUP_CARRY + PREP_OUT   # the plain variant: no PREP_OUT
K1, K2, K3, K4 = ("admm_zy_iterations_res", "polish_solve_compact", "setup_batched",
                  "prepare_scaled")
K5, K6, K7, K8 = ("admm_iterations_res", "admm_iterations", "polish_solve_dense",
                  "ns_inverse_warm")
K3X = "setup_batched_exact"
OUTPUTS = {K4: PREP_OUT, K1: ADMM_OUT, K2: POLISH_OUT, K3: SETUP_OUT,
           K5: ADMM_OUT, K6: ADMM_OUT[:3], K7: POLISH_OUT, K8: ["X"], K3X: SETUP_OUT}
FLOOR = None     # at the rounding floor: float64 guard + resolving case
EXACT = (0.0, 0.0)
ELEM = "elem"    # (ELEM, rtol): |kernel - plain| <= rtol |plain| on every entry
SETUP_TOL_F32 = {
    "H": (1e-8, 0.0), "A": (4e-6, 0.0), "g": (4e-5, 0.0), "l": (1e-5, 0.0),
    "u": (1e-5, 0.0), "h_c": (1e-4, 0.0), "Mc_jj": (1e-5, 0.0),
    "Jc_st_j": (1e-5, 0.0), "com": (1e-5, 0.0), "current_pose": (1e-5, 0.0),
    "foot_pos": (1e-5, 0.0), "old_T": (4e-6, 0.0), "old_J_st": (4e-6, 0.0),
    "old_J_sw": (4e-6, 0.0), "tdot_inv": (4e-3, 0.0),
    "integral_error": (4e-5, 0.0), "prev_contacts": EXACT, "switch_flag": EXACT,
    "deriv_valid": EXACT,
    "sH": (1e-5, 0.0), "sA": (2e-5, 0.0), "sg": (4e-5, 0.0), "sl": (1e-5, 0.0),
    "su": (1e-5, 0.0), "rho": EXACT, "wxs": (ELEM, 1e-5), "wzs": (ELEM, 1e-5),
    "wys": (ELEM, 1e-5), "d": (ELEM, 1e-5), "e": (ELEM, 1e-5),
}
SETUP_TOL_F32_EXACT = {**SETUP_TOL_F32, "tdot_inv": (2e-5, 0.0)}
SETUP_GUARDED = ("h_c", "g", "l", "u")   # cancellations: also the float64 guard
TOL_F32 = {
    (K3, "main"): SETUP_TOL_F32,
    (K3, "plain_variant"): SETUP_TOL_F32,
    (K3X, "main"): SETUP_TOL_F32_EXACT,
    (K3X, "switch"): SETUP_TOL_F32_EXACT,
    (K3X, "plain_variant"): SETUP_TOL_F32_EXACT,
    ("prepare_scaled", "main"): {o: (ELEM, 1e-5) for o in PREP_OUT},
    ("admm_zy_iterations_res", "main"): {
        "x": (1e-4, 0.0), "z": (1e-4, 0.0), "y": (5e-3, 0.0),
        "pr": FLOOR, "du": FLOOR, "sv": FLOOR},
    ("admm_zy_iterations_res", "resolving"): {
        "x": (1e-4, 0.0), "z": (1e-4, 0.0), "y": (1e-4, 0.0),
        "pr": (1e-4, 0.0), "du": (1e-4, 0.0), "sv": (5e-4, 0.0)},
    ("polish_solve_compact", "main"): {
        "x": (1e-5, 0.0), "y": (1e-5, 0.0), "z": (1e-5, 0.0),
        "pr": FLOOR, "du": FLOOR, "sv": (1e-4, 1e-7)},
    ("polish_solve_compact", "resolving"): {
        "x": (1e-5, 0.0), "y": (1e-5, 0.0), "z": (1e-5, 0.0),
        "pr": (1e-3, 0.0), "du": (1e-4, 0.0), "sv": (1e-4, 0.0)},
}
TOL_F32.update({
    (K5, "main"): TOL_F32[(K1, "main")],
    (K5, "resolving"): TOL_F32[(K1, "resolving")],
    (K6, "main"): {o: TOL_F32[(K1, "main")][o] for o in ADMM_OUT[:3]},
    (K7, "main"): TOL_F32[(K2, "main")],
    (K7, "resolving"): TOL_F32[(K2, "resolving")],
    (K8, "main"): {"X": (1e-5, 0.0)},
    (K8, "n70"): {"X": (1e-5, 0.0)},
    (K8, "nan_warm"): {"X": (1e-5, 0.0)},
    (K8, "far_warm"): {"X": (1e-5, 0.0)},
    (K8, "blowup"): {"X": (1e-5, 0.0)},
})
TOL_F64 = (1e-9, 1e-10)
GUARD, GUARD_ATOL = 3.0, 1e-6

_JAX = "quadrupedwholebodycontroller_tpu/ops/pallas/"
REPLACES = {
    K4: _JAX + "prepare_kernel.py:74",
    K1: _JAX + "qp_kernel.py:243",
    K2: _JAX + "polish_kernel.py:276",
    K3: _JAX + "setup_kernel.py:1193",
    K3X: _JAX + "setup_kernel.py:1255",
    K5: _JAX + "qp_kernel.py:438",
    K6: _JAX + "qp_kernel.py:363",
    K7: _JAX + "polish_kernel.py:134",
    K8: _JAX + "ns_kernel.py:126",
}
_CSRC = "quadrupedwholebodycontroller_tpu_torch/csrc/"
SOURCES = {K4: _CSRC + "prepare.cu", K1: _CSRC + "admm_zy.cu", K2: _CSRC + "polish.cu",
           K3: _CSRC + "setup.cu", K5: _CSRC + "admm.cu", K6: _CSRC + "admm.cu",
           K7: _CSRC + "polish.cu", K8: _CSRC + "ns_warm.cu", K3X: _CSRC + "setup.cu"}
SIGMA = 1e-6     # the tuned proximal weight of the sigma path


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------------

def kernel_problem(batch: int, dtype, rng):
    """Inputs of the three kernels at one recorded step (t = 60: one leg in
    swing, so masked friction rows, equality rows and +-1e20 bounds all
    occur), built with the port's own tensor code and the plain versions.
    Returns [(kernel, case, wrapper, plain, args, kwargs)]: the "main" case
    is what the main path hands each kernel, the "resolving" case the same
    problems far from converged (see the tolerance table)."""
    model = anymal_d_model(dtype, DEV)
    cp, qpp = ControllerParams(), QPSolverParams()
    obs, ref, _ = replay.step_inputs(
        TRAJ, 60, batch, dtype, replay.make_offsets(batch, dtype, rng, DEV), DEV)
    carry = wbc.init_carry(batch, dtype, DEV)
    carry = carry._replace(prev_contacts=ref.contacts.clone())
    setup = wbc.wbc_setup(model, cp, obs, ref, carry,
                          torch.ones(batch, dtype=torch.bool, device=DEV))
    d = setup.qp_data
    z = qp.QPState.zeros(batch, N, M, dtype, DEV)
    pk = dict(sweeps=qpp.scaling_iters, rho0=qpp.rho, rho_eq_scale=qpp.rho_eq_scale)
    p0 = prepare.prepare_scaled_plain(d.H, d.A, d.g, d.l, d.u, z.x, z.z, z.y, **pk)
    sH, sA, sg, sl, su, rho, _, _, _, ds, es = p0
    K = sH + (sA.transpose(-1, -2) * rho[:, None, :]) @ sA
    Kinv = ns_inverse(K, qpp.ns_iters)
    cold_args = (Kinv, sA, sg, sl, su, rho, z.x, z.z, z.y, sH, d.l, d.u, ds, es)
    # a realistic warm start: the plain ADMM run from zero, unscaled
    x, zz, y, *_ = admm_zy.admm_zy_iterations_res_plain(
        *cold_args, iters=qpp.cold_iterations, alpha=qpp.alpha)
    warm = qp.QPState(x=ds * x, z=zz / es, y=es * y)
    prep_args = (d.H, d.A, d.g, d.l, d.u, warm.x, warm.z, warm.y)
    p1 = prepare.prepare_scaled_plain(*prep_args, **pk)
    admm_args = (Kinv, p1[1], p1[2], p1[3], p1[4], p1[5], p1[6], p1[7], p1[8],
                 p1[0], d.l, d.u, p1[9], p1[10])
    # polish inputs from the warm iterate's active-set estimate
    Hinv = wbc._wbc_polish_hinv(d.H, qpp.polish_reg)
    eye = torch.eye(KBLK, dtype=dtype, device=DEV)
    diag = torch.diagonal(d.H, dim1=-2, dim2=-1) + qpp.polish_reg
    diag = torch.cat([diag[:, :18], torch.zeros_like(diag[:, :KBLK]), diag[:, 30:]], dim=1)
    Hc = (diag, d.H[:, 18:30, 18:30] + qpp.polish_reg * eye, 18)
    da, b = qp._assemble_active(d, warm)
    G2 = d.A @ qp._blockdiag_dense(Hinv) @ d.A.transpose(-1, -2)
    S = da[:, :, None] * da[:, None, :] * G2 + torch.diag_embed(
        qpp.polish_reg * da + (1.0 - da))
    Sinv = ns_inverse(S, qpp.ns_iters)
    pol_tail = (d.A, da, d.g, b, d.l, d.u)
    stats = {
        "eq_rows": int(((d.u - d.l) <= 1e-9)[0].sum()),
        "inf_bounds": int((d.u[0].abs() > 1e19).sum() + (d.l[0].abs() > 1e19).sum()),
        "zero_rows_A": int((d.A[0].abs().sum(-1) == 0).sum()),
        "active_rows": int(da[0].sum()),
    }
    zy = (admm_zy.admm_zy_iterations_res, admm_zy.admm_zy_iterations_res_plain)
    pol = (polish.polish_solve, polish.polish_solve_plain)
    # the generic path's kernels: the x-space ADMM at sigma > 0 on the same
    # scaled problem, the polish with dense H and its Newton-Schulz inverse
    eye_n = torch.eye(N, dtype=dtype, device=DEV)
    Kinv_s = ns_inverse(K + SIGMA * eye_n, qpp.ns_iters)
    xs_args = (Kinv_s, *admm_args[1:])
    xs_cold = (Kinv_s, *cold_args[1:])
    xk = dict(iters=qpp.iterations, sigma=SIGMA, alpha=qpp.alpha)
    H_reg = d.H + qpp.polish_reg * eye_n
    Hinv_d = ns_inverse(H_reg, qpp.ns_iters)
    S_d = da[:, :, None] * da[:, None, :] * (d.A @ Hinv_d @ d.A.transpose(-1, -2)) \
        + torch.diag_embed(qpp.polish_reg * da + (1.0 - da))
    Sinv_d = ns_inverse(S_d, qpp.ns_iters)
    pk2 = dict(refine=qpp.polish_refine, reg=qpp.polish_reg)
    # one output, as a 1-tuple like every other kernel's
    nw = (lambda *a, **k: (ns_warm.ns_inverse_warm(*a, **k),),
          lambda *a, **k: (ns_warm.ns_inverse_warm_plain(*a, **k),))
    return [
        (K4, "main", prepare.prepare_scaled, prepare.prepare_scaled_plain, prep_args, pk),
        (K1, "main", *zy, admm_args, dict(iters=qpp.iterations, alpha=qpp.alpha)),
        (K1, "resolving", *zy, cold_args, dict(iters=3, alpha=qpp.alpha)),
        (K2, "main", *pol, (Hc, Hinv, Sinv, *pol_tail), pk2),
        (K2, "resolving", *pol,
         (Hc, (0.7 * Hinv[0], 0.7 * Hinv[1], Hinv[2]), 0.7 * Sinv, *pol_tail),
         dict(refine=1, reg=qpp.polish_reg)),
        (K5, "main", admm.admm_iterations_res, admm.admm_iterations_res_plain, xs_args, xk),
        (K5, "resolving", admm.admm_iterations_res, admm.admm_iterations_res_plain,
         xs_cold, dict(xk, iters=3)),
        (K6, "main", admm.admm_iterations, admm.admm_iterations_plain, xs_args[:9], xk),
        (K7, "main", *pol, (H_reg, Hinv_d, Sinv_d, *pol_tail), pk2),
        (K7, "resolving", *pol, (H_reg, 0.7 * Hinv_d, 0.7 * Sinv_d, *pol_tail),
         dict(refine=1, reg=qpp.polish_reg)),
        *((K8, case, *nw, a, dict(warm_iters=2))
          for case, a in ns_warm_cases(K, batch, dtype, rng)),
    ], stats


def ns_warm_cases(K, batch, dtype, rng):
    """(case, (A, W)) of the warm Newton-Schulz kernel: see the tolerance
    table."""
    r = lambda *s: torch.as_tensor(rng.standard_normal(s), device=DEV).to(dtype)
    A42 = K * (1.0 + 1e-3 * r(batch, 1, 1))
    W42 = ns_inverse(K, 30)
    G = r(batch, 70, 42)
    S70 = G @ G.transpose(-1, -2) / 42 + 0.5 * torch.eye(70, dtype=dtype, device=DEV)
    A70 = S70 * (1.0 + 1e-3 * r(batch, 1, 1))
    W70 = ns_inverse(S70, 30)
    nan_w = W42.clone()
    nan_w[:, 3, 5] = float("nan")
    return [("main", (A42, W42)), ("n70", (A70, W70)), ("nan_warm", (A42, nan_w)),
            ("far_warm", (A42, 1e9 * W42)), ("blowup", (1e-20 * K, -5e22 * W42))]


def setup_flat(res):
    """A setup result (dict) as a tuple in the order of SETUP_OUT; flags as
    numbers, so every output goes through the same comparison."""
    cu = res["carry_updates"]
    outs = [res[k] for k in SETUP_RESULT] + [cu[k] for k in SETUP_CARRY]
    outs += list(res["prepared"] or ())
    return tuple(o.to(res["A"].dtype) for o in outs)


def setup_args(batch: int, dtype, rng, step=60, switch=True):
    """Inputs of the setup kernel at a recorded step (60: one leg in swing)
    on a WARMED carry: two steps of the tensor-code setup before it, so the
    old T and J, the stale d(T^-1)/dt and the integral are those of a
    running controller; the warm start is non-zero.  With `switch` a
    quarter of the batch gets another contact pattern (a contact switch
    where the reference is new), `ref_is_new` is False on a third and
    `deriv_valid` False on a fifth; without, every reference is new and
    agrees with the carried contacts."""
    model = anymal_d_model(dtype, DEV)
    cp = ControllerParams()
    off = replay.make_offsets(batch, dtype, rng, DEV)
    carry = wbc.init_carry(batch, dtype, DEV)
    every = torch.ones(batch, dtype=torch.bool, device=DEV)
    for t in (step - 2, step - 1):
        obs, ref, _ = replay.step_inputs(TRAJ, t, batch, dtype, off, DEV)
        s = wbc.wbc_setup(model, cp, obs, ref, carry, every)
        carry = wbc.WBCCarry(qp_warm=carry.qp_warm, **s.carry_updates)
    obs, ref, _ = replay.step_inputs(TRAJ, step, batch, dtype, off, DEV)
    idx = torch.arange(batch, device=DEV)
    rnd = lambda k: torch.as_tensor(0.1 * rng.standard_normal((batch, k)), device=DEV).to(dtype)
    carry = carry._replace(qp_warm=qp.QPState(x=rnd(N), z=rnd(M), y=rnd(M)))
    ref_is_new = every
    if switch:
        contacts = ref.contacts.clone()
        flip = idx % 4 == 1
        contacts[flip, 0] = 1.0 - contacts[flip, 0]
        ref = ref._replace(contacts=contacts)
        ref_is_new = idx % 3 != 0
        carry = carry._replace(deriv_valid=idx % 5 != 2)
    return model, cp, obs, ref, carry, ref_is_new


def setup_problem(batch: int, dtype, rng):
    """The setup kernel's cases at step 60 (`setup_args`, with switches)."""
    qpp = QPSolverParams()
    args = setup_args(batch, dtype, rng)
    carry, ref_is_new = args[4], args[5]
    want = setup_k.setup_batched_plain(*args, qp_params=qpp)
    sw = want["carry_updates"]["switch_flag"]
    stats = {
        "switched": int(sw.sum()), "ref_not_new": int((~ref_is_new).sum()),
        "fd_gate_open": int((~sw & carry.deriv_valid).sum()),
        "swing_legs": int((want["carry_updates"]["prev_contacts"] == 0).sum()),
        "max_abs_old_tdot_inv": float(carry.tdot_inv.abs().max()),
        "max_abs_new_tdot_inv": float(want["carry_updates"]["tdot_inv"].abs().max()),
    }
    fn = lambda *a, **k: setup_flat(setup_k.setup_batched(*a, **k))
    plain = lambda *a, **k: setup_flat(setup_k.setup_batched_plain(*a, **k))
    return [(K3, "main", fn, plain, args, dict(qp_params=qpp)),
            (K3, "plain_variant", fn, plain, args, dict(qp_params=None))], stats


def exact_setup_problem(batch: int, dtype, rng):
    """K3x's cases: "main", recorded step 20 (all feet down, far from any
    contact switch, every reference new); "switch", step 60 with the
    switches of `setup_problem`; "plain_variant", the latter without the
    prepare tail.  The wrapper's `exact_mode=True` runs K3x, its plain
    version `wbc_setup`'s exact branch (forward-mode AD)."""
    qpp = QPSolverParams()
    far = setup_args(batch, dtype, rng, step=20, switch=False)
    near = setup_args(batch, dtype, rng)
    fn = lambda *a, **k: setup_flat(setup_k.setup_batched(*a, exact_mode=True, **k))
    plain = lambda *a, **k: setup_flat(setup_k.setup_batched_plain(*a, exact_mode=True, **k))
    return [(K3X, "main", fn, plain, far, dict(qp_params=qpp)),
            (K3X, "switch", fn, plain, near, dict(qp_params=qpp)),
            (K3X, "plain_variant", fn, plain, near, dict(qp_params=None))]


def setup_bytes(args, got, exact=False) -> int:
    """Bytes the setup kernel must move: every input read once (of the
    carried 18 x 18 T and d(T^-1)/dt only the top 6 rows are read, and the
    exact mode reads neither them nor the carried J; the model table is
    shared by all scenarios), every output written once."""
    _, _, obs, ref, carry, ref_is_new = args
    read = [*obs, *ref, carry.integral_error, carry.prev_contacts,
            carry.switch_flag, carry.deriv_valid, ref_is_new]
    if not exact:
        read += [carry.old_T[:, :6], carry.tdot_inv[:, :6], carry.old_J_st, carry.old_J_sw]
    if len(got) > len(SETUP_RESULT) + len(SETUP_CARRY):
        read += list(carry.qp_warm)
    size = lambda t: t.numel() * t.element_size()
    n_core = len(SETUP_RESULT) + len(SETUP_CARRY)
    written = list(got[:n_core - 2]) + list(got[n_core:])   # the two flags: a byte each
    return sum(size(t) for t in read) + sum(size(t) for t in written) + 2 * got[0].shape[0]


def setup_section_times(args, reps=20, exact=False):
    """Device ms of the setup kernel (float32) cut after each section of
    `setup_k.SECTIONS` (the stop_after probes), then whole without and with
    the prepare tail ("full_plain", "prepare"): {section: [cumulative ms,
    marginal ms]}, each marginal the difference from the section before."""
    out, prev = {}, 0.0
    qpp = QPSolverParams()
    for sec in (*setup_k.SECTIONS, "full_plain", "prepare"):
        kw = dict(exact_mode=exact, qp_params=qpp if sec == "prepare" else None,
                  stop_after=sec if sec in setup_k.SECTIONS else None)
        ms = time_ms(lambda: setup_k.setup_batched(*args, **kw), reps=reps, host_ahead=True)
        out[sec] = [ms, ms - prev]
        prev = ms
    return out


def sub_batch(args, b):
    """The first b scenarios of a kernel's arguments, contiguous."""
    take = lambda t: t[:b].contiguous() if isinstance(t, torch.Tensor) else t
    return tuple(tuple(take(x) for x in a) if isinstance(a, tuple) else take(a)
                 for a in args)


def flat_tensors(args):
    for a in args:
        if isinstance(a, tuple):
            yield from (t for t in a if isinstance(t, torch.Tensor))
        elif isinstance(a, torch.Tensor):
            yield a


def _to_double(a):
    if isinstance(a, RobotModel):
        return a.to(dtype=torch.float64)     # the same rounded constants
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_to_double(x) for x in a))
    if isinstance(a, tuple):
        return tuple(_to_double(x) for x in a)
    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return a.double()
    return a


def output_errors(name, got, want, want64):
    """Per output: abs_err = max |kernel - plain| and scale = max |plain|,
    both over the entries that are not scaled "infinite" bounds
    (|plain| >= 1e19, where kernel and plain must agree in sign and class);
    rel_elem = max elementwise |kernel - plain| / |plain| (prepare's
    measure); and, where a float64 plain result is given, the float32
    kernel's and the float32 plain version's distance from it."""
    out = {}
    for o, g, w, w64 in zip(OUTPUTS[name], got, want, want64 or [None] * len(got)):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}.{o}: kernel output not finite")
        g, w = g.double(), w.double()
        inf = w.abs() >= 1e19
        if not torch.equal(g.abs() >= 1e19, inf) or not torch.equal(g[inf] > 0, w[inf] > 0):
            raise AssertionError(f"{name}.{o}: scaled infinite bounds differ")
        fin = ~inf
        diff = (g - w).abs()[fin]
        row = {"abs_err": float(diff.max()), "scale": float(w[fin].abs().max()),
               "rel_elem": float((diff / w[fin].abs().clamp_min(1e-30)).max())}
        if w64 is not None:
            row["kernel_vs_f64_plain"] = float((g - w64).abs()[fin].max())
            row["plain_vs_f64_plain"] = float((w - w64).abs()[fin].max())
        out[o] = row
    return out


def hold(name, case, dtype, errs):
    """Assert the tolerance table on one comparison's per-output errors."""
    for o, e in errs.items():
        where = f"{name}.{o} ({case}, {str(dtype)[6:]})"
        tol = TOL_F32[(name, case)][o]
        if dtype == torch.float64:          # elementwise outputs stay elementwise
            elem = tol is not FLOOR and tol[0] == ELEM
            tol = (ELEM, TOL_F64[0]) if elem else TOL_F64
        if tol is not FLOOR:
            if tol[0] == ELEM:                 # products only: elementwise
                ok, e["tol"] = e["rel_elem"] <= tol[1], f"{tol[1]:g} elementwise"
            else:
                bound = tol[0] * e["scale"] + tol[1]
                ok, e["tol"] = e["abs_err"] <= bound, bound
            if not ok:
                raise AssertionError(f"{where}: kernel disagrees with its plain version: {e}")
        if (tol is FLOOR or (name in (K3, K3X) and o in SETUP_GUARDED)) \
                and "kernel_vs_f64_plain" in e:
            bound = GUARD * e["plain_vs_f64_plain"] + GUARD_ATOL
            if e["kernel_vs_f64_plain"] > bound:
                raise AssertionError(
                    f"{where}: float32 kernel is {e['kernel_vs_f64_plain']:.3e} from the "
                    f"float64 plain version, the float32 plain version only "
                    f"{e['plain_vs_f64_plain']:.3e}")


def compare(name, case, fn, plain, args, kw, dtype, check=True):
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    want64 = plain(*_to_double(args), **kw) if dtype == torch.float32 else None
    errs = output_errors(name, got, want, want64)
    if check:
        hold(name, case, dtype, errs)
    return errs, got


def time_ms(fn, reps=20, warmup=3, host_ahead=False):
    """Median device time of one call between two CUDA events.  With
    `host_ahead` the card is first kept busy for about 2 ms, so the host has
    enqueued the whole call before the first event passes and its own time
    (allocating outputs, marshalling pointers) is not counted: the time of
    the kernel, not of its wrapper."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if host_ahead:
            torch.cuda._sleep(4_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def flops_of(name: str, batch: int, kw: dict, n: int = N) -> float:
    """Multiply-adds counted as 2, matvecs and matrix products only (the
    elementwise tails are a few percent)."""
    m, k = M, KBLK
    prep = lambda sweeps: sweeps * (2 * n * n + 4 * m * n) + 2 * (n * n + m * n)
    if name == K8:
        # two products a step, 2 n^3 each: the least work for an accepted
        # warm start, whose first step reuses the check's A W
        return float(2 * kw["warm_iters"] * 2 * n ** 3) * batch
    if name in (K5, K6):
        mv = 2 * (2 * m * n + n * n)                 # A^T t, K^-1 ., A .
        epi = 2 * (2 * m * n + n * n) if name == K5 else 0   # A x, Hs x, A^T y
        return float(kw["iters"] * mv + epi) * batch
    if name == "prepare_scaled":
        per = prep(kw["sweeps"])
    elif name in (K3, K3X):
        # about 17,000 multiply-adds from the stages' loop bounds (Mc_jj 2.6k,
        # foot Jacobians 2k, the J rows 1.7k, X 1.3k, kinematics 1.3k, world
        # inertias 1.4k, ...), plus the prepare tail in the fused variant;
        # K3x's tangent stages add about 15,000 (Mbj's tangent 4.3k, dX 3k,
        # the feet's 2k, world inertias' 1.4k, d(T^-1)/dt 2.3k, FK 1k, ...)
        qpp = kw["qp_params"]
        per = 35_000 + (30_000 if name == K3X else 0) \
            + (prep(qpp.scaling_iters) if qpp is not None else 0)
    elif name == "admm_zy_iterations_res":
        mv = 2 * (2 * m * n + n * n)                 # A^T t, K^-1 ., A .
        per = kw["iters"] * mv + 2 * (n * n + m * n) + 2 * (m * n + n * n) \
            + 2 * (m * n + n * n + m * n)
    else:
        # compact H or H^-1 apply, or dense
        hmv = 2 * n * n if name == K7 else 2 * (k * k + n)
        init = 2 * hmv + 2 * (2 * m * n) + 2 * m * m
        per_ref = 3 * hmv + 4 * (2 * m * n) + 2 * m * m
        per = init + kw["refine"] * per_ref + 2 * (2 * m * n) + hmv
    return float(per) * batch


def ns_warm_extra(row, case, fn, plain, args, kw, got):
    """The warm Newton-Schulz kernel beside the torch.matmul chain of the
    solver's warm update (`linalg.ns_inverse_warm_shared`, cuBLAS products)
    at n = 42 and 70, and its guarded cases against the Jacobi start X0."""
    A, W = args
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=DEV)
    err = torch.amax(torch.sum(torch.abs(eye - A @ W), dim=-1), dim=-1)
    row[f"{case}_warm_accepted"] = int((err < 1e3).sum())
    chain = lambda: ns_inverse_warm_shared(A, W, kw["warm_iters"])
    if case == "main":
        row["torch_chain_ms"] = time_ms(chain, host_ahead=True)
    elif case == "n70":
        size = lambda t: t.numel() * t.element_size()
        t_bytes = (size(A) + size(W) + size(got[0])) / HBM_BYTES_PER_S * 1e3
        t_ops = flops_of(K8, BATCH, kw, n=n) / F32_FLOPS * 1e3
        row["n70"] = {"ms": time_ms(lambda: fn(*args, **kw), host_ahead=True),
                      "plain_ms": time_ms(lambda: plain(*args, **kw), reps=5, warmup=1),
                      "torch_chain_ms": time_ms(chain, host_ahead=True),
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    elif case == "blowup":
        # the iterate passed 1e30 in every scenario: X0 itself comes back
        x0 = ns_warm._cold_x0(A)
        gap = float((got[0] - x0).abs().max() / x0.abs().max())
        row["blowup_vs_x0"] = gap
        if gap > 1e-5 or not bool((got[0].abs() < 1e30).all()):
            raise AssertionError(f"{K8}: blow-up case did not return X0 ({gap:.3e})")
    if case in ("nan_warm", "far_warm", "blowup") and row[f"{case}_warm_accepted"] != (
            A.shape[0] if case == "blowup" else 0):
        raise AssertionError(f"{K8} {case}: the warm-start guard read {err}")


def check_kernels():
    rng = np.random.default_rng(SEED)
    rows = {}
    with torch.no_grad():
        cases, stats = kernel_problem(BATCH, torch.float32, rng)
        setup_cases, stats["setup"] = setup_problem(BATCH, torch.float32, rng)
        setup_cases += exact_setup_problem(BATCH, torch.float32, rng)
        for name, case, fn, plain, args, kw in cases + setup_cases:
            errs, got = compare(name, case, fn, plain, args, kw, torch.float32)
            if case != "main":
                rows[name][f"{case}_f32"] = errs
                if name == K8:
                    ns_warm_extra(rows[K8], case, fn, plain, args, kw, got)
                continue
            ms = time_ms(lambda: fn(*args, **kw), host_ahead=True)
            ms_with_host = time_ms(lambda: fn(*args, **kw))
            plain_ms = time_ms(lambda: plain(*args, **kw), reps=5, warmup=1)
            if name in (K3, K3X):
                nbytes = setup_bytes(args, got, exact=name == K3X)
            else:
                nbytes = sum(t.numel() * t.element_size() for t in flat_tensors(args)) \
                    + sum(t.numel() * t.element_size() for t in got)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops_of(name, BATCH, kw) / F32_FLOPS * 1e3
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": max(e["abs_err"] for e in errs.values()),
                "main_f32": errs,
                "ms": ms, "ms_with_wrapper_host_time": ms_with_host, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops_of(name, BATCH, kw),
                "library_ms": None,
                "shape": {"B": BATCH, "n": N, "m": M, **{k: v for k, v in kw.items()
                                                         if isinstance(v, int)}},
            }
            if name == K8:
                ns_warm_extra(rows[K8], case, fn, plain, args, kw, got)
            if name in (K3, K3X):
                # the variant without the prepare tail, and its bound (bytes)
                kw0 = dict(qp_params=None)
                rows[name]["ms_plain_variant"] = time_ms(lambda: fn(*args, **kw0),
                                                         host_ahead=True)
                rows[name]["bound_ms_plain_variant"] = setup_bytes(
                    args, fn(*args, **kw0), exact=name == K3X) / HBM_BYTES_PER_S * 1e3
            if name in (K2, K7):
                # the sub-batches of the main and the generic path: the
                # rescue, the drop round, the rescue's round 2
                for b in (128, 64, 32):
                    ab = sub_batch(args, b)
                    rows[name][f"ms_B{b}"] = time_ms(lambda: fn(*ab, **kw), host_ahead=True)
            if name in (K1, K5, K6):
                # the rescue's sub-batch (K5's held to the table too) and a
                # ragged one; the load and the epilogue alone; the
                # instantiation the shape takes and what ptxas made of it
                for b in (128, 37):
                    ab = sub_batch(args, b)
                    if name == K5 and b == 128:
                        rows[K5]["main_f32_B128"] = compare(
                            name, case, fn, plain, ab, kw, torch.float32)[0]
                    rows[name][f"ms_B{b}"] = time_ms(lambda: fn(*ab, **kw), host_ahead=True)
                kw0 = dict(kw, iters=0)
                rows[name]["ms_iters0"] = time_ms(lambda: fn(*args, **kw0), host_ahead=True)
                mod = admm_zy if name == K1 else admm
                before = dict(mod.VARIANT_LAUNCHES)
                fn(*args, **kw)
                rows[name]["variant"] = [v for v, c in mod.VARIANT_LAUNCHES.items()
                                         if c != before[v]]
                rows[name]["ptxas"] = build.ptxas_report(
                    "admm_zy.cu" if name == K1 else "admm.cu")
            if name in (K3, K3X, K2, K7, K1, K5, K6):
                # the same launch again: a race between threads would rarely
                # repeat bit for bit
                again = fn(*args, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{name}: two launches on the same inputs differ")
                rows[name]["repeat_launch_bit_identical"] = True
        # K4 is the first kernel timed, after the card idled through the
        # build: timed once more here, after the other eight
        _, _, fn, _, args, kw = next(c for c in cases if c[0] == K4 and c[1] == "main")
        rows[K4]["ms_again"] = time_ms(lambda: fn(*args, **kw), host_ahead=True)
        # the same cases in float64 (the scalar type is a template
        # parameter) at the full batch, and both types at a ragged batch
        for batch, dtype in ((BATCH, torch.float64), (37, torch.float32),
                             (37, torch.float64)):
            probs, _ = kernel_problem(batch, dtype, rng)
            probs += setup_problem(batch, dtype, rng)[0]
            probs += exact_setup_problem(batch, dtype, rng)
            for name, case, fn, plain, args, kw in probs:
                errs, _ = compare(name, case, fn, plain, args, kw, dtype)
                rows[name][f"{case}_{str(dtype)[6:].replace('float', 'f')}_B{batch}"] = {
                    o: e["rel_elem"] if name == K4
                    else e["abs_err"] / e["scale"] if e["scale"] else e["abs_err"]
                    for o, e in errs.items()}
    return rows, stats


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def run_walk(batch: int, qpp: QPSolverParams, offsets, record=None, steps=None,
             setup_backend="auto", cparams=None, qp_backend="kernel", dtype=torch.float32):
    """Replay the recorded walk through wbc_step_batched on the card in
    `dtype` (float32 unless asked).  Returns per-step host times (ms), max
    KKT and flagged counts; `record(t, out)` sees every step's output."""
    model = anymal_d_model(dtype, DEV)
    steps = TRAJ["base_R"].shape[0] if steps is None else steps
    flag_thr = qpp.rescue_threshold if qpp.rescue_threshold > 0 else 3e-3
    ms, kkts, flagged = [], [], []

    def on_step(t, out, step_ms):
        ms.append(step_ms)
        if not torch.isfinite(out.tau).all():
            raise AssertionError(f"step {t}: tau not finite")
        kkt = out.qp_info.kkt_residual
        kkts.append(float(kkt.max()))
        flagged.append(int((kkt > flag_thr).sum()))
        if record is not None:
            record(t, out)

    replay.replay(model, TRAJ, range(steps), batch, qpp, offsets, on_step, timed=True,
                  setup_backend=setup_backend, cparams=cparams, qp_backend=qp_backend)
    return ms, kkts, flagged


COMPARE_STEPS = 70     # the window the shorter paths run: steps 0..69, one contact switch
# the exact-derivative paths' solver: the shipped parameters with the rescue
# sized to the burst of scenarios above the threshold next to a contact
# switch (the reference's own record: `rescue_batch` = 128 could not absorb
# it there; 2048 did)
RESCUE_2048 = QPSolverParams(rescue_batch=2048)
EXACT_CP = ControllerParams(exact_derivatives=True)
# each path: steps (None: all), setup backend, solver params, controller
# params, kernels it must launch at least once a step (the setup's exactly
# once), kernels it must not, and whether its KKT and flagged counts are held
# to the bars (the exact path under the shipped solver parameters is printed)
PATHS = {
    "kernel": dict(steps=None, setup_backend="kernel", qpp=QPSolverParams(),
                   runs=(K3, K1, K2), never=(K4, K5, K7, K3X)),
    "torch": dict(steps=COMPARE_STEPS, setup_backend="torch", qpp=QPSolverParams(),
                  runs=(K4, K1, K2), never=(K3, K5, K7, K3X)),
    "sigma": dict(steps=COMPARE_STEPS, setup_backend="kernel",
                  qpp=QPSolverParams(sigma=SIGMA),
                  runs=(K3, K5, K2), never=(K4, K1, K7, K3X)),
    "exact_shipped": dict(steps=COMPARE_STEPS, setup_backend="kernel", qpp=QPSolverParams(),
                          cp=EXACT_CP, runs=(K3X, K1, K2), never=(K3, K4, K5, K7),
                          quality=False),
    "exact": dict(steps=COMPARE_STEPS, setup_backend="kernel", qpp=RESCUE_2048, cp=EXACT_CP,
                  runs=(K3X, K1, K2), never=(K3, K4, K5, K7)),
    "exact_oracle": dict(steps=COMPARE_STEPS, setup_backend="kernel", qpp=RESCUE_2048,
                         cp=ControllerParams(exact_derivatives=True, exact_epilogue=True),
                         runs=(K3, K1, K2), never=(K3X, K4, K5, K7)),
}


def check_run(tag, launches, plain, kkts, flagged, runs, never, n_steps, quality=True):
    """The assertions every counted run shares; with `quality` False the
    KKT and flagged counts are returned, not held to the bars, and only
    have to be finite."""
    for k in runs:
        if launches[k] == 0:
            raise AssertionError(f"{tag}: {k} was never launched: {launches}")
    for k in never:
        if launches[k] != 0:
            raise AssertionError(f"{tag} launched {k}: {launches}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on {tag}: {plain}")
    n_flag = sum(flagged)
    if not quality:
        if not np.isfinite(kkts).all():
            raise AssertionError(f"{tag}: a KKT residual is not finite")
        return n_flag
    if n_flag > 1e-4 * BATCH * n_steps:
        raise AssertionError(
            f"{tag}: {n_flag} flagged scenario-steps (kkt > threshold) of {BATCH * n_steps}")
    if max(kkts) > 3e-3:
        raise AssertionError(f"{tag}: max KKT {max(kkts):.3e} > 3e-3")
    return n_flag


def step_summary(ms, kkts, flagged, n_flag, launches, n_steps, syncs):
    steady = sorted(ms[1:])
    med = statistics.median(steady)
    # K1's launches by instantiation: the WBC's shape keeps the matrices in
    # registers
    k1_variants = dict(admm_zy.VARIANT_LAUNCHES)
    if sum(k1_variants.values()) != launches[K1] or k1_variants["shared_memory"]:
        raise AssertionError(f"K1 by instantiation {k1_variants}, {launches[K1]} launches")
    # and so do K5's and K6's
    k5_variants = dict(admm.VARIANT_LAUNCHES)
    if sum(k5_variants.values()) != launches[K5] + launches[K6] \
            or k5_variants["shared_memory"]:
        raise AssertionError(f"K5/K6 by instantiation {k5_variants}, "
                             f"{launches[K5] + launches[K6]} launches")
    return {
        "steps": n_steps, "batch": BATCH, "dtype": "float32",
        "ms_per_step_median": med,
        "ms_per_step_p90": steady[int(0.9 * (len(steady) - 1))],
        "ms_first_step": ms[0],
        "solves_per_s": BATCH / (med * 1e-3),
        "max_kkt": max(kkts), "flagged_max": max(flagged),
        "flagged_scenario_steps": n_flag,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "k1_launches_by_variant": k1_variants,
        "k5_k6_launches_by_variant": k5_variants,
        "host_syncs_per_step": syncs / n_steps,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }


class StageSpy:
    """Counts the launches of the polish (K2 with a compact H, K7 with a
    dense one) and of the x-space ADMM with its epilogue (K5) by the solver
    stage that makes them, with their batch sizes, while installed (a
    context manager around a counted run; the spies keep references only:
    no device work).  Polish: the first of a solve is round 1, a later one
    the drop round; inside the rescue the first of a stage is its round 1,
    a later one its round 2.  K5: the first of a solve is round 1, a later
    one the cold start's extra iterations; inside the rescue, the rescue.
    `on_solve(data, out)` sees every solve."""

    def __init__(self, on_solve=None):
        self.stages = {K2: {}, K7: {}, K5: {}}
        self.where = {"polish": 0, "admm": 0, "rescue": None}
        self.on_solve = on_solve

    def _count(self, kernel, stage, batch):
        row = self.stages[kernel].setdefault(stage, {"launches": 0, "batch_sizes": {}})
        row["launches"] += 1
        row["batch_sizes"][batch] = row["batch_sizes"].get(batch, 0) + 1

    def __enter__(self):
        self.orig = (qp.solve_batched, qp._rescue_core, polish.polish_solve,
                     admm.admm_iterations_res)
        solve, core, pol, k5 = self.orig
        where = self.where

        def solve_spy(data, *a, **k):
            where["polish"] = where["admm"] = 0
            out = solve(data, *a, **k)
            if self.on_solve is not None:
                self.on_solve(data, out)
            return out

        def core_spy(*a, **k):
            where["rescue"] = 0
            try:
                return core(*a, **k)
            finally:
                where["rescue"] = None

        def polish_spy(H, *a, **k):
            if where["rescue"] is None:
                stage = "round1" if where["polish"] == 0 else "drop_round"
                where["polish"] += 1
            else:
                stage = "rescue" if where["rescue"] == 0 else "rescue_round2"
                where["rescue"] += 1
            self._count(K2 if isinstance(H, tuple) else K7, stage, a[2].shape[0])
            return pol(H, *a, **k)

        def k5_spy(Kinv, *a, **k):
            if where["rescue"] is None:
                stage = "round1" if where["admm"] == 0 else "cold_start"
                where["admm"] += 1
            else:
                stage = "rescue"
            self._count(K5, stage, Kinv.shape[0])
            return k5(Kinv, *a, **k)

        qp.solve_batched, qp._rescue_core = solve_spy, core_spy
        polish.polish_solve, admm.admm_iterations_res = polish_spy, k5_spy
        return self

    def __exit__(self, *exc):
        (qp.solve_batched, qp._rescue_core, polish.polish_solve,
         admm.admm_iterations_res) = self.orig

    def by_stage(self, tag, launches):
        """{"k2_launches_by_stage": ..., and k7's and k5's where they ran};
        raises unless each kernel's stages sum to its launch count."""
        out = {}
        for k, name in ((K2, "k2"), (K7, "k7"), (K5, "k5")):
            total = sum(r["launches"] for r in self.stages[k].values())
            if total != launches[k]:
                raise AssertionError(f"{tag}: {k} by stage {self.stages[k]}, "
                                     f"{launches[k]} launches")
            if k == K2 or total:
                out[f"{name}_launches_by_stage"] = self.stages[k]
        return out


def walk_kept(qpp, offsets, steps, qp_backend, dtype=torch.float32, setup_backend="auto",
              cparams=None):
    """Replay steps 0..steps-1 at B = 4096, the counters zeroed just before,
    and keep the first COMPARE_STEPS steps' (tau, KKT, sign violation).
    Returns (kept, (ms, kkts, flagged), the run's StageSpy)."""
    kept, last = [], {}

    def on_solve(data, out):               # keeps references only: no device work
        last["data"], last["state"] = data, out[0]

    def record(t, out):
        if t < COMPARE_STEPS:
            st = last["state"]
            kept.append((out.tau.clone(), out.qp_info.kkt_residual.clone(),
                         qp._sign_violation(last["data"], st.x, st.y)))

    kernels.reset_counts()
    qp.HOST_SYNCS = 0
    torch.cuda.reset_peak_memory_stats()
    with StageSpy(on_solve) as spy:
        run = run_walk(BATCH, qpp, offsets, record, steps, setup_backend, cparams, qp_backend,
                       dtype)
    return kept, run, spy


def drive_path(path: str, offsets):
    """One path of the control cycle at B = 4096 in float32, the launch
    counts zeroed just before and read just after.  Returns (launches,
    summary, [(tau, kkt) of the first COMPARE_STEPS steps])."""
    spec = PATHS[path]
    qpp, backend, cp = spec["qpp"], spec["setup_backend"], spec.get("cp")
    # warm-up outside the counted run: first-use allocator and library
    # start-up costs are set-up, not step time
    run_walk(BATCH, qpp, offsets, steps=3, setup_backend=backend, cparams=cp)
    n_steps = TRAJ["base_R"].shape[0] if spec["steps"] is None else spec["steps"]
    kept, (ms, kkts, flagged), spy = walk_kept(qpp, offsets, n_steps, "kernel",
                                               setup_backend=backend, cparams=cp)
    launches = kernels.launch_counts()
    by_stage = spy.by_stage(f"the {path} path", launches)
    syncs = qp.HOST_SYNCS
    n_flag = check_run(f"the {path} path", launches, kernels.plain_counts(), kkts, flagged,
                       spec["runs"], spec["never"], n_steps, spec.get("quality", True))
    setup, *solver = spec["runs"]
    if launches[setup] != n_steps or any(launches[k] < n_steps for k in solver):
        raise AssertionError(f"the {path} path: {launches} in {n_steps} steps")
    summary = {"path": path, "setup_backend": backend, "sigma": qpp.sigma,
               "exact_derivatives": bool(cp and cp.exact_derivatives),
               "exact_epilogue": bool(cp and cp.exact_epilogue),
               "rescue_batch": qpp.rescue_batch,
               "quality_asserted": spec.get("quality", True),
               **step_summary(ms, kkts, flagged, n_flag, launches, n_steps, syncs),
               **by_stage}
    if not summary["quality_asserted"]:
        # where the burst sits: flagged scenarios per step, on the steps
        # that have any
        summary["flagged_per_step"] = {t: f for t, f in enumerate(flagged) if f}
    return launches, summary, kept


def compare_paths(kept_a, kept_b, sv_cert=1e-5, bar=1e-3):
    """Two paths against each other, same offsets, steps 0..69: per step
    max |tau_a - tau_b| and max |KKT difference| over the batch.  Asserted
    only on the scenario-steps both paths certify, to `bar` N.m (None:
    printed only): relative KKT < 1e-5 AND sign violation < `sv_cert`, the
    solver's own acceptance measure at 1e-5.
    An uncertified float32 step keeps an ADMM iterate, and two of those
    differ by the ADMM's accuracy, not by rounding; a polish of a wrong
    active set can reach a small KKT residual with wrong-signed multipliers
    (a saddle, not the solution), which only the sign violation shows.  The
    KKT-only count and gap are printed beside, not asserted."""
    per_step, worst_cert, n_cert, worst_kkt, n_kkt = [], 0.0, 0, 0.0, 0
    for (ta, ka, sa), (tb, kb, sb) in zip(kept_a, kept_b):
        dtau = (ta.double() - tb.double()).abs().amax(dim=1)
        kkt_ok = (ka < 1e-5) & (kb < 1e-5)
        cert = kkt_ok & (sa < sv_cert) & (sb < sv_cert)
        c = float(dtau[cert].max()) if bool(cert.any()) else 0.0
        worst_cert, n_cert = max(worst_cert, c), n_cert + int(cert.sum())
        if bool(kkt_ok.any()):
            worst_kkt = max(worst_kkt, float(dtau[kkt_ok].max()))
        n_kkt += int(kkt_ok.sum())
        per_step.append({"max_dtau_Nm": float(dtau.max()), "max_dtau_Nm_certified": c,
                         "max_dkkt": float((ka - kb).abs().max()),
                         "certified": int(cert.sum()), "kkt_only": int(kkt_ok.sum()),
                         "kkt_only_over_1e-3_Nm": int((kkt_ok & (dtau > 1e-3)).sum())})
    if n_cert == 0:
        raise AssertionError("no scenario-step certified by both paths")
    if bar is not None and worst_cert > bar:
        raise AssertionError(f"paths differ by {worst_cert:.3e} N.m on a certified step")
    return {"steps": len(per_step), "sign_violation_certified_below": sv_cert,
            "certified_scenario_steps": n_cert,
            "max_dtau_Nm_certified": worst_cert,
            "kkt_only_scenario_steps": n_kkt, "max_dtau_Nm_kkt_only": worst_kkt,
            "max_dtau_Nm": max(r["max_dtau_Nm"] for r in per_step),
            "max_dkkt": max(r["max_dkkt"] for r in per_step), "per_step": per_step}


def main_paths(offsets):
    """The paths of the control step: the torch-setup and sigma paths each
    against the main one, the exact path against its oracle.  Returns
    (launches, summaries, comparisons, the main path's kept steps)."""
    out = {}
    for path in PATHS:
        out[path] = drive_path(path, offsets)
    kept_k = out["kernel"][2]
    versus = {f"kernel_path_vs_{p}_path": compare_paths(kept_k, out[p][2])
              for p in ("torch", "sigma")}
    versus["kernel_path_vs_exact_oracle"] = compare_paths(out["exact"][2],
                                                          out["exact_oracle"][2])
    return ({p: v[0] for p, v in out.items()}, {p: v[1] for p, v in out.items()}, versus,
            kept_k)


# --------------------------------------------------------------------------
# the generic solve: the walk's QPs without the closed-form H^-1
# --------------------------------------------------------------------------

GENERIC_STEPS = range(30, COMPARE_STEPS)   # one contact switch (step 40)
# dense vs compact x, share of max(1, max |x|), where both certify (KKT and
# sign violation): the two polish paths use different H^-1 (closed form vs
# Newton-Schulz) and their refinement passes converge x to the same active
# set's solution; an H100 measured 4.1e-7 (7.7e-5 on KKT alone: a saddle)
X_TOL = 1e-5


def record_qps(offsets):
    """Replay the main path over steps 0..69 and keep, for steps 30..69, the
    QP each step solved: data, switch-masked warm start, per-scenario warm
    mask and switch flags, and its solution, certificate and sign
    violation.  The compact-H
    path must leave the cache's dense H^-1 slot as it was (zero)."""
    rec, calls = [], {"solve": 0}
    orig_solve, orig_mask = qp.solve_batched, wbc._switch_masked_warm
    clone = lambda tup: type(tup)(*(t.clone() for t in tup))

    def mask_spy(carry, switch):
        calls["switch"] = switch.clone()
        return orig_mask(carry, switch)

    def solve_spy(data, warm, params, backend, **kw):
        out = orig_solve(data, warm, params, backend, **kw)
        if calls["solve"] in GENERIC_STEPS:
            rec.append(dict(data=clone(data), warm=clone(warm), switch=calls["switch"],
                            use_warm=kw["use_warm"].clone(), x=out[0].x.clone(),
                            kkt=out[1].kkt_residual.clone(),
                            sv=qp._sign_violation(data, out[0].x, out[0].y)))
        calls["solve"] += 1
        return out

    qp.solve_batched, wbc._switch_masked_warm = solve_spy, mask_spy
    try:
        model = anymal_d_model(torch.float32, DEV)
        _, cache = replay.replay(model, TRAJ, range(COMPARE_STEPS), BATCH, QPSolverParams(),
                                 offsets)
    finally:
        qp.solve_batched, wbc._switch_masked_warm = orig_solve, orig_mask
    if bool(cache.hinv.any()):
        raise AssertionError("the compact-H path wrote the cache's dense H^-1 slot")
    return rec


def generic_path(rec, sigma, qpp=None):
    """The recorded QPs through `solve_batched(hinv_fn=None)` with a carried
    cache, each step warm-started from this path's previous solution (duals
    dropped where the contacts switched), under the recorded per-scenario
    warm mask; the cache starts empty (mask all False).  `qpp`: other
    solver parameters than the shipped ones at `sigma`; their solutions
    are compared with the main path's, not held to X_TOL (two algorithms
    part within what the 1e-5 certificate admits)."""
    shipped = QPSolverParams(sigma=sigma)
    qpp = shipped if qpp is None else qpp

    def run(steps):
        cache = qp.make_cache(BATCH, N, M, qpp, torch.float32, DEV)
        state, ms, kkts, flagged, worst, n_cert, worst_kkt = None, [], [], [], 0.0, 0, 0.0
        for i, r in enumerate(rec[:steps]):
            if state is None:
                warm, use_warm = r["warm"], torch.zeros(BATCH, dtype=torch.bool, device=DEV)
            else:
                sw = r["switch"][:, None]
                warm = qp.QPState(x=state.x, z=torch.where(sw, 0.0, state.z),
                                  y=torch.where(sw, 0.0, state.y))
                use_warm = r["use_warm"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, info, cache = qp.solve_batched(r["data"], warm, qpp, cache=cache,
                                                  use_warm=use_warm)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0 and not bool(cache.hinv.any()):
                # the first step inverts H cold; warm steps at
                # ns_warm_iters_polish = 0 then pass the carried H^-1 through
                raise AssertionError("the generic path left the cache's dense H^-1 empty")
            kkt = info.kkt_residual
            if not torch.isfinite(state.x).all():
                raise AssertionError(f"generic path, sigma {sigma}: x not finite")
            kkts.append(float(kkt.max()))
            flagged.append(int((kkt > qpp.rescue_threshold).sum()))
            # certified as in compare_paths: KKT and sign violation both small
            kkt_ok = (kkt < 1e-5) & (r["kkt"] < 1e-5)
            cert = kkt_ok & (qp._sign_violation(r["data"], state.x, state.y) < 1e-5) \
                & (r["sv"] < 1e-5)
            scale = torch.clamp_min(r["x"].abs().amax(dim=1), 1.0)
            dx = (state.x - r["x"]).abs().amax(dim=1) / scale
            if bool(cert.any()):
                worst = max(worst, float(dx[cert].max()))
            if bool(kkt_ok.any()):
                worst_kkt = max(worst_kkt, float(dx[kkt_ok].max()))
            n_cert += int(cert.sum())
        return ms, kkts, flagged, worst, n_cert, worst_kkt

    run(3)                                     # warm-up, not counted
    kernels.reset_counts()
    qp.HOST_SYNCS = 0
    torch.cuda.reset_peak_memory_stats()
    with StageSpy() as spy:
        ms, kkts, flagged, worst, n_cert, worst_kkt = run(len(rec))
    launches = kernels.launch_counts()
    by_stage = spy.by_stage(f"the generic path (sigma {sigma})", launches)
    admm_k, other = (K5, K1) if sigma else (K1, K5)
    n_flag = check_run(f"the generic path (sigma {sigma})", launches, kernels.plain_counts(),
                       kkts, flagged, (K7, admm_k), (K2, other, K3), len(rec))
    if n_cert == 0 or (worst > X_TOL and qpp == shipped):
        raise AssertionError(f"generic (dense H) vs main path (compact H): x differs by "
                             f"{worst:.3e} of its scale where both certify ({n_cert})")
    return launches, {
        "path": "generic", "sigma": sigma, "steps_of_the_walk": [GENERIC_STEPS.start,
                                                                 GENERIC_STEPS.stop - 1],
        **step_summary(ms, kkts, flagged, n_flag, launches, len(rec), qp.HOST_SYNCS),
        "dense_vs_compact_x": {"max_share_of_scale": worst,
                               "tol": X_TOL if qpp == shipped else None,
                               "certified_scenario_steps": n_cert,
                               "max_share_of_scale_kkt_only": worst_kkt},
        **by_stage,
    }


def no_cache_step():
    """One cold control step without a cache (step 0 of the walk, B = 4096):
    every inverse cold, the plain Schur polish; returns (out, carry)."""
    model = anymal_d_model(torch.float32, DEV)
    obs, ref, new = replay.step_inputs(TRAJ, 0, BATCH, torch.float32,
                                       replay.make_offsets(BATCH, torch.float32,
                                                           np.random.default_rng(SEED + 2),
                                                           DEV), DEV)
    carry = wbc.init_carry(BATCH, torch.float32, DEV)
    step = lambda: wbc.wbc_step_batched(model, ControllerParams(), QPSolverParams(), obs, ref,
                                        carry, new)
    step()                                     # warm-up
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if len(result) != 2:
        raise AssertionError("a step without a cache returns (out, carry)")
    out = result[0]
    kkt = out.qp_info.kkt_residual
    if not torch.isfinite(out.tau).all() or float(kkt.max()) > 3e-3:
        raise AssertionError(f"cold step without a cache: max KKT {float(kkt.max()):.3e}")
    return {"path": "no_cache", "batch": BATCH, "ms": ms, "max_kkt": float(kkt.max()),
            "launches": kernels.launch_counts(), "plain_calls": kernels.plain_counts()}


def standalone_kernels(rec):
    """The two kernels no path of the control step runs, driven through
    their entry points over the recorded QPs: the warm Newton-Schulz update
    of K^-1 = (sH + sigma I + A^T rho A)^-1 from step to step (beside the
    solver's torch.matmul chain `ns_inverse_warm_shared`, compared where the
    warm start is accepted), and the x-space ADMM loop without its epilogue
    on each scaled problem from its scaled warm start."""
    qpp = QPSolverParams(sigma=SIGMA)
    eye = torch.eye(N, device=DEV)
    kernels.reset_counts()
    X, worst, accepted, kkts = None, 0.0, 0, []
    for r in rec:
        d, w = r["data"], r["warm"]
        sH, sA, sg, sl, su, rho, wxs, wzs, wys, ds, es = prepare.prepare_scaled(
            d.H, d.A, d.g, d.l, d.u, w.x, w.z, w.y, sweeps=qpp.scaling_iters,
            rho0=qpp.rho, rho_eq_scale=qpp.rho_eq_scale)
        K = sH + SIGMA * eye + (sA.transpose(-1, -2) * rho[:, None, :]) @ sA
        if X is None:
            X = ns_inverse(K, qpp.ns_iters)
        else:
            ok = torch.amax(torch.sum(torch.abs(eye - K @ X), dim=-1), dim=-1) < 1e3
            chain = ns_inverse_warm_shared(K, X, qpp.ns_warm_iters)
            X = ns_warm.ns_inverse_warm(K, X, qpp.ns_warm_iters)
            gap = (X - chain).abs().amax(dim=(1, 2)) / chain.abs().amax(dim=(1, 2))
            accepted += int(ok.sum())
            if bool(ok.any()):
                worst = max(worst, float(gap[ok].max()))
            # where the contacts switched, a cache user inverts cold
            cold = ~r["use_warm"]
            if bool(cold.any()):
                X = torch.where(cold[:, None, None], ns_inverse(K, qpp.ns_iters), X)
        x, z, y = admm.admm_iterations(X, sA, sg, sl, su, rho, wxs, wzs, wys,
                                       iters=qpp.iterations, sigma=SIGMA, alpha=qpp.alpha)
        pr, du = qp.kkt_residual(d, ds * x, es * y)
        kkts.append(float(torch.maximum(pr, du).max()))
    launches = kernels.launch_counts()
    if launches[K8] != len(rec) - 1 or launches[K6] != len(rec):
        raise AssertionError(f"standalone kernels: {launches}")
    if worst > 1e-3 or not all(np.isfinite(kkts)):
        raise AssertionError(f"warm Newton-Schulz kernel vs torch chain: {worst:.3e}")
    return launches, {"path": "standalone", "steps": len(rec), "batch": BATCH,
                      "ns_warm_vs_torch_chain_max_share": worst, "warm_accepted": accepted,
                      "admm_loop_max_kkt": max(kkts)}


def torque_errors(qpp):
    """B = 8 unperturbed replay through the main path (fused setup kernel)
    under `qpp` against the float64 torque record: the torque errors
    (N.m), the KKT residuals, and the steps the solver certifies
    (relative KKT < 1e-5)."""
    taus, kk = [], []

    def record(t, o):
        taus.append(o.tau[0].double().cpu().numpy())
        kk.append(float(o.qp_info.kkt_residual[0]))

    run_walk(8, qpp, None, record)
    err = np.abs(np.stack(taus) - TORQUE_F64).max(axis=1)
    kk = np.asarray(kk)
    cert = kk < 1e-5
    return err, kk, cert, {
        "max_Nm": float(err.max()), "p99_Nm": float(np.percentile(err, 99)),
        "median_Nm": float(np.median(err)), "step_of_max": int(err.argmax()),
        "steps_over_1e-3_Nm": int((err > 1e-3).sum()), "max_kkt": float(kk.max()),
        "certified_steps": int(cert.sum()),
        "max_Nm_certified": float(err[cert].max()) if cert.any() else None,
    }


def torque_parity():
    """B = 8 unperturbed replay through the main path against the float64
    torque record.  Two configurations: the shipped defaults, where a
    step's torque is held to the record only where the solver certifies it
    (relative KKT < 1e-5; the 3e-3 rescue threshold leaves uncertified
    steps at ADMM accuracy), and the certificate configuration
    (rescue_threshold = 1e-5), held to 1e-3 N.m at every step."""
    out = {}
    for tag, qpp in (("defaults", QPSolverParams()),
                     ("certificate", QPSolverParams(rescue_threshold=1e-5))):
        err, kk, cert, out[tag] = torque_errors(qpp)
        if kk.max() > 3e-3:
            raise AssertionError(f"torque parity ({tag}): max KKT {kk.max():.2e} > 3e-3")
        if cert.any() and err[cert].max() > 1e-3:
            raise AssertionError(
                f"torque parity ({tag}): a certified step is {err[cert].max():.2e} N.m "
                "from the float64 record")
    c = out["certificate"]
    if c["max_Nm"] > 1e-3 or c["certified_steps"] != len(TORQUE_F64):
        raise AssertionError(f"torque parity (certificate): {c}")
    return out


# --------------------------------------------------------------------------
# the solver options that ship off
# --------------------------------------------------------------------------

# each: its solver parameters and what is held: "bitwise" (every output and
# the cache, each step, bit for bit the defaults': the options only route
# buffers or pick a ranking in the JAX package), "gates" (`max_kkt` and the
# flagged bar; the JAX package's record calls them safe for torque parity),
# None (printed: its record calls them unsafe for torque parity)
OPTION_CASES = {
    "defaults": (QPSolverParams(), "gates"),
    "cond_hoist_1": (QPSolverParams(cond_hoist=1), "bitwise"),
    "cond_hoist_2": (QPSolverParams(cond_hoist=2), "bitwise"),
    "drop_approx_rank_1": (QPSolverParams(drop_approx_rank=1), "bitwise"),
    "comp_final_refine_2": (QPSolverParams(comp_final_refine=2), "gates"),
    "drop_sinv_refresh_1": (QPSolverParams(drop_sinv_refresh=1), "gates"),
    "drop_fire_tol_1e-5": (QPSolverParams(drop_fire_tol=1e-5), "gates"),
    "drop_warm_iters_8": (QPSolverParams(drop_warm_iters=8), None),
    "drop_ns_iters_15": (QPSolverParams(drop_ns_iters=15), None),
}
# the generic path's and the torque probe's options
GENERIC_OPTIONS = QPSolverParams(drop_sinv_refresh=1, comp_final_refine=2)
TORQUE_PROBES = {
    "comp_final_refine_2": QPSolverParams(comp_final_refine=2),
    "drop_sinv_refresh_1": QPSolverParams(drop_sinv_refresh=1),
    "both": QPSolverParams(comp_final_refine=2, drop_sinv_refresh=1),
}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return []


def option_walk(offsets):
    """The main path over walk steps 0..69 under each case of
    OPTION_CASES, in lockstep (every case takes step t before any takes
    t + 1, the cases' order rotated from step to step so that none always
    follows the costliest), each case with its own carry, cache, launch
    counts and StageSpy; a bitwise case's outputs and cache are compared
    with the defaults' after every step."""
    model = anymal_d_model(torch.float32, DEV)
    inputs = [replay.step_inputs(TRAJ, t, BATCH, torch.float32, offsets, DEV)
              for t in range(COMPARE_STEPS)]
    runs = {name: dict(carry=wbc.init_carry(BATCH, torch.float32, DEV),
                       cache=qp.make_cache(BATCH, N, M, qpp, torch.float32, DEV),
                       spy=StageSpy(), ms=[], kkts=[], flagged=[], syncs=0,
                       launches=dict.fromkeys(kernels.launch_counts(), 0))
            for name, (qpp, _) in OPTION_CASES.items()}
    kernels.reset_counts()
    for t, (obs, ref, new) in enumerate(inputs):
        outs = {}
        names = list(OPTION_CASES)
        for name in names[t % len(names):] + names[:t % len(names)]:
            qpp, r = OPTION_CASES[name][0], runs[name]
            before, syncs0 = kernels.launch_counts(), qp.HOST_SYNCS
            with r["spy"]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, r["carry"], r["cache"] = wbc.wbc_step_batched(
                    model, ControllerParams(), qpp, obs, ref, r["carry"], new, "kernel",
                    r["cache"], t > 0)
                torch.cuda.synchronize()
                r["ms"].append((time.perf_counter() - t0) * 1e3)
            for k, v in kernels.launch_counts().items():
                r["launches"][k] += v - before[k]
            r["syncs"] += qp.HOST_SYNCS - syncs0
            if not torch.isfinite(out.tau).all():
                raise AssertionError(f"solver option {name}, step {t}: tau not finite")
            kkt = out.qp_info.kkt_residual
            r["kkts"].append(float(kkt.max()))
            r["flagged"].append(int((kkt > qpp.rescue_threshold).sum()))
            outs[name] = _leaves((out, r["carry"], r["cache"]))
        for name, (_, held) in OPTION_CASES.items():
            if held == "bitwise" and not all(
                    torch.equal(a, b) for a, b in zip(outs[name], outs["defaults"])):
                raise AssertionError(f"solver option {name}, step {t}: not bit for bit "
                                     "the defaults")
    summary = {}
    for name, (qpp, held) in OPTION_CASES.items():
        r = runs[name]
        tag = f"solver option {name}"
        n_flag = check_run(tag, r["launches"], kernels.plain_counts(), r["kkts"], r["flagged"],
                           (K3, K1, K2), (K4, K5, K7, K3X), COMPARE_STEPS,
                           quality=held is not None)
        stages = r["spy"].by_stage(tag, r["launches"])["k2_launches_by_stage"]
        steady = sorted(r["ms"][1:])
        # paired with the defaults step by step: a step's host time moves
        # with its work (switches, rescues) for every case alike
        paired = [a - b for a, b in zip(r["ms"][1:], runs["defaults"]["ms"][1:])]
        summary[name] = {
            "held": held or "printed",
            "ms_per_step_median": statistics.median(steady),
            "ms_per_step_p90": steady[int(0.9 * (len(steady) - 1))],
            "ms_per_step_mean": statistics.fmean(steady),
            "ms_over_defaults_median": statistics.median(paired),
            "max_kkt": max(r["kkts"]), "flagged_max": max(r["flagged"]),
            "flagged_scenario_steps": n_flag,
            "k2_launches_per_step": r["launches"][K2] / COMPARE_STEPS,
            "drop_round_fires": stages.get("drop_round", {}).get("launches", 0),
            "k2_launches_by_stage": stages,
            "host_syncs_per_step": r["syncs"] / COMPARE_STEPS,
        }
    return summary


def solver_options(offsets, rec):
    """The options that ship off, on the card: the main path over steps
    0..69 under each (`option_walk`), and the generic path's QPs of steps
    30..69 under GENERIC_OPTIONS (K7 and the dense H^-1 of the final
    refinement)."""
    t0 = time.perf_counter()
    out = {"main_path_steps": [0, COMPARE_STEPS - 1], "batch": BATCH,
           "cases": option_walk(offsets)}
    dense_calls = {"n": 0}
    orig = qp._hinv_mv

    def hinv_spy(Hinv, v):
        dense_calls["n"] += isinstance(Hinv, torch.Tensor)
        return orig(Hinv, v)

    qp._hinv_mv = hinv_spy
    try:
        _, generic = generic_path(rec, 0.0, GENERIC_OPTIONS)
    finally:
        qp._hinv_mv = orig
    if dense_calls["n"] == 0:
        raise AssertionError("the generic path's final refinement applied no dense H^-1")
    out["generic_path"] = {"options": {"drop_sinv_refresh": 1, "comp_final_refine": 2},
                           "dense_hinv_mv_calls": dense_calls["n"],
                           **{k: generic[k] for k in (
                               "steps", "ms_per_step_median", "max_kkt", "flagged_max",
                               "launches_per_step", "dense_vs_compact_x",
                               "k7_launches_by_stage")}}
    out["seconds_without_torque_probe"] = time.perf_counter() - t0
    return out


def torque_probe(defaults):
    """Queue 3's probe, printed and not asserted: the B = 8 replay at the
    shipped rescue threshold under TORQUE_PROBES, beside the defaults."""
    out = {"defaults": defaults}
    for tag, qpp in TORQUE_PROBES.items():
        out[tag] = torque_errors(qpp)[3]
    return out


# --------------------------------------------------------------------------
# the torch QP backend and the single robot
# --------------------------------------------------------------------------

KERNEL_SETUP_STEPS = 10   # the torch solver behind the setup kernel's plain variant
PROFILED_STEPS = 40       # the single robot's device operations counted over steps 0..39
CYCLE_MS = 2.5            # one 400 Hz control period


# a certificate with a margin: relative KKT < 1e-5 and sign violation < 1e-6.
# Two algorithms (the kernel path and the torch backend) each stop now and
# then on a borderline wrong-set saddle, sign violation ~8.8e-6, under the
# solver's own 1e-5: an H100 measured them 6.4e-3 and 4.0e-3 N.m from the
# float64 solution, and both paths within 3.3e-4 with the margin (ROADMAP
# Queue 3, the certificate's edge)
SV_MARGIN = 1e-6




def versus_float64(kept64, kept):
    """A float32 path against the float64 torch backend on the same
    inputs: max |dtau| where the float64 step converged (relative KKT <
    1e-8) and the float32 one certifies (KKT and sign violation < 1e-5),
    and with the margin (sign violation < SV_MARGIN); the scenario-steps
    more than 1e-3 N.m off, with their KKT and sign violation.  Printed."""
    worst, worst_m, n, n_m, off = 0.0, 0.0, 0, 0, []
    for t, ((t64, k64, _), (ta, ka, sa)) in enumerate(zip(kept64, kept)):
        dtau = (ta.double() - t64).abs().amax(dim=1)
        cert = (k64 < 1e-8) & (ka < 1e-5) & (sa < 1e-5)
        margin = cert & (sa < SV_MARGIN)
        if bool(cert.any()):
            worst = max(worst, float(dtau[cert].max()))
        if bool(margin.any()):
            worst_m = max(worst_m, float(dtau[margin].max()))
        n, n_m = n + int(cert.sum()), n_m + int(margin.sum())
        for b in torch.nonzero(cert & (dtau > 1e-3)).flatten().tolist()[:4]:
            off.append({"step": t, "scenario": b, "dtau_Nm": float(dtau[b]),
                        "kkt": float(ka[b]), "sign_violation": float(sa[b])})
    return {"certified_scenario_steps": n, "max_dtau_Nm_certified": worst,
            "margin_scenario_steps": n_m, "max_dtau_Nm_margin": worst_m,
            "certified_over_1e-3_Nm": off[:12]}


def torch_backend_path(offsets, kept_main):
    """The walk at B = 4096 in float32 through
    `wbc_step_batched(qp_backend="torch")` (tensor-code setup, the
    single-sample algorithm with the batch-level rescue: the JAX package's
    "xla" backend), steps 0..69, counted like the kernel paths: no kernel
    launched, no plain version run; its torques held against the main
    path's to 1e-3 N.m where both certify with the margin (printed at the
    solver's own 1e-5 beside), and both paths against the same backend in
    float64 (printed); then steps 0..9 with `setup_backend="kernel"`, which
    launches the setup kernel's plain variant (K3, no prepare stage) once a
    step and nothing else."""
    qpp = QPSolverParams()
    run_walk(BATCH, qpp, offsets, steps=3, qp_backend="torch")   # warm-up, not counted
    kept, (ms, kkts, flagged), _ = walk_kept(qpp, offsets, COMPARE_STEPS, "torch")
    launches, syncs = kernels.launch_counts(), qp.HOST_SYNCS
    n_flag = check_run("the torch backend path", launches, kernels.plain_counts(), kkts,
                       flagged, (), tuple(launches), COMPARE_STEPS)
    summary = {"path": "torch_backend", "qp_backend": "torch", "setup_backend": "torch",
               **step_summary(ms, kkts, flagged, n_flag, launches, COMPARE_STEPS, syncs)}
    kept64, (ms64, kkts64, _), _ = walk_kept(qpp, offsets, COMPARE_STEPS, "torch",
                                             torch.float64)
    summary["float64"] = {"ms_per_step_median": statistics.median(ms64[1:]),
                          "max_kkt": max(kkts64)}
    versus = {"margin": compare_paths(kept_main, kept, sv_cert=SV_MARGIN),
              "certificate": compare_paths(kept_main, kept, bar=None),
              "main_path_vs_float64": versus_float64(kept64, kept_main),
              "torch_backend_vs_float64": versus_float64(kept64, kept)}
    for k in ("margin", "certificate"):
        del versus[k]["per_step"]
    kernels.reset_counts()
    ms_k, kkts_k, flagged_k = run_walk(BATCH, qpp, offsets, steps=KERNEL_SETUP_STEPS,
                                       setup_backend="kernel", qp_backend="torch")
    launches_k = kernels.launch_counts()
    check_run("the torch solver behind the setup kernel", launches_k, kernels.plain_counts(),
              kkts_k, flagged_k, (K3,), tuple(k for k in launches_k if k != K3),
              KERNEL_SETUP_STEPS)
    if launches_k[K3] != KERNEL_SETUP_STEPS:
        raise AssertionError(f"the torch solver behind the setup kernel: {launches_k}")
    summary["kernel_setup"] = {"steps": KERNEL_SETUP_STEPS, "launches": launches_k,
                               "ms_per_step_median": statistics.median(ms_k[1:]),
                               "max_kkt": max(kkts_k)}
    return summary, versus


def device_ops(run, n):
    """Device operations (kernels, copies, fills) a step and their device
    time, from a torch.profiler trace of `run()`, which makes n steps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"device_ops_per_step": sum(e.count for e in dev) / n,
            "device_ms_per_step": sum(e.self_device_time_total for e in dev) / n / 1e3}


def single_robot():
    """The single robot, B = 1, float32, over the 200 recorded walk steps
    from an unperturbed start: `wbc_step` (tensor-code setup, the
    single-sample solve) beside `wbc_step_batched` on the kernel path with
    a carried cache.  Host ms a step (synchronised around each), host
    syncs, device operations a step (torch.profiler, steps 0..39 once
    more), and the torques against the float64 record where the step
    certifies (relative KKT < 1e-5)."""
    model = anymal_d_model(torch.float32, DEV)
    cp, qpp = ControllerParams(), QPSolverParams()
    n = TRAJ["base_R"].shape[0]
    inputs = [replay.step_inputs(TRAJ, t, 1, torch.float32, None, DEV) for t in range(n)]

    def single_steps(steps, on_step):
        carry = wbc.init_carry(1, torch.float32, DEV)
        for t in range(steps):
            obs, ref, new = inputs[t]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, carry = wbc.wbc_step(model, cp, qpp, obs, ref, carry, new)
            torch.cuda.synchronize()
            on_step(t, out, (time.perf_counter() - t0) * 1e3)

    def kernel_steps(steps, on_step):
        replay.replay(model, TRAJ, range(steps), 1, qpp, None, on_step, timed=True)

    out = {}
    for tag, run in (("wbc_step", single_steps), ("kernel_path", kernel_steps)):
        run(3, lambda *a: None)                     # warm-up, not counted
        rec = []
        kernels.reset_counts()
        qp.HOST_SYNCS = 0
        run(n, lambda t, o, ms: rec.append((ms, o.tau[0].clone(),
                                            o.qp_info.kkt_residual[0].clone())))
        launches, syncs = kernels.launch_counts(), qp.HOST_SYNCS
        if any(kernels.plain_counts().values()):
            raise AssertionError(f"single robot ({tag}): a plain version ran")
        if tag == "kernel_path" and (launches[K3] != n or launches[K1] < n
                                     or launches[K2] < n):
            raise AssertionError(f"single robot ({tag}): launches {launches}")
        if tag == "wbc_step" and any(launches.values()):
            raise AssertionError(f"single robot ({tag}) launched a kernel: {launches}")
        ms = [r[0] for r in rec]
        tau = np.stack([r[1].double().cpu().numpy() for r in rec])
        kkt = np.array([float(r[2]) for r in rec])
        err = np.abs(tau - TORQUE_F64).max(axis=1)
        cert = kkt < 1e-5
        steady = sorted(ms[1:])
        row = {"steps": n, "batch": 1, "dtype": "float32",
               "ms_per_step_median": statistics.median(steady),
               "ms_per_step_p90": steady[int(0.9 * (len(steady) - 1))],
               "ms_first_step": ms[0], "cycle_ms": CYCLE_MS,
               "steps_over_cycle": int(sum(m > CYCLE_MS for m in ms)),
               "host_syncs_per_step": syncs / n,
               "launches_per_step": {k: v / n for k, v in launches.items() if v},
               "max_kkt": float(kkt.max()), "certified_steps": int(cert.sum()),
               "torque_vs_f64_record_max_Nm": float(err.max()),
               "torque_vs_f64_record_max_Nm_certified":
                   float(err[cert].max()) if cert.any() else None}
        if not np.isfinite(tau).all() or kkt.max() > 3e-3:
            raise AssertionError(f"single robot ({tag}): {row}")
        if cert.any() and err[cert].max() > 1e-3:
            raise AssertionError(f"single robot ({tag}): a certified step is "
                                 f"{err[cert].max():.2e} N.m from the float64 record")
        out[tag] = row
    # device operations a step, steps 0..39 once more under the profiler
    for tag, run in (("wbc_step", single_steps), ("kernel_path", kernel_steps)):
        out[tag].update(device_ops(lambda: run(PROFILED_STEPS, lambda *a: None),
                                   PROFILED_STEPS))
    out["profiled_steps"] = PROFILED_STEPS
    return out


SINGLE_STAND_STEPS = 100   # the CLI's 0.25 s of standing before the command
SINGLE_WALK_STEPS = 400
SINGLE_TROT_STEPS = 200


def single_rollout():
    """The CLI's walk and trot at B = 1 in float32 (QPSolverParams(
    iterations=100), the CLI's default; 0.25 s standing, then vx = 0.5
    m/s): `closed_loop_rollout` for 400 control steps and `trot_rollout`
    for 200, the single robot's loop (`wbc_step` each control step, no
    freezing).  Held to what the JAX package's closed-loop tests hold in
    float32 at this length: finite, CoM above 0.4 m, |tau| within the 80
    N.m limit, max relative KKT within the rescue threshold; the walk
    reaches swing phases and moves forward, the trot keeps roll and pitch
    under 0.25 rad."""
    model = anymal_d_model(torch.float32, DEV)
    cp, pp, tp = ControllerParams(), PlannerParams(), trot.TrotParams()
    qpp = QPSolverParams(iterations=100)
    out = {}
    for tag, steps in (("walk", SINGLE_WALK_STEPS), ("trot", SINGLE_TROT_STEPS)):
        def run(T):
            cmds = torch.zeros((1, T, 3), dtype=torch.float32, device=DEV)
            cmds[:, SINGLE_STAND_STEPS:, 0] = 0.5
            if tag == "walk":
                carry = rollout.init_rollout_carry(model, cp, 1, pp, torch.float32, DEV)
                return rollout.closed_loop_rollout(model, cp, pp, qpp, SimParams(), carry, cmds)
            carry = rollout.init_rollout_carry(
                model, cp, 1, None, torch.float32, DEV,
                planner_state=trot.init_trot_state(tp, 1, torch.float32, DEV))
            return rollout.trot_rollout(model, cp, tp, qpp, SimParams(), carry, cmds)

        run(3)                                   # warm-up, not counted
        kernels.reset_counts()
        qp.HOST_SYNCS = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, tr = run(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        com = tr.com_pos[0]
        row = {"steps": steps, "batch": 1, "dtype": "float32", "qp_iterations": 100,
               "ms_per_control_step": wall_ms / steps,
               "host_syncs_per_step": qp.HOST_SYNCS / steps,
               "state_finite": all(bool(torch.isfinite(t).all()) for t in carry.sim),
               "min_com_z": float(com[:, 2].min()),
               "max_abs_tau_Nm": float(tr.tau.abs().max()),
               "max_qp_kkt": float(tr.qp_kkt.max()),
               "min_contact": float(tr.contacts.min()),
               "moved_x_m": float(com[-1, 0] - com[SINGLE_STAND_STEPS, 0]),
               "max_abs_roll_pitch": float(tr.com_pose[0, :, 3:5].abs().max())}
        if any(kernels.launch_counts().values()) or any(kernels.plain_counts().values()):
            raise AssertionError(f"single rollout ({tag}) ran a kernel: "
                                 f"{kernels.launch_counts()}")
        ok = (row["state_finite"] and row["min_com_z"] > 0.4
              and row["max_abs_tau_Nm"] <= 80.0 + 1e-3 and row["max_qp_kkt"] <= 3e-3
              and row["moved_x_m"] > 0.0)
        if tag == "walk":
            ok = ok and row["min_contact"] == 0.0
        else:
            ok = ok and row["max_abs_roll_pitch"] < 0.25
        if not ok:
            raise AssertionError(f"single rollout ({tag}): {row}")
        out[tag] = row
    return out


# --------------------------------------------------------------------------
# the closed loop: planner -> control step -> physics
# --------------------------------------------------------------------------

ROLLOUT_STEPS = 500
STAND_STEPS = 100      # every scenario stands first, then walks at its own speed
BURST_STEPS = 200      # the window that holds the closed loop's burst (step 186)


# the exact closed loop's asserted solver: the rescue sized to the burst
# (`rescue_batch` = 2048, the recipe of the reference's record,
# PERF_JAX_TPU.md "exact_derivatives", which there itself left up to 13
# scenarios a step above the threshold), and its second polish round too.  Each rescue stage
# polishes its whole sub-batch once; round 2 runs only on the
# `rescue_round2_batch` worst scenarios still above the threshold (32 by
# default: the compacted round 2 of `ops.qp._rescue_core`, as the JAX
# package's ops/qp.py:1842 has it), so three stages fix at most 96 of a
# burst.  Set to 2048, round 2 covers the whole sub-batch.  At 2048 / 32 the
# burst leaves scenarios above the threshold: that run is printed beside
# it, over the burst's window.
RESCUE_BURST = QPSolverParams(rescue_batch=2048, rescue_round2_batch=2048)


def closed_loop(exact: bool, qpp: QPSolverParams, quality=True, steps=ROLLOUT_STEPS):
    """`batched_rollout` at B = 4096 in float32 with the static walk: the
    planner ticks every round(loop_rate * planner dt) = 4 control steps;
    per-scenario forward speeds drawn from the seed, uniform in [0, 0.5]
    m/s from control step 100.  Finite differences or exact derivatives,
    under the solver parameters `qpp`, for `steps` control steps.  Stage
    times from CUDA events recorded at each stage boundary (device-stream
    spans, host gaps included); launches counted over the run.  With `quality` False the
    KKT residuals are printed, not held to the 3e-3 bar.  Returns
    (summary, trace)."""
    model = anymal_d_model(torch.float32, DEV)
    cp = EXACT_CP if exact else ControllerParams()
    pp = PlannerParams()
    ratio = int(round(cp.loop_rate * pp.dt))
    speeds = np.random.default_rng(SEED + 3).uniform(0.0, 0.5, BATCH)
    cmds = torch.zeros((BATCH, steps, 3), dtype=torch.float32, device=DEV)
    cmds[:, STAND_STEPS:, 0] = torch.as_tensor(speeds, dtype=torch.float32, device=DEV)[:, None]
    planner = lambda st, c: gait.planner_step(pp, st, c)

    def run(T, mark=None):
        carry = rollout.init_rollout_carry(model, cp, BATCH, pp, torch.float32, DEV)
        return rollout.batched_rollout(model, cp, qpp, SimParams(), planner, ratio, carry,
                                       cmds[:, :T].contiguous(), mark=mark)

    run(3)                                   # warm-up, not counted
    events = {}

    def mark(k, stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[k, stage] = ev

    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, trace = run(steps, mark)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    span = lambda a, b: [events[k, a].elapsed_time(events[k, b]) for k in range(steps)]
    planner_ms, control_ms, sim_ms = (span("planner", "control"), span("control", "sim"),
                                      span("sim", "end"))
    step_ms = [p + c + s_ for p, c, s_ in zip(planner_ms, control_ms, sim_ms)]
    # a scenario that fell is frozen and its torques zeroed from then on
    alive = trace.tau[:, -1].abs().amax(-1) > 0
    finite = all(bool(torch.isfinite(t).all()) for t in carry.sim)
    err = trace.com_pose[:, STAND_STEPS:, :3] - trace.ref_com_pose[:, STAND_STEPS:, :3]
    moved = trace.com_pos[:, -1, 0] - trace.com_pos[:, STAND_STEPS, 0]
    flagged = (trace.qp_kkt > qpp.rescue_threshold).sum(0)
    summary = {
        "exact_derivatives": exact, "rescue_batch": qpp.rescue_batch,
        "rescue_round2_batch": qpp.rescue_round2_batch, "quality_asserted": quality,
        "batch": BATCH,
        "steps": steps, "planner_ratio": ratio, "dtype": "float32",
        "ms_per_control_step": wall_ms / steps,
        "ms_per_control_step_events_median": statistics.median(step_ms),
        "control_ms_median": statistics.median(control_ms),
        "sim_ms_median": statistics.median(sim_ms),
        "planner_ms_median": statistics.median(planner_ms),
        "sim_share": sum(sim_ms) / sum(step_ms), "control_share": sum(control_ms) / sum(step_ms),
        "alive_share": float(alive.float().mean()), "state_finite": finite,
        "min_com_z": float(trace.com_pos[..., 2].min()),
        "max_qp_kkt": float(trace.qp_kkt.max()),
        "flagged_scenario_steps": int(flagged.sum()),
        "flagged_per_step": {int(t): int(flagged[t]) for t in torch.nonzero(flagged).flatten()},
        "tracking_rms_m": float(torch.sqrt((err.double() ** 2).mean())),
        "walked_m_median": float(moved.median()), "walked_m_max": float(moved.max()),
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    setup = K3X if exact else K3
    if launches[setup] != steps or launches[K1] < steps \
            or launches[K2] < steps or launches[K3 if exact else K3X]:
        raise AssertionError(f"closed loop (exact {exact}): launches {launches}")
    if any(kernels.plain_counts().values()):
        raise AssertionError(f"a plain version ran in the closed loop: {kernels.plain_counts()}")
    if not finite or not bool(alive.all()) or summary["min_com_z"] <= 0.4 \
            or not np.isfinite(summary["max_qp_kkt"]) \
            or (quality and summary["max_qp_kkt"] > 3e-3):
        raise AssertionError(f"closed loop (exact {exact}): {summary}")
    return summary, trace


def closed_loops():
    """The closed loop with finite differences (the shipped solver), and
    with exact derivatives: at `rescue_batch` = 2048 over the burst's window
    (printed) and with the rescue sized to the burst (`RESCUE_BURST`,
    asserted).  The asserted
    exact run must track the reference at least nearly as well as the
    finite differences (RMS of the CoM position error over the walking
    steps within 1.2x)."""
    out = {}
    for tag, exact, qpp, quality, steps in (
            ("finite_differences", False, QPSolverParams(), True, ROLLOUT_STEPS),
            ("exact_rescue_batch_2048", True, RESCUE_2048, False, BURST_STEPS),
            ("exact", True, RESCUE_BURST, True, ROLLOUT_STEPS)):
        torch.cuda.reset_peak_memory_stats()
        out[tag] = closed_loop(exact, qpp, quality, steps)[0]
    ratio = out["exact"]["tracking_rms_m"] / out["finite_differences"]["tracking_rms_m"]
    if ratio > 1.2:
        raise AssertionError(f"exact-derivative tracking is {ratio:.2f}x the finite "
                             f"differences': {out}")
    return {**out, "tracking_rms_exact_over_fd": ratio}


# --------------------------------------------------------------------------
# the robustness sweep: per-scenario payload physics, `parallel/` under a
# process group, the sharded control step, and the CLI's sweep
# --------------------------------------------------------------------------

# each gait runs twice (the sweep and its reference loop): 200 steps each
# keep the script well inside its time limit
SWEEP_STEPS = (("walk", 200), ("trot", 200))
SWEEP_STAND = 40       # the CLI's forward speeds start at control step 40
PAYLOAD_SAMPLES = 8
PAYLOAD_TOL = 1e-5     # share of max(1, |x|): float32, the batch against each alone


def _free_port() -> int:
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        return s_.getsockname()[1]


def sweep_inputs(gait_name: str, steps: int):
    """The CLI's sweep from the smoke's seed: forward speeds uniform in
    0-0.8 m/s from control step 40, `Scenario.random_batch` (friction
    0.5-1.2, payload 0-10 kg, one 60 N push of 40 control steps at a random
    onset), every scenario at the reset pose with the gait's planner state.
    (carry, commands, scenario), float32 on the card."""
    g = torch.Generator().manual_seed(SEED)
    vx = 0.8 * torch.rand(BATCH, generator=g, dtype=torch.float64)
    cmds = torch.zeros((BATCH, steps, 3), dtype=torch.float64)
    cmds[:, SWEEP_STAND:, 0] = vx[:, None]
    scen = Scenario.random_batch(g, BATCH, steps, torch.float32, DEV)
    model = anymal_d_model(torch.float32, DEV)
    planner_state = (trot.init_trot_state(trot.TrotParams(), BATCH, torch.float32, DEV)
                     if gait_name == "trot" else None)
    carry = rollout.init_rollout_carry(model, ControllerParams(), BATCH, PlannerParams(),
                                       torch.float32, DEV, planner_state=planner_state)
    return carry, cmds.to(DEV, torch.float32), scen


def payload_physics():
    """One control period of `sim_control_period` at B = 4096 with one
    payload model per scenario (`apply_payload` on the batch's payloads),
    feet 2 mm in the ground, per-scenario friction and push, torques and
    velocities from the seed; 8 sampled scenarios held against each
    simulated alone with its own shared model (`apply_payload` at its scalar
    payload), to PAYLOAD_TOL of max(1, |x|) per state leaf.  Device ms of the
    period with the per-scenario models and with the nominal model."""
    rng = np.random.default_rng(SEED + 7)
    model = anymal_d_model(torch.float32, DEV)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=DEV)
    scen = Scenario.random_batch(torch.Generator().manual_seed(SEED + 7), BATCH, 1,
                                 torch.float32, DEV)
    carry = rollout.init_rollout_carry(model, ControllerParams(), BATCH, PlannerParams(),
                                       torch.float32, DEV)
    sim = carry.sim
    kin = kinematics.forward_kinematics(model, sim.base_R, sim.base_p, sim.q)
    base_p = sim.base_p.clone()
    base_p[:, 2] -= kin.frame_p[..., 2].mean(-1) + 0.002      # feet 2 mm in the ground
    state = sim._replace(base_p=base_p, u=f32(0.2 * rng.standard_normal((BATCH, 18))))
    tau = f32(30.0 * rng.standard_normal((BATCH, 12)))
    push = scen.push_wrench[:, 0].contiguous()     # T = 1: every push starts at step 0
    sim_model = apply_payload(model, scen.payload_mass, scen.payload_com)
    args = (tau, SimParams(), scen.sim_friction, push)
    got = world.sim_control_period(sim_model, state, *args)
    rows = np.random.default_rng(SEED + 8).choice(BATCH, PAYLOAD_SAMPLES, replace=False)
    errs = {k: 0.0 for k in world.SimState._fields}
    for i in rows:
        alone = world.sim_control_period(
            apply_payload(model, scen.payload_mass[i], scen.payload_com[i]),
            world.SimState(*(x[i:i + 1] for x in state)), tau[i:i + 1], SimParams(),
            scen.sim_friction[i:i + 1], push[i:i + 1])
        for k in errs:
            a, b = getattr(got, k)[i:i + 1].double(), getattr(alone, k).double()
            errs[k] = max(errs[k], float((a - b).abs().max() / max(1.0, float(b.abs().max()))))
    shared = world.sim_control_period(model, state, *args)
    moved = float((shared.u - got.u).abs().max())
    out = {"batch": BATCH, "dtype": "float32", "samples": [int(i) for i in rows],
           "max_share_of_scale": errs, "tolerance": PAYLOAD_TOL,
           "payload_kg": [float(scen.payload_mass.min()), float(scen.payload_mass.max())],
           "max_abs_du_vs_nominal_model": moved,
           "ms_per_control_period_per_scenario_models": time_ms(
               lambda: world.sim_control_period(sim_model, state, *args), reps=3, warmup=1),
           "ms_per_control_period_nominal_model": time_ms(
               lambda: world.sim_control_period(model, state, *args), reps=3, warmup=1)}
    if max(errs.values()) > PAYLOAD_TOL or not moved > 0.0 \
            or not all(bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError(f"payload physics: {out}")
    return out


def _metrics(m) -> dict:
    return {k: float(v) for k, v in m._asdict().items()}


def run_sweep(mesh, gait_name: str, steps: int):
    """`sharded_sweep_step` over this rank's shard (the whole batch on one
    rank): B = 4096, `steps` control steps, float32, the kernel backend.
    Stage times from CUDA events at the stage boundaries; launches and
    `all_reduce` calls counted over the run.  Returns (summary, metrics)."""
    model = anymal_d_model(torch.float32, DEV)
    step = sharded_sweep_step(model, ControllerParams(), PlannerParams(), QPSolverParams(),
                              SimParams(), mesh, gait_name)
    step(*shard_batch(sweep_inputs(gait_name, 3), mesh))      # warm-up, not counted
    inputs = shard_batch(sweep_inputs(gait_name, steps), mesh)
    events, reduces = {}, []

    def mark(k, stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[k, stage] = ev

    def counted(*a, **kw):
        reduces.append(kw.get("op"))
        return all_reduce(*a, **kw)

    all_reduce = dist.all_reduce
    dist.all_reduce = counted
    try:
        kernels.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, metrics = step(*inputs, mark=mark)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        dist.all_reduce = all_reduce
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    span = lambda a, b: [events[k, a].elapsed_time(events[k, b]) for k in range(steps)]
    control_ms, sim_ms = span("control", "sim"), span("sim", "end")
    step_ms = [a + b + c for a, b, c in zip(span("planner", "control"), control_ms, sim_ms)]
    m = _metrics(metrics)
    summary = {
        "gait": gait_name, "batch": BATCH, "steps": steps, "dtype": "float32",
        "mesh": list(mesh.shape), "ranks": mesh.size, "backend": dist.get_backend(),
        "ms_per_control_step": wall_s * 1e3 / steps,
        "control_steps_per_s": BATCH * steps / wall_s,
        "ms_per_control_step_events_median": statistics.median(step_ms),
        "control_ms_median": statistics.median(control_ms),
        "sim_ms_median": statistics.median(sim_ms),
        "sim_share": sum(sim_ms) / sum(step_ms),
        "metrics": m,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "all_reduce_calls": len(reduces),
        "all_reduce_ops": sorted({str(op) for op in reduces}),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "state_finite": all(bool(torch.isfinite(t).all()) for t in carry.sim),
    }
    if min(launches[K3], launches[K1], launches[K2]) < steps or any(plain.values()):
        raise AssertionError(f"sweep ({gait_name}): launches {launches}, plain {plain}")
    if m["n_scenarios"] != BATCH or not all(np.isfinite(v) for v in m.values()) \
            or len(reduces) != 2 or not summary["state_finite"]:
        raise AssertionError(f"sweep ({gait_name}): {summary}")
    return summary, metrics


def sweep_reference(gait_name: str, steps: int):
    """The same batch through `batched_rollout` (one payload model per
    scenario) and `sweep_metrics` on a mesh without a group.  Returns the
    metrics and, from the trace, where the KKT residuals exceed the rescue
    threshold (printed: the sweep's tail)."""
    model = anymal_d_model(torch.float32, DEV)
    carry, cmds, scen = sweep_inputs(gait_name, steps)
    planner_fn, ratio = gait_planner(gait_name, ControllerParams(), PlannerParams())
    qpp = QPSolverParams()
    _, trace = rollout.batched_rollout(
        model, ControllerParams(), qpp, SimParams(), planner_fn, ratio, carry,
        cmds, scen, apply_payload(model, scen.payload_mass, scen.payload_com))
    kkt = trace.qp_kkt
    flagged = kkt > qpp.rescue_threshold
    per_step = flagged.sum(0)
    worst = int(torch.argmax(kkt.amax(1)))
    t_worst = int(torch.argmax(kkt[worst]))
    pushed = torch.nonzero(scen.push_wrench[worst, :, :2].abs().sum(-1)).flatten()
    tail = {"flagged_scenario_steps": int(flagged.sum()),
            "flagged_scenarios": int(flagged.any(1).sum()),
            "steps_with_flagged": int((per_step > 0).sum()),
            "max_flagged_in_a_step": int(per_step.max()),
            "kkt_at_least_0_5": int((kkt >= 0.5).sum()),
            "worst": {"scenario": worst, "step": t_worst, "kkt": float(kkt[worst, t_worst]),
                      "payload_kg": float(scen.payload_mass[worst]),
                      "friction": float(scen.sim_friction[worst]),
                      "push_steps": [int(pushed.min()), int(pushed.max())] if len(pushed) else [],
                      "vx": float(cmds[worst, -1, 0]),
                      "com_z_min": float(trace.com_pos[worst, :, 2].min())}}
    return sweep_metrics(trace, make_mesh()), tail


def flagship_step(mesh):
    """`sharded_wbc_step` at B = 4096 over the recorded walk's steps 0 (cold:
    no valid cache) and 1 (warm), with the per-scenario offsets of the
    main path, against `wbc_step_batched` on the same inputs, bit for bit."""
    model, cp, qpp = anymal_d_model(torch.float32, DEV), ControllerParams(), QPSolverParams()
    offsets = replay.make_offsets(BATCH, torch.float32, np.random.default_rng(SEED + 1), DEV)
    inputs = [replay.step_inputs(TRAJ, t, BATCH, torch.float32, offsets, DEV)[:2]
              for t in (0, 1)]
    step = sharded_wbc_step(model, cp, qpp, mesh)

    def run(fn):
        carry = wbc.init_carry(BATCH, torch.float32, DEV)
        cache = qp.make_cache(BATCH, N, M, qpp, torch.float32, DEV)
        outs = []
        for i, (obs, ref) in enumerate(inputs):
            out, carry, cache = fn(obs, ref, carry, cache, i > 0)
            outs.append((out, carry, cache))
        return outs

    kernels.reset_counts()
    got = run(lambda o, r, c, ca, v: step(*shard_batch((o, r, c, ca), mesh), v))
    launches = kernels.launch_counts()
    want = run(lambda o, r, c, ca, v: wbc.wbc_step_batched(model, cp, qpp, o, r, c, True,
                                                           "kernel", ca, v))
    flat = lambda tree: [tree] if isinstance(tree, torch.Tensor) else \
        [x for v in tree for x in flat(v)]
    pairs = list(zip(flat(got), flat(want)))
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    kkt = got[1][0].qp_info.kkt_residual
    out = {"batch": BATCH, "steps": "0 (cold), 1 (warm)", "tensors_compared": len(pairs),
           "tensors_differing": differ, "max_kkt_warm": float(kkt.max()),
           "launches": {k: v for k, v in launches.items() if v}}
    if differ or launches[K3] != 2 or not bool(torch.isfinite(kkt).all()):
        raise AssertionError(f"flagship: {out}")
    return out


def sweeps():
    """The sweep's phases: the walk and the trot (200 control steps each)
    through `sharded_sweep_step` under an NCCL process group of one rank,
    and the flagship step under the same group; then, without a group, the
    same batches through `batched_rollout` and `sweep_metrics`, whose
    metrics must equal the sweep's bit for bit.  `max_kkt` and
    `fallen_fraction` are printed, not held to a bar."""
    os.environ["MASTER_ADDR"] = "localhost"
    os.environ["MASTER_PORT"] = str(_free_port())
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="env://", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        if not (mesh.distributed and mesh.size == 1 and mesh.device.type == "cuda"):
            raise AssertionError(f"sweep: mesh {mesh}")
        runs = {g: run_sweep(mesh, g, steps) for g, steps in SWEEP_STEPS}
        flagship = flagship_step(mesh)
    finally:
        dist.destroy_process_group()
    out = {}
    for g, steps in SWEEP_STEPS:
        summary, metrics = runs[g]
        ref, summary["kkt_tail"] = sweep_reference(g, steps)
        summary["bit_identical_to_batched_rollout"] = all(
            torch.equal(a, b) for a, b in zip(metrics, ref))
        if not summary["bit_identical_to_batched_rollout"]:
            raise AssertionError(f"sweep ({g}): {_metrics(metrics)} against the loop's "
                                 f"{_metrics(ref)}")
        out[g] = summary
    return out, flagship


def cli_sweep():
    """`cli.main(["sweep", "--batch", "256", "--seconds", "0.25"])` in this
    process (no process group: one rank on the card); its line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["sweep", "--batch", "256", "--seconds", "0.25"])
    line = buf.getvalue().strip().splitlines()[-1]
    if not line.startswith("sweep B=256 T=100 on 1 devices") or "fallen=" not in line:
        raise AssertionError(f"cli sweep: {buf.getvalue()}")
    return line


GRAD_LOG_KP0 = float(np.log(600.0))   # the JAX package's differentiability test
GRAD_STEPS = 16        # its horizon: the cost, d/d log kp and the sign step, on the card
# the card's f64 gradient held to the port's own on the CPU over the first 10
# control steps, to 1e-6: over 16 the loop amplifies rounding to ~1e-4 (the
# JAX package's own gradient moves 4e-5 under a 1e-13 change of log kp)
GRAD_CPU_STEPS = 10
GRAD_TOL = 1e-6
GRAD_SWITCH_STEP = 40       # the recorded walk's first contact switch
URDF_JOINTS = ("FL_hip", "FL_knee", "FR_hip", "FR_knee",
               "RL_hip", "RL_knee", "RR_hip", "RR_knee")
URDF_FEET = ("FL_foot", "FR_foot", "RL_foot", "RR_foot")


def _tracking_costs(log_kp, steps, device):
    """The tracking cost of `tests/test_differentiability.py` over the first
    t control steps of one rollout of `steps`, for t in (GRAD_CPU_STEPS,
    steps) (float64, B = 1, standing still)."""
    model, pp = anymal_d_model(torch.float64, device), PlannerParams()
    cp = ControllerParams(kp=torch.exp(log_kp))
    carry = rollout.init_rollout_carry(model, cp, 1, pp, torch.float64, device)
    _, tr = rollout.closed_loop_rollout(
        model, cp, pp, QPSolverParams(iterations=40, polish=False), SimParams(substeps=4),
        carry, torch.zeros((1, steps, 3), dtype=torch.float64, device=device))
    err2 = (tr.com_pose[0, :, :3] - tr.ref_com_pose[0, :, :3]) ** 2
    return [torch.mean(err2[:t]) for t in sorted({GRAD_CPU_STEPS, steps})]


def _closed_loop_gradient(steps, device):
    """(costs, d/d log kp, forward s, backward s) of the tracking costs."""
    log_kp = torch.tensor(GRAD_LOG_KP0, dtype=torch.float64, device=device,
                          requires_grad=True)
    t0 = time.perf_counter()
    costs = _tracking_costs(log_kp, steps, device)
    vals = [c.item() for c in costs]
    t1 = time.perf_counter()
    grads = [torch.autograd.grad(c, log_kp, retain_graph=True)[0].item() for c in costs]
    return vals, grads, t1 - t0, time.perf_counter() - t1


def gradients():
    """The gradient paths on the card: (a) the JAX package's differentiability
    test's closed loop (B = 1, float64, T = 16): one sign step of log kp
    lowers the cost, and the gradient over the first 10 steps equals the
    port's own on the CPU; (b)
    one batched control step at B = 4096, float32, on the tensor-code
    backends under a gradient, next to the walk's contact switch, with no
    kernel launched; (c) the kernel path refuses a gradient before any
    launch, and runs under torch.no_grad(); (d) the toy quadruped from its
    URDF, float64, B = 4096: kinematics and dynamics on the card against
    the same calls on the CPU."""
    out = {}
    # (a) the closed loop
    kernels.reset_counts()
    (v10, val), (g10, grad), fwd_s, bwd_s = _closed_loop_gradient(GRAD_STEPS, DEV)
    if any(kernels.launch_counts().values()) or any(kernels.plain_counts().values()):
        raise AssertionError("the single robot's loop ran a kernel or a plain version")
    (cval,), (cgrad,), cfwd_s, cbwd_s = _closed_loop_gradient(GRAD_CPU_STEPS, "cpu")
    with torch.no_grad():
        step = torch.tensor(GRAD_LOG_KP0 - 0.3 * np.sign(grad), dtype=torch.float64,
                            device=DEV)
        val_step = _tracking_costs(step, GRAD_STEPS, DEV)[-1].item()
    rel = abs(g10 - cgrad) / abs(cgrad)
    out["closed_loop"] = {
        "steps": GRAD_STEPS, "value": val, "d_dlogkp": grad,
        "value_after_sign_step": val_step, "forward_s": fwd_s, "backward_s": bwd_s,
        "cpu_steps": GRAD_CPU_STEPS, "value_at_cpu_steps": v10, "d_dlogkp_at_cpu_steps": g10,
        "cpu_value": cval, "cpu_d_dlogkp": cgrad, "d_dlogkp_vs_cpu_rel": rel,
        "cpu_forward_s": cfwd_s, "cpu_backward_s": cbwd_s}
    if not (np.isfinite(grad) and np.isfinite(g10)) or val_step >= val or rel > GRAD_TOL:
        raise AssertionError(f"gradients, closed loop: {out['closed_loop']}")

    # (b) one batched control step on the tensor-code backends
    model = anymal_d_model(torch.float32, DEV)
    qpp = QPSolverParams()
    offsets = replay.make_offsets(BATCH, torch.float32, np.random.default_rng(SEED + 3), DEV)
    obs, ref, new = replay.step_inputs(TRAJ, GRAD_SWITCH_STEP - 1, BATCH, torch.float32,
                                       offsets, DEV)
    with torch.no_grad():
        _, carry = wbc.wbc_step_batched(model, ControllerParams(), qpp, obs, ref,
                                        wbc.init_carry(BATCH, torch.float32, DEV), new,
                                        "torch", setup_backend="torch")
    obs, ref, new = replay.step_inputs(TRAJ, GRAD_SWITCH_STEP, BATCH, torch.float32,
                                       offsets, DEV)
    base = ControllerParams()
    gains = {g: torch.tensor(getattr(base, g), device=DEV, requires_grad=True)
             for g in ("kp", "kd_swing")}
    cp = dataclasses.replace(base, **gains)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    step_out, _ = wbc.wbc_step_batched(model, cp, qpp, obs, ref, carry, new, "torch",
                                       setup_backend="torch")
    loss = torch.sum(step_out.tau ** 2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g_kp, g_kd = torch.autograd.grad(loss, (gains["kp"], gains["kd_swing"]))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out["control_step"] = {
        "batch": BATCH, "dtype": "float32", "step": GRAD_SWITCH_STEP,
        "d_sum_tau2_dkp": g_kp.item(), "d_sum_tau2_dkd_swing": g_kd.item(),
        "forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": kernels.launch_counts(), "plain_calls": kernels.plain_counts(),
        "max_kkt": float(step_out.qp_info.kkt_residual.detach().max())}
    if not (np.isfinite(g_kp.item()) and np.isfinite(g_kd.item())) or any(
            kernels.launch_counts().values()) or any(kernels.plain_counts().values()):
        raise AssertionError(f"gradients, control step: {out['control_step']}")
    del step_out, loss

    # (c) the kernel path refuses a gradient before any launch
    cache = qp.make_cache(BATCH, N, M, qpp, torch.float32, DEV)
    kernels.reset_counts()
    try:
        wbc.wbc_step_batched(model, cp, qpp, obs, ref, carry, new, qp_cache=cache)
    except RuntimeError as e:
        message = str(e)
    else:
        raise AssertionError("gradients: the kernel path took an input that requires grad")
    refused = kernels.launch_counts()
    with torch.no_grad():
        kernels.reset_counts()
        wbc.wbc_step_batched(model, cp, qpp, obs, ref, carry, new, qp_cache=cache)
        torch.cuda.synchronize()
    ran = kernels.launch_counts()
    out["refusal"] = {"message": message, "launches_at_refusal": refused,
                      "launches_under_no_grad": {k: v for k, v in ran.items() if v}}
    if any(refused.values()) or not message.startswith("wbc_step_batched(") or not (
            ran[K3] == 1 and ran[K1] >= 1 and ran[K2] >= 1):
        raise AssertionError(f"gradients, refusal: {out['refusal']}")

    # (d) the URDF model on the card against the CPU
    path = os.path.join(ROOT, "tests", "data", "toy_quadruped.urdf")
    rng = np.random.default_rng(SEED + 4)
    quat = rng.normal(size=(BATCH, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    R = spatial.quat_to_matrix(torch.as_tensor(quat)).numpy()
    state = (R, rng.normal(size=(BATCH, 3)), rng.uniform(-0.8, 0.3, size=(BATCH, 8)),
             rng.normal(size=(BATCH, 14)))

    def dynamics(device):
        toy = RobotModel.from_urdf(path, URDF_JOINTS, URDF_FEET, torch.float64, device)
        base_R, base_p, q, u = (torch.as_tensor(a, device=device) for a in state)
        kin = kinematics.forward_kinematics(toy, base_R, base_p, q)
        res = {"frame_p": kin.frame_p, "mass_matrix": D.mass_matrix(toy, kin),
               "bias": D.coriolis_bias(toy, base_R, base_p, q, u),
               "frame_jacobians": kinematics.frame_jacobians(toy, kin)}
        return toy, {k: v.cpu().numpy() for k, v in res.items()}

    toy, card = dynamics(DEV)
    _, cpu = dynamics("cpu")
    errs = {k: float(np.abs(card[k] - cpu[k]).max() / max(1.0, np.abs(cpu[k]).max()))
            for k in cpu}
    out["urdf_model"] = {"bodies": toy.num_bodies, "joints": toy.num_joints,
                         "batch": BATCH, "dtype": "float64",
                         "card_vs_cpu_max_share_of_scale": errs}
    if max(errs.values()) > 1e-10:
        raise AssertionError(f"gradients, urdf model: {out['urdf_model']}")
    return out


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in smi.split(",", 1))
    emit({"card": name, "power_limit": limit, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32})

    t0 = time.perf_counter()
    build.lib()
    emit({"build_s": time.perf_counter() - t0, "nvcc_s": build.build_seconds,
          "ptxas": [ln for ln in build.build_log.splitlines()
                    if "registers" in ln or "error" in ln.lower()]})

    rows, stats = check_kernels()
    with torch.no_grad():
        sec_args = setup_args(BATCH, torch.float32, np.random.default_rng(SEED))
        emit({"setup_sections": {k: v[1] for k, v in setup_section_times(sec_args).items()},
              "unit": "marginal device ms, K3, float32, B = 4096, step 60",
              "ptxas_sections": build.ptxas_report("setup_sections")})
        del sec_args
    offsets = replay.make_offsets(BATCH, torch.float32, np.random.default_rng(SEED + 1), DEV)
    launches, summaries, versus, main_kept = main_paths(offsets)
    tag = {"card": name, "power_limit": limit}
    torch_path, torch_versus = torch_backend_path(offsets, main_kept)
    del main_kept
    emit({"torch_backend_path": torch_path, **tag})
    emit({"kernel_path_vs_torch_backend_path": torch_versus, **tag})
    emit({"single_robot": single_robot(), **tag})
    emit({"single_rollout": single_rollout(), **tag})
    rec = record_qps(offsets)
    generic = {s_: generic_path(rec, s_) for s_ in (0.0, SIGMA)}
    standalone = standalone_kernels(rec)
    options = solver_options(offsets, rec)
    del rec
    no_cache = no_cache_step()
    parity = torque_parity()
    t_probe = time.perf_counter()
    options["torque_probe"] = torque_probe(parity["defaults"])
    options["torque_probe_seconds"] = time.perf_counter() - t_probe
    loops = closed_loops()
    payload = payload_physics()
    sweep_runs, flagship = sweeps()
    cli_line = cli_sweep()
    grads = gradients()
    # each kernel's row carries the launches of the run that drives it: the
    # main path's K3, K1, K2; the torch path's K4 (its code runs inside K3 on
    # the main path); the sigma path's K5; the generic path's K7 (sigma 0);
    # the standalone run's K6 and K8, which no path of the control step runs
    counted = {K3: "kernel", K1: "kernel", K2: "kernel", K4: "torch", K5: "sigma",
               K3X: "exact"}
    for k, path in counted.items():
        rows[k]["launches"], rows[k]["launches_from"] = launches[path][k], f"{path} path"
    rows[K7]["launches"] = generic[0.0][0][K7]
    rows[K7]["launches_from"] = "generic path, sigma 0"
    for k in (K6, K8):
        rows[k]["launches"], rows[k]["launches_from"] = standalone[0][k], "standalone run"
    if any(r["launches"] == 0 for r in rows.values()):
        raise AssertionError(f"a kernel was launched on no run: {rows}")
    for path in ("kernel", "torch", "sigma"):
        emit({"main_path" if path == "kernel" else f"{path}_path": summaries[path], **tag})
    emit({"exact_path": {"shipped": summaries["exact_shipped"],
                         "rescue_batch_2048": summaries["exact"]}, **tag})
    emit({"exact_oracle_path": summaries["exact_oracle"], **tag})
    emit({**versus, **tag})
    for s_ in (0.0, SIGMA):
        emit({"generic_path": generic[s_][1], **tag})
    emit({"no_cache_step": no_cache, **tag})
    emit({"standalone_kernels": standalone[1], **tag})
    emit({"torque_parity": parity, **tag})
    emit({"solver_options": options, **tag})
    emit({"rollout": loops, **tag})
    emit({"payload_physics": payload, **tag})
    emit({"sweep": sweep_runs, **tag})
    emit({"flagship": flagship, **tag})
    emit({"cli_sweep": cli_line, **tag})
    emit({"gradients": grads, **tag})
    emit({"kernels": list(rows.values()), "problem": stats, **tag})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
