#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero without them.  It

  1. builds the CUDA kernels from `quadrupedwholebodycontroller_tpu_torch/csrc`,
  2. holds each kernel against its plain PyTorch version on the card, at the
     main path's shapes (B = 4096, n = 42, m = 70) on QPs assembled from a
     recorded walking step, each output to its own tolerance, in float32
     and float64, plus a ragged B = 37,
  3. drives the main path: the batched 400 Hz control cycle replaying the
     recorded 200-step walk at B = 4096 in float32 through
     `control.wbc.wbc_step_batched`, and checks the launch counters,
  4. replays the unperturbed walk at B = 8 against the float64 torque record
     `data/torque_cpu64.npz`.

Every line it prints is one JSON object; the last is
`{"ok": true, "device": {...}}`.  Any failed check raises.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from quadrupedwholebodycontroller_tpu_torch import replay  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.config import (  # noqa: E402
    ControllerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.control import wbc  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops import kernels, qp  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import (  # noqa: E402
    admm_zy,
    build,
    polish,
    prepare,
)
from quadrupedwholebodycontroller_tpu_torch.ops.linalg import ns_inverse  # noqa: E402

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
PREP_OUT = "sH sA sg sl su rho wxs wzs wys d e".split()
ADMM_OUT = "x z y pr du sv".split()
POLISH_OUT = "x y z pr du sv".split()
OUTPUTS = {"prepare_scaled": PREP_OUT, "admm_zy_iterations_res": ADMM_OUT,
           "polish_solve_compact": POLISH_OUT}
FLOOR = None     # at the rounding floor: float64 guard + resolving case
TOL_F32 = {
    ("prepare_scaled", "main"): {o: (1e-5, 0.0) for o in PREP_OUT},
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
TOL_F64 = (1e-9, 1e-10)
GUARD, GUARD_ATOL = 3.0, 1e-6

REPLACES = {
    "prepare_scaled": "quadrupedwholebodycontroller_tpu/ops/pallas/prepare_kernel.py:74",
    "admm_zy_iterations_res": "quadrupedwholebodycontroller_tpu/ops/pallas/qp_kernel.py:243",
    "polish_solve_compact": "quadrupedwholebodycontroller_tpu/ops/pallas/polish_kernel.py:276",
}
SOURCES = {
    "prepare_scaled": "quadrupedwholebodycontroller_tpu_torch/csrc/prepare.cu",
    "admm_zy_iterations_res": "quadrupedwholebodycontroller_tpu_torch/csrc/admm_zy.cu",
    "polish_solve_compact": "quadrupedwholebodycontroller_tpu_torch/csrc/polish.cu",
}


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
    K4, K1, K2 = "prepare_scaled", "admm_zy_iterations_res", "polish_solve_compact"
    admm = (admm_zy.admm_zy_iterations_res, admm_zy.admm_zy_iterations_res_plain)
    pol = (polish.polish_solve, polish.polish_solve_plain)
    return [
        (K4, "main", prepare.prepare_scaled, prepare.prepare_scaled_plain, prep_args, pk),
        (K1, "main", *admm, admm_args, dict(iters=qpp.iterations, alpha=qpp.alpha)),
        (K1, "resolving", *admm, cold_args, dict(iters=3, alpha=qpp.alpha)),
        (K2, "main", *pol, (Hc, Hinv, Sinv, *pol_tail),
         dict(refine=qpp.polish_refine, reg=qpp.polish_reg)),
        (K2, "resolving", *pol,
         (Hc, (0.7 * Hinv[0], 0.7 * Hinv[1], Hinv[2]), 0.7 * Sinv, *pol_tail),
         dict(refine=1, reg=qpp.polish_reg)),
    ], stats


def flat_tensors(args):
    for a in args:
        if isinstance(a, tuple):
            yield from (t for t in a if isinstance(t, torch.Tensor))
        elif isinstance(a, torch.Tensor):
            yield a


def _to_double(a):
    if isinstance(a, tuple):
        return tuple(_to_double(x) for x in a)
    return a.double() if isinstance(a, torch.Tensor) else a


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
        tol = TOL_F64 if dtype == torch.float64 else TOL_F32[(name, case)][o]
        if tol is not FLOOR:
            rtol, atol = tol
            if name == "prepare_scaled":       # products only: elementwise
                ok, e["tol"] = e["rel_elem"] <= rtol, f"{rtol:g} elementwise"
            else:
                bound = rtol * e["scale"] + atol
                ok, e["tol"] = e["abs_err"] <= bound, bound
            if not ok:
                raise AssertionError(f"{where}: kernel disagrees with its plain version: {e}")
        elif "kernel_vs_f64_plain" in e:
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


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def flops_of(name: str, batch: int, kw: dict) -> float:
    """Multiply-adds counted as 2, matvecs only (the elementwise tails are
    a few percent)."""
    n, m, k = N, M, KBLK
    if name == "prepare_scaled":
        per = kw["sweeps"] * (2 * n * n + 4 * m * n) + 2 * (n * n + m * n)
    elif name == "admm_zy_iterations_res":
        mv = 2 * (2 * m * n + n * n)                 # A^T t, K^-1 ., A .
        per = kw["iters"] * mv + 2 * (n * n + m * n) + 2 * (m * n + n * n) \
            + 2 * (m * n + n * n + m * n)
    else:
        hmv = 2 * (k * k + n)                        # compact H or H^-1 apply
        init = 2 * hmv + 2 * (2 * m * n) + 2 * m * m
        per_ref = 3 * hmv + 4 * (2 * m * n) + 2 * m * m
        per = init + kw["refine"] * per_ref + 2 * (2 * m * n) + hmv
    return float(per) * batch


def check_kernels():
    rng = np.random.default_rng(SEED)
    rows = {}
    with torch.no_grad():
        cases, stats = kernel_problem(BATCH, torch.float32, rng)
        for name, case, fn, plain, args, kw in cases:
            errs, got = compare(name, case, fn, plain, args, kw, torch.float32)
            if case != "main":
                rows[name][f"{case}_f32"] = errs
                continue
            ms = time_ms(lambda: fn(*args, **kw))
            plain_ms = time_ms(lambda: plain(*args, **kw), reps=5, warmup=1)
            nbytes = sum(t.numel() * t.element_size() for t in flat_tensors(args)) \
                + sum(t.numel() * t.element_size() for t in got)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops_of(name, BATCH, kw) / F32_FLOPS * 1e3
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": max(e["abs_err"] for e in errs.values()),
                "main_f32": errs,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops_of(name, BATCH, kw),
                "library_ms": None,
                "shape": {"B": BATCH, "n": N, "m": M, **{k: v for k, v in kw.items()
                                                         if isinstance(v, int)}},
            }
        # the same cases in float64 (the scalar type is a template
        # parameter) at the full batch, and both types at a ragged batch
        for batch, dtype in ((BATCH, torch.float64), (37, torch.float32),
                             (37, torch.float64)):
            probs, _ = kernel_problem(batch, dtype, rng)
            for name, case, fn, plain, args, kw in probs:
                errs, _ = compare(name, case, fn, plain, args, kw, dtype)
                rows[name][f"{case}_{str(dtype)[6:].replace('float', 'f')}_B{batch}"] = {
                    o: e["rel_elem"] if name == "prepare_scaled"
                    else e["abs_err"] / e["scale"] if e["scale"] else e["abs_err"]
                    for o, e in errs.items()}
    return rows, stats


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def run_walk(batch: int, qpp: QPSolverParams, offsets, record=None, steps=None):
    """Replay the recorded walk through wbc_step_batched on the card in
    float32.  Returns per-step host times (ms), max KKT and flagged counts;
    `record(t, out)` sees every step's output."""
    model = anymal_d_model(torch.float32, DEV)
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

    replay.replay(model, TRAJ, range(steps), batch, qpp, offsets, on_step, timed=True)
    return ms, kkts, flagged


def main_path():
    rng = np.random.default_rng(SEED + 1)
    qpp = QPSolverParams()
    offsets = replay.make_offsets(BATCH, torch.float32, rng, DEV)
    # warm-up outside the counted run: first-use allocator and library
    # start-up costs are set-up, not step time
    run_walk(BATCH, qpp, offsets, steps=3)
    replay_steps = TRAJ["base_R"].shape[0]
    kernels.reset_counts()
    qp.HOST_SYNCS = 0
    torch.cuda.reset_peak_memory_stats()
    ms, kkts, flagged = run_walk(BATCH, qpp, offsets)
    launches = kernels.launch_counts()
    plain = kernels.plain_counts()
    syncs = qp.HOST_SYNCS
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on the main path: {plain}")
    n_flag = sum(flagged)
    if n_flag > 1e-4 * BATCH * replay_steps:
        raise AssertionError(
            f"{n_flag} flagged scenario-steps (kkt > threshold) of {BATCH * replay_steps}")
    steady = sorted(ms[1:])
    med = statistics.median(steady)
    return launches, {
        "steps": replay_steps, "batch": BATCH, "dtype": "float32",
        "ms_per_step_median": med,
        "ms_per_step_p90": steady[int(0.9 * (len(steady) - 1))],
        "ms_first_step": ms[0],
        "solves_per_s": BATCH / (med * 1e-3),
        "max_kkt": max(kkts), "flagged_max": max(flagged),
        "flagged_scenario_steps": n_flag,
        "launches_per_step": {k: v / replay_steps for k, v in launches.items()},
        "host_syncs_per_step": syncs / replay_steps,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }


def torque_parity():
    """B = 8 unperturbed replay through the kernels against the float64
    torque record.  Two configurations: the shipped defaults, where a step's
    torque is held to the record only where the solver certifies it
    (relative KKT < 1e-5; the 3e-3 rescue threshold leaves uncertified
    steps at ADMM accuracy), and the certificate configuration
    (rescue_threshold = 1e-5), held to 1e-3 N.m at every step."""
    out = {}
    for tag, qpp in (("defaults", QPSolverParams()),
                     ("certificate", QPSolverParams(rescue_threshold=1e-5))):
        taus, kk = [], []

        def record(t, o):
            taus.append(o.tau[0].double().cpu().numpy())
            kk.append(float(o.qp_info.kkt_residual[0]))

        run_walk(8, qpp, None, record)
        err = np.abs(np.stack(taus) - TORQUE_F64).max(axis=1)
        kk = np.asarray(kk)
        cert = kk < 1e-5
        out[tag] = {
            "max_Nm": float(err.max()), "p99_Nm": float(np.percentile(err, 99)),
            "median_Nm": float(np.median(err)), "max_kkt": float(kk.max()),
            "certified_steps": int(cert.sum()),
            "max_Nm_certified": float(err[cert].max()) if cert.any() else None,
        }
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
    launches, main = main_path()
    for k, v in launches.items():
        rows[k]["launches"] = v
    emit({"kernels": list(rows.values()), "problem": stats,
          "card": name, "power_limit": limit})
    emit({"main_path": main, "card": name, "power_limit": limit})
    emit({"torque_parity": torque_parity(), "card": name, "power_limit": limit})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
