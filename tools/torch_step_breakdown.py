#!/usr/bin/env python3
"""Where one batched control step of the PyTorch/CUDA port spends its time.

    python3 tools/torch_step_breakdown.py [--batch 4096] [--steps 40]
                                          [--rescue-threshold 1e-5]
                                          [--setup-backend {both,kernel,torch}]

Needs one CUDA card.  Replays recorded walking steps 30.. (the window holds
the contact switch at step 40) through `wbc_step_batched` in float32 and
prints, for each setup backend asked for (default: the fused setup kernel,
then the tensor-code setup, in one process on one card), JSON lines:

  * stage times per step, measured with CUDA events around the stages of one
    step (setup, prepare kernel, K build + inverse, ADMM kernel, polish
    rounds, rescue, torque map) by wrapping the port's functions, and the
    host syncs per step,
  * the device-busy share of the wall time, the device launches per step and
    the kernels that take most device time, from `torch.profiler`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("needs a CUDA device")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from quadrupedwholebodycontroller_tpu_torch import replay  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.config import QPSolverParams  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.control import wbc  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops import qp  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import admm_zy, polish, prepare  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops.kernels import setup as setup_k  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--first", type=int, default=30)
    ap.add_argument("--rescue-threshold", type=float, default=None,
                    help="override QPSolverParams.rescue_threshold "
                         "(1e-5 is the torque-parity certificate configuration)")
    ap.add_argument("--setup-backend", choices=("both", "kernel", "torch"), default="both")
    args = ap.parse_args()
    backends = ("kernel", "torch") if args.setup_backend == "both" else (args.setup_backend,)
    B, dt, dev = args.batch, torch.float32, "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    traj = np.load(os.path.join(ROOT, "data", "walk_traj_400hz.npz"))
    off = replay.make_offsets(B, dt, np.random.default_rng(1), dev)
    model = anymal_d_model(dt, dev)
    qpp = QPSolverParams() if args.rescue_threshold is None else QPSolverParams(
        rescue_threshold=args.rescue_threshold)

    for backend in backends:
        breakdown(args, backend, model, traj, B, qpp, off, smi)


def breakdown(args, backend, model, traj, B, qpp, off, smi):
    def run(n=args.steps):
        """Replays n steps; returns the summed host time of the steps (ms)."""
        ms = []
        replay.replay(model, traj, range(args.first, args.first + n), B, qpp, off,
                      on_step=lambda t, out, step_ms: ms.append(step_ms), timed=True,
                      setup_backend=backend)
        return sum(ms)

    run(5)  # warm-up

    # ---- stage times: CUDA events around wrapped stages ----
    spans = defaultdict(list)

    def timed(name, fn):
        def wrapper(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            spans[name].append((e0, e1))
            return out
        return wrapper

    patches = [
        (wbc, "wbc_setup", "setup"), (setup_k, "setup_batched", "setup_kernel"),
        (wbc, "_finish_step", "torque_map"),
        (prepare, "prepare_scaled", "prepare_kernel"),
        (admm_zy, "admm_zy_iterations_res", "admm_kernel"),
        (polish, "polish_solve", "polish_kernel"),
        (qp, "ns_inverse", "ns_inverse_cold"),
        (qp, "ns_inverse_warm_shared", "ns_inverse_warm"),
        (qp, "_assemble_active", "assemble_active"),
        (qp, "_rescue_staged", "rescue"),
        (qp, "solve_batched", "solve_batched_total"),
    ]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, label in patches:
        setattr(m, n, timed(label, getattr(m, n)))
    qp.HOST_SYNCS = 0
    wall_ms = run()
    syncs = qp.HOST_SYNCS
    for m, n, f in saved:
        setattr(m, n, f)
    stage = {k: sum(a.elapsed_time(b) for a, b in v) / args.steps for k, v in spans.items()}
    calls = {k: len(v) / args.steps for k, v in spans.items()}
    print(json.dumps({"card": smi, "setup_backend": backend, "batch": B,
                      "steps": args.steps, "rescue_threshold": qpp.rescue_threshold,
                      "wall_ms_per_step": wall_ms / args.steps,
                      "host_syncs_per_step": syncs / args.steps,
                      "stage_ms_per_step": stage, "stage_calls_per_step": calls}), flush=True)

    # ---- device-busy share and top kernels ----
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = run()
    rows = [(e.key, getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0),
             e.count) for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    busy_ms = sum(r[1] for r in rows) / 1e3
    rows.sort(key=lambda r: -r[1])
    print(json.dumps({
        "card": smi, "setup_backend": backend,
        "profiled_wall_ms_per_step": wall_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_busy_share_of_profiled_wall": busy_ms / wall_ms if wall_ms else None,
        "device_kernel_launches_per_step": sum(r[2] for r in rows) / args.steps,
        "top_device_kernels_ms_per_step": [
            {"name": k[:80], "ms": t / 1e3 / args.steps, "calls_per_step": c / args.steps}
            for k, t, c in rows[:15]],
    }), flush=True)


if __name__ == "__main__":
    main()
