#!/usr/bin/env python3
"""Where one control period of the port's simulator spends its time.

    python3 tools/torch_sim_profile.py [--batch 4096] [--periods 5]

Needs one CUDA card.  Advances B robots standing at the reset pose (zero
torque, float32) through `sim.world.sim_control_period` (8 substeps) and
prints JSON lines: the card's name and power limit; the host time of one
period ending in `synchronize()`; from `torch.profiler` over two periods the
device time, the device launches and the operators that take most device
time, per period; and CUDA-event times of the parts of one substep (forward
kinematics, forward dynamics, the Cholesky factorization and solve of M).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("needs a CUDA device")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from quadrupedwholebodycontroller_tpu_torch.config import (  # noqa: E402
    ControllerParams,
    PlannerParams,
)
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops import dynamics as D  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops import kinematics as K  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops import linalg  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.sim import rollout, world  # noqa: E402


def event_ms(fn, reps=20):
    """Median CUDA-event time of one call, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@torch.no_grad()
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--periods", type=int, default=5)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi, "batch": args.batch}), flush=True)
    B, dev = args.batch, "cuda"
    model = anymal_d_model(torch.float32, dev)
    state = rollout.init_rollout_carry(model, ControllerParams(), B, PlannerParams(),
                                       torch.float32, dev).sim
    tau = torch.zeros(B, 12, device=dev)
    sp = world.SimParams()
    for _ in range(3):
        state = world.sim_control_period(model, state, tau, sp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.periods):
        state = world.sim_control_period(model, state, tau, sp)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / args.periods * 1e3

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state = world.sim_control_period(model, state, tau, sp)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_time = lambda e: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
    self_dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    top = sorted(events, key=lambda e: -dev_time(e))[:12]
    print(json.dumps({
        "host_ms_per_period": host_ms,
        "device_ms_per_period": sum(self_dev(e) for e in events) / 1e3 / 2,
        "device_launches_per_period": sum(e.count for e in events
                                          if e.device_type.name == "CUDA") / 2,
        "top_ops_device_ms_per_period": [(e.key[:60], e.count // 2, dev_time(e) / 1e3 / 2)
                                         for e in top],
    }), flush=True)

    kin = K.forward_kinematics(model, state.base_R, state.base_p, state.q)
    M = D.mass_matrix(model, kin)
    rhs = torch.randn(B, 18, device=dev)
    print(json.dumps({
        "forward_kinematics_ms": event_ms(
            lambda: K.forward_kinematics(model, state.base_R, state.base_p, state.q)),
        "forward_dynamics_ms": event_ms(
            lambda: D.forward_dynamics(model, state.base_R, state.base_p, state.q, state.u,
                                       torch.zeros(B, 18, device=dev))),
        "cholesky_ex_ms": event_ms(lambda: torch.linalg.cholesky_ex(M)),
        "spd_solve_ms": event_ms(lambda: linalg.spd_solve(M, rhs)),
        "substep_ms": event_ms(lambda: world._substep(model, state, tau, sp)),
    }), flush=True)


if __name__ == "__main__":
    main()
