#!/usr/bin/env python3
"""The port's closed loop under several controller and solver settings.

    python3 tools/torch_closed_loop.py [--device cuda] [--batch 4096]
        [--steps 200] [--speed V] [--config SPEC ...]

Runs `sim.rollout.batched_rollout` (static-walk planner every 4 control
steps -> `wbc_step_batched` with the kernel setup -> physics, float32)
with the commands of `chip_smoke.py`'s closed loop: every scenario stands
for 100 control steps, then walks forward at its own speed, uniform in
[0, 0.5] m/s from numpy seed 3 (`--speed V`: every scenario at V).  Each
`--config` is `fd` or `exact` (finite-difference or exact centroidal
derivatives), then comma-separated `QPSolverParams` fields, for example
`exact,rescue_batch=2048,rescue_round2_batch=32`.

Prints one JSON line per configuration: the scenarios that entered the
solver's staged rescue and those whose KKT residual is still above the
rescue threshold after it (3e-3 where the rescue is off), per control step;
the largest residual; the alive share and lowest CoM height; the contact
switches the gait made; the RMS of the CoM position error from control
step 100 on (as the smoke run's); and how far the CoM and its reference
have moved forward since the walk was commanded, every 50 control steps
(medians over the batch).  On a card it also prints the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from quadrupedwholebodycontroller_tpu_torch.config import (  # noqa: E402
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops import qp  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.planner import gait  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams, rollout  # noqa: E402

STAND_STEPS = 100


def parse_config(spec: str):
    mode, *fields = spec.split(",")
    if mode not in ("fd", "exact"):
        raise SystemExit(f"--config {spec!r}: starts with fd or exact")
    types = {f.name: f.type for f in dataclasses.fields(QPSolverParams)}
    kw = {}
    for item in fields:
        key, val = item.split("=")
        t = types[key] if isinstance(types[key], str) else types[key].__name__
        kw[key] = {"int": int, "float": float, "bool": lambda v: v == "True"}.get(t, str)(val)
    return mode == "exact", QPSolverParams(**kw)


@torch.no_grad()
def run(args, exact: bool, qpp: QPSolverParams) -> dict:
    dtype = torch.float32
    B, T, dev = args.batch, args.steps, args.device
    model = anymal_d_model(dtype, dev)
    cp = ControllerParams(exact_derivatives=exact)
    pp = PlannerParams()
    ratio = int(round(cp.loop_rate * pp.dt))
    speeds = (np.full(B, args.speed) if args.speed is not None
              else np.random.default_rng(3).uniform(0.0, 0.5, B))
    cmds = torch.zeros((B, T, 3), dtype=dtype, device=dev)
    cmds[:, STAND_STEPS:, 0] = torch.as_tensor(speeds, dtype=dtype, device=dev)[:, None]
    carry = rollout.init_rollout_carry(model, cp, B, pp, dtype, dev)
    # the scenarios that enter the staged rescue, per control step (a host
    # read per rescue call)
    step, rescue_in = [0], {}
    rescue = qp._rescue_staged

    def rescue_spy(data, params, best, pr_b, du_b, res_b, polished, sv_b, *a, **k):
        n = int((torch.maximum(res_b, sv_b) > params.rescue_threshold).sum())
        rescue_in[step[0]] = rescue_in.get(step[0], 0) + n
        return rescue(data, params, best, pr_b, du_b, res_b, polished, sv_b, *a, **k)

    def mark(k, stage):
        step[0] = k

    qp._rescue_staged = rescue_spy
    try:
        carry, tr = rollout.batched_rollout(model, cp, qpp, SimParams(),
                                            lambda s, c: gait.planner_step(pp, s, c),
                                            ratio, carry, cmds, mark=mark)
    finally:
        qp._rescue_staged = rescue
    thr = qpp.rescue_threshold if qpp.rescue_threshold > 0 else 3e-3
    flagged = (tr.qp_kkt > thr).sum(0)
    x0, rx0 = tr.com_pos[:, STAND_STEPS, 0], tr.ref_com_pose[:, STAND_STEPS, 0]
    med = lambda t: float(t.double().median())
    progress = [{"step": t, "com_dx_m": med(tr.com_pos[:, t, 0] - x0),
                 "ref_com_dx_m": med(tr.ref_com_pose[:, t, 0] - rx0)}
                for t in list(range(STAND_STEPS, T, 50)) + [T - 1]]
    switches = (tr.contacts[:, 1:] != tr.contacts[:, :-1]).any(-1).sum(1)
    err = (tr.com_pose[:, STAND_STEPS:, :3] - tr.ref_com_pose[:, STAND_STEPS:, :3]).double()
    return {
        "exact_derivatives": exact,
        "rescue_batch": qpp.rescue_batch, "rescue_round2_batch": qpp.rescue_round2_batch,
        "batch": B, "steps": T, "device": dev,
        "flag_threshold": thr, "max_qp_kkt": float(tr.qp_kkt.max()),
        "flagged_scenario_steps": int(flagged.sum()),
        "flagged_per_step": {int(t): int(flagged[t]) for t in torch.nonzero(flagged).flatten()},
        "rescue_in_per_step": {t: n for t, n in rescue_in.items() if n},
        "alive_share": float((tr.tau[:, -1].abs().amax(-1) > 0).double().mean()),
        "min_com_z": float(tr.com_pos[..., 2].min()),
        "contact_switches_median": med(switches),
        "tracking_rms_m": float(torch.sqrt((err ** 2).mean())),
        "progress": progress,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--speed", type=float, default=None)
    ap.add_argument("--config", action="append", default=None)
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("--device cuda needs a CUDA device")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(json.dumps({"nvidia_smi": smi}), flush=True)
    else:
        torch.set_num_threads(min(4, torch.get_num_threads()))
    for spec in args.config or ["fd"]:
        exact, qpp = parse_config(spec)
        print(json.dumps({"config": spec, **run(args, exact, qpp)}), flush=True)


if __name__ == "__main__":
    main()
