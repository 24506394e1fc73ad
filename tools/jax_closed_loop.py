#!/usr/bin/env python3
"""The JAX package's batched closed loop on the CPU, for comparison with the
port's `tools/torch_closed_loop.py` under the same settings.

    JAX_PLATFORMS=cpu python3 tools/jax_closed_loop.py [--batch 64]
        [--steps 200] [--config SPEC ...]

Runs `sim.rollout.batched_rollout(..., qp_backend="pallas")` (static-walk
planner every 4 control steps, float32, the Pallas kernels in interpret
mode on the CPU, as the package's tests run them) with the commands of the
port's tool and of `chip_smoke.py`: every scenario stands for 100 control
steps, then walks forward at its own speed, uniform in [0, 0.5] m/s from
numpy seed 3.
Each `--config` is `fd` or `exact`, then comma-separated `QPSolverParams`
fields, e.g. `exact,rescue_batch=2048,rescue_threshold=0` (0: no rescue).
Prints one JSON line per configuration: the scenarios whose KKT residual is
above the rescue threshold (3e-3 where the rescue is off), per control
step, the largest residual, and the RMS of the CoM position error from
control step 100 on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from quadrupedwholebodycontroller_tpu.config import (  # noqa: E402
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu.models import anymal_d_model  # noqa: E402
from quadrupedwholebodycontroller_tpu.planner import gait  # noqa: E402
from quadrupedwholebodycontroller_tpu.sim import SimParams  # noqa: E402
from quadrupedwholebodycontroller_tpu.sim import rollout  # noqa: E402

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
    return mode == "exact", QPSolverParams(solve_layout="major", **kw)


def run(args, exact: bool, qpp: QPSolverParams) -> dict:
    dtype = jnp.float32
    B, T = args.batch, args.steps
    model = anymal_d_model(dtype=dtype)
    cp, pp = ControllerParams(exact_derivatives=exact), PlannerParams()
    ratio = int(round(cp.loop_rate * pp.dt))
    speeds = np.random.default_rng(3).uniform(0.0, 0.5, B)
    cmds = np.zeros((B, T, 3))
    cmds[:, STAND_STEPS:, 0] = speeds[:, None]
    carry = jax.tree.map(lambda x: jnp.stack([x] * B),
                         rollout.init_rollout_carry(model, cp, pp, dtype=dtype))
    _, tr = jax.jit(lambda c, x: rollout.batched_rollout(
        model, cp, qpp, SimParams(), lambda s, cc: gait.planner_step(pp, s, cc), ratio, c, x,
        qp_backend="pallas"))(carry, jnp.asarray(cmds, dtype))
    kkt = np.asarray(tr.qp_kkt)
    thr = qpp.rescue_threshold if qpp.rescue_threshold > 0 else 3e-3
    flagged = (kkt > thr).sum(0)
    err = (np.asarray(tr.com_pose)[:, STAND_STEPS:, :3]
           - np.asarray(tr.ref_com_pose)[:, STAND_STEPS:, :3]).astype(np.float64)
    return {
        "exact_derivatives": exact, "batch": B, "steps": T,
        "flag_threshold": thr, "max_qp_kkt": float(kkt.max()),
        "flagged_scenario_steps": int(flagged.sum()),
        "flagged_per_step": {int(t): int(flagged[t]) for t in np.nonzero(flagged)[0]},
        "tracking_rms_m": float(np.sqrt((err ** 2).mean())),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--config", action="append", default=None)
    args = ap.parse_args()
    for spec in args.config or ["fd"]:
        exact, qpp = parse_config(spec)
        print(json.dumps({"config": spec, **run(args, exact, qpp)}), flush=True)


if __name__ == "__main__":
    main()
