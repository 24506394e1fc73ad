#!/usr/bin/env python3
"""The KKT tail of the robustness sweep's trot, on the CPU: chosen
scenarios of `chip_smoke.py`'s sweep (the CLI's scenarios at B = 4096 from
seed 0: friction, payload, one 60 N push, forward speeds from control step
40) run as a batch of their own through the JAX package's
`batched_rollout` and the port's, float32, one payload model per scenario,
the trot planner:

    JAX_PLATFORMS=cpu python3 tools/trot_sweep_tail.py [--rows 0-30,46]
        [--steps 200] [--paths jax_xla,port_torch,port_kernel]

Paths: `jax_xla` (the JAX package's CPU backend), `jax_pallas` (its
kernel path, the Pallas kernels in interpret mode: slow),
`port_torch` (the port's tensor-code backend, the xla algorithm),
`port_kernel` (the port's kernel path; the kernels' plain versions on the
CPU).  Prints one JSON line a path: the scenario-steps whose relative KKT
residual exceeds the rescue threshold (3e-3), the scenarios they fall in,
the maximum, those at 0.5 or more, and the worst rows.

A small batch is not the smoke's: the rescue re-solves at most
`rescue_batch` (128) flagged scenarios a stage, which covers every flagged
scenario of a small batch but not the smoke's thousand-odd in a step, so
the tail here is what the solver leaves even with the rescue's full
attention.  Imports JAX: a tool of the comparison, not of the port.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxCP  # noqa: E402
from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQP  # noqa: E402
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model  # noqa: E402
from quadrupedwholebodycontroller_tpu.planner import trot as jtrot  # noqa: E402
from quadrupedwholebodycontroller_tpu.sim import SimParams as JaxSP  # noqa: E402
from quadrupedwholebodycontroller_tpu.sim import rollout as jrollout  # noqa: E402
from quadrupedwholebodycontroller_tpu.sim import scenario as jscenario  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.config import (  # noqa: E402
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.parallel.sweep import gait_planner  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.planner import trot  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams, rollout  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.sim.scenario import (  # noqa: E402
    Scenario,
    apply_payload,
)

SMOKE_BATCH, SMOKE_SEED, STAND = 4096, 0, 40
THRESHOLD = 3e-3


def smoke_scenarios(rows, steps):
    """(commands (n, T, 3), Scenario fields as numpy) of the smoke's sweep
    rows: the draws of `chip_smoke.sweep_inputs` at B = 4096, on the host."""
    g = torch.Generator().manual_seed(SMOKE_SEED)
    vx = 0.8 * torch.rand(SMOKE_BATCH, generator=g, dtype=torch.float64)
    scen = Scenario.random_batch(g, SMOKE_BATCH, steps, torch.float32, "cpu")
    cmds = np.zeros((len(rows), steps, 3), np.float32)
    cmds[:, STAND:, 0] = vx.numpy()[rows, None]
    return cmds, {k: getattr(scen, k).numpy()[rows] for k in Scenario._fields}


def jax_path(cmds, sc, backend):
    n = cmds.shape[0]
    dt = jnp.float32
    model, cp, tp = jax_model(dtype=dt), JaxCP(), jtrot.TrotParams()
    carry = jax.tree.map(lambda x: jnp.stack([x] * n), jrollout.init_rollout_carry(
        model, cp, dtype=dt, planner_state=jtrot.init_trot_state(tp, dt)))
    scen = jscenario.Scenario(**{k: jnp.asarray(v) for k, v in sc.items()})
    sim_model = jax.vmap(lambda m, c: jscenario.apply_payload(model, m, c))(
        scen.payload_mass, scen.payload_com)
    ratio = max(1, int(round(cp.loop_rate * tp.dt)))
    qpp = JaxQP(solve_layout="major") if backend == "pallas" else JaxQP()
    _, trace = jax.jit(lambda c, x, s, m: jrollout.batched_rollout(
        model, cp, qpp, JaxSP(), lambda st, cc: jtrot.trot_step(tp, st, cc), ratio, c, x, s, m,
        backend))(carry, jnp.asarray(cmds), scen, sim_model)
    return np.asarray(trace.qp_kkt)


def port_path(cmds, sc, backend):
    n = cmds.shape[0]
    model, cp = anymal_d_model(torch.float32, "cpu"), ControllerParams()
    carry = rollout.init_rollout_carry(
        model, cp, n, None, torch.float32, "cpu",
        planner_state=trot.init_trot_state(trot.TrotParams(), n, torch.float32, "cpu"))
    scen = Scenario(*(torch.as_tensor(sc[k]) for k in Scenario._fields))
    planner_fn, ratio = gait_planner("trot", cp, PlannerParams())
    _, trace = rollout.batched_rollout(
        model, cp, QPSolverParams(), SimParams(), planner_fn, ratio, carry,
        torch.as_tensor(cmds), scen,
        apply_payload(model, scen.payload_mass, scen.payload_com), qp_backend=backend)
    return trace.qp_kkt.numpy()


PATHS = {"jax_xla": lambda c, s: jax_path(c, s, "xla"),
         "jax_pallas": lambda c, s: jax_path(c, s, "pallas"),
         "port_torch": lambda c, s: port_path(c, s, "torch"),
         "port_kernel": lambda c, s: port_path(c, s, "kernel")}


def parse_rows(spec: str):
    rows = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        rows += list(range(int(lo), int(hi or lo) + 1))
    return np.asarray(rows)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="0-30,46")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--paths", default="jax_xla,port_torch,port_kernel")
    args = ap.parse_args()
    torch.set_num_threads(4)
    rows = parse_rows(args.rows)
    cmds, sc = smoke_scenarios(rows, args.steps)
    for name in args.paths.split(","):
        t0 = time.perf_counter()
        kkt = PATHS[name](cmds, sc)
        flagged = kkt > THRESHOLD
        order = np.argsort(-kkt.max(1))[:5]
        print(json.dumps({
            "path": name, "batch": len(rows), "steps": args.steps, "dtype": "float32",
            "flagged_scenario_steps": int(flagged.sum()),
            "flagged_scenarios": int(flagged.any(1).sum()), "max_kkt": float(kkt.max()),
            "kkt_at_least_0_5": int((kkt >= 0.5).sum()),
            "worst_rows": [int(r) for r in rows[order]],
            "worst_kkt": [float(k) for k in kkt.max(1)[order]],
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
