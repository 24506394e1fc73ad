#!/usr/bin/env python3
"""The walk's QPs of chosen scenarios of `chip_smoke.py`, on the CPU,
through the JAX package's default "xla" backend in float32 and the port's
two float32 paths, each held against the port's torch backend in float64:
which of them stops on a wrong-set saddle whose sign violation sits just
under the solver's 1e-5 certificate.

    JAX_PLATFORMS=cpu python3 tools/certificate_edge.py [--scenarios 737,825]
        [--steps 3]

The scenarios take the observation offsets the smoke draws at B = 4096
(`replay.make_offsets`, numpy seed 1) and replay the recorded walk from
step 0 as a batch of their own; each path carries its state from step to
step.  Paths: `jax_xla_f32` (`wbc_step_batched(qp_backend="xla")`),
`port_torch_f32` (`qp_backend="torch"`), `port_kernel_f32` (the kernel
path with a carried cache; the kernels' plain versions on the CPU), and
`port_torch_f64`, the reference (the port's torch backend reproduces the
JAX package's float64 torque records to 1e-11 N.m,
`tests/test_torch_torque_records.py`).  Prints one JSON line per
scenario-step: each float32 path's torque error against the reference,
its relative KKT residual and sign violation.

The batch-level rescue of the torch backend re-solves the whole batch when
any scenario is flagged, so a scenario's iterate can depend on the batch
it sits in: a sub-batch need not reproduce the smoke's B = 4096 result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxCP  # noqa: E402
from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQP  # noqa: E402
from quadrupedwholebodycontroller_tpu.control import wbc as jwbc  # noqa: E402
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model  # noqa: E402
from quadrupedwholebodycontroller_tpu.ops import qp as jqp  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch import replay  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.config import (  # noqa: E402
    ControllerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model  # noqa: E402
from quadrupedwholebodycontroller_tpu_torch.ops import qp  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SMOKE_BATCH, SMOKE_OFFSET_SEED = 4096, 1


def port_path(traj, steps, offsets, dtype, backend):
    """Per step (tau, KKT, sign violation) of the port's replay."""
    rows, last = [], {}
    orig = qp.solve_batched

    def spy(data, *a, **k):                # the outermost solve of the step comes last
        out = orig(data, *a, **k)
        last["data"], last["state"] = data, out[0]
        return out

    def on_step(t, out, ms):
        st = last["state"]
        rows.append((out.tau.double().numpy(), out.qp_info.kkt_residual.double().numpy(),
                     qp._sign_violation(last["data"], st.x, st.y).double().numpy()))

    qp.solve_batched = spy
    try:
        replay.replay(anymal_d_model(dtype, "cpu"), traj, range(steps),
                      offsets["q"].shape[0], QPSolverParams(),
                      {k: v.to(dtype) for k, v in offsets.items()}, on_step,
                      qp_backend=backend)
    finally:
        qp.solve_batched = orig
    return rows


def jax_path(traj, steps, offsets):
    """Per step (tau, KKT, sign violation) of the JAX package's xla path in
    float32 (no cache, as its default)."""
    B = offsets["q"].shape[0]
    jm, jcp, jq = jax_model(dtype=jnp.float32), JaxCP(), JaxQP()
    step = jax.jit(lambda o, r, c, n: jwbc.wbc_step_batched(jm, jcp, jq, o, r, c, n, "xla"))
    setup = jax.jit(jax.vmap(lambda o, r, c, n: jwbc.wbc_setup(jm, jcp, o, r, c, n)))
    carry = jax.tree.map(lambda x: jnp.stack([x] * B), jwbc.init_carry(jnp.float32))
    rows = []
    for t in range(steps):
        bc = lambda k: np.broadcast_to(traj[k][t], (B,) + traj[k][t].shape)
        obs = jwbc.RobotObservation(**{
            k: jnp.asarray(bc(k) + (offsets[k].numpy() if k in offsets else 0.0), jnp.float32)
            for k in jwbc.RobotObservation._fields})
        ref = jwbc.Reference(**{k: jnp.asarray(bc(k), jnp.float32)
                                for k in jwbc.Reference._fields})
        new = jnp.full((B,), bool(traj["ref_is_new"][t]))
        data = setup(obs, ref, carry, new).qp_data
        out, carry = step(obs, ref, carry, new)
        sv = jqp._sign_violation(data, out.qp_x, carry.qp_warm.y)
        rows.append((np.asarray(out.tau, np.float64), np.asarray(out.qp_info.kkt_residual,
                                                                  np.float64),
                     np.asarray(sv, np.float64)))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenarios", default="737,825")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    torch.set_num_threads(4)
    pick = [int(s) for s in args.scenarios.split(",")]
    traj = np.load(os.path.join(ROOT, "data", "walk_traj_400hz.npz"))
    full = replay.make_offsets(SMOKE_BATCH, torch.float64,
                               np.random.default_rng(SMOKE_OFFSET_SEED), "cpu")
    offsets = {k: v[pick] for k, v in full.items()}
    ref = port_path(traj, args.steps, offsets, torch.float64, "torch")
    paths = {"jax_xla_f32": jax_path(traj, args.steps, offsets),
             "port_torch_f32": port_path(traj, args.steps, offsets, torch.float32, "torch"),
             "port_kernel_f32": port_path(traj, args.steps, offsets, torch.float32, "kernel")}
    for t in range(args.steps):
        for i, b in enumerate(pick):
            row = {"step": t, "scenario": b, "reference_kkt": float(ref[t][1][i])}
            for name, rows in paths.items():
                tau, kkt, sv = (r[i] for r in rows[t])
                row[name] = {"dtau_Nm": float(np.abs(tau - ref[t][0][i]).max()),
                             "kkt": float(kkt), "sign_violation": float(sv)}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
