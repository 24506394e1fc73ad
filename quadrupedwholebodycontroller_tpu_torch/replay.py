"""Replay of a recorded 400 Hz trajectory through the batched control step.

A recording (`data/walk_traj_400hz.npz`: one observation, one planner
reference and a `ref_is_new` flag per step) is broadcast to B scenarios,
each shifted by its own constant observation offset, and driven through
`control.wbc.wbc_step_batched` with the carry and the QP cache threaded
from step to step: `cache_valid` is False on the first step, True after.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import (
    QP_NUM_CONSTRAINTS,
    QP_NUM_VARS,
    ControllerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.ops import qp

# standard deviation and width of the per-scenario constant offsets
OFFSET_SIGMA = {"base_p": (0.01, 3), "base_vel": (0.02, 6), "q": (0.02, 12), "qd": (0.05, 12)}


def make_offsets(batch: int, dtype, rng: np.random.Generator, device="cuda"):
    """Per-scenario constant observation offsets drawn from `rng`."""
    return {k: torch.as_tensor(s * rng.standard_normal((batch, d)), device=device).to(dtype)
            for k, (s, d) in OFFSET_SIGMA.items()}


def step_inputs(traj, t: int, batch: int, dtype, offsets=None, device="cuda"):
    """(observation, reference, ref_is_new) of recorded step t, broadcast to
    the batch, the observation shifted by `offsets`."""
    bc = lambda k: np.broadcast_to(traj[k][t], (batch,) + traj[k][t].shape)
    obs = convert.obs_from_numpy({k: bc(k) for k in wbc.RobotObservation._fields}, dtype, device)
    if offsets is not None:
        obs = obs._replace(**{k: getattr(obs, k) + v for k, v in offsets.items()})
    ref = convert.ref_from_numpy({k: bc(k) for k in wbc.Reference._fields}, dtype, device)
    return obs, ref, bool(traj["ref_is_new"][t])


def replay(model, traj, steps, batch: int, qpp: QPSolverParams, offsets=None,
           on_step=None, timed: bool = False, setup_backend: str = "auto",
           cparams: ControllerParams | None = None, qp_backend: str = "kernel"):
    """Drive `wbc_step_batched` over the recorded steps `steps` (an iterable
    of step indices) from `init_carry` and an invalid cache, on the model's
    device and dtype.  `on_step(t, out, ms)` sees every step's output; with
    `timed` the device is synchronised around each step and `ms` is the
    step's host time, else `ms` is None.  `qp_backend` and `setup_backend`
    are the step's ("kernel": the kernels; "torch": tensor code; a setup
    backend "auto" follows the QP backend), and `cparams` its controller
    parameters (default `ControllerParams()`).  Returns the final (carry,
    cache)."""
    dtype, device = model.mass.dtype, model.mass.device
    cp = ControllerParams() if cparams is None else cparams
    carry = wbc.init_carry(batch, dtype, device)
    cache = qp.make_cache(batch, QP_NUM_VARS, QP_NUM_CONSTRAINTS, qpp, dtype, device)
    inputs = [(t, *step_inputs(traj, t, batch, dtype, offsets, device)) for t in steps]
    valid, ms = False, None
    for t, obs, ref, new in inputs:
        if timed:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        out, carry, cache = wbc.wbc_step_batched(
            model, cp, qpp, obs, ref, carry, new, qp_backend, cache, valid,
            setup_backend=setup_backend)
        if timed:
            torch.cuda.synchronize(device)
            ms = (time.perf_counter() - t0) * 1e3
        valid = True
        if on_step is not None:
            on_step(t, out, ms)
    return carry, cache
