"""Scenario sweeps: the batched robustness workload (thousands of parallel
scenarios over payload mass, ground friction and pushes, sharded over the
ranks of a mesh).

Each rank runs the closed loop (planner, control step, physics with one
payload model per scenario) on its shard; the sweep's metrics are reduced
across ranks with two `all_reduce` calls (the reference's topic bus
collapsed to one collective of sums and one of maxima).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from quadrupedwholebodycontroller_tpu_torch.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.models.robot_model import RobotModel
from quadrupedwholebodycontroller_tpu_torch.parallel.mesh import Mesh
from quadrupedwholebodycontroller_tpu_torch.planner import gait, trot
from quadrupedwholebodycontroller_tpu_torch.sim import world
from quadrupedwholebodycontroller_tpu_torch.sim.rollout import batched_rollout
from quadrupedwholebodycontroller_tpu_torch.sim.scenario import Scenario, apply_payload


class SweepMetrics(NamedTuple):
    """Health metrics reduced over every rank (0-d tensors)."""

    mean_kkt: torch.Tensor           # mean QP KKT residual over batch and time
    max_kkt: torch.Tensor
    mean_tracking_err: torch.Tensor  # mean |com - ref| (xyz)
    fallen_fraction: torch.Tensor    # scenarios whose CoM dropped below 0.2 m
    n_scenarios: torch.Tensor


def sweep_metrics(trace, mesh: Mesh) -> SweepMetrics:
    """This rank's trace (leaves (B, T, ...)) -> the metrics over every
    rank, the same on each.  Non-finite values (a frozen or fallen
    scenario) are zeroed, so one diverged scenario cannot poison the
    reductions."""
    kkt = torch.where(torch.isfinite(trace.qp_kkt), trace.qp_kkt, 0.0)
    err = torch.abs(trace.com_pose[..., :3] - trace.ref_com_pose[..., :3])
    err = torch.where(torch.isfinite(err), err, 0.0)
    z = trace.com_pos[..., 2]
    fallen = torch.any((z < 0.2) | ~torch.isfinite(z), dim=-1)
    sums = torch.stack([torch.sum(torch.mean(kkt, dim=-1)),
                        torch.sum(torch.mean(err, dim=(-2, -1))),
                        torch.sum(fallen.to(kkt.dtype)),
                        torch.tensor(float(kkt.shape[0]), dtype=kkt.dtype,
                                     device=kkt.device)])
    max_kkt = torch.max(kkt)
    if mesh.distributed:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(max_kkt, op=dist.ReduceOp.MAX)
    n = sums[3]
    return SweepMetrics(mean_kkt=sums[0] / n, max_kkt=max_kkt,
                        mean_tracking_err=sums[1] / n, fallen_fraction=sums[2] / n,
                        n_scenarios=n)


def gait_planner(gait_name: str, cparams: ControllerParams, pparams: PlannerParams):
    """(planner_fn, control steps per planner tick) of the sweep's gait:
    "walk" (the reference's static walk, `pparams`) or "trot" (the default
    `trot.TrotParams`)."""
    if gait_name == "walk":
        return (lambda s, c: gait.planner_step(pparams, s, c),
                int(round(cparams.loop_rate * pparams.dt)))
    if gait_name == "trot":
        tp = trot.TrotParams()
        return (lambda s, c: trot.trot_step(tp, s, c),
                max(1, int(round(cparams.loop_rate * tp.dt))))
    raise ValueError(f"gait_name {gait_name!r}: 'walk' or 'trot'")


def sharded_sweep_step(model: RobotModel, cparams: ControllerParams,
                       pparams: PlannerParams, qparams: QPSolverParams,
                       sparams: world.SimParams, mesh: Mesh, gait_name: str = "walk",
                       qp_backend: str = "kernel"):
    """The sweep over this rank's shard: returns
    `run(carry, commands, scenario=None, mark=None)` -> (carry, SweepMetrics)
    for the shard's carry, commands (B, T, 3) and Scenario (nominal if
    None), each on `mesh.device`.  It simulates one payload model per
    scenario (the controller keeps the nominal `model`), runs
    `batched_rollout` with `qp_backend` ("kernel": the kernels, "torch":
    tensor code) and reduces the metrics over the mesh.  gait_name: "walk"
    (the reference's static walk) or "trot"; `mark` as in `batched_rollout`."""
    planner_fn, ratio = gait_planner(gait_name, cparams, pparams)

    def run(carry, commands, scenario=None, mark=None):
        if scenario is None:
            scenario = Scenario.nominal(commands.shape[0], commands.shape[1], sparams.friction,
                                        commands.dtype, commands.device)
        sim_model = apply_payload(model, scenario.payload_mass, scenario.payload_com)
        carry, trace = batched_rollout(model, cparams, qparams, sparams, planner_fn, ratio,
                                       carry, commands, scenario, sim_model, mark,
                                       qp_backend=qp_backend)
        return carry, sweep_metrics(trace, mesh)

    return run
