"""The batched control step over this rank's shard: `wbc_step_batched`
with its carried QPCache, the kernel setup, warm gating, polish and staged
rescue, data-parallel over the mesh.

Scenarios are not coupled inside a step: every reduction of the solve chain
is per scenario, and the batch-level gates (the rescue's trigger, the warm
top-k compaction) act per shard, the right distributed meaning: a shard's
rescue fires for its own scenarios only.  So a shard's result is
`wbc_step_batched` on that shard alone; it equals the step of the whole
batch wherever the gates decide the same both ways.
"""
from __future__ import annotations

from quadrupedwholebodycontroller_tpu_torch.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models.robot_model import RobotModel
from quadrupedwholebodycontroller_tpu_torch.parallel.mesh import Mesh


def sharded_wbc_step(model: RobotModel, cparams: ControllerParams,
                     qparams: QPSolverParams, mesh: Mesh, qp_backend: str = "kernel"):
    """Returns `step(obs, ref, carry, cache, cache_valid)` ->
    (out, new_carry, new_cache) over this rank's shard of the mesh
    (`shard_batch`), with the shard's own QPCache (`ops.qp.make_cache` at
    the shard's batch), every tensor on `mesh.device`; references count as
    new.  The step has no collective."""
    def step(obs, ref, carry, cache, cache_valid):
        return wbc.wbc_step_batched(model, cparams, qparams, obs, ref, carry, True,
                                    qp_backend, cache, cache_valid)

    return step
