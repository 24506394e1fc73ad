"""The port's `parallel/` (torch.distributed in place of the JAX package's
device mesh) against the JAX package's on the CPU:

  * `make_mesh`: the (hosts, chips) shape and axes over the ranks of a
    process group ((1, n), and hosts reshaping, not folding, as
    tests/test_parallel.py pins for JAX), each rank's coordinates and its
    `shard_batch` slice, here under torch's in-process fake process group
    (no communication: only the layout is tested); one rank without a group;
  * the port's `sharded_sweep_step` (one process, no group,
    `qp_backend="torch"`: the JAX package's CPU choice "xla") against the
    JAX package's on its virtual 8-device CPU mesh (tests/conftest.py):
    B = 8, T = 24, alternate scenarios walking, numpy-made friction,
    payload and push scenarios (a push window inside the 24 steps); the
    SweepMetrics to rtol 1e-8 (the KKT ones plus 1e-12 absolute, their
    float64 rounding floor: see KKT_FLOOR) and every leaf of the final carry
    to 1e-8 of its scale, float64;
  * the same sweep with `qp_backend="kernel"` (the kernels' plain versions
    on the CPU): finite, no scenario fallen;
  * `sharded_wbc_step` on one rank, two steps (cold, then warm with the
    carried cache), bit for bit `wbc_step_batched`.

One JAX sweep for the module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from quadrupedwholebodycontroller_tpu.config import ControllerParams as JaxControllerParams
from quadrupedwholebodycontroller_tpu.config import PlannerParams as JaxPlannerParams
from quadrupedwholebodycontroller_tpu.config import QPSolverParams as JaxQPSolverParams
from quadrupedwholebodycontroller_tpu.models import anymal_d_model as jax_model
from quadrupedwholebodycontroller_tpu.parallel import make_mesh as jax_make_mesh
from quadrupedwholebodycontroller_tpu.parallel import shard_batch as jax_shard_batch
from quadrupedwholebodycontroller_tpu.parallel import sharded_sweep_step as jax_sweep_step
from quadrupedwholebodycontroller_tpu.sim import SimParams as JaxSimParams
from quadrupedwholebodycontroller_tpu.sim import rollout as jrollout
from quadrupedwholebodycontroller_tpu.sim import scenario as jscenario
from quadrupedwholebodycontroller_tpu_torch import convert
from quadrupedwholebodycontroller_tpu_torch.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller_tpu_torch.control import wbc
from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
from quadrupedwholebodycontroller_tpu_torch.parallel import (
    make_mesh,
    shard_batch,
    sharded_sweep_step,
    sharded_wbc_step,
)
from quadrupedwholebodycontroller_tpu_torch.parallel.sweep import SweepMetrics
from quadrupedwholebodycontroller_tpu_torch.sim import SimParams
from tests._torch_port_util import commands, flagship_inputs, scaled_err, scenarios

B, T = 8, 24
RTOL = 1e-8
# the KKT residuals of the converged float64 QPs sit at their rounding floor
# (~1e-12, against a mean of ~8.5e-10): there another batch composition
# alone moves them, the JAX package's own batched rollout of these
# scenarios at B = 8 and B = 1 by up to 1.2e-12 an entry and 5e-14 on
# mean_kkt; the port's B = 8 reads 1.6e-13 from the JAX sweep's
# per-device B = 1.  So the KKT metrics are held to RTOL plus this floor.
KKT_FLOOR = 1e-12
_RUN = {}


def _run():
    if _RUN:
        return _RUN
    torch.set_num_threads(1)
    dt = jnp.float64
    jm = jax_model(dtype=dt)
    jcp, jpp = JaxControllerParams(), JaxPlannerParams()
    carry = jrollout.init_rollout_carry(jm, jcp, jpp, dtype=dt)
    bcarry = jax.tree.map(lambda x: jnp.stack([x] * B), carry)
    scen = jscenario.Scenario(**{k: jnp.asarray(v) for k, v in scenarios(B, T).items()})
    mesh = jax_make_mesh(8)
    step = jax_sweep_step(jm, jcp, jpp, JaxQPSolverParams(), JaxSimParams(), mesh)
    jcarry, jmetrics = step(jax_shard_batch(bcarry, mesh),
                            jax_shard_batch(jnp.asarray(commands(B, T)), mesh),
                            jax_shard_batch(scen, mesh))
    _RUN.update(start=jax.tree.map(np.asarray, bcarry), carry=jax.tree.map(np.asarray, jcarry),
                metrics=jax.tree.map(np.asarray, jmetrics))
    return _RUN


def _port_sweep(qp_backend):
    key = f"port_{qp_backend}"
    if key not in _RUN:
        r = _run()
        model = anymal_d_model(torch.float64, "cpu")
        mesh = make_mesh(device="cpu")
        step = sharded_sweep_step(model, ControllerParams(), PlannerParams(), QPSolverParams(),
                                  SimParams(), mesh, "walk", qp_backend=qp_backend)
        carry = convert.rollout_carry_from_numpy(r["start"], torch.float64, "cpu")
        scen = convert.scenario_from_numpy(scenarios(B, T), torch.float64, "cpu")
        cmds = torch.as_tensor(commands(B, T))
        _RUN[key] = step(*shard_batch((carry, cmds, scen), mesh))
    return _RUN[key]


def _leaves(port, want, path=""):
    """(path, port leaf, other leaf) over the port tree's fields (the
    other tree's leaves found by field name, or by position in a plain
    tuple)."""
    if isinstance(port, tuple) and hasattr(port, "_fields"):
        for k, v in zip(port._fields, port):
            yield from _leaves(v, getattr(want, k), f"{path}.{k}")
    elif isinstance(port, tuple):
        for i, (v, w) in enumerate(zip(port, want)):
            yield from _leaves(v, w, f"{path}[{i}]")
    else:
        yield path, port, want


@pytest.mark.parametrize("world,rank,hosts,shape", [
    (8, 5, None, (1, 8)), (8, 5, 2, (2, 4)), (4, 3, 4, (4, 1)), (2, 1, 2, (2, 1))])
def test_mesh_shape_axes_and_shards(world, rank, hosts, shape):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        mesh = make_mesh(world, hosts=hosts)
        assert mesh.shape == shape and mesh.size == world and mesh.distributed
        assert mesh.axis_names == ("hosts", "chips")
        assert mesh.coords == divmod(rank, shape[1]) and mesh.device.type == "cpu"
        x = torch.arange(4 * world * 3.0).reshape(4 * world, 3)
        got = shard_batch({"x": x, "s": torch.tensor(2.0), "n": 7}, mesh)
        assert torch.equal(got["x"], x[4 * rank:4 * rank + 4]) and got["n"] == 7
        assert float(got["s"]) == 2.0
        with pytest.raises(ValueError, match="split"):
            shard_batch(torch.zeros(world + 1, 2), mesh)
        with pytest.raises(ValueError, match="host"):
            make_mesh(world, hosts=3)
    finally:
        dist.destroy_process_group()


def test_mesh_without_a_group_is_one_rank_on_the_card():
    mesh = make_mesh()
    assert mesh.shape == (1, 1) and mesh.rank == 0 and not mesh.distributed
    assert mesh.device == torch.device("cuda")
    assert make_mesh(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="spans every rank"):
        make_mesh(8)


@pytest.mark.parametrize("field", SweepMetrics._fields)
def test_sweep_metrics_match_jax(field):
    r = _run()
    _, metrics = _port_sweep("torch")
    got, want = float(getattr(metrics, field)), float(getattr(r["metrics"], field))
    atol = KKT_FLOOR if field.endswith("_kkt") else 0.0
    assert abs(got - want) <= RTOL * abs(want) + atol, (field, got, want)
    if field == "n_scenarios":
        assert got == B
    if field == "max_kkt":      # the case: the QPs were solved, and no one fell
        assert 0.0 < got < 3e-3 and float(metrics.fallen_fraction) == 0.0


@pytest.mark.parametrize("part", ["sim", "wbc", "planner", "ref"])
def test_sweep_final_carry_matches_jax(part):
    r = _run()
    carry, _ = _port_sweep("torch")
    leaves = list(_leaves(convert.to_numpy(getattr(carry, part)), getattr(r["carry"], part)))
    assert leaves
    for path, got, want in leaves:
        assert got.shape == want.shape, path
        assert scaled_err(got, want) <= RTOL, (path, scaled_err(got, want))


def test_sweep_on_the_kernel_backend_is_finite_and_alive():
    carry, metrics = _port_sweep("kernel")
    assert float(metrics.n_scenarios) == B and float(metrics.fallen_fraction) == 0.0
    assert all(np.isfinite(float(m)) for m in metrics)
    assert float(metrics.max_kkt) < 3e-3
    assert all(bool(torch.isfinite(t).all()) for t in carry.sim)
    assert float(carry.sim.base_p[:, 2].min()) > 0.4


def test_sharded_wbc_step_on_one_rank_is_wbc_step_batched():
    torch.set_num_threads(1)
    model, cp, qpp, obs, ref, carry, cache = flagship_inputs(B)
    mesh = make_mesh(device="cpu")
    step = sharded_wbc_step(model, cp, qpp, mesh)
    got_a = step(*shard_batch((obs, ref, carry, cache), mesh), False)
    got_b = step(obs, ref, got_a[1], got_a[2], True)
    want_a = wbc.wbc_step_batched(model, cp, qpp, obs, ref, carry, True, "kernel", cache, False)
    want_b = wbc.wbc_step_batched(model, cp, qpp, obs, ref, want_a[1], True, "kernel",
                                  want_a[2], True)
    for got, want in ((got_a, want_a), (got_b, want_b)):
        for path, g, w in _leaves(convert.to_numpy(got), convert.to_numpy(want)):
            np.testing.assert_array_equal(g, w, err_msg=path)
    assert float(got_b[0].qp_info.kkt_residual.max()) < 3e-3
