"""The port's `parallel/` across a real process boundary: two gloo processes
on the CPU, started from this file (run as a script it is the worker, which
imports torch, numpy and the port only), rendezvous through
`parallel.mesh.distributed_init` and form a (2, 1) mesh:

  * the sweep (`sharded_sweep_step`, B = 8, T = 12, `qp_backend="torch"`,
    float64, the scenarios of tests/test_torch_parallel.py), each rank on
    its 4 scenarios, the metrics reduced with gloo `all_reduce`: both ranks'
    metrics identical, and equal to the one-process sweep of the same
    scenarios to rtol 1e-10; each rank's final simulator state equal to
    its half of the one-process sweep's, to 1e-10 of scale;
  * `sharded_wbc_step`, two steps (cold, then warm with the carried cache),
    float64: each rank's outputs, carry and cache equal to
    `wbc_step_batched` on its half, to 1e-10 of scale.

The workers run with their own timeout; the parent kills any left over."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
B, T, WORLD = 8, 12, 2
TOL = 1e-10
WORKER_TIMEOUT_S = 300
_RUN = {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sweep(mesh):
    """(final carry, metrics) of the sweep over this rank's shard."""
    from quadrupedwholebodycontroller_tpu_torch import convert
    from quadrupedwholebodycontroller_tpu_torch.config import (
        ControllerParams,
        PlannerParams,
        QPSolverParams,
    )
    from quadrupedwholebodycontroller_tpu_torch.models import anymal_d_model
    from quadrupedwholebodycontroller_tpu_torch.parallel import shard_batch, sharded_sweep_step
    from quadrupedwholebodycontroller_tpu_torch.sim import SimParams
    from quadrupedwholebodycontroller_tpu_torch.sim.rollout import init_rollout_carry
    from tests._torch_port_util import commands, scenarios

    dt = torch.float64
    model, cp, pp = anymal_d_model(dt, "cpu"), ControllerParams(), PlannerParams()
    step = sharded_sweep_step(model, cp, pp, QPSolverParams(), SimParams(), mesh, "walk",
                              qp_backend="torch")
    carry = init_rollout_carry(model, cp, B, pp, dt, "cpu")
    scen = convert.scenario_from_numpy(scenarios(B, T), dt, "cpu")
    return step(*shard_batch((carry, torch.as_tensor(commands(B, T)), scen), mesh))


def _flagship(mesh):
    """Two steps of `sharded_wbc_step` on this rank's shard."""
    from quadrupedwholebodycontroller_tpu_torch.parallel import shard_batch, sharded_wbc_step
    from tests._torch_port_util import flagship_inputs

    model, cp, qpp, obs, ref, carry, cache = flagship_inputs(B, torch.float64)
    step = sharded_wbc_step(model, cp, qpp, mesh)
    obs, ref, carry, cache = shard_batch((obs, ref, carry, cache), mesh)
    out_a, carry_a, cache_a = step(obs, ref, carry, cache, False)
    return out_a, step(obs, ref, carry_a, cache_a, True)


def _flat(tree):
    """The tensors of a nested tuple as a list of nested lists."""
    if isinstance(tree, torch.Tensor):
        return [tree.tolist()]
    return [x for v in tree for x in _flat(v)]


def worker(rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)
    from quadrupedwholebodycontroller_tpu_torch.parallel import distributed_init, make_mesh

    import torch.distributed as dist

    assert distributed_init(f"localhost:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(hosts=world)
        assert mesh.shape == (world, 1) and mesh.rank == rank and mesh.distributed
        carry, metrics = _sweep(mesh)
        out_a, (out_b, carry_b, cache_b) = _flagship(mesh)
        print("RESULT " + json.dumps({
            "rank": rank, "metrics": [float(m) for m in metrics],
            "sim": _flat(carry.sim), "flagship": _flat((out_a, out_b, carry_b, cache_b))}),
            flush=True)
    finally:
        dist.destroy_process_group()


def _two_processes():
    if _RUN:
        return _RUN
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
                               str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(WORLD)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert lines, f"no RESULT line:\n{out}\n{err}"
            r = json.loads(lines[-1][len("RESULT "):])
            _RUN[r["rank"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return _RUN


def _one_process():
    if "one" not in _RUN:
        from quadrupedwholebodycontroller_tpu_torch.parallel import make_mesh

        torch.set_num_threads(1)
        _RUN["one"] = _sweep(make_mesh(device="cpu"))
    return _RUN["one"]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max())) <= TOL


def test_both_ranks_reduce_to_the_same_metrics():
    r = _two_processes()
    assert r[0]["metrics"] == r[1]["metrics"]
    assert r[0]["metrics"][4] == B and r[0]["metrics"][3] == 0.0   # n, fallen


def test_two_process_metrics_equal_the_one_process_sweep():
    r = _two_processes()
    _, metrics = _one_process()
    for got, want in zip(r[0]["metrics"], metrics):
        assert abs(got - float(want)) <= TOL * abs(float(want)), (got, float(want))


def test_each_rank_holds_its_half_of_the_final_state():
    r = _two_processes()
    carry, _ = _one_process()
    half = B // WORLD
    for rank in range(WORLD):
        for got, want in zip(r[rank]["sim"], carry.sim):
            assert _close(got, want[rank * half:(rank + 1) * half])


def test_sharded_wbc_step_per_rank_equals_wbc_step_batched_on_its_half():
    from quadrupedwholebodycontroller_tpu_torch.control import wbc
    from tests._torch_port_util import flagship_inputs

    r = _two_processes()
    torch.set_num_threads(1)
    model, cp, qpp, obs, ref, carry, cache = flagship_inputs(B, torch.float64)
    half = B // WORLD
    for rank in range(WORLD):
        rows = slice(rank * half, (rank + 1) * half)
        o, rf, c, ca = (_rows(t, rows) for t in (obs, ref, carry, cache))
        out_a, carry_a, cache_a = wbc.wbc_step_batched(model, cp, qpp, o, rf, c, True, "kernel",
                                                       ca, False)
        want = wbc.wbc_step_batched(model, cp, qpp, o, rf, carry_a, True, "kernel", cache_a,
                                    True)
        got = r[rank]["flagship"]
        want = _flat((out_a, want[0], want[1], want[2]))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _close(g, w)


def _rows(tree, rows):
    if isinstance(tree, torch.Tensor):
        return tree[rows].contiguous()
    return type(tree)(*(_rows(v, rows) for v in tree))


if __name__ == "__main__":
    sys.path.insert(0, os.path.abspath(ROOT))
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
