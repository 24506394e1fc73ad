"""The ranks of a process group as a (hosts, chips) mesh, and the sharding
of a scenario batch over it.

The workload is scenario data-parallel: every rank runs the same program on
its contiguous slice of the scenario batch, and the only communication is
the sweep's metric reduction (`all_reduce`, `parallel/sweep.py`).  There is
one rank per GPU (NCCL) or per CPU process (gloo); without a process group
the mesh is one rank on the caller's device, so one process needs no
rendezvous.  The batch-minor cache layout is not ported: every leaf is
batch-major, split along its first axis.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

BATCH_AXES = ("hosts", "chips")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (hosts, chips) view of the ranks; this process is `rank`, row-major
    over `shape`, and keeps its shard on `device`.  `distributed`: the ranks
    are those of the default process group, and reductions cross them."""

    shape: tuple
    rank: int
    device: torch.device
    distributed: bool
    axis_names: tuple = BATCH_AXES

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self) -> tuple:
        """(host, chip) of this rank."""
        return divmod(self.rank, self.shape[1])


def make_mesh(n_devices: int | None = None, hosts: int | None = None,
              device=None) -> Mesh:
    """The mesh over every rank of the default process group (one rank
    without a group).  `hosts` reshapes the ranks into (hosts, n / hosts);
    by default it is the number of machines (world size over
    $LOCAL_WORLD_SIZE, as torchrun sets it; one without it).  `device`
    defaults to the rank's GPU under NCCL, the CPU under another backend,
    and the card without a group."""
    distributed = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if distributed else (1, 0)
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh spans every rank: n_devices={n}, but {world} rank(s)")
    if hosts is None:
        hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if hosts < 1 or n % hosts:
        raise ValueError(f"{n} rank(s) do not split into {hosts} host(s)")
    if device is None:
        if not distributed:
            device = "cuda"
        elif dist.get_backend() == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = "cpu"
    return Mesh((hosts, n // hosts), rank, torch.device(device), distributed)


def _tree_map(fn, tree):
    """fn over the leaves of nested (named) tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: Mesh):
    """This rank's shard of a tree of global tensors: every tensor with a
    leading batch axis is cut into `mesh.size` contiguous slices in rank
    order (the layout of a batch split over ("hosts", "chips")) and this
    rank's slice moved to `mesh.device`; a 0-d tensor is moved whole, and
    anything else passes through.  Every process passes the full tree."""
    def take(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.ndim == 0:
            return x.to(mesh.device)
        if x.shape[0] % mesh.size:
            raise ValueError(f"batch {x.shape[0]} does not split over {mesh.size} rank(s)")
        b = x.shape[0] // mesh.size
        return x[mesh.rank * b:(mesh.rank + 1) * b].to(mesh.device).contiguous()

    return _tree_map(take, tree)


def distributed_init(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device="cuda") -> bool:
    """Join the process group (the rendezvous that replaces the reference's
    ROS master): NCCL with one GPU a rank for device "cuda", gloo for "cpu".
    `coordinator` is "host:port"; without it (and without the counts) the
    variables torchrun sets are read (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK, LOCAL_RANK).  Does nothing for one process; returns whether it
    made a group (the caller then destroys it)."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if torch.device(device).type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}" if coordinator
                            else "env://", world_size=num_processes, rank=process_id)
    return True
