"""Multi-process start-up for the sharded bundle (counterpart of
dbat_tpu/parallel/distributed.py).

The sharded backend (parallel/sharded.py) reduces over shards through
`Mesh.sum_shards`; once `init_distributed()` has joined every process
to a torch.distributed group, the same code runs with one shard per
process and the shard sums all-gather the partials before adding them
in global shard order.

Usage (one call per process, before building the mesh):

    from dbat_tpu_torch.parallel.distributed import init_distributed, \\
        global_mesh
    init_distributed()              # from torchrun's environment
    mesh = global_mesh()            # one shard per process
    result = bundle(project, mesh=mesh)

Started by `torchrun`, the process reads MASTER_ADDR/MASTER_PORT,
WORLD_SIZE, RANK and LOCAL_RANK; elsewhere pass coordinator_address
("host:port"), num_processes and process_id.  The backend is gloo for
shards on the CPU and NCCL for shards on CUDA cards ("cpu:gloo,cuda:nccl"
where a card exists).  NCCL does not put two processes on one card.
"""

from __future__ import annotations

import os

import torch

from .mesh import Mesh, make_mesh

_initialized = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join this process to the process group when running
    multi-process.

    Returns True when a multi-process group was initialized, False for
    the single-process case (no-op: the mesh then spans this process's
    devices only).  Safe to call more than once."""
    global _initialized
    if _initialized:
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        return False  # single process
    import torch.distributed as dist

    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    _initialized = True
    return True


def global_mesh(axis: str = "obs", device=None) -> Mesh:
    """1-D mesh with one shard per process, on cuda:LOCAL_RANK (or on
    `device`, e.g. "cpu"); in a single process, make_mesh over `device`
    or every visible card."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(None if device is None else [device], axis=axis)
    rank, world = dist.get_rank(), dist.get_world_size()
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    mine = str(make_mesh([device]).device)
    names = [None] * world
    dist.all_gather_object(names, mine)
    return Mesh([torch.device(n) for n in names], axis=axis, owned=(rank,),
                group=dist.group.WORLD)
