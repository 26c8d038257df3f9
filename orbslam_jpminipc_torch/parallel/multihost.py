"""Multi-process distributed execution (counterpart of
orbslam_jpminipc_tpu/parallel/multihost.py).

The reference joins processes into one JAX runtime and runs its
`shard_map` programs over a global device mesh. Here the processes join a
`torch.distributed` world (NCCL between cards, Gloo on the CPU), each
process is one shard of the world's mesh on its own device, and the
sharded solvers (parallel/sharded_ba.py, sharded_pose_graph.py) run
unchanged over it: their one sum per iteration becomes one `all_reduce`.

Each process holds the full host-side map (SLAM state is small; the device
work is what scales), builds the same sharded problem and moves only its
own shard onto its device (`lift_sharded_problem`); the replicated outputs
are the same in every process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import DeviceMesh
from .sharded_ba import _SHARD_FIELDS, ShardedBAProblem


def initialize_distributed(coordinator_address: str, num_processes: int, process_id: int,
                           device=None) -> None:
    """Join the `torch.distributed` world at `coordinator_address`
    (host:port, or a tcp:// address) as rank `process_id` of
    `num_processes` (idempotent per process). `device=None` is a card of
    this process (rank modulo the cards present), joined over NCCL; a
    caller that names the CPU joins over Gloo."""
    if device is None:
        resolve_device(None)   # raises where there is no card
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return
    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=addr,
                            world_size=num_processes, rank=process_id)


def global_mesh() -> DeviceMesh:
    """The world as one mesh: one shard a process, on its device (the
    current card under NCCL, the CPU under Gloo). The reference names the
    mesh's axis here; in the port the solver called is what says which axis
    the shards split."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh: call initialize_distributed first")
    dev = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    return DeviceMesh([dev], distributed=True, offset=dist.get_rank(),
                      size=dist.get_world_size())


def lift_sharded_problem(sprob: ShardedBAProblem, mesh: DeviceMesh) -> ShardedBAProblem:
    """A host-side ShardedBAProblem (leading (S, ...) shard axis, S the
    mesh's size) as this process's part of it: its own shard slice and the
    replicated camera arrays, on its device. Every process calls this with
    the SAME data."""
    idx = mesh.local_shards(sprob.points.shape[0])
    dev = mesh.home
    shard = {k: torch.stack([getattr(sprob, k)[j] for j in idx]).to(dev) for k in _SHARD_FIELDS}
    return sprob._replace(kf_R=sprob.kf_R.to(dev), kf_t=sprob.kf_t.to(dev),
                          kf_fixed=sprob.kf_fixed.to(dev), K4=sprob.K4.to(dev), **shard)
