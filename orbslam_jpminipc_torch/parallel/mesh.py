"""A one-axis device mesh for the sharded solvers (the counterpart of the
`jax.sharding.Mesh` that orbslam_jpminipc_tpu/parallel/ runs `shard_map`
programs over).

A `DeviceMesh` holds the shards of THIS process, each on its own
`torch.device` (several shards may share one device, as the CPU tests do),
and knows where they sit on the mesh's one axis: `offset` is the global
index of its first shard, `size` the number of shards of the whole mesh.
`psum` and `pmax` combine one partial per local shard into the value over
the whole mesh, on `home` (the first local device):

  * in one process, the partials are copied to `home` and added in shard
    order;
  * across processes (`distributed=True`, a `torch.distributed` world; see
    parallel/multihost.py), this process's shards are added the same way and
    the sum then goes through one `all_reduce` (Gloo on the CPU, NCCL on the
    card).

Neither reads the device on the host: the copies between devices and the
collective are queued like any other operation.

`mesh_devices(device)` lists the devices a system on `device` may shard
over: every CUDA device of the process for a card, the device alone
otherwise.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


def mesh_devices(device) -> list[torch.device]:
    """The devices a solver on `device` may shard over: all CUDA devices of
    this process when `device` is a card, else `device` alone."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


@dataclass
class DeviceMesh:
    devices: list                 # this process's shards, one torch.device each
    distributed: bool = False     # sum across the torch.distributed world too
    offset: int = 0               # global index of the first local shard
    size: int = field(default=-1) # shards of the whole mesh (-1: the local ones)

    def __post_init__(self):
        self.devices = [torch.device(d) for d in self.devices]
        if self.size < 0:
            self.size = len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def local_shards(self, n_axis: int) -> list[int]:
        """Indices into a shard axis of length `n_axis` of this process's
        shards: the global layout (the whole mesh's shards) or the local one
        (what `lift_sharded_problem` leaves)."""
        if n_axis == self.size:
            return list(range(self.offset, self.offset + len(self.devices)))
        if n_axis == len(self.devices):
            return list(range(n_axis))
        raise ValueError(f"a shard axis of {n_axis} on a mesh of {self.size} shards, "
                         f"{len(self.devices)} of them in this process")

    def _reduce(self, parts, op):
        total = parts[0].to(self.home)
        for p in parts[1:]:
            total = op(total, p.to(self.home))
        return total

    def psum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The sum over every shard of the mesh of one partial per local shard."""
        total = self._reduce(parts, torch.add)
        if self.distributed:
            torch.distributed.all_reduce(total, op=torch.distributed.ReduceOp.SUM)
        return total

    def pmax(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The maximum over every shard of the mesh."""
        total = self._reduce(parts, torch.maximum)
        if self.distributed:
            torch.distributed.all_reduce(total, op=torch.distributed.ReduceOp.MAX)
        return total

    def replicate(self, x: torch.Tensor) -> dict:
        """`x` (on `home`) as one copy per distinct local device."""
        return {d: x.to(d) for d in dict.fromkeys(self.devices)}
