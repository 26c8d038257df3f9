"""Multi-device distribution: map-partitioned bundle adjustment and the
edge-sharded essential graph (counterpart of orbslam_jpminipc_tpu/parallel).

Map points and their observations are sharded across devices, each shard
Schur-reduces its own point blocks, and the reduced camera system, whose
size is only O(keyframes), is summed over the mesh and solved replicated;
the essential graph shards its edges the same way. A `DeviceMesh`
(parallel/mesh.py) stands for `jax.sharding.Mesh`: the shards of one
process on its devices, or one shard a process in a `torch.distributed`
world (parallel/multihost.py), NCCL on the cards and Gloo on the CPU.
"""
from .mesh import DeviceMesh, mesh_devices  # noqa: F401
from .sharded_ba import shard_ba_problem, sharded_bundle_adjust  # noqa: F401
from .sharded_pose_graph import (  # noqa: F401
    shard_essential_graph, sharded_optimize_essential_graph,
)
