"""orbslam_jpminipc_torch — the PyTorch/CUDA port of orbslam_jpminipc_tpu.

The JAX package beside this one is the reference. This package mirrors its
module and public function names (so each counterpart is easy to find) and
keeps its layouts at the public functions: features as (N, 2) xy, (N, 32)
uint8 descriptors, rotations as (3, 3) world->camera.

The whole system is ported (`pipeline/system.py:Slam`, its sharded solvers
on several cards included), with the one hand-written CUDA kernel (FAST,
ops/fast_cuda.py + csrc/fast.cu), its command line (`python -m
orbslam_jpminipc_torch.run`) and the vocabulary trainer (`python -m
orbslam_jpminipc_torch.vocab.train`).

Subpackages
-----------
geometry  : SE3/Sim3 algebra, the pinhole camera, triangulation, epipolar.
ops       : pyramid, FAST, ORB, extraction, Hamming and projection matching.
solvers   : initializer, EPnP/PnP, pose LM, local and global BA, all-Sim3 BA, Sim3,
            essential graph.
parallel  : the sharded global BA and essential graph over a device mesh, in one
            process or a torch.distributed world; the multi-device dry run.
map       : host map state, its device mirror, keyframe database, culling.
vocab     : binary vocabularies (flat and tree), their builders, the trainer, the
            BoW transform and scores.
frontend  : frames, the tracking state machine, the fused WORKING step.
pipeline  : local mapping, loop closing and the `Slam` orchestrator.
io        : the synthetic renderer, TUM directories and PNGs, trajectories, checkpoints,
            the debug drawing and PLY export.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (3x3 rotation products, 6x6 normal equations) needs true float32
# products. A float32 matmul on the card is full precision by default, but
# cuDNN's float32 convolutions run in TF32 unless told otherwise; state both.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
