"""Epipolar geometry: fundamental matrices from poses, line distances
(counterpart of orbslam_jpminipc_tpu/geometry/epipolar.py).

LocalMapping::ComputeF12 (src/LocalMapping.cc:474-491) and
ORBmatcher::CheckDistEpipolarLine (src/ORBmatcher.cc:136-153) as batched
closed forms.
"""
from __future__ import annotations

import torch

from .se3 import hat


def K_matrix(K4: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = K4[..., 0], K4[..., 1], K4[..., 2], K4[..., 3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, z, cx], -1),
        torch.stack([z, fy, cy], -1),
        torch.stack([z, z, o], -1),
    ], dim=-2)


def fundamental_from_poses(R1, t1, R2, t2, K4) -> torch.Tensor:
    """F12 with x1^T F12 x2 = 0 (the reference's convention) from the
    world->camera poses of two views: R12 = R1 R2^T, t12 = -R12 t2 + t1,
    F12 = K^-T [t12]x R12 K^-1."""
    R12 = R1 @ R2.transpose(-1, -2)
    t12 = -(R12 @ t2[..., None])[..., 0] + t1
    # inv_ex: no error check, so no wait for the device (K is triangular
    # with a positive diagonal)
    Kinv = torch.linalg.inv_ex(K_matrix(K4))[0]
    return Kinv.transpose(-1, -2) @ hat(t12) @ R12 @ Kinv


def epipolar_dist2(uv1: torch.Tensor, uv2: torch.Tensor, F12: torch.Tensor) -> torch.Tensor:
    """Squared distance of x2 to the epipolar line l = F12^T x1 in image 2."""
    x, y = uv1[..., 0], uv1[..., 1]
    a = x * F12[..., 0, 0] + y * F12[..., 1, 0] + F12[..., 2, 0]
    b = x * F12[..., 0, 1] + y * F12[..., 1, 1] + F12[..., 2, 1]
    c = x * F12[..., 0, 2] + y * F12[..., 1, 2] + F12[..., 2, 2]
    num = a * uv2[..., 0] + b * uv2[..., 1] + c
    den = a * a + b * b
    return num * num / torch.clamp(den, min=1e-12)
