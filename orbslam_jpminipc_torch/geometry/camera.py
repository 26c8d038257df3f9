"""Pinhole camera model with radial-tangential distortion (counterpart of
orbslam_jpminipc_tpu/geometry/camera.py).

Intrinsics are a 4-vector ``K4 = [fx, fy, cx, cy]``, distortion a 4-vector
``dist = [k1, k2, p1, p2]``. All functions batch over leading dimensions.
"""
from __future__ import annotations

import torch


def _safe_inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def project(xc: torch.Tensor, K4: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (..., 3) to pixels (..., 2). No distortion."""
    inv_z = _safe_inv_z(xc[..., 2])
    u = K4[0] * xc[..., 0] * inv_z + K4[2]
    v = K4[1] * xc[..., 1] * inv_z + K4[3]
    return torch.stack([u, v], dim=-1)


def unproject(uv: torch.Tensor, K4: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> normalized camera rays (..., 3) with z=1."""
    x = (uv[..., 0] - K4[2]) / K4[0]
    y = (uv[..., 1] - K4[3]) / K4[1]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(uv: torch.Tensor, K4: torch.Tensor, dist: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Undistort pixel keypoints (cv::undistortPoints equivalent): a fixed
    number of fixed-point iterations on normalized coordinates, re-projected
    with the same K."""
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + k1 * r2 + k2 * r2 * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) * icdist, (yd - dy) * icdist
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


def project_distorted(xc: torch.Tensor, K4: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (..., 3) applying the full distortion model."""
    inv_z = _safe_inv_z(xc[..., 2])
    xyd = distort_normalized(torch.stack([xc[..., 0] * inv_z, xc[..., 1] * inv_z], dim=-1), dist)
    return torch.stack([xyd[..., 0] * K4[0] + K4[2], xyd[..., 1] * K4[1] + K4[3]], dim=-1)


def in_image(uv: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Mask of points inside [min_x, max_x, min_y, max_y] image bounds."""
    return (
        (uv[..., 0] >= bounds[0])
        & (uv[..., 0] < bounds[1])
        & (uv[..., 1] >= bounds[2])
        & (uv[..., 1] < bounds[3])
    )


def frustum_check(xw, R, t, K4, bounds, normal, min_dist, max_dist,
                  view_cos_limit: float = 0.5):
    """Batched Frame::isInFrustum for (N, 3) world points under one pose.

    Returns (visible_mask, uv, inv_z, view_cos, dist), as the reference does.
    """
    xc = xw @ R.T + t
    z = xc[..., 2]
    uv = project(xc, K4)
    Ow = -(R.T @ t)
    po = xw - Ow
    dist = torch.linalg.norm(po, dim=-1)
    view_cos = torch.sum(po * normal, dim=-1) / torch.clamp(dist, min=1e-12)
    ok = (
        (z > 0.0)
        & in_image(uv, bounds)
        & (dist >= min_dist)
        & (dist <= max_dist)
        & (view_cos > view_cos_limit)
    )
    return ok, uv, 1.0 / torch.clamp(z, min=1e-12), view_cos, dist
