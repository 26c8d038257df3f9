"""Reprojection residuals, analytic Jacobians and Huber weights (counterpart
of orbslam_jpminipc_tpu/solvers/reproj.py).

Residual e = uv_obs - project(R x + t) (g2o's sign); pose tangent
xi = [omega, upsilon] with left-multiplicative update T <- exp(xi) T, so
dp/domega = -[p]_x and dp/dupsilon = I for p = R x + t.
"""
from __future__ import annotations

import math

import torch

from ..geometry.se3 import hat

CHI2_MONO = 5.991  # 2-dof 95% gate
HUBER_DELTA = math.sqrt(CHI2_MONO)


def _safe_inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def _transform(R, t, xw):
    """R xw + t: one (3, 3) pose for all points, or one pose per point."""
    if R.dim() == 2:
        return xw @ R.T + t
    return torch.einsum("...ij,...j->...i", R, xw) + t


def residuals(R, t, xw, uv, K4):
    """e = uv - project(R xw + t). Shapes: xw (N, 3), uv (N, 2); R (3, 3)
    or (N, 3, 3) and t (3,) or (N, 3)."""
    p = _transform(R, t, xw)
    inv_z = _safe_inv_z(p[..., 2])
    u = K4[0] * p[..., 0] * inv_z + K4[2]
    v = K4[1] * p[..., 1] * inv_z + K4[3]
    e = uv - torch.stack([u, v], dim=-1)
    return e, p


def jac_pixel_wrt_point_cam(p, K4):
    """d(projection)/dp for camera-frame points p: (..., 2, 3)."""
    x, y = p[..., 0], p[..., 1]
    inv_z = _safe_inv_z(p[..., 2])
    inv_z2 = inv_z * inv_z
    fx, fy = K4[0], K4[1]
    zr = torch.zeros_like(x)
    row0 = torch.stack([fx * inv_z, zr, -fx * x * inv_z2], dim=-1)
    row1 = torch.stack([zr, fy * inv_z, -fy * y * inv_z2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def jacobians(R, t, xw, K4):
    """Residual Jacobians: (J_pose (N, 2, 6), J_point (N, 2, 3), p_cam).
    J_pose columns are [omega, upsilon]; J_point is wrt the WORLD point."""
    p = _transform(R, t, xw)
    Jproj = jac_pixel_wrt_point_cam(p, K4)
    Jw = Jproj @ hat(p)        # = -Jproj @ (-hat p)
    Jpose = torch.cat([Jw, -Jproj], dim=-1)
    Jpoint = -(Jproj @ R)
    return Jpose, Jpoint, p


def huber_weight(chi2, delta: float = HUBER_DELTA):
    """IRLS weight of the Huber kernel at squared error chi2."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-18))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)
