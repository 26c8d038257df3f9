"""SO3/SE3 operations used by the tracking step (counterpart of
orbslam_jpminipc_tpu/geometry/se3.py).

Conventions as in the reference package: rotations are 3x3 matrices
(world->camera as Tcw), rigid transforms are (R, t) pairs acting by
x_cam = R @ x_world + t, se3 tangents are [omega, upsilon] (rotation first)
and updates are left-multiplicative, T_new = exp(xi) * T_old. All functions
batch over leading dimensions.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``w`` (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis-angle (..., 3) -> rotation matrix (..., 3, 3),
    with Taylor fallbacks near the identity."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 > _EPS
    a = torch.where(small, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(
        small, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS * _EPS),
        0.5 - theta2 / 24.0,
    )
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V such that exp_se3([w, v]).t = V @ v (the SO3 left Jacobian)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 > _EPS
    b = torch.where(
        small, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS * _EPS),
        0.5 - theta2 / 24.0,
    )
    c = torch.where(
        small,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS ** 3),
        1.0 / 6.0 - theta2 / 120.0,
    )
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def exp_se3(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """se3 exp map: 6-vector ``[omega, upsilon]`` -> ``(R, t)``."""
    w, v = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    V = _so3_left_jacobian(w)
    t = (V @ v[..., None])[..., 0]
    return R, t


def compose(Ra, ta, Rb, tb) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ra,ta) * (Rb,tb): apply b first, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w, x, y, z]; branch-free
    Shepperd (the largest of the four pivots picks the construction),
    canonical sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = torch.sqrt(torch.clamp(1.0 + m00 + m11 + m22, min=1e-12)) * 0.5
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 0.5
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 0.5
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 0.5
    c0 = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw)], -1)
    c1 = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx)], -1)
    c2 = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy)], -1)
    c3 = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz], -1)
    idx = torch.argmax(torch.stack([qw, qx, qy, qz], dim=-1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3): two Newton steps of the
    polar iteration X <- X (3 I - X^T X) / 2, as in the reference package
    (f32 rotation products drift off the manifold and must be re-projected)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(2):
        RtR = R.transpose(-1, -2) @ R
        R = R @ (1.5 * eye - 0.5 * RtR)
    return R
