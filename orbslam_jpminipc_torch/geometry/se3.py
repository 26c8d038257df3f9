"""SO3/SE3 operations (counterpart of orbslam_jpminipc_tpu/geometry/se3.py):
`hat`, `vee`, `exp_so3`, `log_so3`, `exp_se3`, `log_se3`, `compose`,
`inverse`, `transform`, `retract`, `camera_center`, `orthonormalize`, the
quaternion helpers `quat_from_mat`, `mat_from_quat`, `quat_mul`, and the
7-vector storage format `pose7_from_Rt`, `Rt_from_pose7`.

Conventions as in the reference package: rotations are 3x3 matrices
(world->camera as Tcw), rigid transforms are (R, t) pairs acting by
x_cam = R @ x_world + t, se3 tangents are [omega, upsilon] (rotation first)
and updates are left-multiplicative, T_new = exp(xi) * T_old. Quaternions
are [w, x, y, z], normalized. All functions batch over leading dimensions,
use no data-dependent indexing and keep both arms of every `where` finite,
so `torch.func.vmap` and `torch.func.jacfwd` trace through them.
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


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


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


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), through the unit
    quaternion (stable for all angles in [0, pi], the near-pi case included).

    The smoothed norm keeps the function AND its derivatives finite at the
    identity: a plain norm has a NaN gradient at 0, which would poison the
    forward-mode Jacobians of the Sim3 pose-graph residuals."""
    q = quat_from_mat(R)  # w >= 0, so theta lies in [0, pi]
    w, xyz = q[..., 0], q[..., 1:]
    n = torch.sqrt(torch.sum(xyz * xyz, dim=-1) + 1e-24)
    theta = 2.0 * torch.atan2(n, w)
    return (theta / n)[..., None] * xyz


def log_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`exp_se3`: ``(R, t)`` -> 6-vector ``[omega, upsilon]``.
    The 3x3 solve is `solve_ex`: no check of its result on the host."""
    w = log_so3(R)
    v = torch.linalg.solve_ex(_so3_left_jacobian(w), t[..., None])[0][..., 0]
    return torch.cat([w, v], dim=-1)


def compose(Ra, ta, Rb, tb) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ra,ta) * (Rb,tb): apply b first, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t) -> tuple[torch.Tensor, torch.Tensor]:
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform(R, t, x) -> torch.Tensor:
    """Apply (R, t) to points x of shape (..., 3)."""
    return (R @ x[..., None])[..., 0] + t


def retract(R, t, xi) -> tuple[torch.Tensor, torch.Tensor]:
    """Left-multiplicative update ``exp(xi) * (R, t)`` (g2o oplus)."""
    dR, dt = exp_se3(xi)
    return compose(dR, dt, R, t)


def camera_center(R, t) -> torch.Tensor:
    """Camera center in world coords for a world->camera transform: -R^T t."""
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


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
    # the first of the largest pivots, selected with `where` (no indexing
    # by data, so the function maps and differentiates in forward mode)
    idx = torch.argmax(torch.stack([qw, qx, qy, qz], dim=-1), dim=-1)[..., None]
    q = torch.where(idx == 0, c0, torch.where(idx == 1, c1, torch.where(idx == 2, c2, c3)))
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def mat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [w, x, y, z] (normalized here) -> rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def pose7_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack (R, t) into a 7-vector [qw,qx,qy,qz, tx,ty,tz] (storage format)."""
    return torch.cat([quat_from_mat(R), t], dim=-1)


def Rt_from_pose7(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return mat_from_quat(p[..., :4]), p[..., 4:7]


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3): two Newton steps of the
    polar iteration X <- X (3 I - X^T X) / 2, as in the reference package
    (f32 rotation products drift off the manifold and must be re-projected)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(2):
        RtR = R.transpose(-1, -2) @ R
        R = R @ (1.5 * eye - 0.5 * RtR)
    return R
