"""Sim3 refinement between two keyframes from matched 3D points
(counterpart of orbslam_jpminipc_tpu/solvers/sim3_opt.py).

Optimizer::OptimizeSim3 (src/Optimizer.cc:1721-1917): a single
VertexSim3Expmap with paired fixed points, forward EdgeSim3ProjectXYZ
(e = uv1 - proj(S12 . x2)) and inverse EdgeInverseSim3ProjectXYZ
(e = uv2 - proj(S12^-1 . x1)), Huber sqrt(10), 5 iterations -> prune
chi2 > 10 -> 10 more iterations.

The reference takes the 4x7 Jacobian of the residual at xi = 0 with
`jax.jacfwd`. Here it is written out, which is the same matrix: for
y = exp(xi) . p, dy/dxi at 0 is [-hat(p), I, p] (rotation, translation,
log-scale; the translation's W matrix is the identity at 0 and its
derivative multiplies upsilon = 0), so with y2 = S12 . x2 and
z1 = S12^-1 . x1

    d e1 / d xi = -Jproj(y2) [-hat(y2), I, y2]
    d e2 / d xi =  Jproj(z1) (1/s) R^T [-hat(x1), I, x1]

One pass of a few dozen elementwise and 3x3 launches instead of a traced
forward-mode sweep per iteration. The 7x7 solve is `solve_ex`: no check of
its result on the host inside the rounds.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import camera as cam
from ..geometry import sim3 as s3
from ..geometry.se3 import hat
from .reproj import huber_weight, jac_pixel_wrt_point_cam

_CHI2_SIM3 = 10.0
_HUBER_SIM3 = math.sqrt(10.0)


class Sim3OptResult(NamedTuple):
    s12: torch.Tensor
    R12: torch.Tensor
    t12: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def residuals(s, R, t, x1, x2, uv1, uv2, K4):
    """(N, 4) two-way reprojection residuals [e1, e2] of the pairs under
    S12 = (s, R, t), and the transformed points (y2 in camera 1, z1 in
    camera 2)."""
    y2 = s3.transform(s, R, t, x2)
    z1 = s3.transform(*s3.inverse(s, R, t), x1)
    e = torch.cat([uv1 - cam.project(y2, K4), uv2 - cam.project(z1, K4)], dim=-1)
    return e, y2, z1


def _tangent_action(p):
    """d(exp(xi) . p)/d xi at xi = 0: (..., 3, 7) = [-hat(p), I, p]."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(*p.shape[:-1], 3, 3)
    return torch.cat([-hat(p), eye, p[..., None]], dim=-1)


def jacobian(s, R, t, x1, y2, z1, K4, fix_scale: bool = False):
    """(N, 4, 7) Jacobian of `residuals` with respect to the left
    perturbation xi of S12, at xi = 0."""
    J1 = -(jac_pixel_wrt_point_cam(y2, K4) @ _tangent_action(y2))
    J2 = jac_pixel_wrt_point_cam(z1, K4) @ ((R.transpose(-1, -2) / s) @ _tangent_action(x1))
    J = torch.cat([J1, J2], dim=-2)
    if fix_scale:
        J = torch.cat([J[..., :6], torch.zeros_like(J[..., 6:])], dim=-1)
    return J


def optimize_sim3(
    s12_0, R12_0, t12_0,
    x1: torch.Tensor,      # (N, 3) points in camera-1 frame
    x2: torch.Tensor,      # (N, 3) matched points in camera-2 frame
    uv1: torch.Tensor,     # (N, 2)
    uv2: torch.Tensor,     # (N, 2)
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    K4: torch.Tensor,
    fix_scale: bool = False,
    iters1: int = 5,
    iters2: int = 10,
) -> Sim3OptResult:
    eye7 = torch.eye(7, dtype=x1.dtype, device=x1.device)

    def chi2_pair(e):
        return (torch.sum(e[:, :2] ** 2, dim=1) * inv_sigma2_1,
                torch.sum(e[:, 2:] ** 2, dim=1) * inv_sigma2_2)

    def gn_rounds(state, n_iters, active):
        s, R, t = state
        for _ in range(n_iters):
            e, y2, z1 = residuals(s, R, t, x1, x2, uv1, uv2, K4)
            J = jacobian(s, R, t, x1, y2, z1, K4, fix_scale)
            c1, c2 = chi2_pair(e)
            w1 = inv_sigma2_1 * huber_weight(c1, _HUBER_SIM3) * active
            w2 = inv_sigma2_2 * huber_weight(c2, _HUBER_SIM3) * active
            w = torch.stack([w1, w1, w2, w2], dim=1)  # (N, 4)
            Jw = J * w[:, :, None]
            H = torch.einsum("nij,nik->jk", Jw, J)
            b = torch.einsum("nij,ni->j", Jw, e)
            H = H + 1e-3 * torch.diag(torch.diagonal(H)) + 1e-9 * eye7
            delta = -torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
            s, R, t = s3.retract(s, R, t, delta, fix_scale=fix_scale)
        return s, R, t

    def inliers_of(state):
        c1, c2 = chi2_pair(residuals(*state, x1, x2, uv1, uv2, K4)[0])
        return valid & (c1 < _CHI2_SIM3) & (c2 < _CHI2_SIM3)

    state = gn_rounds((s12_0, R12_0, t12_0), iters1, valid.to(x1.dtype))
    state = gn_rounds(state, iters2, inliers_of(state).to(x1.dtype))
    inlier = inliers_of(state)
    s, R, t = state
    return Sim3OptResult(s12=s, R12=R, t12=t, inliers=inlier, n_inliers=torch.sum(inlier))
