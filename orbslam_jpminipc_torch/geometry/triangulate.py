"""Two-view DLT triangulation and its validity gates (counterpart of
orbslam_jpminipc_tpu/geometry/triangulate.py).

Initializer::Triangulate (src/Initializer.cc:732-745) and the gates of
LocalMapping::CreateNewMapPoints (src/LocalMapping.cc:299-374) as batched
closed forms: the 3x3 normal equations of the inhomogeneous DLT system,
solved through the adjugate, instead of a per-point 4x4 SVD.
"""
from __future__ import annotations

import torch

from ..solvers.linalg3 import inv3
from .camera import project
from .epipolar import K_matrix


def projection_matrix(R: torch.Tensor, t: torch.Tensor, K4: torch.Tensor) -> torch.Tensor:
    """K[R|t] as a (..., 3, 4) matrix."""
    return K_matrix(K4) @ torch.cat([R, t[..., None]], dim=-1)


def triangulate_dlt(uv1: torch.Tensor, uv2: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor):
    """Batched two-view DLT. uv: (..., 2) pixels, P: (3, 4) or (..., 3, 4).
    Returns (xw (..., 3), ok) where ok flags a non-singular, finite solve."""
    def rows(uv, P):
        r0 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r1 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return torch.stack([r0, r1], dim=-2)

    r1, r2 = rows(uv1, P1), rows(uv2, P2)
    shape = torch.broadcast_shapes(r1.shape, r2.shape)
    A = torch.cat([r1.expand(shape), r2.expand(shape)], dim=-2)  # (..., 4, 4)
    M = A[..., :3]
    b = -A[..., 3]
    AtA = torch.einsum("...ki,...kj->...ij", M, M)
    Atb = torch.einsum("...ki,...k->...i", M, b)
    a0, b0, c0 = AtA[..., 0, 0], AtA[..., 0, 1], AtA[..., 0, 2]
    d0, e0, f0 = AtA[..., 1, 0], AtA[..., 1, 1], AtA[..., 1, 2]
    g0, h0, i0 = AtA[..., 2, 0], AtA[..., 2, 1], AtA[..., 2, 2]
    cA = e0 * i0 - f0 * h0
    cD = f0 * g0 - d0 * i0
    cG = d0 * h0 - e0 * g0
    det = a0 * cA + b0 * cD + c0 * cG
    ok = torch.abs(det) > 1e-18
    eye = torch.eye(3, dtype=AtA.dtype, device=AtA.device).expand(AtA.shape)
    safe = torch.where(ok[..., None, None], AtA, eye)
    x = torch.einsum("...ij,...j->...i", inv3(safe), Atb)
    finite = torch.isfinite(x).all(dim=-1)
    return x, ok & finite


def parallax_cos(xw: torch.Tensor, O1: torch.Tensor, O2: torch.Tensor) -> torch.Tensor:
    """Cosine of the parallax angle at xw seen from camera centers O1, O2."""
    n1 = xw - O1
    n2 = xw - O2
    d1 = torch.linalg.norm(n1, dim=-1)
    d2 = torch.linalg.norm(n2, dim=-1)
    return torch.sum(n1 * n2, dim=-1) / torch.clamp(d1 * d2, min=1e-12)


def reprojection_error2(xw, uv, R, t, K4):
    """Squared pixel reprojection error and positive-depth mask."""
    xc = torch.einsum("...ij,...j->...i", R, xw) + t
    err = project(xc, K4) - uv
    return torch.sum(err * err, dim=-1), xc[..., 2] > 0
