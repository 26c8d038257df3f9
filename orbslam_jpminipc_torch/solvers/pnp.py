"""Batched PnP RANSAC for relocalization (counterpart of
orbslam_jpminipc_tpu/solvers/pnp.py).

src/PnPsolver.cc draws sequential 4-point EPnP minimal sets
(PnPsolver.cc:137-230); here RANSAC is one batched program over all
hypotheses: EPnP on every minimal set at once, inliers counted over all
points, EPnP again on the best hypothesis's inliers (Refine :232-277).

Inlier gating matches the reference: squared reprojection error against
per-point 5.991 * sigma2(octave) (PnPsolver.cc:280-311 mvMaxError).

The minimal sets are an input (`sets`, (n_hyp, 4) point indices): the
reference draws them with `jax.random`, which torch cannot reproduce, so a
caller either draws its own (`sample_minimal_sets`, a `torch.Generator`)
or passes the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as cam
from . import initializer
from .epnp import epnp_pose

N_HYP = 256
MIN_SET = 4


class PnPResult(NamedTuple):
    success: torch.Tensor
    R: torch.Tensor          # (3, 3) world->camera
    t: torch.Tensor          # (3,)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor


def sample_minimal_sets(mask: torch.Tensor, n_hyp: int = N_HYP,
                        generator: torch.Generator | None = None,
                        min_set: int = MIN_SET) -> torch.Tensor:
    """(n_hyp, min_set) distinct indices drawn uniformly from the valid
    points: per hypothesis the top `min_set` of uniform scores, invalid
    slots scoring -1 (the reference's draw, with this package's generator)."""
    return initializer.sample_minimal_sets(generator, mask, n_hyp, k=min_set)


def _dlt_pose(xw: torch.Tensor, rays: torch.Tensor, w: torch.Tensor):
    """Weighted DLT pose from 2D-3D: xw (..., M, 3), rays (..., M, 2)
    normalized image coords, w (..., M) weights. Returns (R, t, ok)."""
    x, y, z = xw[..., 0], xw[..., 1], xw[..., 2]
    u, v = rays[..., 0], rays[..., 1]
    o = torch.ones_like(x)
    zr = torch.zeros_like(x)
    r1 = torch.stack([x, y, z, o, zr, zr, zr, zr, -u * x, -u * y, -u * z, -u], dim=-1)
    r2 = torch.stack([zr, zr, zr, zr, x, y, z, o, -v * x, -v * y, -v * z, -v], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)  # (..., 2M, 12)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    p = vecs[..., :, 0]
    P = p.reshape(*p.shape[:-1], 3, 4)
    # cheirality sign on the PROJECTIVE matrix first: the projective depth
    # w_i = P_row3 . [x; 1] must be positive for points in front
    xh = torch.cat([xw, torch.ones_like(xw[..., :1])], dim=-1)
    depth = torch.einsum("...j,...mj->...m", P[..., 2, :], xh)
    sign = torch.where(torch.sum(torch.sign(depth) * w, dim=-1) < 0, -1.0, 1.0)
    P = P * sign[..., None, None]
    M = P[..., :3]
    U, S, Vt = torch.linalg.svd(M)
    detUV = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(detUV), torch.ones_like(detUV), detUV], dim=-1)
    R = U @ (D[..., :, None] * Vt)
    scale = torch.mean(S, dim=-1)
    t = P[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    ok = (
        torch.isfinite(R).all(dim=-1).all(dim=-1)
        & torch.isfinite(t).all(dim=-1)
        & (detUV > 0)  # genuine poses orthonormalize without reflection
    )
    return R, t, ok


def solve_pnp(
    sets: torch.Tensor,      # (n_hyp, min_set) indices of the minimal sets
    xw: torch.Tensor,        # (N, 3) world points
    uv: torch.Tensor,        # (N, 2) observed pixels (undistorted)
    mask: torch.Tensor,      # (N,) bool
    K4: torch.Tensor,
    max_err2: torch.Tensor,  # (N,) per-point chi2 gates (5.991 * sigma2)
    min_inliers: int = 10,
) -> PnPResult:
    """All-hypotheses EPnP RANSAC with inlier refit.

    EPnP minimal sets of 4 (the reference's mRansacMinSet,
    PnPsolver.cc:93-129), all hypotheses in one batch."""
    sets = sets.to(torch.int64)
    n_hyp, min_set = sets.shape
    w_min = torch.ones((n_hyp, min_set), dtype=xw.dtype, device=xw.device)
    R_h, t_h, ok_h = epnp_pose(xw[sets], uv[sets], w_min, K4)

    # score hypotheses by inliers over all points (CheckInliers :280-311)
    xc = torch.einsum("hij,nj->hni", R_h, xw) + t_h[:, None, :]
    uv_proj = cam.project(xc, K4)
    err2 = torch.sum((uv_proj - uv[None]) ** 2, dim=-1)
    inl = (err2 <= max_err2[None]) & (xc[..., 2] > 0) & mask[None] & ok_h[:, None]
    counts = torch.sum(inl, dim=1)
    # the most inliers, the lowest hypothesis among equals (unique keys)
    order = torch.arange(n_hyp - 1, -1, -1, device=xw.device)
    # (a 1-element index: indexing with a 0-d tensor reads it on the host)
    best = torch.argmax(counts * n_hyp + order).reshape(1)
    pick = lambda x: x[best][0]

    # refit EPnP on the best hypothesis's inliers (PnPsolver::Refine
    # :232-277: the reference also re-runs compute_pose on the inlier set)
    inl_b = pick(inl)
    R_r, t_r, ok_r = epnp_pose(xw[None], uv[None], inl_b.to(xw.dtype)[None], K4)
    R_r, t_r, ok_r = R_r[0], t_r[0], ok_r[0]
    xc_r = torch.einsum("ij,nj->ni", R_r, xw) + t_r
    err2_r = torch.sum((cam.project(xc_r, K4) - uv) ** 2, dim=-1)
    inl_r = (err2_r <= max_err2) & (xc_r[..., 2] > 0) & mask & ok_r

    use_refined = torch.sum(inl_r) >= pick(counts)
    R_f = torch.where(use_refined, R_r, pick(R_h))
    t_f = torch.where(use_refined, t_r, pick(t_h))
    in_f = torch.where(use_refined, inl_r, inl_b)
    n_f = torch.sum(in_f)
    return PnPResult(success=n_f >= min_inliers, R=R_f, t=t_f, inliers=in_f, n_inliers=n_f)
