"""Sim3 RANSAC from 3D-3D correspondences: batched Horn closed form
(counterpart of orbslam_jpminipc_tpu/solvers/sim3solver.py).

src/Sim3Solver.cc iterates RANSAC sequentially, each iteration running
Horn's 1987 absolute-orientation closed form (computeT, :226-332:
centroids, M = Pr2 Pr1^T, the 4x4 N matrix whose top eigenvector is the
rotation quaternion, scale from the rotated-cloud projection) and a
two-way reprojection gate with chi2 <= 9.210 sigma^2 (CheckInliers
:335-359). Here ALL hypotheses are one batched eigendecomposition, the
Jacobi solver of ops/small_linalg_cuda.py: nothing reads the host, so the
RANSAC runs as one captured program (pipeline/loop_closing.py).

Correspondences are in CAMERA coordinates of the two keyframes
(Sim3Solver.cc:94-98). The estimated T12 maps camera-2 coordinates to
camera-1: x1 = s12 R12 x2 + t12.

The minimal 3-sets are an input (`sets`, (n_hyp, 3) pair indices): the
reference draws them with `jax.random`, which torch cannot reproduce, so a
caller either draws its own (`sample_minimal_sets`, a `torch.Generator`)
or passes the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as cam
from ..geometry.se3 import mat_from_quat
from ..ops.small_linalg_cuda import eigh_small
from . import initializer

N_HYP = 128


class Sim3Result(NamedTuple):
    success: torch.Tensor
    s12: torch.Tensor
    R12: torch.Tensor
    t12: torch.Tensor
    inliers: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor


def sample_minimal_sets(mask: torch.Tensor, n_hyp: int = N_HYP,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """(n_hyp, 3) distinct indices drawn uniformly from the valid pairs:
    per hypothesis the top 3 of uniform scores, invalid slots scoring -1
    (the reference's draw, with this package's generator)."""
    return initializer.sample_minimal_sets(generator, mask, n_hyp, k=3)


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = False):
    """Closed-form Sim3 aligning point sets: x1 ~ s R x2 + t.

    p1, p2: (..., M, 3) paired points. Returns (s, R, t) batched. The top
    eigenvector's sign is free and harmless (R is quadratic in it)."""
    O1 = torch.mean(p1, dim=-2, keepdim=True)
    O2 = torch.mean(p2, dim=-2, keepdim=True)
    Pr1 = p1 - O1
    Pr2 = p2 - O2
    # M = sum_m pr2_m pr1_m^T: with the standard Horn N-matrix below, the
    # top eigenvector is the quaternion of R mapping frame 2 -> frame 1
    M = torch.einsum("...mi,...mj->...ij", Pr2, Pr1)
    m = lambda i, j: M[..., i, j]
    N = torch.stack(
        [
            torch.stack([m(0, 0) + m(1, 1) + m(2, 2), m(1, 2) - m(2, 1), m(2, 0) - m(0, 2), m(0, 1) - m(1, 0)], -1),
            torch.stack([m(1, 2) - m(2, 1), m(0, 0) - m(1, 1) - m(2, 2), m(0, 1) + m(1, 0), m(2, 0) + m(0, 2)], -1),
            torch.stack([m(2, 0) - m(0, 2), m(0, 1) + m(1, 0), -m(0, 0) + m(1, 1) - m(2, 2), m(1, 2) + m(2, 1)], -1),
            torch.stack([m(0, 1) - m(1, 0), m(2, 0) + m(0, 2), m(1, 2) + m(2, 1), -m(0, 0) - m(1, 1) + m(2, 2)], -1),
        ],
        dim=-2,
    )
    _, vecs = eigh_small(N)
    R = mat_from_quat(vecs[..., :, -1])  # top eigenvector = [w, x, y, z]
    RPr2 = torch.einsum("...ij,...mj->...mi", R, Pr2)
    if fix_scale:
        s = torch.ones(p1.shape[:-2], dtype=p1.dtype, device=p1.device)
    else:
        num = torch.sum(Pr1 * RPr2, dim=(-2, -1))
        den = torch.sum(RPr2 * RPr2, dim=(-2, -1))
        s = num / torch.clamp(den, min=1e-12)
    t = O1[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, O2[..., 0, :])
    return s, R, t


def _check_inliers(s, R, t, p1, p2, uv1, uv2, K4, max_err1, max_err2):
    """Two-way reprojection gate (CheckInliers, Sim3Solver.cc:335-359)."""
    # p2 into camera 1 with T12, projected, against uv1
    x2in1 = s[..., None, None] * torch.einsum("...ij,...mj->...mi", R, p2) + t[..., None, :]
    e1 = cam.project(x2in1, K4) - uv1
    # the inverse: p1 in camera 2
    s_inv = 1.0 / s
    Rt = R.transpose(-1, -2)
    t_inv = -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t)
    x1in2 = s_inv[..., None, None] * torch.einsum("...ij,...mj->...mi", Rt, p1) + t_inv[..., None, :]
    e2 = cam.project(x1in2, K4) - uv2
    return (torch.sum(e1 * e1, dim=-1) < max_err1) & (torch.sum(e2 * e2, dim=-1) < max_err2)


def solve_sim3(
    sets: torch.Tensor,      # (n_hyp, 3) indices of the minimal sets
    p1: torch.Tensor,        # (N, 3) points in camera-1 frame
    p2: torch.Tensor,        # (N, 3) matched points in camera-2 frame
    uv1: torch.Tensor,       # (N, 2) their pixels in image 1
    uv2: torch.Tensor,       # (N, 2) their pixels in image 2
    mask: torch.Tensor,      # (N,) bool
    K4: torch.Tensor,
    max_err1: torch.Tensor,  # (N,) 9.21 * sigma2(level) gates per point
    max_err2: torch.Tensor,
    min_inliers: int = 20,
    fix_scale: bool = False,
) -> Sim3Result:
    """All-hypotheses Sim3 RANSAC (Sim3Solver::iterate, fully batched)."""
    sets = sets.to(torch.int64)
    n_hyp = sets.shape[0]
    s_h, R_h, t_h = horn_sim3(p1[sets], p2[sets], fix_scale=fix_scale)
    ok = _check_inliers(s_h, R_h, t_h, p1[None], p2[None], uv1[None], uv2[None], K4,
                        max_err1[None], max_err2[None])
    ok = ok & mask[None, :] & (s_h[:, None] > 0)
    counts = torch.sum(ok, dim=1)
    # the most inliers, the lowest hypothesis among equals (unique keys)
    order = torch.arange(n_hyp - 1, -1, -1, device=p1.device)
    # (a 1-element index: indexing with a 0-d tensor reads it on the host)
    best = torch.argmax(counts * n_hyp + order).reshape(1)
    pick = lambda x: x[best][0]
    n_in, ok_b = pick(counts), pick(ok)

    # one more Horn fit on the best inlier set (the reference's Refine-like
    # step): re-centre on the inliers only; masked rows sit at the centroid
    # and add nothing to M or to the scale sums
    w = ok_b.to(p1.dtype)[:, None]
    nw = torch.clamp(torch.sum(w), min=3.0)
    O1 = torch.sum(p1 * w, dim=0) / nw
    O2 = torch.sum(p2 * w, dim=0) / nw
    Pr1 = (p1 - O1) * w
    Pr2 = (p2 - O2) * w
    sr, Rr, tr = horn_sim3(Pr1[None] + O1, Pr2[None] + O2, fix_scale=fix_scale)
    sr, Rr, tr = sr[0], Rr[0], tr[0]
    ok_r = _check_inliers(sr, Rr, tr, p1, p2, uv1, uv2, K4, max_err1, max_err2) & mask
    n_r = torch.sum(ok_r)

    use_refined = n_r >= n_in
    n_f = torch.maximum(n_r, n_in)
    return Sim3Result(
        success=n_f >= min_inliers,
        s12=torch.where(use_refined, sr, pick(s_h)),
        R12=torch.where(use_refined, Rr, pick(R_h)),
        t12=torch.where(use_refined, tr, pick(t_h)),
        inliers=torch.where(use_refined, ok_r, ok_b & mask),
        n_inliers=n_f,
    )
