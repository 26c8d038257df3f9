"""Pose-only optimization: one SE3 vertex, fixed points, 4-round regating
(counterpart of orbslam_jpminipc_tpu/solvers/pose_opt.py).

Optimizer::PoseOptimization (src/Optimizer.cc:154-285): Huber kernel
sqrt(5.991), 4 rounds x (10, 10, 7, 5) LM iterations with chi^2 outlier
re-gating between rounds (gates {9.21, 7.378, 5.991, 5.991}) and the robust
kernel dropped after round 2. Outliers are masks, not removed edges.

The reference's `lax.while_loop` leaves a round early once an accepted
step gains less than 1e-5 relatively. Here each round runs its full
iteration budget and a `done` flag freezes the state once it is set: the
same result, with no host synchronisation per iteration.

`optimize_pose` is what the callers use: on CUDA tensors it is one launch of
the hand-written kernel (ops/pose_lm_cuda.py, csrc/pose_lm.cu), on CPU
tensors `optimize_pose_plain`, the plain version here and the kernel's
oracle.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import compose, exp_se3, orthonormalize
from .linalg3 import solve6_spd
from .reproj import huber_weight, jacobians, residuals

_CHI2_GATES = (9.210, 7.378, 5.991, 5.991)
_ROUND_ITERS = (10, 10, 7, 5)
_DELTA2 = 5.991


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor
    chi2: torch.Tensor      # final total chi2 over inliers


def _normal_eq(R, t, xw, uv, K4, w):
    """Weighted normal equations: H = sum J^T w J, b = sum J^T w e."""
    e, _ = residuals(R, t, xw, uv, K4)
    Jp, _, _ = jacobians(R, t, xw, K4)
    Jw = Jp * w[:, None, None]
    H = torch.einsum("nij,nik->jk", Jw, Jp)
    b = torch.einsum("nij,ni->j", Jw, e)
    return H, b


def _lm_step(R, t, H, b, lam):
    """One additively damped step (g2o puts lambda on the diagonal)."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    delta = -solve6_spd(H + lam * eye + 1e-10 * eye, b)
    dR, dt = exp_se3(delta)
    R_new, t_new = compose(dR, dt, R, t)
    return R_new, t_new, delta


def optimize_pose(R0, t0, xw, uv, inv_sigma2, valid, K4, use_huber_rounds: int = 2,
                  n_rounds: int = 4) -> PoseOptResult:
    """Pose refinement with chi2 re-gating (`optimize_pose_plain`): the
    kernel on a card, the plain version on the CPU."""
    from ..ops import pose_lm_cuda

    return pose_lm_cuda.optimize_pose(R0, t0, xw, uv, inv_sigma2, valid, K4,
                                      use_huber_rounds=use_huber_rounds, n_rounds=n_rounds)


def optimize_pose_plain(
    R0: torch.Tensor,
    t0: torch.Tensor,
    xw: torch.Tensor,          # (N, 3) fixed map points
    uv: torch.Tensor,          # (N, 2) observed (undistorted) keypoints
    inv_sigma2: torch.Tensor,  # (N,) per-observation information weight
    valid: torch.Tensor,       # (N,) bool — has a map point match
    K4: torch.Tensor,
    use_huber_rounds: int = 2,
    n_rounds: int = 4,
) -> PoseOptResult:
    """Pose refinement with chi2 re-gating; n_rounds < 4 runs a truncated
    schedule (the fused tracker's provisional pass-1 poses)."""
    inlier = valid

    def chi2_of(R, t):
        e, p = residuals(R, t, xw, uv, K4)
        return torch.sum(e * e, dim=-1) * inv_sigma2, p[..., 2] > 0

    R, t = R0, t0
    for rnd in range(n_rounds):
        gate = _CHI2_GATES[rnd]
        use_huber = rnd < use_huber_rounds

        def robust_chi2(R, t):
            c, _ = chi2_of(R, t)
            if use_huber:
                c = torch.where(c <= _DELTA2, c, 2.0 * torch.sqrt(_DELTA2 * c) - _DELTA2)
            return torch.sum(torch.where(inlier, c, torch.zeros_like(c)))

        def weights(R, t):
            c, _ = chi2_of(R, t)
            w = inv_sigma2 * inlier.to(inv_sigma2.dtype)
            if use_huber:
                w = w * huber_weight(c)
            return w

        # lambda init = tau * max(diag H) (optimization_algorithm_levenberg.cpp)
        H0, _ = _normal_eq(R, t, xw, uv, K4, weights(R, t))
        lam = 1e-5 * torch.max(torch.abs(torch.diagonal(H0)))
        chi = robust_chi2(R, t)
        ni = torch.full_like(lam, 2.0)
        done = torch.zeros((), dtype=torch.bool, device=R.device)
        for _ in range(_ROUND_ITERS[rnd]):
            H, b = _normal_eq(R, t, xw, uv, K4, weights(R, t))
            R_new, t_new, delta = _lm_step(R, t, H, b, lam)
            chi_new = robust_chi2(R_new, t_new)
            pred = 0.5 * torch.sum(delta * (lam * delta - b))
            rho = (chi - chi_new) / torch.where(
                torch.abs(pred) < 1e-30, torch.full_like(pred, 1e-30), pred)
            accept = (rho > 0) & (chi_new < chi) & torch.isfinite(chi_new)
            # g2o's relative-gain termination; `live` freezes the state after it
            converged = accept & (chi - chi_new < 1e-5 * chi)
            live = ~done
            take = live & accept
            R = torch.where(take, R_new, R)
            t = torch.where(take, t_new, t)
            chi = torch.where(take, chi_new, chi)
            factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            lam_new = torch.clamp(torch.where(accept, lam * factor, lam * ni), 1e-15, 1e10)
            lam = torch.where(live, lam_new, lam)
            ni = torch.where(live, torch.where(accept, torch.full_like(ni, 2.0), ni * 2.0), ni)
            done = done | converged
        # f32 rotation products drift off SO(3); re-project (g2o renormalizes
        # its quaternion on every update)
        R = orthonormalize(R)
        # re-level: recompute inliers from scratch (outliers can return)
        c, pos = chi2_of(R, t)
        inlier = valid & (c <= gate) & pos

    c, _ = chi2_of(R, t)
    return PoseOptResult(
        R=R, t=t, inliers=inlier, n_inliers=torch.sum(inlier),
        chi2=torch.sum(torch.where(inlier, c, torch.zeros_like(c))),
    )
