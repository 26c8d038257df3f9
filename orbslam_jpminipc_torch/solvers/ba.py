"""Bundle adjustment with Schur-complement marginalization (counterpart of
orbslam_jpminipc_tpu/solvers/ba.py).

g2o's BlockSolver_6_3 + LM (Optimizer::{BundleAdjustment,
LocalBundleAdjustment}, src/Optimizer.cc:38-152, 287-536) over flat padded
observation arrays:
  * per-camera 6x6 and per-point 3x3 Hessian blocks by scatter-add over
    observations;
  * the camera-point coupling assembled densely per (point, camera),
    A[p, c] = J_c^T W J_p, so the Schur complement is one einsum
    S[c, d] -= sum_p A[p, c] (Hll_p + lam I)^-1 A[p, d]^T;
  * the reduced (6K x 6K) camera system solved by a dense Cholesky;
  * g2o's gain-ratio LM schedule.

The reference leaves its `lax.while_loop` early once an accepted step gains
less than 1e-5 relatively. Here the loop runs its full iteration budget and
a `done` flag freezes the state once it is set: the same result, with no
host read per iteration. The returned outlier mask mirrors the reference's
post-BA erasure (chi2 > 5.991 or depth <= 0, Optimizer.cc:453-470).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import compose, exp_se3, orthonormalize
from .linalg3 import inv3
from .reproj import CHI2_MONO, huber_weight, jacobians, residuals


class BAProblem(NamedTuple):
    """Padded, fixed-shape bundle adjustment problem."""

    kf_R: torch.Tensor         # (K, 3, 3) world->cam
    kf_t: torch.Tensor         # (K, 3)
    kf_fixed: torch.Tensor     # (K,) bool — held constant (gauge/fixed/invalid)
    points: torch.Tensor       # (P, 3)
    point_valid: torch.Tensor  # (P,) bool
    obs_kf: torch.Tensor       # (O,) int64
    obs_pt: torch.Tensor       # (O,) int64
    obs_uv: torch.Tensor       # (O, 2)
    obs_w: torch.Tensor        # (O,) inv_sigma2 information weight
    obs_valid: torch.Tensor    # (O,) bool
    K4: torch.Tensor           # (4,)


class BAResult(NamedTuple):
    kf_R: torch.Tensor
    kf_t: torch.Tensor
    points: torch.Tensor
    chi2: torch.Tensor          # robust total chi2 at the end
    obs_outlier: torch.Tensor   # (O,) bool — chi2 > 5.991 or nonpositive depth


def _robust_chi2(prob: BAProblem, R, t, pts):
    """Total robust chi2 (Huber rho) over valid observations."""
    e, _ = residuals(R[prob.obs_kf], t[prob.obs_kf], pts[prob.obs_pt], prob.obs_uv, prob.K4)
    c = torch.sum(e * e, dim=-1) * prob.obs_w
    rho = torch.where(c <= CHI2_MONO, c, 2.0 * torch.sqrt(CHI2_MONO * c) - CHI2_MONO)
    return torch.sum(torch.where(prob.obs_valid, rho, 0.0))


def _build_normal_eq(prob: BAProblem, R, t, pts):
    """Blocks of the normal equations at the current state:
    (Hcc (K,6,6), bc (K,6), Hll (P,3,3), bp (P,3), A (P,K,6,3))."""
    K = prob.kf_R.shape[0]
    P = prob.points.shape[0]
    Rk = R[prob.obs_kf]
    tk = t[prob.obs_kf]
    xw = pts[prob.obs_pt]
    e, _ = residuals(Rk, tk, xw, prob.obs_uv, prob.K4)
    Jc, Jp, _ = jacobians(Rk, tk, xw, prob.K4)
    chi2 = torch.sum(e * e, dim=-1) * prob.obs_w
    w = prob.obs_w * huber_weight(chi2) * prob.obs_valid
    # fixed cameras contribute no pose columns
    w_c = torch.where(prob.kf_fixed[prob.obs_kf], 0.0, 1.0)
    Jc = Jc * w_c[:, None, None]
    Jc_w = Jc * w[:, None, None]
    Jp_w = Jp * w[:, None, None]

    dt, dev = Jc.dtype, Jc.device
    Hcc = torch.zeros((K, 6, 6), dtype=dt, device=dev).index_add_(
        0, prob.obs_kf, torch.einsum("oij,oik->ojk", Jc_w, Jc))
    bc = torch.zeros((K, 6), dtype=dt, device=dev).index_add_(
        0, prob.obs_kf, torch.einsum("oij,oi->oj", Jc_w, e))
    Hll = torch.zeros((P, 3, 3), dtype=dt, device=dev).index_add_(
        0, prob.obs_pt, torch.einsum("oij,oik->ojk", Jp_w, Jp))
    bp = torch.zeros((P, 3), dtype=dt, device=dev).index_add_(
        0, prob.obs_pt, torch.einsum("oij,oi->oj", Jp_w, e))
    Y = torch.einsum("oij,oik->ojk", Jc_w, Jp)  # (O, 6, 3)
    A = torch.zeros((P, K, 6, 3), dtype=dt, device=dev).index_put_(
        (prob.obs_pt, prob.obs_kf), Y, accumulate=True)
    return Hcc, bc, Hll, bp, A


def _spd_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b for symmetric positive-definite M by Cholesky. A
    matrix that is not positive definite gives NaN (as the reference's
    solve does), never a host read."""
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where(info == 0, L, torch.nan)
    return torch.cholesky_solve(b[:, None], L)[:, 0]


def _solve_delta(prob: BAProblem, R, t, pts, lam):
    """One damped Schur-reduced solve: (delta_c (K,6), delta_p (P,3), bc,
    bp); the gradients feed the LM gain ratio."""
    K = prob.kf_R.shape[0]
    Hcc, bc, Hll, bp, A = _build_normal_eq(prob, R, t, pts)
    dt, dev = Hcc.dtype, Hcc.device
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    # invalid/unobserved points: their delta is 0 (bp = 0, A = 0)
    U = inv3(Hll + lam * eye3)

    B = torch.einsum("pcij,pjk->pcik", A, U)            # (P, K, 6, 3)
    S = -torch.einsum("pcij,pdkj->cdik", B, A)          # (K, K, 6, 6)
    diag = torch.arange(K, device=dev)
    S[diag, diag] += Hcc + lam * eye6
    # fixed cameras: identity row/col so their delta is exactly 0
    fixed = prob.kf_fixed
    S = torch.where(fixed[:, None, None, None] | fixed[None, :, None, None], 0.0, S)
    S[diag, diag] += torch.where(fixed, 1.0, 0.0)[:, None, None] * eye6

    rhs_c = bc - torch.einsum("pcij,pj->ci", B, bp)     # (K, 6)
    rhs_c = torch.where(fixed[:, None], 0.0, rhs_c)

    Smat = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    # GN solves H delta = -b
    delta_c = _spd_solve(Smat + 1e-8 * torch.eye(K * 6, dtype=dt, device=dev),
                         -rhs_c.reshape(-1)).reshape(K, 6)

    # back-substitution: delta_p = U (-bp - A^T delta_c)
    At_dc = torch.einsum("pcij,ci->pj", A, delta_c)
    delta_p = torch.einsum("pij,pj->pi", U, -bp - At_dc)
    delta_p = torch.where(prob.point_valid[:, None], delta_p, 0.0)
    return delta_c, delta_p, bc, bp


def bundle_adjust(prob: BAProblem, iterations: int = 10, lam0: float = -1.0) -> BAResult:
    """LM bundle adjustment with Schur marginalization of the points.
    lam0 < 0 -> g2o's tau * max(diag) initialization (tau = 1e-5)."""
    Hcc, _, Hll, _, _ = _build_normal_eq(prob, prob.kf_R, prob.kf_t, prob.points)
    max_diag = torch.maximum(
        torch.abs(torch.diagonal(Hcc, dim1=-2, dim2=-1)).max(),
        torch.abs(torch.diagonal(Hll, dim1=-2, dim2=-1)).max())
    lam = 1e-5 * max_diag if lam0 < 0 else torch.full_like(max_diag, lam0)

    R, t, pts = prob.kf_R, prob.kf_t, prob.points
    chi = _robust_chi2(prob, R, t, pts)
    ni = torch.full_like(lam, 2.0)
    done = torch.zeros((), dtype=torch.bool, device=lam.device)
    for _ in range(iterations):
        dc, dp, bc, bp = _solve_delta(prob, R, t, pts, lam)
        dR, dtr = exp_se3(dc)
        R_new, t_new = compose(dR, dtr, R, t)
        R_new = orthonormalize(R_new)  # keep f32 products on SO(3)
        pts_new = pts + dp
        chi_new = _robust_chi2(prob, R_new, t_new, pts_new)
        # g2o's gain-ratio schedule (optimization_algorithm_levenberg.cpp:
        # 100-160)
        pred = 0.5 * (torch.sum(dc * (lam * dc - bc)) + torch.sum(dp * (lam * dp - bp)))
        rho = (chi - chi_new) / torch.where(torch.abs(pred) < 1e-30, 1e-30, pred)
        accept = (rho > 0) & (chi_new < chi) & torch.isfinite(chi_new)
        converged = accept & (chi - chi_new < 1e-5 * chi)
        live = ~done
        take = live & accept
        R = torch.where(take, R_new, R)
        t = torch.where(take, t_new, t)
        pts = torch.where(take, pts_new, pts)
        chi = torch.where(take, chi_new, chi)
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_new = torch.clamp(torch.where(accept, lam * factor, lam * ni), 1e-12, 1e12)
        lam = torch.where(live, lam_new, lam)
        ni = torch.where(live, torch.where(accept, 2.0, ni * 2.0), ni)
        done = done | converged

    # outlier classification at the solution (Optimizer.cc:453-470)
    e, pcam = residuals(R[prob.obs_kf], t[prob.obs_kf], pts[prob.obs_pt], prob.obs_uv, prob.K4)
    c = torch.sum(e * e, dim=-1) * prob.obs_w
    outlier = prob.obs_valid & ((c > CHI2_MONO) | (pcam[..., 2] <= 0))
    return BAResult(kf_R=R, kf_t=t, points=pts, chi2=chi, obs_outlier=outlier)


def two_stage_local_ba(prob: BAProblem) -> BAResult:
    """The reference's local BA schedule: 5 iterations, drop outliers,
    10 more iterations (src/Optimizer.cc:450-494)."""
    r1 = bundle_adjust(prob, iterations=5)
    prob2 = prob._replace(kf_R=r1.kf_R, kf_t=r1.kf_t, points=r1.points,
                          obs_valid=prob.obs_valid & ~r1.obs_outlier)
    r2 = bundle_adjust(prob2, iterations=10)
    # the union of both erase passes (Optimizer.cc:453-470 + :496-520)
    return r2._replace(obs_outlier=r1.obs_outlier | r2.obs_outlier)
