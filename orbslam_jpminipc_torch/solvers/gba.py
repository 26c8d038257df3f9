"""Scalable global bundle adjustment: implicit-Schur PCG, full LM
(counterpart of orbslam_jpminipc_tpu/solvers/gba.py).

Optimizer::GlobalBundleAdjustemnt / BundleAdjustment over the WHOLE map
(src/Optimizer.cc:38-152) at full capacity. solvers/ba.py materializes the
dense per-(point, camera) coupling A (P, K, 6, 3): exact and fast for the
local problem (K <= 48), but ~300 MB and O(P*K) work at map capacity
(P=16384, K=256) even though each point sees <= max_obs cameras.

This solver never materializes the coupling. Per LM iteration:

  * per-observation residuals/Jacobians and the per-point 3x3 Hessian
    blocks Hll (scatter-add by point), per-camera 6x6 blocks Hcc
    (scatter-add by camera), all O(O) work on flat padded arrays;
  * the reduced camera system  S = Hcc + lam I - A U A^T  (U = (Hll+lam)^-1)
    is solved by PRECONDITIONED CG with the Schur matvec applied
    implicitly through the observation lists:
        g_o   = Y_o^T x[kf_o]            (O, 3)   gather
        v_p   = segment_sum_p(g_o)       (P, 3)   scatter-add
        u_p   = U_p v_p                  (P, 3)
        h_o   = Y_o u_{pt_o}             (O, 6)   gather
        S x   = (Hcc + lam) x - scatter_add_c(h_o)
    with block-Jacobi preconditioner M = (Hcc + lam I)^-1 (batched 6x6
    inverse, `inv_ex`: no check on the host). Memory is O(O*18 + K*36 +
    P*9), independent of K*P;
  * LM damping follows g2o's gain-ratio schedule
    (optimization_algorithm_levenberg.cpp:100-160): rho = actual/predicted
    reduction with predicted = 0.5 * delta^T (lam*delta + b); on accept
    lam *= max(1/3, 1-(2 rho-1)^3), ni = 2; on reject lam *= ni, ni *= 2.

The PCG runs its fixed iteration budget and the LM loop its fixed count,
with no host read inside either. Same BAProblem/BAResult interface as
solvers/ba.py, so callers pick the dense-exact or the scalable path by
problem size.
"""
from __future__ import annotations

import torch

from ..geometry.se3 import compose, exp_se3, orthonormalize
from .ba import BAProblem, BAResult, _robust_chi2
from .linalg3 import inv3
from .reproj import CHI2_MONO, huber_weight, jacobians, residuals


def _blocks(prob: BAProblem, R, t, pts, lam):
    """Per-iteration normal-equation blocks, observation-indexed.

    Returns (Hcc_d (K,6,6) damped, bc (K,6), U (P,3,3) = (Hll+lam)^-1,
    bp (P,3), Y (O,6,3) per-observation coupling Jc^T w Jp)."""
    K = prob.kf_R.shape[0]
    P = prob.points.shape[0]
    Rk = R[prob.obs_kf]
    tk = t[prob.obs_kf]
    xw = pts[prob.obs_pt]
    e, _ = residuals(Rk, tk, xw, prob.obs_uv, prob.K4)
    Jc, Jp, _ = jacobians(Rk, tk, xw, prob.K4)
    chi2 = torch.sum(e * e, dim=-1) * prob.obs_w
    w = prob.obs_w * huber_weight(chi2) * prob.obs_valid
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

    U = inv3(Hll + lam * torch.eye(3, dtype=dt, device=dev))
    Hcc_d = Hcc + lam * torch.eye(6, dtype=dt, device=dev)
    return Hcc_d, bc, U, bp, Y


def _schur_matvec(prob: BAProblem, Hcc_d, U, Y, x):
    """S x = (Hcc + lam) x - A U A^T x, never materializing A (P,K,6,3)."""
    g = torch.einsum("oij,oi->oj", Y, x[prob.obs_kf])          # (O, 3)
    g = g * prob.obs_valid[:, None]
    v = torch.zeros((U.shape[0], 3), dtype=g.dtype, device=g.device).index_add_(0, prob.obs_pt, g)
    u = torch.einsum("pij,pj->pi", U, v)
    h = torch.einsum("oij,oj->oi", Y, u[prob.obs_pt])          # (O, 6)
    h = h * prob.obs_valid[:, None]
    w = torch.zeros_like(x).index_add_(0, prob.obs_kf, h)
    Sx = torch.einsum("kij,kj->ki", Hcc_d, x) - w
    # fixed cameras: identity rows => their delta stays 0
    return torch.where(prob.kf_fixed[:, None], x, Sx)


def _safe(d):
    return torch.where(torch.abs(d) < 1e-30, 1e-30, d)


def _pcg(matvec, Minv, b, iters: int):
    """Block-Jacobi preconditioned CG on the (K, 6) camera system."""

    def apply_M(r):
        return torch.einsum("kij,kj->ki", Minv, r)

    x = torch.zeros_like(b)
    r = b  # b - S*0
    p = apply_M(r)
    rz = torch.sum(r * p)
    for _ in range(iters):
        Sp = matvec(p)
        alpha = rz / _safe(torch.sum(p * Sp))
        x = x + alpha * p
        r = r - alpha * Sp
        z = apply_M(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / _safe(rz)) * p
        rz = rz_new
    return x


def _solve_delta_pcg(prob: BAProblem, R, t, pts, lam, cg_iters: int):
    """One damped implicit-Schur solve. Returns (delta_c, delta_p, bc, bp)."""
    Hcc_d, bc, U, bp, Y = _blocks(prob, R, t, pts, lam)

    # rhs_c = bc - A U bp (observation-indexed)
    ubp = torch.einsum("pij,pj->pi", U, bp)
    h = torch.einsum("oij,oj->oi", Y, ubp[prob.obs_pt]) * prob.obs_valid[:, None]
    rhs = bc - torch.zeros_like(bc).index_add_(0, prob.obs_kf, h)
    rhs = torch.where(prob.kf_fixed[:, None], 0.0, rhs)

    eye6 = torch.eye(6, dtype=Hcc_d.dtype, device=Hcc_d.device)
    Minv = torch.linalg.inv_ex(Hcc_d + 1e-8 * eye6)[0]
    Minv = torch.where(prob.kf_fixed[:, None, None], eye6, Minv)

    delta_c = _pcg(lambda x: _schur_matvec(prob, Hcc_d, U, Y, x), Minv, -rhs, cg_iters)
    delta_c = torch.where(prob.kf_fixed[:, None], 0.0, delta_c)

    # back-substitution: delta_p = U (-bp - A^T delta_c)
    g = torch.einsum("oij,oi->oj", Y, delta_c[prob.obs_kf]) * prob.obs_valid[:, None]
    At_dc = torch.zeros_like(bp).index_add_(0, prob.obs_pt, g)
    delta_p = torch.einsum("pij,pj->pi", U, -bp - At_dc)
    delta_p = torch.where(prob.point_valid[:, None], delta_p, 0.0)
    return delta_c, delta_p, bc, bp


def bundle_adjust_large(prob: BAProblem, iterations: int = 20, cg_iters: int = 64,
                        lam0: float = -1.0) -> BAResult:
    """LM bundle adjustment at map capacity (implicit Schur + PCG).

    lam0 < 0 -> g2o's tau * max(diag) initialization
    (optimization_algorithm_levenberg.cpp:47, tau = 1e-5)."""
    Hcc0 = _blocks(prob, prob.kf_R, prob.kf_t, prob.points, 0.0)[0]
    max_diag = torch.abs(torch.diagonal(Hcc0, dim1=-2, dim2=-1)).max()
    lam = 1e-5 * max_diag if lam0 < 0 else torch.full_like(max_diag, lam0)

    R, t, pts = prob.kf_R, prob.kf_t, prob.points
    chi = _robust_chi2(prob, R, t, pts)
    ni = torch.full_like(lam, 2.0)
    for _ in range(iterations):
        dc, dp, bc, bp = _solve_delta_pcg(prob, R, t, pts, lam, cg_iters)
        dR, dtr = exp_se3(dc)
        R_new, t_new = compose(dR, dtr, R, t)
        R_new = orthonormalize(R_new)  # keep f32 products on SO(3)
        pts_new = pts + dp
        chi_new = _robust_chi2(prob, R_new, t_new, pts_new)
        # gain ratio rho = (chi - chi_new) / predicted reduction, predicted
        # = 0.5 delta^T (lam delta - grad): g2o's scale = delta.(lam delta
        # + b), levenberg.cpp:118, with g2o's b the NEGATIVE gradient; bc
        # and bp here are the positive gradient J^T W e
        pred = 0.5 * (torch.sum(dc * (lam * dc - bc)) + torch.sum(dp * (lam * dp - bp)))
        rho = (chi - chi_new) / _safe(pred)
        accept = (rho > 0) & (chi_new < chi) & torch.isfinite(chi_new)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        pts = torch.where(accept, pts_new, pts)
        chi = torch.where(accept, chi_new, chi)
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.clamp(torch.where(accept, lam * factor, lam * ni), 1e-12, 1e12)
        ni = torch.where(accept, 2.0, ni * 2.0)

    e, pcam = residuals(R[prob.obs_kf], t[prob.obs_kf], pts[prob.obs_pt], prob.obs_uv, prob.K4)
    c = torch.sum(e * e, dim=-1) * prob.obs_w
    outlier = prob.obs_valid & ((c > CHI2_MONO) | (pcam[..., 2] <= 0))
    return BAResult(kf_R=R, kf_t=t, points=pts, chi2=chi, obs_outlier=outlier)
