"""All-Sim3 (7-DoF) local bundle adjustment, the fork's experimental variant
(counterpart of orbslam_jpminipc_tpu/solvers/ba_sim3.py).

`LocalBundleAdjustmentWJ_All7Dof` (src/Optimizer.cc:990-1466): every local
keyframe a VertexSim3Expmap, scale fixed on keyframes 0/1 and on those older
than current-5 (:1082). Neither the fork's variant nor this one is wired
into local mapping (LocalMapping.cc:84 calls the SE3 version).

The same padded flat-observation layout as solvers/ba.py, with 7-DoF Sim3
camera blocks:
  * per-observation residual e = uv - proj(exp(xi) o S0 . (x + dx)). The
    reference takes the 2x7 pose and 2x3 point Jacobians with `jax.jacfwd`
    at zero; here they are written out, which is the same matrix: with
    y = s R x + t, d y / d xi = [-hat(y), I, y] (rotation, translation,
    log-scale; g2o's ordering) and d y / d dx = s R, each times
    -d proj / d y;
  * a per-keyframe `scale_fixed` mask zeroing the scale column of J (g2o's
    VertexSim3Expmap::_fix_scale, types_seven_dof_expmap.h:47-93);
  * the Schur complement marginalizing the 3x3 point blocks, a dense
    (7K x 7K) Cholesky camera solve (`cholesky_ex`: no host check), LM
    accept/reject with lambda x0.5 / x4.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import sim3 as s3
from ..geometry.se3 import hat
from .ba import _spd_solve
from .linalg3 import inv3
from .reproj import CHI2_MONO, huber_weight, jac_pixel_wrt_point_cam


class Sim3BAProblem(NamedTuple):
    """Padded all-Sim3 local BA problem (fork WJ_All7Dof semantics)."""

    kf_s: torch.Tensor            # (K,) scale, world->cam
    kf_R: torch.Tensor            # (K, 3, 3)
    kf_t: torch.Tensor            # (K, 3)
    kf_fixed: torch.Tensor        # (K,) bool: pose fully held (gauge / fixed ring)
    kf_scale_fixed: torch.Tensor  # (K,) bool: scale component frozen
    points: torch.Tensor          # (P, 3)
    point_valid: torch.Tensor     # (P,) bool
    obs_kf: torch.Tensor          # (O,) int64
    obs_pt: torch.Tensor          # (O,) int64
    obs_uv: torch.Tensor          # (O, 2)
    obs_w: torch.Tensor           # (O,) inv_sigma2
    obs_valid: torch.Tensor       # (O,) bool
    K4: torch.Tensor              # (4,)


class Sim3BAResult(NamedTuple):
    kf_s: torch.Tensor
    kf_R: torch.Tensor
    kf_t: torch.Tensor
    points: torch.Tensor
    chi2: torch.Tensor
    obs_outlier: torch.Tensor


def _residual(s, R, t, x, uv, K4):
    """e = uv - proj(s R x + t) and the camera-frame point, per observation."""
    y = s3.transform(s, R, t, x)
    inv_z = 1.0 / torch.where(torch.abs(y[..., 2]) < 1e-12,
                              torch.full_like(y[..., 2], 1e-12), y[..., 2])
    u = K4[0] * y[..., 0] * inv_z + K4[2]
    v = K4[1] * y[..., 1] * inv_z + K4[3]
    return uv - torch.stack([u, v], dim=-1), y


def _robust_chi2(prob: Sim3BAProblem, s, R, t, pts):
    """(total Huber chi2 over valid observations, residuals, chi2 each)."""
    k = prob.obs_kf
    e, _ = _residual(s[k], R[k], t[k], pts[prob.obs_pt], prob.obs_uv, prob.K4)
    c = torch.sum(e * e, dim=-1) * prob.obs_w
    rho = torch.where(c <= CHI2_MONO, c, 2.0 * torch.sqrt(CHI2_MONO * c) - CHI2_MONO)
    return torch.sum(torch.where(prob.obs_valid, rho, 0.0)), e, c


def _solve_delta(prob: Sim3BAProblem, s, R, t, pts, lam):
    """One damped Schur-reduced solve: (delta_c (K, 7), delta_p (P, 3))."""
    K = prob.kf_R.shape[0]
    P = prob.points.shape[0]
    k = prob.obs_kf
    e, y = _residual(s[k], R[k], t[k], pts[prob.obs_pt], prob.obs_uv, prob.K4)
    Jproj = jac_pixel_wrt_point_cam(y, prob.K4)                    # (O, 2, 3)
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(y.shape[0], 3, 3)
    Jc = -(Jproj @ torch.cat([-hat(y), eye, y[..., None]], dim=-1))  # (O, 2, 7)
    Jp = -(Jproj @ (s[k][:, None, None] * R[k]))                     # (O, 2, 3)

    dt, dev = y.dtype, y.device
    chi2 = torch.sum(e * e, dim=-1) * prob.obs_w
    w = prob.obs_w * huber_weight(chi2) * prob.obs_valid
    # frozen columns: the whole pose of a fixed keyframe, the scale column
    # of a scale-fixed one
    scale_col = torch.tensor([1, 1, 1, 1, 1, 1, 0], dtype=dt, device=dev)
    col_free = (~prob.kf_fixed[k]).to(dt)[:, None, None] * torch.where(
        prob.kf_scale_fixed[k][:, None, None], scale_col, 1.0)
    Jc = Jc * col_free
    Jc_w = Jc * w[:, None, None]
    Jp_w = Jp * w[:, None, None]

    Hcc = torch.zeros((K, 7, 7), dtype=dt, device=dev).index_add_(
        0, k, torch.einsum("oij,oik->ojk", Jc_w, Jc))
    bc = torch.zeros((K, 7), dtype=dt, device=dev).index_add_(
        0, k, torch.einsum("oij,oi->oj", Jc_w, e))
    Hll = torch.zeros((P, 3, 3), dtype=dt, device=dev).index_add_(
        0, prob.obs_pt, torch.einsum("oij,oik->ojk", Jp_w, Jp))
    bp = torch.zeros((P, 3), dtype=dt, device=dev).index_add_(
        0, prob.obs_pt, torch.einsum("oij,oi->oj", Jp_w, e))
    A = torch.zeros((P, K, 7, 3), dtype=dt, device=dev).index_put_(
        (prob.obs_pt, k), torch.einsum("oij,oik->ojk", Jc_w, Jp), accumulate=True)

    U = inv3(Hll + lam * torch.eye(3, dtype=dt, device=dev))
    B = torch.einsum("pcij,pjk->pcik", A, U)
    S = -torch.einsum("pcij,pdkj->cdik", B, A)
    diag = torch.arange(K, device=dev)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    S[diag, diag] += Hcc + lam * eye7
    fixed = prob.kf_fixed
    S = torch.where(fixed[:, None, None, None] | fixed[None, :, None, None], 0.0, S)
    S[diag, diag] += torch.where(fixed, 1.0, 0.0)[:, None, None] * eye7
    # scale-fixed keyframes have a zero scale row and column in S; pin it to
    # identity so the dense solve stays nonsingular (the delta there is 0)
    sc = (~fixed) & prob.kf_scale_fixed
    S[diag, diag, 6, 6] += torch.where(sc, 1.0, 0.0)

    rhs = bc - torch.einsum("pcij,pj->ci", B, bp)
    rhs = torch.where(fixed[:, None], 0.0, rhs)
    rhs[:, 6] = torch.where(sc, 0.0, rhs[:, 6])

    Smat = S.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
    delta_c = _spd_solve(Smat + 1e-8 * torch.eye(K * 7, dtype=dt, device=dev),
                         -rhs.reshape(-1)).reshape(K, 7)

    At_dc = torch.einsum("pcij,ci->pj", A, delta_c)
    delta_p = torch.einsum("pij,pj->pi", U, -bp - At_dc)
    delta_p = torch.where(prob.point_valid[:, None], delta_p, 0.0)
    return delta_c, delta_p


def bundle_adjust_sim3(prob: Sim3BAProblem, iterations: int = 10) -> Sim3BAResult:
    """LM all-Sim3 local BA with Schur point marginalization; no host read
    inside the iterations."""
    s, R, t, pts = prob.kf_s, prob.kf_R, prob.kf_t, prob.points
    chi, _, _ = _robust_chi2(prob, s, R, t, pts)
    lam = torch.full_like(chi, 1e-5)
    for _ in range(iterations):
        dc, dp = _solve_delta(prob, s, R, t, pts, lam)
        s_new, R_new, t_new = s3.retract(s, R, t, dc)
        pts_new = pts + dp
        chi_new, _, _ = _robust_chi2(prob, s_new, R_new, t_new, pts_new)
        accept = chi_new < chi
        s = torch.where(accept, s_new, s)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        pts = torch.where(accept, pts_new, pts)
        chi = torch.where(accept, chi_new, chi)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    _, _, c = _robust_chi2(prob, s, R, t, pts)
    # depth sign under Sim3: z of s R x + t
    xc = s3.transform(s[prob.obs_kf], R[prob.obs_kf], t[prob.obs_kf], pts[prob.obs_pt])
    outlier = prob.obs_valid & ((c > CHI2_MONO) | (xc[..., 2] <= 0))
    return Sim3BAResult(kf_s=s, kf_R=R, kf_t=t, points=pts, chi2=chi, obs_outlier=outlier)
