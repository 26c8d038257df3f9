"""Distributed Schur-complement bundle adjustment over a device mesh
(counterpart of orbslam_jpminipc_tpu/parallel/sharded_ba.py).

Map POINTS and their observations are sharded across the mesh's shards;
the camera (keyframe) state is replicated. Per LM iteration each shard

  1. computes residuals and Jacobians for ITS observations,
  2. accumulates its partial camera Hessian blocks Hcc and gradient bc,
  3. inverts its own 3x3 point blocks and forms its partial Schur
     complement S_part = sum_p A_p U_p A_p^T,
  4. one sum over the mesh combines {Hcc, bc, S, rhs}: the only
     communication, O(K^2 * 36) floats, one `all_reduce` across processes,
  5. the reduced camera system is solved once per process (replicated:
     every process solves the same system), and
  6. each shard back-substitutes its own point deltas.

This mirrors how g2o's BlockSolver marginalizes landmark blocks
(block_solver.h:144-157), with the elimination a batched einsum and the
sparse assembly a sum over shards. The observation arrays are grouped by
point shard on the host (`shard_ba_problem`), so a shard's observations
index its own points. The iterations read nothing back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.se3 import compose, exp_se3, orthonormalize
from ..solvers.ba import BAProblem, _build_normal_eq, _robust_chi2, _spd_solve
from ..solvers.linalg3 import inv3
from ..solvers.reproj import CHI2_MONO, residuals
from ..utils.host import fetch
from .mesh import DeviceMesh


class ShardedBAProblem(NamedTuple):
    """Point/observation arrays carry a leading shard axis (n_shards, ...).

    Camera arrays are replicated (no shard axis). obs_pt indexes into the
    LOCAL point block of its shard.
    """

    kf_R: torch.Tensor         # (K, 3, 3)
    kf_t: torch.Tensor         # (K, 3)
    kf_fixed: torch.Tensor     # (K,)
    points: torch.Tensor       # (S, Pl, 3)
    point_valid: torch.Tensor  # (S, Pl)
    obs_kf: torch.Tensor       # (S, Ol)
    obs_pt: torch.Tensor       # (S, Ol): local point index
    obs_uv: torch.Tensor       # (S, Ol, 2)
    obs_w: torch.Tensor        # (S, Ol)
    obs_valid: torch.Tensor    # (S, Ol)
    K4: torch.Tensor


_SHARD_FIELDS = ("points", "point_valid", "obs_kf", "obs_pt", "obs_uv", "obs_w", "obs_valid")


def shard_ba_problem(prob: BAProblem, n_shards: int) -> ShardedBAProblem:
    """Host-side partitioning: contiguous point blocks, observations grouped
    along. Each shard's observation list is padded to the largest (at least
    8), so shapes are uniform. The shard-axis arrays lie on the problem's
    device; the camera arrays are the problem's own."""
    points, point_valid, obs_kf, obs_pt, obs_uv, obs_w, obs_valid = fetch(
        prob.points, prob.point_valid, prob.obs_kf, prob.obs_pt, prob.obs_uv, prob.obs_w,
        prob.obs_valid)
    P_total = points.shape[0]
    Pl = -(-P_total // n_shards)
    obs_shard = obs_pt // Pl
    obs_local = obs_pt - obs_shard * Pl

    per_shard = [np.nonzero((obs_shard == s) & obs_valid)[0] for s in range(n_shards)]
    Ol = max(max(len(sel) for sel in per_shard), 8)

    def gather(arr, fill=0):
        out = np.full((n_shards, Ol) + arr.shape[1:], fill, arr.dtype)
        for s, sel in enumerate(per_shard):
            out[s, : len(sel)] = arr[sel]
        return out

    pts = np.zeros((n_shards, Pl, 3), np.float32)
    pv = np.zeros((n_shards, Pl), bool)
    for s in range(n_shards):
        lo, hi = s * Pl, min((s + 1) * Pl, P_total)
        pts[s, : hi - lo] = points[lo:hi]
        pv[s, : hi - lo] = point_valid[lo:hi]

    dev = prob.points.device
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return ShardedBAProblem(
        kf_R=prob.kf_R, kf_t=prob.kf_t, kf_fixed=prob.kf_fixed,
        points=put(pts), point_valid=put(pv),
        obs_kf=put(gather(obs_kf).astype(np.int64)),
        obs_pt=put(gather(obs_local).astype(np.int64)),
        obs_uv=put(gather(obs_uv)), obs_w=put(gather(obs_w)),
        obs_valid=put(gather(np.ones_like(obs_valid))),
        K4=prob.K4,
    )


def _local_problems(sprob: ShardedBAProblem, mesh: DeviceMesh, kf_fixed, K4):
    """This process's shards as single-device problems, each on its device:
    its own points and observations, a copy of the camera arrays (the poses
    are passed at each evaluation)."""
    idx = mesh.local_shards(sprob.points.shape[0])
    fixed_d, K4_d = mesh.replicate(kf_fixed), mesh.replicate(K4)
    probs = []
    for j, dev in zip(idx, mesh.devices):
        f = {k: getattr(sprob, k)[j].to(dev) for k in _SHARD_FIELDS}
        probs.append(BAProblem(
            kf_R=None, kf_t=None, kf_fixed=fixed_d[dev], points=f["points"],
            point_valid=f["point_valid"], obs_kf=f["obs_kf"].long(), obs_pt=f["obs_pt"].long(),
            obs_uv=f["obs_uv"], obs_w=f["obs_w"], obs_valid=f["obs_valid"], K4=K4_d[dev]))
    return probs


def _schur_part(sp: BAProblem, R, t, pts, lam):
    """One shard's partial reduced camera system: the flat [Hcc, bc, S_part,
    rhs_part], and (U, A, bp) for its back-substitution. The blocks are the
    single-device solver's (solvers/ba.py:_build_normal_eq)."""
    Hcc, bc, Hll, bp, A = _build_normal_eq(sp._replace(kf_R=R), R, t, pts)
    U = inv3(Hll + lam * torch.eye(3, dtype=Hll.dtype, device=Hll.device))
    B = torch.einsum("pcij,pjk->pcik", A, U)
    S_part = -torch.einsum("pcij,pdkj->cdik", B, A)
    rhs_part = bc - torch.einsum("pcij,pj->ci", B, bp)
    flat = torch.cat([Hcc.reshape(-1), bc.reshape(-1), S_part.reshape(-1), rhs_part.reshape(-1)])
    return flat, (U, A, bp)


def _replicated_solve(flat, kf_fixed, lam):
    """The combined camera system -> (delta_c (K, 6), bc (K, 6)).

    Jacobi (diagonal) scaling before the float32 Cholesky, as the
    reference: the Schur complement mixes rotation and translation blocks
    whose diagonals span orders of magnitude, and the raw condition number
    turns the shard-order rounding into diverging LM trajectories across
    shard counts. D^-1/2 S D^-1/2 keeps the solve well conditioned.
    """
    K = kf_fixed.shape[0]
    dt, dev = flat.dtype, flat.device
    n1, n2, n3 = K * 36, K * 6, K * K * 36
    Hcc = flat[:n1].reshape(K, 6, 6)
    bc = flat[n1:n1 + n2].reshape(K, 6)
    S = flat[n1 + n2:n1 + n2 + n3].reshape(K, K, 6, 6).clone()
    rhs = flat[n1 + n2 + n3:].reshape(K, 6)
    diag = torch.arange(K, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    S[diag, diag] += Hcc + lam * eye6
    S = torch.where(kf_fixed[:, None, None, None] | kf_fixed[None, :, None, None], 0.0, S)
    S[diag, diag] += torch.where(kf_fixed, 1.0, 0.0)[:, None, None] * eye6
    rhs = torch.where(kf_fixed[:, None], 0.0, rhs)

    Smat = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(Smat)), min=1e-12))
    Sn = Smat / (d[:, None] * d[None, :])
    delta_c = _spd_solve(Sn + 1e-7 * torch.eye(K * 6, dtype=dt, device=dev),
                         -rhs.reshape(-1) / d) / d
    return delta_c.reshape(K, 6), bc


def sharded_bundle_adjust(sprob: ShardedBAProblem, mesh: DeviceMesh, iterations: int = 10):
    """LM bundle adjustment with point blocks sharded over `mesh`.

    Returns (kf_R, kf_t, points (S, Pl, 3), chi2, obs_outlier (S, Ol)): the
    replicated arrays on the mesh's first device, the shard-axis ones for
    this process's shards (all of them in one process), stacked there.
    """
    home = mesh.home
    R, t = sprob.kf_R.to(home), sprob.kf_t.to(home)
    kf_fixed = sprob.kf_fixed.to(home).bool()
    probs = _local_problems(sprob, mesh, kf_fixed, sprob.K4.to(home))
    devs = [sp.points.device for sp in probs]
    pts = [sp.points for sp in probs]
    R_d, t_d = mesh.replicate(R), mesh.replicate(t)

    chi = mesh.psum([_robust_chi2(sp, R_d[d], t_d[d], p) for sp, d, p in zip(probs, devs, pts)])
    # lambda init = tau * max(diag H), as the single-device solver (g2o
    # optimization_algorithm_levenberg.cpp:47, tau = 1e-5): a max over shards
    maxes = []
    for sp, d, p in zip(probs, devs, pts):
        Hcc, _, Hll, _, _ = _build_normal_eq(sp._replace(kf_R=R_d[d]), R_d[d], t_d[d], p)
        maxes.append(torch.maximum(torch.diagonal(Hcc, dim1=-2, dim2=-1).abs().max(),
                                   torch.diagonal(Hll, dim1=-2, dim2=-1).abs().max()))
    lam = 1e-5 * mesh.pmax(maxes)
    ni = torch.full_like(lam, 2.0)

    for _ in range(iterations):
        lam_d = mesh.replicate(lam)
        parts, keep = [], []
        for sp, d, p in zip(probs, devs, pts):
            flat, kept = _schur_part(sp, R_d[d], t_d[d], p, lam_d[d])
            parts.append(flat)
            keep.append(kept)
        # ---- the one collective: combine the reduced camera system ----
        delta_c, bc = _replicated_solve(mesh.psum(parts), kf_fixed, lam)

        dR, dtr = exp_se3(delta_c)
        R_new, t_new = compose(dR, dtr, R, t)
        R_new = orthonormalize(R_new)  # keep the float32 products on SO(3)
        dc_d, Rn_d, tn_d = mesh.replicate(delta_c), mesh.replicate(R_new), mesh.replicate(t_new)
        pts_new, local = [], []
        for sp, d, p, (U, A, bp) in zip(probs, devs, pts, keep):
            At_dc = torch.einsum("pcij,ci->pj", A, dc_d[d])
            dp = torch.einsum("pij,pj->pi", U, -bp - At_dc)
            dp = torch.where(sp.point_valid[:, None], dp, 0.0)
            p_new = p + dp
            pts_new.append(p_new)
            # {chi, the point part of the predicted reduction} in one sum
            local.append(torch.stack([_robust_chi2(sp, Rn_d[d], tn_d[d], p_new),
                                      0.5 * torch.sum(dp * (lam_d[d] * dp - bp))]))
        chi_new, pred_p = mesh.psum(local).unbind()
        # g2o's gain-ratio schedule, as the single-device solver
        pred = 0.5 * torch.sum(delta_c * (lam * delta_c - bc)) + pred_p
        rho = (chi - chi_new) / torch.where(torch.abs(pred) < 1e-30, 1e-30, pred)
        accept = (rho > 0) & (chi_new < chi) & torch.isfinite(chi_new)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        acc_d = mesh.replicate(accept)
        pts = [torch.where(acc_d[d], pn, p) for d, p, pn in zip(devs, pts, pts_new)]
        chi = torch.where(accept, chi_new, chi)
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.clamp(torch.where(accept, lam * factor, lam * ni), 1e-12, 1e12)
        ni = torch.where(accept, 2.0, ni * 2.0)
        R_d, t_d = mesh.replicate(R), mesh.replicate(t)

    # outlier classification at the solution, as the single-device
    # BAResult.obs_outlier (Optimizer.cc:453-470)
    outliers = []
    for sp, d, p in zip(probs, devs, pts):
        e, pcam = residuals(R_d[d][sp.obs_kf], t_d[d][sp.obs_kf], p[sp.obs_pt], sp.obs_uv, sp.K4)
        c = torch.sum(e * e, dim=-1) * sp.obs_w
        outliers.append(sp.obs_valid & ((c > CHI2_MONO) | (pcam[..., 2] <= 0.0)))
    stack = lambda xs: torch.stack([x.to(home) for x in xs])
    return R, t, stack(pts), chi, stack(outliers)
