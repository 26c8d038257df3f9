"""Local bundle adjustment, plain PyTorch: the robust reprojection cost
and the Levenberg-Marquardt schedule that ORB-SLAM's local BA runs through
g2o (Optimizer.cc:287-536; optimization_algorithm_levenberg.cpp), written
from those equations with no code of the system under test.

A problem is a dict of arrays: kf_R (K, 3, 3), kf_t (K, 3) world->camera,
kf_fixed (K,), points (P, 3), point_valid (P,), obs_kf, obs_pt (O,),
obs_uv (O, 2), obs_w (O,) information weights, obs_valid (O,), K4 (4,).

Cost: sum over valid observations of Huber's rho (threshold 5.991, the
2-dof 95 % gate) of w |uv - pi(R x + t)|^2. One LM iteration: the normal
equations of the Huber-reweighted residuals, the points eliminated by their
Schur complement, the damped camera system solved, the step kept only if it
lowers the cost (gain ratio > 0), the damping scaled by
max(1/3, 1 - (2 rho - 1)^3) after a kept step and by a doubling factor after
a refused one; a kept step that gains less than 1e-5 of the cost ends the
run. Pose steps act on the left: T <- exp(xi) T, xi = (omega, upsilon).
"""
from __future__ import annotations

import math

import numpy as np
import torch

CHI2 = 5.991


def _t(prob: dict, dtype, device) -> dict:
    out = {}
    for k, v in prob.items():
        a = torch.as_tensor(np.asarray(v), device=device)
        out[k] = a.to(dtype) if a.is_floating_point() else a
    out["obs_kf"] = out["obs_kf"].long()
    out["obs_pt"] = out["obs_pt"].long()
    out["kf_fixed"] = out["kf_fixed"].bool()
    out["point_valid"] = out["point_valid"].bool()
    out["obs_valid"] = out["obs_valid"].bool()
    return out


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _project(p, K4):
    z = p[..., 2]
    iz = 1.0 / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return torch.stack([K4[0] * p[..., 0] * iz + K4[2], K4[1] * p[..., 1] * iz + K4[3]], -1), iz


def _chi2(P, R, t, X):
    p = torch.einsum("oij,oj->oi", R[P["obs_kf"]], X[P["obs_pt"]]) + t[P["obs_kf"]]
    uv, _ = _project(p, P["K4"])
    e = P["obs_uv"] - uv
    return (e * e).sum(-1) * P["obs_w"], e, p


def _rho_sum(P, R, t, X):
    c, _, _ = _chi2(P, R, t, X)
    rho = torch.where(c <= CHI2, c, 2.0 * torch.sqrt(CHI2 * c) - CHI2)
    return torch.where(P["obs_valid"], rho, torch.zeros_like(rho)).sum()


def cost(prob: dict, R, t, X) -> float:
    """The robust cost of poses R, t and points X on `prob`, in float64."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    P = _t(prob, torch.float64, dev)
    f = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(torch.float64)
    return float(_rho_sum(P, f(R), f(t), f(X)))


def _exp(xi):
    w, v = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (ths - torch.sin(ths)) / (ths ** 3))
    W = _hat(w)
    I = torch.eye(3, dtype=xi.dtype, device=xi.device).expand_as(W)
    WW = W @ W
    R = I + a[..., None, None] * W + b[..., None, None] * WW
    V = I + b[..., None, None] * W + c[..., None, None] * WW
    return R, (V @ v[..., None])[..., 0]


def lm(prob: dict, iterations: int = 5, dtype=torch.float64, device=None):
    """LM from the problem's state: (R, t, X) as float64 numpy arrays. In a
    16-bit `dtype` (the control) every intermediate is rounded to it, the
    linear algebra itself running on the rounded values in float32."""
    dev = device or ("cuda" if torch.cuda.is_available() else "cpu")
    low = dtype in (torch.bfloat16, torch.float16)
    low_dtype = dtype
    Q = (lambda x: x.to(low_dtype).to(torch.float32)) if low else (lambda x: x)
    dtype = torch.float32 if low else dtype
    P = {k: (Q(v) if v.is_floating_point() else v) for k, v in _t(prob, dtype, dev).items()}
    R, t, X = P["kf_R"], P["kf_t"], P["points"]
    K, Np = R.shape[0], X.shape[0]
    okf, opt = P["obs_kf"], P["obs_pt"]
    fixed = P["kf_fixed"]
    free = (~fixed).to(dtype)

    def normal(R, t, X):
        c, e, p = (Q(a) for a in _chi2(P, R, t, X))
        _, iz = _project(p, P["K4"])
        iz = Q(iz)
        fx, fy = P["K4"][0], P["K4"][1]
        zr = torch.zeros_like(iz)
        Jpi = torch.stack([torch.stack([fx * iz, zr, -fx * p[:, 0] * iz * iz], -1),
                           torch.stack([zr, fy * iz, -fy * p[:, 1] * iz * iz], -1)], -2)
        # residual e = uv - pi(p): de/dp = -Jpi; dp/domega = -[p]x, dp/dupsilon = I
        Jpi = Q(Jpi)
        Jc = Q(torch.cat([Jpi @ _hat(p), -Jpi], -1) * free[okf][:, None, None])
        Jx = Q(-(Jpi @ R[okf]))
        s = torch.sqrt(torch.clamp(c, min=1e-18))
        hub = torch.where(s <= math.sqrt(CHI2), torch.ones_like(s), math.sqrt(CHI2) / s)
        w = P["obs_w"] * hub * P["obs_valid"].to(dtype)
        Hcc = torch.zeros(K, 6, 6, dtype=dtype, device=dev).index_add_(
            0, okf, torch.einsum("oai,oaj,o->oij", Jc, Jc, w))
        bc = torch.zeros(K, 6, dtype=dtype, device=dev).index_add_(
            0, okf, torch.einsum("oai,oa,o->oi", Jc, e, w))
        Hxx = torch.zeros(Np, 3, 3, dtype=dtype, device=dev).index_add_(
            0, opt, torch.einsum("oai,oaj,o->oij", Jx, Jx, w))
        bx = torch.zeros(Np, 3, dtype=dtype, device=dev).index_add_(
            0, opt, torch.einsum("oai,oa,o->oi", Jx, e, w))
        Hcx = torch.zeros(Np, K, 6, 3, dtype=dtype, device=dev).index_put_(
            (opt, okf), torch.einsum("oai,oaj,o->oij", Jc, Jx, w), accumulate=True)
        return Q(Hcc), Q(bc), Q(Hxx), Q(bx), Q(Hcx)

    Hcc, _, Hxx, _, _ = normal(R, t, X)
    lam = 1e-5 * torch.maximum(torch.diagonal(Hcc, dim1=-2, dim2=-1).abs().max(),
                               torch.diagonal(Hxx, dim1=-2, dim2=-1).abs().max())
    nu = 2.0
    chi = Q(_rho_sum(P, R, t, X))
    I3 = torch.eye(3, dtype=dtype, device=dev)
    I6 = torch.eye(6, dtype=dtype, device=dev)
    for _ in range(iterations):
        Hcc, bc, Hxx, bx, Hcx = normal(R, t, X)
        U = Q(torch.linalg.inv(Hxx + lam * I3))
        B = Q(torch.einsum("pcij,pjk->pcik", Hcx, U))
        S = Q(-torch.einsum("pcij,pdkj->cdik", B, Hcx))
        idx = torch.arange(K, device=dev)
        S[idx, idx] += Hcc + lam * I6
        keep = ~fixed
        S = S * (keep[:, None, None, None] & keep[None, :, None, None]).to(dtype)
        S[idx, idx] += fixed.to(dtype)[:, None, None] * I6
        rhs = (bc - torch.einsum("pcij,pj->ci", B, bx)) * free[:, None]
        Sm = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        dc = torch.linalg.solve(Sm + 1e-8 * torch.eye(6 * K, dtype=dtype, device=dev),
                                -rhs.reshape(-1)).reshape(K, 6)
        dx = torch.einsum("pij,pj->pi", U, -bx - torch.einsum("pcij,ci->pj", Hcx, dc))
        dc, dx = Q(dc), Q(dx * P["point_valid"].to(dtype)[:, None])
        dR, dt = _exp(dc)
        R1 = Q(dR @ R)
        t1 = Q((dR @ t[..., None])[..., 0] + dt)
        X1 = Q(X + dx)
        chi1 = Q(_rho_sum(P, R1, t1, X1))
        pred = 0.5 * ((dc * (lam * dc - bc)).sum() + (dx * (lam * dx - bx)).sum())
        rho = (chi - chi1) / (pred if abs(float(pred)) > 1e-30 else 1e-30)
        if bool(torch.isfinite(chi1)) and float(rho) > 0 and float(chi1) < float(chi):
            done = float(chi - chi1) < 1e-5 * float(chi)
            R, t, X, chi = R1, t1, X1, chi1
            lam = torch.clamp(lam * max(1.0 / 3.0, 1.0 - (2.0 * float(rho) - 1.0) ** 3), 1e-12, 1e12)
            nu = 2.0
            if done:
                break
        else:
            lam = torch.clamp(lam * nu, 1e-12, 1e12)
            nu *= 2.0
    f = lambda a: a.to(torch.float64).cpu().numpy()
    return f(R), f(t), f(X)


def edge_chi2(prob: dict, R, t, X):
    """(chi2, depth) of every edge at the state (R, t, X); float64 numpy."""
    P = _t(prob, torch.float64, "cpu")
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    c, _, p = _chi2(P, f(R), f(t), f(X))
    return c.numpy(), p[:, 2].numpy()


def outliers(prob: dict, R, t, X) -> np.ndarray:
    """The observations that ORB-SLAM erases between the two stages
    (Optimizer.cc:453-470): chi2 over the 5.991 gate, or the point behind
    the camera, at the state (R, t, X); float64."""
    c, z = edge_chi2(prob, R, t, X)
    return np.asarray(prob["obs_valid"], bool) & ((c > CHI2) | (z <= 0))


# -- the local-BA problem, worked out again from the map -------------------------
#
# Optimizer::LocalBundleAdjustment (Optimizer.cc:287-380) at fixed capacities:
# the local keyframes are the new keyframe and its covisible neighbours
# (shared map points), most shared first; the local points are the valid
# points those keyframes see; the fixed keyframes are the other keyframes that
# observe them, most observations first; the first keyframe (slot 0) fixes the
# gauge. Every observation of a local point by a local or fixed keyframe is an
# edge, weighted 1 / sigma^2 of its keypoint's level. Where a capacity forces
# a cut (`caps`), the candidates of highest weight are kept, the points by
# their number of observations; the edges are taken point by point (point
# slots ascending, each point's observation slots ascending) up to the edge
# capacity.

SNAP_FIELDS = ("kf_valid", "kf_R", "kf_t", "kf_point", "kf_xy", "kf_level",
               "mp_valid", "mp_xyz", "mp_obs_kf", "mp_obs_feat")


def covisibility(snap: dict) -> np.ndarray:
    """(keyframes, keyframes) map points shared by each pair of valid
    keyframes."""
    n_kf = len(snap["kf_valid"])
    C = np.zeros((n_kf, n_kf), np.int64)
    valid = np.nonzero(snap["kf_valid"])[0]
    if len(valid):
        pts = snap["kf_point"][valid]
        M = np.zeros((len(valid), len(snap["mp_valid"])), np.float64)
        rows = np.broadcast_to(np.arange(len(valid))[:, None], pts.shape)
        M[rows[pts >= 0], pts[pts >= 0]] = 1.0
        C[np.ix_(valid, valid)] = np.rint(M @ M.T).astype(np.int64)
    return C


def _top(cands, weight, cap: int, prefer) -> np.ndarray:
    """The `cap` candidates of highest weight. Equal weights at the cut
    cannot be told apart: there the ones in `prefer` go first, so that a
    valid choice of the program's is the same set here."""
    cands = np.asarray(cands, np.int64)
    if len(cands) <= cap:
        return np.sort(cands)
    pref = np.isin(cands, np.asarray(list(prefer), np.int64))
    order = np.lexsort((cands, ~pref, -np.asarray(weight)[cands]))
    return np.sort(cands[order[:cap]])


def local_problem(snap: dict, kf: int, caps: dict, inv_sigma2, K4,
                  prefer_local=(), prefer_fixed=(), prefer_pts=()):
    """(problem, keyframe ids, point ids) of the local BA of keyframe `kf`
    on the map `snap` (the SNAP_FIELDS arrays). `caps`: local_ba_kf,
    local_ba_fixed, local_ba_points, local_ba_obs. The `prefer_*` sets
    break ties at a cut (`_top`): the local keyframes, the fixed ones, the
    points."""
    row = covisibility(snap)[kf].copy()
    row[kf] = 0
    row[~np.asarray(snap["kf_valid"], bool)] = 0
    nb = _top(np.nonzero(row > 0)[0], row, caps["local_ba_kf"] - 1, prefer_local)
    local = [int(kf)] + [int(k) for k in nb]
    kp = snap["kf_point"][np.array(local)]
    pts = np.unique(kp[kp >= 0]).astype(np.int64)
    pts = pts[np.asarray(snap["mp_valid"], bool)[pts]]
    obs_kf = snap["mp_obs_kf"]
    nobs = (obs_kf >= 0).sum(1)
    pts = _top(pts, nobs, caps["local_ba_points"], prefer_pts)
    seen = obs_kf[pts].ravel()
    counts = np.bincount(seen[seen >= 0], minlength=len(snap["kf_valid"]))
    counts[local] = 0
    fixed = [int(k) for k in _top(np.nonzero(counts)[0], counts, caps["local_ba_fixed"],
                                  prefer_fixed)]
    kfs = local + fixed
    index = {k: i for i, k in enumerate(kfs)}
    okf, opt, ouv, ow = [], [], [], []
    levels = len(inv_sigma2)
    for j, p in enumerate(pts):
        for s in range(obs_kf.shape[1]):
            k = int(obs_kf[p, s])
            if k < 0 or k not in index or len(okf) >= caps["local_ba_obs"]:
                continue
            f = int(snap["mp_obs_feat"][p, s])
            okf.append(index[k])
            opt.append(j)
            ouv.append(snap["kf_xy"][k, f])
            ow.append(inv_sigma2[min(max(int(snap["kf_level"][k, f]), 0), levels - 1)])
    kfa = np.array(kfs, np.int64)
    prob = dict(kf_R=np.asarray(snap["kf_R"])[kfa], kf_t=np.asarray(snap["kf_t"])[kfa],
                kf_fixed=np.array([k in fixed or k == 0 for k in kfs], bool),
                points=np.asarray(snap["mp_xyz"])[pts], point_valid=np.ones(len(pts), bool),
                obs_kf=np.array(okf, np.int64), obs_pt=np.array(opt, np.int64),
                obs_uv=np.array(ouv, np.float32).reshape(-1, 2),
                obs_w=np.array(ow, np.float32), obs_valid=np.ones(len(okf), bool),
                K4=np.asarray(K4, np.float32))
    return prob, kfs, pts


def _edges(prob: dict, kfs, pts) -> dict:
    """{(keyframe id, point id, u, v): weight} of the valid edges."""
    v = np.asarray(prob["obs_valid"], bool)
    kfs, pts = np.asarray(kfs), np.asarray(pts)
    uv = np.asarray(prob["obs_uv"], np.float32)[v]
    return dict(zip(zip(kfs[np.asarray(prob["obs_kf"])[v]].tolist(),
                        pts[np.asarray(prob["obs_pt"])[v]].tolist(),
                        uv[:, 0].tolist(), uv[:, 1].tolist()),
                    np.asarray(prob["obs_w"], np.float64)[v].tolist()))


def problem_faults(ref: dict, ref_kfs, ref_pts, prog: dict, prog_kfs, prog_pts) -> dict:
    """How many entries of the program's problem differ from the
    reference's, by part: keyframes, their fixed flags and starting poses,
    points, their starting positions and valid flags, edges, and the
    weights of shared edges (to float32 rounding). All 0 where they are
    the same problem."""
    n = dict.fromkeys(("keyframes", "fixed", "poses", "points", "positions", "edges",
                       "weights"), 0)
    n["keyframes"] = len(set(prog_kfs) ^ set(ref_kfs))
    n["points"] = len(set(np.asarray(prog_pts).tolist()) ^ set(np.asarray(ref_pts).tolist()))
    ri = {k: i for i, k in enumerate(ref_kfs)}
    for i, k in enumerate(prog_kfs):
        if k in ri:
            j = ri[k]
            n["fixed"] += bool(prog["kf_fixed"][i]) != bool(ref["kf_fixed"][j])
            n["poses"] += not (np.array_equal(prog["kf_R"][i], ref["kf_R"][j])
                               and np.array_equal(prog["kf_t"][i], ref["kf_t"][j]))
    rp = {int(p): j for j, p in enumerate(ref_pts)}
    for i, p in enumerate(np.asarray(prog_pts).tolist()):
        if p in rp:
            n["positions"] += not np.array_equal(prog["points"][i], ref["points"][rp[p]])
    pv = np.asarray(prog["point_valid"], bool)
    n["positions"] += int((pv[:len(prog_pts)] == 0).sum() + pv[len(prog_pts):].sum())
    a, b = _edges(prog, prog_kfs, prog_pts), _edges(ref, ref_kfs, ref_pts)
    n["edges"] = len(a.keys() ^ b.keys())
    # a weight is 1 / sigma^2 of a level, rounded to float32 either way
    n["weights"] = int(sum(abs(a[e] - b[e]) > 1e-6 * b[e] for e in a.keys() & b.keys()))
    return n
