"""Two-view map initialization: batched H/F RANSAC + reconstruction
(counterpart of orbslam_jpminipc_tpu/solvers/initializer.py).

Both models' 200 hypotheses in one batched program (Initializer.cc:102-107,
224-301): DLT through a batched 9x9 symmetric eigendecomposition,
chi^2 symmetric-transfer scoring against all matches at once
(CheckHomography :303-386, CheckFundamental :388-466), model selection
RH = SH/(SH+SF) > 0.40 (:109-116), then reconstruction: E decomposition
with 4-way cheirality disambiguation (ReconstructF :468-567, DecomposeE
:907-927, CheckRT :796-905) or the Faugeras 8-hypothesis homography
decomposition (ReconstructH :570-730).

The minimal sets are an input (`sets`, (n_hyp, 8) match indices): the
reference draws them with `jax.random`, which torch cannot reproduce, so a
caller either draws its own (`sample_minimal_sets`, a `torch.Generator`)
or passes the reference's. The candidate poses of a reconstruction are
checked as one batch.

Nothing here reads the host: the eigendecompositions and SVDs are the
Jacobi solvers of ops/small_linalg_cuda.py (on the CPU the SVDs are
LAPACK's, as the reference's: `_svd`), the 3x3
determinants and inverses closed forms, and every pick of one row (the best hypothesis, the
best candidate pose) a 1-element index (a 0-d tensor as an index is read
on the host). So an attempt runs as one captured program
(frontend/tracking.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import triangulate as tri
from ..geometry.epipolar import K_matrix
from ..ops.small_linalg_cuda import eigh_small, svd_small
from .linalg3 import det3, inv3_exact


class InitResult(NamedTuple):
    success: torch.Tensor  # () bool
    used_h: torch.Tensor   # () bool — which model was selected
    R: torch.Tensor        # (3, 3) world(frame1)->frame2
    t: torch.Tensor        # (3,) unit-norm translation
    points: torch.Tensor   # (N, 3) triangulated points in frame-1 coords
    good: torch.Tensor     # (N,) bool — triangulated & all gates passed
    n_good: torch.Tensor   # () int


def _normalize(uv: torch.Tensor, mask: torch.Tensor):
    """Zero mean, unit mean absolute deviation (Initializer.cc:747-793)."""
    w = mask.to(uv.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(uv * w[:, None], dim=0) / n
    dev = torch.sum(torch.abs(uv - mean) * w[:, None], dim=0) / n
    # no spread (fewer than two distinct valid points, e.g. no match at
    # all): the reference's 1e9 scale overflows A^T A to inf, where its
    # eigh gives NaN and torch's raises; unit scale instead. The attempt
    # fails either way (its inliers are its mask's)
    s = 1.0 / torch.where(dev > 0, torch.clamp(dev, min=1e-9), 1.0)
    uvn = (uv - mean) * s
    z = torch.zeros((), dtype=uv.dtype, device=uv.device)
    o = torch.ones((), dtype=uv.dtype, device=uv.device)
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, o]),
    ])
    return uvn, T


def sample_minimal_sets(generator: torch.Generator, mask: torch.Tensor, n_hyp: int = 200,
                        k: int = 8) -> torch.Tensor:
    """(n_hyp, k) distinct indices drawn uniformly from valid matches: per
    hypothesis, the top k of uniform scores over the valid slots (invalid
    slots score -1), ties to the lower index."""
    n = mask.shape[0]
    scores = torch.rand((n_hyp, n), generator=generator, device=mask.device)
    return select_minimal_sets(scores, mask, k)


def select_minimal_sets(scores: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """The minimal sets of drawn scores (n_hyp, n): per row the top k over
    the valid slots (invalid slots score -1), ties to the lower index. A
    score above 1 (never drawn: uniform scores lie in [0, 1)) is a forced
    pick, valid or not: `scores_for_sets` makes such rows. On the device,
    without a host read: a program takes the scores, drawn before it runs."""
    scores = torch.where(mask[None, :] | (scores > 1.0), scores, -1.0)
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]


def scores_for_sets(sets: torch.Tensor, n: int) -> torch.Tensor:
    """Scores (n_hyp, n) that `select_minimal_sets` turns back into `sets`
    (n_hyp, k), each row's indices in order: a replayed set (another
    implementation's draw) through a program that takes scores."""
    sets = sets.to(torch.int64)
    n_hyp, k = sets.shape
    rank = torch.arange(k + 1, 1, -1, dtype=torch.float32, device=sets.device)
    return torch.zeros((n_hyp, n), dtype=torch.float32, device=sets.device).scatter_(
        1, sets, rank.expand(n_hyp, k).contiguous())


def _fit_h(p1, p2):
    """Homography from >= 4 pairs: smallest eigenvector of A^T A
    (ComputeH21, Initializer.cc:224-264)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, vecs = eigh_small(AtA)
    h = vecs[..., :, 0]
    return h.reshape(*h.shape[:-1], 3, 3)


def _fit_f(p1, p2):
    """Fundamental from >= 8 pairs + rank-2 projection (ComputeF21,
    Initializer.cc:266-301)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], dim=-1)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, vecs = eigh_small(AtA)
    f = vecs[..., :, 0].reshape(*x1.shape[:-1], 3, 3)
    u, s, vt = _svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ (s[..., :, None] * vt)


_CHI2_H = 5.991
_CHI2_F = 3.841
_TH_SCORE = 5.991


def _score_h(H, Hinv, uv1, uv2, mask, inv_sigma2):
    def transfer(M, src):
        x = torch.cat([src, torch.ones_like(src[..., :1])], dim=-1)
        y = torch.einsum("...ij,...nj->...ni", M, x)
        return y[..., :2] / torch.clamp(torch.abs(y[..., 2:]), min=1e-12) * torch.sign(y[..., 2:])

    e12 = torch.sum((transfer(H, uv1) - uv2) ** 2, dim=-1) * inv_sigma2
    e21 = torch.sum((transfer(Hinv, uv2) - uv1) ** 2, dim=-1) * inv_sigma2
    in12 = e12 < _CHI2_H
    in21 = e21 < _CHI2_H
    score = torch.sum(
        torch.where(mask & in12, _TH_SCORE - e12, 0.0)
        + torch.where(mask & in21, _TH_SCORE - e21, 0.0),
        dim=-1,
    )
    return score, mask & in12 & in21


def _score_f(F, uv1, uv2, mask, inv_sigma2):
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], dim=-1)
    x2 = torch.cat([uv2, torch.ones_like(uv2[..., :1])], dim=-1)
    l2 = torch.einsum("...ij,...nj->...ni", F, x1)  # line in image 2
    l1 = torch.einsum("...ji,...nj->...ni", F, x2)  # line in image 1
    d2 = torch.sum(l2 * x2, dim=-1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(l1 * x1, dim=-1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    e1 = d1 * inv_sigma2
    e2 = d2 * inv_sigma2
    in1 = e1 < _CHI2_F
    in2 = e2 < _CHI2_F
    score = torch.sum(
        torch.where(mask & in1, _TH_SCORE - e1, 0.0)
        + torch.where(mask & in2, _TH_SCORE - e2, 0.0),
        dim=-1,
    )
    return score, mask & in1 & in2


def _check_rt(R, t, uv1, uv2, mask, K4, th2):
    """Initializer.cc:796-905 for a batch of candidate poses R (C, 3, 3),
    t (C, 3). Returns (n_good (C,), parallax_deg (C,), points (C, N, 3),
    good (C, N))."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    zero = torch.zeros(3, dtype=R.dtype, device=R.device)
    P1 = tri.projection_matrix(eye, zero, K4)
    P2 = tri.projection_matrix(R, t, K4)[:, None]               # (C, 1, 3, 4)
    xw, ok = tri.triangulate_dlt(uv1, uv2, P1, P2)              # (C, N, 3)
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]          # (C, 3)
    cosp = tri.parallax_cos(xw, zero, O2[:, None])
    z1 = xw[..., 2]
    xc2 = torch.einsum("cij,cnj->cni", R, xw) + t[:, None]
    z2 = xc2[..., 2]
    e1, _ = tri.reprojection_error2(xw, uv1, eye, zero, K4)
    e2, _ = tri.reprojection_error2(xw, uv2, R[:, None], t[:, None], K4)
    # depth gates apply where parallax is sufficient (cos < 0.99998)
    enough_par = cosp < 0.99998
    good = (mask & ok & enough_par & (z1 > 0) & (z2 > 0)
            & (e1 < th2) & (e2 < th2) & torch.isfinite(xw).all(dim=-1))
    n_good = good.sum(dim=-1)
    # parallax statistic: the 50th-smallest angle among good (or the max)
    deg = torch.rad2deg(torch.arccos(torch.clamp(cosp, -1.0, 1.0)))
    deg_sorted = torch.sort(torch.where(good, deg, torch.inf), dim=-1).values
    k = torch.clamp(torch.clamp(n_good - 1, min=0), max=49)
    par = torch.where(n_good > 0, torch.take_along_dim(deg_sorted, k[:, None], dim=-1)[:, 0], 0.0)
    return n_good, par, xw, good


def _svd(M):
    """The initializer's 3x3 SVDs (F's rank-2 projection, E, Faugeras's A).
    On a card the Jacobi kernel (no host read). On the CPU LAPACK's gesdd,
    the reference's own routine there: the initial map turns on the pose's
    last bits, and a Jacobi SVD's rounding is LAPACK's within 3e-7, not to
    the bit. With the plain Jacobi SVD here, tests/test_torch_reloc.py's
    per-frame point counts part from the reference's at frame 6 (535
    against 534); every other parity test passes. The Jacobi path is held
    on the CPU by tests/test_torch_initializer.py's `*_with_the_cards_svd`
    tests and on the card by chip_smoke.py's system run (the initial pose
    and map against the JAX outcome). The eigendecompositions are the
    Jacobi solver on either device."""
    if M.is_cuda:
        return svd_small(M)
    return torch.linalg.svd(M)


def _decompose_e(E):
    """4 candidate (R, t) from an essential matrix (DecomposeE :907-927)."""
    u, _, vt = _svd(E)
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    # W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]], made on the device (a list or
    # a scalar written into it would be a host copy, which a capture refuses)
    e = torch.eye(3, dtype=E.dtype, device=E.device)
    W = torch.stack([-e[1], e[0], e[2]])
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * torch.sign(det3(R1))
    R2 = R2 * torch.sign(det3(R2))
    return (R1, R2), t


def _reconstruct_f(F, uv1, uv2, inliers, K4, sigma2, min_parallax, min_triangulated):
    K = K_matrix(K4)
    E = K.T @ F @ K
    (R1, R2), t = _decompose_e(E)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    n, par, pts, good = _check_rt(Rs, ts, uv1, uv2, inliers, K4, 4.0 * sigma2)
    n_max = n.max()
    n_inliers = inliers.sum()
    min_good = torch.clamp((0.9 * n_inliers).to(torch.int32), min=int(min_triangulated))
    n_similar = torch.sum(n > 0.7 * n_max)
    best = torch.argmax(n).reshape(1)
    pick = lambda x: x[best][0]
    ok = (n_max >= min_good) & (n_similar == 1) & (pick(par) > min_parallax)
    return ok, pick(Rs), pick(ts), pick(pts), pick(good), pick(n)


def _reconstruct_h(H, uv1, uv2, inliers, K4, sigma2, min_parallax, min_triangulated):
    """Faugeras SVD-based decomposition (ReconstructH :570-730): 8 motion
    hypotheses from H = K A K^-1, disambiguated by CheckRT."""
    K = K_matrix(K4)
    Kinv = inv3_exact(K)
    A = Kinv @ H @ K
    U, w, Vt = _svd(A)
    s = det3(U) * det3(Vt)
    d1, d2, d3 = w[0], w[1], w[2]

    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / torch.clamp(d1 * d1 - d3 * d3, min=1e-12), min=0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / torch.clamp(d1 * d1 - d3 * d3, min=1e-12), min=0))
    # the sign patterns [1, 1, -1, -1], [1, -1, 1, -1] and [1, -1, -1, 1],
    # made on the device (a list would be a host upload)
    i = torch.arange(4, device=H.device)
    sgn = torch.where(i < 2, 1.0, -1.0).to(H.dtype)
    sgn3 = torch.where(i % 2 == 0, 1.0, -1.0).to(H.dtype)
    sgn_s = sgn * sgn3
    x1s = sgn * aux1
    x3s = sgn3 * aux3

    # case d' > 0
    aux_stheta = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0)) / torch.clamp(
        (d1 + d3) * d2, min=1e-12)
    ctheta = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    sthetas = sgn_s * aux_stheta
    # case d' < 0
    aux_sphi = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0)) / torch.clamp(
        (d1 - d3) * d2, min=1e-12)
    cphi = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    sphis = sgn_s * aux_sphi

    z = torch.zeros_like(sthetas)
    o = torch.ones_like(sthetas)
    ct = ctheta.expand(4)
    cp = cphi.expand(4)
    Rp_pos = torch.stack([torch.stack([ct, z, -sthetas], -1), torch.stack([z, o, z], -1),
                          torch.stack([sthetas, z, ct], -1)], dim=-2)
    Rp_neg = torch.stack([torch.stack([cp, z, sphis], -1), torch.stack([z, -o, z], -1),
                          torch.stack([sphis, z, -cp], -1)], dim=-2)
    tp_pos = (d1 - d3) * torch.stack([x1s, z, -x3s], -1)
    tp_neg = (d1 + d3) * torch.stack([x1s, z, x3s], -1)
    Rp = torch.cat([Rp_pos, Rp_neg])                             # (8, 3, 3)
    tp = torch.cat([tp_pos, tp_neg])                             # (8, 3)
    Rs = s * U @ Rp @ Vt
    ts = (U @ tp[..., None])[..., 0]
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)

    n, par, pts, good = _check_rt(Rs, ts, uv1, uv2, inliers, K4, 4.0 * sigma2)
    best = torch.argmax(n).reshape(1)
    pick = lambda x: x[best][0]
    n_max = n.max()
    second = torch.sort(n).values[-2]
    n_inliers = inliers.sum()
    # reference gates (Initializer.cc:712-729): clear winner (1.75x), enough
    # parallax, >= 90% of inliers triangulated and >= minTriangulated
    ok = ((second < 0.75 * n_max) & (pick(par) >= min_parallax)
          & (n_max > min_triangulated) & (n_max > 0.9 * n_inliers))
    return ok, pick(Rs), pick(ts), pick(pts), pick(good), pick(n)


def initialize(
    sets: torch.Tensor,   # (n_hyp, 8) minimal sets: match indices
    uv1: torch.Tensor,    # (N, 2) undistorted matched keypoints, frame 1
    uv2: torch.Tensor,    # (N, 2) matched keypoints, frame 2 (aligned with uv1)
    mask: torch.Tensor,   # (N,) bool — valid match slots
    K4: torch.Tensor,
    sigma: float = 1.0,
    min_parallax: float = 1.0,
    min_triangulated: int = 50,
) -> InitResult:
    """Initializer::Initialize (src/Initializer.cc:44-222), fully batched."""
    inv_sigma2 = 1.0 / (sigma * sigma)
    sigma2 = sigma * sigma
    sets = sets.to(torch.int64)

    uv1n, T1 = _normalize(uv1, mask)
    uv2n, T2 = _normalize(uv2, mask)
    p1 = uv1n[sets]  # (n_hyp, 8, 2)
    p2 = uv2n[sets]

    # homography hypotheses
    Hn = _fit_h(p1, p2)
    H = inv3_exact(T2) @ Hn @ T1  # un-normalized
    Hinv = inv3_exact(H)
    h_scores, h_in = _score_h(H, Hinv, uv1[None], uv2[None], mask[None], inv_sigma2)
    bh = torch.argmax(h_scores).reshape(1)
    SH = h_scores[bh][0]

    # fundamental hypotheses
    Fn = _fit_f(p1, p2)
    F = T2.T @ Fn @ T1
    f_scores, f_in = _score_f(F, uv1[None], uv2[None], mask[None], inv_sigma2)
    bf = torch.argmax(f_scores).reshape(1)
    SF = f_scores[bf][0]

    RH = SH / torch.clamp(SH + SF, min=1e-12)
    use_h = RH > 0.40

    ok_h, Rh, th, pts_h, good_h, n_h = _reconstruct_h(
        H[bh][0], uv1, uv2, h_in[bh][0], K4, sigma2, min_parallax, min_triangulated)
    ok_f, Rf, tf, pts_f, good_f, n_f = _reconstruct_f(
        F[bf][0], uv1, uv2, f_in[bf][0], K4, sigma2, 1.0, min_triangulated)

    pick = lambda a, b: torch.where(use_h, a, b)
    return InitResult(
        success=pick(ok_h, ok_f), used_h=use_h, R=pick(Rh, Rf), t=pick(th, tf),
        points=pick(pts_h, pts_f), good=pick(good_h, good_f), n_good=pick(n_h, n_f),
    )
