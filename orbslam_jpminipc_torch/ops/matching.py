"""The matcher family over a dense Hamming matrix (counterpart of
orbslam_jpminipc_tpu/ops/matching.py).

Every matcher is: distance matrix + geometric predicate mask + best/second
min + threshold / NN-ratio / rotation-consistency / uniqueness filters.
"No match" is index 0 with a False mask. Every function takes leading batch
dimensions (the reference maps them with `jax.vmap`: one row per target
keyframe or neighbor); all reductions run over the last axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .hamming import hamming_matrix

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
_BIG = 1 << 20
_INT32_MAX = 2 ** 31 - 1


class Matches(NamedTuple):
    idx: torch.Tensor   # (..., N) int32 — index into the second feature set
    dist: torch.Tensor  # (..., N) int32 — Hamming distance (BIG where invalid)
    mask: torch.Tensor  # (..., N) bool


def masked_best2(ham: torch.Tensor, mask: torch.Tensor):
    """Per-row best and second-best over a masked (..., N, M) distance matrix.

    Returns (best_idx, best_dist, second_dist); the second-best is the
    runner-up in a DIFFERENT column. Two min-reductions over a packed
    (dist << shift | col) int32 key, so ties go to the lower column.
    """
    m = ham.shape[-1]
    shift = max(m.bit_length(), 1)
    low = (1 << shift) - 1
    col = torch.arange(m, dtype=torch.int32, device=ham.device)
    invalid = _INT32_MAX
    key = torch.where(mask, (ham << shift) | col, invalid)
    k1 = key.amin(dim=-1)
    none1 = k1 == invalid
    best_idx = torch.where(none1, 0, k1 & low).to(torch.int32)
    best = torch.where(none1, _BIG, k1 >> shift).to(torch.int32)
    key2 = torch.where(col == best_idx[..., None], invalid, key)
    k2 = key2.amin(dim=-1)
    second = torch.where(k2 == invalid, _BIG, k2 >> shift).to(torch.int32)
    return best_idx, best, second


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] along the last axis, batched."""
    return torch.take_along_dim(x, idx.to(torch.int64), dim=-1)


def rotation_consistency(rot_deg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Keep matches whose rotation offset falls in the 3 dominant bins.

    rot_deg: (..., N) angle1 - angle2 per tentative match. The reference's
    histogram: bin = round(rot * 1/HISTO_LENGTH) (only ~12 of 30 bins in
    use), bins with count < 0.1 * max dropped from the top 3, ties to the
    lower bin (ORBmatcher.cc:1748-1789).
    """
    rot = torch.remainder(rot_deg, 360.0)
    binf = torch.round(rot * (1.0 / HISTO_LENGTH))
    bins = torch.where(binf >= HISTO_LENGTH, 0, binf).to(torch.int64)
    ar = torch.arange(HISTO_LENGTH, device=rot.device)
    onehot = (bins[..., :, None] == ar) & valid[..., :, None]
    counts = onehot.sum(dim=-2)
    vals, idx = torch.sort(counts, dim=-1, descending=True, stable=True)
    top = vals[..., :3].to(torch.float32)
    keep1 = bins == idx[..., 0:1]
    keep2 = (bins == idx[..., 1:2]) & (top[..., 1:2] >= 0.1 * top[..., 0:1])
    keep3 = (bins == idx[..., 2:3]) & (top[..., 2:3] >= 0.1 * top[..., 0:1])
    return valid & (keep1 | keep2 | keep3)


def enforce_unique(idx: torch.Tensor, dist: torch.Tensor, valid: torch.Tensor,
                   m: int) -> torch.Tensor:
    """One-to-one constraint: each target keeps only its best source
    (lowest distance, then lowest source index)."""
    n = idx.shape[-1]
    src = torch.arange(n, dtype=torch.int32, device=idx.device)
    key = torch.where(valid, dist * n + src, _BIG).to(torch.int32)
    best = torch.full((*idx.shape[:-1], m), _BIG, dtype=torch.int32, device=idx.device)
    best = best.scatter_reduce(-1, idx.to(torch.int64), key, reduce="amin")
    return valid & (_gather(best, idx) == key)


def search_by_projection(
    desc1: torch.Tensor,       # (..., N, 32) uint8 — query (map point) descriptors
    uv_proj: torch.Tensor,     # (..., N, 2) — projected pixel positions
    pred_level: torch.Tensor,  # (..., N) int32 — predicted pyramid level
    valid1: torch.Tensor,      # (..., N) bool
    desc2: torch.Tensor,       # (..., M, 32) uint8 — frame descriptors
    xy2: torch.Tensor,         # (..., M, 2) — frame keypoint positions (undistorted)
    level2: torch.Tensor,      # (..., M) int32
    valid2: torch.Tensor,      # (..., M) bool
    scale_factors: torch.Tensor,  # (L,) per-level scale
    radius,                    # float or (..., N) tensor: base search radius in px
    max_dist: int = TH_HIGH,
    nn_ratio: float = 0.9,
    level_window: tuple[int, int] = (-1, 0),
) -> Matches:
    """Project-and-match: candidates lie within radius * scale[pred_level]
    of the projection and within pred_level + level_window."""
    ham = hamming_matrix(desc1, desc2)
    n_levels = scale_factors.shape[0]
    r = radius * scale_factors[torch.clamp(pred_level, 0, n_levels - 1).to(torch.int64)]
    d2 = torch.sum((uv_proj[..., :, None, :] - xy2[..., None, :, :]) ** 2, dim=-1)
    in_radius = d2 <= (r * r)[..., :, None]
    lo = pred_level[..., :, None] + level_window[0]
    hi = pred_level[..., :, None] + level_window[1]
    lv2 = level2[..., None, :]
    in_level = (lv2 >= lo) & (lv2 <= hi)
    mask = in_radius & in_level & valid1[..., :, None] & valid2[..., None, :]

    best_idx, best, second = masked_best2(ham, mask)
    ok = (best <= max_dist) & valid1
    ok = ok & ((best < nn_ratio * second) | (second >= _BIG))
    ok = enforce_unique(best_idx, best, ok, desc2.shape[-2])
    return Matches(best_idx, best, ok)


def window_search(
    desc1, xy1, angle1, valid1,
    desc2, xy2, angle2, level2, valid2,
    window_px: float,
    max_dist: int = TH_LOW,
    nn_ratio: float = 0.9,
    min_level: int = 0,
    max_level: int = 7,
    check_rotation: bool = True,
) -> Matches:
    """Windowed search (WindowSearch ORBmatcher.cc:409-516 and
    SearchForInitialization :598-713 with min_level = max_level = 0)."""
    ham = hamming_matrix(desc1, desc2)
    d2 = torch.sum((xy1[..., :, None, :] - xy2[..., None, :, :]) ** 2, dim=-1)
    lv2 = level2[..., None, :]
    mask = ((d2 <= window_px * window_px) & (lv2 >= min_level) & (lv2 <= max_level)
            & valid1[..., :, None] & valid2[..., None, :])
    best_idx, best, second = masked_best2(ham, mask)
    ok = (best <= max_dist) & valid1
    ok = ok & ((best < nn_ratio * second) | (second >= _BIG))
    if check_rotation:
        ok = rotation_consistency(angle1 - _gather(angle2, best_idx), ok)
    ok = enforce_unique(best_idx, best, ok, desc2.shape[-2])
    return Matches(best_idx, best, ok)


def mutual_match(
    desc1, angle1, valid1,
    desc2, angle2, valid2,
    max_dist: int = TH_LOW,
    nn_ratio: float = 0.75,
    check_rotation: bool = True,
    extra_mask: torch.Tensor | None = None,
) -> Matches:
    """Unconstrained descriptor matching (SearchByBoW family,
    ORBmatcher.cc:155-284 and :715-850; the BoW node grouping only prunes
    a brute-force search, so here it is the full masked matrix)."""
    ham = hamming_matrix(desc1, desc2)
    mask = valid1[..., :, None] & valid2[..., None, :]
    if extra_mask is not None:
        mask = mask & extra_mask
    best_idx, best, second = masked_best2(ham, mask)
    ok = (best <= max_dist) & valid1
    ok = ok & ((best < nn_ratio * second) | (second >= _BIG))
    if check_rotation:
        ok = rotation_consistency(angle1 - _gather(angle2, best_idx), ok)
    ok = enforce_unique(best_idx, best, ok, desc2.shape[-2])
    return Matches(best_idx, best, ok)


def search_for_triangulation(
    desc1, xy1, angle1, level1, has_point1, valid1,
    desc2, xy2, angle2, level2, has_point2, valid2,
    F12: torch.Tensor,          # (..., 3, 3)
    sigma2: torch.Tensor,       # (L,) per-level sigma^2 table
    epipole2: torch.Tensor,     # (..., 2) epipole of camera 1 in image 2
    scale_factors: torch.Tensor,
    max_dist: int = TH_LOW,
    check_rotation: bool = True,
) -> Matches:
    """Epipolar-constrained matching for new-point triangulation
    (SearchForTriangulation ORBmatcher.cc:852-1014): keypoints without a
    map point, candidates near the epipolar line of kp1 (chi^2 3.84 *
    sigma^2 of the kp2 level) and away from the epipole."""
    from ..geometry.epipolar import epipolar_dist2

    ham = hamming_matrix(desc1, desc2)
    n_lv = sigma2.shape[0]
    lv2 = torch.clamp(level2, 0, n_lv - 1).to(torch.int64)
    d_epi = epipolar_dist2(xy1[..., :, None, :], xy2[..., None, :, :], F12[..., None, None, :, :])
    epi_ok = d_epi < 3.84 * sigma2[lv2][..., None, :]
    d_ep2 = torch.sum((xy2 - epipole2[..., None, :]) ** 2, dim=-1)
    ep_ok = d_ep2 >= 100.0 * scale_factors[torch.clamp(level2, 0, scale_factors.shape[0] - 1).to(torch.int64)]
    mask = (epi_ok & ep_ok[..., None, :]
            & (~has_point1)[..., :, None] & (~has_point2)[..., None, :]
            & valid1[..., :, None] & valid2[..., None, :])
    best_idx, best, _ = masked_best2(ham, mask)
    ok = (best <= max_dist) & valid1 & (~has_point1)
    if check_rotation:
        ok = rotation_consistency(angle1 - _gather(angle2, best_idx), ok)
    ok = enforce_unique(best_idx, best, ok, desc2.shape[-2])
    return Matches(best_idx, best, ok)


def fuse_search(
    point_desc, uv_proj, pred_level, valid_pts,
    kf_desc, kf_xy, kf_level, kf_valid,
    scale_factors,
    radius: float = 3.0,
    max_dist: int = TH_LOW,
) -> Matches:
    """Duplicate-point fusion search (Fuse, ORBmatcher.cc:1016-1134): the
    best keypoint within radius*scale[pred] at level pred-1..pred+1."""
    return search_by_projection(
        point_desc, uv_proj, pred_level, valid_pts,
        kf_desc, kf_xy, kf_level, kf_valid,
        scale_factors, radius,
        max_dist=max_dist, nn_ratio=1.0, level_window=(-1, 1),
    )
