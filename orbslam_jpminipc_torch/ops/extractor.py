"""ORB pyramid feature extraction (counterpart of
orbslam_jpminipc_tpu/ops/extractor.py).

Same design as the reference package: dense FAST maps per level, a per-cell
threshold fallback (cells with no high-threshold corner use the low one),
and quota redistribution as one top-k over a (rank-in-cell major, score
minor) priority, so every cell's best corner is taken first.

Two points where PyTorch differs from JAX and the port says how it keeps
the reference's answer:
  * top-k ties: `lax.top_k` and the stable `argsort` keep the lower index
    first; `torch.topk` promises no order, so every top-k here is a stable
    descending `torch.sort` followed by a slice;
  * the fast/slow candidate path (`lax.cond` per level) needs one flag per
    level on the host: `extract` reads all levels' flags in one transfer
    and runs the exact slow path only for levels that need it. Its halves
    (`detect` up to the flags, `pick` per level, `describe` after) are the
    segments the WORKING step captures as programs (fused_track.py).

With `use_harris_score` (the settings' `ORBextractor.nScoreType: 0`) the
selected corners' `response` is their Harris response
(`fast.harris_score_map`, ORBextractor.cc:678-701); the selection itself
stays on the FAST scores, so the FAST launch does not change.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import fast, orb, pyramid

EDGE_THRESHOLD = 19  # reference border margin (ORBextractor.cc EDGE_THRESHOLD)


class Features(NamedTuple):
    """Padded per-frame features. Capacity N = n_features."""

    xy: torch.Tensor        # (N, 2) float32 — (x, y) at level-0 scale
    level: torch.Tensor     # (N,) int32 — pyramid level
    angle: torch.Tensor     # (N,) float32 — IC angle, degrees
    response: torch.Tensor  # (N,) float32 — FAST (or Harris) score
    desc: torch.Tensor      # (N, 32) uint8 — packed rBRIEF
    valid: torch.Tensor     # (N,) bool


def features_per_level(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    """Geometric distribution of the feature budget (ORBextractor.cc:476-487)."""
    factor = 1.0 / scale_factor
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    quotas = []
    acc = 0
    for lvl in range(n_levels - 1):
        q = int(round(n_first * factor ** lvl))
        quotas.append(q)
        acc += q
    quotas.append(max(n_features - acc, 0))
    return quotas


def topk_stable(x: torch.Tensor, k: int):
    """Largest k along the last dim, ties broken by lower index first
    (the `lax.top_k` order). Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _to_cells(score: torch.Tensor, cell: int):
    """(H, W) -> (n_cells, cell*cell) zero-padded blocks, and the cell grid width."""
    h, w = score.shape
    ph, pw = -h % cell, -w % cell
    s = F.pad(score, (0, pw, 0, ph))
    hc, wc = s.shape[0] // cell, s.shape[1] // cell
    cells = s.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3).reshape(hc * wc, cell * cell)
    return cells, hc, wc


def _cell_priority(score: torch.Tensor, cell: int) -> torch.Tensor:
    """Priority map -(rank in cell) * 1024 + score, -inf for non-corners."""
    h, w = score.shape
    cells, hc, wc = _to_cells(score, cell)
    order = torch.sort(cells, dim=1, descending=True, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(cells.shape[1], device=cells.device)
                   .expand_as(order).contiguous())
    prio = -ranks.to(torch.float32) * 1024.0 + cells
    prio = torch.where(cells > 0, prio, torch.full_like(prio, float("-inf")))
    prio = prio.reshape(hc, wc, cell, cell).permute(0, 2, 1, 3).reshape(hc * cell, wc * cell)
    return prio[:h, :w]


class _Candidates(NamedTuple):
    prio: torch.Tensor     # (n_cells * R,) candidate priorities
    pix: torch.Tensor      # (n_cells * R,) flat pixel index of each candidate
    fast_ok: torch.Tensor  # () bool: the candidates can fill the quota


def _cell_candidates(score: torch.Tensor, quota: int, cell: int) -> _Candidates:
    """Per-cell top-R candidates (the reference's fast path, first half)."""
    h, w = score.shape
    cells, _, wc = _to_cells(score, cell)
    n_cells, cell_sq = cells.shape
    r = int(min(cell_sq, max(16, -(-quota // n_cells))))
    vals, within = topk_stable(cells, r)
    rank_key = -1024.0 * torch.arange(r, dtype=torch.float32, device=score.device)
    prio = torch.where(vals > 0, rank_key[None, :] + vals,
                       torch.full_like(vals, float("-inf")))
    cid = torch.arange(n_cells, device=score.device)[:, None]
    py = (cid // wc) * cell + within // cell
    px = (cid % wc) * cell + within % cell
    pix = py * w + px  # flat index in the unpadded map (garbage for pad candidates)
    n_corners = torch.sum(score > 0)
    n_cand = torch.sum(prio > float("-inf"))
    fast_ok = n_cand >= torch.clamp(n_corners, max=quota)
    return _Candidates(prio.reshape(-1), pix.reshape(-1), fast_ok)


def _pick(score: torch.Tensor, quota: int, cell: int, cand: _Candidates,
          fast_ok: bool):
    """Second half of the selection: the global top-`quota`."""
    h, w = score.shape
    if fast_ok:
        v, i = topk_stable(cand.prio, quota)
        idx = cand.pix[i]
    else:
        v, idx = topk_stable(_cell_priority(score, cell).reshape(-1), quota)
    return torch.clamp(idx, 0, h * w - 1), v > float("-inf")


def _select_in_cells(score: torch.Tensor, quota: int, cell: int):
    """Top-`quota` pixels by (rank-in-cell, score) priority.
    Returns (flat_idx, valid) of shape (quota,)."""
    cand = _cell_candidates(score, quota, cell)
    return _pick(score, quota, cell, cand, bool(cand.fast_ok))


def _level_score(img: torch.Tensor, fast_th: float, fast_min_th: float,
                 cell: int) -> torch.Tensor:
    """One level's FAST score map with the per-cell threshold fallback."""
    return fast.level_scores([img], fast_th, fast_min_th, EDGE_THRESHOLD, cell)[0]


def _level_xy(idx: torch.Tensor, w: int) -> torch.Tensor:
    return torch.stack([idx % w, idx // w], dim=-1).to(torch.float32)


def _select_level(img: torch.Tensor, quota: int, fast_th: float,
                  fast_min_th: float, cell: int, use_harris_score: bool = False):
    """One pyramid level's keypoint selection -> (xy, response, valid)."""
    score = _level_score(img, fast_th, fast_min_th, cell)
    idx, valid = _select_in_cells(score, quota, cell)
    resp = fast.harris_score_map(img) if use_harris_score else score
    return _level_xy(idx, img.shape[1]), resp.reshape(-1)[idx], valid


class Detection(NamedTuple):
    """The first half of an extraction, up to the per-level fast-path flags:
    every level with a quota, its score map and its cell candidates."""

    levels: list          # (H_l, W_l) float32 pyramid levels
    scores: list          # (H_l, W_l) float32 score maps
    cands: list           # _Candidates per level
    fast_ok: torch.Tensor  # (n,) bool: the candidates of level l fill its quota


def level_plan(n_features: int, n_levels: int, scale_factor: float) -> list[tuple[int, int]]:
    """(level, quota) of every pyramid level with a feature quota."""
    quotas = features_per_level(n_features, n_levels, scale_factor)
    return [(lvl, q) for lvl, q in enumerate(quotas) if q > 0]


def detect(image: torch.Tensor, n_features: int = 1000, n_levels: int = 8,
           scale_factor: float = 1.2, fast_th: float = 20.0, fast_min_th: float = 7.0,
           cell: int = 32) -> Detection:
    """Pyramid, FAST (one kernel launch on the card) and every level's cell
    candidates, with no host read."""
    levels = pyramid.build_pyramid(image, n_levels, scale_factor)
    plan = level_plan(n_features, n_levels, scale_factor)
    imgs = [levels[lvl] for lvl, _ in plan]
    # every level's score map in one call: one kernel launch on the card
    scores = (fast.level_scores(imgs, fast_th, fast_min_th, EDGE_THRESHOLD, cell)
              if plan else [])
    cands = [_cell_candidates(s, quota, cell) for s, (_, quota) in zip(scores, plan)]
    return Detection(imgs, scores, cands, torch.stack([c.fast_ok for c in cands]))


def pick(score: torch.Tensor, quota: int, cand: _Candidates, fast_ok: bool, cell: int = 32):
    """One level's selection, by the path its host-read flag names:
    (flat pixel index (quota,), valid (quota,))."""
    return _pick(score, quota, cell, cand, fast_ok)


def describe(det: Detection, picks, n_features: int = 1000, n_levels: int = 8,
             scale_factor: float = 1.2, use_harris_score: bool = False) -> Features:
    """The second half: keypoints, IC angles and descriptors of the picked
    pixels, `picks` holding one level's (index, valid) each."""
    xys, lvls, resps, valids, p31, p37 = [], [], [], [], [], []
    crop = orb.PATCH_RADIUS - orb.HALF_PATCH_SIZE
    plan = level_plan(n_features, n_levels, scale_factor)
    for (lvl, quota), img, score, (idx, valid) in zip(plan, det.levels, det.scores, picks):
        xy = _level_xy(idx, img.shape[1])
        # round the blur to integer intensities (cv2's uint8 blur)
        blurred = torch.round(orb.gaussian_blur_7x7_sigma2(img))
        both = orb.gather_patches_multi(torch.stack([img, blurred]), xy, orb.PATCH_RADIUS)
        p31.append(both[:, 0, crop:-crop, crop:-crop])
        p37.append(both[:, 1])
        xys.append(xy * float(np.float32(scale_factor ** lvl)))
        lvls.append(torch.full((quota,), lvl, dtype=torch.int32, device=img.device))
        resp = fast.harris_score_map(img) if use_harris_score else score
        resps.append(resp.reshape(-1)[idx])
        valids.append(valid)

    angle = orb.ic_angle_from_patches(torch.cat(p31))
    desc = orb.descriptors_from_patches(torch.cat(p37), angle)
    return Features(
        xy=torch.cat(xys), level=torch.cat(lvls), angle=angle,
        response=torch.cat(resps), desc=desc, valid=torch.cat(valids),
    )


def extract(
    image: torch.Tensor,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    fast_th: float = 20.0,
    fast_min_th: float = 7.0,
    cell: int = 32,
    use_harris_score: bool = False,
) -> Features:
    """Extract ORB features from a grayscale float32 (H, W) image in [0, 255]."""
    det = detect(image, n_features, n_levels, scale_factor, fast_th, fast_min_th, cell)
    plan = level_plan(n_features, n_levels, scale_factor)
    # one device->host transfer for every level's fast-path flag
    ok = det.fast_ok.tolist()
    picks = [pick(s, quota, c, o, cell)
             for (_, quota), s, c, o in zip(plan, det.scores, det.cands, ok)]
    return describe(det, picks, n_features, n_levels, scale_factor, use_harris_score)
