"""FAST-9/16 corner detection (counterpart of orbslam_jpminipc_tpu/ops/fast.py).

`fast_score_map`, `nonmax_3x3`, `border_mask` and `cell_select` are the
plain PyTorch versions: the dense corner score from 16 shifted copies of the
image, the strict 3x3 non-maximum suppression, the border mask, and the
extractor's high/low threshold select per cell. `level_scores` (all levels
of a pyramid) and `detect` (one level, no select) run them for tensors on
the CPU and the hand-written CUDA kernel (ops/fast_cuda.py) for tensors on
the card; the two are bit-identical (same float32 subtract/min/max/-1
sequence).

Semantics match OpenCV FAST_9_16 with nonmax suppression: a pixel is a
corner if >= 9 contiguous circle pixels are all brighter than center + t or
all darker than center - t; its score is the largest t for which it stays a
corner, minus 1; ties between neighbours suppress both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import fast_cuda

# Bresenham circle of radius 3, in circular order, as (dy, dx).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _circle_stack(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (16, H, W): the image sampled at each circle offset, with
    zeros outside the image."""
    padded = F.pad(img, (3, 3, 3, 3))
    h, w = img.shape
    return torch.stack(
        [padded[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dy, dx in CIRCLE_OFFSETS]
    )


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9/16 score map, float32 (H, W); 0 where the test fails."""
    d = _circle_stack(img) - img[None]

    def arc_min(x):
        # min over the 9-arc starting at each of the 16 positions
        mins = x
        for j in range(1, 9):
            mins = torch.minimum(mins, torch.roll(x, -j, dims=0))
        return mins

    a = torch.amax(arc_min(d), dim=0)    # arc fully brighter
    b = torch.amax(arc_min(-d), dim=0)   # arc fully darker
    m = torch.maximum(a, b)
    return torch.where(m > threshold, m - 1.0, torch.zeros_like(m))


def nonmax_3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only strict local maxima (score > all 8 neighbours), cv2-style."""
    h, w = score.shape
    padded = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    neigh_max = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) == (0, 0):
                continue
            n = padded[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            neigh_max = n if neigh_max is None else torch.maximum(neigh_max, n)
    keep = (score > neigh_max) & (score > 0)
    return torch.where(keep, score, torch.zeros_like(score))


def border_mask(score: torch.Tensor, border: int) -> torch.Tensor:
    """Zero the `border`-pixel frame of a score map."""
    if border <= 0:
        return score
    out = torch.zeros_like(score)
    out[border:-border, border:-border] = score[border:-border, border:-border]
    return out


def detect(img: torch.Tensor, threshold: float, border: int = 0) -> torch.Tensor:
    """FAST corners with nonmax suppression and border masking.

    Returns the suppressed score map (H, W); nonzero entries are keypoints.
    A CUDA tensor goes through the CUDA kernel (which applies the border in
    the same pass); a CPU tensor through the plain version.
    """
    if img.is_cuda:
        return fast_cuda.fast_detect(img, threshold, border)
    if img.device.type != "cpu":
        raise ValueError(f"FAST detect: unsupported device {img.device}")
    return border_mask(nonmax_3x3(fast_score_map(img, threshold)), border)


def cell_select(lo: torch.Tensor, fast_th: float, cell: int) -> torch.Tensor:
    """The per-cell threshold fallback on a low-threshold score map `lo`:
    cells (edge `cell`, grid from (0, 0)) that hold a high-threshold corner
    keep only those; the others keep every corner of `lo`.

    The score is threshold-independent, so the high-threshold map is a mask
    of the low-threshold map (nonmax commutes with that mask).
    """
    h, w = lo.shape
    hi = torch.where(lo + 1.0 > fast_th, lo, torch.zeros_like(lo))
    ph, pw = -h % cell, -w % cell
    hi_p = F.pad(hi, (0, pw, 0, ph))
    cell_max = hi_p.reshape((h + ph) // cell, cell, (w + pw) // cell, cell).amax(dim=(1, 3))
    has_hi = (cell_max > 0).repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]
    return torch.where(has_hi, hi, lo)


def level_scores(levels, fast_th: float, fast_min_th: float, border: int = 0,
                 cell: int = 32) -> list[torch.Tensor]:
    """The extractor's score map of every pyramid level: FAST at
    `fast_min_th` with nonmax suppression and border masking, then
    `cell_select` at `fast_th`.

    CUDA tensors go through the CUDA kernel, all levels in one launch (with
    the select in the same pass for `cell` 32); CPU tensors through the
    plain version.
    """
    levels = list(levels)
    if levels and all(img.is_cuda for img in levels):
        return fast_cuda.fast_level_scores(levels, fast_th, fast_min_th, border, cell)
    if not levels or any(img.device.type != "cpu" for img in levels):
        raise ValueError(
            f"FAST level_scores: levels on {[str(img.device) for img in levels]}")
    return [cell_select(detect(img, fast_min_th, border), fast_th, cell)
            for img in levels]


def harris_score_map(img: torch.Tensor, block_size: int = 7, k: float = 0.04) -> torch.Tensor:
    """Dense Harris response (HarrisResponses, src/ORBextractor.cc:79-120):
    central differences on the edge-padded image, a block_size x
    block_size unnormalized box sum (zero outside the image), scaled by
    1/(4 * block_size * 255) per derivative. The extractor's Harris score
    type re-scores the selected FAST corners with it."""
    h, w = img.shape
    padded = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    ix = (padded[1:1 + h, 2:2 + w] - padded[1:1 + h, 0:w]) * 0.5
    iy = (padded[2:2 + h, 1:1 + w] - padded[0:h, 1:1 + w]) * 0.5
    r = block_size // 2
    box = torch.ones((1, 1, block_size, block_size), dtype=img.dtype, device=img.device)
    sums = F.conv2d(torch.stack([ix * ix, iy * iy, ix * iy])[:, None], box, padding=r)[:, 0]
    scale = 1.0 / (4 * block_size * 255.0)
    s2 = scale * scale
    a, b, c = sums[0] * s2, sums[1] * s2, sums[2] * s2
    return a * b - c * c - k * (a + b) * (a + b)
