"""Image pyramid (counterpart of orbslam_jpminipc_tpu/ops/pyramid.py).

The reference resizes level to level with `jax.image.resize(..., "linear",
antialias=False)`: a separable product with a triangle-kernel weight matrix
whose columns have two non-zero taps. `F.interpolate(mode="bilinear")` is
not bit-identical to it (up to 8e-4 off at level 6), so this module rebuilds
the reference's arithmetic instead:

  * the sample position of output i is (i + 0.5) * inv_scale - 0.5 rounded
    once, as the reference's compiled program evaluates it (a fused
    multiply-add); the weights are the triangle kernel normalised by their
    column sum, exactly as `compute_weight_mat` builds them;
  * rows are resized first, then columns, and each output is the two-tap
    sum acc = x0 * w0 followed by acc = fma(x1, w1, acc), the order of the
    reference's dot product. The fused multiply-add is evaluated in float64
    (the product of two float32 values is exact there) and rounded once.

Measured against the JAX package on the CPU (random 480x640 frame; max abs
difference / share of pixels that differ), each level fed the JAX level
above it: L1 1.5e-5 / 15 %, L2 1.5e-5 / 0.05 %, L3 1.5e-5 / 0.07 %,
L4 0 / 0 %, L5 1.5e-5 / 17 %, L6 8.2e-4 / 17 %, L7 0 / 0 %. The remaining
differences are the reference compiler's own choice of contraction per
shape; a FAST map is bit-identical whenever both sides get the same level
image (tests/test_torch_extract.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def level_sizes(h: int, w: int, n_levels: int, scale_factor: float) -> list[tuple[int, int]]:
    """Static (height, width) per level, mirroring the reference's rounding."""
    sizes = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        sizes.append((int(round(h / s)), int(round(w / s))))
    return sizes


def scale_factors(n_levels: int, scale_factor: float):
    """Per-level scale and sigma2 tables (Frame.cc:95-107 equivalents)."""
    scales = np.array([scale_factor ** i for i in range(n_levels)], np.float32)
    return scales, scales ** 2


@functools.lru_cache(maxsize=64)
def _taps(n_in: int, n_out: int, device: str):
    """Two-tap form of the reference's (n_in, n_out) linear weight matrix:
    (i0, i1, w0, w1), each (n_out,). w1 is 0 where only one tap exists."""
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    pos = torch.arange(n_out, dtype=torch.float32) + 0.5
    sample = (pos.double() * inv_scale - 0.5).float()
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None])
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    cols = torch.arange(n_out)
    i0 = torch.argmax((w > 0).to(torch.int8), dim=0)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    w0 = w[i0, cols]
    w1 = torch.where(i1 > i0, w[i1, cols], torch.zeros_like(w0))
    return tuple(a.to(device) for a in (i0, i1, w0.double(), w1.double()))


def _resize_axis(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    i0, i1, w0, w1 = _taps(x.shape[dim], n_out, str(x.device))
    if dim == 0:
        x0, x1, w0, w1 = x[i0], x[i1], w0[:, None], w1[:, None]
    else:
        x0, x1 = x[:, i0], x[:, i1]
    acc = (x0.double() * w0).float()
    return (x1.double() * w1 + acc.double()).float()


def resize_linear(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(H, W) float32 -> size, the reference's linear resize without
    antialiasing (half-pixel sample positions, like cv::resize INTER_LINEAR)."""
    out = img
    if size[0] != img.shape[0]:
        out = _resize_axis(out, size[0], 0)
    if size[1] != img.shape[1]:
        out = _resize_axis(out, size[1], 1)
    return out


def build_pyramid(image: torch.Tensor, n_levels: int, scale_factor: float) -> list[torch.Tensor]:
    """Grayscale image (H, W) float32 -> list of per-level images, each
    resized from the level above it (as the reference does)."""
    h, w = image.shape
    sizes = level_sizes(h, w, n_levels, scale_factor)
    levels = [image]
    for lvl in range(1, n_levels):
        levels.append(resize_linear(levels[-1], sizes[lvl]))
    return levels
