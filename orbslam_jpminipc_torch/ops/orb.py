"""ORB orientation and descriptor (counterpart of
orbslam_jpminipc_tpu/ops/orb.py).

IC_Angle, the 7x7 sigma=2 Gaussian blur and rotated BRIEF with the exact
OpenCV point-pair pattern, round-half-even rotation (`torch.round`, like
cvRound) and LSB-first bit packing, so descriptors compare with the
reference package's and with cv2.ORB's.

The reference samples the rotated pattern through a bf16 one-hot matrix
product (a trick for the TPU's matrix unit, exact because intensities are
integers <= 255); here a plain integer gather reads the same values.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .orb_pattern import BIT_PATTERN_31

HALF_PATCH_SIZE = 15
PATCH_RADIUS = 18  # covers rotated pattern points (|coord| <= 13*sqrt(2) < 19)
PATCH_SIZE = 2 * PATCH_RADIUS + 1  # 37


def _u_max_table() -> np.ndarray:
    """Circular-patch row extents, as the reference builds them (OpenCV's
    symmetric umax construction)."""
    hp = HALF_PATCH_SIZE
    umax = np.zeros(hp + 1, np.int32)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def _circular_mask() -> np.ndarray:
    """(31, 31) boolean mask of the orientation patch."""
    umax = _u_max_table()
    hp = HALF_PATCH_SIZE
    mask = np.zeros((2 * hp + 1, 2 * hp + 1), bool)
    for v in range(-hp, hp + 1):
        u_lim = umax[abs(v)]
        mask[v + hp, hp - u_lim: hp + u_lim + 1] = True
    return mask


class _Consts(NamedTuple):
    mask: torch.Tensor      # (31, 31) float32 orientation patch mask
    u: torch.Tensor         # (31,) float32 patch coordinates -15..15
    pattern: torch.Tensor   # (256, 2, 2) float32 [pair, point, (x, y)]
    pack: torch.Tensor      # (8,) int32 LSB-first bit weights


@functools.lru_cache(maxsize=8)
def _consts(device: str) -> _Consts:
    """The module's constant tables, uploaded once per device."""
    return _Consts(
        mask=torch.from_numpy(_circular_mask().astype(np.float32)).to(device),
        u=torch.arange(-HALF_PATCH_SIZE, HALF_PATCH_SIZE + 1,
                       dtype=torch.float32).to(device),
        pattern=torch.from_numpy(np.stack(
            [BIT_PATTERN_31[:, 0:2], BIT_PATTERN_31[:, 2:4]], axis=1
        ).astype(np.float32)).to(device),
        pack=torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32).to(device),
    )


def _blur_kernel() -> tuple[float, ...]:
    """The 7-tap sigma=2 Gaussian as float32 values."""
    x = np.arange(7) - 3.0
    k = np.exp(-(x * x) / (2.0 * 2.0 * 2.0))
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


_BLUR_KERNEL = _blur_kernel()


@functools.lru_cache(maxsize=64)
def _reflect101_index(n: int, pad: int, device: str) -> torch.Tensor:
    i = np.arange(-pad, n + pad)
    i = np.where(i < 0, -i, i)
    i = np.where(i > n - 1, 2 * (n - 1) - i, i)
    return torch.from_numpy(i).to(device)


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding (a fused multiply-add): the
    product of two float32 values is exact in float64."""
    return (a.double() * b + c.double()).float()


def gaussian_blur_7x7_sigma2(img: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 sigma=2 Gaussian, BORDER_REFLECT_101.

    The reference writes each pass as sum(k[i] * shifted[i]); its compiled
    program evaluates that as k1*p1, then fused multiply-adds of k0*p0 and of
    k2*p2 .. k6*p6. The same order here makes the blur bit-identical to it
    (measured on the CPU), and so the rounded blur that the descriptor reads.
    """
    h, w = img.shape
    k = _BLUR_KERNEL

    def one_pass(shifted):
        acc = shifted(1) * k[1]
        acc = _fma(shifted(0), k[0], acc)
        for i in range(2, 7):
            acc = _fma(shifted(i), k[i], acc)
        return acc

    padded = img[_reflect101_index(h, 3, str(img.device))]
    rows = one_pass(lambda i: padded[i: i + h])
    padded = rows[:, _reflect101_index(w, 3, str(img.device))]
    return one_pass(lambda i: padded[:, i: i + w])


def gather_patches_multi(imgs: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    """Patches around rounded keypoint coords from C stacked images:
    (C, H, W), (N, 2) xy -> (N, C, 2r+1, 2r+1). Zero outside the image.
    Starts follow the reference's dynamic_slice: a negative start counts
    from the end, then starts are clamped into the padded image (the
    extractor's keypoints keep a 19-pixel border, so neither happens there)."""
    size = 2 * radius + 1
    c, h, w = imgs.shape
    hp, wp = h + 2 * radius, w + 2 * radius
    padded = F.pad(imgs, (radius, radius, radius, radius))
    starts = torch.round(xy).to(torch.int64)
    sx, sy = starts[:, 0], starts[:, 1]
    sx = torch.clamp(torch.where(sx < 0, sx + wp, sx), 0, wp - size)
    sy = torch.clamp(torch.where(sy < 0, sy + hp, sy), 0, hp - size)
    offs = torch.arange(size, device=imgs.device)
    ys = (sy[:, None] + offs[None, :])[:, :, None]   # (N, size, 1)
    xs = (sx[:, None] + offs[None, :])[:, None, :]   # (N, 1, size)
    return padded[:, ys, xs].permute(1, 0, 2, 3)     # (N, C, size, size)


def gather_patches(img: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    """Patches around rounded keypoint coords of one image: (H, W), (N, 2)
    xy -> (N, 2r+1, 2r+1) (`gather_patches_multi` of a single channel)."""
    return gather_patches_multi(img[None], xy, radius)[:, 0]


def ic_angle_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """IC angle in degrees [0, 360) from (N, 31, 31) patches (moments m01,
    m10 over the circular patch of radius 15)."""
    k = _consts(str(patches.device))
    mask, u = k.mask, k.u
    masked = patches * mask[None]
    m10 = torch.sum(masked * u[None, None, :], dim=(1, 2))
    m01 = torch.sum(masked * u[None, :, None], dim=(1, 2))
    ang = torch.atan2(m01, m10) * float(np.float32(180.0 / np.pi))
    return torch.where(ang < 0, ang + 360.0, ang)


def descriptors_from_patches(patches: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF from (N, 37, 37) blurred patches -> (N, 32) uint8.

    Pattern point (x, y) rotated by the keypoint angle with round-half-even:
    col' = round(x*cos - y*sin), row' = round(x*sin + y*cos); bit =
    I(p1) < I(p2); 8 pairs per byte, LSB first.
    """
    n = patches.shape[0]
    dev = patches.device
    rad = angle_deg * float(np.float32(np.pi / 180.0))
    a, b = torch.cos(rad), torch.sin(rad)
    k = _consts(str(dev))
    px, py = k.pattern[..., 0], k.pattern[..., 1]   # (256, 2)
    col = torch.round(px[None] * a[:, None, None] - py[None] * b[:, None, None])
    row = torch.round(px[None] * b[:, None, None] + py[None] * a[:, None, None])
    flat = ((row.to(torch.int64) + PATCH_RADIUS) * PATCH_SIZE
            + col.to(torch.int64) + PATCH_RADIUS).reshape(n, 512)
    vals = torch.gather(patches.reshape(n, -1), 1, flat).reshape(n, 256, 2)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int32).reshape(n, 32, 8)
    return torch.sum(bits * k.pack, dim=-1).to(torch.uint8)


def ic_angle(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation, degrees in [0, 360) (IC_Angle,
    src/ORBextractor.cc:124-151): moments over the circular patch of radius
    15 on the (unblurred) level image."""
    return ic_angle_from_patches(gather_patches(img, xy, HALF_PATCH_SIZE))


def descriptors(img_blurred: torch.Tensor, xy: torch.Tensor,
                angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF descriptors of one blurred level: (N, 32) uint8 (see
    descriptors_from_patches)."""
    return descriptors_from_patches(gather_patches(img_blurred, xy, PATCH_RADIUS), angle_deg)
