"""ORB extraction, plain PyTorch: the pyramid, FAST-9/16 with the per-cell
threshold fallback, the per-cell quota selection, IC angles and rotated
BRIEF, as ORB-SLAM's extractor defines them (ORBextractor.cc) and in the
arithmetic order the port's plain version keeps (a frozen copy of it, with
no kernel). `extract(image, ...)` returns every keypoint's level, level-0
position, angle and descriptor.

`dtype` is the working precision of the image arithmetic (pyramid and
blur): float32 is the configuration's; bfloat16 is the benchmark's control,
the nearest precision below.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .orb_pattern import BIT_PATTERN_31

EDGE_THRESHOLD = 19
CELL = 32
HALF_PATCH = 15
PATCH_RADIUS = 18
PATCH_SIZE = 2 * PATCH_RADIUS + 1
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def quotas(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    """The geometric feature budget per level (ORBextractor.cc:476-487)."""
    factor = 1.0 / scale_factor
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    out, acc = [], 0
    for lvl in range(n_levels - 1):
        q = int(round(n_first * factor ** lvl))
        out.append(q)
        acc += q
    out.append(max(n_features - acc, 0))
    return out


def level_sizes(h: int, w: int, n_levels: int, scale_factor: float):
    return [(int(round(h / scale_factor ** l)), int(round(w / scale_factor ** l)))
            for l in range(n_levels)]


# -- pyramid: a two-tap linear resize, rows then columns ------------------------

def _taps(n_in: int, n_out: int, device):
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    sample = ((torch.arange(n_out, dtype=torch.float32) + 0.5).double() * inv_scale - 0.5).float()
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None])
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    cols = torch.arange(n_out)
    i0 = torch.argmax((w > 0).to(torch.int8), dim=0)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    w0 = w[i0, cols]
    w1 = torch.where(i1 > i0, w[i1, cols], torch.zeros_like(w0))
    return tuple(a.to(device) for a in (i0, i1, w0.double(), w1.double()))


def _resize_axis(x, n_out, dim, dtype):
    i0, i1, w0, w1 = _taps(x.shape[dim], n_out, x.device)
    if dim == 0:
        x0, x1, w0, w1 = x[i0], x[i1], w0[:, None], w1[:, None]
    else:
        x0, x1 = x[:, i0], x[:, i1]
    if dtype == torch.float32:
        acc = (x0.double() * w0).float()
        return (x1.double() * w1 + acc.double()).float()
    return (x0.to(dtype) * w0.to(dtype) + x1.to(dtype) * w1.to(dtype)).to(dtype).float()


def pyramid(image: torch.Tensor, n_levels: int, scale_factor: float, dtype=torch.float32):
    h, w = image.shape
    levels = [image]
    for (lh, lw) in level_sizes(h, w, n_levels, scale_factor)[1:]:
        out = levels[-1]
        if lh != out.shape[0]:
            out = _resize_axis(out, lh, 0, dtype)
        if lw != out.shape[1]:
            out = _resize_axis(out, lw, 1, dtype)
        levels.append(out)
    return levels


# -- FAST ------------------------------------------------------------------------

def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9/16 score map: the largest t for which a 9-arc stays all
    brighter or all darker than the centre by more than t, minus 1."""
    padded = F.pad(img, (3, 3, 3, 3))
    h, w = img.shape
    d = torch.stack([padded[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dy, dx in CIRCLE]) - img[None]

    def arc_min(x):
        m = x
        for j in range(1, 9):
            m = torch.minimum(m, torch.roll(x, -j, dims=0))
        return m

    m = torch.maximum(torch.amax(arc_min(d), 0), torch.amax(arc_min(-d), 0))
    return torch.where(m > threshold, m - 1.0, torch.zeros_like(m))


def nonmax(score: torch.Tensor) -> torch.Tensor:
    h, w = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    nb = torch.stack([p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]).amax(0)
    return torch.where((score > nb) & (score > 0), score, torch.zeros_like(score))


def level_score(img, fast_th, fast_min_th):
    """FAST at the low threshold, non-maximum suppression, the border, then
    the per-cell fallback: a cell with a corner above the high threshold
    keeps only those."""
    lo = nonmax(fast_score(img, fast_min_th))
    b = EDGE_THRESHOLD
    out = torch.zeros_like(lo)
    out[b:-b, b:-b] = lo[b:-b, b:-b]
    lo = out
    h, w = lo.shape
    hi = torch.where(lo + 1.0 > fast_th, lo, torch.zeros_like(lo))
    ph, pw = -h % CELL, -w % CELL
    cmax = F.pad(hi, (0, pw, 0, ph)).reshape((h + ph) // CELL, CELL, (w + pw) // CELL, CELL).amax((1, 3))
    has = (cmax > 0).repeat_interleave(CELL, 0).repeat_interleave(CELL, 1)[:h, :w]
    return torch.where(has, hi, lo)


def _cells(score):
    h, w = score.shape
    ph, pw = -h % CELL, -w % CELL
    s = F.pad(score, (0, pw, 0, ph))
    hc, wc = s.shape[0] // CELL, s.shape[1] // CELL
    return s.reshape(hc, CELL, wc, CELL).permute(0, 2, 1, 3).reshape(hc * wc, CELL * CELL), hc, wc


def _top(x, k):
    """The k largest, ties to the lower index first."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def select(score: torch.Tensor, quota: int):
    """The top `quota` pixels by (rank in its 32x32 cell, then score):
    (flat index, valid). Where each cell's best R = max(16, quota / cells)
    corners hold enough candidates, from those (cell-major order on ties),
    else from every pixel (pixel order on ties)."""
    h, w = score.shape
    cells, hc, wc = _cells(score)
    n_cells, csq = cells.shape
    r = int(min(csq, max(16, -(-quota // n_cells))))
    vals, within = _top(cells, r)
    rank_key = -1024.0 * torch.arange(r, dtype=torch.float32, device=score.device)
    cprio = torch.where(vals > 0, rank_key[None, :] + vals, torch.full_like(vals, float("-inf")))
    cid = torch.arange(n_cells, device=score.device)[:, None]
    pix = ((cid // wc) * CELL + within // CELL) * w + (cid % wc) * CELL + within % CELL
    enough = bool(torch.sum(cprio > float("-inf")) >= torch.clamp(torch.sum(score > 0), max=quota))
    if enough:
        v, i = _top(cprio.reshape(-1), quota)
        idx = pix.reshape(-1)[i]
    else:
        order = torch.sort(cells, dim=1, descending=True, stable=True).indices
        ranks = torch.empty_like(order)
        ranks.scatter_(1, order, torch.arange(csq, device=cells.device).expand_as(order).contiguous())
        prio = -ranks.to(torch.float32) * 1024.0 + cells
        prio = torch.where(cells > 0, prio, torch.full_like(prio, float("-inf")))
        prio = prio.reshape(hc, wc, CELL, CELL).permute(0, 2, 1, 3).reshape(hc * CELL, wc * CELL)[:h, :w]
        v, idx = _top(prio.reshape(-1), quota)
    return torch.clamp(idx, 0, h * w - 1), v > float("-inf")


# -- orientation and rotated BRIEF --------------------------------------------------

def _umax() -> np.ndarray:
    hp = HALF_PATCH
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


def _patch_mask() -> np.ndarray:
    umax, hp = _umax(), HALF_PATCH
    m = np.zeros((2 * hp + 1, 2 * hp + 1), bool)
    for v in range(-hp, hp + 1):
        m[v + hp, hp - umax[abs(v)]: hp + umax[abs(v)] + 1] = True
    return m


def _blur_taps():
    x = np.arange(7) - 3.0
    k = np.exp(-(x * x) / 8.0)
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


def blur(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """7x7 Gaussian, sigma 2, reflect-101 border, in the order k1 p1, then
    fused multiply-adds of k0 p0 and k2 p2 .. k6 p6 (rounded once each)."""
    h, w = img.shape
    k = _blur_taps()

    def refl(n):
        i = np.arange(-3, n + 3)
        i = np.where(i < 0, -i, i)
        return torch.from_numpy(np.where(i > n - 1, 2 * (n - 1) - i, i)).to(img.device)

    def one_pass(sh):
        if dtype != torch.float32:
            acc = sh(1).to(dtype) * k[1]
            for i in (0, 2, 3, 4, 5, 6):
                acc = acc + sh(i).to(dtype) * k[i]
            return acc.float()
        acc = sh(1) * k[1]
        for i in (0, 2, 3, 4, 5, 6):
            acc = (sh(i).double() * k[i] + acc.double()).float()
        return acc

    p = img[refl(h)]
    rows = one_pass(lambda i: p[i: i + h])
    p = rows[:, refl(w)]
    return one_pass(lambda i: p[:, i: i + w])


def patches(imgs: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    size = 2 * radius + 1
    c, h, w = imgs.shape
    padded = F.pad(imgs, (radius, radius, radius, radius))
    s = torch.round(xy).to(torch.int64)
    sx = torch.clamp(s[:, 0], 0, w + 2 * radius - size)
    sy = torch.clamp(s[:, 1], 0, h + 2 * radius - size)
    o = torch.arange(size, device=imgs.device)
    return padded[:, (sy[:, None] + o)[:, :, None], (sx[:, None] + o)[:, None, :]].permute(1, 0, 2, 3)


def ic_angle(p31: torch.Tensor) -> torch.Tensor:
    mask = torch.from_numpy(_patch_mask().astype(np.float32)).to(p31.device)
    u = torch.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=torch.float32, device=p31.device)
    m = p31 * mask[None]
    m10 = torch.sum(m * u[None, None, :], dim=(1, 2))
    m01 = torch.sum(m * u[None, :, None], dim=(1, 2))
    a = torch.atan2(m01, m10) * float(np.float32(180.0 / np.pi))
    return torch.where(a < 0, a + 360.0, a)


def brief(p37: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    n, dev = p37.shape[0], p37.device
    rad = angle * float(np.float32(np.pi / 180.0))
    a, b = torch.cos(rad), torch.sin(rad)
    pat = torch.from_numpy(np.stack([BIT_PATTERN_31[:, 0:2], BIT_PATTERN_31[:, 2:4]], 1)
                           .astype(np.float32)).to(dev)
    px, py = pat[..., 0], pat[..., 1]
    col = torch.round(px[None] * a[:, None, None] - py[None] * b[:, None, None])
    row = torch.round(px[None] * b[:, None, None] + py[None] * a[:, None, None])
    flat = ((row.to(torch.int64) + PATCH_RADIUS) * PATCH_SIZE
            + col.to(torch.int64) + PATCH_RADIUS).reshape(n, 512)
    vals = torch.gather(p37.reshape(n, -1), 1, flat).reshape(n, 256, 2)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int32).reshape(n, 32, 8)
    pack = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32, device=dev)
    return torch.sum(bits * pack, dim=-1).to(torch.uint8)


@torch.no_grad()
def extract(image: np.ndarray, n_features: int, n_levels: int, scale_factor: float,
            fast_th: float, fast_min_th: float, device="cpu", dtype=torch.float32) -> dict:
    """Every keypoint of a (H, W) uint8 frame: level (N,), xy (N, 2) at
    level-0 scale, angle (N,) in degrees, desc (N, 32) uint8, valid (N,)."""
    img = torch.from_numpy(np.ascontiguousarray(image)).to(device).to(torch.float32)
    levels = pyramid(img, n_levels, scale_factor, dtype)
    lv, xys, p31, p37, valid = [], [], [], [], []
    crop = PATCH_RADIUS - HALF_PATCH
    for l, q in enumerate(quotas(n_features, n_levels, scale_factor)):
        if q <= 0:
            continue
        im = levels[l]
        idx, ok = select(level_score(im, fast_th, fast_min_th), q)
        xy = torch.stack([idx % im.shape[1], idx // im.shape[1]], -1).to(torch.float32)
        both = patches(torch.stack([im, torch.round(blur(im, dtype))]), xy, PATCH_RADIUS)
        p31.append(both[:, 0, crop:-crop, crop:-crop])
        p37.append(both[:, 1])
        xys.append(xy * float(np.float32(scale_factor ** l)))
        lv.append(torch.full((q,), l, dtype=torch.int32, device=img.device))
        valid.append(ok)
    angle = ic_angle(torch.cat(p31))
    desc = brief(torch.cat(p37), angle)
    out = {"level": torch.cat(lv), "xy": torch.cat(xys), "angle": angle, "desc": desc,
           "valid": torch.cat(valid)}
    return {k: v.cpu().numpy() for k, v in out.items()}
