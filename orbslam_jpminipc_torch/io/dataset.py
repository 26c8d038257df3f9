"""Dataset readers: the synthetic rendered room and TUM RGB-D directories
(counterpart of orbslam_jpminipc_tpu/io/dataset.py).

The synthetic renderer draws a textured room (walls, floor, furniture
panels) through the pinhole camera with exact ground-truth poses. It
reproduces the reference's frames without cv2: the textures come from the
same numpy draws, with cv2's bicubic resize and its 8-bit Gaussian blur
rebuilt in numpy, and each frame is the reference's painter's-order
sequence of `cv2.warpPerspective(..., BORDER_TRANSPARENT)` calls rebuilt as
a few batched passes on the sequence's device: the frame is rendered where
it is tracked, so a run uploads no image.

The TUM reader consumes the standard `rgb.txt` index of a TUM RGB-D
sequence directory; its PNGs are decoded by `io/png.py`.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from scipy.spatial.transform import Rotation

from ..utils.device import resolve_device
from ..utils.host import upload
from . import png


# ---------------------------------------------------------------------------
# cv2's arithmetic, rebuilt (the reference calls cv2 5.0 for these)
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """float32 fused multiply-add of float32 operands, exactly rounded: a*b
    is exact in float64, the float64 sum is rounded to odd (its exact
    error from a two-sum decides the last bit), and a float64 rounded to
    odd rounds to float32 as the exact value would."""
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd = (s.view(np.uint64) & 1).astype(bool) if s.ndim else bool(np.float64(s).view(np.uint64) & 1)
    s = np.where((err != 0) & ~odd, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _fma32_t(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`_fma32` on tensors (float32 operands whose product is exact in
    float64), in separate float64 operations on any device."""
    a, b, c = a.to(torch.float64), b.to(torch.float64), c.to(torch.float64)
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd = (s.view(torch.int64) & 1).bool()
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(torch.float64)
    s = torch.where((err != 0) & ~odd, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _cubic_taps(n_src: int, n_dst: int):
    """cv2.resize INTER_CUBIC taps along one axis: the source index of tap 1
    and four float32 weights per output (a = -0.75, centres at
    (d + 0.5) * scale - 0.5, weights evaluated in double then rounded)."""
    scale = 1.0 / (n_dst / n_src)
    fx = (np.arange(n_dst) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    x = fx - sx
    A = -0.75
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    return sx, np.stack([c0, c1, c2, c3], axis=-1).astype(np.float32)


def _cubic_resize(src: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(src, (size, size), interpolation=INTER_CUBIC) of a square
    float32 array, replicated border. Where no tap is clamped, in both
    axes, the float32 operations are cv2's, in cv2's order (measured
    against cv2 5.0: the row pass sums the products pairwise, the column
    pass as two fused pairs): equal bits (but for 0.4 % of them at scale
    2). In the border bands, where a tap is clamped, cv2 takes another
    order that was not pinned down; there the sums below differ from it in
    the last bit on a small share (under 2 % of all floats). The uint8
    textures built on them come out equal (tests/test_torch_dataset.py)."""
    n = src.shape[0]
    sx, w = _cubic_taps(n, size)
    idx = np.clip(sx[:, None] + np.arange(-1, 3)[None, :], 0, n - 1)
    inner = (sx - 1 >= 0) & (sx + 2 <= n - 1)

    def prods(p, c):
        return [(p[..., k] * c[..., k]).astype(np.float32) for k in range(4)]

    p = src[:, idx]                                           # (n, size, 4)
    m = prods(p, w)
    h_pair = (m[0] + m[1]).astype(np.float32) + (m[2] + m[3]).astype(np.float32)
    h_chain = _fma32(p[..., 3], w[:, 3], _fma32(p[..., 2], w[:, 2],
                                                _fma32(p[..., 0], w[:, 0], m[1])))

    def column(h, form):
        q = np.transpose(h.astype(np.float32)[idx], (0, 2, 1))   # (size, size, 4)
        cw = np.broadcast_to(w[:, None, :], q.shape)
        mm = prods(q, cw)
        if form == "inner":
            return (_fma32(q[..., 0], cw[..., 0], mm[1])
                    + _fma32(q[..., 2], cw[..., 2], mm[3])).astype(np.float32)
        return ((mm[0] + mm[2]).astype(np.float32)
                + (mm[1] + mm[3]).astype(np.float32)).astype(np.float32)

    out = column(h_chain, "border")
    out[np.ix_(inner, inner)] = column(h_pair, "inner")[np.ix_(inner, inner)]
    return out


def _gaussian_blur_3x3(img: np.ndarray, sigma: float = 0.7) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), sigma) of a uint8 image: cv2's
    fixed-point separable kernel (taps in 1/256, the centre taking the
    remainder), reflect-101 border, and the sum rounded from 1/65536."""
    side = np.exp(-1.0 / (2.0 * sigma * sigma))
    k_side = int(round(256.0 * side / (1.0 + 2.0 * side)))
    k = (k_side, 256 - 2 * k_side, k_side)
    a = np.pad(img.astype(np.int64), 1, mode="reflect")
    h = k[0] * a[:, :-2] + k[1] * a[:, 1:-1] + k[2] * a[:, 2:]
    v = k[0] * h[:-2] + k[1] * h[1:-1] + k[2] * h[2:]
    return ((v + (1 << 15)) >> 16).astype(np.uint8)


def _perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getPerspectiveTransform for a batch (..., 4, 2) of point pairs:
    the 8x8 system (the products of coordinates in float32, as cv2 forms
    them from its Point2f inputs), solved in float64. Returns (..., 3, 3)."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    batch = src.shape[:-2]
    a = np.zeros(batch + (8, 8), np.float64)
    b = np.zeros(batch + (8,), np.float64)
    sx, sy, dx, dy = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
    a[..., :4, 0] = a[..., 4:, 3] = sx
    a[..., :4, 1] = a[..., 4:, 4] = sy
    a[..., :4, 2] = a[..., 4:, 5] = 1.0
    a[..., :4, 6] = -(sx * dx)
    a[..., :4, 7] = -(sy * dx)
    a[..., 4:, 6] = -(sx * dy)
    a[..., 4:, 7] = -(sy * dy)
    b[..., :4] = dx
    b[..., 4:] = dy
    x = np.linalg.solve(a, b[..., None])[..., 0]
    return np.concatenate([x, np.ones(batch + (1,))], axis=-1).reshape(batch + (3, 3))


def _invert3(H: np.ndarray) -> np.ndarray:
    """cv2.invert of 3x3 float64 matrices (..., 3, 3): its closed form by
    cofactors."""
    s = lambda i, j: H[..., i, j]
    d = (s(0, 0) * (s(1, 1) * s(2, 2) - s(1, 2) * s(2, 1))
         - s(0, 1) * (s(1, 0) * s(2, 2) - s(1, 2) * s(2, 0))
         + s(0, 2) * (s(1, 0) * s(2, 1) - s(1, 1) * s(2, 0)))
    d = 1.0 / d
    return np.stack([
        (s(1, 1) * s(2, 2) - s(1, 2) * s(2, 1)) * d,
        (s(0, 2) * s(2, 1) - s(0, 1) * s(2, 2)) * d,
        (s(0, 1) * s(1, 2) - s(0, 2) * s(1, 1)) * d,
        (s(1, 2) * s(2, 0) - s(1, 0) * s(2, 2)) * d,
        (s(0, 0) * s(2, 2) - s(0, 2) * s(2, 0)) * d,
        (s(0, 2) * s(1, 0) - s(0, 0) * s(1, 2)) * d,
        (s(1, 0) * s(2, 1) - s(1, 1) * s(2, 0)) * d,
        (s(0, 1) * s(2, 0) - s(0, 0) * s(2, 1)) * d,
        (s(0, 0) * s(1, 1) - s(0, 1) * s(1, 0)) * d,
    ], axis=-1).reshape(H.shape)


def _matmul_t32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b.T for float32 (..., 4, 3) and (3, 3) as the reference's numpy
    computes it (its BLAS: a fused multiply-add chain over k, in order),
    on any machine."""
    out = (a[..., :, None, 0] * b[:, 0]).astype(np.float32)
    for k in (1, 2):
        out = _fma32(a[..., :, None, k], b[:, k], out)
    return out


# ---------------------------------------------------------------------------
# the scene (the reference's numpy call sequence, kept draw for draw)
# ---------------------------------------------------------------------------

def _make_texture(rng, size=1024, blobs=900):
    """Multi-scale, non-repetitive texture: octave noise for unique
    large-scale context plus blobs spanning 6..160 px (the reference's
    `_make_texture`, with cv2's resize and blur rebuilt)."""
    tex = np.zeros((size, size), np.float32)
    for octave, amp in [(8, 60.0), (32, 40.0), (128, 25.0)]:
        small = rng.normal(0, 1, (octave, octave)).astype(np.float32)
        tex += amp * _cubic_resize(small, size)
    tex += 128.0
    for _ in range(blobs):
        w = int(rng.integers(6, 160))
        h = int(rng.integers(6, 160))
        x = int(rng.integers(0, size - w))
        y = int(rng.integers(0, size - h))
        base = rng.uniform(20, 235)
        gx, gy = rng.uniform(-2, 2, 2)
        patch = base + gx * np.arange(w)[None, :] + gy * np.arange(h)[:, None]
        alpha = rng.uniform(0.5, 1.0)
        if rng.uniform() < 0.5:
            tex[y : y + h, x : x + w] = (1 - alpha) * tex[y : y + h, x : x + w] + alpha * patch
        else:
            yy, xx = np.mgrid[0:h, 0:w]
            m = ((yy - h / 2) ** 2 / (h / 2) ** 2 + (xx - w / 2) ** 2 / (w / 2) ** 2) <= 1
            reg = tex[y : y + h, x : x + w]
            reg[m] = (1 - alpha) * reg[m] + alpha * np.broadcast_to(patch, reg.shape)[m]
    tex += rng.normal(0, 4.0, tex.shape)
    tex = np.clip(tex, 0, 255).astype(np.uint8)
    return _gaussian_blur_3x3(tex, 0.7)


def _tile_quad(corners: np.ndarray, tex: np.ndarray, n: int = 10):
    """Split a textured planar quad into an n x n grid of sub-quads, each
    with its texture sub-rectangle (a view of `tex`)."""
    if n <= 1:
        return [(corners, tex)]
    size = tex.shape[0]
    c00, c10, c11, c01 = corners[0], corners[1], corners[2], corners[3]

    def lerp(u, v):
        a = c00 * (1 - u) + c10 * u
        b = c01 * (1 - u) + c11 * u
        return a * (1 - v) + b * v

    out = []
    for j in range(n):
        v0, v1 = j / n, (j + 1) / n
        y0, y1 = int(round(v0 * (size - 1))), int(round(v1 * (size - 1))) + 1
        for i in range(n):
            u0, u1 = i / n, (i + 1) / n
            x0, x1 = int(round(u0 * (size - 1))), int(round(u1 * (size - 1))) + 1
            sub = np.stack([lerp(u0, v0), lerp(u1, v0), lerp(u1, v1), lerp(u0, v1)])
            out.append((sub.astype(np.float32), tex[y0:y1, x0:x1]))
    return out


class SyntheticSequence:
    """Renders a textured room from a ground-truth trajectory, on `device`.

    The room: back wall (z = wall_z), two side walls and the floor, a front
    wall closing it for `orbit`, each cut into 10 x 10 tiles, and ten
    fronto-parallel panels at spread depths. `render(i)` returns a (H, W)
    uint8 tensor on the sequence's device, equal to the reference's frame.
    """

    def __init__(self, n_frames: int = 120, width: int = 640, height: int = 480,
                 K4=(500.0, 500.0, 320.0, 240.0), trajectory: str = "xyz", seed: int = 0,
                 wall_z: float = 3.0, floor_y: float = 1.2, device=None):
        rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.width, self.height = width, height
        self.K = np.array([[K4[0], 0, K4[2]], [0, K4[1], K4[3]], [0, 0, 1]], np.float64)
        self.K4 = np.array(K4, np.float32)
        self.wall_z = wall_z
        self.floor_y = floor_y
        fy = floor_y
        wz = wall_z
        # the orbit trajectory sweeps 360 degrees: its room is closed
        z_near = -1.5 if trajectory == "orbit" else 0.6
        hw = 2.0  # room half-width
        self.quads = [
            # (corners [4x3, painter order far->near], texture)
            (np.array([[-hw, -1.5, wz], [hw, -1.5, wz], [hw, fy, wz], [-hw, fy, wz]], np.float32),
             _make_texture(rng)),
            (np.array([[-hw, -1.5, wz], [-hw, fy, wz], [-hw, fy, z_near], [-hw, -1.5, z_near]], np.float32),
             _make_texture(np.random.default_rng(seed + 2))),
            (np.array([[hw, -1.5, wz], [hw, fy, wz], [hw, fy, z_near], [hw, -1.5, z_near]], np.float32),
             _make_texture(np.random.default_rng(seed + 3))),
            (np.array([[-hw, fy, wz], [hw, fy, wz], [hw, fy, z_near], [-hw, fy, z_near]], np.float32),
             _make_texture(np.random.default_rng(seed + 1))),
        ]
        if trajectory == "orbit":
            self.quads.append((
                np.array([[hw, -1.5, z_near], [-hw, -1.5, z_near],
                          [-hw, fy, z_near], [hw, fy, z_near]], np.float32),
                _make_texture(np.random.default_rng(seed + 4)),
            ))
        # tiles: a quad with a corner behind the near plane is dropped, and
        # a camera inside the room always has some wall partly behind it
        self.quads = [t for q in self.quads for t in _tile_quad(*q, n=10)]
        # furniture panels at 1.35-2.5 m, painter order far to near
        prng = np.random.default_rng(seed + 7)
        panels = []
        for depth in [2.5, 2.2, 1.9, 1.6, 1.35]:
            for _ in range(2):
                cx_p = float(prng.uniform(-1.3, 1.3))
                cy_p = float(prng.uniform(-0.6, fy - 0.3))
                w2 = float(prng.uniform(0.25, 0.45))
                h2 = float(prng.uniform(0.2, 0.4))
                quad = np.array(
                    [[cx_p - w2, cy_p - h2, depth], [cx_p + w2, cy_p - h2, depth],
                     [cx_p + w2, cy_p + h2, depth], [cx_p - w2, cy_p + h2, depth]],
                    np.float32,
                )
                panels.append((quad, _make_texture(prng, size=256, blobs=120)))
        self.quads.extend(panels)
        self.poses = self._trajectory(n_frames, trajectory)
        self.timestamps = np.arange(n_frames) / 30.0
        self._corners = np.stack([c for c, _ in self.quads]).astype(np.float32)
        self._tex_shape = np.array([tex.shape[:2] for _, tex in self.quads], np.int64)
        self._upload_textures()
        # on a card frames are drawn on a stream of their own (see `render`),
        # which first waits for the textures' upload
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def __len__(self):
        return len(self.poses)

    def _trajectory(self, n, kind):
        poses = []
        for i in range(n):
            ph = i / max(n - 1, 1)
            if kind == "xyz":
                # oscillating translation (TUM fr1/xyz-like), small rotation
                t_wc = np.array(
                    [0.35 * np.sin(2 * np.pi * ph * 2),
                     0.15 * np.sin(2 * np.pi * ph * 3),
                     0.25 * np.sin(2 * np.pi * ph)],
                )
                rot = Rotation.from_euler(
                    "yxz", [0.06 * np.sin(2 * np.pi * ph * 2), 0.03 * np.sin(2 * np.pi * ph * 3), 0.0]
                )
            elif kind == "forward":
                t_wc = np.array([0.0, 0.0, 0.02 * i])
                rot = Rotation.identity()
            elif kind == "loop":
                # the camera pans ~60 degrees away and comes back
                t_wc = np.array(
                    [0.8 * np.sin(2 * np.pi * ph),
                     0.03 * np.sin(4 * np.pi * ph),
                     0.2 * np.sin(2 * np.pi * ph)],
                )
                rot = Rotation.from_euler("y", 1.05 * np.sin(2 * np.pi * ph))
            elif kind == "orbit":
                # a full 360-degree sweep on a circle of radius 0.7, facing out
                theta = 2 * np.pi * ph
                r = 0.7
                t_wc = np.array(
                    [r * np.sin(theta),
                     0.02 * np.sin(4 * np.pi * ph),
                     r * np.cos(theta)],
                )
                rot = Rotation.from_euler("y", theta)
            else:
                raise ValueError(kind)
            R_wc = rot.as_matrix()
            # world->cam: R = R_wc^T, t = -R_wc^T t_wc
            R = R_wc.T
            t = -R @ t_wc
            poses.append((R.astype(np.float32), t.astype(np.float32)))
        return poses

    # -- textures on the device ---------------------------------------------

    def _upload_textures(self):
        """Every texture the quads view, once, in one flat uint8 tensor; per
        quad the flat offset of its first texel, its row stride, width and
        height (a tile is a view into its wall's texture)."""
        bases, flat, starts = {}, [], []
        off = 0
        meta = np.zeros((len(self.quads), 4), np.int64)
        for q, (_, tex) in enumerate(self.quads):
            base = tex if tex.base is None else tex.base
            key = id(base)
            if key not in bases:
                bases[key] = (off, base)
                flat.append(np.ascontiguousarray(base).reshape(-1))
                off += base.size
            start, base = bases[key]
            meta[q] = (start + (tex.ctypes.data - base.ctypes.data),
                       tex.strides[0], tex.shape[1], tex.shape[0])
        self._tex = upload(np.concatenate(flat), self.device)
        self._tex_meta = meta

    # -- rendering ------------------------------------------------------------

    def _homographies(self, R, t, corners, tex_shape):
        """Per quad the homography mapping texture pixels -> image pixels
        (the reference's float32 projection, then
        cv2.getPerspectiveTransform), and whether it exists: a quad with a
        corner within 0.05 of the camera plane is dropped."""
        th, tw = tex_shape[:, 0], tex_shape[:, 1]
        src = np.zeros((len(corners), 4, 2), np.float32)
        src[:, 1, 0] = src[:, 2, 0] = tw - 1
        src[:, 2, 1] = src[:, 3, 1] = th - 1
        xc = _matmul_t32(corners, np.asarray(R, np.float32)) + t
        ok = (xc[..., 2] > 0.05).all(axis=1)
        uv = _matmul_t32(xc[ok], self.K.astype(np.float32))
        uv = uv[..., :2] / uv[..., 2:]
        H = np.zeros((len(corners), 3, 3))
        if ok.any():
            H[ok] = _perspective_transform(src[ok], uv.astype(np.float32))
        return H, ok

    def _plane_homography(self, R, t, corners_world, tex_shape):
        """The reference's per-quad form of `_homographies`: the 3x3
        homography, or None."""
        H, ok = self._homographies(R, t, np.asarray(corners_world, np.float32)[None],
                                   np.array([tex_shape[:2]]))
        return H[0] if ok[0] else None

    def _frame_quads(self, i: int):
        """The visible quads of frame i: their indices, the float32 inverse
        maps (image -> texture, as cv2.warpPerspective inverts H), and the
        image boxes (x0, y0, x1, y1) that the texels each may touch project
        into."""
        R, t = self.poses[i]
        W, Hh = self.width, self.height
        H, ok = self._homographies(R, t, self._corners, self._tex_shape)
        q = np.nonzero(ok)[0]
        H = H[q]
        th, tw = self._tex_shape[q, 0], self._tex_shape[q, 1]
        # a pixel is touched when its source lies in [-1, tw) x [-1, th)
        ext = np.stack([np.where([1, 0, 0, 1], -1.0, tw[:, None]),
                        np.where([1, 1, 0, 0], -1.0, th[:, None]), np.ones((len(q), 4))], -1)
        p = np.einsum("qij,qkj->qki", H, ext)
        whole = (p[..., 2] <= 1e-9).any(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            u, v = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
        lo = np.stack([np.floor(u.min(1)) - 1, np.floor(v.min(1)) - 1], 1)
        hi = np.stack([np.ceil(u.max(1)) + 1, np.ceil(v.max(1)) + 1], 1)
        lo[whole], hi[whole] = 0, (W - 1, Hh - 1)
        lo = np.maximum(lo, 0)
        hi = np.minimum(hi, (W - 1, Hh - 1))
        keep = (lo <= hi).all(axis=1)          # boxes off the image are empty
        box = np.concatenate([lo, hi], 1)
        box[~keep] = 0
        box = box.astype(np.int64)
        return q[keep], _invert3(H[keep]).astype(np.float32).reshape(-1, 9), box[keep]

    @torch.no_grad()
    def render(self, i: int) -> torch.Tensor:
        """Frame i as a (H, W) uint8 tensor on the sequence's device (see
        `_draw`). On a card the frame is drawn on the sequence's own stream:
        the draw reads the host twice (its compaction's size, the depth of
        the quad stack), and on the caller's stream each read would wait for
        all the work queued there, a pipelined system's steps included. The
        caller's stream waits for the frame on the device instead."""
        if self._stream is None:
            return self._draw(i)
        caller = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            img = self._draw(i)
        caller.wait_stream(self._stream)
        img.record_stream(caller)
        return img

    def _draw(self, i: int) -> torch.Tensor:
        """Frame i on the current stream: the
        reference's painter's-order warps, each pixel's arithmetic as cv2's
        (source coordinate by a fused multiply-add and a float32 division,
        bilinear blend by fused multiply-adds, round half to even). A pixel
        whose source has all four texels inside the quad's texture takes
        the blend; one whose source lies within one texel outside blends the
        inside texels with the pixel's current value (cv2's rule for
        BORDER_TRANSPARENT, measured); others keep it. So the last quad with
        all four texels inside sets the base value and the partial quads
        above it apply in order."""
        dev = self.device
        W, Hh = self.width, self.height
        q_ids, minv, box = self._frame_quads(i)
        img = torch.zeros(W * Hh, dtype=torch.float32, device=dev)
        if not len(q_ids):
            return img.reshape(Hh, W).to(torch.uint8)
        bw, bh = box[:, 2] - box[:, 0] + 1, box[:, 3] - box[:, 1] + 1
        counts = bw * bh
        per_quad = np.concatenate([
            q_ids[:, None], box[:, :2], bw[:, None], np.cumsum(counts)[:, None] - counts[:, None],
            self._tex_meta[q_ids]], axis=1)
        pq = upload(per_quad, dev)                                    # (Q, 9) int64
        mq = upload(minv, dev)                                        # (Q, 9) float32
        n = int(counts.sum())
        c = torch.repeat_interleave(torch.arange(len(q_ids), device=dev),
                                    upload(counts, dev), output_size=n)
        local = torch.arange(n, device=dev) - pq[c, 4]
        px = pq[c, 1] + local % pq[c, 3]
        py = pq[c, 2] + torch.div(local, pq[c, 3], rounding_mode="floor")
        quad = pq[c, 0]
        pix = py * W + px
        M = mq[c]
        xf, yf = px.to(torch.float32), py.to(torch.float32)

        def coord(k):
            # cv2: the row term in float32, then x * M[k] + row as one fma
            return _fma32_t(xf, M[:, k], yf * M[:, k + 1] + M[:, k + 2])

        X, Y, Wd = coord(0), coord(3), coord(6)
        sx, sy = X / Wd, Y / Wd
        finite = torch.isfinite(sx) & torch.isfinite(sy) & (sx.abs() < 1e7) & (sy.abs() < 1e7)
        sx = torch.where(finite, sx, torch.full_like(sx, -1e7))
        sy = torch.where(finite, sy, torch.full_like(sy, -1e7))
        fxs, fys = torch.floor(sx), torch.floor(sy)
        ax, ay = sx - fxs, sy - fys
        ix, iy = fxs.to(torch.int64), fys.to(torch.int64)
        t_off, t_str, tw, th = pq[c, 5], pq[c, 6], pq[c, 7], pq[c, 8]
        touched = (ix >= -1) & (ix <= tw - 1) & (iy >= -1) & (iy <= th - 1)
        full = (ix >= 0) & (ix <= tw - 2) & (iy >= 0) & (iy <= th - 2)
        # compact to the candidates that touch their pixel
        keep = torch.nonzero(touched).squeeze(1)
        pix, quad, full = pix[keep], quad[keep], full[keep]
        ix, iy, ax, ay = ix[keep], iy[keep], ax[keep], ay[keep]
        t_off, t_str, tw, th = t_off[keep], t_str[keep], tw[keep], th[keep]
        texels = []
        for dy in (0, 1):
            for dx in (0, 1):
                xx, yy = ix + dx, iy + dy
                inside = (xx >= 0) & (xx < tw) & (yy >= 0) & (yy < th)
                at = t_off + yy.clamp(min=0) * t_str + xx.clamp(min=0)
                texels.append((self._tex[torch.where(inside, at, 0)].to(torch.float32), inside))

        def blend(cur):
            p = [torch.where(ins, v, cur) for v, ins in texels]
            # cv2's lerps are fused multiply-adds (seen on ties: x.5 exactly
            # in float32 rounds the other way without the fusion)
            v0 = _fma32_t(ax, p[1] - p[0], p[0])
            v1 = _fma32_t(ax, p[3] - p[2], p[2])
            return torch.round(_fma32_t(ay, v1 - v0, v0)).clamp(0, 255)

        # the base: the last quad with all four texels inside
        last_full = torch.full((W * Hh,), -1, dtype=torch.int64, device=dev)
        last_full.scatter_reduce_(0, pix[full], quad[full], reduce="amax")
        top = full & (quad == last_full[pix])
        img[pix[top]] = blend(torch.zeros_like(ax))[top]
        # then the partial quads above it, in painter's order, one round per
        # depth of the stack (its depth is read once)
        part = ~full & (quad > last_full[pix])
        sel = torch.nonzero(part).squeeze(1)
        if sel.numel():
            order = torch.argsort(pix[sel] * (len(self.quads) + 1) + quad[sel])
            sel = sel[order]
            ps = pix[sel]
            first = torch.ones_like(ps, dtype=torch.bool)
            first[1:] = ps[1:] != ps[:-1]
            pos = torch.arange(len(ps), device=dev)
            start = torch.cummax(torch.where(first, pos, 0), 0).values
            rank = pos - start
            depth = int(rank.max()) + 1
            texels = [(v[sel], ins[sel]) for v, ins in texels]
            ax, ay = ax[sel], ay[sel]
            for r in range(depth):
                at = rank == r
                val = blend(img[ps])
                img[ps[at]] = val[at]
        return img.reshape(Hh, W).to(torch.uint8)

    def get(self, i: int):
        return self.render(i), float(self.timestamps[i]), self.poses[i]


class TumDataset:
    """TUM RGB-D sequence directory reader (rgb.txt + rgb/*.png). `get(i)`
    returns the frame as a (H, W) uint8 tensor on `device`, decoded as
    cv2.imread(..., IMREAD_GRAYSCALE) decodes it."""

    def __init__(self, path: str, device=None):
        self.path = path
        self.device = resolve_device(device)
        self.entries: list[tuple[float, str]] = []
        with open(os.path.join(path, "rgb.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                self.entries.append((float(ts), rel))

    def __len__(self):
        return len(self.entries)

    def get(self, i: int):
        ts, rel = self.entries[i]
        img = png.read_gray(os.path.join(self.path, rel))
        return upload(img, self.device), ts, None


class PhotometricAugment:
    """Photometric degradation over a sequence (all deterministic in the
    seed): directional motion blur along the dominant image-plane motion
    (`blur_px`), additive Gaussian noise (`noise_sigma`, DN, drawn by the
    reference's numpy generator), a sinusoidal exposure gain in [1-a, 1+a]
    (`exposure_amp`), and radial vignetting (`vignette` at the corners).
    The arithmetic runs on the base sequence's device in the reference's
    dtypes: a float32 image, float64 noise, then clip and truncation to
    uint8."""

    def __init__(self, base, blur_px: float = 0.0, noise_sigma: float = 0.0,
                 exposure_amp: float = 0.0, vignette: float = 0.0, seed: int = 0):
        self.base = base
        self.blur_px = blur_px
        self.noise_sigma = noise_sigma
        self.exposure_amp = exposure_amp
        self.vignette = vignette
        self.seed = seed
        self.timestamps = base.timestamps
        self.poses = base.poses
        self.device = base.device
        h, w = base.height, base.width
        yy, xx = np.mgrid[0:h, 0:w]
        r2 = (((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2) / 2.0
        self._vig = (1.0 - vignette * r2).astype(np.float32)
        self._vig_dev = upload(self._vig, self.device)

    def __len__(self):
        return len(self.base)

    def _blur_kernel(self, i: int):
        if self.blur_px < 1.0 or i == 0:
            return None
        # dominant translation direction projected to the image plane
        R0, t0 = self.base.poses[i - 1]
        R1, t1 = self.base.poses[i]
        d = (-R1.T @ t1) - (-R0.T @ t0)
        dc = R1 @ d  # camera-frame motion
        v = np.array([dc[0], dc[1]])
        n = np.linalg.norm(v)
        v = v / n if n > 1e-9 else np.array([1.0, 0.0])
        L = max(int(round(self.blur_px)), 1)
        k = np.zeros((L * 2 + 1, L * 2 + 1), np.float32)
        for s in np.linspace(-L, L, 2 * L + 1):
            x, y = int(round(L + s * v[0])), int(round(L + s * v[1]))
            k[y, x] += 1.0
        return k / k.sum()

    @torch.no_grad()
    def get(self, i: int):
        img, ts, pose = self.base.get(i)
        out = torch.as_tensor(img).to(self.device).to(torch.float32)
        k = self._blur_kernel(i)
        if k is not None:
            # cv2.filter2D: a correlation, reflect-101 border
            L = k.shape[0] // 2
            padded = F.pad(out[None, None], (L, L, L, L), mode="reflect")
            out = F.conv2d(padded, upload(k, self.device)[None, None])[0, 0]
        if self.vignette > 0:
            out = out * self._vig_dev
        if self.exposure_amp > 0:
            gain = 1.0 + self.exposure_amp * np.sin(2 * np.pi * i / 60.0)
            out = out * np.float32(gain)
        if self.noise_sigma > 0:
            rng = np.random.default_rng(self.seed * 100003 + i)
            noise = rng.normal(0.0, self.noise_sigma, tuple(out.shape))
            out = out.to(torch.float64) + upload(noise, self.device)
        return out.clamp(0, 255).to(torch.uint8), ts, pose


def write_tum_sequence(path: str, seq, n: int | None = None):
    """Write a sequence as a TUM RGB-D directory (rgb.txt + rgb/*.png) and
    return the ground-truth pose dict (keyed by the timestamp rounded to
    6 decimals)."""
    os.makedirs(os.path.join(path, "rgb"), exist_ok=True)
    gt = {}
    lines = ["# color images", "# file: synthetic", "# timestamp filename"]
    for i in range(n or len(seq)):
        img, ts, pose = seq.get(i)
        rel = f"rgb/{ts:.6f}.png"
        png.write_gray(os.path.join(path, rel), torch.as_tensor(img).cpu().numpy())
        lines.append(f"{ts:.6f} {rel}")
        gt[round(float(ts), 6)] = pose
    with open(os.path.join(path, "rgb.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return gt
