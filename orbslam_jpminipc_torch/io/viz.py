"""Visualization: debug frame rendering and map export (counterpart of
orbslam_jpminipc_tpu/io/viz.py), in numpy, without cv2.

Replaces the ROS publishers:
  * FramePublisher (src/FramePublisher.cc): tracked points or the
    initialization's keypoints and a state banner on the current frame
    -> `draw_frame` returns the annotated BGR image;
  * MapPublisher (src/MapPublisher.cc): map points, keyframes, the
    covisibility graph and the spanning tree -> `draw_map_topdown` renders
    an orthographic map view, and `export_ply` writes the point cloud and
    keyframe centres for any 3D viewer.

The reference draws with cv2; the rasterisers here give cv2's pixels for
the calls it makes: `rectangle` (thickness 1 and filled), filled `circle`
of radius 1 and 3, `line` (LINE_8: cv2's Bresenham, major axis stepped,
the minor step taken while the error is negative) and `putText` with
FONT_HERSHEY_PLAIN at scale 1.0, thickness 1. cv2 5.0 renders that font as
antialiased glyphs at integer pen positions, blended one after another;
the glyphs' coverage and advances are a table recorded from cv2 by
tools/make_torch_glyph_table.py (data/glyphs_hershey_plain.npz).
"""
from __future__ import annotations

import functools
import os

import numpy as np

from ..frontend.frame import Frame
from ..frontend.tracking import TrackState
from ..map.map_state import MapState

_GLYPHS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                       "glyphs_hershey_plain.npz")
# filled circles: the half-width of each row from -r to r, as cv2 fills them
_DISCS = {1: (0, 1, 0), 3: (0, 2, 2, 3, 2, 2, 0)}


@functools.lru_cache(maxsize=1)
def _glyph_table() -> dict:
    z = np.load(_GLYPHS)
    table = {}
    for i, code in enumerate(z["codes"]):
        h, w = z["hw"][i]
        o = z["offsets"][i]
        table[chr(int(code))] = (int(z["dy"][i]), int(z["dx"][i]), int(z["advance"][i]),
                                 z["alpha"][o:o + h * w].reshape(h, w).astype(np.int64))
    return table


def put_text(img: np.ndarray, text: str, org, color):
    """cv2.putText(img, text, org, FONT_HERSHEY_PLAIN, 1.0, color, 1): each
    glyph's coverage a blended in turn at the pen position,
    dst = (dst (255 - a) + color a + 127) // 255; characters the table
    lacks are drawn as '?'."""
    table = _glyph_table()
    H, W = img.shape[:2]
    col = np.asarray(color, np.int64)
    x = int(org[0])
    for ch in text:
        dy, dx, adv, a = table.get(ch, table["?"])
        y0, x0 = int(org[1]) + dy, x + dx
        ya, xa = max(y0, 0), max(x0, 0)
        yb, xb = min(y0 + a.shape[0], H), min(x0 + a.shape[1], W)
        if ya < yb and xa < xb:
            cov = a[ya - y0:yb - y0, xa - x0:xb - x0][..., None]
            dst = img[ya:yb, xa:xb].astype(np.int64)
            img[ya:yb, xa:xb] = ((dst * (255 - cov) + col * cov + 127) // 255).astype(img.dtype)
        x += adv


def _set(img, ys, xs, color):
    ys, xs = np.asarray(ys), np.asarray(xs)
    ok = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    img[ys[ok], xs[ok]] = color


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1):
    """cv2.rectangle with thickness 1 (the outline) or -1 (filled)."""
    (x1, y1), (x2, y2) = p1, p2
    x1, x2 = sorted((int(x1), int(x2)))
    y1, y2 = sorted((int(y1), int(y2)))
    if thickness < 0:
        H, W = img.shape[:2]
        img[max(y1, 0):min(y2, H - 1) + 1, max(x1, 0):min(x2, W - 1) + 1] = color
        return
    xs, ys = np.arange(x1, x2 + 1), np.arange(y1, y2 + 1)
    _set(img, np.full_like(xs, y1), xs, color)
    _set(img, np.full_like(xs, y2), xs, color)
    _set(img, ys, np.full_like(ys, x1), color)
    _set(img, ys, np.full_like(ys, x2), color)


def circle(img: np.ndarray, center, radius: int, color):
    """cv2.circle(img, center, radius, color, -1) for radius 1 or 3."""
    cx, cy = int(center[0]), int(center[1])
    for dy, half in zip(range(-radius, radius + 1), _DISCS[radius]):
        xs = np.arange(cx - half, cx + half + 1)
        _set(img, np.full_like(xs, cy + dy), xs, color)


def line(img: np.ndarray, p1, p2, color):
    """cv2.line(img, p1, p2, color, 1) with LINE_8: drawn left to right, the
    major axis stepped every pixel, the minor one while the error is
    negative. Equal to cv2 for segments inside the image (every call here
    draws one); cv2 clips a segment that leaves the image before stepping,
    where this drops the pixels outside."""
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    n = dx + 1
    # err_k = dx - 2 dy - 2 dy k + 2 dx m_k, with m_k the minor steps so far
    xs, ys, err, m = [], [], dx - 2 * dy, 0
    for k in range(n):
        xs.append(k)
        ys.append(m)
        if err < 0:
            err += 2 * dx - 2 * dy
            m += 1
        else:
            err -= 2 * dy
    major, minor = np.array(xs), np.array(ys)
    if steep:
        _set(img, y1 + sy * major, x1 + minor, color)
    else:
        _set(img, y1 + sy * minor, x1 + major, color)


def draw_frame(image: np.ndarray, frame: Frame, state: TrackState,
               n_kf: int = 0, n_mp: int = 0) -> np.ndarray:
    """Annotated tracking image (FramePublisher::DrawFrame :60-150)."""
    image = image.astype(np.uint8)
    vis = np.repeat(image[..., None], 3, axis=2)          # GRAY2BGR
    n_tracked = 0
    if state == TrackState.WORKING and frame.point is not None:
        sel = (frame.point >= 0) & ~frame.outlier
        n_tracked = int(sel.sum())
        for x, y in frame.xy[sel].astype(int):
            rectangle(vis, (x - 3, y - 3), (x + 3, y + 3), (0, 255, 0), 1)
            circle(vis, (x, y), 1, (0, 255, 0))
    elif frame.valid is not None:
        for x, y in frame.xy[frame.valid].astype(int):
            circle(vis, (x, y), 1, (200, 200, 200))

    # state banner (FramePublisher::DrawTextInfo :155-188)
    banners = {
        TrackState.NO_IMAGES_YET: "WAITING FOR IMAGES",
        TrackState.NOT_INITIALIZED: "TRYING TO INITIALIZE",
        TrackState.INITIALIZING: "TRYING TO INITIALIZE",
        TrackState.WORKING: f"SLAM ON | KFs: {n_kf} | MPs: {n_mp} | tracked: {n_tracked}",
        TrackState.LOST: "TRACK LOST - RELOCALIZING",
    }
    txt = banners.get(state, "")
    h = vis.shape[0]
    rectangle(vis, (0, h - 22), (vis.shape[1], h), (0, 0, 0), -1)
    put_text(vis, txt, (6, h - 6), (255, 255, 255))
    return vis


def draw_map_topdown(state: MapState, size: int = 640, pad: float = 0.1,
                     covis_weight: int = 15) -> np.ndarray:
    """Orthographic x-z map view: points, keyframes, covisibility graph
    (weight >= 15) and spanning tree, the marker set of the reference's
    MapPublisher (src/MapPublisher.cc:29-117)."""
    vis = np.full((size, size, 3), 255, np.uint8)
    pts = state.mp_xyz[state.mp_valid]
    kfs = np.nonzero(state.kf_valid)[0]
    if len(pts) == 0 and len(kfs) == 0:
        return vis
    centers = np.stack(
        [-state.kf_R[k].T @ state.kf_t[k] for k in kfs]
    ) if len(kfs) else np.zeros((0, 3))
    allxz = np.concatenate([pts[:, [0, 2]], centers[:, [0, 2]]]) if len(pts) else centers[:, [0, 2]]
    lo = allxz.min(0) - pad
    hi = allxz.max(0) + pad
    scale = (size - 1) / max((hi - lo).max(), 1e-6)

    def to_px(xz):
        p = (xz - lo) * scale
        return int(p[0]), size - 1 - int(p[1])

    for p in pts:
        circle(vis, to_px(p[[0, 2]]), 1, (80, 80, 80))
    # covisibility-graph edges (weight >= covis_weight)
    kf_index = {int(k): i for i, k in enumerate(kfs)}
    covis = state.covisibility()
    for i, k in enumerate(kfs):
        for n in np.nonzero(covis[k] >= covis_weight)[0]:
            j = kf_index.get(int(n))
            if j is None or j <= i:
                continue
            line(vis, to_px(centers[i][[0, 2]]), to_px(centers[j][[0, 2]]), (120, 220, 120))
    # spanning tree edges
    for k in kfs:
        parent = state.kf_parent[k]
        if parent >= 0 and state.kf_valid[parent]:
            c1 = -state.kf_R[k].T @ state.kf_t[k]
            c2 = -state.kf_R[parent].T @ state.kf_t[parent]
            line(vis, to_px(c1[[0, 2]]), to_px(c2[[0, 2]]), (180, 120, 0))
    for i, k in enumerate(kfs):
        color = (0, 0, 255) if i == len(kfs) - 1 else (255, 0, 0)
        circle(vis, to_px(centers[i][[0, 2]]), 3, color)
    return vis


def export_ply(path: str, state: MapState):
    """Point cloud + keyframe centers as a PLY (any 3D viewer)."""
    pts = state.mp_xyz[state.mp_valid]
    kfs = np.nonzero(state.kf_valid)[0]
    centers = np.stack(
        [-state.kf_R[k].T @ state.kf_t[k] for k in kfs]
    ) if len(kfs) else np.zeros((0, 3))
    n = len(pts) + len(centers)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p in pts:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} 120 120 120\n")
        for c in centers:
            f.write(f"{c[0]:.5f} {c[1]:.5f} {c[2]:.5f} 255 0 0\n")
