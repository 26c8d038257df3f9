"""The port's debug drawing and map export (io/viz.py, numpy) against the
JAX package's (io/viz.py, cv2) on the same inputs.

A port `Slam` runs over the first frames of the system fixture's `xyz`
sequence (small widths, as tests/test_torch_slam.py); the reference's
`draw_frame`, `draw_map_topdown` and `export_ply`, which only read arrays,
are handed the port's frame, map and state. Held, pixel for pixel: the
tracked frame (green boxes and dots, the "SLAM ON | ..." banner), a frame
drawn in the other states (grey dots, the other banners), the top-down map
(points, covisibility and spanning-tree lines, keyframes), cv2's
rectangles, filled circles and lines on random shapes, and cv2's text on
random strings (the glyph table of tools/make_torch_glyph_table.py). The
PLY text is equal. `run.py --viz DIR` writes frame.png and map.png that
cv2 reads back equal to the drawn arrays."""
import os

import cv2
import numpy as np
import pytest
import torch

from orbslam_jpminipc_tpu.frontend.tracking import TrackState as JTrackState
from orbslam_jpminipc_tpu.io import viz as jviz
from orbslam_jpminipc_torch import run
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend.tracking import TrackState
from orbslam_jpminipc_torch.io import viz as tviz
from orbslam_jpminipc_torch.pipeline.system import Slam

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLAM_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "slam_fixture_xyz.npz")
CFG_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=600, max_kf=64,
              max_mp=8192, local_ba_obs=8192, pipelined_tracking=False, async_mapping=False)


@pytest.fixture(scope="module")
def system():
    fx = np.load(SLAM_FIXTURE)
    slam = Slam(SlamConfig(**CFG_KW), vocab=None, device="cpu")
    images = fx["images"][:8]
    out = []
    for img, ts in zip(images, fx["timestamps"][:8]):
        out.append(slam.process(img, float(ts)))
    return slam, images, out


def _equal(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = np.nonzero(np.any(got != ref, axis=-1))
    assert len(diff[0]) == 0, f"{len(diff[0])} pixels differ, first at {diff[0][:5], diff[1][:5]}"


def test_draw_frame_tracked_equal(system):
    slam, images, out = system
    state, frame = out[-1]
    assert state == TrackState.WORKING and (frame.point >= 0).sum() > 50
    got = tviz.draw_frame(images[-1], frame, state, slam.n_keyframes, slam.n_points)
    ref = jviz.draw_frame(images[-1], frame, JTrackState(state.value), slam.n_keyframes,
                          slam.n_points)
    _equal(got, ref)


@pytest.mark.parametrize("state", list(TrackState))
def test_draw_frame_every_state_equal(system, state):
    slam, images, out = system
    frame = out[0][1]
    got = tviz.draw_frame(images[0], frame, state, 7, 1234)
    ref = jviz.draw_frame(images[0], frame, JTrackState(state.value), 7, 1234)
    _equal(got, ref)


def test_draw_map_topdown_equal(system):
    slam = system[0]
    assert slam.n_keyframes >= 3
    for size in (640, 301):
        _equal(tviz.draw_map_topdown(slam.map, size=size), jviz.draw_map_topdown(slam.map, size=size))


def test_export_ply_text_equal(system, tmp_path):
    slam = system[0]
    tviz.export_ply(str(tmp_path / "t.ply"), slam.map)
    jviz.export_ply(str(tmp_path / "j.ply"), slam.map)
    assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()


def test_shapes_and_text_equal_cv2():
    rng = np.random.default_rng(0)
    got = np.zeros((120, 160, 3), np.uint8)
    ref = got.copy()
    for _ in range(300):
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        p1 = tuple(int(v) for v in rng.integers(-10, 170, 2))
        p2 = tuple(int(v) for v in rng.integers(-10, 170, 2))
        kind = rng.integers(0, 4)
        if kind == 0:
            # inside the image: cv2 clips a segment that leaves it before
            # stepping (clipLine), the port drops the pixels outside; no
            # call of the reference draws a line that leaves its image
            p1, p2 = (p1[0] % 160, p1[1] % 120), (p2[0] % 160, p2[1] % 120)
            tviz.line(got, p1, p2, color)
            cv2.line(ref, p1, p2, color, 1)
        elif kind == 1:
            th = int(rng.choice([1, -1]))
            tviz.rectangle(got, p1, p2, color, th)
            cv2.rectangle(ref, p1, p2, color, th)
        else:
            r = int(rng.choice([1, 3]))
            tviz.circle(got, p1, r, color)
            cv2.circle(ref, p1, r, color, -1)
    _equal(got, ref)
    chars = [chr(c) for c in range(32, 127)]
    for k in range(10):
        text = "".join(rng.choice(chars, 40))
        got = np.full((30, 420, 3), 255 * (k % 2), np.uint8)
        got[:, :, 1] = 37
        ref = got.copy()
        tviz.put_text(got, text, (6, 22), (255, 255, 255))
        cv2.putText(ref, text, (6, 22), cv2.FONT_HERSHEY_PLAIN, 1.0, (255, 255, 255), 1)
        _equal(got, ref)


def test_run_viz_writes_pngs(tmp_path, monkeypatch):
    drawn = {}
    draw_frame, draw_map = tviz.draw_frame, tviz.draw_map_topdown
    monkeypatch.setattr(tviz, "draw_frame",
                        lambda *a, **k: drawn.__setitem__("frame", draw_frame(*a, **k)) or drawn["frame"])
    monkeypatch.setattr(tviz, "draw_map_topdown",
                        lambda *a, **k: drawn.__setitem__("map", draw_map(*a, **k)) or drawn["map"])
    d = tmp_path / "viz"
    run.main(["--dataset", "synthetic:forward", "--frames", "3", "--n-features", "300",
              "--device", "cpu", "--out", str(tmp_path / "kf.txt"), "--viz", str(d)])
    for name in ("frame", "map"):
        back = cv2.imread(str(d / f"{name}.png"), cv2.IMREAD_COLOR)
        _equal(back, drawn[name])
    assert drawn["frame"].shape == (480, 640, 3) and drawn["map"].shape == (640, 640, 3)
