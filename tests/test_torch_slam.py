"""PyTorch port vs the JAX package: the whole sequential system.

Both `Slam`s run over the first 12 frames of the system fixture's
synthetic `xyz` sequence at small widths (`n_features=600`, `max_kf=64`,
`max_mp=8192`) with synchronous tracking and mapping. The reference draws
its RANSAC minimal sets with `jax.random`; the port replays the sets that
the reference drew (recorded by the fixture generator's wrapper).

Tolerances: per-frame tracking states and keyframe counts equal, point
counts within 1 %, camera centres within 1e-3 of the reference's (the map's
median depth is 1), the keyframe trajectory after `finish()` within 1e-3,
and its ATE against ground truth at most the reference's plus 1 mm.
Measured on the CPU: states and counts identical, centres within 3e-6.
"""
import ast
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend.tracking import TrackState
from orbslam_jpminipc_torch.pipeline.system import Slam

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "orbslam_jpminipc_torch")
SLAM_FIXTURE = os.path.join(PACKAGE, "data", "slam_fixture_xyz.npz")
N_FRAMES = 12
CFG_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=600, max_kf=64,
              max_mp=8192, local_ba_obs=8192, pipelined_tracking=False, async_mapping=False)
CENTRE_TOL = 1e-3
POINTS_REL = 0.01
ATE_MARGIN = 1e-3


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_torch_slam_fixture", os.path.join(REPO, "tools", "make_torch_slam_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _centre(R, t):
    return -R.T @ t


@pytest.fixture(scope="module")
def runs():
    gen = _generator()
    fx = np.load(SLAM_FIXTURE)
    images, ts = fx["images"][:N_FRAMES], fx["timestamps"][:N_FRAMES]
    ref, jslam = gen.run_reference(CFG_KW, images, ts)
    ref["kf"] = gen.keyframe_arrays(jslam)
    ref["n_keyframes"], ref["n_points"] = jslam.n_keyframes, jslam.n_points

    slam = Slam(SlamConfig(**CFG_KW), device="cpu")
    sets = iter(torch.from_numpy(s) for s in ref["init_sets"])
    slam.tracker.sampler = lambda mask, n_hyp: next(sets)
    got = dict(states=[], poses=[], nkf=[], npt=[])
    for img, t in zip(images, ts):
        state, frame = slam.process(img, float(t))
        got["states"].append(state.value)
        pose = np.full((3, 4), np.nan, np.float32)
        if frame is not None and frame.R is not None:
            pose[:, :3], pose[:, 3] = frame.R, frame.t
        got["poses"].append(pose)
        got["nkf"].append(slam.n_keyframes)
        got["npt"].append(slam.n_points)
    slam.finish()
    got["kf"] = gen.keyframe_arrays(slam)
    got["n_keyframes"], got["n_points"] = slam.n_keyframes, slam.n_points
    got["unused_sets"] = sum(1 for _ in sets)
    gt = (fx["timestamps"], fx["gt_R"], fx["gt_t"])
    return ref, got, gen, gt


def test_states_match_per_frame(runs):
    ref, got, _, _ = runs
    assert got["states"] == ref["states"].tolist()
    assert got["states"][-1] == TrackState.WORKING.value
    assert got["unused_sets"] == 0  # the port made as many attempts


def test_keyframe_and_point_counts_match_per_frame(runs):
    ref, got, _, _ = runs
    assert got["nkf"] == ref["n_keyframes_per_frame"].tolist()
    npt, rpt = np.array(got["npt"]), ref["n_points_per_frame"]
    assert np.all(np.abs(npt - rpt) <= POINTS_REL * rpt), (npt, rpt)
    assert got["n_keyframes"] == ref["n_keyframes"] >= 5


def test_camera_centres_match_per_frame(runs):
    ref, got, _, _ = runs
    poses = np.stack(got["poses"])
    has = ~np.isnan(ref["poses"][:, 0, 0])
    np.testing.assert_array_equal(~np.isnan(poses[:, 0, 0]), has)
    for g, r in zip(poses[has], ref["poses"][has]):
        np.testing.assert_allclose(_centre(g[:, :3], g[:, 3]), _centre(r[:, :3], r[:, 3]),
                                   atol=CENTRE_TOL)


def test_keyframe_trajectory_after_finish(runs):
    ref, got, gen, gt = runs
    (rts, rR, rt), (gts, gR, gtt) = ref["kf"], got["kf"]
    np.testing.assert_array_equal(gts, rts)
    for a, b, c, d in zip(gR, gtt, rR, rt):
        np.testing.assert_allclose(_centre(a, b), _centre(c, d), atol=CENTRE_TOL)
    ate_ref = gen.keyframe_ate(rts, rR, rt, *gt)
    ate_got = gen.keyframe_ate(gts, gR, gtt, *gt)
    assert ate_got <= ate_ref + ATE_MARGIN, (ate_got, ate_ref)


def _sources():
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_package_sources_import_neither_jax_nor_cv2():
    """Parse every module of the port and `chip_smoke.py`: no import of
    jax, cv2 or the JAX package, at any depth (function bodies included),
    and no string literal that is a path into the JAX package (its data
    directory included: the port keeps its own copies)."""
    banned = ("jax", "jaxlib", "cv2", "orbslam_jpminipc_tpu")
    n = 0
    for path in list(_sources()) + [os.path.join(REPO, "chip_smoke.py")]:
        tree = ast.parse(open(path).read(), filename=path)
        docstrings = {id(b.body[0].value) for b in ast.walk(tree)
                      if isinstance(b, (ast.Module, ast.FunctionDef, ast.ClassDef))
                      and b.body and isinstance(b.body[0], ast.Expr)
                      and isinstance(b.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docstrings):
                # docstrings name the counterpart file, and a `file.py:line`
                # citation is no path to open; anything else would be one
                text = re.sub(r"orbslam_jpminipc_tpu/[\w/]+\.py:\d+", "", node.value)
                assert "orbslam_jpminipc_tpu" not in text, \
                    f"{path}:{node.lineno}: a path into the JAX package"
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
        n += 1
    assert n > 30


@pytest.mark.parametrize("override", [dict(pipelined_tracking=True), "loop_closing"])
def test_unported_options_are_refused(override):
    """Pipelined tracking, and loop closing (asked for by giving a
    vocabulary without `enable_loop_closing=False`), are refused; a
    vocabulary with loop closing off, and asynchronous mapping, are not."""
    kw = dict(CFG_KW)
    extra = {}
    if override == "loop_closing":
        extra = dict(vocab=object(), enable_loop_closing=True)
    else:
        kw.update(override)
    with pytest.raises(ValueError):
        Slam(SlamConfig(**kw), device="cpu", **extra)
    if override == "loop_closing":
        with pytest.raises(ValueError, match="loop closing"):
            Slam(SlamConfig(**kw), vocab=object(), device="cpu")  # the default asks for it
        assert Slam(SlamConfig(**kw), enable_loop_closing=True, device="cpu").kfdb is None


def test_blank_frames_never_initialize_and_reset_clears():
    """All-black frames: no features, no map, no crash; `reset()` leaves an
    empty map that a next frame starts from."""
    slam = Slam(SlamConfig(**CFG_KW), device="cpu")
    blank = np.zeros((480, 640), np.uint8)
    for i in range(3):
        state, _ = slam.process(blank, 0.1 * i)
        assert state in (TrackState.NOT_INITIALIZED, TrackState.INITIALIZING)
    assert slam.n_keyframes == 0 and slam.n_points == 0 and slam.trajectory == []
    slam.reset()
    assert slam.tracker.state == TrackState.NOT_INITIALIZED
    state, _ = slam.process(blank, 1.0)
    assert state in (TrackState.NOT_INITIALIZED, TrackState.INITIALIZING)
    assert slam.keyframe_trajectory() == []
