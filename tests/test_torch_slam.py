"""PyTorch port vs the JAX package: the whole sequential system.

Both `Slam`s are built by the default constructor call, `Slam(cfg,
vocab=v)` (a 1024-word vocabulary; loop closing on, so every keyframe is
searched for a loop after its mapping stages), and run over the first 12
frames of the system fixture's synthetic `xyz` sequence at small widths
(`n_features=600`, `max_kf=64`, `max_mp=8192`) with synchronous tracking
and mapping. Neither closes a loop on these frames. The reference draws
its RANSAC minimal sets with `jax.random`; the port replays the sets that
the reference drew (recorded by the fixture generator's wrapper).

Tolerances: per-frame tracking states and keyframe counts equal, point
counts within 1 %, camera centres within 1e-3 of the reference's (the map's
median depth is 1), the keyframe trajectory after `finish()` within 1e-3,
and its ATE against ground truth at most the reference's plus 1 mm.
Measured on the CPU: states and counts identical, centres within 3e-6.

`Slam._loop_close` itself is driven on a `Slam` whose map is the small
constructed loop of tools/loop_scene.py: it closes the loop on the
reference's keyframe, forces a relocalization, and with `post_loop_gba`
runs global BA; `reset()` rewires the closer.
"""
import ast
import importlib.util
import os
import re

import sys

import numpy as np
import pytest
import torch

from orbslam_jpminipc_tpu.vocab.vocabulary import build_vocabulary
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend.tracking import TrackState
from orbslam_jpminipc_torch.map.map_state import MapState
from orbslam_jpminipc_torch.pipeline.loop_closing import LoopCloser
from orbslam_jpminipc_torch.pipeline.system import Slam
from orbslam_jpminipc_torch.utils.tracing import get_tracer
from orbslam_jpminipc_torch.vocab.vocabulary import vocab_from_numpy

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


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _generator():
    return _tool("make_torch_slam_fixture")


@pytest.fixture(scope="module")
def jax_vocab():
    return build_vocabulary(np.random.default_rng(0).integers(0, 256, (20000, 32)).astype(np.uint8),
                            n_words=1024, iters=3)


def _centre(R, t):
    return -R.T @ t


@pytest.fixture(scope="module")
def runs(jax_vocab):
    gen = _generator()
    fx = np.load(SLAM_FIXTURE)
    images, ts = fx["images"][:N_FRAMES], fx["timestamps"][:N_FRAMES]
    ref, jslam = gen.run_reference(CFG_KW, images, ts, vocab=jax_vocab)
    ref["kf"] = gen.keyframe_arrays(jslam)
    ref["n_keyframes"], ref["n_points"] = jslam.n_keyframes, jslam.n_points
    ref["n_loops_closed"], ref["has_closer"] = jslam.n_loops_closed, jslam.loop_closer is not None

    # the default constructor call: loop closing on
    slam = Slam(SlamConfig(**CFG_KW), vocab=vocab_from_numpy(jax_vocab, device="cpu"), device="cpu")
    get_tracer().reset()
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
    got["n_loops_closed"], got["closer"] = slam.n_loops_closed, slam.loop_closer
    got["stages"] = get_tracer().summary()
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


def test_default_constructor_runs_loop_closing_and_closes_no_loop_like_jax(runs):
    """`Slam(cfg, vocab=v)` builds the closer, searches every keyframe
    that went through mapping for a loop, and closes none: 0 in both."""
    ref, got, _, _ = runs
    assert ref["has_closer"] and isinstance(got["closer"], LoopCloser)
    assert got["n_loops_closed"] == ref["n_loops_closed"] == 0
    # the two initial keyframes are made outside the mapper
    n = got["n_keyframes"] - 2
    assert got["stages"]["loop_closing"]["count"] == got["stages"]["loop_detect"]["count"] >= n > 0


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
def test_unported_options_are_refused(override, jax_vocab):
    """Neither option is refused any more. Pipelined tracking, the default:
    `Slam(SlamConfig(...))` constructs on the CPU with nothing in flight
    (tests/test_torch_pipelined.py drives it). Loop closing (asked for by
    giving a vocabulary without `enable_loop_closing=False`): the default
    call builds a closer wired to the mapper's mirror, without a vocabulary
    there is none, and without a card the call fails on the device, not on
    loop closing."""
    kw = dict(CFG_KW)
    if override != "loop_closing":
        kw.update(override)
        assert SlamConfig().pipelined_tracking   # the default
        slam = Slam(SlamConfig(**kw), device="cpu")
        assert slam.cfg.pipelined_tracking and len(slam._inflight) == 0
        assert slam.process(np.zeros((480, 640), np.uint8))[0] == TrackState.NOT_INITIALIZED
        assert len(slam._inflight) == 0
        return
    vocab = vocab_from_numpy(jax_vocab, device="cpu")
    slam = Slam(SlamConfig(**kw), vocab=vocab, device="cpu")     # the default asks for it
    assert isinstance(slam.loop_closer, LoopCloser) and slam.loop_closer.dmap is slam.mapper.dmap
    assert slam.loop_closer.map is slam.map and slam.n_loops_closed == 0
    assert Slam(SlamConfig(**kw), vocab=vocab, enable_loop_closing=False,
                device="cpu").loop_closer is None
    no_vocab = Slam(SlamConfig(**kw), enable_loop_closing=True, device="cpu")
    assert no_vocab.kfdb is None and no_vocab.loop_closer is None
    # the default allocation is fine with the default `distributed_gba=True`
    assert SlamConfig(**kw).distributed_gba
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Slam(SlamConfig(**kw), vocab=vocab)


@pytest.mark.parametrize("post_loop_gba", [False, True])
def test_loop_close_on_a_constructed_loop_corrects_the_map(post_loop_gba):
    """A default `Slam` whose map is the small constructed loop:
    `_loop_close` over the tail closes it on the reference's keyframe (8,
    with keyframe 0), forces a relocalization, refreshes the mirror, and
    with `post_loop_gba` runs global BA; `reset()` rewires the closer."""
    loop_scene = _tool("loop_scene")
    st, info = loop_scene.build_loop_scene(MapState, "small", 0, device="cpu")
    vocab = vocab_from_numpy(build_vocabulary(info["vocab_descriptors"], n_words=256, iters=3,
                                              seed=0), device="cpu")
    cfg = SlamConfig(**dict(info["cfg"], post_loop_gba=post_loop_gba, gba_obs=4096))
    slam = Slam(cfg, vocab=vocab, device="cpu")
    st2 = MapState.create(cfg.max_kf, cfg.max_mp, 2 * cfg.n_features, cfg.max_obs, device="cpu")
    # the scene at the capacities this Slam allocates
    for name in ("kf_xy", "kf_level", "kf_angle", "kf_desc", "kf_feat_valid", "kf_point"):
        getattr(st2, name)[:, :st.n_feat] = getattr(st, name)
    for name in ("mp_obs_kf", "mp_obs_feat"):
        getattr(st2, name)[:, :st.max_obs] = getattr(st, name)
    for name in ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_timestamp", "kf_parent", "mp_xyz",
                 "mp_valid", "mp_desc", "mp_ref_kf", "mp_first_kf"):
        getattr(st2, name)[:] = getattr(st, name)
    st2.next_kf_id, st2.next_mp_id = st.next_kf_id, st.next_mp_id
    slam.map = slam.tracker.map = slam.mapper.map = slam.loop_closer.map = st2
    dm = slam.mapper.dmap
    dm.sync_all(st2)
    loop_scene.finish_scene(st2, info, slam.kfdb,
                            lambda ids: st2.update_point_attributes(ids, cfg.scale_factors, dm))
    slam.tracker.state = TrackState.WORKING
    tracer = get_tracer()
    tracer.reset()
    version = dm.version
    before = loop_scene.camera_centres(st2)[:9].copy()
    closed_on = []
    for k in info["tail"]:
        slam._loop_close(k)
        if slam.n_loops_closed:
            closed_on.append(k)
            break
    assert closed_on == [8] and st2.kf_loop_edges[8] == {0} and slam.n_loops_closed == 1
    assert slam.tracker.state == TrackState.LOST and slam.tracker.velocity is None
    assert dm.version > version
    np.testing.assert_array_equal(dm.kf_t.numpy(), st2.kf_t)
    np.testing.assert_array_equal(dm.mp_xyz.numpy(), st2.mp_xyz)
    after = loop_scene.camera_centres(st2)[:9]
    true_c = info["true_centres"]
    assert (np.linalg.norm(after[5:] - true_c[5:], axis=1)
            < 0.55 * np.linalg.norm(before[5:] - true_c[5:], axis=1)).all()
    stages = tracer.summary()
    assert stages["loop_closing"]["count"] == 4 and stages["loop_essential_graph"]["count"] == 1
    assert ("global_ba" in stages) is post_loop_gba
    assert np.isfinite(st2.kf_t[st2.kf_valid]).all() and np.isfinite(st2.mp_xyz[st2.mp_valid]).all()
    if not post_loop_gba:
        # by hand: the gauge keyframe (the oldest) stays, the others move
        t0 = st2.kf_t.copy()
        res = slam.global_ba(iterations=3)
        assert res is not None and np.isfinite(float(res.chi2))
        np.testing.assert_array_equal(st2.kf_t[0], t0[0])
        assert np.abs(st2.kf_t[1:9] - t0[1:9]).max() > 0
    old_closer = slam.loop_closer
    slam.reset()
    assert slam.loop_closer is old_closer and old_closer.map is slam.map is not st2
    # the one mirror, emptied in place (its captured programs read its tensors)
    assert old_closer.dmap is slam.mapper.dmap is dm and old_closer.consistent_groups == []
    assert not dm.mp_valid.any() and not dm.kf_t.any() and not dm.kf_feat_valid.any()
    assert slam.n_keyframes == 0 and slam.pending == []


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
