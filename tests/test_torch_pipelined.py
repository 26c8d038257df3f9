"""PyTorch port vs the JAX package: pipelined tracking, the packages' default
frame loop (`cfg.pipelined_tracking=True`).

Both `Slam`s run frames 0-15 of the system fixture's synthetic `xyz`
sequence at small widths (`n_features=600`, `max_kf=64`, `max_mp=8192`,
synchronous mapping, no vocabulary) with a noise frame
(`np.random.default_rng(7)`, as warmup draws it) after frame 6. A fused
frame's step is dispatched and its host half runs when its read has landed,
up to `pipeline_depth` frames later, so `process` returns the most recently
completed frame. Completion is made deterministic on both sides, in this
file only: every tracking read reports "not landed" until it is taken (the
JAX package's `utils/pull.pull_pool("track")`, the port's
`tracking.fetch_async`), so a record completes only when the queue forces
it, and both packages' monotonic clocks are frozen (the 0.15 s head-age
test never fires). The noise frame goes LOST when it completes; the map
then holds 5 keyframes, so the system resets, and the record dispatched
after the noise frame, against the pre-reset state, is tracked again on the
host path (`reprocess_stale`); the system initializes again. The port
replays the reference's initialization minimal sets.

Tolerances, as tests/test_torch_slam.py's: for every `process` call the
completed frame's id, its state and the keyframe count equal, points within
1 %, camera centres within 1e-3 (the map's median depth is 1); the queue's
depth at every drain and the count of stale records equal. Measured on the
CPU: all equal, centres within 4.8e-4, points within one. The file takes
about two and a half minutes on the CPU.

The pipelined step on the card (one chain whose branches the device
decides, utils/graph_chain.py) is held to the synchronous step by a
`gpu`-marked test in tests/test_torch_graphs.py, which imports no JAX.
"""
import importlib.util
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

from orbslam_jpminipc_tpu.frontend import tracking as jtracking
from orbslam_jpminipc_tpu.pipeline import system as jsystem
from orbslam_jpminipc_tpu.solvers import initializer as jinitializer
from orbslam_jpminipc_tpu.utils import pull as jpull
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend import tracking as ptracking
from orbslam_jpminipc_torch.frontend.tracking import TrackState
from orbslam_jpminipc_torch.io.checkpoint import load_slam, save_slam
from orbslam_jpminipc_torch.pipeline import system as psystem

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "orbslam_jpminipc_torch", "data")
SLAM_FIXTURE = os.path.join(DATA, "slam_fixture_xyz.npz")
N_FRAMES = 16
NOISE_AT = 7      # the noise frame is the 8th frame submitted
CFG_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=600, max_kf=64,
              max_mp=8192, local_ba_obs=8192, pipelined_tracking=True, async_mapping=False)
CENTRE_TOL = 1e-3
POINTS_REL = 0.01


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _frames():
    """The fixture's first frames with the noise frame inserted."""
    fx = np.load(SLAM_FIXTURE)
    images, ts = list(fx["images"][:N_FRAMES]), [float(t) for t in fx["timestamps"][:N_FRAMES]]
    noise = np.random.default_rng(7).integers(0, 256, (480, 640)).astype(np.uint8)
    images.insert(NOISE_AT, noise)
    ts.insert(NOISE_AT, 0.5 * (ts[NOISE_AT - 1] + ts[NOISE_AT]))
    return images, ts


class _Late:
    """A read that reports "not landed" until it is taken."""

    def __init__(self, take):
        self._take = take
        self._value = None

    def done(self):
        return False

    def result(self):
        if self._value is None:
            self._value = (self._take(),)
        return self._value[0]


class _LatePool:
    def submit(self, tree):
        return _Late(lambda: jax.device_get(tree))


def _deterministic(mp):
    """Late reads and frozen clocks on both sides; queue depths and stale
    records counted by package."""
    real_pool, real_fetch = jpull.pull_pool, ptracking.fetch_async
    mp.setattr(jpull, "pull_pool",
               lambda name="track": _LatePool() if name == "track" else real_pool(name))
    mp.setattr(ptracking, "fetch_async", lambda *t: _Late(real_fetch(*t).result))
    mp.setattr(time, "monotonic", lambda: 0.0)   # the JAX system reads time.monotonic
    for mod in (jtracking, ptracking, psystem):
        mp.setattr(mod, "_monotonic", lambda: 0.0)
    log = {"jax": {"depths": [], "stale": 0}, "port": {"depths": [], "stale": 0}}
    for name, sys_mod, tr_mod in (("jax", jsystem, jtracking), ("port", psystem, ptracking)):
        drain, stale = sys_mod.Slam._drain_inflight, tr_mod.Tracker.reprocess_stale

        def counted_drain(self, force=False, drain_all=False, _d=drain, _n=name):
            log[_n]["depths"].append(len(self._inflight))
            return _d(self, force, drain_all)

        def counted_stale(self, rec, _s=stale, _n=name):
            log[_n]["stale"] += 1
            return _s(self, rec)

        mp.setattr(sys_mod.Slam, "_drain_inflight", counted_drain)
        mp.setattr(tr_mod.Tracker, "reprocess_stale", counted_stale)
    return log


def _drive(slam, images, ts):
    out = dict(ids=[], states=[], poses=[], nkf=[], npt=[])
    for img, t in zip(images, ts):
        state, frame = slam.process(img, t)
        out["ids"].append(-1 if frame is None else int(frame.frame_id))
        out["states"].append(state.value)
        pose = np.full((3, 4), np.nan, np.float32)
        if frame is not None and frame.R is not None:
            pose[:, :3], pose[:, 3] = frame.R, frame.t
        out["poses"].append(pose)
        out["nkf"].append(slam.n_keyframes)
        out["npt"].append(slam.n_points)
    slam.finish()
    out["trajectory_ts"] = [ts_ for ts_, _, _ in slam.trajectory]
    out["inflight_after_finish"] = len(slam._inflight)
    return out


@pytest.fixture(scope="module")
def runs():
    from orbslam_jpminipc_tpu.config import SlamConfig as JaxConfig

    gen = _tool("make_torch_slam_fixture")
    images, ts = _frames()
    with pytest.MonkeyPatch.context() as mp:
        log = _deterministic(mp)
        attempts = []
        orig = gen.record_init_sets(jtracking, jinitializer, attempts)
        try:
            ref = _drive(jsystem.Slam(JaxConfig(**CFG_KW), vocab=None), images, ts)
        finally:
            jtracking._init_attempt = orig
        slam = psystem.Slam(SlamConfig(**CFG_KW), vocab=None, device="cpu")
        sets = iter(torch.from_numpy(np.array(s)) for s in attempts)
        slam.tracker.sampler = lambda mask, n_hyp: next(sets)
        got = _drive(slam, images, ts)
        got["unused_sets"] = sum(1 for _ in sets)
    return ref, got, log


def test_completed_frames_and_states_match_per_call(runs):
    ref, got, _ = runs
    assert got["ids"] == ref["ids"]
    assert got["states"] == ref["states"]
    assert got["unused_sets"] == 0   # the port made as many initialization attempts
    # pipelined: some calls return an earlier frame than the one submitted
    assert any(i != k for k, i in enumerate(got["ids"]) if i >= 0)
    # the noise frame went LOST, the system initialized again and works
    assert TrackState.LOST.value in got["states"]
    assert got["states"][-1] == TrackState.WORKING.value


def test_keyframe_and_point_counts_match_per_call(runs):
    ref, got, _ = runs
    assert got["nkf"] == ref["nkf"]
    npt, rpt = np.array(got["npt"]), np.array(ref["npt"])
    assert np.all(np.abs(npt - rpt) <= POINTS_REL * rpt), (npt, rpt)


def test_camera_centres_match_per_call(runs):
    ref, got, _ = runs
    poses, rposes = np.stack(got["poses"]), np.stack(ref["poses"])
    has = ~np.isnan(rposes[:, 0, 0])
    np.testing.assert_array_equal(~np.isnan(poses[:, 0, 0]), has)
    centre = lambda p: -p[:, :3].T @ p[:, 3]
    for g, r in zip(poses[has], rposes[has]):
        np.testing.assert_allclose(centre(g), centre(r), atol=CENTRE_TOL)


def test_queue_depth_and_stale_records_match(runs):
    _, _, log = runs
    assert log["port"]["depths"] == log["jax"]["depths"]
    assert max(log["port"]["depths"]) >= 2
    assert log["port"]["stale"] == log["jax"]["stale"] >= 1


def test_trajectory_in_frame_order_after_finish(runs):
    ref, got, _ = runs
    for run in (ref, got):
        assert run["inflight_after_finish"] == 0
        assert run["trajectory_ts"] == sorted(run["trajectory_ts"])
    assert got["trajectory_ts"] == ref["trajectory_ts"]


# ---- the record machinery, port only ---------------------------------------

@pytest.fixture
def midrun(monkeypatch):
    """A pipelined port `Slam` over the first 7 fixture frames, late reads:
    WORKING with records in flight."""
    real_fetch = ptracking.fetch_async
    monkeypatch.setattr(ptracking, "fetch_async", lambda *t: _Late(real_fetch(*t).result))
    images, ts = _frames()
    slam = psystem.Slam(SlamConfig(**CFG_KW), vocab=None, device="cpu")
    for img, t in zip(images[:NOISE_AT], ts[:NOISE_AT]):
        slam.process(img, t)
    assert slam.tracker.state == TrackState.WORKING and len(slam._inflight) >= 1
    return slam, images, ts


def test_completion_binds_to_the_dispatch_time_slice(midrun):
    """A slice refreshed between a record's dispatch and its completion:
    the record's bindings go to the slice rows it was dispatched with."""
    slam, images, ts = midrun
    tr = slam.tracker
    slam._drain_inflight(drain_all=True)
    slam.process(images[NOISE_AT + 1], ts[NOISE_AT + 1])
    rec = slam._inflight[-1]
    # the map changes under the record (its first 10 slice points culled)
    # and the slice is refreshed: every later row moves up by 10
    slam.map.mp_valid[rec.slice_ids[:10]] = False
    tr.__dict__.pop("_slice_key", None)
    tr.refresh_fused_slice()
    new_ids = tr.fused.slice_ids
    np.testing.assert_array_equal(new_ids, rec.slice_ids[10:])
    bind = rec.future.result()[3]
    tr.on_new_keyframe = lambda frame: None    # keep the frame's bindings as completed
    _, frame = tr.fused_complete(rec)
    bound = frame.point >= 0
    assert bound.sum() >= 30
    slot = bind[bound] & 0xFFFF
    np.testing.assert_array_equal(frame.point[bound], rec.slice_ids[slot])
    # the rows of the current slice would have bound other points
    assert not np.array_equal(new_ids[np.minimum(slot, len(new_ids) - 1)], rec.slice_ids[slot])


def test_load_slam_drops_records_in_flight(midrun, tmp_path):
    slam, images, ts = midrun
    path = str(tmp_path / "world.npz")
    save_slam(path, slam)
    load_slam(path, slam)
    assert len(slam._inflight) == 0
    assert slam._last_result == (TrackState.LOST, None)
    assert slam.tracker.state == TrackState.LOST
    state, _ = slam.process(images[NOISE_AT + 1], ts[NOISE_AT + 1])
    assert state == TrackState.LOST and len(slam._inflight) == 0   # no vocabulary: no relocalization


def test_warmup_under_the_pipelined_config_leaves_a_fresh_system():
    slam = psystem.Slam(SlamConfig(**CFG_KW), vocab=None, device="cpu")
    slam.warmup()
    assert len(slam._inflight) == 0 and slam.frame_count == 0
    assert slam.trajectory == [] and slam.n_keyframes == 0
    assert slam.tracker.state == TrackState.NO_IMAGES_YET
    assert slam._last_result == (TrackState.NO_IMAGES_YET, None)
