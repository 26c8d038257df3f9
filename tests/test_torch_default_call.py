"""PyTorch port vs the JAX package: the default call, `Slam(SlamConfig(...),
vocab=v)`: pipelined tracking, asynchronous mapping, loop closing and a
vocabulary (`data/vocab_synthetic.npz`, a byte copy of the JAX package's).

Both `Slam`s run frames 0-16 of the system fixture's synthetic `xyz`
sequence at small widths (`n_features=600`, `max_kf=64`, `max_mp=8192`)
with a noise frame (`np.random.default_rng(7)`) after frame 10, when the
map holds more than five keyframes: with a vocabulary the loss is then not
terminal and the system relocalizes, through the port's `reloc_candidate`
program; the initialization runs through its `init_attempt` program (both
eager programs on the CPU).

Reads are made deterministic on both sides, in this file only, as
tests/test_torch_pipelined.py and tests/test_torch_async.py do: every
tracking read reports "not landed" until it is taken (a record completes
when the queue forces it), every mapping-stage read has landed when it is
queued (the JAX package's `pull_pool("mapping")` answers at once, as the
port's reads of CPU tensors do), and both packages' monotonic clocks are
frozen. The port replays the reference's initialization and PnP minimal
sets.

Tolerances, as tests/test_torch_pipelined.py's: for every `process` call
the completed frame's id, its state and the keyframe count equal, points
within 1 %, camera centres within 1e-3 (the map's median depth is 1); the
relocalization log's candidate lists and PnP verdicts equal; no loop
closed on either side. Measured on the CPU: ids, states and keyframes
equal, points within one, centres within 7.6e-5; one relocalization (the
frame after the noise, one candidate, PnP accepted).
"""
import concurrent.futures as futures
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
from orbslam_jpminipc_tpu.utils.tracing import get_tracer as jget_tracer
from orbslam_jpminipc_tpu.vocab.vocabulary import load_vocabulary as jload_vocabulary
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend import tracking as ptracking
from orbslam_jpminipc_torch.frontend.tracking import TrackState
from orbslam_jpminipc_torch.pipeline import system as psystem
from orbslam_jpminipc_torch.utils.tracing import get_tracer
from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "orbslam_jpminipc_torch", "data")
SLAM_FIXTURE = os.path.join(DATA, "slam_fixture_xyz.npz")
VOCAB = os.path.join(DATA, "vocab_synthetic.npz")
N_FRAMES = 17
NOISE_AT = 11     # the noise frame is the 12th frame submitted
CFG_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=600, max_kf=64,
              max_mp=8192, local_ba_obs=8192)
CENTRE_TOL = 1e-3
POINTS_REL = 0.01


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _frames():
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


class _NowPool:
    """Mapping-stage reads that have landed when they are queued."""

    def submit(self, tree):
        f = futures.Future()
        f.set_result(jax.device_get(tree))
        return f


def _deterministic(mp):
    real_fetch = ptracking.fetch_async
    pools = {"track": _LatePool(), "mapping": _NowPool()}
    mp.setattr(jpull, "pull_pool", lambda name="track": pools[name])
    mp.setattr(ptracking, "fetch_async", lambda *t: _Late(real_fetch(*t).result))
    mp.setattr(time, "monotonic", lambda: 0.0)   # the JAX system reads time.monotonic
    for mod in (jtracking, ptracking, psystem):
        mp.setattr(mod, "_monotonic", lambda: 0.0)


def _drive(slam, images, ts, tracer):
    out = dict(ids=[], states=[], poses=[], nkf=[], npt=[], log=[])
    orig = tracer.log
    tracer.log = lambda event, **f: (out["log"].append({"event": event, **f}),
                                     orig(event, **f))[1]
    try:
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
    finally:
        del tracer.log
    out["loops"] = slam.n_loops_closed
    return out


def _reloc_log(log):
    keep = {"reloc_candidates": ("frame", "cands"), "reloc_attempt": ("frame", "kf", "pnp_ok")}
    return [{k: e[k] for k in keep[e["event"]]} | {"event": e["event"]}
            for e in log if e["event"] in keep]


@pytest.fixture(scope="module")
def runs():
    from orbslam_jpminipc_tpu.config import SlamConfig as JaxConfig

    slam_tool = _tool("make_torch_slam_fixture")
    reloc_tool = _tool("make_torch_reloc_fixture")
    images, ts = _frames()
    with pytest.MonkeyPatch.context() as mp:
        _deterministic(mp)
        init_sets, pnp_sets = [], []
        orig_init = slam_tool.record_init_sets(jtracking, jinitializer, init_sets)
        orig_pnp = reloc_tool.record_pnp_sets(jtracking, pnp_sets)
        try:
            jslam = jsystem.Slam(JaxConfig(**CFG_KW), vocab=jload_vocabulary(VOCAB))
            ref = _drive(jslam, images, ts, jget_tracer())
        finally:
            jtracking._init_attempt = orig_init
            jtracking._reloc_candidate_prog = orig_pnp
        slam = psystem.Slam(SlamConfig(**CFG_KW), vocab=load_vocabulary(VOCAB, device="cpu"),
                            device="cpu")
        isets = iter(torch.from_numpy(np.array(s)) for s in init_sets)
        psets = iter(torch.from_numpy(np.array(s)) for s in pnp_sets)
        slam.tracker.sampler = lambda mask, n_hyp: next(isets)
        slam.tracker.pnp_sampler = lambda mask, n_hyp: next(psets)
        got = _drive(slam, images, ts, get_tracer())
        got["unused_sets"] = (sum(1 for _ in isets), sum(1 for _ in psets))
    return ref, got, slam


def test_default_call_is_pipelined_asynchronous_with_loop_closing(runs):
    *_, slam = runs
    cfg = slam.cfg
    assert cfg.pipelined_tracking and cfg.async_mapping
    assert slam.loop_closer is not None and slam.tracker.kfdb is not None
    names = {c.name.split("[")[0] for s in slam.tracker.programs.values()
             for c in s.programs.values()}
    assert {"reloc_candidate", "init_attempt"} <= names


def test_completed_frames_and_states_match_per_call(runs):
    ref, got, _ = runs
    assert got["ids"] == ref["ids"]
    assert got["states"] == ref["states"]
    assert got["unused_sets"] == (0, 0)   # as many initialization and PnP attempts
    lost, working = TrackState.LOST.value, TrackState.WORKING.value
    assert lost in got["states"] and got["states"][-1] == working


def test_relocalization_log_matches(runs):
    ref, got, _ = runs
    assert _reloc_log(got["log"]) == _reloc_log(ref["log"])
    assert any(e["event"] == "reloc_attempt" for e in got["log"])


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


def test_no_loop_closed(runs):
    ref, got, _ = runs
    assert got["loops"] == ref["loops"] == 0
