"""PyTorch port vs the JAX package: io/checkpoint.py. The npz keys are the
same in both packages, so a world saved by one loads in the other; a
loaded world puts the tracker in LOST and the next frames relocalize into
it (the reference's resume)."""
import types

import numpy as np
import pytest
import torch

from orbslam_jpminipc_tpu.io import checkpoint as jck
from orbslam_jpminipc_tpu.map.map_state import MapState as JMapState
from orbslam_jpminipc_tpu.vocab.vocabulary import build_vocabulary
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend.tracking import TrackState
from orbslam_jpminipc_torch.io import checkpoint as tck
from orbslam_jpminipc_torch.io.dataset import SyntheticSequence
from orbslam_jpminipc_torch.map.keyframe_db import KeyFrameDatabase
from orbslam_jpminipc_torch.pipeline.system import Slam
from orbslam_jpminipc_torch.vocab.vocabulary import vocab_from_numpy

torch.set_num_threads(2)

CFG_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=600, max_kf=64,
              max_mp=8192, local_ba_obs=8192, pipelined_tracking=False)
# a resumed system is WORKING again within this many frames of the mapped
# region (measured: on the first frame)
RELOC_WITHIN = 10


@pytest.fixture(scope="module")
def vocab():
    v = build_vocabulary(np.random.default_rng(0).integers(0, 256, (20000, 32)).astype(np.uint8),
                         n_words=1024, iters=3)
    return vocab_from_numpy(v, device="cpu")


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=45, trajectory="xyz", seed=3, device="cpu")


@pytest.fixture(scope="module")
def mapped(vocab, seq, tmp_path_factory):
    """A port system after 18 frames, saved once."""
    slam = Slam(SlamConfig(**CFG_KW), vocab=vocab, enable_loop_closing=False, device="cpu")
    for i in range(18):
        img, ts, _ = seq.get(i)
        slam.process(img, ts)
    assert slam.n_keyframes >= 3
    path = str(tmp_path_factory.mktemp("world") / "w.npz")
    tck.save_slam(path, slam)
    return slam, path


def _fresh(vocab):
    return Slam(SlamConfig(**CFG_KW), vocab=vocab, enable_loop_closing=False, device="cpu")


def _assert_same_world(a, b):
    for f in tck._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.next_kf_id, a.next_mp_id) == (b.next_kf_id, b.next_mp_id)
    assert [set(e) for e in a.kf_loop_edges] == [set(e) for e in b.kf_loop_edges]


def _assert_same_db(a, b):
    for f in ("bow_ids", "bow_vals", "bow_n", "present"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_roundtrip_exact(mapped, vocab):
    slam, path = mapped
    slam2 = tck.load_slam(path, _fresh(vocab))
    _assert_same_world(slam2.map, slam.map)
    _assert_same_db(slam2.kfdb, slam.kfdb)
    assert slam2.n_keyframes == slam.n_keyframes and slam2.n_points == slam.n_points
    assert slam2.tracker.state == TrackState.LOST and slam2.pending == []
    assert slam2.tracker.velocity is None and slam2.tracker.last_frame is None
    assert slam2.loop_closer is None and slam2._last_result == (TrackState.LOST, None)


def _db_like(kfdb):
    return types.SimpleNamespace(**{f: np.zeros_like(getattr(kfdb, f))
                                    for f in ("bow_ids", "bow_vals", "bow_n", "present")})


def test_port_world_loads_in_jax(mapped):
    slam, path = mapped
    db = _db_like(slam.kfdb)
    db.bow_ids[:] = -1
    state = jck.load_world(path, db)
    _assert_same_world(state, slam.map)
    _assert_same_db(db, slam.kfdb)


def _random_jax_world(rng):
    st = JMapState.create(max_kf=64, max_mp=8192, n_feat=1200, max_obs=32)
    for f in tck._ARRAY_FIELDS:
        a = getattr(st, f)
        if a.dtype == bool:
            a[...] = rng.random(a.shape) < 0.5
        elif np.issubdtype(a.dtype, np.integer):
            a[...] = rng.integers(-1, 200, a.shape)
        else:
            a[...] = rng.normal(0, 1, a.shape)
    st.next_kf_id, st.next_mp_id = 61, 7001
    st.kf_loop_edges[3] = {7, 9}
    st.kf_loop_edges[7] = {3}
    db = types.SimpleNamespace(
        bow_ids=np.sort(rng.integers(0, 1024, (64, 2048)), axis=1).astype(np.int32),
        bow_vals=rng.random((64, 2048)).astype(np.float32),
        bow_n=rng.integers(0, 2048, 64).astype(np.int32),
        present=rng.random(64) < 0.7)
    return st, db


def test_jax_world_loads_in_port(tmp_path, vocab):
    st, db = _random_jax_world(np.random.default_rng(1))
    path = str(tmp_path / "j.npz")
    jck.save_world(path, st, db)
    kfdb = KeyFrameDatabase(vocab, 64, device="cpu")
    got = tck.load_world(path, kfdb, device="cpu")
    _assert_same_world(got, st)
    _assert_same_db(kfdb, db)
    # and back: the port's save of it equals the JAX package's file
    path2 = str(tmp_path / "t.npz")
    tck.save_world(path2, got, kfdb)
    a, b = np.load(path), np.load(path2)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_legacy_dense_bow(tmp_path, vocab):
    rng = np.random.default_rng(2)
    st, _ = _random_jax_world(rng)
    path = str(tmp_path / "plain.npz")
    jck.save_world(path, st)
    z = dict(np.load(path))
    dense = np.zeros((64, 4096), np.float32)
    present = np.zeros(64, bool)
    for kf in range(0, 64, 3):
        present[kf] = True
        n = 3000 if kf == 6 else int(rng.integers(1, 300))    # one row above capacity
        ids = rng.choice(4096, n, replace=False)
        dense[kf, ids] = rng.random(n).astype(np.float32) + 0.01
    z["kfdb_bow"], z["kfdb_present"] = dense, present
    legacy = str(tmp_path / "legacy.npz")
    np.savez_compressed(legacy, **z)
    kfdb = KeyFrameDatabase(vocab, 64, device="cpu")
    tck.load_world(legacy, kfdb, device="cpu")
    ref = _db_like(kfdb)
    ref.bow_ids[:] = -1
    jck.load_world(legacy, ref)
    _assert_same_db(kfdb, ref)
    assert kfdb.present.sum() == present.sum() and kfdb.bow_n[6] == 2048
    assert np.all(np.diff(kfdb.bow_ids[6]) > 0)


def test_capacity_mismatch_raises(mapped, vocab):
    _, path = mapped
    with pytest.raises(ValueError, match="BoW capacity"):
        tck.load_world(path, KeyFrameDatabase(vocab, 64, max_words_per_kf=1024, device="cpu"),
                       device="cpu")


def test_resume_relocalizes(mapped, vocab, seq):
    slam, path = mapped
    slam2 = tck.load_slam(path, _fresh(vocab))
    assert slam2.tracker.state == TrackState.LOST
    n_kf = slam2.n_keyframes
    back = None
    for k, i in enumerate(range(8, 18)):
        img, ts, _ = seq.get(i)
        state, frame = slam2.process(img, ts)
        if state == TrackState.WORKING:
            back = k
            break
    assert back is not None and back < RELOC_WITHIN, back
    # relocalized into the loaded map: the pose agrees with the first run's
    R, t = frame.R, frame.t
    ref = {round(ts, 6): (R_, t_) for ts, R_, t_ in slam.trajectory}[round(ts, 6)]
    assert np.abs(-R.T @ t - (-ref[0].T @ ref[1])).max() < 0.05
    assert slam2.n_keyframes >= n_kf
