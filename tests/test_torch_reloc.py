"""PyTorch port vs the JAX package: a forced loss and the relocalization.

Both `Slam`s (a vocabulary, loop closing off, synchronous tracking and
mapping, the small widths of tests/test_torch_slam.py) run over the first
9 frames of the system fixture's synthetic `xyz` sequence, 2 noise frames
(the camera covered) and the 3 frames that follow. The vocabulary is a
1024-word flat one made by the JAX package's `build_vocabulary` and carried into the port by
`vocab_from_numpy`. The reference draws its RANSAC minimal sets with
`jax.random`; the port replays them: the initialization sets and the PnP
sets of every relocalization candidate, recorded by the fixture tool's
wrappers (tools/make_torch_reloc_fixture.py).

On this stretch the reference goes LOST on the noise, relocalizes on the
first real frame, loses the next frame (the wide post-relocalization
search does not hold it) and relocalizes again: two recoveries.

Tolerances: per-frame states, keyframe counts, point counts and the
relocalization log's candidate lists, match counts and PnP verdicts equal;
inlier counts after a relocalization within 2; camera centres within 1e-3
(the map's median depth is 1). Measured on the CPU: centres within 3e-6,
one inlier count one off.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from orbslam_jpminipc_tpu.vocab.vocabulary import build_vocabulary
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend import tracking as ttracking
from orbslam_jpminipc_torch.frontend.tracking import TrackState
from orbslam_jpminipc_torch.pipeline.system import Slam
from orbslam_jpminipc_torch.utils.tracing import get_tracer
from orbslam_jpminipc_torch.vocab.vocabulary import vocab_from_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLAM_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "slam_fixture_xyz.npz")
CFG_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=600, max_kf=64,
              max_mp=8192, local_ba_obs=8192, pipelined_tracking=False, async_mapping=False)
N_BEFORE, N_NOISE, N_AFTER = 9, 2, 3
CENTRE_TOL = 1e-3
INLIER_TOL = 2


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_reloc_fixture", os.path.join(REPO, "tools", "make_torch_reloc_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _centre(P):
    return -P[:, :3].T @ P[:, 3]


@pytest.fixture(scope="module")
def runs():
    tool = _tool()
    fx = np.load(SLAM_FIXTURE)
    ts = fx["timestamps"]
    images = np.concatenate([fx["images"][:N_BEFORE], tool.noise_frames(N_NOISE),
                             fx["images"][N_BEFORE:N_BEFORE + N_AFTER]])
    stamps = np.concatenate([ts[:N_BEFORE],
                             tool.noise_timestamps(ts[N_BEFORE - 1], ts[N_BEFORE], N_NOISE),
                             ts[N_BEFORE:N_BEFORE + N_AFTER]])
    vocab = build_vocabulary(
        np.random.default_rng(0).integers(0, 256, (20000, 32)).astype(np.uint8),
        n_words=1024, iters=3)
    recorded = []
    ref, jslam = tool.run_reference(CFG_KW, images, stamps, vocab, keep_args=recorded)
    ref["log"] = json.loads(str(ref["reloc_log"]))

    slam = Slam(SlamConfig(**CFG_KW), vocab=vocab_from_numpy(vocab, device="cpu"),
                enable_loop_closing=False, device="cpu")
    isets = iter(torch.from_numpy(s) for s in ref["init_sets"])
    psets = iter(torch.from_numpy(s) for s in ref["pnp_sets"])
    slam.tracker.sampler = lambda mask, n_hyp: next(isets)
    slam.tracker.pnp_sampler = lambda mask, n_hyp: next(psets)
    tracer = get_tracer()
    log = []
    orig = tracer.log
    tracer.log = lambda event, **f: (log.append({"event": event, **f}), orig(event, **f))[1]
    got = dict(states=[], poses=[], nkf=[], npt=[], inl=[], fused=[])
    try:
        for img, t in zip(images, stamps):
            got["fused"].append(slam.tracker.fused_usable(slam.frame_count))
            state, frame = slam.process(img, float(t))
            got["states"].append(state.value)
            pose = np.full((3, 4), np.nan, np.float32)
            if frame is not None and frame.R is not None:
                pose[:, :3], pose[:, 3] = frame.R, frame.t
            got["poses"].append(pose)
            got["nkf"].append(slam.n_keyframes)
            got["npt"].append(slam.n_points)
            got["inl"].append(int(slam.tracker.n_inliers))
        slam.finish()
    finally:
        del tracer.log
    got["log"] = [e for e in log if e["event"].startswith("reloc_")]
    got["unused"] = (sum(1 for _ in isets), sum(1 for _ in psets))
    return ref, got, slam, jslam, recorded


def test_states_match_per_frame_through_loss_and_recovery(runs):
    ref, got, *_ = runs
    assert got["states"] == ref["states"].tolist()
    lost, working = TrackState.LOST.value, TrackState.WORKING.value
    first_lost = got["states"].index(lost)
    assert first_lost == N_BEFORE
    back = next(i for i in range(first_lost, len(got["states"])) if got["states"][i] == working)
    ref_back = next(i for i in range(first_lost, len(ref["states"])) if ref["states"][i] == working)
    assert back == ref_back == N_BEFORE + N_NOISE and back - first_lost <= 20
    assert got["states"][-1] == working
    assert got["unused"] == (0, 0)  # as many initialization and PnP attempts


def test_counts_match_per_frame(runs):
    ref, got, *_ = runs
    assert got["nkf"] == ref["n_keyframes_per_frame"].tolist()
    assert got["npt"] == ref["n_points_per_frame"].tolist()
    d = np.abs(np.array(got["inl"]) - ref["n_inliers"])
    assert d.max() <= INLIER_TOL, (got["inl"], ref["n_inliers"].tolist())


def test_camera_centres_match_per_frame(runs):
    ref, got, *_ = runs
    poses = np.stack(got["poses"])
    has = ~np.isnan(ref["poses"][:, 0, 0])
    np.testing.assert_array_equal(~np.isnan(poses[:, 0, 0]), has)
    assert not has[N_BEFORE:N_BEFORE + N_NOISE].any()  # a LOST frame keeps no pose
    worst = max(float(np.abs(_centre(g) - _centre(r)).max())
                for g, r in zip(poses[has], ref["poses"][has]))
    print(f"worst camera centre difference {worst:.3g} (bound {CENTRE_TOL})")
    assert worst <= CENTRE_TOL


def test_relocalization_log_matches(runs):
    ref, got, *_ = runs
    assert [e["event"] for e in got["log"]] == [e["event"] for e in ref["log"]]
    n_ok = 0
    for g, r in zip(got["log"], ref["log"]):
        assert g["frame"] == r["frame"]
        if g["event"] == "reloc_candidates":
            assert g["cands"] == r["cands"]
        elif g["event"] == "reloc_attempt":
            assert (g["kf"], g["n_match"], g["pnp_ok"]) == (r["kf"], r["n_match"], r["pnp_ok"])
            n_ok += g["pnp_ok"]
        else:
            assert g["kf"] == r["kf"] and abs(g["n_inliers"] - r["n_inliers"]) <= INLIER_TOL
    assert n_ok == 2  # two recoveries on this stretch


def test_keyframe_database_follows_the_map(runs):
    """Every keyframe of the map is indexed, culled ones are not, and the
    rows equal the reference database's."""
    _, _, slam, jslam, _ = runs
    np.testing.assert_array_equal(slam.kfdb.present, slam.map.kf_valid)
    np.testing.assert_array_equal(slam.kfdb.present, jslam.kfdb.present)
    np.testing.assert_array_equal(slam.kfdb.bow_ids, jslam.kfdb.bow_ids)
    np.testing.assert_allclose(slam.kfdb.bow_vals, jslam.kfdb.bow_vals, atol=1e-6)
    assert slam.kfdb.present.sum() == slam.n_keyframes >= 8


def test_fused_path_is_left_and_entered_again(runs):
    """The frame after a relocalization stays on the host path (the wide
    search window); the fused path carried the frames before the loss."""
    _, got, slam, *_ = runs
    back = N_BEFORE + N_NOISE
    assert all(got["fused"][4:N_BEFORE + 1])       # steady WORKING, and the frame that is lost
    assert not any(got["fused"][N_BEFORE + 1:back + 2])  # LOST frames, and the one after recovery
    assert slam.tracker.fused.ready                # armed again by the last recovery


def test_candidate_program_matches_jax_on_the_recorded_candidates(runs):
    """Every candidate attempt the reference made, its recorded inputs
    through the port's program."""
    ref, *_, recorded = runs
    assert len(recorded) == len(ref["pnp_sets"]) == 3
    for (args, out), sets in zip(recorded, ref["pnp_sets"]):
        jidx, jmask, jok, jsel, jopt = out
        idx, mask, ok, sel, opt = ttracking._reloc_candidate_prog(
            lambda m, n_hyp: torch.from_numpy(sets), *(torch.from_numpy(np.array(a)) for a in args))
        np.testing.assert_array_equal(mask.numpy(), jmask)
        np.testing.assert_array_equal(idx.numpy()[jmask], jidx[jmask])
        assert bool(ok) == bool(jok)
        if bool(jok):
            assert int((sel.numpy() != jsel).sum()) <= INLIER_TOL
            assert abs(int(opt.n_inliers) - int(jopt.n_inliers)) <= INLIER_TOL
            np.testing.assert_allclose(opt.R.numpy(), jopt.R, atol=1e-4)
            np.testing.assert_allclose(opt.t.numpy(), jopt.t, atol=1e-3)


def test_lost_stays_lost_without_a_vocabulary():
    """No database: `_relocalize` returns False, as the reference's does."""
    slam = Slam(SlamConfig(**CFG_KW), device="cpu")
    assert slam.kfdb is None and slam.tracker.kfdb is None and slam.mapper.kfdb is None
    assert slam.tracker._relocalize(None) is False


def test_force_relocalization_and_reset_clear_the_state(runs):
    _, _, slam, *_ = runs
    tr = slam.tracker
    assert tr.state == TrackState.WORKING and tr.fused.ready
    tr.force_relocalization()
    assert tr.state == TrackState.LOST and tr.velocity is None and not tr.fused.ready
    slam.pending.append((0, ["cull_kf"]))
    slam.reset()
    assert slam.pending == [] and not slam.kfdb.present.any()
    assert slam.n_keyframes == 0 and tr.state == TrackState.NOT_INITIALIZED
