"""The port's warmed system: `Slam.warmup()` leaving a fresh system, its
drive reaching only the program shapes `_compile_programs` took ahead (each
program holder: the map mirror's stage programs, the tracker's, frame
extraction's), and a warmed system against the JAX package's recorded
outcome on frames 0-27 of the system fixture (the fixture's shipping
config: ~12 min on the CPU). The
compiled-program model, the step's programs, the warmup with a vocabulary,
the command line's warmup flags and the `gpu`-marked captures are
tests/test_torch_graphs_programs.py's (a file of its own, so the two share
the run's workers).

This file's count of test ids steers the tier-1 run: pytest-xdist's
`--dist loadfile` hands out the files with the most ids first, and this
one holds the heaviest work (the two `warmed` tests, ~13 min on the CPU).
With two or three ids it would start last and stretch the run by minutes;
`test_warmup_drive_reached_only_the_compiled_shapes`, one case a program
holder (HOLDERS), makes it start among the first. Merging those cases, or
moving tests out, undoes that: check the run's wall time if you do."""
import json
import os

import numpy as np
import pytest
import torch

from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.pipeline.system import Slam

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "orbslam_jpminipc_torch", "data")
SLAM_FIXTURE = os.path.join(DATA, "slam_fixture_xyz.npz")
# the system against the reference's recorded outcome (tests/test_torch_slam.py's
# bounds): states and keyframe counts equal, points within 1 %, camera centres
# within 1e-3 (the map's median depth is 1)
POINTS_REL = 0.01
CENTRE_TOL = 1e-3


# ---- Slam.warmup --------------------------------------------------------------

def _fresh_state(slam):
    """What a freshly constructed system starts from."""
    tr = slam.tracker
    st = slam.map
    out = {
        "frame_count": slam.frame_count, "trajectory": len(slam.trajectory),
        "pending": len(slam.pending), "n_keyframes": slam.n_keyframes,
        "n_points": slam.n_points, "next_kf_id": st.next_kf_id,
        "n_loops_closed": slam.n_loops_closed, "last_result": slam._last_result[0],
        "inlier_peak": slam._inlier_peak, "tracker_state": tr.state,
        "velocity": tr.velocity, "last_frame": tr.last_frame, "ref_kf": tr.ref_kf,
        "last_kf_frame_id": tr.last_kf_frame_id, "last_reloc_frame_id": tr.last_reloc_frame_id,
        "n_inliers": tr.n_inliers, "generator": tr.generator.get_state().tolist(),
        "fused_ready": tr.fused.ready, "slice_ids": tr.fused.slice_ids.tolist(),
        "probation": slam.mapper.probation, "dmap_version": slam.mapper.dmap.version,
        "kf_valid": st.kf_valid.tolist(), "mp_valid": int(st.mp_valid.sum()),
    }
    if slam.kfdb is not None:
        out["kfdb_present"] = slam.kfdb.present.tolist()
        out["kfdb_n"] = slam.kfdb.bow_n.tolist()
    if slam.loop_closer is not None:
        lc = slam.loop_closer
        out.update(loop_groups=lc.consistent_groups, last_loop=lc.last_loop_kf_id,
                   loop_generator=lc.generator.get_state().tolist())
    return out


# the program holders of a system without a vocabulary: the map mirror's
# stage programs, the tracker's host-path programs, frame extraction's
MIRROR_SETS = ("scatter", "tri", "fuse", "local_ba", "attrs", "slice")
TRACKER_SETS = ("track_frame", "track_local_map", "reloc_candidate", "reloc_refine",
                "init_attempt")
HOLDERS = MIRROR_SETS + TRACKER_SETS + ("extraction",)


def _programs(slam) -> dict:
    """Each holder's programs by name: one per input shape a call (or a
    capture) has reached."""
    sets = {**slam.mapper.dmap.programs, **slam.tracker.programs}
    out = {k: sorted(p.name for p in sets[k].programs.values()) for k in HOLDERS[:-1]}
    out["extraction"] = sorted(p.name for p in slam.tracker.extraction.all_programs)
    return out


@pytest.fixture(scope="module")
def warmed():
    """The system fixture's config (the reference's recorded run), warmed;
    the frames its drive took, and the programs right after
    `_compile_programs` and at the warmup's end."""
    sf = dict(np.load(SLAM_FIXTURE))
    cfg = SlamConfig(**json.loads(str(sf["meta"]))["config"])
    slam = Slam(cfg, vocab=None, device="cpu")
    drove, compiled = [], {}
    process, compile_programs = slam.process, slam._compile_programs
    slam.process = lambda img, ts=0.0: (drove.append(ts), process(img, ts))[1]
    slam._compile_programs = lambda: (compile_programs(), compiled.update(_programs(slam)))
    slam.warmup()
    del slam.process, slam._compile_programs
    return slam, cfg, sf, drove, (compiled, _programs(slam))


def test_warmup_leaves_a_fresh_system(warmed):
    slam, cfg, _, drove, _ = warmed
    assert len(drove) > 12   # phase 2 drove frames through the system
    assert _fresh_state(slam) == _fresh_state(Slam(cfg, vocab=None, device="cpu"))


@pytest.mark.parametrize("holder", HOLDERS)
def test_warmup_drive_reached_only_the_compiled_shapes(warmed, holder):
    """Every program shape the warmup's drive reached (initialization,
    tracking, a noise frame, the mapping stages at the shipping widths) is
    one `_compile_programs` took ahead of it: the dummy inputs have the
    real calls' shapes and dtypes, so a warmed system captures nothing in
    the middle of a run (a second shape would be a second program)."""
    _, _, _, _, (compiled, after) = warmed
    assert compiled[holder], holder
    assert after[holder] == compiled[holder]


def test_warmed_system_matches_recorded_reference(warmed):
    """A warmed system over frames 0-27 of the system fixture (the
    reference's initialization sets injected) against the JAX package's
    recorded outcome: states and keyframe counts per frame, points, camera
    centres."""
    slam, _, sf, _, _ = warmed
    sets = iter(torch.from_numpy(s) for s in sf["init_sets"])
    slam.tracker.sampler = lambda mask, n_hyp: next(sets)
    states, nkf, npt, poses = [], [], [], []
    for img, ts in zip(sf["images"], sf["timestamps"]):
        state, frame = slam.process(img, float(ts))
        states.append(state.value)
        nkf.append(slam.n_keyframes)
        npt.append(slam.n_points)
        pose = np.full((3, 4), np.nan, np.float32)
        if frame is not None and frame.R is not None:
            pose[:, :3], pose[:, 3] = frame.R, frame.t
        poses.append(pose)
    slam.finish()
    assert states == sf["states"].tolist()
    assert nkf == sf["n_keyframes_per_frame"].tolist()
    rpt = sf["n_points_per_frame"]
    assert np.all(np.abs(np.array(npt) - rpt) <= POINTS_REL * rpt), (npt, rpt)
    assert slam.n_keyframes == int(sf["n_keyframes"])
    assert abs(slam.n_points - int(sf["n_points"])) <= POINTS_REL * int(sf["n_points"])
    poses, ref = np.stack(poses), sf["poses"]
    has = ~np.isnan(ref[:, 0, 0])
    np.testing.assert_array_equal(~np.isnan(poses[:, 0, 0]), has)
    for g, r in zip(poses[has], ref[has]):
        np.testing.assert_allclose(-g[:, :3].T @ g[:, 3], -r[:, :3].T @ r[:, 3], atol=CENTRE_TOL)
