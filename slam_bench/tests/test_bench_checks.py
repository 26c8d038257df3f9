"""The comparisons that decide `correct`, at test size: the sound program
reads under each limit, the control (the references in bfloat16 in the
program's place) and the planted faults read over one."""
import json

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from slam_bench import check
from slam_bench.reference import ba as ref_ba
from slam_bench.reference import extract as ref_extract
from slam_bench.reference import pose as ref_pose
from slam_bench.reference import trajectory as ref_traj
from slam_bench.traffic import Stream

from .conftest import ROOT

LIMITS = check.load_limits("tum_fr1_vga30.handheld")
CAM = {"width": 256, "height": 192, "fps": 30.0, "fx": 206.9, "fy": 206.6, "cx": 127.5, "cy": 102.1}


@pytest.fixture(scope="module")
def frames():
    s = Stream({"trajectory": "xyz", "period": 100}, CAM, 2 ** 31 + 3, "cpu")
    return [s.frame(i)[0] for i in (0, 37)]


def test_the_reference_extractor_equals_the_ports_plain_path(frames):
    from orbslam_jpminipc_torch.ops import extractor

    for img in frames:
        for n in (300, 600):
            f = extractor.extract(torch.from_numpy(img).float(), n, 8, 1.2, 20.0, 7.0)
            prog = {k: getattr(f, k).numpy() for k in ("level", "xy", "desc", "valid")}
            ref = ref_extract.extract(img, n, 8, 1.2, 20.0, 7.0)
            assert check.compare_features(prog, ref) == (0.0, 0.0)


def test_the_bf16_extraction_control_fails(frames):
    for img in frames:
        ref = ref_extract.extract(img, 300, 8, 1.2, 20.0, 7.0)
        low = ref_extract.extract(img, 300, 8, 1.2, 20.0, 7.0, dtype=torch.bfloat16)
        m, b = check.compare_features(low, ref)
        assert m > LIMITS["kp_mismatch_pct"] or b > LIMITS["desc_bits_pct"]


def test_an_altered_descriptor_or_keypoint_fails(frames):
    ref = ref_extract.extract(frames[0], 300, 8, 1.2, 20.0, 7.0)
    bad = dict(ref, desc=ref["desc"] ^ np.uint8(1))
    assert check.compare_features(bad, ref)[1] > LIMITS["desc_bits_pct"]
    moved = dict(ref, xy=ref["xy"] + np.float32(1.0))
    assert check.compare_features(moved, ref)[0] > LIMITS["kp_mismatch_pct"]


def ba_problem(seed, K=10, P=500, noise=1.0, pert=0.001):
    """A seeded local-BA problem: K cameras (the first two fixed), P points,
    half of all (camera, point) pairs observed with pixel noise, the free
    cameras and every point perturbed."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 2], [1, 1, 4], (P, 3))
    R = np.stack([Rotation.from_rotvec(rng.normal(0, 0.05, 3)).as_matrix() for _ in range(K)])
    t = rng.normal(0, 0.2, (K, 3))
    K4 = np.array([500, 500, 320, 240.0])
    kf, pt = np.nonzero(rng.uniform(size=(K, P)) < 0.5)
    pc = np.einsum("oij,oj->oi", R[kf], X[pt]) + t[kf]
    uv = K4[:2] * pc[:, :2] / pc[:, 2:] + K4[2:] + rng.normal(0, noise, (len(kf), 2))
    fixed = np.arange(K) < 2
    Rn = np.stack([r if f else Rotation.from_rotvec(rng.normal(0, pert, 3)).as_matrix() @ r
                   for r, f in zip(R, fixed)])
    tn = t + rng.normal(0, pert, t.shape) * ~fixed[:, None]
    O = len(kf)
    return dict(kf_R=Rn.astype(np.float32), kf_t=tn.astype(np.float32), kf_fixed=fixed,
                points=(X + rng.normal(0, pert, X.shape)).astype(np.float32),
                point_valid=np.ones(P, bool), obs_kf=kf.astype(np.int32), obs_pt=pt.astype(np.int32),
                obs_uv=uv.astype(np.float32), obs_w=np.ones(O, np.float32),
                obs_valid=np.ones(O, bool), K4=K4.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ba_sound_control_and_unchanged(seed):
    from orbslam_jpminipc_torch.solvers import ba as port_ba

    prob = ba_problem(seed)
    T = {k: torch.as_tensor(v) for k, v in prob.items()}
    T["obs_kf"], T["obs_pt"] = T["obs_kf"].long(), T["obs_pt"].long()
    res = port_ba.bundle_adjust(port_ba.BAProblem(**T), iterations=5)
    sound = check.ba_shortfall(prob, (res.kf_R.numpy(), res.kf_t.numpy(), res.points.numpy()))
    assert sound < LIMITS["ba_shortfall_pct"]
    control = check.ba_shortfall(prob, ref_ba.lm(prob, 5, dtype=torch.bfloat16))
    assert control > LIMITS["ba_shortfall_pct"]
    unchanged = check.ba_shortfall(prob, (prob["kf_R"], prob["kf_t"], prob["points"]))
    assert unchanged == pytest.approx(100.0)


def pose_sample(seed, n=250, noise=1.0):
    """A seeded frame: n map points, their keypoints under a true pose with
    pixel noise and levels, and descriptors that match within 30 bits; the
    matches within the gate at the true pose."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 2], [1, 1, 4], (n, 3))
    R = Rotation.from_rotvec(rng.normal(0, 0.1, 3)).as_matrix()
    t = rng.normal(0, 0.2, 3)
    level = rng.integers(0, 4, n)
    uv = ref_pose.pixels(X, R, t, K4_TUM) + rng.normal(0, noise, (n, 2)) * 1.2 ** level[:, None]
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    flip = np.zeros((n, 256), np.uint8)
    flip[:, :30] = rng.integers(0, 2, (n, 30))
    desc_m = desc ^ np.packbits(flip, axis=1)
    # the pose optimizer's inliers: within the gate at the pose
    e = uv - ref_pose.pixels(X, R, t, K4_TUM)
    keep = (e * e).sum(1) / 1.44 ** level <= 5.991
    return dict(xw=X[keep], uv=uv[keep], level=level[keep], desc=desc[keep],
                desc_m=desc_m[keep], R=R, t=t)


K4_TUM = np.array([517.306, 516.469, 318.643, 255.314])
CONFIG = json.loads((ROOT / "slam_bench/configs/tum_fr1_vga30.json").read_text())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_pose_sound_late_and_altered(seed):
    """A pose solved in float32 from the program's side passes; the pose of
    a frame 5 mm and 2 mrad away (one frame late), and bindings moved to the
    neighbouring point, fail."""
    s = pose_sample(seed)
    w = check.inv_sigma2(CONFIG)[s["level"]]
    R, t = ref_pose.solve(s["xw"], s["uv"], w, s["R"], s["t"], K4_TUM, dtype=torch.float32)
    sound = check.pose_numbers([dict(s, R=R, t=t)], CONFIG, "step")
    assert sound["step_pose_px"] < LIMITS["step_pose_px"]
    assert sound["step_match_bad_pct"] < LIMITS["step_match_bad_pct"]
    dR = Rotation.from_rotvec([0.002, 0, 0]).as_matrix()
    late = check.pose_numbers([dict(s, R=dR @ R, t=t + 0.005)], CONFIG, "step")
    assert late["step_pose_px"] > LIMITS["step_pose_px"]
    rolled = dict(s, R=R, t=t, xw=np.roll(s["xw"], 1, 0), desc_m=np.roll(s["desc_m"], 1, 0))
    bad = check.pose_numbers([rolled], CONFIG, "step")
    assert bad["step_match_bad_pct"] > LIMITS["step_match_bad_pct"]


def test_the_bf16_pose_solve_reads_above_the_float64_one():
    s = pose_sample(7)
    w = check.inv_sigma2(CONFIG)[s["level"]]
    R, t = ref_pose.solve(s["xw"], s["uv"], w, s["R"], s["t"], K4_TUM)
    R32, t32 = ref_pose.solve(s["xw"], s["uv"], w, s["R"], s["t"], K4_TUM, dtype=torch.float32)
    Rb, tb = ref_pose.solve(s["xw"], s["uv"], w, s["R"], s["t"], K4_TUM, dtype=torch.bfloat16)
    assert ref_pose.pose_px(s["xw"], Rb, tb, R, t, K4_TUM) > 10 * ref_pose.pose_px(
        s["xw"], R32, t32, R, t, K4_TUM)


def random_map(seed, n_kf=40, n_mp=400, n_feat=64, max_obs=8):
    """A port map with random observations: many keyframes share equally
    many points, so the capacities cut among equal weights."""
    from orbslam_jpminipc_torch.map.map_state import MapState

    rng = np.random.default_rng(seed)
    st = MapState.create(n_kf, n_mp, n_feat, max_obs, device="cpu")
    st.kf_valid[:] = True
    st.kf_R[:] = Rotation.random(n_kf, random_state=seed).as_matrix()
    st.kf_t[:] = rng.normal(0, 1, (n_kf, 3))
    st.kf_xy[:] = rng.uniform(0, 640, (n_kf, n_feat, 2))
    st.kf_level[:] = rng.integers(0, 8, (n_kf, n_feat))
    used = np.zeros(n_kf, int)
    for p in range(n_mp):
        obs = [k for k in rng.choice(n_kf, size=rng.integers(2, max_obs + 1), replace=False)
               if used[k] < n_feat]
        for s, k in enumerate(obs):
            st.kf_point[k, used[k]] = p
            st.mp_obs_kf[p, s], st.mp_obs_feat[p, s] = k, used[k]
            used[k] += 1
    st.mp_valid[:] = rng.uniform(size=n_mp) > 0.05
    st.mp_xyz[:] = rng.normal(0, 1, (n_mp, 3))
    st._covis_cache = None
    return st


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_reference_assembles_the_ports_local_ba_problem(seed):
    """The port's assembly (`LocalMapper.build_local_ba_problem`) and the
    reference's agree entry for entry under cuts among equal weights; an
    edge dropped from the port's problem is one fault."""
    from types import SimpleNamespace

    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.pipeline.local_mapping import LocalMapper
    from slam_bench.session import BA_FIELDS

    st = random_map(seed)
    caps = dict(local_ba_kf=4, local_ba_fixed=3, local_ba_points=60, local_ba_obs=150)
    cfg = SlamConfig(**caps)
    config = {"ORBextractor.nLevels": cfg.n_levels, "ORBextractor.scaleFactor": cfg.scale_factor,
              "Camera.fx": cfg.fx, "Camera.fy": cfg.fy, "Camera.cx": cfg.cx, "Camera.cy": cfg.cy,
              "port": caps}
    for kf in (5, 17, 30):
        prob, kfs, pts, _, _ = LocalMapper.build_local_ba_problem(
            SimpleNamespace(map=st, cfg=cfg), kf)
        b = {"kf": kf, "map": {f: getattr(st, f) for f in ref_ba.SNAP_FIELDS},
             "prob": {f: np.array(getattr(prob, f)) for f in BA_FIELDS},
             "kfs": [int(k) for k in kfs], "pts": np.asarray(pts)}
        ref, rk, rp = check.reference_problem(b, config)
        assert ref_ba.problem_faults(ref, rk, rp, b["prob"], b["kfs"], b["pts"]) == dict.fromkeys(
            ("keyframes", "fixed", "poses", "points", "positions", "edges", "weights"), 0)
        valid = b["prob"]["obs_valid"].copy()
        valid[int(valid.sum()) - 1] = False
        dropped = dict(b["prob"], obs_valid=valid)
        assert sum(ref_ba.problem_faults(ref, rk, rp, dropped, b["kfs"], b["pts"]).values()) == 1


def test_umeyama_recovers_a_similarity():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(50, 3))
    R = Rotation.from_rotvec([0.3, -0.2, 0.5]).as_matrix()
    dst = 2.5 * src @ R.T + np.array([1.0, -2.0, 0.5])
    s, R2, t2 = ref_traj.umeyama(src, dst)
    assert s == pytest.approx(2.5) and np.allclose(R2, R) and np.allclose(t2, [1.0, -2.0, 0.5])
    assert ref_traj.aligned_errors(src, dst).max() < 1e-9


def test_trajectory_faults_read_higher():
    """A pose that never updates fails the limit; a pose one frame late
    reads higher than the sound one (it stays under the limit: section
    "How correct is decided" of PERF.md says why)."""
    truth = lambda i: np.array([0.35 * np.sin(i / 15), 0.15 * np.sin(i / 10), 0.25 * np.sin(i / 30)])
    rng = np.random.default_rng(5)
    good = {i: ("WORKING", 0.5 * truth(i) + rng.normal(0, 1e-3, 3) + 1.0, 0) for i in range(100)}
    late = {i: ("WORKING", good[max(i - 1, 0)][1], 0) for i in good}
    held = {i: ("WORKING", good[0][1], 0) for i in good}
    g = check.trajectory_number(good, truth)["traj_err_pct"]
    assert g < LIMITS["traj_err_pct"]
    assert check.trajectory_number(late, truth)["traj_err_pct"] > g
    assert check.trajectory_number(held, truth)["traj_err_pct"] > LIMITS["traj_err_pct"]


def test_decide_prints_every_number_beside_its_limit():
    ok, table, lines = check.decide({"a": 1.0, "b": 3.0, "c": None}, {"a": 2.0, "b": 2.0, "c": 1.0})
    assert not ok and table["a"] == {"value": 1.0, "limit": 2.0}
    assert lines[0].startswith("check a: 1.0 limit 2.0 ok") and "FAILED" in lines[1]
    assert table["c"]["value"] is None


def test_limit_files_give_their_readings():
    for p in (ROOT / "slam_bench/limits").glob("*.json"):
        d = json.loads(p.read_text())
        assert set(d["limits"]) == {"kp_mismatch_pct", "desc_bits_pct", "step_pose_px",
                                    "step_match_bad_pct", "reloc_pose_px", "reloc_match_bad_pct",
                                    "ba_problem_diff", "ba_shortfall_pct", "ba2_shortfall_pct",
                                    "traj_err_pct"}
        assert "readings" in d


@pytest.mark.chip
def test_the_cards_extraction_equals_the_reference(frames):
    """The port's extraction on the card (the FAST kernel and the captured
    steps' torch operations) against the reference extractor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from orbslam_jpminipc_torch.ops import extractor

    for img in frames:
        f = extractor.extract(torch.from_numpy(img).float().cuda(), 300, 8, 1.2, 20.0, 7.0)
        prog = {k: getattr(f, k).cpu().numpy() for k in ("level", "xy", "desc", "valid")}
        ref = ref_extract.extract(img, 300, 8, 1.2, 20.0, 7.0, device="cuda")
        assert check.compare_features(prog, ref) == (0.0, 0.0)
