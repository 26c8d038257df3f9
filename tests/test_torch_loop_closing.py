"""PyTorch port vs the JAX package: loop closing.

The constructed loop of tools/loop_scene.py (the scene of the reference's
tests/test_loop_closing.py: a 9-keyframe chain whose tail revisits the
start through drifted duplicates) is built by the same code on both
packages' `MapState`, with a 256-word vocabulary built by the reference's
`build_vocabulary` and carried across with `vocab_from_numpy`. Both
`LoopCloser`s run over the tail; the port replays the Sim3 minimal sets
the reference drew (recomputed from its key and mask by the fixture
tool's wrapper).

Held: per keyframe the database's candidate list and the candidates that
pass the consistency filter equal; the loop closes on the same keyframe
with the same loop keyframe; every pose and point after the correction
within 1e-3 (measured 2e-5 and 1e-4); loop edges equal; with the edge
capacity cut to 12 both keep the same edges, all structural ones among
them; `correct_loop` alone on a 32-keyframe chain with linear drift agrees
within 1e-3 and pulls the chain onto the truth. The shipping-size scene
(max_kf 256, max_mp 16384, eg_edges 2048, the 64k-word vocabulary) runs once,
port only, through the very functions `chip_smoke.py`'s `loop` phase uses,
against the reference's recorded outcome in `loop_fixture.npz` (~25 s here),
global BA at full capacity included.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from orbslam_jpminipc_tpu.config import SlamConfig as JConfig
from orbslam_jpminipc_tpu.map.map_state import MapState as JMapState
from orbslam_jpminipc_tpu.pipeline import loop_closing as jlc
from orbslam_jpminipc_tpu.vocab.vocabulary import build_vocabulary
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.map.device_map import DeviceMap
from orbslam_jpminipc_torch.map.keyframe_db import KeyFrameDatabase
from orbslam_jpminipc_torch.map.map_state import MapState
from orbslam_jpminipc_torch.pipeline import loop_closing as tlc
from orbslam_jpminipc_torch.utils.tracing import get_tracer
from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary, vocab_from_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-3


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


sys.path.insert(0, os.path.join(REPO, "tools"))
import loop_scene  # noqa: E402

fixture_tool = _load("make_torch_loop_fixture", "tools/make_torch_loop_fixture.py")
chip_smoke = _load("chip_smoke", "chip_smoke.py")


@pytest.fixture(scope="module")
def jax_vocab():
    _, info = loop_scene.build_loop_scene(JMapState, "small", 0)
    return build_vocabulary(info["vocab_descriptors"], n_words=256, iters=3, seed=0)


def _port_run(jax_vocab, ref, eg_edges=None, scene="small"):
    """The port's LoopCloser over the scene's tail, the reference's Sim3
    sets injected. Returns (map, per-keyframe records, events, the
    essential-graph problem)."""
    st, info = loop_scene.build_loop_scene(MapState, scene, 0, device="cpu")
    cfg = SlamConfig(**info["cfg"])
    if eg_edges is not None:
        cfg.eg_edges = eg_edges
    kfdb = KeyFrameDatabase(vocab_from_numpy(jax_vocab, device="cpu"), st.max_kf, device="cpu")
    dm = DeviceMap(st.max_kf, st.n_feat, st.max_mp, device="cpu")
    dm.sync_all(st)
    loop_scene.finish_scene(st, info, kfdb,
                            lambda ids: st.update_point_attributes(ids, cfg.scale_factors, dm))
    closer = tlc.LoopCloser(cfg, st, kfdb, device="cpu")   # makes its own mirror
    calls = iter(ref["ransac"])

    def sampler(mask, n_hyp):
        call = next(calls)
        np.testing.assert_array_equal(mask.numpy(), call["mask"])  # the same pairs to draw from
        return torch.from_numpy(call["sets"])

    closer.sim3_sampler = sampler
    events, problems = [], []
    tracer = get_tracer()
    solve = tlc.essential_graph.optimize_essential_graph
    tracer.log = lambda event, **f: events.append({"event": event, **f})
    tlc.essential_graph.optimize_essential_graph = lambda prob, iterations=20: (
        problems.append(prob), solve(prob, iterations=iterations))[1]
    per_kf = []
    try:
        for k in info["tail"]:
            n0 = len(events)
            closed = closer.process(k)
            ev = {e["event"]: e for e in events[n0:]}
            per_kf.append(dict(kf=int(k), closed=closed,
                               cands=ev.get("loop_detect", {}).get("cands", []),
                               enough=ev.get("loop_consistency", {}).get("enough", [])))
            if closed:
                break
    finally:
        del tracer.log
        tlc.essential_graph.optimize_essential_graph = solve
    assert next(calls, None) is None      # the port ran the RANSAC as often
    return st, per_kf, events, problems[-1] if problems else None


@pytest.fixture(scope="module")
def small(jax_vocab):
    ref = fixture_tool.run_reference("small", 0, jax_vocab, global_ba=False)
    return ref, _port_run(jax_vocab, ref)


def test_detect_loop_lists_equal_per_keyframe(small):
    ref, (_, per_kf, events, _) = small
    assert per_kf == ref["per_kf"]
    assert [r["cands"] for r in per_kf] == [[0]] * 4
    assert [r["enough"] for r in per_kf] == [[], [], [], [0]]
    # the database never proposes a covisible keyframe
    assert all(8 not in r["cands"] and 7 not in r["cands"] for r in per_kf)


def test_process_closes_on_the_same_keyframe_with_the_same_loop_keyframe(small):
    ref, (st, per_kf, events, _) = small
    assert ref["closed_kf"] == 8 and per_kf[-1] == dict(kf=8, closed=True, cands=[0], enough=[0])
    assert st.kf_loop_edges[8] == {ref["loop_kf"]} == {0}
    by = {e["event"]: e for e in events}
    assert by["sim3_mutual"]["n_match"] == ref["n_mutual"][-1]
    assert by["sim3_ransac"]["n_inliers"] == int(ref["ransac"][-1]["n_inliers"])
    assert by["sim3_opt"]["n_inliers"] == int(ref["refined"][-1]["n_inliers"])
    assert by["sim3_guided"]["total"] == ref["guided_total"][-1] >= 40
    np.testing.assert_allclose(by["sim3_opt"]["R"], ref["refined"][-1]["R12"], atol=1e-4)
    np.testing.assert_allclose(by["sim3_opt"]["t"], ref["refined"][-1]["t12"], atol=1e-4)
    assert abs(by["sim3_opt"]["s"] - float(ref["refined"][-1]["s12"])) < 1e-4


def test_poses_points_and_loop_edges_after_the_correction(small):
    ref, (st, _, events, _) = small
    jst = ref["st"]
    np.testing.assert_array_equal(st.kf_valid, jst.kf_valid)
    np.testing.assert_array_equal(st.mp_valid, jst.mp_valid)
    np.testing.assert_array_equal(st.kf_point, jst.kf_point)
    dR = np.abs(st.kf_R - jst.kf_R).max()
    dt = np.abs(st.kf_t - jst.kf_t).max()
    dx = np.abs(st.mp_xyz[st.mp_valid] - jst.mp_xyz[st.mp_valid]).max()
    print(f"after the correction: dR {dR:.3g} dt {dt:.3g} points {dx:.3g} (bound {TOL})")
    assert max(dR, dt, dx) <= TOL
    assert [sorted(e) for e in st.kf_loop_edges] == [sorted(e) for e in jst.kf_loop_edges]
    np.testing.assert_array_equal(st.mp_desc[st.mp_valid], jst.mp_desc[st.mp_valid])
    np.testing.assert_allclose(st.mp_max_dist[st.mp_valid], jst.mp_max_dist[st.mp_valid], atol=TOL)
    done = next(e for e in events if e["event"] == "essential_graph_done")
    assert abs(done["chi2"] - ref["eg_chi2"]) <= 0.01 * ref["eg_chi2"]
    kinds = next(e for e in events if e["event"] == "essential_graph_edges")
    assert {k: kinds[k] for k in ref["eg_kinds"]} == ref["eg_kinds"]
    # the drifted tail is pulled back toward the true trajectory, the start stays
    info = ref["info"]
    c = loop_scene.camera_centres(st)
    drift = float(np.linalg.norm(info["drift"]))
    for k in range(5, 9):
        assert np.linalg.norm(c[k] - info["true_centres"][k]) < 0.55 * drift
    for k in (0, 1):
        assert np.linalg.norm(c[k] - info["true_centres"][k]) < 0.4 * drift


@pytest.mark.parametrize("scene,cap", [("small", 12), ("dense", 17)])
def test_essential_graph_edge_overflow_keeps_the_same_edges(jax_vocab, scene, cap):
    """A small edge capacity. `small` with eg_edges = 12 is the reference's
    own case: its 9 edges (8 spanning, the loop edge) fit. On `dense` the
    8 loop connections, 8 spanning edges and 3 strong covisibility edges
    overflow a capacity of 17: structural edges survive, the weakest
    covisibility edges drop, in both packages alike."""
    ref = fixture_tool.run_reference(scene, 0, jax_vocab, global_ba=False, eg_edges=cap)
    st, per_kf, events, prob = _port_run(jax_vocab, ref, eg_edges=cap, scene=scene)
    assert per_kf == ref["per_kf"] and per_kf[-1]["closed"]

    def pairs(e_i, e_j, e_valid):
        return [(min(int(a), int(b)), max(int(a), int(b)))
                for a, b, v in zip(e_i, e_j, e_valid) if v]

    jp = ref["eg_problem"]
    got = pairs(prob.e_i.numpy(), prob.e_j.numpy(), prob.e_valid.numpy())
    want = pairs(jp["e_i"], jp["e_j"], jp["e_valid"])
    assert got == want and len(set(got)) == len(got) <= cap == prob.e_i.shape[0]
    for k in range(1, 9):
        assert (k - 1, k) in got               # the spanning tree
    assert (0, 8) in got                       # the loop edge itself
    dropped = [e["dropped"] for e in events if e["event"] == "essential_graph_edges_dropped"]
    kinds = next(e for e in events if e["event"] == "essential_graph_edges")
    print(f"{scene}: {kinds}, dropped {dropped}")
    assert {k: kinds[k] for k in ref["eg_kinds"]} == ref["eg_kinds"]
    if scene == "dense":
        assert len(got) == cap and dropped and dropped[0] == kinds["total"] - cap > 0
        assert kinds["covisibility"] > dropped[0] and kinds["loop"] == 8
    else:
        assert len(got) == 9 and not dropped
    np.testing.assert_allclose(prob.e_t.numpy(), jp["e_t"], atol=1e-5)
    np.testing.assert_allclose(st.kf_t, ref["st"].kf_t, atol=TOL)


def _drift_chain(MapStateCls, **create_kw):
    """The 32-keyframe chain with linearly accumulating drift of the
    reference's test_correction_propagates_beyond_covisible_group."""
    rng = np.random.default_rng(7)
    N, n_per = 32, 30
    st = MapStateCls.create(max_kf=64, max_mp=4096, n_feat=64, max_obs=8, **create_kw)
    drift_full = np.array([0.6, 0.0, 0.3], np.float32)
    gt_centre = lambda k: np.array([0.25 * k, 0.0, 0.0], np.float32)
    est_centre = lambda k: gt_centre(k) + (k / (N - 1)) * drift_full
    sets = []
    for k in range(N - 1):
        gt_pts = np.stack([rng.uniform(-1.2, 1.2, n_per), rng.uniform(-0.9, 0.9, n_per),
                           rng.uniform(3.0, 5.0, n_per)], 1).astype(np.float32) + gt_centre(k)
        est_pts = gt_pts + (k / (N - 1)) * drift_full
        desc = rng.integers(0, 256, (n_per, 32)).astype(np.uint8)
        sets.append((st.add_points(est_pts, desc, ref_kf=k), est_pts, desc))
    for k in range(N):
        obs = []
        for s in ([k - 1] if k > 0 else []) + ([k] if k < N - 1 else []):
            obs += list(zip(*sets[s]))
        xyz = np.array([o[1] for o in obs], np.float32)
        c = est_centre(k)
        kf = st.add_keyframe(
            np.eye(3, dtype=np.float32), -c, loop_scene.project(xyz - c[None, :]),
            np.zeros(len(obs), np.int32), np.zeros(len(obs), np.float32),
            np.array([o[2] for o in obs], np.uint8), np.ones(len(obs), bool))
        for f, (mp, _, _) in enumerate(obs):
            st.add_observation(int(mp), kf, f)
        if k > 0:
            st.kf_parent[k] = k - 1
    return st, N, gt_centre


def test_correct_loop_alone_on_a_32_keyframe_chain_matches_jax():
    cfg_kw = dict(pipelined_tracking=False, fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                  max_kf=64, max_mp=4096, n_features=64)
    jst, N, gt_centre = _drift_chain(JMapState)
    jcfg = JConfig(**cfg_kw)
    jcfg.distributed_gba = False      # the test process shows 8 host devices
    jst.update_point_attributes(np.nonzero(jst.mp_valid)[0], jcfg.scale_factors)
    st, _, _ = _drift_chain(MapState, device="cpu")
    cfg = SlamConfig(**cfg_kw)
    dm = DeviceMap(st.max_kf, st.n_feat, st.max_mp, device="cpu")
    dm.sync_all(st)
    st.update_point_attributes(np.nonzero(st.mp_valid)[0], cfg.scale_factors, dm)
    np.testing.assert_allclose(st.mp_max_dist[st.mp_valid], jst.mp_max_dist[jst.mp_valid], atol=1e-5)
    # the true corrected Sim3 of the closing keyframe relative to loop keyframe 0
    S_cw = (np.float32(1.0), np.eye(3, dtype=np.float32), -gt_centre(N - 1))
    S_lw = (np.float32(1.0), st.kf_R[0].copy(), st.kf_t[0].copy())
    s_cl, R_cl, t_cl = tlc._compose_np(S_cw, tlc._inverse_np(S_lw))
    for a, b in zip((s_cl, R_cl, t_cl), jlc._compose_np(S_cw, jlc._inverse_np(S_lw))):
        np.testing.assert_array_equal(a, b)
    before = np.linalg.norm(loop_scene.camera_centres(st)[:N] - np.stack(
        [gt_centre(k) for k in range(N)]), axis=1)
    jlc.LoopCloser(jcfg, jst, None).correct_loop(N - 1, 0, s_cl, R_cl, t_cl, None, None)
    tlc.LoopCloser(cfg, st, None, device="cpu").correct_loop(N - 1, 0, s_cl, R_cl, t_cl, None, None)
    dR, dt = np.abs(st.kf_R - jst.kf_R).max(), np.abs(st.kf_t - jst.kf_t).max()
    dx = np.abs(st.mp_xyz[st.mp_valid] - jst.mp_xyz[st.mp_valid]).max()
    print(f"correct_loop alone: dR {dR:.3g} dt {dt:.3g} points {dx:.3g} (bound {TOL})")
    assert max(dR, dt, dx) <= TOL
    assert st.kf_loop_edges[N - 1] == {0} and st.kf_loop_edges[0] == {N - 1}
    # keyframes outside the covisible group {30, 31} move toward the truth
    after = np.linalg.norm(loop_scene.camera_centres(st)[:N] - np.stack(
        [gt_centre(k) for k in range(N)]), axis=1)
    for k in range(5, N - 2):
        assert after[k] < 0.35 * before[k] + 0.02, (k, after[k], before[k])


def test_shipping_size_scene_against_the_recorded_reference():
    """max_kf 256, max_mp 16384, 2000 feature rows, eg_edges 2048, the
    64k-word tree vocabulary: the functions of `chip_smoke.py`'s loop phase,
    here on the CPU, against `loop_fixture.npz`."""
    vocab = load_vocabulary(chip_smoke.VOCAB, device="cpu")
    slam, info, lf, meta = chip_smoke.loop_system("cpu", vocab)
    assert (slam.map.max_kf, slam.map.max_mp, slam.map.n_feat, slam.cfg.eg_edges) == (
        256, 16384, 2000, 2048)
    assert slam.n_keyframes >= 40 and slam.n_points >= 10000
    assert (slam.map.kf_point[slam.map.kf_valid] >= 0).sum(1).min() >= 500
    out = chip_smoke.loop_run(slam, info, lf)
    held = chip_smoke.loop_hold(out, info, lf, meta)
    print(held)
    assert slam.n_loops_closed == 1 and held["eg_n_edges"] == 111
    ba_held = chip_smoke.loop_global_ba(slam, meta)
    print(ba_held)
    assert ba_held["shape"] == [256, 16384, 65536]
