"""PyTorch port vs the JAX package: the multi-device solvers (parallel/).

The reference runs on the 8-device virtual CPU mesh tests/conftest.py sets;
the port on a `DeviceMesh` of S shards on the CPU device (the in-process
mesh; across processes see tests/test_torch_multihost.py).

Held:
  * `shard_ba_problem` and `shard_essential_graph`: every array equal to the
    reference's at S in {1, 2, 3, 8};
  * `sharded_bundle_adjust` at S in {1, 2, 8} on tests/test_ba.py's problem
    against the reference's at the same S: chi2 within 1e-3 relative, R
    within 2e-4, t within 2e-3, points within 4e-3, outlier flags equal
    (measured on the CPU, printed with -s: 1e-5, 2.9e-5, 2.0e-4, 4.0e-4; tests/test_parallel.py
    holds the reference to chi2 1 % + 0.1, R 1e-2, aligned points 2e-2);
  * `sharded_optimize_essential_graph` at S in {2, 8} on
    tests/test_sharded_pose_graph.py's drifted loop: t within 2e-3, s within
    1e-4 of the reference's (that file's bounds), and the loop closed;
  * `Slam.global_ba` on the constructed loop scene of tools/loop_scene.py,
    the port's device list monkeypatched to 8 CPU shards, against the JAX
    `Slam.global_ba` on the same map, which takes its sharded branch on the
    8 virtual devices: poses within 1e-3, points within 1e-3 plus 1e-3 of
    their coordinates;
  * `LoopCloser.process` over the loop scene's tail, the port's device list
    monkeypatched to 8 CPU shards, against the JAX `LoopCloser`, which takes
    its edge-sharded essential graph on the 8 virtual devices: both close
    the loop through the sharded solver at 8 shards; that solve's s within
    1e-4, t within 2e-3 (tests/test_sharded_pose_graph.py's bounds) and R
    within 1e-3 of the reference's; its chi2 within 1 %; every pose and
    point after the correction within 1e-3, as the single-device closers
    are held in tests/test_torch_loop_closing.py;
  * `dryrun_multichip(2)`'s asserts.
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from orbslam_jpminipc_tpu.parallel import (
    shard_ba_problem as j_shard_ba, shard_essential_graph as j_shard_eg,
    sharded_bundle_adjust as j_sba, sharded_optimize_essential_graph as j_seg,
)
from orbslam_jpminipc_torch.parallel import (
    DeviceMesh, shard_ba_problem, shard_essential_graph, sharded_bundle_adjust,
    sharded_optimize_essential_graph,
)
from orbslam_jpminipc_torch.parallel.dryrun import dryrun_multichip
from orbslam_jpminipc_torch.solvers import ba as tba
from orbslam_jpminipc_torch.solvers import essential_graph as teg

from test_ba import make_ba_problem
from test_sharded_pose_graph import _drifted_loop_problem

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _to_torch(prob, cls):
    f = {k: torch.from_numpy(np.array(v)) for k, v in prob._asdict().items()}
    for k in ("obs_kf", "obs_pt", "e_i", "e_j"):
        if k in f:
            f[k] = f[k].to(torch.int64)
    return cls(**f)


def _jmesh(n, axis):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_shard_arrays_equal(n_shards):
    prob, *_ = make_ba_problem(np.random.default_rng(0), n_kf=5, n_pts=96)
    ref = j_shard_ba(prob, n_shards)
    got = shard_ba_problem(_to_torch(prob, tba.BAProblem), n_shards)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    gprob, _ = _drifted_loop_problem(np.random.default_rng(0))
    ref = j_shard_eg(gprob, n_shards)
    got = shard_essential_graph(_to_torch(gprob, teg.EssentialGraphProblem), n_shards)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_sharded_bundle_adjust_matches_reference(n_shards):
    prob, *_ = make_ba_problem(np.random.default_rng(0), n_kf=5, n_pts=96)
    R0, t0, p0, c0, o0 = j_sba(j_shard_ba(prob, n_shards), _jmesh(n_shards, "points"),
                               iterations=8)
    R, t, pts, chi2, out = sharded_bundle_adjust(
        shard_ba_problem(_to_torch(prob, tba.BAProblem), n_shards),
        DeviceMesh(["cpu"] * n_shards), iterations=8)
    assert pts.shape == p0.shape and out.shape == o0.shape
    print(f"{n_shards} shards: chi2 {float(chi2):.6g} (ref {float(c0):.6g}), max diffs: R "
          f"{np.abs(R.numpy() - np.asarray(R0)).max():.3g}, t "
          f"{np.abs(t.numpy() - np.asarray(t0)).max():.3g}, points "
          f"{np.abs(pts.numpy() - np.asarray(p0)).max():.3g}")
    np.testing.assert_allclose(float(chi2), float(c0), rtol=1e-3)
    np.testing.assert_allclose(R.numpy(), np.asarray(R0), atol=2e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(t0), atol=2e-3)
    np.testing.assert_allclose(pts.numpy(), np.asarray(p0), atol=4e-3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(o0))
    # the gauge camera is held
    np.testing.assert_array_equal(t.numpy()[0], np.asarray(prob.kf_t)[0])


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_essential_graph_matches_reference(n_shards):
    gprob, t_true = _drifted_loop_problem(np.random.default_rng(0))
    ref = j_seg(j_shard_eg(gprob, n_shards), _jmesh(n_shards, "edges"), iterations=20)
    res = sharded_optimize_essential_graph(
        shard_essential_graph(_to_torch(gprob, teg.EssentialGraphProblem), n_shards),
        DeviceMesh(["cpu"] * n_shards), iterations=20)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(ref.t), atol=2e-3)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), atol=1e-4)
    assert np.linalg.norm(res.t.numpy() - t_true, axis=1).max() < 0.01


def _scene_slam(pkg: str):
    """A `Slam` of either package (vocab None) whose map is the constructed
    loop scene, built from the same seed by the same code."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import loop_scene

    if pkg == "jax":
        from orbslam_jpminipc_tpu.config import SlamConfig
        from orbslam_jpminipc_tpu.map.map_state import MapState
        from orbslam_jpminipc_tpu.pipeline.system import Slam
        st, info = loop_scene.build_loop_scene(MapState, "small", 0)
        slam = Slam(SlamConfig(**info["cfg"]), vocab=None)
    else:
        from orbslam_jpminipc_torch.config import SlamConfig
        from orbslam_jpminipc_torch.map.map_state import MapState
        from orbslam_jpminipc_torch.pipeline.system import Slam
        st, info = loop_scene.build_loop_scene(MapState, "small", 0, device="cpu")
        slam = Slam(SlamConfig(**info["cfg"]), vocab=None, device="cpu")
    slam.map = slam.tracker.map = slam.mapper.map = st
    dm = slam.mapper.dmap
    dm.sync_all(st)
    loop_scene.finish_scene(st, info, None,
                            lambda ids: st.update_point_attributes(ids, slam.cfg.scale_factors,
                                                                   dmap=dm))
    dm.sync_all(st)
    return slam


def test_slam_global_ba_on_eight_shards_matches_reference(monkeypatch):
    from orbslam_jpminipc_torch.parallel import mesh as pmesh
    from orbslam_jpminipc_torch.pipeline import system as tsystem

    assert len(jax.devices()) == 8
    ref = _scene_slam("jax")
    assert ref.cfg.distributed_gba
    ref.global_ba()
    slam = _scene_slam("port")
    before = slam.map.kf_t.copy()
    calls = []
    real = tsystem.sharded_bundle_adjust

    def spy(sprob, mesh, iterations):
        calls.append((sprob.points.shape[0], len(mesh.devices)))
        return real(sprob, mesh, iterations=iterations)

    monkeypatch.setattr(pmesh, "mesh_devices", lambda device: [torch.device("cpu")] * 8)
    monkeypatch.setattr(tsystem, "sharded_bundle_adjust", spy)
    slam.global_ba()
    assert calls == [(8, 8)]
    st, jst = slam.map, ref.map
    live = st.kf_valid
    np.testing.assert_array_equal(live, jst.kf_valid)
    assert np.abs(st.kf_t[live] - before[live]).max() > 0
    np.testing.assert_allclose(st.kf_R[live], jst.kf_R[live], atol=1e-3)
    np.testing.assert_allclose(st.kf_t[live], jst.kf_t[live], atol=1e-3)
    pv = st.mp_valid
    np.testing.assert_array_equal(pv, jst.mp_valid)
    np.testing.assert_allclose(st.mp_xyz[pv], jst.mp_xyz[pv], atol=1e-3, rtol=1e-3)


def test_loop_closer_on_eight_shards_matches_reference(monkeypatch):
    import test_torch_loop_closing as tl
    from orbslam_jpminipc_tpu.map.map_state import MapState as JMapState
    from orbslam_jpminipc_tpu.vocab.vocabulary import build_vocabulary
    from orbslam_jpminipc_torch.parallel import mesh as pmesh
    from orbslam_jpminipc_torch.pipeline import loop_closing as tlc

    assert len(jax.devices()) == 8
    _, info = tl.loop_scene.build_loop_scene(JMapState, "small", 0)
    vocab = build_vocabulary(info["vocab_descriptors"], n_words=256, iters=3, seed=0)
    ref = tl.fixture_tool.run_reference("small", 0, vocab, global_ba=False, distributed=True)
    assert ref["closed_kf"] == 8 and ref["eg_shards"] == 8
    calls, results = [], []
    real = tlc.sharded_optimize_essential_graph

    def spy(sprob, mesh, iterations):
        calls.append((sprob.e_i.shape[0], len(mesh.devices)))
        results.append(real(sprob, mesh, iterations=iterations))
        return results[-1]

    monkeypatch.setattr(pmesh, "mesh_devices", lambda device: [torch.device("cpu")] * 8)
    monkeypatch.setattr(tlc, "sharded_optimize_essential_graph", spy)
    st, per_kf, events, single_device_problem = tl._port_run(vocab, ref)
    assert single_device_problem is None and calls == [(8, 8)]
    assert per_kf == ref["per_kf"]
    got, want = results[0], ref["eg_result"]
    ds = np.abs(got.s.numpy() - want["s"]).max()
    dR = np.abs(got.R.numpy() - want["R"]).max()
    dt = np.abs(got.t.numpy() - want["t"]).max()
    print(f"sharded essential graph at 8 shards: max |ds| {ds:.3g}, |dR| {dR:.3g}, |dt| {dt:.3g}")
    assert ds <= 1e-4 and dR <= 1e-3 and dt <= 2e-3
    done = next(e for e in events if e["event"] == "essential_graph_done")
    assert abs(done["chi2"] - ref["eg_chi2"]) <= 0.01 * ref["eg_chi2"]
    jst = ref["st"]
    np.testing.assert_array_equal(st.kf_valid, jst.kf_valid)
    np.testing.assert_array_equal(st.mp_valid, jst.mp_valid)
    assert st.kf_loop_edges[8] == jst.kf_loop_edges[8] == {0}
    np.testing.assert_allclose(st.kf_R, jst.kf_R, atol=tl.TOL)
    np.testing.assert_allclose(st.kf_t, jst.kf_t, atol=tl.TOL)
    np.testing.assert_allclose(st.mp_xyz[st.mp_valid], jst.mp_xyz[jst.mp_valid], atol=tl.TOL)


def test_dryrun_multichip_two_shards():
    r = dryrun_multichip(2, device="cpu")
    assert r["devices"] == ["cpu", "cpu"]
    assert np.isfinite(r["chi2_2_iterations"]) and np.isfinite(r["pose_graph_chi2"])
    assert r["chi2_rel"] < 0.01 and r["max_point_delta"] < 0.01 * r["extent"]
