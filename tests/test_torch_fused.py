"""PyTorch port vs the JAX package: the whole WORKING tracking step.

A small live run of both packages' fused steps on the same inputs (with and
without the recovery pass), the full-size fixture run (real frames, the
reference system's map slice and pose) against the outputs the JAX step
recorded, and the carriers of state and settings into the port."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam_jpminipc_tpu.frontend import fused_track as jfused
from orbslam_jpminipc_tpu.config import SlamConfig as JaxSlamConfig
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend import fused_track as tfused
from orbslam_jpminipc_torch.ops import fast_cuda

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "track_fixture_xyz.npz")
SLAM_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "slam_fixture_xyz.npz")

# Full-size fixture run on the CPU vs the recorded JAX outputs. Measured:
# pose within 7e-8, bindings, flags and inlier counts identical on all 10
# frames; the bounds leave room for another CPU's reduction order.
POSE_TOL = 1e-5
BIND_MIN = 0.99
INLIER_REL = 0.01


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(FIXTURE))


def _seed_pose(fx):
    vel = (fx["vel_R0"], fx["vel_t0"]) if bool(fx["has_vel0"]) else None
    return fx["R0"], fx["t0"], vel


def _small_slice(fx, m=512):
    """The first m valid rows of the fixture's packed slice."""
    buf = fx["slice_buf"]
    rows = np.nonzero(buf[:, 7] > 0)[0][:m]
    return np.ascontiguousarray(buf[rows])


@pytest.mark.parametrize("motion", ["fixture", "wrong_velocity"])
def test_small_live_run_matches_jax(fixture, motion):
    """240x320 frames (the fixture subsampled 2x, so K halves), 300
    features, 4 levels, a 512-point slice: both steps, fed forward 3 frames.
    A wrong motion-model velocity makes pass 1 collapse on the first frame,
    so the wide recovery pass runs (three match passes instead of two)."""
    kw = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
              n_features=300, n_levels=4, pipelined_tracking=False)
    buf = _small_slice(fixture)
    jstep = jfused.make_fused_step(JaxSlamConfig(**kw), n_map=512)
    ctx = tfused.FusedContext(SlamConfig(**kw), n_map=512, device="cpu")
    R0, t0, vel = _seed_pose(fixture)
    if motion == "wrong_velocity":
        vel = (np.eye(3, dtype=np.float32), np.array([0.1, 0.0, 0.0], np.float32))
    ctx.set_pose(R0, t0, velocity=vel)
    ctx.set_slice(buf)
    passes = []
    match_pass = ctx.step._match_pass
    ctx.step._match_pass = lambda *a, **k: (passes.append(1), match_pass(*a, **k))[1]
    jR, jt = jnp.asarray(R0), jnp.asarray(t0)
    jvR, jvt = (jnp.asarray(vel[0]), jnp.asarray(vel[1])) if vel else (jnp.eye(3), jnp.zeros(3))
    jhas = jnp.asarray(vel is not None)
    n = 300
    for k in range(3):
        img = np.ascontiguousarray(fixture["images"][k][::2, ::2])
        passes.clear()
        out = ctx.track(img)
        if k == 0:
            assert len(passes) == (3 if motion == "wrong_velocity" else 2)
        jo = jstep(jnp.asarray(img), jR, jt, jvR, jvt, jhas, jnp.asarray(buf))
        jR, jt, jvR, jvt, jhas = jo.R, jo.t, jo.vel_R, jo.vel_t, jnp.asarray(True)
        pull = np.asarray(jo.pull)
        stats = pull[:16].view(np.float32)[12:16].astype(int)
        np.testing.assert_allclose(out.R.numpy(), np.asarray(jo.R), atol=POSE_TOL)
        np.testing.assert_allclose(out.t.numpy(), np.asarray(jo.t), atol=POSE_TOL)
        got_stats = [int(out.n_inl2), int(out.n_inl1), int(out.n_match2), int(out.n_match1)]
        assert got_stats == stats.tolist(), (k, got_stats, stats)
        if motion == "fixture":
            assert stats[0] >= 20, stats  # the passes really matched and optimized
        np.testing.assert_array_equal(out.feat_bind.numpy(), pull[16:16 + n])
        np.testing.assert_array_equal(out.flags.numpy(), pull[16 + n:].astype(np.uint8))
        np.testing.assert_array_equal(out.feats.desc.numpy(), np.asarray(jo.feats["desc"]))


def test_context_epoch_and_cleared_velocity_match_jax(fixture):
    """The context's bookkeeping against the JAX `FusedContext`: `epoch`
    counts every host overwrite of the device pose (`set_pose`,
    `invalidate`), `ready` needs a pose and a slice, and after
    `clear_velocity` a wrong velocity is ignored: the next step runs
    without the motion model in both packages (pose within 1e-5, stats
    equal), and the motion model is back on after it."""
    kw = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
              n_features=300, n_levels=4, pipelined_tracking=False)
    buf = _small_slice(fixture)
    jctx = jfused.FusedContext(JaxSlamConfig(**kw), n_map=512)
    ctx = tfused.FusedContext(SlamConfig(**kw), n_map=512, device="cpu")
    R0, t0, _ = _seed_pose(fixture)
    wrong = (np.eye(3, dtype=np.float32), np.array([0.1, 0.0, 0.0], np.float32))

    def both(fn):
        fn(jctx)
        fn(ctx)
        assert ctx.epoch == jctx.epoch
        assert ctx.ready == jctx.ready
        assert bool(ctx.has_vel) == bool(jctx.has_vel)

    def put_slice(c):
        if c is ctx:
            c.set_slice(buf)
        else:
            c.slice_buf = jnp.asarray(buf)

    both(lambda c: c.set_pose(R0, t0, velocity=wrong))
    both(put_slice)
    assert ctx.epoch == 1 and ctx.ready and bool(ctx.has_vel)
    both(lambda c: c.invalidate())
    assert ctx.epoch == 2 and not ctx.ready
    both(lambda c: c.set_pose(R0, t0, velocity=wrong))
    both(put_slice)
    both(lambda c: c.clear_velocity())
    assert ctx.epoch == 3 and ctx.ready and not bool(ctx.has_vel)
    img = np.ascontiguousarray(fixture["images"][0][::2, ::2])
    out = ctx.track(img)
    jo = jctx.track(img)
    assert bool(ctx.has_vel) and bool(jctx.has_vel) and ctx.epoch == jctx.epoch == 3
    np.testing.assert_allclose(out.R.numpy(), np.asarray(jo.R), atol=POSE_TOL)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(jo.t), atol=POSE_TOL)
    stats = np.asarray(jo.pull)[:16].view(np.float32)[12:16].astype(int)
    got = [int(out.n_inl2), int(out.n_inl1), int(out.n_match2), int(out.n_match1)]
    assert got == stats.tolist() and stats[0] >= 20, (got, stats)


def test_fixture_run_matches_recorded_reference(fixture):
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=1000,
                     pipelined_tracking=False)
    ctx = tfused.FusedContext(cfg, device="cpu")
    R0, t0, vel = _seed_pose(fixture)
    ctx.set_pose(R0, t0, velocity=vel)
    ctx.set_slice(fixture["slice_buf"])
    before = fast_cuda.LAUNCHES
    for k in range(len(fixture["images"])):
        out = ctx.track(fixture["images"][k])
        np.testing.assert_allclose(out.R.numpy(), fixture["out_R"][k], atol=POSE_TOL)
        np.testing.assert_allclose(out.t.numpy(), fixture["out_t"][k], atol=POSE_TOL)
        bind_eq = np.mean(out.feat_bind.numpy() == fixture["out_feat_bind"][k])
        assert bind_eq >= BIND_MIN, (k, bind_eq)
        ref_inl2 = int(fixture["out_stats"][k][0])
        assert abs(int(out.n_inl2) - ref_inl2) <= INLIER_REL * ref_inl2, (k, int(out.n_inl2))
        assert out.feat_bind.shape == (1000,) and out.flags.shape == (4096,)
    assert fast_cuda.LAUNCHES == before  # the CPU run never reaches the kernel


def test_recovery_pass_matches_jax(fixture):
    """Full-size step from a perturbed seed pose (the system fixture's: the
    tracking fixture's pose turned 8 degrees about the optical axis and
    moved 0.1 along x): pass 1 keeps fewer than 20 inliers, both packages
    run the wide pass and agree (pose within 1e-5, bindings and counts
    equal), and both agree with the outputs the fixture recorded."""
    kw = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=1000,
              pipelined_tracking=False)
    sf = np.load(SLAM_FIXTURE)
    R0, t0 = sf["recovery_R0"], sf["recovery_t0"]
    vel = (fixture["vel_R0"], fixture["vel_t0"])
    ctx = tfused.FusedContext(SlamConfig(**kw), device="cpu")
    ctx.set_pose(R0, t0, velocity=vel)
    ctx.set_slice(fixture["slice_buf"])
    inliers = []
    match_pass = ctx.step._match_pass

    def counting(*a, **k):
        r = match_pass(*a, **k)
        inliers.append(int(r.res.n_inliers))
        return r

    ctx.step._match_pass = counting
    out = ctx.track(fixture["images"][0])
    assert len(inliers) == 3 and inliers[0] < 20 <= inliers[1], inliers

    jstep = jfused.make_fused_step(JaxSlamConfig(**kw))
    jo = jstep(jnp.asarray(fixture["images"][0]), jnp.asarray(R0), jnp.asarray(t0),
               jnp.asarray(vel[0]), jnp.asarray(vel[1]), jnp.asarray(True),
               jnp.asarray(fixture["slice_buf"]))
    pull = np.asarray(jo.pull)
    stats = pull[:16].view(np.float32)[12:16].astype(int)
    # the reference kept the wide pass: its pass-1 count is the recovery's
    assert stats[1] == inliers[1], (stats, inliers)
    np.testing.assert_allclose(out.R.numpy(), np.asarray(jo.R), atol=POSE_TOL)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(jo.t), atol=POSE_TOL)
    got = [int(out.n_inl2), int(out.n_inl1), int(out.n_match2), int(out.n_match1)]
    assert got == stats.tolist(), (got, stats)
    np.testing.assert_array_equal(out.feat_bind.numpy(), pull[16:1016])
    np.testing.assert_array_equal(out.flags.numpy(), pull[1016:].astype(np.uint8))
    np.testing.assert_allclose(out.R.numpy(), sf["recovery_out_R"], atol=POSE_TOL)
    np.testing.assert_array_equal(out.feat_bind.numpy(), sf["recovery_out_feat_bind"])


def test_slice_from_packed_round_trip():
    rng = np.random.default_rng(0)
    m, n = 64, 50
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    mind = rng.uniform(0.1, 1, n).astype(np.float32)
    maxd = rng.uniform(1, 5, n).astype(np.float32)
    desc = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    n_obs = rng.integers(1, 9, n).astype(np.float32)
    buf = jfused.pack_slice(xyz, normal, mind, maxd, desc, n_obs, n, m)
    slc = tfused.slice_from_packed(buf, "cpu")
    np.testing.assert_array_equal(slc.xyz.numpy()[:n], xyz)
    np.testing.assert_array_equal(slc.normal.numpy()[:n], normal)
    np.testing.assert_array_equal(slc.min_dist.numpy()[:n], mind)
    np.testing.assert_array_equal(slc.max_dist.numpy()[:n], maxd)
    np.testing.assert_array_equal(slc.desc.numpy()[:n], desc)
    np.testing.assert_array_equal(slc.n_obs.numpy()[:n], n_obs)
    assert (slc.max_dist.numpy()[n:] == 0).all() and slc.desc.shape == (m, 32)
    with pytest.raises(ValueError):
        tfused.slice_from_packed(buf[:, :16], "cpu")
    R, t = tfused.pose_from_numpy(np.eye(3), [1, 2, 3], "cpu")
    assert R.dtype == torch.float32 and t.tolist() == [1.0, 2.0, 3.0]


@pytest.mark.parametrize("body", [
    "Camera.fx: 535.4\nCamera.fy: 539.2\nCamera.cx: 320.1\nCamera.cy: 247.6\n"
    "Camera.k1: 0.262383\nCamera.k2: -0.953104\nCamera.p1: -0.005358\n"
    "Camera.p2: 0.002628\nCamera.fps: 30.0\nCamera.RGB: 1\n\n"
    "# ORB Extractor\nORBextractor.nFeatures: 1200\nORBextractor.scaleFactor: 1.2\n"
    "ORBextractor.nLevels: 8\nORBextractor.fastTh: 20\nORBextractor.nScoreType: 0\n"
    "UseMotionModel: 0\n",
    "Camera.fx: 500\nCamera.fps: 0\n",  # defaults and the fps fallback
])
def test_config_from_yaml_matches_reference(tmp_path, body):
    path = tmp_path / "settings.yaml"
    path.write_text("%YAML:1.0\n\n# Camera Parameters\n" + body)
    got = dataclasses.asdict(SlamConfig.from_yaml(str(path)))
    ref = dataclasses.asdict(JaxSlamConfig.from_yaml(str(path)))
    assert got == ref


def test_port_imports_without_jax_or_cv2():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cv2'] = None\n"
        "import importlib, pkgutil\n"
        "import orbslam_jpminipc_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k.startswith('orbslam_jpminipc_tpu') for k in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
