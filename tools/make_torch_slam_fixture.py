"""Write the PyTorch port's whole-system fixture from the JAX reference.

Renders the first frames of the synthetic `xyz` sequence and runs the JAX
`Slam` over them at the shipping widths with synchronous tracking and
mapping, recording what the port's `Slam` is held to:

  * the frames, their timestamps and ground-truth poses, the configuration;
  * per frame: the tracking state, the pose (NaN when none), `n_inliers`;
  * the map's keyframe and point counts and the keyframe trajectory after
    `finish()`, and the keyframe trajectory's Sim3-aligned ATE;
  * the RANSAC minimal sets of every initialization attempt (the reference
    draws them with `jax.random`, which torch cannot reproduce; the port
    takes them as an input);
  * a frame where the WORKING step takes its wide recovery pass: the
    tracking fixture's first frame and slice from a seed pose turned 8
    degrees about the optical axis and moved 0.1 along x, with the JAX
    step's outputs.

The frames need the renderer (cv2) and the outcome needs JAX, so the file
carries both to a machine that has neither.

    env JAX_PLATFORMS=cpu python tools/make_torch_slam_fixture.py

Runs on the CPU in a few minutes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "orbslam_jpminipc_torch", "data", "slam_fixture_xyz.npz",
)
SLICE_CONFIG = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0,
                    p1=0.0, p2=0.0, n_features=1000, pipelined_tracking=False,
                    async_mapping=False)


def record_init_sets(tracking, initializer, attempts: list):
    """Wrap the JAX tracker's initialization program so every attempt's
    minimal sets are recomputed from its key and match mask, exactly as
    `initializer.initialize` draws them, and appended to `attempts`."""
    import jax

    orig = tracking._init_attempt

    def wrapped(key, *args):
        out = orig(key, *args)
        k1, _ = jax.random.split(key)
        sets = initializer._sample_minimal_sets(k1, out[2], 200)
        attempts.append(np.asarray(sets, np.int32))
        return out

    tracking._init_attempt = wrapped
    return orig


def run_reference(cfg_kw: dict, images, timestamps, vocab=None):
    """The JAX Slam over `images`; returns its per-frame outcome, the init
    attempts' minimal sets (with the frame of each) and the Slam."""
    from orbslam_jpminipc_tpu.config import SlamConfig
    from orbslam_jpminipc_tpu.frontend import tracking
    from orbslam_jpminipc_tpu.pipeline.system import Slam
    from orbslam_jpminipc_tpu.solvers import initializer

    attempts: list = []
    attempt_frame: list = []
    orig = record_init_sets(tracking, initializer, attempts)
    try:
        slam = Slam(SlamConfig(**cfg_kw), vocab=vocab)
        states, poses, inliers, nkf, npt = [], [], [], [], []
        for i, (img, ts) in enumerate(zip(images, timestamps)):
            before = len(attempts)
            state, frame = slam.process(img, float(ts))
            attempt_frame += [i] * (len(attempts) - before)
            states.append(state.value)
            pose = np.full((3, 4), np.nan, np.float32)
            if frame is not None and frame.R is not None:
                pose[:, :3], pose[:, 3] = frame.R, frame.t
            poses.append(pose)
            inliers.append(int(slam.tracker.n_inliers))
            nkf.append(slam.n_keyframes)
            npt.append(slam.n_points)
            print(f"frame {i}: {state.name} inl {inliers[-1]} "
                  f"kf {nkf[-1]} pts {npt[-1]}", file=sys.stderr)
        slam.finish()
    finally:
        tracking._init_attempt = orig
    sets = (np.stack(attempts) if attempts
            else np.zeros((0, 200, 8), np.int32))
    return dict(
        states=np.array(states, np.int8), poses=np.stack(poses),
        n_inliers=np.array(inliers, np.int32),
        n_keyframes_per_frame=np.array(nkf, np.int32),
        n_points_per_frame=np.array(npt, np.int32),
        init_sets=sets, init_frames=np.array(attempt_frame, np.int32),
    ), slam


def keyframe_arrays(slam):
    kft = slam.keyframe_trajectory()
    ts = np.array([k[0] for k in kft], np.float64)
    R = np.stack([k[1] for k in kft]).astype(np.float32)
    t = np.stack([k[2] for k in kft]).astype(np.float32)
    return ts, R, t


def keyframe_ate(kf_ts, kf_R, kf_t, timestamps, gt_R, gt_t) -> float:
    from orbslam_jpminipc_tpu.io.trajectory import ate_rmse

    index = {round(float(ts), 6): i for i, ts in enumerate(timestamps)}
    est = np.stack([-R.T @ t for R, t in zip(kf_R, kf_t)])
    gi = [index[round(float(ts), 6)] for ts in kf_ts]
    gt = np.stack([-gt_R[i].T @ gt_t[i] for i in gi])
    return ate_rmse(est.astype(np.float64), gt.astype(np.float64))


TRACK_FIXTURE = os.path.join(os.path.dirname(DEFAULT_OUT), "track_fixture_xyz.npz")


def recovery_case(track_fixture: str = TRACK_FIXTURE) -> dict:
    """The fused step from a perturbed seed pose, through the JAX step."""
    import jax.numpy as jnp

    from orbslam_jpminipc_tpu.config import SlamConfig
    from orbslam_jpminipc_tpu.frontend.fused_track import make_fused_step

    fx = np.load(track_fixture)
    a = np.radians(8.0)
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                  np.float32)
    R0 = rz @ fx["R0"]
    t0 = rz @ fx["t0"] + np.float32([0.1, 0.0, 0.0])
    kw = SLICE_CONFIG
    step = make_fused_step(SlamConfig(**kw))
    out = step(jnp.asarray(fx["images"][0]), jnp.asarray(R0), jnp.asarray(t0),
               jnp.asarray(fx["vel_R0"]), jnp.asarray(fx["vel_t0"]), jnp.asarray(True),
               jnp.asarray(fx["slice_buf"]))
    pull = np.asarray(out.pull)
    n = kw["n_features"]
    packed = pull[:16].view(np.float32)
    print(f"recovery frame: inl2/inl1/m2/m1 = {packed[12:16].astype(int).tolist()}",
          file=sys.stderr)
    return dict(recovery_R0=R0, recovery_t0=t0,
                recovery_out_R=packed[:9].reshape(3, 3).copy(),
                recovery_out_t=packed[9:12].copy(),
                recovery_out_stats=packed[12:16].astype(np.int32),
                recovery_out_feat_bind=pull[16:16 + n].astype(np.int32),
                recovery_out_flags=pull[16 + n:].astype(np.uint8))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--frames", type=int, default=28)
    args = ap.parse_args()

    import jax

    from orbslam_jpminipc_tpu.io.dataset import SyntheticSequence

    seq = SyntheticSequence(n_frames=45, trajectory="xyz", seed=3)
    n = args.frames
    images = np.stack([seq.get(i)[0] for i in range(n)])
    timestamps = np.asarray(seq.timestamps[:n], np.float64)
    gt_R = np.stack([seq.poses[i][0] for i in range(n)]).astype(np.float32)
    gt_t = np.stack([seq.poses[i][1] for i in range(n)]).astype(np.float32)

    out, slam = run_reference(SLICE_CONFIG, images, timestamps)
    kf_ts, kf_R, kf_t = keyframe_arrays(slam)
    ate = keyframe_ate(kf_ts, kf_R, kf_t, timestamps, gt_R, gt_t)
    print(f"after finish: {slam.n_keyframes} KFs, {slam.n_points} points, "
          f"kf-ATE {ate:.6f}; {len(out['init_sets'])} init attempts",
          file=sys.stderr)

    rec = recovery_case()

    meta = {
        "command": "env JAX_PLATFORMS=cpu python tools/make_torch_slam_fixture.py "
                   f"--frames {n}",
        "sequence": "SyntheticSequence(n_frames=45, trajectory='xyz', seed=3)",
        "config": SLICE_CONFIG,
        "vocab": None,
        "jax": jax.__version__,
        "numpy": np.__version__,
        "jax_backend": jax.default_backend(),
        "states": "TrackState values: 0 NO_IMAGES_YET, 1 NOT_INITIALIZED, "
                  "2 INITIALIZING, 3 WORKING, 4 LOST",
        "poses": "(frames, 3, 4) world->camera [R | t], NaN when none",
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(
        args.out,
        meta=np.array(json.dumps(meta)),
        images=images, timestamps=timestamps, gt_R=gt_R, gt_t=gt_t,
        **out,
        n_keyframes=np.array(slam.n_keyframes), n_points=np.array(slam.n_points),
        kf_timestamps=kf_ts, kf_R=kf_R, kf_t=kf_t, kf_ate=np.array(ate),
        **rec,
    )
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)", file=sys.stderr)


if __name__ == "__main__":
    main()
