"""Write the PyTorch port's relocalization fixture from the JAX reference.

Runs the JAX `Slam` with the 64k-word tree vocabulary, synchronous tracking
and mapping and loop closing off, at the shipping widths, over a forced
loss: frames 0-27 of the synthetic `xyz` sequence (the frames the system
fixture already holds), then noise frames (the camera covered), then the
sequence's remaining frames. It records what the port's `Slam` is held to
on that run, and only what the system fixture lacks:

  * frames `--resume`..44, their timestamps and ground-truth poses;
  * per frame of the whole run: the tracking state, the pose (NaN when
    none), `n_inliers`, keyframe and point counts;
  * the keyframe trajectory after `finish()` and its Sim3-aligned ATE;
  * the relocalization log: the tracer's `reloc_candidates`,
    `reloc_attempt`, `reloc_opt` and `reloc_refine` records, as JSON;
  * the minimal sets of every initialization attempt and of every PnP
    candidate attempt. The reference draws them with `jax.random`, which
    torch cannot reproduce, so the port takes them as an input. The PnP
    sets are recomputed from each attempt's key and match mask exactly as
    `solvers/pnp.py:solve_pnp` draws them.

The noise frames are `np.random.default_rng(5).integers(0, 256, (480, 640))`
drawn in order; they are not stored, a reader makes them again.

    env JAX_PLATFORMS=cpu python tools/make_torch_reloc_fixture.py

Runs on the CPU in some minutes. `run_reference` is also what the CPU
parity tests call at small widths.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np  # noqa: E402

import make_torch_slam_fixture as slam_fixture  # noqa: E402

DEFAULT_OUT = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "reloc_fixture_xyz.npz")
VOCAB = os.path.join(REPO, "orbslam_jpminipc_tpu", "data", "vocab_tree64k.npz")
CONFIG = dict(slam_fixture.SLICE_CONFIG)
NOISE_SEED = 5
PNP_HYP = 256
PNP_SET = 4


def noise_frames(n: int, shape=(480, 640)) -> np.ndarray:
    rng = np.random.default_rng(NOISE_SEED)
    return np.stack([rng.integers(0, 256, shape).astype(np.uint8) for _ in range(n)]) \
        if n else np.zeros((0, *shape), np.uint8)


def noise_timestamps(t_before: float, t_after: float, n: int) -> np.ndarray:
    """n timestamps strictly between two frames' (the covered camera)."""
    return t_before + (t_after - t_before) * (np.arange(n) + 1) / (n + 1)


def record_pnp_sets(tracking, attempts: list, keep_args: list | None = None):
    """Wrap the JAX tracker's relocalization-candidate program: every
    attempt's minimal sets are recomputed from its key and the match mask
    it returned, as `solve_pnp` draws them, and appended to `attempts`.
    With `keep_args`, the attempt's inputs and outputs are kept too."""
    import jax
    import jax.numpy as jnp

    orig = tracking._reloc_candidate_prog

    def wrapped(key, *args):
        out = orig(key, *args)
        mask = out[1]
        scores = jax.random.uniform(key, (PNP_HYP, mask.shape[0]))
        scores = jnp.where(mask[None, :], scores, -1.0)
        _, sets = jax.lax.top_k(scores, PNP_SET)
        attempts.append(np.asarray(sets, np.int32))
        if keep_args is not None:
            keep_args.append((jax.device_get(args), jax.device_get(out)))
        return out

    tracking._reloc_candidate_prog = wrapped
    return orig


def run_reference(cfg_kw: dict, images, timestamps, vocab, keep_args: list | None = None):
    """The JAX Slam (loop closing off) over `images`; returns its per-frame
    outcome, the minimal sets of its initialization and PnP attempts, its
    relocalization log, and the Slam."""
    from orbslam_jpminipc_tpu.config import SlamConfig
    from orbslam_jpminipc_tpu.frontend import tracking
    from orbslam_jpminipc_tpu.pipeline.system import Slam
    from orbslam_jpminipc_tpu.solvers import initializer
    from orbslam_jpminipc_tpu.utils.tracing import get_tracer

    init_sets: list = []
    pnp_sets: list = []
    pnp_frame: list = []
    events: list = []
    orig_init = slam_fixture.record_init_sets(tracking, initializer, init_sets)
    orig_pnp = record_pnp_sets(tracking, pnp_sets, keep_args)
    tracer = get_tracer()
    orig_log = tracer.log

    def log(event, **fields):
        if event.startswith("reloc_"):
            events.append({"event": event, **fields})
        return orig_log(event, **fields)

    tracer.log = log
    try:
        slam = Slam(SlamConfig(**cfg_kw), vocab=vocab, enable_loop_closing=False)
        states, poses, inliers, nkf, npt = [], [], [], [], []
        for i, (img, ts) in enumerate(zip(images, timestamps)):
            before = len(pnp_sets)
            state, frame = slam.process(img, float(ts))
            pnp_frame += [i] * (len(pnp_sets) - before)
            states.append(state.value)
            pose = np.full((3, 4), np.nan, np.float32)
            if frame is not None and frame.R is not None:
                pose[:, :3], pose[:, 3] = frame.R, frame.t
            poses.append(pose)
            inliers.append(int(slam.tracker.n_inliers))
            nkf.append(slam.n_keyframes)
            npt.append(slam.n_points)
            print(f"frame {i}: {state.name} inl {inliers[-1]} kf {nkf[-1]} pts {npt[-1]}",
                  file=sys.stderr)
        slam.finish()
    finally:
        tracking._init_attempt = orig_init
        tracking._reloc_candidate_prog = orig_pnp
        del tracer.log  # the instance attribute; the class's method shows again
    return dict(
        states=np.array(states, np.int8), poses=np.stack(poses),
        n_inliers=np.array(inliers, np.int32),
        n_keyframes_per_frame=np.array(nkf, np.int32),
        n_points_per_frame=np.array(npt, np.int32),
        init_sets=(np.stack(init_sets) if init_sets else np.zeros((0, 200, 8), np.int32)),
        pnp_sets=(np.stack(pnp_sets) if pnp_sets
                  else np.zeros((0, PNP_HYP, PNP_SET), np.int32)),
        pnp_frames=np.array(pnp_frame, np.int32),
        reloc_log=np.array(json.dumps(events)),
    ), slam


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--before", type=int, default=28, help="real frames before the loss")
    ap.add_argument("--noise", type=int, default=3, help="noise frames")
    ap.add_argument("--resume", type=int, default=28, help="first real frame after the loss")
    args = ap.parse_args()

    import jax

    from orbslam_jpminipc_tpu.io.dataset import SyntheticSequence
    from orbslam_jpminipc_tpu.vocab.vocabulary import load_vocabulary

    seq = SyntheticSequence(n_frames=45, trajectory="xyz", seed=3)
    n_seq = len(seq)
    head = list(range(args.before))
    tail = list(range(args.resume, n_seq))
    images = np.concatenate([
        np.stack([seq.get(i)[0] for i in head]),
        noise_frames(args.noise),
        np.stack([seq.get(i)[0] for i in tail]),
    ])
    ts_all = np.asarray(seq.timestamps, np.float64)
    timestamps = np.concatenate([
        ts_all[head],
        noise_timestamps(ts_all[args.before - 1], ts_all[args.before], args.noise),
        ts_all[tail],
    ])
    seq_index = np.array(head + [-1] * args.noise + tail, np.int32)
    gt_R = np.stack([seq.poses[i][0] for i in range(n_seq)]).astype(np.float32)
    gt_t = np.stack([seq.poses[i][1] for i in range(n_seq)]).astype(np.float32)

    out, slam = run_reference(CONFIG, images, timestamps, load_vocabulary(VOCAB))
    kf_ts, kf_R, kf_t = slam_fixture.keyframe_arrays(slam)
    ate = slam_fixture.keyframe_ate(kf_ts, kf_R, kf_t, ts_all, gt_R, gt_t)
    lost = np.nonzero(out["states"] == 4)[0]
    back = [i for i in range(len(images)) if lost.size and i > lost[0] and out["states"][i] == 3]
    print(f"after finish: {slam.n_keyframes} KFs, {slam.n_points} points, kf-ATE {ate:.6f}; "
          f"{len(out['pnp_sets'])} PnP attempts; LOST on {lost.tolist()}, WORKING again on "
          f"{back[:1]}", file=sys.stderr)

    meta = {
        "command": "env JAX_PLATFORMS=cpu python tools/make_torch_reloc_fixture.py "
                   f"--before {args.before} --noise {args.noise} --resume {args.resume}",
        "sequence": "SyntheticSequence(n_frames=45, trajectory='xyz', seed=3)",
        "run": f"frames 0-{args.before - 1}, {args.noise} noise frames "
               f"(np.random.default_rng({NOISE_SEED}).integers(0, 256, (480, 640)) in order), "
               f"frames {args.resume}-{n_seq - 1}",
        "config": CONFIG, "vocab": "vocab_tree64k.npz", "enable_loop_closing": False,
        "before": args.before, "noise": args.noise, "resume": args.resume,
        "noise_seed": NOISE_SEED,
        "jax": jax.__version__, "numpy": np.__version__, "jax_backend": jax.default_backend(),
        "states": "TrackState values: 0 NO_IMAGES_YET, 1 NOT_INITIALIZED, "
                  "2 INITIALIZING, 3 WORKING, 4 LOST",
        "poses": "(run frames, 3, 4) world->camera [R | t], NaN when none",
        "seq_index": "per run frame, its index in the sequence (-1: a noise frame)",
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(
        args.out,
        meta=np.array(json.dumps(meta)),
        images=images[args.before + args.noise:],
        timestamps=timestamps, seq_index=seq_index,
        seq_timestamps=ts_all, gt_R=gt_R, gt_t=gt_t,
        **out,
        n_keyframes=np.array(slam.n_keyframes), n_points=np.array(slam.n_points),
        kf_timestamps=kf_ts, kf_R=kf_R, kf_t=kf_t, kf_ate=np.array(ate),
    )
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)", file=sys.stderr)


if __name__ == "__main__":
    main()
