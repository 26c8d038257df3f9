"""Command-line entry point: run SLAM over a dataset (counterpart of
orbslam_jpminipc_tpu/run.py).

The reference's `rosrun ORB_SLAM ORB_SLAM <vocabulary> <settings.yaml>`
(src/main.cc:58-66) becomes:

    python -m orbslam_jpminipc_torch.run --dataset synthetic:xyz --frames 300 \\
        [--settings settings.yaml] [--vocab vocab.npz] [--out KeyFrameTrajectory.txt] \\
        [--save-world w.npz] [--load-world w.npz] [--viz DIR] [--device cuda|cpu]

Datasets: `synthetic[:trajectory]` (the rendered room, rendered on the
device; the ground-truth ATE is printed) or `tum:<dir>` (a TUM RGB-D
sequence directory). Writes the keyframe trajectory in TUM format on exit
(main.cc:226-245) and saves and resumes worlds (SaveLoadWorld). It runs on
the current CUDA device unless `--device` names another; without a card
and without `--device cpu` it raises.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def default_vocabulary(device):
    """The vocabulary a run without `--vocab` uses, in the reference's order:
    the ORBvoc-style tree (64k words, `vocab/train.py --tree`), the analogue
    of the reference's shipped ORBvoc.txt (main.cc:101); else the flat
    trained vocabulary; else an ad-hoc one built from random descriptors."""
    from .vocab.vocabulary import build_vocabulary, load_vocabulary

    for name in ("vocab_tree64k.npz", "vocab_synthetic.npz"):
        path = os.path.join(DATA_DIR, name)
        if os.path.exists(path):
            return load_vocabulary(path, device=device)
    rng = np.random.default_rng(0)
    return build_vocabulary(rng.integers(0, 256, (20000, 32)).astype(np.uint8),
                            n_words=1024, iters=3, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description="monocular ORB-SLAM on PyTorch")
    ap.add_argument("--dataset", default="synthetic",
                    help="synthetic[:traj] | tum:<dir>")
    ap.add_argument("--settings", default=None, help="settings.yaml (reference layout)")
    ap.add_argument("--vocab", default=None,
                    help="vocabulary .npz (default: data/vocab_tree64k.npz, else "
                         "data/vocab_synthetic.npz, else an ad-hoc vocabulary)")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--n-features", type=int, default=1000)
    ap.add_argument("--out", default="KeyFrameTrajectory.txt")
    ap.add_argument("--save-world", default=None)
    ap.add_argument("--load-world", default=None)
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--realtime", action="store_true",
                    help="consume frames against the camera clock (cfg.fps) "
                         "and DROP late frames, like the reference's live "
                         "image topic (src/Tracking.cc:166-189); reports "
                         "%%dropped alongside fps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the startup capture of the system's programs "
                         "(Slam.warmup): each is then captured at its first call")
    ap.add_argument("--viz", default=None, metavar="DIR",
                    help="live visualization: write the tracked-frame debug "
                         "image and a top-down map view to DIR every frame "
                         "(the reference refreshes its Frame/Map publishers "
                         "at camera fps, src/main.cc:210-218)")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the current CUDA device)")
    args = ap.parse_args(argv)
    viz_dir = None
    if args.viz:
        os.makedirs(args.viz, exist_ok=True)
        viz_dir = args.viz

    from .config import SlamConfig
    from .io.dataset import SyntheticSequence, TumDataset
    from .io.trajectory import ate_rmse, save_tum
    from .pipeline.system import Slam
    from .utils.device import resolve_device
    from .vocab.vocabulary import load_vocabulary

    device = resolve_device(args.device)
    if args.settings:
        cfg = SlamConfig.from_yaml(args.settings)
        cfg.n_features = args.n_features
    else:
        cfg = SlamConfig(n_features=args.n_features)
    # the reference's default pipelines its tracking (a workaround for its
    # device link); this package tracks each frame to its end and refuses
    # the option
    cfg.pipelined_tracking = False

    gt = None
    if args.dataset.startswith("synthetic"):
        traj = args.dataset.split(":")[1] if ":" in args.dataset else "xyz"
        cfg.fx = cfg.fy = 500.0
        cfg.cx, cfg.cy = 320.0, 240.0
        cfg.k1 = cfg.k2 = cfg.p1 = cfg.p2 = 0.0
        seq = SyntheticSequence(n_frames=args.frames, trajectory=traj, seed=args.seed,
                                device=device)
        gt = {round(float(seq.timestamps[i]), 6): seq.poses[i] for i in range(len(seq))}
    elif args.dataset.startswith("tum:"):
        seq = TumDataset(args.dataset[4:], device=device)
    else:
        ap.error(f"unknown dataset {args.dataset}")

    vocab = load_vocabulary(args.vocab, device=device) if args.vocab else default_vocabulary(device)

    slam = Slam(cfg, vocab=vocab, enable_loop_closing=not args.no_loop_closing,
                device=device)
    if not args.no_warmup:
        t_w = time.time()
        slam.warmup()
        print(f"warmup (program capture): {time.time() - t_w:.1f}s", file=sys.stderr)

    def refresh_viz(img, frame, state):
        """FramePublisher/MapPublisher refresh (src/main.cc:210-218). The
        system tracks each frame to its end, so `frame` is the image's own."""
        if viz_dir is None:
            return
        from .io.png import write_bgr
        from .io.viz import draw_frame, draw_map_topdown

        if frame is not None:
            host = img.cpu().numpy() if hasattr(img, "cpu") else np.asarray(img)
            write_bgr(os.path.join(viz_dir, "frame.png"),
                      draw_frame(host, frame, state, n_kf=slam.n_keyframes, n_mp=slam.n_points))
        write_bgr(os.path.join(viz_dir, "map.png"), draw_map_topdown(slam.map))

    if args.load_world:
        from .io.checkpoint import load_slam

        load_slam(args.load_world, slam)
        print(f"resumed world: {slam.n_keyframes} KFs, {slam.n_points} points")

    n = min(args.frames, len(seq))
    fps_clock = cfg.fps if cfg.fps > 0 else 30.0
    dropped = 0
    t0 = time.time()
    if args.realtime:
        # live-camera semantics: frame i becomes available at i/fps; when
        # several frames have arrived while the system was busy, only the
        # newest is processed (the reference's topic queue of depth 1,
        # src/main.cc:169)
        i = 0
        done = 0
        while i < n:
            img, ts, _ = seq.get(i)
            state, frame = slam.process(img, ts)
            refresh_viz(img, frame, state)
            done += 1
            if done % 20 == 0:
                print(f"[{i}/{n}] {state.name} kfs={slam.n_keyframes} "
                      f"pts={slam.n_points}", file=sys.stderr)
            arrived = int((time.time() - t0) * fps_clock) + 1
            nxt = min(max(i + 1, arrived), n)
            dropped += nxt - (i + 1)
            i = nxt
        wall = time.time() - t0
        print(f"realtime @{fps_clock:.0f}fps: processed {done}/{n} frames in "
              f"{wall:.1f}s, dropped {dropped} ({100.0*dropped/max(n,1):.1f}%), "
              f"{slam.n_keyframes} KFs, {slam.n_points} points, "
              f"{slam.n_loops_closed} loops closed")
    else:
        for i in range(n):
            img, ts, _ = seq.get(i)
            state, frame = slam.process(img, ts)
            refresh_viz(img, frame, state)
            if i % 20 == 0:
                print(
                    f"[{i}/{n}] {state.name} kfs={slam.n_keyframes} "
                    f"pts={slam.n_points} inliers={slam.tracker.n_inliers}",
                    file=sys.stderr,
                )
        wall = time.time() - t0
        print(f"processed {n} frames in {wall:.1f}s ({n / wall:.1f} fps), "
              f"{slam.n_keyframes} KFs, {slam.n_points} points, "
              f"{slam.n_loops_closed} loops closed")

    slam.finish()
    save_tum(args.out, slam.keyframe_trajectory())
    print(f"keyframe trajectory -> {args.out}")

    if gt is not None and len(slam.trajectory) > 10:
        est_c, gt_c = [], []
        for ts, R, t in slam.trajectory:
            if round(ts, 6) in gt:
                Rg, tg = gt[round(ts, 6)]
                gt_c.append(-Rg.T @ tg)
                est_c.append(-R.T @ t)
        print(f"ATE RMSE (scale-aligned): {ate_rmse(np.stack(est_c), np.stack(gt_c)):.4f} m "
              f"over {len(est_c)} tracked frames")

    if args.save_world:
        from .io.checkpoint import save_slam

        save_slam(args.save_world, slam)
        print(f"world -> {args.save_world}")
    return slam


if __name__ == "__main__":
    main()
