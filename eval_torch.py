"""Accuracy evaluation of the PyTorch package (counterpart of eval.py).

Runs the synthetic suite (or a TUM RGB-D directory with `--tum <dir>`)
through `orbslam_jpminipc_torch` with the 64k-word tree vocabulary and the
default system (`Slam(cfg, vocab=v)`: asynchronous mapping, loop closing
on), on the current CUDA device unless `--device` names another.

    python3 eval_torch.py --seqs xyz:300,loop:400,orbit:300

Prints one JSON line per sequence, with the keys of eval.py's lines:
  {"metric": "kf_ate_rmse_<seq>", "unit": "m", "value": N, "frames": F,
   "frames_tracked": T, "keyframes": K, "points": P, "loops_closed": L,
   "fps": R, "ate_rmse": A, "extent_m": E, "ate_pct_extent": X, ...}

The aggregate (`--out`) also holds the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def run_sequence(seq, cfg, vocab, frames, gt_poses=None, verbose=True, warmup=True,
                 device=None):
    """Run `frames` frames of `seq` through a default `Slam` and return the
    result dict of eval.py's `run_sequence`. With `warmup` the system
    captures its programs (`Slam.warmup`) before the timed run, as eval.py
    compiles them."""
    from orbslam_jpminipc_torch.io.trajectory import ate_rmse
    from orbslam_jpminipc_torch.pipeline.system import Slam

    slam = Slam(cfg, vocab=vocab, device=device)
    if warmup:
        t_w = time.time()
        slam.warmup()
        if verbose:
            print(f"  warmup: {time.time() - t_w:.1f}s", file=sys.stderr)
    n = min(frames, len(seq))
    t0 = time.time()
    for i in range(n):
        img, ts, _ = seq.get(i)
        state, _ = slam.process(img, ts)
        if verbose and i % 40 == 0:
            print(f"  [{i}/{n}] {state.name} kfs={slam.n_keyframes} "
                  f"pts={slam.n_points} loops={slam.n_loops_closed}", file=sys.stderr)
    wall = time.time() - t0
    slam.finish()  # drain the tail mapping and loop stages

    result = {
        "frames": n,
        "frames_tracked": len(slam.trajectory),
        "keyframes": slam.n_keyframes,
        "points": slam.n_points,
        "loops_closed": slam.n_loops_closed,
        "fps": round(n / wall, 2),
    }
    if gt_poses is not None:
        est_c, gt_c = [], []
        for ts, R, t in slam.trajectory:
            key = round(ts, 6)
            if key in gt_poses:
                Rg, tg = gt_poses[key]
                gt_c.append(-Rg.T @ tg)
                est_c.append(-R.T @ t)
        if len(est_c) > 10:
            gt_c = np.stack(gt_c)
            est_c = np.stack(est_c)
            extent = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
            ate = ate_rmse(est_c, gt_c)
            result.update(
                ate_rmse=round(ate, 4),
                extent_m=round(extent, 3),
                ate_pct_extent=round(100.0 * ate / max(extent, 1e-9), 2),
            )
        # keyframe-trajectory ATE (the reference dumps keyframes only,
        # main.cc:226-245, and TRO'15 evaluates that trajectory)
        kf_est, kf_gt = [], []
        for ts, R, t in slam.keyframe_trajectory():
            key = round(ts, 6)
            if key in gt_poses:
                Rg, tg = gt_poses[key]
                kf_gt.append(-Rg.T @ tg)
                kf_est.append(-R.T @ t)
        if len(kf_est) > 3:
            result["kf_ate_rmse"] = round(ate_rmse(np.stack(kf_est), np.stack(kf_gt)), 4)
    return result


def card():
    """The card's name and power limit, or None off a card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=240)
    # the synthetic trajectories are phase-parameterized: more frames =
    # slower motion; 300/400 frames is the TUM fr1 regime (~1-2 cm/frame)
    ap.add_argument("--seqs", default="xyz:300,loop:400,orbit:300",
                    help="synthetic sequences as name:frames,...")
    ap.add_argument("--tum", default=None, help="TUM sequence directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the aggregate results JSON to this path")
    ap.add_argument("--n-features", type=int, default=1000)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip each system's startup capture of its programs")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the current CUDA device)")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.io.dataset import SyntheticSequence, TumDataset
    from orbslam_jpminipc_torch.utils.device import resolve_device
    from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary

    device = resolve_device(args.device)
    vocab = load_vocabulary(os.path.join(REPO, "orbslam_jpminipc_torch", "data",
                                         "vocab_tree64k.npz"), device=device)
    # pipelined tracking (the reference's default) is refused by this package
    if args.tum:
        cfg = SlamConfig(n_features=args.n_features, pipelined_tracking=False)
        seq = TumDataset(args.tum, device=device)
        res = run_sequence(seq, cfg, vocab, args.frames, warmup=not args.no_warmup,
                           device=device)
        print(json.dumps({"metric": "tum_run", **res}))
        return

    all_results = {}
    for spec in args.seqs.split(","):
        name, _, nf = spec.partition(":")
        n = int(nf) if nf else args.frames
        cfg = SlamConfig(
            fx=500.0, fy=500.0, cx=320.0, cy=240.0,
            k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=args.n_features,
            pipelined_tracking=False,
        )
        seq = SyntheticSequence(n_frames=n, trajectory=name, seed=args.seed, device=device)
        gt = {round(float(seq.timestamps[i]), 6): seq.poses[i] for i in range(len(seq))}
        res = run_sequence(seq, cfg, vocab, n, gt_poses=gt, warmup=not args.no_warmup,
                           device=device)
        # headline: the keyframe-trajectory ATE (main.cc:226-245, TRO'15)
        print(json.dumps({"metric": f"kf_ate_rmse_{name}", "unit": "m",
                          "value": res.get("kf_ate_rmse", res.get("ate_rmse")),
                          **res}), flush=True)
        all_results[name] = res
    all_results["card"] = card() if device.type == "cuda" else None
    if args.out:
        with open(args.out, "w") as f:
            json.dump(all_results, f, indent=1)


if __name__ == "__main__":
    main()
