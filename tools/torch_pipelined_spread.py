"""How far pipelined runs of the PyTorch port spread, and why.

Runs one synthetic sequence several times through one default `Slam`
(pipelined tracking, asynchronous mapping, the 64k-word vocabulary, as
eval_torch.py runs it), warmed once and put back as a fresh system between
runs (`Slam._restart`). The first runs feed the frames as fast as the system
takes them, as eval_torch.py does; the paced runs wait until each frame's
slot at `--pace` frames a second, as a camera delivers them.

Per run: frames a second, frames tracked, keyframes and the keyframe
trajectory's ATE, the frames that became keyframes, and the keyframe
decisions (`Tracker._need_new_keyframe`'s `kf_decision` events: a frame
that degraded enough to want a keyframe) that were refused because the
mapper was busy. Each run's keyframes are compared with those of the run of
the lowest keyframe ATE.

    python3 tools/torch_pipelined_spread.py --seq xyz:300 --runs 4 --paced-runs 2

Prints one JSON line per run and a summary line; `--out` also writes them,
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def one_run(slam, seq, n, pace, gt):
    """The first `n` frames of `seq` through `slam` (fresh), at `pace`
    frames a second or as fast as it takes them (pace 0)."""
    from orbslam_jpminipc_torch.io.trajectory import ate_rmse
    from orbslam_jpminipc_torch.utils.tracing import get_tracer

    slam._restart()
    tracer = get_tracer()
    decisions = []
    tracer.log = lambda event, **f: decisions.append(f) if event == "kf_decision" else None
    try:
        t0 = time.perf_counter()
        for i in range(n):
            if pace:
                delay = t0 + i / pace - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            img, ts, _ = seq.get(i)
            slam.process(img, ts)
        slam.finish()
        wall = time.perf_counter() - t0
    finally:
        del tracer.log   # the class's method again
    frame_of = {round(float(t), 6): i for i, t in enumerate(seq.timestamps)}
    kft = slam.keyframe_trajectory()
    kf_frames = sorted(frame_of[round(t, 6)] for t, _, _ in kft)
    ate = None
    if len(kft) > 3:   # as eval_torch.py: a Sim3 fit needs a few centres
        est = np.stack([-R.T @ t for _, R, t in kft]).astype(np.float64)
        ref = np.stack([gt[i] for i in kf_frames]).astype(np.float64)
        ate = ate_rmse(est, ref) * 1e3
    refused = [d["frame"] for d in decisions
               if not (d["idle"] or d["c1a"] or d["urgent"])]
    return {"pace": pace, "frames": n, "fps": n / wall, "frames_tracked": len(slam.trajectory),
            "keyframes": len(kft), "kf_ate_mm": ate,
            "kf_frames": kf_frames, "kf_decisions": len(decisions),
            "refused_busy": len(refused), "refused_frames": refused}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default="xyz:300", help="synthetic sequence as name:frames")
    ap.add_argument("--runs", type=int, default=4, help="runs fed as fast as taken")
    ap.add_argument("--paced-runs", type=int, default=2)
    ap.add_argument("--pace", type=float, default=10.0, help="frames a second when paced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from eval_torch import card
    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.io.dataset import SyntheticSequence
    from orbslam_jpminipc_torch.pipeline.system import Slam
    from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary

    if not torch.cuda.is_available():
        raise SystemExit("torch_pipelined_spread: needs a CUDA device")
    name, _, nf = args.seq.partition(":")
    n = int(nf)
    vocab = load_vocabulary(os.path.join(REPO, "orbslam_jpminipc_torch", "data",
                                         "vocab_tree64k.npz"), device="cuda")
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=1000)
    seq = SyntheticSequence(n_frames=n, trajectory=name, seed=args.seed, device="cuda")
    gt = [-R.T @ t for R, t in seq.poses]
    slam = Slam(cfg, vocab=vocab, device="cuda")
    t0 = time.perf_counter()
    slam.warmup()
    warmup_s = time.perf_counter() - t0
    smi = card()
    rows = []
    for k in range(args.runs + args.paced_runs):
        row = one_run(slam, seq, n, args.pace if k >= args.runs else 0.0, gt)
        row.update(run=k, tracking="pipelined" if cfg.pipelined_tracking else "synchronous")
        rows.append(row)
        print(json.dumps(row), flush=True)
    best = min(rows, key=lambda r: np.inf if r["kf_ate_mm"] is None else r["kf_ate_mm"])
    for r in rows:
        r["kf_only_here"] = sorted(set(r["kf_frames"]) - set(best["kf_frames"]))
        r["kf_only_in_best"] = sorted(set(best["kf_frames"]) - set(r["kf_frames"]))
        r["of_those_refused_busy_here"] = sorted(set(r["kf_only_in_best"])
                                                 & set(r["refused_frames"]))
    summary = {"seq": args.seq, "card": smi, "warmup_s": warmup_s, "best_run": best["run"],
               "per_run": [{k: r[k] for k in ("run", "pace", "fps", "frames_tracked",
                                               "keyframes", "kf_ate_mm", "refused_busy",
                                               "kf_only_here", "kf_only_in_best",
                                               "of_those_refused_busy_here")}
                           for r in rows]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "runs": rows}, f, indent=1)


if __name__ == "__main__":
    main()
