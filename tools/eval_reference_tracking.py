"""The JAX package's accuracy run (eval.py's `run_sequence`) with its
tracking pipelined and tracked frame by frame, to tell which of the two a
result belongs to. The PyTorch package tracks every frame to its end
(`pipelined_tracking=False`); eval.py runs the JAX package's default,
pipelined tracking, which decides keyframes a few frames late.

    env JAX_PLATFORMS=cpu python tools/eval_reference_tracking.py --seqs orbit:300

Prints one JSON line per sequence and tracking mode, with eval.py's keys.
About 4 minutes a 300-frame sequence on a CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqs", default="orbit:300", help="synthetic sequences as name:frames,...")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipelined", default="both", choices=("both", "on", "off"))
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import eval as reference_eval
    from orbslam_jpminipc_tpu.config import SlamConfig
    from orbslam_jpminipc_tpu.io.dataset import SyntheticSequence
    from orbslam_jpminipc_tpu.vocab.vocabulary import load_vocabulary

    vocab = load_vocabulary(os.path.join(REPO, "orbslam_jpminipc_tpu", "data", "vocab_tree64k.npz"))
    modes = {"both": (True, False), "on": (True,), "off": (False,)}[args.pipelined]
    for spec in args.seqs.split(","):
        name, _, nf = spec.partition(":")
        n = int(nf)
        seq = SyntheticSequence(n_frames=n, trajectory=name, seed=args.seed)
        gt = {round(float(seq.timestamps[i]), 6): seq.poses[i] for i in range(len(seq))}
        for pipelined in modes:
            cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0,
                             p2=0.0, n_features=1000, pipelined_tracking=pipelined)
            t0 = time.time()
            res = reference_eval.run_sequence(seq, cfg, vocab, n, gt_poses=gt, verbose=False,
                                              warmup=False)
            print(json.dumps({"seq": name, "pipelined_tracking": pipelined,
                              "wall_s": round(time.time() - t0, 1), **res}), flush=True)


if __name__ == "__main__":
    main()
