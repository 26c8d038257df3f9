"""Train the default vocabulary from real ORB descriptors (counterpart of
orbslam_jpminipc_tpu/vocab/train.py).

The reference ships a pre-trained ORBvoc.txt (loaded at src/main.cc:101).
With no dataset downloads, the equivalent is trained from descriptors
extracted off rendered synthetic scenes (many seeds and viewpoints, real
rBRIEF statistics, not random bytes): the frames are rendered and the
features extracted on the device, the k-medians runs there too.

Usage:  python -m orbslam_jpminipc_torch.vocab.train \\
            [--words 8192] [--frames 60] [--seeds 8] [--tree --k 16 --depth 4] \\
            [--out path.npz] [--device cuda|cpu]

It runs on the current CUDA device unless `--device` names another.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "data", "vocab_synthetic.npz")


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def collect_descriptors(n_frames: int = 60, seeds=(0, 1, 2, 3), device=None,
                        times: dict | None = None) -> np.ndarray:
    """ORB descriptors of every (n_frames // 15)-th frame of the `xyz` and
    `loop` sequences of each seed, 1000 features a frame: (N, 32) uint8.
    `times`, when given, receives the seconds spent rendering and
    extracting."""
    from ..config import SlamConfig
    from ..frontend.frame import build_frame
    from ..io.dataset import SyntheticSequence
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    t_render = t_extract = 0.0
    descs = []
    for seed in seeds:
        for traj in ("xyz", "loop"):
            t0 = time.perf_counter()
            seq = SyntheticSequence(n_frames=n_frames, trajectory=traj, seed=seed, device=dev)
            t_render += time.perf_counter() - t0
            step = max(1, n_frames // 15)
            for i in range(0, n_frames, step):
                t0 = time.perf_counter()
                img, ts, _ = seq.get(i)
                _sync(dev)
                t1 = time.perf_counter()
                f = build_frame(img, cfg, frame_id=i, timestamp=ts, n_features=1000, device=dev)
                descs.append(f.desc[f.valid])
                t2 = time.perf_counter()
                t_render += t1 - t0
                t_extract += t2 - t1
    if times is not None:
        times.update(render_s=t_render, extract_s=t_extract)
    return np.concatenate(descs, axis=0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--words", type=int, default=8192)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--tree", action="store_true",
                    help="train a hierarchical (ORBvoc-style k-ary tree) "
                         "vocabulary instead of a flat one")
    ap.add_argument("--k", type=int, default=16, help="tree branching factor")
    ap.add_argument("--depth", type=int, default=4, help="tree depth")
    ap.add_argument("--seeds", type=int, default=8,
                    help="number of synthetic scene seeds to render")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the current CUDA device)")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device
    from .vocabulary import build_vocabulary, save_vocabulary

    dev = resolve_device(args.device)
    times: dict = {}
    descs = collect_descriptors(args.frames, seeds=tuple(range(args.seeds)), device=dev,
                                times=times)
    print(f"training set: {len(descs)} descriptors", flush=True)
    t0 = time.perf_counter()
    if args.tree:
        from .tree import build_tree_vocabulary

        vocab = build_tree_vocabulary(descs, k=args.k, depth=args.depth, device=dev)
    else:
        vocab = build_vocabulary(descs, n_words=args.words, iters=args.iters, device=dev)
    _sync(dev)
    times["kmedians_s"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_vocabulary(vocab, args.out)
    print(f"seconds: render {times['render_s']:.2f}, extract {times['extract_s']:.2f}, "
          f"k-medians {times['kmedians_s']:.2f}")
    print(f"vocabulary ({vocab.n_words} words) -> {args.out}")
    return vocab


if __name__ == "__main__":
    main()
