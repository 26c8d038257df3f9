"""The device trace of a traced run: a `torch.profiler` window over a fixed
stretch of calls, reduced to what the per-layer metrics read.

The benchmark marks the stretch from its own files with `record_function`
ranges named `bench.*`: `bench.call` around each `Slam.process` call, and
ranges around the layer calls it wraps (`session.Recorder`). A device
operation belongs to the range in which the host launched it (the runtime
call with the same correlation id); a CUDA graph's kernels carry the id of
their graph launch.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

PREFIX = "bench."
CALL = "bench.call"


def _events(prof):
    """The profiler's raw events (no per-event Python tree is built)."""
    inner = getattr(prof, "profiler", None)
    res = getattr(inner, "kineto_results", None)
    if res is None:
        raise RuntimeError("the profiler kept no kineto results")
    return res.events()


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def reduce(prof) -> dict:
    """Device operations, launches and `bench.*` ranges of one profiled
    stretch -> the numbers the readers take (all times in seconds)."""
    dev_s, dev_e, dev_c, dev_n = [], [], [], []
    launch = {}
    ranges = defaultdict(list)
    for e in _events(prof):
        name = e.name()
        if _is_device(e):
            if name.startswith(PREFIX) or e.is_user_annotation():
                continue
            s = e.start_ns()
            dev_s.append(s)
            dev_e.append(s + e.duration_ns())
            dev_c.append(e.correlation_id())
            dev_n.append(name)
        elif name.startswith(PREFIX):
            ranges[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    return summarize(np.array(dev_s, np.int64), np.array(dev_e, np.int64), dev_c, dev_n,
                     launch, dict(ranges))


def summarize(dev_s, dev_e, dev_c, dev_n, launch, ranges) -> dict:
    """The reduction itself, on plain arrays (so a fixture can feed it)."""
    calls = sorted(ranges.get(CALL, []))
    if not calls:
        return {}
    w0, w1 = calls[0][0], max(b for _, b in calls)
    inside = (dev_e > w0) & (dev_s < w1)
    s = np.clip(dev_s[inside], w0, w1)
    e = np.clip(dev_e[inside], w0, w1)
    names = [n for n, k in zip(dev_n, inside) if k]
    corr = [c for c, k in zip(dev_c, inside) if k]
    # the union of device intervals: busy time and the idle gaps between
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    names = [names[i] for i in order]
    corr = [corr[i] for i in order]
    busy, gaps = 0, []
    cur_s = cur_e = None
    for a, b in zip(s.tolist(), e.tolist()):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, a))
            elif a > w0:
                gaps.append((w0, a))
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    else:
        gaps.append((w0, w1))
    out = {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9, "calls": len(calls)}

    by_name = defaultdict(int)
    for n, a, b in zip(names, s.tolist(), e.tolist()):
        by_name[n] += b - a
    out["device_ops"] = sorted(([n, v * 1e-9] for n, v in by_name.items()),
                               key=lambda x: -x[1])[:10]

    # what the host was doing in each idle gap: the innermost bench range
    # around the gap's middle, "harness" between calls
    mids = np.array([(a + b) / 2 for a, b in gaps])
    kinds = ["harness"] + list(ranges)
    label = np.zeros(len(gaps), np.int64)
    width = np.full(len(gaps), np.inf)
    for ki, (rname, iv) in enumerate(ranges.items(), start=1):
        for a, b in iv:
            lo, hi = np.searchsorted(mids, a), np.searchsorted(mids, b, side="right")
            if hi > lo:
                tighter = width[lo:hi] > (b - a)
                label[lo:hi][tighter] = ki
                width[lo:hi][tighter] = b - a
    gap_len = np.array([b - a for a, b in gaps], np.int64)
    idle = {kinds[k]: int(gap_len[label == k].sum()) for k in np.unique(label)}
    out["idle_gaps"] = sorted(([n, v * 1e-9] for n, v in idle.items()), key=lambda x: -x[1])[:10]

    # device work launched inside each kind of range
    t_launch = np.array([launch.get(c, -1) for c in corr], np.int64)
    dur = e - s
    is_kernel = np.array([not n.startswith(("Memcpy", "Memset")) for n in names], bool)
    out["ranges"] = {}
    for rname, iv in ranges.items():
        iv = sorted(iv)
        starts = np.array([a for a, _ in iv], np.int64)
        ends = np.array([b for _, b in iv], np.int64)
        k = np.searchsorted(starts, t_launch, side="right") - 1
        hit = (t_launch >= 0) & (k >= 0) & (t_launch <= ends[np.maximum(k, 0)])
        out["ranges"][rname] = {"count": len(iv), "device_s": float(dur[hit].sum()) * 1e-9,
                                "kernels": int((hit & is_kernel).sum())}
    fast = [b - a for n, a, b in zip(names, s.tolist(), e.tolist()) if "fast_levels_kernel" in n]
    out["fast_launches"] = len(fast)
    out["fast_s"] = sum(fast) * 1e-9
    return out
