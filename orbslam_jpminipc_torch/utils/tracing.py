"""Per-stage tracing: structured timing and state logs (counterpart of
orbslam_jpminipc_tpu/utils/tracing.py).

One tracer per process: per-stage wall timings (with percentiles), an
optional JSONL event stream, and a `torch.profiler` window for device-level
traces. A stage's time is the host's wall clock; on the card it includes
whatever the stage waited for on the device (a host read synchronises).
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

MAX_SAMPLES = 65536  # bound per-stage sample memory for long sessions


class StageTracer:
    def __init__(self, jsonl_path: str | None = None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.samples = defaultdict(list)  # per-stage ms samples (p50/p95)
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self.enabled = True

    @contextlib.contextmanager
    def stage(self, name: str, **fields):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            s = self.samples[name]
            if len(s) >= MAX_SAMPLES:
                # keep a uniform subsample over long sessions
                del s[::2]
            s.append(dt * 1e3)
            if self._jsonl is not None:
                self._jsonl.write(
                    json.dumps({"stage": name, "ms": round(dt * 1e3, 3), **fields}) + "\n")

    def reset(self):
        """Drop accumulated samples (e.g. between a warm-up segment and the
        measured run: the tracer is global)."""
        self.totals.clear()
        self.counts.clear()
        self.samples.clear()

    def log(self, event: str, **fields):
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"event": event, **fields}) + "\n")
            self._jsonl.flush()

    def summary(self) -> dict:
        import numpy as np

        out = {}
        for name in sorted(self.totals):
            s = np.array(self.samples[name]) if self.samples[name] else np.zeros(1)
            out[name] = {
                "total_s": round(self.totals[name], 3),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 3),
                "p50_ms": round(float(np.percentile(s, 50)), 3),
                "p95_ms": round(float(np.percentile(s, 95)), 3),
            }
        return out

    @contextlib.contextmanager
    def device_trace(self, logdir: str):
        """Wrap a region in a `torch.profiler` window (CPU and, where there
        is one, CUDA activity) and write a Chrome trace into `logdir`."""
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_tracer = StageTracer()


def get_tracer() -> StageTracer:
    return _tracer


class StageQueueAudit:
    """Follows a `Slam`'s mapping stage queue from outside: which stages of
    each queued keyframe ran, which were skipped because the keyframe had
    been culled, which the InterruptBA rules took out, and how deep the
    queue got. It wraps the Slam's queue methods on the instance and reads
    `slam.pending`; the Slam does not know of it.

    `check(stages)` raises when a keyframe's stage ran twice, when a stage
    neither ran nor was taken out by the rules, or when the queue was deeper
    than the rules allow. The queue is deepest right after a keyframe
    arrives. Then the new keyframe holds all `n = len(stages)` stages, and
    each of the `p - 1` keyframes still queued holds at most `n - 4`: the
    arrival cancels every bundle adjustment that has not started (four
    stages), and one that has started has fewer stages left than that. So
    the depth is at most `n + (n - 4) * (p - 1)`. `p` itself has no bound in
    the rules (the gate lets a keyframe in on every frame of a streak of
    hard tracking decay): `counts()` reports the largest seen."""

    BA = ("ba_d", "ba_m", "ba2_d", "ba2_m")

    def __init__(self, slam):
        self.slam = slam
        self.entries: list[dict] = []   # one per queued keyframe, in order
        self._by_list: dict[int, dict] = {}
        self.max_depth = 0              # the queue is deepest right after a keyframe
        self.arrivals: list[tuple[int, int]] = []   # (depth, keyframes queued) at each arrival
        run, on_kf = slam._run_pending_stage, slam._on_new_keyframe

        def run_pending_stage():
            kf, stages = slam.pending[0]
            e = self._entry(kf, stages)
            self._diff(e)
            valid = bool(slam.map.kf_valid[kf])
            stage = run()
            (e["ran"] if valid else e["skipped"]).append(stage)
            e["last"] = list(stages)
            return stage

        def on_new_keyframe(frame):
            on_kf(frame)
            for kf, stages in slam.pending:
                self._diff(self._entry(kf, stages))
            depth = sum(len(s) for _, s in slam.pending)
            if slam.pending:
                self.arrivals.append((depth, len(slam.pending)))
            self.max_depth = max(self.max_depth, depth)

        slam._run_pending_stage = run_pending_stage
        slam._on_new_keyframe = on_new_keyframe
        slam.tracker.on_new_keyframe = on_new_keyframe

    def _entry(self, kf, stages):
        e = self._by_list.get(id(stages))
        if e is None:
            e = {"kf": int(kf), "list": stages, "queued": list(stages), "last": list(stages),
                 "ran": [], "skipped": [], "removed": [], "inserted": []}
            self._by_list[id(stages)] = e
            self.entries.append(e)
        return e

    def _diff(self, e):
        """What changed in a queued list since it was last seen."""
        now = list(e["list"])
        e["removed"] += [s for s in e["last"] if s not in now]
        e["inserted"] += [s for s in now if s not in e["last"]]
        e["last"] = now

    def counts(self) -> dict:
        cancelled = sum(set(self.BA) <= set(e["removed"]) for e in self.entries)
        aborted = sum("ba_abort" in e["inserted"] for e in self.entries)
        return {"keyframes_queued": len(self.entries), "ba_cancelled": cancelled,
                "ba_aborted": aborted, "max_depth": self.max_depth,
                "max_keyframes_queued_at_once": max((p for _, p in self.arrivals), default=0),
                "stages_run": sum(len(e["ran"]) for e in self.entries),
                "stages_skipped_culled": sum(len(e["skipped"]) for e in self.entries)}

    def check(self, stages):
        if self.slam.pending:
            raise AssertionError(f"stages still queued: {self.slam.pending}")
        n = len(stages)
        for depth, p in self.arrivals:
            if depth > n + (n - 4) * (p - 1):
                raise AssertionError(f"the queue held {depth} stages with {p} keyframes queued")
        for e in self.entries:
            done = e["ran"] + e["skipped"]
            for s in list(stages) + ["ba_abort"]:
                if done.count(s) > 1:
                    raise AssertionError(f"keyframe {e['kf']}: stage {s} ran {done.count(s)} times")
            removed = set(e["removed"])
            if removed not in (set(), set(self.BA), {"ba2_d", "ba2_m"}):
                raise AssertionError(f"keyframe {e['kf']}: stages {removed} were taken out")
            aborted = removed == {"ba2_d", "ba2_m"}
            if aborted != ("ba_abort" in done):
                raise AssertionError(f"keyframe {e['kf']}: ba_abort and the removed stages disagree")
            missing = [s for s in stages if s not in done and s not in removed]
            if missing:
                raise AssertionError(f"keyframe {e['kf']}: stages {missing} never ran")
