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
