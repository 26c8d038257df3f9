"""Per-layer metric readers, one module each, found by the metric's name.

A reader module declares NAME, UNIT, LAYER, SOURCE and MOVES (as
BENCHMARK.json's `per_layer` entry has them) and a function
`read(run) -> float | None`. `run` is a `session.RunRecord`:

  run.spans     {span name: (total seconds, count)} of the program's
                `StageTracer` over the measured window, the profiled
                stretch left out (the profiler slows the host there)
  run.counts    counters over the same part of the window: frames, lost,
                keyframes (and working, resets over the whole window)
  run.trace     `trace.reduce` of the profiled stretch: window_s, busy_s,
                calls, ranges {`bench.*` name: {count, device_s, kernels}},
                fast_launches, fast_s, device_ops, idle_gaps
  run.config    the configuration file as a dict

A reader that finds nothing to read returns None, and the metric is left
out of the result line.
"""
from __future__ import annotations

import importlib


def load(name: str):
    """The reader module of metric `name`."""
    return importlib.import_module(f"{__name__}.{name}")
