"""Per-stage tracing: the port's spans, counters and, in detail mode, the
card's own busy intervals (counterpart of orbslam_jpminipc_tpu/utils/tracing.py).

One tracer per process (`get_tracer()`). Always on: per-span wall time
totals, counts and samples (p50/p95), the counter `reads` (device -> host
copies, `utils/host.py`) and the `log()` hook, which does nothing and is
there for a caller to wrap. A span's time is the host's wall clock; on the
card it includes whatever the span waited for on the device.

Detail mode (`tracer.detail = True`, off by default) adds, with no profiler
attached:

* a span tree: each span gets an id, its parent's id (a stack of open
  spans) and the id of the `call` span (one `Slam.process`) it ran in;
  closed spans are kept in a bounded ring (`records`), and `self.<name>`
  totals the span's time less its children's;
* timed host waits: `utils/host.py`'s device reads report each wait
  (`note_wait`); it is credited to the innermost open span (`wait.<name>`)
  and to every open span's waited time (`waited.<name>`), so `mapping` less
  `waited.mapping` is mapping's host work;
* the card's intervals: `Program.run` and `Chain.launch` record a timing
  event on each side of their launch (`launch_begin`, `launch_end`). At
  later span closes the pairs whose events have completed are resolved in
  stream order, without waiting, and mapped onto the host's
  `perf_counter_ns` clock through one anchor event (`CudaClock`). Totals:
  `device.busy` (the union of the intervals on the one stream),
  `device.<program>` and `idle.<span>`, each gap between intervals put down
  to the innermost host span open at its middle (`harness` outside every
  span, between calls);
* while a `torch.profiler` records, each span also opens
  `record_function("slam.<name>")`, so the spans sit in its trace. The
  card's idle time across the profiler's teardown is put down to nothing:
  the first span after it resolves what is pending and takes a new anchor.

`export(path)` writes the span ring and the card's intervals as one Chrome
trace on the host clock.
"""
from __future__ import annotations

import contextlib
import json
from collections import defaultdict, deque
from time import perf_counter, perf_counter_ns

import torch
from torch.autograd.profiler import record_function

MAX_SAMPLES = 65536  # bound per-stage sample memory for long sessions
RING = 1 << 17       # closed spans (and card intervals) kept in detail mode
CALL = "call"        # the root span of one Slam.process
HARNESS = "harness"  # what the host did outside every span: its caller's work


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class CudaClock:
    """The card's side of detail mode: pooled timing events recorded on the
    current CUDA stream, read on the host's `perf_counter_ns` clock through
    one anchor (a synchronise, an anchor event, the host's time)."""

    def __init__(self):
        self._pool: list = []
        self._anchor = None      # (event, host ns)
        self._stream = None      # the stream the anchor was taken on

    def sync(self):
        torch.cuda.synchronize()

    def _stamp(self):
        """A fresh event recorded on an idle card: (event, host ns)."""
        self.sync()
        ev = torch.cuda.Event(enable_timing=True)
        h0 = perf_counter_ns()
        ev.record()
        ev.synchronize()
        return ev, (h0 + perf_counter_ns()) // 2

    def anchor(self) -> int | None:
        """Take the anchor; its host time, or None without a card."""
        if not torch.cuda.is_available():
            self._anchor = None
            return None
        self._anchor = self._stamp()
        self._stream = torch.cuda.current_stream().cuda_stream
        return self._anchor[1]

    @property
    def anchor_ns(self) -> int | None:
        """The host time of the anchor."""
        return self._anchor[1] if self._anchor is not None else None

    def record(self):
        """A timing event recorded now, or None off the anchored stream (a
        capture's stream among them) or without an anchor."""
        if self._anchor is None or torch.cuda.current_stream().cuda_stream != self._stream:
            return None
        ev = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def done(self, ev) -> bool:
        return ev.query()

    def host_ns(self, ev) -> int:
        a, h = self._anchor
        return h + round(a.elapsed_time(ev) * 1e6)

    def release(self, *evs):
        self._pool.extend(evs)

    def capturing(self) -> bool:
        """A graph capture is under way: asking an event would break it."""
        return torch.cuda.is_current_stream_capturing()

    def drift_ns(self) -> int:
        """The host time the anchor gives a fresh event less the host time
        it was recorded at: how far the two clocks moved apart since."""
        ev, h = self._stamp()
        return self.host_ns(ev) - h


class _Open:
    """A span while it is open."""

    __slots__ = ("name", "id", "parent", "call", "t0", "child", "wait", "rf")

    def __init__(self, name, id_, parent, call):
        self.name, self.id, self.parent, self.call = name, id_, parent, call
        self.t0 = self.child = self.wait = 0
        self.rf = None


class StageTracer:
    def __init__(self, clock=None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.samples = defaultdict(list)  # per-stage ms samples (p50/p95)
        self.enabled = True
        self.clock = clock if clock is not None else CudaClock()
        self._detail = False
        self._next_id = 0
        self._stack: list[_Open] = []
        # (name, id, parent, call, start ns, end ns, children ns, own waits ns)
        self.records: deque = deque(maxlen=RING)
        # (start ns, end ns, program, id of the span that launched it)
        self.intervals: deque = deque(maxlen=RING)
        self._pending: deque = deque()   # (begin, end, program, span id)
        self._dev_end = 0                # end of the card's last interval, host ns
        self._profiled = False           # a profiler recorded at the last span's open

    @property
    def detail(self) -> bool:
        return self._detail

    @detail.setter
    def detail(self, on: bool):
        if on and not self._detail:
            self._anchor()
        self._detail = bool(on)

    def _anchor(self):
        self._pending.clear()
        h = self.clock.anchor()
        self._dev_end = h if h is not None else 0

    @property
    def pending(self) -> int:
        """Launches whose card interval is not resolved yet."""
        return len(self._pending)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        if self._detail:
            span = self._open(name)
            try:
                yield
            finally:
                self._close(span)
            return
        t0 = perf_counter()
        try:
            yield
        finally:
            self._add(name, perf_counter() - t0)

    def _add(self, name: str, dt: float):
        self.totals[name] += dt
        self.counts[name] += 1
        s = self.samples[name]
        if len(s) >= MAX_SAMPLES:
            # keep a uniform subsample over long sessions
            del s[::2]
        s.append(dt * 1e3)

    def _open(self, name: str) -> _Open:
        self._next_id += 1
        up = self._stack[-1] if self._stack else None
        if up is not None:
            span = _Open(name, self._next_id, up.id, up.call)
        else:
            span = _Open(name, self._next_id, 0, self._next_id if name == CALL else 0)
        profiling = _profiling()
        if profiling:
            span.rf = record_function(f"slam.{name}")
            span.rf.__enter__()
        elif self._profiled:
            self._after_profiler()
        self._profiled = profiling
        self._stack.append(span)
        span.t0 = perf_counter_ns()
        return span

    def _close(self, span: _Open):
        t1 = perf_counter_ns()
        if span.rf is not None:
            span.rf.__exit__(None, None, None)
        self._stack.pop()
        dur = t1 - span.t0
        self._add(span.name, dur * 1e-9)
        key = f"self.{span.name}"
        self.totals[key] += (dur - span.child) * 1e-9
        self.counts[key] += 1
        if self._stack:
            self._stack[-1].child += dur
        self.records.append((span.name, span.id, span.parent, span.call, span.t0, t1,
                             span.child, span.wait))
        if self._pending:
            self._resolve()

    def _after_profiler(self):
        """A profiler stopped since the last span opened. Its teardown held
        the host, outside every span, while the card idled: resolve what
        ran before it and take a new anchor, so that gap counts nowhere."""
        if self._pending:
            self._resolve(wait=True)
        self._anchor()

    def note_wait(self, t0: int, t1: int):
        """A host wait from `t0` to `t1` (perf_counter_ns), in detail mode."""
        dt = t1 - t0
        inner = self._stack[-1].name if self._stack else HARNESS
        if self._stack:
            self._stack[-1].wait += dt
        self.totals[f"wait.{inner}"] += dt * 1e-9
        self.counts[f"wait.{inner}"] += 1
        for span in self._stack:
            self.totals[f"waited.{span.name}"] += dt * 1e-9
            self.counts[f"waited.{span.name}"] += 1

    def launch_begin(self):
        """Detail mode: an event before a launch on the current stream (None
        where the card's clock cannot take one)."""
        return self.clock.record()

    def launch_end(self, begin, name: str):
        """The event after the launch; the pair waits to be resolved."""
        end = self.clock.record()
        self._pending.append((begin, end, name, self._stack[-1].id if self._stack else 0))

    def _resolve(self, wait: bool = False):
        """Resolve the pending pairs, in stream order, while their events
        have completed (all of them after a synchronise with `wait`)."""
        clock = self.clock
        if clock.capturing():
            return
        if wait:
            clock.sync()
        while self._pending:
            begin, end, name, sid = self._pending[0]
            if not clock.done(end):
                break
            self._pending.popleft()
            t0, t1 = clock.host_ns(begin), clock.host_ns(end)
            clock.release(begin, end)
            self._interval(t0, t1, name, sid)

    def _interval(self, t0: int, t1: int, name: str, sid: int):
        if t0 > self._dev_end:
            label = self._innermost((t0 + self._dev_end) // 2)
            self.totals[f"idle.{label}"] += (t0 - self._dev_end) * 1e-9
            self.counts[f"idle.{label}"] += 1
        self.totals["device.busy"] += max(0, t1 - max(t0, self._dev_end)) * 1e-9
        self.counts["device.busy"] += 1
        self.totals[f"device.{name}"] += (t1 - t0) * 1e-9
        self.counts[f"device.{name}"] += 1
        self._dev_end = max(self._dev_end, t1)
        self.intervals.append((t0, t1, name, sid))

    def _innermost(self, t: int) -> str:
        """The innermost span open at host time `t`: the latest started
        among the open ones and the closed ones that had not ended."""
        best, start = HARNESS, -1
        for span in self._stack:
            if start < span.t0 <= t:
                best, start = span.name, span.t0
        for rec in reversed(self.records):
            if rec[5] <= t:   # closed in order: every earlier one ended too
                break
            if start < rec[4] <= t:
                best, start = rec[0], rec[4]
        return best

    def reset(self):
        """Drop accumulated samples (e.g. between a warm-up segment and the
        measured run: the tracer is global). Keeps `detail`; drops the
        pending launches and, in detail mode, takes a new clock anchor."""
        self.totals.clear()
        self.counts.clear()
        self.samples.clear()
        self.records.clear()
        self.intervals.clear()
        self._pending.clear()
        if self._detail:
            self._anchor()

    def log(self, event: str, **fields):
        """A state event: does nothing; a caller wraps it to collect them."""

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

    def export(self, path: str):
        """Write the span ring and the card's intervals as one Chrome trace
        (microseconds of the host's perf_counter clock): a track for the
        host, one for the card. Resolves what is still pending first, after
        a synchronise."""
        if self._pending:
            self._resolve(wait=True)
        ev = [{"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "slam"}},
              {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1, "args": {"name": "host"}},
              {"name": "thread_name", "ph": "M", "pid": 1, "tid": 2, "args": {"name": "card"}}]
        for name, sid, parent, call, t0, t1, child, wait in self.records:
            ev.append({"name": name, "ph": "X", "pid": 1, "tid": 1, "ts": t0 / 1e3,
                       "dur": (t1 - t0) / 1e3,
                       "args": {"id": sid, "parent": parent, "call": call,
                                "self_us": (t1 - t0 - child) / 1e3, "wait_us": wait / 1e3}})
        for t0, t1, name, sid in self.intervals:
            ev.append({"name": name, "ph": "X", "pid": 1, "tid": 2, "ts": t0 / 1e3,
                       "dur": (t1 - t0) / 1e3, "args": {"span": sid}})
        with open(path, "w") as f:
            json.dump({"traceEvents": ev, "displayTimeUnit": "ms"}, f)


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
