"""One measured session: the system under test built as its users call it,
a closed-loop window of `Slam.process` calls, and what the benchmark
records around it from its own files.

`Recorder` wraps methods of one `Slam` instance (as the port's
`StageQueueAudit` does): the system does not know of it. It notes when each
submitted frame's result came out and the pose it reported
(`Slam._after_track`), the features of every completed frame, each keyframe
inserted, each reset, and, for the checks, samples of the timed path's
answers: the WORKING step's bindings with the local-map slice it matched
against (`Tracker.fused_dispatch` and `fused_complete`, frames drawn by a
stride from the seed), every relocalization's bindings and pose
(`Tracker._relocalize`), and local BAs (keyframes drawn by a stride from the
seed) with the map they were assembled from, the problem the program
assembled and both stages' results (`LocalMapper.build_local_ba_problem`,
`ba_merge`, `_ba_writeback`). With tracing on it also marks the layer calls
with `record_function` ranges for the device trace; those wrap the program's
methods directly, so nothing the Recorder copies falls inside them.
"""
from __future__ import annotations

import contextlib
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from .reference.ba import SNAP_FIELDS

_NONE = object()
BA_FIELDS = ("kf_R", "kf_t", "kf_fixed", "points", "point_valid", "obs_kf", "obs_pt",
             "obs_uv", "obs_w", "obs_valid", "K4")


@dataclass
class RunRecord:
    spans: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    trace: dict | None = None
    config: dict = field(default_factory=dict)


class Recorder:
    def __init__(self, slam, ranges: bool = False, seed: int = 0, every: dict | None = None):
        self.slam = slam
        self.done_in_call = []        # frames completed during the call in progress
        self.completed = {}           # frame id -> (state name, centre or None, segment)
        self.poses = {}               # frame id -> (R, t) reported, float64
        self.frames = {}              # frame id -> Frame (its features)
        self.steps = {}               # frame id -> the step's inlier bindings (host)
        self.relocs = []              # one dict per relocalization that succeeded
        self.ba = []                  # one dict per sampled local BA
        self.keyframes = 0
        self.keyframes_in_window = 0
        self.segment = 0              # bumped by every reset: a new map, a new gauge
        every = every or {"frame": 1, "ba": 1}
        rng = np.random.default_rng([seed, 0x5A])
        self._every = every
        self._offset = {k: int(rng.integers(v)) for k, v in every.items()}
        self._slices = {}             # frame id -> (xyz, desc) of the slice at dispatch
        self._n_ba = 0
        self._snap = None             # (kf, map arrays) of a sampled BA being assembled
        self._installed = []
        if ranges:
            self._ranges()
        self._wrap_after_track()
        self._wrap("reset", self._on_reset, slam)
        self._wrap("insert_keyframe", self._on_insert, slam.mapper)
        self._wrap("ba_merge", self._on_ba_merge, slam.mapper)
        self._wrap("_ba_writeback", self._on_writeback, slam.mapper)
        self._wrap("_relocalize", self._on_relocalize, slam.tracker)
        self._wrap("fused_complete", self._on_complete, slam.tracker)
        self._wrap_before("fused_dispatch", self._on_dispatch, slam.tracker)
        self._wrap_before("build_local_ba_problem", self._on_build, slam.mapper)

    def _install(self, obj, name, fn):
        """Put `fn` in place of the instance's method; `detach` undoes it."""
        self._installed.append((obj, name, obj.__dict__.get(name, _NONE)))
        setattr(obj, name, fn)

    def detach(self):
        """Give the instance its own methods back (last installed first)."""
        for obj, name, prev in reversed(self._installed):
            if prev is _NONE:
                delattr(obj, name)
            else:
                setattr(obj, name, prev)
        self._installed.clear()

    def _wrap(self, name, after, obj):
        orig = getattr(obj, name)

        def wrapped(*a, **k):
            out = orig(*a, **k)
            after(out, *a, **k)
            return out

        self._install(obj, name, wrapped)

    def _wrap_before(self, name, before, obj):
        orig = getattr(obj, name)

        def wrapped(*a, **k):
            before(*a, **k)
            return orig(*a, **k)

        self._install(obj, name, wrapped)

    def _sampled(self, kind: str, i: int) -> bool:
        return i % self._every[kind] == self._offset[kind]

    def _wrap_after_track(self):
        slam = self.slam
        orig = slam._after_track

        def after_track(state, frame, timestamp):
            n = len(slam.trajectory)
            orig(state, frame, timestamp)
            fid = frame.frame_id
            centre = None
            if len(slam.trajectory) > n:
                _, R, t = slam.trajectory[-1]
                R, t = R.astype(np.float64), t.astype(np.float64)
                centre = -R.T @ t
                self.poses[fid] = (R, t)
            self.completed[fid] = (state.name, centre, self.segment)
            self.frames[fid] = frame
            self.done_in_call.append(fid)

        self._install(slam, "_after_track", after_track)

    def _on_reset(self, _out):
        self.segment += 1

    def _on_insert(self, kf, _frame):
        self.keyframes += kf >= 0

    def _on_dispatch(self, _image, frame_id, _timestamp):
        """A sampled frame: the slice the step is about to match against,
        copied on the device in stream order (no wait)."""
        slc = self.slam.tracker.fused.slice
        if slc is not None and self._sampled("frame", frame_id):
            self._slices[frame_id] = (slc.xyz.clone(), slc.desc.clone())

    def _on_complete(self, out, rec):
        fid = rec.frame_id
        if fid not in self._slices:
            return
        state, _frame = out
        host = rec.future.result()
        # the step's own pose was kept (no host fallback under 30 inliers)
        if state.name == "WORKING" and int(host[2]) >= 30:
            self.steps[fid] = {"bind": np.array(host[3]), "uv": np.array(host[6]),
                               "level": np.array(host[7]), "desc": np.array(host[10])}
        else:
            del self._slices[fid]

    def _on_relocalize(self, ok, frame):
        if not ok:
            return
        st = self.slam.map
        inl = (frame.point >= 0) & ~frame.outlier
        pts = frame.point[inl].astype(np.int64)
        self.relocs.append({
            "frame": int(frame.frame_id), "segment": self.segment,
            "R": np.array(frame.R, np.float64), "t": np.array(frame.t, np.float64),
            "xw": np.array(st.mp_xyz[pts]), "desc_m": np.array(st.mp_desc[pts]),
            "uv": np.array(frame.xy_un[inl]), "level": np.array(frame.level[inl]),
            "desc": np.array(frame.desc[inl])})

    def _on_build(self, kf):
        """A sampled local BA: the map it is assembled from, as it stands."""
        i = self._n_ba
        self._n_ba += 1
        self._snap = None
        if self._sampled("ba", i):
            st = self.slam.map
            self._snap = (kf, {f: np.array(getattr(st, f)) for f in SNAP_FIELDS})

    def _on_ba_merge(self, _out, kf):
        s1 = self.slam.mapper._ba_stage1
        if s1 is None or s1[0] != kf or self._snap is None or self._snap[0] != kf:
            return
        prob, res = s1[1], s1[-1]
        self.ba.append({"kf": int(kf), "map": self._snap[1], "prob_obj": prob,
                        "prob": {f: np.array(getattr(prob, f)) for f in BA_FIELDS},
                        "kfs": [int(k) for k in s1[2]], "pts": np.array(s1[3], np.int64),
                        "res1": (np.array(res.kf_R), np.array(res.kf_t), np.array(res.points)),
                        "out1": np.array(res.obs_outlier),
                        "res2": None})
        self._snap = None

    def _on_writeback(self, _out, prob, all_kfs, pts, gens, obs_src, kf_R, kf_t, points,
                      outlier):
        if outlier is None:        # a BA cut between its stages: no second stage
            return
        for b in self.ba:
            if b["prob_obj"] is prob:
                b["res2"] = (np.array(kf_R), np.array(kf_t), np.array(points))

    def finish(self):
        """After the window: the sampled slices to the host, matched with the
        step's inlier bindings."""
        for fid, (xyz, desc) in self._slices.items():
            s = self.steps.get(fid)
            if s is None:
                continue
            bind = s.pop("bind")
            inl = bind >= (1 << 16)      # slice slot | the pose optimizer's inlier bit
            slot = (bind[inl] & 0xFFFF).astype(np.int64)
            xyz, desc = xyz.cpu().numpy(), desc.cpu().numpy()
            s.update(xw=xyz[slot], desc_m=desc[slot], uv=s["uv"][inl],
                     level=s["level"][inl], desc=s["desc"][inl])
        self.steps = {f: s for f, s in self.steps.items() if "xw" in s}
        self._slices.clear()
        for b in self.ba:
            b.pop("prob_obj", None)

    def _ranges(self):
        """`bench.*` ranges around the layer calls, for the device trace."""
        from torch.autograd.profiler import record_function

        def mark(obj, name, label):
            orig = getattr(obj, name)

            def marked(*a, **k):
                with record_function(label):
                    return orig(*a, **k)

            self._install(obj, name, marked)

        slam, tr = self.slam, self.slam.tracker
        mark(tr, "fused_dispatch", "bench.fused_dispatch")
        mark(tr, "fused_complete", "bench.fused_complete")
        mark(tr, "process_frame", "bench.host_track")
        mark(tr, "_relocalize", "bench.relocalize")
        mark(slam, "_mapping_tick", "bench.mapping_tick")
        mark(slam, "_drain_mapping_hard", "bench.mapping_hard_drain")
        mark(slam, "_loop_close", "bench.loop_closing")
        run_stage = slam.mapper.run_stage

        def staged(kf, stage):
            with record_function(f"bench.stage.{stage}"):
                return run_stage(kf, stage)

        self._install(slam.mapper, "run_stage", staged)

    def take_done(self) -> list:
        out, self.done_in_call = self.done_in_call, []
        return out


@dataclass
class Window:
    submitted: list          # host time of each submission
    call_s: list             # how long each call blocked
    done_at: dict            # frame id -> host time its result was out
    failed_calls: int
    seconds: float           # first submission to last return
    finish_s: float
    prof: object = None      # the torch.profiler window of the stretch
    spans: dict = field(default_factory=dict)   # the program's spans over the window
    # (spans, keyframes, LOST frames) at the stretch's start and end: the
    # profiler slows the stretch, so span readers leave it out
    stretch_marks: list = field(default_factory=list)


def run_window(slam, rec: Recorder, stream, seconds: float, stretch=None,
               max_frames: int | None = None, cuda: bool = True) -> Window:
    """Feed frames 0, 1, ... as each call returns, until `seconds` have
    passed (or `max_frames` were fed); then `Slam.finish()` completes the
    frames still in flight. With `stretch` = (first, last) call indices,
    profile those calls with `torch.profiler` (no end-to-end metric is read
    from a traced run)."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    submitted, call_s, done_at = [], [], {}
    failed = 0
    slam.tracer.reset()
    t0 = time.perf_counter()
    i = 0
    prof = result = None
    tracer = slam.tracer
    marks = []

    def mark():
        lost = sum(1 for c in rec.completed.values() if c[0] == "LOST")
        marks.append(({k: (tracer.totals[k], tracer.counts[k]) for k in tracer.totals},
                      rec.keyframes, lost))

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    while True:
        if stretch is not None and i == stretch[0]:
            mark()
            prof = profile(activities=acts)
            prof.__enter__()
        img, ts, _ = stream.frame(i)
        ta = time.perf_counter()
        try:
            with record_function("bench.call") if prof is not None else contextlib.nullcontext():
                slam.process(img, ts)
        except Exception:      # a call that raises counts as failed; the stream goes on
            failed += 1
            if failed == 1:
                traceback.print_exc(file=sys.stderr)
        tb = time.perf_counter()
        submitted.append(ta)
        call_s.append(tb - ta)
        for fid in rec.take_done():
            done_at[fid] = tb
        i += 1
        if prof is not None and i > stretch[1]:
            sync()
            prof.__exit__(None, None, None)
            mark()
            result, prof, stretch = prof, None, None
        if tb - t0 >= seconds or (max_frames is not None and i >= max_frames):
            break
    t_end = time.perf_counter()
    spans = {k: (tracer.totals[k], tracer.counts[k]) for k in tracer.totals}
    rec.keyframes_in_window = rec.keyframes
    if prof is not None:       # the window closed inside the stretch
        sync()
        prof.__exit__(None, None, None)
        mark()
        result = prof
    fa = time.perf_counter()
    slam.finish()
    fb = time.perf_counter()
    for fid in rec.take_done():
        done_at[fid] = fb
    return Window(submitted, call_s, done_at, failed, t_end - t0, fb - fa, result, spans, marks)


def outside_stretch(spans: dict, counts: dict, marks: list) -> tuple[dict, dict]:
    """The window's spans and keyframe and LOST counts without the profiled
    stretch's share."""
    if len(marks) != 2:
        return spans, counts
    (s0, k0, l0), (s1, k1, l1) = marks
    out = {}
    for k, (tot, n) in spans.items():
        a, b = s0.get(k, (0.0, 0)), s1.get(k, (0.0, 0))
        out[k] = (tot - (b[0] - a[0]), n - (b[1] - a[1]))
    counts = dict(counts, keyframes=counts["keyframes"] - (k1 - k0), lost=counts["lost"] - (l1 - l0))
    return out, counts
