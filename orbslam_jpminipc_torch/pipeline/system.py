"""The SLAM system (counterpart of orbslam_jpminipc_tpu/pipeline/system.py).

src/main.cc: builds the map, the keyframe database, the tracker, the
local mapper and the loop closer, wires them together and exposes a
per-frame `process()`. Instead of the reference's mutex-synchronized
threads, stages run deterministically: tracking per frame, and the mapping
stages of a new keyframe, loop closing last, either right after the frame
that made it, or (`cfg.async_mapping`, the reference package's default)
queued and worked off over the following frames, a few stages a frame and
never one whose device program has not finished. The non-empty queue is
the mapper-busy gate of the keyframe decision. With a vocabulary every
keyframe is indexed in a `KeyFrameDatabase`, a LOST tracker relocalizes
against it, and (`enable_loop_closing`, the default) every keyframe is
searched for a loop; a closed loop corrects the whole map through the
essential graph, optionally followed by global bundle adjustment
(`cfg.post_loop_gba`, or `global_ba()` by hand). The keyframe trajectory
(main.cc:226-245, TUM order) comes from `keyframe_trajectory()`.

With `cfg.pipelined_tracking` (the default, as the reference's) a WORKING
frame's fused step is dispatched without waiting for the device and the
host bookkeeping of an earlier frame whose results have landed is done
instead, so `process` returns the most recently COMPLETED frame, up to
`cfg.pipeline_depth` frames behind the one just submitted; keyframe
decisions lag by as much, the reference's mapper-thread lag
(LocalMapping.cc:52-127). While tracking degrades the depth drops to 1 for
10 frames. Records dispatched before a host intervention are tracked again
on the host path; `finish()` completes them all. With `cfg.distributed_gba`
(the default) and more than one device to shard over
(`parallel.mesh.mesh_devices`: every card of the process), global BA and
the essential graph take the sharded solvers of `parallel/`, as the
reference does on a multi-device mesh; with one device, the single-device
solvers.
"""
from __future__ import annotations

import weakref
from collections import deque
from time import monotonic as _monotonic

import numpy as np

from ..config import SlamConfig
from ..frontend.frame import Frame, build_frame
from ..frontend.tracking import Tracker, TrackState
from ..map.keyframe_db import KeyFrameDatabase
from ..map.map_state import MapState
from ..parallel import mesh as pmesh
from ..parallel.sharded_ba import shard_ba_problem, sharded_bundle_adjust
from ..solvers import ba, gba
from ..utils.device import resolve_device
from ..utils.host import fetch
from ..utils.tracing import get_tracer
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser


def _weak(method):
    """`method`, called through a weak reference to its object."""
    ref = weakref.WeakMethod(method)
    return lambda *a, **k: ref()(*a, **k)


class Slam:
    # the stages queued for every keyframe under cfg.async_mapping: the
    # mapper's, then loop closing (a host stage with blocking reads)
    STAGES = LocalMapper.STAGES + ("loop",)

    def __init__(self, cfg: SlamConfig, vocab=None, enable_loop_closing: bool = True,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # keyframe feature arrays sized for the 2x init extractor output
        self.map = MapState.create(cfg.max_kf, cfg.max_mp, 2 * cfg.n_features, cfg.max_obs,
                                   device=self.device)
        self.kfdb = (KeyFrameDatabase(vocab, cfg.max_kf, device=self.device)
                     if vocab is not None else None)
        self.tracker = Tracker(cfg, self.map, self.kfdb, device=self.device)
        self.mapper = LocalMapper(cfg, self.map, self.kfdb, device=self.device)
        self.loop_closer = (
            LoopCloser(cfg, self.map, self.kfdb, device=self.device)
            if (vocab is not None and enable_loop_closing)
            else None
        )
        # the tracker calls back through weak references: a dropped system
        # is freed at once, with the device memory of its map mirror's
        # programs, not at the collector's next pass
        self.tracker.on_initialized = _weak(self._create_initial_map)
        self.tracker.on_new_keyframe = _weak(self._on_new_keyframe)
        self.tracker.dmap = self.mapper.dmap
        if self.loop_closer is not None:
            self.loop_closer.dmap = self.mapper.dmap
        if cfg.async_mapping:
            self.tracker.mapper_busy = _weak(self._mapper_busy)
        self.frame_count = 0
        self.trajectory: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.n_loops_closed = 0
        self.tracer = get_tracer()
        # amortized mapping queue: (kf, [remaining stages]), worked off a few
        # stages a frame when cfg.async_mapping, in place of the reference's
        # mapper thread (main.cc:182, LocalMapping.cc:52-127)
        self.pending: list[tuple[int, list[str]]] = []
        # pipelined tracking: dispatched fused records whose host half has
        # not run yet, completed strictly in frame order
        self._inflight: deque = deque()
        self._inlier_peak = 0.0
        self._latency_frames = 0   # frames left at pipeline depth 1
        self._last_result: tuple[TrackState, Frame | None] = (TrackState.NO_IMAGES_YET, None)
        self._warming = False  # warmup() holds off the LOST auto-reset

    # ------------------------------------------------------------------

    def process(self, image, timestamp: float = 0.0) -> tuple[TrackState, Frame]:
        """One frame: a (H, W) uint8 host array or tensor. Returns the
        tracking state and the frame (its pose in frame.R / frame.t): this
        frame's, or pipelined, the most recently completed one's. The call
        is the tracer's root span `call`."""
        with self.tracer.stage("call"):
            return self._process(image, timestamp)

    def _process(self, image, timestamp: float) -> tuple[TrackState, Frame]:
        frame_id = self.frame_count
        self.frame_count += 1
        tr = self.tracker
        # while tracking quality is degrading (against a decaying peak of
        # the inlier count), interrupt BA and finish the mapper's backlog
        # NOW, every degraded frame, so the keyframe the tracker needs is
        # not refused by the busy gate (InterruptBA dynamics,
        # Tracking.cc:692-698); and pipeline at depth 1 for the next 10
        # frames, so that keyframe decisions land at once and dispatches
        # match a fresh slice
        self._inlier_peak = 0.97 * self._inlier_peak
        if tr.state == TrackState.WORKING:
            self._inlier_peak = max(float(tr.n_inliers), self._inlier_peak)
        degraded = (tr.n_inliers < self.cfg.pipeline_guard_inliers
                    or tr.n_inliers < 0.7 * self._inlier_peak)
        if degraded:
            if self.pending:
                with self.tracer.stage("mapping_hard_drain"):
                    self._drain_mapping_hard()
            self._latency_frames = 10
        else:
            self._latency_frames = max(0, self._latency_frames - 1)
        if self.cfg.pipelined_tracking and tr.fused_usable(frame_id):
            self._inflight.append(tr.fused_dispatch(image, frame_id, timestamp))
            # the mapping tick BEFORE completing frames: a completion's
            # keyframe decision reads the stage queue as the mapper-busy
            # gate (Tracking.cc:679)
            self._mapping_tick()
            depth = 1 if self._latency_frames > 0 else self.cfg.pipeline_depth
            # bound the decision lag apart from the queue's depth: the head
            # is completed once it is 3 or more submissions old while a
            # latency episode is live, or older than 0.15 s of wall clock
            # (about 5 frame periods at 30 fps)
            head = self._inflight[0]
            head_stale = (frame_id - head.frame_id >= 3 and (
                self._latency_frames > 0 or _monotonic() - head.t_dispatch > 0.15))
            self._drain_inflight(force=len(self._inflight) > depth or head_stale)
            return self._last_result
        # the host path or the synchronous loop: complete every frame in
        # flight first (frame order)
        self._drain_inflight(drain_all=True)
        if tr.fused_usable(frame_id):
            # steady state: extraction happens inside the fused step
            with self.tracer.stage("track"):
                state, frame = tr.process_fused(image, frame_id, timestamp)
        else:
            # double feature budget until the map is initialized (the
            # reference builds a 2x-features init extractor, Tracking.cc:126)
            initializing = tr.state in (
                TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED,
                TrackState.INITIALIZING,
            )
            n_features = 2 * self.cfg.n_features if initializing else self.cfg.n_features
            with self.tracer.stage("extract"):
                frame = build_frame(image, self.cfg, frame_id=frame_id, timestamp=timestamp,
                                    n_features=n_features, extraction=tr.extraction)
            with self.tracer.stage("track"):
                state = tr.process_frame(frame)
            if state == TrackState.WORKING and self.cfg.fused_tracking:
                # (re)arm the fused path for the next frame
                tr.enter_fused(frame)
        self._after_track(state, frame, timestamp)
        self._mapping_tick()
        return self._last_result

    def _mapper_busy(self) -> bool:
        """The mbAcceptKeyFrames gate (Tracking.cc:679 / LocalMapping.cc:
        529-539): busy while the stage queue is non-empty. This
        backpressure is load-bearing: it rations keyframes the way the
        reference's mapper thread does (a looser gate floods the map with
        tiny-baseline keyframes and tracking collapses)."""
        return bool(self.pending)

    def _after_track(self, state: TrackState, frame: Frame, timestamp: float):
        """Trajectory entry + auto-reset after a failed start
        (Tracking.cc:287-294: the reference gates on map size alone)."""
        if frame is not None and frame.R is not None:
            self.trajectory.append((timestamp, frame.R.copy(), frame.t.copy()))
        n_kf = int(self.map.kf_valid.sum())
        if state == TrackState.LOST and 0 < n_kf <= 5 and not self._warming:
            self.reset()
        self._last_result = (state, frame)

    def _mapping_tick(self):
        """Amortized mapping: run pending stages after the pose is out (the
        tracker never waits for the mapper). Stages are either launches or
        cheap host halves, so run until a second launch is out, a host
        half's read has not landed, 8 stages ran, or the queue empties."""
        if not self.pending:
            return
        with self.tracer.stage("mapping"):
            dispatched = 0
            for _ in range(8):
                if not self.pending:
                    break
                kf, stages = self.pending[0]
                if (self.map.kf_valid[kf]
                        and not self.mapper.stage_ready(kf, stages[0])):
                    # the stage would wait for a device program still in
                    # flight: skip mapping this frame, the tracker keeps
                    # streaming (the reference's tracker never waits for
                    # its mapper thread either)
                    self.tracer.log("mapping_not_ready", kf=int(kf), stage=stages[0])
                    break
                stage = self._run_pending_stage()
                if stage in LocalMapper.DISPATCH_STAGES:
                    # at most two programs in flight per tick
                    dispatched += 1
                    if dispatched >= 2:
                        break
        # mapping stages mutate the map: refresh the device-resident
        # tracking slice so the fused path sees it
        self.tracker.refresh_fused_slice()

    def _drain_mapping_hard(self):
        """Finish every pending mapping stage NOW, aborting bundle
        adjustment the way a new keyframe would (InterruptBA,
        LocalMapping.cc:541-544): the 5-iteration first BA stage still
        runs (the reference's aborted BA also writes back the iterations
        it completed, Optimizer.cc:450-452), only the second 10-iteration
        stage is skipped. Waits for the programs in flight: used only when
        the tracker is degrading and needs the mapper idle to insert a
        keyframe."""
        while self.pending:
            kf, stages = self.pending[0]
            if "ba2_d" in stages:
                i = stages.index("ba2_d")
                del stages[i:i + 2]
                # ba_abort writes the 5-iteration state back to the map:
                # after ba_m when stage 1 is still queued, immediately in
                # its place when stage 1 already ran
                stages.insert(
                    i if "ba_d" not in stages else stages.index("ba_m") + 1,
                    "ba_abort")
                self.tracer.log("ba_aborted", kf=int(kf), by="hard_drain")
            self._run_pending_stage()
        self.mapper.drain_attrs(force=True)
        self.tracker.refresh_fused_slice()

    def _drain_inflight(self, force: bool = False, drain_all: bool = False):
        """Complete in-flight pipelined records whose reads have landed,
        strictly in frame order. force: complete at least one (waiting for
        its read). drain_all: complete every one."""
        tr = self.tracker
        while self._inflight:
            head = self._inflight[0]
            if not (drain_all or force or head.future.done()):
                break
            force = False
            self._inflight.popleft()
            if tr.fused is None or head.epoch != tr.fused.epoch:
                # dispatched against device state the host has since
                # rewritten (a fallback pose, LOST, a reset, a
                # relocalization): track the frame again on the host path
                with self.tracer.stage("track"):
                    state, frame = tr.reprocess_stale(head)
                self.tracer.log("reprocess_stale", frame=int(head.frame_id))
                if state == TrackState.WORKING and self.cfg.fused_tracking:
                    tr.enter_fused(frame)
            else:
                with self.tracer.stage("track"):
                    state, frame = tr.fused_complete(head)
            self._after_track(state, frame, head.timestamp)

    def finish(self):
        """Complete every frame in flight, work off every pending mapping
        stage and apply what is still in flight at the end of a sequence
        (the reference joins its threads on shutdown, main.cc:222)."""
        self._drain_inflight(drain_all=True)
        while self.pending:
            self._run_pending_stage()
        self.mapper.drain_attrs()
        self.tracker.refresh_fused_slice()

    def warmup(self):
        """Capture every program of the steady state and of the recovery
        paths before live frames arrive (the reference's warmup: a real-time
        system cannot stall on a capture mid-run), then put the system back
        as a fresh one: empty map and trajectory, frame count 0.

        Two phases, as the reference's: (1) `_compile_programs`, every
        captured program at the config's shapes; (2) a short rendered
        sequence on the system's device driving the whole pipeline:
        initialization, one WORKING frame, a noise frame (collapse, host
        fallback, LOST, relocalization), then 20 steady frames with the
        mapping stages. Phase 2 also takes every eager path's first-call
        costs (library handles, kernel modules, the caching allocator).
        Without `warmup()` a program is captured at its first call."""
        self._compile_programs()
        cfg = self.cfg
        from ..io.dataset import SyntheticSequence

        seq = SyntheticSequence(
            n_frames=60, width=cfg.width, height=cfg.height,
            K4=tuple(float(x) for x in cfg.K4), trajectory="xyz", seed=11,
            device=self.device)
        noise = np.random.default_rng(7).integers(
            0, 256, (cfg.height, cfg.width)).astype(np.uint8)
        self._warming = True
        try:
            i, fps = 0, 30.0
            # initialization until WORKING
            while i < 12:
                state, _ = self.process(seq.get(i)[0], i / fps)
                i += 1
                if state == TrackState.WORKING:
                    break
            # one fused frame (arms the step), then noise: collapse, host
            # fallback, LOST, relocalization
            self.process(seq.get(i)[0], i / fps)
            self.process(noise, (i + 1) / fps)
            self._drain_inflight(drain_all=True)
            for j in range(i + 1, i + 4):
                self.process(seq.get(j)[0], j / fps)
            # steady tracking and the mapping stages
            for j in range(i + 4, i + 24):
                self.process(seq.get(j)[0], j / fps)
            self.finish()
        finally:
            self._warming = False
        self._restart()

    def _compile_programs(self):
        """Phase 1 of warmup(): capture, at the config's shapes, every
        program the reference compiles ahead of time (its
        `_compile_programs`): the WORKING step (every segment and both arms
        of its two host tests), the map mirror's stage programs
        (triangulation, fusion, both local-BA stages with their gathers, the
        attrs pass and the point scatter at their first two row buckets,
        the slice refresh), the tracking host path (extraction,
        frame-to-frame and local-map tracking, the relocalization
        candidate, both ladder rungs and the initialization attempt) and,
        with a loop closer, loop closing's matchers, the Sim3 RANSAC and
        refinement and the essential graph. On the CPU nothing is
        captured.

        Left eager: the sharded essential graph of several cards."""
        if self.tracker.fused is not None:
            self.tracker.fused.capture()
        self.mapper.capture_programs()
        self.tracker.capture_programs()
        if self.loop_closer is not None:
            self.loop_closer.capture_programs()

    def _restart(self):
        """The state of a freshly constructed system, its captured programs
        kept: `reset()`, then the counters, draws and trackers' marks a
        constructor starts from."""
        cfg = self.cfg
        self.reset()
        self.frame_count = 0
        self.trajectory.clear()
        self.n_loops_closed = 0
        self._inflight.clear()
        self._inlier_peak = 0.0
        self._latency_frames = 0
        self._last_result = (TrackState.NO_IMAGES_YET, None)
        tr = self.tracker
        tr.state = TrackState.NO_IMAGES_YET
        tr.last_kf_frame_id = 0
        tr.last_reloc_frame_id = -(10 ** 9)
        tr.n_inliers = 0
        tr.generator.manual_seed(cfg.seed)
        tr.__dict__.pop("_slice_key", None)
        if tr.fused is not None:
            tr.fused.slice_ids = np.zeros(0, np.int64)
            tr.fused.slice_gen = np.zeros(0, np.int32)
        if self.loop_closer is not None:
            self.loop_closer.last_loop_kf_id = -(10 ** 9)
            self.loop_closer.generator.manual_seed(cfg.seed + 1)
        self.tracer.reset()

    def reset(self):
        """Full reset (Tracking::Reset, Tracking.cc:1066-1103). Pipelined
        records in flight are kept: the context's epoch moves, so each is
        tracked again on the host path (initialization): they are real
        camera frames the reset must not swallow."""
        cfg = self.cfg
        self.map = MapState.create(cfg.max_kf, cfg.max_mp, 2 * cfg.n_features, cfg.max_obs,
                                   device=self.device)
        if self.kfdb is not None:
            self.kfdb.clear()
        tr = self.tracker
        tr.map = self.map
        tr.state = TrackState.NOT_INITIALIZED
        tr.velocity = None
        tr.last_frame = None
        tr.init_frame = None
        tr.ref_kf = -1
        if tr.fused is not None:
            tr.fused.invalidate()
        m = self.mapper
        m.map = self.map
        m.probation = []
        m._tri_pending = None
        m._fuse_pending = None
        m._ba_pending = None
        m._ba_stage1 = None
        m._ba2_pending = None
        m._attrs_pending = []
        m._attrs_inflight = None
        # emptied in place: the mirror's captured programs read its tensors
        m.dmap.clear()
        self.pending = []
        if self.loop_closer is not None:
            self.loop_closer.map = self.map
            self.loop_closer.consistent_groups = []

    # ------------------------------------------------------------------
    # initial map (Tracking::CreateInitialMap, Tracking.cc:422-524)
    # ------------------------------------------------------------------

    def _create_initial_map(self, f0: Frame, f1: Frame, match_info, init_res):
        idx, mask = match_info
        st, cfg = self.map, self.cfg
        good = np.asarray(init_res.good) & mask
        if good.sum() < 50:
            return
        R21 = np.asarray(init_res.R)
        t21 = np.asarray(init_res.t)
        pts3d = np.asarray(init_res.points)

        f0.R, f0.t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        f1.R, f1.t = R21.astype(np.float32), t21.astype(np.float32)

        kf0 = st.add_keyframe(
            f0.R, f0.t, f0.xy_un, f0.level, f0.angle, f0.desc, f0.valid,
            frame_id=f0.frame_id, timestamp=f0.timestamp,
        )
        kf1 = st.add_keyframe(
            f1.R, f1.t, f1.xy_un, f1.level, f1.angle, f1.desc, f1.valid,
            frame_id=f1.frame_id, timestamp=f1.timestamp,
        )
        feats0 = np.nonzero(good)[0]
        ids = st.add_points(
            pts3d[feats0], f0.desc[feats0], ref_kf=kf1, first_kf_id=st.next_kf_id - 1
        )
        for mp, fi in zip(ids, feats0):
            st.add_observation(int(mp), kf0, int(fi))
            st.add_observation(int(mp), kf1, int(idx[fi]))

        # global BA on the 2-KF map (Tracking.cc:476)
        self._two_frame_global_ba(kf0, kf1, ids)

        # gauge: scale to unit median depth (Tracking.cc:479-503)
        xc = st.mp_xyz[ids] @ st.kf_R[kf1].T + st.kf_t[kf1]
        med = float(np.median(xc[:, 2]))
        if med <= 0 or (~st.mp_valid[ids]).all():
            # degenerate: roll back (Tracking.cc:482-487)
            self.reset()
            return
        st.kf_t[kf1] /= med
        st.mp_xyz[ids] /= med
        # attributes AFTER the gauge scaling, so the scale bands and normals
        # describe the scaled geometry (the fused tracker reads them at once)
        dm = self.mapper.dmap
        dm.sync_keyframe(st, kf0)
        dm.sync_keyframe(st, kf1)
        dm.sync_points(st, ids)
        st.update_point_attributes(ids, cfg.scale_factors, dmap=dm)
        if self.kfdb is not None:
            self.kfdb.add(kf0, st.kf_desc[kf0], st.kf_feat_valid[kf0])
            self.kfdb.add(kf1, st.kf_desc[kf1], st.kf_feat_valid[kf1])
        covis = st.covisibility()
        st.update_spanning_tree(kf1, covis[kf1])
        dm.sync_points(st, ids)

        # frame bookkeeping -> WORKING
        f1.point[:] = -1
        f1.point[idx[feats0]] = ids
        f1.point_gen[idx[feats0]] = st.mp_gen[ids]
        f1.R, f1.t = st.kf_R[kf1].copy(), st.kf_t[kf1].copy()
        tr = self.tracker
        tr.ref_kf = kf1
        tr.last_kf_frame_id = f1.frame_id
        tr.state = TrackState.WORKING
        self.mapper.probation.extend((int(i), int(st.mp_gen[i])) for i in ids)

    def _two_frame_global_ba(self, kf0: int, kf1: int, ids: np.ndarray, iters: int = 20):
        st, cfg = self.map, self.cfg
        # fixed capacity: init produces <= one point per f0 feature
        P = max(2048, 1 << int(np.ceil(np.log2(2 * cfg.n_features))))
        points = np.zeros((P, 3), np.float32)
        points[: len(ids)] = st.mp_xyz[ids]
        pvalid = np.zeros(P, bool)
        pvalid[: len(ids)] = True
        O = 2 * P
        obs_kf = np.zeros(O, np.int64)
        obs_pt = np.zeros(O, np.int64)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_w = np.ones(O, np.float32)
        obs_valid = np.zeros(O, bool)
        n = 0
        for i, p in enumerate(ids):
            for s in np.nonzero(st.mp_obs_kf[p] >= 0)[0]:
                k = int(st.mp_obs_kf[p, s])
                f = int(st.mp_obs_feat[p, s])
                obs_kf[n] = 0 if k == kf0 else 1
                obs_pt[n] = i
                obs_uv[n] = st.kf_xy[k, f]
                obs_w[n] = cfg.inv_sigma2[min(int(st.kf_level[k, f]), cfg.n_levels - 1)]
                obs_valid[n] = True
                n += 1
        put = self.mapper.dmap.put
        prob = ba.BAProblem(
            kf_R=put(np.stack([st.kf_R[kf0], st.kf_R[kf1]])),
            kf_t=put(np.stack([st.kf_t[kf0], st.kf_t[kf1]])),
            kf_fixed=put(np.array([True, False])),
            points=put(points), point_valid=put(pvalid),
            obs_kf=put(obs_kf), obs_pt=put(obs_pt),
            obs_uv=put(obs_uv), obs_w=put(obs_w),
            obs_valid=put(obs_valid), K4=put(cfg.K4),
        )
        res = ba.bundle_adjust(prob, iterations=iters)
        kf_R1, kf_t1, points = fetch(res.kf_R[1], res.kf_t[1], res.points)  # one read
        st.kf_R[kf1] = kf_R1
        st.kf_t[kf1] = kf_t1
        st.mp_xyz[ids] = points[: len(ids)]

    # ------------------------------------------------------------------

    def _on_new_keyframe(self, frame: Frame):
        if self.cfg.async_mapping:
            # insert synchronously (the tracker needs the reference KF and
            # its observations), then queue the heavy stages
            with self.tracer.stage("mapping"):
                kf = self.mapper.insert_keyframe(frame)
            if kf < 0:
                return  # capacity-refused insertion (alloc_kf)
            self.tracker.ref_kf = kf
            self.tracker.refresh_fused_slice()
            for qkf, stages in self.pending:
                # InterruptBA semantics (LocalMapping.cc:541-544 -> g2o
                # setForceStopFlag, Optimizer.cc:58-59):
                # - BA not yet started: cancel it entirely;
                # - stage 1 running/done but stage 2 not launched: abort,
                #   write back the 5-iteration state without the outlier
                #   erase passes (Optimizer.cc:450-452 + bDoMore=false)
                if "ba_d" in stages:
                    for s_ in ("ba_d", "ba_m", "ba2_d", "ba2_m"):
                        if s_ in stages:
                            stages.remove(s_)
                    self.tracer.log("ba_cancelled", kf=int(qkf), by=int(kf))
                elif "ba2_d" in stages:
                    i = stages.index("ba2_d")
                    del stages[i:i + 2]
                    stages.insert(i, "ba_abort")
                    self.tracer.log("ba_aborted", kf=int(qkf), by=int(kf))
            # queued whether or not there is a loop closer, as the reference
            # does: the stage counts toward a tick's budget either way
            self.pending.append((kf, list(self.STAGES)))
            return
        with self.tracer.stage("mapping"):
            kf = self.mapper.process(frame)
        if kf < 0:
            return  # capacity-refused insertion (alloc_kf)
        self.tracker.ref_kf = kf
        self._loop_close(kf)
        self.tracker.refresh_fused_slice()

    def _run_pending_stage(self) -> str:
        kf, stages = self.pending[0]
        stage = stages.pop(0)
        if not stages:
            self.pending.pop(0)
        if not self.map.kf_valid[kf]:
            return stage  # culled while queued
        if stage == "loop":
            # loop detection/correction reads host point attributes: apply
            # any deferred attrs writeback first
            self.mapper.drain_attrs()
            self._loop_close(kf)
        else:
            self.mapper.run_stage(kf, stage)
        return stage

    def _loop_close(self, kf: int):
        if self.loop_closer is None:
            return
        with self.tracer.stage("loop_closing"):
            closed = self.loop_closer.process(kf)
        if closed:
            self.n_loops_closed += 1
            self.tracer.log("loop_closed", kf=int(kf))
            # the correction rewrote poses and points wholesale
            self.mapper.dmap.sync_all(self.map)
            self.tracker.force_relocalization()
            if self.cfg.post_loop_gba:
                with self.tracer.stage("global_ba"):
                    self.global_ba()

    # ------------------------------------------------------------------
    # global bundle adjustment over the whole map (Optimizer.cc:38-152)
    # ------------------------------------------------------------------

    def build_global_ba_problem(self):
        """Full-map BAProblem at fixed capacity (max_kf, max_mp, gba_obs):
        every valid keyframe is a vertex (the oldest one fixed as the
        gauge: GlobalBundleAdjustemnt fixes mnId==0, Optimizer.cc:87),
        every valid point a landmark, observations gathered from the
        adjacency. Returns (problem, number of observations)."""
        st, cfg = self.map, self.cfg
        pts = np.nonzero(st.mp_valid)[0]
        kf_index = np.where(st.kf_valid, np.arange(st.max_kf), -1).astype(np.int32)
        O = cfg.gba_obs
        obs_kf = np.zeros(O, np.int64)
        obs_pt = np.zeros(O, np.int64)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_w = np.ones(O, np.float32)
        obs_valid = np.zeros(O, bool)
        from ..native import build_ba_obs_native

        native = build_ba_obs_native(st, pts, kf_index, O)
        if native is not None:
            okf, _, ofe, osp, osk = native
        else:
            okf, ofe, osp, osk = [], [], [], []
            for p in pts:
                for s in np.nonzero(st.mp_obs_kf[p] >= 0)[0]:
                    if len(okf) >= O:
                        break
                    okf.append(int(st.mp_obs_kf[p, s]))
                    ofe.append(int(st.mp_obs_feat[p, s]))
                    osp.append(int(p))
                    osk.append(int(st.mp_obs_kf[p, s]))
            okf, ofe = np.array(okf, np.int32), np.array(ofe, np.int32)
            osp, osk = np.array(osp, np.int32), np.array(osk, np.int32)
        n = len(okf)
        obs_kf[:n] = okf
        obs_pt[:n] = osp           # kf_index is the identity on valid KFs
        obs_uv[:n] = st.kf_xy[osk, ofe]
        lv = np.clip(st.kf_level[osk, ofe], 0, cfg.n_levels - 1)
        obs_w[:n] = cfg.inv_sigma2[lv]
        obs_valid[:n] = True

        fixed = ~st.kf_valid
        if st.kf_valid.any():
            live = np.nonzero(st.kf_valid)[0]
            fixed[int(live[np.argmin(st.kf_frame_id[live])])] = True
        put = self.mapper.dmap.put
        return ba.BAProblem(
            kf_R=put(st.kf_R), kf_t=put(st.kf_t), kf_fixed=put(fixed),
            points=put(st.mp_xyz), point_valid=put(st.mp_valid),
            obs_kf=put(obs_kf), obs_pt=put(obs_pt), obs_uv=put(obs_uv), obs_w=put(obs_w),
            obs_valid=put(obs_valid), K4=put(cfg.K4),
        ), n

    def global_ba(self, iterations: int | None = None):
        """Run global BA and write back poses and points. With more than one
        device to shard over and `cfg.distributed_gba`, the map-partitioned
        solver runs (points and observations sharded, the reduced camera
        system summed over the devices, parallel/sharded_ba.py); otherwise
        the implicit-Schur PCG on the system's device. The reference's
        global variant does not erase outlier observations (only local BA
        does, Optimizer.cc:453-470). Returns the result, or None when the
        map holds fewer than 20 observations."""
        st, cfg = self.map, self.cfg
        prob, n_obs = self.build_global_ba_problem()
        if n_obs < 20:
            return None
        iters = cfg.gba_iterations if iterations is None else iterations
        devices = pmesh.mesh_devices(self.device)
        if len(devices) > 1 and cfg.distributed_gba:
            sprob = shard_ba_problem(prob, len(devices))
            R, t, pts_sh, chi2, out = sharded_bundle_adjust(
                sprob, pmesh.DeviceMesh(devices), iterations=iters)
            res = ba.BAResult(kf_R=R, kf_t=t, points=pts_sh.reshape(-1, 3)[: st.max_mp],
                              chi2=chi2, obs_outlier=out)
        else:
            res = gba.bundle_adjust_large(prob, iterations=iters, cg_iters=cfg.gba_cg_iters)
        kf_R, kf_t, points, fixed = fetch(res.kf_R, res.kf_t, res.points,
                                          prob.kf_fixed.to(res.kf_R.device))  # one read
        live = st.kf_valid & ~fixed
        st.kf_R[live] = kf_R[live]
        st.kf_t[live] = kf_t[live]
        st.mp_xyz[st.mp_valid] = points[st.mp_valid]
        # refresh the mirror FIRST so the attrs pass gathers the post-BA
        # poses and points on the device, then sync the recomputed
        # attributes back into it
        dm = self.mapper.dmap
        dm.sync_all(st)
        ids = np.nonzero(st.mp_valid)[0]
        st.update_point_attributes(ids, cfg.scale_factors, dmap=dm)
        dm.sync_points(st, ids)
        return res

    # ------------------------------------------------------------------

    def keyframe_trajectory(self) -> list[tuple[float, np.ndarray, np.ndarray]]:
        """Keyframe poses in TUM order (main.cc:226-245)."""
        st = self.map
        out = []
        for k in np.argsort(st.kf_timestamp):
            if st.kf_valid[k]:
                out.append((float(st.kf_timestamp[k]), st.kf_R[k].copy(), st.kf_t[k].copy()))
        return out

    @property
    def n_keyframes(self) -> int:
        return int(self.map.kf_valid.sum())

    @property
    def n_points(self) -> int:
        return int(self.map.mp_valid.sum())
