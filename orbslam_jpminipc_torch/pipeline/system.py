"""The SLAM system (counterpart of orbslam_jpminipc_tpu/pipeline/system.py).

src/main.cc: builds the map, the keyframe database, the tracker and the
local mapper, wires them together and exposes a per-frame `process()`.
Instead of the reference's mutex-synchronized threads, stages run
deterministically: tracking per frame, and the mapping stages of a new
keyframe either right after the frame that made it, or
(`cfg.async_mapping`, the reference package's default) queued and worked
off over the following frames, a few stages a frame and never one whose
device program has not finished. The non-empty queue is the mapper-busy
gate of the keyframe decision. With a vocabulary every keyframe is indexed
in a `KeyFrameDatabase` and a LOST tracker relocalizes against it. The
keyframe trajectory (main.cc:226-245, TUM order) comes from
`keyframe_trajectory()`.

Not ported yet, and refused instead of being run some other way:
`pipelined_tracking` (a workaround for the reference's device link) and
loop closing (`enable_loop_closing=True` with a vocabulary).
"""
from __future__ import annotations

import numpy as np

from ..config import SlamConfig
from ..frontend.frame import Frame, build_frame
from ..frontend.tracking import Tracker, TrackState
from ..map.device_map import DeviceMap
from ..map.keyframe_db import KeyFrameDatabase
from ..map.map_state import MapState
from ..solvers import ba
from ..utils.device import resolve_device
from ..utils.host import fetch
from ..utils.tracing import get_tracer
from .local_mapping import LocalMapper


class Slam:
    def __init__(self, cfg: SlamConfig, vocab=None, enable_loop_closing: bool = True,
                 device=None):
        if cfg.pipelined_tracking:
            raise ValueError("pipelined_tracking=True is not supported: set it to False")
        if vocab is not None and enable_loop_closing:
            raise ValueError("loop closing is not ported yet: pass enable_loop_closing=False "
                             "with a vocabulary")
        self.cfg = cfg
        self.device = resolve_device(device)
        # keyframe feature arrays sized for the 2x init extractor output
        self.map = MapState.create(cfg.max_kf, cfg.max_mp, 2 * cfg.n_features, cfg.max_obs,
                                   device=self.device)
        self.kfdb = (KeyFrameDatabase(vocab, cfg.max_kf, device=self.device)
                     if vocab is not None else None)
        self.tracker = Tracker(cfg, self.map, self.kfdb, device=self.device)
        self.mapper = LocalMapper(cfg, self.map, self.kfdb, device=self.device)
        self.tracker.on_initialized = self._create_initial_map
        self.tracker.on_new_keyframe = self._on_new_keyframe
        self.tracker.dmap = self.mapper.dmap
        if cfg.async_mapping:
            self.tracker.mapper_busy = self._mapper_busy
        self.frame_count = 0
        self.trajectory: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.tracer = get_tracer()
        # amortized mapping queue: (kf, [remaining stages]), worked off a few
        # stages a frame when cfg.async_mapping, in place of the reference's
        # mapper thread (main.cc:182, LocalMapping.cc:52-127)
        self.pending: list[tuple[int, list[str]]] = []
        self._inlier_peak = 0.0
        self._last_result: tuple[TrackState, Frame | None] = (TrackState.NO_IMAGES_YET, None)

    # ------------------------------------------------------------------

    def process(self, image, timestamp: float = 0.0) -> tuple[TrackState, Frame]:
        """One frame: a (H, W) uint8 host array or tensor. Returns the
        tracking state and the frame (its pose in frame.R / frame.t)."""
        frame_id = self.frame_count
        self.frame_count += 1
        tr = self.tracker
        # while tracking quality is degrading (against a decaying peak of
        # the inlier count), interrupt BA and finish the mapper's backlog
        # NOW, every degraded frame, so the keyframe the tracker needs is
        # not refused by the busy gate (InterruptBA dynamics,
        # Tracking.cc:692-698)
        self._inlier_peak = 0.97 * self._inlier_peak
        if tr.state == TrackState.WORKING:
            self._inlier_peak = max(float(tr.n_inliers), self._inlier_peak)
        degraded = (tr.n_inliers < self.cfg.pipeline_guard_inliers
                    or tr.n_inliers < 0.7 * self._inlier_peak)
        if degraded and self.pending:
            with self.tracer.stage("mapping_hard_drain"):
                self._drain_mapping_hard()
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
                                    n_features=n_features, device=self.device)
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
        if state == TrackState.LOST and 0 < n_kf <= 5:
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

    def finish(self):
        """Work off every pending mapping stage and apply what is still in
        flight at the end of a sequence (the reference joins its threads on
        shutdown, main.cc:222)."""
        while self.pending:
            self._run_pending_stage()
        self.mapper.drain_attrs()
        self.tracker.refresh_fused_slice()

    def reset(self):
        """Full reset (Tracking::Reset, Tracking.cc:1066-1103)."""
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
        m.dmap = DeviceMap(self.map.max_kf, self.map.n_feat, self.map.max_mp, device=self.device)
        tr.dmap = m.dmap
        self.pending = []

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
            # the reference queues a "loop" stage after these; loop closing
            # is refused in the constructor, so the stage is not queued
            self.pending.append((kf, list(self.mapper.STAGES)))
            return
        with self.tracer.stage("mapping"):
            kf = self.mapper.process(frame)
        if kf < 0:
            return  # capacity-refused insertion (alloc_kf)
        self.tracker.ref_kf = kf
        self.tracker.refresh_fused_slice()

    def _run_pending_stage(self) -> str:
        kf, stages = self.pending[0]
        stage = stages.pop(0)
        if not stages:
            self.pending.pop(0)
        if not self.map.kf_valid[kf]:
            return stage  # culled while queued
        self.mapper.run_stage(kf, stage)
        return stage

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
