"""Local mapping: keyframe insertion, triangulation, fusion, local BA
(counterpart of orbslam_jpminipc_tpu/pipeline/local_mapping.py).

src/LocalMapping.cc: ProcessNewKeyFrame (:145-195), MapPointCulling
(:197-225), CreateNewMapPoints (:227-393, epipolar search against 20
covisible keyframes + 6 validity gates), SearchInNeighbors (:395-472,
two-way fusion), local BA (:84), KeyFrameCulling (:546-600). The
reference's polling thread becomes a deterministic per-keyframe call from
the System: either every stage of a keyframe back to back (`process`), or
one stage at a time spread over later frames (`run_stage`, the System's
stage queue under `cfg.async_mapping`).

The heavy stages are split into a device half ("*_d": the torch program
over the device mirror, ending with its results' read queued into pinned
host memory, `utils/host.fetch_async`) and a host half ("*_m": take the
read + the bookkeeping). `stage_ready` asks the queued read's event
whether a host half can run without waiting for the device.
"""
from __future__ import annotations

import numpy as np

from ..config import SlamConfig
from ..frontend.frame import Frame
from ..map import culling
from ..map.device_map import DeviceMap, fuse_kernel, local_ba_kernel, tri_kernel
from ..map.map_state import MapState
from ..solvers import ba
from ..utils.host import fetch_async
from ..utils.tracing import get_tracer

# fixed fuse-target capacity (first + second covisibility ring, strongest
# first)
FUSE_TARGETS = 32

# fixed neighbor capacity of CreateNewMapPoints
TRI_NEIGHBORS = 20


class LocalMapper:
    def __init__(self, cfg: SlamConfig, state: MapState, kfdb=None, device=None):
        self.cfg = cfg
        self.map = state
        self.kfdb = kfdb  # map/keyframe_db.KeyFrameDatabase or None
        self.probation: list = []  # (point, generation) under culling
        # device-resident mirror of the map arrays: stage kernels gather
        # their operands on the device, only indices ship per call
        self.dmap = DeviceMap(state.max_kf, state.n_feat, state.max_mp, device=device)
        # split-stage state: device results awaiting their host half, and
        # point ids awaiting the per-keyframe attrs pass
        self._tri_pending = None
        self._fuse_pending = None
        self._ba_pending = None
        self._ba_stage1 = None   # stage-1 result awaiting stage 2
        self._ba2_pending = None
        self._attrs_pending: list[int] = []
        self._attrs_inflight = None  # launched attrs awaiting writeback

    def capture_programs(self):
        """Capture the mirror's stage programs ahead of the first keyframe at
        the shapes the stages call them with (the reference jits each at its
        first host spec; its warmup drives them): triangulation against
        TRI_NEIGHBORS keyframes, fusion over 2 FUSE_TARGETS rows, both
        local-BA stages (5 and 10 iterations) at the problem's fixed
        capacities, the attrs pass and the point scatter at their first two
        row buckets (256 and 2048; a larger bucket is captured at its first
        call). Dummy inputs of the real calls' dtypes; on the CPU nothing is
        captured."""
        cfg, dm = self.cfg, self.dmap
        F, B, T = self.map.n_feat, TRI_NEIGHBORS, FUSE_TARGETS
        K, P, O = cfg.local_ba_kf + cfg.local_ba_fixed, cfg.local_ba_points, cfg.local_ba_obs
        zb = lambda *s: np.zeros(s, bool)
        zi = lambda *s: np.zeros(s, np.int32)
        dm.capture("tri", None, 0, zi(B), zb(F), zb(B, F), zb(B, F), cfg.K4, cfg.sigma2,
                   cfg.scale_factors)
        dm.capture("fuse", None, np.full((2 * T, F), -1, np.int32), zb(2 * T, F), zi(2 * T),
                   cfg.K4, cfg.scale_factors)
        for iterations in (5, 10):
            dm.capture("local_ba", iterations, np.tile(np.eye(3), (K, 1, 1)), np.zeros((K, 3)),
                       np.ones(K, bool), np.zeros((P, 3)), zb(P), zi(O), zi(O), zi(O), zi(O),
                       zb(O), cfg.K4, cfg.inv_sigma2)
        for n in (256, 2048):
            dm.capture("attrs", None, np.full((n, self.map.max_obs), -1, np.int32),
                       zi(n, self.map.max_obs), np.zeros((n, 3)), zi(n), cfg.scale_factors)
            dm.capture_scatter(n)

    # ------------------------------------------------------------------

    def insert_keyframe(self, frame: Frame) -> int:
        """ProcessNewKeyFrame (:145-195): create the KF, bind tracked
        points, refresh covisibility and the spanning tree."""
        st = self.map
        kf = st.add_keyframe(
            frame.R, frame.t, frame.xy_un, frame.level, frame.angle, frame.desc,
            frame.valid, frame_id=frame.frame_id, timestamp=frame.timestamp,
        )
        if kf < 0:
            # keyframe capacity exhausted: evict the most isolated
            # unprotected keyframe to make room
            victim = culling.force_free_keyframe(st)
            if victim is None:
                return -1
            if self.kfdb is not None:
                self.kfdb.erase(victim)
            kf = st.add_keyframe(
                frame.R, frame.t, frame.xy_un, frame.level, frame.angle,
                frame.desc, frame.valid, frame_id=frame.frame_id,
                timestamp=frame.timestamp,
            )
            if kf < 0:
                return -1
        tracked = np.nonzero((frame.point >= 0) & ~frame.outlier)[0]
        gen_ok = st.mp_gen[frame.point[tracked]] == frame.point_gen[tracked]
        tracked = tracked[gen_ok]
        from ..native import add_observations_native

        if add_observations_native(st, kf, tracked, frame.point[tracked]) is None:
            for f in tracked:
                mp = int(frame.point[f])
                if st.mp_valid[mp]:
                    st.add_observation(mp, kf, int(f))
        # the descriptor/normal/depth refresh of the tracked points joins
        # the keyframe's single attrs pass at the fuse merge
        self._attrs_pending.extend(int(p) for p in frame.point[tracked])
        covis = st.covisibility()
        st.update_spanning_tree(kf, covis[kf])
        if self.kfdb is not None:
            self.kfdb.add(kf, st.kf_desc[kf], st.kf_feat_valid[kf])
        self.dmap.sync_keyframe(st, kf)
        return kf

    # ------------------------------------------------------------------

    # the per-keyframe mapping pipeline, stage by stage
    STAGES = ("cull_points", "triangulate_d", "triangulate_m",
              "fuse_d", "fuse_m", "ba_d", "ba_m", "ba2_d", "ba2_m",
              "cull_kf")
    DISPATCH_STAGES = ("triangulate_d", "fuse_d", "ba_d", "ba2_d")

    def stage_ready(self, kf: int, stage: str) -> bool:
        """True when running `stage` now would not wait for the device: a
        host half whose queued read has not landed is not ready. The only
        device call is the read's event query. The System skips the mapping
        tick for a frame instead of stalling the tracker."""
        if stage == "triangulate_m":
            p = self._tri_pending
            return p is None or p[0] != kf or p[2].done()
        if stage == "fuse_m":
            p = self._fuse_pending
            return p is None or p[0] != kf or p[4].done()
        if stage == "ba_m":
            p = self._ba_pending
            return p is None or p[0] != kf or p[7].done()
        if stage == "ba2_m":
            p = self._ba2_pending
            return p is None or p[0] != kf or p[6].done()
        return True

    def run_stage(self, kf: int, stage: str):
        # apply the previous stage's deferred attrs writeback first: its
        # device program ran while the host did other work (kept pending
        # rather than waited for when its read has not landed yet)
        self.drain_attrs(force=False)
        with get_tracer().stage(f"map_{stage}"):
            self._run_stage(kf, stage)

    def drain_attrs(self, force: bool = True):
        """Apply a launched attrs computation (one host read + the host
        writeback + the mirror sync). force=False keeps it pending when
        its queued read has not landed yet."""
        pending = self._attrs_inflight
        if pending is not None and not (force or pending[2].done()):
            return
        self._attrs_inflight = None
        if pending is not None:
            with get_tracer().stage("attrs_drain"):
                ids = self.map.apply_point_attributes(pending)
                self.dmap.sync_points(self.map, ids)

    def _run_stage(self, kf: int, stage: str):
        if stage == "cull_points":
            before = [mp for mp, _ in self.probation]
            self.probation = culling.cull_recent_points(
                self.map, self.probation, self.map.next_kf_id - 1
            )
            self.dmap.sync_points(self.map, np.array(before, np.int64))
        elif stage == "triangulate_d":
            self.triangulate_dispatch(kf)
        elif stage == "triangulate_m":
            self.triangulate_merge(kf)
        elif stage == "fuse_d":
            self.fuse_dispatch(kf)
        elif stage == "fuse_m":
            self.fuse_merge(kf)
        elif stage == "ba_d":
            self.ba_dispatch(kf)
        elif stage == "ba_m":
            self.ba_merge(kf)
        elif stage == "ba2_d":
            self.ba2_dispatch(kf)
        elif stage == "ba2_m":
            self.ba2_merge(kf)
        elif stage == "ba_abort":
            self.ba_abort(kf)
        elif stage == "cull_kf":
            self.cull_keyframes(kf)
        else:  # pragma: no cover
            raise ValueError(stage)

    def process(self, frame: Frame) -> int:
        kf = self.insert_keyframe(frame)
        if kf < 0:
            return kf
        for stage in self.STAGES:
            self.run_stage(kf, stage)
        return kf

    def cull_keyframes(self, kf: int) -> list[int]:
        """Redundant-KF culling over the covisible neighbors (:546-600)."""
        covis = self.map.covisibility()
        neighbors = np.nonzero(covis[kf] >= 15)[0]
        erased = culling.cull_redundant_keyframes(self.map, neighbors[neighbors != kf])
        # culled KFs leave the place-recognition index too (KeyFrame.cc:586-587
        # -> KeyFrameDatabase::erase), so they stop competing as candidates
        if self.kfdb is not None:
            for k in erased:
                self.kfdb.erase(k)
        if erased:
            get_tracer().log("kf_culled", kf=int(kf),
                             erased=[int(k) for k in erased])
        return erased

    # ------------------------------------------------------------------
    # triangulation of new points (CreateNewMapPoints :227-393)
    # ------------------------------------------------------------------

    def _scene_median_depth(self, kf: int) -> float:
        pts = self.map.kf_point[kf]
        pts = pts[pts >= 0]
        if len(pts) == 0:
            return 1.0
        xc = self.map.mp_xyz[pts] @ self.map.kf_R[kf].T + self.map.kf_t[kf]
        return float(np.median(xc[:, 2]))

    def create_new_points(self, kf: int):
        """Synchronous triangulation (dispatch + merge back to back)."""
        self.triangulate_dispatch(kf)
        self.triangulate_merge(kf)

    def triangulate_dispatch(self, kf: int, max_neighbors: int = TRI_NEIGHBORS):
        """Device half of CreateNewMapPoints: neighbor selection on the
        host, the epipolar search + DLT + gates as one program."""
        st, cfg = self.map, self.cfg
        self._tri_pending = None
        covis = st.covisibility()
        row = covis[kf].copy()
        row[kf] = 0
        row[~st.kf_valid] = 0
        neighbors = np.argsort(-row)[:max_neighbors]
        neighbors = neighbors[row[neighbors] >= 15]

        R1, t1 = st.kf_R[kf], st.kf_t[kf]
        O1 = -R1.T @ t1

        # baseline / median-depth gate per neighbor (:256-260), host math
        active = []
        for kn in neighbors:
            kn = int(kn)
            O2 = -st.kf_R[kn].T @ st.kf_t[kn]
            baseline = np.linalg.norm(O2 - O1)
            if baseline / max(self._scene_median_depth(kn), 1e-9) >= 0.01:
                active.append(kn)
        if not active:
            return

        # pad the neighbor axis to the fixed capacity; pad rows carry
        # valid2 = False so they cannot produce matches
        B = TRI_NEIGHBORS
        sel = np.array((active + [active[0]] * B)[:B])
        active_mask = np.zeros((B, 1), bool)
        active_mask[: len(active)] = True
        outs = tri_kernel(
            self.dmap, kf, sel,
            st.kf_point[kf] >= 0,
            st.kf_point[sel] >= 0,
            np.broadcast_to(active_mask, (B, st.n_feat)).copy(),
            cfg.K4, cfg.sigma2, cfg.scale_factors,
        )
        # the read is queued now and lands while the host goes on
        self._tri_pending = (kf, active, fetch_async(*outs))

    def triangulate_merge(self, kf: int):
        """Host half: claim features, allocate points, wire observations.
        New-point attributes are computed once per keyframe, at the fuse
        merge."""
        st, cfg = self.map, self.cfg
        if self._tri_pending is None or self._tri_pending[0] != kf:
            return
        _, active, outs = self._tri_pending
        self._tri_pending = None
        if not st.kf_valid[kf]:
            return
        with get_tracer().stage("tri_m_read"):
            cnt, f1c, f2c, xwc = outs.result()

        # sequential claim: a feature triangulated against an earlier (more
        # covisible) neighbor is excluded from later ones
        claimed = st.kf_point[kf] >= 0
        new_ids = []
        from ..native import add_observations_native

        for b, kn in enumerate(active):
            if not st.kf_valid[kn]:
                continue
            n_b = min(int(cnt[b]), f1c.shape[1])
            if n_b == 0:
                continue
            feats1 = f1c[b][:n_b].astype(np.int64)
            idx2 = f2c[b][:n_b].astype(np.int64)
            xws = xwc[b][:n_b]
            keep = ~claimed[feats1]
            feats1, idx2, xws = feats1[keep], idx2[keep], xws[keep]
            if len(feats1) == 0:
                continue
            n_free = int((~st.mp_valid).sum())
            if n_free < len(feats1):
                feats1 = feats1[:n_free]
                idx2 = idx2[:n_free]
                xws = xws[:n_free]
                if len(feats1) == 0:
                    break
            ids = st.add_points(
                xws, st.kf_desc[kf][feats1], ref_kf=kf,
                first_kf_id=st.next_kf_id - 1,
            )
            if add_observations_native(st, kf, feats1, ids) is None:
                for mp_id, fi in zip(ids, feats1):
                    st.add_observation(int(mp_id), kf, int(fi))
            if add_observations_native(st, kn, idx2, ids) is None:
                for mp_id, f2 in zip(ids, idx2):
                    st.add_observation(int(mp_id), kn, int(f2))
            self.probation.extend((int(i), int(st.mp_gen[i])) for i in ids)
            claimed[feats1] = True
            new_ids.append(ids)
        if new_ids:
            all_new = np.concatenate(new_ids)
            # provisional attributes from the creating observation
            # (MapPoint.cc:273-312 with one observation) so the tracker sees
            # the new points at once; the full pass runs at the fuse merge
            O1 = -st.kf_R[kf].T @ st.kf_t[kf]
            d = st.mp_xyz[all_new] - O1
            dist = np.linalg.norm(d, axis=1)
            st.mp_normal[all_new] = d / np.maximum(dist[:, None], 1e-12)
            feats = np.argmax(st.kf_point[kf][None, :] == all_new[:, None], axis=1)
            lv = np.clip(st.kf_level[kf][feats], 0, cfg.n_levels - 1)
            dmax = dist * cfg.scale_factors[lv]
            st.mp_max_dist[all_new] = dmax
            st.mp_min_dist[all_new] = dmax / cfg.scale_factors[-1]
            self._attrs_pending.extend(int(i) for i in all_new)
            self.dmap.sync_points(st, all_new)
        get_tracer().log("triangulated", kf=int(kf),
                         n_new=int(sum(len(i) for i in new_ids)),
                         n_neighbors=len(active))

    # ------------------------------------------------------------------
    # duplicate fusion (SearchInNeighbors :395-472)
    # ------------------------------------------------------------------

    def fuse_neighbors(self, kf: int, n_neighbors: int = 20):
        """Synchronous fusion (dispatch + merge back to back)."""
        self.fuse_dispatch(kf, n_neighbors)
        self.fuse_merge(kf)

    def fuse_dispatch(self, kf: int, n_neighbors: int = 20):
        """Device half of SearchInNeighbors: BOTH projection directions (the
        current KF's points into the ring, the ring's points into the
        current KF) as ONE (2T,)-row program against the pre-fuse map."""
        st, cfg = self.map, self.cfg
        self._fuse_pending = None
        covis = st.covisibility()
        row = covis[kf].copy()
        row[kf] = 0
        row[~st.kf_valid] = 0
        first_ring = np.argsort(-row)[:n_neighbors]
        first_ring = [int(k) for k in first_ring if row[k] >= 15]
        targets = list(first_ring)
        seen = set(first_ring)
        for k1 in first_ring:  # second ring (:408-419)
            row2 = covis[k1].copy()
            row2[~st.kf_valid] = 0
            row2[k1] = 0
            for k2 in np.argsort(-row2)[:5]:
                k2 = int(k2)
                if row2[k2] >= 15 and k2 != kf and k2 not in seen:
                    targets.append(k2)
                    seen.add(k2)
        targets = targets[:FUSE_TARGETS]
        if not targets:
            return
        T = FUSE_TARGETS
        sel = np.array((targets + [targets[0]] * T)[:T])
        n_act = len(targets)

        row_act = np.zeros((2 * T, 1), bool)
        row_act[:n_act] = True
        row_act[T:T + n_act] = True
        row_valid = np.broadcast_to(row_act, (2 * T, st.n_feat)).copy()
        kf_row = np.full(T, kf, np.int64)
        # rows 0..T-1: the current KF's points into each target;
        # rows T..2T-1: each target's points into the current KF
        q = np.concatenate([
            np.broadcast_to(st.kf_point[kf], (T, st.n_feat)),
            st.kf_point[sel],
        ]).astype(np.int32)
        dst = np.concatenate([sel.astype(np.int64), kf_row])
        outs = fuse_kernel(self.dmap, q, row_valid, dst, cfg.K4, cfg.scale_factors)
        self._fuse_pending = (kf, sel, n_act, q, fetch_async(*outs))

    def fuse_merge(self, kf: int):
        """Host half: merge bookkeeping + the keyframe's ONE attrs pass over
        tracked + new + fused points (the reference refreshes them at each
        of those moments, MapPoint.cc:185-312, with the same end state)."""
        st = self.map
        if self._fuse_pending is None or self._fuse_pending[0] != kf:
            self._flush_attrs(kf)
            return
        tracer = get_tracer()
        _, sel, n_act, q, outs = self._fuse_pending
        self._fuse_pending = None
        with tracer.stage("fuse_m_read"):
            cnt, srcs, dsts = outs.result()
        T = FUSE_TARGETS
        C = srcs.shape[1]
        touched: list[int] = []

        def row(i):
            n = min(int(cnt[i]), C)
            return srcs[i][:n].astype(np.int64), dsts[i][:n].astype(np.int64)

        if st.kf_valid[kf]:
            for i in range(n_act):
                if st.kf_valid[sel[i]]:
                    touched.extend(self._merge_fuse(q[i], int(sel[i]), *row(i)))
            for i in range(n_act):
                touched.extend(self._merge_fuse(q[T + i], kf, *row(T + i)))
        with tracer.stage("fuse_m_attrs"):
            self._flush_attrs(kf, touched)

    def _flush_attrs(self, kf: int, touched=()):
        """The per-keyframe attrs pass: one device program over the union
        of the KF's live points, the points created this round, and
        fuse-touched points. It is applied at the next stage."""
        # a still-pending previous attrs pass must land first: its slot is
        # about to be overwritten
        self.drain_attrs(force=True)
        st, cfg = self.map, self.cfg
        pts = st.kf_point[kf] if st.kf_valid[kf] else np.zeros(0, np.int64)
        live = np.unique(pts[pts >= 0]) if len(pts) else pts
        ids = np.unique(np.concatenate([
            np.asarray(live, np.int64),
            np.array(self._attrs_pending, np.int64),
            np.array(list(touched), np.int64),
        ]))
        self._attrs_pending = []
        ids = ids[(ids >= 0) & st.mp_valid[np.clip(ids, 0, st.max_mp - 1)]]
        if len(ids) == 0:
            return
        self._attrs_inflight = st.update_point_attributes_async(
            ids, cfg.scale_factors, dmap=self.dmap)

    def _merge_fuse(self, q_ids, dst_kf: int, f_srcs, f_dsts) -> list[int]:
        """Merge bookkeeping after a fuse search (ORBmatcher.cc:1083-1091).
        The batched searches all saw the pre-fuse map snapshot, so stale
        rows (point already replaced by an earlier merge) are re-checked.
        Takes the compacted (source feature, target feature) match lists.
        Returns the touched map-point ids (for the device-mirror sync)."""
        st = self.map
        touched = []
        for f_src, f_dst_c in zip(f_srcs, f_dsts):
            mp = int(q_ids[f_src])
            if mp < 0 or not st.mp_valid[mp]:
                continue
            f_dst = int(f_dst_c)
            existing = int(st.kf_point[dst_kf, f_dst])
            if existing == mp:
                continue
            if existing >= 0 and st.mp_valid[existing]:
                # merge: keep the point with more observations (:1083-1091)
                if st.n_observations(existing) >= st.n_observations(mp):
                    st.replace_point(mp, existing)
                else:
                    st.replace_point(existing, mp)
                touched.extend((mp, existing))
            else:
                st.add_observation(mp, dst_kf, f_dst)
                touched.append(mp)
        return touched

    # ------------------------------------------------------------------
    # local bundle adjustment (Optimizer::LocalBundleAdjustment :287-536)
    # ------------------------------------------------------------------

    def build_local_ba_problem(self, kf: int):
        st, cfg = self.map, self.cfg
        covis = st.covisibility()
        row = covis[kf].copy()
        row[kf] = 0
        row[~st.kf_valid] = 0
        local = [kf] + [int(k) for k in np.argsort(-row) if row[k] > 0][: cfg.local_ba_kf - 1]
        local_set = set(local)
        # local points = points seen by local KFs
        pts = np.unique(st.kf_point[np.array(local)])
        pts = pts[pts >= 0]
        pts = pts[st.mp_valid[pts]]
        if len(pts) > cfg.local_ba_points:
            # keep the best-anchored points (most observations), not slot order
            nobs = (st.mp_obs_kf[pts] >= 0).sum(axis=1)
            pts = pts[np.argpartition(-nobs, cfg.local_ba_points - 1)[: cfg.local_ba_points]]
            pts.sort()
        # fixed KFs: other observers of local points (Optimizer.cc:328-345
        # includes ALL of them; at our fixed capacity keep the KFs anchoring
        # the MOST local observations, not the first ones encountered)
        obs_flat = st.mp_obs_kf[pts].ravel()
        obs_flat = obs_flat[obs_flat >= 0]
        counts = np.bincount(obs_flat, minlength=st.max_kf)
        for k in local:
            counts[k] = 0
        cand = np.nonzero(counts)[0]
        if len(cand) > cfg.local_ba_fixed:
            cand = cand[np.argpartition(-counts[cand], cfg.local_ba_fixed - 1)[
                : cfg.local_ba_fixed]]
        fixed = set(int(k) for k in cand)
        all_kfs = local + sorted(fixed)
        kf_index = {k: i for i, k in enumerate(all_kfs)}
        K = cfg.local_ba_kf + cfg.local_ba_fixed
        # fixed capacities, as the reference: the padded problem has the
        # same arithmetic (zero rows) whatever the map size
        P = cfg.local_ba_points

        kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        kf_t = np.zeros((K, 3), np.float32)
        kf_fixed = np.ones(K, bool)
        for i, k in enumerate(all_kfs):
            kf_R[i] = st.kf_R[k]
            kf_t[i] = st.kf_t[k]
            kf_fixed[i] = (k in fixed) or (k == 0)  # KF0 is the gauge

        points = np.zeros((P, 3), np.float32)
        point_valid = np.zeros(P, bool)
        points[: len(pts)] = st.mp_xyz[pts]
        point_valid[: len(pts)] = True
        pt_index = {p: i for i, p in enumerate(pts.tolist())}

        O = cfg.local_ba_obs
        obs_kf = np.zeros(O, np.int32)
        obs_pt = np.zeros(O, np.int32)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_w = np.ones(O, np.float32)
        obs_valid = np.zeros(O, bool)
        obs_feat = np.zeros(O, np.int32)
        obs_srckf = np.zeros(O, np.int32)
        kf_index_dense = np.full(st.max_kf, -1, np.int32)
        for k, i in kf_index.items():
            kf_index_dense[k] = i
        from ..native import build_ba_obs_native

        native = build_ba_obs_native(st, pts, kf_index_dense, O)
        if native is not None:
            okf, opt, ofe, osp, osk = native
            n = len(okf)
            obs_kf[:n] = okf
            obs_pt[:n] = opt
            obs_feat[:n] = ofe
            obs_srckf[:n] = osk
            obs_uv[:n] = st.kf_xy[osk, ofe]
            lv = np.clip(st.kf_level[osk, ofe], 0, cfg.n_levels - 1)
            obs_w[:n] = cfg.inv_sigma2[lv]
            obs_valid[:n] = True
            obs_src = list(zip(osp.tolist(), osk.tolist(), ofe.tolist()))
        else:
            obs_src = []  # (mp, kf, feat) for writeback/erasure
            n = 0
            for p in pts:
                pi = pt_index[int(p)]
                for s in np.nonzero(st.mp_obs_kf[p] >= 0)[0]:
                    k = int(st.mp_obs_kf[p, s])
                    if k not in kf_index or n >= O:
                        continue
                    f = int(st.mp_obs_feat[p, s])
                    obs_kf[n] = kf_index[k]
                    obs_pt[n] = pi
                    obs_feat[n] = f
                    obs_srckf[n] = k
                    obs_uv[n] = st.kf_xy[k, f]
                    obs_w[n] = cfg.inv_sigma2[min(int(st.kf_level[k, f]), cfg.n_levels - 1)]
                    obs_valid[n] = True
                    obs_src.append((int(p), k, f))
                    n += 1

        prob = ba.BAProblem(
            kf_R=kf_R, kf_t=kf_t, kf_fixed=kf_fixed,
            points=points, point_valid=point_valid,
            obs_kf=obs_kf, obs_pt=obs_pt,
            obs_uv=obs_uv, obs_w=obs_w,
            obs_valid=obs_valid, K4=cfg.K4,
        )
        # (obs_feat, obs_srckf) index the mirror: the kernel gathers the
        # observation pixels and weights on the device
        return prob, all_kfs, pts, obs_src, (obs_feat, obs_srckf)

    def local_ba(self, kf: int):
        """Synchronous local BA (both stages back to back)."""
        self.ba_dispatch(kf)
        self.ba_merge(kf)
        self.ba2_dispatch(kf)
        self.ba2_merge(kf)

    def ba_dispatch(self, kf: int):
        """Launch LM stage 1 (5 iterations, Optimizer.cc:450)."""
        st = self.map
        self._ba_pending = None
        self._ba_stage1 = None
        self._ba2_pending = None
        prob, all_kfs, pts, obs_src, obs_idx = self.build_local_ba_problem(kf)
        if len(obs_src) < 20:
            return
        obs_feat, obs_srckf = obs_idx
        res = local_ba_kernel(
            self.dmap, prob.kf_R, prob.kf_t, prob.kf_fixed, prob.points,
            prob.point_valid, prob.obs_kf, prob.obs_pt, obs_feat,
            obs_srckf, prob.obs_valid, prob.K4,
            self.cfg.inv_sigma2, iterations=5)
        # snapshot generations: points may be culled by other stages
        # before the writeback; never write into a recycled slot
        self._ba_pending = (kf, prob, all_kfs, pts, st.mp_gen[pts].copy(),
                            obs_src, obs_idx, fetch_async(*res))

    def ba_merge(self, kf: int):
        """Read stage 1's result and hold it: NO map writeback yet (the
        reference writes back only after the abortable second stage)."""
        if self._ba_pending is None or self._ba_pending[0] != kf:
            return
        _, prob, all_kfs, pts, gens, obs_src, obs_idx, res = self._ba_pending
        self._ba_pending = None
        with get_tracer().stage("ba_m_read"):
            res = ba.BAResult(*res.result())
        self._ba_stage1 = (kf, prob, all_kfs, pts, gens, obs_src, obs_idx, res)

    def ba2_dispatch(self, kf: int):
        """Launch LM stage 2 (10 iterations on the outlier-pruned set,
        Optimizer.cc:480-494)."""
        if self._ba_stage1 is None or self._ba_stage1[0] != kf:
            return
        _, prob, all_kfs, pts, gens, obs_src, (obs_feat, obs_srckf), res1 = self._ba_stage1
        obs_valid2 = np.asarray(prob.obs_valid) & ~res1.obs_outlier
        res = local_ba_kernel(
            self.dmap, res1.kf_R, res1.kf_t, prob.kf_fixed, res1.points,
            prob.point_valid, prob.obs_kf, prob.obs_pt, obs_feat,
            obs_srckf, obs_valid2, prob.K4,
            self.cfg.inv_sigma2, iterations=10)
        self._ba2_pending = (kf, prob, all_kfs, pts, gens, obs_src, fetch_async(*res), res1)

    def ba2_merge(self, kf: int):
        """Writeback + outlier erasure after stage 2 (Optimizer.cc:496-534;
        erased set = union of both passes :453-470 + :480-494)."""
        if self._ba2_pending is None or self._ba2_pending[0] != kf:
            return
        _, prob, all_kfs, pts, gens, obs_src, res, res1 = self._ba2_pending
        self._ba2_pending = None
        self._ba_stage1 = None
        with get_tracer().stage("ba_m_read"):
            res = ba.BAResult(*res.result())
        outlier = res1.obs_outlier | res.obs_outlier
        self._ba_writeback(prob, all_kfs, pts, gens, obs_src,
                           res.kf_R, res.kf_t, res.points, outlier)

    def ba_abort(self, kf: int):
        """A new keyframe interrupted the BA between stages: write back the
        5-iteration state WITHOUT erasing outlier observations
        (Optimizer.cc:450-452 + :496-534 with bDoMore=false)."""
        if self._ba_stage1 is None or self._ba_stage1[0] != kf:
            return
        _, prob, all_kfs, pts, gens, obs_src, _, res1 = self._ba_stage1
        self._ba_stage1 = None
        self._ba_writeback(prob, all_kfs, pts, gens, obs_src,
                           res1.kf_R, res1.kf_t, res1.points, None)

    def _ba_writeback(self, prob, all_kfs, pts, gens, obs_src,
                      kf_R, kf_t, points, outlier):
        st = self.map
        tracer = get_tracer()
        for i, k in enumerate(all_kfs):
            if not bool(prob.kf_fixed[i]) and st.kf_valid[k]:
                st.kf_R[k] = kf_R[i]
                st.kf_t[k] = kf_t[i]
        fresh = st.mp_gen[pts] == gens
        st.mp_xyz[pts[fresh]] = points[: len(pts)][fresh]
        if outlier is not None:
            # erase outlier observations (:453-470 + :496-520)
            with tracer.stage("ba_m_erase"):
                gen_of = {int(p): int(g) for p, g in zip(pts, gens)}
                for o in np.nonzero(outlier[: len(obs_src)])[0]:
                    p, k, f = obs_src[o]
                    if st.mp_gen[p] == gen_of.get(p, -1):
                        st.remove_observation(p, k)
        with tracer.stage("ba_m_sync"):
            self.dmap.sync_poses(st)
            self.dmap.sync_points(st, pts[fresh])
