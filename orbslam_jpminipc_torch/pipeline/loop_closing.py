"""Loop closing: detection, Sim3 computation, and loop correction
(counterpart of orbslam_jpminipc_tpu/pipeline/loop_closing.py).

src/LoopClosing.cc: DetectLoop (:115-242: min-score gate, database query,
>=3-consecutive consistent-group temporal filter), ComputeSim3 (:244-414:
per-candidate matching, Sim3 RANSAC, guided search, Sim3 refinement, >=20
inliers then >=40 total matches), and CorrectLoop (:416-574: propagate the
corrected Sim3 to the covisible group, re-map their points, fuse
duplicates, build loop connections, optimize the essential graph).

The reference's stop-the-mapper handshake (RequestStop :420-427)
disappears: stages run deterministically in sequence. The graph
bookkeeping is host numpy; the device programs are `mutual_match`,
`search_by_projection`, `fuse_search`, `solve_sim3`, `optimize_sim3` and
`optimize_essential_graph` (with more than one device to shard over and
`cfg.distributed_gba`, the edge-sharded `sharded_optimize_essential_graph`
of parallel/, as the reference on a multi-device mesh). All but the
sharded essential graph run as captured programs (utils/program.py
`ProgramSet`, one CUDA graph per shape and variant, on one memory pool;
`capture_programs` takes them ahead of time at the reference's shapes):
host arrays are copied in, results copied out, and each call's results
come back in one batched read. The Sim3 RANSAC (`sim3_ransac`) selects its
minimal sets inside the program from uniform scores drawn before it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig
from ..frontend.frame import predict_scale_level
from ..map.device_map import DeviceMap
from ..map.map_state import MapState
from ..ops import matching
from ..parallel import mesh as pmesh
from ..parallel.sharded_pose_graph import (
    shard_essential_graph, sharded_optimize_essential_graph,
)
from ..solvers import essential_graph, initializer, sim3_opt, sim3solver
from ..utils.device import resolve_device
from ..utils.host import fetch, host_tensor
from ..utils.program import GraphPool, ProgramSet
from ..utils.tracing import get_tracer

# fixed capacity of the loop-side point set (mvpLoopMapPoints)
LOOP_POINTS_CAP = 4096


class LoopCloser:
    def __init__(self, cfg: SlamConfig, state: MapState, kfdb, device=None):
        self.cfg = cfg
        self.map = state
        self.kfdb = kfdb
        self.device = resolve_device(device)
        # ConsistentGroup bookkeeping (LoopClosing.h:47, .cc:165-224)
        self.consistent_groups: list[tuple[set, int]] = []
        self.last_loop_kf_id = -(10 ** 9)
        self.covisibility_consistency_th = 3
        # Sim3 RANSAC minimal sets: uniform scores drawn from a generator
        # seeded from cfg.seed, selected inside the program. A test may set
        # `sim3_sampler` to sim3_sampler(mask, n_hyp) -> (n_hyp, 3) pair
        # indices to replay another implementation's sets.
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.sim3_sampler = None
        self.on_loop_closed = None  # fn(kf) hook
        # device mirror of the map (wired by the System; a closer used on
        # its own makes one at first need)
        self.dmap: DeviceMap | None = None
        # the device functions as captured programs, on one pool; the
        # static arguments are the variants
        dev, pool = self.device, GraphPool()
        self.programs = {
            "mutual": ProgramSet(lambda v, *a: matching.mutual_match(
                *a, max_dist=50, nn_ratio=0.75, check_rotation=True), dev, "lc_mutual",
                pool=pool),
            # variant (radius, max_dist)
            "proj": ProgramSet(lambda v, *a: matching.search_by_projection(
                *a, radius=v[0], max_dist=v[1], nn_ratio=1.0, level_window=(-1, 1)), dev,
                "lc_proj", pool=pool),
            # variant: the radius
            "fuse": ProgramSet(lambda v, *a: matching.fuse_search(*a, radius=v), dev,
                               "lc_fuse", pool=pool),
            "sim3_opt": ProgramSet(lambda v, *a: sim3_opt.optimize_sim3(*a), dev,
                                   "lc_sim3_opt", pool=pool),
            # the draw's scores, then solve_sim3's inputs
            "sim3_ransac": ProgramSet(
                lambda v, scores, p1, p2, uv1, uv2, mask, *a: sim3solver.solve_sim3(
                    initializer.select_minimal_sets(scores, mask, 3),
                    p1, p2, uv1, uv2, mask, *a),
                dev, "lc_sim3_ransac", pool=pool),
            # variant: the iterations
            "essential_graph": ProgramSet(
                lambda v, prob: essential_graph.optimize_essential_graph(prob, iterations=v),
                dev, "essential_graph", pool=pool),
        }

    def _sim3_scores(self, mask: torch.Tensor) -> torch.Tensor:
        """The scores the RANSAC program selects its sets from: a draw from
        the closer's generator, or the sets a replaying `sim3_sampler`
        gives (`initializer.scores_for_sets`)."""
        n = mask.shape[0]
        if self.sim3_sampler is None:
            return torch.rand((sim3solver.N_HYP, n), generator=self.generator, device=self.device)
        sets = self.sim3_sampler(mask, sim3solver.N_HYP)
        return initializer.scores_for_sets(sets.to(self.device), n)

    def _mirror(self) -> DeviceMap:
        if self.dmap is None:
            st = self.map
            self.dmap = DeviceMap(st.max_kf, st.n_feat, st.max_mp, device=self.device)
        return self.dmap

    def _sharded_eg(self) -> bool:
        """The essential graph takes parallel/'s edge-sharded solver."""
        return len(pmesh.mesh_devices(self.device)) > 1 and self.cfg.distributed_gba

    @torch.no_grad()
    def capture_programs(self):
        """Capture every program ahead of the first closure at the shapes
        the reference compiles (its `Slam._compile_programs`), with dummy
        inputs of the real calls' dtypes: the mutual match at n2 x n2 (n2 =
        the keyframe rows), the Sim3 RANSAC and refinement at n2 pairs, the projection
        searches at n2 (search by Sim3, 7.5 px) and `LOOP_POINTS_CAP` rows
        (guided matches, 10 px), the fuse search at `LOOP_POINTS_CAP` rows,
        and the essential graph at (max_kf, eg_edges), 20 iterations,
        unless it takes the sharded solver. On the CPU nothing is captured."""
        cfg, dev, P = self.cfg, self.device, self.programs
        n2, Q, K, E = self.map.n_feat, LOOP_POINTS_CAP, self.map.max_kf, cfg.eg_edges
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)
        u8, i32, b = torch.uint8, torch.int32, torch.bool
        K4, sf = z(4), z(cfg.n_levels)
        kf = (z(n2, 32, dt=u8), z(n2, 2), z(n2, dt=i32), z(n2, dt=b))  # desc xy level valid
        P["mutual"].capture(None, kf[0], z(n2), kf[3], kf[0], z(n2), kf[3])
        P["sim3_opt"].capture(None, z(), torch.eye(3, device=dev), z(3), z(n2, 3), z(n2, 3),
                              z(n2, 2), z(n2, 2), z(n2), z(n2), z(n2, dt=b), K4)
        P["sim3_ransac"].capture(None, z(sim3solver.N_HYP, n2), z(n2, 3), z(n2, 3), z(n2, 2),
                                 z(n2, 2), z(n2, dt=b), K4, z(n2), z(n2))
        for rows, variant in ((n2, (7.5, 100)), (Q, (10.0, 100))):
            P["proj"].capture(variant, z(rows, 32, dt=u8), z(rows, 2), z(rows, dt=i32),
                              z(rows, dt=b), *kf, sf)
        P["fuse"].capture(4.0, z(Q, 32, dt=u8), z(Q, 2), z(Q, dt=i32), z(Q, dt=b), *kf, sf)
        if not self._sharded_eg():
            eye = lambda n: torch.eye(3, device=dev).repeat(n, 1, 1)
            P["essential_graph"].capture(20, essential_graph.EssentialGraphProblem(
                s=z(K) + 1, R=eye(K), t=z(K, 3), fixed=z(K, dt=b) | True,
                e_i=z(E, dt=torch.int64), e_j=z(E, dt=torch.int64), e_s=z(E) + 1, e_R=eye(E),
                e_t=z(E, 3), e_valid=z(E, dt=b)))

    # ------------------------------------------------------------------

    def process(self, kf: int) -> bool:
        cands = self.detect_loop(kf)
        if not cands:
            return False
        ok, loop_kf, s_cl, R_cl, t_cl, loop_points, loop_point_ids = \
            self.compute_sim3(kf, cands)
        if not ok:
            return False
        self.correct_loop(kf, loop_kf, s_cl, R_cl, t_cl, loop_points, loop_point_ids)
        if self.on_loop_closed is not None:
            self.on_loop_closed(kf)
        return True

    # ------------------------------------------------------------------
    # DetectLoop (:115-242)
    # ------------------------------------------------------------------

    def detect_loop(self, kf: int) -> list[int]:
        with get_tracer().stage("loop_detect"):
            return self._detect_loop(kf)

    def _detect_loop(self, kf: int) -> list[int]:
        st = self.map
        # don't search right after the last loop (:123-128: 10 KFs)
        if st.next_kf_id < self.last_loop_kf_id + 10:
            return []
        covis = st.covisibility()
        self.kfdb.set_covisibility(covis)
        qbow = self.kfdb.bow_of(kf)
        candidates = self.kfdb.detect_loop_candidates(kf, qbow, covis[kf])
        get_tracer().log(
            "loop_detect", kf=int(kf), cands=[int(c) for c in candidates],
            n_groups=len(self.consistent_groups),
        )
        if not candidates:
            self.consistent_groups = []
            return []

        # temporal consistency (:165-224): a candidate group must share
        # members with a group seen in N consecutive keyframes
        covis_th = 15
        enough = []
        current_groups: list[tuple[set, int]] = []
        for c in candidates:
            group = {c} | {
                int(k) for k in np.nonzero(covis[c] >= covis_th)[0] if st.kf_valid[k]
            }
            best_consistency = 0
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    best_consistency = max(best_consistency, count + 1)
            current_groups.append((group, best_consistency))
            if best_consistency >= self.covisibility_consistency_th:
                enough.append(c)
        self.consistent_groups = current_groups
        get_tracer().log(
            "loop_consistency", kf=int(kf),
            enough=[int(c) for c in enough],
            counts=[int(c) for _, c in current_groups],
        )
        return enough

    # ------------------------------------------------------------------
    # ComputeSim3 (:244-414)
    # ------------------------------------------------------------------

    def compute_sim3(self, kf: int, candidates: list[int]):
        st, cfg = self.map, self.cfg
        tracer = get_tracer()
        put, h, P = self._mirror().put, host_tensor, self.programs
        K4 = put(cfg.K4)
        for cand in candidates:
            has_q = st.kf_feat_valid[kf] & (st.kf_point[kf] >= 0)
            has_c = st.kf_feat_valid[cand] & (st.kf_point[cand] >= 0)
            with tracer.stage("sim3_mutual"):
                m = P["mutual"].run(
                    None, h(st.kf_desc[kf]), h(st.kf_angle[kf]), h(has_q),
                    h(st.kf_desc[cand]), h(st.kf_angle[cand]), h(has_c))
                mask, idx = fetch(m.mask, m.idx)  # one read
            tracer.log("sim3_mutual", kf=int(kf), cand=int(cand), n_match=int(mask.sum()),
                       n_q=int(has_q.sum()), n_c=int(has_c.sum()))
            if mask.sum() < 20:
                continue
            p_c = st.kf_point[kf]
            p_l = st.kf_point[cand][idx]
            pair_ok = mask & (p_c >= 0) & (p_l >= 0)
            pair_ok &= st.mp_valid[np.clip(p_c, 0, st.max_mp - 1)]
            pair_ok &= st.mp_valid[np.clip(p_l, 0, st.max_mp - 1)]
            if pair_ok.sum() < 20:
                continue
            # camera-frame coordinates (Sim3Solver.cc:94-98)
            x_c = st.mp_xyz[np.clip(p_c, 0, st.max_mp - 1)] @ st.kf_R[kf].T + st.kf_t[kf]
            x_l = st.mp_xyz[np.clip(p_l, 0, st.max_mp - 1)] @ st.kf_R[cand].T + st.kf_t[cand]
            lev_c = np.clip(st.kf_level[kf], 0, cfg.n_levels - 1)
            lev_l = np.clip(st.kf_level[cand][idx], 0, cfg.n_levels - 1)
            x_c_d, uv_c_d = put(x_c.astype(np.float32)), put(st.kf_xy[kf])
            with tracer.stage("sim3_ransac"):
                pair_ok_d = put(pair_ok)
                res = P["sim3_ransac"].run(
                    None, self._sim3_scores(pair_ok_d),
                    x_c_d, put(x_l.astype(np.float32)), uv_c_d, put(st.kf_xy[cand][idx]),
                    pair_ok_d, K4,
                    put((9.21 * cfg.sigma2[lev_c]).astype(np.float32)),
                    put((9.21 * cfg.sigma2[lev_l]).astype(np.float32)),
                )
                success, s12, R12, t12, inliers, n_in = fetch(*res)  # one read
            tracer.log("sim3_ransac", kf=int(kf), cand=int(cand), success=bool(success),
                       n_inliers=int(n_in), s=float(s12), R=R12.tolist(), t=t12.tolist())
            if not bool(success):
                continue
            # SearchBySim3 enrichment (ORBmatcher.cc:1267-1440, called at
            # LoopClosing.cc:336 with th=7.5): project each side's points
            # through the RANSAC Sim3 into the other keyframe and keep the
            # two-way agreements; OptimizeSim3 then runs on the enlarged
            # match set, not just the original mutual-descriptor inliers
            with tracer.stage("sim3_search"):
                idx, pair_ok = self._search_by_sim3(
                    kf, cand, float(s12), R12, t12, idx, pair_ok & inliers)
            p_l = st.kf_point[cand][idx]
            x_l = st.mp_xyz[np.clip(p_l, 0, st.max_mp - 1)] @ st.kf_R[cand].T + st.kf_t[cand]
            lev_l = np.clip(st.kf_level[cand][idx], 0, cfg.n_levels - 1)
            # refine (OptimizeSim3, >=20 inliers gate :340-352)
            with tracer.stage("sim3_opt"):
                opt = P["sim3_opt"].run(
                    None, h(s12), h(R12), h(t12),
                    x_c_d, h(x_l), uv_c_d, h(st.kf_xy[cand][idx]),
                    h(cfg.inv_sigma2[lev_c]), h(cfg.inv_sigma2[lev_l]), h(pair_ok), K4)
                s_o, R_o, t_o, _, n_opt = fetch(*opt)
            tracer.log("sim3_opt", kf=int(kf), cand=int(cand), n_pairs=int(pair_ok.sum()),
                       n_inliers=int(n_opt), s=float(s_o), R=R_o.tolist(), t=t_o.tolist())
            if int(n_opt) < 20:
                continue
            # guided projection of the loop neighborhood's points (:355-399)
            with tracer.stage("sim3_guided"):
                total, loop_points, loop_point_ids = self._guided_matches(
                    kf, cand, float(s_o), R_o, t_o)
            tracer.log("sim3_guided", kf=int(kf), cand=int(cand), total=int(total))
            if total >= 40:
                return True, cand, float(s_o), R_o, t_o, loop_points, loop_point_ids
        return (False, -1, 1.0, np.eye(3, dtype=np.float32),
                np.zeros(3, np.float32), None, None)

    def _project(self, x):
        """Pixels and depths of camera-frame points (host)."""
        cfg = self.cfg
        z = x[:, 2]
        uv = np.stack(
            [cfg.fx * x[:, 0] / np.maximum(z, 1e-9) + cfg.cx,
             cfg.fy * x[:, 1] / np.maximum(z, 1e-9) + cfg.cy], 1).astype(np.float32)
        return uv, z

    def _search_by_sim3(self, kf1: int, kf2: int, s12, R12, t12,
                        idx12: np.ndarray, matched1: np.ndarray, th: float = 7.5):
        """Bidirectional Sim3-guided projection search
        (ORBmatcher::SearchBySim3, src/ORBmatcher.cc:1267-1440).

        idx12/matched1: current per-feature-of-kf1 match table into kf2.
        Returns the enriched (idx12, pair_ok): two-way agreements between
        unmatched point-bearing features are added to the match set."""
        st, cfg = self.map, self.cfg
        h = host_tensor
        sf = h(cfg.scale_factors)

        def project_dir(src, dst, sR, t, q_skip):
            """Launch: src's map points projected into dst through (sR, t)
            and matched against dst's point-bearing features."""
            p = st.kf_point[src]
            mpid = np.clip(p, 0, st.max_mp - 1)
            valid_q = (p >= 0) & st.mp_valid[mpid] & ~q_skip
            x_src = st.mp_xyz[mpid] @ st.kf_R[src].T + st.kf_t[src]
            x_dst = x_src @ sR.T + t
            uv, z = self._project(x_dst)
            valid_q &= z > 0
            dist = np.linalg.norm(x_dst, axis=1)
            pred = predict_scale_level(
                dist, st.mp_max_dist[mpid], cfg.scale_factor, cfg.n_levels)
            dst_p = st.kf_point[dst]
            dst_valid = st.kf_feat_valid[dst] & (dst_p >= 0) & st.mp_valid[
                np.clip(dst_p, 0, st.max_mp - 1)]
            m = self.programs["proj"].run(
                (th, 100), h(st.mp_desc[mpid]), h(uv), h(pred), h(valid_q),
                h(st.kf_desc[dst]), h(st.kf_xy[dst]), h(st.kf_level[dst]), h(dst_valid), sf)
            return m.idx, m.mask

        # skip features already matched (vbAlreadyMatched, :1301-1312)
        skip2 = np.zeros(st.n_feat, bool)
        skip2[idx12[matched1]] = True
        sR21 = (1.0 / s12) * R12.T
        t21 = -sR21 @ t12
        sR12 = s12 * R12
        # both directions launched, then one read
        i12, ok12, i21, ok21 = fetch(*project_dir(kf1, kf2, sR21, t21, matched1),
                                     *project_dir(kf2, kf1, sR12, t12, skip2))
        # two-way agreement (:1417-1437)
        agree = ok12.copy()
        back = np.where(ok12, i21[np.clip(i12, 0, st.n_feat - 1)], -1)
        back_ok = np.where(ok12, ok21[np.clip(i12, 0, st.n_feat - 1)], False)
        agree &= back_ok & (back == np.arange(st.n_feat))
        idx_new = np.where(agree & ~matched1, i12, idx12)
        return idx_new, matched1 | (agree & ~matched1)

    def _padded_points(self, pts: np.ndarray):
        """`pts` cut and padded to the fixed capacity: (ids, valid)."""
        pts = pts[:LOOP_POINTS_CAP]
        pad = LOOP_POINTS_CAP - len(pts)
        return (np.concatenate([pts, np.zeros(pad, np.int64)]),
                np.concatenate([np.ones(len(pts), bool), np.zeros(pad, bool)]))

    def _guided_matches(self, kf: int, loop_kf: int, s_cl, R_cl, t_cl):
        """Project the loop KF neighborhood's map points into the current
        keyframe through the corrected Scw (SearchBySim3 equivalent)."""
        st, cfg = self.map, self.cfg
        h = host_tensor
        covis = st.covisibility()
        group = {loop_kf} | {
            int(k) for k in np.nonzero(covis[loop_kf] >= 15)[0] if st.kf_valid[k]
        }
        pts = np.unique(st.kf_point[np.array(sorted(group))])
        pts = pts[pts >= 0]
        pts = pts[st.mp_valid[pts]]
        if len(pts) == 0:
            return 0, None, None
        pts = pts[:LOOP_POINTS_CAP]
        pts_pad, pvalid = self._padded_points(pts)

        # corrected camera coords: x_c = S_cl (R_lw x + t_lw)
        x_l = st.mp_xyz[pts_pad] @ st.kf_R[loop_kf].T + st.kf_t[loop_kf]
        x_c = s_cl * (x_l @ R_cl.T) + t_cl
        uv, z = self._project(x_c)
        pvalid &= z > 0
        dist = np.linalg.norm(x_c, axis=1)
        pred = predict_scale_level(dist, st.mp_max_dist[pts_pad], cfg.scale_factor, cfg.n_levels)
        m = self.programs["proj"].run(
            (10.0, 100),  # th=10 at this step (LoopClosing.cc:389)
            h(st.mp_desc[pts_pad]), h(uv), h(pred), h(pvalid),
            h(st.kf_desc[kf]), h(st.kf_xy[kf]), h(st.kf_level[kf]),
            h(st.kf_feat_valid[kf]), h(cfg.scale_factors))
        mask, idx = fetch(m.mask, m.idx)
        loop_points = (pts_pad[mask], idx[mask])  # (map point, feature in kf)
        # the full loop-side point set (mvpLoopMapPoints, LoopClosing.cc:371)
        # feeds SearchAndFuse over the whole corrected group later
        return int(mask.sum()), loop_points, pts

    # ------------------------------------------------------------------
    # CorrectLoop (:416-574)
    # ------------------------------------------------------------------

    def correct_loop(self, kf: int, loop_kf: int, s_cl, R_cl, t_cl,
                     loop_points, loop_point_ids=None):
        with get_tracer().stage("loop_correct"):
            self._correct_loop(kf, loop_kf, s_cl, R_cl, t_cl, loop_points, loop_point_ids)

    def _correct_loop(self, kf, loop_kf, s_cl, R_cl, t_cl, loop_points, loop_point_ids):
        st = self.map
        covis_before = st.covisibility()

        # NonCorrectedSim3 (:460-462): snapshot EVERY pose before any
        # write-back: structural essential-graph measurements must come
        # from the pre-correction poses (Optimizer.cc:1577-1646)
        pre_R = st.kf_R.copy()
        pre_t = st.kf_t.copy()

        # corrected Scw of the current KF: S_cl o S_lw (:435-439)
        S_lw = (np.float32(1.0), st.kf_R[loop_kf].copy(), st.kf_t[loop_kf].copy())
        S_cw_corr = _compose_np((s_cl, R_cl, t_cl), S_lw)

        # covisible group of the current KF inherits the correction (:441-510)
        group = [kf] + [
            int(k) for k in np.nonzero(covis_before[kf] >= 15)[0] if st.kf_valid[k] and k != kf
        ]
        new_sim3 = {}
        T_cw_old = (np.float32(1.0), st.kf_R[kf].copy(), st.kf_t[kf].copy())
        T_wc_old = _inverse_np(T_cw_old)
        for k in group:
            if k == kf:
                S_kw_new = S_cw_corr
            else:
                S_kw_old = (np.float32(1.0), pre_R[k], pre_t[k])
                S_kc = _compose_np(S_kw_old, T_wc_old)   # relative, pre-correction
                S_kw_new = _compose_np(S_kc, S_cw_corr)
            new_sim3[k] = S_kw_new

        # correct the group's points through their KF correction (:466-497),
        # tracking which group KF corrected each point (mnCorrectedReference)
        # so the post-optimization remap uses the SAME frame (:1697-1703)
        corrected_by = np.full(st.max_mp, -1, np.int32)
        for k in group:
            pts = st.kf_point[k]
            pts = pts[pts >= 0]
            pts = pts[st.mp_valid[pts] & (corrected_by[pts] < 0)]
            if len(pts) == 0:
                continue
            x_cam = st.mp_xyz[pts] @ pre_R[k].T + pre_t[k]   # NonCorrected Siw
            s_i, R_i, t_i = _inverse_np(new_sim3[k])
            st.mp_xyz[pts] = (s_i * (x_cam @ R_i.T) + t_i).astype(np.float32)
            corrected_by[pts] = k
        # write back SE3 = [R, t/s] (:499-508)
        for k, (s, R, t) in new_sim3.items():
            st.kf_R[k] = R
            st.kf_t[k] = t / s

        # fuse the guided loop matches into the current KF (:514-531):
        # existing point is replaced BY the loop point
        if loop_points is not None:
            mps, feats = loop_points
            for mp, f in zip(mps, feats):
                mp, f = int(mp), int(f)
                if not st.mp_valid[mp]:
                    continue
                existing = int(st.kf_point[kf, f])
                if existing >= 0 and st.mp_valid[existing] and existing != mp:
                    st.replace_point(existing, mp)
                else:
                    st.add_observation(mp, kf, f)

        # SearchAndFuse (:534, :576-589): project the loop-side point set
        # into EVERY corrected-group keyframe and fuse duplicates, welding
        # covisibility across the loop
        if loop_point_ids is not None:
            with get_tracer().stage("loop_fuse"):
                self._search_and_fuse(group, loop_point_ids)

        # LoopConnections (:538-556): fresh cross-loop covisibility links =
        # post-fusion neighbors minus pre-loop neighbors minus the group
        covis_after = st.covisibility()
        group_set = set(group)
        loop_connections: dict[int, set[int]] = {}
        for i in group:
            prev = {int(j) for j in np.nonzero(covis_before[i] >= 15)[0]}
            now = {
                int(j) for j in np.nonzero(covis_after[i] >= 15)[0]
                if st.kf_valid[j] and int(j) != i
            }
            conns = now - prev - group_set
            if conns:
                loop_connections[i] = conns

        # essential-graph optimization over ALL keyframes (:560)
        self._essential_graph(
            kf, loop_kf, covis_after, new_sim3, pre_R, pre_t,
            loop_connections, corrected_by,
        )

        # loop edges (:563-565)
        st.kf_loop_edges[kf].add(loop_kf)
        st.kf_loop_edges[loop_kf].add(kf)
        self.last_loop_kf_id = st.next_kf_id

    def _search_and_fuse(self, group: list[int], loop_point_ids: np.ndarray):
        """LoopClosing::SearchAndFuse (:576-589) + ORBmatcher::Fuse(Scw)
        (ORBmatcher.cc:1136-1265): project the loop points through each
        corrected group pose (stored SE3 [R, t/s], the reference's
        normalized Scw decomposition), match within radius 4*scale, and
        replace any existing point with the loop point."""
        st, cfg = self.map, self.cfg
        h = host_tensor
        pts = loop_point_ids[st.mp_valid[loop_point_ids]]
        if len(pts) == 0:
            return
        pts_pad, base_valid = self._padded_points(pts)
        sf = h(cfg.scale_factors)
        for k in group:
            # the map changes between keyframes (a replaced point dies):
            # each keyframe's search sees the map the last one left
            xw = st.mp_xyz[pts_pad]
            R, t = st.kf_R[k], st.kf_t[k]
            uv, z = self._project(xw @ R.T + t)
            valid_q = base_valid & (z > 0) & st.mp_valid[pts_pad]
            # skip points the keyframe already observes (spAlreadyFound)
            valid_q &= ~(st.mp_obs_kf[pts_pad] == k).any(axis=1)
            O = -R.T @ t
            dist = np.linalg.norm(xw - O, axis=1)
            valid_q &= (dist >= 0.8 * st.mp_min_dist[pts_pad]) & (
                dist <= 1.2 * st.mp_max_dist[pts_pad]
            )
            pred = predict_scale_level(
                dist, st.mp_max_dist[pts_pad], cfg.scale_factor, cfg.n_levels
            )
            m = self.programs["fuse"].run(
                4.0, h(st.mp_desc[pts_pad]), h(uv), h(pred), h(valid_q),
                h(st.kf_desc[k]), h(st.kf_xy[k]), h(st.kf_level[k]),
                h(st.kf_feat_valid[k]), sf)
            mask, idx = fetch(m.mask, m.idx)
            for qi in np.nonzero(mask)[0]:
                mp = int(pts_pad[qi])
                if not st.mp_valid[mp]:
                    continue
                f = int(idx[qi])
                existing = int(st.kf_point[k, f])
                if existing >= 0 and st.mp_valid[existing]:
                    if existing != mp:
                        st.replace_point(existing, mp)
                else:
                    st.add_observation(mp, k, f)

    def _essential_graph(self, kf: int, loop_kf: int, covis_after,
                         corrected: dict, pre_R: np.ndarray, pre_t: np.ndarray,
                         loop_connections: dict, corrected_by: np.ndarray):
        """OptimizeEssentialGraph (Optimizer.cc:1470-1719).

        Vertex estimates: CorrectedSim3 for the group, current (=
        pre-correction) poses elsewhere (:1508-1521). Loop-connection edges
        measure the relative Sim3 between vertex ESTIMATES (:1540-1556);
        all structural edges (spanning tree, prior loop edges, strong
        covisibility) measure the relative pose between the PRE-correction
        poses, NonCorrectedSim3 (:1577-1646), so the loop residual is
        carried by the graph instead of vanishing at the initial point.
        """
        st, cfg = self.map, self.cfg
        dm = self._mirror()
        put = dm.put
        K = st.max_kf
        valid = st.kf_valid.copy()

        # vertex estimates (vScw): corrected Sim3 where available, else the
        # stored pose (untouched outside the group => pre-correction)
        s_v = np.ones(K, np.float32)
        R_v = st.kf_R.copy()
        t_v = st.kf_t.copy()
        for k, (s, R, t) in corrected.items():
            s_v[k] = s
            R_v[k] = R
            t_v[k] = t

        # edges collected in PRIORITY BUCKETS: when the fixed capacity
        # overflows, structural edges (loop connections, spanning tree,
        # prior loop edges) must all survive and only the WEAKEST strong-
        # covisibility edges drop (the reference uses all edges,
        # Optimizer.cc:1486-1664; a fixed-shape program must rank them)
        e_i, e_j, e_s, e_R, e_t, e_prio = [], [], [], [], [], []
        kinds = {"loop": 0, "spanning": 0, "prior_loop": 0, "covisibility": 0}

        def add_edge(i, j, meas, kind, prio=np.inf):
            e_i.append(i)
            e_j.append(j)
            e_s.append(meas[0])
            e_R.append(meas[1])
            e_t.append(meas[2])
            e_prio.append(prio)
            kinds[kind] += 1

        def est(i):
            return (s_v[i], R_v[i], t_v[i])

        def noncorr(i):
            return (np.float32(1.0), pre_R[i], pre_t[i])

        # loop-connection edges (:1540-1565): measurement from the vertex
        # estimates; weight gate 100 except the (current, loop) pair itself
        seen = set()
        for i, conns in sorted(loop_connections.items()):
            for j in sorted(conns):
                if not valid[j]:
                    continue
                if (i != kf or j != loop_kf) and covis_after[i, j] < 100:
                    continue
                key = (min(i, j), max(i, j))
                if key in seen:
                    continue
                seen.add(key)
                add_edge(i, j, _compose_np(est(j), _inverse_np(est(i))), "loop")
        # the explicit current<->loop edge (always present: the reference's
        # weight-gate exemption guarantees it once fusion links the pair)
        key = (min(kf, loop_kf), max(kf, loop_kf))
        if key not in seen:
            seen.add(key)
            add_edge(kf, loop_kf, _compose_np(est(loop_kf), _inverse_np(est(kf))), "loop")

        # normal edges (:1573-1664): measurements from NonCorrectedSim3
        for k in np.nonzero(valid)[0]:
            k = int(k)
            Swi_pre = _inverse_np(noncorr(k))
            parent = int(st.kf_parent[k])
            if parent >= 0 and valid[parent]:
                key = (min(k, parent), max(k, parent))
                if key not in seen:
                    seen.add(key)
                    add_edge(k, parent, _compose_np(noncorr(parent), Swi_pre), "spanning")
            for le in st.kf_loop_edges[k]:
                le = int(le)
                key = (min(k, le), max(k, le))
                if valid[le] and le < k and key not in seen:
                    seen.add(key)
                    add_edge(k, le, _compose_np(noncorr(le), Swi_pre), "prior_loop")
            # strong covisibility edges (weight >= 100, Optimizer.cc:1496)
            for n in np.nonzero(covis_after[k] >= 100)[0]:
                n = int(n)
                key = (min(k, n), max(k, n))
                if valid[n] and n < k and key not in seen:
                    seen.add(key)
                    add_edge(k, n, _compose_np(noncorr(n), Swi_pre), "covisibility",
                             prio=float(covis_after[k, n]))

        E = len(e_i)
        cap = cfg.eg_edges  # fixed edge capacity: one program shape
        get_tracer().log("essential_graph_edges", kf=int(kf), loop_kf=int(loop_kf), total=E,
                         cap=cap, **kinds)
        if E > cap:
            # rank by priority: structural edges (inf) always survive, the
            # weakest strong-covisibility edges drop first
            order = np.argsort(-np.asarray(e_prio), kind="stable")[:cap]
            get_tracer().log(
                "essential_graph_edges_dropped", total=E, cap=cap, dropped=E - cap,
                structural=int(np.sum(~np.isfinite(e_prio))),
            )
            take = lambda lst: [lst[i] for i in order]
            e_i, e_j = take(e_i), take(e_j)
            e_s, e_R, e_t = take(e_s), take(e_R), take(e_t)
            E = cap
        pad = cap - E
        prob = essential_graph.EssentialGraphProblem(
            s=put(s_v), R=put(R_v), t=put(t_v),
            fixed=put(~valid | (np.arange(K) == loop_kf)),
            e_i=put(np.concatenate([e_i, np.zeros(pad)]).astype(np.int64)),
            e_j=put(np.concatenate([e_j, np.zeros(pad)]).astype(np.int64)),
            e_s=put(np.concatenate([e_s, np.ones(pad)]).astype(np.float32)),
            e_R=put(np.concatenate([np.stack(e_R), np.tile(np.eye(3), (pad, 1, 1))])
                    .astype(np.float32)),
            e_t=put(np.concatenate([np.stack(e_t), np.zeros((pad, 3))]).astype(np.float32)),
            e_valid=put(np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])),
        )
        with get_tracer().stage("loop_essential_graph"):
            if self._sharded_eg():
                # the edge-sharded pose graph over the process's devices
                devices = pmesh.mesh_devices(self.device)
                res = sharded_optimize_essential_graph(
                    shard_essential_graph(prob, len(devices)),
                    pmesh.DeviceMesh(devices), iterations=20)
            else:
                res = self.programs["essential_graph"].run(20, prob)
            s_new, R_new, t_new, chi2 = fetch(res.s, res.R, res.t, res.chi2)
        get_tracer().log("essential_graph_done", kf=int(kf), chi2=float(chi2), edges=E)

        # correct every point through the vertex estimate of the keyframe
        # that owns it (its rigid-correction reference if it was corrected
        # by this loop, else its reference KF, Optimizer.cc:1687-1718):
        # x' = S_opt(r)^-1 ( S_est(r) (x) )
        mp_sel = np.nonzero(st.mp_valid)[0]
        if len(mp_sel):
            r = np.where(corrected_by[mp_sel] >= 0,
                         corrected_by[mp_sel], st.mp_ref_kf[mp_sel])
            ok = (r >= 0) & valid[np.clip(r, 0, K - 1)]
            mp_sel = mp_sel[ok]
            r = np.clip(r[ok], 0, K - 1)
            x = st.mp_xyz[mp_sel]
            x_cam = (s_v[r, None] * np.einsum("nij,nj->ni", R_v[r], x)) + t_v[r]
            # inverse of the optimized Sim3 at r, batched
            si = 1.0 / s_new[r]
            Rn_T = R_new[r].transpose(0, 2, 1)
            x_w = si[:, None] * np.einsum("nij,nj->ni", Rn_T, x_cam - t_new[r])
            st.mp_xyz[mp_sel] = x_w.astype(np.float32)
        # recover SE3 poses [R, t/s] (:1677-1685)
        live = np.nonzero(valid)[0]
        st.kf_R[live] = R_new[live]
        st.kf_t[live] = (t_new[live] / s_new[live, None]).astype(np.float32)
        # refresh normals/depth bands after the deformation (:1716); the
        # mirror first, so the attrs program sees the corrected poses and
        # points on the device
        dm.sync_all(st)
        ids = np.nonzero(st.mp_valid)[0]
        st.update_point_attributes(ids, cfg.scale_factors, dmap=dm)
        dm.sync_points(st, ids)


def _compose_np(a, b):
    sa, Ra, ta = a
    sb, Rb, tb = b
    return (
        np.float32(sa * sb),
        (Ra @ Rb).astype(np.float32),
        (sa * (Ra @ tb) + ta).astype(np.float32),
    )


def _inverse_np(a):
    s, R, t = a
    si = 1.0 / s
    Ri = R.T
    return np.float32(si), Ri.astype(np.float32), (-si * (Ri @ t)).astype(np.float32)
