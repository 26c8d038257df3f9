"""Tracking: the per-frame camera pose state machine (counterpart of
orbslam_jpminipc_tpu/frontend/tracking.py).

src/Tracking.cc: the FSM {NO_IMAGES_YET, NOT_INITIALIZED, INITIALIZING,
WORKING, LOST} (Tracking.h:57-64), motion-model tracking
(TrackWithMotionModel :594-628) with the window-search fallback
(TrackPreviousFrame :526-592), local-map tracking (TrackLocalMap :630-662),
the keyframe decision (NeedNewKeyFrame :665-703), BoW + PnP relocalization
(Relocalisation :881-1050) and the motion-model velocity update (:297-310).

Host control flow; every heavy step (matching, frustum checks, pose
optimization) is one torch program on the tracker's device whose results
come back in one host read. On a card each runs as a captured program
(utils/program.py `ProgramSet`: one CUDA graph per shape and variant, the
reference's jitted programs), host arrays copied in and results copied
out; `capture_programs` takes them all ahead of the first frame, frame
extraction's (`frame.Extraction`) with them, on one memory pool. The
tracker mutates only its own Frame bookkeeping and the per-point
visible/found statistics; map growth belongs to local mapping. The steady
WORKING state runs the fused step (fused_track.py) in two halves:
`fused_dispatch` queues the step and the read of its results and returns a
`FusedRecord`; `fused_complete(record)` does the host bookkeeping once the
read has landed, against the slice the step ran on. The synchronous frame
loop completes each record at once (`process_fused`); the pipelined one
(`cfg.pipelined_tracking`, pipeline/system.py) up to `pipeline_depth` frames
later, and re-tracks a record on the host path (`reprocess_stale`) when the
host has rewritten the step's state since its dispatch.

Relocalization needs a keyframe database (place recognition,
map/keyframe_db.py): with one, a LOST frame queries it for candidate
keyframes and tries each (mutual match + EPnP RANSAC + pose
optimization: one program, `reloc_candidate`) and the projection-search
ladder. The RANSACs' minimal sets are drawn as uniform scores on the host
side of a program (`draw_scores`, from the tracker's generator) and
selected inside it (`initializer.select_minimal_sets`), so no generator
runs inside a captured graph; the initialization attempt is one program
too (`init_attempt`);
without one (no vocabulary) `_relocalize` returns False, as the reference's does, and LOST
is terminal. The keyframe decision asks the System's `mapper_busy` hook:
under asynchronous mapping the stage queue rations keyframes; when mapping
runs synchronously the hook is None and the mapper is always idle.
"""
from __future__ import annotations

import enum
from time import monotonic as _monotonic

import numpy as np
import torch

from ..config import SlamConfig
from ..map.map_state import MapState
from ..ops import matching
from ..solvers import initializer, pnp, pose_opt
from ..utils.device import resolve_device
from ..utils.host import fetch, fetch_async, host_tensor, upload
from ..utils.program import GraphPool, ProgramSet
from ..utils.tracing import get_tracer
from . import fused_track
from .frame import _FEAT_FIELDS, Extraction, Frame

MAX_LOCAL_POINTS = fused_track.MAX_SLICE
INIT_HYP = 200   # the initializer's hypotheses per model (Initializer.cc:102-107)


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    INITIALIZING = 2
    WORKING = 3
    LOST = 4


class FusedRecord:
    """One dispatched fused step: the frame, the step's outputs on the
    device, the dispatch-time snapshot of the slice rows (`slice_ids`,
    `slice_gen`) and of the context's `epoch`, the queued read of every
    output (`future`: `utils/host.AsyncFetch`) and the dispatch time."""

    __slots__ = ("frame_id", "timestamp", "image", "out",
                 "slice_ids", "slice_gen", "epoch", "future", "t_dispatch")

    def __init__(self, frame_id, timestamp, image, out, slice_ids, slice_gen, epoch, future):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.image = image
        self.out = out
        self.slice_ids = slice_ids
        self.slice_gen = slice_gen
        self.epoch = epoch
        self.future = future
        self.t_dispatch = _monotonic()


def _record_fields(out: fused_track.FusedOut) -> tuple:
    """The step's outputs a completion reads, in `fused_complete`'s order:
    pose, pass-2 inliers, bindings, slice flags, the features (in
    `_FEAT_FIELDS` order), then whether the recovery pass ran."""
    f = out.feats
    return (out.R, out.t, out.n_inl2, out.feat_bind, out.flags,
            f.xy, out.xy_un, f.level, f.angle, f.response, f.desc, f.valid, out.recovered)


def _record_frame(rec: FusedRecord, host: tuple) -> Frame:
    """The record's frame, its features from the record's read. It keeps no
    device tensors: those are views of the step's whole packed outputs
    (~75 kB a frame), which a caller holding the frame would keep on the
    card; the host path uploads what it needs (`Frame.feature_tensor`)."""
    return Frame(rec.frame_id, rec.timestamp, n_feat=int(host[3].shape[0]),
                 host=dict(zip(_FEAT_FIELDS, host[5:5 + len(_FEAT_FIELDS)])))


def _scatter_bindings(idx, mask, n: int) -> torch.Tensor:
    """Per frame feature, the query row matched to it (-1 none). Unmatched
    rows go to a sink row n (the reference's out-of-range dropped index);
    enforce_unique leaves at most one matched row per feature."""
    nq = idx.shape[0]
    target = torch.where(mask, idx.to(torch.int64), n)
    feat_q = torch.full((n + 1,), -1, dtype=torch.int32, device=idx.device)
    feat_q.scatter_(0, target, torch.arange(nq, dtype=torch.int32, device=idx.device))
    return feat_q[:n]


def _from_scores(scores, k):
    """A sampler(mask, n_hyp) over drawn scores: each row's top k valid
    slots (`initializer.select_minimal_sets`), inside the program."""
    return lambda mask, n_hyp: initializer.select_minimal_sets(scores, mask, k)


def _init_attempt(sampler, d0, xy0, a0, v0, lvl0, d1, xy1un, a1, lvl1, v1, K4):
    """One initialization attempt as ONE program: level-0 window match
    (SearchForInitialization, win=100, ORBmatcher.cc:598-713) + the batched
    dual-model H||F RANSAC (Initializer::Initialize) on minimal sets drawn
    by `sampler(mask, n_hyp)`."""
    m = matching.window_search(
        d0, xy0, a0, v0, d1, xy1un, a1, lvl1, v1,
        window_px=100.0, max_dist=50, nn_ratio=0.9,
        min_level=0, max_level=0, check_rotation=True,
    )
    mask = m.mask & (lvl0 == 0)
    uv2 = xy1un[m.idx.to(torch.int64)]
    res = initializer.initialize(sampler(mask, INIT_HYP), xy0, uv2, mask, K4)
    return torch.sum(v1), m.idx, mask, res


def _bind_and_optimize(idx, mask, xw_q, R0, t0, f_xy, w, K4, n_rounds=4):
    """Scatter query->feature matches to per-feature bindings and run the
    4-round pose optimizer. Returns (feat_q, res)."""
    n = f_xy.shape[0]
    nq = idx.shape[0]
    feat_q = _scatter_bindings(idx, mask, n)
    has = feat_q >= 0
    xw_f = xw_q[torch.clamp(feat_q, 0, nq - 1).to(torch.int64)]
    res = pose_opt.optimize_pose(R0, t0, xw_f, f_xy, w, has, K4, n_rounds=n_rounds)
    return feat_q, res


def _track_frame_prog(desc_q, uv_proj, lf_xy, lf_angle, lf_level, valid_q,
                      xw_q, f_desc, f_xy, f_angle, f_level, f_valid, w,
                      R0, t0, K4, scale_factors):
    """TrackWithMotionModel + the TrackPreviousFrame fallback as ONE
    program: projection search under the predicted pose, 200 px window
    search fallback, binding scatter, 4-round pose optimization
    (Tracking.cc:526-628). Both searches run; the mask count picks one."""
    m1 = matching.search_by_projection(
        desc_q, uv_proj, lf_level, valid_q,
        f_desc, f_xy, f_level, f_valid, scale_factors,
        radius=15.0, max_dist=100, nn_ratio=0.9, level_window=(-1, 1))
    m2 = matching.window_search(
        desc_q, lf_xy, lf_angle, valid_q,
        f_desc, f_xy, f_angle, f_level, f_valid,
        window_px=200.0, max_dist=100, nn_ratio=0.9,
        min_level=0, max_level=scale_factors.shape[0] - 1,
        check_rotation=True)
    use2 = torch.sum(m1.mask) < 20
    idx = torch.where(use2, m2.idx, m1.idx)
    mask = torch.where(use2, m2.mask, m1.mask)
    feat_q, res = _bind_and_optimize(idx, mask, xw_q, R0, t0, f_xy, w, K4)
    return idx, mask, use2, feat_q, res


def _track_local_map_prog(mp_xyz, mp_normal, mp_mind, mp_maxd, mp_desc,
                          q_valid, already, f_desc, f_xy, f_level, f_valid,
                          prev_xw, prev_has, w, R, t, K4, bounds,
                          scale_factors, radius_mult):
    """TrackLocalMap's frustum gate + projection search + pose
    re-optimization over the MERGED binding set (prior frame-to-frame
    matches + new local-map matches) as ONE program (Tracking.cc:630-773)."""
    from ..geometry.camera import frustum_check

    n_levels = scale_factors.shape[0]
    ok, uv, _, view_cos, dist = frustum_check(
        mp_xyz, R, t, K4, bounds, mp_normal, mp_mind * 0.8, mp_maxd * 1.2)
    visible = ok & q_valid
    ratio = torch.clamp(mp_maxd, min=1e-9) / torch.clamp(dist, min=1e-9)
    pred = torch.clamp(
        torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / torch.log(scale_factors[1])),
        0, n_levels - 1).to(torch.int32)
    th = torch.where(view_cos > 0.998, 2.5, 4.0) * radius_mult
    m = matching.search_by_projection(
        mp_desc, uv, pred, visible & ~already,
        f_desc, f_xy, f_level, f_valid & ~prev_has, scale_factors,
        radius=th, max_dist=100, nn_ratio=0.8, level_window=(-1, 1))
    n = f_xy.shape[0]
    nq = m.idx.shape[0]
    feat_q = _scatter_bindings(m.idx, m.mask, n)
    new_has = feat_q >= 0
    has = prev_has | new_has
    xw_f = torch.where(new_has[:, None],
                       mp_xyz[torch.clamp(feat_q, 0, nq - 1).to(torch.int64)], prev_xw)
    res = pose_opt.optimize_pose(R, t, xw_f, f_xy, w, has, K4)
    return visible, m.idx, m.mask, feat_q, has, res


def _reloc_candidate_prog(sampler, f_desc, f_xy, f_angle, f_level, f_valid, w,
                          kf_desc, kf_angle, kf_has, kf_xw, max_err2, K4):
    """One relocalization candidate attempt, the reference's one program
    (Relocalisation :881-1050 inner loop): the mutual match, EPnP RANSAC
    over the matched points on minimal sets drawn by `sampler(mask,
    n_hyp)`, then the 4-round pose optimization on the PnP inliers. The
    tracker runs it as the `reloc_candidate` program, its sampler selecting
    from scores drawn before the replay."""
    m = matching.mutual_match(
        f_desc, f_angle, f_valid, kf_desc, kf_angle, kf_has,
        max_dist=50, nn_ratio=0.75, check_rotation=True)
    # each frame feature's world point through the candidate's bindings
    xw = kf_xw[m.idx.to(torch.int64)]
    res = pnp.solve_pnp(sampler(m.mask, pnp.N_HYP), xw, f_xy, m.mask, K4, max_err2)
    sel = m.mask & res.inliers
    opt = pose_opt.optimize_pose(res.R, res.t, xw, f_xy, w, sel, K4)
    return m.idx, m.mask, res.success, sel, opt


def _reloc_refine_prog(q_desc, uv_proj, q_level, valid_q, q_xw,
                       f_desc, f_xy, f_level, f_valid, prev_xw, prev_has,
                       w, R, t, K4, scale_factors,
                       radius: float = 10.0, max_dist: int = 100):
    """One post-PnP projection-search ladder rung as ONE program
    (Tracking.cc:988-1027): project the candidate KF's points, re-match
    within `radius` px (the reference runs a 10 px/dist-100 rung, then a
    3 px/dist-64 rung when 30 <= inliers < 50), re-optimize on the union."""
    m = matching.search_by_projection(
        q_desc, uv_proj, q_level, valid_q,
        f_desc, f_xy, f_level, f_valid, scale_factors,
        radius=radius, max_dist=max_dist, nn_ratio=1.0, level_window=(-1, 1))
    n = f_xy.shape[0]
    nq = m.idx.shape[0]
    feat_q = _scatter_bindings(m.idx, m.mask, n)
    new_has = feat_q >= 0
    has = prev_has | new_has
    xw_f = torch.where(new_has[:, None],
                       q_xw[torch.clamp(feat_q, 0, nq - 1).to(torch.int64)], prev_xw)
    res = pose_opt.optimize_pose(R, t, xw_f, f_xy, w, has, K4)
    return m.idx, m.mask, feat_q, has, res


class Tracker:
    def __init__(self, cfg: SlamConfig, state: MapState, kfdb=None, device=None):
        self.cfg = cfg
        self.map = state
        self.kfdb = kfdb  # map/keyframe_db.KeyFrameDatabase or None
        self.device = resolve_device(device)
        self.state = TrackState.NO_IMAGES_YET
        self.velocity: tuple[np.ndarray, np.ndarray] | None = None
        self.last_frame: Frame | None = None
        self.init_frame: Frame | None = None
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = 0
        self.last_reloc_frame_id: int = -(10 ** 9)
        self.n_inliers: int = 0
        # RANSAC minimal sets: uniform scores drawn by `draw_scores` from a
        # generator seeded from cfg.seed, selected inside the program. A
        # test may set `sampler` (initialization, (n_hyp, 8) indices) or
        # `pnp_sampler` (a relocalization candidate, (n_hyp, 4)) to
        # sampler(mask, n_hyp) to replay another implementation's sets: the
        # mask is computed inside the program, so the hook gets None
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.sampler = None
        self.pnp_sampler = None
        self.bounds = self._compute_bounds()
        self.K4 = self._put(cfg.K4)
        self.scale_factors = self._put(cfg.scale_factors)
        self.fused = (fused_track.FusedContext(cfg, device=self.device)
                      if cfg.fused_tracking else None)
        # the host path's programs, on one pool (they never run at once)
        dev, pool = self.device, GraphPool()
        self.extraction = Extraction(cfg, device=dev, pool=pool)
        self.programs = {
            "track_frame": ProgramSet(lambda v, *a: _track_frame_prog(*a), dev,
                                      "track_frame", pool=pool),
            "track_local_map": ProgramSet(lambda v, *a: _track_local_map_prog(*a), dev,
                                          "track_local_map", pool=pool),
            # the scores of the RANSAC draw come first
            "reloc_candidate": ProgramSet(
                lambda v, scores, *a: _reloc_candidate_prog(
                    _from_scores(scores, pnp.MIN_SET), *a),
                dev, "reloc_candidate", pool=pool),
            "init_attempt": ProgramSet(
                lambda v, scores, *a: _init_attempt(_from_scores(scores, 8), *a),
                dev, "init_attempt", pool=pool),
            # variant (radius, max_dist): the ladder's two rungs
            "reloc_refine": ProgramSet(
                lambda v, *a: _reloc_refine_prog(*a, radius=v[0], max_dist=v[1]), dev,
                "reloc_refine", pool=pool),
        }
        # device mirror of the map (owned by the LocalMapper, wired by the
        # System): slice refreshes gather on the device
        self.dmap = None
        # callbacks wired by the System
        self.on_initialized = None   # fn(frame1, frame2, matches, init_result)
        self.on_new_keyframe = None  # fn(frame)
        self.mapper_busy = None      # fn() -> bool (mbAcceptKeyFrames inverse)

    def _put(self, a) -> torch.Tensor:
        """A host array on the tracker's device (a queued, pinned upload)."""
        return upload(a, self.device)

    def _compute_bounds(self):
        """Undistorted image bounds (Frame.cc:321-349)."""
        cfg = self.cfg
        corners = np.array(
            [[0, 0], [cfg.width, 0], [0, cfg.height], [cfg.width, cfg.height]], np.float32)
        if np.any(cfg.dist4 != 0):
            from ..geometry.camera import undistort_points

            und = undistort_points(torch.from_numpy(corners), torch.from_numpy(cfg.K4),
                                   torch.from_numpy(cfg.dist4)).numpy()
        else:
            und = corners
        return np.array([und[:, 0].min(), und[:, 0].max(), und[:, 1].min(), und[:, 1].max()],
                        np.float32)

    def _feat(self, frame: Frame, name: str) -> torch.Tensor:
        return frame.feature_tensor(name, self.device)

    def draw_scores(self, n_hyp: int, n: int) -> torch.Tensor:
        """Uniform scores (n_hyp, n) for a RANSAC draw, from the tracker's
        generator on its device."""
        return torch.rand((n_hyp, n), generator=self.generator, device=self.device)

    def _scores(self, sampler, n_hyp: int, n: int) -> torch.Tensor:
        """The scores a program selects its minimal sets from: a fresh draw,
        or the sets a replaying `sampler` gives (`scores_for_sets`)."""
        if sampler is None:
            return self.draw_scores(n_hyp, n)
        return initializer.scores_for_sets(sampler(None, n_hyp).to(self.device), n)

    @torch.no_grad()
    def capture_programs(self):
        """Capture the host path's programs ahead of the first frame at the
        shapes the reference compiles (its `Slam._compile_programs`):
        extraction at n1 = n_features and n2 = 2 n1; frame-to-frame tracking
        at (last frame, frame) in {n1, n2}^2; local-map tracking at frame n1
        and n2 against the slice's M rows; the relocalization candidate and
        both ladder rungs at frame n1 and n2 against keyframe rows; the
        initialization attempt at n2 (the initializing frames' extraction);
        the slice refresh (the map mirror's `slice` program) at M rows.
        Dummy inputs of the real calls' dtypes; on the CPU nothing is
        captured (the sets still note the shapes)."""
        cfg, dev = self.cfg, self.device
        n1, n2, M, nk = cfg.n_features, 2 * cfg.n_features, MAX_LOCAL_POINTS, self.map.n_feat
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)
        u8, i32, b = torch.uint8, torch.int32, torch.bool
        eye = torch.eye(3, device=dev)
        self.extraction.capture((n1, n2))
        P = self.programs
        for nf in (n1, n2):
            # the frame's desc, xy, angle, level, valid
            f = (z(nf, 32, dt=u8), z(nf, 2), z(nf), z(nf, dt=i32), z(nf, dt=b))
            for nq in (n1, n2):
                P["track_frame"].capture(
                    None, z(nq, 32, dt=u8), z(nq, 2), z(nq, 2), z(nq), z(nq, dt=i32),
                    z(nq, dt=b), z(nq, 3), *f, z(nf), eye, z(3), self.K4, self.scale_factors)
            P["track_local_map"].capture(
                None, z(M, 3), z(M, 3), z(M), z(M), z(M, 32, dt=u8), z(M, dt=b), z(M, dt=b),
                f[0], f[1], f[3], f[4], z(nf, 3), z(nf, dt=b), z(nf), eye, z(3), self.K4,
                z(4), self.scale_factors, z())
            P["reloc_candidate"].capture(
                None, z(pnp.N_HYP, nf), f[0], f[1], f[2], f[3], f[4], z(nf),
                z(nk, 32, dt=u8), z(nk), z(nk, dt=b), z(nk, 3), z(nf), self.K4)
            for rung in ((10.0, 100), (3.0, 64)):
                P["reloc_refine"].capture(
                    rung, z(nk, 32, dt=u8), z(nk, 2), z(nk, dt=i32), z(nk, dt=b), z(nk, 3),
                    f[0], f[1], f[3], f[4], z(nf, 3), z(nf, dt=b), z(nf), eye, z(3),
                    self.K4, self.scale_factors)
        # frame 0's desc, xy_un, angle, valid, level; frame 1's desc, xy_un,
        # angle, level, valid
        P["init_attempt"].capture(
            None, z(INIT_HYP, n2), z(n2, 32, dt=u8), z(n2, 2), z(n2), z(n2, dt=b),
            z(n2, dt=i32), z(n2, 32, dt=u8), z(n2, 2), z(n2), z(n2, dt=i32), z(n2, dt=b),
            self.K4)
        # the slice refresh, the map mirror's program at the slice's rows
        if self.dmap is not None and self.fused is not None:
            self.dmap.capture("slice", None, np.zeros(M, np.int64), np.zeros(M, bool),
                              np.zeros(M, np.float32))

    # ------------------------------------------------------------------
    # main entry
    # ------------------------------------------------------------------

    def process_frame(self, frame: Frame) -> TrackState:
        """One tracking step on the host path. Returns the post-step state;
        on success frame.R/frame.t hold the world->camera pose."""
        if self.state == TrackState.NO_IMAGES_YET:
            self.state = TrackState.NOT_INITIALIZED

        if self.state == TrackState.NOT_INITIALIZED:
            self._first_initialization(frame)
        elif self.state == TrackState.INITIALIZING:
            self._try_initialize(frame)
        else:
            ok = False
            if self.state == TrackState.WORKING:
                ok = self._track_frame(frame)
                if ok:
                    ok = self._track_local_map(frame)
            elif self.state == TrackState.LOST:
                ok = self._relocalize(frame)
                if ok:
                    ok = self._track_local_map(frame)

            if ok:
                self.state = TrackState.WORKING
                if self._need_new_keyframe(frame):
                    self._create_keyframe(frame)
                # motion model velocity (Tracking.cc:297-310), host numpy
                if self.last_frame is not None and self.last_frame.R is not None:
                    Rl, tl = self.last_frame.R, self.last_frame.t
                    Rv = frame.R @ Rl.T
                    self.velocity = (Rv, frame.t - Rv @ tl)
            else:
                self.state = TrackState.LOST
                self.velocity = None
                # a failed frame keeps no pose (Tracking.cc:244-311)
                frame.R = None
                frame.t = None

        self.last_frame = frame
        return self.state

    # ------------------------------------------------------------------
    # the fused WORKING path (fused_track.py)
    # ------------------------------------------------------------------

    def fused_usable(self, frame_id: int) -> bool:
        """The fused path covers the steady WORKING state; the wide-radius
        post-relocalization window (Tracking.cc:646) stays on the host path."""
        return (
            self.fused is not None
            and self.state == TrackState.WORKING
            and self.fused.ready
            and frame_id >= self.last_reloc_frame_id + 2
        )

    def slice_points(self) -> np.ndarray:
        """Local-map point set around the reference KF: the points observed
        by the covisible neighborhood (UpdateReference*, Tracking.cc:775-860),
        prioritized by (seen-by-ref-kf, observation count) when over the
        slice capacity."""
        st = self.map
        k = self.ref_kf
        if k < 0 or not st.kf_valid[k]:
            return np.zeros(0, np.int64)
        covis = st.covisibility()
        row = covis[k].copy()
        row[~st.kf_valid] = 0
        row[k] = 0
        nb = np.nonzero(row > 0)[0]
        nb = nb[np.argsort(-row[nb])][:79]
        local = np.concatenate([[k], nb]).astype(np.int64)
        pts = np.unique(st.kf_point[local])
        pts = pts[pts >= 0]
        pts = pts[st.mp_valid[pts]]
        if len(pts) > MAX_LOCAL_POINTS:
            ref_pts = st.kf_point[k]
            in_ref = np.isin(pts, ref_pts[ref_pts >= 0])
            nobs = (st.mp_obs_kf[pts] >= 0).sum(axis=1)
            order = np.lexsort((-nobs, ~in_ref))
            pts = np.sort(pts[order[:MAX_LOCAL_POINTS]])
        return pts.astype(np.int64)

    def refresh_fused_slice(self):
        if self.fused is None:
            return
        # skip when neither the mirror nor the reference KF changed since
        # the last refresh: the slice would be identical
        key = (self.dmap.version if self.dmap is not None else -1,
               self.ref_kf, self.map.next_kf_id)
        if getattr(self, "_slice_key", None) == key:
            return
        self._slice_key = key
        pts = self.slice_points()
        if len(pts) == 0:
            return
        if self.dmap is None:
            self.fused.refresh_slice(self.map, pts)
            return
        from ..map.device_map import slice_kernel

        st = self.map
        M = MAX_LOCAL_POINTS
        pts = pts[:M]
        n = len(pts)
        ids = np.zeros(M, np.int64)
        ids[:n] = pts
        rv = np.zeros(M, bool)
        rv[:n] = True
        n_obs = np.zeros(M, np.float32)
        n_obs[:n] = (st.mp_obs_kf[pts] >= 0).sum(axis=1)
        self.fused.load_slice(slice_kernel(self.dmap, ids, rv, n_obs))
        self.fused.slice_ids = pts.astype(np.int64)
        self.fused.slice_gen = st.mp_gen[pts].copy()

    def enter_fused(self, frame: Frame):
        """(Re)arm the fused path from host state after init/reloc/fallback:
        a pose upload + a slice refresh if none is resident."""
        if self.fused is None or frame.R is None:
            return
        self.fused.set_pose(frame.R, frame.t, velocity=self.velocity)
        if self.fused.slice is None:
            self.refresh_fused_slice()

    def fused_dispatch(self, image, frame_id: int, timestamp: float) -> FusedRecord:
        """Queue one fused step and the read of its outputs; the host
        bookkeeping (`fused_complete`) runs when the read has landed,
        possibly several frames later in the pipelined frame loop. The
        slice rows and the epoch are taken NOW: the result binds against
        the slice resident at dispatch. On a card the step runs as one
        chain whose branches the device decides (`FusedContext.dispatch`),
        so the call never waits."""
        fused = self.fused
        with get_tracer().stage("track_dispatch"):
            out = fused.dispatch(image)
            future = fetch_async(*_record_fields(out))
        return FusedRecord(frame_id, timestamp, image, out, fused.slice_ids, fused.slice_gen,
                           fused.epoch, future)

    def fused_complete(self, rec: FusedRecord):
        """Host bookkeeping of one fused step: pose writeback, visible/found
        statistics, match bindings (to the record's slice rows), FSM
        transition, keyframe decision. Takes the record's read, waiting for
        it only when it has not landed."""
        st = self.map
        with get_tracer().stage("track_pull"):
            host = self._take(rec)
        R, t, n_inl2, bind, flags = host[:5]
        frame = _record_frame(rec, host)
        frame.R = R.astype(np.float32)
        frame.t = t.astype(np.float32)
        self.n_inliers = int(n_inl2)

        ids, slice_gen = rec.slice_ids, rec.slice_gen
        n_ids = len(ids)
        if n_ids:
            live = st.mp_valid[ids] & (st.mp_gen[ids] == slice_gen)
            fl = flags[:n_ids]
            vis = ((fl & fused_track.FLAG_VISIBLE) > 0) & live
            fnd = ((fl & fused_track.FLAG_FOUND) > 0) & live
            st.mp_visible[ids[vis]] += 1
            st.mp_found[ids[fnd]] += 1

            has = bind >= 0
            slot = np.where(has, bind & 0xFFFF, 0)
            inl = bind >= fused_track.BIND_INLIER
            ok_slot = has & (slot < n_ids) & live[np.minimum(slot, n_ids - 1)]
            frame.point[ok_slot] = ids[slot[ok_slot]]
            frame.point_gen[ok_slot] = st.mp_gen[ids[slot[ok_slot]]]
            frame.outlier[:] = ok_slot & ~inl

        fell_back = False
        ok = self.n_inliers >= 30
        if not ok:
            # host fallback on this frame's (lazily copied) features
            fell_back = True
            ok = self._track_frame(frame)
            if ok:
                ok = self._track_local_map(frame)
        else:
            # reference-KF vote (UpdateReferenceKeyFrames, Tracking.cc:804-860)
            pts = frame.point[(frame.point >= 0) & ~frame.outlier]
            if len(pts):
                obs = st.mp_obs_kf[pts]
                votes = np.bincount(obs[obs >= 0], minlength=st.max_kf)
                if votes.max() > 0:
                    self.ref_kf = int(votes.argmax())

        if ok:
            self.state = TrackState.WORKING
            if self._need_new_keyframe(frame):
                self._create_keyframe(frame)
            if self.last_frame is not None and self.last_frame.R is not None:
                Rl, tl = self.last_frame.R, self.last_frame.t
                Rv = frame.R @ Rl.T
                self.velocity = (Rv, frame.t - Rv @ tl)
            if fell_back:
                self.fused.set_pose(frame.R, frame.t, velocity=self.velocity)
        else:
            self.state = TrackState.LOST
            self.velocity = None
            self.fused.invalidate()
            frame.R = None  # see process_frame: no garbage pose survives
            frame.t = None
        self.last_frame = frame
        return self.state, frame

    def process_fused(self, image, frame_id: int, timestamp: float):
        """One fused step and its host bookkeeping, back to back."""
        return self.fused_complete(self.fused_dispatch(image, frame_id, timestamp))

    def reprocess_stale(self, rec: FusedRecord):
        """A record dispatched before a host intervention (a fallback pose
        fix, LOST, a reset, a relocalization: the context's epoch moved) ran
        against state the host has since rewritten, so its result is not
        used. The frame is tracked again on the host path from the step's
        features; the extraction is not redone."""
        frame = _record_frame(rec, self._take(rec))
        return self.process_frame(frame), frame

    def _take(self, rec: FusedRecord) -> tuple:
        """The record's read (waiting only if it has not landed); the step's
        recovery pass, when it ran, counts its kernel launches now."""
        host = rec.future.result()
        if host[-1]:
            self.fused.count_recovery()
        return host

    # ------------------------------------------------------------------
    # initialization (Tracking.cc:360-420 + CreateInitialMap :422-524)
    # ------------------------------------------------------------------

    def _first_initialization(self, frame: Frame):
        if frame.n_valid > 100:
            self.init_frame = frame
            self.state = TrackState.INITIALIZING

    def _attempt_init(self, f0: Frame, frame: Frame):
        """One initialization attempt from `f0` to `frame`: the draw, ONE
        program (`init_attempt`) and ONE host read. Returns the frame's
        valid count, the match table and mask, and the `InitResult`, on
        the host."""
        out = self.programs["init_attempt"].run(
            None, self._scores(self.sampler, INIT_HYP, f0.n_feat),
            self._feat(f0, "desc"), self._feat(f0, "xy_un"),
            self._feat(f0, "angle"), self._feat(f0, "valid"),
            self._feat(f0, "level"),
            self._feat(frame, "desc"), self._feat(frame, "xy_un"),
            self._feat(frame, "angle"), self._feat(frame, "level"),
            self._feat(frame, "valid"), self.K4,
        )
        host = fetch(*out[:3], *out[3])
        return (*host[:3], initializer.InitResult(*host[3:]))

    def _try_initialize(self, frame: Frame):
        f0 = self.init_frame
        n1, idx, mask, res = self._attempt_init(f0, frame)
        if int(n1) <= 100:
            self.state = TrackState.NOT_INITIALIZED
            return
        if int(mask.sum()) < 100:
            self.state = TrackState.NOT_INITIALIZED
            return
        if not bool(res.success):
            return  # keep trying with the same init frame
        if self.on_initialized is not None:
            self.on_initialized(f0, frame, (idx, mask), res)

    # ------------------------------------------------------------------
    # frame-to-frame tracking
    # ------------------------------------------------------------------

    def _predict_pose(self):
        lf = self.last_frame
        if self.velocity is not None and self.cfg.use_motion_model:
            Rv, tv = self.velocity
            return Rv @ lf.R, Rv @ lf.t + tv
        return lf.R.copy(), lf.t.copy()

    def _track_frame(self, frame: Frame) -> bool:
        """Motion-model projection search + window-search fallback + pose
        optimization (TrackWithMotionModel :594-628 / TrackPreviousFrame
        :526-592): ONE program, ONE host read."""
        lf = self.last_frame
        if lf is None or lf.R is None:
            return False
        R0, t0 = self._predict_pose()

        lp = lf.point.copy()
        lp[lf.outlier] = -1
        has_pt = lp >= 0
        mp = np.clip(lp, 0, self.map.max_mp - 1)
        # generation check: a culled and recycled slot must not bind
        valid_q = has_pt & self.map.mp_valid[mp] & (self.map.mp_gen[mp] == lf.point_gen)
        xw = self.map.mp_xyz[mp]
        desc_q = self.map.mp_desc[mp]

        # project with the predicted pose
        xc = xw @ R0.T + t0
        z = xc[:, 2]
        uv_proj = np.stack(
            [
                self.cfg.fx * xc[:, 0] / np.maximum(z, 1e-9) + self.cfg.cx,
                self.cfg.fy * xc[:, 1] / np.maximum(z, 1e-9) + self.cfg.cy,
            ],
            axis=1,
        ).astype(np.float32)
        valid_q &= z > 0

        w = self.cfg.inv_sigma2[np.clip(frame.level, 0, self.cfg.n_levels - 1)]
        h = host_tensor
        _idx, mmask, _use2, feat_q, res = self.programs["track_frame"].run(
            None, h(desc_q), h(uv_proj), self._feat(lf, "xy_un"), self._feat(lf, "angle"),
            self._feat(lf, "level"), h(valid_q), h(xw),
            self._feat(frame, "desc"), self._feat(frame, "xy_un"),
            self._feat(frame, "angle"), self._feat(frame, "level"),
            self._feat(frame, "valid"),
            h(w), h(np.asarray(R0, np.float32)), h(np.asarray(t0, np.float32)), self.K4,
            self.scale_factors,
        )
        mmask, feat_q, R, t, inliers, n_inl = fetch(
            mmask, feat_q, res.R, res.t, res.inliers, res.n_inliers)
        if mmask.sum() < 20:
            return False
        # bindings from the program's feat_q: the host table is the one the
        # optimizer scored
        has = feat_q >= 0
        fq = np.clip(feat_q, 0, len(lp) - 1)
        frame.point[:] = -1
        frame.point[has] = lp[fq[has]]
        frame.point_gen[has] = self.map.mp_gen[lp[fq[has]]]
        frame.outlier = has & ~inliers
        frame.R = R
        frame.t = t
        self.n_inliers = int(n_inl)
        return self.n_inliers >= 10

    # ------------------------------------------------------------------
    # local map tracking (TrackLocalMap :630-662)
    # ------------------------------------------------------------------

    def _local_keyframes(self, frame: Frame) -> np.ndarray:
        """K1 = KFs sharing points with the frame; K2 = their top covisible
        neighbors (UpdateReferenceKeyFrames, Tracking.cc:804-860)."""
        has = (frame.point >= 0) & ~frame.outlier
        pts = frame.point[has]
        obs = self.map.mp_obs_kf[pts]  # (n, MAX_OBS)
        votes = np.bincount(obs[obs >= 0], minlength=self.map.max_kf)
        k1 = np.nonzero(votes)[0]
        if len(k1) == 0:
            return k1
        self.ref_kf = int(votes.argmax())
        covis = self.map.covisibility()
        k2 = set(k1.tolist())
        for k in k1:
            row = covis[k].copy()
            row[~self.map.kf_valid] = 0
            row[k] = 0
            top = np.argsort(-row)[:10]
            k2.update(int(x) for x in top if row[x] > 0)
            parent = self.map.kf_parent[k]
            if parent >= 0:
                k2.add(int(parent))
            if len(k2) > 80:
                break
        return np.array(sorted(k2), np.int64)

    def _track_local_map(self, frame: Frame) -> bool:
        """Frustum gate + projection search + pose re-optimization over the
        local-map points (TrackLocalMap :630-773): ONE program, ONE read."""
        local_kfs = self._local_keyframes(frame)
        if len(local_kfs) == 0:
            return False
        # local points (UpdateReferencePoints :775-802)
        pts = np.unique(self.map.kf_point[local_kfs])
        pts = pts[pts >= 0]
        pts = pts[self.map.mp_valid[pts]]
        if len(pts) == 0:
            return False
        if len(pts) > MAX_LOCAL_POINTS:
            pts = pts[:MAX_LOCAL_POINTS]
        pad = MAX_LOCAL_POINTS - len(pts)
        pts_pad = np.concatenate([pts, np.zeros(pad, np.int64)])
        pvalid = np.concatenate([np.ones(len(pts), bool), np.zeros(pad, bool)])

        # wider search right after relocalization (Tracking.cc:646)
        mult = 5.0 if frame.frame_id < self.last_reloc_frame_id + 2 else 1.0
        already = np.isin(pts_pad, frame.point[frame.point >= 0])
        w = self.cfg.inv_sigma2[np.clip(frame.level, 0, self.cfg.n_levels - 1)]
        # the program optimizes the UNION of the prior frame-to-frame
        # bindings (prev_xw/prev_has) and the new local-map matches
        lp = frame.point.copy()
        lp[frame.outlier] = -1
        prev_has = lp >= 0
        prev_xw = self.map.mp_xyz[np.clip(lp, 0, self.map.max_mp - 1)]
        h = host_tensor
        maxd = self.map.mp_max_dist[pts_pad]
        visible, _idx, _mask, feat_q, has, res = self.programs["track_local_map"].run(
            None, h(self.map.mp_xyz[pts_pad]), h(self.map.mp_normal[pts_pad]),
            h(self.map.mp_min_dist[pts_pad]), h(np.where(np.isfinite(maxd), maxd, 0.0)),
            h(self.map.mp_desc[pts_pad]), h(pvalid), h(already),
            self._feat(frame, "desc"), self._feat(frame, "xy_un"),
            self._feat(frame, "level"), self._feat(frame, "valid"),
            h(prev_xw), h(prev_has), h(w),
            h(np.asarray(frame.R, np.float32)), h(np.asarray(frame.t, np.float32)), self.K4,
            h(self.bounds), self.scale_factors, h(np.float32(mult)),
        )
        visible, feat_q, has, R, t, inliers, n_inl = fetch(
            visible, feat_q, has, res.R, res.t, res.inliers, res.n_inliers)
        visible = visible & pvalid
        # visibility statistics (Frame::isInFrustum -> IncreaseVisible)
        self.map.mp_visible[pts_pad[visible]] += 1
        # rebuild bindings from the PROGRAM's own feat_q, so frame.point is
        # exactly the set the pose optimizer saw
        new_has = feat_q >= 0
        fq = np.clip(feat_q, 0, MAX_LOCAL_POINTS - 1)
        frame.point = np.where(
            new_has, pts_pad[fq], np.where(prev_has, lp, -1)).astype(np.int32)
        frame.point_gen = np.where(
            new_has, self.map.mp_gen[pts_pad[fq]], frame.point_gen).astype(np.int32)
        frame.outlier = has & ~inliers
        frame.R = R
        frame.t = t
        self.n_inliers = int(n_inl)
        # found statistics for inlier points (Tracking.cc:646-655)
        inl = (frame.point >= 0) & ~frame.outlier
        self.map.mp_found[frame.point[inl]] += 1

        min_needed = 50 if frame.frame_id < self.last_reloc_frame_id + self.cfg.max_frames else 30
        return self.n_inliers >= min_needed

    # ------------------------------------------------------------------
    # keyframe decision (NeedNewKeyFrame :665-703)
    # ------------------------------------------------------------------

    def _need_new_keyframe(self, frame: Frame) -> bool:
        """Reference-exact NeedNewKeyFrame (Tracking.cc:665-703): post-reloc
        blackout only once the map holds > MaxFrames keyframes; a KF iff
        (timeout OR mapper idle OR tracking decaying hard) AND tracking
        degraded. While the mapper is busy the keyframe is deferred, unless
        tracking is decaying hard (the reference interrupts the running BA
        and takes the keyframe, InterruptBA :692-698; the System's stage
        queue applies those rules when the keyframe arrives)."""
        if self.ref_kf < 0:
            return False
        n_kf = int(self.map.kf_valid.sum())
        if (frame.frame_id < self.last_reloc_frame_id + self.cfg.max_frames
                and n_kf > self.cfg.max_frames):
            return False
        ref_matches = int((self.map.kf_point[self.ref_kf] >= 0).sum())
        idle = self.mapper_busy is None or not self.mapper_busy()
        c1a = frame.frame_id >= self.last_kf_frame_id + self.cfg.max_frames
        c2 = self.n_inliers < 0.9 * ref_matches and self.n_inliers > 15
        if not c2:
            return False
        urgent = self.n_inliers < 0.5 * ref_matches
        get_tracer().log("kf_decision", frame=int(frame.frame_id),
                         inl=self.n_inliers, ref=ref_matches, idle=idle,
                         c1a=bool(c1a), urgent=bool(urgent))
        return c1a or urgent or idle  # c1b = idle (mMinFrames = 0, :77)

    def _create_keyframe(self, frame: Frame):
        if self.on_new_keyframe is not None:
            self.on_new_keyframe(frame)
        self.last_kf_frame_id = frame.frame_id

    # ------------------------------------------------------------------
    # relocalization (Relocalisation :881-1050)
    # ------------------------------------------------------------------

    def _relocalize(self, frame: Frame) -> bool:
        """Candidates from the keyframe database, then per candidate ONE
        program (match, PnP RANSAC, pose optimization) and ONE host read.
        Without a database (no vocabulary) LOST is terminal, as in the
        reference."""
        if self.kfdb is None:
            return False
        tracer = get_tracer()
        qbow = self.kfdb.query_bow(frame.desc, frame.valid)
        self.kfdb.set_covisibility(self.map.covisibility())
        cands = self.kfdb.detect_reloc_candidates(qbow)
        tracer.log("reloc_candidates", frame=int(frame.frame_id),
                   cands=[int(c) for c in cands])
        st, cfg = self.map, self.cfg
        max_err = 5.991 * cfg.sigma2[np.clip(frame.level, 0, cfg.n_levels - 1)]
        w = cfg.inv_sigma2[np.clip(frame.level, 0, cfg.n_levels - 1)]
        w_d = self._put(w.astype(np.float32))
        max_err_d = self._put(max_err.astype(np.float32))
        f = lambda name: self._feat(frame, name)
        h = host_tensor
        for kf in cands:
            kf_point = st.kf_point[kf]
            mp_safe = np.clip(kf_point, 0, st.max_mp - 1)
            kf_has = st.kf_feat_valid[kf] & (kf_point >= 0) & st.mp_valid[mp_safe]
            with tracer.stage("reloc_candidate"):
                idx, mask, pnp_ok, sel, opt = self._reloc_candidate(
                    f("desc"), f("xy_un"), f("angle"), f("level"), f("valid"), w_d,
                    h(st.kf_desc[kf]), h(st.kf_angle[kf]), h(kf_has), h(st.mp_xyz[mp_safe]),
                    max_err_d, self.K4)
                idx, mask, pnp_ok, sel, R, t, inliers, n_inl = fetch(
                    idx, mask, pnp_ok, sel, opt.R, opt.t, opt.inliers, opt.n_inliers)
            tracer.log("reloc_attempt", frame=int(frame.frame_id),
                       kf=int(kf), n_match=int(mask.sum()),
                       pnp_ok=bool(pnp_ok))
            if mask.sum() < 15 or not bool(pnp_ok):
                continue
            # the frame is rewritten before the candidate is known to
            # succeed: _track_local_map reads these bindings
            mp = np.where(sel, kf_point[idx], -1)
            frame.point[:] = -1
            frame.point[sel] = mp[sel]
            frame.point_gen[sel] = st.mp_gen[mp[sel]]
            frame.outlier = sel & ~inliers
            frame.R = R
            frame.t = t
            self.n_inliers = int(n_inl)
            tracer.log("reloc_opt", frame=int(frame.frame_id), kf=int(kf),
                       n_inliers=self.n_inliers)
            if self.n_inliers >= 10:
                if self.n_inliers >= 50 or self._reloc_refine(frame, kf):
                    self.last_reloc_frame_id = frame.frame_id
                    return True
        return False

    def _reloc_candidate(self, f_desc, f_xy, f_angle, f_level, f_valid, w,
                         kf_desc, kf_angle, kf_has, kf_xw, max_err2, K4):
        """`_reloc_candidate_prog` (mutual match + EPnP RANSAC + 4-round
        pose optimization on the PnP inliers) as one program, on scores
        drawn for it (`_scores`)."""
        scores = self._scores(self.pnp_sampler, pnp.N_HYP, f_desc.shape[0])
        return self.programs["reloc_candidate"].run(
            None, scores, f_desc, f_xy, f_angle, f_level, f_valid, w,
            kf_desc, kf_angle, kf_has, kf_xw, max_err2, K4)

    def _reloc_refine(self, frame: Frame, kf: int) -> bool:
        """The reference's full post-PnP refinement ladder
        (Tracking.cc:988-1027): a 10 px projection-search rung, and, when
        it lands in [30, 50) inliers, a second, tighter 3 px / ORB-dist-64
        rung from the once-refined pose. Accept at >= 50."""
        if self._reloc_refine_rung(frame, kf, radius=10.0, max_dist=100):
            return True
        if 30 <= self.n_inliers < 50:
            return self._reloc_refine_rung(frame, kf, radius=3.0, max_dist=64)
        return False

    def _reloc_refine_rung(self, frame: Frame, kf: int, radius: float,
                           max_dist: int) -> bool:
        """One projection-search + re-optimize rung: ONE program, ONE read."""
        st, cfg = self.map, self.cfg
        q = st.kf_point[kf].copy()
        valid_q = q >= 0
        mpid = np.clip(q, 0, st.max_mp - 1)
        xw = st.mp_xyz[mpid]
        xc = xw @ frame.R.T + frame.t
        z = xc[:, 2]
        uv_proj = np.stack(
            [
                cfg.fx * xc[:, 0] / np.maximum(z, 1e-9) + cfg.cx,
                cfg.fy * xc[:, 1] / np.maximum(z, 1e-9) + cfg.cy,
            ],
            axis=1,
        ).astype(np.float32)
        valid_q &= (z > 0) & st.mp_valid[mpid]
        lp = frame.point.copy()
        lp[frame.outlier] = -1
        prev_has = lp >= 0
        prev_xw = st.mp_xyz[np.clip(lp, 0, st.max_mp - 1)]
        w = cfg.inv_sigma2[np.clip(frame.level, 0, cfg.n_levels - 1)]
        h = host_tensor
        with get_tracer().stage("reloc_refine"):
            _idx, _mask, feat_q, has, res = self.programs["reloc_refine"].run(
                (radius, max_dist), h(st.mp_desc[mpid]), h(uv_proj),
                h(st.kf_level[kf]), h(valid_q), h(xw),
                self._feat(frame, "desc"), self._feat(frame, "xy_un"),
                self._feat(frame, "level"), self._feat(frame, "valid"),
                h(prev_xw), h(prev_has), h(w),
                h(np.asarray(frame.R, np.float32)), h(np.asarray(frame.t, np.float32)),
                self.K4, self.scale_factors,
            )
            feat_q, has, R, t, inliers, n_inl = fetch(
                feat_q, has, res.R, res.t, res.inliers, res.n_inliers)
        new_has = feat_q >= 0
        fqc = np.clip(feat_q, 0, len(q) - 1)
        frame.point = np.where(
            new_has, q[fqc], np.where(prev_has, lp, -1)
        ).astype(np.int32)
        frame.point_gen = np.where(
            new_has, st.mp_gen[np.clip(q[fqc], 0, st.max_mp - 1)],
            frame.point_gen,
        ).astype(np.int32)
        frame.outlier = has & ~inliers
        frame.R = R
        frame.t = t
        self.n_inliers = int(n_inl)
        get_tracer().log("reloc_refine", frame=int(frame.frame_id),
                         kf=int(kf), radius=radius,
                         n_new=int(new_has.sum()),
                         n_inliers=self.n_inliers)
        return self.n_inliers >= 50

    def force_relocalization(self):
        """Loop closing tells the tracker the map moved under it
        (Tracking::ForceRelocalisation, Tracking.cc:1052-1064)."""
        self.state = TrackState.LOST
        self.velocity = None
        if self.fused is not None:
            self.fused.invalidate()
