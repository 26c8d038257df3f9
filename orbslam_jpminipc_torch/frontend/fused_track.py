"""The steady-state WORKING tracking step (counterpart of
orbslam_jpminipc_tpu/frontend/fused_track.py).

One call per tracked frame, over device-resident state: extract ORB
features from the frame, predict the pose with the motion model, then

  * pass 1: match the local-map slice under the predicted pose with a wide
    radius (TrackWithMotionModel's window, ORBmatcher.cc:1507-1620),
    anchored on established (>= 3 keyframe) points, and run 2 rounds of the
    pose LM;
  * recovery: when pass 1 keeps fewer than 20 inliers, one ~25x-radius pass
    from the un-predicted previous pose over every valid slice point;
  * pass 2: re-match under the refined pose with the tight radius
    (SearchLocalPoints + TrackLocalMap) and run the full 4-round pose LM.

The pose, the velocity and the slice stay on the device between calls. The
result is a small named tuple of tensors (`FusedOut`); the reference's
single packed host-pull buffer is not needed here.

The reference runs the step as ONE XLA program with two `lax.cond`s in it:
the extractor's fast/slow candidate path per level, and the recovery pass.
Here the step is three segments cut at the conds (`detect`, `pass1`,
`pass2`, with `pick` per level), each a captured program
(utils/program.py), one per arm of a cond. `FusedContext.track` decides
each cond with a host read (all levels' flags in one transfer; `n_inliers
< 20`) and replays the arm it names. Each read waits for everything queued
before it on the stream, mapping programs included, so
`FusedContext.dispatch`, what the tracker runs, launches the same captured
graphs as one chain (utils/graph_chain.py) whose IF nodes decide the conds
on the device: one launch, no read, no wait, the same bits; `track` is its
reference. The recovery pass runs only on the frames that need it either way:
computing it on every frame and selecting would cost a third
match-and-optimize pass on every frame.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..config import SlamConfig
from ..geometry.camera import frustum_check, undistort_points
from ..geometry.se3 import orthonormalize
from ..ops import extractor, matching
from ..ops.extractor import Features
from ..solvers import pose_opt
from ..utils.device import resolve_device
from ..utils.host import upload
from ..utils.program import Program, unpack

MAX_SLICE = 4096  # local-map slice capacity (points of the covisible set)

# feat_bind encoding: low 16 bits = slice slot, bit 16 = pose-opt inlier
BIND_INLIER = 1 << 16
# slice flags encoding
FLAG_VISIBLE = 1
FLAG_FOUND = 2


class MapSlice(NamedTuple):
    """The local-map slice on the device. Rows with max_dist == 0 are empty."""

    xyz: torch.Tensor       # (M, 3) float32 world positions
    normal: torch.Tensor    # (M, 3) float32 mean viewing directions
    min_dist: torch.Tensor  # (M,) float32 scale-invariance band
    max_dist: torch.Tensor  # (M,) float32
    desc: torch.Tensor      # (M, 32) uint8
    n_obs: torch.Tensor     # (M,) float32 observing keyframes


class FusedOut(NamedTuple):
    R: torch.Tensor          # (3, 3) refined world->cam
    t: torch.Tensor          # (3,)
    vel_R: torch.Tensor      # (3, 3) motion-model velocity for the next frame
    vel_t: torch.Tensor      # (3,)
    n_inl2: torch.Tensor     # () pass-2 inliers
    n_inl1: torch.Tensor     # () pass-1 (or recovery) inliers
    n_match2: torch.Tensor   # () pass-2 matches
    n_match1: torch.Tensor   # () pass-1 matches
    feat_bind: torch.Tensor  # (N,) int32: slice slot | BIND_INLIER, -1 = none
    flags: torch.Tensor      # (M,) uint8: FLAG_VISIBLE | FLAG_FOUND
    feats: Features          # the frame's features
    xy_un: torch.Tensor      # (N, 2) undistorted keypoints
    recovered: torch.Tensor  # () bool: the recovery pass ran (pass 1's test)


def pack_slice(xyz, normal, min_dist, max_dist, desc, n_obs, n_valid,
               m=MAX_SLICE) -> np.ndarray:
    """Host-side packing of a local-map slice into the reference's (M, 17)
    float32 layout. Rows >= n_valid are empty (max_dist = 0). Column 16 is
    the observation count: pass 1 anchors only on established (>= 3 KF)
    points."""
    buf = np.zeros((m, 17), np.float32)
    n = min(n_valid, m)
    buf[:n, 0:3] = xyz[:n]
    buf[:n, 3:6] = normal[:n]
    buf[:n, 6] = min_dist[:n]
    buf[:n, 7] = np.maximum(max_dist[:n], 1e-6)
    buf[:n, 8:16] = np.ascontiguousarray(desc[:n]).view(np.float32)
    buf[:n, 16] = n_obs[:n]
    return buf


def slice_from_packed(buf: np.ndarray, device) -> MapSlice:
    """The reference's packed (M, 17) float32 slice (`pack_slice`:
    xyz 0:3, normal 3:6, min 6, max 7, descriptor bytes bitcast into 8:16,
    n_obs 16) -> a MapSlice on `device`."""
    buf = np.ascontiguousarray(buf, dtype=np.float32)
    if buf.ndim != 2 or buf.shape[1] != 17:
        raise ValueError(f"packed slice must be (M, 17), got {buf.shape}")
    desc = np.ascontiguousarray(buf[:, 8:16]).view(np.uint8).reshape(-1, 32)
    t = lambda a: upload(a, device)
    return MapSlice(xyz=t(buf[:, 0:3]), normal=t(buf[:, 3:6]),
                    min_dist=t(buf[:, 6]), max_dist=t(buf[:, 7]),
                    desc=t(desc), n_obs=t(buf[:, 16]))


def pose_from_numpy(R, t, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Host (3, 3) rotation and (3,) translation -> float32 device tensors
    (queued uploads)."""
    return (upload(np.asarray(R, np.float32).reshape(3, 3), device),
            upload(np.asarray(t, np.float32).reshape(3), device))


class _PassResult(NamedTuple):
    res: pose_opt.PoseOptResult
    feat_pt: torch.Tensor   # (N,) int64 slice slot matched to each feature, -1 none
    has: torch.Tensor       # (N,) bool
    ok: torch.Tensor        # (M,) bool frustum test
    n_match: torch.Tensor   # ()


class Pass1(NamedTuple):
    """What the first two segments of the step hand to the third."""

    feats: Features
    xy_un: torch.Tensor
    R_prev: torch.Tensor    # the pose fed in
    t_prev: torch.Tensor
    R0: torch.Tensor        # the motion-model prediction
    t0: torch.Tensor
    R1: torch.Tensor        # pass 1's pose
    t1: torch.Tensor
    n_inl1: torch.Tensor
    n_match1: torch.Tensor
    recover: torch.Tensor   # () bool: n_inl1 < 20, the recovery pass's test


class FusedStep(nn.Module):
    """The per-frame WORKING step for one camera/extractor configuration."""

    def __init__(self, cfg: SlamConfig, n_map: int = MAX_SLICE):
        super().__init__()
        self.cfg = cfg
        self.n_map = n_map
        self.n_levels = cfg.n_levels
        # (level, quota) of every pyramid level the extractor picks from
        self.plan = extractor.level_plan(cfg.n_features, cfg.n_levels, cfg.scale_factor)
        self.has_dist = bool(np.any(cfg.dist4 != 0))
        self.register_buffer("K4", torch.from_numpy(cfg.K4))
        self.register_buffer("dist4", torch.from_numpy(cfg.dist4))
        self.register_buffer("scale_factors", torch.from_numpy(cfg.scale_factors))
        self.register_buffer("inv_sigma2",
                             torch.from_numpy(cfg.inv_sigma2.astype(np.float32)))
        # undistorted image bounds (Frame.cc:321-349)
        corners = torch.tensor(
            [[0, 0], [cfg.width, 0], [0, cfg.height], [cfg.width, cfg.height]],
            dtype=torch.float32)
        und = (undistort_points(corners, self.K4, self.dist4)
               if self.has_dist else corners)
        self.register_buffer("bounds", torch.stack([
            und[:, 0].min(), und[:, 0].max(), und[:, 1].min(), und[:, 1].max()]))

    def _match_pass(self, R, t, slc: MapSlice, valid, feats: Features, xy_un,
                    radius_mult: float, nn_ratio: float, n_rounds: int = 4) -> _PassResult:
        ok, uv, _, view_cos, dist = frustum_check(
            slc.xyz, R, t, self.K4, self.bounds, slc.normal,
            0.8 * slc.min_dist, 1.2 * slc.max_dist)
        ok = ok & valid
        ratio = torch.clamp(slc.max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
        pred = torch.clamp(
            torch.ceil(torch.log(torch.clamp(ratio, min=1e-9))
                       / torch.log(self.scale_factors[1])),
            0, self.n_levels - 1,
        ).to(torch.int32)
        th = torch.where(view_cos > 0.998, 2.5, 4.0) * radius_mult
        m = matching.search_by_projection(
            slc.desc, uv, pred, ok,
            feats.desc, xy_un, feats.level, feats.valid,
            self.scale_factors, th,
            max_dist=100, nn_ratio=nn_ratio, level_window=(-1, 1),
        )
        # scatter matches to features: unmatched rows go to a sink row n
        n = xy_un.shape[0]
        target = torch.where(m.mask, m.idx.to(torch.int64), n)
        feat_pt = torch.full((n + 1,), -1, dtype=torch.int64, device=R.device)
        feat_pt.scatter_(0, target, torch.arange(self.n_map, device=R.device))
        feat_pt = feat_pt[:n]
        has = feat_pt >= 0
        xw = slc.xyz[torch.clamp(feat_pt, 0, self.n_map - 1)]
        w = self.inv_sigma2[torch.clamp(feats.level, 0, self.n_levels - 1).to(torch.int64)]
        res = pose_opt.optimize_pose(R, t, xw, xy_un, w, has, self.K4, n_rounds=n_rounds)
        return _PassResult(res, feat_pt, has, ok, torch.sum(m.mask))

    # -- the step's segments, cut at its two host reads ------------------

    def detect(self, image_u8) -> extractor.Detection:
        """Segment 1: pyramid, FAST and the cell candidates of a (H, W)
        uint8 frame, up to the per-level fast-path flags."""
        cfg = self.cfg
        return extractor.detect(
            image_u8.to(torch.float32), n_features=cfg.n_features, n_levels=cfg.n_levels,
            scale_factor=cfg.scale_factor, fast_th=cfg.fast_threshold,
            fast_min_th=cfg.fast_min_threshold)

    def pick(self, k: int, score, cand, fast_ok: bool):
        """Level k's selection on the path its flag names (the reference's
        `lax.cond(fast_ok, ...)` per level)."""
        return extractor.pick(score, self.plan[k][1], cand, fast_ok)

    def pass1(self, det: extractor.Detection, picks, R_prev, t_prev, vel_R, vel_t,
              has_vel, slc: MapSlice) -> Pass1:
        """Segment 2: descriptors, undistortion, the motion-model prediction
        and pass 1, up to the recovery test."""
        cfg = self.cfg
        feats = extractor.describe(det, picks, n_features=cfg.n_features,
                                   n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
                                   use_harris_score=cfg.use_harris_score)
        xy_un = (undistort_points(feats.xy, self.K4, self.dist4)
                 if self.has_dist else feats.xy)
        valid = slc.max_dist > 0
        # established points: verified by >= 3 keyframes. When the young map
        # has too few of them, pass 1 anchors on everything.
        established = valid & (slc.n_obs >= 3)
        anchor = torch.where(torch.sum(established) >= 100, established, valid)

        # motion-model pose prediction (Tracking.cc:297-310), re-projected
        # onto SO(3) so f32 drift never accumulates across frames
        R0 = orthonormalize(torch.where(has_vel, vel_R @ R_prev, R_prev))
        t0 = torch.where(has_vel, vel_R @ t_prev + vel_t, t_prev)

        # pass 1: wide search under the predicted pose, established anchors
        p1 = self._match_pass(R0, t0, slc, anchor, feats, xy_un,
                              radius_mult=3.0, nn_ratio=0.9, n_rounds=2)
        # the pose fed in, copied: a context rewrites its pose buffers at
        # the end of the step
        return Pass1(feats=feats, xy_un=xy_un, R_prev=R_prev.clone(), t_prev=t_prev.clone(),
                     R0=R0, t0=t0, R1=p1.res.R, t1=p1.res.t, n_inl1=p1.res.n_inliers,
                     n_match1=p1.n_match, recover=p1.res.n_inliers < 20)

    def pass2(self, p: Pass1, slc: MapSlice, recover: bool) -> FusedOut:
        """Segment 3: the recovery pass when `recover` (pass 1 kept fewer
        than 20 inliers), then pass 2 and the step's outputs."""
        valid = slc.max_dist > 0
        n_inl1, R1p, t1p = p.n_inl1, p.R1, p.t1
        # recovery pass (ORBmatcher.cc:1600-1616, TrackPreviousFrame): from
        # the un-predicted previous pose, over every valid point
        if recover:
            rw = self._match_pass(orthonormalize(p.R_prev), p.t_prev, slc, valid,
                                  p.feats, p.xy_un, radius_mult=25.0, nn_ratio=0.9,
                                  n_rounds=2).res
            use_wide = rw.n_inliers > n_inl1
            n_inl1 = torch.where(use_wide, rw.n_inliers, n_inl1)
            R1p = torch.where(use_wide, rw.R, R1p)
            t1p = torch.where(use_wide, rw.t, t1p)
        # accept pass 1 only if it converged on enough inliers
        acc1 = n_inl1 >= 10
        R1 = torch.where(acc1, R1p, p.R0)
        t1 = torch.where(acc1, t1p, p.t0)

        # pass 2: tight search under the refined pose (TrackLocalMap)
        p2 = self._match_pass(R1, t1, slc, valid, p.feats, p.xy_un,
                              radius_mult=1.0, nn_ratio=0.8)
        r2 = p2.res
        inlier = r2.inliers & p2.has
        slot = torch.clamp(p2.feat_pt, 0, self.n_map - 1)
        found = torch.zeros(self.n_map, dtype=torch.int32, device=slot.device)
        found = found.scatter_reduce(0, slot, inlier.to(torch.int32), reduce="amax") > 0
        flags = (p2.ok.to(torch.uint8) * FLAG_VISIBLE) | (found.to(torch.uint8) * FLAG_FOUND)
        feat_bind = torch.where(
            p2.has, p2.feat_pt + torch.where(inlier, BIND_INLIER, 0), -1
        ).to(torch.int32)

        # velocity for the next frame's prediction
        vel_R_new = r2.R @ p.R_prev.T
        vel_t_new = r2.t - vel_R_new @ p.t_prev
        return FusedOut(
            R=r2.R, t=r2.t, vel_R=vel_R_new, vel_t=vel_t_new,
            n_inl2=r2.n_inliers, n_inl1=n_inl1,
            n_match2=p2.n_match, n_match1=p.n_match1,
            feat_bind=feat_bind, flags=flags, feats=p.feats, xy_un=p.xy_un,
            recovered=p.recover,
        )

    def forward(self, image_u8, R_prev, t_prev, vel_R, vel_t, has_vel,
                slc: MapSlice) -> FusedOut:
        """The whole step, eagerly: the three segments with the two host
        reads between them (every level's fast-path flag in one transfer,
        then the recovery test)."""
        det = self.detect(image_u8)
        ok = det.fast_ok.tolist()
        picks = [self.pick(k, s, c, o)
                 for k, (s, c, o) in enumerate(zip(det.scores, det.cands, ok))]
        p = self.pass1(det, picks, R_prev, t_prev, vel_R, vel_t, has_vel, slc)
        return self.pass2(p, slc, bool(p.recover))


class FusedContext:
    """Handle on the device-resident tracking state: pose, motion-model
    velocity and local-map slice, fed forward from one step to the next.

    The state lives in fixed buffers that are written in place, never
    rebound: on a card the step runs as captured programs
    (utils/program.py) that read and write them at fixed addresses. The
    step's segments are programs of their own, cut where the host reads:
    `detect` (the frame copied in), one `pick` per level in its fast and
    slow variants, `pass1`, and `pass2` with and without the recovery pass,
    which ends by writing the new pose and velocity into the state. A frame
    is 3 + (levels) replays, the frame copied in and the outputs copied out;
    `capture` captures every variant ahead of the first frame. `dispatch`
    runs the same graphs as one chain that decides the arms on the device.
    """

    def __init__(self, cfg: SlamConfig, n_map: int = MAX_SLICE, device=None):
        self.cfg = cfg
        self.n_map = n_map
        self.device = dev = resolve_device(device)
        self.step = FusedStep(cfg, n_map).to(dev)
        self.R = torch.eye(3, device=dev)
        self.t = torch.zeros(3, device=dev)
        self.vel_R = torch.eye(3, device=dev)
        self.vel_t = torch.zeros(3, device=dev)
        self.has_vel = torch.zeros((), dtype=torch.bool, device=dev)
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)
        self._slice = MapSlice(xyz=z(n_map, 3), normal=z(n_map, 3), min_dist=z(n_map),
                               max_dist=z(n_map), desc=z(n_map, 32, dt=torch.uint8),
                               n_obs=z(n_map))
        # host flags: the state buffers hold a pose / a slice
        self._has_pose = False
        self._has_slice = False
        # host metadata of the slice rows
        self.slice_ids = np.zeros(0, np.int64)   # map-point slot per row
        self.slice_gen = np.zeros(0, np.int32)   # slot generation at refresh
        # bumped whenever the host overwrites the device-resident pose
        self.epoch = 0
        # the last step's host reads: every level's fast-path flag, pass 1's
        # inlier count (the recovery test)
        self.last_fast_ok = None
        self.last_pass1_inliers = None
        # the step's programs, their graphs kept for dispatch's chain; the
        # picks write one level's selection into fixed buffers, so either
        # variant feeds the same pass-1 program
        self._picks_out = [(z(q, dt=torch.int64), z(q, dt=torch.bool))
                           for _, q in self.step.plan]
        self._detect = Program(lambda v, img: self.step.detect(img), dev, "detect",
                               copy_in=True, keep_graph=True)
        self._pick = [Program(functools.partial(self._pick_into, k), dev, f"pick{k}",
                              keep_graph=True)
                      for k in range(len(self.step.plan))]
        self._pass1 = Program(lambda v, *a: self.step.pass1(*a), dev, "pass1", keep_graph=True)
        self._pass2 = Program(self._finish, dev, "pass2", copy_out=True, keep_graph=True)
        # dispatch's chain of those graphs, and the buffer both arms of the
        # recovery branch copy their packed outputs into: made at the first
        # dispatch on a card
        self._chain = None
        self._chain_out = None

    def _pick_into(self, k, fast_ok, score, cand):
        idx, valid = self.step.pick(k, score, cand, fast_ok)
        self._picks_out[k][0].copy_(idx)
        self._picks_out[k][1].copy_(valid)

    def _finish(self, recover, p, slc, R, t, vel_R, vel_t, has_vel) -> FusedOut:
        out = self.step.pass2(p, slc, recover)
        R.copy_(out.R)
        t.copy_(out.t)
        vel_R.copy_(out.vel_R)
        vel_t.copy_(out.vel_t)
        # the motion model stays off when the settings disable it
        if self.cfg.use_motion_model:
            has_vel.fill_(True)
        return out

    @property
    def ready(self) -> bool:
        return self._has_pose and self._has_slice

    @property
    def slice(self) -> MapSlice | None:
        """The slice buffers, None until a slice is loaded."""
        return self._slice if self._has_slice else None

    def set_pose(self, R, t, velocity=None):
        """(Re)enter the tracking step from a host pose (and velocity)."""
        self.epoch += 1
        for dst, src in zip((self.R, self.t), pose_from_numpy(R, t, self.device)):
            dst.copy_(src)
        if velocity is not None:
            for dst, src in zip((self.vel_R, self.vel_t),
                                pose_from_numpy(*velocity, self.device)):
                dst.copy_(src)
        self.has_vel.fill_(velocity is not None)
        self._has_pose = True

    def clear_velocity(self):
        self.has_vel.fill_(False)

    def load_slice(self, slc: MapSlice):
        """Copy a local-map slice of `n_map` rows into the slice buffers."""
        for name, dst, src in zip(MapSlice._fields, self._slice, slc):
            if src.shape != dst.shape:
                raise ValueError(f"slice {name}: {tuple(src.shape)}, the step holds "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
        self._has_slice = True

    def set_slice(self, packed: np.ndarray):
        """Upload a packed (M, 17) local-map slice."""
        self.load_slice(slice_from_packed(packed, self.device))

    def refresh_slice(self, st, pts: np.ndarray):
        """Build the slice of map points `pts` from the host map (one
        upload)."""
        pts = pts[: self.n_map]
        n_obs = (st.mp_obs_kf[pts] >= 0).sum(axis=1).astype(np.float32)
        self.set_slice(pack_slice(
            st.mp_xyz[pts], st.mp_normal[pts], st.mp_min_dist[pts],
            st.mp_max_dist[pts], st.mp_desc[pts], n_obs, len(pts), self.n_map))
        self.slice_ids = pts.astype(np.int64)
        self.slice_gen = st.mp_gen[pts].copy()

    def invalidate(self):
        self.epoch += 1
        self._has_pose = False
        self._has_slice = False

    def _picks(self, det, ok):
        for k, (prog, score, cand) in enumerate(zip(self._pick, det.scores, det.cands)):
            prog.run(ok[k], score, cand)

    @torch.no_grad()
    def track(self, image_u8) -> FusedOut:
        """Run one step on a (H, W) uint8 frame (host array or tensor), from
        the state buffers, and write the new pose and velocity into them.
        The outputs are copies: the next step does not overwrite them."""
        img = (image_u8 if isinstance(image_u8, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(image_u8)))
        det = self._detect.run(None, img)
        # host read 1: every level's fast-path flag, in one transfer
        self.last_fast_ok = det.fast_ok.tolist()
        self._picks(det, self.last_fast_ok)
        p1 = self._pass1.run(None, det, self._picks_out, self.R, self.t, self.vel_R,
                             self.vel_t, self.has_vel, self._slice)
        # host read 2: the recovery test
        self.last_pass1_inliers = int(p1.n_inl1)
        return self._pass2.run(self.last_pass1_inliers < 20, p1, self._slice, self.R,
                               self.t, self.vel_R, self.vel_t, self.has_vel)

    @torch.no_grad()
    def dispatch(self, image_u8) -> FusedOut:
        """`track` without a host read: on a card the step's graphs run as
        one chain (utils/graph_chain.py) in which the device takes each
        level's pick and the recovery test, so the call only queues work (the
        frame copied in, one launch, the outputs cloned) and never waits.
        The same captured graphs as `track`, so the same bits. On the CPU,
        `track` (a host read there costs no wait)."""
        if self.device.type != "cuda":
            return self.track(image_u8)
        if self._chain is None:
            self._build_chain()
        img = (image_u8 if isinstance(image_u8, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(image_u8)))
        self._detect.stage(img)
        self._chain.launch()
        # the hand-written kernels the chain ran: FAST in `detect`, the pose
        # LM in `pass1` and in pass 2's plain arm (the recovery arm's extra
        # launch is counted when the step's read says it ran:
        # `count_recovery`)
        for cap in (self._detect.captured(None), self._pass1.captured(None),
                    self._pass2.captured(False)):
            for add in cap.launches:
                add(1)
        self.last_fast_ok = self.last_pass1_inliers = None
        buf, layout = self._chain_out
        return unpack(buf.clone(), layout)

    def count_recovery(self):
        """A dispatched step took the recovery pass (`FusedOut.recovered`,
        read with its outputs): count the hand-written kernel launches that
        arm adds to the plain arm's, which `dispatch` counted. It runs the
        plain arm's kernels and the recovery pass's. Nothing where no chain
        ran (on the CPU `dispatch` is `track`, whose programs count their
        own)."""
        if self._chain is None:
            return
        plain, recover = self._pass2.captured(False), self._pass2.captured(True)
        for add in recover.launches[len(plain.launches):]:
            add(1)

    def _build_chain(self):
        from ..utils.graph_chain import Arm, Chain, Link

        if not self._captured():
            self.capture()
        det = self._detect.captured(None)
        p1 = self._pass1.captured(None)
        plain, recover = self._pass2.captured(False), self._pass2.captured(True)
        if plain.packed[1] != recover.packed[1]:
            raise RuntimeError("the two arms of pass 2 pack their outputs differently")
        buf = torch.empty_like(plain.packed[0])
        links = [Link(None, Arm(det.graph))]
        for k, prog in enumerate(self._pick):
            links.append(Link(det.out.fast_ok[k:k + 1], Arm(prog.captured(True).graph),
                              Arm(prog.captured(False).graph)))
        links.append(Link(None, Arm(p1.graph)))
        links.append(Link(p1.out.recover, Arm(recover.graph, (buf, recover.packed[0])),
                          Arm(plain.graph, (buf, plain.packed[0]))))
        self._chain = Chain(links, self.device, name="step")
        self._chain_out = (buf, plain.packed[1])

    def _captured(self) -> bool:
        """Every variant of every program captured (`capture` ran)."""
        return (len(self._detect.variants) == len(self._pass1.variants) == 1
                and len(self._pass2.variants) == 2
                and all(len(p.variants) == 2 for p in self._pick))

    @torch.no_grad()
    def capture(self):
        """Capture every program of the step and every variant (both arms of
        both host tests) ahead of the first frame, as the reference compiles
        its step before live frames. The chain runs on a blank frame; the
        state buffers are put back as they were. On the CPU the programs run
        eagerly and nothing is captured."""
        cfg = self.cfg
        state = (self.R, self.t, self.vel_R, self.vel_t, self.has_vel)
        saved = [x.clone() for x in state]
        det = self._detect.run(
            None, torch.zeros((cfg.height, cfg.width), dtype=torch.uint8))
        for ok in (False, True):
            self._picks(det, [ok] * len(self._pick))
        p1 = self._pass1.run(None, det, self._picks_out, self.R, self.t, self.vel_R,
                             self.vel_t, self.has_vel, self._slice)
        for recover in (False, True):
            self._pass2.capture(recover, p1, self._slice, *state)
        for dst, src in zip(state, saved):
            dst.copy_(src)

    @property
    def programs(self) -> list:
        """Every program of the step, in the order a frame runs them."""
        return [self._detect, *self._pick, self._pass1, self._pass2]
