"""Fixed-capacity struct-of-arrays map state and its updates (counterpart
of orbslam_jpminipc_tpu/map/map_state.py).

Dense, padded numpy arrays with validity masks instead of heap objects;
slot allocation through free lists. The host mutates the arrays (cheap,
sequential bookkeeping); the covisibility product and the point-attribute
refresh (distinctive descriptor, viewing normal, scale band) run as torch
programs, on the card when the map lives beside one.

Replaces: src/Map.cc, src/MapPoint.cc (observations, distinctive
descriptor, normal/depth, visible/found counters) and src/KeyFrame.cc
(pose + feature arrays + map-point slots + covisibility + spanning tree).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.host import fetch_async


@dataclasses.dataclass
class MapState:
    """Host-resident map. All arrays are preallocated at fixed capacity."""

    max_kf: int
    max_mp: int
    n_feat: int
    max_obs: int

    # --- keyframes ---
    kf_R: np.ndarray          # (MAX_KF, 3, 3) world->cam
    kf_t: np.ndarray          # (MAX_KF, 3)
    kf_valid: np.ndarray      # (MAX_KF,) bool
    kf_frame_id: np.ndarray   # (MAX_KF,) int64 — source frame id
    kf_timestamp: np.ndarray  # (MAX_KF,) float64
    kf_xy: np.ndarray         # (MAX_KF, N_FEAT, 2) float32 undistorted kp
    kf_level: np.ndarray      # (MAX_KF, N_FEAT) int32
    kf_angle: np.ndarray      # (MAX_KF, N_FEAT) float32
    kf_desc: np.ndarray       # (MAX_KF, N_FEAT, 32) uint8
    kf_feat_valid: np.ndarray # (MAX_KF, N_FEAT) bool
    kf_point: np.ndarray      # (MAX_KF, N_FEAT) int32 — map point slot or -1
    kf_parent: np.ndarray     # (MAX_KF,) int32 — spanning tree parent or -1
    kf_loop_edges: list       # list[set[int]] — loop edge sets per KF

    # --- map points ---
    mp_xyz: np.ndarray        # (MAX_MP, 3) float32
    mp_valid: np.ndarray      # (MAX_MP,) bool
    mp_desc: np.ndarray       # (MAX_MP, 32) uint8 — distinctive descriptor
    mp_normal: np.ndarray     # (MAX_MP, 3) float32
    mp_min_dist: np.ndarray   # (MAX_MP,) float32
    mp_max_dist: np.ndarray   # (MAX_MP,) float32
    mp_ref_kf: np.ndarray     # (MAX_MP,) int32
    mp_first_kf: np.ndarray   # (MAX_MP,) int32 — KF id at creation (culling)
    mp_visible: np.ndarray    # (MAX_MP,) int32
    mp_found: np.ndarray      # (MAX_MP,) int32
    mp_obs_kf: np.ndarray     # (MAX_MP, MAX_OBS) int32 — observing KF or -1
    mp_obs_feat: np.ndarray   # (MAX_MP, MAX_OBS) int32 — feature index in KF
    mp_gen: np.ndarray        # (MAX_MP,) int32 — slot generation; bumped on
                              # erase so stale references (e.g. the tracker's
                              # last-frame associations) can be detected
                              # instead of silently binding to a slot's new
                              # occupant after culling recycles it

    next_kf_id: int = 0       # monotously increasing creation counter
    next_mp_id: int = 0
    # cached covisibility matrix; None = stale. Every observation-topology
    # mutation (add/remove/replace observation, KF insert/erase) invalidates
    # it, so tracking frames between keyframes reuse one matrix instead of
    # paying the product per frame.
    _covis_cache: np.ndarray | None = None
    # the device of the system this map belongs to: the map's arrays are
    # host numpy, its programs run over the DeviceMap's tensors there
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))

    @staticmethod
    def create(max_kf: int = 256, max_mp: int = 16384, n_feat: int = 1024, max_obs: int = 32,
               device=None) -> "MapState":
        z = np.zeros
        return MapState(
            max_kf=max_kf, max_mp=max_mp, n_feat=n_feat, max_obs=max_obs,
            device=resolve_device(device),
            kf_R=np.tile(np.eye(3, dtype=np.float32), (max_kf, 1, 1)),
            kf_t=z((max_kf, 3), np.float32),
            kf_valid=z(max_kf, bool),
            kf_frame_id=z(max_kf, np.int64),
            kf_timestamp=z(max_kf, np.float64),
            kf_xy=z((max_kf, n_feat, 2), np.float32),
            kf_level=z((max_kf, n_feat), np.int32),
            kf_angle=z((max_kf, n_feat), np.float32),
            kf_desc=z((max_kf, n_feat, 32), np.uint8),
            kf_feat_valid=z((max_kf, n_feat), bool),
            kf_point=np.full((max_kf, n_feat), -1, np.int32),
            kf_parent=np.full(max_kf, -1, np.int32),
            kf_loop_edges=[set() for _ in range(max_kf)],
            mp_xyz=z((max_mp, 3), np.float32),
            mp_valid=z(max_mp, bool),
            mp_desc=z((max_mp, 32), np.uint8),
            mp_normal=z((max_mp, 3), np.float32),
            mp_min_dist=z(max_mp, np.float32),
            mp_max_dist=np.full(max_mp, np.inf, np.float32),
            mp_ref_kf=np.full(max_mp, -1, np.int32),
            mp_first_kf=np.full(max_mp, -1, np.int32),
            mp_visible=np.ones(max_mp, np.int32),
            mp_found=np.ones(max_mp, np.int32),
            mp_obs_kf=np.full((max_mp, max_obs), -1, np.int32),
            mp_obs_feat=np.full((max_mp, max_obs), -1, np.int32),
            mp_gen=np.zeros(max_mp, np.int32),
        )

    # ------------------------------------------------------------------
    # slot allocation
    # ------------------------------------------------------------------

    def alloc_kf(self) -> int:
        """Allocate a keyframe slot; -1 when full (graceful degradation:
        the caller refuses the insertion and the system keeps tracking
        against the existing map — the reference runs indefinitely because
        culling bounds growth, LocalMapping.cc:546-600; at a fixed capacity
        the same culling usually frees slots before this triggers)."""
        free = np.nonzero(~self.kf_valid)[0]
        if len(free) == 0:
            return -1
        return int(free[0])

    def alloc_mps(self, n: int) -> np.ndarray:
        """Allocate up to n point slots; may return fewer (or none) when
        the map is at capacity — callers create what fits."""
        free = np.nonzero(~self.mp_valid)[0]
        return free[:n]

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------

    def add_keyframe(self, R, t, xy, level, angle, desc, feat_valid,
                     frame_id=0, timestamp=0.0) -> int:
        k = self.alloc_kf()
        if k < 0:
            return -1
        n = len(feat_valid)  # frames may carry fewer features than capacity
        assert n <= self.n_feat, (n, self.n_feat)
        self.kf_R[k] = R
        self.kf_t[k] = t
        self.kf_xy[k] = 0
        self.kf_xy[k, :n] = xy
        self.kf_level[k] = 0
        self.kf_level[k, :n] = level
        self.kf_angle[k] = 0
        self.kf_angle[k, :n] = angle
        self.kf_desc[k] = 0
        self.kf_desc[k, :n] = desc
        self.kf_feat_valid[k] = False
        self.kf_feat_valid[k, :n] = feat_valid
        self.kf_point[k] = -1
        self.kf_valid[k] = True
        self.kf_frame_id[k] = frame_id
        self.kf_timestamp[k] = timestamp
        self.kf_parent[k] = -1
        self.kf_loop_edges[k] = set()
        self.next_kf_id += 1
        self._covis_cache = None
        return k

    def erase_keyframe(self, k: int):
        """KeyFrame::SetBadFlag (KeyFrame.cc:474-588): remove observations,
        then iteratively re-bind each spanning-tree child to its strongest
        covisible keyframe among the growing candidate set (parent first,
        then already re-bound siblings); unbindable children inherit the
        grandparent (KeyFrame.cc:580-586)."""
        feats = np.nonzero(self.kf_point[k] >= 0)[0]
        for f in feats:
            self.remove_observation(int(self.kf_point[k, f]), k)
        self.kf_valid[k] = False
        self.kf_point[k] = -1
        self.kf_feat_valid[k] = False
        self._covis_cache = None
        self._reparent_children(k)

    def _covis_weight(self, a: int, b: int) -> int:
        """Shared valid map point count between two keyframes."""
        pa = self.kf_point[a]
        pb = self.kf_point[b]
        sa = pa[(pa >= 0)]
        sb = pb[(pb >= 0)]
        return len(np.intersect1d(sa, sb))

    def _reparent_children(self, k: int, min_weight: int = 15):
        """Strongest-covisible child re-binding (KeyFrame.cc:497-588).
        Candidates start as {parent}; each round binds the (child,
        candidate) pair with the globally largest covisibility weight and
        promotes the child to a candidate; leftovers get the grandparent."""
        parent = int(self.kf_parent[k])
        children = {int(c) for c in np.nonzero(self.kf_parent == k)[0]}
        candidates = {parent} if parent >= 0 and self.kf_valid[parent] else set()
        while children and candidates:
            best_w, best_c, best_p = min_weight - 1, -1, -1
            for c in children:
                for p in candidates:
                    w = self._covis_weight(c, p)
                    if w > best_w:
                        best_w, best_c, best_p = w, c, p
            if best_c < 0:
                break
            self.kf_parent[best_c] = best_p
            candidates.add(best_c)
            children.remove(best_c)
        for c in children:
            self.kf_parent[c] = parent
        self.kf_parent[k] = -1

    # ------------------------------------------------------------------
    # map points / observations
    # ------------------------------------------------------------------

    def add_points(self, xyz, desc, ref_kf: int, first_kf_id=None) -> np.ndarray:
        ids = self.alloc_mps(len(xyz))
        xyz = np.asarray(xyz)[: len(ids)]
        desc = np.asarray(desc)[: len(ids)]
        self.mp_xyz[ids] = xyz
        self.mp_desc[ids] = desc
        self.mp_ref_kf[ids] = ref_kf
        self.mp_first_kf[ids] = self.next_kf_id - 1 if first_kf_id is None else first_kf_id
        self.mp_valid[ids] = True
        self.mp_visible[ids] = 1
        self.mp_found[ids] = 1
        self.mp_obs_kf[ids] = -1
        self.mp_obs_feat[ids] = -1
        self.mp_normal[ids] = 0
        self.mp_min_dist[ids] = 0
        self.mp_max_dist[ids] = np.inf
        self.next_mp_id += len(ids)
        return ids

    def add_observation(self, mp: int, kf: int, feat: int) -> bool:
        """Link point<->keyframe (MapPoint::AddObservation + KeyFrame::
        AddMapPoint). Returns False if the adjacency row is full."""
        slots = self.mp_obs_kf[mp]
        if (slots == kf).any():
            return True
        empty = np.nonzero(slots < 0)[0]
        if len(empty) == 0:
            return False
        self.mp_obs_kf[mp, empty[0]] = kf
        self.mp_obs_feat[mp, empty[0]] = feat
        self.kf_point[kf, feat] = mp
        self._covis_cache = None
        return True

    def remove_observation(self, mp: int, kf: int):
        slots = np.nonzero(self.mp_obs_kf[mp] == kf)[0]
        for s in slots:
            feat = int(self.mp_obs_feat[mp, s])
            if feat >= 0 and self.kf_point[kf, feat] == mp:
                self.kf_point[kf, feat] = -1
            self.mp_obs_kf[mp, s] = -1
            self.mp_obs_feat[mp, s] = -1
        self._covis_cache = None
        # a monocular point needs >= 2 observations to stay alive
        if self.n_observations(mp) < 2:
            self.erase_point(mp)

    def n_observations(self, mp: int) -> int:
        return int((self.mp_obs_kf[mp] >= 0).sum())

    def erase_point(self, mp: int):
        """MapPoint::SetBadFlag: unlink from all keyframes."""
        for s in np.nonzero(self.mp_obs_kf[mp] >= 0)[0]:
            kf = int(self.mp_obs_kf[mp, s])
            feat = int(self.mp_obs_feat[mp, s])
            if self.kf_point[kf, feat] == mp:
                self.kf_point[kf, feat] = -1
        self.mp_obs_kf[mp] = -1
        self.mp_obs_feat[mp] = -1
        self.mp_valid[mp] = False
        self.mp_gen[mp] += 1
        self._covis_cache = None

    def replace_point(self, mp: int, other: int):
        """MapPoint::Replace (MapPoint.cc:124-158): merge mp into other."""
        if mp == other:
            return
        for s in np.nonzero(self.mp_obs_kf[mp] >= 0)[0]:
            kf = int(self.mp_obs_kf[mp, s])
            feat = int(self.mp_obs_feat[mp, s])
            if (self.mp_obs_kf[other] == kf).any():
                # other already observed in kf: drop this slot
                if self.kf_point[kf, feat] == mp:
                    self.kf_point[kf, feat] = -1
            else:
                self.kf_point[kf, feat] = other
                empty = np.nonzero(self.mp_obs_kf[other] < 0)[0]
                if len(empty):
                    self.mp_obs_kf[other, empty[0]] = kf
                    self.mp_obs_feat[other, empty[0]] = feat
        self.mp_found[other] += self.mp_found[mp]
        self.mp_visible[other] += self.mp_visible[mp]
        self.mp_obs_kf[mp] = -1
        self.mp_obs_feat[mp] = -1
        self.mp_valid[mp] = False
        self._covis_cache = None

    # ------------------------------------------------------------------
    # derived structures
    # ------------------------------------------------------------------

    def membership_matrix(self) -> np.ndarray:
        """(MAX_KF, MAX_MP) bool: KF k observes point p."""
        M = np.zeros((self.max_kf, self.max_mp), bool)
        kf_idx = np.repeat(np.arange(self.max_kf), self.n_feat).reshape(self.max_kf, self.n_feat)
        pts = self.kf_point
        sel = pts >= 0
        M[kf_idx[sel], pts[sel]] = True
        return M

    def covisibility(self) -> np.ndarray:
        """(MAX_KF, MAX_KF) int32 shared-point counts.

        Cached until the observation topology changes: tracking queries this
        every frame, but it only changes per keyframe event. Computed as one
        host BLAS matmul over the valid-KF membership submatrix, as the
        reference does: graph bookkeeping is latency-bound, and a device
        product would queue behind whatever mapping program is in flight
        and make its caller wait for it. Exact: every sum is an integer
        below 2^24."""
        if self._covis_cache is not None:
            return self._covis_cache
        C = np.zeros((self.max_kf, self.max_kf), np.int32)
        valid = np.nonzero(self.kf_valid)[0]
        if len(valid):
            M = np.zeros((len(valid), self.max_mp), np.float32)
            pts = self.kf_point[valid]
            sel = pts >= 0
            rows = np.broadcast_to(np.arange(len(valid))[:, None], pts.shape)
            M[rows[sel], pts[sel]] = 1.0
            C[np.ix_(valid, valid)] = (M @ M.T).astype(np.int32)
        self._covis_cache = C
        return C

    def update_spanning_tree(self, k: int, covis_row: np.ndarray):
        """Parent = strongest covisible existing KF (KeyFrame.cc:413-418)."""
        cand = covis_row.copy()
        cand[k] = 0
        cand[~self.kf_valid] = 0
        if cand.max() > 0:
            self.kf_parent[k] = int(cand.argmax())

    def update_point_attributes(self, ids: np.ndarray, scale_factors: np.ndarray, dmap):
        """Recompute distinctive descriptor + normal + depth band for the
        given points (MapPoint::ComputeDistinctiveDescriptors :185-250 and
        UpdateNormalAndDepth :273-312), batched."""
        pending = self.update_point_attributes_async(ids, scale_factors, dmap)
        if pending is not None:
            self.apply_point_attributes(pending)

    def update_point_attributes_async(self, ids, scale_factors, dmap):
        """Launch the attrs computation; returns a pending handle for
        apply_point_attributes (the device works while the host goes on).
        The observation operands are gathered on the DeviceMap's device
        (the upload is index lists)."""
        from .device_map import attrs_kernel, size_bucket

        if len(ids) == 0:
            return None
        n_real = len(ids)
        # the reference pads to coarse size buckets (one XLA program each,
        # one captured program each here); the pad rows repeat ids[0] and
        # their outputs are dropped, so the same padding keeps the batch's
        # arithmetic identical
        ids = np.concatenate([ids, np.full(size_bucket(n_real) - n_real, ids[0], ids.dtype)])
        obs_kf = self.mp_obs_kf[ids]
        obs_feat = np.clip(self.mp_obs_feat[ids], 0, self.n_feat - 1)
        ref_slot = np.argmax(obs_kf == self.mp_ref_kf[ids][:, None], axis=1)
        outs = attrs_kernel(dmap, obs_kf, obs_feat, self.mp_xyz[ids], ref_slot, scale_factors)
        # the read is queued now: whoever applies it may ask `done()` first
        return ids[:n_real], self.mp_gen[ids[:n_real]].copy(), fetch_async(*outs)

    def apply_point_attributes(self, pending):
        """Read back and write an attrs computation. Generation-checked:
        points culled between launch and apply are skipped."""
        if pending is None:
            return np.zeros(0, np.int64)
        ids, gens, outs = pending
        desc, normal, dmin, dmax = outs.result()
        n_real = len(ids)
        fresh = self.mp_gen[ids] == gens
        ids = ids[fresh]
        self.mp_desc[ids] = desc[:n_real][fresh]
        self.mp_normal[ids] = normal[:n_real][fresh]
        self.mp_min_dist[ids] = dmin[:n_real][fresh]
        self.mp_max_dist[ids] = dmax[:n_real][fresh]
        return ids


def attrs_math(descs, valid, xyz, centers, levels, ref_slot, scale_factors):
    """Batched distinctive-descriptor + normal/depth computation.

    descs: (n, O, 32) uint8; valid: (n, O); xyz: (n, 3); centers: (n, O, 3)
    camera centers; levels: (n, O); ref_slot: (n,) index of the reference
    KF's observation slot. Returns (desc, normal, dmin, dmax).
    """
    from ..ops.hamming import unpack_bits

    n, O, _ = descs.shape
    bits = unpack_bits(descs).to(torch.float32)                  # (n, O, 256)
    dots = torch.einsum("nob,npb->nop", bits, bits)
    pc = bits.sum(dim=-1).to(torch.int32)
    ham = pc[:, :, None] + pc[:, None, :] - 2 * dots.to(torch.int32)
    pair_ok = valid[:, :, None] & valid[:, None, :]
    ham = torch.where(pair_ok, ham, 1 << 20)
    # median distance to the others, per candidate; the smallest median
    # wins, the lowest slot on ties (MapPoint.cc:228-248)
    ham_sorted = torch.sort(ham, dim=-1).values
    n_valid = valid.sum(dim=-1)
    med_idx = torch.clamp((n_valid[:, None] - 1) // 2, 0, O - 1).expand(n, O)
    median = torch.take_along_dim(ham_sorted, med_idx[..., None], dim=-1)[..., 0]
    median = torch.where(valid, median, 1 << 20)
    best = torch.argmin(median, dim=-1)
    desc = descs[torch.arange(n, device=descs.device), best]

    # viewing normal: mean unit camera->point direction (MapPoint.cc:273-312)
    d = xyz[:, None, :] - centers
    dist = torch.linalg.norm(d, dim=-1)
    unit = d / torch.clamp(dist[..., None], min=1e-12)
    normal = torch.where(valid[..., None], unit, 0.0).sum(dim=1)
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-12)

    # scale band from the reference observation (MapPoint.cc:300-311)
    ref = ref_slot.to(torch.int64)[:, None]
    ref_dist = torch.take_along_dim(dist, ref, dim=1)[:, 0]
    ref_level = torch.take_along_dim(levels, ref, dim=1)[:, 0]
    n_levels = scale_factors.shape[0]
    level_factor = scale_factors[torch.clamp(ref_level, 0, n_levels - 1).to(torch.int64)]
    dmax = ref_dist * level_factor
    dmin = dmax / scale_factors[n_levels - 1]
    return desc, normal, dmin, dmax
