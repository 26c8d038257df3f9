"""Device-resident mirror of the map arrays + the mapping-stage kernels
(counterpart of orbslam_jpminipc_tpu/map/device_map.py).

The mapping stages (triangulation, fusion, local BA, the attrs pass, the
tracker's slice refresh) read large slices of the keyframe and point
arrays, which barely change between calls: a keyframe's features never
change after insertion, poses change at BA events, and point rows change
only for the touched ids. So the mirror keeps them resident on its device
and each stage gathers its operands there from indices sent by the host.

The stage functions are plain torch programs over the mirror. Where the
reference maps a per-target function with `jax.vmap`, the targets here are
a leading batch dimension of the same tensors. `mirror_call`/`packed_call`
(the reference's transfer batching for the TPU link) are not needed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..frontend.fused_track import MapSlice
from ..geometry import epipolar, triangulate
from ..ops import matching
from ..solvers import ba
from ..utils.device import resolve_device
from ..utils.host import host_tensor, upload
from ..utils.program import Program

TRI_CANDS = 512   # per-neighbor triangulation candidate capacity
FUSE_CANDS = 256  # per-target fuse match capacity


class DeviceMap:
    """The map mirror on `device`."""

    def __init__(self, max_kf: int, n_feat: int, max_mp: int, device=None):
        self.max_kf = max_kf
        self.n_feat = n_feat
        self.max_mp = max_mp
        self.device = resolve_device(device)
        # bumped on every sync; the tracker's slice refresh skips rebuilding
        # when nothing changed
        self.version = 0
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=self.device)
        self.kf_desc = z(max_kf, n_feat, 32, dt=torch.uint8)
        self.kf_xy = z(max_kf, n_feat, 2)
        self.kf_angle = z(max_kf, n_feat)
        self.kf_level = z(max_kf, n_feat, dt=torch.int32)
        self.kf_feat_valid = z(max_kf, n_feat, dt=torch.bool)
        self.kf_R = torch.eye(3, device=self.device).repeat(max_kf, 1, 1)
        self.kf_t = z(max_kf, 3)
        self.mp_xyz = z(max_mp, 3)
        self.mp_desc = z(max_mp, 32, dt=torch.uint8)
        self.mp_normal = z(max_mp, 3)
        self.mp_min_dist = z(max_mp)
        self.mp_max_dist = z(max_mp)
        self.mp_valid = z(max_mp, dt=torch.bool)

    def put(self, a) -> torch.Tensor:
        """A host array as a tensor on the mirror's device (int64 indices
        stay int64; float64 becomes float32), staged in pinned memory and
        queued behind the stream's work (`utils.host.upload`): a plain
        `.to(device)` of pageable memory waits for the stream to drain,
        which would make every upload of a mapping stage wait for the
        programs in flight."""
        return upload(host_tensor(a), self.device)

    # --- host -> device sync ------------------------------------------

    def sync_keyframe(self, st, k: int):
        """Upload one keyframe's immutable feature row + all poses."""
        self.version += 1
        k = int(k)
        self.kf_desc[k] = self.put(st.kf_desc[k])
        self.kf_xy[k] = self.put(st.kf_xy[k])
        self.kf_angle[k] = self.put(st.kf_angle[k])
        self.kf_level[k] = self.put(st.kf_level[k])
        self.kf_feat_valid[k] = self.put(st.kf_feat_valid[k])
        self.sync_poses(st)

    def sync_poses(self, st):
        """Upload ALL keyframe poses — after BA / corrections."""
        self.version += 1
        self.kf_R = self.put(st.kf_R)
        self.kf_t = self.put(st.kf_t)

    def sync_points(self, st, ids: np.ndarray):
        """Upload the touched point rows."""
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[(ids >= 0) & (ids < self.max_mp)]
        if len(ids) == 0:
            return
        self.version += 1
        i = self.put(ids)
        self.mp_xyz[i] = self.put(st.mp_xyz[ids].astype(np.float32))
        self.mp_desc[i] = self.put(st.mp_desc[ids])
        self.mp_normal[i] = self.put(st.mp_normal[ids].astype(np.float32))
        self.mp_min_dist[i] = self.put(st.mp_min_dist[ids].astype(np.float32))
        maxd = st.mp_max_dist[ids]
        self.mp_max_dist[i] = self.put(np.where(np.isfinite(maxd), maxd, 0.0).astype(np.float32))
        self.mp_valid[i] = self.put(st.mp_valid[ids])

    def sync_all(self, st):
        """Full refresh — after loop corrections / global BA / reset."""
        self.version += 1
        self.kf_desc = self.put(st.kf_desc)
        self.kf_xy = self.put(st.kf_xy)
        self.kf_angle = self.put(st.kf_angle)
        self.kf_level = self.put(st.kf_level)
        self.kf_feat_valid = self.put(st.kf_feat_valid)
        self.sync_poses(st)
        self.mp_xyz = self.put(st.mp_xyz)
        self.mp_desc = self.put(st.mp_desc)
        self.mp_normal = self.put(st.mp_normal)
        self.mp_min_dist = self.put(st.mp_min_dist)
        self.mp_max_dist = self.put(
            np.where(np.isfinite(st.mp_max_dist), st.mp_max_dist, 0.0).astype(np.float32))
        self.mp_valid = self.put(st.mp_valid)


def _compact(ok: torch.Tensor, cap: int) -> torch.Tensor:
    """Per row, the indices of the True entries first, in order (a stable
    sort on ~ok), cut to `cap`: the host merge claims in this order."""
    return torch.sort((~ok).to(torch.int8), dim=-1, stable=True).indices[..., :cap]


def fuse_kernel(dm: DeviceMap, q_point, q_row_valid, dst_idx, K4, scale_factors):
    """Batched ORBmatcher::Fuse (ORBmatcher.cc:1016-1134) over the mirror.

    q_point: (T, F) map-point slot per query-row feature (-1 none);
    q_row_valid: (T, F) bool; dst_idx: (T,) target keyframe per row.
    Returns (cnt (T,), source feature (T, FUSE_CANDS), target feature
    (T, FUSE_CANDS)); entries past cnt are padding."""
    q_point = dm.put(q_point).to(torch.int64)
    dst = dm.put(dst_idx).to(torch.int64)
    K4 = dm.put(K4)
    sf = dm.put(scale_factors)
    qid = torch.clamp(q_point, 0, dm.max_mp - 1)
    q_valid = (q_point >= 0) & dm.mp_valid[qid] & dm.put(q_row_valid)
    qx = dm.mp_xyz[qid]
    qmin = dm.mp_min_dist[qid]
    qmax = dm.mp_max_dist[qid]
    R = dm.kf_R[dst]
    t = dm.kf_t[dst]

    xc = qx @ R.transpose(-1, -2) + t[:, None]
    z = xc[..., 2]
    uv = torch.stack([
        K4[0] * xc[..., 0] / torch.clamp(z, min=1e-9) + K4[2],
        K4[1] * xc[..., 1] / torch.clamp(z, min=1e-9) + K4[3],
    ], dim=-1)
    O = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    dist = torch.linalg.norm(qx - O[:, None], dim=-1)
    valid = q_valid & (z > 0)
    valid &= (dist >= 0.8 * qmin) & (dist <= 1.2 * qmax)
    ratio = torch.clamp(qmax, min=1e-9) / torch.clamp(dist, min=1e-9)
    pred = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / torch.log(sf[1]))
    pred = torch.clamp(pred, 0, sf.shape[0] - 1).to(torch.int32)
    m = matching.fuse_search(
        dm.mp_desc[qid], uv, pred, valid,
        dm.kf_desc[dst], dm.kf_xy[dst], dm.kf_level[dst], dm.kf_feat_valid[dst], sf)
    order = _compact(m.mask, FUSE_CANDS)
    cnt = m.mask.sum(dim=-1, dtype=torch.int32)
    return cnt, order, torch.take_along_dim(m.idx, order, dim=-1)


def tri_kernel(dm: DeviceMap, kf1, sel, has1, has2, valid2_extra, K4, sigma2, scale_factors):
    """CreateNewMapPoints' epipolar search + DLT + validity gates
    (LocalMapping.cc:227-393) of keyframe `kf1` against the B neighbors
    `sel`. Returns per neighbor (cnt (B,), feature in kf1 (B, TRI_CANDS),
    feature in the neighbor (B, TRI_CANDS), point (B, TRI_CANDS, 3)),
    candidates in feature order; entries past cnt are padding."""
    k1 = int(kf1)
    sel = dm.put(sel).to(torch.int64)
    K4 = dm.put(K4)
    sigma2 = dm.put(sigma2)
    sf = dm.put(scale_factors)
    desc1, xy1 = dm.kf_desc[k1], dm.kf_xy[k1]
    angle1, level1, valid1 = dm.kf_angle[k1], dm.kf_level[k1], dm.kf_feat_valid[k1]
    R1, t1 = dm.kf_R[k1], dm.kf_t[k1]
    xy2, level2 = dm.kf_xy[sel], dm.kf_level[sel]
    valid2 = dm.kf_feat_valid[sel] & dm.put(valid2_extra)
    R2, t2 = dm.kf_R[sel], dm.kf_t[sel]

    O1 = -(R1.T @ t1)
    ratio_factor = 1.5 * sf[1]
    n_levels = sigma2.shape[0]
    F12 = epipolar.fundamental_from_poses(R1, t1, R2, t2, K4)        # (B, 3, 3)
    O2 = -(R2.transpose(-1, -2) @ t2[..., None])[..., 0]             # (B, 3)
    xc_e = (R2 @ O1) + t2
    ep = torch.stack([
        K4[0] * xc_e[:, 0] / torch.clamp(xc_e[:, 2], min=1e-9) + K4[2],
        K4[1] * xc_e[:, 1] / torch.clamp(xc_e[:, 2], min=1e-9) + K4[3],
    ], dim=-1)
    m = matching.search_for_triangulation(
        desc1, xy1, angle1, level1, dm.put(has1), valid1,
        dm.kf_desc[sel], xy2, dm.kf_angle[sel], level2, dm.put(has2), valid2,
        F12, sigma2, ep, sf)
    idx = m.idx.to(torch.int64)
    uv2 = torch.take_along_dim(xy2, idx[..., None], dim=1)
    P1 = triangulate.projection_matrix(R1, t1, K4)
    P2 = triangulate.projection_matrix(R2, t2, K4)[:, None]
    xw, ok_dlt = triangulate.triangulate_dlt(xy1, uv2, P1, P2)       # (B, F, 3)
    ok = m.mask & ok_dlt
    e1, pos1 = triangulate.reprojection_error2(xw, xy1, R1, t1, K4)
    e2, pos2 = triangulate.reprojection_error2(xw, uv2, R2[:, None], t2[:, None], K4)
    ok &= pos1 & pos2
    ok &= triangulate.parallax_cos(xw, O1, O2[:, None]) < 0.9998
    lv1 = torch.clamp(level1, 0, n_levels - 1).to(torch.int64)
    lv2 = torch.clamp(torch.take_along_dim(level2, idx, dim=1), 0, n_levels - 1).to(torch.int64)
    ok &= (e1 < 5.991 * sigma2[lv1]) & (e2 < 5.991 * sigma2[lv2])
    d1 = torch.linalg.norm(xw - O1, dim=-1)
    d2 = torch.linalg.norm(xw - O2[:, None], dim=-1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_octave = sf[lv1] / sf[lv2]
    ok &= (ratio_dist < ratio_octave * ratio_factor) & (ratio_dist * ratio_factor > ratio_octave)
    order = _compact(ok, TRI_CANDS)
    return (ok.sum(dim=-1, dtype=torch.int32), order,
            torch.take_along_dim(m.idx, order, dim=-1),
            torch.take_along_dim(xw, order[..., None], dim=1))


def local_ba_program(device) -> Program:
    """A local-BA LM stage as a captured program, one variant per
    iteration count (the reference jits its local BA per static schedule):
    the problem is copied into the program's buffers at the mapper's fixed
    capacities, and the result copied out."""
    return Program(lambda iterations, prob: ba.bundle_adjust(prob, iterations=iterations),
                   resolve_device(device), "local_ba", copy_in=True, copy_out=True)


def local_ba_kernel(dm: DeviceMap, kf_R, kf_t, kf_fixed, points, point_valid,
                    obs_kf, obs_pt, obs_feat, obs_src_kf, obs_valid, K4, inv_sigma2,
                    iterations: int = 5, program: Program | None = None) -> ba.BAResult:
    """ONE local-BA LM stage with observation pixels and weights gathered
    from the mirror (obs_uv = kf_xy[src_kf, feat]). The reference's
    5 -> erase -> 10 schedule (Optimizer.cc:450-494) runs as two calls with
    the host erase between them. Pose and point arguments may be host
    arrays or tensors already on the device (a first stage's result). The
    uploads and gathers run first; the LM itself runs as `program`
    (`local_ba_program`) when given, else eagerly."""
    put = lambda a: a if isinstance(a, torch.Tensor) else dm.put(a)
    src = dm.put(obs_src_kf).to(torch.int64)
    feat = dm.put(obs_feat).to(torch.int64)
    inv_sigma2 = dm.put(inv_sigma2)
    lv = torch.clamp(dm.kf_level[src, feat], 0, inv_sigma2.shape[0] - 1).to(torch.int64)
    prob = ba.BAProblem(
        kf_R=put(kf_R), kf_t=put(kf_t), kf_fixed=put(kf_fixed),
        points=put(points), point_valid=put(point_valid),
        obs_kf=dm.put(obs_kf).to(torch.int64), obs_pt=dm.put(obs_pt).to(torch.int64),
        obs_uv=dm.kf_xy[src, feat], obs_w=inv_sigma2[lv],
        obs_valid=put(obs_valid), K4=dm.put(K4),
    )
    if program is not None:
        return program.run(iterations, prob)
    return ba.bundle_adjust(prob, iterations=iterations)


def attrs_kernel(dm: DeviceMap, obs_kf, obs_feat, xyz, ref_slot, scale_factors):
    """Point-attribute refresh with the observations gathered from the
    mirror (MapPoint::ComputeDistinctiveDescriptors + UpdateNormalAndDepth,
    MapPoint.cc:185-312). Returns (desc, normal, dmin, dmax) tensors."""
    from .map_state import attrs_math

    obs_kf = dm.put(obs_kf).to(torch.int64)
    obs_feat = dm.put(obs_feat).to(torch.int64)
    valid = obs_kf >= 0
    kf_safe = torch.clamp(obs_kf, 0, dm.max_kf - 1)
    R = dm.kf_R[kf_safe]                               # (n, O, 3, 3)
    t = dm.kf_t[kf_safe]
    centers = -torch.einsum("noji,noj->noi", R, t)
    return attrs_math(dm.kf_desc[kf_safe, obs_feat], valid, dm.put(xyz), centers,
                      dm.kf_level[kf_safe, obs_feat], dm.put(ref_slot),
                      dm.put(scale_factors))


def slice_kernel(dm: DeviceMap, ids, row_valid, n_obs) -> MapSlice:
    """The fused tracker's local-map slice, gathered on the device from the
    mirror. Rows that are not valid get max_dist = 0."""
    mid = torch.clamp(dm.put(ids).to(torch.int64), 0, dm.max_mp - 1)
    valid = dm.put(row_valid) & dm.mp_valid[mid]
    maxd = torch.where(valid, torch.clamp(dm.mp_max_dist[mid], min=1e-6), 0.0)
    return MapSlice(xyz=dm.mp_xyz[mid], normal=dm.mp_normal[mid],
                    min_dist=dm.mp_min_dist[mid], max_dist=maxd,
                    desc=dm.mp_desc[mid], n_obs=dm.put(n_obs))


def map_from_snapshot(snap, device=None):
    """A port MapState and a synced DeviceMap from a snapshot of a
    reference map: any object or dict with the MapState fields as numpy
    arrays (a JAX `MapState` itself, or `dataclasses.asdict` of one)."""
    import dataclasses

    from .map_state import MapState

    device = resolve_device(device)
    get = (snap.get if isinstance(snap, dict) else lambda k: getattr(snap, k))
    st = MapState.create(int(get("max_kf")), int(get("max_mp")), int(get("n_feat")),
                         int(get("max_obs")), device=device)
    for f in dataclasses.fields(MapState):
        if f.name in ("max_kf", "max_mp", "n_feat", "max_obs", "device", "_covis_cache"):
            continue
        v = get(f.name)
        if isinstance(v, np.ndarray):
            setattr(st, f.name, v.copy())
        elif f.name == "kf_loop_edges":
            setattr(st, f.name, [set(e) for e in v])
        else:
            setattr(st, f.name, v)
    dm = DeviceMap(st.max_kf, st.n_feat, st.max_mp, device=device)
    dm.sync_all(st)
    return st, dm
