"""Device-resident mirror of the map arrays + the mapping-stage kernels
(counterpart of orbslam_jpminipc_tpu/map/device_map.py).

The mapping stages (triangulation, fusion, local BA, the attrs pass, the
tracker's slice refresh) read large slices of the keyframe and point
arrays, which barely change between calls: a keyframe's features never
change after insertion, poses change at BA events, and point rows change
only for the touched ids. So the mirror keeps them resident on its device
and each stage gathers its operands there from indices sent by the host.

Each stage function, and the scatter of touched point rows, is a captured
program over the mirror (`utils/program.py:ProgramSet`, one program per
input shape, all on the mirror's one `GraphPool`): the reference jits each
as `mirror_call` does, one executable per host spec, with the host arrays
shipped as one packed transfer; here the host arrays are copied in as one
pinned transfer, one replay runs the stage, and its outputs are copied out
for the read the caller queues. The functions read the mirror tensors in
place, so every sync writes into them (`copy_`, `index_copy_`) and never
rebinds one: a graph reads the addresses of its capture. `DeviceMap.clear`
empties the mirror in place for a reset. The programs reach the mirror
through a weak reference, so a dropped mirror frees its graphs and their
pool at once, not at the collector's next pass; `release` drops them
while the mirror lives. On the CPU the functions run eagerly through the
same copy-in and copy-out code.
Where the reference maps a per-target function with `jax.vmap`, the
targets here are a leading batch dimension of the same tensors.
"""
from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from ..frontend.fused_track import MapSlice
from ..geometry import epipolar, triangulate
from ..ops import matching
from ..solvers import ba
from ..utils.device import resolve_device
from ..utils.host import host_tensor, upload, upload_into
from ..utils.program import GraphPool, ProgramSet

TRI_CANDS = 512   # per-neighbor triangulation candidate capacity
FUSE_CANDS = 256  # per-target fuse match capacity


def size_bucket(n: int) -> int:
    """The reference's coarse row buckets for the point scatter and the
    attrs pass (one program each): 256, 2048, then powers of two."""
    return 256 if n <= 256 else 2048 if n <= 2048 else 1 << int(np.ceil(np.log2(n)))


class DeviceMap:
    """The map mirror on `device`, with its stage programs."""

    def __init__(self, max_kf: int, n_feat: int, max_mp: int, device=None):
        self.device = resolve_device(device)
        # bumped on every sync; the tracker's slice refresh skips rebuilding
        # when nothing changed
        self.version = 0
        self._allocate(max_kf, n_feat, max_mp)

    def _allocate(self, max_kf: int, n_feat: int, max_mp: int):
        """The mirror's tensors at these capacities, zero, and its stage
        programs, none captured yet (the old ones go first: their graphs
        read the old tensors)."""
        self.programs = None
        self.max_kf = max_kf
        self.n_feat = n_feat
        self.max_mp = max_mp
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
        self.release()

    def release(self):
        """Drop the stage programs, their graphs and their pool now; each
        stage captures again at its next call."""
        self.programs = None
        # a weak reference: the programs do not keep their mirror alive
        me, pool = weakref.proxy(self), GraphPool()
        prog = lambda fn, name: ProgramSet(functools.partial(fn, me), self.device, name,
                                           pool=pool, log=False)
        self.programs = {"scatter": prog(_scatter, "map_scatter"), "tri": prog(_tri, "map_tri"),
                         "fuse": prog(_fuse, "map_fuse"), "local_ba": prog(_local_ba, "local_ba"),
                         "attrs": prog(_attrs, "map_attrs"), "slice": prog(_slice, "map_slice")}

    def put(self, a) -> torch.Tensor:
        """A host array as a tensor on the mirror's device (int64 indices
        stay int64; float64 becomes float32), staged in pinned memory and
        queued behind the stream's work (`utils.host.upload`): a plain
        `.to(device)` of pageable memory waits for the stream to drain,
        which would make every upload of a mapping stage wait for the
        programs in flight."""
        return upload(host_tensor(a), self.device)

    def mirror(self) -> dict:
        """The mirror's tensors by name."""
        return {k: getattr(self, k) for k in MIRRORED}

    def capture(self, name: str, variant, *args):
        """Capture stage `name` (a key of `programs`) at the shapes of `args`,
        given as to its entry point below; on the CPU nothing is captured."""
        self.programs[name].capture(variant, *_INPUTS[name](*args))

    def capture_scatter(self, n: int):
        """Capture the point scatter at bucket `n`. Its warm-up writes
        mirror row 0 with its own values: nothing changes."""
        rows = [t[:1].expand(n, *t.shape[1:]) for t in (
            self.mp_xyz, self.mp_desc, self.mp_normal, self.mp_min_dist, self.mp_max_dist,
            self.mp_valid)]
        self.programs["scatter"].capture(None, torch.zeros(n, dtype=torch.int32), *rows)

    # --- host -> device sync: every write lands in the mirror's tensors ------

    def sync_keyframe(self, st, k: int):
        """Upload one keyframe's immutable feature row + all poses."""
        self.version += 1
        k = int(k)
        for name in ("kf_desc", "kf_xy", "kf_angle", "kf_level", "kf_feat_valid"):
            upload_into(getattr(self, name)[k], host_tensor(getattr(st, name)[k]))
        self.sync_poses(st)

    def sync_poses(self, st):
        """Upload ALL keyframe poses — after BA / corrections."""
        self.version += 1
        upload_into(self.kf_R, host_tensor(st.kf_R))
        upload_into(self.kf_t, host_tensor(st.kf_t))

    def sync_points(self, st, ids: np.ndarray):
        """Upload the touched point rows: one program per size bucket, the
        ids padded with ids[0] (the same row written twice), as the
        reference's `_scatter_points`."""
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[(ids >= 0) & (ids < self.max_mp)]
        if len(ids) == 0:
            return
        self.version += 1
        n = len(ids)
        idp = np.concatenate([ids, np.full(size_bucket(n) - n, ids[0], np.int64)])
        self.programs["scatter"].run(None, *_INPUTS["scatter"](
            idp, st.mp_xyz[idp], st.mp_desc[idp], st.mp_normal[idp], st.mp_min_dist[idp],
            st.mp_max_dist[idp], st.mp_valid[idp]))

    def sync_all(self, st):
        """Full refresh — after loop corrections / global BA / reset. A map
        of other capacities gets a mirror of its own: new tensors, and new
        programs (those captured on the old tensors are dropped first)."""
        self.version += 1
        if (st.kf_desc.shape[:2], st.mp_xyz.shape[0]) != ((self.max_kf, self.n_feat),
                                                          self.max_mp):
            self._allocate(st.kf_desc.shape[0], st.kf_desc.shape[1], st.mp_xyz.shape[0])
        for name in MIRRORED:
            a = getattr(st, name)
            if name == "mp_max_dist":
                a = np.where(np.isfinite(a), a, 0.0)
            upload_into(getattr(self, name), host_tensor(a))

    def clear(self):
        """The mirror of an empty map, written in place (a reset keeps the
        captured programs), at a fresh mirror's version."""
        self.version = 0
        for t in self.mirror().values():
            t.zero_()
        self.kf_R.copy_(torch.eye(3, device=self.device).expand_as(self.kf_R))


# the mirror's tensors, named as the MapState arrays they mirror
MIRRORED = ("kf_desc", "kf_xy", "kf_angle", "kf_level", "kf_feat_valid", "kf_R", "kf_t",
            "mp_xyz", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist", "mp_valid")


def _host(a, dtype) -> torch.Tensor:
    """A stage's argument as a tensor of `dtype`: a host array as a CPU
    tensor (copied in as part of the packed transfer), a tensor where it
    lies."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(a.shape).to(dtype)


_i32 = functools.partial(_host, dtype=torch.int32)
_b = functools.partial(_host, dtype=torch.bool)
_f32 = functools.partial(_host, dtype=torch.float32)


def _compact(ok: torch.Tensor, cap: int) -> torch.Tensor:
    """Per row, the indices of the True entries first, in order (a stable
    sort on ~ok), cut to `cap`: the host merge claims in this order."""
    return torch.sort((~ok).to(torch.int8), dim=-1, stable=True).indices[..., :cap]


# --- the stage programs' functions: (mirror, variant, *copied-in inputs) -----

def _scatter(dm: DeviceMap, _, ids, xyz, desc, normal, min_dist, max_dist, valid):
    i = ids.to(torch.int64)
    for dst, src in ((dm.mp_xyz, xyz), (dm.mp_desc, desc), (dm.mp_normal, normal),
                     (dm.mp_min_dist, min_dist), (dm.mp_max_dist, max_dist),
                     (dm.mp_valid, valid)):
        dst.index_copy_(0, i, src)
    return ()   # it writes the mirror: nothing to copy out


def _fuse(dm: DeviceMap, _, q_point, q_row_valid, dst_idx, K4, sf):
    q_point = q_point.to(torch.int64)
    dst = dst_idx.to(torch.int64)
    qid = torch.clamp(q_point, 0, dm.max_mp - 1)
    q_valid = (q_point >= 0) & dm.mp_valid[qid] & q_row_valid
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


def _tri(dm: DeviceMap, _, kf1, sel, has1, has2, valid2_extra, K4, sigma2, sf):
    # the keyframe as a one-element index: the program serves every keyframe
    k1 = kf1.to(torch.int64)
    row = lambda t: t.index_select(0, k1)[0]
    sel = sel.to(torch.int64)
    desc1, xy1 = row(dm.kf_desc), row(dm.kf_xy)
    angle1, level1, valid1 = row(dm.kf_angle), row(dm.kf_level), row(dm.kf_feat_valid)
    R1, t1 = row(dm.kf_R), row(dm.kf_t)
    xy2, level2 = dm.kf_xy[sel], dm.kf_level[sel]
    valid2 = dm.kf_feat_valid[sel] & valid2_extra
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
        desc1, xy1, angle1, level1, has1, valid1,
        dm.kf_desc[sel], xy2, dm.kf_angle[sel], level2, has2, valid2,
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


def _local_ba(dm: DeviceMap, iterations, kf_R, kf_t, kf_fixed, points, point_valid,
              obs_kf, obs_pt, obs_feat, obs_src_kf, obs_valid, K4, inv_sigma2):
    src, feat = obs_src_kf.to(torch.int64), obs_feat.to(torch.int64)
    lv = torch.clamp(dm.kf_level[src, feat], 0, inv_sigma2.shape[0] - 1).to(torch.int64)
    prob = ba.BAProblem(
        kf_R=kf_R, kf_t=kf_t, kf_fixed=kf_fixed, points=points, point_valid=point_valid,
        obs_kf=obs_kf.to(torch.int64), obs_pt=obs_pt.to(torch.int64),
        obs_uv=dm.kf_xy[src, feat], obs_w=inv_sigma2[lv], obs_valid=obs_valid, K4=K4)
    return ba.bundle_adjust(prob, iterations=iterations)


def _attrs(dm: DeviceMap, _, obs_kf, obs_feat, xyz, ref_slot, sf):
    from .map_state import attrs_math

    obs_kf = obs_kf.to(torch.int64)
    obs_feat = obs_feat.to(torch.int64)
    valid = obs_kf >= 0
    kf_safe = torch.clamp(obs_kf, 0, dm.max_kf - 1)
    R = dm.kf_R[kf_safe]                               # (n, O, 3, 3)
    t = dm.kf_t[kf_safe]
    centers = -torch.einsum("noji,noj->noi", R, t)
    return attrs_math(dm.kf_desc[kf_safe, obs_feat], valid, xyz, centers,
                      dm.kf_level[kf_safe, obs_feat], ref_slot, sf)


def _slice(dm: DeviceMap, _, ids, row_valid, n_obs):
    mid = torch.clamp(ids.to(torch.int64), 0, dm.max_mp - 1)
    valid = row_valid & dm.mp_valid[mid]
    maxd = torch.where(valid, torch.clamp(dm.mp_max_dist[mid], min=1e-6), 0.0)
    return MapSlice(xyz=dm.mp_xyz[mid], normal=dm.mp_normal[mid],
                    min_dist=dm.mp_min_dist[mid], max_dist=maxd,
                    desc=dm.mp_desc[mid], n_obs=n_obs)


# --- each stage's arguments as the tensors its program copies in -------------

_INPUTS = {
    "scatter": lambda ids, xyz, desc, normal, min_dist, max_dist, valid: (
        _i32(ids), _f32(xyz), _host(desc, torch.uint8), _f32(normal), _f32(min_dist),
        _f32(np.where(np.isfinite(max_dist), max_dist, 0.0)), _b(valid)),
    "tri": lambda kf1, sel, has1, has2, valid2_extra, K4, sigma2, sf: (
        _i32(np.reshape(kf1, 1)), _i32(sel), _b(has1), _b(has2), _b(valid2_extra),
        _f32(K4), _f32(sigma2), _f32(sf)),
    "fuse": lambda q_point, q_row_valid, dst_idx, K4, sf: (
        _i32(q_point), _b(q_row_valid), _i32(dst_idx), _f32(K4), _f32(sf)),
    "local_ba": lambda kf_R, kf_t, kf_fixed, points, point_valid, obs_kf, obs_pt, obs_feat,
    obs_src_kf, obs_valid, K4, inv_sigma2: (
        _f32(kf_R), _f32(kf_t), _b(kf_fixed), _f32(points), _b(point_valid), _i32(obs_kf),
        _i32(obs_pt), _i32(obs_feat), _i32(obs_src_kf), _b(obs_valid), _f32(K4),
        _f32(inv_sigma2)),
    "attrs": lambda obs_kf, obs_feat, xyz, ref_slot, sf: (
        _i32(obs_kf), _i32(obs_feat), _f32(xyz), _i32(ref_slot), _f32(sf)),
    "slice": lambda ids, row_valid, n_obs: (_i32(ids), _b(row_valid), _f32(n_obs)),
}


# --- the stages' entry points -----------------------------------------------

def fuse_kernel(dm: DeviceMap, q_point, q_row_valid, dst_idx, K4, scale_factors):
    """Batched ORBmatcher::Fuse (ORBmatcher.cc:1016-1134) over the mirror.

    q_point: (T, F) map-point slot per query-row feature (-1 none);
    q_row_valid: (T, F) bool; dst_idx: (T,) target keyframe per row.
    Returns (cnt (T,), source feature (T, FUSE_CANDS), target feature
    (T, FUSE_CANDS)); entries past cnt are padding."""
    return dm.programs["fuse"].run(
        None, *_INPUTS["fuse"](q_point, q_row_valid, dst_idx, K4, scale_factors))


def tri_kernel(dm: DeviceMap, kf1, sel, has1, has2, valid2_extra, K4, sigma2, scale_factors):
    """CreateNewMapPoints' epipolar search + DLT + validity gates
    (LocalMapping.cc:227-393) of keyframe `kf1` against the B neighbors
    `sel`. Returns per neighbor (cnt (B,), feature in kf1 (B, TRI_CANDS),
    feature in the neighbor (B, TRI_CANDS), point (B, TRI_CANDS, 3)),
    candidates in feature order; entries past cnt are padding."""
    return dm.programs["tri"].run(None, *_INPUTS["tri"](
        kf1, sel, has1, has2, valid2_extra, K4, sigma2, scale_factors))


def local_ba_kernel(dm: DeviceMap, kf_R, kf_t, kf_fixed, points, point_valid,
                    obs_kf, obs_pt, obs_feat, obs_src_kf, obs_valid, K4, inv_sigma2,
                    iterations: int = 5) -> ba.BAResult:
    """ONE local-BA LM stage with observation pixels and weights gathered
    from the mirror (obs_uv = kf_xy[src_kf, feat]) inside the same program
    as the LM, one variant per iteration count (the reference's
    `mirror_call(2)` jits them together). The reference's 5 -> erase -> 10
    schedule (Optimizer.cc:450-494) runs as two calls with the host erase
    between them. Pose and point arguments may be host arrays or tensors
    on the device (a first stage's result)."""
    return dm.programs["local_ba"].run(iterations, *_INPUTS["local_ba"](
        kf_R, kf_t, kf_fixed, points, point_valid, obs_kf, obs_pt, obs_feat, obs_src_kf,
        obs_valid, K4, inv_sigma2))


def attrs_kernel(dm: DeviceMap, obs_kf, obs_feat, xyz, ref_slot, scale_factors):
    """Point-attribute refresh with the observations gathered from the
    mirror (MapPoint::ComputeDistinctiveDescriptors + UpdateNormalAndDepth,
    MapPoint.cc:185-312), one program per row bucket (`size_bucket`).
    Returns (desc, normal, dmin, dmax) tensors."""
    return dm.programs["attrs"].run(
        None, *_INPUTS["attrs"](obs_kf, obs_feat, xyz, ref_slot, scale_factors))


def slice_kernel(dm: DeviceMap, ids, row_valid, n_obs) -> MapSlice:
    """The fused tracker's local-map slice, gathered on the device from the
    mirror. Rows that are not valid get max_dist = 0."""
    return dm.programs["slice"].run(None, *_INPUTS["slice"](ids, row_valid, n_obs))


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
