"""PyTorch port vs the JAX package: the mapping layer.

The matchers that mapping calls, the two-view geometry, the map state's
covisibility and point attributes, the device-map stage kernels and the
culling rules. Inputs are made from a seed with numpy. The kernels run on a
small synthetic map (5 keyframes looking at 300 points, 180 of them mapped)
that the JAX package's own `MapState` API builds; the port starts from the
same map through `map_from_snapshot`.

Tolerances: matcher indices, masks and distances exactly equal;
covisibility exact; attribute descriptors exact, normals within 1e-6 and
depth bands within 1e-6 relative; epipolar outputs and the triangulation
gates within 1e-5 (relative to their scale); compaction orders and
candidate counts exactly equal; local BA poses within 1e-4, points within
1e-4 relative (the scene lies 4-7 units deep) and outliers equal.

Triangulated points are held within 1e-4 relative, not 1e-5: the DLT's
float32 normal equations (pixel-scaled rows) leave both packages ~3.5e-5
(relative) from the float64 solution of the same system, and the JAX
package's own eager and jitted runs differ by as much. So the port must
also be no further from the float64 solution than the reference is, plus
1e-5.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from orbslam_jpminipc_tpu.config import SlamConfig as JaxSlamConfig
from orbslam_jpminipc_tpu.geometry import epipolar as jepi
from orbslam_jpminipc_tpu.geometry import se3 as jse3
from orbslam_jpminipc_tpu.geometry import triangulate as jtri
from orbslam_jpminipc_tpu.io import trajectory as jtraj
from orbslam_jpminipc_tpu.map import culling as jcull
from orbslam_jpminipc_tpu.map import device_map as jdmap
from orbslam_jpminipc_tpu.map import map_state as jms
from orbslam_jpminipc_tpu.ops import matching as jmat
# imported before any kernel is traced: the BA module makes jnp constants at
# import time, which must not be created inside a trace
from orbslam_jpminipc_tpu.solvers import ba as _jba  # noqa: F401
from orbslam_jpminipc_torch import native as tnative
from orbslam_jpminipc_torch.frontend import fused_track as tfused
from orbslam_jpminipc_torch.geometry import epipolar as tepi
from orbslam_jpminipc_torch.geometry import se3 as tse3
from orbslam_jpminipc_torch.geometry import triangulate as ttri
from orbslam_jpminipc_torch.io import trajectory as ttraj
from orbslam_jpminipc_torch.map import culling as tcull
from orbslam_jpminipc_torch.map import device_map as tdmap
from orbslam_jpminipc_torch.map import map_state as tms

torch.set_num_threads(2)

CFG = JaxSlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
K4 = CFG.K4.astype(np.float32)
SF = CFG.scale_factors.astype(np.float32)
SIGMA2 = CFG.sigma2.astype(np.float32)
GEOM_TOL = 1e-5
DLT_TOL = 1e-4


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_matches_equal(got, ref):
    np.testing.assert_array_equal(_np(got.mask), np.asarray(ref.mask))
    np.testing.assert_array_equal(_np(got.idx), np.asarray(ref.idx))
    np.testing.assert_array_equal(_np(got.dist), np.asarray(ref.dist))


def _flip_bits(rng, desc, max_flips):
    """Copies of `desc` with up to `max_flips` random bits flipped per row."""
    out = desc.copy()
    for r in range(len(out)):
        for b in rng.choice(256, rng.integers(0, max_flips + 1), replace=False):
            out[r, b // 8] ^= np.uint8(1 << (b % 8))
    return out


# ---------------------------------------------------------------------------
# the matchers mapping calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotation_consistency_exact(seed):
    """Dominant bins, ties between bins, the 0.1 * max cut and the 360
    wrap all appear: a cluster near 0/360, two near-equal clusters, noise."""
    rng = np.random.default_rng(seed)
    n = 400
    rot = np.concatenate([rng.normal(0, 8, 150), rng.normal(95, 5, 80), rng.normal(200, 5, 80),
                          rng.uniform(-720, 720, n - 310)]).astype(np.float32)
    valid = rng.uniform(size=n) < 0.85
    ref = jmat.rotation_consistency(jnp.asarray(rot), jnp.asarray(valid))
    got = tmat_rotation(rot, valid)
    np.testing.assert_array_equal(got, np.asarray(ref))
    # batched rows agree with the reference mapped over them
    rot2 = np.stack([rot, np.roll(rot, 17)])
    val2 = np.stack([valid, ~valid])
    ref2 = jax.vmap(jmat.rotation_consistency)(jnp.asarray(rot2), jnp.asarray(val2))
    np.testing.assert_array_equal(tmat_rotation(rot2, val2), np.asarray(ref2))


def tmat_rotation(rot, valid):
    from orbslam_jpminipc_torch.ops import matching as tmat

    return tmat.rotation_consistency(T(rot), T(valid)).numpy()


def _feature_pair(rng, n=300, m=320, window=60.0):
    """Two feature sets: the second holds noisy copies of most of the first
    (moved a few pixels, descriptor bits flipped), plus clutter."""
    xy1 = rng.uniform([20, 20], [620, 460], (n, 2)).astype(np.float32)
    d1 = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    a1 = rng.uniform(0, 360, n).astype(np.float32)
    src = rng.permutation(n)[: m - 40]
    xy2 = np.concatenate([xy1[src] + rng.normal(0, window / 4, (len(src), 2)),
                          rng.uniform([20, 20], [620, 460], (40, 2))]).astype(np.float32)
    d2 = np.concatenate([_flip_bits(rng, d1[src], 40),
                         rng.integers(0, 256, (40, 32), dtype=np.uint8)])
    a2 = np.concatenate([a1[src] + rng.normal(0, 3, len(src)) + 30.0,
                         rng.uniform(0, 360, 40)]).astype(np.float32)
    l2 = rng.integers(0, 3, m).astype(np.int32)
    v1 = rng.uniform(size=n) < 0.95
    v2 = rng.uniform(size=m) < 0.95
    return xy1, d1, a1, v1, xy2, d2, a2, l2, v2


@pytest.mark.parametrize("check_rotation", [True, False])
@pytest.mark.parametrize("levels", [(0, 0), (0, 7)])
def test_window_search_exact(check_rotation, levels):
    from orbslam_jpminipc_torch.ops import matching as tmat

    rng = np.random.default_rng(3)
    xy1, d1, a1, v1, xy2, d2, a2, l2, v2 = _feature_pair(rng)
    kw = dict(window_px=60.0, max_dist=70, nn_ratio=0.9, min_level=levels[0],
              max_level=levels[1], check_rotation=check_rotation)
    args = (d1, xy1, a1, v1, d2, xy2, a2, l2, v2)
    ref = jmat.window_search(*map(jnp.asarray, args), **kw)
    got = tmat.window_search(*map(T, args), **kw)
    assert int(np.asarray(ref.mask).sum()) > 20
    _assert_matches_equal(got, ref)


def _pose(rotvec, t):
    return (Rotation.from_rotvec(rotvec).as_matrix().astype(np.float32),
            np.asarray(t, np.float32))


# ---------------------------------------------------------------------------
# a small synthetic map, built with the JAX package's MapState API
# ---------------------------------------------------------------------------

N_KF, N_PTS, N_MAPPED, N_FEAT = 5, 300, 180, 512


def _project(xw, R, t):
    xc = xw @ R.T + t
    return np.stack([K4[0] * xc[:, 0] / xc[:, 2] + K4[2],
                     K4[1] * xc[:, 1] / xc[:, 2] + K4[3]], 1), xc[:, 2]


def _build_world(seed=0):
    """Five keyframes sliding along x; points 0..179 are mapped (observed by
    keyframes 0-3, and points 0..119 also by keyframe 4, the newest);
    points 180.. are seen but not mapped, so keyframe 4 can triangulate
    them against its neighbors."""
    rng = np.random.default_rng(seed)
    xw = np.stack([rng.uniform(-2, 2, N_PTS), rng.uniform(-1.5, 1.5, N_PTS),
                   rng.uniform(4, 7, N_PTS)], 1).astype(np.float32)
    base_desc = rng.integers(0, 256, (N_PTS, 32), dtype=np.uint8)
    base_angle = rng.uniform(0, 360, N_PTS)
    st = jms.MapState.create(max_kf=8, max_mp=1024, n_feat=N_FEAT, max_obs=8)
    feat_of = []
    for k in range(N_KF):
        R, t = _pose([0.0, 0.03 * k, 0.0], [-0.25 * k, 0.02 * k, 0.0])
        uv, z = _project(xw, R, t)
        vis = np.nonzero((z > 0) & (uv[:, 0] > 20) & (uv[:, 0] < 620)
                         & (uv[:, 1] > 20) & (uv[:, 1] < 460))[0]
        vis = rng.permutation(vis)
        n_clutter = 40
        n = len(vis) + n_clutter
        level = rng.integers(0, 3, n).astype(np.int32)
        xy = np.concatenate([uv[vis] + rng.normal(0, 0.3, (len(vis), 2)),
                             rng.uniform([20, 20], [620, 460], (n_clutter, 2))]).astype(np.float32)
        desc = np.concatenate([_flip_bits(rng, base_desc[vis], 6),
                               rng.integers(0, 256, (n_clutter, 32), dtype=np.uint8)])
        angle = np.concatenate([base_angle[vis] + rng.normal(0, 2, len(vis)),
                                rng.uniform(0, 360, n_clutter)]).astype(np.float32)
        st.add_keyframe(R, t, xy, level, angle, desc, np.ones(n, bool),
                        frame_id=10 * k, timestamp=float(k))
        feat_of.append({int(p): f for f, p in enumerate(vis)})
    mapped = [p for p in range(N_MAPPED) if p in feat_of[0]]
    ids = st.add_points(xw[mapped] + rng.normal(0, 0.01, (len(mapped), 3)).astype(np.float32),
                        base_desc[mapped], ref_kf=0, first_kf_id=0)
    for mp, p in zip(ids, mapped):
        for k in range(N_KF):
            if p in feat_of[k] and (k < N_KF - 1 or p < 120):
                st.add_observation(int(mp), k, feat_of[k][p])
    st.mp_found[ids] = rng.integers(0, 4, len(ids))
    st.mp_visible[ids] = 4
    st.mp_first_kf[ids] = rng.integers(0, 3, len(ids))
    st.update_point_attributes(ids, CFG.scale_factors)
    covis = st.covisibility()
    for k in range(1, N_KF):
        st.update_spanning_tree(k, covis[k])
    return st, ids


@pytest.fixture(scope="module")
def world():
    return _build_world()


def _both(world):
    """Fresh copies of the JAX map with its device mirror, and the port's
    map and mirror carried across from it."""
    jst = copy.deepcopy(world[0])
    jdm = jdmap.DeviceMap(jst.max_kf, jst.n_feat, jst.max_mp)
    jdm.sync_all(jst)
    tst, tdm = tdmap.map_from_snapshot(copy.deepcopy(world[0]), device="cpu")
    return jst, jdm, tst, tdm


def test_map_from_snapshot_carries_every_field(world):
    jst, jdm, tst, tdm = _both(world)
    for name in ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_timestamp", "kf_xy",
                 "kf_level", "kf_angle", "kf_desc", "kf_feat_valid", "kf_point", "kf_parent",
                 "mp_xyz", "mp_valid", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist",
                 "mp_ref_kf", "mp_first_kf", "mp_visible", "mp_found", "mp_obs_kf",
                 "mp_obs_feat", "mp_gen"):
        np.testing.assert_array_equal(getattr(tst, name), getattr(jst, name), err_msg=name)
    assert (tst.next_kf_id, tst.next_mp_id) == (jst.next_kf_id, jst.next_mp_id)
    assert tst.kf_loop_edges == jst.kf_loop_edges
    for name in ("kf_desc", "kf_xy", "kf_angle", "kf_level", "kf_feat_valid", "kf_R", "kf_t",
                 "mp_xyz", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist", "mp_valid"):
        np.testing.assert_array_equal(getattr(tdm, name).numpy(), np.asarray(getattr(jdm, name)),
                                      err_msg=name)


def test_covisibility_exact(world):
    jst, _, tst, _ = _both(world)
    ref = jst.covisibility()
    got = tst.covisibility()
    assert got.dtype == np.int32 and ref[0, 1] > 100
    np.testing.assert_array_equal(got, ref)
    # the same counts as the reference's device product of the membership rows
    M = jst.membership_matrix().astype(np.float32)
    np.testing.assert_array_equal(got, np.asarray(jms._covis_matmul(jnp.asarray(M))))


def _attrs_inputs(st, ids):
    obs_kf = st.mp_obs_kf[ids]
    obs_feat = np.clip(st.mp_obs_feat[ids], 0, st.n_feat - 1)
    valid = obs_kf >= 0
    kf_safe = np.clip(obs_kf, 0, st.max_kf - 1)
    centers = -np.einsum("koji,koj->koi", st.kf_R[kf_safe], st.kf_t[kf_safe]).astype(np.float32)
    ref_slot = np.argmax(obs_kf == st.mp_ref_kf[ids][:, None], axis=1)
    return (st.kf_desc[kf_safe, obs_feat], valid, st.mp_xyz[ids].astype(np.float32), centers,
            st.kf_level[kf_safe, obs_feat], ref_slot, SF)


def _check_attrs(got, ref):
    np.testing.assert_array_equal(_np(got[0]), np.asarray(ref[0]))
    np.testing.assert_allclose(_np(got[1]), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_allclose(_np(got[2]), np.asarray(ref[2]), rtol=1e-6)
    np.testing.assert_allclose(_np(got[3]), np.asarray(ref[3]), rtol=1e-6)


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicate_descs"])
def test_attrs_math_matches_jax(world, dup):
    """Descriptor selection by the smallest median distance (ties to the
    lowest slot: the duplicate case gives every observation one of two
    descriptors), viewing normal and scale band."""
    st = world[0]
    ids = np.nonzero(st.mp_valid)[0]
    args = list(_attrs_inputs(st, ids))
    if dup:
        args[0] = np.where((np.arange(8) % 2 == 0)[None, :, None], args[0][:, :1], args[0][:, 1:2])
    ref = jms.attrs_math(*map(jnp.asarray, args))
    args_t = [T(a) for a in args]
    args_t[5] = args_t[5].long()
    _check_attrs(tms.attrs_math(*args_t), ref)


def test_attrs_kernel_and_update_match_jax(world):
    """The attrs pass through each package's device mirror, written back
    into the host map."""
    jst, jdm, tst, tdm = _both(world)
    ids = np.nonzero(jst.mp_valid)[0][::2]
    # move the points so the refresh has something to change
    for st in (jst, tst):
        st.mp_xyz[ids] *= np.float32(1.05)
    jdm.sync_points(jst, ids)
    tdm.sync_points(tst, ids)
    jst.update_point_attributes(ids, CFG.scale_factors, dmap=jdm)
    tst.update_point_attributes(ids, CFG.scale_factors, dmap=tdm)
    _check_attrs((tst.mp_desc[ids], tst.mp_normal[ids], tst.mp_min_dist[ids], tst.mp_max_dist[ids]),
                 (jst.mp_desc[ids], jst.mp_normal[ids], jst.mp_min_dist[ids], jst.mp_max_dist[ids]))


# ---------------------------------------------------------------------------
# two-view geometry
# ---------------------------------------------------------------------------


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(np.max(np.abs(np.asarray(b))), 1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_epipolar_matches_jax(seed):
    rng = np.random.default_rng(seed)
    R1, t1 = _pose(rng.normal(0, 0.05, 3), rng.normal(0, 0.3, 3))
    R2, t2 = _pose(rng.normal(0, 0.05, 3), rng.normal(0, 0.3, 3))
    Fj = jepi.fundamental_from_poses(*map(jnp.asarray, (R1, t1, R2, t2, K4)))
    Ft = tepi.fundamental_from_poses(*map(T, (R1, t1, R2, t2, K4)))
    assert _rel(Ft.numpy(), Fj) < GEOM_TOL
    uv1 = rng.uniform([0, 0], [640, 480], (200, 2)).astype(np.float32)
    uv2 = rng.uniform([0, 0], [640, 480], (200, 2)).astype(np.float32)
    Fn = np.asarray(Fj)
    dj = jepi.epipolar_dist2(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(Fn))
    dt = tepi.epipolar_dist2(T(uv1), T(uv2), T(Fn))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=GEOM_TOL, atol=GEOM_TOL)
    np.testing.assert_array_equal(tepi.K_matrix(T(K4)).numpy(), np.asarray(jepi.K_matrix(jnp.asarray(K4))))


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 256
    xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 8, n)], 1).astype(np.float32)
    R1, t1 = _pose([0, 0, 0], [0, 0, 0])
    R2, t2 = _pose(rng.normal(0, 0.03, 3), [-0.3, 0.02, 0.01])
    uv1 = (_project(xw, R1, t1)[0] + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2 = (_project(xw, R2, t2)[0] + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    P1j = jtri.projection_matrix(*map(jnp.asarray, (R1, t1, K4)))
    P2j = jtri.projection_matrix(*map(jnp.asarray, (R2, t2, K4)))
    P1t = ttri.projection_matrix(*map(T, (R1, t1, K4)))
    P2t = ttri.projection_matrix(*map(T, (R2, t2, K4)))
    np.testing.assert_allclose(P2t.numpy(), np.asarray(P2j), rtol=GEOM_TOL)
    xj, okj = jtri.triangulate_dlt(jnp.asarray(uv1), jnp.asarray(uv2), P1j, P2j)
    xt, okt = ttri.triangulate_dlt(T(uv1), T(uv2), P1t, P2t)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert _rel(xt.numpy(), xj) < DLT_TOL
    x64, _ = ttri.triangulate_dlt(*(T(a).double() for a in (uv1, uv2, np.asarray(P1j),
                                                           np.asarray(P2j))))
    assert _rel(xt.numpy(), x64.numpy()) <= 1.5 * _rel(xj, x64.numpy()) + GEOM_TOL
    xn = np.asarray(xj)
    O2 = -R2.T @ t2
    np.testing.assert_allclose(
        ttri.parallax_cos(T(xn), T(np.zeros(3, np.float32)), T(O2)).numpy(),
        np.asarray(jtri.parallax_cos(jnp.asarray(xn), jnp.zeros(3), jnp.asarray(O2))),
        atol=GEOM_TOL)
    ej, pj = jtri.reprojection_error2(*map(jnp.asarray, (xn, uv2, R2, t2, K4)))
    et, pt = ttri.reprojection_error2(*map(T, (xn, uv2, R2, t2, K4)))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4, atol=GEOM_TOL)


def test_search_for_triangulation_exact(world):
    """Keyframe 4 against neighbors 3 and 2 of the synthetic map, one
    neighbor at a time as the reference maps them, and batched."""
    from orbslam_jpminipc_torch.ops import matching as tmat

    st = world[0]
    k1, sel = 4, [3, 2]
    R1, t1 = st.kf_R[k1], st.kf_t[k1]
    O1 = -R1.T @ t1
    outs_t = []
    args_b = []
    for k2 in sel:
        R2, t2 = st.kf_R[k2], st.kf_t[k2]
        F12 = np.asarray(jepi.fundamental_from_poses(*map(jnp.asarray, (R1, t1, R2, t2, K4))))
        xc = R2 @ O1 + t2
        ep = np.array([K4[0] * xc[0] / xc[2] + K4[2], K4[1] * xc[1] / xc[2] + K4[3]], np.float32)
        args = (st.kf_desc[k1], st.kf_xy[k1], st.kf_angle[k1], st.kf_level[k1],
                st.kf_point[k1] >= 0, st.kf_feat_valid[k1],
                st.kf_desc[k2], st.kf_xy[k2], st.kf_angle[k2], st.kf_level[k2],
                st.kf_point[k2] >= 0, st.kf_feat_valid[k2], F12, SIGMA2, ep, SF)
        ref = jmat.search_for_triangulation(*map(jnp.asarray, args))
        got = tmat.search_for_triangulation(*map(T, args))
        assert int(np.asarray(ref.mask).sum()) > 30
        _assert_matches_equal(got, ref)
        outs_t.append(got)
        args_b.append(args)
    batched = [np.stack([a[i] for a in args_b]) if i not in (13, 15) else args_b[0][i]
               for i in range(16)]
    got_b = tmat.search_for_triangulation(*map(T, batched))
    for b, g in enumerate(outs_t):
        np.testing.assert_array_equal(got_b.idx[b].numpy(), g.idx.numpy())
        np.testing.assert_array_equal(got_b.mask[b].numpy(), g.mask.numpy())


def test_fuse_search_exact(world):
    """Keyframe 0's points projected into keyframe 4, with the predicted
    level of the fuse kernel."""
    from orbslam_jpminipc_torch.ops import matching as tmat

    st = world[0]
    ids = st.kf_point[0][st.kf_point[0] >= 0]
    R, t = st.kf_R[4], st.kf_t[4]
    uv, z = _project(st.mp_xyz[ids], R, t)
    pred = np.clip(np.arange(len(ids)) % 3, 0, 7).astype(np.int32)
    valid = z > 0
    args = (st.mp_desc[ids], uv.astype(np.float32), pred, valid, st.kf_desc[4], st.kf_xy[4],
            st.kf_level[4], st.kf_feat_valid[4], SF)
    ref = jmat.fuse_search(*map(jnp.asarray, args))
    got = tmat.fuse_search(*map(T, args))
    assert int(np.asarray(ref.mask).sum()) > 30
    _assert_matches_equal(got, ref)


# ---------------------------------------------------------------------------
# device-map stage kernels on the carried-across map
# ---------------------------------------------------------------------------


def test_tri_kernel_matches_jax(world):
    jst, jdm, tst, tdm = _both(world)
    kf, sel = 4, np.array([3, 2, 1, 3], np.int64)
    extra = np.ones((4, N_FEAT), bool)
    extra[3] = False  # a padding neighbor row, as the mapper pads them
    args = (np.array([kf], np.int32), sel.astype(np.int32), jst.kf_point[kf] >= 0,
            jst.kf_point[sel] >= 0, extra, CFG.K4, CFG.sigma2, CFG.scale_factors)
    ref = jax.tree.map(np.asarray, jdmap.tri_kernel(
        jdm.kf_desc, jdm.kf_xy, jdm.kf_angle, jdm.kf_level, jdm.kf_feat_valid,
        jdm.kf_R, jdm.kf_t, *args))
    got = tdmap.tri_kernel(tdm, kf, sel, *args[2:])
    cnt = ref[0]
    assert cnt[:3].min() > 20 and cnt[3] == 0
    np.testing.assert_array_equal(got[0].numpy(), cnt)
    np.testing.assert_array_equal(got[1].numpy(), ref[1].astype(np.int64))
    np.testing.assert_array_equal(got[2].numpy(), ref[2].astype(np.int64))
    for b in range(len(sel)):
        n = min(int(cnt[b]), tdmap.TRI_CANDS)
        assert _rel(got[3][b, :n].numpy(), ref[3][b, :n]) < DLT_TOL if n else True


def test_fuse_kernel_matches_jax(world):
    jst, jdm, tst, tdm = _both(world)
    kf, targets = 4, np.array([0, 1, 2, 0], np.int32)
    T_ = len(targets)
    row_valid = np.ones((2 * T_, N_FEAT), bool)
    row_valid[T_ - 1] = row_valid[2 * T_ - 1] = False
    q = np.concatenate([np.broadcast_to(jst.kf_point[kf], (T_, N_FEAT)),
                        jst.kf_point[targets]]).astype(np.int32)
    dst = np.concatenate([targets, np.full(T_, kf, np.int32)])
    ref = jax.tree.map(np.asarray, jdmap.fuse_kernel(
        jdm.kf_desc, jdm.kf_xy, jdm.kf_level, jdm.kf_feat_valid, jdm.kf_R, jdm.kf_t,
        jdm.mp_xyz, jdm.mp_desc, jdm.mp_min_dist, jdm.mp_max_dist, jdm.mp_valid,
        q, row_valid, dst, CFG.K4, CFG.scale_factors))
    got = tdmap.fuse_kernel(tdm, q, row_valid, dst, CFG.K4, CFG.scale_factors)
    assert ref[0][:T_ - 1].min() > 30 and ref[0][T_ - 1] == 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.astype(np.int64))


def test_local_ba_kernel_matches_jax(world):
    """Both stages of the local BA schedule with pixels and weights gathered
    from each mirror; keyframe 0 fixed, a few observations corrupted."""
    jst, jdm, tst, tdm = _both(world)
    rng = np.random.default_rng(5)
    kfs = np.arange(N_KF)
    ids = np.nonzero(jst.mp_valid)[0]
    P, O = 256, 1024
    pos = {int(k): i for i, k in enumerate(kfs)}
    obs = [(pos[int(k)], i, int(f), int(k)) for i, p in enumerate(ids)
           for k, f in zip(jst.mp_obs_kf[p], jst.mp_obs_feat[p]) if k >= 0]
    obs = np.array(obs[:O])
    n = len(obs)
    pad = lambda a, fill=0: np.concatenate([a, np.full(O - n, fill, a.dtype)])
    obs_kf, obs_pt, obs_feat, obs_src = (pad(obs[:, i].astype(np.int32)) for i in range(4))
    # corrupt some observations through the mirrors' pixels
    bad = rng.choice(n, 10, replace=False)
    for b in bad:
        jst.kf_xy[obs_src[b], obs_feat[b]] += np.float32(25.0)
    jdm.sync_all(jst)
    tdm.sync_all(jst)
    R0 = jst.kf_R[kfs].copy()
    t0 = jst.kf_t[kfs].copy()
    t0[1:] += rng.normal(0, 0.01, (N_KF - 1, 3)).astype(np.float32)
    pts = np.zeros((P, 3), np.float32)
    pts[:len(ids)] = jst.mp_xyz[ids]
    pvalid = np.arange(P) < len(ids)
    fixed = kfs == 0
    ovalid = np.arange(O) < n
    common = (fixed, pts, pvalid, obs_kf, obs_pt, obs_feat, obs_src)
    ref1 = jdmap.local_ba_kernel(jdm.kf_xy, jdm.kf_level, R0, t0, *common, ovalid,
                                 CFG.K4, CFG.inv_sigma2, iterations=5)
    got1 = tdmap.local_ba_kernel(tdm, R0, t0, *common, ovalid, CFG.K4, CFG.inv_sigma2,
                                 iterations=5)
    ov2 = ovalid & ~np.asarray(ref1.obs_outlier)
    ref2 = jdmap.local_ba_kernel(jdm.kf_xy, jdm.kf_level, ref1.kf_R, ref1.kf_t, fixed,
                                 ref1.points, *common[2:], ov2, CFG.K4, CFG.inv_sigma2,
                                 iterations=10)
    got2 = tdmap.local_ba_kernel(tdm, got1.kf_R, got1.kf_t, fixed, got1.points, *common[2:],
                                 ov2, CFG.K4, CFG.inv_sigma2, iterations=10)
    for got, ref in ((got1, ref1), (got2, ref2)):
        np.testing.assert_allclose(got.kf_R.numpy(), np.asarray(ref.kf_R), atol=1e-4)
        np.testing.assert_allclose(got.kf_t.numpy(), np.asarray(ref.kf_t), atol=1e-4)
        np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(got.obs_outlier.numpy(), np.asarray(ref.obs_outlier))
    assert np.asarray(ref1.obs_outlier)[bad].all()


def test_ba_abort_matches_jax(world):
    """A local BA cut between its stages: both mappers run stage 1 for
    keyframe 4 (`ba_d`, `ba_m`), ignore an abort for another keyframe, then
    abort: the 5-iteration poses and points are written back and no
    observation is erased, a few corrupted observations included."""
    from orbslam_jpminipc_tpu.pipeline.local_mapping import LocalMapper as JaxLocalMapper
    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.pipeline.local_mapping import LocalMapper

    jst, _, _, _ = _both(world)
    rng = np.random.default_rng(11)
    jst.kf_t[1:N_KF] += rng.normal(0, 0.01, (N_KF - 1, 3)).astype(np.float32)
    feats = np.nonzero(jst.kf_point[3] >= 0)[0][:8]
    jst.kf_xy[3, feats] += np.float32(25.0)
    tst, _ = tdmap.map_from_snapshot(copy.deepcopy(jst), device="cpu")
    jm = JaxLocalMapper(CFG, jst)
    tm = LocalMapper(SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0), tst, device="cpu")
    jm.dmap.sync_all(jst)
    tm.dmap.sync_all(tst)
    before = [(st.kf_R.copy(), st.kf_t.copy(), st.mp_xyz.copy(), st.mp_obs_kf.copy())
              for st in (jst, tst)]
    for m in (jm, tm):
        for stage in ("ba_d", "ba_m"):
            m.run_stage(4, stage)
        m.run_stage(3, "ba_abort")
    for st, (R0, t0, x0, o0) in zip((jst, tst), before):
        np.testing.assert_array_equal(st.kf_t, t0)  # held until stage 2 or an abort
        np.testing.assert_array_equal(st.mp_xyz, x0)
    assert jm._ba_stage1 is not None and tm._ba_stage1 is not None
    for m in (jm, tm):
        m.run_stage(4, "ba_abort")
    assert jm._ba_stage1 is None and tm._ba_stage1 is None
    assert np.abs(jst.kf_t - before[0][1]).max() > 1e-3  # the poses moved
    np.testing.assert_allclose(tst.kf_R, jst.kf_R, atol=1e-4)
    np.testing.assert_allclose(tst.kf_t, jst.kf_t, atol=1e-4)
    np.testing.assert_allclose(tst.mp_xyz, jst.mp_xyz, rtol=1e-4, atol=1e-4)
    for st, (_, _, _, o0) in zip((jst, tst), before):
        np.testing.assert_array_equal(st.mp_obs_kf, o0)


def test_slice_kernel_matches_jax(world):
    jst, jdm, tst, tdm = _both(world)
    M = 512
    pts = np.nonzero(jst.mp_valid)[0]
    ids = np.zeros(M, np.int32)
    ids[:len(pts)] = pts
    rv = np.arange(M) < len(pts)
    rv[3] = False
    n_obs = (jst.mp_obs_kf[ids] >= 0).sum(axis=1).astype(np.float32)
    ref = np.asarray(jdmap.slice_kernel(jdm.mp_xyz, jdm.mp_desc, jdm.mp_normal, jdm.mp_min_dist,
                                        jdm.mp_max_dist, jdm.mp_valid, ids, rv, n_obs))
    got = tdmap.slice_kernel(tdm, ids, rv, n_obs)
    want = tfused.slice_from_packed(ref, "cpu")
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                      err_msg=name)


def test_fused_refresh_slice_matches_reference_packing(world):
    """The host-side slice packing (the tracker's refresh) against the
    reference package's `pack_slice` layout."""
    from orbslam_jpminipc_tpu.frontend import fused_track as jfused
    from orbslam_jpminipc_torch.config import SlamConfig

    st = world[0]
    pts = np.nonzero(st.mp_valid)[0][:100]
    n_obs = (st.mp_obs_kf[pts] >= 0).sum(axis=1).astype(np.float32)
    args = (st.mp_xyz[pts], st.mp_normal[pts], st.mp_min_dist[pts], st.mp_max_dist[pts],
            st.mp_desc[pts], n_obs, len(pts))
    ref = np.asarray(jfused.pack_slice(*args, m=256))
    np.testing.assert_array_equal(tfused.pack_slice(*args, m=256), ref)
    tst, _ = tdmap.map_from_snapshot(copy.deepcopy(st), device="cpu")
    ctx = tfused.FusedContext(SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0), n_map=256, device="cpu")
    ctx.refresh_slice(tst, pts)
    want = tfused.slice_from_packed(ref, "cpu")
    for name in want._fields:
        np.testing.assert_array_equal(getattr(ctx.slice, name).numpy(),
                                      getattr(want, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(ctx.slice_ids, pts)
    np.testing.assert_array_equal(ctx.slice_gen, st.mp_gen[pts])


# ---------------------------------------------------------------------------
# culling and the native map-graph runtime
# ---------------------------------------------------------------------------


def test_cull_recent_points_matches_jax(world):
    jst, _, tst, _ = _both(world)
    ids = np.nonzero(jst.mp_valid)[0]
    probation = [(int(i), int(jst.mp_gen[i])) for i in ids]
    probation.append((int(ids[0]), int(jst.mp_gen[ids[0]]) + 1))  # a stale entry
    keep_j = jcull.cull_recent_points(jst, list(probation), current_kf_id=3)
    keep_t = tcull.cull_recent_points(tst, list(probation), current_kf_id=3)
    assert keep_t == keep_j and len(keep_j) < len(probation)
    np.testing.assert_array_equal(tst.mp_valid, jst.mp_valid)
    np.testing.assert_array_equal(tst.mp_gen, jst.mp_gen)
    np.testing.assert_array_equal(tst.kf_point, jst.kf_point)


@pytest.mark.parametrize("runtime", ["native", "python"])
def test_cull_redundant_keyframes_matches_jax(world, runtime, monkeypatch):
    jst, _, tst, _ = _both(world)
    # every mapped point seen at level 0 in the other keyframes: keyframes
    # become redundant, and each erasure changes the next one's count
    for st in (jst, tst):
        st.kf_level[:, :] = np.where(np.arange(N_FEAT) % 7 == 0, 1, 0)
    if runtime == "python":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    else:
        assert tnative.get_lib() is not None, "g++ should build the map-graph library"
    cands = np.arange(N_KF)
    ref = jcull.cull_redundant_keyframes(jst, cands)
    got = tcull.cull_redundant_keyframes(tst, cands)
    assert got == ref and len(ref) >= 1 and 0 not in ref
    for name in ("kf_valid", "kf_point", "mp_obs_kf", "mp_obs_feat", "mp_valid", "mp_gen"):
        np.testing.assert_array_equal(getattr(tst, name), getattr(jst, name), err_msg=name)


def test_native_add_observations_and_ba_obs_match_python(world):
    _, _, tst, _ = _both(world)
    lib = tnative.get_lib()
    assert lib is not None
    st_py = copy.deepcopy(tst)
    feats = np.nonzero((tst.kf_point[4] < 0) & tst.kf_feat_valid[4])[0][:40]
    pts = np.nonzero(tst.mp_valid)[0][120:160]
    n = tnative.add_observations_native(tst, 4, feats, pts)
    for f, p in zip(feats, pts):
        st_py.add_observation(int(p), 4, int(f))
    assert n == len(feats)
    np.testing.assert_array_equal(tst.kf_point, st_py.kf_point)
    np.testing.assert_array_equal(tst.mp_obs_kf, st_py.mp_obs_kf)
    np.testing.assert_array_equal(tst.mp_obs_feat, st_py.mp_obs_feat)
    kidx = np.full(tst.max_kf, -1, np.int32)
    kidx[:N_KF] = np.arange(N_KF)
    out = tnative.build_ba_obs_native(tst, pts, kidx, 4096)
    want = [(kidx[k], i, f) for i, p in enumerate(pts)
            for k, f in zip(tst.mp_obs_kf[p], tst.mp_obs_feat[p]) if k >= 0 and kidx[k] >= 0]
    got = sorted(zip(out[0].tolist(), out[1].tolist(), out[2].tolist()), key=lambda x: (x[1], x[0]))
    assert got == sorted(want, key=lambda x: (x[1], x[0]))


# ---------------------------------------------------------------------------
# trajectory output
# ---------------------------------------------------------------------------


def test_trajectory_io_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    traj = []
    for i in range(20):
        R, t = _pose(rng.normal(0, 1.0, 3), rng.normal(0, 1, 3))
        traj.append((0.1 * i, R, t))
    q_ref = np.asarray(jse3.quat_from_mat(jnp.asarray(np.stack([r for _, r, _ in traj]))))
    q_got = tse3.quat_from_mat(T(np.stack([r for _, r, _ in traj]))).numpy()
    np.testing.assert_allclose(q_got, q_ref, atol=1e-6)
    jtraj.save_tum(str(tmp_path / "ref.txt"), traj)
    ttraj.save_tum(str(tmp_path / "got.txt"), traj)
    ref = np.loadtxt(tmp_path / "ref.txt")
    got = np.loadtxt(tmp_path / "got.txt")
    np.testing.assert_allclose(got, ref, atol=2e-6)
    est = ttraj.camera_centers(traj)
    gt = est * 2.0 + rng.normal(0, 0.01, est.shape)
    assert ttraj.ate_rmse(est, gt) == pytest.approx(jtraj.ate_rmse(est, gt), rel=1e-9)
