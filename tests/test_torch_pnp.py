"""PyTorch port vs the JAX package: the relocalization solvers.

`hamming_pairwise` and `mutual_match` are integer work and held exact.

EPnP and the PnP RANSAC: the reference draws its minimal sets from a
`jax.random` key inside the program; the port takes them as an input, so
each case recomputes the reference's sets from its key as `solve_pnp` does
(uniform scores, masked to -1, `top_k(4)`) and injects them. Individual
hypotheses are NOT compared: a 4-point EPnP has a 4-dimensional null space
whose eigenvectors are not determined to rounding, and the two LAPACKs
give unrelated bases (measured: only 11-15 % of the 256 hypotheses agree
within 1e-3 on a general scene). What they vote for is determined: `success`
and the inlier set are held equal (at most 2 points may differ, and only
points within 1 % of their gate), R within `CASE_TOL[case][0]` and t within
`CASE_TOL[case][1]` of the scene's depth. Measured gaps (R max abs / t over
depth): general 1.2e-6 / 1.6e-6, near-planar 5.8e-6 / 3.6e-7, exactly
planar 1.7e-6 / 4.5e-6 (another draw of the planar scene reached 2.6e-3 /
3.6e-3: there the refit's null space is wider still); each case prints its
reading. The cases are those
of tests/test_sim3_pnp.py (general with 20 % outliers, near-planar with
40 %, exactly planar).

The two relocalization programs of the tracker are compared on a candidate
made from a real frame: the keyframe's rows are the frame's 2000-feature
extraction with world points behind them, the query is the same image's
1000-feature extraction seen from the same pose.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from orbslam_jpminipc_tpu.frontend import tracking as jtracking
from orbslam_jpminipc_tpu.ops import hamming as jhamming
from orbslam_jpminipc_tpu.ops import matching as jmatching
from orbslam_jpminipc_tpu.solvers import epnp as jepnp
from orbslam_jpminipc_tpu.solvers import pnp as jpnp
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend import tracking as ttracking
from orbslam_jpminipc_torch.frontend.frame import build_frame
from orbslam_jpminipc_torch.ops import hamming as thamming
from orbslam_jpminipc_torch.ops import matching as tmatching
from orbslam_jpminipc_torch.solvers import epnp as tepnp
from orbslam_jpminipc_torch.solvers import pnp as tpnp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLAM_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "slam_fixture_xyz.npz")
K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
# case -> (R bound, t bound as a share of the scene's depth)
CASE_TOL = {"general": (1e-3, 1e-3), "near_planar": (1e-3, 1e-3), "planar": (1e-3, 1e-3)}
GATE_BAND = 0.01        # a point may change sides only within 1 % of its gate
MAX_FLIPPED = 2

_jsolve = jax.jit(jpnp.solve_pnp, static_argnames=("n_hyp", "min_inliers", "min_set"))
_jepnp = jax.jit(jepnp.epnp_pose)
t_ = torch.from_numpy


def _jax_sets(key, mask, n_hyp=256, min_set=4):
    """The minimal sets `solve_pnp` draws from `key` (its first lines)."""
    scores = jax.random.uniform(key, (n_hyp, mask.shape[0]))
    scores = jnp.where(jnp.asarray(mask)[None, :], scores, -1.0)
    return np.array(jax.lax.top_k(scores, min_set)[1])


# ---- integer work -----------------------------------------------------------

@pytest.mark.parametrize("shape1,shape2", [((50, 32), (50, 32)), ((7, 1, 32), (7, 16, 32)),
                                            ((1, 32), (9, 32))])
def test_hamming_pairwise_exact(shape1, shape2):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, shape1).astype(np.uint8)
    b = rng.integers(0, 256, shape2).astype(np.uint8)
    b[..., :3, :] = a[..., :3, :] if a.shape == b.shape else b[..., :3, :]
    ref = np.asarray(jhamming.hamming_pairwise(jnp.asarray(a), jnp.asarray(b)))
    got = thamming.hamming_pairwise(t_(a), t_(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, np.unpackbits(a ^ b, axis=-1).sum(-1))


def _match_inputs(seed, n1=300, n2=500):
    """Two feature sets sharing noisy copies of descriptors, with
    duplicates (ties) and an in-plane rotation between them."""
    rng = np.random.default_rng(seed)
    d2 = rng.integers(0, 256, (n2, 32)).astype(np.uint8)
    src = rng.integers(0, n2, n1)
    d1 = d2[src].copy()
    flips = rng.integers(0, 256, (n1, 32)).astype(np.uint8) & rng.integers(
        0, 256, (n1, 32)).astype(np.uint8) & rng.integers(0, 256, (n1, 32)).astype(np.uint8)
    d1 ^= flips
    d1[:20] = d2[src[:20]]          # exact copies
    d2[-10:] = d2[:10]              # duplicated targets: equal distances
    a2 = rng.uniform(0, 360, n2).astype(np.float32)
    a1 = ((a2[src] + 20.0 + rng.normal(0, 3, n1)) % 360).astype(np.float32)
    a1[::9] = rng.uniform(0, 360, len(a1[::9])).astype(np.float32)
    v1 = rng.random(n1) < 0.9
    v2 = rng.random(n2) < 0.9
    return d1, a1, v1, d2, a2, v2


@pytest.mark.parametrize("kw", [dict(max_dist=50, nn_ratio=0.75, check_rotation=True),
                                dict(max_dist=100, nn_ratio=0.9, check_rotation=False),
                                "extra_mask"])
def test_mutual_match_exact(kw):
    d1, a1, v1, d2, a2, v2 = _match_inputs(1)
    jkw, tkw = {}, {}
    if kw == "extra_mask":
        extra = np.random.default_rng(2).random((len(d1), len(d2))) < 0.7
        jkw, tkw = dict(extra_mask=jnp.asarray(extra)), dict(extra_mask=t_(extra))
    else:
        jkw = tkw = kw
    ref = jmatching.mutual_match(*map(jnp.asarray, (d1, a1, v1, d2, a2, v2)), **jkw)
    got = tmatching.mutual_match(*map(t_, (d1, a1, v1, d2, a2, v2)), **tkw)
    rmask = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), rmask)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    assert rmask.sum() > 50


# ---- EPnP ------------------------------------------------------------------

def _project(xw, R, t):
    xc = xw @ R.T + t
    return np.stack([K4[0] * xc[:, 0] / xc[:, 2] + K4[2],
                     K4[1] * xc[:, 1] / xc[:, 2] + K4[3]], 1).astype(np.float32)


@pytest.mark.parametrize("trial", range(5))
def test_epnp_pose_matches_jax_on_clean_points(trial):
    """12 clean correspondences (the reference's cv2-oracle case): the pose
    is determined, so both packages must give it."""
    rng = np.random.default_rng(20 + trial)
    n = 12
    xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(-1, 1, n)], 1).astype(np.float32)
    R_true = Rotation.from_rotvec(rng.normal(0, 0.4, 3)).as_matrix()
    t_true = np.array([0.2, -0.1, 4.0]) + rng.normal(0, 0.2, 3)
    uv = _project(xw, R_true, t_true)
    w = np.ones((1, n), np.float32)
    Rj, tj, okj = _jepnp(jnp.asarray(xw)[None], jnp.asarray(uv)[None], jnp.asarray(w),
                         jnp.asarray(K4))
    Rt, tt, okt = tepnp.epnp_pose(t_(xw)[None], t_(uv)[None], t_(w), t_(K4))
    assert bool(okj[0]) and bool(okt[0])
    dR = float(np.abs(Rt[0].numpy() - np.asarray(Rj[0])).max())
    dt = float(np.abs(tt[0].numpy() - np.asarray(tj[0])).max())
    print(f"epnp clean trial {trial}: dR {dR:.3g} dt {dt:.3g}")
    assert dR < 1e-3 and dt < 4e-3
    np.testing.assert_allclose(Rt[0].numpy(), R_true, atol=5e-3)
    np.testing.assert_allclose(tt[0].numpy(), t_true, atol=2e-2)


def test_epnp_pose_masks_points_by_weight_like_jax():
    """Zero-weight points (garbage pixels) must not move the pose; the
    batch carries different weights per row."""
    rng = np.random.default_rng(30)
    n = 40
    xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 8, n)], 1).astype(np.float32)
    R_true = Rotation.from_rotvec([0.1, -0.2, 0.05]).as_matrix()
    t_true = np.array([0.3, -0.1, 0.5])
    uv = _project(xw, R_true, t_true)
    uv[:10] = rng.uniform(0, 640, (10, 2)).astype(np.float32)
    w = np.ones((2, n), np.float32)
    w[:, :10] = 0.0
    w[1, 10:20] = 0.0
    args_j = (jnp.broadcast_to(jnp.asarray(xw), (2, n, 3)), jnp.broadcast_to(jnp.asarray(uv), (2, n, 2)),
              jnp.asarray(w), jnp.asarray(K4))
    args_t = (t_(xw).expand(2, n, 3), t_(uv).expand(2, n, 2), t_(w), t_(K4))
    Rj, tj, okj = _jepnp(*args_j)
    Rt, tt, okt = tepnp.epnp_pose(*args_t)
    assert np.asarray(okj).all() and okt.numpy().all()
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=4e-3)
    np.testing.assert_allclose(Rt[0].numpy(), R_true, atol=5e-3)


# ---- PnP RANSAC -------------------------------------------------------------

def _scene(case):
    """The reference's own test scenes (tests/test_sim3_pnp.py:132-265)."""
    rng = np.random.default_rng({"general": 0, "near_planar": 1, "planar": 2}[case])
    if case == "general":
        n, z, frac, noise, gate = 100, None, 0.2, 0.5, 5.991
        rotvec, t = np.array([0.1, -0.2, 0.05]), np.array([0.3, -0.1, 0.5])
    elif case == "near_planar":
        n, z, frac, noise, gate = 80, None, 0.4, 0.5, 5.991 * 4.0
        rotvec, t = None, np.array([0.1, 0.0, 4.0])
    else:
        n, z, frac, noise, gate = 60, 0.0, 0.0, 0.3, 5.991 * 4.0
        rotvec, t = None, np.array([0.05, -0.1, 4.0])
    x, y = rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n)
    if case == "general":
        zz = rng.uniform(3, 8, n)
    elif case == "near_planar":
        zz = rng.normal(0, 0.02, n)
    else:
        zz = np.zeros(n)
    xw = np.stack([x, y, zz], 1).astype(np.float32)
    if rotvec is None:
        rotvec = rng.normal(0, 0.3 if case == "near_planar" else 0.25, 3)
    R = Rotation.from_rotvec(rotvec).as_matrix()
    uv = _project(xw, R, t)
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    n_out = int(frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] = rng.uniform(0, 640, (n_out, 2)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[rng.choice(n, 5, replace=False)] = False
    depth = float(np.median((xw @ R.T + t)[:, 2]))
    return xw, uv, mask, np.full(n, gate, np.float32), R, t, depth, n - n_out


@pytest.mark.parametrize("case", ["general", "near_planar", "planar"])
def test_solve_pnp_matches_jax(case):
    xw, uv, mask, gate, R_true, t_true, depth, n_good = _scene(case)
    key = jax.random.key(3)
    ref = _jsolve(key, jnp.asarray(xw), jnp.asarray(uv), jnp.asarray(mask), jnp.asarray(K4),
                  jnp.asarray(gate))
    sets = _jax_sets(key, mask)
    got = tpnp.solve_pnp(t_(sets), t_(xw), t_(uv), t_(mask), t_(K4), t_(gate))
    assert bool(ref.success), "the case must succeed in the reference"
    assert bool(got.success)
    rin, gin = np.asarray(ref.inliers), got.inliers.numpy()
    flipped = np.nonzero(rin != gin)[0]
    # a point that changed sides must sit on its gate
    err2 = np.sum((_project(xw, got.R.numpy().astype(np.float64), got.t.numpy().astype(np.float64))
                   - uv) ** 2, axis=1)
    assert len(flipped) <= MAX_FLIPPED
    assert np.all(np.abs(err2[flipped] - gate[flipped]) <= GATE_BAND * gate[flipped])
    assert int(got.n_inliers) == int(gin.sum()) and not gin[~mask].any()
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= MAX_FLIPPED
    assert int(got.n_inliers) >= 0.8 * (n_good - 5)
    dR = float(np.abs(got.R.numpy() - np.asarray(ref.R)).max())
    dt = float(np.abs(got.t.numpy() - np.asarray(ref.t)).max()) / depth
    r_tol, t_tol = CASE_TOL[case]
    print(f"solve_pnp {case}: dR {dR:.3g} (bound {r_tol}), dt/depth {dt:.3g} (bound {t_tol}), "
          f"inliers {int(got.n_inliers)} (ref {int(ref.n_inliers)}), flipped {len(flipped)}")
    assert dR <= r_tol and dt <= t_tol
    np.testing.assert_allclose(got.R.numpy(), R_true, atol=3e-2)
    np.testing.assert_allclose(got.t.numpy(), t_true, atol=0.1)


def test_solve_pnp_fails_on_garbage_like_jax():
    rng = np.random.default_rng(4)
    n = 16
    xw = (rng.uniform(-1, 1, (n, 3)) + [0, 0, 5]).astype(np.float32)
    uv = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    mask, gate = np.ones(n, bool), np.full(n, 5.991, np.float32)
    key = jax.random.key(1)
    ref = _jsolve(key, jnp.asarray(xw), jnp.asarray(uv), jnp.asarray(mask), jnp.asarray(K4),
                  jnp.asarray(gate))
    got = tpnp.solve_pnp(t_(_jax_sets(key, mask)), t_(xw), t_(uv), t_(mask), t_(K4), t_(gate))
    assert not bool(ref.success) and not bool(got.success)


def test_solve_pnp_survives_an_empty_mask():
    """No valid point (a candidate with no match): every set is garbage,
    nothing may raise, the result is a failure with finite-or-not pose."""
    n = 64
    xw = np.zeros((n, 3), np.float32)
    uv = np.zeros((n, 2), np.float32)
    mask, gate = np.zeros(n, bool), np.full(n, 5.991, np.float32)
    sets = tpnp.sample_minimal_sets(t_(mask), 256, torch.Generator().manual_seed(0))
    got = tpnp.solve_pnp(sets, t_(xw), t_(uv), t_(mask), t_(K4), t_(gate))
    assert not bool(got.success) and int(got.n_inliers) == 0


def test_best_hypothesis_tie_goes_to_the_lowest_like_argmax():
    """Equal inlier counts: the reference's `argmax` takes the first; the
    port's keyed maximum must too. All sets identical -> all counts equal."""
    xw, uv, mask, gate, *_ = _scene("general")
    good = np.nonzero(mask)[0][20:24]
    sets = np.tile(good, (256, 1)).astype(np.int32)
    got = tpnp.solve_pnp(t_(sets), t_(xw), t_(uv), t_(mask), t_(K4), t_(gate))
    one = tpnp.solve_pnp(t_(sets[:1].repeat(2, 0)), t_(xw), t_(uv), t_(mask), t_(K4), t_(gate))
    np.testing.assert_array_equal(got.inliers.numpy(), one.inliers.numpy())


def test_sample_minimal_sets_draws_distinct_valid_points():
    mask = np.zeros(200, bool)
    mask[np.random.default_rng(5).choice(200, 30, replace=False)] = True
    gen = torch.Generator().manual_seed(7)
    sets = tpnp.sample_minimal_sets(t_(mask), 256, gen).numpy()
    assert sets.shape == (256, 4)
    assert mask[sets].all()
    assert all(len(set(row)) == 4 for row in sets.tolist())
    again = tpnp.sample_minimal_sets(t_(mask), 256, torch.Generator().manual_seed(7)).numpy()
    np.testing.assert_array_equal(sets, again)
    assert len({tuple(r) for r in sets.tolist()}) > 200


def test_dlt_pose_matches_jax():
    rng = np.random.default_rng(6)
    n = 30
    xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 8, n)], 1).astype(np.float32)
    R_true = Rotation.from_rotvec([0.1, -0.2, 0.05]).as_matrix()
    t_true = np.array([0.3, -0.1, 0.5])
    xc = xw @ R_true.T + t_true
    rays = (xc[:, :2] / xc[:, 2:]).astype(np.float32)
    w = np.ones(n, np.float32)
    w[:4] = 0.0
    Rj, tj, okj = jpnp._dlt_pose(jnp.asarray(xw), jnp.asarray(rays), jnp.asarray(w))
    Rt, tt, okt = tpnp._dlt_pose(t_(xw), t_(rays), t_(w))
    assert bool(okj) and bool(okt)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=5e-3)
    np.testing.assert_allclose(Rt.numpy(), R_true, atol=5e-3)


# ---- the tracker's relocalization programs ------------------------------------

@pytest.fixture(scope="module")
def candidate():
    """A relocalization candidate from a real frame (see the module's
    docstring): the arguments of `_reloc_candidate_prog` as numpy."""
    fx = np.load(SLAM_FIXTURE)
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=1000)
    img = fx["images"][10]
    kf = build_frame(img, cfg, n_features=2000, device="cpu")
    fr = build_frame(img, cfg, n_features=1000, device="cpu")
    R, t = fx["gt_R"][10].astype(np.float64), fx["gt_t"][10].astype(np.float64)
    rng = np.random.default_rng(8)
    # world points behind the keyframe's features, on a tilted surface
    depth = 2.0 + 0.002 * kf.xy_un[:, 0] + 0.001 * kf.xy_un[:, 1] + rng.normal(0, 0.05, len(kf.xy_un))
    xc = np.stack([(kf.xy_un[:, 0] - K4[2]) / K4[0] * depth,
                   (kf.xy_un[:, 1] - K4[3]) / K4[1] * depth, depth], 1)
    kf_xw = ((xc - t) @ R).astype(np.float32)
    kf_has = kf.valid & (rng.random(len(kf.valid)) < 0.7)
    lvl = np.clip(fr.level, 0, cfg.n_levels - 1)
    return dict(
        f_desc=fr.desc, f_xy=fr.xy_un, f_angle=fr.angle, f_level=fr.level, f_valid=fr.valid,
        w=cfg.inv_sigma2[lvl].astype(np.float32),
        kf_desc=kf.desc, kf_angle=kf.angle, kf_has=kf_has, kf_xw=kf_xw,
        max_err2=(5.991 * cfg.sigma2[lvl]).astype(np.float32), K4=K4,
        kf_level=kf.level, R=R.astype(np.float32), t=t.astype(np.float32),
        scale_factors=cfg.scale_factors.astype(np.float32))


CAND_ARGS = ("f_desc", "f_xy", "f_angle", "f_level", "f_valid", "w",
             "kf_desc", "kf_angle", "kf_has", "kf_xw", "max_err2", "K4")


def test_reloc_candidate_prog_matches_jax(candidate):
    key = jax.random.key(9)
    args = [candidate[k] for k in CAND_ARGS]
    jidx, jmask, jok, jsel, jopt = jax.tree.map(
        np.asarray, jtracking._reloc_candidate_prog(key, *map(jnp.asarray, args)))
    sets = _jax_sets(key, jmask)
    idx, mask, ok, sel, opt = ttracking._reloc_candidate_prog(
        lambda m, n_hyp: t_(sets), *map(t_, args))
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_array_equal(idx.numpy()[jmask], jidx[jmask])
    assert bool(jok) and bool(ok) and jmask.sum() > 300
    flipped = int((sel.numpy() != jsel).sum())
    dR = float(np.abs(opt.R.numpy() - jopt.R).max())
    dt = float(np.abs(opt.t.numpy() - jopt.t).max())
    print(f"candidate program: sel differs on {flipped}, inliers {int(opt.n_inliers)} "
          f"(ref {int(jopt.n_inliers)}), dR {dR:.3g}, dt {dt:.3g}")
    assert flipped <= MAX_FLIPPED
    assert abs(int(opt.n_inliers) - int(jopt.n_inliers)) <= MAX_FLIPPED
    assert dR <= 1e-4 and dt <= 1e-3
    np.testing.assert_allclose(opt.R.numpy(), candidate["R"], atol=2e-3)
    np.testing.assert_allclose(opt.t.numpy(), candidate["t"], atol=1e-2)


@pytest.mark.parametrize("radius,max_dist", [(10.0, 100), (3.0, 64)])
def test_reloc_refine_prog_matches_jax(candidate, radius, max_dist):
    """A ladder rung from a slightly wrong pose with a third of the
    bindings known: it must find the rest and agree with the reference."""
    c = candidate
    rng = np.random.default_rng(10)
    R0 = (Rotation.from_rotvec([0.002, -0.001, 0.001]).as_matrix() @ c["R"]).astype(np.float32)
    t0 = (c["t"] + np.float32([0.004, -0.003, 0.002])).astype(np.float32)
    xc = c["kf_xw"] @ R0.T + t0
    uv_proj = np.stack([K4[0] * xc[:, 0] / np.maximum(xc[:, 2], 1e-9) + K4[2],
                        K4[1] * xc[:, 1] / np.maximum(xc[:, 2], 1e-9) + K4[3]], 1).astype(np.float32)
    valid_q = c["kf_has"] & (xc[:, 2] > 0)
    n = len(c["f_valid"])
    # prior bindings: a third of the frame's features, from the true pose
    m = tmatching.mutual_match(t_(c["f_desc"]), t_(c["f_angle"]), t_(c["f_valid"]),
                               t_(c["kf_desc"]), t_(c["kf_angle"]), t_(c["kf_has"]), max_dist=50)
    prev_has = m.mask.numpy() & (rng.random(n) < 0.33)
    prev_xw = c["kf_xw"][m.idx.numpy()]
    args = (c["kf_desc"], uv_proj, c["kf_level"], valid_q, c["kf_xw"],
            c["f_desc"], c["f_xy"], c["f_level"], c["f_valid"], prev_xw, prev_has,
            c["w"], R0, t0, K4, c["scale_factors"])
    jidx, jmask, jfeat_q, jhas, jres = jax.tree.map(np.asarray, jtracking._reloc_refine_prog(
        *map(jnp.asarray, args), radius=radius, max_dist=max_dist))
    idx, mask, feat_q, has, res = ttracking._reloc_refine_prog(
        *map(t_, args), radius=radius, max_dist=max_dist)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_array_equal(idx.numpy()[jmask], jidx[jmask])
    np.testing.assert_array_equal(feat_q.numpy(), jfeat_q)
    np.testing.assert_array_equal(has.numpy(), jhas)
    np.testing.assert_array_equal(res.inliers.numpy(), jres.inliers)
    np.testing.assert_allclose(res.R.numpy(), jres.R, atol=1e-5)
    np.testing.assert_allclose(res.t.numpy(), jres.t, atol=1e-4)
    assert int(res.n_inliers) == int(jres.n_inliers) >= 50
    assert (feat_q.numpy() >= 0).sum() > prev_has.sum()
