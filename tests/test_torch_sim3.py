"""PyTorch port vs the JAX package: the Sim3 group, the new SE3 functions,
Horn's closed form, the Sim3 RANSAC and the Sim3 refinement.

The same numpy inputs go through both packages, the port on the CPU.
Tolerances: group functions 1e-5; `horn_sim3` s, R, t within 1e-4 on
well-spread triples; `solve_sim3` with the reference's minimal sets
injected (recomputed from its key as `solve_sim3` draws them: uniform
scores, masked to -1, `top_k(3)`): success and inlier set equal, s/R/t
within 1e-4; `optimize_sim3` from a perturbed start: inlier set equal,
s/R/t within 1e-4. Single hypotheses of the RANSAC are not compared: on a
near-collinear triple the top eigenvector of Horn's 4x4 matrix is not
determined to rounding, and the two LAPACKs differ there; the chosen
hypothesis's outcome is determined. The port writes the refinement's 4x7
Jacobian out by hand; it is held to `jax.jacfwd` of the reference's
residual, the identity and a near-pi rotation included.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from orbslam_jpminipc_tpu.geometry import camera as jcam
from orbslam_jpminipc_tpu.geometry import se3 as jse3
from orbslam_jpminipc_tpu.geometry import sim3 as jsim3
from orbslam_jpminipc_tpu.solvers import sim3_opt as jopt
from orbslam_jpminipc_tpu.solvers import sim3solver as jsolver
from orbslam_jpminipc_torch.geometry import se3 as tse3
from orbslam_jpminipc_torch.geometry import sim3 as tsim3
from orbslam_jpminipc_torch.solvers import sim3_opt as topt
from orbslam_jpminipc_torch.solvers import sim3solver as tsolver

torch.set_num_threads(2)

K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
TOL = 1e-5
t_ = torch.from_numpy
j_ = jnp.asarray

_jsolve = jax.jit(jsolver.solve_sim3, static_argnames=("n_hyp", "min_inliers", "fix_scale"))


def _np(x):
    return np.asarray(x)


def _rotations(rng, n):
    """Random rotations, plus the identity, a tiny angle, and angles within
    1e-3 and 1e-6 of pi about a skew axis."""
    rv = rng.normal(0, 1.0, (n, 3))
    axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    rv[0] = 0.0
    rv[1] = 1e-7 * axis
    rv[2] = (np.pi - 1e-3) * axis
    rv[3] = (np.pi - 1e-6) * axis
    return Rotation.from_rotvec(rv).as_matrix().astype(np.float32), rv.astype(np.float32)


def _xi_cases(rng, n):
    """Sim3 tangents covering the branches of `_W_matrix`: general, sigma
    below 1e-6, theta below 1e-6, both, and zero."""
    xi = rng.normal(0, 0.4, (n, 7)).astype(np.float32)
    xi[0] = 0.0
    xi[1, 6] = 1e-8                      # small sigma, general theta
    xi[2, :3] = 1e-8                     # small theta, general sigma
    xi[3, :3] = 1e-8
    xi[3, 6] = -1e-8                     # both small
    xi[4, :3] *= 5.0                     # a large rotation
    return xi


# ---- se3 ---------------------------------------------------------------------

def test_new_se3_functions_match_jax():
    rng = np.random.default_rng(0)
    R, _ = _rotations(rng, 16)
    t = rng.normal(0, 1, (16, 3)).astype(np.float32)
    x = rng.normal(0, 2, (16, 3)).astype(np.float32)
    xi = rng.normal(0, 0.3, (16, 6)).astype(np.float32)
    W = rng.normal(0, 1, (16, 3, 3)).astype(np.float32)
    q = rng.normal(0, 1, (16, 4)).astype(np.float32)
    q2 = rng.normal(0, 1, (16, 4)).astype(np.float32)
    np.testing.assert_array_equal(tse3.vee(t_(W)).numpy(), _np(jse3.vee(j_(W))))
    np.testing.assert_array_equal(tse3.vee(tse3.hat(t_(t))).numpy(), t)
    for got, ref in zip(tse3.inverse(t_(R), t_(t)), jse3.inverse(j_(R), j_(t))):
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=TOL)
    np.testing.assert_allclose(tse3.transform(t_(R), t_(t), t_(x)).numpy(),
                               _np(jse3.transform(j_(R), j_(t), j_(x))), atol=TOL)
    for got, ref in zip(tse3.retract(t_(R), t_(t), t_(xi)), jse3.retract(j_(R), j_(t), j_(xi))):
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=TOL)
    np.testing.assert_allclose(tse3.mat_from_quat(t_(q)).numpy(), _np(jse3.mat_from_quat(j_(q))),
                               atol=TOL)
    np.testing.assert_allclose(tse3.quat_mul(t_(q), t_(q2)).numpy(),
                               _np(jse3.quat_mul(j_(q), j_(q2))), atol=TOL)
    np.testing.assert_allclose(tse3.quat_from_mat(t_(R)).numpy(), _np(jse3.quat_from_mat(j_(R))),
                               atol=TOL)


def test_log_so3_matches_jax_at_identity_and_near_pi():
    rng = np.random.default_rng(1)
    R, rv = _rotations(rng, 32)
    got = tse3.log_so3(t_(R)).numpy()
    ref = _np(jse3.log_so3(j_(R)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL)
    np.testing.assert_array_equal(got[0], np.zeros(3, np.float32))
    # it inverts exp_so3 (up to the sign of the axis at pi)
    back = tse3.exp_so3(t_(got)).numpy()
    np.testing.assert_allclose(back, R, atol=2e-4)
    assert abs(np.linalg.norm(got[2]) - (np.pi - 1e-3)) < 1e-3


# ---- sim3 --------------------------------------------------------------------

def test_sim3_group_functions_match_jax():
    rng = np.random.default_rng(2)
    n = 16
    Ra, _ = _rotations(rng, n)
    Rb = Rotation.from_rotvec(rng.normal(0, 0.8, (n, 3))).as_matrix().astype(np.float32)
    sa = rng.uniform(0.5, 2.0, n).astype(np.float32)
    sb = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ta = rng.normal(0, 1, (n, 3)).astype(np.float32)
    tb = rng.normal(0, 1, (n, 3)).astype(np.float32)
    x = rng.normal(0, 2, (n, 3)).astype(np.float32)
    np.testing.assert_allclose(tsim3.transform(t_(sa), t_(Ra), t_(ta), t_(x)).numpy(),
                               _np(jsim3.transform(j_(sa), j_(Ra), j_(ta), j_(x))), atol=TOL)
    for got, ref in zip(tsim3.compose(t_(sa), t_(Ra), t_(ta), t_(sb), t_(Rb), t_(tb)),
                        jsim3.compose(j_(sa), j_(Ra), j_(ta), j_(sb), j_(Rb), j_(tb))):
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=TOL)
    for got, ref in zip(tsim3.inverse(t_(sa), t_(Ra), t_(ta)),
                        jsim3.inverse(j_(sa), j_(Ra), j_(ta))):
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=TOL)
    p8 = tsim3.pack8(t_(sa), t_(Ra), t_(ta))
    np.testing.assert_allclose(p8.numpy(), _np(jsim3.pack8(j_(sa), j_(Ra), j_(ta))), atol=TOL)
    for got, ref in zip(tsim3.unpack8(p8), jsim3.unpack8(j_(p8.numpy()))):
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=TOL)
    for got, ref in zip(tsim3.identity(device="cpu"), jsim3.identity()):
        np.testing.assert_array_equal(got.numpy(), _np(ref))


def test_W_matrix_exp7_log7_match_jax_in_every_branch():
    rng = np.random.default_rng(3)
    xi = _xi_cases(rng, 24)
    W = tsim3._W_matrix(t_(xi[:, :3]), t_(xi[:, 6])).numpy()
    np.testing.assert_allclose(W, _np(jsim3._W_matrix(j_(xi[:, :3]), j_(xi[:, 6]))), atol=TOL)
    assert np.isfinite(W).all()
    np.testing.assert_allclose(W[0], np.eye(3), atol=1e-7)
    got = tsim3.exp7(t_(xi))
    ref = jsim3.exp7(j_(xi))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), _np(r), atol=TOL)
    # log7 on the reference's group elements, and the round trip
    ref_np = [np.array(r) for r in ref]
    back = tsim3.log7(*map(t_, ref_np)).numpy()
    np.testing.assert_allclose(back, _np(jsim3.log7(*ref)), atol=2e-5)
    small_rot = np.linalg.norm(xi[:, :3], axis=1) < 3.0   # the principal branch
    np.testing.assert_allclose(back[small_rot], xi[small_rot], atol=2e-5)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_retract_matches_jax(fix_scale):
    rng = np.random.default_rng(4)
    n = 12
    R, _ = _rotations(rng, n)
    s = rng.uniform(0.5, 2.0, n).astype(np.float32)
    t = rng.normal(0, 1, (n, 3)).astype(np.float32)
    xi = _xi_cases(rng, n)
    got = tsim3.retract(t_(s), t_(R), t_(t), t_(xi), fix_scale=fix_scale)
    ref = jsim3.retract(j_(s), j_(R), j_(t), j_(xi), fix_scale=fix_scale)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), _np(r), atol=TOL)
    if fix_scale:
        np.testing.assert_array_equal(got[0].numpy(), s)


# ---- Horn and the RANSAC --------------------------------------------------------

def _sim3_pair(seed, n=100, s_true=1.3, outliers=15, noise=0.005):
    """Matched 3D points in two camera frames related by a Sim3 (the scene
    of the reference's tests/test_sim3_pnp.py)."""
    rng = np.random.default_rng(seed)
    p2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
                  axis=1).astype(np.float32)
    R = Rotation.from_rotvec([0.1, -0.3, 0.05]).as_matrix().astype(np.float32)
    t = np.array([0.4, -0.2, 0.6], np.float32)
    p1 = s_true * p2 @ R.T + t
    p1 += rng.normal(0, noise, p1.shape).astype(np.float32)
    p1[:outliers] = rng.uniform(-3, 3, (outliers, 3)).astype(np.float32) + [0, 0, 5]
    p1 = p1.astype(np.float32)
    uv1 = np.array(jcam.project(j_(p1), j_(K4)))
    uv2 = np.array(jcam.project(j_(p2), j_(K4)))
    return p1, p2, uv1, uv2, s_true, R, t


def _jax_sets(key, mask, n_hyp=128):
    """The minimal sets `solve_sim3` draws from `key` (its first lines)."""
    scores = jax.random.uniform(key, (n_hyp, mask.shape[0]))
    scores = jnp.where(j_(mask)[None, :], scores, -1.0)
    return np.array(jax.lax.top_k(scores, 3)[1])


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_matches_jax_on_well_spread_triples(fix_scale):
    rng = np.random.default_rng(5)
    p1, p2, *_ = _sim3_pair(6, outliers=0, s_true=1.0 if fix_scale else 1.3)
    # triples whose smallest side is large: the eigenvector is determined
    sets = np.stack([rng.choice(len(p1), 3, replace=False) for _ in range(400)])
    tri = p2[sets]
    side = np.min([np.linalg.norm(tri[:, a] - tri[:, b], axis=1)
                   for a, b in ((0, 1), (1, 2), (0, 2))], axis=0)
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    sets = sets[(side > 1.0) & (area > 1.5)][:64]
    assert len(sets) == 64
    got = tsolver.horn_sim3(t_(p1[sets]), t_(p2[sets]), fix_scale=fix_scale)
    ref = jsolver.horn_sim3(j_(p1[sets]), j_(p2[sets]), fix_scale=fix_scale)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), _np(r), atol=1e-4)
    # and the noise-free case is exact (the reference's own test)
    p2e = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    Re = Rotation.from_rotvec([0.3, 0.1, -0.2]).as_matrix().astype(np.float32)
    p1e = (2.0 * p2e @ Re.T + np.array([1, 2, 3], np.float32)).astype(np.float32)
    s, R_e, t_e = tsolver.horn_sim3(t_(p1e)[None], t_(p2e)[None])
    assert abs(float(s[0]) - 2.0) < 1e-3
    np.testing.assert_allclose(R_e[0].numpy(), Re, atol=1e-4)
    np.testing.assert_allclose(t_e[0].numpy(), [1, 2, 3], atol=1e-3)


SCENES = {
    # the three scenes of the reference's tests: RANSAC with 15 % outliers,
    # the refinement's outlier-free pair, and a unit-scale pair (fix_scale)
    "outliers": dict(outliers=15, s_true=1.3, fix_scale=False),
    "clean": dict(outliers=0, s_true=1.3, fix_scale=False),
    "fixed_scale": dict(outliers=10, s_true=1.0, fix_scale=True),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_solve_sim3_matches_jax_with_its_sets_injected(scene):
    cfg = SCENES[scene]
    p1, p2, uv1, uv2, s_t, R_t, t_t = _sim3_pair(7, outliers=cfg["outliers"], s_true=cfg["s_true"])
    n = len(p1)
    mask = np.ones(n, bool)
    mask[np.random.default_rng(8).choice(n, 6, replace=False)] = False
    gate = np.full(n, 9.21, np.float32)
    key = jax.random.key(11)
    ref = _jsolve(key, j_(p1), j_(p2), j_(uv1), j_(uv2), j_(mask), j_(K4), j_(gate), j_(gate),
                  fix_scale=cfg["fix_scale"])
    got = tsolver.solve_sim3(t_(_jax_sets(key, mask)), t_(p1), t_(p2), t_(uv1), t_(uv2),
                             t_(mask), t_(K4), t_(gate), t_(gate), fix_scale=cfg["fix_scale"])
    assert bool(ref.success) and bool(got.success)
    np.testing.assert_array_equal(got.inliers.numpy(), _np(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) == int(got.inliers.sum())
    assert not got.inliers.numpy()[~mask].any()
    assert abs(float(got.s12) - float(ref.s12)) < 1e-4
    np.testing.assert_allclose(got.R12.numpy(), _np(ref.R12), atol=1e-4)
    np.testing.assert_allclose(got.t12.numpy(), _np(ref.t12), atol=1e-4)
    # and it is the scene's transform
    assert abs(float(got.s12) - s_t) < 0.02
    np.testing.assert_allclose(got.R12.numpy(), R_t, atol=1e-2)
    assert np.linalg.norm(got.t12.numpy() - t_t) < 0.1
    assert got.inliers.numpy()[:cfg["outliers"]].mean() < 0.2 if cfg["outliers"] else True


def test_solve_sim3_fails_with_too_few_valid_pairs_like_jax():
    p1, p2, uv1, uv2, *_ = _sim3_pair(9, outliers=0)
    n = len(p1)
    mask = np.zeros(n, bool)
    mask[:12] = True                     # fewer than min_inliers = 20
    gate = np.full(n, 9.21, np.float32)
    key = jax.random.key(12)
    ref = _jsolve(key, j_(p1), j_(p2), j_(uv1), j_(uv2), j_(mask), j_(K4), j_(gate), j_(gate))
    got = tsolver.solve_sim3(t_(_jax_sets(key, mask)), t_(p1), t_(p2), t_(uv1), t_(uv2),
                             t_(mask), t_(K4), t_(gate), t_(gate))
    assert not bool(ref.success) and not bool(got.success)
    assert int(got.n_inliers) == int(ref.n_inliers) <= 12
    # no valid pair at all: nothing raises, the result is a failure
    none = np.zeros(n, bool)
    sets = tsolver.sample_minimal_sets(t_(none), 128, torch.Generator().manual_seed(0))
    got = tsolver.solve_sim3(sets, t_(p1), t_(p2), t_(uv1), t_(uv2), t_(none), t_(K4),
                             t_(gate), t_(gate))
    assert not bool(got.success) and int(got.n_inliers) == 0


def test_best_hypothesis_tie_goes_to_the_lowest_like_argmax():
    p1, p2, uv1, uv2, *_ = _sim3_pair(10, outliers=15)
    n = len(p1)
    gate = np.full(n, 9.21, np.float32)
    mask = np.ones(n, bool)
    sets = np.tile(np.array([[20, 50, 80]]), (128, 1))
    sets[0] = [0, 1, 2]                  # an outlier triple first, then 127 equal ones
    args = (t_(p1), t_(p2), t_(uv1), t_(uv2), t_(mask), t_(K4), t_(gate), t_(gate))
    got = tsolver.solve_sim3(t_(sets), *args)
    one = tsolver.solve_sim3(t_(sets[:2]), *args)
    np.testing.assert_array_equal(got.inliers.numpy(), one.inliers.numpy())
    np.testing.assert_array_equal(got.R12.numpy(), one.R12.numpy())


def test_sample_minimal_sets_draws_distinct_valid_pairs():
    mask = np.zeros(300, bool)
    mask[np.random.default_rng(13).choice(300, 40, replace=False)] = True
    sets = tsolver.sample_minimal_sets(t_(mask), 128, torch.Generator().manual_seed(3)).numpy()
    assert sets.shape == (128, 3) and mask[sets].all()
    assert all(len(set(r)) == 3 for r in sets.tolist())
    again = tsolver.sample_minimal_sets(t_(mask), 128, torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(sets, again)


# ---- the refinement ---------------------------------------------------------------

def _perturbed_start(rng, s_t, R_t, t_t):
    xi = np.concatenate([rng.normal(0, 0.02, 6), [0.03]]).astype(np.float32)
    return [np.array(a) for a in jsim3.retract(jnp.float32(s_t), j_(R_t), j_(t_t), j_(xi))]


@pytest.mark.parametrize("fix_scale,outliers", [(False, 0), (False, 12), (True, 0)])
def test_optimize_sim3_matches_jax_from_a_perturbed_start(fix_scale, outliers):
    rng = np.random.default_rng(14)
    p1, p2, uv1, uv2, s_t, R_t, t_t = _sim3_pair(15, outliers=outliers,
                                                 s_true=1.0 if fix_scale else 1.3)
    n = len(p1)
    s0, R0, t0 = _perturbed_start(rng, s_t, R_t, t_t)
    if fix_scale:
        s0 = np.float32(1.0)
    w1 = rng.choice([1.0, 1 / 1.44, 1 / 2.0736], n).astype(np.float32)
    w2 = rng.choice([1.0, 1 / 1.44], n).astype(np.float32)
    valid = rng.random(n) < 0.9
    ref = jopt.optimize_sim3(j_(s0), j_(R0), j_(t0), j_(p1), j_(p2), j_(uv1), j_(uv2),
                             j_(w1), j_(w2), j_(valid), j_(K4), fix_scale=fix_scale)
    got = topt.optimize_sim3(t_(np.asarray(s0)), t_(R0), t_(t0), t_(p1), t_(p2), t_(uv1), t_(uv2),
                             t_(w1), t_(w2), t_(valid), t_(K4), fix_scale=fix_scale)
    np.testing.assert_array_equal(got.inliers.numpy(), _np(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) > 0.7 * (n - outliers)
    assert abs(float(got.s12) - float(ref.s12)) < 1e-4
    np.testing.assert_allclose(got.R12.numpy(), _np(ref.R12), atol=1e-4)
    np.testing.assert_allclose(got.t12.numpy(), _np(ref.t12), atol=1e-4)
    assert abs(float(got.s12) - s_t) < 0.01
    if fix_scale:
        assert float(got.s12) == 1.0


def _jax_residual(fix_scale):
    """The reference's residual (the closure inside its `optimize_sim3`)."""
    def residual(xi, s0, R0, t0, x1p, x2p, uv1p, uv2p):
        s, R, t = jsim3.retract(s0, R0, t0, xi, fix_scale=fix_scale)
        si, Ri, ti = jsim3.inverse(s, R, t)
        e1 = uv1p - jcam.project(jsim3.transform(s, R, t, x2p), j_(K4))
        e2 = uv2p - jcam.project(jsim3.transform(si, Ri, ti, x1p), j_(K4))
        return jnp.concatenate([e1, e2])
    return residual


@pytest.mark.parametrize("case", ["identity", "general", "near_pi"])
@pytest.mark.parametrize("fix_scale", [False, True])
def test_refinement_jacobian_matches_jax_jacfwd(case, fix_scale):
    """The hand-written 4x7 Jacobian against `jax.jacfwd` of the reference's
    residual at xi = 0: at the identity (zero rotation, unit scale), at a
    general Sim3 and at a rotation within 1e-3 of pi. Entries are of the
    order fx/z ~ 100 and fx ~ 500: held to 2e-3 absolute and 1e-5 relative."""
    rng = np.random.default_rng(16)
    p1, p2, uv1, uv2, *_ = _sim3_pair(17, n=40, outliers=0)
    if case == "identity":
        s0, R0, t0 = np.float32(1.0), np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    elif case == "general":
        s0 = np.float32(1.3)
        R0 = Rotation.from_rotvec([0.1, -0.3, 0.05]).as_matrix().astype(np.float32)
        t0 = np.array([0.4, -0.2, 0.6], np.float32)
    else:
        axis = np.array([0.05, 0.02, 1.0]) / np.linalg.norm([0.05, 0.02, 1.0])
        s0 = np.float32(0.9)
        R0 = Rotation.from_rotvec((np.pi - 1e-3) * axis).as_matrix().astype(np.float32)
        t0 = np.array([0.1, 0.2, 0.3], np.float32)
    res = _jax_residual(fix_scale)
    in_axes = (None, None, None, None, 0, 0, 0, 0)
    zero = jnp.zeros(7, jnp.float32)
    args = (j_(s0), j_(R0), j_(t0), j_(p1), j_(p2), j_(uv1), j_(uv2))
    e_ref = _np(jax.vmap(res, in_axes=in_axes)(zero, *args))
    J_ref = _np(jax.vmap(jax.jacfwd(res), in_axes=in_axes)(zero, *args))
    s, R, t = t_(np.asarray(s0)), t_(R0), t_(t0)
    e, y2, z1 = topt.residuals(s, R, t, t_(p1), t_(p2), t_(uv1), t_(uv2), t_(K4))
    J = topt.jacobian(s, R, t, t_(p1), y2, z1, t_(K4), fix_scale=fix_scale).numpy()
    assert J.shape == (40, 4, 7) and np.isfinite(J).all() and np.isfinite(J_ref).all()
    np.testing.assert_allclose(e.numpy(), e_ref, atol=2e-3, rtol=1e-5)
    np.testing.assert_allclose(J, J_ref, atol=2e-3, rtol=1e-5)
    if fix_scale:
        assert not J[..., 6].any()
