"""PyTorch port vs the JAX package: two-view initialization.

The reference draws its RANSAC minimal sets with `jax.random`; the port
takes them as an input. Each case computes the reference's sets with its
own sampler and key schedule (`initialize` splits its key once and samples
from the first half) and feeds the same sets to the port.

Tolerances. The discrete outcome is held equal everywhere: success, the
model (H or F), the best hypothesis, the `good` mask. R is held to the
reference within 1e-4 on the system fixture's real attempt and on three of
the four synthetic scenes. The translation cannot be held to 1e-4: the
minimal-set fits are eigenvectors of A^T A in float32, and on the same
A^T A (bit-identical in both packages) the two LAPACK eigensolvers each
land ~2e-4 (median) from the float64 eigenvector. At a small baseline the
motion is a small part of H (or F), so that relative error reaches t
amplified. Measured gaps to the reference (max abs, R / t): fixture
attempt 5.1e-5 / 3.1e-3; general seed 0 1.5e-5 / 3.0e-4; planar seed 0
9.1e-6 / 1.1e-4; planar seed 1 7.2e-6 / 9.0e-5; general seed 1 (its best
8-point set is ill-conditioned) 1.4e-3 / 3.2e-2. Each case is held to the
bound in `CASE_TOL` beside its reading, and on synthetic scenes the port's
error against the true motion must also be no worse than the reference's
plus a margin."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from orbslam_jpminipc_tpu.frontend import tracking as jtracking
from orbslam_jpminipc_tpu.solvers import initializer as jinit
from orbslam_jpminipc_torch.config import SlamConfig
from orbslam_jpminipc_torch.frontend import tracking as ttracking
from orbslam_jpminipc_torch.frontend.frame import build_frame
from orbslam_jpminipc_torch.solvers import initializer as tinit
from orbslam_jpminipc_torch.solvers import small_linalg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLAM_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "slam_fixture_xyz.npz")
K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
POSE_TOL = 1e-4
T_TOL = 1e-2
# (seed, planar) -> (R, t) bounds against the reference's R and t
CASE_TOL = {(0, False): (POSE_TOL, 1e-3), (0, True): (POSE_TOL, 1e-3),
            (1, False): (2e-3, 5e-2), (1, True): (POSE_TOL, 1e-3)}
# synthetic scenes: the port's error against the true motion may exceed the
# reference's by these margins
ROT_MARGIN_DEG = 0.05
DIR_MARGIN_DEG = 1.0

_jinit = jax.jit(jinit.initialize, static_argnames=("n_hyp", "min_triangulated"))
_jsets = jax.jit(jinit._sample_minimal_sets, static_argnames=("n_hyp", "k"))


def _scene(seed: int, planar: bool, n=300, noise=0.3, outliers=20):
    """Two views of random points (on a plane at depth 5, or spread over
    depths 3-8), pixel noise, and `outliers` corrupted matches."""
    rng = np.random.default_rng(seed)
    z = np.full(n, 5.0) if planar else rng.uniform(3, 8, n)
    xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z], 1).astype(np.float32)
    R2 = Rotation.from_rotvec([0.02, 0.12, 0.01]).as_matrix().astype(np.float32)
    t2 = np.array([-0.4, 0.03, 0.05], np.float32)

    def project(R, t):
        xc = xw @ R.T + t
        return np.stack([K4[0] * xc[:, 0] / xc[:, 2] + K4[2],
                         K4[1] * xc[:, 1] / xc[:, 2] + K4[3]], 1).astype(np.float32)

    uv1 = project(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    uv2 = project(R2, t2)
    uv1 += rng.normal(0, noise, uv1.shape).astype(np.float32)
    uv2 += rng.normal(0, noise, uv2.shape).astype(np.float32)
    uv2[:outliers] = rng.uniform(0, 640, (outliers, 2)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[rng.choice(n, 15, replace=False)] = False
    return uv1, uv2, mask


def _reference(uv1, uv2, mask, key):
    res = _jinit(key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask), jnp.asarray(K4))
    k1, _ = jax.random.split(key)
    sets = np.asarray(_jsets(k1, jnp.asarray(mask), 200))
    return jax.tree.map(np.asarray, res), sets


def test_initialize_matches_jax_on_fixture_frames():
    """The system fixture's real initialization attempt (frames 0 and 1 at
    2000 features, extracted once by the port): level-0 window match + the
    dual-model RANSAC in both packages, with the reference tracker's key
    schedule (key(seed), split once per attempt)."""
    fx = np.load(SLAM_FIXTURE)
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=1000)
    frames = [build_frame(fx["images"][i], cfg, frame_id=i, n_features=2000, device="cpu") for i in (0, 1)]
    f0, f1 = frames
    args = (f0.desc, f0.xy_un, f0.angle, f0.valid, f0.level,
            f1.desc, f1.xy_un, f1.angle, f1.level, f1.valid, K4)
    _, key = jax.random.split(jax.random.key(cfg.seed))
    jn1, jidx, jmask, jres = jax.tree.map(np.asarray, jtracking._init_attempt(
        key, *map(jnp.asarray, args)))
    sets = np.asarray(_jsets(jax.random.split(key)[0], jnp.asarray(jmask), 200))
    np.testing.assert_array_equal(sets, fx["init_sets"][0])  # the fixture's sets
    n1, idx, mask, res = ttracking._init_attempt(
        lambda m, n: torch.from_numpy(sets), *map(torch.from_numpy, args))
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_array_equal(idx.numpy()[jmask], jidx[jmask])
    assert bool(jres.success) and bool(res.success)
    assert bool(res.used_h) == bool(jres.used_h)
    np.testing.assert_array_equal(res.good.numpy(), jres.good)
    np.testing.assert_allclose(res.R.numpy(), jres.R, atol=POSE_TOL)
    np.testing.assert_allclose(res.t.numpy(), jres.t, atol=T_TOL)


def test_initialize_on_fixture_frames_with_the_cards_svd(monkeypatch):
    """The same attempt with the card's SVDs: `initializer._svd` takes
    LAPACK on the CPU and the Jacobi kernel on a card, so here its plain
    version, held to the reference within the same bounds."""
    monkeypatch.setattr(tinit, "_svd", small_linalg.svd_small)
    test_initialize_matches_jax_on_fixture_frames()


def _angle_deg(a, b):
    c = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.mark.parametrize("planar", [False, True], ids=["general", "planar"])
@pytest.mark.parametrize("seed", [0, 1])
def test_initialize_matches_jax(planar, seed):
    uv1, uv2, mask = _scene(seed, planar)
    ref, sets = _reference(uv1, uv2, mask, jax.random.key(seed))
    got = tinit.initialize(torch.from_numpy(sets), torch.from_numpy(uv1), torch.from_numpy(uv2),
                           torch.from_numpy(mask), torch.from_numpy(K4))
    assert bool(ref.success), "the case must initialize"
    assert bool(got.success) == bool(ref.success)
    assert bool(got.used_h) == bool(ref.used_h) == planar
    np.testing.assert_array_equal(got.good.numpy(), ref.good)
    assert int(got.n_good) == int(ref.n_good)
    r_tol, t_tol = CASE_TOL[(seed, planar)]
    np.testing.assert_allclose(got.R.numpy(), ref.R, atol=r_tol)
    np.testing.assert_allclose(got.t.numpy(), ref.t, atol=t_tol)
    R_true = Rotation.from_rotvec([0.02, 0.12, 0.01]).as_matrix()
    t_true = np.array([-0.4, 0.03, 0.05])
    rot_err = lambda R: np.degrees(Rotation.from_matrix(R.astype(np.float64) @ R_true.T).magnitude())
    assert rot_err(got.R.numpy()) <= rot_err(ref.R) + ROT_MARGIN_DEG
    assert _angle_deg(got.t.numpy(), t_true) <= _angle_deg(ref.t, t_true) + DIR_MARGIN_DEG


@pytest.mark.parametrize("planar", [False, True], ids=["general", "planar"])
@pytest.mark.parametrize("seed", [0, 1])
def test_initialize_matches_jax_with_the_cards_svd(planar, seed, monkeypatch):
    """The synthetic scenes with the card's SVDs (the plain Jacobi version,
    as on the fixture's frames above), within the same bounds."""
    monkeypatch.setattr(tinit, "_svd", small_linalg.svd_small)
    test_initialize_matches_jax(planar, seed)


def test_initialize_refuses_pure_rotation_like_jax():
    """No baseline: neither package may report success."""
    uv1, _, mask = _scene(3, False, outliers=0)
    uv2 = uv1 + np.float32([3.0, -2.0])
    ref, sets = _reference(uv1, uv2, mask, jax.random.key(3))
    got = tinit.initialize(torch.from_numpy(sets), torch.from_numpy(uv1), torch.from_numpy(uv2),
                           torch.from_numpy(mask), torch.from_numpy(K4))
    assert not bool(ref.success) and not bool(got.success)
    assert bool(got.used_h) == bool(ref.used_h)


@pytest.mark.parametrize("n_valid", [0, 1])
def test_initialize_without_matches_fails_like_jax(n_valid):
    """No match, or one (a frame pair that shares nothing): the attempt
    fails in both packages, and the port does not raise (the reference's
    normalization scale is 1e9 there and its A^T A overflows: its eigh
    gives NaN where torch's raises)."""
    uv1, uv2, _ = _scene(4, False)
    mask = np.zeros(len(uv1), bool)
    mask[:n_valid] = True
    ref, sets = _reference(uv1, uv2, mask, jax.random.key(4))
    got = tinit.initialize(torch.from_numpy(sets), torch.from_numpy(uv1), torch.from_numpy(uv2),
                           torch.from_numpy(mask), torch.from_numpy(K4))
    assert not bool(ref.success) and not bool(got.success)
    assert not got.good.numpy().any() and not np.asarray(ref.good).any()


@pytest.mark.parametrize("model", ["h", "f"])
def test_model_fit_and_score_match_jax(model):
    """Batched DLT fits and chi^2 scores on the same minimal sets: the same
    best hypothesis, its score within 2e-3 relative and its inlier mask
    equal (degenerate minimal sets give unrelated fits in both packages)."""
    uv1, uv2, mask = _scene(5, model == "h")
    _, sets = _reference(uv1, uv2, mask, jax.random.key(5))
    j1, T1 = jinit._normalize(jnp.asarray(uv1), jnp.asarray(mask))
    j2, T2 = jinit._normalize(jnp.asarray(uv2), jnp.asarray(mask))
    t1, tT1 = tinit._normalize(torch.from_numpy(uv1), torch.from_numpy(mask))
    t2, tT2 = tinit._normalize(torch.from_numpy(uv2), torch.from_numpy(mask))
    np.testing.assert_allclose(tT1.numpy(), np.asarray(T1), rtol=1e-6)
    s = torch.from_numpy(sets).long()
    args_j = (jnp.asarray(uv1)[None], jnp.asarray(uv2)[None], jnp.asarray(mask)[None], 1.0)
    args_t = (torch.from_numpy(uv1)[None], torch.from_numpy(uv2)[None],
              torch.from_numpy(mask)[None], 1.0)
    if model == "h":
        Hj = jnp.linalg.inv(T2) @ jinit._fit_h(j1[sets], j2[sets]) @ T1
        Ht = torch.linalg.inv(tT2) @ tinit._fit_h(t1[s], t2[s]) @ tT1
        sj, ij = jinit._score_h(Hj, jnp.linalg.inv(Hj), *args_j)
        st, it = tinit._score_h(Ht, torch.linalg.inv(Ht), *args_t)
    else:
        Fj = T2.T @ jinit._fit_f(j1[sets], j2[sets]) @ T1
        Ft = tT2.T @ tinit._fit_f(t1[s], t2[s]) @ tT1
        sj, ij = jinit._score_f(Fj, *args_j)
        st, it = tinit._score_f(Ft, *args_t)
    sj, st = np.asarray(sj), st.numpy()
    best = int(np.argmax(sj))
    assert int(np.argmax(st)) == best
    np.testing.assert_allclose(st[best], sj[best], rtol=2e-3)
    np.testing.assert_array_equal(it.numpy()[best], np.asarray(ij)[best])
