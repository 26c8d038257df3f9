"""PyTorch port vs the JAX package: pyramid, per-level FAST and cell
selection, ORB orientation/descriptors, and the whole extractor."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orbslam_jpminipc_tpu.ops import extractor as jext
from orbslam_jpminipc_tpu.ops import fast as jfast
from orbslam_jpminipc_tpu.ops import orb as jorb
from orbslam_jpminipc_tpu.ops import pyramid as jpyr
from orbslam_jpminipc_torch.ops import extractor as text
from orbslam_jpminipc_torch.ops import fast as tfast
from orbslam_jpminipc_torch.ops import orb as torb
from orbslam_jpminipc_torch.ops import pyramid as tpyr

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "orbslam_jpminipc_torch", "data", "track_fixture_xyz.npz")

# The port rebuilds jax.image.resize's arithmetic (ops/pyramid.py); the
# reference's compiler still picks a different contraction for some shapes,
# which leaves ulp-level differences (measured max 8.2e-4 at level 6 of a
# random 480x640 frame, each level fed the reference's level above).
PYRAMID_TOL = 1e-3


def _small_frame(k: int = 0) -> np.ndarray:
    """A real 240x320 frame: a fixture frame subsampled 2x."""
    return np.load(FIXTURE)["images"][k][::2, ::2].astype(np.float32)


@pytest.fixture(scope="module")
def jax_levels():
    img = jnp.asarray(_small_frame())
    return [np.array(l) for l in jax.jit(
        jpyr.build_pyramid, static_argnums=(1, 2))(img, 4, 1.2)]


def test_pyramid_within_tolerance():
    img = np.random.default_rng(0).integers(0, 256, (480, 640)).astype(np.float32)
    sizes = jpyr.level_sizes(480, 640, 8, 1.2)
    assert tpyr.level_sizes(480, 640, 8, 1.2) == sizes
    resize = jax.jit(lambda x, s: jax.image.resize(x, s, method="linear", antialias=False),
                     static_argnums=1)
    jl = [img]
    for s in sizes[1:]:
        jl.append(np.array(resize(jnp.asarray(jl[-1]), s)))
    chained = tpyr.build_pyramid(torch.from_numpy(img), 8, 1.2)
    for lvl in range(1, 8):
        fed = tpyr.resize_linear(torch.from_numpy(jl[lvl - 1]), sizes[lvl]).numpy()
        assert fed.shape == jl[lvl].shape
        assert np.abs(fed - jl[lvl]).max() <= PYRAMID_TOL, lvl
        assert np.abs(chained[lvl].numpy() - jl[lvl]).max() <= PYRAMID_TOL, lvl


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_level_fast_and_selection_exact(jax_levels, lvl):
    """Fed the JAX level image, the FAST map, the hi/lo cell select and the
    in-cell top-k are exactly the reference's."""
    img = jax_levels[lvl]
    quota = jext.features_per_level(300, 4, 1.2)[lvl]
    assert text.features_per_level(300, 4, 1.2)[lvl] == quota
    t_img = torch.from_numpy(img)
    lo = tfast.detect(t_img, 7.0, border=text.EDGE_THRESHOLD)
    j_lo = jax.jit(jfast.detect, static_argnames=("threshold", "border"))(
        jnp.asarray(img), threshold=7.0, border=jext.EDGE_THRESHOLD)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo))

    xy, resp, valid = text._select_level(t_img, quota, 20.0, 7.0, 32)
    jxy, jresp, jvalid = jax.jit(jext._select_level, static_argnums=(1, 2, 3, 4, 5))(
        jnp.asarray(img), quota, 20.0, 7.0, 32, False)
    np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(resp.numpy(), np.asarray(jresp))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.numpy().sum() > 0

    score = text._level_score(t_img, 20.0, 7.0, 32)
    idx, ok = text._select_in_cells(score, quota, 32)
    jidx, jok = jax.jit(jext._select_in_cells, static_argnums=(1, 2))(
        jnp.asarray(score.numpy()), quota, 32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_select_in_cells_slow_path_with_ties():
    """Corners crowded into one cell, with integer (tied) scores: the
    candidate pool cannot fill the quota, so the exact full ranking runs."""
    rng = np.random.default_rng(4)
    score = np.zeros((96, 128), np.float32)
    ys, xs = rng.integers(0, 32, 60), rng.integers(32, 64, 60)
    score[ys, xs] = rng.integers(1, 6, 60).astype(np.float32)
    score[70, 100] = 9.0
    cand = text._cell_candidates(torch.from_numpy(score), 50, 32)
    assert not bool(cand.fast_ok)
    idx, ok = text._select_in_cells(torch.from_numpy(score), 50, 32)
    jidx, jok = jax.jit(jext._select_in_cells, static_argnums=(1, 2))(
        jnp.asarray(score), 50, 32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_blur_and_patches_exact(jax_levels):
    img = jax_levels[1]
    blur = torch.round(torb.gaussian_blur_7x7_sigma2(torch.from_numpy(img))).numpy()
    jblur = np.asarray(jnp.round(jax.jit(jorb.gaussian_blur_7x7_sigma2)(jnp.asarray(img))))
    np.testing.assert_array_equal(blur, jblur)
    rng = np.random.default_rng(6)
    h, w = img.shape
    # keypoints anywhere, including within the patch radius of the edge
    xy = np.stack([rng.uniform(-3, w + 3, 200), rng.uniform(-3, h + 3, 200)], 1).astype(np.float32)
    stack = np.stack([img, blur])
    got = torb.gather_patches_multi(torch.from_numpy(stack), torch.from_numpy(xy), 18).numpy()
    ref = np.asarray(jax.jit(jorb.gather_patches_multi, static_argnums=2)(
        jnp.asarray(stack), jnp.asarray(xy), 18))
    np.testing.assert_array_equal(got, ref)


def test_angle_and_descriptors_given_identical_patches():
    rng = np.random.default_rng(7)
    n = 600
    p37 = rng.integers(0, 256, (n, 37, 37)).astype(np.float32)
    p31 = p37[:, 3:-3, 3:-3]
    ang = torb.ic_angle_from_patches(torch.from_numpy(np.ascontiguousarray(p31))).numpy()
    jang = np.asarray(jax.jit(jorb.ic_angle_from_patches)(jnp.asarray(p31)))
    d = np.abs((ang - jang + 180.0) % 360.0 - 180.0)
    assert d.max() < 1e-3, d.max()  # moments summed in another order (measured 3e-5)
    angles = rng.uniform(0, 360, n).astype(np.float32)
    angles[:8] = [0, 90, 180, 270, 45, 135, 225, 315]
    desc = torb.descriptors_from_patches(torch.from_numpy(p37), torch.from_numpy(angles)).numpy()
    jdesc = np.asarray(jax.jit(jorb.descriptors_from_patches)(jnp.asarray(p37), jnp.asarray(angles)))
    same = np.all(desc == jdesc, axis=1).mean()
    assert same >= 0.99, same


def test_extract_small_frame():
    img = _small_frame(3)
    f = text.extract(torch.from_numpy(img), n_features=300, n_levels=4)
    j = jext.extract(jnp.asarray(img), n_features=300, n_levels=4)
    assert f.xy.shape == (300, 2) and f.desc.shape == (300, 32)
    valid = np.asarray(j.valid)
    np.testing.assert_array_equal(f.valid.numpy(), valid)
    same_xy = np.all(f.xy.numpy() == np.asarray(j.xy), axis=1)[valid].mean()
    same_level = (f.level.numpy() == np.asarray(j.level))[valid].mean()
    # measured: 100 % on all 10 fixture frames subsampled to 240x320
    assert same_xy >= 0.99 and same_level >= 0.99, (same_xy, same_level)
    same_desc = np.all(f.desc.numpy() == np.asarray(j.desc), axis=1)[valid].mean()
    assert same_desc >= 0.99, same_desc


def test_harris_score_map_within_tolerance():
    img = _small_frame(2)
    j = np.asarray(jax.jit(jfast.harris_score_map)(jnp.asarray(img)))
    t = tfast.harris_score_map(torch.from_numpy(img)).numpy()
    assert t.shape == j.shape
    # float32 box sums in another order: relative to the map's scale
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5 * np.abs(j).max())


def test_extract_with_harris_score():
    img = _small_frame(3)
    f = text.extract(torch.from_numpy(img), n_features=300, n_levels=4, use_harris_score=True)
    g = text.extract(torch.from_numpy(img), n_features=300, n_levels=4)
    j = jext.extract(jnp.asarray(img), n_features=300, n_levels=4, use_harris_score=True)
    valid = np.asarray(j.valid)
    np.testing.assert_array_equal(f.valid.numpy(), valid)
    # the Harris score changes the response only, never the selection
    np.testing.assert_array_equal(f.xy.numpy(), g.xy.numpy())
    same_xy = np.all(f.xy.numpy() == np.asarray(j.xy), axis=1)[valid].mean()
    assert same_xy >= 0.99, same_xy
    jr = np.asarray(j.response)[valid]
    np.testing.assert_allclose(f.response.numpy()[valid], jr, rtol=1e-4,
                               atol=1e-5 * np.abs(jr).max())


def test_one_level_patches_angle_descriptors_exact(jax_levels):
    """The one-level forms (`gather_patches`, `ic_angle`, `descriptors`) on a
    real level: patches bit-equal; angles within 1e-4 degrees (the moments
    are exact integers, atan2 differs by an ulp between the two libraries:
    measured 3.05e-5 degrees on 24 of 300 keypoints); descriptors bit-equal
    given the same angle, and on >= 99 % of keypoints from each package's
    own angle (the bound of the multi-level forms, test_extract_small_frame)."""
    img = jax_levels[0]
    blur = np.asarray(jnp.round(jax.jit(jorb.gaussian_blur_7x7_sigma2)(jnp.asarray(img))))
    rng = np.random.default_rng(8)
    h, w = img.shape
    xy = np.stack([rng.uniform(19, w - 20, 300), rng.uniform(19, h - 20, 300)],
                  1).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    np.testing.assert_array_equal(
        torb.gather_patches(T(img), T(xy), 15).numpy(),
        np.asarray(jax.jit(jorb.gather_patches, static_argnums=2)(J(img), J(xy), 15)))
    ang = torb.ic_angle(T(img), T(xy))
    jang = np.asarray(jax.jit(jorb.ic_angle)(J(img), J(xy)))
    np.testing.assert_allclose(ang.numpy(), jang, rtol=0, atol=1e-4)
    desc = torb.descriptors(T(blur), T(xy), T(jang)).numpy()
    jdesc = np.asarray(jax.jit(jorb.descriptors)(J(blur), J(xy), J(jang)))
    np.testing.assert_array_equal(desc, jdesc)
    own = torb.descriptors(T(blur), T(xy), ang).numpy()
    assert np.all(own == jdesc, axis=1).mean() >= 0.99


def test_scale_factors():
    for n, f in ((8, 1.2), (4, 1.5)):
        got, ref = tpyr.scale_factors(n, f), jpyr.scale_factors(n, f)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
