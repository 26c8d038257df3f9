"""PyTorch port vs the JAX package: bundle adjustment.

A 4-keyframe, 256-point problem with pixel noise, perturbed initial poses
and points, some corrupted observations, dropped observations and padding
rows, as the local-BA kernel pads them. Both packages' Schur-complement LM
(`bundle_adjust`) and the two-stage local schedule (`two_stage_local_ba`)
run on the same inputs. Tolerances: poses and points within 1e-4,
`obs_outlier` equal."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from orbslam_jpminipc_tpu.solvers import ba as jba
from orbslam_jpminipc_torch.solvers import ba as tba

torch.set_num_threads(2)

K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
TOL = 1e-4


def _problem(seed: int, n_kf=4, n_pts=256, noise=0.5, perturb=0.01, n_bad=12, pad_pts=32,
             pad_obs=64):
    rng = np.random.default_rng(seed)
    xw = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                   rng.uniform(4, 8, n_pts)], 1).astype(np.float32)
    Rs = np.stack([Rotation.from_rotvec([0, (i - n_kf / 2) * 0.04, 0]).as_matrix()
                   for i in range(n_kf)]).astype(np.float32)
    ts = np.stack([[-0.3 * i, 0.02 * i, 0.0] for i in range(n_kf)]).astype(np.float32)
    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(n_kf):
        xc = xw @ Rs[k].T + ts[k]
        uv = np.stack([K4[0] * xc[:, 0] / xc[:, 2] + K4[2], K4[1] * xc[:, 1] / xc[:, 2] + K4[3]], 1)
        for p in range(n_pts):
            if rng.uniform() < 0.15:
                continue
            obs_kf.append(k)
            obs_pt.append(p)
            obs_uv.append(uv[p] + rng.normal(0, noise, 2))
    obs_uv = np.array(obs_uv, np.float32)
    bad = rng.choice(len(obs_uv), n_bad, replace=False)
    obs_uv[bad] += rng.uniform(-30, 30, (n_bad, 2)).astype(np.float32)
    R0, t0 = Rs.copy(), ts.copy()
    for k in range(1, n_kf):
        R0[k] = Rotation.from_rotvec(rng.normal(0, perturb, 3)).as_matrix() @ Rs[k]
        t0[k] += rng.normal(0, perturb, 3).astype(np.float32)
    pts = np.zeros((n_pts + pad_pts, 3), np.float32)
    pts[:n_pts] = xw + rng.normal(0, perturb, xw.shape)
    O = len(obs_kf) + pad_obs
    arr = lambda a, dt, fill=0: np.concatenate([np.asarray(a, dt),
                                                np.full((pad_obs, *np.shape(a)[1:]), fill, dt)])
    lv = rng.integers(0, 3, len(obs_kf))
    return dict(
        kf_R=R0, kf_t=t0, kf_fixed=np.arange(n_kf) == 0,
        points=pts, point_valid=np.arange(n_pts + pad_pts) < n_pts,
        obs_kf=arr(obs_kf, np.int32), obs_pt=arr(obs_pt, np.int32),
        obs_uv=arr(obs_uv, np.float32), obs_w=arr(1.2 ** (-2.0 * lv), np.float32, 1),
        obs_valid=np.arange(O) < len(obs_kf), K4=K4,
    )


def _run_both(p, fn_j, fn_t):
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = tba.BAProblem(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()})
    tp = tp._replace(obs_kf=tp.obs_kf.long(), obs_pt=tp.obs_pt.long())
    return jax.tree.map(np.asarray, fn_j(jp)), fn_t(tp)


def _check(ref, got, p):
    np.testing.assert_allclose(got.kf_R.numpy(), ref.kf_R, atol=TOL)
    np.testing.assert_allclose(got.kf_t.numpy(), ref.kf_t, atol=TOL)
    np.testing.assert_allclose(got.points.numpy(), ref.points, atol=TOL)
    np.testing.assert_array_equal(got.obs_outlier.numpy(), ref.obs_outlier)
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-4)
    # the fixed gauge keyframe gets a zero step (both packages re-project
    # every rotation onto SO(3) after a step, which moves it by an ulp);
    # the padding rows stay exactly as given
    np.testing.assert_allclose(got.kf_R.numpy()[0], p["kf_R"][0], atol=1e-6)
    np.testing.assert_array_equal(got.kf_t.numpy()[0], p["kf_t"][0])
    np.testing.assert_array_equal(got.points.numpy()[~p["point_valid"]], 0.0)
    assert ref.obs_outlier.sum() > 0  # the corrupted observations are caught


@pytest.mark.parametrize("iterations", [5, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_bundle_adjust_matches_jax(seed, iterations):
    p = _problem(seed)
    ref, got = _run_both(p, lambda q: jba.bundle_adjust(q, iterations=iterations),
                         lambda q: tba.bundle_adjust(q, iterations=iterations))
    _check(ref, got, p)


@pytest.mark.parametrize("seed", [0, 2])
def test_two_stage_local_ba_matches_jax(seed):
    p = _problem(seed)
    ref, got = _run_both(p, jax.jit(jba.two_stage_local_ba), tba.two_stage_local_ba)
    _check(ref, got, p)


def test_bundle_adjust_reduces_error_against_truth():
    """Sanity of the port alone: the LM lowers the robust chi2 from its
    start value and never accepts a NaN step."""
    p = _problem(3)
    tp = tba.BAProblem(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()})
    tp = tp._replace(obs_kf=tp.obs_kf.long(), obs_pt=tp.obs_pt.long())
    chi0 = float(tba._robust_chi2(tp, tp.kf_R, tp.kf_t, tp.points))
    res = tba.bundle_adjust(tp, iterations=10)
    assert np.isfinite(float(res.chi2)) and float(res.chi2) < 0.5 * chi0
