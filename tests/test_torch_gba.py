"""PyTorch port vs the JAX package: global bundle adjustment (implicit
Schur + PCG, `bundle_adjust_large`).

The four cases of the reference's tests/test_gba.py, as parity: the same
problem (built by that file's `make_ba_problem` and carried across as
numpy) through both packages' `bundle_adjust_large`, and through the
port's dense `bundle_adjust` as the exact oracle. Tolerances: final chi2
within 1 %, poses within 1e-4, points within 1e-3 plus 1e-4 of their
coordinates (the depth of a point seen under little parallax is the least
determined direction: one point of 150 differs by 1.3e-3 at depth 6.6); the fixed camera is
returned bit for bit; outlier flags equal (an observation within 1 % of
its gate may change sides); the capacity-shaped problem (128 cameras, 4096
points) runs and converges as the reference does.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orbslam_jpminipc_tpu.solvers import ba as jba
from orbslam_jpminipc_tpu.solvers import gba as jgba
from orbslam_jpminipc_torch.solvers import ba as tba
from orbslam_jpminipc_torch.solvers import gba as tgba

from test_ba import make_ba_problem

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x)


def _to_torch(prob: jba.BAProblem) -> tba.BAProblem:
    f = {k: torch.from_numpy(np.array(v)) for k, v in prob._asdict().items()}
    f["obs_kf"], f["obs_pt"] = f["obs_kf"].to(torch.int64), f["obs_pt"].to(torch.int64)
    return tba.BAProblem(**f)


def _hold(got, ref, chi_rel=0.01, pose=1e-4, pts=1e-3):
    chi, chi_ref = float(got.chi2), float(ref.chi2)
    assert abs(chi - chi_ref) <= chi_rel * chi_ref, (chi, chi_ref)
    np.testing.assert_allclose(got.kf_R.numpy(), _np(ref.kf_R), atol=pose)
    np.testing.assert_allclose(got.kf_t.numpy(), _np(ref.kf_t), atol=pose)
    np.testing.assert_allclose(got.points.numpy(), _np(ref.points), atol=pts, rtol=1e-4)
    print(f"chi2 {chi:.6g} (ref {chi_ref:.6g}), max diffs: R "
          f"{np.abs(got.kf_R.numpy() - _np(ref.kf_R)).max():.3g}, t "
          f"{np.abs(got.kf_t.numpy() - _np(ref.kf_t)).max():.3g}, points "
          f"{np.abs(got.points.numpy() - _np(ref.points)).max():.3g}")


def test_bundle_adjust_large_matches_jax_and_the_dense_solver():
    prob, Rs, ts, xw = make_ba_problem(np.random.default_rng(0))
    ref = jgba.bundle_adjust_large(prob, iterations=10, cg_iters=48)
    tp = _to_torch(prob)
    got = tgba.bundle_adjust_large(tp, iterations=10, cg_iters=48)
    _hold(got, ref)
    # the dense solver reaches the same optimum
    dense = tba.bundle_adjust(tp, iterations=10)
    O = tp.obs_uv.shape[0]
    assert float(got.chi2) < 2.5 * O * 0.3 ** 2
    assert float(got.chi2) < 1.1 * float(dense.chi2) + 1.0
    np.testing.assert_allclose(got.kf_t.numpy(), dense.kf_t.numpy(), atol=5e-3)
    for k in range(1, 6):
        assert np.linalg.norm(got.kf_t[k].numpy() - ts[k]) < 0.01
    assert np.median(np.linalg.norm(got.points.numpy() - xw, axis=1)) < 0.03


def test_fixed_camera_untouched():
    prob, *_ = make_ba_problem(np.random.default_rng(1))
    tp = _to_torch(prob)
    got = tgba.bundle_adjust_large(tp, iterations=5, cg_iters=32)
    ref = jgba.bundle_adjust_large(prob, iterations=5, cg_iters=32)
    np.testing.assert_array_equal(got.kf_R[0].numpy(), tp.kf_R[0].numpy())
    np.testing.assert_array_equal(got.kf_t[0].numpy(), tp.kf_t[0].numpy())
    _hold(got, ref)


def test_outlier_flags_equal():
    rng = np.random.default_rng(2)
    prob, *_ = make_ba_problem(rng, noise=0.2, perturb=0.0)
    uv = np.array(prob.obs_uv)
    n_bad = len(uv) // 20
    uv[:n_bad] += rng.uniform(30, 80, size=(n_bad, 2)) * rng.choice([-1, 1], size=(n_bad, 2))
    prob = prob._replace(obs_uv=jnp.array(uv))
    ref = jgba.bundle_adjust_large(prob, iterations=10, cg_iters=32)
    tp = _to_torch(prob)
    got = tgba.bundle_adjust_large(tp, iterations=10, cg_iters=32)
    out, out_ref = got.obs_outlier.numpy(), _np(ref.obs_outlier)
    flipped = np.nonzero(out != out_ref)[0]
    e, _ = tba.residuals(got.kf_R[tp.obs_kf], got.kf_t[tp.obs_kf], got.points[tp.obs_pt],
                         tp.obs_uv, tp.K4)
    c = (torch.sum(e * e, dim=-1) * tp.obs_w).numpy()
    assert len(flipped) <= 2 and np.all(np.abs(c[flipped] - 5.991) < 0.06), (flipped, c[flipped])
    assert out[:n_bad].mean() > 0.9 and out[n_bad:].mean() < 0.02
    _hold(got, ref)


def test_runs_at_capacity_shape():
    """128 cameras along a trajectory, 4096 points each seen by a handful
    of nearby cameras: the shape the dense solver cannot assemble at full
    map size."""
    rng = np.random.default_rng(3)
    n_kf, n_pts, obs_per_pt = 128, 4096, 6
    xw = np.stack([rng.uniform(0, 40, n_pts), rng.uniform(-2, 2, n_pts),
                   rng.uniform(4, 8, n_pts)], 1).astype(np.float32)
    ts_gt = np.stack([np.linspace(0, 40, n_kf), np.zeros(n_kf), np.zeros(n_kf)], 1).astype(np.float32)
    near = np.clip((xw[:, 0] / 40 * n_kf).astype(int)[:, None]
                   + np.arange(-obs_per_pt // 2, obs_per_pt - obs_per_pt // 2)[None], 0, n_kf - 1)
    obs_kf = near.reshape(-1)
    obs_pt = np.repeat(np.arange(n_pts), obs_per_pt)
    xc = xw[obs_pt] - ts_gt[obs_kf]
    uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320, 500 * xc[:, 1] / xc[:, 2] + 240],
                  1).astype(np.float32)
    inb = (xc[:, 2] > 1.0) & (np.abs(uv[:, 0] - 320) < 400) & (np.abs(uv[:, 1] - 240) < 300)
    uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    ts0 = -(ts_gt + rng.normal(0, 0.05, (n_kf, 3))).astype(np.float32)
    ts0[0], ts0[-1] = -ts_gt[0], -ts_gt[-1]
    fixed = np.zeros(n_kf, bool)
    fixed[0] = fixed[-1] = True
    fields = dict(
        kf_R=np.tile(np.eye(3, dtype=np.float32), (n_kf, 1, 1)), kf_t=ts0, kf_fixed=fixed,
        points=(xw + rng.normal(0, 0.05, xw.shape)).astype(np.float32),
        point_valid=np.ones(n_pts, bool), obs_kf=obs_kf.astype(np.int32),
        obs_pt=obs_pt.astype(np.int32), obs_uv=uv, obs_w=np.ones(len(uv), np.float32),
        obs_valid=inb, K4=np.array([500.0, 500.0, 320.0, 240.0], np.float32))
    prob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = _to_torch(prob)
    ref = jgba.bundle_adjust_large(prob, iterations=12, cg_iters=64)
    got = tgba.bundle_adjust_large(tp, iterations=12, cg_iters=64)
    chi0 = float(tba._robust_chi2(tp, tp.kf_R, tp.kf_t, tp.points))
    floor = 2.0 * float(inb.sum()) * 0.3 ** 2
    print(f"capacity shape: chi2 {chi0:.6g} -> {float(got.chi2):.6g} (ref {float(ref.chi2):.6g})")
    assert float(got.chi2) < max(1.5 * floor, 0.05 * chi0)
    for k in (32, 64, 96):
        assert np.linalg.norm(got.kf_t[k].numpy() - (-ts_gt[k])) < 0.15
    # a 128-camera chain in float32: the two packages' 12 x 64 PCG steps
    # agree to 1 % in chi2 and 1e-3 in the poses
    _hold(got, ref, pose=1e-3, pts=5e-3)
    np.testing.assert_array_equal(got.kf_t.numpy()[[0, -1]], ts0[[0, -1]])
