"""PyTorch port vs the JAX package: SE3 algebra and the camera model."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orbslam_jpminipc_tpu.geometry import camera as jcam
from orbslam_jpminipc_tpu.geometry import se3 as jse3
from orbslam_jpminipc_torch.geometry import camera as tcam
from orbslam_jpminipc_torch.geometry import se3 as tse3

torch.set_num_threads(2)

TOL = 1e-6  # float32 evaluation of the same formulas in two frameworks
# Pixel outputs: the reference's compiled program fuses u = fx*x/z + cx into
# a multiply-add, so where the sum cancels (u near 0) the two differ by an
# ulp of the product, up to ~3e-5 px; the bound is 1e-6 of the image width.
PX_TOL = TOL * 640


def _close(t, j, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _rotvecs(rng, n=64):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w *= (rng.uniform(0, 3.0, n) / np.linalg.norm(w, axis=1))[:, None].astype(np.float32)
    w[:4] *= np.float32(1e-5)  # the small-angle branch
    return w


@pytest.mark.parametrize("seed", [0, 1])
def test_so3_functions(seed):
    w = _rotvecs(np.random.default_rng(seed))
    tw = torch.from_numpy(w)
    _close(tse3.hat(tw), jse3.hat(jnp.asarray(w)))
    _close(tse3.exp_so3(tw), jax.jit(jse3.exp_so3)(jnp.asarray(w)))
    _close(tse3._so3_left_jacobian(tw), jax.jit(jse3._so3_left_jacobian)(jnp.asarray(w)))


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_exp_compose_orthonormalize(seed):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([_rotvecs(rng, 32), rng.normal(size=(32, 3)).astype(np.float32)], 1)
    R, t = tse3.exp_se3(torch.from_numpy(xi))
    jR, jt = jax.jit(jse3.exp_se3)(jnp.asarray(xi))
    _close(R, jR)
    _close(t, jt)
    Rb, tb = R.flip(0), t.flip(0)
    Rc, tc = tse3.compose(R, t, Rb, tb)
    jRc, jtc = jax.jit(jse3.compose)(jR, jt, jR[::-1], jt[::-1])
    _close(Rc, jRc)
    _close(tc, jtc)
    # a rotation drifted off SO(3) by float32 products
    drift = (R + torch.from_numpy(rng.normal(0, 1e-3, (32, 3, 3)).astype(np.float32)))
    _close(tse3.orthonormalize(drift), jax.jit(jse3.orthonormalize)(jnp.asarray(drift.numpy())))


def test_project_in_image_undistort():
    rng = np.random.default_rng(2)
    K4 = np.array([500.0, 505.0, 320.0, 240.0], np.float32)
    dist = np.array([0.1, -0.05, 0.001, -0.002], np.float32)
    xc = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                   rng.uniform(0.5, 4, 200)], 1).astype(np.float32)
    uv = tcam.project(torch.from_numpy(xc), torch.from_numpy(K4))
    juv = jax.jit(jcam.project)(jnp.asarray(xc), jnp.asarray(K4))
    _close(uv, juv, rtol=0.0, atol=PX_TOL)
    bounds = np.array([0, 640, 0, 480], np.float32)
    np.testing.assert_array_equal(
        tcam.in_image(uv, torch.from_numpy(bounds)).numpy(),
        np.asarray(jcam.in_image(juv, jnp.asarray(bounds))))
    pix = np.stack([rng.uniform(0, 640, 200), rng.uniform(0, 480, 200)], 1).astype(np.float32)
    und = tcam.undistort_points(torch.from_numpy(pix), torch.from_numpy(K4), torch.from_numpy(dist))
    jund = jax.jit(jcam.undistort_points)(jnp.asarray(pix), jnp.asarray(K4), jnp.asarray(dist))
    _close(und, jund, rtol=0.0, atol=PX_TOL)


def test_frustum_check():
    rng = np.random.default_rng(3)
    n = 512
    xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(-1, 5, n)], 1).astype(np.float32)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    normal = np.where((normal * xw).sum(1, keepdims=True) < 0, -normal, normal)
    mind = rng.uniform(0.2, 1.5, n).astype(np.float32)
    maxd = (mind * rng.uniform(2, 8, n)).astype(np.float32)
    R = np.asarray(jse3.exp_so3(jnp.array([0.05, -0.1, 0.02], jnp.float32)))
    t = np.array([0.1, -0.05, 0.3], np.float32)
    K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    bounds = np.array([0, 640, 0, 480], np.float32)
    T = lambda a: torch.from_numpy(np.array(a))
    ok, uv, inv_z, view_cos, dist = tcam.frustum_check(
        T(xw), T(R), T(t), T(K4), T(bounds), T(normal), T(mind), T(maxd))
    jok, juv, jinv_z, jview, jdist = jax.jit(jcam.frustum_check)(
        *(jnp.asarray(a) for a in (xw, R, t, K4, bounds, normal, mind, maxd)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.numpy().sum() > 20
    sel = ok.numpy()
    _close(uv[sel], np.asarray(juv)[sel], rtol=0.0, atol=PX_TOL)
    _close(inv_z[sel], np.asarray(jinv_z)[sel])
    _close(view_cos, jview)
    _close(dist, jdist)


def test_unproject_distort_project_distorted():
    rng = np.random.default_rng(4)
    K4 = np.array([500.0, 505.0, 320.0, 240.0], np.float32)
    dist = np.array([0.1, -0.05, 0.001, -0.002], np.float32)
    pix = np.stack([rng.uniform(0, 640, 200), rng.uniform(0, 480, 200)], 1).astype(np.float32)
    _close(tcam.unproject(torch.from_numpy(pix), torch.from_numpy(K4)),
           jax.jit(jcam.unproject)(jnp.asarray(pix), jnp.asarray(K4)))
    xy = rng.uniform(-0.8, 0.8, (200, 2)).astype(np.float32)
    _close(tcam.distort_normalized(torch.from_numpy(xy), torch.from_numpy(dist)),
           jax.jit(jcam.distort_normalized)(jnp.asarray(xy), jnp.asarray(dist)))
    xc = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                   rng.uniform(0.5, 4, 200)], 1).astype(np.float32)
    _close(tcam.project_distorted(torch.from_numpy(xc), torch.from_numpy(K4),
                                  torch.from_numpy(dist)),
           jax.jit(jcam.project_distorted)(jnp.asarray(xc), jnp.asarray(K4), jnp.asarray(dist)),
           rtol=0.0, atol=PX_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_log_se3_camera_center_pose7(seed):
    rng = np.random.default_rng(seed)
    w = _rotvecs(rng, 32)
    w[4:] *= np.float32(0.8)  # away from pi, where log is two-valued
    xi = np.concatenate([w, rng.normal(size=(32, 3)).astype(np.float32)], 1)
    jR, jt = jax.jit(jse3.exp_se3)(jnp.asarray(xi))
    R, t = torch.from_numpy(np.asarray(jR)), torch.from_numpy(np.asarray(jt))
    # the reference's log_so3 and the port's (through the quaternion) are
    # two formulas: within 1e-6 all the same, and log(exp(xi)) within 2e-6
    # of xi
    log = tse3.log_se3(R, t)
    jlog = jax.jit(jse3.log_se3)(jR, jt)
    _close(log, jlog, rtol=0.0, atol=1e-6)
    _close(log, xi, rtol=0.0, atol=2e-6)
    _close(tse3.camera_center(R, t), jax.jit(jse3.camera_center)(jR, jt))
    p7 = tse3.pose7_from_Rt(R, t)
    _close(p7, jax.jit(jse3.pose7_from_Rt)(jR, jt))
    R2, t2 = tse3.Rt_from_pose7(p7)
    jR2, jt2 = jax.jit(jse3.Rt_from_pose7)(jnp.asarray(p7.numpy()))
    _close(R2, jR2)
    _close(t2, jt2)
