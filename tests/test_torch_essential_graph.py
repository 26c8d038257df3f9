"""PyTorch port vs the JAX package: the essential-graph (Sim3 pose-graph)
optimizer.

`_edge_residual` and its two 7x7 Jacobians (`torch.func.jacfwd` under
`vmap` against `jax.jacfwd` under `vmap`) on the same edges, with the
identity (zero rotation, unit scale, zero residual) and a relative
rotation within 1e-3 of pi among them: residuals within 1e-5, Jacobians
within 1e-4, finite everywhere. `optimize_essential_graph` on a drifted
chain with a loop edge, a fixed vertex, inert vertices (slots no edge
touches) and padded edges: final chi2 within 1 %, poses within 1e-4. And an
input on which the Cholesky breaks down (a non-finite measurement): both
packages reject every step and return the finite poses they started from.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from orbslam_jpminipc_tpu.geometry import sim3 as jsim3
from orbslam_jpminipc_tpu.solvers import essential_graph as jeg
from orbslam_jpminipc_torch.solvers import essential_graph as teg

torch.set_num_threads(2)

t_ = torch.from_numpy
j_ = jnp.asarray
IN_AXES = (None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0, None)


def _np(x):
    return np.asarray(x)


def _edges(seed, n=24):
    """n edges as (si, Ri, ti, sj, Rj, tj, ms, mR, mt). Edge 0 is the
    identity everywhere (zero residual); edge 1 has a residual rotation
    within 1e-3 of pi; edge 2 a zero residual at general vertices."""
    rng = np.random.default_rng(seed)
    rot = lambda sig: Rotation.from_rotvec(rng.normal(0, sig, (n, 3))).as_matrix().astype(np.float32)
    si = rng.uniform(0.7, 1.4, n).astype(np.float32)
    sj = rng.uniform(0.7, 1.4, n).astype(np.float32)
    Ri, Rj = rot(0.6), rot(0.6)
    ti = rng.normal(0, 1, (n, 3)).astype(np.float32)
    tj = rng.normal(0, 1, (n, 3)).astype(np.float32)
    # measurement = true relative Sim3 times a perturbation
    rel = jsim3.compose(j_(sj), j_(Rj), j_(tj), *jsim3.inverse(j_(si), j_(Ri), j_(ti)))
    xi = rng.normal(0, 0.15, (n, 7)).astype(np.float32)
    xi[2] = 0.0
    axis = np.array([0.2, -0.1, 1.0]) / np.linalg.norm([0.2, -0.1, 1.0])
    xi[1, :3] = (np.pi - 1e-3) * axis
    ms, mR, mt = [np.array(a) for a in jsim3.compose(*jsim3.exp7(j_(xi)), *rel)]
    si[0] = sj[0] = ms[0] = 1.0
    Ri[0] = Rj[0] = mR[0] = np.eye(3)
    ti[0] = tj[0] = mt[0] = 0.0
    return si, Ri, ti, sj, Rj, tj, ms, mR, mt


@pytest.mark.parametrize("fix_scale", [False, True])
def test_edge_residual_and_jacobians_match_jax(fix_scale):
    args = _edges(0)
    zero = jnp.zeros(7, jnp.float32)
    jargs = tuple(map(j_, args))
    e_ref = _np(jax.vmap(jeg._edge_residual, in_axes=IN_AXES)(zero, zero, *jargs, fix_scale))
    Ji_ref = _np(jax.vmap(jax.jacfwd(jeg._edge_residual, argnums=0), in_axes=IN_AXES)(
        zero, zero, *jargs, fix_scale))
    Jj_ref = _np(jax.vmap(jax.jacfwd(jeg._edge_residual, argnums=1), in_axes=IN_AXES)(
        zero, zero, *jargs, fix_scale))
    targs = tuple(map(t_, args))
    e = teg.edge_residuals(targs, fix_scale).numpy()
    Ji, Jj = (J.numpy() for J in teg.edge_jacobians(targs, fix_scale))
    assert Ji.shape == Jj.shape == (len(e), 7, 7)
    for a in (e, Ji, Jj, e_ref, Ji_ref, Jj_ref):
        assert np.isfinite(a).all()
    # the near-pi edge's rotation part may come out with the other sign of
    # the axis (both are logs of the same rotation): compare what it is
    np.testing.assert_allclose(e[[0, 2]], 0.0, atol=2e-6)
    assert abs(np.linalg.norm(e[1, :3]) - np.linalg.norm(e_ref[1, :3])) < 1e-4
    keep = np.arange(len(e)) != 1
    np.testing.assert_allclose(e[keep], e_ref[keep], atol=1e-5)
    if np.dot(e[1, :3], e_ref[1, :3]) > 0:
        keep = np.ones(len(e), bool)
        np.testing.assert_allclose(e[1], e_ref[1], atol=1e-3)
    np.testing.assert_allclose(Ji[keep], Ji_ref[keep], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(Jj[keep], Jj_ref[keep], atol=1e-4, rtol=1e-4)
    # at the identity the Jacobians are +I and -I (the reason for the
    # smoothed norm in log_so3: a plain norm gives NaN here)
    fixed_cols = np.eye(7, dtype=np.float32)
    if fix_scale:
        fixed_cols[6, 6] = 0.0
    np.testing.assert_allclose(Ji[0], fixed_cols, atol=1e-6)
    np.testing.assert_allclose(Jj[0], -fixed_cols, atol=1e-6)


def _chain_problem(seed, K=16, n_live=12, pad=5, bad_edge=False):
    """A drifted chain of n_live keyframes in K slots (the rest inert),
    odometry edges from the true relative poses, a loop edge to the start,
    vertex 0 fixed, `pad` padded edges."""
    rng = np.random.default_rng(seed)
    t_true = np.zeros((K, 3), np.float32)
    t_true[:n_live, 0] = np.linspace(0, n_live - 1, n_live)
    rv = np.zeros((K, 3))
    rv[:n_live, 1] = np.linspace(0, 0.6, n_live)
    R_true = Rotation.from_rotvec(rv).as_matrix().astype(np.float32)
    t_est = t_true.copy()
    t_est[:n_live] += np.cumsum(rng.normal(0, 0.05, (n_live, 3)), axis=0).astype(np.float32)
    t_est[0] = t_true[0]
    s_est = np.ones(K, np.float32)
    s_est[1:n_live] += rng.normal(0, 0.02, n_live - 1).astype(np.float32)
    e_i, e_j, e_s, e_R, e_t = [], [], [], [], []

    def add_edge(i, j):
        Sjw = (jnp.float32(1.0), j_(R_true[j]), j_(t_true[j]))
        s, R, t = jsim3.compose(*Sjw, *jsim3.inverse(jnp.float32(1.0), j_(R_true[i]), j_(t_true[i])))
        e_i.append(i); e_j.append(j)
        e_s.append(float(s)); e_R.append(_np(R)); e_t.append(_np(t))

    for i in range(n_live - 1):
        add_edge(i, i + 1)
    add_edge(0, n_live - 1)      # the loop edge
    add_edge(3, 7)               # a covisibility edge
    E = len(e_i)
    if bad_edge:
        e_t[4] = np.full(3, np.nan, np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    fixed[n_live + 1:] = True    # invalid slots; slot n_live is free but untouched
    return dict(
        s=s_est, R=R_true.copy(), t=t_est, fixed=fixed,
        e_i=np.concatenate([e_i, np.zeros(pad)]).astype(np.int32),
        e_j=np.concatenate([e_j, np.zeros(pad)]).astype(np.int32),
        e_s=np.concatenate([e_s, np.ones(pad)]).astype(np.float32),
        e_R=np.concatenate([np.stack(e_R), np.tile(np.eye(3), (pad, 1, 1))]).astype(np.float32),
        e_t=np.concatenate([np.stack(e_t), np.zeros((pad, 3))]).astype(np.float32),
        e_valid=np.concatenate([np.ones(E, bool), np.zeros(pad, bool)]),
    ), t_true, n_live


def _both(prob, iterations=20):
    ref = jeg.optimize_essential_graph(
        jeg.EssentialGraphProblem(**{k: j_(v) for k, v in prob.items()}), iterations=iterations)
    tp = {k: t_(v) for k, v in prob.items()}
    tp["e_i"], tp["e_j"] = tp["e_i"].to(torch.int64), tp["e_j"].to(torch.int64)
    got = teg.optimize_essential_graph(teg.EssentialGraphProblem(**tp), iterations=iterations)
    return ref, got


def test_optimize_essential_graph_matches_jax_on_a_drifted_chain():
    prob, t_true, n_live = _chain_problem(1)
    ref, got = _both(prob)
    chi_ref, chi = float(ref.chi2), float(got.chi2)
    print(f"essential graph: chi2 {chi:.6g} (ref {chi_ref:.6g})")
    assert abs(chi - chi_ref) <= 0.01 * chi_ref + 1e-9
    np.testing.assert_allclose(got.s.numpy(), _np(ref.s), atol=1e-4)
    np.testing.assert_allclose(got.R.numpy(), _np(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), _np(ref.t), atol=1e-4)
    # the loop is closed: the chain is back on the truth
    assert np.linalg.norm(got.t.numpy()[:n_live] - t_true[:n_live], axis=1).max() < 0.01
    assert np.abs(got.s.numpy() - 1).max() < 0.01
    # fixed and inert vertices did not move
    np.testing.assert_array_equal(got.t.numpy()[0], prob["t"][0])
    np.testing.assert_array_equal(got.t.numpy()[n_live:], prob["t"][n_live:])
    np.testing.assert_array_equal(got.s.numpy()[n_live:], prob["s"][n_live:])


def test_correct_points_and_recover_se3_match_jax():
    rng = np.random.default_rng(2)
    n = 20
    x = rng.normal(0, 2, (n, 3)).astype(np.float32)
    R = Rotation.from_rotvec(rng.normal(0, 0.5, (2, n, 3)).reshape(-1, 3)).as_matrix().astype(
        np.float32).reshape(2, n, 3, 3)
    s = rng.uniform(0.8, 1.2, (2, n)).astype(np.float32)
    t = rng.normal(0, 1, (2, n, 3)).astype(np.float32)
    got = teg.correct_points(t_(x), t_(s[0]), t_(R[0]), t_(t[0]), t_(s[1]), t_(R[1]), t_(t[1]))
    ref = jeg.correct_points(j_(x), j_(s[0]), j_(R[0]), j_(t[0]), j_(s[1]), j_(R[1]), j_(t[1]))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)
    for g, r in zip(teg.recover_se3(t_(s[0]), t_(R[0]), t_(t[0])),
                    jeg.recover_se3(j_(s[0]), j_(R[0]), j_(t[0]))):
        np.testing.assert_allclose(g.numpy(), _np(r), atol=1e-6)


def test_a_cholesky_that_breaks_down_rejects_the_step_in_both():
    """A non-finite measurement makes the normal equations non-finite:
    the reference's solve returns NaN, `chi_new < chi` is false and every
    step is rejected. The port's `cholesky_ex` must lead to the same, with
    nothing raised: finite poses, those it started from."""
    prob, _, _ = _chain_problem(3, bad_edge=True)
    ref, got = _both(prob, iterations=4)
    for name in ("s", "R", "t"):
        a = getattr(got, name).numpy()
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, prob[name])
        np.testing.assert_array_equal(_np(getattr(ref, name)), prob[name])
    assert not np.isfinite(float(got.chi2)) and not np.isfinite(float(ref.chi2))
