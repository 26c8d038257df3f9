"""The Jacobi solvers of the port (solvers/small_linalg.py, the plain
version of csrc/small_linalg.cu) against numpy.linalg in float64 and
jnp.linalg, and the `gpu`-marked kernel against its plain version.

Inputs are made with numpy from fixed seeds. Invariants, not bits: the
eigen-residual |A V - V L| / |A|, |V^T V - I|, the eigenvalues against
float64, subspaces where eigenvalues repeat, U S Vt against A, the rank the
pseudo-inverse keeps. Bounds: float32 Jacobi is backward stable, so 2e-6 of
|A| for residuals and eigenvalues (float32 eps is 1.2e-7; a 12x12 sweep
sums a few dozen rounding steps) and 5e-6 for orthogonality. The card's
kernel contracts multiply-adds, so it is held to the plain version by the
same invariants and to its eigenvalues within 2e-6 of |A|.

jax is imported inside the tests that use it: the card's machine has none,
and runs only the `gpu` tests of this file.
"""
import numpy as np
import pytest
import torch

from orbslam_jpminipc_torch.solvers import initializer
from orbslam_jpminipc_torch.solvers import small_linalg as sl
from orbslam_jpminipc_torch.solvers.linalg3 import det3, inv3_exact

torch.set_num_threads(2)

RES_TOL = 2e-6        # residuals and eigenvalues, relative to |A|
ORTH_TOL = 5e-6       # |V^T V - I|
SUBSPACE_TOL = 1e-5   # projectors onto a repeated eigenvalue's space
LAPACK_SIGN_SHARE = 0.99


def _spd(rng, batch, n, rank=None, scale=None):
    """P^T P of random point sets: (batch, n, n) float32."""
    m = n + 5
    X = rng.normal(size=(batch, m, n))
    if scale is not None:
        X = X * scale
    if rank is not None:
        X[..., rank:] = X[..., :rank] @ rng.normal(size=(batch, rank, n - rank))
    return np.einsum("bmi,bmj->bij", X, X).astype(np.float32)


def _sym(rng, batch, n):
    A = rng.normal(size=(batch, n, n))
    return ((A + np.swapaxes(A, 1, 2)) / 2).astype(np.float32)


def _eig_invariants(A, w, V):
    A, w, V = (np.asarray(x, np.float64) for x in (A, w, V))
    norm = np.linalg.norm(A, axis=(-2, -1))
    res = np.linalg.norm(A @ V - V * w[..., None, :], axis=(-2, -1)) / norm
    n = A.shape[-1]
    orth = np.abs(np.swapaxes(V, -1, -2) @ V - np.eye(n)).max(axis=(-2, -1))
    ref = np.linalg.eigvalsh(A)
    dw = np.abs(w - ref).max(-1) / norm
    return res.max(), orth.max(), dw.max()


@pytest.mark.parametrize("n", [3, 4, 9, 12])
@pytest.mark.parametrize("kind", ["spd", "indefinite"])
def test_eigh_small_against_float64(n, kind):
    rng = np.random.default_rng(n)
    A = _spd(rng, 64, n) if kind == "spd" else _sym(rng, 64, n)
    w, V = sl.eigh_small(torch.from_numpy(A))
    assert w.dtype == torch.float32 and V.shape == (64, n, n)
    res, orth, dw = _eig_invariants(A, w.numpy(), V.numpy())
    assert res <= RES_TOL and orth <= ORTH_TOL and dw <= RES_TOL, (res, orth, dw)
    assert (np.diff(w.numpy(), axis=-1) >= 0).all()
    # the sign convention: each column's largest entry positive
    Vn = V.numpy()
    big = np.take_along_axis(Vn, np.abs(Vn).argmax(-2)[:, None, :], -2)
    assert (big > 0).all()


@pytest.mark.parametrize("n", [3, 4, 9, 12])
def test_eigh_small_against_jnp(n):
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(100 + n)
    A = _spd(rng, 32, n)
    wj, Vj = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(A)))
    w, V = sl.eigh_small(torch.from_numpy(A))
    norm = np.linalg.norm(A, axis=(-2, -1))[:, None]
    assert (np.abs(w.numpy() - wj) / norm).max() <= RES_TOL
    # well-separated spectra: the same vectors up to sign
    dots = np.abs(np.einsum("bij,bij->bj", V.numpy(), Vj))
    assert dots.min() >= 1 - 1e-4


@pytest.mark.parametrize("n", [4, 9, 12])
def test_eigh_small_repeated_eigenvalues_as_subspaces(n):
    """A = Q diag(1, 1, 1, 2, ...) Q^T: the triple eigenvalue's vectors are
    any basis of its space; its projector is determined."""
    rng = np.random.default_rng(200 + n)
    Q = np.linalg.qr(rng.normal(size=(16, n, n)))[0]
    lam = np.concatenate([[1.0, 1.0, 1.0], 2.0 + np.arange(n - 3)])
    A = (Q * lam[None, None, :]) @ np.swapaxes(Q, 1, 2)
    w, V = sl.eigh_small(torch.from_numpy(A.astype(np.float32)))
    w, V = w.numpy().astype(np.float64), V.numpy().astype(np.float64)
    np.testing.assert_allclose(w, np.broadcast_to(lam, w.shape), atol=RES_TOL * np.sqrt(n) * 3)
    P = V[..., :3] @ np.swapaxes(V[..., :3], 1, 2)
    P_ref = Q[..., :3] @ np.swapaxes(Q[..., :3], 1, 2)
    assert np.abs(P - P_ref).max() <= SUBSPACE_TOL
    res, orth, _ = _eig_invariants(A, w, V)
    assert res <= RES_TOL * 3 and orth <= ORTH_TOL


@pytest.mark.parametrize("shape", ["coplanar", "colinear"])
def test_eigh_small_rank_deficient_scatter(shape):
    """P^T P of coplanar (rank 2) and colinear (rank 1) points, as EPnP's
    control points meet them on planar scenes."""
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(32, 20, 3))
    if shape == "coplanar":
        pts[..., 2] = 0.3 * pts[..., 0] - 0.2 * pts[..., 1]
    else:
        pts = pts[..., :1] * np.array([0.6, -0.3, 0.2])
    d = pts - pts.mean(1, keepdims=True)
    A = np.einsum("bmi,bmj->bij", d, d).astype(np.float32)
    w, V = sl.eigh_small(torch.from_numpy(A))
    res, orth, dw = _eig_invariants(A, w.numpy(), V.numpy())
    assert res <= RES_TOL and orth <= ORTH_TOL and dw <= RES_TOL
    zeros = 1 if shape == "coplanar" else 2
    norm = np.linalg.norm(A, axis=(-2, -1))
    assert (np.abs(w.numpy()[:, :zeros]) <= RES_TOL * norm[:, None]).all()


def test_lapack_signs_match_jnp_eigh():
    """`lapack_signs=True` (EPnP's PCA axes): the sign of every column as
    jnp.linalg.eigh (LAPACK ssyev) gives it, on point clouds of every
    flatness; ties of the emulation's float32 rounding with LAPACK's may
    flip a degenerate axis (measured: 19 of 6,000 sets)."""
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(11)
    mats = []
    for i in range(600):
        pts = rng.normal(size=(rng.integers(4, 40), 3)) * rng.uniform(0.01, 3, 3)
        if i % 3 == 1:
            pts[:, 2] *= 1e-4
        if i % 3 == 2:
            pts[:, 2] = 0.0
        if i % 2:
            pts = pts @ np.linalg.qr(rng.normal(size=(3, 3)))[0]
        d = pts - pts.mean(0)
        mats.append(d.T @ d)
    A = np.array(mats, np.float32)
    Vj = np.asarray(jnp.linalg.eigh(jnp.asarray(A))[1])
    w, V = sl.eigh_small(torch.from_numpy(A), lapack_signs=True)
    res, orth, _ = _eig_invariants(A, w.numpy(), V.numpy())
    assert res <= RES_TOL and orth <= ORTH_TOL
    agree = np.all(np.einsum("bij,bij->bj", V.numpy(), Vj) > 0, axis=-1)
    assert agree.mean() >= LAPACK_SIGN_SHARE, agree.mean()
    with pytest.raises(ValueError):
        sl.eigh_small(torch.eye(4)[None], lapack_signs=True)


def test_lapack_rotation_in_and_out_of_range():
    """The emulation's slartg (LAPACK >= 3.10) on operands whose squares
    leave float32 (scaled) and inside it: c^2 + s^2 = 1 and
    [c s; -s c] [f; g] = [r; 0] within float32 rounding, c >= 0, r with f's
    sign. Unscaled, the colinear scatter's QR sweep took slartg(7e-18,
    ~1e-22) to 0 / 0, and its axes' signs from NaN."""
    f = torch.tensor([7.1e-18, -3e-25, 2e25, -1.5, 0.0, 4.0], dtype=torch.float32)
    g = torch.tensor([-1.6e-22, 5e-26, -3e24, 2.5, 2.0, 0.0], dtype=torch.float32)
    c, s, r = sl._slartg(f, g)
    f64, g64, c64, s64, r64 = (x.double() for x in (f, g, c, s, r))
    assert torch.isfinite(torch.stack([c, s, r])).all()
    assert (torch.abs(c64 ** 2 + s64 ** 2 - 1) <= 4e-7).all()
    scale = torch.maximum(f64.abs(), g64.abs())
    assert (torch.abs(c64 * f64 + s64 * g64 - r64) <= 4e-7 * scale).all()
    assert (torch.abs(-s64 * f64 + c64 * g64) <= 4e-7 * scale).all()
    assert (c >= 0).all() and (torch.sign(r[f != 0]) == torch.sign(f[f != 0])).all()


@pytest.mark.parametrize("n", [3, 4])
def test_svd_small_against_float64_and_jnp(n):
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(300 + n)
    A = rng.normal(size=(64, n, n)).astype(np.float32)
    U, S, Vt = (x.numpy().astype(np.float64) for x in sl.svd_small(torch.from_numpy(A)))
    norm = np.linalg.norm(A, axis=(-2, -1))
    rec = np.abs(U * S[:, None, :] @ Vt - A).max(axis=(-2, -1)) / norm
    assert rec.max() <= RES_TOL
    for M in (U, np.swapaxes(Vt, 1, 2)):
        assert np.abs(np.swapaxes(M, 1, 2) @ M - np.eye(n)).max() <= ORTH_TOL
    assert (np.diff(S, axis=-1) <= 0).all()
    ref = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert (np.abs(S - ref).max(-1) / norm).max() <= RES_TOL
    Sj = np.asarray(jnp.linalg.svd(jnp.asarray(A), compute_uv=False))
    assert (np.abs(S - Sj).max(-1) / norm).max() <= RES_TOL
    # det(U Vt) is +-1: what EPnP's and the initializer's rotations use
    np.testing.assert_allclose(np.abs(np.linalg.det(U @ Vt)), 1.0, atol=ORTH_TOL)


@pytest.mark.parametrize("n", [3, 4])
def test_svd_small_completes_zero_singular_values(n):
    """A zero column (a planar point set's H, a rank-2 E): U stays a full
    orthonormal basis."""
    rng = np.random.default_rng(400 + n)
    A = rng.normal(size=(16, n, n)).astype(np.float32)
    A[:, :, -1] = 0.0
    A[:8, :, -2] = 0.0
    U, S, Vt = (x.numpy().astype(np.float64) for x in sl.svd_small(torch.from_numpy(A)))
    assert (S[:, -1] == 0).all() and (S[:8, -2] == 0).all()
    assert np.abs(np.swapaxes(U, 1, 2) @ U - np.eye(n)).max() <= ORTH_TOL
    assert np.abs(U * S[:, None, :] @ Vt - A).max() <= RES_TOL * np.linalg.norm(A, axis=(1, 2)).max()


def _control_matrix(points):
    """EPnP's C = [control points^T; 1] (4x4) of a point set: the centroid
    and the PCA axes scaled by sqrt(lambda / N), lambda clamped at 1e-12."""
    c0 = points.mean(0)
    d = points - c0
    lam, vec = np.linalg.eigh(d.T @ d)
    k = np.sqrt(np.maximum(lam, 1e-12) / len(points))
    ctrl = np.concatenate([c0[None], c0 + (k[::-1, None] * vec.T[::-1])])
    return np.concatenate([ctrl.T, np.ones((1, 4))]).astype(np.float32)


@pytest.mark.parametrize("shape", ["general", "planar", "colinear"])
def test_pinv_small_keeps_jnp_rank_at_1e_6(shape):
    """EPnP's C truncated at rtol 1e-6: the same rank as jnp.linalg.pinv, and
    the same pseudo-inverse where the kept singular values are clear of the
    cut."""
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(500)
    Cs = []
    for _ in range(32):
        pts = rng.normal(size=(12, 3)) * [2.0, 1.5, 1.0] + [0.1, -0.2, 4.0]
        if shape == "planar":
            pts[:, 2] = 4.0
        elif shape == "colinear":
            pts = np.outer(rng.normal(size=12), [1.0, 0.5, -0.2]) + [0.0, 0.0, 4.0]
        Cs.append(_control_matrix(pts))
    C = np.array(Cs)
    U, S, Vt = sl.svd_small(torch.from_numpy(C))
    rank = (S > 1e-6 * S[:, :1]).sum(-1).numpy()
    sj = np.asarray(jnp.linalg.svd(jnp.asarray(C), compute_uv=False))
    rank_j = (sj > 1e-6 * sj[:, :1]).sum(-1)
    np.testing.assert_array_equal(rank, rank_j)
    assert set(rank.tolist()) == {"general": {4}, "planar": {3}, "colinear": {2}}[shape]
    got = sl.pinv_small(torch.from_numpy(C), 1e-6).numpy()
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(C), rtol=1e-6))
    scale = np.abs(want).max(axis=(1, 2))
    assert (np.abs(got - want).max(axis=(1, 2)) / scale).max() <= 1e-4


def test_non_finite_input_gives_nan_and_never_raises():
    rng = np.random.default_rng(600)
    A = _spd(rng, 4, 12)
    A[1, 3, 5] = np.nan
    A[2, 0, 0] = np.inf
    w, V = sl.eigh_small(torch.from_numpy(A))
    for b in (1, 2):
        assert torch.isnan(w[b]).all() and torch.isnan(V[b]).all()
    assert torch.isfinite(w[[0, 3]]).all() and torch.isfinite(V[[0, 3]]).all()
    M = rng.normal(size=(3, 3, 3)).astype(np.float32)
    M[0, 1, 1] = np.nan
    U, S, Vt = sl.svd_small(torch.from_numpy(M))
    P = sl.pinv_small(torch.from_numpy(M), 1e-6)
    for x in (U, S, Vt, P):
        assert torch.isnan(x[0]).all() and torch.isfinite(x[1:]).all()


def test_sizes_outside_the_kernel_raise():
    with pytest.raises(ValueError):
        sl.eigh_small(torch.eye(13)[None])
    with pytest.raises(ValueError):
        sl.svd_small(torch.eye(5)[None])
    with pytest.raises(ValueError):
        sl.svd_small(torch.zeros(2, 3, 4))


def test_round_robin_rounds_cover_every_pair_once():
    for m in (2, 4, 10, 12):
        pairs = [p for r in sl.rounds(m) for p in r]
        assert len(pairs) == len(set(pairs)) == m * (m - 1) // 2
        for r in sl.rounds(m):
            flat = [i for p in r for i in p]
            assert len(set(flat)) == m          # disjoint within a round


def test_det3_and_inv3_exact_against_numpy():
    rng = np.random.default_rng(700)
    M = rng.normal(size=(50, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(det3(torch.from_numpy(M)).numpy(), np.linalg.det(M),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inv3_exact(torch.from_numpy(M)).numpy(), np.linalg.inv(M),
                               rtol=1e-3, atol=1e-4)
    S = np.zeros((1, 3, 3), np.float32)
    assert not torch.isfinite(inv3_exact(torch.from_numpy(S))).all()


def test_replayed_sets_select_exactly_through_scores():
    """`scores_for_sets` then `select_minimal_sets` gives back each set in
    its order, even an index the mask excludes; uniform scores give the
    generator draw's sets."""
    rng = np.random.default_rng(800)
    n = 60
    mask = torch.from_numpy(rng.random(n) < 0.5)
    sets = torch.from_numpy(np.stack([rng.choice(n, 4, replace=False) for _ in range(32)]))
    got = initializer.select_minimal_sets(initializer.scores_for_sets(sets, n), mask, 4)
    np.testing.assert_array_equal(got.numpy(), sets.numpy())
    gen = torch.Generator().manual_seed(3)
    drawn = initializer.sample_minimal_sets(gen, mask, 32, k=4)
    scores = torch.rand((32, n), generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(drawn.numpy(),
                                  initializer.select_minimal_sets(scores, mask, 4).numpy())
    assert mask[drawn].all()


# ---- the kernel on the card --------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from orbslam_jpminipc_torch.ops import small_linalg_cuda

    small_linalg_cuda.build()
    return torch.device("cuda", torch.cuda.current_device())


# the main path's shapes and batches (csrc/small_linalg.cu's table)
CARD_EIGH = [(3, 257), (12, 257), (4, 129), (9, 200)]
CARD_SVD = [(3, 771), (4, 257), (3, 200), (3, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,batch", CARD_EIGH)
def test_kernel_eigh_matches_plain_on_the_card(card, n, batch):
    from orbslam_jpminipc_torch.ops import small_linalg_cuda as k

    rng = np.random.default_rng(900 + n)
    A = _spd(rng, batch, n)
    A[: batch // 4] = _sym(rng, batch // 4, n)
    Ad = torch.from_numpy(A).to(card)
    before = k.LAUNCHES
    w, V = k.eigh_small(Ad, lapack_signs=n == 3)
    torch.cuda.synchronize()
    assert k.LAUNCHES == before + 1
    wp, Vp = sl.eigh_small(torch.from_numpy(A), lapack_signs=n == 3)
    res, orth, dw = _eig_invariants(A, w.cpu().numpy(), V.cpu().numpy())
    assert res <= RES_TOL and orth <= ORTH_TOL and dw <= RES_TOL
    norm = np.linalg.norm(A, axis=(-2, -1))[:, None]
    assert (np.abs(w.cpu().numpy() - wp.numpy()) / norm).max() <= RES_TOL
    # the same sign convention column by column
    dots = np.einsum("bij,bij->bj", V.cpu().numpy(), Vp.numpy())
    assert (dots > 0).mean() >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("n,batch", CARD_SVD)
def test_kernel_svd_matches_plain_on_the_card(card, n, batch):
    from orbslam_jpminipc_torch.ops import small_linalg_cuda as k

    rng = np.random.default_rng(1000 + n)
    A = rng.normal(size=(batch, n, n)).astype(np.float32)
    A[: batch // 8, :, -1] = 0.0
    U, S, Vt = (x.cpu().numpy().astype(np.float64)
                for x in k.svd_small(torch.from_numpy(A).to(card)))
    norm = np.linalg.norm(A, axis=(-2, -1))
    assert (np.abs(U * S[:, None, :] @ Vt - A).max(axis=(-2, -1)) / norm).max() <= RES_TOL
    assert np.abs(np.swapaxes(U, 1, 2) @ U - np.eye(n)).max() <= ORTH_TOL
    Sp = sl.svd_small(torch.from_numpy(A))[1].numpy()
    assert (np.abs(S - Sp).max(-1) / norm).max() <= RES_TOL


@pytest.mark.gpu
def test_kernel_nan_and_bad_shapes_on_the_card(card):
    from orbslam_jpminipc_torch.ops import small_linalg_cuda as k

    A = torch.eye(12, device=card).repeat(3, 1, 1)
    A[1, 2, 2] = float("nan")
    w, V = k.eigh_small(A)
    assert torch.isnan(w[1]).all() and torch.isfinite(w[[0, 2]]).all()
    with pytest.raises(ValueError):
        k.eigh_small(torch.eye(13, device=card)[None])
    with pytest.raises(ValueError):
        k.svd_small(torch.eye(4, device=card, dtype=torch.float64)[None])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n", [("eigh", 3), ("eigh", 4), ("eigh", 9), ("eigh", 12),
                                    ("svd", 3), ("svd", 4)])
def test_kernel_result_does_not_depend_on_its_warp(card, kind, n):
    """The kernel stops when no matrix of a warp rotated in a sweep (one
    vote a warp); a matrix that converged earlier rotates nothing in the
    sweeps after, so each matrix's result equals its own launch's (a stop
    for that matrix alone), bit for bit: every matrix of a batch against a
    launch of it alone and a launch beside slow neighbours."""
    from orbslam_jpminipc_torch.ops import small_linalg_cuda as k

    rng = np.random.default_rng(1100 + n)
    A = _spd(rng, 48, n) if kind == "eigh" else rng.normal(size=(48, n, n)).astype(np.float32)
    A[::3] = np.eye(n, dtype=np.float32) * 2   # converged at once
    fn = k.eigh_small if kind == "eigh" else k.svd_small
    batch = fn(torch.from_numpy(A).to(card))
    # each matrix alone, and again after a random one (matrix 1) in its warp
    for b in range(0, 48, 5):
        alone = fn(torch.from_numpy(A[b:b + 1]).to(card))
        paired = fn(torch.from_numpy(A[[1, b]]).to(card))
        for x, y, z in zip(batch, alone, paired):
            assert torch.equal(x[b], y[0]) and torch.equal(x[b], z[1]), (kind, n, b)
