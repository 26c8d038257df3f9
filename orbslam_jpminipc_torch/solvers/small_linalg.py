"""Small symmetric eigendecompositions, SVDs and pseudo-inverses by Jacobi
rotations: the plain PyTorch version of the CUDA kernel
csrc/small_linalg.cu (its wrapper: ops/small_linalg_cuda.py).

The reference calls `jnp.linalg.eigh`, `svd` and `pinv` inside its jitted
solvers (EPnP, the Sim3 RANSAC, the H/F initializer), and XLA lowers them
to iterative Jacobi-type solvers on a TPU. Here the same functions are
Jacobi iterations written out, so that they run without a host read on a
card and can be captured into a program; torch.linalg's forms check their
result on the host. This module runs the kernel's algorithm in torch
operations, step for step:

* `eigh_small` (symmetric n <= 12): the input symmetrized as (A + A^T) / 2
  (jnp's default), then cyclic two-sided Jacobi in parallel (round-robin)
  order: an odd n is padded with a decoupled zero row and column, and each
  of the m - 1 rounds of a sweep (m the padded size) applies m / 2 disjoint
  rotations at once, columns first, then rows, then the rotated 2 x 2
  blocks set exactly (Rutishauser's update). A pair rotates when
  |a_pq| > EIGH_TOL sqrt|a_pp| sqrt|a_qq|; a matrix stops after the first
  sweep that rotates nothing, or after `max_sweeps`.
* `svd_small` (square n <= 4): one-sided (Hestenes) Jacobi on the columns
  in the same round-robin order: a pair rotates when
  |u_p . u_q| > SVD_TOL |u_p| |u_q|, with the same stopping rule. The
  singular values are the column norms; U's columns of a zero singular
  value are completed to an orthonormal basis by Gram-Schmidt on the unit
  vector with the largest residual (the first of equals).
* `pinv_small(A, rtol)`: from `svd_small`, keeping s > rtol * s_max, as
  `jnp.linalg.pinv`.

Conventions, as `jnp.linalg`: eigenvalues ascending with the eigenvectors
as columns; singular values descending, `U, S, Vt`. Ties keep the lower
index first. Signs: each eigenvector, and each right singular vector (with
its left one), has its largest-magnitude component (the first of equals)
positive. A matrix with a non-finite entry gives NaN everywhere, and
nothing raises. Everything is float32, as the reference computes.

This version is what the port runs on the CPU, and what the tests and
chip_smoke.py hold the kernel to; it reads the host once a sweep to stop
when every matrix has, which the kernel decides per matrix on the card.
"""
from __future__ import annotations

from functools import lru_cache

import torch

MAX_N = 12             # eigh: the kernel's largest matrix (csrc/small_linalg.cu)
MAX_SVD_N = 4          # svd and pinv
EIGH_SWEEPS = 16       # sweep limits; the early exit comes first in practice
SVD_SWEEPS = 16
_EPS = 1.1920929e-07   # float32 machine epsilon
EIGH_TOL = _EPS
SVD_TOL = 4 * _EPS     # a computed dot product of 4-vectors is good to ~4 eps
BIG = 1e18             # |theta| above this: t = 1 / (2 theta), theta^2 would overflow

# the sweeps the plain version has run, summed over matrices (a sweep of
# every matrix still rotating), by solver: what a measurement counts the
# operations of a call by (chip_smoke.py), the kernel's sweeps being these
SWEEPS = {"eigh": 0, "svd": 0}


@lru_cache(maxsize=None)
def rounds(m: int) -> tuple:
    """The round-robin order for an even size m: m - 1 rounds of m / 2
    disjoint pairs (p < q), by the circle method: in round r, pair 0 is
    (r, m - 1) and pair k >= 1 is {(r + k) mod (m - 1), (r - k) mod (m - 1)}
    (the same formula as csrc/small_linalg.cu:pair)."""
    out = []
    for r in range(m - 1):
        pairs = [(r, m - 1)]
        for k in range(1, m // 2):
            a, b = (r + k) % (m - 1), (r - k) % (m - 1)
            pairs.append((min(a, b), max(a, b)))
        out.append(tuple(pairs))
    return tuple(out)


def _round_index(m: int, device) -> list:
    return [(torch.tensor([p for p, _ in rr], device=device),
             torch.tensor([q for _, q in rr], device=device)) for rr in rounds(m)]


def _rotation(d, g, rot):
    """(c, s, t) of the rotation that zeroes g against the difference d
    (a_qq - a_pp, or beta - alpha): theta = d / (2 g),
    t = sign(theta) / (|theta| + sqrt(1 + theta^2)) with sign(0) = 1. Where
    `rot` is false: the identity."""
    g = torch.where(rot, g, torch.ones_like(g))
    theta = d / (2.0 * g)
    at = torch.abs(theta)
    sgn = torch.where(theta >= 0, 1.0, -1.0)
    t = torch.where(at > BIG, 0.5 / theta, sgn / (at + torch.sqrt(1.0 + theta * theta)))
    t = torch.where(rot, t, torch.zeros_like(t))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c, t


def _rotate_columns(X, P, Q, c, s):
    """X <- X J over the round's pairs: column p becomes c x_p - s x_q and
    column q becomes s x_p + c x_q."""
    xp, xq = X[..., :, P], X[..., :, Q]
    c, s = c[..., None, :], s[..., None, :]
    X[..., :, P] = c * xp - s * xq
    X[..., :, Q] = s * xp + c * xq


def _sign_fix(V):
    """The sign of each column that makes its largest-magnitude entry (the
    first of equals) positive."""
    i = torch.argmax(torch.abs(V), dim=-2, keepdim=True)
    return torch.where(torch.gather(V, -2, i) < 0, -1.0, 1.0)


def _finite(A):
    return torch.isfinite(A).flatten(-2).all(-1)


def eigh_small(A: torch.Tensor, max_sweeps: int = EIGH_SWEEPS, lapack_signs: bool = False):
    """(w, V) of symmetric (..., n, n) float32 A, n <= 12: eigenvalues
    ascending (..., n), eigenvectors as the columns of V (..., n, n).
    `lapack_signs` (n = 3 only): each eigenvector's sign is the one LAPACK's
    ssyev gives it (`lapack_signs3`) in place of the largest-component
    rule."""
    n = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"eigh_small takes (..., n, n) with n <= {MAX_N}, got {tuple(A.shape)}")
    if lapack_signs and n != 3:
        raise ValueError(f"lapack_signs takes n = 3, got {n}")
    lead = A.shape[:-2]
    A = A.reshape(-1, n, n).to(torch.float32)
    ok = _finite(A)
    A = torch.where(ok[:, None, None], A, torch.zeros_like(A))
    A = 0.5 * (A + A.transpose(-1, -2))
    A0 = A
    m = n + n % 2
    if m != n:
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
    B = A.shape[0]
    V = torch.eye(m, dtype=A.dtype, device=A.device).expand(B, m, m).clone()
    active = torch.ones(B, dtype=torch.bool, device=A.device)
    idx = _round_index(m, A.device)
    for _ in range(max_sweeps):
        SWEEPS["eigh"] += int(active.sum())
        rotated = torch.zeros_like(active)
        for P, Q in idx:
            app, aqq, apq = A[:, P, P], A[:, Q, Q], A[:, P, Q]
            rot = (torch.abs(apq) > EIGH_TOL * torch.sqrt(torch.abs(app))
                   * torch.sqrt(torch.abs(aqq))) & active[:, None]
            c, s, t = _rotation(aqq - app, apq, rot)
            _rotate_columns(A, P, Q, c, s)
            _rotate_columns(V, P, Q, c, s)
            ap, aq = A[:, P, :], A[:, Q, :]
            A[:, P, :] = c[..., None] * ap - s[..., None] * aq
            A[:, Q, :] = s[..., None] * ap + c[..., None] * aq
            zero = torch.zeros_like(apq)
            A[:, P, P] = torch.where(rot, app - t * apq, A[:, P, P])
            A[:, Q, Q] = torch.where(rot, aqq + t * apq, A[:, Q, Q])
            A[:, P, Q] = torch.where(rot, zero, A[:, P, Q])
            A[:, Q, P] = torch.where(rot, zero, A[:, Q, P])
            rotated |= rot.any(-1)
        active &= rotated
        if not bool(active.any()):
            break
    w = torch.diagonal(A, dim1=-2, dim2=-1)[:, :n]
    V = V[:, :n, :n]
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[:, None, :].expand(B, n, n))
    V = V * (lapack_signs3(A0, V) if lapack_signs else _sign_fix(V))
    nan = torch.full_like(w, float("nan"))
    w = torch.where(ok[:, None], w, nan)
    V = torch.where(ok[:, None, None], V, nan[:, :, None].expand(B, n, n))
    return w.reshape(*lead, n), V.reshape(*lead, n, n)


def svd_small(A: torch.Tensor, max_sweeps: int = SVD_SWEEPS):
    """(U, S, Vt) of square (..., n, n) float32 A, n <= 4: A = U diag(S) Vt,
    singular values descending."""
    n = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != n or not 1 <= n <= MAX_SVD_N:
        raise ValueError(f"svd_small takes (..., n, n) with n <= {MAX_SVD_N}, "
                         f"got {tuple(A.shape)}")
    lead = A.shape[:-2]
    U = A.reshape(-1, n, n).to(torch.float32)
    ok = _finite(U)
    U = torch.where(ok[:, None, None], U, torch.zeros_like(U))
    m = n + n % 2
    if m != n:
        U = torch.nn.functional.pad(U, (0, 1))           # a decoupled zero column
    B = U.shape[0]
    V = torch.eye(m, dtype=U.dtype, device=U.device).expand(B, m, m).clone()
    active = torch.ones(B, dtype=torch.bool, device=U.device)
    idx = _round_index(m, U.device)
    for _ in range(max_sweeps):
        SWEEPS["svd"] += int(active.sum())
        rotated = torch.zeros_like(active)
        for P, Q in idx:
            up, uq = U[:, :, P], U[:, :, Q]
            alpha = torch.sum(up * up, dim=-2)
            beta = torch.sum(uq * uq, dim=-2)
            gamma = torch.sum(up * uq, dim=-2)
            rot = (torch.abs(gamma) > SVD_TOL * torch.sqrt(alpha) * torch.sqrt(beta)) \
                & active[:, None]
            c, s, _ = _rotation(beta - alpha, gamma, rot)
            _rotate_columns(U, P, Q, c, s)
            _rotate_columns(V, P, Q, c, s)
            rotated |= rot.any(-1)
        active &= rotated
        if not bool(active.any()):
            break
    U, V = U[:, :, :n], V[:, :n, :n]
    S = torch.sqrt(torch.sum(U * U, dim=-2))
    order = torch.argsort(-S, dim=-1, stable=True)
    S = torch.gather(S, -1, order)
    perm = order[:, None, :].expand(B, n, n)
    U, V = torch.gather(U, -1, perm), torch.gather(V, -1, perm)
    sign = _sign_fix(V)
    U, V = U * sign, V * sign
    pos = S > 0
    U = torch.where(pos[:, None, :], U / torch.where(pos, S, 1.0)[:, None, :],
                    torch.zeros_like(U))
    U = _complete(U, pos)
    nan = torch.full_like(S, float("nan"))
    S = torch.where(ok[:, None], S, nan)
    U = torch.where(ok[:, None, None], U, nan[:, :, None].expand(B, n, n))
    V = torch.where(ok[:, None, None], V, nan[:, :, None].expand(B, n, n))
    return U.reshape(*lead, n, n), S.reshape(*lead, n), V.transpose(-1, -2).reshape(*lead, n, n)


def _complete(U, pos):
    """U's columns where `pos` is false (zero singular values: zero columns
    so far) completed in order to an orthonormal basis: the unit vector e_k
    with the largest residual after projecting out the columns set so far
    (the first of equals), normalized."""
    n = U.shape[-1]
    eye = torch.eye(n, dtype=U.dtype, device=U.device)
    for j in range(n):
        R = eye - U @ U.transpose(-1, -2)           # column k: e_k's residual
        norm = torch.sqrt(torch.sum(R * R, dim=-2))
        k = torch.argmax(norm, dim=-1, keepdim=True)
        col = torch.gather(R, -1, k[:, None, :].expand(-1, n, 1))[..., 0]
        col = col / torch.gather(norm, -1, k)
        U[:, :, j] = torch.where(pos[:, j, None], U[:, :, j], col)
    return U


def pinv_small(A: torch.Tensor, rtol: float):
    """Pseudo-inverse of square (..., n, n) A, n <= 4, by `svd_small`:
    singular values s > rtol * s_max kept (jnp.linalg.pinv's rule)."""
    return pinv_from_svd(*svd_small(A), rtol)


def pinv_from_svd(U, S, Vt, rtol: float):
    """V diag(1/s) U^T over the singular values above rtol * s_max."""
    keep = S > rtol * S[..., :1]
    inv = torch.where(keep, 1.0 / torch.where(keep, S, 1.0), torch.zeros_like(S))
    return Vt.transpose(-1, -2) @ (inv[..., :, None] * U.transpose(-1, -2))


# ---- LAPACK's eigenvector signs for 3x3 ------------------------------------
#
# EPnP's control points are the centroid plus the PCA axes of the points
# (solvers/epnp.py:_weighted_control_points), and its pose depends on the
# axes' signs (not only in theory: a near-planar refit moves by 4e-3 rad
# between sign patterns, a planar one by 0.2). The reference's signs are
# those of LAPACK's ssyev (jnp.linalg.eigh on the CPU): Householder
# tridiagonalization (ssytd2, lower) and implicit QL/QR with Wilkinson shifts
# (ssteqr, LAPACK >= 3.10's slartg, slaev2), the eigenvectors accumulated on
# the Householder matrix and selection-sorted. `lapack_signs3` runs those
# steps in float32 for a batch of 3x3 matrices, a fixed LAPACK_STEPS
# events each (a split, a deflation, a 2x2 block or a QL/QR sweep; a
# matrix that needs more keeps its state: 3x3 needs a few), and returns the
# sign that turns each column of V towards its LAPACK eigenvector.
# csrc/small_linalg.cu:lapack_signs3 is the same in one thread a matrix.

LAPACK_EPS = 2.0 ** -24          # slamch('E') in float32
LAPACK_SAFMIN = 1.1754944e-38    # slamch('S'), 2^-126
LAPACK_RTMIN = 2.0 ** -63        # slartg's sqrt(safmin)
LAPACK_RTMAX = 2.0 ** 62.5       # slartg's sqrt(safmax / 2)
LAPACK_STEPS = 16


def _fsign(a, b):
    """Fortran SIGN(a, b): |a| with the sign of b (b >= 0: +)."""
    return torch.where(b >= 0, torch.abs(a), -torch.abs(a))


def _slapy2(x, y):
    """sqrt(x^2 + y^2) as LAPACK's slapy2 scales it."""
    w = torch.maximum(torch.abs(x), torch.abs(y))
    z = torch.minimum(torch.abs(x), torch.abs(y))
    return torch.where(z == 0, w, w * torch.sqrt(1.0 + (z / torch.where(w == 0, 1.0, w)) ** 2))


def _slartg(f, g):
    """(c, s, r) with [c s; -s c] [f; g] = [r; 0] (LAPACK >= 3.10: c >= 0,
    r with the sign of f; f and g scaled where their squares would leave
    float32's range)."""
    f1, g1 = torch.abs(f), torch.abs(g)
    inside = ((f1 > LAPACK_RTMIN) & (f1 < LAPACK_RTMAX)
              & (g1 > LAPACK_RTMIN) & (g1 < LAPACK_RTMAX))
    u = torch.where(inside, 1.0, torch.clamp(torch.maximum(f1, g1), min=LAPACK_SAFMIN,
                                             max=1.0 / LAPACK_SAFMIN))
    fs, gs = f / u, g / u
    d = torch.sqrt(fs * fs + gs * gs)
    g0, f0 = g == 0, f == 0
    rs = _fsign(d, f)
    r = torch.where(g0, f, torch.where(f0, g1, rs * u))
    c = torch.where(g0, 1.0, torch.where(f0, 0.0, torch.abs(fs) / d))
    s = torch.where(g0, 0.0, torch.where(f0, torch.where(g >= 0, 1.0, -1.0), gs / rs))
    return c, s, r


def _slaev2(a, b, c):
    """(rt1, rt2, cs1, sn1) of [[a, b], [b, c]]: rt1 the eigenvalue of larger
    magnitude, (cs1, sn1) its unit eigenvector (LAPACK slaev2)."""
    sm, df = a + c, a - c
    adf, tb = torch.abs(df), b + b
    ab = torch.abs(tb)
    big = torch.abs(a) > torch.abs(c)
    acmx, acmn = torch.where(big, a, c), torch.where(big, c, a)
    rt = torch.where(adf > ab, adf * torch.sqrt(1.0 + (ab / adf) ** 2),
                     torch.where(adf < ab, ab * torch.sqrt(1.0 + (adf / ab) ** 2),
                                 ab * 1.4142135))
    rt1 = torch.where(sm < 0, 0.5 * (sm - rt), 0.5 * (sm + rt))
    rt1 = torch.where(sm == 0, 0.5 * rt, rt1)
    rt2 = torch.where(sm == 0, -0.5 * rt, (acmx / rt1) * acmn - (b / rt1) * b)
    sgn1 = torch.where(sm < 0, -1, 1)
    cs = torch.where(df >= 0, df + rt, df - rt)
    sgn2 = torch.where(df >= 0, 1, -1)
    ct = -tb / cs
    sn_a = 1.0 / torch.sqrt(1.0 + ct * ct)
    tn = -cs / tb
    cs_b = 1.0 / torch.sqrt(1.0 + tn * tn)
    wide = torch.abs(cs) > ab
    cs1 = torch.where(wide, ct * sn_a, torch.where(ab == 0, 1.0, cs_b))
    sn1 = torch.where(wide, sn_a, torch.where(ab == 0, 0.0, tn * cs_b))
    swap = sgn1 == sgn2
    return rt1, rt2, torch.where(swap, -sn1, cs1), torch.where(swap, cs1, sn1)


def _rot(Z, j, c, s, mask):
    """Z's columns j, j + 1 rotated as slasr('R', 'V', ...) does, where `mask`."""
    t, z = Z[:, :, j + 1].clone(), Z[:, :, j].clone()
    c, s = c[:, None], s[:, None]
    m = mask[:, None]
    Z[:, :, j + 1] = torch.where(m, c * t - s * z, t)
    Z[:, :, j] = torch.where(m, s * t + c * z, z)


def lapack_signs3(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(B, 1, 3) signs turning each column of V (B, 3, 3), eigenvectors of
    symmetric A (B, 3, 3) in ascending order, towards LAPACK ssyev's
    eigenvectors of A."""
    B = A.shape[0]
    f = lambda x: x.to(torch.float32)
    a00, a10, a20 = A[:, 0, 0], A[:, 1, 0], A[:, 2, 0]
    a11, a21, a22 = A[:, 1, 1], A[:, 2, 1], A[:, 2, 2]
    # ssytd2 (lower): one reflector, slarfg(2, a10, a20)
    xnorm = torch.abs(a20)
    refl = xnorm != 0
    beta = -_fsign(_slapy2(a10, xnorm), a10)
    beta = torch.where(refl, beta, a10)
    tau = torch.where(refl, (beta - a10) / torch.where(refl, beta, 1.0), 0.0)
    v2 = a20 * (1.0 / torch.where(refl, a10 - beta, 1.0))
    x1 = tau * (a11 + a21 * v2)
    x2 = tau * (a21 + a22 * v2)
    alpha = -0.5 * tau * (x1 + x2 * v2)
    w1, w2 = x1 + alpha, x2 + alpha * v2
    d = torch.stack([a00, torch.where(refl, a11 - 2.0 * w1, a11),
                     torch.where(refl, a22 - 2.0 * v2 * w2, a22)], -1)
    e = torch.stack([beta, torch.where(refl, a21 - v2 * w1 - w2, a21),
                     torch.zeros_like(beta)], -1)
    # sorgtr: Q = diag(1, I - tau v v^T)
    Z = torch.zeros((B, 3, 3), dtype=torch.float32, device=A.device)
    Z[:, 0, 0] = 1.0
    Z[:, 1, 1] = 1.0 - tau
    Z[:, 1, 2] = Z[:, 2, 1] = -tau * v2
    Z[:, 2, 2] = 1.0 - tau * v2 * v2
    # ssteqr's state: mode 0 finds the next block, 1 runs QL on it, 2 QR, 3 done
    z64 = torch.zeros(B, dtype=torch.int64, device=A.device)
    mode, l1, l, lend = z64.clone(), z64.clone(), z64.clone(), z64.clone()
    eps, eps2, safmin = LAPACK_EPS, LAPACK_EPS ** 2, LAPACK_SAFMIN
    at = lambda x, i: torch.gather(x, 1, i[:, None])[:, 0]
    for _ in range(LAPACK_STEPS):
        if not bool((mode != 3).any()):        # a finished matrix's steps change nothing
            break
        d0, d1, d2, e0, e1 = d[:, 0], d[:, 1], d[:, 2], e[:, 0], e[:, 1]
        # ---- mode 0: the next unreduced block from l1 (label 10)
        m0 = mode == 0
        done = m0 & (l1 > 2)
        go = m0 & ~done
        e0 = torch.where(go & (l1 == 1), 0.0, e0)
        e1 = torch.where(go & (l1 == 2), 0.0, e1)
        small0 = torch.abs(e0) <= torch.sqrt(torch.abs(d0)) * torch.sqrt(torch.abs(d1)) * eps
        small1 = torch.abs(e1) <= torch.sqrt(torch.abs(d1)) * torch.sqrt(torch.abs(d2)) * eps
        hit0 = (l1 == 0) & ((e0 == 0) | small0)
        hit1 = (l1 <= 1) & ~hit0 & ((e1 == 0) | small1)
        m = torch.where(hit0, 0, torch.where(hit1, 1, 2))
        e0 = torch.where(go & hit0, 0.0, e0)
        e1 = torch.where(go & hit1, 0.0, e1)
        bl, bend = torch.clamp(l1, max=2), m
        k = torch.arange(3, device=A.device)[None]
        in_d = (k >= bl[:, None]) & (k <= bend[:, None])
        in_e = (k[:, :2] >= bl[:, None]) & (k[:, :2] < bend[:, None])
        anorm = torch.maximum(
            torch.where(in_d, torch.abs(d), 0.0).amax(-1),
            torch.where(in_e, torch.abs(torch.stack([e0, e1], -1)), 0.0).amax(-1))
        start = go & (bend != bl) & (anorm > 0)
        qr = torch.abs(at(d, bend)) < torch.abs(at(d, bl))
        l = torch.where(start, torch.where(qr, bend, bl), l)
        lend = torch.where(start, torch.where(qr, bl, bend), lend)
        mode = torch.where(done, 3, torch.where(start, torch.where(qr, 2, 1), mode))
        l1 = torch.where(go, m + 1, l1)
        # ---- modes 1 and 2: one event of the block's QL (label 40) or QR (90)
        sm0 = e0 * e0 <= (eps2 * torch.abs(d0)) * torch.abs(d1) + safmin
        sm1 = e1 * e1 <= (eps2 * torch.abs(d1)) * torch.abs(d2) + safmin
        ql, qrm = (mode == 1) & ~start, (mode == 2) & ~start
        mq = lend.clone()
        mq = torch.where(ql & (1 >= l) & (1 < lend) & sm1, 1, mq)
        mq = torch.where(ql & (0 >= l) & (0 < lend) & sm0, 0, mq)
        mq = torch.where(qrm & (1 <= l) & (1 > lend) & sm0, 1, mq)
        mq = torch.where(qrm & (2 <= l) & (2 > lend) & sm1, 2, mq)
        cut0 = (ql & (mq < lend) & (mq == 0)) | (qrm & (mq > lend) & (mq == 1))
        cut1 = (ql & (mq < lend) & (mq == 1)) | (qrm & (mq > lend) & (mq == 2))
        e0 = torch.where(cut0, 0.0, e0)
        e1 = torch.where(cut1, 0.0, e1)
        step = torch.where(ql, 1, -1)
        found = (ql | qrm) & (mq == l)
        two = (ql | qrm) & (mq == l + step)
        sweep_ql = ql & (mq == l + 2)
        sweep_qr = qrm & (mq == l - 2)
        # a 2x2 block on rows a, a + 1
        a = torch.where(ql, l, l - 1)
        two0, two1 = two & (a == 0), two & (a == 1)
        da, ea, db = torch.where(two1, d1, d0), torch.where(two1, e1, e0), torch.where(two1, d2, d1)
        rt1, rt2, c2, s2 = _slaev2(da, ea, db)
        _rot(Z, 0, c2, s2, two0)
        _rot(Z, 1, c2, s2, two1)
        d0 = torch.where(two0, rt1, d0)
        d1 = torch.where(two0, rt2, torch.where(two1, rt1, d1))
        d2 = torch.where(two1, rt2, d2)
        e0 = torch.where(two0, 0.0, e0)
        e1 = torch.where(two1, 0.0, e1)
        # the QL sweep over the whole block (l = 0, m = 2)
        p = d0
        g = (d1 - p) / (2.0 * torch.where(sweep_ql, e0, 1.0))
        r = _slapy2(g, torch.ones_like(g))
        g = d2 - p + (e0 / (g + _fsign(r, g)))
        cA, sA, _ = _slartg(g, e1)                       # i = 1: s = c = 1
        bA = e1
        gq = d2                                          # p = 0
        rq = (d1 - gq) * sA + 2.0 * cA * bA
        pq = sA * rq
        d2q = gq + pq
        gq = cA * rq - bA
        cB, sB, rB = _slartg(gq, sA * e0)                # i = 0
        bB = cA * e0
        e1q = rB
        gq = d1 - pq
        rq = (d0 - gq) * sB + 2.0 * cB * bB
        pq2 = sB * rq
        d1q = gq + pq2
        gq = cB * rq - bB
        _rot(Z, 1, cA, -sA, sweep_ql)                    # slasr 'B': j = 1, then 0
        _rot(Z, 0, cB, -sB, sweep_ql)
        d0 = torch.where(sweep_ql, d0 - pq2, d0)
        d1 = torch.where(sweep_ql, d1q, d1)
        d2 = torch.where(sweep_ql, d2q, d2)
        e0n = torch.where(sweep_ql, gq, e0)
        e1 = torch.where(sweep_ql, e1q, e1)
        e0 = e0n
        # the QR sweep over the whole block (l = 2, m = 0)
        p = d2
        g = (d1 - p) / (2.0 * torch.where(sweep_qr, e1, 1.0))
        r = _slapy2(g, torch.ones_like(g))
        g = d0 - p + (e1 / (g + _fsign(r, g)))
        cA, sA, _ = _slartg(g, e0)                       # i = 0
        bA = e0
        gq = d0
        rq = (d1 - gq) * sA + 2.0 * cA * bA
        pq = sA * rq
        d0q = gq + pq
        gq = cA * rq - bA
        cB, sB, rB = _slartg(gq, sA * e1)                # i = 1
        bB = cA * e1
        e0q = rB
        gq = d1 - pq
        rq = (d2 - gq) * sB + 2.0 * cB * bB
        pq2 = sB * rq
        d1q = gq + pq2
        gq = cB * rq - bB
        _rot(Z, 0, cA, sA, sweep_qr)                     # slasr 'F': j = 0, then 1
        _rot(Z, 1, cB, sB, sweep_qr)
        d0 = torch.where(sweep_qr, d0q, d0)
        d1 = torch.where(sweep_qr, d1q, d1)
        d2 = torch.where(sweep_qr, d2 - pq2, d2)
        e0 = torch.where(sweep_qr, e0q, e0)
        e1 = torch.where(sweep_qr, gq, e1)
        # the block's position after the event; past its end: the next block
        l = torch.where(found, l + step, torch.where(two, l + 2 * step, l))
        past = (ql & (l > lend)) | (qrm & (l < lend))
        mode = torch.where(past, 0, mode)
        d = torch.stack([d0, d1, d2], -1)
        e = torch.stack([e0, e1, e[:, 2]], -1)
    # selection sort, ascending (the first of equals stays)
    for i in range(2):
        rest = d[:, i:]
        kk = i + torch.argmin(rest, dim=-1)
        kk = torch.where(at(d, kk) < d[:, i], kk, i)
        di = d[:, i].clone()
        d[:, i] = at(d, kk)
        d = d.scatter(1, kk[:, None], di[:, None])
        zi = Z[:, :, i].clone()
        zk = torch.gather(Z, 2, kk[:, None, None].expand(B, 3, 1))[..., 0]
        Z[:, :, i] = zk
        Z = Z.scatter(2, kk[:, None, None].expand(B, 3, 1), zi[..., None])
    return torch.where(torch.sum(Z * f(V), dim=-2, keepdim=True) < 0, -1.0, 1.0)
