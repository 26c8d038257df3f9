"""Batched EPnP (Lepetit et al. 2009), the PnP core of relocalization
(counterpart of orbslam_jpminipc_tpu/solvers/epnp.py).

src/PnPsolver.cc: control points via centroid + PCA (choose_control_points
:347-380), barycentric coordinates (:383-406), the 2N x 12 M matrix (fill_M
:408-442), its null space from the 12x12 MtM eigendecomposition (:449-478),
the three beta approximations over the L_6x10 system
(find_betas_approx_{1,2,3} :639-731), Gauss-Newton refinement of the betas
(gauss_newton :812-830), and the rigid Horn alignment for the final pose
(estimate_R_and_t :541-593). Every function takes leading batch dimensions
(one row per RANSAC hypothesis): the reference's sequential `iterate(n)`
loop (:137-230) is one batched program.

Weighted form: every per-point quantity carries a weight (1/0 mask), so
the same program serves the 4-point minimal sets AND the all-inlier Refine
(:232-277).

The eigendecompositions, the SVDs and the pseudo-inverse are the Jacobi
solvers of ops/small_linalg_cuda.py (the hand-written kernel on a card, its
plain version on the CPU); the small solves are `solve_ex` and the 3x3
determinant a closed form, so nothing here reads the host and the whole
RANSAC can be one captured program. The fixed index sets are slices: a
Python list as an index is uploaded, and waited for, on every call. The
four smallest eigenvectors of MtM span a near-null space: the individual
vectors are not determined to rounding, the poses that come out of them
are.
"""
from __future__ import annotations

import torch

from ..ops.small_linalg_cuda import eigh_small, svd_small
from .linalg3 import det3
from .small_linalg import pinv_from_svd


def _pair_diffs(x):
    """x[..., a, :] - x[..., b, :] over the six pairs (0, 1), (0, 2),
    (0, 3), (1, 2), (1, 3), (2, 3) of dim -2, by slices."""
    return torch.cat([x[..., 0:1, :] - x[..., 1:4, :], x[..., 1:2, :] - x[..., 2:4, :],
                      x[..., 2:3, :] - x[..., 3:4, :]], dim=-2)


def _weighted_control_points(xw, w):
    """Centroid + PCA control points (choose_control_points :347-380).

    xw: (..., M, 3), w: (..., M) weights. Returns (..., 4, 3)."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    c0 = torch.sum(xw * w[..., None], dim=-2) / wsum
    d = (xw - c0[..., None, :]) * torch.sqrt(w)[..., None]
    PtP = torch.einsum("...mi,...mj->...ij", d, d)
    # ascending; the axes' signs are LAPACK's, as the reference's (the pose
    # depends on them: solvers/small_linalg.py:lapack_signs3)
    vals, vecs = eigh_small(PtP, lapack_signs=True)
    # k_i = sqrt(lambda_i / N): the reference divides by the point count
    k = torch.sqrt(torch.clamp(vals, min=1e-12) / wsum)
    # descending order like cvSVD's convention (largest first)
    cs = c0[..., None, :] + (torch.flip(k, (-1,))[..., None]
                             * torch.flip(vecs.transpose(-1, -2), (-2,)))
    return torch.cat([c0[..., None, :], cs], dim=-2)  # (..., 4, 3)


def _barycentric(xw, ctrl):
    """alphas (..., M, 4) with sum_j alpha_j c_j = x, sum alpha = 1
    (compute_barycentric_coordinates :383-406), and the projector (..., 4,
    4) onto the directions of C the pseudo-inverse drops (zero where it
    drops none)."""
    C = torch.cat([ctrl.transpose(-1, -2), torch.ones_like(ctrl[..., None, :, 0])], dim=-2)
    X = torch.cat([xw, torch.ones_like(xw[..., :1])], dim=-1)  # (..., M, 4)
    # SVD pseudo-inverse, NOT inv: for (near-)coplanar world points the PCA
    # control points collapse (third eigenvalue ~ 0) and C goes singular;
    # the reference inverts CC with CV_SVD (PnPsolver.cc:383-406), which
    # degrades gracefully on planar scenes (walls and floors are the common
    # relocalization case). The truncation decides those sets: the SVD is
    # one-sided Jacobi on C itself, not an eigendecomposition of C^T C,
    # whose squared condition number would blur the 1e-6 cut into rounding
    U, S, Vt = svd_small(C)
    Cinv = pinv_from_svd(U, S, Vt, rtol=1e-6)
    dropped = (S <= 1e-6 * S[..., :1]).to(C.dtype)
    P4 = torch.einsum("...ki,...k,...kj->...ij", Vt, dropped, Vt)
    return torch.einsum("...ij,...mj->...mi", Cinv, X), P4


def _fill_MtM(alphas, uv, w, K4):
    """MtM (..., 12, 12) from the weighted 2N x 12 M matrix (fill_M)."""
    fu, fv, uc, vc = K4[0], K4[1], K4[2], K4[3]
    u, v = uv[..., 0], uv[..., 1]
    a = alphas  # (..., M, 4)
    # row_u[j*3 + (0,1,2)] = (a_j fu, 0, a_j (uc - u))
    zero = torch.zeros_like(a)
    ru = torch.stack([a * fu, zero, a * (uc - u)[..., None]], dim=-1).reshape(*a.shape[:-1], 12)
    rv = torch.stack([zero, a * fv, a * (vc - v)[..., None]], dim=-1).reshape(*a.shape[:-1], 12)
    sw = w[..., None]
    return (torch.einsum("...mi,...mj->...ij", ru * sw, ru)
            + torch.einsum("...mi,...mj->...ij", rv * sw, rv))


def _rho(ctrl):
    """Squared distances between the 4 world control points (..., 6)."""
    d = _pair_diffs(ctrl)
    return torch.sum(d * d, dim=-1)


def _v_diffs(V):
    """V: (..., 4, 4, 3) null-space vectors as per-control-point 3-vectors
    -> dv (..., 4, 6, 3): differences of control-point coordinates for
    each null vector and each of the 6 pairs."""
    return _pair_diffs(V)


def _L6x10(dv):
    """The 6x10 system of beta quadratic terms (compute_L_6x10 :747-784).

    Column order (matching the reference): [b11 b12 b22 b13 b23 b33 b14
    b24 b34 b44]."""
    d1, d2, d3, d4 = dv[..., 0, :, :], dv[..., 1, :, :], dv[..., 2, :, :], dv[..., 3, :, :]
    dot = lambda a, b: torch.sum(a * b, dim=-1)
    cols = [
        dot(d1, d1), 2 * dot(d1, d2), dot(d2, d2), 2 * dot(d1, d3),
        2 * dot(d2, d3), dot(d3, d3), 2 * dot(d1, d4), 2 * dot(d2, d4),
        2 * dot(d3, d4), dot(d4, d4),
    ]
    return torch.stack(cols, dim=-1)  # (..., 6, 10)


def _lstsq(A, b, reg=1e-9):
    """Small least squares via normal equations."""
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    Atb = torch.einsum("...ki,...k->...i", A, b)
    n = AtA.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    # solve_ex: a singular system gives non-finite values (as the reference's
    # LU solve does) instead of raising, and costs no wait for the device
    return torch.linalg.solve_ex(AtA + reg * eye, Atb[..., None])[0][..., 0]


def _signed_sqrt(x):
    """sqrt(|x|) carrying the sign of x."""
    r = torch.sqrt(torch.abs(x))
    return torch.where(x < 0, -r, r)


def _safe(b):
    return torch.where(torch.abs(b) < 1e-12, torch.full_like(b, 1e-12), b)


def _betas_approx_1(L, rho):
    """betas_approx_1: [b11 b12 b13 b14] (:639-664)."""
    x = _lstsq(torch.cat([L[..., 0:2], L[..., 3:4], L[..., 6:7]], dim=-1), rho)
    b1 = _signed_sqrt(x[..., 0])
    rest = x[..., 1:] / _safe(b1[..., None])
    return torch.cat([b1[..., None], rest], dim=-1)


def _betas_approx_2(L, rho):
    """betas_approx_2: [b11 b12 b22] (:672-698)."""
    x = _lstsq(L[..., 0:3], rho)
    b1 = _signed_sqrt(x[..., 0])  # keeps the reference's b1*b1 sign convention
    b2 = torch.sqrt(torch.abs(x[..., 2]))
    # sign consistency via b12
    b2 = torch.where(x[..., 1] < 0, -b2, b2)
    z = torch.zeros_like(b1)
    return torch.stack([b1, b2, z, z], dim=-1)


def _betas_approx_3(L, rho):
    """betas_approx_3: [b11 b12 b22 b13 b23] (:706-731)."""
    x = _lstsq(L[..., 0:5], rho)
    b1 = _signed_sqrt(x[..., 0])
    b2 = torch.sqrt(torch.abs(x[..., 2]))
    b2 = torch.where(x[..., 1] < 0, -b2, b2)
    b3 = x[..., 3] / _safe(b1)
    z = torch.zeros_like(b1)
    return torch.stack([b1, b2, b3, z], dim=-1)


def _betas_one(dv, rho):
    """The N = 1 case (Lepetit et al. 2009, section 3.3): the scale of the first
    null vector that best matches the control points' distances,
    beta = sum |v_i - v_j| |c_i - c_j| / sum |v_i - v_j|^2."""
    dn = torch.sqrt(torch.sum(dv[..., 0, :, :] ** 2, dim=-1))          # (..., 6)
    b1 = torch.sum(dn * torch.sqrt(rho), dim=-1) / torch.clamp(torch.sum(dn * dn, dim=-1),
                                                                min=1e-30)
    z = torch.zeros_like(b1)
    return torch.stack([b1, z, z, z], dim=-1)


def _gauss_newton(L, rho, betas, iters: int = 5):
    """Refine betas on the 6 control-distance residuals (:812-830)."""
    b = betas
    for _ in range(iters):
        b1, b2, b3, b4 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        q = torch.stack([b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3,
                         b3 * b3, b1 * b4, b2 * b4, b3 * b4, b4 * b4], dim=-1)
        r = rho - torch.einsum("...ij,...j->...i", L, q)
        # d(q)/d(b): (..., 10, 4) -> J = L @ dq (..., 6, 4)
        z = torch.zeros_like(b1)
        row = lambda *c: torch.stack(c, dim=-1)
        dq = torch.stack([
            row(2.0 * b1, z, z, z),
            row(b2, b1, z, z),
            row(z, 2.0 * b2, z, z),
            row(b3, z, b1, z),
            row(z, b3, b2, z),
            row(z, z, 2.0 * b3, z),
            row(b4, z, z, b1),
            row(z, b4, z, b2),
            row(z, z, b4, b3),
            row(z, z, z, 2.0 * b4),
        ], dim=-2)  # (..., 10, 4)
        J = torch.einsum("...ik,...kj->...ij", L, dq)  # (..., 6, 4)
        b = b + _lstsq(J, r, reg=1e-8)
    return b


def _pose_from_betas(betas, V, alphas, xw, w):
    """Camera-frame control points -> rigid Horn alignment
    (compute_ccs/compute_pcs + estimate_R_and_t :499-593)."""
    # ccs (..., 4, 3) = sum_k beta_k V_k
    ccs = torch.einsum("...k,...kcj->...cj", betas, V)
    pcs = torch.einsum("...mc,...cj->...mj", alphas, ccs)  # (..., M, 3)
    # depth sign fix (solve_for_sign :487-497)
    sgn = torch.where(w > 0, torch.sign(pcs[..., 2]), torch.zeros_like(w))
    neg = torch.sum(sgn, dim=-1) < 0
    pcs = torch.where(neg[..., None, None], -pcs, pcs)

    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    pc0 = torch.sum(pcs * w[..., None], dim=-2) / wsum
    pw0 = torch.sum(xw * w[..., None], dim=-2) / wsum
    dc = (pcs - pc0[..., None, :]) * w[..., None]
    dw = xw - pw0[..., None, :]
    H = torch.einsum("...mi,...mj->...ij", dc, dw)   # cam x world
    # non-finite betas (a singular beta system) give a NaN pose, as in the
    # reference; `bad` marks such a hypothesis
    bad = ~torch.isfinite(H).all(dim=-1).all(dim=-1)
    U, _, Vt = svd_small(H)
    detUV = det3(U @ Vt)
    D = torch.stack([torch.ones_like(detUV), torch.ones_like(detUV), detUV], dim=-1)
    R = torch.einsum("...ij,...j,...jk->...ik", U, D, Vt)
    t = pc0 - torch.einsum("...ij,...j->...i", R, pw0)
    return R, t, bad


def _beta_cases(xw, uv, w, K4):
    """The null-space vectors V (..., 4, 4, 3), the alphas, the beta cases
    (4, ..., 4): the reference's three, each refined by Gauss-Newton, then
    the N = 1 case; and which sets are planar (see `epnp_pose`)."""
    ctrl = _weighted_control_points(xw, w)
    alphas, P4 = _barycentric(xw, ctrl)
    MtM = _fill_MtM(alphas, uv, w, K4)
    planar = torch.diagonal(P4, dim1=-2, dim2=-1).sum(-1) > 0.5
    eye3 = torch.eye(3, dtype=MtM.dtype, device=MtM.device)
    spurious = torch.einsum("...ij,kl->...ikjl", P4, eye3).reshape(MtM.shape)
    MtM = MtM + torch.diagonal(MtM, dim1=-2, dim2=-1).sum(-1)[..., None, None] * spurious
    _, vecs = eigh_small(MtM)                  # ascending eigenvalues
    # 4 smallest eigenvectors as (4 vectors, 4 control points, 3)
    V = vecs[..., :, :4].transpose(-1, -2).reshape(*MtM.shape[:-2], 4, 4, 3)
    rho = _rho(ctrl)
    dv = _v_diffs(V)
    L = _L6x10(dv)
    betas = torch.stack([_gauss_newton(L, rho, approx(L, rho))
                         for approx in (_betas_approx_1, _betas_approx_2, _betas_approx_3)]
                        + [_betas_one(dv, rho)])
    return V, alphas, betas, planar


def _pose_errors(betas, V, alphas, xw, uv, w, K4):
    """Each beta case's pose (R, t) and its weighted reprojection error,
    infinite where the pose is not finite; the cases as one batch (one SVD
    for all)."""
    R, t, bad = _pose_from_betas(betas, V, alphas, xw, w)
    xc = torch.einsum("...ij,...mj->...mi", R, xw) + t[..., None, :]
    z = torch.clamp(xc[..., 2], min=1e-9)
    up = K4[0] * xc[..., 0] / z + K4[2]
    vp = K4[1] * xc[..., 1] / z + K4[3]
    e = (up - uv[..., 0]) ** 2 + (vp - uv[..., 1]) ** 2
    inf = torch.full((), float("inf"), dtype=xw.dtype, device=xw.device)
    e = torch.where(bad, inf, torch.sum(e * w, dim=-1))
    return torch.where(torch.isfinite(e), e, inf), R, t


def epnp_pose(xw, uv, w, K4):
    """Weighted batched EPnP. xw: (..., M, 3); uv: (..., M, 2) pixels;
    w: (..., M) weights (0 masks a point out). Returns (R, t, ok) with the
    best of the three beta cases by weighted reprojection error
    (compute_pose :449-478).

    A planar set (the pseudo-inverse of C drops a direction: the third PCA
    axis has collapsed) departs from the reference. Every alpha is then
    orthogonal to the dropped direction n, so the three control-point
    moves n (x) R^3 change no image residual: MtM has three spurious null
    vectors, and which of them the 4 smallest eigenvectors mix with the
    true one is set by rounding (the reference's planar refit is right, or
    off by 3e-3 to 5e-2, depending on the alphas' last bits). Here they are pushed out
    of the null space (MtM + trace(MtM) P), which leaves the true
    direction alone at the bottom, and the N = 1 case joins the three. Its
    pose is computed for every set, planar or not, in the same batch as the
    three (a program cannot skip it by the data), and kept only on a planar
    one: a quarter more work in the pose's SVD and reprojection, no more
    launches."""
    V, alphas, betas, planar = _beta_cases(xw, uv, w, K4)
    e, R, t = _pose_errors(betas, V, alphas, xw, uv, w, K4)
    best_e, best_R, best_t = e[0], R[0], t[0]
    for i in (1, 2, 3):
        # the N = 1 case only on a planar set (where the reference has none)
        take = (e[i] < best_e) & planar if i == 3 else e[i] < best_e
        best_e = torch.where(take, e[i], best_e)
        best_R = torch.where(take[..., None, None], R[i], best_R)
        best_t = torch.where(take[..., None], t[i], best_t)
    ok = (torch.isfinite(best_e)
          & torch.isfinite(best_R).all(dim=-1).all(dim=-1)
          & torch.isfinite(best_t).all(dim=-1))
    return best_R, best_t, ok
