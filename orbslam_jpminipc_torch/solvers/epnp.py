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

The eigendecompositions, the SVD, the inverse and the small solves are
library calls (LAPACK on the CPU, cuSOLVER on a card), as they are in the
reference. On a card `eigh`, `svd` and `pinv` check their result on the
host (none has a form without the check); the small solves are the `_ex`
form, and the fixed index sets are slices: a Python list as an index is
uploaded, and waited for, on every call. The four smallest eigenvectors of MtM span a near-null
space: the individual vectors are not determined to rounding, the poses
that come out of them are.
"""
from __future__ import annotations

import torch


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
    vals, vecs = torch.linalg.eigh(PtP)          # ascending
    # k_i = sqrt(lambda_i / N): the reference divides by the point count
    k = torch.sqrt(torch.clamp(vals, min=1e-12) / wsum)
    # descending order like cvSVD's convention (largest first)
    cs = c0[..., None, :] + (torch.flip(k, (-1,))[..., None]
                             * torch.flip(vecs.transpose(-1, -2), (-2,)))
    return torch.cat([c0[..., None, :], cs], dim=-2)  # (..., 4, 3)


def _barycentric(xw, ctrl):
    """alphas (..., M, 4) with sum_j alpha_j c_j = x, sum alpha = 1
    (compute_barycentric_coordinates :383-406)."""
    C = torch.cat([ctrl.transpose(-1, -2), torch.ones_like(ctrl[..., None, :, 0])], dim=-2)
    X = torch.cat([xw, torch.ones_like(xw[..., :1])], dim=-1)  # (..., M, 4)
    # SVD pseudo-inverse, NOT inv: for (near-)coplanar world points the PCA
    # control points collapse (third eigenvalue ~ 0) and C goes singular;
    # the reference inverts CC with CV_SVD (PnPsolver.cc:383-406), which
    # degrades gracefully on planar scenes (walls and floors are the common
    # relocalization case). The truncation decides those sets, so the
    # pseudo-inverse stays, host check and all
    Cinv = torch.linalg.pinv(C, rtol=1e-6)
    return torch.einsum("...ij,...mj->...mi", Cinv, X)


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
    # non-finite betas (a singular beta system) would make the SVD raise:
    # such a hypothesis gets a placeholder here and is marked `bad`
    bad = ~torch.isfinite(H).all(dim=-1).all(dim=-1)
    H = torch.where(bad[..., None, None], torch.eye(3, dtype=H.dtype, device=H.device), H)
    pc0 = torch.where(bad[..., None], torch.zeros_like(pc0), pc0)
    U, _, Vt = torch.linalg.svd(H)
    detUV = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(detUV), torch.ones_like(detUV), detUV], dim=-1)
    R = torch.einsum("...ij,...j,...jk->...ik", U, D, Vt)
    t = pc0 - torch.einsum("...ij,...j->...i", R, pw0)
    return R, t, bad


def epnp_pose(xw, uv, w, K4):
    """Weighted batched EPnP. xw: (..., M, 3); uv: (..., M, 2) pixels;
    w: (..., M) weights (0 masks a point out). Returns (R, t, ok) with the
    best of the three beta cases by weighted reprojection error
    (compute_pose :449-478)."""
    ctrl = _weighted_control_points(xw, w)
    alphas = _barycentric(xw, ctrl)
    MtM = _fill_MtM(alphas, uv, w, K4)
    _, vecs = torch.linalg.eigh(MtM)           # ascending eigenvalues
    # 4 smallest eigenvectors as (4 vectors, 4 control points, 3)
    V = vecs[..., :, :4].transpose(-1, -2).reshape(*MtM.shape[:-2], 4, 4, 3)
    rho = _rho(ctrl)
    L = _L6x10(_v_diffs(V))
    inf = torch.full((), float("inf"), dtype=xw.dtype, device=xw.device)

    def err_of(betas):
        R, t, bad = _pose_from_betas(betas, V, alphas, xw, w)
        xc = torch.einsum("...ij,...mj->...mi", R, xw) + t[..., None, :]
        z = torch.clamp(xc[..., 2], min=1e-9)
        up = K4[0] * xc[..., 0] / z + K4[2]
        vp = K4[1] * xc[..., 1] / z + K4[3]
        e = (up - uv[..., 0]) ** 2 + (vp - uv[..., 1]) ** 2
        return torch.where(bad, inf, torch.sum(e * w, dim=-1)), R, t

    best_e = best_R = best_t = None
    for approx in (_betas_approx_1, _betas_approx_2, _betas_approx_3):
        betas = _gauss_newton(L, rho, approx(L, rho))
        e, R, t = err_of(betas)
        e = torch.where(torch.isfinite(e), e, inf)
        if best_e is None:
            best_e, best_R, best_t = e, R, t
        else:
            take = e < best_e
            best_e = torch.where(take, e, best_e)
            best_R = torch.where(take[..., None, None], R, best_R)
            best_t = torch.where(take[..., None], t, best_t)
    ok = (torch.isfinite(best_e)
          & torch.isfinite(best_R).all(dim=-1).all(dim=-1)
          & torch.isfinite(best_t).all(dim=-1))
    return best_R, best_t, ok
