"""Essential-graph (Sim3 pose-graph) optimization for loop closing
(counterpart of orbslam_jpminipc_tpu/solvers/essential_graph.py).

Optimizer::OptimizeEssentialGraph (src/Optimizer.cc:1470-1719): a Sim3 pose
graph over ALL keyframes (loop keyframe fixed, lambda init 1e-16,
BlockSolver_7_3, 20 LM iterations) whose edges are loop connections
(covisibility weight >= 100), spanning-tree edges, previous loop edges and
strong covisibility edges, each carrying a relative Sim3 measurement Sji
with identity 7x7 information.

Vertices are packed Sim3 arrays, edges flat padded arrays; the residual of
edge (i, j) is

    e = log7( Sji o Siw o Sjw^-1 )        (g2o EdgeSim3::computeError,
                                           types_seven_dof_expmap.h:106-114)

with its 7x14 Jacobian from forward-mode autodiff (`torch.func.jacfwd`
under `torch.func.vmap`; g2o differentiates numerically here). The 7K x 7K
normal equations are assembled with scatter-adds of 7x7 blocks and solved
by a dense Cholesky whose failure is a rejected step decided on the device
(`cholesky_ex`): the iterations make no host read.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..geometry import sim3 as s3
from ..geometry.se3 import orthonormalize
from .ba import _spd_solve


class EssentialGraphProblem(NamedTuple):
    s: torch.Tensor          # (K,) Siw scales
    R: torch.Tensor          # (K, 3, 3)
    t: torch.Tensor          # (K, 3)
    fixed: torch.Tensor      # (K,) bool: loop KF + invalid slots
    e_i: torch.Tensor        # (E,) int64: vertex i of each edge
    e_j: torch.Tensor        # (E,) int64
    e_s: torch.Tensor        # (E,) measurement Sji scale
    e_R: torch.Tensor        # (E, 3, 3)
    e_t: torch.Tensor        # (E, 3)
    e_valid: torch.Tensor    # (E,) bool


class EssentialGraphResult(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    chi2: torch.Tensor


def _edge_residual(xi_i, xi_j, si, Ri, ti, sj, Rj, tj, ms, mR, mt, fix_scale=False):
    """log7(Sji o exp(xi_i) Siw o (exp(xi_j) Sjw)^-1): (7,)."""
    a = s3.compose(ms, mR, mt, *s3.retract(si, Ri, ti, xi_i, fix_scale=fix_scale))
    b = s3.inverse(*s3.retract(sj, Rj, tj, xi_j, fix_scale=fix_scale))
    return s3.log7(*s3.compose(*a, *b))


def edge_residuals(args, fix_scale: bool = False) -> torch.Tensor:
    """(E, 7) residuals of the edges `args` = (si, Ri, ti, sj, Rj, tj, ms,
    mR, mt), each batched over E, at the vertices as they stand."""
    zero = torch.zeros(7, dtype=args[2].dtype, device=args[2].device)
    return vmap(lambda *a: _edge_residual(zero, zero, *a, fix_scale))(*args)


def edge_jacobians(args, fix_scale: bool = False):
    """((E, 7, 7), (E, 7, 7)): the residuals' Jacobians with respect to the
    left perturbations of vertex i and of vertex j, at zero."""
    zero14 = torch.zeros(14, dtype=args[2].dtype, device=args[2].device)

    def f(xi, *a):
        # one edge as a batch of one: with 0-dim tensors inside, `jacfwd`
        # (a `vmap` of forward-mode sweeps) promotes every `tensor + 1.0`
        # to float64
        a = [x[None] for x in a]
        return _edge_residual(xi[None, :7], xi[None, 7:], *a, fix_scale)[0]

    J = vmap(lambda *a: jacfwd(f)(zero14, *a))(*args)   # (E, 7, 14)
    return J[..., :7], J[..., 7:]


def edge_system(args, e_i, e_j, w, wi, wj, K: int, fix_scale: bool = False):
    """The edges' part of the normal equations at the vertices as they
    stand: (H (K, K, 7, 7), b (K, 7)). `w` weighs each edge (0 for padding),
    `wi`/`wj` also zero the columns of a fixed vertex."""
    e = edge_residuals(args, fix_scale)             # (E, 7)
    Ji, Jj = edge_jacobians(args, fix_scale)        # (E, 7, 7) each
    Ji = Ji * wi[:, None, None]
    Jj = Jj * wj[:, None, None]
    ew = e * w[:, None]
    H = torch.zeros((K, K, 7, 7), dtype=e.dtype, device=e.device)
    H.index_put_((e_i, e_i), torch.einsum("eri,erj->eij", Ji, Ji), accumulate=True)
    H.index_put_((e_j, e_j), torch.einsum("eri,erj->eij", Jj, Jj), accumulate=True)
    H.index_put_((e_i, e_j), torch.einsum("eri,erj->eij", Ji, Jj), accumulate=True)
    H.index_put_((e_j, e_i), torch.einsum("eri,erj->eij", Jj, Ji), accumulate=True)
    b = torch.zeros((K, 7), dtype=e.dtype, device=e.device)
    b.index_add_(0, e_i, torch.einsum("eri,er->ei", Ji, ew))
    b.index_add_(0, e_j, torch.einsum("eri,er->ei", Jj, ew))
    return H, b


def optimize_essential_graph(
    prob: EssentialGraphProblem,
    iterations: int = 20,
    lam0: float = 1e-16,
    fix_scale: bool = False,
) -> EssentialGraphResult:
    K = prob.s.shape[0]
    dt, dev = prob.t.dtype, prob.t.device
    e_i, e_j = prob.e_i.to(torch.int64), prob.e_j.to(torch.int64)
    diag = torch.arange(K, device=dev)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    eye7K = torch.eye(K * 7, dtype=dt, device=dev)
    w = prob.e_valid.to(dt)
    # fixed vertices contribute no columns
    wi = w * (~prob.fixed[e_i]).to(dt)
    wj = w * (~prob.fixed[e_j]).to(dt)
    # fixed / untouched vertices: identity rows
    free_deg = torch.zeros(K, dtype=dt, device=dev).index_add_(0, e_i, wi).index_add_(0, e_j, wj)
    inert = prob.fixed | (free_deg == 0)
    inert_block = inert[:, None, None, None] | inert[None, :, None, None]

    def gather(s, R, t):
        return (s[e_i], R[e_i], t[e_i], s[e_j], R[e_j], t[e_j], prob.e_s, prob.e_R, prob.e_t)

    def total_chi2(s, R, t):
        e = edge_residuals(gather(s, R, t), fix_scale)
        return torch.sum(torch.where(prob.e_valid[:, None], e * e, 0.0))

    s, R, t = prob.s, prob.R, prob.t
    chi = total_chi2(s, R, t)
    lam = torch.full_like(chi, lam0)
    for _ in range(iterations):
        H, b = edge_system(gather(s, R, t), e_i, e_j, w, wi, wj, K, fix_scale)
        H = torch.where(inert_block, 0.0, H)
        H[diag, diag] += torch.where(inert, 1.0, lam)[:, None, None] * eye7
        b = torch.where(inert[:, None], 0.0, b)

        Hmat = H.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        # a Cholesky that breaks down gives NaN, chi_new < chi is then
        # false and the step is rejected, as in the reference
        delta = _spd_solve(Hmat + 1e-9 * eye7K, -b.reshape(-1)).reshape(K, 7)
        delta = torch.where(inert[:, None], 0.0, delta)

        s_new, R_new, t_new = s3.retract(s, R, t, delta, fix_scale=fix_scale)
        R_new = orthonormalize(R_new)  # keep f32 products on SO(3)
        chi_new = total_chi2(s_new, R_new, t_new)
        accept = chi_new < chi
        s = torch.where(accept, s_new, s)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        chi = torch.where(accept, chi_new, chi)
        lam = torch.where(accept, lam * 0.5, torch.clamp(lam * 10.0 + 1e-12, max=1e6))
    return EssentialGraphResult(s=s, R=R, t=t, chi2=chi)


def recover_se3(s, R, t):
    """Sim3 -> SE3 pose recovery: Tiw = [R | t/s] (Optimizer.cc:1687-1700)."""
    return R, t / s[..., None]


def correct_points(xw, s_old, R_old, t_old, s_new, R_new, t_new):
    """Re-map points through their reference KF's corrected pose:
    x' = S_new^-1 ( S_old (x) )  (Optimizer.cc:1701-1718)."""
    x_cam = s3.transform(s_old, R_old, t_old, xw)
    return s3.transform(*s3.inverse(s_new, R_new, t_new), x_cam)
