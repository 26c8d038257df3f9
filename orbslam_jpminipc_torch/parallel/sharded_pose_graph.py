"""Distributed Sim3 essential-graph optimization over a device mesh
(counterpart of orbslam_jpminipc_tpu/parallel/sharded_pose_graph.py).

The essential graph grows with the trajectory (OptimizeEssentialGraph runs
over ALL keyframes, src/Optimizer.cc:1470-1719), so it is the second
multi-device axis after bundle adjustment: EDGES are sharded across the
mesh, the vertex state stays replicated. Per LM iteration each shard

  1. evaluates residuals and 7x7 Jacobian blocks for ITS edges and
     scatter-adds its partial (K, K, 7, 7) Hessian and (K, 7) gradient
     (solvers/essential_graph.py:edge_system, the single-device LM's own),
  2. counts the free degree of each vertex,
  3. one sum over the mesh combines {H, b, free_deg}: the only
     communication, one `all_reduce` across processes,
  4. the 7K x 7K system is solved once per process and every vertex
     retracted (the same on every process).

There is no marginalization here, so the whole normal-equation assembly
distributes. The iterations read nothing back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import sim3 as s3
from ..geometry.se3 import orthonormalize
from ..solvers.ba import _spd_solve
from ..solvers.essential_graph import (
    EssentialGraphProblem, EssentialGraphResult, edge_residuals, edge_system,
)
from ..utils.host import fetch
from .mesh import DeviceMesh


class ShardedEssentialGraph(NamedTuple):
    """Edge arrays carry a leading (n_shards, El) axis; vertices replicated."""

    s: torch.Tensor        # (K,)
    R: torch.Tensor        # (K, 3, 3)
    t: torch.Tensor        # (K, 3)
    fixed: torch.Tensor    # (K,)
    e_i: torch.Tensor      # (S, El)
    e_j: torch.Tensor      # (S, El)
    e_s: torch.Tensor      # (S, El)
    e_R: torch.Tensor      # (S, El, 3, 3)
    e_t: torch.Tensor      # (S, El, 3)
    e_valid: torch.Tensor  # (S, El)


_EDGE_FIELDS = ("e_i", "e_j", "e_s", "e_R", "e_t", "e_valid")


def shard_essential_graph(prob: EssentialGraphProblem, n_shards: int) -> ShardedEssentialGraph:
    """Host-side partitioning: valid edges dealt round-robin, padded equal
    (at least 4 a shard). Padded edges carry the identity rotation and
    scale 1, so their residuals stay finite."""
    e_valid, e_i, e_j, e_s, e_R, e_t = fetch(prob.e_valid, prob.e_i, prob.e_j, prob.e_s,
                                             prob.e_R, prob.e_t)
    valid = np.nonzero(e_valid)[0]
    El = max(-(-len(valid) // n_shards), 4)

    def gather(arr, fill=0):
        out = np.full((n_shards, El) + arr.shape[1:], fill, arr.dtype)
        for s in range(n_shards):
            sel = valid[s::n_shards]
            out[s, : len(sel)] = arr[sel]
        return out

    ev = gather(np.ones(e_valid.shape, bool))
    eR = gather(e_R)
    eR[~ev] = np.eye(3, dtype=eR.dtype)
    es = gather(e_s)
    es[~ev] = 1.0
    dev = prob.t.device
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return ShardedEssentialGraph(
        s=prob.s, R=prob.R, t=prob.t, fixed=prob.fixed,
        e_i=put(gather(e_i).astype(np.int64)), e_j=put(gather(e_j).astype(np.int64)),
        e_s=put(es), e_R=put(eR), e_t=put(gather(e_t)), e_valid=put(ev),
    )


def sharded_optimize_essential_graph(sprob: ShardedEssentialGraph, mesh: DeviceMesh,
                                     iterations: int = 20, lam0: float = 1e-16,
                                     fix_scale: bool = False) -> EssentialGraphResult:
    """The essential graph's LM with the edges sharded over `mesh`; the
    result (replicated) lies on the mesh's first device. `fixed` is an input,
    so any gauge is served (the reference compiles and caches one program per
    mesh here; eager PyTorch has nothing to compile)."""
    home = mesh.home
    K = sprob.s.shape[0]
    s, R, t = sprob.s.to(home), sprob.R.to(home), sprob.t.to(home)
    fixed = sprob.fixed.to(home).bool()
    idx = mesh.local_shards(sprob.e_i.shape[0])
    shards = [dict({k: getattr(sprob, k)[j].to(dev) for k in _EDGE_FIELDS}, dev=dev)
              for j, dev in zip(idx, mesh.devices)]
    fixed_d = mesh.replicate(fixed)

    def args_of(sh, s_, R_, t_):
        i, j = sh["e_i"], sh["e_j"]
        return (s_[i], R_[i], t_[i], s_[j], R_[j], t_[j], sh["e_s"], sh["e_R"], sh["e_t"])

    def total_chi2(s_, R_, t_):
        sd, Rd, td = mesh.replicate(s_), mesh.replicate(R_), mesh.replicate(t_)
        local = []
        for sh in shards:
            d = sh["dev"]
            e = edge_residuals(args_of(sh, sd[d], Rd[d], td[d]), fix_scale)
            local.append(torch.sum(torch.where(sh["e_valid"][:, None], e * e, 0.0)))
        return mesh.psum(local)

    chi = total_chi2(s, R, t)
    lam = torch.full_like(chi, lam0)
    diag = torch.arange(K, device=home)
    eye7 = torch.eye(7, dtype=t.dtype, device=home)
    for _ in range(iterations):
        sd, Rd, td = mesh.replicate(s), mesh.replicate(R), mesh.replicate(t)
        parts = []
        for sh in shards:
            d, i, j = sh["dev"], sh["e_i"], sh["e_j"]
            w = sh["e_valid"].to(t.dtype)
            wi = w * (~fixed_d[d][i]).to(t.dtype)
            wj = w * (~fixed_d[d][j]).to(t.dtype)
            H, b = edge_system(args_of(sh, sd[d], Rd[d], td[d]), i, j, w, wi, wj, K,
                               fix_scale)
            free_deg = torch.zeros(K, dtype=t.dtype, device=d).index_add_(
                0, i, wi).index_add_(0, j, wj)
            parts.append(torch.cat([H.reshape(-1), b.reshape(-1), free_deg]))
        # ---- the one collective ----
        flat = mesh.psum(parts)
        H = flat[:K * K * 49].reshape(K, K, 7, 7)
        b = flat[K * K * 49:K * K * 49 + K * 7].reshape(K, 7)
        free_deg = flat[K * K * 49 + K * 7:]

        inert = fixed | (free_deg == 0)
        H = torch.where(inert[:, None, None, None] | inert[None, :, None, None], 0.0, H)
        H[diag, diag] += torch.where(inert, 1.0, lam)[:, None, None] * eye7
        b = torch.where(inert[:, None], 0.0, b)
        Hmat = H.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        delta = _spd_solve(Hmat + 1e-9 * torch.eye(K * 7, dtype=t.dtype, device=home),
                           -b.reshape(-1)).reshape(K, 7)
        delta = torch.where(inert[:, None], 0.0, delta)

        s_new, R_new, t_new = s3.retract(s, R, t, delta, fix_scale=fix_scale)
        R_new = orthonormalize(R_new)  # keep the float32 products on SO(3)
        chi_new = total_chi2(s_new, R_new, t_new)
        accept = chi_new < chi
        s = torch.where(accept, s_new, s)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        chi = torch.where(accept, chi_new, chi)
        lam = torch.where(accept, lam * 0.5, torch.clamp(lam * 10.0 + 1e-12, max=1e6))
    return EssentialGraphResult(s=s, R=R, t=t, chi2=chi)
