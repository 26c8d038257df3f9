"""Multi-device dry run (counterpart of `dryrun_multichip` in the reference
package's driver entry points): one small map-partitioned bundle adjustment
and one edge-sharded essential graph over `n_devices` shards, with the
reference's asserts. `chip_smoke.py`'s multichip phase and
tests/test_torch_parallel.py call it.

The shards lie on the devices `mesh_devices` lists for `device` (every card
of the process), dealt round-robin when there are fewer devices than
shards (the CPU runs N shards on the one CPU device).
"""
from __future__ import annotations

import numpy as np
import torch

from ..solvers.ba import BAProblem
from ..solvers.essential_graph import EssentialGraphProblem
from ..utils.device import resolve_device
from .mesh import DeviceMesh, mesh_devices
from .sharded_ba import shard_ba_problem, sharded_bundle_adjust
from .sharded_pose_graph import shard_essential_graph, sharded_optimize_essential_graph


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run two iterations of the distributed BA (finite chi2), then hold the
    N-shard against the 1-shard result after 12 (points within 1 % of the
    scene's extent, chi2 within 1 %), then two iterations of the
    edge-sharded pose graph (finite chi2). Returns the readings."""
    dev = resolve_device(device)
    devices = mesh_devices(dev)
    mesh = DeviceMesh([devices[i % len(devices)] for i in range(n_devices)])
    rng = np.random.default_rng(0)
    K, P = 4, 8 * n_devices
    xyz = np.stack([rng.uniform(-1, 1, P), rng.uniform(-1, 1, P), rng.uniform(3, 6, P)],
                   1).astype(np.float32)
    kf_R = np.tile(np.eye(3, dtype=np.float32)[None], (K, 1, 1))
    kf_t = np.stack([np.array([-0.2 * k, 0, 0], np.float32) for k in range(K)])
    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(K):
        xc = xyz @ kf_R[k].T + kf_t[k]
        uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320, 500 * xc[:, 1] / xc[:, 2] + 240], 1)
        for p in range(P):
            obs_kf.append(k)
            obs_pt.append(p)
            obs_uv.append(uv[p] + rng.normal(0, 0.3, 2))
    O = len(obs_kf)
    put = lambda a, dt=None: torch.from_numpy(np.asarray(a, dt)).to(dev)
    prob = BAProblem(
        kf_R=put(kf_R), kf_t=put(kf_t), kf_fixed=put([True] + [False] * (K - 1)),
        points=put(xyz + rng.normal(0, 0.01, xyz.shape).astype(np.float32)),
        point_valid=put(np.ones(P, bool)), obs_kf=put(obs_kf, np.int64),
        obs_pt=put(obs_pt, np.int64), obs_uv=put(np.array(obs_uv), np.float32),
        obs_w=put(np.ones(O, np.float32)), obs_valid=put(np.ones(O, bool)),
        K4=put([500.0, 500.0, 320.0, 240.0], np.float32),
    )
    sprob = shard_ba_problem(prob, n_devices)
    _, _, _, chi2, _ = sharded_bundle_adjust(sprob, mesh, iterations=2)
    chi2 = float(chi2)
    assert np.isfinite(chi2), "distributed BA produced non-finite chi2"

    # numerical parity with the one-shard solve: both converge to the same
    # gauge-fixed optimum; 12 iterations converge this tiny problem
    mesh1 = DeviceMesh(devices[:1])
    _, _, pts1, chi1, _ = sharded_bundle_adjust(shard_ba_problem(prob, 1), mesh1, iterations=12)
    _, _, ptsN, chiN, _ = sharded_bundle_adjust(sprob, mesh, iterations=12)
    p1 = pts1.cpu().numpy().reshape(-1, 3)[:P]
    pN = ptsN.cpu().numpy().reshape(-1, 3)[:P]
    extent = float(xyz.max() - xyz.min())
    max_delta = float(np.abs(p1 - pN).max())
    assert max_delta < 0.01 * extent, (
        f"1-shard vs {n_devices}-shard BA point divergence {max_delta:.4f} "
        f"exceeds 1% of scene extent {extent:.2f}")
    rel = abs(float(chiN) - float(chi1)) / max(float(chi1), 1e-9)
    assert rel < 0.01, f"chi2 divergence {rel:.4f} across shard counts"

    # the second axis: the edge-sharded Sim3 essential graph
    Kv = 2 * n_devices
    t_true = np.stack([np.linspace(0, Kv - 1, Kv), np.zeros(Kv), np.zeros(Kv)],
                      1).astype(np.float32)
    e_i = list(range(Kv - 1)) + [0]
    e_j = list(range(1, Kv)) + [Kv - 1]
    e_t = np.array([t_true[j] - t_true[i] for i, j in zip(e_i, e_j)], np.float32)
    E = len(e_i)
    gprob = EssentialGraphProblem(
        s=put(np.ones(Kv, np.float32)), R=put(np.tile(np.eye(3, dtype=np.float32), (Kv, 1, 1))),
        t=put(t_true + rng.normal(0, 0.03, t_true.shape).astype(np.float32)),
        fixed=put([True] + [False] * (Kv - 1)),
        e_i=put(e_i, np.int64), e_j=put(e_j, np.int64), e_s=put(np.ones(E, np.float32)),
        e_R=put(np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))), e_t=put(e_t),
        e_valid=put(np.ones(E, bool)),
    )
    gres = sharded_optimize_essential_graph(shard_essential_graph(gprob, n_devices), mesh,
                                            iterations=2)
    g_chi2 = float(gres.chi2)
    assert np.isfinite(g_chi2), "distributed pose graph non-finite"
    return {"n_devices": n_devices, "devices": [str(d) for d in mesh.devices],
            "chi2_2_iterations": chi2, "chi2_1_shard": float(chi1),
            "chi2_n_shards": float(chiN), "chi2_rel": rel, "max_point_delta": max_delta,
            "extent": extent, "pose_graph_chi2": g_chi2}

