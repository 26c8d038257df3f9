"""The port's multi-process sharded BA: a `torch.distributed` world of two
processes over Gloo on the CPU, one shard each (parallel/multihost.py).

This file is also the worker: `python tests/test_torch_multihost.py <rank>
<world> <port>`. Every process builds the problem of the reference's
tests/multihost_worker.py (rebuilt here in numpy), joins the world through
`initialize_distributed`, moves its own shard onto its device with
`lift_sharded_problem` and runs `sharded_bundle_adjust` over `global_mesh`;
it holds R and t within 5e-4 of the port's single-device
`solvers/ba.bundle_adjust` (the reference worker's bound) and prints
MULTIHOST_OK."""
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 240


def build_problem():
    """tests/multihost_worker.py:build_problem's arrays, as numpy."""
    rng = np.random.default_rng(0)
    K, Pn = 6, 96
    xyz = np.stack([rng.uniform(-1, 1, Pn), rng.uniform(-1, 1, Pn), rng.uniform(3, 6, Pn)],
                   1).astype(np.float32)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    kf_t = np.stack([np.array([-0.25 * k, 0, 0], np.float32) for k in range(K)])
    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(K):
        xc = xyz @ kf_R[k].T + kf_t[k]
        uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320, 500 * xc[:, 1] / xc[:, 2] + 240], 1)
        for p in range(Pn):
            obs_kf.append(k)
            obs_pt.append(p)
            obs_uv.append(uv[p] + rng.normal(0, 0.3, 2))
    O = len(obs_kf)
    return dict(
        kf_R=kf_R,
        kf_t=(kf_t + np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.01, (K - 1, 3))])
              ).astype(np.float32),
        kf_fixed=np.array([True] + [False] * (K - 1)),
        points=xyz + rng.normal(0, 0.02, xyz.shape).astype(np.float32),
        point_valid=np.ones(Pn, bool), obs_kf=np.array(obs_kf, np.int64),
        obs_pt=np.array(obs_pt, np.int64), obs_uv=np.array(obs_uv, np.float32),
        obs_w=np.ones(O, np.float32), obs_valid=np.ones(O, bool),
        K4=np.array([500.0, 500.0, 320.0, 240.0], np.float32))


def worker(rank: int, world: int, port: str):
    sys.path.insert(0, REPO)
    import torch

    from orbslam_jpminipc_torch.parallel.multihost import (
        global_mesh, initialize_distributed, lift_sharded_problem,
    )
    from orbslam_jpminipc_torch.parallel.sharded_ba import shard_ba_problem, sharded_bundle_adjust
    from orbslam_jpminipc_torch.solvers.ba import BAProblem, bundle_adjust

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    prob = BAProblem(**{k: torch.from_numpy(v) for k, v in build_problem().items()})
    mesh = global_mesh()
    assert (mesh.offset, mesh.size) == (rank, world)
    sprob = lift_sharded_problem(shard_ba_problem(prob, world), mesh)
    assert sprob.points.shape[0] == 1
    R, t, pts, chi2, _ = sharded_bundle_adjust(sprob, mesh, iterations=10)
    ref = bundle_adjust(prob, iterations=10)
    assert np.isfinite(float(chi2))
    np.testing.assert_allclose(R.numpy(), ref.kf_R.numpy(), atol=5e-4)
    np.testing.assert_allclose(t.numpy(), ref.kf_t.numpy(), atol=5e-4)
    torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK rank={rank} chi2={float(chi2):.3f} ref={float(ref.chi2):.3f}",
          flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_gloo_world_of_two_matches_single_device():
    world, port = 2, _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"rank {r} output:\n{out}"


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
