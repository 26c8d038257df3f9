"""EPnP on exactly planar scenes: the port's `solve_pnp` against the JAX
package's, on the planar scene of tests/test_torch_pnp.py (60 points on
z = 0, 0.3 px of noise, 5 masked) over several scene seeds and PRNG keys.

The port departs from the reference on a planar set
(orbslam_jpminipc_torch/solvers/epnp.py:epnp_pose). This is the witness:
each (seed, key) is run twice, as drawn and once more with every world
point's x and y moved by one float32 ulp (`np.nextafter`), which moves no
pose by more than rounding. Per run it prints R's largest difference from
the truth for the reference and for the port, their difference from each
other, and the points whose inlier flags differ; a row agrees where R is
within the parity test's bound (1e-3) on both runs.

    env JAX_PLATFORMS=cpu python tools/epnp_planar_witness.py [--seeds 2,12,22] [--keys 3,4,5,6]

CPU only (jax on the CPU, the port's plain solvers): it reads the
reference's LAPACK, which is what the departure answers.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
R_TOL = 1e-3


def _project(xw, R, t):
    xc = xw @ R.T + t
    return np.stack([K4[0] * xc[:, 0] / xc[:, 2] + K4[2],
                     K4[1] * xc[:, 1] / xc[:, 2] + K4[3]], 1).astype(np.float32)


def planar_scene(seed):
    """tests/test_torch_pnp.py:_scene("planar") with another seed."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    n, noise, gate, t = 60, 0.3, 5.991 * 4.0, np.array([0.05, -0.1, 4.0])
    x, y = rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n)
    xw = np.stack([x, y, np.zeros(n)], 1).astype(np.float32)
    R = Rotation.from_rotvec(rng.normal(0, 0.25, 3)).as_matrix()
    uv = _project(xw, R, t)
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    rng.choice(n, 0, replace=False)           # the test's (empty) outlier draw
    mask = np.ones(n, bool)
    mask[rng.choice(n, 5, replace=False)] = False
    return xw, uv, mask, np.full(n, gate, np.float32), R


def run(seeds, keys):
    import jax
    import jax.numpy as jnp
    import torch

    from orbslam_jpminipc_tpu.solvers import pnp as jpnp
    from orbslam_jpminipc_torch.solvers import pnp as tpnp

    jsolve = jax.jit(jpnp.solve_pnp, static_argnames=("n_hyp", "min_inliers", "min_set"))
    rows = []
    for seed in seeds:
        xw0, uv, mask, gate, R_true = planar_scene(seed)
        for key_i in keys:
            key = jax.random.key(key_i)
            scores = jax.random.uniform(key, (256, mask.shape[0]))
            scores = jnp.where(jnp.asarray(mask)[None, :], scores, -1.0)
            sets = torch.from_numpy(np.array(jax.lax.top_k(scores, 4)[1]))
            row = {"seed": seed, "key": key_i}
            for run_i, xw in enumerate((xw0, _ulp(xw0))):
                ref = jsolve(key, *map(jnp.asarray, (xw, uv, mask, K4, gate)))
                got = tpnp.solve_pnp(sets, *map(torch.from_numpy, (xw, uv, mask, K4, gate)))
                Rr, Rp = np.asarray(ref.R), got.R.numpy()
                row[f"run{run_i + 1}"] = {
                    "ref_vs_truth": float(np.abs(Rr - R_true).max()),
                    "port_vs_truth": float(np.abs(Rp - R_true).max()),
                    "port_vs_ref": float(np.abs(Rp - Rr).max()),
                    "inliers_differ": int((np.asarray(ref.inliers) != got.inliers.numpy()).sum()),
                    "success": [bool(ref.success), bool(got.success)],
                }
            row["agree"] = all(row[r]["port_vs_ref"] <= R_TOL for r in ("run1", "run2"))
            rows.append(row)
            r1, r2 = row["run1"], row["run2"]
            print(f"seed {seed} key {key_i}: port-ref {r1['port_vs_ref']:.2g} / "
                  f"{r2['port_vs_ref']:.2g}, ref-truth {r1['ref_vs_truth']:.2g} / "
                  f"{r2['ref_vs_truth']:.2g}, port-truth {r1['port_vs_truth']:.2g} / "
                  f"{r2['port_vs_truth']:.2g}, inliers differ {r1['inliers_differ']} / "
                  f"{r2['inliers_differ']}: {'agree' if row['agree'] else 'DISAGREE'}", flush=True)
    return rows


def _ulp(xw):
    """Every x and y moved by one float32 ulp away from zero."""
    out = xw.copy()
    out[:, :2] = np.nextafter(xw[:, :2], np.copysign(np.inf, xw[:, :2])).astype(np.float32)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="2,12,22")
    ap.add_argument("--keys", default="3,4,5,6")
    args = ap.parse_args(argv)
    rows = run([int(s) for s in args.seeds.split(",")], [int(k) for k in args.keys.split(",")])
    print(json.dumps({"agree": sum(r["agree"] for r in rows), "rows": len(rows)}))


if __name__ == "__main__":
    main()
