"""Write the PyTorch port's loop-closing fixture from the JAX reference.

Builds the constructed loop of tools/loop_scene.py at its shipping size
(max_kf 256, max_mp 16384, 2000 feature rows, eg_edges 2048; 46 keyframes,
11,310 points) on the JAX `MapState` with the 64k-word tree vocabulary,
runs the JAX `LoopCloser.process` over the tail keyframes until the loop
closes, then global bundle adjustment (`bundle_adjust_large` on the problem
`Slam.build_global_ba_problem` makes of the corrected map, at the full
(256, 16384, 65536) capacity), and records what the port is held to.
Outcomes only; the scene is rebuilt from the seed by whoever reads the
file:

  * the scene's name and seed and its sizes;
  * per processed keyframe: the database's candidate list, the candidates
    that passed the consistency filter, whether the loop closed;
  * at the closure: the loop keyframe, the mutual-match count, the minimal
    3-sets of the Sim3 RANSAC (the reference draws them with `jax.random`,
    which torch cannot reproduce: they are recomputed from the call's key
    and mask exactly as `solvers/sim3solver.py:solve_sim3` draws them),
    s, R, t and the inlier count after the RANSAC and after
    `optimize_sim3`, the guided-match total, the essential graph's edges by
    kind and its final chi2, every keyframe pose and every point after the
    correction, the loop edges;
  * global BA's chi2 before and after, its poses and which cameras it held.

    env JAX_PLATFORMS=cpu python tools/make_torch_loop_fixture.py

Runs on the CPU in about two minutes. `run_reference` is also what the CPU
parity tests call on the small scene with a vocabulary of their own.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np  # noqa: E402

import loop_scene  # noqa: E402

DEFAULT_OUT = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "loop_fixture.npz")
VOCAB = os.path.join(REPO, "orbslam_jpminipc_tpu", "data", "vocab_tree64k.npz")
SIM3_HYP = 128


def jax_sim3_sets(key, mask: np.ndarray, n_hyp: int = SIM3_HYP) -> np.ndarray:
    """The minimal sets `solve_sim3` draws from `key` (its first lines)."""
    import jax
    import jax.numpy as jnp

    scores = jax.random.uniform(key, (n_hyp, mask.shape[0]))
    scores = jnp.where(jnp.asarray(mask)[None, :], scores, -1.0)
    return np.array(jax.lax.top_k(scores, 3)[1]).astype(np.int32)


def run_reference(name: str, seed: int, vocab, global_ba: bool = True, eg_edges=None,
                  distributed: bool = False) -> dict:
    """The JAX `LoopCloser` over the tail of scene `name`, then global BA.
    Returns the recorded outcome (see the module's docstring) plus `st`,
    the JAX map as the run left it, `info`, the scene's description, and
    `eg_problem`, the essential-graph problem as numpy arrays.

    `distributed=True` keeps `cfg.distributed_gba`, so that with several
    devices the closer takes its edge-sharded essential graph; the result
    then also holds `eg_shards` (the shard count) and `eg_result` (s, R, t
    of the sharded solve)."""
    import jax

    from orbslam_jpminipc_tpu import parallel as par
    from orbslam_jpminipc_tpu.config import SlamConfig
    from orbslam_jpminipc_tpu.map.keyframe_db import KeyFrameDatabase
    from orbslam_jpminipc_tpu.map.map_state import MapState
    from orbslam_jpminipc_tpu.pipeline import loop_closing as lc
    from orbslam_jpminipc_tpu.pipeline.system import Slam
    from orbslam_jpminipc_tpu.solvers import ba, gba
    from orbslam_jpminipc_tpu.utils.tracing import get_tracer

    st, info = loop_scene.build_loop_scene(MapState, name, seed)
    cfg = SlamConfig(**info["cfg"])
    cfg.distributed_gba = distributed   # False: the single-device solvers, whatever devices
    if eg_edges is not None:
        cfg.eg_edges = eg_edges
    kfdb = KeyFrameDatabase(vocab, st.max_kf)
    loop_scene.finish_scene(st, info, kfdb,
                            lambda ids: st.update_point_attributes(ids, cfg.scale_factors))
    centres_before = loop_scene.camera_centres(st)
    closer = lc.LoopCloser(cfg, st, kfdb)

    events, ransac, refined, graph = [], [], [], {}
    tracer = get_tracer()
    real = dict(log=tracer.log, solve=lc._solve_sim3, opt=lc.sim3_opt.optimize_sim3,
                eg=lc.essential_graph.optimize_essential_graph,
                build=lc.LoopCloser._essential_graph, shard=par.shard_essential_graph,
                sharded=par.sharded_optimize_essential_graph)

    def spy_solve(key, *a, **k):
        res = real["solve"](key, *a, **k)
        mask = np.asarray(a[4])
        ransac.append(dict(sets=jax_sim3_sets(key, mask), mask=mask,
                           **{f: np.asarray(getattr(res, f)) for f in res._fields}))
        return res

    def spy_opt(*a, **k):
        res = real["opt"](*a, **k)
        refined.append({f: np.asarray(getattr(res, f)) for f in res._fields})
        return res

    def spy_eg(prob, iterations=20):
        res = real["eg"](prob, iterations=iterations)
        graph["problem"] = {f: np.asarray(getattr(prob, f)) for f in prob._fields}
        graph["chi2"] = float(res.chi2)
        return res

    def spy_shard(prob, n_shards):
        graph["problem"] = {f: np.asarray(getattr(prob, f)) for f in prob._fields}
        graph["shards"] = n_shards
        return real["shard"](prob, n_shards)

    def spy_sharded(sprob, mesh, iterations=20):
        res = real["sharded"](sprob, mesh, iterations=iterations)
        graph["chi2"] = float(res.chi2)
        graph["result"] = {f: np.asarray(getattr(res, f)) for f in ("s", "R", "t")}
        return res

    def spy_build(self, kf, loop_kf, covis_after, corrected, pre_R, pre_t, loop_connections,
                  corrected_by):
        graph["kinds"] = loop_scene.eg_edge_kinds(st, kf, loop_kf, covis_after, loop_connections)
        return real["build"](self, kf, loop_kf, covis_after, corrected, pre_R, pre_t,
                             loop_connections, corrected_by)

    tracer.log = lambda event, **f: events.append({"event": event, **f})
    lc._solve_sim3 = spy_solve
    lc.sim3_opt.optimize_sim3 = spy_opt
    lc.essential_graph.optimize_essential_graph = spy_eg
    lc.LoopCloser._essential_graph = spy_build
    par.shard_essential_graph = spy_shard
    par.sharded_optimize_essential_graph = spy_sharded
    per_kf = []
    try:
        for k in info["tail"]:
            n0 = len(events)
            closed = bool(closer.process(k))
            ev = {e["event"]: e for e in events[n0:]}
            per_kf.append(dict(
                kf=int(k), closed=closed,
                cands=ev.get("loop_detect", {}).get("cands", []),
                enough=ev.get("loop_consistency", {}).get("enough", [])))
            if closed:
                break
    finally:
        del tracer.log
        lc._solve_sim3 = real["solve"]
        lc.sim3_opt.optimize_sim3 = real["opt"]
        lc.essential_graph.optimize_essential_graph = real["eg"]
        lc.LoopCloser._essential_graph = real["build"]
        par.shard_essential_graph = real["shard"]
        par.sharded_optimize_essential_graph = real["sharded"]

    out = dict(st=st, info=info, per_kf=per_kf, centres_before=centres_before,
               closed_kf=next((r["kf"] for r in per_kf if r["closed"]), -1))
    if out["closed_kf"] < 0:
        return out
    kf = out["closed_kf"]
    mutual = [e for e in events if e["event"] == "sim3_mutual" and e["kf"] == kf]
    guided = [e for e in events if e["event"] == "sim3_guided" and e["kf"] == kf]
    out.update(
        loop_kf=int(next(iter(st.kf_loop_edges[kf]))),
        n_mutual=[int(e["n_match"]) for e in mutual],
        # one entry per candidate the RANSAC ran on; the last one closed
        ransac=ransac, refined=refined,
        guided_total=[int(e["total"]) for e in guided],
        eg_kinds=graph["kinds"], eg_chi2=graph["chi2"], eg_problem=graph["problem"],
        eg_n_edges=int(graph["problem"]["e_valid"].sum()),
        eg_shards=graph.get("shards", 1), eg_result=graph.get("result"),
        kf_R=st.kf_R.copy(), kf_t=st.kf_t.copy(), mp_xyz=st.mp_xyz.copy(),
        mp_valid=st.mp_valid.copy(), kf_valid=st.kf_valid.copy(),
        loop_edges=sorted((int(a), int(b)) for a in range(st.max_kf)
                          for b in st.kf_loop_edges[a] if a < b),
    )
    if global_ba:
        # the problem Slam.global_ba solves, on the corrected map
        prob, n_obs = Slam.build_global_ba_problem(types.SimpleNamespace(map=st, cfg=cfg))
        chi0 = float(ba._robust_chi2(prob, prob.kf_R, prob.kf_t, prob.points))
        res = gba.bundle_adjust_large(prob, iterations=cfg.gba_iterations,
                                      cg_iters=cfg.gba_cg_iters)
        kf_R, kf_t, pts, chi2 = jax.device_get((res.kf_R, res.kf_t, res.points, res.chi2))
        out.update(gba_n_obs=int(n_obs), gba_chi2_before=chi0, gba_chi2_after=float(chi2),
                   gba_kf_R=np.asarray(kf_R), gba_kf_t=np.asarray(kf_t),
                   gba_points=np.asarray(pts), gba_fixed=np.asarray(prob.kf_fixed),
                   gba_shape=[int(prob.kf_R.shape[0]), int(prob.points.shape[0]),
                              int(prob.obs_kf.shape[0])])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from orbslam_jpminipc_tpu.vocab.vocabulary import load_vocabulary

    ref = run_reference("shipping", args.seed, load_vocabulary(VOCAB))
    if ref["closed_kf"] < 0:
        raise SystemExit(f"the reference did not close the loop: {ref['per_kf']}")
    st, info = ref["st"], ref["info"]
    live = np.nonzero(ref["kf_valid"])[0]
    true_c = info["true_centres"]
    err = lambda c: float(np.linalg.norm(c[live] - true_c[live], axis=1).mean())
    last = len(ref["ransac"]) - 1
    meta = {
        "scene": "shipping", "seed": args.seed, "config": info["cfg"], "vocab": "vocab_tree64k.npz",
        "n_keyframes": int(st.kf_valid.sum()), "n_points_before": 11310,
        "n_points_after": int(st.mp_valid.sum()),
        "features_per_keyframe_min": int((st.kf_point[live] >= 0).sum(1).min()),
        "per_kf": ref["per_kf"], "closed_kf": ref["closed_kf"], "loop_kf": ref["loop_kf"],
        "n_mutual": ref["n_mutual"], "guided_total": ref["guided_total"],
        "ransac_n_inliers": [int(r["n_inliers"]) for r in ref["ransac"]],
        "opt_n_inliers": [int(r["n_inliers"]) for r in ref["refined"]],
        "eg_kinds": ref["eg_kinds"], "eg_n_edges": ref["eg_n_edges"], "eg_chi2": ref["eg_chi2"],
        "loop_edges": ref["loop_edges"],
        "mean_centre_error_before": err(ref["centres_before"]),
        "mean_centre_error_after": err(loop_scene.camera_centres(st)),
        "gba_n_obs": ref["gba_n_obs"], "gba_shape": ref["gba_shape"],
        "gba_chi2_before": ref["gba_chi2_before"], "gba_chi2_after": ref["gba_chi2_after"],
    }
    r, o = ref["ransac"][last], ref["refined"][last]
    np.savez_compressed(
        args.out, meta=json.dumps(meta),
        sim3_sets=np.stack([x["sets"] for x in ref["ransac"]]),
        ransac_s=r["s12"], ransac_R=r["R12"], ransac_t=r["t12"],
        opt_s=o["s12"], opt_R=o["R12"], opt_t=o["t12"],
        kf_R=ref["kf_R"], kf_t=ref["kf_t"], kf_valid=ref["kf_valid"],
        mp_xyz=ref["mp_xyz"], mp_valid=ref["mp_valid"],
        gba_kf_R=ref["gba_kf_R"], gba_kf_t=ref["gba_kf_t"], gba_fixed=ref["gba_fixed"],
    )
    print(json.dumps(meta, indent=1))
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
