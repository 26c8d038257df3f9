"""A constructed loop-closure situation, from a seed, numpy only.

A genuine loop closure cannot arise in the clean synthetic renders
(tracking re-matches the persistent map before covisibility ever breaks,
tests/test_loop_closing.py), so the situation is built directly, the way the
reference encounters it (LoopClosing.cc:115-574): a keyframe chain whose
tail revisits the start's VIEW but not its map. The tail observes drifted
duplicates of the start's points with the same descriptors, and its
estimated poses carry the accumulated drift. A loop closer must detect the
loop through the BoW database and the consistency filter, solve the
relative Sim3, and pull the tail back onto the start through the essential
graph.

`build_loop_scene` takes the `MapState` class as an argument, so the JAX package
and the PyTorch port build the very same map with the very same code:

    st, info = build_loop_scene(MapState, "small", seed=0)          # JAX
    st, info = build_loop_scene(MapState, "small", seed=0, device="cpu")  # port
    finish_scene(st, info, kfdb, update_attrs)

Three scenes. `small` is the scene of tests/test_loop_closing.py (9 keyframes,
60 points a set, 16 x 2048 capacity), `dense` the same with 110 points a
set (covisibility weights above 100). `shipping` is sized as a deployment:
the capacities `Slam` allocates for n_features=1000 (max_kf 256, max_mp
16384, 2000 feature rows, max_obs 32, eg_edges 2048), 46 keyframes, 11,310
points, 650 point-bearing features per keyframe, neighbours sharing 260 and
130 points (strong covisibility edges of weight >= 100 beyond the spanning
tree), 0.3 px of pixel noise, and a drift that grows linearly along the
chain to 0.39 at a median depth of 4 (in `small` the whole drift sits in the
step from the chain to the tail).
"""
from __future__ import annotations

import numpy as np

K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
DRIFT = np.array([0.35, 0.0, 0.18], np.float32)

SCENES = {
    # views: (set offset, share of the set) seen by chain keyframe k: set k + offset
    "small": dict(
        n_chain=5, n_tail=4, n_per=60, spacing=0.4, views=((-1, 1.0), (0, 1.0)),
        pixel_noise=0.0, drift_along_chain=False,
        create=dict(max_kf=16, max_mp=2048, n_feat=160, max_obs=12),
        cfg=dict(max_kf=16, max_mp=2048, n_features=128),
    ),
    # `small` with 110 points a set: the tail's keyframes share enough points
    # for strong covisibility edges, so a small edge capacity really cuts
    "dense": dict(
        n_chain=5, n_tail=4, n_per=110, spacing=0.4, views=((-1, 1.0), (0, 1.0)),
        pixel_noise=0.0, drift_along_chain=False,
        create=dict(max_kf=16, max_mp=2048, n_feat=256, max_obs=12),
        cfg=dict(max_kf=16, max_mp=2048, n_features=128),
    ),
    "shipping": dict(
        n_chain=40, n_tail=6, n_per=260, spacing=0.15, views=((0, 1.0), (1, 1.0), (2, 0.5)),
        pixel_noise=0.3, drift_along_chain=True,
        create=dict(max_kf=256, max_mp=16384, n_feat=2000, max_obs=32),
        cfg=dict(max_kf=256, max_mp=16384, n_features=1000, eg_edges=2048),
    ),
}


def project(xc: np.ndarray) -> np.ndarray:
    return np.stack([K4[0] * xc[:, 0] / xc[:, 2] + K4[2],
                     K4[1] * xc[:, 1] / xc[:, 2] + K4[3]], 1).astype(np.float32)


def _make_points(rng, n):
    return np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                     rng.uniform(3.0, 5.0, n)], 1).astype(np.float32)


def build_loop_scene(MapState, name: str = "small", seed: int = 0, **create_kw):
    """The map of scene `name` on a fresh `MapState` (made with the scene's
    capacities plus `create_kw`, e.g. the port's `device`). Point
    attributes and the keyframe database are left to `finish_scene`.

    Returns (st, info): info holds the `SlamConfig` keywords, the tail
    keyframes in the order a system would process them, every keyframe's
    true centre, the drift and the median depth."""
    sc = SCENES[name]
    rng = np.random.default_rng(seed)
    st = MapState.create(**sc["create"], **create_kw)
    n_chain, n_tail, n_per = sc["n_chain"], sc["n_tail"], sc["n_per"]
    views = sorted(sc["views"])
    # every set is seen whole by at least one chain keyframe
    n_sets = n_chain + max(o for o, share in views if share == 1.0)

    centres = np.zeros((n_chain + n_tail, 3), np.float32)
    centres[:n_chain, 0] = sc["spacing"] * np.arange(n_chain)
    centres[n_chain:, 0] = 0.05 * np.arange(n_tail)        # back near the start

    # set j sits in front of chain keyframe min(j, n_chain - 1)
    sets_xyz = [_make_points(rng, n_per) + centres[min(j, n_chain - 1)] for j in range(n_sets)]
    sets_desc = [rng.integers(0, 256, (n_per, 32)).astype(np.uint8) for _ in range(n_sets)]

    def drift_of(k):
        """The estimate's drift at chain keyframe k: all of it in the step
        from the chain to the tail, or growing linearly along the chain."""
        return (k / (n_chain - 1)) * DRIFT if sc["drift_along_chain"] else 0.0 * DRIFT

    def seen(k):
        """(set, point indices) seen by chain keyframe k, in set order."""
        out = []
        for o, share in views:
            j = k + o
            if 0 <= j < n_sets:
                out.append((j, np.arange(int(round(share * n_per)))))
        return out

    def ref_kf(j):
        """The nearest chain keyframe that sees the whole of set j."""
        for o, share in sorted(views, key=lambda v: abs(v[0])):
            if share == 1.0 and 0 <= j - o < n_chain:
                return j - o
        raise ValueError(f"no keyframe sees the whole of set {j}")

    # a set's estimated position carries the drift of its reference keyframe
    set_ids = [st.add_points(sets_xyz[j] + drift_of(ref_kf(j)), sets_desc[j], ref_kf=ref_kf(j))
               for j in range(n_sets)]
    # drifted duplicates of what keyframe 0 sees, observed only by the tail
    dups = [(j, idx, st.add_points(sets_xyz[j][idx] + DRIFT, sets_desc[j][idx], ref_kf=n_chain))
            for j, idx in seen(0)]

    def add_kf(k, centre_est, obs):
        """obs: (point ids, their true world positions, descriptors). The
        pixels are what the camera at its true centre sees; only the pose
        estimate carries drift."""
        ids = np.concatenate([o[0] for o in obs])
        xyz = np.concatenate([o[1] for o in obs]).astype(np.float32)
        desc = np.concatenate([o[2] for o in obs])
        uv = project(xyz - centres[k][None, :])            # R = I
        if sc["pixel_noise"] > 0:
            uv = (uv + rng.normal(0, sc["pixel_noise"], uv.shape)).astype(np.float32)
        n = len(ids)
        kf = st.add_keyframe(
            np.eye(3, dtype=np.float32), -centre_est.astype(np.float32), uv,
            np.zeros(n, np.int32), np.zeros(n, np.float32), desc, np.ones(n, bool),
            frame_id=k, timestamp=k / 30.0)
        if kf != k:
            raise RuntimeError(f"keyframe {k} landed in slot {kf}")
        for f, mp in enumerate(ids):
            st.add_observation(int(mp), kf, f)

    for k in range(n_chain):
        add_kf(k, centres[k] + drift_of(k),
               [(set_ids[j][idx], sets_xyz[j][idx], sets_desc[j][idx]) for j, idx in seen(k)])
    for r in range(n_tail):      # the tail sees the duplicates, with the whole drift
        add_kf(n_chain + r, centres[n_chain + r] + DRIFT,
               [(ids, sets_xyz[j][idx], sets_desc[j][idx]) for j, idx, ids in dups])
    n_kf = n_chain + n_tail
    st.kf_parent[1:n_kf] = np.arange(0, n_kf - 1)

    info = dict(
        name=name, seed=seed,
        cfg=dict(pipelined_tracking=False, fx=500.0, fy=500.0, cx=320.0, cy=240.0, **sc["cfg"]),
        n_keyframes=n_kf, tail=list(range(n_chain, n_kf)), true_centres=centres,
        drift=DRIFT, median_depth=4.0, vocab_descriptors=np.concatenate(sets_desc),
    )
    return st, info


def finish_scene(st, info, kfdb, update_attrs, chunk: int = 2048):
    """Point attributes (through the package's own `update_attrs(ids)`, a
    chunk at a time to bound its memory) and the keyframe database."""
    ids = np.nonzero(st.mp_valid)[0]
    for a in range(0, len(ids), chunk):
        update_attrs(ids[a:a + chunk])
    if kfdb is not None:
        for k in range(info["n_keyframes"]):
            kfdb.add(k, st.kf_desc[k], st.kf_feat_valid[k])


def camera_centres(st) -> np.ndarray:
    """(max_kf, 3) camera centres -R^T t of every slot."""
    return -np.einsum("kji,kj->ki", st.kf_R, st.kf_t)


def eg_edge_kinds(st, kf: int, loop_kf: int, covis_after: np.ndarray,
                  loop_connections: dict) -> dict:
    """How many essential-graph edges of each kind a loop correction
    builds, counted from the map by the rules of OptimizeEssentialGraph
    (Optimizer.cc:1540-1664): loop connections (weight >= 100, the
    current/loop pair exempt and always present), then per keyframe its
    spanning-tree edge, its earlier loop edges and its strong covisibility
    edges, every pair once."""
    valid = st.kf_valid
    kinds = {"loop": 0, "spanning": 0, "prior_loop": 0, "covisibility": 0}
    seen = set()

    def take(i, j, kind):
        key = (min(i, j), max(i, j))
        if key not in seen:
            seen.add(key)
            kinds[kind] += 1

    for i, conns in sorted(loop_connections.items()):
        for j in sorted(conns):
            if valid[j] and ((i == kf and j == loop_kf) or covis_after[i, j] >= 100):
                take(i, j, "loop")
    take(kf, loop_kf, "loop")
    for k in np.nonzero(valid)[0]:
        k = int(k)
        parent = int(st.kf_parent[k])
        if parent >= 0 and valid[parent]:
            take(k, parent, "spanning")
        for le in st.kf_loop_edges[k]:
            if valid[le] and le < k:
                take(k, int(le), "prior_loop")
        for n in np.nonzero(covis_after[k] >= 100)[0]:
            if valid[n] and n < k:
                take(k, int(n), "covisibility")
    return kinds
