"""World checkpoint and resume (counterpart of
orbslam_jpminipc_tpu/io/checkpoint.py).

The reference's SaveLoadWorld subsystem (binary records, id->pointer
re-linking, covisibility rebuild; loaded at src/main.cc:143, saved at :249)
becomes one compressed npz of the map's dense arrays and the keyframe
database. The keys are the JAX package's, so a world saved by either
package loads in the other. Loading restores the arrays and puts the
tracker in LOST, so the next frame relocalizes into the loaded map (the
reference's resume contract, src/main.cc:171-177).
"""
from __future__ import annotations

import json

import numpy as np

from ..map.map_state import MapState

_ARRAY_FIELDS = [
    "kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_timestamp", "kf_xy",
    "kf_level", "kf_angle", "kf_desc", "kf_feat_valid", "kf_point",
    "kf_parent", "mp_xyz", "mp_valid", "mp_desc", "mp_normal",
    "mp_min_dist", "mp_max_dist", "mp_ref_kf", "mp_first_kf", "mp_visible",
    "mp_found", "mp_obs_kf", "mp_obs_feat", "mp_gen",
]


def save_world(path: str, state: MapState, kfdb=None):
    """Serialize the whole world (and the BoW database when given)."""
    payload = {f: getattr(state, f) for f in _ARRAY_FIELDS}
    payload["loop_edges"] = np.frombuffer(
        json.dumps([sorted(s) for s in state.kf_loop_edges]).encode(), np.uint8
    )
    payload["meta"] = np.array(
        [state.max_kf, state.max_mp, state.n_feat, state.max_obs,
         state.next_kf_id, state.next_mp_id],
        np.int64,
    )
    if kfdb is not None:
        payload["kfdb_bow_ids"] = kfdb.bow_ids
        payload["kfdb_bow_vals"] = kfdb.bow_vals
        payload["kfdb_bow_n"] = kfdb.bow_n
        payload["kfdb_present"] = kfdb.present
    np.savez_compressed(path, **payload)


def load_world(path: str, kfdb=None, device=None) -> MapState:
    """Rebuild a MapState (its programs run on `device`) and refill the BoW
    database when given."""
    z = np.load(path, allow_pickle=False)
    max_kf, max_mp, n_feat, max_obs, next_kf, next_mp = (int(x) for x in z["meta"])
    state = MapState.create(max_kf, max_mp, n_feat, max_obs, device=device)
    for f in _ARRAY_FIELDS:
        getattr(state, f)[...] = z[f]
    state.next_kf_id = next_kf
    state.next_mp_id = next_mp
    edges = json.loads(bytes(z["loop_edges"]).decode())
    state.kf_loop_edges = [set(e) for e in edges]
    if kfdb is not None and "kfdb_bow" in z and "kfdb_bow_ids" not in z:
        # legacy dense-format checkpoint: rebuild the sparse vectors from
        # the dense (MAX_KF, n_words) matrix rather than load an empty
        # database (which would disable loop closing and relocalization)
        dense = z["kfdb_bow"]
        present = z["kfdb_present"] if "kfdb_present" in z else None
        S = kfdb.bow_ids.shape[1]
        for kf in range(min(dense.shape[0], kfdb.present.shape[0])):
            if present is not None and not present[kf]:
                continue
            ids = np.nonzero(dense[kf])[0]
            if len(ids) == 0:
                continue
            vals = dense[kf, ids].astype(np.float32)
            if len(ids) > S:
                # keep the top S by weight, ids re-sorted: the database scan
                # requires ascending word ids per row
                keep = np.sort(np.argsort(-vals)[:S])
                ids, vals = ids[keep], vals[keep]
            vals = vals / max(vals.sum(), 1e-12)
            kfdb.present[kf] = True
            kfdb.bow_n[kf] = len(ids)
            kfdb.bow_ids[kf, :len(ids)] = ids
            kfdb.bow_vals[kf, :len(ids)] = vals
    elif kfdb is not None and "kfdb_bow_ids" in z:
        saved = z["kfdb_bow_ids"]
        if saved.shape != kfdb.bow_ids.shape:
            raise ValueError(
                f"checkpoint BoW capacity {saved.shape} does not match the "
                f"database {kfdb.bow_ids.shape}; construct the "
                f"KeyFrameDatabase with matching max_kf/max_words_per_kf"
            )
        kfdb.bow_ids[...] = z["kfdb_bow_ids"]
        kfdb.bow_vals[...] = z["kfdb_bow_vals"]
        kfdb.bow_n[...] = z["kfdb_bow_n"]
        kfdb.present[...] = z["kfdb_present"]
    return state


def save_slam(path: str, slam):
    slam.mapper.drain_attrs()  # apply a deferred attribute writeback first
    save_world(path, slam.map, slam.kfdb)


def load_slam(path: str, slam):
    """Load a world into an existing Slam and put the tracker in LOST, so
    the next frame relocalizes into the loaded map (the reference's resume,
    src/main.cc:171-177)."""
    from ..frontend.tracking import TrackState

    state = load_world(path, slam.kfdb, device=slam.device)
    slam.map = state
    slam.tracker.map = state
    slam.mapper.map = state
    slam.mapper.dmap.sync_all(state)
    if slam.loop_closer is not None:
        slam.loop_closer.map = state
    slam.tracker.state = TrackState.LOST
    slam.tracker.velocity = None
    slam.tracker.last_frame = None
    if slam.tracker.fused is not None:
        slam.tracker.fused.invalidate()
    # drop the split-stage work dispatched against the pre-load map (as
    # Slam.reset does): a deferred merge applied after the load would write
    # results computed on the old map into the loaded one
    m = slam.mapper
    m.probation = []
    m._tri_pending = None
    m._fuse_pending = None
    m._ba_pending = None
    m._ba_stage1 = None
    m._ba2_pending = None
    m._attrs_pending = []
    m._attrs_inflight = None
    slam.pending = []
    # (the reference also drops its in-flight pipelined-tracking records
    # here; this package tracks each frame to its end, so it has none)
    slam._last_result = (TrackState.LOST, None)
    return slam
