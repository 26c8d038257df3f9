"""Map maintenance culling rules (counterpart of
orbslam_jpminipc_tpu/map/culling.py).

Mirrors LocalMapping::MapPointCulling (src/LocalMapping.cc:197-225) and
LocalMapping::KeyFrameCulling (:546-600) as batch passes over the SoA map.
"""
from __future__ import annotations

import numpy as np

from .map_state import MapState


def cull_recent_points(state: MapState, recent_ids: list[int], current_kf_id: int) -> list[int]:
    """Prune recently created points (LocalMapping.cc:197-225).

    A recent point is erased if its found-ratio < 0.25, or it is >= 2
    keyframes old but has <= 2 observations. Points >= 3 keyframes old
    graduate out of the probation list. Returns the surviving probation list.
    """
    keep = []
    for entry in recent_ids:
        mp, gen = entry
        if not state.mp_valid[mp] or state.mp_gen[mp] != gen:
            continue
        found_ratio = state.mp_found[mp] / max(state.mp_visible[mp], 1)
        age = current_kf_id - state.mp_first_kf[mp]
        nobs = state.n_observations(mp)
        if found_ratio < 0.25:
            state.erase_point(mp)
        elif age >= 2 and nobs <= 2:
            state.erase_point(mp)
        elif age >= 3:
            pass  # graduated
        else:
            keep.append((mp, gen))
    return keep


def cull_redundant_keyframes(state: MapState, candidates: np.ndarray,
                             redundancy: float = 0.9) -> list[int]:
    """Erase keyframes whose points are >= 90% covered by >= 3 other
    keyframes at the same or finer pyramid level (LocalMapping.cc:546-600).

    candidates: KF ids to consider (the reference checks the current KF's
    covisible keyframes). Returns the erased ids. Uses the native (C++)
    map-graph runtime when available; the Python loop below is the
    fallback and the reference implementation for tests.
    """
    candidates = protect_keyframes(state, candidates)
    if len(candidates) == 0:
        return []
    from ..native import cull_redundant_keyframes_native

    native = cull_redundant_keyframes_native(state, candidates, redundancy)
    if native is not None:
        return native
    return _cull_redundant_keyframes_py(state, candidates, redundancy)


def force_free_keyframe(state: MapState) -> int | None:
    """Graceful degradation at keyframe capacity: erase the most isolated
    unprotected keyframe (lowest total covisibility weight) so a NEW one
    can be inserted. The reference never hits this (it has no capacity),
    but its redundant-KF culling embodies the same policy — keep the
    keyframes that anchor the most shared observations. Returns the freed
    slot, or None if every keyframe is protected."""
    cands = protect_keyframes(state, np.nonzero(state.kf_valid)[0])
    if len(cands) == 0:
        return None
    covis = state.covisibility()
    w = covis[cands][:, state.kf_valid].sum(axis=1)
    victim = int(cands[np.argmin(w)])
    state.erase_keyframe(victim)
    return victim


def protect_keyframes(state: MapState, candidates) -> np.ndarray:
    """Drop the keyframes the reference never erases from a culling
    candidate list (KeyFrame::SetBadFlag, src/KeyFrame.cc:501-503):

    * the gauge keyframe (mnId == 0 — here: the valid KF with the smallest
      frame id; erasing it would delete the fixed vertex local/global BA
      anchors the gauge on, src/LocalMapping.cc:556 skips it too);
    * any keyframe holding loop edges (mbNotErase, set permanently by
      AddLoopEdge, src/KeyFrame.cc:461-472 — erasing one silently deletes
      essential-graph loop constraints).
    """
    candidates = np.asarray(candidates, np.int64).reshape(-1)
    if len(candidates) == 0:
        return candidates
    keep = np.ones(len(candidates), bool)
    if state.kf_valid.any():
        valid_ids = np.nonzero(state.kf_valid)[0]
        gauge = int(valid_ids[np.argmin(state.kf_frame_id[valid_ids])])
        keep &= candidates != gauge
    for i, k in enumerate(candidates):
        if keep[i] and state.kf_loop_edges[int(k)]:
            keep[i] = False
    return candidates[keep]


def _cull_redundant_keyframes_py(state: MapState, candidates, redundancy=0.9):
    erased = []
    for k in candidates:
        k = int(k)
        if not state.kf_valid[k]:
            continue
        feats = np.nonzero(state.kf_point[k] >= 0)[0]
        if len(feats) == 0:
            continue
        n_redundant = 0
        for f in feats:
            mp = int(state.kf_point[k, f])
            level = int(state.kf_level[k, f])
            n_better = 0
            for s in np.nonzero(state.mp_obs_kf[mp] >= 0)[0]:
                okf = int(state.mp_obs_kf[mp, s])
                if okf == k:
                    continue
                of = int(state.mp_obs_feat[mp, s])
                if state.kf_level[okf, of] <= level + 1:
                    n_better += 1
                    if n_better >= 3:
                        break
            if n_better >= 3:
                n_redundant += 1
        if n_redundant > redundancy * len(feats):
            state.erase_keyframe(k)
            erased.append(k)
    return erased
