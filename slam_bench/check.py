"""How `correct` is decided: what the timed path produced, against the plain
references in `reference/`, after the window has closed and the system's
state is freed.

The numbers, each with its limit from `limits/<workload>.json`:

  kp_mismatch_pct     extraction: over a sample of the window's frames drawn
                      from the seed (a host-path frame and, where there are
                      any, a LOST frame among them), the keypoints (level and
                      position) that the program and the reference extractor
                      do not share, per 100 of the reference's; the worst frame
  desc_bits_pct       extraction: descriptor bits that differ on the shared
                      keypoints, per 100 bits; the worst frame
  step_pose_px        the WORKING step: over frames drawn by a stride from the
                      seed, the pose the system reported for the frame against
                      the float64 reference solve on the step's own inlier
                      matches (the slice rows it bound, as they stood at
                      dispatch), RMS pixels between the matched points'
                      projections under the two poses; the worst frame
  step_match_bad_pct  the same frames: inlier matches that cannot be inliers
                      (descriptors over ORB-SLAM's 100 bits apart, the point
                      behind the camera, or over the 5.991 gate at the
                      reference pose), per 100; the worst frame
  reloc_pose_px,      the same two for the poses that relocalization returned
  reloc_match_bad_pct (its inlier matches against the map as it stood)
  ba_problem_diff     local BA: over keyframes drawn by a stride from the seed,
                      the entries of the problem the program assembled
                      (keyframes, fixed flags, starting poses, points, edges,
                      pixels, weights) that differ from the problem the
                      reference assembles again from the map as it stood
  ba_shortfall_pct    local BA's first stage on the reference's problem: the
                      part of the reference LM's cost decrease (5 iterations)
                      that the program's result falls short of, in %; the
                      worst keyframe
  ba2_shortfall_pct   its second stage (10 iterations from the first stage's
                      state, the reference's own outliers erased; an edge
                      within 1 % of the gate takes the program's call), the
                      same way; where the stage ran
  traj_err_pct        the trajectory: the centres of every frame that completed
                      WORKING against the renderer's truth, aligned by a
                      similarity per map, RMS error per 100 of the truth's RMS
                      spread about its mean

A number with nothing to read (no BA stage in the window) is not compared
and says so. Each is printed beside its limit.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .reference import ba as ref_ba
from .reference import extract as ref_extract
from .reference import pose as ref_pose
from .reference import trajectory as ref_traj

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
N_EXTRACT = 6
N_BA = 6
N_STEP = 8
N_RELOC = 8
# sampling strides of the window: every `frame`-th frame id and every `ba`-th
# local BA, from an offset drawn from the seed (session.Recorder)
EVERY = {"frame": 53, "ba": 4}
BA_CAPS = ("local_ba_kf", "local_ba_fixed", "local_ba_points", "local_ba_obs")


def load_limits(workload: str) -> dict:
    with open(LIMITS_DIR / f"{workload}.json") as f:
        return json.load(f)["limits"]


def sample_frames(completed: dict, frames: dict, seed: int, n: int = N_EXTRACT) -> list:
    """Frame ids drawn from the seed: one of the host-path frames (the
    largest feature budget), one LOST frame where there is one, the rest
    among the others."""
    rng = np.random.default_rng([seed, 0xE7])
    ids = sorted(f for f in completed if f in frames)
    if not ids:
        return []
    budget = {f: len(frames[f].valid) for f in ids}
    big = max(budget.values())
    host = [f for f in ids if budget[f] == big and big > min(budget.values())]
    lost = [f for f in ids if completed[f][0] == "LOST"]
    pick = []
    for pool in (host, lost):
        if pool:
            pick.append(int(rng.choice(pool)))
    rest = [f for f in ids if f not in pick]
    k = min(n - len(pick), len(rest))
    pick += [int(x) for x in rng.choice(rest, size=k, replace=False)] if k > 0 else []
    return sorted(set(pick))


def extraction_numbers(samples, config: dict, device) -> dict:
    """samples: [(image, program features {level, xy, desc, valid})]."""
    import torch

    mismatch, bits = 0.0, 0.0
    for image, prog in samples:
        ref = reference_features(image, len(prog["valid"]), config, device, torch.float32)
        m, b = compare_features(prog, ref)
        mismatch, bits = max(mismatch, m), max(bits, b)
    return {"kp_mismatch_pct": mismatch, "desc_bits_pct": bits}


def fast_thresholds(config: dict) -> tuple[float, float]:
    """(high, low) FAST thresholds: ORB-SLAM2's iniThFAST/minThFAST, or
    ORB-SLAM's single fastTh with the port's fallback under `port`."""
    high = config.get("ORBextractor.iniThFAST", config.get("ORBextractor.fastTh", 20))
    low = config.get("ORBextractor.minThFAST", config.get("port", {}).get("fast_min_threshold", 7))
    return float(high), float(low)


def reference_features(image, n_features: int, config: dict, device, dtype) -> dict:
    """The reference extractor at the configuration's settings."""
    high, low = fast_thresholds(config)
    return ref_extract.extract(image, n_features, config["ORBextractor.nLevels"],
                               config["ORBextractor.scaleFactor"], high, low,
                               device=device, dtype=dtype)


def compare_features(prog: dict, ref: dict) -> tuple[float, float]:
    """(keypoints not shared per 100 of the reference's, differing
    descriptor bits per 100 on the shared ones)."""
    def keyed(f):
        v = np.asarray(f["valid"], bool)
        lv = np.asarray(f["level"])[v]
        xy = np.asarray(f["xy"], np.float32)[v]
        d = np.asarray(f["desc"], np.uint8)[v]
        return {(int(l), float(x), float(y)): row for l, (x, y), row in zip(lv, xy, d)}

    p, r = keyed(prog), keyed(ref)
    shared = p.keys() & r.keys()
    mismatch = 100.0 * (len(p) + len(r) - 2 * len(shared)) / max(len(r), 1)
    if not shared:
        return mismatch, 100.0
    a = np.stack([p[k] for k in shared])
    b = np.stack([r[k] for k in shared])
    diff = np.unpackbits(a ^ b, axis=1).sum()
    return mismatch, 100.0 * diff / (256 * len(shared))


def camera_k4(config: dict) -> np.ndarray:
    return np.array([config["Camera.fx"], config["Camera.fy"], config["Camera.cx"],
                     config["Camera.cy"]], np.float64)


def inv_sigma2(config: dict) -> np.ndarray:
    """1 / sigma^2 per pyramid level: sigma is the level's scale."""
    n, s = config["ORBextractor.nLevels"], config["ORBextractor.scaleFactor"]
    return 1.0 / np.float64(s) ** (2 * np.arange(n))


def draw(ids, n: int, seed: int, salt: int) -> list:
    ids = sorted(ids)
    if len(ids) <= n:
        return ids
    rng = np.random.default_rng([seed, salt])
    return sorted(int(x) for x in rng.choice(ids, size=n, replace=False))


# -- the WORKING step and relocalization: the pose on its own matches ----------

def step_samples(rec, seed: int) -> list:
    """The sampled step frames that reported a pose, drawn from the seed:
    [{xw, uv, level, desc, desc_m, R, t, frame}]."""
    ids = [f for f in rec.steps if f in rec.poses]
    return [dict(rec.steps[f], R=rec.poses[f][0], t=rec.poses[f][1], frame=f)
            for f in draw(ids, N_STEP, seed, 0x57)]


def reloc_samples(rec, seed: int) -> list:
    picks = draw(range(len(rec.relocs)), N_RELOC, seed, 0x4E)
    return [rec.relocs[i] for i in picks]


def reference_pose(s: dict, config: dict, dtype=None):
    """The reference solve on a sample's matches, from its reported pose."""
    import torch

    w = inv_sigma2(config)[np.clip(s["level"], 0, config["ORBextractor.nLevels"] - 1)]
    return ref_pose.solve(s["xw"], s["uv"], w, s["R"], s["t"], camera_k4(config),
                          dtype=dtype or torch.float64), w


def pose_numbers(samples, config: dict, prefix: str, poses=None) -> dict:
    """{prefix_pose_px, prefix_match_bad_pct}, the worst sample each. With
    `poses` [(R, t)] one per sample, those are judged in place of the
    samples' reported poses (the faults)."""
    K4 = camera_k4(config)
    px, bad = [], []
    for i, s in enumerate(samples):
        if len(s["xw"]) == 0:
            continue
        (R, t), w = reference_pose(s, config)
        Rp, tp = poses[i] if poses is not None else (s["R"], s["t"])
        px.append(ref_pose.pose_px(s["xw"], Rp, tp, R, t, K4))
        bad.append(100.0 * ref_pose.bad_matches(s["desc"], s["desc_m"], s["xw"], s["uv"], w,
                                                R, t, K4).mean())
    return {f"{prefix}_pose_px": max(px) if px else None,
            f"{prefix}_match_bad_pct": max(bad) if bad else None}


# -- local BA ------------------------------------------------------------------

def ba_samples(rec, seed: int) -> list:
    return [rec.ba[i] for i in draw(range(len(rec.ba)), N_BA, seed, 0xBA)]


def reference_problem(b: dict, config: dict):
    """The reference's own assembly of a sampled BA's problem:
    (problem, keyframe ids, point ids)."""
    caps = {k: int(config["port"][k]) for k in BA_CAPS}
    # the program lists its local keyframes first, then its fixed ones in
    # ascending order, flagged fixed; the first keyframe (slot 0) is
    # flagged fixed wherever it stands
    kfs, flags = b["kfs"], np.asarray(b["prob"]["kf_fixed"], bool)[:len(b["kfs"])]
    free = np.nonzero(~flags)[0]
    n_local = int(free[-1]) + 1 if len(free) else 1
    return ref_ba.local_problem(b["map"], b["kf"], caps, inv_sigma2(config),
                                camera_k4(config), prefer_local=kfs[:n_local],
                                prefer_fixed=kfs[n_local:], prefer_pts=b["pts"])


def in_reference_order(out, prog_kfs, prog_pts, ref: dict, kfs, pts):
    """The program's (R, t, X), indexed by its own keyframes and points,
    laid out as the reference's problem has them; what the program does not
    have keeps the problem's start."""
    R, t, X = (np.array(ref[k], np.float64) for k in ("kf_R", "kf_t", "points"))
    ki = {k: i for i, k in enumerate(prog_kfs)}
    pi = {int(p): i for i, p in enumerate(prog_pts)}
    for j, k in enumerate(kfs):
        if k in ki:
            R[j], t[j] = out[0][ki[k]], out[1][ki[k]]
    for j, p in enumerate(np.asarray(pts).tolist()):
        if p in pi:
            X[j] = out[2][pi[p]]
    return R, t, X


def ba_shortfall(prob: dict, program_out, iterations: int = 5, ref_out=None) -> float | None:
    """100 (c_prog - c_ref) / (c_in - c_ref), costs in float64, the reference
    LM run `iterations` from the problem's state; None where its decrease
    is under 1e-6 of the cost (nothing to judge)."""
    R, t, X = ref_out if ref_out is not None else ref_ba.lm(prob, iterations=iterations)
    c_in = ref_ba.cost(prob, prob["kf_R"], prob["kf_t"], prob["points"])
    c_ref = ref_ba.cost(prob, R, t, X)
    c_prog = ref_ba.cost(prob, *program_out)
    gain = c_in - c_ref
    if not np.isfinite(c_prog):
        return float("inf")
    if gain <= 1e-6 * c_in:
        return None
    return 100.0 * (c_prog - c_ref) / gain


# an edge whose chi2 lies this close to the gate (relatively) at the first
# stage's state is kept or erased by rounding: there the program's own call
# is taken, as `reference.ba._top` takes its choice among equal weights
GATE_BAND = 0.01


def program_outliers(b: dict) -> dict:
    """{(keyframe id, point id): erased} of the program's first stage."""
    prob, out = b["prob"], b["out1"]
    v = np.nonzero(np.asarray(prob["obs_valid"], bool))[0]
    kfs, pts = np.asarray(b["kfs"]), np.asarray(b["pts"])
    keys = zip(kfs[np.asarray(prob["obs_kf"])[v]].tolist(),
               pts[np.asarray(prob["obs_pt"])[v]].tolist())
    return dict(zip(keys, np.asarray(out, bool)[v].tolist()))


def second_stage(ref: dict, kfs, pts, stage1, prog_out: dict | None = None):
    """The second stage's problem: the first stage's state, its outliers
    erased. Returns (problem, edges in the band, of those the program
    decided otherwise, edges outside it the program decided otherwise)."""
    c, z = ref_ba.edge_chi2(ref, *stage1)
    valid = np.asarray(ref["obs_valid"], bool)
    out = valid & ((c > ref_ba.CHI2) | (z <= 0))
    band = valid & (np.abs(c - ref_ba.CHI2) <= GATE_BAND * ref_ba.CHI2) & (z > 0)
    flips = clear = 0
    if prog_out is not None:
        kfa, pta = np.asarray(kfs), np.asarray(pts)
        for i in np.nonzero(valid)[0]:
            key = (int(kfa[ref["obs_kf"][i]]), int(pta[ref["obs_pt"][i]]))
            if key not in prog_out or prog_out[key] == out[i]:
                continue
            if band[i]:
                flips += 1
                out[i] = prog_out[key]
            else:
                clear += 1
    prob2 = dict(ref, kf_R=stage1[0], kf_t=stage1[1], points=stage1[2], obs_valid=valid & ~out)
    return prob2, int(band.sum()), flips, clear


def ba_numbers(samples, config: dict, stage1=None, stage2=None) -> dict:
    """{ba_problem_diff, ba_shortfall_pct, ba2_shortfall_pct} over the
    sampled BAs, and `ba_detail`, one entry a BA. `stage1` / `stage2`
    (functions of (problem, program's result in the reference's order) ->
    state) put something else in the program's place: the control and the
    faults."""
    diff, s1, s2, detail = 0, [], [], []
    for b in samples:
        ref, kfs, pts = reference_problem(b, config)
        parts = ref_ba.problem_faults(ref, kfs, pts, b["prob"], b["kfs"], b["pts"])
        diff += sum(parts.values())
        row = {"kf": b["kf"], "edges": len(ref["obs_kf"]),
               "problem_diff": {k: v for k, v in parts.items() if v}}
        detail.append(row)
        if len(ref["obs_kf"]) < 20:
            continue
        prog1 = in_reference_order(b["res1"], b["kfs"], b["pts"], ref, kfs, pts)
        ref1 = ref_ba.lm(ref, iterations=5)
        v = ba_shortfall(ref, stage1(ref, prog1) if stage1 else prog1, ref_out=ref1)
        row["s1"] = v
        if v is not None:
            s1.append(v)
        if b["res2"] is None:
            continue
        prob2, row["band"], row["band_flips"], row["clear_flips"] = second_stage(
            ref, kfs, pts, ref1, program_outliers(b))
        prog2 = in_reference_order(b["res2"], b["kfs"], b["pts"], ref, kfs, pts)
        ref2 = ref_ba.lm(prob2, iterations=10)
        v = ba_shortfall(prob2, stage2(prob2, prog1, prog2) if stage2 else prog2,
                         ref_out=ref2)
        c_in = ref_ba.cost(ref, ref["kf_R"], ref["kf_t"], ref["points"])
        row["s2"] = v
        row["gain2_share"] = ((ref_ba.cost(prob2, *ref1) - ref_ba.cost(prob2, *ref2))
                              / max(c_in - ref_ba.cost(ref, *ref1), 1e-300))
        if v is not None:
            s2.append(v)
    return {"ba_problem_diff": float(diff) if samples else None,
            "ba_shortfall_pct": max(s1) if s1 else None,
            "ba2_shortfall_pct": max(s2) if s2 else None, "ba_detail": detail}


def trajectory_number(completed: dict, truth) -> dict:
    """completed: frame id -> (state, centre or None, segment); truth(i) the
    true centre of frame i."""
    by_seg = {}
    for fid, (state, centre, seg) in completed.items():
        if state == "WORKING" and centre is not None:
            by_seg.setdefault(seg, []).append((fid, centre))
    num = den = 0.0
    n = 0
    for rows in by_seg.values():
        if len(rows) < 10:
            continue
        est = np.stack([c for _, c in rows])
        gt = np.stack([truth(f) for f, _ in rows])
        err = ref_traj.aligned_errors(est, gt)
        num += float((err ** 2).sum())
        den += float(((gt - gt.mean(0)) ** 2).sum())
        n += len(rows)
    if n == 0:
        return {"traj_err_pct": float("inf")}
    return {"traj_err_pct": 100.0 * np.sqrt(num / den)}


def decide(numbers: dict, limits: dict) -> tuple[bool, dict, list]:
    """(correct, {name: {value, limit}}, lines to print)."""
    table, lines, ok = {}, [], True
    for name, limit in limits.items():
        v = numbers.get(name)
        if v is None:
            lines.append(f"check {name}: nothing to compare in this run (limit {limit})")
            table[name] = {"value": None, "limit": limit}
            continue
        passed = bool(np.isfinite(v) and v <= limit)
        ok &= passed
        table[name] = {"value": float(v), "limit": limit}
        lines.append(f"check {name}: {float(v)!r} limit {limit!r} {'ok' if passed else 'FAILED'}")
    return ok, table, lines
