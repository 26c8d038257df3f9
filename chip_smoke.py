#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: the WORKING tracking step, and
the whole system (`Slam.process`) from the first frame.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):
  1. device      card name and power limit (nvidia-smi), torch and CUDA versions
  2. build       compile the FAST CUDA kernel from the checkout's sources
  3. kernel      the kernel vs its plain PyTorch version, torch.equal: one
                 level a launch (`fast_detect`) at the 8 pyramid-level shapes
                 of a 480x640 frame, thresholds 7 and 20, on random images,
                 the fixture's pyramid levels and a smooth ramp; all 8 levels
                 in one launch with the per-cell select (`fast_level_scores`)
                 on the fixture's pyramid, random levels and a frame with
                 weak and flat regions (both arms of the cell vote), against
                 the plain version and against 8 one-level launches. Then
                 times per frame (CUDA events, warm, median of 20 batches of
                 10; device time from torch.profiler): one launch, 8
                 one-level launches, the plain version; and the kernel's
                 bound from the level shapes
  4. slice       the fused step (FusedContext/FusedStep) on the card over the
                 fixture's frames from the JAX reference's recorded state,
                 checked against the reference's recorded outputs; the FAST
                 kernel must have run once per frame. Then one frame from
                 a perturbed seed pose, where the step must take its wide
                 recovery pass, against the reference's outputs there
  5. throughput  200 steps cycling the fixture, re-seeding the pose at each
                 wrap: p50/p95 ms per frame, frames/s, peak device memory
  6. breakdown   the step's layers timed alone at the step's shapes, and a
                 torch.profiler window over 9 steps (device busy share)
  7. system      `Slam(cfg, vocab=None, device="cuda")` at the shipping widths
                 over the 28 frames of the system fixture, from the first
                 frame (initialization, keyframes, triangulation, fusion,
                 local BA, culling), the reference's RANSAC minimal sets
                 injected, then `finish()`; held to the JAX reference's
                 recorded outcome (states, keyframe and point counts, camera
                 centres, keyframe ATE); the FAST kernel must run once on
                 each initialization frame and each fused frame. Reports ms
                 per `process` call (initialization / keyframe / other
                 frames), the tracer's stage summary, host reads per frame
                 and peak device memory. A second, untimed system over the
                 same frames counts host synchronisations per frame (CUDA
                 sync debug mode) and shows how far two runs on the card
                 agree.

The fixtures (orbslam_jpminipc_torch/data/track_fixture_xyz.npz and
slam_fixture_xyz.npz) carry real frames and the reference's state and
outputs; tools/make_torch_fixture.py and tools/make_torch_slam_fixture.py
write them. Details go to chiprun_out/chip_smoke.json. The last line of
standard output is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "track_fixture_xyz.npz")
SLAM_FIXTURE = os.path.join(REPO, "orbslam_jpminipc_torch", "data", "slam_fixture_xyz.npz")
LEVEL_SHAPES = [(480, 640), (400, 533), (333, 444), (278, 370),
                (231, 309), (193, 257), (161, 214), (134, 179)]
# parity with the reference's recorded outputs on the card: pose entries,
# share of features with the same binding, relative pass-2 inlier count
TOL_POSE = 1e-3
TOL_BIND = 0.95
TOL_INLIERS = 0.03
# the whole system against the reference's recorded outcome on the card
SYS_STATES_MIN = 27       # of 28 frames with the reference's state
SYS_KF_TOL = 2            # keyframes, absolute
SYS_POINTS_REL = 0.10     # map points, relative
SYS_CENTRE_TOL = 1e-2     # camera centre per frame (median depth is 1)
SYS_ATE_MARGIN = 5e-3     # keyframe ATE above the reference's
# the card's published peaks (NVIDIA H100 SXM data sheet) for the kernel's bound
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per pixel of the FAST score, nonmax and select in the cheapest
# exact form known, the one csrc/fast.cu ships: 2 x 40 three-input integer
# min/max for the 9-arcs of both polarities (16 + 16 + 5 + 3 each), 3 to turn
# a pixel into an integer key of the same order, 3 x 3 to turn the centre and
# the two arc results back, 2 subtractions of the centre, 1 negation, 1 max of
# the two, compare + select + -1 for the threshold, 8 max for the 3x3 nonmax,
# 7 compares and selects for the nonmax test, the border mask and the cell
# select. Counted at the card's float32 rate.
FAST_OPS_PER_PIXEL = 2 * 40 + 3 + 3 * 3 + 2 + 1 + 1 + 3 + 8 + 7
EDGE = 19                 # the extractor's border (EDGE_THRESHOLD)


def log(msg: str):
    print(msg, flush=True)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return smi


def phase_build(fast_cuda):
    t0 = time.perf_counter()
    fast_cuda.build()
    dt = time.perf_counter() - t0
    log(f"[build] {fast_cuda.library_path().name} in {dt:.2f} s")
    for line in fast_cuda.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    return dt


def _event_ms(torch, fn, n=20, batch=10, warm=5):
    """Median over n batches of the per-call time of `batch` back-to-back
    calls between two CUDA events (host launch cost included)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def _is_device_event(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _device_time_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0.0))


def _device_ms(torch, fn, n=10):
    """Device (kernel) time per call from torch.profiler, launch gaps excluded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_time_us(e) for e in prof.key_averages() if _is_device_event(e))
    return us / n / 1e3


def phase_kernel(torch, fast, fast_cuda, pyramid, fx):
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    levels = pyramid.build_pyramid(
        torch.as_tensor(fx["images"][0]).to(dev).float(), 8, 1.2)
    if [tuple(l.shape) for l in levels] != LEVEL_SHAPES:
        raise AssertionError(f"pyramid shapes {[tuple(l.shape) for l in levels]}")

    def plain(img, th, border):
        return fast.border_mask(fast.nonmax_3x3(fast.fast_score_map(img, th)), border)

    n_cmp, max_err = 0, 0.0
    for (h, w), lvl in zip(LEVEL_SHAPES, levels):
        ramp = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w).contiguous()
        cases = {
            "random_u8": torch.randint(0, 256, (h, w), generator=gen, device=dev).float(),
            "random_f32": torch.rand((h, w), generator=gen, device=dev) * 255.0,
            "pyramid": lvl.contiguous(),
            "ramp": ramp,
        }
        for name, img in cases.items():
            for th in (7.0, 20.0):
                for border in (0, 19):
                    got = fast_cuda.fast_detect(img, th, border)
                    ref = plain(img, th, border)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    max_err = max(max_err, err)
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            f"FAST kernel != plain at {(h, w)} {name} th={th} "
                            f"border={border}: max abs err {err}, "
                            f"{int((got != ref).sum())} pixels differ")
                    n_cmp += 1
        ramp_score = fast_cuda.fast_detect(ramp, 7.0, 0)
        if bool((ramp_score[5:-5, 5:-5] != 0).any()):
            raise AssertionError(f"corners on a smooth ramp at {(h, w)}")
    log(f"[kernel] {n_cmp} one-level comparisons torch.equal, max abs err {max_err}")

    per_level = []
    for (h, w), lvl in zip(LEVEL_SHAPES, levels):
        img = lvl.contiguous()
        kern = lambda: fast_cuda.fast_detect(img, 7.0, EDGE)
        ref = lambda: plain(img, 7.0, EDGE)
        row = {"shape": [h, w],
               "plain_ms": _event_ms(torch, ref, n=10, batch=5),
               "ms": _event_ms(torch, kern)}
        row["device_ms"] = _device_ms(torch, kern)
        row["plain_device_ms"] = _device_ms(torch, ref, n=5)
        per_level.append(row)
        log(f"[kernel] {h}x{w} alone: kernel {row['ms']:.4f} ms (device "
            f"{row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms (device "
            f"{row['plain_device_ms']:.4f})")

    # --- all levels in one launch, with the per-cell select ---------------
    def plain_levels(lv, fast_th, fast_min_th, border, cell=32):
        return [fast.cell_select(plain(l, fast_min_th, border), fast_th, cell) for l in lv]

    def mixed(h, w):
        # strong corners left, weak ones (between the thresholds) in the
        # middle, flat right: cells with and without a high corner
        img = torch.full((h, w), 128.0, device=dev)
        a, b = w // 3, 2 * w // 3
        img[:, :a] = torch.randint(0, 256, (h, a), generator=gen, device=dev).float()
        img[:, a:b] += torch.randint(-6, 7, (h, b - a), generator=gen, device=dev).float()
        return img

    level_sets = {
        "pyramid": [l.contiguous() for l in levels],
        "random": [torch.rand((h, w), generator=gen, device=dev) * 255.0 for h, w in LEVEL_SHAPES],
        "mixed": [mixed(h, w) for h, w in LEVEL_SHAPES],
    }
    n_multi, both_arms = 0, False
    for name, lv in level_sets.items():
        for fast_th, fast_min_th in ((20.0, 7.0), (7.0, 7.0)):
            ref = plain_levels(lv, fast_th, fast_min_th, EDGE)
            lo = [plain(l, fast_min_th, EDGE) for l in lv]
            n0 = fast_cuda.LAUNCHES
            got = fast_cuda.fast_level_scores(lv, fast_th, fast_min_th, EDGE, 32)
            if fast_cuda.LAUNCHES != n0 + 1:
                raise AssertionError("fast_level_scores did not launch exactly once")
            torch.cuda.synchronize()
            for k, (g, r) in enumerate(zip(got, ref)):
                err = float((g - r).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(g, r):
                    raise AssertionError(
                        f"one launch != plain on {name} level {k} ths "
                        f"{(fast_th, fast_min_th)}: max abs err {err}, "
                        f"{int((g != r).sum())} pixels differ")
            n_multi += 1
            single = [fast_cuda.fast_level_scores([l], fast_th, fast_min_th, EDGE, 32)[0]
                      for l in lv]
            other_cell = fast_cuda.fast_level_scores(lv, fast_th, fast_min_th, EDGE, 16)
            torch.cuda.synchronize()
            if not all(torch.equal(g, o) for g, o in zip(got, single)):
                raise AssertionError(f"one launch != 8 one-level launches on {name}")
            if not all(torch.equal(g, r) for g, r in zip(
                    other_cell, plain_levels(lv, fast_th, fast_min_th, EDGE, 16))):
                raise AssertionError(f"cell 16 != plain on {name}")
            if name == "mixed" and fast_th > fast_min_th:
                # the vote's two arms: low corners dropped from a cell
                # with a high corner, and kept in a cell without one
                dropped = any(bool(((l > 0) & (g == 0)).any()) for g, l in zip(got, lo))
                kept = any(bool(((l > 0) & (l + 1.0 <= fast_th) & (g > 0)).any())
                           for g, l in zip(got, lo))
                both_arms = dropped and kept
    if not both_arms:
        raise AssertionError("the cell vote did not take both arms on the mixed frame")
    log(f"[kernel] {n_multi} one-launch comparisons torch.equal, one launch == 8 launches, "
        f"cell 16 == plain, both arms of the vote taken")

    # --- times per frame, on the fixture's pyramid -------------------------
    lv = level_sets["pyramid"]
    one = lambda: fast_cuda.fast_level_scores(lv, 20.0, 7.0, EDGE, 32)
    eight = lambda: [fast_cuda.fast_level_scores([l], 20.0, 7.0, EDGE, 32) for l in lv]
    ref = lambda: plain_levels(lv, 20.0, 7.0, EDGE)
    frame = {
        "ms": _event_ms(torch, one),
        "device_ms": _device_ms(torch, one),
        "eight_launches_ms": _event_ms(torch, eight),
        "eight_launches_device_ms": _device_ms(torch, eight),
        "plain_ms": _event_ms(torch, ref, n=10, batch=5),
        "plain_device_ms": _device_ms(torch, ref, n=5),
    }
    frame.update(_fast_bound(lv))
    log(f"[kernel] per frame (8 levels, select included): one launch {frame['ms']:.4f} ms "
        f"(device {frame['device_ms']:.4f}), 8 one-level launches "
        f"{frame['eight_launches_ms']:.4f} ms (device {frame['eight_launches_device_ms']:.4f}), "
        f"plain {frame['plain_ms']:.4f} ms (device {frame['plain_device_ms']:.4f}); bound "
        f"{frame['bound_ms']:.5f} ms by {frame['bound_by']} ({frame['pixels']} pixels, "
        f"{frame['bytes']} bytes, {frame['operations']} operations)")
    return {"comparisons": n_cmp + n_multi, "max_abs_err": max_err, "frame": frame,
            "per_level": per_level}


def _fast_bound(levels):
    """The least time the card could take for one frame's score maps: each
    pixel read once and written once as float32 over the memory rate, or
    FAST_OPS_PER_PIXEL operations a pixel over the peak float32 rate,
    whichever is larger. The work does not depend on the data."""
    pixels = sum(l.numel() for l in levels)
    ops = pixels * FAST_OPS_PER_PIXEL
    n_bytes = pixels * 2 * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"pixels": pixels, "bytes": n_bytes, "operations": ops,
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _context(FusedContext, SlamConfig, fx):
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                     k1=0.0, k2=0.0, p1=0.0, p2=0.0, n_features=1000,
                     pipelined_tracking=False)
    ctx = FusedContext(cfg, device="cuda")
    ctx.set_slice(fx["slice_buf"])
    return ctx


def _seed(ctx, fx):
    vel = (fx["vel_R0"], fx["vel_t0"]) if bool(fx["has_vel0"]) else None
    ctx.set_pose(fx["R0"], fx["t0"], velocity=vel)


def phase_slice(torch, fast_cuda, FusedContext, SlamConfig, fx):
    ctx = _context(FusedContext, SlamConfig, fx)
    _seed(ctx, fx)
    images = [torch.as_tensor(im).cuda() for im in fx["images"]]
    K = len(images)
    torch.cuda.synchronize()
    fast_cuda.LAUNCHES = 0
    outs = []
    for k in range(K):
        out = ctx.track(images[k])
        outs.append(out)
    torch.cuda.synchronize()
    launches = fast_cuda.LAUNCHES
    rows = []
    for k, out in enumerate(outs):
        R, t = out.R.cpu().numpy(), out.t.cpu().numpy()
        bind = out.feat_bind.cpu().numpy()
        for name, a in (("R", R), ("t", t), ("xy_un", out.xy_un.cpu().numpy())):
            if not np.all(np.isfinite(a)):
                raise AssertionError(f"non-finite {name} at frame {k}")
        if (R.shape, t.shape, bind.shape, tuple(out.flags.shape)) != (
                (3, 3), (3,), (1000,), (fx["slice_buf"].shape[0],)):
            raise AssertionError(f"output shapes at frame {k}")
        n_inl2 = int(out.n_inl2)
        ref_inl2 = int(fx["out_stats"][k][0])
        row = {
            "frame": k,
            "dR": float(np.abs(R - fx["out_R"][k]).max()),
            "dt": float(np.abs(t - fx["out_t"][k]).max()),
            "bind_eq": float(np.mean(bind == fx["out_feat_bind"][k])),
            "flags_eq": float(np.mean(out.flags.cpu().numpy() == fx["out_flags"][k])),
            "desc_eq": float(np.mean(np.all(
                out.feats.desc.cpu().numpy() == fx["out_desc"][k], axis=1))),
            "stats": [n_inl2, int(out.n_inl1), int(out.n_match2), int(out.n_match1)],
            "ref_stats": fx["out_stats"][k].tolist(),
            "inl2_rel": abs(n_inl2 - ref_inl2) / max(ref_inl2, 1),
        }
        rows.append(row)
        log(f"[slice] frame {k}: dR {row['dR']:.3g} dt {row['dt']:.3g} "
            f"bind_eq {row['bind_eq']:.4f} desc_eq {row['desc_eq']:.4f} "
            f"stats {row['stats']} ref {row['ref_stats']}")
    worst = {
        "dR": max(r["dR"] for r in rows), "dt": max(r["dt"] for r in rows),
        "bind_eq": min(r["bind_eq"] for r in rows),
        "inl2_rel": max(r["inl2_rel"] for r in rows),
    }
    log(f"[slice] worst over {K} frames: {json.dumps(worst)}; FAST launches {launches}")
    if launches != K:
        raise AssertionError(f"FAST kernel launched {launches} times, expected {K} "
                             f"(one launch per frame)")
    if max(worst["dR"], worst["dt"]) > TOL_POSE:
        raise AssertionError(f"pose off the reference by {worst}")
    if worst["bind_eq"] < TOL_BIND or worst["inl2_rel"] > TOL_INLIERS:
        raise AssertionError(f"bindings off the reference: {worst}")
    recovery = _recovery_frame(torch, ctx, images[0], fx)
    return {"frames": K, "fast_launches": launches, "worst": worst, "rows": rows,
            "recovery": recovery}


def _recovery_frame(torch, ctx, image, fx):
    """One step from the system fixture's perturbed seed pose: pass 1 must
    collapse, the wide recovery pass run, and the result agree with the
    reference's outputs for that frame."""
    sf = dict(np.load(SLAM_FIXTURE))
    ctx.set_pose(sf["recovery_R0"], sf["recovery_t0"], velocity=(fx["vel_R0"], fx["vel_t0"]))
    inliers = []
    match_pass = ctx.step._match_pass

    def counting(*a, **k):
        r = match_pass(*a, **k)
        inliers.append(int(r.res.n_inliers))
        return r

    ctx.step._match_pass = counting
    try:
        out = ctx.track(image)
    finally:
        ctx.step._match_pass = match_pass
    stats = [int(out.n_inl2), int(out.n_inl1), int(out.n_match2), int(out.n_match1)]
    ref = sf["recovery_out_stats"].tolist()
    row = {
        "pass_inliers": inliers, "stats": stats, "ref_stats": ref,
        "dR": float(np.abs(out.R.cpu().numpy() - sf["recovery_out_R"]).max()),
        "dt": float(np.abs(out.t.cpu().numpy() - sf["recovery_out_t"]).max()),
        "bind_eq": float(np.mean(out.feat_bind.cpu().numpy() == sf["recovery_out_feat_bind"])),
    }
    log(f"[slice] recovery frame: {json.dumps(row)}")
    if len(inliers) != 3 or not inliers[0] < 20 <= inliers[1]:
        raise AssertionError(f"the recovery pass did not run as expected: {inliers}")
    if max(row["dR"], row["dt"]) > TOL_POSE or row["bind_eq"] < TOL_BIND:
        raise AssertionError(f"recovery frame off the reference: {row}")
    if abs(stats[0] - ref[0]) > TOL_INLIERS * ref[0]:
        raise AssertionError(f"recovery frame inliers off the reference: {row}")
    return row


def phase_throughput(torch, FusedContext, SlamConfig, fx, n_steps=200):
    ctx = _context(FusedContext, SlamConfig, fx)
    images = [torch.as_tensor(im).cuda() for im in fx["images"]]
    K = len(images)
    _seed(ctx, fx)
    for k in range(3):  # warm
        ctx.track(images[k])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    t_all = time.perf_counter()
    for i in range(n_steps):
        if i % K == 0:
            _seed(ctx, fx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.track(images[i % K])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated()
    res = {
        "steps": n_steps,
        "p50_ms": float(np.percentile(times, 50)),
        "p95_ms": float(np.percentile(times, 95)),
        "mean_ms": float(np.mean(times)),
        "fps": n_steps / wall,
        "peak_mem_bytes": int(peak),
    }
    log(f"[throughput] {json.dumps(res)}")
    return res


def phase_breakdown(torch, fx, FusedContext, SlamConfig):
    from orbslam_jpminipc_torch.ops import extractor, fast, matching, pyramid
    from orbslam_jpminipc_torch.solvers import pose_opt

    ctx = _context(FusedContext, SlamConfig, fx)
    _seed(ctx, fx)
    img = torch.as_tensor(fx["images"][0]).cuda().float()
    slc = ctx.slice
    feats = extractor.extract(img)
    levels = pyramid.build_pyramid(img, 8, 1.2)
    m = slc.desc.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    uv = torch.rand((m, 2), generator=gen, device="cuda") * torch.tensor(
        [640.0, 480.0], device="cuda")
    pred = torch.randint(0, 8, (m,), generator=gen, device="cuda", dtype=torch.int32)
    sf = ctx.step.scale_factors
    xw = slc.xyz[:1000]
    valid = torch.ones(1000, dtype=torch.bool, device="cuda")

    def host_ms(fn, n=20, warm=3):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    parts = {
        "pyramid": host_ms(lambda: pyramid.build_pyramid(img, 8, 1.2)),
        "fast_8_levels": host_ms(lambda: fast.level_scores(levels, 20.0, 7.0, EDGE, 32)),
        "extract": host_ms(lambda: extractor.extract(img)),
        "search_by_projection_4096x1000": host_ms(lambda: matching.search_by_projection(
            slc.desc, uv, pred, slc.max_dist > 0, feats.desc, feats.xy, feats.level,
            feats.valid, sf, 4.0, level_window=(-1, 1))),
        "optimize_pose_4_rounds_1000": host_ms(lambda: pose_opt.optimize_pose(
            ctx.R, ctx.t, xw, feats.xy, torch.ones(1000, device="cuda"), valid,
            ctx.step.K4)),
    }
    log(f"[breakdown] ms (host clock, synchronised): {json.dumps(parts)}")

    images = [torch.as_tensor(im).cuda() for im in fx["images"]]
    from torch.profiler import ProfilerActivity, profile

    _seed(ctx, fx)
    ctx.track(images[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(1, 1 + min(10, len(images) - 1)):
            ctx.track(images[k])
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events if _is_device_event(e)]
    dev_us = sum(_device_time_us(e) for e in kernels)
    top = sorted(kernels, key=_device_time_us, reverse=True)[:12]
    n_steps = min(10, len(images) - 1)
    prof_res = {
        "steps": n_steps,
        "wall_us_profiled": wall_us,
        "device_us": dev_us,
        "device_ms_per_step": dev_us / n_steps / 1e3,
        "kernels_per_step": sum(e.count for e in kernels) / n_steps,
        "top_kernels": [
            {"name": e.key, "device_us": _device_time_us(e), "count": e.count}
            for e in top],
    }
    log(f"[breakdown] profiler: {prof_res['device_ms_per_step']:.2f} ms of "
        f"kernel time and {prof_res['kernels_per_step']:.0f} kernels per step "
        f"(wall under the profiler {wall_us / 1e3:.1f} ms for {n_steps} steps)")
    for e in prof_res["top_kernels"][:8]:
        log(f"[breakdown]   {e['device_us'] / 1e3:9.3f} ms x{e['count']:5d}  {e['name'][:90]}")
    return {"layers_ms": parts, "profile": prof_res}


def _percentiles(xs, unit="_ms"):
    if not xs:
        return None
    return {"n": len(xs), f"p50{unit}": float(np.percentile(xs, 50)),
            f"p95{unit}": float(np.percentile(xs, 95)), f"mean{unit}": float(np.mean(xs))}


def _centre(P):
    return -P[:3, :3].T @ P[:3, 3]


def _kf_ate(slam, sf):
    """Sim3-aligned ATE of the keyframe trajectory against ground truth."""
    from orbslam_jpminipc_torch.io.trajectory import ate_rmse

    index = {round(float(ts), 6): i for i, ts in enumerate(sf["timestamps"])}
    kft = slam.keyframe_trajectory()
    est = np.stack([-R.T @ t for _, R, t in kft]).astype(np.float64)
    gi = [index[round(ts, 6)] for ts, _, _ in kft]
    gt = np.stack([-sf["gt_R"][i].T @ sf["gt_t"][i] for i in gi]).astype(np.float64)
    return ate_rmse(est, gt)


def phase_system(torch, fast_cuda, smi):
    import warnings

    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.frontend.tracking import TrackState
    from orbslam_jpminipc_torch.pipeline.system import Slam
    from orbslam_jpminipc_torch.utils import host
    from orbslam_jpminipc_torch.utils.tracing import get_tracer

    sf = dict(np.load(SLAM_FIXTURE))
    meta = json.loads(str(sf["meta"]))
    cfg = SlamConfig(**meta["config"])
    images = [torch.as_tensor(im).cuda() for im in sf["images"]]
    n = len(images)

    def make():
        slam = Slam(cfg, vocab=None, device="cuda")
        sets = iter(torch.as_tensor(x).cuda() for x in sf["init_sets"])
        slam.tracker.sampler = lambda mask, n_hyp: next(sets)
        kf_events = []
        process = slam.mapper.process
        slam.mapper.process = lambda frame: (kf_events.append(frame.frame_id), process(frame))[1]
        return slam, kf_events

    # warm-up on a separate system (library handles, allocator, first launches)
    slam, _ = make()
    for i in range(4):
        slam.process(images[i], float(sf["timestamps"][i]))
    torch.cuda.synchronize()
    del slam

    def drive(slam, kf_events, count_syncs):
        """Feed the frames through `Slam.process`, one synchronised call
        each. With `count_syncs` every host synchronisation is recorded
        (CUDA sync debug mode), which slows the calls: that pass is not
        timed."""
        rows = []
        for i in range(n):
            was = slam.tracker.state
            fused = slam.tracker.fused_usable(slam.frame_count)
            reads0, launches0, kf0 = host.READS, fast_cuda.LAUNCHES, len(kf_events)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.synchronize()
                if count_syncs:
                    torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    state, frame = slam.process(images[i], float(sf["timestamps"][i]))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            syncs = sum("synchroniz" in str(w.message) for w in caught)
            pose = np.full((3, 4), np.nan, np.float32)
            if frame is not None and frame.R is not None:
                pose[:, :3], pose[:, 3] = frame.R, frame.t
            ref = sf["poses"][i]
            both = np.isfinite(pose).all() and np.isfinite(ref).all()
            kind = ("init" if was != TrackState.WORKING
                    else "keyframe" if len(kf_events) > kf0 else "other")
            rows.append({
                "frame": i, "kind": kind, "ms": ms, "state": state.value,
                "ref_state": int(sf["states"][i]), "n_inliers": slam.tracker.n_inliers,
                "ref_n_inliers": int(sf["n_inliers"][i]),
                "n_keyframes": slam.n_keyframes, "n_points": slam.n_points,
                "centre": _centre(pose).tolist() if np.isfinite(pose).all() else None,
                "dcentre": float(np.abs(_centre(pose) - _centre(ref)).max()) if both else None,
                "has_pose": bool(np.isfinite(pose).all()), "ref_has_pose": bool(np.isfinite(ref).all()),
                "fetches": host.READS - reads0, "syncs": syncs if count_syncs else None,
                "fast_launches": fast_cuda.LAUNCHES - launches0, "fused": fused,
            })
        slam.finish()
        torch.cuda.synchronize()
        return rows

    # the main path: timed, with the kernel's launch count from 0
    slam, kf_events = make()
    tracer = get_tracer()
    tracer.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fast_cuda.LAUNCHES = 0
    rows = drive(slam, kf_events, count_syncs=False)
    launches = fast_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    stages = tracer.summary()
    for r in rows:
        log(f"[system] frame {r['frame']} {r['kind']}: {TrackState(r['state']).name} (ref "
            f"{TrackState(r['ref_state']).name}) {r['ms']:.1f} ms, inl {r['n_inliers']} "
            f"(ref {r['ref_n_inliers']}), kf {r['n_keyframes']}, pts {r['n_points']}, "
            f"dcentre {r['dcentre']}, fetches {r['fetches']}, FAST {r['fast_launches']}")

    # a second, untimed system over the same frames counts the host
    # synchronisations per frame
    slam2, kf_events2 = make()
    rows2 = drive(slam2, kf_events2, count_syncs=True)
    del slam2
    for r, r2 in zip(rows, rows2):
        r["syncs"] = r2["syncs"]
    rerun = {
        "states_equal": sum(a["state"] == b["state"] for a, b in zip(rows, rows2)),
        "max_dcentre": max((float(np.abs(np.subtract(a["centre"], b["centre"])).max())
                            for a, b in zip(rows, rows2)
                            if a["centre"] is not None and b["centre"] is not None),
                           default=None),
    }

    ate = _kf_ate(slam, sf)
    ref_ate = float(sf["kf_ate"])
    n_kf, ref_kf = slam.n_keyframes, int(sf["n_keyframes"])
    n_pts, ref_pts = slam.n_points, int(sf["n_points"])
    states_eq = sum(r["state"] == r["ref_state"] for r in rows)
    pose_mismatch = [r["frame"] for r in rows if r["has_pose"] != r["ref_has_pose"]]
    dc = [r["dcentre"] for r in rows if r["dcentre"] is not None]
    groups = {k: _percentiles([r["ms"] for r in rows if r["kind"] == k])
              for k in ("init", "keyframe", "other")}
    res = {
        "card": smi, "frames": n, "states_equal": states_eq,
        "n_keyframes": n_kf, "ref_n_keyframes": ref_kf,
        "n_points": n_pts, "ref_n_points": ref_pts,
        "max_dcentre": max(dc) if dc else None, "kf_ate": ate, "ref_kf_ate": ref_ate,
        "ms_per_frame": groups,
        "syncs_per_frame": _percentiles([r["syncs"] for r in rows], unit=""),
        "fetches_per_frame": _percentiles([r["fetches"] for r in rows], unit=""),
        "fast_launches": launches, "peak_mem_bytes": int(peak),
        "stages": stages, "rerun_vs_main": rerun, "rows": rows,
    }
    for k, g in groups.items():
        log(f"[system] {smi}: {k} frames ms per process: {json.dumps(g)}")
    log(f"[system] {smi}: host synchronisations per frame (sync debug mode, untimed "
        f"second run) "
        f"{json.dumps(res['syncs_per_frame'])}; batched reads per frame "
        f"{json.dumps(res['fetches_per_frame'])}")
    log(f"[system] {smi}: peak device memory {peak} bytes")
    log(f"[system] {smi}: stage summary {json.dumps(res['stages'])}")
    log(f"[system] outcome: states equal {states_eq}/{n}, keyframes {n_kf} (ref {ref_kf}), "
        f"points {n_pts} (ref {ref_pts}), max centre diff {res['max_dcentre']}, "
        f"kf ATE {ate:.6f} (ref {ref_ate:.6f}), FAST launches {launches}")
    log(f"[system] second run vs the first: states equal {rerun['states_equal']}/{n}, "
        f"max centre diff {rerun['max_dcentre']}")

    if states_eq < SYS_STATES_MIN:
        raise AssertionError(f"states equal on only {states_eq}/{n} frames")
    if pose_mismatch:
        raise AssertionError(f"pose present/absent differs on frames {pose_mismatch}")
    if abs(n_kf - ref_kf) > SYS_KF_TOL:
        raise AssertionError(f"{n_kf} keyframes, reference {ref_kf}")
    if abs(n_pts - ref_pts) > SYS_POINTS_REL * ref_pts:
        raise AssertionError(f"{n_pts} points, reference {ref_pts}")
    if not dc or max(dc) > SYS_CENTRE_TOL:
        raise AssertionError(f"camera centres off the reference by {res['max_dcentre']}")
    if not np.isfinite(ate) or ate > ref_ate + SYS_ATE_MARGIN:
        raise AssertionError(f"keyframe ATE {ate} above the reference's {ref_ate} + {SYS_ATE_MARGIN}")
    # both frame paths extract through the kernel: build_frame on the
    # initialization frames, the fused step on every tracked frame
    no_fast = [r["frame"] for r in rows
               if (r["kind"] == "init" or r["fused"]) and r["fast_launches"] != 1]
    if no_fast or not any(r["fused"] for r in rows):
        raise AssertionError(f"FAST kernel not launched exactly once on frames {no_fast}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    sys.path.insert(0, REPO)
    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.frontend.fused_track import FusedContext
    from orbslam_jpminipc_torch.ops import fast, fast_cuda, pyramid

    fx = dict(np.load(FIXTURE))
    report = {"device": phase_device(torch)}
    report["build_s"] = phase_build(fast_cuda)
    report["kernel"] = phase_kernel(torch, fast, fast_cuda, pyramid, fx)
    report["slice"] = phase_slice(torch, fast_cuda, FusedContext, SlamConfig, fx)
    report["throughput"] = phase_throughput(torch, FusedContext, SlamConfig, fx)
    report["breakdown"] = phase_breakdown(torch, fx, FusedContext, SlamConfig)
    busy = (report["breakdown"]["profile"]["device_ms_per_step"]
            / report["throughput"]["mean_ms"])
    report["device_busy_share"] = busy
    log(f"[breakdown] device busy share: {busy:.3f} (profiled kernel time per "
        f"step over the unprofiled mean step time)")
    report["system"] = phase_system(torch, fast_cuda, report["device"])

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    k = report["kernel"]["frame"]
    log(json.dumps({"kernels": [{
        "name": "fast9_score_nonmax3x3",
        "route": "cuda",
        "source": "orbslam_jpminipc_torch/csrc/fast.cu",
        "replaces": "orbslam_jpminipc_tpu/ops/fast_pallas.py:82",
        # the system phase's count: Slam.process over the 28 frames
        "launches": report["system"]["fast_launches"],
        "launches_slice_phase": report["slice"]["fast_launches"],
        "max_abs_err": report["kernel"]["max_abs_err"],
        # per frame: one launch over the 8 pyramid levels, the select included
        "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        # no single PyTorch call computes this function
        "library_ms": None,
        "device_ms": k["device_ms"], "plain_device_ms": k["plain_device_ms"],
        "eight_launches_ms": k["eight_launches_ms"],
        "eight_launches_device_ms": k["eight_launches_device_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
