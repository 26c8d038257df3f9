"""The port's benchmark: one run of one cell.

    python3 -m slam_bench.run --workload <config>.<traffic> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json's `workloads` entry) names a configuration
(`configs/<config>.json`) and a traffic mix (`traffic/<traffic>.json`). Set-up
builds the system as its users call it, `Slam(cfg, vocab=<64k tree>)` on
cuda:0 with `Slam.warmup()`, and renders the stream from the seed. The window
then feeds frames in a closed loop for `--seconds`. With `--trace 0` the last
line of standard output carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from the program's spans and
counters over the window and from a `torch.profiler` trace of a fixed
stretch of calls (the mix's `trace_stretch`). Each run then decides
`correct` (check.py) and prints every number compared beside its limit.
`--control 1` also prints the control's and the planted faults' readings
(for setting the limits; the benchmark's own runs do not take it).
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from . import check  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
PORT = "orbslam_jpminipc_torch"
VOCAB = ROOT / PORT / "data" / "vocab_tree64k.npz"
# top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam_jpminipc_tpu")


def _env():
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def slam_kwargs(config: dict) -> dict:
    """SlamConfig's keywords from a configuration file: the settings file's
    keys, then the port's own (`port`)."""
    c = config
    kw = dict(
        width=int(c["Camera.width"]), height=int(c["Camera.height"]), fps=float(c["Camera.fps"]),
        fx=float(c["Camera.fx"]), fy=float(c["Camera.fy"]),
        cx=float(c["Camera.cx"]), cy=float(c["Camera.cy"]),
        k1=float(c["Camera.k1"]), k2=float(c["Camera.k2"]),
        p1=float(c["Camera.p1"]), p2=float(c["Camera.p2"]),
        n_features=int(c["ORBextractor.nFeatures"]),
        scale_factor=float(c["ORBextractor.scaleFactor"]),
        n_levels=int(c["ORBextractor.nLevels"]),
    )
    kw["fast_threshold"], kw["fast_min_threshold"] = check.fast_thresholds(c)
    if c.get("Camera.k3", 0.0):
        raise ValueError("the port reads no Camera.k3")
    port = {k: v for k, v in c.get("port", {}).items()
            if k not in ("loop_closing", "fast_min_threshold")}
    kw.update(port)
    return kw


def camera(config: dict) -> dict:
    c = config
    return {"width": c["Camera.width"], "height": c["Camera.height"], "fps": c["Camera.fps"],
            "fx": c["Camera.fx"], "fy": c["Camera.fy"], "cx": c["Camera.cx"], "cy": c["Camera.cy"]}


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


class Context:
    """A cell's files and the system under test, built once."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def setup(workload: str, device: str, bench: dict | None = None,
          config_over: dict | None = None, mix_over: dict | None = None,
          warmup: bool = True) -> Context:
    """The cell's configuration, mix and limits, and the system as its users
    build it: `Slam(cfg, vocab=<64k tree>)` with `Slam.warmup()`."""
    import torch

    from .traffic import load_mix

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    config.update(config_over or {})
    mix = load_mix(cell["traffic"])
    mix.update(mix_over or {})
    limits = check.load_limits(workload)

    from orbslam_jpminipc_torch.config import SlamConfig
    from orbslam_jpminipc_torch.pipeline.system import Slam
    from orbslam_jpminipc_torch.vocab.vocabulary import load_vocabulary

    marks = {"imports": time.monotonic() - T_START}
    dev = torch.device(device)
    cfg = SlamConfig(**slam_kwargs(config))
    vocab = load_vocabulary(str(VOCAB), device=dev)
    slam = Slam(cfg, vocab=vocab, enable_loop_closing=config["port"].get("loop_closing", True),
                device=dev)
    marks["system"] = time.monotonic() - T_START
    if warmup:
        slam.warmup()
    marks["warmup"] = time.monotonic() - T_START
    return Context(workload=workload, bench=bench, cell=cell, config=config, mix=mix,
                   limits=limits, dev=dev, slam=slam, vocab=vocab, marks=marks)


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str,
            control: bool = False, bench: dict | None = None, config_over: dict | None = None,
            max_frames: int | None = None, warmup: bool = True,
            mix_over: dict | None = None, every: dict | None = None) -> dict:
    """One run; returns the result object (the last line's keys). The
    keyword arguments after `control` serve the CPU tests' tiny runs."""
    ctx = setup(workload, device, bench, config_over, mix_over, warmup)
    return session_run(ctx, seed, seconds, trace, control=control, max_frames=max_frames,
                       every=every, free=True)


def session_run(ctx: Context, seed: int, seconds: float, trace: bool, control: bool = False,
                max_frames: int | None = None, every: dict | None = None,
                free: bool = True) -> dict:
    """One session of the built system from `seed`: the stream, the window,
    then the checks. With `free` the system is dropped before the checks."""
    import torch

    from . import session, trace as tr
    from .metrics import load as load_reader
    from .traffic import Stream

    bench, workload, config, mix, dev = ctx.bench, ctx.workload, ctx.config, ctx.mix, ctx.dev
    slam = ctx.slam
    marks = dict(ctx.marks)
    stream = Stream(mix, camera(config), seed, dev, frames=max_frames)
    rec = session.Recorder(slam, ranges=trace, seed=seed, every=every or check.EVERY)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.monotonic() - T_START
    marks["stream"] = setup_s
    marks["scene_s"], marks["render_s"] = stream.scene_s, stream.render_s

    stretch = None
    if trace:
        s = mix["trace_stretch"]
        stretch = (int(s["first"]), int(s["first"]) + int(s["calls"]) - 1)
    win = session.run_window(slam, rec, stream, seconds, stretch, max_frames=max_frames,
                             cuda=dev.type == "cuda")
    n = len(win.submitted)
    mem = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0

    # outputs kept for the checks; then the system's state is freed
    rec.finish()
    completed = dict(rec.completed)
    first_working = min((f for f, c in completed.items() if c[0] == "WORKING"), default=None)
    failed = win.failed_calls
    if first_working is not None:
        failed += sum(1 for f in range(first_working + 1, n)
                      if stream.clean(f) and completed.get(f, ("MISSING",))[0] != "WORKING")
    else:
        failed += sum(1 for f in range(n) if stream.clean(f))
    lost = sum(1 for f, c in completed.items() if c[0] == "LOST" and f < n)
    working = sum(1 for f, c in completed.items() if c[0] == "WORKING" and f < n)
    picks = check.sample_frames(completed, rec.frames, seed)
    feats = []
    for f in picks:
        fr = rec.frames[f].materialize()
        feats.append((stream.frame(f)[0], {k: np.array(getattr(fr, k))
                                           for k in ("level", "xy", "desc", "valid")}))
    steps = check.step_samples(rec, seed)
    relocs = check.reloc_samples(rec, seed)
    bas = check.ba_samples(rec, seed)
    poses = dict(rec.poses)
    counts = {"frames": n, "working": working, "lost": lost, "keyframes": rec.keyframes_in_window,
              "resets": rec.segment, "loops_closed": slam.n_loops_closed,
              "relocalizations": len(rec.relocs)}
    trace_summary = tr.reduce(win.prof) if win.prof is not None else None
    rec.detach()
    del rec, win.prof
    if free:
        ctx.slam = ctx.vocab = slam = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # correct: the plain references, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.monotonic()
    numbers = {}
    numbers.update(check.extraction_numbers(feats, config, dev))
    numbers.update(check.pose_numbers(steps, config, "step"))
    numbers.update(check.pose_numbers(relocs, config, "reloc"))
    numbers.update(check.ba_numbers(bas, config))
    numbers.update(check.trajectory_number(completed, stream.center))
    ok, table, lines = check.decide(numbers, ctx.limits)
    check_s = time.monotonic() - t_check
    control_out = None
    if control:
        control_out = controls(feats, steps, relocs, bas, completed, poses, stream, config, dev)
        for name, readings in control_out.items():
            verdict, _, _ = check.decide(dict(numbers, **readings), ctx.limits)
            shown = {k: (None if v is None else float(v)) for k, v in readings.items()}
            lines.append(f"control {name}: correct {verdict} {json.dumps(_finite(shown))}")

    result = {"correct": bool(ok), "attempted": n, "failed": int(failed)}
    lags = [win.done_at[f] - win.submitted[f] for f in range(n) if f in win.done_at]
    if not trace:
        e2e = {
            "frames_per_s": n / win.seconds,
            "call_ms_p95": percentile(win.call_s, 95) * 1e3,
            "pose_lag_p95_ms": percentile(lags, 95) * 1e3 if lags else float("inf"),
            "device_mem_gb": mem / 1e9,
            "setup_s": setup_s,
        }
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in bench["end_to_end"]
                             if "workloads" not in m or workload in m["workloads"]}
    else:
        out_spans, out_counts = session.outside_stretch(win.spans, counts, win.stretch_marks)
        stretch_calls = (trace_summary or {}).get("calls", 0)
        out_counts["frames"] = counts["frames"] - stretch_calls
        run = session.RunRecord(spans=out_spans, counts=out_counts, trace=trace_summary,
                                config=config)
        metrics = {}
        for m in bench["per_layer"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            v = load_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
    result["device"] = device_info(dev, mem, trace_summary if trace else None)
    if trace and trace_summary:
        result["breakdown"] = {"device_ops": trace_summary["device_ops"],
                               "idle_gaps": trace_summary["idle_gaps"]}
    # what the end-to-end metrics move with: the keyframes the busy gate let
    # in, the LOST frames and relocalizations, resets and loops closed
    result["counts"] = counts
    # for the reader of standard error: where set-up went, the window's
    # counts, and the middle of the distributions whose tails are metrics
    info = {"setup_s": setup_s, "setup_marks": marks, "window_s": win.seconds,
            "finish_s": win.finish_s, "check_s": check_s, "counts": counts,
            "failed_calls": win.failed_calls, "extract_frames": picks,
            "step_frames": [s["frame"] for s in steps],
            "reloc_frames": [r["frame"] for r in relocs], "ba_keyframes": [b["kf"] for b in bas],
            "ba_second_stages": sum(b["res2"] is not None for b in bas),
            "ba_detail": numbers["ba_detail"],
            "call_ms_p50_p90_p99": [percentile(win.call_s, q) * 1e3 for q in (50, 90, 99)]}
    if lags:
        info["lag_ms_p50_p90_p99"] = [percentile(lags, q) * 1e3 for q in (50, 90, 99)]
    info["total_s"] = time.monotonic() - T_START
    lines.insert(0, "run " + json.dumps(_finite(info)))
    if control_out is not None:
        result["_control"] = control_out
    result["_numbers"] = numbers
    result["checks"] = table
    result["_lines"] = lines
    return result


def controls(feats, steps, relocs, bas, completed, poses, stream, config, dev) -> dict:
    """The control (the references in the program's place, computed in
    bfloat16, the precision below the configuration's float32) and the
    planted faults, read on this run's own inputs: {name: {number: reading}}.
    Each is judged beside the run's other numbers."""
    import torch

    from .reference import ba as ref_ba

    bf = torch.bfloat16
    out = {}
    low = [(image, check.reference_features(image, len(prog["valid"]), config, dev, bf))
           for image, prog in feats]
    c = check.extraction_numbers(low, config, dev)
    c["step_pose_px"] = check.pose_numbers(
        steps, config, "step", poses=[check.reference_pose(s, config, bf)[0] for s in steps]
    )["step_pose_px"]
    c["reloc_pose_px"] = check.pose_numbers(
        relocs, config, "reloc", poses=[check.reference_pose(s, config, bf)[0] for s in relocs]
    )["reloc_pose_px"]
    lm_bf = lambda prob, _prog: ref_ba.lm(prob, iterations=5, dtype=bf)
    c["ba_shortfall_pct"] = check.ba_numbers(bas, config, stage1=lm_bf)["ba_shortfall_pct"]
    c["ba2_shortfall_pct"] = check.ba_numbers(
        bas, config, stage2=lambda prob, _p1, _p2: ref_ba.lm(prob, iterations=10, dtype=bf)
    )["ba2_shortfall_pct"]
    out["bf16"] = c

    # a stage that returns its state unchanged
    out["ba_unchanged"] = {
        "ba_shortfall_pct": check.ba_numbers(
            bas, config, stage1=lambda prob, _p: (prob["kf_R"], prob["kf_t"], prob["points"])
        )["ba_shortfall_pct"],
        "ba2_shortfall_pct": check.ba_numbers(
            bas, config, stage2=lambda _prob, p1, _p2: p1)["ba2_shortfall_pct"]}
    # every pose one frame late (the previous frame's reported): the step's
    # sampled frames and the trajectory
    late = [poses.get(s["frame"] - 1, (s["R"], s["t"])) for s in steps]
    late_c = {}
    for f, (state, centre, seg) in completed.items():
        prev = completed.get(f - 1)
        late_c[f] = (state, prev[1] if prev and prev[1] is not None else centre, seg)
    out["pose_late"] = dict(check.pose_numbers(steps, config, "step", poses=late),
                            **check.trajectory_number(late_c, stream.center))
    # the pose never updated after the first WORKING frame
    first, held_c, held_p = {}, None, None
    for f in sorted(completed):
        state, centre, seg = completed[f]
        if state == "WORKING" and centre is not None and held_c is None:
            held_c, held_p = centre, poses.get(f)
        first[f] = (state, held_c if held_c is not None else centre, seg)
    held = [held_p if held_p is not None else (s["R"], s["t"]) for s in steps]
    out["pose_unchanged"] = dict(check.pose_numbers(steps, config, "step", poses=held),
                                 **check.trajectory_number(first, stream.center))
    # each inlier bound to its neighbour's point: an answer altered where made
    roll = lambda s: dict(s, xw=np.roll(s["xw"], 1, 0), desc_m=np.roll(s["desc_m"], 1, 0))
    out["step_match_altered"] = check.pose_numbers([roll(s) for s in steps], config, "step")
    # relocalization returns the pose it was lost at (its state unchanged)
    lost_at = []
    for r in relocs:
        before = [f for f in poses if f < r["frame"] and completed.get(f, ("",))[0] == "WORKING"
                  and completed[f][2] == r["segment"]]
        lost_at.append(poses[max(before)] if before else (r["R"], r["t"]))
    out["reloc_unchanged"] = {"reloc_pose_px": check.pose_numbers(
        relocs, config, "reloc", poses=lost_at)["reloc_pose_px"]}
    out["reloc_match_altered"] = check.pose_numbers([roll(r) for r in relocs], config, "reloc")
    return out


def device_info(dev, mem: int, trace_summary) -> dict:
    import torch

    from . import peaks

    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(mem)}
        info.update(peaks.card())
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace_summary:
        info["busy_s"] = trace_summary["busy_s"]
        info["window_s"] = trace_summary["window_s"]
    return info


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _finite(x):
    """JSON has no infinity or NaN: such a reading is written as null."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not np.isfinite(x):
        return None
    return x


def emit(result: dict) -> None:
    lines = result.pop("_lines")
    result.pop("_control", None)
    result.pop("_numbers", None)
    print(json.dumps(_finite(result)), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                     control=bool(args.control), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"modules that the run may not load were loaded: {bad}", file=sys.stderr)
        return 4
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
