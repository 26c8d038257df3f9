"""One traced benchmark session of a cell, read from the port's own tracer
in detail mode (no profiler needed for what it reports here):

    python3 tools/torch_trace_window.py --workload tum_fr1_vga30.handheld \
        --seed 7 --seconds 51 --out build/trace_handheld_7.json \
        [--sync-seconds 15] [--export build/trace_handheld_7.chrome.json]

Builds the cell's system as `slam_bench.run` does, turns the tracer's
detail mode on, runs one `--trace 1` session (`run.session_run`) and prints
its result line. It reads the detail-mode metrics (`step_event_ms`,
`event_idle_pct`, `host_wait_ms_per_call`, `mapping_self_ms_per_kf`,
`slam_bench/metrics/`) from the same record as the line's per-layer
metrics. Then it writes the tracer's Chrome trace (`StageTracer.export`)
and reads it back for:

* the books of every call: the self times of the spans in it against the
  `call` span, and their own waits;
* the card's intervals: whether any two overlap on the stream;
* the calls at or above the 95th percentile of the call spans (the profiled
  stretch left out): which spans' self time and waits fill them, against
  the calls below it;
* the unprofiled idle seconds by host span (`idle.*`, the stretch left out)
  beside the profiled stretch's `breakdown`, and inside the stretch the
  events' `device.step` beside `bench.fused_dispatch`'s profiled device time;
* the captures made in the window, the launches whose interval was still
  pending at each stretch mark, and the drift of the card's clock against
  the host's since the window's anchor.

With `--sync-seconds`, a second session of the same system (restarted, the
next seed) runs under `torch.cuda.set_sync_debug_mode("warn")` for that many
seconds, untraced, and the implicit synchronisations of its window are
counted by source line. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DETAIL_METRICS = ("step_event_ms", "event_idle_pct", "host_wait_ms_per_call",
                  "mapping_self_ms_per_kf")
sys.path.insert(0, str(ROOT))


def _pct(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None


def books(trace: dict, stretch: tuple[int, int]) -> dict:
    """The span tree and the card's intervals of one exported trace."""
    ev = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    spans = [e for e in ev if e["tid"] == 1]
    card = sorted((e for e in ev if e["tid"] == 2), key=lambda e: e["ts"])
    calls = sorted((e for e in spans if e["name"] == "call"), key=lambda e: e["ts"])
    index = {c["args"]["id"]: i for i, c in enumerate(calls)}
    by_call = collections.defaultdict(list)
    for e in spans:
        if e["args"]["call"] in index:
            by_call[e["args"]["call"]].append(e)
    worst = 0.0
    for c in calls:
        selfs = sum(e["args"]["self_us"] for e in by_call[c["args"]["id"]])
        worst = max(worst, abs(selfs - c["dur"]) / max(c["dur"], 1e-9))
    overlaps, worst_overlap = 0, 0.0
    for a, b in zip(card, card[1:]):
        if b["ts"] < a["ts"] + a["dur"]:
            overlaps += 1
            worst_overlap = max(worst_overlap, a["ts"] + a["dur"] - b["ts"])
    outside = [c for i, c in enumerate(calls) if not stretch[0] <= i <= stretch[1]]
    p95 = _pct([c["dur"] for c in outside], 95)

    def fill(group):
        """Mean ms a call of `group` spends in each span's self time (less
        its waits), in its waits, and the call's mean."""
        host, wait = collections.Counter(), collections.Counter()
        for c in group:
            for e in by_call[c["args"]["id"]]:
                host[e["name"]] += (e["args"]["self_us"] - e["args"]["wait_us"]) / 1e3
                wait[e["name"]] += e["args"]["wait_us"] / 1e3
        n = max(len(group), 1)
        return {"calls": len(group),
                "call_ms_mean": sum(c["dur"] for c in group) / 1e3 / n,
                "host_ms": {k: v / n for k, v in host.most_common(12)},
                "wait_ms": {k: v / n for k, v in wait.most_common(8) if v > 0}}

    tail = [c for c in outside if c["dur"] >= p95]
    # spans launched by the tail's calls on the card
    span_call = {e["args"]["id"]: e["args"]["call"] for e in spans}
    tail_ids = {c["args"]["id"] for c in tail}
    tail_dev = collections.Counter()
    for e in card:
        if span_call.get(e["args"]["span"]) in tail_ids:
            tail_dev[e["name"]] += e["dur"] / 1e3
    between = [calls[i + 1]["ts"] - (calls[i]["ts"] + calls[i]["dur"])
               for i in range(len(calls) - 1) if not stretch[0] - 1 <= i <= stretch[1]]
    return {
        "calls": len(calls), "spans": len(spans), "intervals": len(card),
        "between_calls_ms_p50_p95": [_pct(between, q) / 1e3 for q in (50, 95)] if between else None,
        "spans_per_call": len(spans) / max(len(calls), 1),
        "books_worst_rel_err": worst, "overlaps": overlaps, "worst_overlap_us": worst_overlap,
        "call_ms_p95_spans": p95 / 1e3 if p95 is not None else None,
        "tail": fill(tail), "body": fill([c for c in outside if c["dur"] < p95]),
        "tail_device_ms_per_call": {k: v / max(len(tail), 1)
                                    for k, v in tail_dev.most_common(8)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--export", default=None, help="keep the Chrome trace here")
    ap.add_argument("--sync-seconds", type=float, default=0.0)
    args = ap.parse_args(argv)

    from slam_bench import run, session
    from slam_bench.metrics import load as load_reader

    run._env()
    import torch

    from orbslam_jpminipc_torch.utils.tracing import get_tracer

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    ctx = run.setup(args.workload, "cuda:0")
    slam, tracer = ctx.slam, get_tracer()
    s = ctx.mix["trace_stretch"]
    stretch = (int(s["first"]), int(s["first"]) + int(s["calls"]) - 1)
    seen = {"captures": [], "pending_at_marks": [], "outside": None}
    tracer.log = lambda event, **f: (seen["captures"].append(f["program"])
                                     if event == "capture" else None)
    window, outside, record = session.run_window, session.outside_stretch, session.RunRecord

    def run_window(slam_, rec, stream, seconds, *a, **k):
        process, calls = slam_.process, [0]

        def counted(img, ts):
            if calls[0] in (stretch[0], stretch[1] + 1):
                seen["pending_at_marks"].append(tracer.pending)
            calls[0] += 1
            return process(img, ts)

        slam_.process = counted
        try:
            win = window(slam_, rec, stream, seconds, *a, **k)
        finally:
            del slam_.process
        # since the anchor the first span after the profiled stretch took
        seen["drift_over_s"] = (time.perf_counter_ns() - tracer.clock.anchor_ns) * 1e-9
        seen["drift_ns"] = tracer.clock.drift_ns()
        return win

    def outside_stretch(spans, counts, marks):
        seen["outside"] = outside(spans, counts, marks)
        if len(marks) == 2:
            (a, _, _), (b, _, _) = marks
            seen["stretch_step"] = [b.get("device.step", (0.0, 0))[i]
                                    - a.get("device.step", (0.0, 0))[i] for i in (0, 1)]
        return seen["outside"]

    def run_record(**k):
        seen["record"] = record(**k)
        return seen["record"]

    session.run_window, session.outside_stretch = run_window, outside_stretch
    session.RunRecord = run_record
    tracer.detail = True
    try:
        res = run.session_run(ctx, args.seed, args.seconds, True, free=False)
    finally:
        tracer.detail = False
        session.run_window, session.outside_stretch = window, outside
        session.RunRecord = record
    detail = {n: load_reader(n).read(seen["record"]) for n in DETAIL_METRICS}
    line = dict({k: v for k, v in res.items() if not k.startswith("_")}, detail_metrics=detail)
    print(json.dumps(run._finite(line)), flush=True)

    path = args.export or str(ROOT / "build" / f"trace_{args.workload}_{args.seed}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tracer.export(path)
    with open(path) as f:
        out = books(json.load(f), stretch)
    spans = seen["outside"][0]
    idle = {k[5:]: v[0] for k, v in spans.items() if k.startswith("idle.")}
    r = (res.get("breakdown") or {})
    prof_step = res["metrics"].get("step_device_ms", {}).get("value")
    ev_total, ev_n = seen.get("stretch_step", [0.0, 0])
    out.update({
        "workload": args.workload, "seed": args.seed, "card": torch.cuda.get_device_name(0),
        "power_limit": res["device"].get("power_limit_w"),
        "metrics": dict({k: v["value"] for k, v in res["metrics"].items()}, **detail),
        "correct": res["correct"], "counts": res["counts"],
        "idle_s_by_span": dict(sorted(idle.items(), key=lambda x: -x[1])),
        "busy_s": spans.get("device.busy", (0.0, 0))[0],
        "profiled_idle_gaps": r.get("idle_gaps"),
        "stretch": {"event_step_ms": ev_total / ev_n * 1e3 if ev_n else None,
                    "event_steps": ev_n, "profiled_step_ms": prof_step},
        "captures_in_window": collections.Counter(seen["captures"]),
        "pending_at_marks": seen["pending_at_marks"],
        "clock_drift_us": seen["drift_ns"] / 1e3, "drift_over_s": seen["drift_over_s"],
        "records_kept": len(tracer.records), "ring": tracer.records.maxlen,
        "reads": tracer.counts["reads"],
    })

    if args.sync_seconds > 0:
        slam._restart()
        caught_all = []

        def synced_window(slam_, rec, stream, seconds, *a, **k):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return window(slam_, rec, stream, seconds, *a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    caught_all.extend(caught)

        session.run_window = synced_window
        sres = run.session_run(ctx, args.seed + 1, args.sync_seconds, False, free=False)
        session.run_window = window
        sites = collections.Counter(
            f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught_all
            if "synchroniz" in str(w.message))
        frames = sres["attempted"]
        out["syncs"] = {"frames": frames, "per_frame": sum(sites.values()) / max(frames, 1),
                        "by_line": dict(sites.most_common())}
    with open(args.out, "w") as f:
        json.dump(run._finite(out), f, indent=1, default=int)
    print(json.dumps(run._finite(out), default=int), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
