"""Local mapping's host work per keyframe inserted: the `mapping` and
`mapping_hard_drain` spans less the time they waited for the card
(`waited.mapping`, `waited.mapping_hard_drain`), over the window (the
profiled stretch left out), divided by the keyframes inserted there. Read
only where the tracer ran in detail mode (its `self.*` totals are there;
no `BENCHMARK.json` entry reads it yet)."""
NAME = "mapping_self_ms_per_kf"
UNIT = "ms"
LAYER = "local mapping (pipeline/local_mapping.py, map/)"
SOURCE = "program_span"
MOVES = "frames_per_s"

SPANS = ("mapping", "mapping_hard_drain")


def read(run):
    kf = run.counts.get("keyframes", 0)
    if not kf or not any(f"self.{n}" in run.spans for n in SPANS):
        return None
    total = sum(run.spans.get(n, (0.0, 0))[0] - run.spans.get(f"waited.{n}", (0.0, 0))[0]
                for n in SPANS)
    return total / kf * 1e3
