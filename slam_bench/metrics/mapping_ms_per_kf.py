"""Host time of local mapping per keyframe inserted: the program's
`mapping` and `mapping_hard_drain` spans over the window (the profiled
stretch left out), divided by the keyframes inserted there."""
NAME = "mapping_ms_per_kf"
UNIT = "ms"
LAYER = "local mapping (pipeline/local_mapping.py, map/)"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(run):
    kf = run.counts.get("keyframes", 0)
    if not kf:
        return None
    total = sum(run.spans.get(n, (0.0, 0))[0] for n in ("mapping", "mapping_hard_drain"))
    return total / kf * 1e3 if total else None
