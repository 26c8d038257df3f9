"""Device time of one WORKING step: the kernels and copies launched inside
`Tracker.fused_dispatch` (the `bench.fused_dispatch` range), per dispatch,
over the profiled stretch."""
NAME = "step_device_ms"
UNIT = "ms"
LAYER = "tracking step (frontend/fused_track.py via frontend/tracking.py)"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(run):
    r = (run.trace or {}).get("ranges", {}).get("bench.fused_dispatch")
    if not r or not r["count"] or not r["device_s"]:
        return None
    return r["device_s"] / r["count"] * 1e3
