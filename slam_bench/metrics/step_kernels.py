"""Kernels the device ran per WORKING step (launched inside
`Tracker.fused_dispatch`), over the profiled stretch."""
NAME = "step_kernels"
UNIT = "kernels"
LAYER = "tracking step (frontend/fused_track.py via frontend/tracking.py)"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(run):
    r = (run.trace or {}).get("ranges", {}).get("bench.fused_dispatch")
    if not r or not r["count"] or not r["kernels"]:
        return None
    return r["kernels"] / r["count"]
