"""The WORKING step's span on the card, unprofiled: the program's
`device.step` total over its count, each a pair of CUDA timing events
around the step chain's one launch (`Chain.launch` in the tracer's detail
mode), the bubbles between the chain's kernels included and no CUPTI
attached. Over the window, the profiled stretch left out. Reads a run in
which the tracer's detail mode was on (`tools/torch_trace_window.py`
turns it on; no `BENCHMARK.json` entry reads it yet)."""
NAME = "step_event_ms"
UNIT = "ms"
LAYER = "tracking step (frontend/fused_track.py via frontend/tracking.py)"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(run):
    total, n = run.spans.get("device.step", (0.0, 0))
    return total / n * 1e3 if n and total else None
