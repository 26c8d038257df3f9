"""How long the host waited for the card per call: the program's timed
device reads (`wait.*`, `utils/host.py`: `fetch` and a queued read taken
before it landed) over the window, the profiled stretch left out, divided
by the calls made there. The reads are timed in the tracer's detail mode
only (no `BENCHMARK.json` entry reads it yet)."""
NAME = "host_wait_ms_per_call"
UNIT = "ms"
LAYER = "entry point (pipeline/system.py)"
SOURCE = "program_span"
MOVES = "call_ms_p95"


def read(run):
    frames = run.counts.get("frames", 0)
    waits = [t for k, (t, _) in run.spans.items() if k.startswith("wait.")]
    return sum(waits) / frames * 1e3 if frames and waits else None
