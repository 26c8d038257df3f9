"""The card's idle share, unprofiled: the gaps between the program's device
intervals (`idle.*`, each put down to the host span open at its middle)
over the busy union (`device.busy`) and the gaps, per 100. Read from the
tracer's detail mode over the window, the profiled stretch left out (no
`BENCHMARK.json` entry reads it yet)."""
NAME = "event_idle_pct"
UNIT = "%"
LAYER = "device (H100)"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(run):
    busy = run.spans.get("device.busy", (0.0, 0))[0]
    idle = sum(t for k, (t, _) in run.spans.items() if k.startswith("idle."))
    return 100.0 * idle / (busy + idle) if busy else None
