"""Keyframes inserted per 100 frames submitted in the window, the
profiled stretch left out (the busy gate, `Slam._mapper_busy`, rations
them)."""
NAME = "keyframes_per_100_frames"
UNIT = "kf/100frames"
LAYER = "local mapping's cadence (the busy gate, Slam._mapper_busy)"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(run):
    n, kf = run.counts.get("frames", 0), run.counts.get("keyframes", 0)
    return 100.0 * kf / n if n and kf else None
