"""The FAST kernel's share of its roofline: the least time one frame's
launch could take (`peaks.fast_bound` of the configuration's level shapes,
against the published H100 peaks) over its mean time in the trace."""
from .. import peaks

NAME = "fast_roofline_pct"
UNIT = "%"
LAYER = "extraction kernel (ops/fast_cuda.py, csrc/fast.cu)"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(run):
    t = run.trace or {}
    if not t.get("fast_launches") or not t.get("fast_s"):
        return None
    c = run.config
    shapes = peaks.level_shapes(c["Camera.height"], c["Camera.width"],
                                c["ORBextractor.nLevels"], c["ORBextractor.scaleFactor"])
    return 100.0 * peaks.fast_bound(shapes)["bound_s"] / (t["fast_s"] / t["fast_launches"])
