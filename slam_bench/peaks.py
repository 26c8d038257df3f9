"""The card's published peaks and the operations and bytes of the kernels
the benchmark sets against them.

NVIDIA H100 SXM data sheet, dense rates: 3.35 TB/s of HBM3, 67 TFLOP/s in
float32 outside the tensor cores. They assume the full 700 W power limit;
`card()` reads the limit the card runs at, and every roofline share is
reported with it."""
from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# operations per pixel of the FAST score, non-maximum suppression and the
# per-cell select in the cheapest exact form known: 2 x 40 three-input
# integer min/max for the 9-arcs of both polarities, 3 to turn a pixel into
# an integer key of the same order, 3 x 3 to turn the centre and the two arc
# results back, 2 subtractions of the centre, 1 negation, 1 max of the two,
# compare + select + -1 for the threshold, 8 max for the 3x3 non-maximum
# suppression, 7 compares and selects for the non-maximum test, the border
# mask and the cell select. Counted at the float32 rate.
FAST_OPS_PER_PIXEL = 2 * 40 + 3 + 3 * 3 + 2 + 1 + 1 + 3 + 8 + 7


def level_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """(h, w) of each pyramid level: the image divided by scale^level, rounded."""
    return [(int(round(height / scale_factor ** l)), int(round(width / scale_factor ** l)))
            for l in range(n_levels)]


def fast_bound(shapes) -> dict:
    """The least time one frame's FAST launch could take: every pixel of
    every level read once and its score written once as float32 over the
    memory rate, or FAST_OPS_PER_PIXEL operations a pixel over the float32
    rate, whichever is larger. The work does not depend on the data."""
    pixels = sum(h * w for h, w in shapes)
    n_bytes = pixels * 2 * 4
    ops = pixels * FAST_OPS_PER_PIXEL
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"pixels": pixels, "bytes": n_bytes, "operations": ops,
            "bound_s": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them (empty
    where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    first = out.strip().splitlines()[:1]
    if not first:
        return {}
    name, _, limit = first[0].rpartition(",")
    try:
        return {"smi_name": name.strip(), "power_limit_w": float(limit)}
    except ValueError:
        return {"smi_name": first[0].strip()}
