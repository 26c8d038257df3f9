"""Where an entry point runs.

Every entry point of the package (`Slam`, `FusedContext`, `build_frame`,
`Tracker`, `LocalMapper`, `DeviceMap`, `map_from_snapshot`,
`MapState.create`) takes `device=None`, which means the current CUDA
device. Nothing carries on on the CPU because it found no card: the CPU is
used only when the caller names it (`device="cpu"`), as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device to run on, with an explicit index for CUDA (tensors report
    `cuda:0`, and placement checks compare devices). `None` is the current
    CUDA device; without one it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None means the current CUDA device, and there is none: "
                "pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
