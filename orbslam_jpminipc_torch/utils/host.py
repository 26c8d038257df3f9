"""Device -> host reads, one copy per program's results.

Every `int()`, `bool()` or `.cpu()` of a CUDA tensor waits for the device.
The reference takes each program's results in one `jax.device_get` of a
tuple; `fetch` does the same here: the tensors' bytes are concatenated on
their device and copied to the host once, then split into numpy arrays.

`READS` counts the copies made from a CUDA device (a CPU tensor costs no
read), so a caller can report host reads per frame.
"""
from __future__ import annotations

import numpy as np
import torch

READS = 0


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def fetch(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """The given tensors as host numpy arrays (copies), in one transfer."""
    global READS
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return tuple(t.detach().numpy().copy() for t in tensors)
    if len(devs) != 1:
        raise ValueError(f"fetch: tensors on several devices {devs}")
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat(flat).cpu().numpy()
    READS += 1
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        out.append(buf[off:off + n].view(_np_dtype(t.dtype)).reshape(tuple(t.shape)).copy())
        off += n
    return tuple(out)
