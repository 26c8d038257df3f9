"""Device -> host reads, one copy per program's results.

Every `int()`, `bool()` or `.cpu()` of a CUDA tensor waits for the device.
The reference takes each program's results in one `jax.device_get` of a
tuple; `fetch` does the same here: the tensors' bytes are concatenated on
their device and copied to the host once, then split into numpy arrays.

`fetch_async` is the same read without the wait: the copy is queued into
pinned host memory behind the work already on the stream, and the handle
it returns says whether the copy has landed (`done()`, which asks an event
and never waits) and hands the arrays out (`result()`, which waits if it
must). A mapping stage launches its program and queues the read; a later
frame asks `done()` and takes the result only when it costs no wait.

`upload` is the other direction: a host array as a tensor on a device,
staged in pinned host memory and queued behind the stream's work on a card
(a plain `.to(device)` of pageable memory waits for the stream to drain);
`upload_into` writes it into an existing tensor the same way (a buffer a
captured program reads in place).

`host_tensor` is a host array as a CPU tensor with the dtypes the map
mirror uploads (float64 becomes float32): a captured program's copy-in
stages it in pinned memory and queues the copy.

The tracer's counter `reads` (`utils/tracing.py`) counts the copies made
from a CUDA device (a CPU tensor costs no read), so a caller can report host
reads per frame. In the tracer's detail mode each wait for the device, a
`fetch` or a `result()` whose copy has not landed, is timed and credited to
the spans open around it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .tracing import get_tracer

_tracer = get_tracer()


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def _on_cpu(tensors) -> bool:
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1:
        raise ValueError(f"fetch: tensors on several devices {devs}")
    return False


def _flatten(tensors) -> torch.Tensor:
    """The tensors' bytes, concatenated on their device."""
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _split(buf: np.ndarray, layout) -> tuple[np.ndarray, ...]:
    out, off = [], 0
    for dtype, shape in layout:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out.append(buf[off:off + n].view(dtype).reshape(shape).copy())
        off += n
    return tuple(out)


def _layout(tensors):
    return [(_np_dtype(t.dtype), tuple(t.shape)) for t in tensors]


def fetch(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """The given tensors as host numpy arrays (copies), in one transfer."""
    if _on_cpu(tensors):
        return tuple(t.detach().numpy().copy() for t in tensors)
    buf = _flatten(tensors)
    if _tracer.detail:
        t0 = time.perf_counter_ns()
        buf = buf.cpu()
        _tracer.note_wait(t0, time.perf_counter_ns())
    else:
        buf = buf.cpu()
    _tracer.counts["reads"] += 1
    return _split(buf.numpy(), _layout(tensors))


class AsyncFetch:
    """A queued device -> host read of several tensors (see `fetch_async`)."""

    def __init__(self, tensors):
        self._arrays = None
        self._event = None
        if _on_cpu(tensors):
            self._arrays = tuple(t.detach().numpy().copy() for t in tensors)
            return
        self._layout = _layout(tensors)
        dev = _flatten(tensors)
        self._host = torch.empty(dev.shape, dtype=torch.uint8, pin_memory=True)
        self._host.copy_(dev, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()
        _tracer.counts["reads"] += 1

    def done(self) -> bool:
        """Has the copy landed? Never waits for the device."""
        return self._event is None or self._event.query()

    def result(self) -> tuple[np.ndarray, ...]:
        """The arrays; waits for the copy when it has not landed yet."""
        if self._arrays is None:
            if _tracer.detail and not self._event.query():
                t0 = time.perf_counter_ns()
                self._event.synchronize()
                _tracer.note_wait(t0, time.perf_counter_ns())
            else:
                self._event.synchronize()
            self._arrays = _split(self._host.numpy(), self._layout)
            self._event = self._host = None
        return self._arrays


def fetch_async(*tensors: torch.Tensor) -> AsyncFetch:
    """Queue one read of the given tensors behind the work already on the
    current stream and return at once. On CPU tensors the handle is done at
    once and holds the same arrays as `fetch`."""
    return AsyncFetch(tensors)


def host_tensor(a) -> torch.Tensor:
    """A host array (or scalar) as a CPU tensor, float64 as float32."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    # (ascontiguousarray makes a 0-d array 1-d: the shape is put back)
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(a.shape)


def upload(a, device) -> torch.Tensor:
    """A host array (or CPU tensor) as a tensor on `device`, same dtype. On
    a card the bytes are staged in pinned host memory and the copy is
    queued behind the work already on the stream; the caching host
    allocator keeps the pinned buffer until the copy has landed."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a)).reshape(np.shape(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    if t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def upload_into(dst: torch.Tensor, a):
    """Copy a host array (or CPU tensor) into the existing tensor `dst` (its
    shape; the dtype converted where it differs), staged and queued as
    `upload` does on a card."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a)).reshape(np.shape(a))
    if dst.device.type == "cuda" and t.device.type == "cpu":
        dst.copy_(t.pin_memory(), non_blocking=True)
    else:
        dst.copy_(t)
