"""A chain of captured programs with branches the device decides, launched
as one CUDA graph (csrc/graph_chain.cu).

The reference runs its WORKING step as one XLA program with `lax.cond`s in
it, so dispatching a frame never waits for the device. A `Program`'s graph
(utils/program.py) has no branch in it: a caller that picks the variant to
replay reads the host first, and on one stream that read waits for every
program queued before it. A `Chain` puts the branch on the device: its
links are captured graphs, run always, or branches, a predicate byte in
device memory and a graph for each of its values. The chain is built once,
after every graph it holds is captured, as one executable graph whose
branches are IF nodes set by a one-thread kernel (`chain_branch_kernel`)
from the predicate; `launch()` is one cudaGraphLaunch on the current stream
and reads nothing.

An arm may end by copying its outputs (a device buffer) into a buffer of the
chain's caller, so that both arms of a branch hand over the result at one
address. The chain holds every graph, predicate and buffer it reads.

`LAUNCHES` counts the branch kernel's launches: one per branch at each
launch of a chain (each runs inside the graph, where it decides its branch).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from . import nvcc
from .tracing import get_tracer

LAUNCHES = 0

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "graph_chain.cu"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
_tracer = get_tracer()


class _Arm(ctypes.Structure):  # ChainArm in csrc/graph_chain.cu
    _fields_ = [("graph", ctypes.c_void_p), ("copy_dst", ctypes.c_void_p),
                ("copy_src", ctypes.c_void_p), ("copy_bytes", ctypes.c_ulonglong)]


class _Link(ctypes.Structure):  # ChainLink in csrc/graph_chain.cu
    _fields_ = [("pred", ctypes.c_void_p), ("on_true", _Arm), ("on_false", _Arm)]


def library_path() -> Path:
    return nvcc.library_path(SOURCE, NVCC_FLAGS, "libgraph_chain")


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the library; idempotent."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_built()))
        lib.graph_chain_build.argtypes = [ctypes.POINTER(_Link), ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_void_p),
                                          ctypes.POINTER(ctypes.c_void_p)]
        lib.graph_chain_build.restype = ctypes.c_int
        lib.graph_chain_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.graph_chain_launch.restype = ctypes.c_int
        lib.graph_chain_destroy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.graph_chain_destroy.restype = ctypes.c_int
        lib.graph_chain_error_string.argtypes = [ctypes.c_int]
        lib.graph_chain_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _built() -> Path:
    so = library_path()
    nvcc.compile_library(SOURCE, NVCC_FLAGS, so)
    return so


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.graph_chain_error_string(err).decode()}")


class Arm(NamedTuple):
    """A captured graph (`torch.cuda.CUDAGraph` kept after capture), and
    optionally (dst, src): device tensors of equal bytes, src copied into dst
    after the graph ran."""

    graph: torch.cuda.CUDAGraph
    copy: tuple | None = None


class Link(NamedTuple):
    """`on_true` always, when `pred` is None; else a branch on the first byte
    of `pred` (a CUDA bool tensor): `on_true` when it is set, `on_false`
    when not."""

    pred: torch.Tensor | None
    on_true: Arm | None
    on_false: Arm | None = None


def _count(n: int):
    global LAUNCHES
    LAUNCHES += n


class Chain:
    """The links as one executable graph on `device` (see the module);
    `name` names its launches in the tracer."""

    def __init__(self, links, device, name: str):
        self.device = torch.device(device)
        self.name = name
        self.links = list(links)
        self.n_branches = sum(link.pred is not None for link in self.links)
        lib = build()
        table = (_Link * len(self.links))()
        for row, link in zip(table, self.links):
            if link.pred is not None:
                if not (link.pred.is_cuda and link.pred.dtype == torch.bool):
                    raise ValueError("a branch's predicate must be a CUDA bool tensor")
                if link.on_true is None or link.on_false is None:
                    raise ValueError("a branch needs a graph on each arm")
                row.pred = link.pred.data_ptr()
            elif link.on_false is not None:
                raise ValueError("a link without a predicate runs one graph")
            for arm, dst in ((link.on_true, row.on_true), (link.on_false, row.on_false)):
                if arm is None:
                    continue
                dst.graph = arm.graph.raw_cuda_graph()
                if arm.copy is not None:
                    to, frm = arm.copy
                    n = to.numel() * to.element_size()
                    if (n != frm.numel() * frm.element_size() or not to.is_contiguous()
                            or not frm.is_contiguous()):
                        raise ValueError("an arm's copy needs two contiguous buffers "
                                         "of equal bytes")
                    dst.copy_dst, dst.copy_src, dst.copy_bytes = (
                        to.data_ptr(), frm.data_ptr(), n)
        exec_, graph = ctypes.c_void_p(), ctypes.c_void_p()
        _check(lib, lib.graph_chain_build(table, len(self.links), self.device.index or 0,
                                          ctypes.byref(exec_), ctypes.byref(graph)),
               "graph_chain_build")
        self._lib, self._exec, self._graph = lib, exec_, graph

    def launch(self):
        """One launch of the whole chain on the current stream; no wait. In
        the tracer's detail mode it lies between two timing events."""
        begin = _tracer.launch_begin() if _tracer.detail else None
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check(self._lib, self._lib.graph_chain_launch(self._exec, stream),
               "graph_chain_launch")
        if begin is not None:
            _tracer.launch_end(begin, self.name)
        if self.n_branches:
            _count(self.n_branches)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.graph_chain_destroy(self._exec, self._graph)
