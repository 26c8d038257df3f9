"""Captured programs: the counterpart of the reference's jitted callables.

The reference compiles each device function once per static shape (`jax.jit`)
and then runs it as one program a call. A `Program` does the same on a card
with a CUDA graph: each variant of its function (a static argument, as a
`jax.jit` static argument or the arm of a `lax.cond`) is captured once, at its
first call or ahead of time by `capture`, on the program's own memory pool,
and every later call replays the graph, one launch from the host in place of
the function's kernels. A capture that fails raises; nothing on a card runs
the function eagerly in place of its graph. On the CPU (only when the caller
names it, as the tests do) the function runs eagerly at every call, through
the same copy-in and copy-out code.

A graph replays the kernels of its capture on the addresses of its capture.
So the function must read only tensors that stay where they are (its inputs,
buffers it closes over, constant tables) and allocate everything else inside
itself; and it must not read what it writes, because the capture's warm-up
runs it once eagerly before the capture (library handles, constant tables and
kernel builds happen there, not inside the capture). Inputs come two ways:

* in place (`copy_in=False`): the caller passes the same tensors at every
  call, typically another program's outputs or state buffers it owns; the
  program checks that they are;
* copied (`copy_in=True`): the program owns one byte buffer, allocated at
  its first call, with a view of it for each input; before each replay the
  host tensors' bytes go in as one pinned copy (the reference's
  `mirror_call`: a function of many small host arrays pays one transfer,
  not one each), and tensors already on the device are copied into their
  views.

Outputs come back in place (the graph's own buffers, overwritten by the next
replay: for a chain of programs within one call) or, with `copy_out=True`, as
copies: the graph ends by packing every output into one byte buffer, and a
call hands out views of one clone of it (one launch).

A program reads one set of input shapes, as a `jax.jit` executable does. A
function the reference compiles at several shapes is a `ProgramSet`: one
`Program` per shape signature of its inputs, made at the first call with
that signature. Programs that never replay at the same time share one
`GraphPool`, so their graphs reuse each other's intermediates.

A hand-written kernel's wrapper counts its launches with `count_launch`: a
launch made while a program is captured is counted at each replay of it.

`CallLog` keeps, while it is active, the first call of every program
(inputs, outputs and the function that computes them eagerly), so that a
run on a card can be checked afterwards program by program against the
eager function on the same inputs.
"""
from __future__ import annotations

import gc
from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from .tracing import get_tracer

# packed outputs start on this boundary, so every dtype can view its slot
_ALIGN = 16

# the launch counters noted by the capture in progress (see count_launch)
_noted: list | None = None
# the active CallLog, if any
_log = None
_tracer = get_tracer()


def count_launch(add: Callable[[int], None]):
    """Count one launch of a hand-written kernel, where its wrapper launches
    it: `add(n)` adds n to the wrapper's count. Outside a stream capture the
    kernel ran: add(1) now. Inside a program's capture nothing ran yet: the
    program keeps `add` and calls add(1) at each replay of its graph."""
    if not torch.cuda.is_current_stream_capturing():
        add(1)
    elif _noted is not None:
        _noted.append(add)


class _Layout(NamedTuple):
    """Where each output lies in the packed byte buffer."""

    spec: pytree.TreeSpec
    slots: tuple  # (offset, bytes, dtype, shape) per leaf


def _slots(leaves) -> tuple:
    """(offset, bytes, dtype, shape) of each tensor in one byte buffer, and
    the buffer's size."""
    slots, size = [], 0
    for x in leaves:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"a program's inputs and outputs must be tensors, "
                            f"got {type(x).__name__}")
        size = -(-size // _ALIGN) * _ALIGN
        n = x.numel() * x.element_size()
        slots.append((size, n, x.dtype, tuple(x.shape)))
        size += n
    return tuple(slots), size


def _pack(out):
    """The outputs copied into one byte buffer: (buffer, layout)."""
    leaves, spec = pytree.tree_flatten(out)
    slots, size = _slots(leaves)
    dev = leaves[0].device if leaves else torch.device("cpu")
    buf = torch.empty(size, dtype=torch.uint8, device=dev)
    layout = _Layout(spec, slots)
    for view, x in zip(_views(buf, layout), leaves):
        view.copy_(x)
    return buf, layout


def _views(buf: torch.Tensor, layout: _Layout) -> list:
    return [buf[off:off + n].view(dtype).view(shape) for off, n, dtype, shape in layout.slots]


def unpack(buf: torch.Tensor, layout: _Layout):
    return pytree.tree_unflatten(_views(buf, layout), layout.spec)


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    out: object              # the outputs: the graph's own tensors
    packed: tuple | None     # (buffer, layout) with copy_out
    launches: list           # count_launch callbacks, one per kernel launch captured


class GraphPool:
    """A CUDA graph memory pool, made at the first capture. Graphs captured
    into one pool may reuse each other's intermediates, so the programs
    that share it must never replay at the same time (one stream, one
    thread); each graph's outputs stay its own."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class Program:
    """`fn(variant, *inputs)` as one CUDA graph per variant on a card, eager
    on the CPU.

    `fn` returns a tensor or a tuple, list, dict or NamedTuple of tensors
    (or None). `variant` is any hashable value the function branches on in
    Python; each value is a program of its own. With `keep_graph` each
    captured graph is kept after instantiation, for a chain of programs
    (utils/graph_chain.py) to add to a graph of its own.
    """

    def __init__(self, fn, device, name: str, copy_in: bool = False,
                 copy_out: bool = False, pool: GraphPool | None = None,
                 keep_graph: bool = False):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self.copy_in = copy_in
        self.copy_out = copy_out
        self.keep_graph = keep_graph
        self._graphs: dict = {}
        self._inputs: list | None = None   # the leaves read in place
        self.pool = pool if pool is not None else GraphPool()

    @property
    def variants(self) -> tuple:
        """The variants captured so far."""
        return tuple(self._graphs)

    def _stage(self, inputs) -> tuple:
        """The inputs the function reads: the caller's (checked to be the same
        tensors as at the first call, on a card), or the program's own views
        with the caller's tensors copied in."""
        leaves, spec = pytree.tree_flatten(inputs)
        if self.copy_in:
            return pytree.tree_unflatten(self._copy_in(leaves), spec)
        if self._inputs is None:
            self._inputs = list(leaves)
        if len(leaves) != len(self._inputs):
            raise ValueError(f"program {self.name}: {len(leaves)} inputs, "
                             f"{len(self._inputs)} at its first call")
        if self.device.type == "cuda" and any(a is not b for a, b in zip(leaves, self._inputs)):
            raise ValueError(f"program {self.name} reads its inputs in place: pass the "
                             "tensors of its first call")
        return inputs

    def _copy_in(self, leaves) -> list:
        """Copy the inputs into the views of the program's one byte buffer:
        the host tensors' bytes gathered in one pinned buffer and copied in
        at once, device tensors each into its view. Returns the views."""
        slots, size = _slots(leaves)
        if self._inputs is None:
            self._packed = torch.empty(size, dtype=torch.uint8, device=self.device)
            self._slots = slots
            self._inputs = _views(self._packed, _Layout(None, slots))
        elif slots != self._slots:
            raise ValueError(f"program {self.name}: inputs "
                             f"{[(s[3], s[2]) for s in slots]}, its buffer holds "
                             f"{[(s[3], s[2]) for s in self._slots]}")
        host = [i for i, x in enumerate(leaves) if x.device.type == "cpu"]
        if self.device.type == "cuda" and host:
            stage = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            staged = _views(stage, _Layout(None, slots))
            for i in host:
                staged[i].copy_(leaves[i])
            # the pinned block is not reused before this copy has landed
            # (the caching host allocator records it on the stream)
            self._packed.copy_(stage, non_blocking=True)
        else:
            for i in host:
                self._inputs[i].copy_(leaves[i])
        for i, x in enumerate(leaves):
            if x.device.type != "cpu":
                self._inputs[i].copy_(x)
        return self._inputs

    def run(self, variant, *inputs):
        """One call: the outputs (the graph's own on a card, unless
        `copy_out`). The first call of a variant on a card captures it. In
        the tracer's detail mode the call's device work, copy-in to copy-out,
        lies between two timing events."""
        if self.device.type != "cuda":
            inputs = self._stage(inputs)
            out = self.fn(variant, *inputs)
            if not self.copy_out:
                return out
            buf, layout = _pack(out)
            return unpack(buf.clone(), layout)
        begin = _tracer.launch_begin() if _tracer.detail else None
        inputs = self._stage(inputs)
        cap = self._graphs.get(variant)
        if cap is None:
            cap = self._capture(variant, inputs)
        cap.graph.replay()
        for add in cap.launches:
            add(1)
        out = cap.out
        if cap.packed is not None:
            buf, layout = cap.packed
            out = unpack(buf.clone(), layout)
        if begin is not None:
            _tracer.launch_end(begin, self.name)
        return out

    def capture(self, variant, *inputs):
        """Capture `variant` ahead of its first call, without running it
        (beyond the capture's eager warm-up). On the CPU: nothing."""
        inputs = self._stage(inputs)
        if self.device.type == "cuda" and variant not in self._graphs:
            self._capture(variant, inputs)

    def stage(self, *inputs):
        """Copy the inputs in (or check them) without running anything: for
        a caller that launches the captured graph inside a larger one
        (utils/graph_chain.py)."""
        self._stage(inputs)

    def captured(self, variant) -> _Captured:
        """The capture of `variant` (its graph, outputs, packed outputs and
        launch counters); raises KeyError when it is not captured."""
        return self._graphs[variant]

    def _capture(self, variant, inputs) -> _Captured:
        """Capture `variant` (inside the tracer's span `capture`)."""
        _tracer.log("capture", program=self.name, variant=repr(variant))
        with _tracer.stage("capture"):
            return self._capture_graph(variant, inputs)

    def _capture_graph(self, variant, inputs) -> _Captured:
        global _noted
        with torch.cuda.device(self.device):
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            # warm-up: library handles, constant tables, kernel builds
            with torch.cuda.stream(stream):
                self.fn(variant, *inputs)
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graph)
            launches = []
            _noted = launches
            # no garbage collection during the capture: a collected cycle
            # holding a graph (an older system's programs) would destroy
            # it, a call that invalidates the capture
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool.handle(), stream=stream):
                    out = self.fn(variant, *inputs)
                    packed = _pack(out) if self.copy_out else None
            finally:
                _noted = None
                if gc_on:
                    gc.enable()
            if self.keep_graph:
                graph.instantiate()
        cap = _Captured(graph, out, packed, launches)
        self._graphs[variant] = cap
        return cap


def _signature(inputs):
    leaves, spec = pytree.tree_flatten(inputs)
    return spec, tuple((tuple(x.shape), x.dtype) for x in leaves)


def _label(inputs) -> str:
    """The sizes that tell a function's shapes apart: the leading dimension
    of each input of 16 or more rows, each once, in order."""
    dims = []
    for x in pytree.tree_leaves(inputs):
        if x.dim() and x.shape[0] >= 16 and x.shape[0] not in dims:
            dims.append(x.shape[0])
    return "x".join(map(str, dims))


class ProgramSet:
    """`fn(variant, *inputs)` at every shape it is called with: one
    `Program` per shape signature of the inputs (the reference's jitted
    function, compiled once per static shape), all on one `GraphPool`, the
    inputs copied in and the outputs copied out. `capture` makes the
    program of its inputs' shapes on the CPU too (without capturing
    anything), so a test can tell which shapes a run reached beyond those
    captured ahead of time. With `log` False its calls stay out of an
    active `CallLog`: for a function that reads state the program does not
    copy in (the map mirror's stages), which the log's later eager run
    would not see as the call did (tests/test_torch_programs_host.py holds
    a whole run's log)."""

    def __init__(self, fn, device, name: str, pool: GraphPool | None = None,
                 log: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        self.name = name
        self.pool = pool if pool is not None else GraphPool()
        self.log = log
        self.programs: dict = {}   # signature -> Program

    def program(self, inputs) -> Program:
        """The program of `inputs`' shapes, made at the first need."""
        sig = _signature(inputs)
        prog = self.programs.get(sig)
        if prog is None:
            prog = Program(self.fn, self.device, f"{self.name}[{_label(inputs)}]",
                           copy_in=True, copy_out=True, pool=self.pool)
            self.programs[sig] = prog
        return prog

    def run(self, variant, *inputs):
        prog = self.program(inputs)
        out = prog.run(variant, *inputs)
        if _log is not None and self.log:
            _log.note(prog.name, variant, inputs, out,
                      lambda *a: self.fn(variant, *a), self.device)
        return out

    def capture(self, variant, *inputs):
        self.program(inputs).capture(variant, *inputs)


class Call(NamedTuple):
    """One logged call: `out` is what the caller got (it must not change
    after later calls), `out_copy` a clone taken at once, `eager(*inputs)`
    the function run eagerly."""

    name: str
    variant: object
    inputs: tuple
    out: object
    out_copy: object
    eager: Callable


class CallLog:
    """While active (`with CallLog() as log:`), the first call of each
    program (by name and variant) is kept in `calls`, its inputs cloned
    where they lie (a copy to the card would wait for it): `eager` moves
    them to the program's device."""

    def __init__(self):
        self.calls: list[Call] = []
        self._seen: set = set()

    def __enter__(self):
        global _log
        if _log is not None:
            raise RuntimeError("a CallLog is already active")
        _log = self
        return self

    def __exit__(self, *exc):
        global _log
        _log = None

    def note(self, name, variant, inputs, out, eager, device):
        if (name, variant) in self._seen:
            return
        self._seen.add((name, variant))
        clone = lambda t: pytree.tree_map(lambda x: x.detach().clone(), t)
        on_device = lambda t: pytree.tree_map(lambda x: x.to(device), t)
        self.calls.append(Call(name, variant, clone(inputs), out, clone(out),
                               lambda *a: eager(*on_device(a))))
