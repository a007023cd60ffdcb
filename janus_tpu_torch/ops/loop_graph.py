"""The decode loops' ``lax.while_loop`` condition, decided on the card.

The JAX package's decode loops are ``lax.while_loop``s whose condition,
``(step < max) & ~all(done)``, XLA tests on the device before every step
(``janus_tpu/models/asr.py:546-562``, ``janus_tpu/models/tts.py:
393-412``). ``csrc/loop_graph.cu`` (the port's own kernel) builds a CUDA
graph around a captured step: a WHILE conditional node whose body holds
the step's own nodes and edges (copied from its captured graph, the
programmatic edges kept) and then ``loop_condition``, one warp that counts
the trip and sets the node's handle to that condition; the same kernel
before the node sets it for the first test. One launch runs the loop, and
the host reads nothing back (:class:`WhileGraph`). A synthesis adds its
prefill before the loop and its vocoder after it, in the same graph, and
an event record node at each boundary of the WHILE part (outside its
body), which a traced launch points at its own timing events. The
stream's chunk, a ``lax.scan`` of ``n`` steps that runs each step whatever
``done`` says (``janus_tpu/models/tts.py:451-484``), is the step's nodes
``n`` times in sequence (:class:`ChainGraph`).

:func:`loop_condition` is the kernel alone (one launch, outside a graph),
and :func:`loop_condition_plain` its plain version, which the CPU runs:
``trips + add`` and ``(trips < limit) & any(~done)``. :func:`graph_census`
counts a graph's nodes and its edges, programmatic ones apart (the
loop's body against its step's: every edge kept).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional, Tuple

import torch

from janus_tpu_torch.ops import cuda_build

__all__ = ["KERNEL", "WhileGraph", "ChainGraph", "loop_condition",
           "loop_condition_plain", "graph_census", "CENSUS"]

KERNEL = cuda_build.KERNELS["loop_graph"]
_CREATE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
_MARKS = [ctypes.c_void_p] * 3
_CHAIN = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
_CENSUS_ARGS = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
# what a census counts, in the order of csrc/loop_graph.cu's out[8]
CENSUS = ("nodes", "kernels", "memcpys", "memsets", "children",
          "conditionals", "edges", "programmatic_edges")
# cudaGraphNodeType by value, for a refused node's message
_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "child graph", "empty",
               "event wait", "event record", "semaphore signal",
               "semaphore wait", "memory allocation", "memory free",
               "batch memory operation", "conditional")
_CONDITION = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
              + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)


def loop_condition_plain(done: torch.Tensor, trips: torch.Tensor, limit: int,
                         add: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(trips + add, (trips + add < limit) & any(~done))``: the trip
    count (int32) and the loop's condition (a 0-dim bool)."""
    t = trips + add
    return t, torch.logical_and(torch.logical_not(done.all()), t < limit)


def loop_condition(done: torch.Tensor, trips: torch.Tensor, limit: int,
                   add: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`loop_condition_plain` by the kernel on a CUDA tensor (``trips``
    advanced in place, as the loop's tail does), by the plain version on
    the CPU."""
    if done.device.type != "cuda":
        return loop_condition_plain(done, trips, limit, add)
    if done.dtype != torch.bool or trips.dtype != torch.int32 \
            or trips.numel() != 1 or done.dim() != 1:
        raise TypeError(f"loop_condition takes done [B] bool and one int32 "
                        f"trip count, got {done.dtype} {tuple(done.shape)}, "
                        f"{trips.dtype} {tuple(trips.shape)}")
    done = done.contiguous()
    go = torch.empty((), dtype=torch.int32, device=done.device)
    fn = cuda_build.entry(KERNEL, "jt_loop_condition", _CONDITION)
    KERNEL.launched(float(done.numel()), done.numel() + 8.0)
    cuda_build.check_launch(KERNEL, fn(
        done.data_ptr(), done.numel(), trips.data_ptr(), limit, add,
        go.data_ptr(), torch.cuda.current_stream(done.device).cuda_stream))
    return trips, go.bool()


def _census(name: str, handle: int) -> dict:
    out = (ctypes.c_longlong * len(CENSUS))()
    cuda_build.check_launch(KERNEL, cuda_build.entry(
        KERNEL, name, _CENSUS_ARGS)(handle, out))
    return dict(zip(CENSUS, out))


def graph_census(graph: int) -> dict:
    """The nodes of a ``cudaGraph_t`` by type and its edges, programmatic
    ones apart (:data:`CENSUS`), its child graphs included."""
    return _census("jt_graph_census", graph)


def _check_build(code: int) -> None:
    """Raise for a refused build, naming the node type the copy refused."""
    if code != 0:
        t = cuda_build.entry(KERNEL, "jt_refused_node_type", [])()
        if t >= 0:
            name = _NODE_TYPES[t] if t < len(_NODE_TYPES) else str(t)
            raise RuntimeError(f"{KERNEL.name}: the step graph holds a node "
                               f"of type '{name}', which a loop body or "
                               f"chain does not take (kernel, memcpy, "
                               f"memset, empty and child graph nodes)")
        cuda_build.check_launch(KERNEL, code)


def _destroy(handle: int) -> None:
    cuda_build.entry(KERNEL, "jt_loop_destroy", [ctypes.c_void_p])(handle)


class _Executable:
    """An instantiated graph of ``csrc/loop_graph.cu`` (``_handle``),
    launched on the current stream and freed with this object."""

    def _own(self, handle: int) -> None:
        self._handle = handle
        self._launch = cuda_build.entry(KERNEL, "jt_loop_launch",
                                        [ctypes.c_void_p] * 2)
        weakref.finalize(self, _destroy, handle)

    def census(self) -> dict:
        """:func:`graph_census` of a loop's WHILE body (of a chain: its whole
        graph)."""
        return _census("jt_loop_census", self._handle)

    def launch(self, device: torch.device) -> None:
        cuda_build.check_launch(KERNEL, self._launch(
            self._handle, torch.cuda.current_stream(device).cuda_stream))


class WhileGraph(_Executable):
    """The loop ``while (trips < limit) & any(~done): step; trips += 1`` as
    one executable CUDA graph (``csrc/loop_graph.cu``): ``step_graph`` (a
    ``cudaGraph_t``, its nodes and edges copied into the WHILE node's
    body) over the static ``done [B]`` (bool) and ``trips`` (one int32) it
    reads and writes; ``before`` and ``after`` (``cudaGraph_t``s or None,
    copied) run before the loop's first test and after its exit.
    :meth:`launch` enqueues the whole graph on the current stream; the
    caller (or ``before``) zeroes ``trips`` and sets ``done`` before the
    first test. With ``before`` or ``after`` an event record node follows
    ``before`` and one the WHILE node, recording the loop's own two events
    until :meth:`mark` points them elsewhere. Refused graphs (a CUDA without
    conditional nodes, a node type a conditional body refuses) raise."""

    def __init__(self, step_graph: int, done: torch.Tensor,
                 trips: torch.Tensor, limit: int,
                 before: Optional[int] = None, after: Optional[int] = None):
        if done.dtype != torch.bool or not done.is_contiguous() \
                or trips.dtype != torch.int32 or trips.numel() != 1:
            raise TypeError("WhileGraph takes a contiguous done [B] bool and "
                            "one int32 trip count")
        self._own_marks = self._marks = None
        a = b = None
        if before is not None or after is not None:
            # an event exists once recorded: the nodes need two that do
            self._own_marks = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
            for ev in self._own_marks:
                ev.record()
            self._marks = self._own_marks
            a, b = (ev.cuda_event for ev in self._own_marks)
        out = ctypes.c_void_p()
        fn = cuda_build.entry(KERNEL, "jt_loop_create", _CREATE)
        _check_build(fn(step_graph, done.data_ptr(), done.numel(),
                        trips.data_ptr(), limit, before, after, a, b,
                        ctypes.byref(out)))
        self._own(out.value)

    def mark(self, events) -> None:
        """Point the boundary nodes at ``events`` (two CUDA events, each
        recorded at least once) for the next launches, or with None back
        at the graph's own (a graph with neither ``before`` nor ``after``:
        nothing)."""
        events = tuple(events) if events is not None else self._own_marks
        if self._own_marks is None or events == self._marks:
            return
        cuda_build.check_launch(KERNEL, cuda_build.entry(
            KERNEL, "jt_loop_marks", _MARKS)(
                self._handle, events[0].cuda_event, events[1].cuda_event))
        self._marks = events


class ChainGraph(_Executable):
    """``step_graph`` (a ``cudaGraph_t``) copied ``n`` times in sequence
    as one executable graph: ``n`` steps a launch, no condition."""

    def __init__(self, step_graph: int, n: int):
        if n < 1:
            raise ValueError(f"a chain of {n} steps")
        out = ctypes.c_void_p()
        fn = cuda_build.entry(KERNEL, "jt_chain_create", _CHAIN)
        _check_build(fn(step_graph, n, ctypes.byref(out)))
        self._own(out.value)
