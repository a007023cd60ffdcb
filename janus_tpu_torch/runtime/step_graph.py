"""The decode loops captured in CUDA graphs and replayed.

The JAX package compiles each decode loop into one program: ``jit`` over
a ``lax.while_loop`` (the recognizer's greedy search,
``janus_tpu/models/asr.py``; the TTS's AR loop, ``janus_tpu/models/
tts.py``) whose condition, ``(step < max) & ~all(done)``, is tested on the
device before every step. The port's loops are Python. Issued op by op
from Python, a step is ~1800-2600 launches, and the card idles most of the
step while the host enqueues them. On the card the port captures the step
over static buffers (the KV caches, the cross K/V, the token or mel group,
the device position counter, the output buffer). The JAX package has no
counterpart of this module: ``jit`` plays its role there.

- :class:`StepGraph`: one step function (or any device work over static
  tensors), captured once after one eager warm-up on the capture stream,
  replayed per call; on the CPU it runs the step eagerly (the same ops
  over the same static buffers), which is how the tests hold the
  device-position step to the eager loop.
- :class:`LoopGraph`: the ``while_loop`` itself. The step's nodes and
  edges copied into the body of a WHILE conditional node (CUDA 12.4+),
  the loop's condition, ``(trips < limit) & ~all(done)``, computed on the
  card by the port's kernel (``csrc/loop_graph.cu``) before the node and
  after each body, which also counts the trips in a device counter. One
  launch runs the loop and nothing is read back, whatever its exit. On
  the CPU the same loop runs eagerly, the condition read before each
  body. A synthesis puts its prefill before the node and its vocoder
  after it, each a captured graph copied into the loop's: one launch a
  synthesis.
- :class:`StepChain`: the JAX package's ``lax.scan`` of ``n`` steps (the
  stream's chunk), which runs every step whatever ``done`` says: the step's
  nodes ``n`` times in sequence, one launch a chunk.
- :class:`StepGraphs`: the graphs of one caller (an encoder, a
  synthesizer) by key, with one memory pool, one capture stream and one
  lock, for one parameter tree at a time: a graph holds its weights'
  addresses, so a call with another tree (any leaf replaced) drops the old
  graphs and captures anew. What a step derives from the tree once (the
  recognizer head's fp32 table: :meth:`StepGraphs.derived`) is kept
  beside it, for all holders.
- Lifetime: a holder owns its graphs (a :class:`LoopGraph` holds its
  :class:`StepGraph`, which holds the holder's step method weakly), so
  dropping a holder frees its graphs, its pool's blocks and its buffers
  at once, not whenever the cyclic collector next runs
  (perhaps inside another capture, which a graph's teardown there
  invalidates; the collector is kept off during a capture).
- Kernel accounting: a replay bypasses the Python wrappers that count
  their launches (:class:`~janus_tpu_torch.ops.cuda_build.Kernel`), so the
  counts a capture records are taken back from the kernels. A
  :class:`StepGraph` adds them again at every replay; a :class:`LoopGraph`
  adds one body's counts times the bodies that ran (:meth:`LoopGraph.
  account`, with ``trips`` as the caller reads it back beside its
  results), since a replay does not say how many ran.

:func:`use_graphs` picks the path, with no fallback: the graph on the card,
the eager loop on the CPU, when the caller asks for it (``eager=True``),
and under a mesh of more than one rank (its collectives cannot be
captured). A failed capture or replay raises, and so does a CUDA without
conditional nodes.
"""

from __future__ import annotations

import functools
import gc
import math
import threading
import types
import weakref
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from janus_tpu_torch.ops.cuda_build import KERNELS, Kernel
from janus_tpu_torch.ops.loop_graph import KERNEL as LOOP_KERNEL
from janus_tpu_torch.ops.loop_graph import (ChainGraph, WhileGraph,
                                            graph_census,
                                            loop_condition_plain)
from janus_tpu_torch.parallel.collectives import current_mesh, mesh_shape
from janus_tpu_torch.runtime.profiling import span

__all__ = ["StepGraph", "LoopGraph", "StepChain", "StepGraphs", "use_graphs",
           "default_graphs"]

Counts = Dict[Kernel, Tuple[int, float, float]]


def use_graphs(device: torch.device, eager: bool = False) -> bool:
    """Whether a decode loop replays a captured step: on a CUDA device,
    unless ``eager`` asks for the Python loop or the current mesh has more
    than one rank."""
    if eager or device.type != "cuda":
        return False
    return math.prod(mesh_shape(current_mesh()).values()) == 1


def _counts() -> Counts:
    return {k: (k.launches, k.flops, k.bytes) for k in KERNELS.values()}


def _restore(counts: Counts) -> None:
    for k, (launches, flops, nbytes) in counts.items():
        k.launches, k.flops, k.bytes = launches, flops, nbytes


def _add(counts: Counts, times: int) -> None:
    for k, (launches, flops, nbytes) in counts.items():
        k.launches += times * launches
        k.flops += times * flops
        k.bytes += times * nbytes


class StepGraph:
    """``step()`` (which reads and writes only static tensors) captured in
    a CUDA graph on a CUDA ``device``; on the CPU :meth:`replay` runs it
    eagerly.

    On the card: one eager warm-up of ``step`` on the capture stream sets
    up what must not happen inside a capture (cuBLAS handles and
    workspaces, kernel libraries, cached constants), then the capture, in
    ``thread_local`` mode so that another thread may launch work and read
    results meanwhile (the engine encodes on one thread while the receiver
    synthesizes on another); a device-wide ``torch.cuda.synchronize()`` in
    another thread during a capture still invalidates it, so callers
    capture up front (the ``warmup`` methods) and captures take turns.
    The warm-up launches count as launches; the capture's are recorded in
    :attr:`counts` and added to the kernels at every replay.
    ``capture_ms`` is the warm-up and capture's wall time, the
    ``setup.capture`` span's. A bound method
    ``step`` is held weakly (its object owns this graph); ``args`` are
    passed to it at every call (the capture fixes them). With ``keep``
    the captured ``cudaGraph_t`` is kept (:meth:`raw_graph`), for a
    :class:`LoopGraph` or a :class:`StepChain` to clone."""

    def __init__(self, step: Callable[..., None], device: torch.device,
                 pool=None, stream=None, keep: bool = False,
                 args: tuple = ()):
        self._keep = keep
        fn = (weakref.WeakMethod(step) if isinstance(step, types.MethodType)
              else lambda: step)
        self._step = lambda: functools.partial(fn(), *args)
        self.device = device
        self.replays = 0
        self.counts: Counts = {}
        self.capture_ms = 0.0
        self._graph = None
        if device.type == "cuda":
            self._graph = self._capture(pool, stream)

    @property
    def step(self) -> Callable[[], None]:
        return self._step()

    def _capture(self, pool, stream):
        dev = self.device
        # one capture at a time in the process: entering a capture
        # synchronises the device, which would invalidate another thread's
        # capture under way
        with _CAPTURE_LOCK, span("setup.capture") as traced:
            stream = stream or torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self.step()
            torch.cuda.current_stream(dev).wait_stream(stream)
            before = _counts()
            graph = (torch.cuda.CUDAGraph(keep_graph=True) if self._keep
                     else torch.cuda.CUDAGraph())
            # no cyclic collection during the capture: one that freed
            # another graph would tear it down inside the capture, which
            # invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.step()
            finally:
                if collecting:
                    gc.enable()
            after = _counts()
            _restore(before)
            self.counts = {k: (a[0] - before[k][0], a[1] - before[k][1],
                               a[2] - before[k][2])
                           for k, a in after.items() if a[0] != before[k][0]}
            stream.synchronize()
        self.capture_ms = (traced.end_ns - traced.start_ns) / 1e6
        return graph

    def raw_graph(self) -> int:
        """The captured ``cudaGraph_t`` (a capture with ``keep``)."""
        if self._graph is None or not self._keep:
            raise RuntimeError("no kept CUDA graph: capture with keep=True")
        return self._graph.raw_cuda_graph()

    def census(self) -> Optional[dict]:
        """The kept graph's nodes and edges (:func:`~janus_tpu_torch.ops.
        loop_graph.graph_census`); None on the CPU."""
        return None if self._graph is None else graph_census(
            self.raw_graph())

    def replay(self) -> None:
        if self._graph is None:
            self.step()
        else:
            self._graph.replay()
            _add(self.counts, 1)
        self.replays += 1


class LoopGraph:
    """The loop ``while trips < limit and any(~done): step(); trips += 1``
    with its test on the card: ``step``'s graph (a :class:`StepGraph`
    captured with ``keep=True``), its nodes and edges copied into the body
    of a WHILE conditional node, and the condition, counting the trips,
    computed by the port's kernel before the node and after each body
    (:class:`~janus_tpu_torch.ops.loop_graph.WhileGraph`). One launch runs
    the loop, whatever its exit; nothing is read back. On the CPU
    :meth:`run` is the same loop run eagerly, the condition
    (:func:`~janus_tpu_torch.ops.loop_graph.loop_condition_plain`) read back
    before each body.

    ``trips`` (int32, on the device) is the holder's to zero before a run,
    in work it issues before (its prefill), so that a run is one launch.
    :meth:`run` returns a copy of it, which the caller reads back with its
    results and hands to :meth:`account`: the step graph's kernel counts
    times the bodies that ran, and the condition kernel's launches (one
    before the node, one after each body); :meth:`defer` keeps the copy to
    be read at :meth:`settle` instead. The step graph's own
    :attr:`StepGraph.replays` do not move: the loop is its own graph, over
    the same pool addresses, so a holder never runs the two at once.

    ``before`` and ``after`` (:class:`StepGraph` s captured with ``keep``,
    or None) run before the loop's first test and after its exit, in the
    same launch (a synthesis: the prefill, which zeroes ``trips`` and sets
    ``done``, and the vocoder); their counts are added once a run.
    ``trips`` is the counter of another loop over the same step, where one
    already owns it. With ``before`` or ``after`` the graph holds an event
    record node after ``before`` and one after the WHILE node (outside its
    body), which :meth:`mark` points at a traced launch's events; ``build_ms`` is the
    ``setup.build`` span's time."""

    def __init__(self, step: StepGraph, done: torch.Tensor, limit: int,
                 before: Optional[StepGraph] = None,
                 after: Optional[StepGraph] = None,
                 trips: Optional[torch.Tensor] = None):
        if limit < 1:
            raise ValueError(f"a loop of at most {limit} steps")
        self.step_graph = step
        self.before, self.after = before, after
        self.device = step.device
        self.done = done
        self.limit = limit
        self.trips = (torch.zeros((), dtype=torch.int32, device=self.device)
                      if trips is None else trips)
        self.runs = 0        # calls of run()
        self.trips_run = 0   # bodies run, as account() was told
        self.counts: Counts = step.counts
        self.build_ms = 0.0
        self._pending: List[tuple] = []
        self._graph = None
        if self.device.type == "cuda":
            with span("setup.build", steps=limit) as traced:
                self._graph = WhileGraph(
                    step.raw_graph(), done, self.trips, limit,
                    before.raw_graph() if before is not None else None,
                    after.raw_graph() if after is not None else None)
            self.build_ms = (traced.end_ns - traced.start_ns) / 1e6

    def run(self) -> torch.Tensor:
        """The loop from the holder's state (after ``before``, then
        ``after``): on the card one graph launch, nothing read back; on the
        CPU the same functions eagerly. Returns a copy of ``trips`` (on the
        loop's device)."""
        if self._graph is None:
            if self.before is not None:
                self.before.step()
            while bool(loop_condition_plain(self.done, self.trips,
                                            self.limit)[1]):
                self.step_graph.step()
                self.trips.add_(1)
            if self.after is not None:
                self.after.step()
        else:
            self._graph.launch(self.device)
        self.runs += 1
        return self.trips.clone()

    def census(self) -> Optional[dict]:
        """The loop's WHILE body's nodes and edges; None on the CPU."""
        return None if self._graph is None else self._graph.census()

    def mark(self, events: Optional[list]) -> None:
        """Point the boundary nodes (a loop with ``before`` or ``after``) at two
        events for the next runs, or with None back at the loop's own."""
        if self._graph is not None:
            self._graph.mark(events)

    def account(self, trips: int) -> None:
        """A run's ``trips`` as read back: its kernels' launches."""
        trips = int(trips)
        _add(self.counts, trips)
        if self._graph is not None:
            for g in (self.before, self.after):
                if g is not None:
                    _add(g.counts, 1)
        if self._graph is not None:
            LOOP_KERNEL.launches += 1 + trips
            LOOP_KERNEL.flops += (1 + trips) * self.done.numel()
            LOOP_KERNEL.bytes += (1 + trips) * (self.done.numel() + 8.0)
        self.trips_run += trips

    def defer(self, trips: torch.Tensor, traced=None) -> None:
        """Keep a run's ``trips`` copy until :meth:`settle`, which sets
        them as the ``steps`` of the run's span ``traced``."""
        self._pending.append((trips, traced))

    def settle(self) -> None:
        """Read back and :meth:`account` every deferred run (a wait for the
        last of them)."""
        if self._pending:
            runs = torch.stack([t for t, _ in self._pending]).cpu().tolist()
            spans = [s for _, s in self._pending]
            self._pending.clear()
            for trips, traced in zip(runs, spans):
                self.account(trips)
                if traced is not None:
                    traced.set(steps=int(trips))


class StepChain:
    """``n`` steps in sequence, whatever ``done`` says (the JAX package's
    ``lax.scan`` over a chunk): ``step``'s graph (a :class:`StepGraph`
    captured with ``keep=True``), its nodes and edges copied ``n`` times
    into one executable graph (:class:`~janus_tpu_torch.ops.loop_graph.
    ChainGraph`), one launch a run; on the CPU the step ``n`` times
    eagerly. Each run on the card adds the step's counts ``n`` times.
    ``build_ms`` is the ``setup.build`` span's time."""

    def __init__(self, step: StepGraph, n: int):
        self.step_graph, self.n = step, n
        self.device = step.device
        self.runs = 0
        self.build_ms = 0.0
        self._graph = None
        if self.device.type == "cuda":
            with span("setup.build", steps=n) as traced:
                self._graph = ChainGraph(step.raw_graph(), n)
            self.build_ms = (traced.end_ns - traced.start_ns) / 1e6

    def census(self) -> Optional[dict]:
        """The chain's nodes and edges; None on the CPU."""
        return None if self._graph is None else self._graph.census()

    def run(self) -> None:
        if self._graph is None:
            for _ in range(self.n):
                self.step_graph.step()
        else:
            self._graph.launch(self.device)
            _add(self.step_graph.counts, self.n)
        self.runs += 1


_CAPTURE_LOCK = threading.Lock()


def _leaves(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    return out


class StepGraphs:
    """The step graphs of one caller: holders by key (each owning its
    static buffers and its :class:`StepGraph`), one memory pool and one
    capture stream shared by them, and one lock that a decode holds while
    it fills and replays a holder (the holders of one caller share the
    pool, so they never run at the same time). The graphs serve one
    parameter tree at a time, whose leaves they keep alive."""

    def __init__(self):
        self.lock = threading.RLock()
        self._holders: Dict[Hashable, object] = {}
        self._derived: Dict[Hashable, object] = {}
        self._leaves: Optional[List[torch.Tensor]] = None
        self._pool = None
        self._stream = None

    def holder(self, params, key: Hashable, build: Callable[[], object]):
        """The holder for ``key`` built by ``build()`` for this tree (the
        first call captures). Call with :attr:`lock` held."""
        leaves = _leaves(params, [])
        old = self._leaves
        if old is None or len(old) != len(leaves) or any(
                a is not b for a, b in zip(old, leaves)):
            self.clear()
            self._leaves = leaves
        h = self._holders.get(key)
        if h is None:
            h = self._holders[key] = build()
        return h

    def derived(self, name: Hashable, build: Callable[[], object]):
        """``build()`` of the current tree (the one the last
        :meth:`holder` call served), made at the first request and shared
        by every holder until the tree is replaced. Call with :attr:`lock`
        held, from a holder's constructor."""
        if name not in self._derived:
            self._derived[name] = build()
        return self._derived[name]

    def capture_args(self, device: torch.device) -> dict:
        """The pool and stream a new :class:`StepGraph` of this caller
        captures with."""
        if device.type != "cuda":
            return {}
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)
        return {"pool": self._pool, "stream": self._stream}

    def holders(self, kind: Optional[str] = None) -> List[object]:
        """The holders, or those whose key starts with ``kind`` (a tuple
        key's first item: ``"greedy"``, ``"encode"``, ``"ar"``)."""
        return [h for k, h in self._holders.items()
                if kind is None or (isinstance(k, tuple) and k[0] == kind)]

    def graphs(self, kind: Optional[str] = None) -> List[StepGraph]:
        """The holders' one-step (or front) graphs."""
        return [h.graph for h in self.holders(kind)
                if getattr(h, "graph", None) is not None]

    def side_graphs(self, kind: Optional[str] = None) -> List[StepGraph]:
        """The holders' other graphs: the TTS prefill, the synthesis tail,
        the stream's emissions."""
        return [g for h in self.holders(kind)
                for g in getattr(h, "side_graphs", ())]

    def loops(self, kind: Optional[str] = None) -> List[LoopGraph]:
        """The holders' loop graphs (those built so far)."""
        return [h.loop for h in self.holders(kind)
                if getattr(h, "loop", None) is not None]

    def chains(self, kind: Optional[str] = None) -> List[StepChain]:
        """The holders' chains of steps (those built so far)."""
        return [c for h in self.holders(kind)
                for c in getattr(h, "chains", {}).values()]

    @property
    def replays(self) -> int:
        """Host launches of the holders' graphs: each replay of a step,
        front, prefill, tail or emission graph, and each run of a loop or
        a chain."""
        return (sum(g.replays for g in self.graphs())
                + sum(g.replays for g in self.side_graphs())
                + sum(lp.runs for lp in self.loops())
                + sum(c.runs for c in self.chains()))

    @property
    def steps(self) -> int:
        """Decode steps the holders ran: a step graph's replays and the
        bodies of every loop and chain run (deferred counts read back
        first)."""
        self.settle()
        return (sum(h.graph.replays for h in self.holders()
                    if hasattr(h, "loop"))
                + sum(lp.trips_run for lp in self.loops())
                + sum(c.runs * c.n for c in self.chains()))

    def settle(self) -> None:
        """Account the loop runs whose ``trips`` were deferred
        (:meth:`LoopGraph.settle`: a wait for the last of them)."""
        with self.lock:
            for lp in self.loops():
                lp.settle()

    def pool_bytes(self) -> int:
        """Device memory the allocator holds in this caller's graph pool
        (the captured steps' intermediates; the static buffers lie
        outside it)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def clear(self) -> None:
        """Drop every graph and the tree they served (the pool's memory
        goes back with the last graph); deferred loop counts are
        accounted first."""
        with self.lock:
            self.settle()
            self._holders.clear()
            self._derived.clear()
            self._leaves = None
            self._pool = None


_DEFAULT: Dict[str, StepGraphs] = {}
_DEFAULT_LOCK = threading.Lock()


def default_graphs(kind: str) -> StepGraphs:
    """The graphs of the bare model functions called without a caller's
    own :class:`StepGraphs` (one per loop ``kind``, so the recognizer's and
    the TTS's do not evict each other)."""
    with _DEFAULT_LOCK:
        g = _DEFAULT.get(kind)
        if g is None:
            g = _DEFAULT[kind] = StepGraphs()
        return g
