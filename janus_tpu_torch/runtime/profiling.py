"""The port's tracer: spans where the work happens, and the exporter.

The reference had no profiling at all (SURVEY.md §5 — only duration log
lines). The port measures itself with one tracer:

- :func:`span` ``(name, request=None, parent=None, device=None, **attrs)``
  records a name, a request id (given, else the parent's, else a new
  one), the id of its parent (given, else the innermost span open on the
  thread), its host start and end on ``time.perf_counter_ns`` and a few
  attributes (``batch``, ``steps``, ``trips``; :meth:`Span.set` sets one
  after the span has closed). Used as ``with span(...)`` it is the
  thread's innermost span until it closes; a span that outlives a
  ``yield`` is opened bare and closed with :meth:`Span.close`, and its
  children name it as ``parent``.
- A span given a CUDA ``device`` is a device span: two timing events from
  a pool, recorded on the device's current stream when it opens and when
  it closes, bracket the launches it encloses. The events are resolved
  later (:func:`spans`), by queries, never by a synchronise: each
  stretch of tracing (an on-period) takes one anchor a device, an event
  recorded on a stream of the tracer's own, where nothing is queued
  before it, paired with ``perf_counter_ns`` read just before, and each
  event is placed on the host's clock from the last one placed before
  it. :meth:`Span.marks` hands out
  events for graph nodes to record inside a launch and
  :meth:`Span.parts` turns them into device spans of the launch's parts.
- Tracing is on between :func:`enable` and :func:`disable` and while a
  ``torch.profiler`` session records (torch's own flag, read when a span
  opens); then each span also opens ``record_function("janus.<name>")``,
  so the program's names sit beside the device rows on the profiler's
  clock. Off, :func:`span` returns one shared no-op that records
  nothing, creates no event and makes no CUDA call. Set-up spans
  (``setup.*``: kernel builds and loads, graph captures and builds,
  warm-ups) are few and on no request's path: they are host spans,
  recorded on or off.
- Spans are kept in a ring of :data:`CAPACITY` (the oldest dropped and
  counted): :func:`spans` reads it, :func:`take` reads and clears it,
  :func:`report` sums it by name (count, total, self time, device time,
  and the card's idle time before each device span, put down to the
  innermost host span open when the gap ended).
- Counters (``Kernel.launches``, ``LoopGraph.trips_run``,
  ``StepGraphs.steps``, ...) are plain integers on their objects, counted
  whether tracing is on or off.

:func:`trace` is the operator's exporter: a ``torch.profiler`` Chrome
trace of a block, which holds the ``janus.*`` ranges of its spans.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import torch

__all__ = ["span", "Span", "NOOP", "enable", "disable", "spans", "take",
           "report", "dropped", "trace", "CAPACITY", "PREFIX"]

CAPACITY = 1 << 16      # spans the ring keeps
PREFIX = "janus."       # the profiler ranges' prefix
_SETUP = "setup."

_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled

_lock = threading.RLock()
_local = threading.local()
_ids = itertools.count(1)
_requests = itertools.count(1)
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_on = False
_period: Optional["_Period"] = None
_pending: collections.deque = collections.deque()   # marks, in record order
_pool: Dict[int, List[torch.cuda.Event]] = {}       # free events by device
_streams: Dict[int, torch.cuda.Stream] = {}         # the anchors' streams


class _Period:
    """One stretch of tracing: by device, the last event placed on the
    host's clock (first the anchor) and its time."""

    __slots__ = ("ref",)

    def __init__(self):
        self.ref: Dict[int, tuple] = {}


class _Mark:
    """One timing event of a device span and, once resolved, its time on
    the host's clock (``ns``; the event then goes back to the pool). A
    mark recorded by a graph node waits for its ``guard``, the stream
    event after the launch, before it is read."""

    __slots__ = ("event", "ns", "period", "device", "guard")

    def __init__(self, event, period, device):
        self.event, self.period, self.device = event, period, device
        self.ns = self.guard = None

    def done(self) -> bool:
        return self.event is None or self.event.query()


class _NoSpan:
    """The shared no-op of a span while tracing is off."""

    __slots__ = ()
    id = request = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def close(self) -> None:
        pass

    def marks(self, n: int):
        return None

    def parts(self, names: Sequence[str], marks) -> tuple:
        return (self,) * len(names)


NOOP = _NoSpan()


class Span:
    """One recorded span (see the module's docstring); made by
    :func:`span`."""

    __slots__ = ("id", "parent", "request", "name", "start_ns", "end_ns",
                 "attrs", "device", "_stream", "_marks", "_inner", "_range",
                 "_pushed")

    def __init__(self, name, request, parent, device, attrs):
        self.id = next(_ids)
        self.name, self.request, self.parent = name, request, parent
        self.attrs = attrs
        self.device = device
        self._stream = None
        self._marks: Optional[List[_Mark]] = None
        self._inner: List[_Mark] = []
        self._range = None
        self._pushed = False
        self.end_ns: Optional[int] = None
        self.start_ns = _clock()

    def __enter__(self):
        _stack().append(self)
        self._pushed = True
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def set(self, **attrs) -> None:
        """Set attributes, also after the span has closed."""
        self.attrs.update(attrs)

    def close(self) -> None:
        if self.end_ns is not None:
            return
        if self._marks is not None:
            end = _record(self.device, self._stream)
            for m in self._inner:
                m.guard = end
            self._marks.append(end)
        self.end_ns = _clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._pushed:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
            self._pushed = False

    def marks(self, n: int) -> Optional[List[torch.cuda.Event]]:
        """``n`` events, in the order the launch records them, for graph
        nodes inside this open device span's launch (None for a host
        span); :meth:`parts` reads them."""
        if self._marks is None:
            return None
        out = []
        for _ in range(n):
            m = _record(self.device)
            self._inner.append(m)
            out.append(m.event)
        return out

    def parts(self, names: Sequence[str], marks) -> tuple:
        """Device spans of the launch's parts, children of this span: the
        ``i``-th from the ``i``-th boundary (this span's start, then each
        of :meth:`marks`' events, then its end) to the next. Call after
        the span has closed."""
        if self._marks is None or marks is None:
            return (NOOP,) * len(names)
        bounds = [self._marks[0], *self._inner, self._marks[-1]]
        out = []
        for name, a, b in zip(names, bounds, bounds[1:]):
            s = Span.__new__(Span)
            s.id, s.name, s.request, s.parent = next(_ids), name, \
                self.request, self.id
            s.attrs, s.device, s._stream = {}, self.device, None
            s._marks, s._inner, s._range, s._pushed = [a, b], [], None, False
            # a part has no host extent of its own: the launch's end
            s.start_ns = s.end_ns = self.end_ns
            _keep(s)
            out.append(s)
        return tuple(out)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _keep(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(s)


def _event(device: int) -> torch.cuda.Event:
    with _lock:
        free = _pool.setdefault(device, [])
        if free:
            return free.pop()
    return torch.cuda.Event(enable_timing=True)


def _release(device: int, event) -> None:
    with _lock:
        _pool.setdefault(device, []).append(event)


def _anchor(period: _Period, device: int) -> None:
    """The period's anchor on ``device``: an event recorded on a stream of
    the tracer's own, where nothing waits before it (so the card stamps it
    as it arrives, with no synchronise), paired with the host's clock read
    just before the record. Called with the lock held."""
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    ev = _event(device)
    t = _clock()
    ev.record(stream)
    period.ref[device] = (ev, t)


def _record(device: int, stream=None) -> _Mark:
    """A mark on ``device``: its event recorded on ``stream``, or with
    None handed out for a graph node to record (an event exists once first
    recorded: a new one is recorded once on the current stream)."""
    global _period
    with _lock:
        period = _period
        if period is None:
            period = _period = _Period()
        if device not in period.ref:
            _anchor(period, device)
        free = _pool.get(device)
        ev = free.pop() if free else None
    if ev is None:
        ev = torch.cuda.Event(enable_timing=True)
    if stream is not None:
        ev.record(stream)
    elif not ev.cuda_event:
        ev.record(torch.cuda.current_stream(device))
    m = _Mark(ev, period, device)
    with _lock:
        if len(_pending) >= 2 * _ring.maxlen:
            # never read: their spans have left the ring
            old = _pending.popleft()
            _pool.setdefault(old.device, []).append(old.event)
        _pending.append(m)
    return m


def _resolve() -> None:
    """Place the finished marks on the host's clock, in the order they
    were recorded, up to the first that has not run (queries only; read
    by :func:`spans`, never on a request's path)."""
    with _lock:
        while _pending:
            m = _pending[0]
            if (m.guard is not None and not m.guard.done()) \
                    or not m.event.query():
                return
            ref_ev, ref_ns = m.period.ref[m.device]
            m.ns = ref_ns + int(round(ref_ev.elapsed_time(m.event) * 1e6))
            m.period.ref[m.device] = (m.event, m.ns)
            _pool.setdefault(m.device, []).append(ref_ev)
            m.event = None
            _pending.popleft()


def span(name: str, request: Optional[int] = None, parent=None,
         device=None, **attrs):
    """A span (see the module's docstring), or the shared no-op while
    tracing is off (a ``setup.*`` span is recorded regardless, on the host
    alone). ``device``: a ``torch.device`` (or its index); a CUDA one makes
    a device span."""
    global _period
    profiling = _profiling()
    if not (_on or profiling):
        if _period is not None:
            _period = None
        if not name.startswith(_SETUP):
            return NOOP
        device = None
    if parent is None:
        st = getattr(_local, "stack", None)
        parent = st[-1] if st else None
    if parent is NOOP:
        parent = None
    if request is None:
        request = parent.request if parent is not None else None
        if request is None:
            request = next(_requests)
    index = _cuda_index(device)
    s = Span(name, request, parent.id if parent is not None else None,
             index, attrs)
    if profiling:
        s._range = torch.profiler.record_function(PREFIX + name)
        s._range.__enter__()
    if index is not None:
        s._stream = torch.cuda.current_stream(index)
        s._marks = [_record(index, s._stream)]
    _keep(s)
    return s


def _cuda_index(device) -> Optional[int]:
    if device is None:
        return None
    if isinstance(device, int):
        return device
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def enable() -> None:
    """Turn tracing on (an operator's switch): a new on-period."""
    global _on, _period
    _period = None
    _on = True


def disable() -> None:
    """Turn the operator's switch off (a profiler session still traces)."""
    global _on, _period
    _on = False
    _period = None


def _as_dict(s: Span) -> dict:
    dev = s._marks
    d0 = d1 = None
    if dev is not None and len(dev) == 2:
        d0, d1 = dev[0].ns, dev[1].ns
    return {"id": s.id, "parent": s.parent, "request": s.request,
            "name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
            "device": s.device, "device_start_ns": d0,
            "device_end_ns": d1, "attrs": dict(s.attrs)}


def spans() -> List[dict]:
    """The ring's spans, oldest first, as dicts: ``id``, ``parent``,
    ``request``, ``name``, ``start_ns``, ``end_ns`` (None while open),
    ``device`` (a CUDA index, None for a host span), ``device_start_ns``
    and ``device_end_ns`` on the host's clock (None until the card has run
    them), ``attrs``. Finished device events are resolved first."""
    _resolve()
    with _lock:
        items = list(_ring)
    return [_as_dict(s) for s in items]


def take() -> List[dict]:
    """:func:`spans`, then the ring and its drop count cleared."""
    global _dropped
    out = spans()
    with _lock:
        _ring.clear()
        _dropped = 0
    return out


def dropped() -> int:
    """Spans the ring dropped (its oldest) since the last :func:`take`."""
    return _dropped


def _host_ns(s: dict) -> int:
    return (s["end_ns"] - s["start_ns"]) if s["end_ns"] is not None else 0


def report(records: Optional[Iterable[dict]] = None) -> Dict[str, dict]:
    """By span name: ``count``, ``total_ms`` (host), ``self_ms`` (host, the
    spans less their children), ``device_ms`` (the device spans' time on
    the card) and ``idle_ms``: the card's idle time before each device
    span (from the end of the device work before it), put down to the
    innermost host span open when the gap ended. ``records``: a list of
    :func:`spans`' dicts (default: :func:`spans`)."""
    recs = spans() if records is None else list(records)
    child_ns: Dict[int, int] = collections.defaultdict(int)
    ids = {s["id"] for s in recs}
    for s in recs:
        if s["parent"] in ids:
            child_ns[s["parent"]] += _host_ns(s)
    out: Dict[str, dict] = {}
    for s in recs:
        e = out.setdefault(s["name"], {"count": 0, "total_ms": 0.0,
                                       "self_ms": 0.0, "device_ms": 0.0,
                                       "idle_ms": 0.0})
        e["count"] += 1
        e["total_ms"] += _host_ns(s) / 1e6
        e["self_ms"] += (_host_ns(s) - child_ns[s["id"]]) / 1e6
        if s["device_start_ns"] is not None and s["device_end_ns"] is not None:
            e["device_ms"] += (s["device_end_ns"] - s["device_start_ns"]) / 1e6
    hosts = sorted((s for s in recs if _host_ns(s) > 0),
                   key=lambda s: s["start_ns"])
    by_device: Dict[int, List[dict]] = collections.defaultdict(list)
    for s in recs:
        if s["device_start_ns"] is not None and s["device_end_ns"] is not None:
            by_device[s["device"]].append(s)
    for rows in by_device.values():
        # the gaps' ends come in order: one walk over the host spans, the
        # ones begun so far on a stack, those ended before the gap popped
        reach, nxt, opened = None, 0, []
        for s in sorted(rows, key=lambda s: s["device_start_ns"]):
            t = s["device_start_ns"]
            if reach is not None and t > reach:
                while nxt < len(hosts) and hosts[nxt]["start_ns"] <= t:
                    opened.append(hosts[nxt])
                    nxt += 1
                while opened and opened[-1]["end_ns"] < t:
                    opened.pop()
                if opened:
                    out[opened[-1]["name"]]["idle_ms"] += (t - reach) / 1e6
            reach = s["device_end_ns"] if reach is None else max(
                reach, s["device_end_ns"])
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """``with trace("traces/"):`` profiles the block with ``torch.profiler``
    and writes ``trace_<pid>_<time>.json`` (Chrome trace format) under
    ``log_dir``; with ``None`` it is a zero-cost no-op. CUDA activity is
    traced when a card is present; the device's queue is drained before
    the trace stops, so the block's kernels are in it. The program's spans
    opened in the block are recorded (:func:`spans`) and appear in the
    trace as ``janus.<name>`` ranges."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
