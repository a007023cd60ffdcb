"""Tracing and performance counters.

The reference had no profiling at all (SURVEY.md §5 — only duration log
lines). This module provides two tools:

- :class:`StageTimer` — lightweight per-stage wall-clock accumulators with
  RTF reporting (compute-seconds per audio-second);
- :func:`trace` — a context manager around ``torch.profiler`` (host and,
  where a card is present, CUDA activity) that writes a Chrome trace
  under a directory when one is given, a no-op otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

__all__ = ["StageTimer", "trace"]


class StageTimer:
    """Accumulate wall-clock per pipeline stage; report RTF per stage."""

    def __init__(self) -> None:
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        self._audio_seconds: float = 0.0

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def add_audio_seconds(self, seconds: float) -> None:
        self._audio_seconds += seconds

    def report(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, total in self._total.items():
            n = self._count[name]
            entry = {
                "total_s": round(total, 6),
                "calls": n,
                "mean_ms": round(1e3 * total / max(n, 1), 3),
            }
            if self._audio_seconds > 0:
                entry["rtf"] = round(total / self._audio_seconds, 6)
            out[name] = entry
        return out

    def reset(self) -> None:
        self._total.clear()
        self._count.clear()
        self._audio_seconds = 0.0


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """``with trace("traces/"):`` profiles the block with ``torch.profiler``
    and writes ``trace_<pid>_<time>.json`` (Chrome trace format) under
    ``log_dir``; with ``None`` it is a zero-cost no-op. CUDA activity is
    traced when a card is present; the device's queue is drained before
    the trace stops, so the block's kernels are in it."""
    if log_dir is None:
        yield
        return
    import torch
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
