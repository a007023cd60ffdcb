"""Arithmetic the metric readers share: the requests' throughput and
latencies over the window, and the spans and rooflines that a driver's
``traced`` hands over. A driver names its groups of device work
(``spans``: name -> (groups of rows, count)) and its kernels' least
times (``least_s``: kernel -> seconds); a reader only divides."""

from __future__ import annotations

from typing import List, Optional

from portbench.harness import work
from portbench.harness.runner import percentile
from portbench.harness.trace import span_us

__all__ = ["speech_s_per_s", "latencies_ms", "p90_ms", "span_ms",
           "roofline", "mfu"]


def speech_s_per_s(run) -> Optional[float]:
    """Seconds of speech of every request the window completed over the
    window's length."""
    if run.window_s <= 0 or not run.records:
        return None
    return sum(r["speech_s"] for r in run.records if r["ok"]) / run.window_s


def latencies_ms(run, start: str = "t0", end: str = "t_end") -> List[float]:
    """Each request's time in ms; a failed request misses every limit."""
    return [1e3 * (r[end] - r[start]) if r["ok"] else float("inf")
            for r in run.records]


def p90_ms(run, end: str = "t_end") -> Optional[float]:
    if not run.records:
        return None
    return percentile(latencies_ms(run, end=end), 90.0)


def span_ms(run, name: str) -> Optional[float]:
    """The union of each of the driver's ``name`` groups' intervals,
    summed, over its count, in ms; nothing where the trace held none."""
    groups, count = run.traced.get("spans", {}).get(name, ([], 0))
    total = sum(span_us(g) for g in groups if g)
    if count <= 0 or total <= 0:
        return None
    return total / 1e3 / count


def roofline(run, kernel: str) -> Optional[float]:
    """The least time of the traced part's ``kernel`` launches (the
    driver's) over the time the kernels whose names hold ``kernel`` took,
    in per cent; nothing where none ran."""
    least = run.traced.get("least_s", {}).get(kernel)
    spent = sum(r["end_us"] - r["start_us"]
                for r in run.trace.kernels(kernel)) / 1e6
    if least is None or spent <= 0:
        return None
    return 100.0 * least / spent


def mfu(ctx, run, name: str) -> Optional[float]:
    """``least_s`` of the window's passes over its wall time, in per
    cent; both terms (operations and bytes at their peaks, as shares of
    the window) go to standard error."""
    w = run.counters.get("work")
    if not w or run.window_s <= 0:
        return None
    ctx.log(f"{name}: operations term {100 * w['flops'] / work.PEAK_FLOPS / run.window_s!r} %, "
            f"bytes term {100 * w['bytes'] / work.PEAK_BYTES / run.window_s!r} %, "
            f"window {run.window_s!r} s")
    return 100.0 * w["least_s"] / run.window_s
