"""Reading the program's own spans: what ``janus_tpu_torch.runtime.
profiling.spans()`` recorded in a run. Tracing is on while the profiler
records, so the store holds the traced part's spans and the set-up spans
(``setup.*``, recorded whether tracing is on or off). Nothing here clears
the store. A program without that tracer gives nothing to read (None),
and the readers then leave their metrics out."""

from __future__ import annotations

import statistics
from typing import List, Optional

__all__ = ["program_spans", "traced", "setup", "host_ms", "device_ms",
           "median_host_ms", "summary", "setup_summary"]

SETUP = "setup."


def program_spans() -> Optional[List[dict]]:
    """Every span the program's tracer holds, or None where it has none."""
    try:
        from janus_tpu_torch.runtime import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if callable(read) else None


def traced(*names: str) -> List[dict]:
    """The traced part's spans named ``names`` (every name: all of them)."""
    recs = program_spans() or []
    return [s for s in recs if not s["name"].startswith(SETUP)
            and (not names or s["name"] in names)]


def setup(run, *names: str) -> List[dict]:
    """The set-up spans named ``names`` that ended before the window's
    first request (the clocks are one: ``perf_counter`` and
    ``perf_counter_ns``)."""
    if not run.records:
        return []
    first_ns = int(min(r["t0"] for r in run.records) * 1e9)
    return [s for s in program_spans() or [] if s["name"] in names
            and s["end_ns"] is not None and s["end_ns"] <= first_ns]


def host_ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def device_ms(s: dict) -> Optional[float]:
    if s["device_start_ns"] is None or s["device_end_ns"] is None:
        return None
    return (s["device_end_ns"] - s["device_start_ns"]) / 1e6


def median_host_ms(name: str) -> Optional[float]:
    """The median host time of the traced part's ``name`` spans."""
    times = [host_ms(s) for s in traced(name) if s["end_ns"] is not None]
    return statistics.median(times) if times else None


def summary(ctx) -> None:
    """The traced part's spans summed by name (the tracer's ``report``:
    host, self, device and the card's idle time put down to the host span
    open when each gap ended) and the requests whose spans do not form one
    tree, for standard error."""
    recs = traced()
    if not recs:
        return
    from janus_tpu_torch.runtime import profiling

    ids = {s["id"]: s for s in recs}
    roots: dict = {}
    for s in recs:
        if ids.get(s["parent"]) is None:
            roots.setdefault(s["request"], []).append(s["name"])
    split = {r: n for r, n in roots.items() if len(n) > 1
             and not {"encode.submit", "encode.harvest"} >= set(n)}
    rep = profiling.report(recs)
    ctx.log("program spans: " + ", ".join(
        f"{k} n {v['count']} total {v['total_ms']!r} self {v['self_ms']!r} "
        f"device {v['device_ms']!r} idle {v['idle_ms']!r} ms"
        for k, v in rep.items()))
    ctx.log(f"program spans: {len(roots)} requests, split trees "
            f"{split if split else 'none'}")


def setup_summary(ctx, run) -> None:
    """The set-up's spans that ended before the window, summed by name in
    seconds, ``setup.kernel`` split into builds and loads with the kernels
    built named, and the kernels' ``builds`` / ``loads`` counters, for
    standard error."""
    recs = setup(run, "setup.kernel", "setup.capture", "setup.build",
                 "setup.warmup")
    if not recs:
        return
    parts: dict = {}
    built = []
    for s in recs:
        name = s["name"]
        if name == "setup.kernel":
            name += ".built" if s["attrs"].get("built") else ".loaded"
            if s["attrs"].get("built"):
                built.append(s["attrs"].get("kernel"))
        n, t = parts.get(name, (0, 0.0))
        parts[name] = (n + 1, t + host_ms(s) / 1e3)
    from janus_tpu_torch.ops import cuda_build

    builds = sum(getattr(k, "builds", 0) for k in cuda_build.KERNELS.values())
    loads = sum(getattr(k, "loads", 0) for k in cuda_build.KERNELS.values())
    ctx.log("set-up spans: " + ", ".join(
        f"{k} n {n} {t!r} s" for k, (n, t) in sorted(parts.items()))
        + f"; kernels built {built if built else 'none'}, "
        f"Kernel.builds {builds} Kernel.loads {loads}")
