"""Reading a device trace: the profiler's Chrome trace of a traced part of
a run, reduced to the device's operations, the host launches that
enqueued them, and the benchmark's own annotations around each request.

``timeline``, ``span_us``, ``launch_spans``, ``gaps_by_kind`` and
``kind_of`` are copied from the program's trace tool, so that a change to
the program cannot move the yardstick. A device operation belongs to the
host launch that shares its correlation id (one id a graph launch); a
launch belongs to the innermost annotation around its host call. The
kernels of a conditional graph node's body (a decode loop's steps) carry
no host launch's correlation id: they are the trace's ``orphans``. Spans
are unions of intervals, never first-to-last extents: inside a
conditional body the profiler's timestamps jump at every iteration, so
the orphans' union is taken apart from the rest and the two added (one
stream runs one operation at a time; the jumps can make the two sets
seem to overlap, never the body with itself).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List

__all__ = ["KINDS", "kind_of", "timeline", "span_us", "launch_spans",
           "gaps_by_kind", "Trace", "profiled", "profiler_ready",
           "ANNOTATION"]

ANNOTATION = "portbench."

KINDS = (("norm", re.compile(r"layer_norm")),
         ("attention", re.compile(r"decode_attn|attention", re.IGNORECASE)),
         ("gelu", re.compile(r"gelu", re.IGNORECASE)),
         ("mixed linear", re.compile(r"mixed_linear")))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if pattern.search(name):
            return kind
    return "other"


def timeline(trace: dict) -> List[dict]:
    """The device work of a Chrome trace (kernels, copies, memsets) in
    order of start: ``{name, cat, kind, launch, start_us, end_us,
    gap_us}``, times from the first event's start, the gap from the end of
    the event before (none for the first); ``launch`` is the profiler's
    correlation id of the host call that enqueued it."""
    events = sorted((e for e in trace.get("traceEvents", [])
                     if e.get("cat") in DEVICE_CATS),
                    key=lambda e: float(e["ts"]))
    rows: List[dict] = []
    t0 = float(events[0]["ts"]) if events else 0.0
    for e in events:
        start = float(e["ts"]) - t0
        end = start + float(e.get("dur", 0.0))
        rows.append({"name": e["name"][:160], "cat": e["cat"],
                     "kind": kind_of(e["name"]),
                     "launch": e.get("args", {}).get("correlation"),
                     "start_us": start, "end_us": end,
                     "gap_us": start - rows[-1]["end_us"] if rows else None})
    return rows


def span_us(rows: List[dict]) -> float:
    """The union of the rows' intervals: the time the device ran at least
    one of them."""
    total, reach = 0.0, None
    for row in sorted(rows, key=lambda r: r["start_us"]):
        start, end = row["start_us"], row["end_us"]
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def launch_spans(rows: List[dict]) -> List[float]:
    """:func:`span_us` of each host launch's device work, in order of the
    launches' first starts."""
    groups: Dict[object, List[dict]] = {}
    for row in rows:
        groups.setdefault(row["launch"], []).append(row)
    return [span_us(g) for g in groups.values()]


def gaps_by_kind(rows: List[dict]) -> Dict[str, dict]:
    """Each row's gap and time by its kind and the kind before it."""
    out: Dict[str, dict] = {}
    for prev, row in zip(rows, rows[1:]):
        key = f"{row['kind']} after {prev['kind']}"
        acc = out.setdefault(key, {"count": 0, "us": 0.0, "gaps": []})
        acc["count"] += 1
        acc["us"] += row["end_us"] - row["start_us"]
        acc["gaps"].append(row["gap_us"])
    return {key: {"count": a["count"], "mean_us": a["us"] / a["count"],
                  "mean_gap_us": sum(a["gaps"]) / a["count"],
                  "min_gap_us": min(a["gaps"]), "max_gap_us": max(a["gaps"])}
            for key, a in sorted(out.items(), key=lambda kv: -kv[1]["count"])}


class Trace:
    """One traced part of a run: ``rows`` (the device timeline),
    ``launches`` (correlation id -> ``{"call", "ts", "note"}``: the host
    call and the annotation around it), ``notes`` (the annotations in
    order: ``{"name", "ts", "end", "launches": [ids]}``), ``wall_s``
    (the host's synchronised clock over the traced part)."""

    def __init__(self, trace: dict, wall_s: float):
        self.wall_s = wall_s
        self.rows = timeline(trace)
        events = trace.get("traceEvents", [])
        t0 = min((float(e["ts"]) for e in events
                  if e.get("cat") in DEVICE_CATS), default=0.0)
        notes = sorted(({"name": e["name"], "ts": float(e["ts"]) - t0,
                         "end": float(e["ts"]) + float(e.get("dur", 0)) - t0,
                         "launches": []}
                        for e in events if e.get("cat") == "user_annotation"
                        and e["name"].startswith(ANNOTATION)),
                       key=lambda n: n["ts"])
        self.notes = notes
        self.launches: Dict[object, dict] = {}
        for e in sorted((e for e in events if e.get("cat") in HOST_CATS
                         and "correlation" in e.get("args", {})),
                        key=lambda e: float(e["ts"])):
            ts = float(e["ts"]) - t0
            inner = None
            for n in notes:
                if n["ts"] <= ts <= n["end"] and (
                        inner is None or n["ts"] >= inner["ts"]):
                    inner = n
            cid = e["args"]["correlation"]
            self.launches[cid] = {"call": e["name"], "ts": ts,
                                  "note": inner["name"] if inner else None}
            if inner is not None:
                inner["launches"].append(cid)
        self.by_launch: Dict[object, List[dict]] = {}
        self.orphans: List[dict] = []
        for row in self.rows:
            if row["launch"] in self.launches:
                self.by_launch.setdefault(row["launch"], []).append(row)
            else:
                self.orphans.append(row)

    @property
    def busy_s(self) -> float:
        """The device's busy time: the union of the launched rows' intervals
        plus the union of the orphans'."""
        launched = [r for g in self.by_launch.values() for r in g]
        return (span_us(launched) + span_us(self.orphans)) / 1e6

    def kernels(self, pattern: str) -> List[dict]:
        rx = re.compile(pattern)
        return [r for r in self.rows if r["cat"] == "kernel"
                and rx.search(r["name"])]

    def notes_named(self, name: str) -> List[dict]:
        return [n for n in self.notes if n["name"] == ANNOTATION + name]

    def graph_launches(self, note: dict) -> List[List[dict]]:
        """The device work of each graph launch under ``note``, in
        order."""
        return [self.by_launch[c] for c in note["launches"]
                if c in self.by_launch
                and "Graph" in self.launches[c]["call"]]

    def kernels_under(self, note: dict, pattern: str = "") -> List[dict]:
        """The kernels of the launches under ``note`` whose names match
        ``pattern``."""
        rx = re.compile(pattern)
        return [r for c in note["launches"] for r in self.by_launch.get(c, [])
                if r["cat"] == "kernel" and rx.search(r["name"])]

    def device_launches(self, note: dict) -> List[List[dict]]:
        """The device work of each host launch under ``note`` that
        enqueued any, in order of the launches' host calls."""
        return [self.by_launch[c] for c in note["launches"]
                if c in self.by_launch]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle stretches summed by the annotation and host call
        that ended them (a stretch that a loop body's kernel ends is
        summed apart: the profiler's timestamps jump there)."""
        by_name: Dict[str, float] = {}
        for r in self.rows:
            by_name[r["name"]] = by_name.get(r["name"], 0.0) + (
                r["end_us"] - r["start_us"]) / 1e6
        gaps: Dict[str, float] = {}
        reach = None
        for r in sorted(self.rows, key=lambda r: r["start_us"]):
            if reach is not None and r["start_us"] > reach:
                if r["launch"] in self.launches:
                    host = self.launches[r["launch"]]
                    note = (host["note"] or "outside a request").replace(
                        ANNOTATION, "")
                    key = f"{note}: before {host['call']}"
                else:
                    key = "inside a loop body (timestamps jump there)"
                gaps[key] = gaps.get(key, 0.0) + (r["start_us"] - reach) / 1e6
            reach = r["end_us"] if reach is None else max(reach, r["end_us"])

        def order(d):
            return sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order(by_name)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}


def profiler_ready(device) -> None:
    """One empty profiler session: a loop graph built before a process's
    first session is recorded with one body a launch, so a traced run
    opens one before it builds its graphs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)


@contextmanager
def profiled(device) -> Iterator[list]:
    """Profile the block; the list it yields receives one :class:`Trace`.
    The Chrome trace goes through a file under ``TMPDIR``, deleted once
    read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: list = []
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    out.append(Trace(raw, wall))


@contextmanager
def note(name: str) -> Iterator[None]:
    """An annotation the trace keeps around a request or a phase."""
    import torch

    with torch.profiler.record_function(ANNOTATION + name):
        yield
