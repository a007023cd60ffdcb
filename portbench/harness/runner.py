"""One run of one cell: set-up, the measured window, the traced part,
the check against the plain reference, and the result line.

A driver (``drivers/<name>.py``) provides

- ``prepare(ctx)``: the weights, the program, its warm-up and the
  seed's requests (set-up);
- ``window(ctx, program, seconds)``: the closed loop, returning one
  record a request (``t0``, ``t_end``, optionally ``t_first``,
  ``speech_s``, ``ok``), the window's length and the counters it read;
- ``traced(ctx, program)``: a few more requests under the profiler,
  annotated, returning the trace and what the readers take from it:
  ``spans`` (name -> (groups of device rows, count)) and ``least_s``
  (kernel -> least seconds of its launches);
- ``check(ctx, program, records)``: the comparison with the reference,
  as ``[(name, value, limit)]``, each within its limit when correct:
  ``collect`` (the program's outputs and state for a seeded sample),
  the program's state freed, ``numbers`` (the reference's comparison)
  and ``compared`` (the numbers beside their limits), which
  ``tools/calibrate.py`` also calls, with ``reseed`` and, where the
  program has a lower-precision path, ``control_program``.

Metric readers (``metrics/<name>.py``) take ``(ctx, run)`` and return a
number or None (nothing to read: the metric is left out).
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

from portbench.harness import lookup

__all__ = ["Context", "Run", "run_cell", "percentile", "FORBIDDEN",
           "forbidden_modules", "correct_of"]

FORBIDDEN = ("jax", "jaxlib", "flax", "janus_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load
    (whole names: the port's ``janus_tpu_torch`` is not ``janus_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def correct_of(checks) -> bool:
    """Whether every compared number is within its limit (``checks``:
    ``[(name, value, limit)]``, a driver's ``check``)."""
    return all(value <= limit for _, value, limit in checks)


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``
    per cent of the values at or below it (inf counts as a miss)."""
    if not values:
        return math.inf
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


@dataclass
class Context:
    root: Path
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    base: Path = lookup.BENCH_DIR
    notes: List[str] = field(default_factory=list)

    def log(self, line: str) -> None:
        """A line for standard error, printed before the checks."""
        self.notes.append(line)


@dataclass
class Run:
    records: List[dict]
    window_s: float
    setup_s: float
    counters: Dict[str, Any]
    trace: Any = None
    traced: Dict[str, Any] = field(default_factory=dict)

    @property
    def attempted(self) -> int:
        return len(self.records)

    @property
    def failed(self) -> int:
        return sum(1 for r in self.records if not r["ok"])


def _device_record(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(root: Path, bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device, started: float,
             base: Path = lookup.BENCH_DIR) -> dict:
    """The result object of one run (``started``: the process's start on
    ``time.perf_counter``)."""
    import torch

    cell = lookup.workload(bench, name)
    ctx = Context(root, cell, lookup.config_of(bench, root, cell),
                  lookup.traffic_of(cell, base), int(seed), float(seconds),
                  bool(trace), torch.device(device), base)
    drv = lookup.driver(ctx.traffic["driver"], base)
    wanted = lookup.metrics_for(bench, name, trace)
    readers = {m["name"]: lookup.reader(m["name"], base) for m in wanted}

    t_prepare = time.perf_counter()
    if trace and ctx.device.type == "cuda":
        from portbench.harness.trace import profiler_ready
        profiler_ready(ctx.device)
    program = drv.prepare(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    setup_s = time.perf_counter() - started
    ctx.log(f"setup: {t_prepare - started!r} s to the driver (imports, "
            f"the kernels' build or load, the card), "
            f"{setup_s - (t_prepare - started)!r} s in it")
    records, window_s, counters = drv.window(ctx, program, seconds)
    dev = _device_record(ctx.device)
    run = Run(records, window_s, setup_s, counters)
    if trace:
        run.trace, run.traced = drv.traced(ctx, program)
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.wall_s
        if not run.trace.rows:
            raise RuntimeError("the profiler recorded no device operation")
    checks = drv.check(ctx, program, records)
    del program
    metrics: Dict[str, dict] = {}
    for m in wanted:
        value = readers[m["name"]].read(ctx, run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = correct_of(checks)
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = run.trace.breakdown()
    result["notes"] = ctx.notes
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result
