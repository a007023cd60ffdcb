"""Everything a cell needs, found by name from ``BENCHMARK.json``: its
configuration file, its traffic file (which names its driver), the
driver ``drivers/<name>.py`` and one reader ``metrics/<metric>.py`` a
metric. Adding a cell, a mix, a driver or a metric adds files and
entries; no file here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

__all__ = ["BENCH_DIR", "load_benchmark", "workload", "config_of",
           "traffic_of", "driver", "reader", "metrics_for"]

BENCH_DIR = Path(__file__).resolve().parents[1]

_modules: Dict[Path, ModuleType] = {}


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (there are: "
                   f"{', '.join(w['name'] for w in bench['workloads'])})")


def config_of(bench: dict, root: Path, cell: dict) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")


def traffic_of(cell: dict, base: Path = BENCH_DIR) -> dict:
    with open(base / "traffic" / f"{cell['traffic']}.json") as f:
        return json.load(f)


def _load(path: Path) -> ModuleType:
    mod = _modules.get(path)
    if mod is None:
        if not path.exists():
            raise FileNotFoundError(f"{path} is missing")
        spec = importlib.util.spec_from_file_location(
            "portbench_" + path.stem.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return mod


def driver(name: str, base: Path = BENCH_DIR) -> ModuleType:
    return _load(base / "drivers" / f"{name}.py")


def reader(metric: str, base: Path = BENCH_DIR) -> ModuleType:
    return _load(base / "metrics" / f"{metric}.py")


def metrics_for(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones: those that list the cell, or list none and move an end-to-end
    metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
