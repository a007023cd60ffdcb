"""``BENCHMARK.json`` against the rules its readers hold it to: names,
units, text fields, and every configuration, traffic mix, driver and
metric reader found by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

from portbench.harness import lookup

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _text(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_text(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_and_cells_are_found_by_name():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _text(w["why"])
        assert w["config"] in names
        used.add(w["config"])
        t = lookup.traffic_of(w)
        assert (lookup.BENCH_DIR / "drivers" / f"{t['driver']}.py").exists()
        assert t["limits"]
    assert used == set(names)


def test_metrics_have_readers_and_their_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (lookup.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert _text(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        assert len(lookup.metrics_for(BENCH, cell, False)) >= 2
        assert lookup.metrics_for(BENCH, cell, True)
