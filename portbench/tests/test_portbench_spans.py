"""The readers of the program's own spans over a synthetic store: each of
the seven metrics from the spans it names, the traced part apart from the
set-up, the set-up cut at the window's first request, and nothing (no
error) from a program without the tracer."""

from __future__ import annotations

import types

import pytest

from portbench.harness import lookup
from portbench.harness import spans as S

MS = 1_000_000
READERS = ("pad_ms.asr", "harvest_wait_ms.asr", "front_device_ms.asr",
           "step_device_ms.asr", "step_device_ms.tts", "chunk_wait_ms.tts",
           "capture_s")


def _span(i, name, t0, t1, parent=None, dev=None, request=1, **attrs):
    return {"id": i, "parent": parent, "request": request, "name": name,
            "start_ns": t0, "end_ns": t1,
            "device": 0 if dev is not None else None,
            "device_start_ns": dev[0] if dev is not None else None,
            "device_end_ns": dev[1] if dev is not None else None,
            "attrs": attrs}


# the window's first request at 10 s on the host's clock
WINDOW_S = 10.0
STORE = [
    _span(1, "setup.capture", 1 * MS, 301 * MS),
    _span(2, "setup.build", 400 * MS, 600 * MS, steps=23),
    _span(3, "setup.kernel", 0, 50 * MS, kernel="mixed_linear", built=0),
    _span(5, "setup.kernel", 0, 4_000 * MS, kernel="loop_graph", built=1),
    _span(6, "setup.warmup", 300 * MS, 9_000 * MS),
    # a capture after the window began is not the set-up's
    _span(4, "setup.capture", 10_500 * MS, 10_600 * MS),
    # two traced batches
    _span(10, "encode.submit", 20_000 * MS, 20_060 * MS, batch=8),
    _span(11, "encode.pad", 20_000 * MS, 20_050 * MS, 10),
    _span(12, "encode.front", 20_055 * MS, 20_056 * MS, 10,
          (20_056 * MS, 20_082 * MS)),
    _span(13, "encode.loop", 20_056 * MS, 20_057 * MS, 10,
          (20_082 * MS, 20_142 * MS), trips=20),
    _span(14, "encode.submit", 20_100 * MS, 20_160 * MS, batch=8, request=2),
    _span(15, "encode.pad", 20_100 * MS, 20_140 * MS, 14, request=2),
    _span(16, "encode.front", 20_150 * MS, 20_151 * MS, 14,
          (20_151 * MS, 20_175 * MS), request=2),
    _span(17, "encode.loop", 20_151 * MS, 20_152 * MS, 14,
          (20_175 * MS, 20_195 * MS), request=2, trips=10),
    _span(18, "encode.harvest", 20_160 * MS, 20_200 * MS),
    _span(19, "encode.read", 20_160 * MS, 20_190 * MS, 18),
    _span(20, "encode.harvest", 20_200 * MS, 20_220 * MS, request=2),
    _span(21, "encode.read", 20_200 * MS, 20_210 * MS, 20, request=2),
    # a stream: two chunks, one dones read
    _span(30, "stream.request", 30_000 * MS, 30_400 * MS, request=3),
    _span(31, "stream.decode", 30_010 * MS, 30_011 * MS, 30,
          (30_011 * MS, 30_027 * MS), request=3, steps=16),
    _span(32, "stream.dones", 30_011 * MS, 30_028 * MS, 30, request=3),
    _span(33, "stream.read", 30_030 * MS, 30_034 * MS, 30, request=3),
    _span(34, "stream.read", 30_100 * MS, 30_103 * MS, 30, request=3),
    # a synthesis: its WHILE part
    _span(40, "synth.loop", 40_400 * MS, 40_400 * MS, 41,
          (40_005 * MS, 40_329 * MS), request=4, steps=240),
    _span(41, "synth.launch", 40_000 * MS, 40_400 * MS, request=4),
]


@pytest.fixture
def store(monkeypatch):
    monkeypatch.setattr(S, "program_spans", lambda: [dict(s) for s in STORE])


def _ctx():
    notes = []
    return types.SimpleNamespace(log=notes.append, notes=notes)


def _run():
    return types.SimpleNamespace(records=[{"t0": WINDOW_S + 1.0},
                                          {"t0": WINDOW_S}])


EXPECTED = {
    "pad_ms.asr": 45.0,                          # median of 50 and 40
    "harvest_wait_ms.asr": 20.0,                 # median of 30 and 10
    "front_device_ms.asr": 25.0,                 # mean of 26 and 24
    "step_device_ms.asr": (60 + 20) / (20 + 10),
    "step_device_ms.tts": (16 + 324) / (16 + 240),
    "chunk_wait_ms.tts": (17 + 4 + 3) / 2,       # two chunks read
    "capture_s": (300 + 200) / 1e3,              # before the window only
}


@pytest.mark.parametrize("name", READERS)
def test_reader_over_a_synthetic_store(store, name):
    got = lookup.reader(name).read(_ctx(), _run())
    assert got == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_tracer_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(S, "program_spans", lambda: None)
    assert lookup.reader(name).read(_ctx(), _run()) is None


def test_the_traced_part_leaves_out_the_set_up(store):
    assert {s["name"] for s in S.traced()} >= {"encode.pad", "synth.loop"}
    assert not any(s["name"].startswith("setup.") for s in S.traced())
    assert [s["id"] for s in S.setup(_run(), "setup.capture")] == [1]


def test_the_summary_names_each_span_and_the_split_requests(store):
    ctx = _ctx()
    S.summary(ctx)
    assert "stream.dones n 1" in ctx.notes[0]
    # an encode's submit and harvest share their request: no split tree
    assert ctx.notes[1] == "program spans: 4 requests, split trees none"


def test_the_set_up_summary_splits_builds_loads_and_warm_up(store):
    ctx = _ctx()
    S.setup_summary(ctx, _run())
    (line,) = ctx.notes
    assert line.startswith("set-up spans: setup.build n 1 0.2 s, "
                           "setup.capture n 1 0.3 s, ")
    assert "setup.kernel.built n 1 4.0 s, setup.kernel.loaded n 1 0.05 s, "\
        "setup.warmup n 1 8.7 s; kernels built ['loop_graph'], " in line
    assert "Kernel.builds " in line and "Kernel.loads " in line


def test_the_set_up_summary_without_the_tracer_says_nothing(monkeypatch):
    monkeypatch.setattr(S, "program_spans", lambda: None)
    ctx = _ctx()
    S.setup_summary(ctx, _run())
    assert ctx.notes == []
