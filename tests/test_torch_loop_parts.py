"""What a decode loop costs around its step, as ``tools/trace_step.py``
splits it, on the CPU: the timeline's copies and memsets beside the
kernels, each host launch's span (a graph launch, or one replay of a
run of replays), and ``trace_loop_parts``'s per-body costs from its
four runs ((a) the loop, (b) a chain of its steps, (c) the step replayed
as often, (c1) the step at its first position), each from the same
rewound state; the loop graph's trips at the exits the card is held to.
No JAX: the pieces are the port's own."""

import pytest
import torch

from janus_tpu_torch.common.config import TTSConfig
from janus_tpu_torch.models import tts as tts_mod
from janus_tpu_torch.runtime.step_graph import (LoopGraph, StepChain,
                                                StepGraph, StepGraphs)
from janus_tpu_torch.tools import trace_step


def _event(cat, name, ts, dur, launch):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": launch}}


def test_timeline_holds_copies_and_each_launchs_span():
    """Copies and memsets are device work of the timeline (a graph holds
    them as nodes of their own; inside a conditional body the card runs
    them as kernels), the kernel rows stay kernels; each host launch's
    span is the union of its events' intervals, summed apart from the
    idle time between launches."""
    trace = {"traceEvents": [
        {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 0.0,
         "dur": 5.0},
        _event("kernel", "void layer_norm_kernel<float>", 10.0, 3.0, 7),
        _event("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 14.0, 1.0, 7),
        _event("kernel", "void (anonymous namespace)::mixed_linear<4, 2>",
               12.0, 6.0, 7),
        _event("gpu_memset", "Memset (Device)", 40.0, 2.0, 9),
        _event("kernel", "loop_condition", 43.0, 2.0, 9)]}
    rows = trace_step.timeline(trace)
    assert [r["name"][:8] for r in rows] == [
        "void lay", "void (an", "Memcpy D", "Memset (", "loop_con"]
    assert [r["launch"] for r in rows] == [7, 7, 7, 9, 9]
    assert [r["gap_us"] for r in rows] == [None, -1.0, -4.0, 25.0, 1.0]
    assert trace_step.launch_spans(rows) == [8.0, 4.0]
    assert trace_step.span_us(rows) == 12.0
    assert sum(r["count"] for r in trace_step.kernel_rows(trace)) == 3


def _fake_replays(spans):
    """A stand-in for ``trace_replays`` that runs nothing on a device: it
    calls ``rewind`` and ``replay`` once each (as the real one does before
    its trace) and returns the next record of ``spans``."""
    calls = []

    def fake(replay, device, rewind=lambda: None, rounds=9, per_round=16,
             out=None, timeline_rows=None):
        rewind()
        replay()
        span, launch_sum, gap = spans[len(calls)]
        calls.append(per_round)
        return {"span_ms": span, "launch_span_sum_ms": launch_sum,
                "by_kind_pair": {"mixed linear after norm": {
                    "mean_gap_us": gap}}}
    return fake, calls


def test_trace_loop_parts_splits_the_loops_cost(monkeypatch):
    """``trace_loop_parts`` on a small AR holder (its step run eagerly on
    the CPU): every run starts from ``rewind()``; (b) is a chain of the
    loop's trips, (c) ``trips`` replays; the per-body costs are (a - b) /
    trips, (b - c) / trips (c summed over its launches) and c / trips -
    c1; no census off the card."""
    cfg = TTSConfig(d_model=64, layers=2, num_heads=4, n_mels=16, reduction=2,
                    max_text_tokens=32, max_mel_frames=48, dtype="float32")
    params = tts_mod.init_tts(torch.Generator().manual_seed(0), cfg)
    cpu = torch.device("cpu")
    graphs = StepGraphs()
    fake, calls = _fake_replays([(20.0, 20.0, -2.0), (18.0, 18.0, -1.5),
                                 (19.0, 17.5, -3.0), (1.5, 1.5, -3.5)])
    monkeypatch.setattr(trace_step, "trace_replays", fake)
    with torch.no_grad(), graphs.lock:
        h = tts_mod.ar_graph(graphs, params, cfg, 2, 11, 11, 2.0, cpu)
        h.prefill(torch.zeros((2, 8), dtype=torch.long),
                  torch.zeros((2,), dtype=torch.long))
        saved = [t.clone() for t in (h.prev, h.done)]
        rewinds = []

        def rewind():
            rewinds.append(1)
            h.prev.copy_(saved[0])
            h.done.copy_(saved[1])
            h.group.zero_()
            h.loop.trips.zero_()
            h.steps = 0

        rewind()
        h.loop.run()
        trips = int(h.loop.trips)
        assert trips == 10
        got = trace_step.trace_loop_parts(h.loop, rewind, h.advance, trips,
                                          cpu)
    assert len(rewinds) == 1 + 4 and calls == [1, 1, 1, 16]
    # (c) ran the step ``trips`` times from the rewind
    assert h.steps == 1
    assert got["trips"] == 10
    assert got["per_body_ms"] == {"a_loop": 2.0, "b_chain": 1.8,
                                  "c_replays": 1.75, "c1_step": 1.5}
    assert got["while_ms"] == pytest.approx(0.2)
    assert got["boundary_ms"] == pytest.approx(0.05)
    assert got["growth_ms"] == pytest.approx(0.25)
    assert got["norm_to_mixed_gap_us"] == {"a_loop": -2.0,
                                           "c_replays": -3.0}
    assert got["census"] == {"step": None, "body": None, "chain": None}
    assert got["build_ms"] == {"loop": 0.0, "chain": 0.0}


@pytest.mark.parametrize("exit_at", [0, 1, 2, 7, 8, 9, 17, 23, 100])
def test_loop_graph_trips_at_the_card_exits(exit_at):
    """The loop graph's eager form (the CPU's) runs a trivial step until
    every lane is done or the limit, at the exits ``chip_smoke.py`` forces
    on the card; a chain runs its ``n`` steps whatever ``done`` says."""
    done = torch.zeros(4, dtype=torch.bool)
    x = torch.zeros((), dtype=torch.int32)

    def step():
        x.add_(1)
        torch.logical_or(done, x >= exit_at, out=done)

    graph = StepGraph(step, torch.device("cpu"))
    loop = LoopGraph(graph, done, 23)
    done.fill_(exit_at == 0)
    trips = loop.run()
    assert int(trips) == int(x) == min(exit_at, 23)
    assert loop.census() is None and graph.census() is None
    chain = StepChain(graph, 5)
    x.zero_()
    done.fill_(True)
    chain.run()
    assert int(x) == 5 and chain.census() is None
