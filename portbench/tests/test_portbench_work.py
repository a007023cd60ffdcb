"""The least-work counts against bounds the port's measurements printed
at the same shapes (one H100: 989 TFLOP/s, 3.35 TB/s), and the trace
arithmetic and readers on a hand-made Chrome trace."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness import lookup, weights as W, work
from portbench.harness.trace import Trace, span_us

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / name).read_text())


@pytest.mark.parametrize("k,n,us", [(1280, 5120, 3.923), (5120, 1280, 3.921),
                                    (1280, 1280, 0.982), (320, 1280, 0.247)])
def test_mixed_linear_bound_at_one_row(k, n, us):
    assert work.least_s(work.mixed_linear(1, k, n)) * 1e6 == pytest.approx(
        us, abs=6e-4)


def test_cross_decode_attention_bound():
    # q [8, 20, 1, 64] over a bf16 cache of 500 rows
    assert work.least_s(work.decode_attention(8, 20, 1, 64, 500)) * 1e6 \
        == pytest.approx(6.126, abs=6e-4)


def test_model_sizes_and_step_bounds():
    tts = _config("janus-tts-flagship.json")["tts"]
    assert W.count_params(W.tts_leaves(tts, 261, -5.0)) == 595_406_401
    from portbench.drivers import asr_encode
    m = asr_encode.model_dims(_config("whisper-large-v3.json"))
    assert W.count_params(W.asr_leaves(m)) == sum(work.asr_params(m))
    # a b 1 AR step reads its 1.19 GB of bf16 weights once: ~0.355 ms
    lin = sum(work.least_s(work.mixed_linear(r, k, n, bias=b))
              for r, k, n, b in work.ar_step_mixed_linears(tts))
    assert lin * 1e3 == pytest.approx(0.3546, abs=1e-3)
    # a b 8 x 10 s encoder pass is bound by its operations: ~5.5 ms
    flops, nbytes = work.encoder_pass(m, 8, 1000)
    assert flops / work.PEAK_FLOPS > nbytes / work.PEAK_BYTES
    assert work.least_s((flops, nbytes)) * 1e3 == pytest.approx(5.47, abs=0.05)


def _event(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_trace_attributes_device_work_to_notes_and_launches():
    raw = {"traceEvents": [
        _event("user_annotation", "portbench.submit.0", 0, 100),
        _event("cuda_runtime", "cudaMemcpyAsync", 1, 1, 1),
        _event("cuda_runtime", "cudaGraphLaunch", 2, 1, 2),
        _event("cuda_runtime", "cudaGraphLaunch", 3, 1, 3),
        _event("gpu_memcpy", "Memcpy HtoD", 10, 2, 1),
        _event("kernel", "mel_log10_fft", 12, 5, 2),
        _event("kernel", "flash_fwd", 16, 4, 2),     # overlaps the one before
        _event("kernel", "loop_condition", 28, 1, 3),
        # a loop's body: no host launch's correlation, and the second
        # body's timestamp jumped into the next launch's work
        _event("kernel", "decode_attn_kernel", 30, 3, 0),
        _event("kernel", "decode_attn_kernel", 305, 2, 0),
        _event("cuda_runtime", "cudaGraphLaunch", 200, 1, 4),
        _event("kernel", "outside", 300, 10, 4),
    ]}
    t = Trace(raw, wall_s=400e-6)
    note = t.notes_named("submit.0")[0]
    assert note["launches"] == [1, 2, 3]
    assert [len(g) for g in t.device_launches(note)] == [1, 2, 1]
    assert len(t.orphans) == 2
    assert span_us(t.by_launch[2]) == pytest.approx(8.0)
    # the body's union apart from the launched work's: 2 + 8 + 1 + 10, 3 + 2
    assert t.busy_s == pytest.approx(26e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["outside", pytest.approx(10e-6)]

    spans = lookup.driver("asr_encode").trace_spans(t, 1, 2)
    run = SimpleNamespace(trace=t, traced={"spans": spans})
    front = lookup.reader("front_ms.asr").read(None, run)
    loop = lookup.reader("loop_body_ms.asr").read(None, run)
    assert front == pytest.approx(8e-3)
    assert loop == pytest.approx(5e-3 / 2)
    assert lookup.reader("ar_step_ms.tts").read(None, run) is None
