"""A rehearsal of the harness on the CPU at tiny widths: the lookup by
name, the window, the percentiles, the check against the reference and
the result line, for each driver; the same run with the timed path
broken underneath, which must come out not correct; and the refusal to
run a real cell without a card."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import lookup, runner

ROOT = Path(__file__).resolve().parents[2]

TINY_WHISPER = {
    "name": "tiny-whisper", "source": "test", "model_type": "whisper",
    "d_model": 64, "encoder_layers": 2, "decoder_layers": 2,
    "encoder_attention_heads": 4, "decoder_attention_heads": 4,
    "encoder_ffn_dim": 256, "decoder_ffn_dim": 256, "num_mel_bins": 80,
    "vocab_size": 261, "max_source_positions": 1500,
    "max_target_positions": 48, "torch_dtype": "float32",
    "port": {"weight_seed": 3, "prompt": [256], "eot": 257,
             "prosody": {"energy_quiet": 0.05, "energy_loud": 0.15,
                         "pitch_deep_hz": 120.0, "pitch_high_hz": 200.0}}}
TINY_TTS = {
    "name": "tiny-tts", "source": "test", "dtype": "float32",
    "tts": {"d_model": 64, "layers": 2, "num_heads": 4, "mlp_ratio": 4,
            "n_mels": 80, "reduction": 4, "max_text_tokens": 256,
            "max_mel_frames": 64},
    "vocoder": {"n_fft": 1024, "hop_length": 256, "d_model": 32,
                "layers": 2, "sample_rate": 24000},
    "port": {"weight_seed": 4, "stop_bias": -5.0, "text_vocab": 261,
             "pad": 258, "seconds_per_text_byte": 0.15}}
# the numbers the send cells compare (enc_rel and kv_rel are read, not
# compared: the int8 control parts from the program by under 3x there)
LIM_ASR = {"kv_first_rel": 1e-4, "token_gap": 1e-3,
           "f0_rel": 1e-3, "rms_rel": 1e-4, "code_mismatch": 0.0}
LIM_TTS = {"mel_gap": 1e-3, "mel_rms_gap": 1e-4, "pcm_gap": 1e-3}
TRAFFIC = {
    "asr": {"driver": "asr_encode", "batch": 2, "seconds": [0.5, 1.0],
            "variants": 1, "bucket_s": 2, "f0_hz": [90.0, 260.0],
            "amp": [0.03, 0.3], "max_decode_tokens": 4,
            "warm_batches": 1, "trace_batches": 1, "sample_batches": 1,
            "limits": LIM_ASR},
    "stream": {"driver": "tts_stream", "text_bytes": [1, 2],
               "trace_packets": 1, "sample_packets": 2,
               "limits": LIM_TTS},
    "synth": {"driver": "tts_synth", "text_bytes": [1, 2],
              "trace_packets": 1, "sample_packets": 2, "limits": LIM_TTS},
}


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A benchmark over tiny configurations whose files lie in
    ``tmp_path``; the drivers and readers are the real ones. The graph
    holders run their steps eagerly on the CPU."""
    from janus_tpu_torch.runtime import codec, streaming_tts, synthesizer

    for mod in (codec, synthesizer, streaming_tts):
        monkeypatch.setattr(mod, "use_graphs",
                            lambda device, eager=False: not eager)
    for c in (TINY_WHISPER, TINY_TTS):
        (tmp_path / f"{c['name']}.json").write_text(json.dumps(c))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": c["name"], "file": f"{c['name']}.json"}
                        for c in (TINY_WHISPER, TINY_TTS)]
    bench["workloads"] = [
        {"name": "asr", "config": "tiny-whisper", "traffic": "asr",
         "chips": 1},
        {"name": "stream", "config": "tiny-tts", "traffic": "stream",
         "chips": 1},
        {"name": "synth", "config": "tiny-tts", "traffic": "synth",
         "chips": 1}]
    paths = {"asr": ["asr"], "tts": ["stream", "synth"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
        path = m["name"].rsplit(".", 1)[-1]
        if m["name"].startswith("first_"):
            m["workloads"] = ["stream"]
        elif path in paths:
            m["workloads"] = paths[path]
    monkeypatch.setattr(lookup, "traffic_of",
                        lambda cell, base=None: TRAFFIC[cell["traffic"]])
    return tmp_path, bench


def _run(tiny, cell, seconds=1.0):
    root, bench = tiny
    return runner.run_cell(root, bench, cell, 2 ** 31 + 11, seconds, False,
                           "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", ["asr", "stream", "synth"])
def test_a_cell_runs_and_checks_on_the_cpu(tiny, cell):
    res = _run(tiny, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    path = "asr" if cell == "asr" else "tts"
    want = {f"speech_s_per_s.{path}", f"latency_p90_ms.{path}",
            "setup_s"} | ({"first_audio_p90_ms"} if cell == "stream"
                          else set())
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    json.dumps({k: v for k, v in res.items() if k != "notes"})


def _alter_token(monkeypatch):
    from janus_tpu_torch.models import asr

    real = asr.GreedyGraph.run_loop

    def broken(self):
        tokens, trips = real(self)
        tokens[0, 1] = (tokens[0, 1] + 1) % 261
        return tokens, trips
    monkeypatch.setattr(asr.GreedyGraph, "run_loop", broken)


def _alter_group(monkeypatch):
    from janus_tpu_torch.models import tts

    real = tts._step

    def broken(*a, **k):
        nxt, done = real(*a, **k)
        return nxt + 0.1, done
    monkeypatch.setattr(tts, "_step", broken)


def _alter_pcm(monkeypatch):
    import numpy as np
    from janus_tpu_torch.runtime.streaming_tts import StreamingSynthesizer

    real = StreamingSynthesizer.stream_pcm16

    def broken(self, *a, **k):
        for i, chunk in enumerate(real(self, *a, **k)):
            if i == 0:
                x = np.frombuffer(chunk, np.int16).copy()
                x[len(x) // 2] ^= 0x4000
                chunk = x.tobytes()
            yield chunk
    monkeypatch.setattr(StreamingSynthesizer, "stream_pcm16", broken)


@pytest.mark.parametrize("cell,fault", [
    ("asr", _alter_token), ("stream", _alter_group), ("synth", _alter_group),
    ("stream", _alter_pcm)])
def test_a_fault_in_the_timed_path_is_not_correct(tiny, monkeypatch, cell,
                                                  fault):
    fault(monkeypatch)
    res = _run(tiny, cell)
    assert not res["correct"], res["checks"]


def test_without_a_card_a_real_cell_exits_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tts-stream",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no CPU fallback" in out.stderr


def test_nearest_rank_percentile():
    xs = list(range(1, 101))
    assert runner.percentile(xs, 90) == 90
    assert runner.percentile([5.0], 90) == 5.0
    assert runner.percentile([1.0, math.inf], 90) == math.inf


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tts-synth", "asr-sessions-b64"])
def test_a_real_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 7), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res
