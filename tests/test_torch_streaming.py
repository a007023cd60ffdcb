"""The port's streaming transcriber against the JAX package's on the CPU:
``merge_transcripts`` on the same cases, the same partials and final from
a counting fake encoder, and from both packages' demo recognizers on a
rendered stream (after ``tests/test_streaming.py``)."""

import dataclasses
import os

import numpy as np
import pytest

from janus_tpu.common.config import JanusConfig as JJanusConfig
from janus_tpu.eval.roundtrip import load_npz_params as j_load_npz
from janus_tpu.runtime.codec import SemanticEncoder as JEncoder
from janus_tpu.runtime.streaming import StreamingTranscriber as JTranscriber
from janus_tpu.runtime.streaming import merge_transcripts as j_merge
from janus_tpu.train.demo import demo_asr_config
from janus_tpu_torch.audio.synthetic import chunk_stream, render_text
from janus_tpu_torch.common.config import ASRConfig, JanusConfig
from janus_tpu_torch.models.params import load_npz_params
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.runtime.streaming import (StreamingTranscriber,
                                               merge_transcripts)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "demo_asr.npz")


@pytest.mark.parametrize("committed,hypothesis,expected", [
    ("", "alpha bravo", "alpha bravo"),
    ("alpha bravo", "", "alpha bravo"),
    ("alpha bravo", "bravo charlie", "alpha bravo charlie"),
    ("a b c", "b c d e", "a b c d e"),
    ("alpha", "delta", "alpha delta"),
    ("a b", "a b", "a b"),
    ("a b a b", "a b a", "a b a b a"),
    ("", "", ""),
])
def test_merge_transcripts(committed, hypothesis, expected):
    assert merge_transcripts(committed, hypothesis) == expected
    assert j_merge(committed, hypothesis) == expected


class CountingEncoder:
    """Deterministic fake: one word per second of audio."""

    def encode_batch(self, phrases):
        return [{"text": " ".join(f"w{i}" for i in range(len(p) // 48_000)),
                 "prosody": {"energy": "Normal", "pitch": "Normal"}}
                for p in phrases]


def _drive(transcriber, chunks):
    partials = [transcriber.push(c) for c in chunks]
    return partials, transcriber.partial, transcriber.finalize(), \
        transcriber.partial


@pytest.mark.parametrize("window,stride,chunk_s,n", [
    (4.0, 1.0, 0.5, 12), (8.0, 1.0, 1.0, 3), (2.0, 0.5, 0.25, 30)])
def test_counting_partials_and_final_equal_jax(window, stride, chunk_s, n):
    chunk = np.zeros(int(48_000 * chunk_s), np.float32)
    ours = _drive(StreamingTranscriber(CountingEncoder(), window, stride),
                  [chunk] * n)
    ref = _drive(JTranscriber(CountingEncoder(), window, stride), [chunk] * n)
    assert ours == ref
    partials, _, final, after = ours
    assert any(p is not None for p in partials)
    assert final == " ".join(f"w{i}" for i in range(int(n * chunk_s)))
    assert after == ""


def test_memory_bound_keeps_the_suffix():
    st = StreamingTranscriber(CountingEncoder(), window_seconds=2.0,
                              stride_seconds=1.0, max_phrase_seconds=3.0)
    for _ in range(10):
        st.push(np.zeros(48_000, np.float32))
    assert st.finalize() == "w0 w1 w2"


def test_demo_encoders_give_equal_partials_and_final():
    """Both packages' demo recognizers on the same rendered stream (all
    windows inside one 2 s bucket)."""
    jenc = JEncoder(dataclasses.replace(JJanusConfig(),
                                        asr=demo_asr_config()),
                    asr_params=j_load_npz(CKPT), buckets=(96_000,))
    tenc = SemanticEncoder(dataclasses.replace(JanusConfig(),
                                               asr=ASRConfig.demo()),
                           asr_params=load_npz_params(CKPT),
                           buckets=(96_000,), device="cpu")
    audio = np.concatenate([render_text("alpha bravo", 48_000, seed=0),
                            np.zeros(4_800, np.float32),
                            render_text("kilo", 48_000, seed=1),
                            np.zeros(14_400, np.float32)])
    chunks = list(chunk_stream(audio))
    ours = _drive(StreamingTranscriber(tenc, 1.5, 0.5), chunks)
    ref = _drive(JTranscriber(jenc, 1.5, 0.5), chunks)
    assert ours == ref
    assert sum(p is not None for p in ours[0]) >= 2
    assert ours[2]  # the final transcript is not empty
