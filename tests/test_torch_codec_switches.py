"""The send path's two wire and pitch switches against the JAX package on
the CPU: the μ-law audio wire (``runtime.encode_transfer_ulaw``) and YIN
at the native 48 kHz capture rate (``prosody.yin_rate = 0``), each with
the committed demo recognizer and byte-equal packets."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.audio.ulaw import ulaw_decode as j_ulaw_decode
from janus_tpu.audio.ulaw import ulaw_encode as j_ulaw_encode
from janus_tpu.common.config import JanusConfig as JJanusConfig
from janus_tpu.eval.roundtrip import load_npz_params as j_load_npz
from janus_tpu.runtime.codec import SemanticEncoder as JEncoder
from janus_tpu.train.demo import demo_asr_config
from janus_tpu_torch.audio.synthetic import render_text, voiced_phrase
from janus_tpu_torch.audio.ulaw import ulaw_decode, ulaw_encode
from janus_tpu_torch.common.config import ASRConfig, JanusConfig
from janus_tpu_torch.models.params import load_npz_params
from janus_tpu_torch.runtime.codec import SemanticEncoder

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "demo_asr.npz")
TEXTS = ("alpha bravo", "fox golf hotel", "kilo lima")
TIMESTAMP = 1_700_000_000.25


def test_ulaw_codes_equal_and_decode_close_to_jax():
    w = render_text("alpha bravo charlie", 48_000, seed=3)
    w = np.concatenate([w, np.linspace(-1.2, 1.2, 1001, dtype=np.float32)])
    codes = ulaw_encode(w)
    np.testing.assert_array_equal(codes, j_ulaw_encode(w))
    every = np.arange(256, dtype=np.uint8)
    out = ulaw_decode(torch.from_numpy(every)).numpy()
    assert out.dtype == np.float32
    # float32 pow in two libraries: a few ulps of |x| <= 1
    np.testing.assert_allclose(out, np.asarray(j_ulaw_decode(
        jnp.asarray(every))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("switch", [{"runtime.encode_transfer_ulaw": True},
                                    {"prosody.yin_rate": 0}],
                         ids=["ulaw_wire", "yin_48k"])
def test_switch_packets_byte_equal(switch):
    jcfg = dataclasses.replace(JJanusConfig(),
                               asr=demo_asr_config()).override(**switch)
    tcfg = dataclasses.replace(JanusConfig(),
                               asr=ASRConfig.demo()).override(**switch)
    jenc = JEncoder(jcfg, asr_params=j_load_npz(CKPT), buckets=(96_000,))
    tenc = SemanticEncoder(tcfg, asr_params=load_npz_params(CKPT),
                           buckets=(96_000,), device="cpu")
    phrases = [render_text(t, 48_000, seed=s) for s, t in enumerate(TEXTS)]
    for phrase in phrases:
        jpkt = jenc.encode_packet(phrase, timestamp=TIMESTAMP)
        tpkt = tenc.encode_packet(phrase, timestamp=TIMESTAMP)
        assert (jpkt is None) == (tpkt is None)
        if tpkt is not None:
            assert tpkt.serialize() == jpkt.serialize()
    phrases.append(voiced_phrase(f0=150.0, seconds=1.5, amp=0.1, seed=4))
    ref = jenc.encode_batch(phrases)
    out = tenc.encode_batch(phrases)
    for a, b in zip(out, ref):
        assert a["text"] == b["text"] and a["prosody"] == b["prosody"]
        # Hz and linear rms, the tolerances of test_torch_codec.py
        assert abs(a["f0"] - b["f0"]) < 1e-2
        assert abs(a["rms"] - b["rms"]) < 1e-6
    assert out[-1]["f0"] > 0
