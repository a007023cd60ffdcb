"""The port's phrase segmenter and VAD against the JAX package on the CPU:
the same chunk sequences give the same events and bit-equal phrases; the
energy gate gives the same probabilities, noise floor and decisions over
a long stream; the model gate with the JAX package's ``init_vad`` weights
gives the same probabilities (tolerances: ``tests/test_segmenter_vad.py``;
probabilities within 1e-6 for the energy gate, 1e-5 for the model)."""

import numpy as np
import pytest
import torch

from janus_tpu.common.config import SegmenterConfig as JSegmenterConfig
from janus_tpu.common.config import VADConfig as JVADConfig
from janus_tpu.models import vad as j_vad
from janus_tpu.runtime.segmenter import PhraseSegmenter as JSegmenter
from janus_tpu_torch.audio.synthetic import chunk_stream, conversation
from janus_tpu_torch.common.config import SegmenterConfig, VADConfig
from janus_tpu_torch.models import vad as t_vad
from janus_tpu_torch.models.params import params_from_jax
from janus_tpu_torch.runtime.segmenter import PhraseSegmenter, SegmenterEvent

CHUNK = 1536


def _chunk(value, rng=None):
    if rng is None:
        return np.full(CHUNK, value, dtype=np.float32)
    return (value * rng.standard_normal(CHUNK)).astype(np.float32)


# -- the segmenter ----------------------------------------------------------

def _script(name):
    """(op, chunk, flag) steps: op "s" = push_streaming(chunk, is_speech),
    "p" = push_ptt(chunk, held), "f" = flush, "r" = reset."""
    rng = np.random.default_rng(sum(map(ord, name)))
    steps = []
    if name == "streaming":
        for v in range(3):
            steps.append(("s", _chunk(0.01 * v, rng), False))
        steps += [("s", _chunk(0.5, rng), True) for _ in range(6)]
        steps += [("s", _chunk(0.01, rng), False) for _ in range(16)]
    elif name == "silence_resets":
        steps.append(("s", _chunk(0.5, rng), True))
        steps += [("s", _chunk(0.0), False) for _ in range(10)]
        steps.append(("s", _chunk(0.5, rng), True))
        steps += [("s", _chunk(0.0), False) for _ in range(16)]
    elif name == "ptt":
        steps += [("p", _chunk(0.3, rng), True) for _ in range(8)]
        steps.append(("p", _chunk(0.0), False))
        steps.append(("p", _chunk(0.0), False))
    elif name == "short_drop":
        steps += [("p", _chunk(0.5, rng), True) for _ in range(2)]
        steps.append(("p", _chunk(0.0), False))
        steps.append(("s", _chunk(0.5, rng), True))
        steps += [("s", _chunk(0.0), False) for _ in range(16)]
    elif name == "pre_roll_cap":
        steps += [("s", _chunk(float(i)), False) for i in range(25)]
        steps.append(("s", _chunk(99.0), True))
        steps += [("s", _chunk(0.0), False) for _ in range(16)]
    elif name == "flush":
        steps += [("s", _chunk(0.5, rng), True) for _ in range(7)]
        steps += [("f", None, None), ("f", None, None)]
        steps += [("s", _chunk(0.5, rng), True) for _ in range(3)]
        steps += [("r", None, None), ("f", None, None)]
    elif name == "random":
        # a long random stream of speech/silence runs with PTT holds
        for _ in range(60):
            kind = rng.integers(0, 3)
            n = int(rng.integers(1, 25))
            for _ in range(n):
                if kind == 2:
                    steps.append(("p", _chunk(0.2, rng), True))
                else:
                    steps.append(("s", _chunk(0.2, rng), bool(kind)))
            if kind == 2:
                steps.append(("p", _chunk(0.0), False))
        steps.append(("f", None, None))
    return steps


def _run(seg, steps):
    out = []
    for op, chunk, flag in steps:
        if op == "s":
            r = seg.push_streaming(chunk, flag)
        elif op == "p":
            r = seg.push_ptt(chunk, flag)
        elif op == "f":
            r = seg.flush()
        else:
            seg.reset()
            continue
        out.append((r.event.value, r.phrase, seg.is_open, seg.ptt_held,
                    seg.buffered_samples))
    return out


@pytest.mark.parametrize("name", ["streaming", "silence_resets", "ptt",
                                  "short_drop", "pre_roll_cap", "flush",
                                  "random"])
def test_segmenter_events_and_phrases_equal_jax(name):
    steps = _script(name)
    ours = _run(PhraseSegmenter(SegmenterConfig()), steps)
    ref = _run(JSegmenter(JSegmenterConfig()), steps)
    assert len(ours) == len(ref)
    ready = 0
    for (ev, ph, *flags), (rev, rph, *rflags) in zip(ours, ref):
        assert ev == rev and flags == rflags
        assert (ph is None) == (rph is None)
        if ph is not None:
            ready += 1
            assert ph.dtype == rph.dtype
            np.testing.assert_array_equal(ph, rph)
    assert ready > 0 or name == "short_drop"


def test_segmenter_config_equals_jax():
    assert SegmenterConfig() == SegmenterConfig(**vars(JSegmenterConfig()))
    seg = PhraseSegmenter()
    seg.push_streaming(_chunk(0.5), True)
    assert seg.is_open and seg.push_streaming(
        _chunk(0.0), False).event is SegmenterEvent.NONE


# -- the energy gate --------------------------------------------------------

def _vad_stream():
    """200 chunks: a three-turn conversation, then loud noise."""
    conv = list(chunk_stream(conversation(turns=3, speech_seconds=1.0,
                                          silence_seconds=0.6, amp=0.3)))
    rng = np.random.default_rng(1)
    loud = (0.05 * rng.standard_normal((200 - len(conv), CHUNK))
            ).astype(np.float32)
    return conv + list(loud)


def test_energy_gate_matches_jax_over_a_long_stream():
    stream = _vad_stream()
    assert len(stream) == 200
    ours = t_vad.VoiceActivityDetector(VADConfig(backend="energy"),
                                       device="cpu")
    ref = j_vad.VoiceActivityDetector(JVADConfig(backend="energy"))
    decisions, ref_decisions = [], []
    for chunk in stream:
        p, rp = ours.speech_prob(chunk), ref.speech_prob(chunk)
        assert abs(p - rp) <= 1e-6
        floor, rfloor = float(ours._floor), float(ref._floor)
        assert abs(floor - rfloor) <= 1e-6 * abs(rfloor)
        assert ours._floor.dtype == torch.float32 and ours._floor.dim() == 0
        decisions.append(p > 0.5)
        ref_decisions.append(rp > 0.5)
    assert decisions == ref_decisions
    assert any(decisions[:100]) and not all(decisions[:100])


def test_energy_gate_function_matches_jax():
    rng = np.random.default_rng(2)
    x = (0.1 * rng.standard_normal((5, 512))).astype(np.float32)
    for floor in (1e-3, 0.02, 0.5):
        p, f = t_vad.energy_gate_prob(torch.from_numpy(x),
                                      torch.tensor(floor), 0.015)
        rp, rf = j_vad.energy_gate_prob(x, np.float32(floor), 0.015)
        np.testing.assert_allclose(p.numpy(), np.asarray(rp), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(f.numpy(), np.asarray(rf), rtol=1e-6)


# -- the model gate ---------------------------------------------------------

@pytest.fixture(scope="module")
def model_params():
    jp = j_vad.init_vad(0)
    return jp, params_from_jax(jp)


def test_model_gate_matches_jax(model_params):
    jp, tp = model_params
    rng = np.random.default_rng(3)
    for x in (np.zeros((4, 512), np.float32),
              (0.2 * rng.standard_normal((4, 512))).astype(np.float32),
              (0.05 * rng.standard_normal(512)).astype(np.float32)):
        out = t_vad.vad_model_prob(tp, torch.from_numpy(x)).numpy()
        ref = np.asarray(j_vad.vad_model_prob(jp, x))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_model_detector_matches_jax_on_single_chunks(model_params):
    jp, tp = model_params
    ours = t_vad.VoiceActivityDetector(VADConfig(backend="model"), params=tp,
                                       device="cpu")
    ref = j_vad.VoiceActivityDetector(JVADConfig(backend="model"), params=jp)
    assert ours.backend == ref.backend == "model"
    for chunk in _vad_stream()[::20]:
        assert abs(ours.speech_prob(chunk) - ref.speech_prob(chunk)) <= 1e-5
        assert isinstance(ours.is_speech(chunk), bool)


def test_seeded_init_has_the_jax_shapes(model_params):
    jp, _ = model_params
    ours = t_vad.init_vad(torch.Generator().manual_seed(0))
    for layer in ("fc1", "fc2", "out"):
        for name in ("w", "b"):
            assert tuple(ours[layer][name].shape) == jp[layer][name].shape


def test_backend_choice_and_reset():
    assert t_vad.VoiceActivityDetector(device="cpu").backend == "energy"
    vad = t_vad.VoiceActivityDetector(VADConfig(backend="energy"),
                                      device="cpu")
    for _ in range(10):
        vad.is_speech(np.full(CHUNK, 0.2, np.float32))
    assert float(vad._floor) > 1e-3
    vad.reset()
    assert float(vad._floor) == pytest.approx(1e-3)
    assert vad._floor.dtype == torch.float32
