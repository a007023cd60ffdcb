"""The receive side as a whole against the JAX package on the CPU:
``Synthesizer`` on the committed demo and hard checkpoints, streaming
against fused synthesis, routing and the failure ladder, voice-clone hot
reload, the duration cap, and the send → receive → send round trip."""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from janus_tpu.common.protocol import JanusMode as JJanusMode
from janus_tpu.common.protocol import JanusPacket as JJanusPacket
from janus_tpu.models import zoo as j_zoo
from janus_tpu.runtime.codec import SemanticEncoder as JEncoder
from janus_tpu.runtime.synthesizer import Synthesizer as JSynthesizer
from janus_tpu.train import demo as j_demo
from janus_tpu_torch.audio.synthetic import render_text, voiced_phrase
from janus_tpu_torch.audio.wav import write_wav
from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.protocol import JanusMode, JanusPacket
from janus_tpu_torch.models import tts as t_tts
from janus_tpu_torch.models import vocoder as t_voc
from janus_tpu_torch.models import zoo as t_zoo
from janus_tpu_torch.models.params import load_npz_params
from janus_tpu_torch.ops.morse import morse_audio
from janus_tpu_torch.ops.resample import resample_poly
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.runtime.streaming_tts import StreamingSynthesizer
from janus_tpu_torch.runtime.synthesizer import Synthesizer

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
DEMO_TEXTS = ("alpha bravo", "fox golf hotel", "kilo lima")
BASE = JanusConfig()


def small_cfg(**over):
    """The geometry of the JAX package's ``tests/test_synthesis.py``."""
    return JanusConfig().override(**{
        "tts.d_model": 64, "tts.layers": 2, "tts.num_heads": 4,
        "tts.n_mels": 16, "tts.max_text_tokens": 32,
        "tts.max_mel_frames": 32, "vocoder.d_model": 64,
        "vocoder.layers": 2, "vocoder.n_fft": 256, "vocoder.hop_length": 64,
        **over})


def stream_cfg():
    """The geometry of the JAX package's ``tests/test_streaming_tts.py``."""
    return JanusConfig().override(**{
        "tts.d_model": 64, "tts.layers": 2, "tts.num_heads": 4,
        "tts.n_mels": 20, "tts.max_mel_frames": 192,
        "tts.max_text_tokens": 32, "vocoder.d_model": 48,
        "vocoder.layers": 3, "vocoder.n_fft": 256, "vocoder.hop_length": 64,
        "vocoder.sample_rate": 24_000})


def _pcm(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32767.0


# -- the committed checkpoints ----------------------------------------------

@pytest.fixture(scope="module")
def demo_pair():
    jb = j_zoo.load_demo(base=None)
    tb = t_zoo.load_demo(base=BASE)
    jsyn = JSynthesizer(jb.config, tts_params=jb.tts_params,
                        vocoder_params=jb.vocoder_params,
                        speaker_params=jb.speaker_params,
                        default_speaker_vec=jb.default_speaker_vec)
    tsyn = Synthesizer(tb.config, tts_params=tb.tts_params,
                       vocoder_params=tb.vocoder_params,
                       speaker_params=tb.speaker_params,
                       default_speaker_vec=tb.default_speaker_vec,
                       device="cpu")
    return jb, tb, jsyn, tsyn


def test_demo_bundle_equals_the_jax_bundle(demo_pair):
    jb, tb, _, _ = demo_pair
    assert t_zoo.demo_available()
    for name in ("tts", "vocoder", "asr"):
        assert dataclasses.asdict(getattr(tb.config, name)) == (
            dataclasses.asdict(getattr(jb.config, name)))
    assert dataclasses.asdict(t_zoo.hard_tts_config()) == dataclasses.asdict(
        j_demo.hard_tts_config())
    assert t_zoo.ENROLLMENT_PHRASE == j_demo.ENROLLMENT_PHRASE
    np.testing.assert_allclose(tb.default_speaker_vec,
                               np.asarray(jb.default_speaker_vec), rtol=0,
                               atol=1e-5)


# fp32 checkpoints with bf16 generation caches on both sides: the same
# sample count, and the PCM within 1e-3 of full scale (an int16 step is
# 3e-5 of it; measured: 1 to 10 steps on peaks of 0.7)
@pytest.mark.parametrize("mode,text,prosody", [
    ("SEMANTIC_VOICE", DEMO_TEXTS[0], {"pitch": "High", "energy": "Loud"}),
    ("SEMANTIC_VOICE", DEMO_TEXTS[1], {"pitch": "Deep", "energy": "Quiet"}),
    ("TEXT_ONLY", DEMO_TEXTS[2], {}),
    ("MORSE_CODE", "SOS", {})])
def test_demo_synthesizer_matches_jax(demo_pair, mode, text, prosody):
    _, _, jsyn, tsyn = demo_pair
    ref = jsyn.synthesize(JJanusPacket(text=text, mode=JJanusMode[mode],
                                       prosody=prosody))
    got = tsyn.synthesize(JanusPacket(text=text, mode=JanusMode[mode],
                                      prosody=prosody))
    assert len(got) == len(ref) > 0
    if mode == "MORSE_CODE":
        assert got == ref
        return
    err = np.abs(_pcm(got) - _pcm(ref)).max()
    assert err <= 1e-3, err
    assert np.abs(_pcm(got)).max() > 0.05  # it is speech, not silence


def test_hard_checkpoint_matches_jax():
    """``demo_tts_hard.npz`` with the demo vocoder; the speaker vector
    comes from the JAX package's bundle (its encoder is seeded by JAX's
    generator, which the port cannot reproduce)."""
    jb = j_zoo.load_demo_hard(base=None)
    cfg = t_zoo._with_sections(BASE, tts=t_zoo.hard_tts_config(),
                               vocoder=t_zoo.demo_vocoder_config())
    assert dataclasses.asdict(cfg.tts) == dataclasses.asdict(jb.config.tts)
    vec = np.asarray(jb.default_speaker_vec)
    jsyn = JSynthesizer(jb.config, tts_params=jb.tts_params,
                        vocoder_params=jb.vocoder_params,
                        speaker_params=jb.speaker_params,
                        default_speaker_vec=vec)
    tsyn = Synthesizer(
        cfg, tts_params=load_npz_params(os.path.join(CKPT_DIR,
                                                     "demo_tts_hard.npz")),
        vocoder_params=load_npz_params(os.path.join(CKPT_DIR,
                                                    "demo_vocoder.npz")),
        default_speaker_vec=vec, device="cpu")
    text = "bado kife"
    ref = jsyn.synthesize(JJanusPacket(text=text, prosody={
        "pitch": "High", "energy": "Normal"}))
    got = tsyn.synthesize(JanusPacket(text=text, prosody={
        "pitch": "High", "energy": "Normal"}))
    assert len(got) == len(ref) > 0
    assert np.abs(_pcm(got) - _pcm(ref)).max() <= 1e-3


def test_round_trip_gives_the_jax_transcripts(demo_pair):
    """phrase → packet → speech → packet again: the port hears what the
    JAX package hears, at both ends."""
    jb, tb, jsyn, tsyn = demo_pair
    jenc = JEncoder(jb.config, asr_params=jb.asr_params, buckets=(96_000,))
    tenc = SemanticEncoder(tb.config, asr_params=tb.asr_params,
                           buckets=(96_000,), device="cpu")
    for seed, text in enumerate(DEMO_TEXTS):
        phrase = render_text(text, 48_000, seed=seed)
        jp = jenc.encode_packet(phrase, timestamp=1.0)
        tp = tenc.encode_packet(phrase, timestamp=1.0)
        assert tp.serialize() == jp.serialize()
        jheard = jenc.encode_packet(_pcm(jsyn.synthesize(jp)), timestamp=2.0)
        theard = tenc.encode_packet(_pcm(tsyn.synthesize(tp)), timestamp=2.0)
        assert theard.text == jheard.text
        assert theard.prosody == jheard.prosody


def test_demo_streaming_equals_synthesize(demo_pair):
    _, _, _, tsyn = demo_pair
    pkt = JanusPacket(text=DEMO_TEXTS[1], prosody={"pitch": "High",
                                                   "energy": "Loud"})
    whole = tsyn.synthesize(pkt)
    chunks = list(tsyn.synthesize_streaming(pkt))
    assert len(chunks) > 1 and all(isinstance(c, bytes) for c in chunks)
    joined = b"".join(chunks)
    assert len(joined) == len(whole)
    assert np.abs(_pcm(joined) - _pcm(whole)).max() <= 2 / 32767
    morse = list(tsyn.synthesize_streaming(JanusPacket(
        text="SOS", mode=JanusMode.MORSE_CODE)))
    assert morse == [morse_audio("SOS")]


# -- streaming against fused at the JAX streaming test's geometry ----------

@pytest.fixture(scope="module")
def stream_setup():
    cfg = stream_cfg()
    g = torch.Generator().manual_seed(0)
    tts_params = t_tts.init_tts(g, cfg.tts, text_vocab=261)
    voc_params = t_voc.init_vocoder(g, cfg.vocoder, n_mels=cfg.tts.n_mels)
    return cfg, tts_params, voc_params


def _fused(cfg, tts_params, voc_params, text, stop_threshold):
    """generate + vocode + resample, as ``Synthesizer._synth_impl``."""
    from janus_tpu_torch.models.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    ids = tok.encode(text)[: cfg.tts.max_text_tokens]
    padded = np.full((1, t_tts.text_bucket(len(ids),
                                           cfg.tts.max_text_tokens)),
                     tok.pad, np.int64)
    padded[0, : len(ids)] = ids
    mel, n_frames = t_tts.tts_generate(
        tts_params, cfg.tts, torch.from_numpy(padded),
        torch.zeros(1, dtype=torch.long), stop_threshold=stop_threshold)
    wav = t_voc.vocoder_waveform(voc_params, cfg.vocoder, mel)
    wav48 = resample_poly(wav, up=2, down=1)
    n48 = int(n_frames[0]) * cfg.vocoder.hop_length * 2
    cap = int((0.35 + cfg.tts.max_seconds_per_text_token * len(ids)) * 48_000)
    return wav48[0, :min(n48, cap)].numpy(), int(n_frames[0])


# 2.0 never stops: the duration cap ends the stream after several chunks;
# 0.5 lets the untrained stop head end it where it fires
@pytest.mark.parametrize("stop_threshold,chunk_groups", [
    (2.0, 8), (2.0, 5), (0.5, 8)])
def test_stream_equals_fused(stream_setup, stop_threshold, chunk_groups):
    cfg, tts_params, voc_params = stream_setup
    ref, n_frames = _fused(cfg, tts_params, voc_params, "stream me",
                           stop_threshold)
    s = StreamingSynthesizer(cfg, tts_params=tts_params,
                             vocoder_params=voc_params,
                             chunk_groups=chunk_groups,
                             stop_threshold=stop_threshold, device="cpu")
    chunks = list(s.stream("stream me"))
    got = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape, n_frames)
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-5)
    if stop_threshold == 2.0:
        assert len(chunks) > 1  # it really streamed
    blobs = list(s.stream_pcm16("stream me"))
    assert sum(len(b) for b in blobs) == 2 * len(ref)


def test_stream_runs_the_whole_budget_without_the_cap(stream_setup):
    """With the cap lifted the stream covers the full mel budget, flush
    and last (shorter) chunk included, and still equals the fused path."""
    cfg, tts_params, voc_params = stream_setup
    cfg = cfg.override(**{"tts.max_seconds_per_text_token": 10.0})
    ref, n_frames = _fused(cfg, tts_params, voc_params, "all of it", 2.0)
    assert n_frames == cfg.tts.max_mel_frames
    s = StreamingSynthesizer(cfg, tts_params=tts_params,
                             vocoder_params=voc_params, chunk_groups=7,
                             stop_threshold=2.0, device="cpu")
    chunks = list(s.stream("all of it"))
    got = np.concatenate(chunks)
    assert got.shape == ref.shape == (192 * 64 * 2,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-5)
    first, total, n = s.turnaround("all of it")
    assert n == len(ref) and 0 < first < total


# -- the service: routing, ladder, hot reload, cap --------------------------

@pytest.fixture(scope="module")
def synth():
    return Synthesizer(small_cfg(), device="cpu")


def test_routing(synth):
    assert synth.synthesize(JanusPacket(
        text="SOS", mode=JanusMode.MORSE_CODE)) == morse_audio("SOS")
    sem = synth.synthesize(JanusPacket(
        text="hello", prosody={"energy": "Loud", "pitch": "High"}))
    txt = synth.synthesize(JanusPacket(text="hi there",
                                       mode=JanusMode.TEXT_ONLY))
    for audio in (sem, txt):
        assert isinstance(audio, bytes) and audio and len(audio) % 2 == 0
    pkt = JanusPacket(text="x")
    pkt.mode = 99
    with pytest.raises(ValueError, match="Unknown packet mode"):
        synth.synthesize(pkt)


@pytest.mark.parametrize("packet,tag", [
    (JanusPacket(text="x", prosody={"pitch": "High", "energy": "Loud"}),
     "excited"),
    (JanusPacket(text="x", prosody={"pitch": "Deep", "energy": "Quiet"}),
     "whispering"),
    (JanusPacket(text="x"), "relaxed"),
    (JanusPacket(text="x", override_emotion="panicked",
                 prosody={"pitch": "High", "energy": "Loud"}), "panicked"),
    (JanusPacket(text="x", mode=JanusMode.TEXT_ONLY), "neutral"),
    (JanusPacket(text="x", mode=JanusMode.TEXT_ONLY,
                 override_emotion="calm"), "calm")])
def test_emotion_tag_reaches_the_model(synth, monkeypatch, packet, tag):
    seen = []
    monkeypatch.setattr(synth, "_run_tts",
                        lambda text, emo: seen.append(emo) or b"\0\0")
    assert synth.synthesize(packet) == b"\0\0"
    assert seen == [tag]


def test_ladder_ends_in_empty_bytes(synth, monkeypatch, caplog):
    calls = []

    def boom(*a, **k):
        calls.append(a)
        raise RuntimeError("tts down")

    monkeypatch.setattr(synth, "_run_tts", boom)
    with caplog.at_level(logging.ERROR):
        out = synth.synthesize(JanusPacket(text="x"))
    assert out == b"" and len(calls) == 2  # semantic, then fast TTS
    assert sum(r.levelno >= logging.ERROR for r in caplog.records) == 2
    calls.clear()
    assert synth.synthesize(JanusPacket(
        text="x", mode=JanusMode.TEXT_ONLY)) == b""
    assert len(calls) == 1


def test_streaming_failure_falls_back_to_fast_tts(synth, monkeypatch):
    list(synth.synthesize_streaming(JanusPacket(text="warm")))

    def boom(*a, **k):
        raise RuntimeError("stream down")
        yield  # pragma: no cover

    monkeypatch.setattr(synth._streamer, "stream_pcm16", boom)
    pkt = JanusPacket(text="hello")
    out = list(synth.synthesize_streaming(pkt))
    assert out == [synth._generate_fast_tts("hello", pkt.override_emotion)]


def test_voice_clone_hot_reload(tmp_path):
    ref = tmp_path / "ref.wav"
    syn = Synthesizer(small_cfg(), reference_audio_path=str(ref),
                      device="cpu")
    assert syn._speaker_vec is None  # not present yet
    write_wav(str(ref), voiced_phrase(seconds=0.5), 48_000)
    syn._check_and_reload_reference_audio()
    first = syn._speaker_vec.clone()
    assert tuple(first.shape) == (64,)
    # unchanged mtime: no reload
    syn._speaker_vec = None
    syn._check_and_reload_reference_audio()
    assert syn._speaker_vec is None
    # other audio at another rate, later mtime: a new embedding
    write_wav(str(ref), voiced_phrase(f0=320.0, seconds=0.5,
                                      sample_rate=44_100), 44_100)
    os.utime(ref, (os.path.getmtime(ref) + 5, os.path.getmtime(ref) + 5))
    syn._check_and_reload_reference_audio()
    assert not torch.allclose(first, syn._speaker_vec)
    assert len(syn.synthesize(JanusPacket(text="cloned"))) > 0
    # an upload this package cannot decode degrades to "no clone voice"
    ref.write_bytes(b"OggS\x00not really")
    os.utime(ref, (os.path.getmtime(ref) + 9, os.path.getmtime(ref) + 9))
    syn._check_and_reload_reference_audio()
    assert syn._speaker_vec is None


def test_clone_embedding_matches_jax(tmp_path):
    """16 kHz, 48 kHz and 44.1 kHz references through both synthesizers:
    the enrolled vector within 1e-4 (resampler 1e-5, then a unit vector)."""
    for sr in (16_000, 48_000, 44_100):
        ref = tmp_path / f"ref{sr}.wav"
        write_wav(str(ref), voiced_phrase(seconds=0.4, sample_rate=sr), sr)
        jsyn = JSynthesizer(j_zoo.JanusConfig().override(**{
            "tts.d_model": 64, "tts.layers": 1, "tts.num_heads": 4,
            "tts.n_mels": 16, "vocoder.d_model": 16, "vocoder.layers": 1}),
            reference_audio_path=str(ref))
        from janus_tpu_torch.models.params import params_from_jax

        tsyn = Synthesizer(
            small_cfg(), speaker_params=params_from_jax(jsyn.speaker_params),
            reference_audio_path=str(ref), device="cpu")
        np.testing.assert_allclose(tsyn._speaker_vec.numpy(),
                                   np.asarray(jsyn._speaker_vec), rtol=0,
                                   atol=1e-4)


def test_duration_cap(monkeypatch):
    """A stop head that never fires is cut at 0.35 s + 0.15 s per token."""
    cfg = small_cfg(**{"tts.max_mel_frames": 512})
    syn = Synthesizer(cfg, device="cpu")
    generate = t_tts.tts_generate
    monkeypatch.setattr(
        t_tts, "tts_generate",
        lambda *a, **k: generate(*a, **{**k, "stop_threshold": 2.0}))
    out = syn.synthesize(JanusPacket(text="ab"))
    assert len(out) == 2 * int((0.35 + 0.15 * 2) * 48_000)
