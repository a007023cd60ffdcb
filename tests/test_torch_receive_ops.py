"""The receive side's operators against the JAX package on the CPU: the
inverse STFT (both overlap-add routes), the polyphase resampler (every
route), Morse audio, the emotion tables, WAV I/O, the mixed-dtype
``linear`` and the parameter bridge for the receive-side trees. Inputs
come from numpy seeds; tolerances are the JAX package's own for each
part (``tests/test_ops_frontend.py``, ``tests/test_audio.py``)."""

import importlib
import itertools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from janus_tpu.common.config import TTSConfig as JTTSConfig
from janus_tpu.common.config import VocoderConfig as JVocoderConfig
from janus_tpu.common.protocol import JanusMode as JJanusMode
from janus_tpu.eval.roundtrip import load_npz_params as j_load_npz
from janus_tpu.models import tts as j_tts
from janus_tpu.models import vocoder as j_voc
from janus_tpu.models.speaker import init_speaker_encoder as j_init_speaker
from janus_tpu.ops import layers as j_layers
from janus_tpu.ops import morse as j_morse
from janus_tpu.ops import resample as j_resample
from janus_tpu.runtime import emotion as j_emotion
from janus_tpu_torch.audio import decode as t_decode
from janus_tpu_torch.audio import wav as t_wav
from janus_tpu_torch.common.protocol import JanusMode
from janus_tpu_torch.models.params import (flatten_with_paths,
                                           load_npz_params, params_from_jax)
from janus_tpu_torch.ops import layers as t_layers
from janus_tpu_torch.ops import morse as t_morse
from janus_tpu_torch.ops import resample as t_resample
from janus_tpu_torch.runtime import emotion as t_emotion

# (``janus_tpu.ops`` re-exports a function named ``stft`` over the module)
j_stft = importlib.import_module("janus_tpu.ops.stft")
t_stft = importlib.import_module("janus_tpu_torch.ops.stft")

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "checkpoints")


def _signal(shape, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# -- istft -------------------------------------------------------------------

# 256/64 and 1024/256 take the shifted-add route, 400/160 and 256/100 the
# scatter route; atol 1e-5 on signals of unit scale
@pytest.mark.parametrize("n_fft,hop", [(256, 64), (1024, 256), (640, 160),
                                       (400, 160), (256, 100)])
@pytest.mark.parametrize("shape", [(3, 37), (2, 2, 9), (5,)])
def test_istft_matches_jax(n_fft, hop, shape):
    rng = np.random.default_rng(n_fft + hop)
    n_bins = n_fft // 2 + 1
    spec = (rng.standard_normal(shape + (n_bins,))
            + 1j * rng.standard_normal(shape + (n_bins,))).astype(np.complex64)
    ref = np.asarray(j_stft.istft(jnp.asarray(spec), n_fft, hop))
    got = t_stft.istft(torch.from_numpy(spec), n_fft, hop)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    cut = t_stft.istft(torch.from_numpy(spec), n_fft, hop, length=17)
    np.testing.assert_array_equal(cut.numpy(), got.numpy()[..., :17])


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (400, 160)])
def test_istft_inverts_stft(n_fft, hop):
    x = torch.from_numpy(_signal((2, 4000), seed=3))
    spec = t_stft.stft(x, n_fft, hop)
    back = t_stft.istft(spec, n_fft, hop)
    n = back.shape[-1]
    np.testing.assert_allclose(back.numpy(), x.numpy()[:, :n], rtol=0,
                               atol=1e-5)
    ref = np.asarray(j_stft.istft(j_stft.stft(jnp.asarray(x.numpy()), n_fft,
                                              hop), n_fft, hop))
    np.testing.assert_allclose(back.numpy(), ref, rtol=0, atol=1e-5)


def test_istft_chunk_with_halo_is_bit_equal():
    """The shifted-add route sums every slot in one order: frames
    [a - halo, b + halo) give the samples of frames [a, b) bit for bit."""
    n_fft, hop, halo = 256, 64, 256 // 64 + 1
    rng = np.random.default_rng(9)
    spec = torch.from_numpy((rng.standard_normal((1, 60, 129)) + 1j
                             * rng.standard_normal((1, 60, 129))
                             ).astype(np.complex64))
    full = t_stft.istft(spec, n_fft, hop)
    a, b = 20, 36
    part = t_stft.istft(spec[:, a - halo:b + halo], n_fft, hop)
    assert torch.equal(part[:, halo * hop:(halo + b - a) * hop],
                       full[:, a * hop:b * hop])


# -- resample ----------------------------------------------------------------

@pytest.mark.parametrize("up,down,shape", [
    (2, 1, (2, 1000)), (3, 1, (1, 777)), (1, 3, (2, 4801)), (1, 2, (3, 999)),
    (160, 441, (1, 4410)), (2, 3, (2, 1500)), (3, 2, (2, 1001)),
    (16_000, 44_100, (1, 2205)), (4, 2, (2, 500)), (48_000, 24_000, (700,)),
    (5, 5, (2, 64))])
def test_resample_poly_matches_jax(up, down, shape):
    x = _signal(shape, seed=up * 7 + down)
    ref = np.asarray(j_resample.resample_poly(jnp.asarray(x), up, down))
    got = t_resample.resample_poly(torch.from_numpy(x), up, down)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_decimate_conv_reference_and_naive(factor):
    x = _signal((2, 4800), seed=factor)
    taps = 32 * factor
    ref = np.asarray(j_resample._decimate_fir_conv(jnp.asarray(x), factor,
                                                   taps))
    got = t_resample._decimate_fir_conv(torch.from_numpy(x), factor, taps)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # the matmul decimator is the same filter
    mm = t_resample._decimate_fir(torch.from_numpy(x), factor, taps)
    np.testing.assert_allclose(mm.numpy(), got.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        t_resample.naive_decimate(torch.from_numpy(x), factor).numpy(),
        np.asarray(j_resample.naive_decimate(jnp.asarray(x), factor)))


@pytest.mark.parametrize("up", [2, 3])
def test_upsample_chunk_with_halo_is_bit_equal(up):
    """A chunk with 128 samples of halo gives the full signal's samples
    bit for bit: the tap order of a sum does not depend on its position."""
    x = torch.from_numpy(_signal((1, 6000), seed=up))
    full = t_resample._upsample_fir(x, up)
    halo = 128
    for a, b in ((1000, 2536), (0, 777), (5000, 6000)):
        lo, hi = max(0, a - halo), min(x.shape[-1], b + halo)
        part = t_resample._upsample_fir(x[:, lo:hi], up)
        assert torch.equal(part[:, (a - lo) * up:(b - lo) * up],
                           full[:, a * up:b * up])


# -- morse, emotion, wav -----------------------------------------------------

@pytest.mark.parametrize("text", ["SOS", "hello world", "A1 B2", "", "!!!",
                                  "janus 42", "e"])
def test_morse_bytes_equal(text):
    assert t_morse.morse_audio(text) == j_morse.morse_audio(text)
    assert t_morse.text_to_morse(text) == j_morse.text_to_morse(text)


def test_morse_table_equal():
    assert t_morse.MORSE_TABLE == j_morse.MORSE_TABLE


def test_emotion_tables_equal_over_the_grid():
    tags = ("High", "Normal", "Deep", "Low", "Loud", "Quiet", "", "other")
    for pitch, energy in itertools.product(tags, tags):
        assert (t_emotion.tts_emotion_tag(pitch, energy)
                == j_emotion.tts_emotion_tag(pitch, energy))
        assert (t_emotion.ui_emotion_tag(pitch, energy)
                == j_emotion.ui_emotion_tag(pitch, energy))
    assert t_emotion.API_MODES == j_emotion.API_MODES
    for api in t_emotion.API_MODES + ("bogus",):
        assert int(t_emotion.api_mode_to_protocol(api)) == int(
            j_emotion.api_mode_to_protocol(api))
    for mode, jmode in zip(JanusMode, JJanusMode):
        assert (t_emotion.protocol_mode_to_api(mode)
                == j_emotion.protocol_mode_to_api(jmode))
    for emo in ("auto", "Auto", "AUTO", "relaxed", "panicked"):
        assert (t_emotion.api_emotion_to_protocol(emo)
                == j_emotion.api_emotion_to_protocol(emo))


def test_wav_roundtrip_and_sniffing(tmp_path):
    from janus_tpu.audio import wav as j_wav

    audio = np.clip(_signal((4800,), seed=4), -1, 1)
    path = str(tmp_path / "a.wav")
    t_wav.write_wav(path, audio, 48_000)
    got, sr = t_wav.read_wav(path)
    ref, jsr = j_wav.read_wav(path)
    assert sr == jsr == 48_000
    np.testing.assert_array_equal(got, ref)
    got2, sr2 = t_decode.read_audio(path)
    np.testing.assert_array_equal(got2, ref)
    with open(path, "rb") as f:
        data = f.read()
    assert t_decode.sniff_format(data) == "wav"
    assert t_wav.float_to_pcm16(audio) == j_wav.float_to_pcm16(audio)
    np.testing.assert_array_equal(t_wav.pcm16_to_float(data[44:]),
                                  j_wav.pcm16_to_float(data[44:]))
    assert t_decode.sniff_format(b"\x1a\x45\xdf\xa3rest") == "webm"
    assert t_decode.sniff_format(b"OggS\x00rest") == "ogg"
    assert t_decode.sniff_format(b"nothing") == "unknown"
    # a WebM or Ogg header over no Opus stream: the JAX package's error
    from janus_tpu.audio import decode as j_decode

    for blob in (b"\x1a\x45\xdf\xa3rest", b"OggS\x00rest"):
        with pytest.raises(Exception) as ref:
            j_decode.read_audio(blob)
        with pytest.raises(ref.type, match=str(ref.value)):
            t_decode.read_audio(blob)
    with pytest.raises(ValueError):
        t_decode.read_audio(b"nothing at all")


# -- linear under mixed dtypes -----------------------------------------------

@pytest.mark.parametrize("x_dtype,w_dtype", [
    ("float32", "bfloat16"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16"), ("float32", "float32")])
@pytest.mark.parametrize("bias", [True, False])
def test_linear_follows_the_jax_dtype_flow(x_dtype, w_dtype, bias):
    """The result is in ``x.dtype``; the weight is promoted for the
    product. fp32 results within 1e-5, bf16 ones within one bf16 ulp."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (0.1 * rng.standard_normal((48, 24))).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32) if bias else None
    jx = jnp.asarray(x).astype(x_dtype)
    jw = jnp.asarray(w).astype(w_dtype)
    jb = None if b is None else jnp.asarray(b).astype(w_dtype)
    ref = j_layers.linear(jx, jw, jb)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    tw = torch.from_numpy(w).to(getattr(torch, w_dtype))
    tb = None if b is None else torch.from_numpy(b).to(getattr(torch, w_dtype))
    got = t_layers.linear(tx, tw, tb)
    assert got.dtype == getattr(torch, x_dtype) and str(ref.dtype) == x_dtype
    ref32 = np.asarray(ref.astype(jnp.float32))
    if x_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref32, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), ref32, rtol=2 ** -7,
                                   atol=1e-6)


# -- the receive-side trees cross leaf for leaf ------------------------------

def _assert_trees_equal(ours, theirs):
    """``theirs`` is a JAX-side tree, possibly layer-stacked."""
    ours = dict(flatten_with_paths(ours))
    theirs = dict(flatten_with_paths(params_from_jax(theirs)))
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(), k)


def _small_tts():
    return JTTSConfig(d_model=32, layers=3, num_heads=4, n_mels=8,
                      max_text_tokens=16, max_mel_frames=32)


@pytest.mark.parametrize("stacked", [False, True])
def test_tts_tree_crosses_from_jax(stacked):
    jp = j_tts.init_tts(0, _small_tts(), text_vocab=261)
    per_layer = params_from_jax(jp)
    assert isinstance(per_layer["blocks"], list) and len(
        per_layer["blocks"]) == 3
    src = j_tts.prestack_tts(jp) if stacked else jp
    if stacked:
        src = j_tts._prestack(jp)
        assert isinstance(src["blocks"], dict)
    _assert_trees_equal(per_layer, src)


def test_vocoder_and_speaker_trees_cross_from_jax():
    jv = j_voc.init_vocoder(1, JVocoderConfig(n_fft=64, hop_length=16,
                                              d_model=16, layers=2), n_mels=8)
    tv = params_from_jax(jv)
    assert tv["blocks"][0]["dwconv"]["w"].shape == (7, 16)
    _assert_trees_equal(tv, jv)
    js = j_init_speaker(2, n_mels=8, d_out=16)
    _assert_trees_equal(params_from_jax(js), js)


@pytest.mark.parametrize("name", ["demo_tts.npz", "demo_tts_hard.npz",
                                  "demo_vocoder.npz", "demo_speaker.npz"])
def test_committed_receive_checkpoints_load_equal(name):
    path = os.path.join(CKPT_DIR, name)
    _assert_trees_equal(load_npz_params(path), j_load_npz(path))


def test_port_initialisers_have_the_jax_shapes():
    from janus_tpu_torch.common.config import TTSConfig, VocoderConfig
    from janus_tpu_torch.models.speaker import init_speaker_encoder
    from janus_tpu_torch.models.tts import init_tts, prestack_tts
    from janus_tpu_torch.models.vocoder import init_vocoder

    g = torch.Generator().manual_seed(0)
    pairs = [
        (init_tts(g, TTSConfig(d_model=32, layers=3, num_heads=4, n_mels=8,
                               max_text_tokens=16, max_mel_frames=32)),
         j_tts.init_tts(0, _small_tts())),
        (init_vocoder(g, VocoderConfig(n_fft=64, hop_length=16, d_model=16,
                                       layers=2), n_mels=8),
         j_voc.init_vocoder(1, JVocoderConfig(n_fft=64, hop_length=16,
                                              d_model=16, layers=2),
                            n_mels=8)),
        (init_speaker_encoder(g, n_mels=8, d_out=16),
         j_init_speaker(2, n_mels=8, d_out=16)),
    ]
    for ours, theirs in pairs:
        assert prestack_tts(ours) is ours
        a = {k: tuple(v.shape) for k, v in flatten_with_paths(ours)}
        b = {k: tuple(np.asarray(v).shape)
             for k, v in flatten_with_paths(theirs)}
        assert a == b
        for k, v in flatten_with_paths(ours):
            assert v.dtype == torch.float32
            if k.endswith("/b") or k.endswith("bias"):
                assert not v.any(), k
