"""The send side's last entry points against the JAX package on the CPU:
YIN's per-window route (``yin_frame``, the ``yin_track`` fallback) and its
matmul-DFT route, ``pitch_tag``, ``transcribe_mel``, ``warmup``, the hard
recognizer's preset and packets; and the encode without autograd, on the
calling thread and on a worker thread (tolerances from
``tests/test_ops_yin.py`` and ``tests/test_asr.py``)."""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.common.config import JanusConfig as JJanusConfig
from janus_tpu.eval.roundtrip import load_npz_params as j_load_npz
from janus_tpu.models import asr as j_asr
from janus_tpu.ops import yin as j_yin
from janus_tpu.runtime.codec import SemanticEncoder as JEncoder
from janus_tpu.train import demo as j_demo
from janus_tpu.train.synthetic_task import HARD_WORDS
from janus_tpu_torch.audio.synthetic import render_text, tone
from janus_tpu_torch.common.config import ASRConfig, JanusConfig
from janus_tpu_torch.models import asr as t_asr
from janus_tpu_torch.models import zoo as t_zoo
from janus_tpu_torch.models.params import load_npz_params, map_tree
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.ops import yin as t_yin
from janus_tpu_torch.runtime.codec import SemanticEncoder

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
TIMESTAMP = 1_700_000_000.25

# the JAX side compiled once a call rather than op by op
j_track_difference = jax.jit(j_yin._track_difference, static_argnums=(1, 2, 3),
                             static_argnames=("route",))
j_yin_track = jax.jit(j_yin.yin_track, static_argnums=(1, 2, 3),
                      static_argnames=("fmin", "fmax"))


def _signals(sr, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    tone_ = 0.2 * np.sin(2 * np.pi * 196.0 * t)
    noise = 0.05 * rng.standard_normal(len(t))
    return np.stack([tone_ + noise, noise, tone_]).astype(np.float32)


# -- YIN --------------------------------------------------------------------

@pytest.mark.parametrize("n_lags_out", [None, 1202, 402])
def test_difference_function_matches_jax(n_lags_out):
    w = np.random.default_rng(5).standard_normal((3, 4096)).astype(np.float32)
    out = t_yin._difference_function(torch.from_numpy(w), 2048, n_lags_out)
    ref = np.asarray(j_yin._difference_function(jnp.asarray(w), 2048,
                                                n_lags_out=n_lags_out))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n", [5304, 4097, 8192, 1, 170, 1763])
def test_fast_fft_len_equals_jax(n):
    assert t_yin._fast_fft_len(n) == j_yin._fast_fft_len(n)


def _same_track(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out[out > 0], ref[ref > 0], rtol=0, atol=0.01)


@pytest.mark.parametrize("bounded", [False, True])
def test_yin_frame_matches_jax(bounded):
    kw = {"fmin": 40.0, "fmax": 1000.0} if bounded else {}
    sig = _signals(48_000, 1.0, 11)
    windows = np.stack([sig[:, i * 4096:(i + 1) * 4096] for i in range(3)],
                       axis=1)
    _same_track(t_yin.yin_frame(torch.from_numpy(windows), 48_000, 0.8, **kw),
                j_yin.yin_frame(jnp.asarray(windows), 48_000, 0.8, **kw))
    f0 = float(t_yin.yin_frame(torch.from_numpy(
        tone(170.0, 4096 / 48_000, amp=1.0)[None]), 48_000, fmin=40.0,
        fmax=1000.0)[0])
    assert abs(f0 - 170.0) < 1.0


@pytest.mark.parametrize("sr,buf,hop,bounded", [
    (16_000, 1024, 384, True), (16_000, 1024, 384, False),
    (48_000, 2048, 700, True)])
def test_yin_track_fallback_geometry_matches_jax(sr, buf, hop, bounded):
    """Geometries where hop does not divide buf // 2 take the per-window
    route on both sides (the port raised here before)."""
    assert (buf // 2) % hop
    kw = {"fmin": 40.0, "fmax": 1000.0} if bounded else {}
    sig = _signals(sr, 0.8, 12)
    out = t_yin.yin_track(torch.from_numpy(sig), sr, buf, hop, **kw)
    ref = j_yin_track(jnp.asarray(sig), sr, buf, hop, **kw)
    _same_track(out, ref)
    assert out.shape[-1] == -(-sig.shape[-1] // hop)
    windows = t_yin._hop_windows(torch.from_numpy(sig), buf, hop)
    np.testing.assert_array_equal(
        windows.numpy(), np.asarray(j_yin._hop_windows(jnp.asarray(sig),
                                                       buf, hop)))


@pytest.mark.parametrize("buf,hop,n_lags_out,t", [(1360, 170, 402, 16_000),
                                                  (4096, 512, 1202, 24_000)])
def test_block_sums_dft_match_jax_and_plain(buf, hop, n_lags_out, t):
    from janus_tpu_torch.ops.yin_blocksums import block_sums_plain

    audio = np.random.default_rng(11).standard_normal((2, t)).astype(
        np.float32)
    padded, n_hops = t_yin._pad_stream(torch.from_numpy(audio), buf, hop)
    nblk = n_hops + (buf // 2) // hop - 1
    out = t_yin._block_sums_dft(padded, nblk, hop, n_lags_out).numpy()
    jpadded, _ = j_yin._pad_stream(jnp.asarray(audio), buf, hop)
    ref = np.asarray(j_yin._block_sums_dft(jpadded, nblk, hop, n_lags_out))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-3)
    plain = block_sums_plain(padded, nblk, hop, n_lags_out).numpy()
    np.testing.assert_allclose(out, plain[..., :n_lags_out], rtol=2e-4,
                               atol=2e-3)


@pytest.mark.parametrize("shape", [(2, 8000), (8000,), (1, 2, 3000)])
def test_dft_route_matches_jax_dft_route(shape):
    """The route is named on both sides: its 1e-5 relative snap can flip
    borderline voiced frames against the block-sum route."""
    audio = np.random.default_rng(12).standard_normal(shape).astype(
        np.float32)
    out = t_yin._track_difference(torch.from_numpy(audio), 1360, 170, 402,
                                  route="dft")
    ref = np.asarray(j_track_difference(jnp.asarray(audio), 1360, 170, 402,
                                        route="dft"))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=5e-3)
    kernel = t_yin._track_difference(torch.from_numpy(audio), 1360, 170, 402)
    np.testing.assert_allclose(out.numpy(), kernel.numpy(), rtol=1e-3,
                               atol=5e-3)


@pytest.mark.parametrize("freq", [90.0, 300.0, 700.0])
def test_dft_route_pitch_matches_jax(freq):
    sr = 16_000
    x = (0.6 * np.sin(2 * np.pi * freq * np.arange(sr) / sr)).astype(
        np.float32)
    p_lo, p_hi, n_out, bounded = t_yin._search_bounds(1360, sr, 40.0, 1000.0)

    def mean_f0(d, mod):
        return float(mod.mean_voiced_pitch(mod._select_pitch(
            mod._cmndf(d)[..., :n_out], sr, 0.8, p_lo, p_hi, bounded)))

    f_t = mean_f0(t_yin._track_difference(torch.from_numpy(x), 1360, 170,
                                          402, route="dft"), t_yin)
    f_j = mean_f0(j_track_difference(jnp.asarray(x), 1360, 170, 402,
                                     route="dft"), j_yin)
    assert abs(f_t - f_j) < 0.01
    assert abs(f_t - freq) / freq < 0.01


def test_routes_reject():
    x = torch.zeros(4000)
    with pytest.raises(ValueError):
        t_yin._track_difference(x, 1360, 170, 402, route="fft")
    with pytest.raises(ValueError):
        t_yin._track_difference(x, 1024, 384, 402)


@pytest.mark.parametrize("code", [0, 1, 2])
def test_pitch_tag(code):
    assert t_yin.pitch_tag(code) == j_yin.pitch_tag(code)
    assert t_yin.pitch_tag(np.int32(code)) == t_yin.PITCH_TAGS[code]


# -- the recognizer's entry points ------------------------------------------

def test_transcribe_mel_tokens_equal_jax():
    cfg = ASRConfig.demo()
    jcfg = j_demo.demo_asr_config()
    path = os.path.join(CKPT_DIR, "demo_asr.npz")
    tok = ByteTokenizer()
    audio16 = np.zeros((2, 32_000), np.float32)
    for i, text in enumerate(("alpha bravo", "kilo lima")):
        x = render_text(text, 16_000, seed=i)
        audio16[i, :len(x)] = x
    mel = j_asr.prepare_mel(jnp.asarray(audio16), jcfg, pad_to_frames=200)
    prompt = np.full((2, 1), tok.sot, dtype=np.int64)
    ref = np.asarray(j_asr.transcribe_mel(j_load_npz(path), jcfg, mel,
                                          jnp.asarray(prompt, jnp.int32),
                                          tok.eot, max_new=12))
    out = t_asr.transcribe_mel(load_npz_params(path), cfg,
                               torch.from_numpy(np.array(mel)),
                               torch.from_numpy(prompt), tok.eot, max_new=12)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert tok.decode(out[0].tolist()).startswith("alpha")


def test_hard_asr_config_equals_jax():
    assert dataclasses.asdict(t_zoo.hard_asr_config()) == dataclasses.asdict(
        j_demo.hard_asr_config())


@pytest.fixture(scope="module")
def hard_encoders():
    path = os.path.join(CKPT_DIR, "demo_asr_hard.npz")
    jenc = JEncoder(dataclasses.replace(JJanusConfig(),
                                        asr=j_demo.hard_asr_config()),
                    asr_params=j_load_npz(path), buckets=(96_000,))
    tenc = SemanticEncoder(dataclasses.replace(JanusConfig(),
                                               asr=t_zoo.hard_asr_config()),
                           asr_params=load_npz_params(path),
                           buckets=(96_000,), device="cpu")
    return jenc, tenc


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hard_checkpoint_packets_byte_equal(hard_encoders, seed):
    jenc, tenc = hard_encoders
    rng = np.random.default_rng(seed)
    words = [HARD_WORDS[i] for i in rng.integers(0, len(HARD_WORDS),
                                                 size=1 + seed % 3)]
    phrase = render_text(" ".join(words), 48_000, seed=seed,
                         speaker=seed % 4)
    jpkt = jenc.encode_packet(phrase, timestamp=TIMESTAMP)
    tpkt = tenc.encode_packet(phrase, timestamp=TIMESTAMP)
    assert (jpkt is None) == (tpkt is None)
    if tpkt is not None:
        assert tpkt.serialize() == jpkt.serialize()


def test_warmup_runs_and_changes_nothing(hard_encoders):
    _, tenc = hard_encoders
    phrase = render_text(HARD_WORDS[7], 48_000, seed=9)
    before = tenc.encode_packet(phrase, timestamp=TIMESTAMP)
    tenc.warmup()
    tenc.warmup(bucket=48_000)
    after = tenc.encode_packet(phrase, timestamp=TIMESTAMP)
    assert (before is None) == (after is None)
    if before is not None:
        assert before.serialize() == after.serialize()


# -- the send path runs without autograd ------------------------------------

def test_encode_holds_no_graph_on_any_thread(monkeypatch):
    """With parameters that require gradients, the encoder output and the
    decode step's logits carry no ``grad_fn`` whether ``encode_batch``
    runs on the calling thread or on an executor thread (grad mode is
    thread-local), and the packets do not change."""
    cfg = dataclasses.replace(JanusConfig(), asr=ASRConfig.demo())
    params = load_npz_params(os.path.join(CKPT_DIR, "demo_asr.npz"))
    plain = SemanticEncoder(cfg, asr_params=params, buckets=(96_000,),
                            device="cpu")
    enc = SemanticEncoder(cfg, asr_params=params, buckets=(96_000,),
                          device="cpu")
    enc.params = map_tree(lambda t: t.detach().clone().requires_grad_(True)
                          if t.is_floating_point() else t, enc.params)
    seen = []
    encode_audio, decoder_step = t_asr.encode_audio, t_asr.decoder_step

    def spy_encode(*a, **k):
        out = encode_audio(*a, **k)
        seen.append((torch.is_grad_enabled(), out.grad_fn))
        return out

    def spy_step(*a, **k):
        logits, state = decoder_step(*a, **k)
        seen.append((torch.is_grad_enabled(), logits.grad_fn))
        return logits, state

    monkeypatch.setattr(t_asr, "encode_audio", spy_encode)
    monkeypatch.setattr(t_asr, "decoder_step", spy_step)
    phrase = render_text("fox golf hotel", 48_000, seed=1)
    ref = plain.encode_packet(phrase, timestamp=TIMESTAMP)
    here = enc.encode_packet(phrase, timestamp=TIMESTAMP)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        there = pool.submit(enc.encode_packet, phrase,
                            timestamp=TIMESTAMP).result()
    assert len(seen) > 4
    assert all(not grad and fn is None for grad, fn in seen), seen
    assert here.serialize() == there.serialize() == ref.serialize()
    assert torch.is_grad_enabled()  # the caller's grad mode is untouched
