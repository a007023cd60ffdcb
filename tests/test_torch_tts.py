"""The port's TTS transformer, vocoder and speaker encoder against the JAX
package on the CPU at small sizes: the same numpy-seeded inputs and the
JAX initialisers' parameters (through ``params_from_jax``) go through
both. Tolerances are the JAX package's own (``tests/test_synthesis.py``,
``tests/test_streaming_tts.py``) or tighter."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from janus_tpu.common.config import TTSConfig as JTTSConfig
from janus_tpu.common.config import VocoderConfig as JVocoderConfig
from janus_tpu.models import tts as j_tts
from janus_tpu.models import vocoder as j_voc
from janus_tpu.models.speaker import init_speaker_encoder as j_init_speaker
from janus_tpu.models.speaker import speaker_embed as j_speaker_embed
from janus_tpu_torch.common.config import TTSConfig, VocoderConfig
from janus_tpu_torch.models import tts as t_tts
from janus_tpu_torch.models import vocoder as t_voc
from janus_tpu_torch.models.params import cast_floating, params_from_jax
from janus_tpu_torch.models.speaker import speaker_embed

TTS_KW = dict(d_model=64, layers=2, num_heads=4, n_mels=16, reduction=2,
              max_text_tokens=32, max_mel_frames=32)
VOC_KW = dict(d_model=64, layers=2, n_fft=256, hop_length=64)


def _cfgs(**over):
    kw = {**TTS_KW, **over}
    return JTTSConfig(**kw), TTSConfig(**kw)


@pytest.fixture(scope="module")
def tts_params():
    jp = j_tts.init_tts(0, JTTSConfig(**TTS_KW), text_vocab=261)
    return jp, params_from_jax(jp)


def _prompt(batch, width, seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 256, size=(batch, width)).astype(np.int32)
    emo = rng.integers(0, len(t_tts.EMOTIONS), size=(batch,)).astype(np.int32)
    spk = rng.standard_normal((batch, TTS_KW["d_model"])).astype(np.float32)
    return text, emo, spk


def test_constants_and_buckets_equal():
    assert t_tts.EMOTIONS == j_tts.EMOTIONS
    for tag in ("excited", "EXCITED", "unknown-tag", "auto", "Sad"):
        assert t_tts.emotion_id(tag) == j_tts.emotion_id(tag)
    a, b = t_tts.special_ids(261), j_tts.special_ids(261)
    assert (a.emotion_base, a.boa, a.spk, a.total) == (
        b.emotion_base, b.boa, b.spk, b.total)
    for n in (0, 1, 8, 9, 31, 32, 33, 500):
        assert t_tts.text_bucket(n, 48) == j_tts.text_bucket(n, 48)
    assert t_tts.text_buckets(48) == j_tts.text_buckets(48)
    jc, tc = _cfgs()
    assert t_tts.audio_pos_base(tc) == j_tts.audio_pos_base(jc)


@pytest.mark.parametrize("with_speaker,with_inputs", [
    (False, False), (True, False), (True, True)])
def test_tts_forward_matches_jax(tts_params, with_speaker, with_inputs):
    """Teacher-forced pass, fp32 parameters and fp32 caches: 2e-5."""
    jp, tp = tts_params
    jc, tc = _cfgs()
    text, emo, spk = _prompt(2, 8, seed=1)
    rng = np.random.default_rng(2)
    groups = rng.standard_normal((2, 5, 32)).astype(np.float32)
    inputs = (groups + 0.3 * rng.standard_normal(groups.shape)
              ).astype(np.float32) if with_inputs else None
    ref_mel, ref_stop = j_tts.tts_forward(
        jp, jc, jnp.asarray(text), jnp.asarray(emo), jnp.asarray(groups),
        speaker=jnp.asarray(spk) if with_speaker else None,
        mel_inputs=None if inputs is None else jnp.asarray(inputs))
    mel, stop = t_tts.tts_forward(
        tp, tc, torch.from_numpy(text), torch.from_numpy(emo),
        torch.from_numpy(groups),
        speaker=torch.from_numpy(spk) if with_speaker else None,
        mel_inputs=None if inputs is None else torch.from_numpy(inputs))
    assert tuple(mel.shape) == (2, 5, 32) and tuple(stop.shape) == (2, 5)
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(stop.numpy(), np.asarray(ref_stop), rtol=0,
                               atol=2e-5)


# stop_threshold 2.0 never stops (the whole budget is compared), 0.5 lets
# the untrained stop head fire where it will
@pytest.mark.parametrize("stop_threshold", [2.0, 0.5])
@pytest.mark.parametrize("scan_layers", [False, True])
def test_tts_generate_matches_jax_fp32_caches(tts_params, stop_threshold,
                                              scan_layers):
    """``tts.dtype=float32``: mel within 1e-4, ``n_frames`` equal, zeros
    after a stop in both. The JAX side also runs its layer-stacked
    ``scan_layers`` form; the port takes per-layer blocks either way."""
    jp, tp = tts_params
    jc, tc = _cfgs(dtype="float32", scan_layers=scan_layers)
    text, emo, spk = _prompt(3, 8, seed=3)
    ref_mel, ref_n = j_tts.tts_generate(
        jp, jc, jnp.asarray(text), jnp.asarray(emo),
        speaker=jnp.asarray(spk), stop_threshold=stop_threshold)
    mel, n = t_tts.tts_generate(
        tp, tc, torch.from_numpy(text), torch.from_numpy(emo),
        speaker=torch.from_numpy(spk), stop_threshold=stop_threshold)
    assert mel.dtype == torch.float32
    assert tuple(mel.shape) == (3, tc.max_mel_frames, tc.n_mels)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), rtol=0,
                               atol=1e-4)
    for lane in range(3):
        assert not mel[lane, int(n[lane]):].any()


def test_tts_generate_matches_jax_bf16_caches(tts_params):
    """fp32 parameters, bf16 generation caches (the default ``tts.dtype``)
    on both sides. A rounding difference ahead of the cache write can
    move a cached value by one bf16 ulp (2^-8 relative), which the
    following steps carry: the bar on the whole budget is 2e-4 on mel of
    order 0.5 (measured 1.4e-6: no cached value flipped here); the first
    group, which only the prefill's caches touch, is held to 1e-4, well
    inside the JAX test's 4e-3. ``n_frames`` is equal."""
    jp, tp = tts_params
    jc, tc = _cfgs()
    assert tc.dtype == "bfloat16"
    text, emo, spk = _prompt(2, 8, seed=4)
    ref_mel, ref_n = j_tts.tts_generate(
        jp, jc, jnp.asarray(text), jnp.asarray(emo),
        speaker=jnp.asarray(spk), stop_threshold=2.0)
    mel, n = t_tts.tts_generate(
        tp, tc, torch.from_numpy(text), torch.from_numpy(emo),
        speaker=torch.from_numpy(spk), stop_threshold=2.0)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    ref_mel = np.asarray(ref_mel)
    np.testing.assert_allclose(mel.numpy(), ref_mel, rtol=0, atol=2e-4)
    r = tc.reduction
    np.testing.assert_allclose(mel.numpy()[:, :r], ref_mel[:, :r], rtol=0,
                               atol=1e-4)
    # and against the teacher-forced prediction at position 0, as the JAX
    # package's own test does (fp32 caches there, bf16 here)
    tf_mel, _ = t_tts.tts_forward(
        tp, tc, torch.from_numpy(text), torch.from_numpy(emo),
        torch.zeros((2, 3, r * tc.n_mels)), speaker=torch.from_numpy(spk))
    np.testing.assert_allclose(mel.numpy()[:, :r].reshape(2, -1),
                               tf_mel.numpy()[:, 0], rtol=0, atol=4e-3)


def test_tts_generate_under_bf16_parameters_follows_jax(tts_params):
    """bf16 parameters (the flagship's form): the prompt runs bf16
    activations, every AR step re-enters from the fp32 mel buffer and runs
    fp32 activations against bf16 weights. Both packages round the same
    quantities to bf16 (prefill activations, cached K/V), so they agree to
    a few bf16 ulps of mel of order 0.5 (an ulp there is 2e-3): 1e-2 on
    the budget (measured 2.4e-3), and the output stays float32."""
    jp, tp = tts_params
    jc, tc = _cfgs()
    import jax

    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp16 = cast_floating(tp, torch.bfloat16)
    text, emo, spk = _prompt(2, 8, seed=5)
    ref_mel, ref_n = j_tts.tts_generate(
        jp16, jc, jnp.asarray(text), jnp.asarray(emo),
        speaker=jnp.asarray(spk), max_groups=8, stop_threshold=2.0)
    mel, n = t_tts.tts_generate(
        tp16, tc, torch.from_numpy(text), torch.from_numpy(emo),
        speaker=torch.from_numpy(spk), max_groups=8, stop_threshold=2.0)
    assert mel.dtype == torch.float32 and str(ref_mel.dtype) == "float32"
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), rtol=0,
                               atol=1e-2)
    # the steps really ran fp32 against bf16 weights: casting the mel
    # input to bf16 instead would give a different (coarser) result
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 1, 32)).astype(np.float32))
    h = t_tts._embed_mel(tp16, x)
    assert h.dtype == torch.float32
    ref_h = j_tts._embed_mel(jp16, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=0,
                               atol=1e-5)
    assert float((h - t_tts._embed_mel(tp16, x.bfloat16()).float()
                  ).abs().max()) > 3e-5


@pytest.mark.parametrize("stop_threshold", [2.0, 0.5])
def test_prefill_and_chunks_match_generate(tts_params, stop_threshold):
    """``tts_prefill`` + ``tts_decode_chunk`` in chunks of 7 (no divisor
    of the budget) give the port's own ``tts_generate`` buffer to 2e-5
    (in fact the same steps, so equal) and the JAX package's chunked
    groups and flags."""
    jp, tp = tts_params
    jc, tc = _cfgs(dtype="float32")
    text, emo, spk = _prompt(2, 16, seed=7)
    args = (torch.from_numpy(text), torch.from_numpy(emo))
    kw = dict(speaker=torch.from_numpy(spk), stop_threshold=stop_threshold)
    mel_full, n_full = t_tts.tts_generate(tp, tc, *args, **kw)
    max_groups, r = tc.max_mel_frames // tc.reduction, tc.reduction

    first, done, state = t_tts.tts_prefill(tp, tc, *args, **kw)
    jfirst, jdone, jstate = j_tts.tts_prefill(
        jp, jc, jnp.asarray(text), jnp.asarray(emo),
        speaker=jnp.asarray(spk), stop_threshold=stop_threshold)
    np.testing.assert_allclose(first.numpy(), np.asarray(jfirst), rtol=0,
                               atol=2e-5)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert state.fill == int(np.asarray(jstate.fill).reshape(-1)[0]) == 19

    got = torch.zeros_like(mel_full)
    got[:, :r] = first.reshape(2, r, tc.n_mels)
    prev, jprev, start = first, jfirst, 0
    while start < max_groups - 1:
        n = min(7, max_groups - 1 - start)
        groups, dones, prev, done, state = t_tts.tts_decode_chunk(
            tp, tc, state, prev, done, start, n_steps=n,
            stop_threshold=stop_threshold)
        jgroups, jdones, jprev, jdone, jstate = j_tts.tts_decode_chunk(
            jp, jc, jstate, jprev, jdone, jnp.int32(start), n_steps=n,
            stop_threshold=stop_threshold)
        assert tuple(groups.shape) == (2, n, r * tc.n_mels)
        np.testing.assert_allclose(groups.numpy(), np.asarray(jgroups),
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(dones.numpy(), np.asarray(jdones))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        lo = start + 1
        got[:, lo * r:(lo + n) * r] = groups.reshape(2, n * r, tc.n_mels)
        start += n
    np.testing.assert_allclose(got.numpy(), mel_full.numpy(), rtol=0,
                               atol=2e-5)
    assert state.fill == 16 + 3 + max_groups - 1
    # the caches hold prompt + max_groups positions: the second step from
    # here would write past them, which is an error, not a clamp
    with pytest.raises(ValueError, match="overflow"):
        t_tts.tts_decode_chunk(tp, tc, state, prev, done, start, n_steps=2)


def test_positions_past_the_table_raise(tts_params):
    _, tp = tts_params
    _, tc = _cfgs()
    rows = tp["pos_emb"].shape[0]
    assert rows == tc.max_text_tokens + tc.max_mel_frames // tc.reduction + 8
    t_tts._pos_rows(tp, rows - 1, 1)
    with pytest.raises(ValueError, match="position table"):
        t_tts._pos_rows(tp, rows, 1)
    text, emo, _ = _prompt(1, 8, seed=8)
    with pytest.raises(ValueError, match="position table"):
        t_tts.tts_generate(tp, tc, torch.from_numpy(text),
                           torch.from_numpy(emo), max_groups=64,
                           stop_threshold=2.0)


def test_generate_leaves_its_loop_once_every_lane_is_done(tts_params,
                                                          monkeypatch):
    """The flags are read back every few steps only; a stop at the very
    first group ends the loop at the next reading."""
    _, tp = tts_params
    _, tc = _cfgs(dtype="float32")
    calls = []
    step = t_tts._step
    monkeypatch.setattr(t_tts, "_step",
                        lambda *a, **k: calls.append(1) or step(*a, **k))
    text, emo, _ = _prompt(2, 8, seed=9)
    mel, n = t_tts.tts_generate(tp, tc, torch.from_numpy(text),
                                torch.from_numpy(emo), stop_threshold=-1.0)
    assert n.tolist() == [tc.reduction] * 2 and not calls
    assert not mel[:, tc.reduction:].any()


# -- vocoder -----------------------------------------------------------------

@pytest.fixture(scope="module")
def voc_params():
    jv = j_voc.init_vocoder(1, JVocoderConfig(**VOC_KW), n_mels=16)
    return jv, params_from_jax(jv)


@pytest.mark.parametrize("shape", [(1, 2, 7, 16), (33, 16)])
def test_vocoder_matches_jax(voc_params, shape):
    """Spectra and waveform within 1e-4 of the peak."""
    jv, tv = voc_params
    jc, tc = JVocoderConfig(**VOC_KW), VocoderConfig(**VOC_KW)
    mel = np.random.default_rng(shape[-2]).standard_normal(shape).astype(
        np.float32)
    ref_spec = np.asarray(j_voc.vocoder_spectra(jv, jc, jnp.asarray(mel)))
    spec = t_voc.vocoder_spectra(tv, tc, torch.from_numpy(mel))
    assert spec.dtype == torch.complex64
    assert tuple(spec.shape) == shape[:-1] + (129,)
    peak = np.abs(ref_spec).max()
    assert np.abs(spec.numpy() - ref_spec).max() <= 1e-4 * peak
    ref_wav = np.asarray(j_voc.vocoder_waveform(jv, jc, jnp.asarray(mel)))
    wav = t_voc.vocoder_waveform(tv, tc, torch.from_numpy(mel))
    assert tuple(wav.shape) == shape[:-2] + (shape[-2] * 64,)
    assert np.abs(wav.numpy() - ref_wav).max() <= 1e-4 * np.abs(ref_wav).max()
    cut = t_voc.vocoder_waveform(tv, tc, torch.from_numpy(mel), length=100)
    np.testing.assert_array_equal(cut.numpy(), wav.numpy()[..., :100])
    assert t_voc.vocoder_halo_frames(tc) == j_voc.vocoder_halo_frames(jc) == 6
    # interior chunks: no tail repeat
    ref_open = np.asarray(j_voc.spectra_to_waveform(
        jc, jnp.asarray(ref_spec), tail_repeat=False))
    got_open = t_voc.spectra_to_waveform(tc, spec, tail_repeat=False)
    assert tuple(got_open.shape) == ref_open.shape
    assert np.abs(got_open.numpy() - ref_open).max() <= 1e-4 * np.abs(
        ref_open).max()


def test_vocoder_chunk_with_halo_matches_whole(voc_params):
    """Frame-locality: frames [a, b) from mel [a - halo, b + halo) equal
    those of the whole sequence to rounding (the matmuls see other row
    counts): 1e-5 of the peak."""
    _, tv = voc_params
    tc = VocoderConfig(**VOC_KW)
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 64, 16)).astype(np.float32))
    full = t_voc.vocoder_spectra(tv, tc, mel)
    halo, a, b = t_voc.vocoder_halo_frames(tc), 20, 36
    part = t_voc.vocoder_spectra(tv, tc, mel[:, a - halo:b + halo])
    err = (part[:, halo:halo + b - a] - full[:, a:b]).abs().max()
    assert float(err) <= 1e-5 * float(full.abs().max())


def test_vocoder_under_bf16_parameters(voc_params):
    """bf16 weights with the fp32 mel buffer, as the flagship runs:
    activations stay fp32, the spectra are complex64 and agree with JAX
    to 1e-4 of the peak; a bf16 mel input builds complex64 as well."""
    import jax

    jv, tv = voc_params
    jc, tc = JVocoderConfig(**VOC_KW), VocoderConfig(**VOC_KW)
    jv16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jv)
    tv16 = cast_floating(tv, torch.bfloat16)
    mel = np.random.default_rng(3).standard_normal((2, 10, 16)).astype(
        np.float32)
    ref = np.asarray(j_voc.vocoder_spectra(jv16, jc, jnp.asarray(mel)))
    spec = t_voc.vocoder_spectra(tv16, tc, torch.from_numpy(mel))
    assert spec.dtype == torch.complex64
    assert np.abs(spec.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    spec16 = t_voc.vocoder_spectra(tv16, tc, torch.from_numpy(mel).bfloat16())
    assert spec16.dtype == torch.complex64
    assert bool(torch.isfinite(torch.view_as_real(spec16)).all())


# -- speaker encoder ---------------------------------------------------------

@pytest.mark.parametrize("shape,n_mels,d_out", [((16_000,), 80, 64),
                                                ((2, 8_000), 80, 32),
                                                ((4_000,), 16, 64)])
def test_speaker_embed_matches_jax(shape, n_mels, d_out):
    js = j_init_speaker(0, n_mels=n_mels, d_out=d_out)
    ts = params_from_jax(js)
    audio = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = np.asarray(j_speaker_embed(js, jnp.asarray(audio), n_mels=n_mels))
    got = speaker_embed(ts, torch.from_numpy(audio), n_mels=n_mels)
    assert tuple(got.shape) == shape[:-1] + (d_out,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)
