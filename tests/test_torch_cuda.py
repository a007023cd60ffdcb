"""Kernels against their plain versions on the card, at small shapes.
These need an NVIDIA GPU and the CUDA toolkit: they skip on a machine
without one. On the card: ``python -m pytest tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from janus_tpu_torch.common.device import resolve_device

    return resolve_device("cuda")


def test_mel_kernel_matches_plain(dev):
    from janus_tpu_torch.ops.mel import log_mel_spectrogram
    from janus_tpu_torch.ops.mel_fused import KERNEL, log_mel_spectrogram_fused

    audio = torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal(
        (3, 16_000))).astype(np.float32)).to(dev)
    for n_mels in (80, 128):
        before = KERNEL.launches
        out = log_mel_spectrogram_fused(audio, n_mels=n_mels)
        assert KERNEL.launches == before + 1
        ref = log_mel_spectrogram(audio, n_mels=n_mels)
        torch.testing.assert_close(out, ref, rtol=0, atol=5e-5)


# an odd signal length, a batch of 1, an odd frame count (51: the last pair
# of frames is half empty), the shortest signal the reflect edge allows,
# 1 and 77 mels; atol 5e-5 as the JAX package holds its fused kernel to
@pytest.mark.parametrize("route", ["fft", "dense"])
@pytest.mark.parametrize("shape,n_mels", [
    ((3, 16_123), 77), ((1, 16_000), 1), ((2, 8_160), 128), ((2, 8_160), 80),
    ((5, 330), 80), ((2, 3, 4_000), 128)])
def test_mel_routes_match_plain(dev, route, shape, n_mels):
    from janus_tpu_torch.ops.mel import _floor_and_scale, log_mel_spectrogram
    from janus_tpu_torch.ops.mel_fused import KERNEL, mel_log10

    audio = torch.from_numpy((0.3 * np.random.default_rng(5).standard_normal(
        shape)).astype(np.float32)).to(dev)
    before = KERNEL.launches
    out = _floor_and_scale(mel_log10(audio, n_mels=n_mels, route=route))
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    ref = log_mel_spectrogram(audio, n_mels=n_mels)
    assert out.shape == ref.shape == shape[:-1] + (shape[-1] // 160, n_mels)
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-5)


def test_mel_fft_route_reads_rows_in_place(dev):
    """Rows that are a slice of a longer buffer (as ``prepare_mel`` trims
    them) and a misaligned first sample give the contiguous copy's result,
    bit for bit."""
    from janus_tpu_torch.ops.mel_fused import mel_log10

    g = torch.Generator(device=dev).manual_seed(6)
    buf = torch.randn((4, 20_001), generator=g, device=dev)
    for start in (0, 1, 2, 3):
        rows = buf[:, start:start + 16_000]
        assert not rows.is_contiguous()
        assert torch.equal(mel_log10(rows), mel_log10(rows.contiguous()))


def test_mel_routes_reject(dev):
    from janus_tpu_torch.ops.mel_fused import mel_log10

    audio = torch.zeros((2, 4_000), device=dev)
    with pytest.raises(ValueError):
        mel_log10(audio, n_fft=512, route="fft")
    with pytest.raises(ValueError):
        mel_log10(audio, route="cufft")
    with pytest.raises(ValueError):
        mel_log10(audio[:, :200])
    # another frame length takes the dense kernel by itself
    from janus_tpu_torch.ops.mel import _floor_and_scale, log_mel_spectrogram
    torch.testing.assert_close(
        _floor_and_scale(mel_log10(audio + 0.1, n_fft=512, hop=128)),
        log_mel_spectrogram(audio + 0.1, n_fft=512, hop=128), rtol=0,
        atol=5e-5)


# bf16: two bf16 ulps of the output for its rounding (rtol), plus 5e-3 for
# p rounded to bf16 before PV in each version, which shows where outputs
# cancel to near zero (atol). Dh 64 in bf16 takes the tensor-core kernel,
# everything else the SIMT one; causal where the lengths agree.
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 0, 2e-5),
                                             (torch.bfloat16, 2 ** -6, 5e-3)])
@pytest.mark.parametrize("bh,tq,tk,dh,causal", [
    (6, 77, 77, 64, False), (6, 77, 77, 64, True),
    (3, 64, 64, 64, False), (3, 64, 64, 64, True),
    (2, 130, 500, 64, False), (2, 1, 65, 64, False),
    (6, 77, 77, 32, False), (6, 77, 77, 32, True)])
def test_flash_kernel_matches_plain(dev, dtype, rtol, atol, bh, tq, tk, dh,
                                    causal):
    from janus_tpu_torch.ops.flash import KERNEL, attend_bh, flash_forward

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((bh, tq, dh), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((bh, tk, dh), generator=g, device=dev).to(dtype)
            for _ in range(2))
    before = KERNEL.launches
    out = flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    ref = attend_bh(q, k, v, causal)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


def test_flash_kernels_agree_on_the_same_input(dev):
    """bf16 at Dh 64 through the tensor-core kernel and through the SIMT
    one (the forced route), each within the bar of the plain version; a
    route that does not take the input raises."""
    from janus_tpu_torch.ops.flash import attend_bh, flash_forward

    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((4, 200, 64), generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    ref = attend_bh(q, k, v, False).float()
    for route in ("wgmma", "simt"):
        out = flash_forward(q, k, v, route=route)
        torch.testing.assert_close(out.float(), ref, rtol=2 ** -6, atol=5e-3)
    with pytest.raises(ValueError):
        flash_forward(q.float(), k.float(), v.float(), route="wgmma")


def test_yin_kernel_matches_plain(dev):
    from janus_tpu_torch.ops.yin import _pad_stream
    from janus_tpu_torch.ops.yin_blocksums import block_sums, block_sums_plain

    audio = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16_000)).astype(np.float32)).to(dev)
    padded, n_hops = _pad_stream(audio, 1360, 170)
    out = block_sums(padded, n_hops + 3, 170, 402)
    ref = block_sums_plain(padded, n_hops + 3, 170, 402)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-4)


# the 48 kHz geometry with its lag count and with every lag; lag counts
# that leave 3 and 1 of a thread's 8 lags; row counts that are no multiple
# of the plan's rows per block; a signal shorter than one row's span
@pytest.mark.parametrize("buf,hop,n_lags,shape", [
    (4096, 512, 1202, (2, 96_000)), (4096, 512, 2048, (1, 20_000)),
    (1360, 170, 403, (3, 3_000)), (1360, 170, 17, (2, 5_000)),
    (1360, 170, 402, (1, 300)), (1360, 170, 402, (2, 3, 4_000))])
def test_yin_routes_match_plain_and_each_other(dev, buf, hop, n_lags, shape):
    from janus_tpu_torch.ops.yin import _pad_stream
    from janus_tpu_torch.ops.yin_blocksums import (KERNEL, block_sums,
                                                   block_sums_plain)

    audio = torch.from_numpy(np.random.default_rng(7).standard_normal(
        shape).astype(np.float32)).to(dev)
    padded, n_hops = _pad_stream(audio, buf, hop)
    nblk = n_hops + (buf // 2) // hop - 1
    ref = block_sums_plain(padded, nblk, hop, n_lags)
    before = KERNEL.launches
    tiled = block_sums(padded, nblk, hop, n_lags)
    simple = block_sums(padded, nblk, hop, n_lags, route="simple")
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 2
    assert tiled.shape == ref.shape == shape[:-1] + (nblk, n_lags)
    torch.testing.assert_close(tiled, ref, rtol=2e-4, atol=2e-4)
    # one fmaf chain per output over i in index order, in both kernels
    assert torch.equal(tiled, simple)


def test_yin_rows_too_large_for_shared_memory_raise(dev):
    from janus_tpu_torch.ops.yin_blocksums import block_sums

    with pytest.raises(ValueError):
        block_sums(torch.zeros((1, 100_000), device=dev), 2, 8192, 30_000)


# bf16: both versions compute in fp32 and round once to bf16, so they may
# differ by one bf16 ulp of the output (at most 2^-7 of |ref|); fp32 by
# the order of the sums only
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 0, 2e-5),
                                             (torch.bfloat16, 2 ** -7, 1e-5)])
@pytest.mark.parametrize("tq", [1, 3, 5])
@pytest.mark.parametrize("t", [77, 200, 499, 500, 1500])
def test_cross_attn_int8_kernel_matches_plain(dev, dtype, rtol, atol, tq, t):
    from janus_tpu_torch.ops.cross_attn import (KERNEL, cross_attention_kv,
                                                cross_attention_int8_plain)
    from janus_tpu_torch.ops.quant import quantize_kv_t

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 5, tq, 64), generator=g, device=dev).to(dtype)
    k, v = (quantize_kv_t(torch.randn((2, 5, t, 64), generator=g,
                                      device=dev)) for _ in range(2))
    before = KERNEL.launches
    out = cross_attention_kv(q, k, v)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    ref = cross_attention_int8_plain(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)


# T 77, 200 and 499+ give 1, 2 and 4 blocks per (batch, head)
@pytest.mark.parametrize("t,width", [(77, 1), (200, 4), (499, 1), (500, 4),
                                     (512, 16)])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_cross_attn_int8_packed_rows(dev, t, width, dh):
    """Rows packed densely (no padding) take the 4-byte and 1-byte loads
    and give the plain version's answer, at every head dim the kernel is
    built for."""
    from janus_tpu_torch.ops.cross_attn import (_rows, cross_attention_int8,
                                                cross_attention_int8_plain,
                                                load_bytes)
    from janus_tpu_torch.ops.quant import QuantKVT, quantize_kv_t

    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((2, 3, 2, dh), generator=g, device=dev)
    k, v = (quantize_kv_t(torch.randn((2, 3, t, dh), generator=g,
                                      device=dev)) for _ in range(2))
    ref = cross_attention_int8_plain(q, k, v)
    torch.testing.assert_close(cross_attention_int8(q, k, v), ref, rtol=0,
                               atol=2e-5)
    k, v = (QuantKVT(x.q.contiguous(), x.scale) for x in (k, v))
    (kr, k_row), (vr, v_row) = _rows(k.q), _rows(v.q)
    assert load_bytes(kr.data_ptr(), vr.data_ptr(), k_row, v_row) == width
    torch.testing.assert_close(cross_attention_int8(q, k, v), ref, rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_repeat_bit_for_bit(dev, dtype):
    """Two launches on the same inputs give equal outputs: the split-T
    combine runs in a fixed order, with no float atomics."""
    from janus_tpu_torch.ops.cross_attn import cross_attention_int8
    from janus_tpu_torch.ops.flash import flash_forward
    from janus_tpu_torch.ops.quant import quantize_kv_t

    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((8, 20, 1, 64), generator=g, device=dev).to(dtype)
    k, v = (quantize_kv_t(torch.randn((8, 20, 500, 64), generator=g,
                                      device=dev)) for _ in range(2))
    assert torch.equal(cross_attention_int8(q, k, v),
                       cross_attention_int8(q, k, v))
    fq, fk, fv = (torch.randn((20, 500, 64), generator=g,
                              device=dev).to(dtype) for _ in range(3))
    assert torch.equal(flash_forward(fq, fk, fv), flash_forward(fq, fk, fv))
    if dtype == torch.float32:
        from janus_tpu_torch.ops.mel_fused import mel_log10
        from janus_tpu_torch.ops.yin_blocksums import block_sums

        audio = torch.randn((4, 16_000), generator=g, device=dev)
        for route in ("fft", "dense"):
            assert torch.equal(mel_log10(audio, n_mels=128, route=route),
                               mel_log10(audio, n_mels=128, route=route))
        for route in ("tiled", "simple"):
            assert torch.equal(block_sums(audio, 90, 170, 402, route=route),
                               block_sums(audio, 90, 170, 402, route=route))


def test_linear_int8_dynamic_on_the_card_equals_cpu(dev):
    from janus_tpu_torch.ops.quant import (DynQuantizedWeight,
                                           linear_int8_dynamic,
                                           quantize_weight)

    rng = np.random.default_rng(2)
    # 8 rows: fewer than the card's int8 product takes, so the rows are
    # padded; the int32 sums are exact and the rescale is elementwise fp32
    x = torch.from_numpy(rng.standard_normal((8, 1, 1280)).astype(np.float32))
    w = torch.from_numpy((0.02 * rng.standard_normal((1280, 3840))
                          ).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3840,)).astype(np.float32))
    qw = DynQuantizedWeight(*quantize_weight(w))
    ref = linear_int8_dynamic(x, qw, b)
    out = linear_int8_dynamic(x.to(dev), DynQuantizedWeight(
        qw.q.to(dev), qw.scale.to(dev)), b.to(dev))
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)


# -- the receive side: plain PyTorch on the card against the CPU ------------

@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (640, 160), (400, 160)])
def test_istft_on_the_card_equals_cpu(dev, n_fft, hop):
    """Both overlap-add routes (400/160 scatters); 1e-5 on unit-scale
    spectra, and the shifted-add route repeats bit for bit."""
    from janus_tpu_torch.ops.stft import istft

    rng = np.random.default_rng(n_fft)
    spec = torch.from_numpy((rng.standard_normal((3, 40, n_fft // 2 + 1))
                             + 1j * rng.standard_normal(
                                 (3, 40, n_fft // 2 + 1))
                             ).astype(np.complex64))
    ref = istft(spec, n_fft, hop)
    out = istft(spec.to(dev), n_fft, hop)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-5)
    if n_fft % hop == 0:
        assert torch.equal(out, istft(spec.to(dev), n_fft, hop))


@pytest.mark.parametrize("up,down", [(2, 1), (3, 1), (1, 3), (160, 441),
                                     (2, 3)])
def test_resample_poly_on_the_card_equals_cpu(dev, up, down):
    from janus_tpu_torch.ops.resample import resample_poly

    x = torch.from_numpy((0.3 * np.random.default_rng(up).standard_normal(
        (2, 4410))).astype(np.float32))
    ref = resample_poly(x, up, down)
    out = resample_poly(x.to(dev), up, down)
    assert out.shape == ref.shape
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-5)


def test_upsample_chunk_is_bit_equal_on_the_card(dev):
    from janus_tpu_torch.ops.resample import _upsample_fir

    x = torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal(
        (1, 6000))).astype(np.float32)).to(dev)
    full = _upsample_fir(x, 2)
    part = _upsample_fir(x[:, 872:2664], 2)
    assert torch.equal(part[:, 256:-256], full[:, 2000:5072])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_tts_generate_on_the_card_equals_cpu(dev, dtype):
    """fp32 parameters; fp32 caches within 1e-4, bf16 caches within 2e-3
    (a cached value may round to the neighbouring bf16); ``n_frames``
    equal; then the vocoder and the resampler on that mel within 1e-4 of
    the peak."""
    from janus_tpu_torch.common.config import TTSConfig, VocoderConfig
    from janus_tpu_torch.models.params import tree_to
    from janus_tpu_torch.models.tts import init_tts, tts_generate
    from janus_tpu_torch.models.vocoder import init_vocoder, vocoder_waveform
    from janus_tpu_torch.ops.resample import resample_poly

    cfg = TTSConfig(d_model=64, layers=2, num_heads=4, n_mels=16,
                    max_text_tokens=32, max_mel_frames=32, dtype=dtype)
    vcfg = VocoderConfig(d_model=64, layers=2, n_fft=256, hop_length=64)
    g = torch.Generator().manual_seed(0)
    params = init_tts(g, cfg)
    voc = init_vocoder(g, vcfg, n_mels=16)
    rng = np.random.default_rng(1)
    text = torch.from_numpy(rng.integers(0, 256, (2, 8)))
    emo = torch.tensor([1, 4])
    spk = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    ref, ref_n = tts_generate(params, cfg, text, emo, speaker=spk,
                              stop_threshold=2.0)
    out, n = tts_generate(tree_to(params, dev), cfg, text.to(dev),
                          emo.to(dev), speaker=spk.to(dev),
                          stop_threshold=2.0)
    assert out.device.type == "cuda" and torch.equal(n.cpu(), ref_n)
    torch.testing.assert_close(out.cpu(), ref, rtol=0,
                               atol=1e-4 if dtype == "float32" else 2e-3)
    wav_ref = resample_poly(vocoder_waveform(voc, vcfg, ref), 2, 1)
    wav = resample_poly(vocoder_waveform(tree_to(voc, dev), vcfg,
                                         ref.to(dev)), 2, 1)
    assert float((wav.cpu() - wav_ref).abs().max()) <= 1e-4 * float(
        wav_ref.abs().max())
