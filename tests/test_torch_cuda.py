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
