"""Kernels against their plain versions on the card, at small shapes.
These need an NVIDIA GPU and the CUDA toolkit: they skip on a machine
without one. On the card: ``python -m pytest tests/test_torch_cuda.py``."""

import re

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
    from janus_tpu_torch.ops.int8_linear import KERNEL
    from janus_tpu_torch.ops.quant import (DynQuantizedWeight, column_major,
                                           linear_int8_dynamic,
                                           quantize_weight)

    rng = np.random.default_rng(2)
    # 8 rows, as a decode step at b = 8 gives them: the weight converted
    # to the kernel's layout once, as SemanticEncoder converts its tree;
    # the int32 sums are exact and the rescale is rounded as the CPU's
    x = torch.from_numpy(rng.standard_normal((8, 1, 1280)).astype(np.float32))
    w = torch.from_numpy((0.02 * rng.standard_normal((1280, 3840))
                          ).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3840,)).astype(np.float32))
    qw = DynQuantizedWeight(*quantize_weight(w))
    ref = linear_int8_dynamic(x, qw, b)
    before = KERNEL.launches
    out = linear_int8_dynamic(x.to(dev), column_major(DynQuantizedWeight(
        qw.q.to(dev), qw.scale.to(dev))), b.to(dev))
    assert KERNEL.launches == before + 1
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)


def _int8_case(dev, m, k, n, x_dtype, p_dtype, bias=True, seed=0):
    """x with an all-zero first row, a K-contiguous int8 weight with its
    scales and the bias in the parameters' dtype."""
    from janus_tpu_torch.ops.quant import (DynQuantizedWeight, column_major,
                                           quantize_weight)

    g = torch.Generator(device=dev).manual_seed(seed)
    x = (3 * torch.randn((m, k), generator=g, device=dev)).to(x_dtype)
    x[0] = 0
    qw = quantize_weight(0.05 * torch.randn((k, n), generator=g, device=dev))
    qw = column_major(DynQuantizedWeight(qw.q, qw.scale.to(p_dtype)))
    b = (torch.randn(n, generator=g, device=dev).to(p_dtype) if bias
         else None)
    return x, qw, b


# every shape of the main path (large-v3: the decode steps' four weights at
# b = 1, 8, 64 and the 4-token prefill at b = 8; the encoder's and the cross
# K/V's at 8 x 10 s, the 2 s bucket at b = 64) and the demo width
_INT8_SHAPES = ([(m, k, n) for m in (1, 8, 32, 64)
                 for k, n in ((1280, 3840), (1280, 1280), (1280, 5120),
                              (5120, 1280))]
                + [(m, k, n) for m in (4000, 6400)
                   for k, n in ((1280, 1280), (1280, 5120), (5120, 1280))]
                + [(m, k, n) for m in (8, 100)
                   for k, n in ((128, 384), (128, 128), (128, 512),
                                (512, 128))])


@pytest.mark.parametrize("m,k,n", _INT8_SHAPES)
def test_int8_linear_bit_equal_to_plain(dev, m, k, n):
    """The kernel's output, quantized rows and row scales equal the plain
    version's on the card bit for bit (bf16 activations and parameters, as
    the flagship's tree)."""
    from janus_tpu_torch.ops.int8_linear import (_launch, _round_int8,
                                                 _scale_of, int8_linear_plain)

    x, qw, b = _int8_case(dev, m, k, n, torch.bfloat16, torch.bfloat16)
    y, xq, xs = _launch(x, qw, b)
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=-1, keepdim=True))
    assert torch.equal(xs, scale)
    assert torch.equal(xq, _round_int8(xf / scale))
    assert torch.equal(y, int8_linear_plain(x, qw, b))


@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 1280, 1280), (64, 5120, 1280)])
def test_int8_linear_amax_in_one_split(dev, m, k, n, x_dtype, where):
    """Rows whose largest |x| lies only in the first or only in the last
    split's range of K: the scale is the whole row's amax, whatever the
    split plan (a range's own would pass any tolerance)."""
    from janus_tpu_torch.ops.int8_linear import (_launch, _round_int8,
                                                 _scale_of, _sm_count,
                                                 int8_linear_plain,
                                                 plan_splits)

    x, qw, b = _int8_case(dev, m, k, n, x_dtype, torch.bfloat16, seed=k)
    splits = plan_splits(m, k, n, _sm_count(dev))
    assert splits == 8
    span = k // splits
    lo, hi = (0, span) if where == "first" else (k - span, k)
    for r in range(1, m, 2):  # odd rows: the peak only in that range
        x[r] = x[r].clamp(-1, 1)
        x[r, lo + (r * 37) % span] = 40.0 * (-1) ** r
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=-1, keepdim=True))
    for s_ in (splits, 1, 2, 4):
        y, xq, xs = _launch(x, qw, b, splits=s_)
        assert torch.equal(xs, scale), s_
        assert torch.equal(xq, _round_int8(xf / scale)), s_
        assert torch.equal(y, int8_linear_plain(x, qw, b)), s_


# fp32 and bf16 activations against fp32 and bf16 parameters, no bias;
# ragged rows (17, 33, 65, 257, 4001) and columns (96, 100); every split
# plan and the warpgroup product at few rows; the overlapped launch on and
# off; fc2 at 64 rows in fp32 (the streaming slots' ring at small splits);
# the persistent product with fewer tiles than SMs (65 and 128 rows) and
# ragged last tiles in both dimensions (4001 x 100)
@pytest.mark.parametrize("x_dtype,p_dtype,bias", [
    (torch.float32, torch.float32, True), (torch.float32, torch.bfloat16,
                                           True),
    (torch.bfloat16, torch.float32, False), (torch.bfloat16, torch.bfloat16,
                                             False)])
@pytest.mark.parametrize("m,k,n", [(17, 512, 384), (33, 160, 96),
                                   (65, 256, 100), (257, 160, 96),
                                   (5, 1280, 1280), (64, 5120, 1280),
                                   (4001, 1280, 100), (65, 1280, 1280),
                                   (128, 1280, 1280)])
def test_int8_linear_types_plans_and_edges(dev, m, k, n, x_dtype, p_dtype,
                                           bias):
    from janus_tpu_torch.ops.int8_linear import _launch, int8_linear_plain

    x, qw, b = _int8_case(dev, m, k, n, x_dtype, p_dtype, bias, seed=m)
    ref = int8_linear_plain(x, qw, b)
    plans = [None, 0] + ([s for s in (1, 2, 4, 8) if s <= k // 32]
                         if m <= 64 else [])
    for splits in plans:
        for pdl in (None, True, False):
            y = _launch(x, qw, b, splits=splits, pdl=pdl)[0]
            assert y.dtype == x_dtype
            assert torch.equal(y, ref), (splits, pdl)


def test_int8_linear_two_launches_a_call(dev):
    """One call is two kernels on the device (the quantization and the
    product), at decode shapes and encoder shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from janus_tpu_torch.ops.int8_linear import KERNEL, int8_linear

    for m in (8, 64, 65, 4000):
        x, qw, b = _int8_case(dev, m, 1280, 1280, torch.bfloat16,
                              torch.bfloat16)
        int8_linear(x, qw, b)
        torch.cuda.synchronize()
        before = KERNEL.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            int8_linear(x, qw, b)
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        assert KERNEL.launches == before + 1
        if device:  # a profiler without device tracing records none
            assert len(device) == 2, (m, [e.name for e in device])


@pytest.mark.parametrize("m,k,n", [(8, 5120, 1280), (4000, 1280, 5120)])
def test_int8_linear_replays_from_a_graph(dev, m, k, n):
    """A captured call replays bit-equal on new inputs (no workspace to
    reset between calls), at the decode step's fc2 shape and the encoder's
    fc1 (the persistent product)."""
    from janus_tpu_torch.ops.int8_linear import int8_linear, int8_linear_plain

    x, qw, b = _int8_case(dev, m, k, n, torch.bfloat16, torch.bfloat16)
    xs = x.clone()
    y = int8_linear(xs, qw, b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = int8_linear(xs, qw, b)
    for seed in range(3):
        g = torch.Generator(device=dev).manual_seed(100 + seed)
        xs.copy_(torch.randn(xs.shape, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, int8_linear_plain(xs, qw, b))


@pytest.mark.parametrize("m", [4000, 6400])
def test_int8_linear_reads_a_weight_written_just_before(dev, m):
    """A copy kernel writes the int8 weight just before each programmatic
    call at the tile product's row counts (the product asks for the
    weight before its wait; the quantization before it lets it start
    only once the kernel before the call has finished): every call gives
    the plain version's bits on the weight written. Each round's weight
    lies where the last one lay."""
    from janus_tpu_torch.ops.int8_linear import _launch, int8_linear_plain
    from janus_tpu_torch.ops.quant import DynQuantizedWeight

    k, n = 1280, 5120
    x, qw, b = _int8_case(dev, m, k, n, torch.bfloat16, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(m)
    srcs = [torch.randint(-127, 128, (n, k), generator=g, device=dev,
                          dtype=torch.int8) for _ in range(6)]
    buf = torch.empty((n, k), dtype=torch.int8, device=dev)
    got = []
    for src in srcs:
        buf.copy_(src)
        got.append(_launch(x, DynQuantizedWeight(buf.t(), qw.scale), b,
                           pdl=True)[0])
    torch.cuda.synchronize()
    for src, y in zip(srcs, got):
        assert torch.equal(y, int8_linear_plain(
            x, DynQuantizedWeight(src.t(), qw.scale), b))


def test_int8_linear_raises_on_what_it_cannot_take(dev):
    from janus_tpu_torch.ops.int8_linear import int8_linear
    from janus_tpu_torch.ops.quant import DynQuantizedWeight, linear_int8_dynamic

    x, qw, b = _int8_case(dev, 8, 1280, 1280, torch.bfloat16, torch.bfloat16)
    rows = DynQuantizedWeight(qw.q.contiguous(), qw.scale)
    with pytest.raises(ValueError, match="column_major"):
        linear_int8_dynamic(x, rows, b)
    with pytest.raises(TypeError):
        int8_linear(x.half(), qw, b)
    with pytest.raises(ValueError):
        int8_linear(x[:, :1000], DynQuantizedWeight(qw.q[:1000], qw.scale), b)
    with pytest.raises(ValueError):
        int8_linear(x, DynQuantizedWeight(qw.q.cpu(), qw.scale), b)


# -- the mixed-dtype linear (fp32 rows against bf16 weights) ---------------

def _mixed_case(dev, m, k, n, bias="bfloat16", seed=0):
    """fp32 rows, a bf16 weight [k, n] and a bias (bf16, fp32 or none)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = 2 * torch.randn((m, k), generator=g, device=dev)
    w = (0.05 * torch.randn((k, n), generator=g, device=dev)).to(
        torch.bfloat16)
    b = None if bias is None else (0.1 * torch.randn(
        n, generator=g, device=dev)).to(getattr(torch, bias))
    return x, w, b


def _mixed_bar(x, w, b, scale=1e-5):
    """``scale * (sum_k |x_k w_kn| + |b_n|)`` elementwise, in float64."""
    mag = x.double().abs() @ w.double().abs()
    if b is not None:
        mag = mag + b.double().abs()
    return scale * mag


# the AR step's linears at flagship width (d 1280, r mels 320): the
# prenet, q/k/v/out, fc1, fc2, the mel and the stop heads
_MIXED_SHAPES = [(320, 1280), (1280, 1280), (1280, 5120), (5120, 1280),
                 (1280, 320), (1280, 1)]


@pytest.mark.parametrize("bias", ["bfloat16", "float32", None])
@pytest.mark.parametrize("m", [1, 8, 16, 64])
@pytest.mark.parametrize("k,n", _MIXED_SHAPES)
def test_mixed_linear_holds_the_bar_of_plain(dev, k, n, m, bias):
    """Within 1e-5 (sum |x w| + |b|) of the plain version elementwise; the
    kernel's largest error against a float64 product within 2x the plain
    version's (where there are 256 outputs or more: the largest of a few
    is one draw); two launches bit-equal."""
    from janus_tpu_torch.ops.mixed_linear import (KERNEL, mixed_linear,
                                                  mixed_linear_plain)

    x, w, b = _mixed_case(dev, m, k, n, bias, seed=k + n + m)
    before = KERNEL.launches
    y = mixed_linear(x, w, b)
    assert KERNEL.launches == before + 1
    ref = mixed_linear_plain(x, w, b)
    assert y.dtype == torch.float32 and y.shape == (m, n)
    assert bool(((y - ref).double().abs() <= _mixed_bar(x, w, b)).all())
    exact = x.double() @ w.double()
    if b is not None:
        exact = exact + b.double()
    err = float((y.double() - exact).abs().max())
    plain_err = float((ref.double() - exact).abs().max())
    assert m * n < 256 or err <= 2 * plain_err, (err, plain_err)
    assert torch.equal(y, mixed_linear(x, w, b))


@pytest.mark.parametrize("m,k,n", [(8, 100, 72), (5, 1280, 100),
                                   (3, 96, 1), (64, 200, 136),
                                   (9, 1280, 1280), (33, 320, 320)])
def test_mixed_linear_plans_and_edges(dev, m, k, n):
    """Every split plan and row grouping; N not a multiple of 8 (a value
    at a time) and K not one; ragged column tiles; rows that are a
    misaligned view; a weight that is a column slice of a wider one (its
    rows further apart)."""
    from janus_tpu_torch.ops.mixed_linear import (_launch,
                                                  mixed_linear_plain,
                                                  vector_loads)

    x, w, b = _mixed_case(dev, m, k, n, seed=m * k)
    ref = mixed_linear_plain(x, w, b)
    bar = _mixed_bar(x, w, b)
    for splits in (1, 2, 4, 8):
        if splits <= -(-k // 8):
            y = _launch(x, w, b, splits=splits)
            assert bool(((y - ref).double().abs() <= bar).all()), splits
    for rows in (1, 2, 4, 8):
        if 8 * rows >= m:
            y = _launch(x, w, b, rows=rows)
            assert bool(((y - ref).double().abs() <= bar).all()), rows
    # rows one fp32 value into a buffer
    buf = torch.empty(m * k + 1, device=dev)
    view = buf[1:].view(m, k)
    view.copy_(x)
    assert view.data_ptr() % 16
    assert torch.equal(_launch(view, w, b), _launch(x, w, b))
    # the weight's columns inside a wider row
    wide = torch.zeros((k, n + 24), dtype=torch.bfloat16, device=dev)
    wide[:, 8:8 + n] = w
    part = wide[:, 8:8 + n]
    assert vector_loads(n, part.stride(0), part.data_ptr()) == (n % 8 == 0)
    assert torch.equal(_launch(x, part, b), _launch(x, w.contiguous(), b))


def test_mixed_linear_replays_from_a_graph(dev):
    """A captured call replays bit-equal to an eager launch on new inputs
    (nothing to reset between calls)."""
    from janus_tpu_torch.ops.mixed_linear import mixed_linear

    x, w, b = _mixed_case(dev, 8, 5120, 1280)
    xs = x.clone()
    y = mixed_linear(xs, w, b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = mixed_linear(xs, w, b)
    for seed in range(3):
        g = torch.Generator(device=dev).manual_seed(200 + seed)
        xs.copy_(torch.randn(xs.shape, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, mixed_linear(xs.clone(), w, b))


def test_mixed_linear_gradient_is_the_plain_one(dev):
    from janus_tpu_torch.ops.mixed_linear import (mixed_linear,
                                                  mixed_linear_plain)

    x, w, b = _mixed_case(dev, 4, 256, 128, seed=7)
    g = torch.randn((4, 128), device=dev)

    def grads(fn):
        ins = [t.detach().clone().requires_grad_() for t in (x, w, b)]
        return torch.autograd.grad(fn(*ins), ins, g)

    for a, c in zip(grads(mixed_linear), grads(mixed_linear_plain)):
        assert torch.equal(a, c)


def test_mixed_linear_raises_on_what_it_cannot_take(dev):
    """No fallback: a CPU tensor, more than 64 rows, other dtypes, a weight
    whose N is not contiguous, a bias of another type raise; ``linear``
    routes above 64 rows to the per-call widening instead."""
    from janus_tpu_torch.ops.layers import linear
    from janus_tpu_torch.ops.mixed_linear import (KERNEL, _launch,
                                                  mixed_linear_plain)

    x, w, b = _mixed_case(dev, 8, 256, 128)
    with pytest.raises(ValueError, match="not a CUDA device"):
        _launch(x.cpu(), w.cpu(), b.cpu())
    with pytest.raises(ValueError):
        _launch(torch.zeros((65, 256), device=dev), w, b)
    with pytest.raises(TypeError):
        _launch(x.bfloat16(), w, b)
    with pytest.raises(TypeError):
        _launch(x, w.half(), b)
    with pytest.raises(ValueError):
        _launch(x[:, :128], w.t().contiguous().t()[:128], b)
    with pytest.raises(TypeError):
        _launch(x, w, b.half())
    with pytest.raises(ValueError):
        _launch(x, w.cpu(), b)
    many = torch.randn((65, 256), device=dev)
    before = KERNEL.launches
    assert torch.equal(linear(many, w, b), mixed_linear_plain(many, w, b))
    assert KERNEL.launches == before


def test_mixed_linear_group_is_each_member_at_the_group_plan(dev):
    """One launch for q/k/v (k without a bias) and for the mel and stop
    heads (N 320 and 1: 16-byte and value-at-a-time tiles in one launch):
    each output within 1e-5 (sum |x w| + |b|) of the plain version and bit
    for bit the member launched alone at the group's splits and rows (the
    same order of sums); two launches bit-equal; one launch counted."""
    from janus_tpu_torch.ops.mixed_linear import (KERNEL, _launch,
                                                  _sm_count,
                                                  mixed_linear_group,
                                                  mixed_linear_plain,
                                                  plan_group)

    for m in (1, 8):
        for spec in ([(1280, "bfloat16"), (1280, None), (1280, "bfloat16")],
                     [(320, "bfloat16"), (1, "bfloat16")],
                     [(100, "float32"), (72, None), (1, None), (8, "bfloat16")]):
            x, _, _ = _mixed_case(dev, m, 1280, 1, seed=m)
            members = [_mixed_case(dev, 1, 1280, n, bias, seed=n + i)[1:]
                       for i, (n, bias) in enumerate(spec)]
            plan = plan_group(m, 1280, [n for n, _ in spec], _sm_count(dev))
            before = KERNEL.launches
            ys = mixed_linear_group(x, members)
            assert KERNEL.launches == before + 1
            for y, (w, b) in zip(ys, members):
                ref = mixed_linear_plain(x, w, b)
                assert y.shape == ref.shape
                assert bool(((y - ref).double().abs()
                             <= _mixed_bar(x, w, b)).all())
                alone = _launch(x, w, b, splits=plan.splits, rows=plan.rows)
                assert torch.equal(y, alone)
            again = mixed_linear_group(x, members)
            assert all(torch.equal(a, c) for a, c in zip(ys, again))


@pytest.mark.parametrize("m", [1, 8, 64])
def test_mixed_linear_gelu_epilogue_holds_the_bar(dev, m):
    """fc1 with the exact GELU in the epilogue: within 1e-5 (sum |x w| +
    |b|) of gelu(mixed_linear_plain); two launches bit-equal; the CPU-side
    option off gives the plain product's kernel."""
    from janus_tpu_torch.ops.layers import gelu, linear_gelu
    from janus_tpu_torch.ops.mixed_linear import (mixed_linear,
                                                  mixed_linear_plain)

    x, w, b = _mixed_case(dev, m, 1280, 5120, seed=m)
    y = mixed_linear(x, w, b, gelu=True)
    ref = gelu(mixed_linear_plain(x, w, b))
    assert bool(((y - ref).double().abs() <= _mixed_bar(x, w, b)).all())
    assert torch.equal(y, mixed_linear(x, w, b, gelu=True))
    assert torch.equal(y, linear_gelu(x, w, b))


@pytest.mark.parametrize("pdl", [True, False])
def test_mixed_linear_reads_a_weight_written_just_before(dev, pdl):
    """The layer norm writes the weight (bf16 rows of width N) and lets its
    dependents start once its rows are read; the programmatic call right
    after it, whose blocks ask the L2 cache for that weight before their
    wait, gives the bits of the same call made after a synchronize. Each
    round's weight lands where the last one lay (the allocator reuses the
    block), so a read before the norm's writes would see the old one."""
    from janus_tpu_torch.ops.layers import layer_norm_fused
    from janus_tpu_torch.ops.mixed_linear import _launch

    k, n = 1280, 1280
    g = torch.Generator(device=dev).manual_seed(11)
    x = 2 * torch.randn((8, k), generator=g, device=dev)
    scale = (0.05 * torch.randn(n, generator=g, device=dev)).bfloat16()
    shift = (0.01 * torch.randn(n, generator=g, device=dev)).bfloat16()
    srcs = [torch.randn((k, n), generator=g, device=dev).bfloat16()
            for _ in range(6)]
    got = []
    for src in srcs:
        w = layer_norm_fused(src, scale, shift)
        got.append(_launch(x, w, None, pdl=pdl))
        del w
    torch.cuda.synchronize()
    for src, y in zip(srcs, got):
        w = layer_norm_fused(src, scale, shift)
        torch.cuda.synchronize()
        assert torch.equal(y, _launch(x, w, None, pdl=False))


def test_mixed_linear_group_and_gelu_replay_from_a_graph(dev):
    """The grouped launch and fc1's GELU epilogue, programmatic after a
    layer norm, captured: each replay bit-equal to the eager calls."""
    from janus_tpu_torch.ops.layers import layer_norm_fused
    from janus_tpu_torch.ops.mixed_linear import (mixed_linear,
                                                  mixed_linear_group)

    x, w1, b1 = _mixed_case(dev, 8, 1280, 5120, seed=3)
    members = [_mixed_case(dev, 1, 1280, 1280, bias, seed=i)[1:]
               for i, bias in enumerate(("bfloat16", None, "bfloat16"))]
    scale = torch.ones(1280, device=dev).bfloat16()
    shift = torch.zeros(1280, device=dev).bfloat16()
    xs = x.clone()

    def step():
        h = layer_norm_fused(xs, scale, shift)
        return mixed_linear_group(h, members) + [mixed_linear(h, w1, b1,
                                                              gelu=True)]

    step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for seed in range(3):
        g = torch.Generator(device=dev).manual_seed(300 + seed)
        xs.copy_(torch.randn(xs.shape, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        want = step()
        assert all(torch.equal(a, c) for a, c in zip(outs, want))


def test_mixed_linear_records_its_least_work(dev):
    from janus_tpu_torch.ops.mixed_linear import KERNEL, mixed_linear

    x, w, b = _mixed_case(dev, 8, 1280, 320)
    before = (KERNEL.launches, KERNEL.flops, KERNEL.bytes)
    mixed_linear(x, w, b)
    assert (KERNEL.launches - before[0], KERNEL.flops - before[1],
            KERNEL.bytes - before[2]) == (
        1, 2.0 * 8 * 1280 * 320 + 8 * 320,
        4 * 8 * 1280 + 2 * 1280 * 320 + 4 * 8 * 320 + 2 * 320)


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


# -- the live duplex link ---------------------------------------------------

def _demo_loopback(device):
    """The three demo phrases (1 s of silence after each) through
    ``sender_main.main_loop`` → localhost UDP → ``receive_loop`` with the
    demo bundle on ``device``: (sent, played, transcripts, played PCM)."""
    import threading
    import time

    from janus_tpu_torch.audio.io import StreamAudioService
    from janus_tpu_torch.audio.synthetic import render_text
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.common.protocol import JanusPacket
    from janus_tpu_torch.models.vad import VoiceActivityDetector
    from janus_tpu_torch.models.zoo import load_demo
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.link import LinkSimulator, PacketListener
    from janus_tpu_torch.runtime.synthesizer import Synthesizer
    from janus_tpu_torch.tools.receiver_main import receive_loop
    from janus_tpu_torch.tools.sender_main import main_loop

    b = load_demo(base=JanusConfig())
    listener = PacketListener(0, timeout=0.2)
    cfg = b.config.override(**{
        "link.baud_rate": 48_000, "link.target_ip": "127.0.0.1",
        "link.target_port": listener.port,
        "runtime.audio_queue_depth": 1_000})
    enc = SemanticEncoder(cfg, b.asr_params, buckets=(96_000,),
                          device=device)
    syn = Synthesizer(cfg, tts_params=b.tts_params,
                      vocoder_params=b.vocoder_params,
                      speaker_params=b.speaker_params,
                      default_speaker_vec=b.default_speaker_vec,
                      device=device)
    enc.warmup()
    heard = []
    receive = listener.receive

    def recording_receive():
        payload = receive()
        if payload is not None:
            heard.append(JanusPacket.deserialize(payload).text)
        return payload

    listener.receive = recording_receive
    audio = np.concatenate([np.concatenate([render_text(t, 48_000, seed=s),
                                            np.zeros(48_000, np.float32)])
                            for s, t in enumerate(("alpha bravo",
                                                   "fox golf hotel",
                                                   "kilo lima"))])
    speaker, stop, played = StreamAudioService(), threading.Event(), []
    rx = threading.Thread(target=lambda: played.append(receive_loop(
        cfg, speaker, synthesizer=syn, listener=listener, stop_event=stop,
        max_idle_seconds=8.0)), daemon=True)
    rx.start()
    sent = main_loop(cfg, StreamAudioService(audio), encoder=enc,
                     vad=VoiceActivityDetector(cfg.vad, device=device),
                     link=LinkSimulator(cfg.link), max_idle_seconds=2.0)
    deadline = time.monotonic() + 60
    while len(speaker.written_chunks) < sent and time.monotonic() < deadline:
        time.sleep(0.05)
    stop.set()
    rx.join(timeout=60)
    return sent, played[0], heard, list(speaker.written_chunks)


def test_demo_duplex_on_the_card_equals_cpu(dev):
    """The card's run against the CPU's: the same counts and transcripts,
    the PCM within 1e-2 of full scale with equal sample counts."""
    from janus_tpu_torch.ops.mel_fused import KERNEL as MEL
    from janus_tpu_torch.ops.yin_blocksums import KERNEL as YIN

    before = (MEL.launches, YIN.launches)
    card = _demo_loopback("cuda")
    assert MEL.launches > before[0] and YIN.launches > before[1]
    cpu = _demo_loopback("cpu")
    assert card[0] == cpu[0] == 3 and card[1] == cpu[1] == 3
    assert card[2] == cpu[2]
    for got, ref in zip(card[3], cpu[3]):
        assert len(got) == len(ref) > 0
        err = np.abs(np.frombuffer(got, np.int16).astype(np.float32)
                     - np.frombuffer(ref, np.int16)) / 32767.0
        assert err.max() <= 1e-2


def test_energy_vad_on_the_card_decides_as_cpu(dev):
    """200 chunks (a conversation, then loud noise): identical decisions,
    probabilities within 1e-6, the noise floor a 0-dim fp32 tensor on the
    card."""
    from janus_tpu_torch.audio.synthetic import chunk_stream, conversation
    from janus_tpu_torch.common.config import VADConfig
    from janus_tpu_torch.models.vad import VoiceActivityDetector

    conv = list(chunk_stream(conversation(turns=3, speech_seconds=1.0,
                                          silence_seconds=0.6, amp=0.3)))
    loud = (0.05 * np.random.default_rng(1).standard_normal(
        (200 - len(conv), 1536))).astype(np.float32)
    card = VoiceActivityDetector(VADConfig(backend="energy"), device="cuda")
    cpu = VoiceActivityDetector(VADConfig(backend="energy"), device="cpu")
    assert card._floor.device.type == "cuda" and card._floor.dim() == 0
    decisions = []
    for chunk in conv + list(loud):
        p, q = card.speech_prob(chunk), cpu.speech_prob(chunk)
        assert abs(p - q) <= 1e-6
        decisions.append((p > 0.5, q > 0.5))
    assert all(a == b for a, b in decisions)
    assert any(a for a, _ in decisions)


def _session_packets(device):
    """The demo bundle's ``SessionManager`` over three sessions (two
    phrases ending on one tick), one 32 ms chunk a session a tick; packet
    bytes with the timestamp fixed, in harvest order."""
    import dataclasses

    from janus_tpu_torch.audio.synthetic import render_text
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.models.zoo import load_demo
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.sessions import SessionManager

    b = load_demo(base=JanusConfig())
    mgr = SessionManager(b.config, encoder=SemanticEncoder(
        b.config, b.asr_params, buckets=(96_000,), device=device))
    silence = np.zeros(48_000, np.float32)
    a = render_text("alpha bravo", 48_000, seed=0)
    streams = {"s0": np.concatenate([a, silence]),
               "s1": np.concatenate([0.6 * a, silence]),
               "s2": np.concatenate([render_text("fox golf hotel", 48_000,
                                                 seed=1), silence])}
    for sid in streams:
        assert mgr.add_session(sid).ring.native
    out = []
    for k in range(max(len(x) for x in streams.values()) // 1536 + 1):
        for sid, x in streams.items():
            if len(x[k * 1536:(k + 1) * 1536]):
                mgr.push_audio(sid, x[k * 1536:(k + 1) * 1536])
        out += mgr.tick()
    out += mgr.flush()
    return [(sid, dataclasses.replace(p, timestamp=1.0).serialize())
            for sid, p in out]


def test_session_manager_on_the_card_equals_cpu(dev):
    from janus_tpu_torch.ops.cuda_build import KERNELS

    before = KERNELS["flash_attn"].launches
    card = _session_packets("cuda")
    assert KERNELS["flash_attn"].launches > before
    assert card == _session_packets("cpu") and len(card) == 3


def test_janus_server_on_the_card(dev, tmp_path):
    """``JanusServer`` on the card: health, and the WebSocket snapshot and
    ack through ``chip_smoke.py``'s stdlib client."""
    import chip_smoke
    from janus_tpu_torch.api.server import JanusServer
    from janus_tpu_torch.audio.io import StreamAudioService
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.models.zoo import load_demo
    from janus_tpu_torch.runtime.codec import SemanticEncoder

    b = load_demo(base=JanusConfig())
    cfg = b.config.override(**{
        "server.port": 0,
        "server.reference_audio_path": str(tmp_path / "ref.wav")})
    srv = JanusServer(cfg, audio_service=StreamAudioService(),
                      encoder=SemanticEncoder(cfg, b.asr_params,
                                              buckets=(96_000,)))
    assert srv.encoder.device.type == "cuda"
    assert srv.synthesizer.device.type == "cuda"
    with chip_smoke.serving(srv, start_engine=False):
        port = srv.http.bound_port
        assert chip_smoke.http_json(port, "/api/health") == (
            200, {"status": "ok"})
        ws = chip_smoke.WsClient(port)
        try:
            assert ws.recv_json()["type"] == "control_state"
            ws.send_json({"type": "control", "is_streaming": True})
            assert ws.recv_json()["is_streaming"] is True
        finally:
            ws.close()


def test_wrappers_record_their_least_work(dev):
    """Each launch adds its least work to its kernel, which the scaling
    rows read: attention 4 BH Tq Tk Dh, the YIN sums 2 rows lags hop, and
    each kernel's inputs read and outputs written once."""
    from janus_tpu_torch.ops.flash import KERNEL as FLASH, flash_attention
    from janus_tpu_torch.ops.mel_fused import KERNEL as MEL, mel_log10
    from janus_tpu_torch.ops.yin_blocksums import KERNEL as YIN, block_sums

    def work(k, fn):
        before = (k.launches, k.flops, k.bytes)
        fn()
        return k.launches - before[0], k.flops - before[1], k.bytes - before[2]

    q = torch.randn(2, 4, 48, 64, device=dev)
    assert work(FLASH, lambda: flash_attention(q, q, q)) == (
        1, 4.0 * 8 * 48 * 48 * 64, 4 * 8 * 48 * 64 * 4)
    x = torch.randn(3, 170 * 6 + 402, device=dev)
    assert work(YIN, lambda: block_sums(x, 6, 170, 402)) == (
        1, 2.0 * 3 * 6 * 402 * 170, 4 * (x.numel() + 3 * 6 * 402))
    audio = torch.randn(2, 16_000, device=dev)
    n, flops, nbytes = work(MEL, lambda: mel_log10(audio, n_mels=80))
    assert n == 1 and flops > 2 * 100 * 2.5 * 400 * np.log2(400)
    assert nbytes == 4 * (audio.numel() + 2 * 100 * 80)
    # the int8 linear: x (bf16), the weight, its bf16 scales and bias read
    # once, y written once; one count for its two launches
    from janus_tpu_torch.ops.int8_linear import KERNEL as INT8, int8_linear

    xi, qw, b = _int8_case(dev, 8, 1280, 3840, torch.bfloat16,
                           torch.bfloat16)
    assert work(INT8, lambda: int8_linear(xi, qw, b)) == (
        1, 2.0 * 8 * 1280 * 3840,
        2 * 8 * 1280 + 1280 * 3840 + 2 * 2 * 3840 + 2 * 8 * 3840)


# -- the decode loops replayed from CUDA graphs -----------------------------

_GRAPH_ASR = dict(n_mels=80, d_model=128, encoder_layers=2, decoder_layers=2,
                  num_heads=2, vocab_size=261, max_source_positions=64,
                  max_target_positions=32, max_decode_tokens=12,
                  dtype="bfloat16")
_GRAPH_TTS = dict(d_model=64, layers=2, num_heads=4, n_mels=16, reduction=2,
                  max_text_tokens=32, max_mel_frames=48)


def _graph_asr(dev, seed=0, int8=False):
    """A small recognizer on the card (head dim 64, K4's), bf16, with its
    random weights scaled up so that the logits separate; an encoder
    output of it and the prompt."""
    from janus_tpu_torch.common.config import ASRConfig
    from janus_tpu_torch.models.asr import encode_audio
    from janus_tpu_torch.models.params import (cast_floating, init_asr,
                                               map_tree,
                                               prepare_decode_params)
    from janus_tpu_torch.ops.quant import column_major, quantize_tree

    cfg = ASRConfig(**_GRAPH_ASR)
    tree = map_tree(lambda a: a * 4.0 if a.ndim > 1 else a, init_asr(
        torch.Generator(device=dev).manual_seed(seed), cfg))
    tree = cast_floating(tree, torch.bfloat16)
    if int8:
        tree = quantize_tree(tree, mode="dynamic")
    params = column_major(prepare_decode_params(tree))
    mel = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (4, 64, 80)).astype(np.float32)).to(dev, torch.bfloat16)
    enc = encode_audio(params, cfg, mel)
    prompt = torch.full((4, 1), 256, dtype=torch.long, device=dev)
    return cfg, params, enc, prompt


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_greedy_graph_equals_eager_on_the_card(dev, int8):
    """The loop graph gives the eager loop's tokens bit for bit, two calls
    on one holder; under int8 cross K/V the step runs K4 inside the graph,
    and the loop's trips count its launches: one a decoder layer and
    forward (the prefill's and every step the loop ran)."""
    from janus_tpu_torch.models.asr import greedy_decode
    from janus_tpu_torch.ops.cross_attn import KERNEL as CROSS
    from janus_tpu_torch.runtime.step_graph import StepGraphs

    cfg, params, enc, prompt = _graph_asr(dev, int8=int8)
    graphs = StepGraphs()
    kw = dict(max_new=12, cache_dtype=torch.bfloat16, cross_kv_int8=int8)
    for e in (enc, enc * 0.5):
        eager = greedy_decode(params, cfg, e, prompt, 257, eager=True, **kw)
        greedy_decode(params, cfg, e, prompt, 257, graphs=graphs, **kw)
        torch.cuda.synchronize()
        steps0 = graphs.steps  # the call before accounted first
        before = CROSS.launches
        graphed = greedy_decode(params, cfg, e, prompt, 257, graphs=graphs,
                                **kw)
        torch.cuda.synchronize()
        assert torch.equal(graphed, eager)
        # the loop's trips, read back: the bodies that ran
        steps = graphs.steps - steps0
        assert steps >= 7
        assert CROSS.launches - before == (
            cfg.decoder_layers * (1 + steps) if int8 else 0)
    assert len(graphs.graphs()) == 1


def _eot_at(params, step):
    """The tree with the decoder's position row ``step`` pushed along the
    eot embedding (257): with a one-token prompt every lane emits eot at
    that step."""
    dec = dict(params["decoder"])
    pos = dec["pos_emb"].clone()
    e = dec["token_emb"][257].float()
    pos[step] += (200.0 * e / e.norm()).to(pos.dtype)
    return {**params, "decoder": {**dec, "pos_emb": pos}}


def _first_all_eot(tokens, max_new):
    """The while_loop's trip count from its tokens: the first step at
    which every lane has emitted eot, at most ``max_new - 1``."""
    hit = tokens == 257
    first = torch.where(hit.any(1), hit.int().argmax(1),
                        torch.full_like(hit[:, 0], max_new, dtype=torch.long))
    return min(int(first.max()), max_new - 1)


@pytest.mark.parametrize("stop", [1, 2, 9, None], ids=["1", "2", "9",
                                                       "never"])
def test_greedy_loop_ends_on_the_card(dev, stop):
    """The loop graph (a WHILE node around the captured step, its
    condition tested on the card) gives the eager loop's tokens bit for
    bit and runs the while_loop's trips: ``stop`` where every lane emits
    eot there, 11 where none does."""
    from janus_tpu_torch.models.asr import greedy_decode, greedy_graph
    from janus_tpu_torch.runtime.step_graph import StepGraphs

    cfg, params, enc, prompt = _graph_asr(dev)
    if stop is not None:
        params = _eot_at(params, stop)
    eager = greedy_decode(params, cfg, enc, prompt, 257, max_new=12,
                          cache_dtype=torch.bfloat16, eager=True)
    graphs = StepGraphs()
    with graphs.lock:
        h = greedy_graph(graphs, params, cfg, 4, enc.shape[-2], enc.dtype, 1,
                         12, torch.bfloat16, False, 257, dev)
        for _ in range(2):
            tokens, trips = h.decode(enc, prompt)
            assert torch.equal(tokens, eager)
            assert int(trips) == _first_all_eot(eager, 12)
    assert int(trips) == (11 if stop is None else stop)
    assert h.graph.replays == 0 and h.loop.runs == 2


def test_loop_condition_kernel_equals_plain(dev):
    """The loop's condition kernel alone: the trip count and
    ``(trips < limit) & any(~done)`` as the plain version gives them, at
    one to 64 lanes (two strides of the warp), done or live in any lane,
    at and past the limit; a trivial step's loop graph (its body the
    step's own nodes) runs exactly the eager loop's trips at the exits
    the decode loops are held to, and one that finds every lane done runs
    none."""
    from janus_tpu_torch.ops.loop_graph import (loop_condition,
                                                loop_condition_plain)
    from janus_tpu_torch.runtime.step_graph import LoopGraph, StepGraph

    g = torch.Generator(device=dev).manual_seed(0)
    for batch in (1, 8, 33, 64):
        for p in (0.0, 0.5, 1.0):
            done = torch.rand(batch, generator=g, device=dev) < p
            for trips, limit, add in ((0, 1, 0), (0, 1, 1), (5, 6, 1),
                                      (5, 23, 0), (23, 23, 0)):
                t = torch.tensor(trips, dtype=torch.int32, device=dev)
                got = loop_condition(done, t.clone(), limit, add)
                want = loop_condition_plain(done.cpu(), t.cpu(), limit, add)
                assert int(got[0]) == int(want[0])
                assert bool(got[1]) == bool(want[1])
    done = torch.zeros(8, dtype=torch.bool, device=dev)
    x = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.int32, device=dev)

    def step():
        x.add_(1)
        torch.logical_or(done, x >= stop, out=done)

    loop = LoopGraph(StepGraph(step, dev, keep=True), done, 23)
    for k in (0, 1, 2, 7, 8, 9, 17, 23, 100):
        stop.fill_(k)
        x.zero_()
        done.fill_(k == 0)
        loop.trips.zero_()
        assert int(loop.run()) == int(x) == min(k, 23)


def test_loop_body_keeps_the_steps_programmatic_edges(dev):
    """The AR step under bf16 weights runs its linears on the mixed linear,
    launched programmatically: its captured graph holds programmatic edges,
    and the loop's body (the step's nodes copied, then the condition) and
    a chain of ``n`` steps hold each of them once a copy, beside every
    other edge and node of the step; no child graph node."""
    from janus_tpu_torch.common.config import TTSConfig
    from janus_tpu_torch.models.params import cast_floating
    from janus_tpu_torch.models.tts import ar_graph, init_tts
    from janus_tpu_torch.runtime.step_graph import StepGraphs

    cfg = TTSConfig(**_GRAPH_TTS, dtype="float32")
    params = cast_floating(init_tts(torch.Generator(device=dev).manual_seed(0),
                                    cfg), torch.bfloat16)
    graphs = StepGraphs()
    with graphs.lock:
        h = ar_graph(graphs, params, cfg, 3, 11, 24, 0.5, dev)
        step = h.graph.census()
        body = h.loop.census()
        chain = h.chain(5).census()
    assert step["programmatic_edges"] > 0
    assert body["programmatic_edges"] == step["programmatic_edges"]
    assert chain["programmatic_edges"] == 5 * step["programmatic_edges"]
    assert body["kernels"] == step["kernels"] + 1
    assert body["nodes"] == step["nodes"] + 1
    assert chain["nodes"] == 5 * step["nodes"]
    assert body["children"] == chain["children"] == 0


def test_a_step_the_body_refuses_raises_at_construction(dev):
    """A step graph holding a node type a conditional body refuses (an
    event record node: an external event recorded inside the capture)
    raises when its loop or chain is built; it never becomes a loop of
    another form."""
    from janus_tpu_torch.runtime.step_graph import (LoopGraph, StepChain,
                                                    StepGraph)

    done = torch.zeros(4, dtype=torch.bool, device=dev)
    x = torch.zeros((), dtype=torch.int32, device=dev)
    event = torch.cuda.Event(external=True)

    def step():
        x.add_(1)
        event.record()
        torch.logical_or(done, x >= 3, out=done)

    graph = StepGraph(step, dev, keep=True)
    with pytest.raises(RuntimeError, match="node of type 'event record'"):
        LoopGraph(graph, done, 8)
    with pytest.raises(RuntimeError, match="node of type 'event record'"):
        StepChain(graph, 2)


def test_submit_reads_nothing_back(dev):
    """``encode_batch_submit`` on the card's graph path synchronises with
    nothing and copies nothing to the host: one upload, the front's
    replay and the loop's launch; ``result()`` then equals
    ``encode_batch``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from janus_tpu_torch.audio.synthetic import voiced_phrase
    from janus_tpu_torch.models.zoo import load_demo
    from janus_tpu_torch.runtime.codec import SemanticEncoder

    b = load_demo()
    enc = SemanticEncoder(b.config, b.asr_params, buckets=(96_000,),
                          device="cuda")
    phrases = [voiced_phrase(f0=140.0 + 20 * i, seconds=1.5, amp=0.12,
                             seed=i) for i in range(3)]
    want = enc.encode_batch(phrases)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pending = enc.encode_batch_submit(phrases)
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CPU]
    waits = [n for n in names if re.search(
        r"Synchronize|cudaMemcpy$|cudaMemcpy2D$|_local_scalar_dense|"
        r"aten::item", n)]
    assert not waits, waits
    assert sum(n.startswith("cudaGraphLaunch") for n in names) <= 2
    assert pending.result() == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tts_graph_equals_eager_on_the_card(dev, dtype):
    """bf16 weights, fp32 or bf16 caches: the replayed AR step gives the
    eager loop's mel and ``n_frames`` bit for bit, and the chunked path
    (``tts_prefill`` + ``tts_decode_chunk``) the eager chunks."""
    from janus_tpu_torch.common.config import TTSConfig
    from janus_tpu_torch.models.params import cast_floating
    from janus_tpu_torch.models.tts import (init_tts, tts_decode_chunk,
                                            tts_generate, tts_prefill)
    from janus_tpu_torch.runtime.step_graph import StepGraphs

    cfg = TTSConfig(**_GRAPH_TTS, dtype=dtype)
    params = cast_floating(init_tts(torch.Generator(device=dev).manual_seed(0),
                                    cfg), torch.bfloat16)
    rng = np.random.default_rng(1)
    text = torch.from_numpy(rng.integers(0, 256, (3, 8))).to(dev)
    emo = torch.tensor([1, 4, 0], device=dev)
    spk = torch.from_numpy(rng.standard_normal((3, 64)).astype(
        np.float32)).to(dev)
    graphs = StepGraphs()
    for thr in (2.0, 0.5):
        eager = tts_generate(params, cfg, text, emo, speaker=spk,
                             stop_threshold=thr, eager=True)
        graphed = tts_generate(params, cfg, text, emo, speaker=spk,
                               stop_threshold=thr, graphs=graphs)
        assert torch.equal(graphed[0], eager[0])
        assert torch.equal(graphed[1], eager[1])
    *a, graph_state = tts_prefill(params, cfg, text, emo, speaker=spk,
                                  graphs=graphs)
    *b, eager_state = tts_prefill(params, cfg, text, emo, speaker=spk,
                                  eager=True)
    assert graph_state.graph is not None and eager_state.graph is None
    for lo, n in ((0, 10), (10, 10), (20, 3)):
        got = tts_decode_chunk(params, cfg, graph_state, *a, lo, n)
        want = tts_decode_chunk(params, cfg, eager_state, *b, lo, n)
        for x, y in zip(got[:4], want[:4]):
            assert torch.equal(x, y)
        a, b = got[2:4], want[2:4]


def test_a_replaced_tree_is_recaptured_on_the_card(dev):
    """Two trees through one caller's graphs: each call gives its own
    tree's eager tokens (a graph holds the weights' addresses, so the
    second tree is captured anew)."""
    from janus_tpu_torch.models.asr import greedy_decode
    from janus_tpu_torch.runtime.step_graph import StepGraphs

    graphs = StepGraphs()
    kw = dict(max_new=12, cache_dtype=torch.bfloat16)
    seen = []
    for seed in (0, 1, 0):
        cfg, params, enc, prompt = _graph_asr(dev, seed=seed)
        graphed = greedy_decode(params, cfg, enc, prompt, 257, graphs=graphs,
                                **kw)
        eager = greedy_decode(params, cfg, enc, prompt, 257, eager=True, **kw)
        assert torch.equal(graphed, eager)
        seen.append(graphs.graphs()[0])
    assert seen[0] is not seen[1] and seen[1] is not seen[2]


def test_capture_beside_another_threads_work(dev):
    """A capture (thread-local mode) while a second thread keeps launching
    products on its stream and reading results back, as the receiver's
    thread does beside the encoder's: it succeeds and the replayed loop
    still equals the eager one."""
    import threading
    import time

    from janus_tpu_torch.models.asr import greedy_decode
    from janus_tpu_torch.runtime.step_graph import StepGraphs

    cfg, params, enc, prompt = _graph_asr(dev)
    stop, done = threading.Event(), []

    def busy():
        a = torch.randn(1024, 1024, device=dev)
        while not stop.is_set():
            for _ in range(20):
                a = torch.tanh(a @ a)
            done.append(float(a[0, 0]))
            torch.cuda.current_stream(dev).synchronize()

    t = threading.Thread(target=busy)
    t.start()
    try:
        while not done:
            time.sleep(0.01)
        graphs = StepGraphs()
        graphed = greedy_decode(params, cfg, enc, prompt, 257, graphs=graphs,
                                max_new=12, cache_dtype=torch.bfloat16)
    finally:
        stop.set()
        t.join()
    eager = greedy_decode(params, cfg, enc, prompt, 257, eager=True,
                          max_new=12, cache_dtype=torch.bfloat16)
    assert graphs.graphs()[0].capture_ms > 0
    assert torch.equal(graphed, eager)


def _front_encoders(dev, int8: bool):
    """The demo recognizer on the card through its captured front and
    eagerly (bf16, so K2 takes the encoder; under ``int8`` dynamic-int8
    weights and int8 cross K/V, so the int8 linear and K4 run too)."""
    import dataclasses

    from janus_tpu_torch.common.config import ASRConfig, JanusConfig
    from janus_tpu_torch.models.params import cast_floating, load_npz_params
    from janus_tpu_torch.ops.quant import quantize_tree
    from janus_tpu_torch.runtime.codec import SemanticEncoder

    cfg = dataclasses.replace(JanusConfig(), asr=dataclasses.replace(
        ASRConfig.demo(), dtype="bfloat16", decode_cross_kv_int8=int8))
    tree = load_npz_params("checkpoints/demo_asr.npz")
    if int8:
        tree = quantize_tree(cast_floating(tree, torch.bfloat16),
                             mode="dynamic")
    return [SemanticEncoder(cfg, tree, buckets=(96_000,), device=dev,
                            eager=eager) for eager in (False, True)]


def _front_phrases(seed: int):
    from janus_tpu_torch.audio.synthetic import render_text, voiced_phrase

    texts = (("alpha bravo", "fox golf hotel"), ("kilo lima", "mike"))[seed]
    return [render_text(t, 48_000, seed=seed + i) for i, t in
            enumerate(texts)] + [voiced_phrase(f0=150.0, seconds=1.2,
                                               amp=0.1, seed=seed)]


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_encode_front_graph_equals_eager_on_the_card(dev, int8):
    """``encode_batch`` on the card replays one captured front per (bucket,
    padded batch) and the greedy loop: the encoder output, tokens, codes,
    f0 and rms equal the eager path's bit for bit, two batches in turn
    through one holder; the replay launches the front's kernels (K1, K3,
    K2 a layer, the prefill's attention; the int8 linear under int8) and
    its cross K/V land in the loop's static buffers in place."""
    from janus_tpu_torch.ops.cuda_build import KERNELS
    from janus_tpu_torch.ops.quant import QuantKVT
    from janus_tpu_torch.runtime.codec import encode_front

    graph, eager = _front_encoders(dev, int8)
    graph.warmup()
    with graph._graphs.lock:
        holder = graph.encode_graph(96_000, 4)
        counts = {k.name: n[0] for k, n in holder.graph.counts.items()}
        cross = holder.greedy.state.cross_k[0]
        ptr = (cross.q if isinstance(cross, QuantKVT) else cross).data_ptr()
    layers = graph.cfg.asr.decoder_layers
    assert counts["mel_fused"] == 1 and counts["yin_block_sums"] == 1
    assert counts["flash_attn"] == graph.cfg.asr.encoder_layers
    # the prefill's self-attention, and its cross-attention where dense
    assert counts["decode_attn"] == layers * (1 if int8 else 2)
    assert counts.get("cross_attn_int8", 0) == (layers if int8 else 0)
    assert (counts.get("int8_linear", 0) > 0) == int8
    for seed in (0, 1, 0):
        phrases = _front_phrases(seed)
        before = {k: KERNELS[k].launches for k in counts}
        got = graph.encode_batch(phrases)
        torch.cuda.synchronize()
        assert all(KERNELS[k].launches - before[k] >= n
                   for k, n in counts.items())
        assert got == eager.encode_batch(phrases)
        batch, n_valid = holder.host_audio.numpy(), holder.host_n_valid
        audio, nv = torch.from_numpy(batch.copy()).to(dev), n_valid.to(dev)
        tokens, *prosody = eager._encode_impl(audio, nv, 200)
        with graph._graphs.lock:
            out = holder.run(batch.copy(), n_valid.numpy().copy())
            ref_enc = encode_front(eager.params, eager.cfg,
                                   eager._compute_dtype, audio, nv, 200)[0]
            assert torch.equal(holder.enc, ref_enc)
        for a, b in zip(out, [tokens] + prosody):
            assert torch.equal(a, b)
    cross = holder.greedy.state.cross_k[0]
    assert (cross.q if isinstance(cross, QuantKVT) else cross
            ).data_ptr() == ptr
    assert holder.graph.capture_ms > 0 and holder.pool_bytes >= 0


def test_yin_prefix_sums_of_one_row_repeat_bit_for_bit(dev):
    """A one-phrase encode's YIN prefix sums are one row: scanned beside a
    zero row, their bits repeat from call to call and equal the row's
    scan inside a batch."""
    from janus_tpu_torch.ops.yin import _cumsum

    x = torch.randn((3, 400_000), device=dev) ** 2
    first = _cumsum(x[:1])
    for _ in range(20):
        assert torch.equal(_cumsum(x[:1]), first)
    assert torch.equal(_cumsum(x)[:1], first)


def test_encode_front_capture_beside_another_threads_work(dev):
    """A front captured (thread-local mode) while a second thread keeps
    launching products and reading results back: the capture succeeds and
    the replayed encode equals the eager one."""
    import threading
    import time

    graph, eager = _front_encoders(dev, False)
    phrases = _front_phrases(0)
    ref = eager.encode_batch(phrases)
    stop, done = threading.Event(), []

    def busy():
        a = torch.randn(1024, 1024, device=dev)
        while not stop.is_set():
            for _ in range(20):
                a = torch.tanh(a @ a)
            done.append(float(a[0, 0]))
            torch.cuda.current_stream(dev).synchronize()

    t = threading.Thread(target=busy)
    t.start()
    try:
        while not done:
            time.sleep(0.01)
        got = graph.encode_batch(phrases)
    finally:
        stop.set()
        t.join()
    assert got == ref
    assert graph._graphs.holders("encode")[0].graph.capture_ms > 0


def _receive_small(dev, eager=False, stop_bias=None):
    """A small TTS (``_GRAPH_TTS``) and vocoder at 24 kHz on the card, bf16
    weights, through ``Synthesizer`` (captured, or ``eager``); with
    ``stop_bias`` the stop head's bias is that value."""
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.models.params import cast_floating
    from janus_tpu_torch.models.tts import init_tts
    from janus_tpu_torch.models.vocoder import init_vocoder
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    cfg = JanusConfig().override(**{
        **{f"tts.{k}": v for k, v in _GRAPH_TTS.items()},
        "vocoder.d_model": 64, "vocoder.layers": 2, "vocoder.n_fft": 256,
        "vocoder.hop_length": 64, "vocoder.sample_rate": 24_000})
    g = torch.Generator(device=dev).manual_seed(0)
    tts = cast_floating(init_tts(g, cfg.tts), torch.bfloat16)
    voc = cast_floating(init_vocoder(g, cfg.vocoder, n_mels=16),
                        torch.bfloat16)
    if stop_bias is not None:
        tts = {**tts, "stop_head": {**tts["stop_head"], "b": torch.full_like(
            tts["stop_head"]["b"], stop_bias)}}
    return Synthesizer(cfg, tts_params=tts, vocoder_params=voc, device=dev,
                       eager=eager)


def _receive_inputs(dev, batch=3, bucket=16, seed=1):
    rng = np.random.default_rng(seed)
    text = torch.from_numpy(rng.integers(0, 256, (batch, bucket)))
    emo = torch.from_numpy(rng.integers(0, 12, (batch,)))
    spk = torch.from_numpy(rng.standard_normal((batch, 64)).astype(
        np.float32)).to(dev)
    return text, emo, spk


def test_prefill_graph_equals_the_eager_prefill_on_the_card(dev):
    """The captured prefill (the prompt's embedding, the caches zeroed and
    filled, the counters) from host inputs through the pinned twin gives
    the eager prefill's first group, flags and caches bit for bit, twice
    with another prompt in between."""
    from janus_tpu_torch.models import tts as tts_mod

    syn = _receive_small(dev)
    tcfg, tree = syn.cfg.tts, syn.tts_params
    for seed in (1, 2, 1):
        text, emo, spk = _receive_inputs(dev, seed=seed)
        with syn._graphs.lock:
            h = syn.synth_graph(16, 3, torch.float32)
            first, done, state = h.ar.prefill(text, emo, spk)
        f0, d0, s0 = tts_mod.tts_prefill(
            tree, tcfg, text.to(dev), emo.to(dev), speaker=spk,
            max_groups=h.ar.max_groups, eager=True)
        torch.cuda.synchronize()
        assert torch.equal(first, f0.float()) and torch.equal(done, d0)
        assert state.fill == s0.fill == 19
        for a, b in zip(state.caches, s0.caches):
            assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
    assert h.ar.prefill_graph.capture_ms > 0


def test_synthesis_tail_equals_the_eager_vocoder_on_the_card(dev):
    """One launch of a ``SynthGraph`` (prefill, loop, tail) gives the eager
    synthesis's ``wav48`` and ``n48`` bit for bit (vocoder, iSTFT with its
    cuFFT inverse, resampler), and the tail replayed alone over the loop's
    output the eager vocoder and resampler's."""
    from janus_tpu_torch.runtime.synthesizer import vocode_48k

    syn, eager = _receive_small(dev), _receive_small(dev, eager=True)
    for seed in (1, 2):
        text, emo, spk = _receive_inputs(dev, seed=seed)
        with syn._graphs.lock:
            wav, n48 = (t.clone() for t in syn._synth_impl(text, emo, spk))
            h = syn.synth_graph(16, 3, torch.float32)
            ar = h.ar
            mel = ar.out[:, :ar.max_groups].reshape(
                3, -1, syn.cfg.tts.n_mels).contiguous()
            want_tail = vocode_48k(syn.vocoder_params, syn.cfg, mel,
                                   ar.n_groups * syn.cfg.tts.reduction)
            h.tail.replay()
            torch.cuda.synchronize()
            assert torch.equal(h.wav48, want_tail[0])
            assert torch.equal(h.n48, want_tail[1])
        want = eager._synth_impl(text, emo, spk)
        assert torch.equal(wav, want[0]) and torch.equal(n48, want[1])
    assert h.tail.capture_ms > 0 and h.loop.runs == 2


def test_chunk_launch_equals_single_replays_on_the_card(dev):
    """A chain of ``n`` steps (one launch) leaves the holder's buffers and
    caches as ``n`` replays of the step do, bit for bit."""
    syn = _receive_small(dev, stop_bias=-5.0)
    text, emo, spk = _receive_inputs(dev)
    states = []
    for chained in (True, False):
        s = syn.streamer()
        with s._graphs.lock:
            h = s.ar_graph(16, None)
            h.prefill(text[:1], emo[:1], None)
            for n in (5, 9):
                if chained:
                    h.run_steps(n)
                else:
                    for _ in range(n):
                        h.advance()
            torch.cuda.synchronize()
            states.append([t.clone() for t in (
                h.out, h.dones, h.n_groups, h.prev, h.done, h.group)]
                + [t.clone() for c in h.caches for t in (c.k, c.v)])
    assert sorted(h.chains) == [5, 9] and h.chains[9].runs == 1
    for a, b in zip(*states):
        assert torch.equal(a, b)


@pytest.mark.parametrize("batch", [8, 1])
def test_captured_synthesis_and_stream_equal_eager_on_the_card(dev, batch):
    """One launch of a ``SynthGraph`` (the prefill's nodes, the WHILE node
    whose body holds the step's nodes, the tail's nodes) gives ``eager=True``'s ``wav48`` and ``n48`` bit for bit at b 8
    and 1, lanes stopping at their own steps; the captured stream (a chain
    a chunk) gives the eager stream's chunks."""
    syn, eager = _receive_small(dev), _receive_small(dev, eager=True)
    for seed in (3, 4):
        text, emo, spk = _receive_inputs(dev, batch=batch, seed=seed)
        with syn._graphs.lock:
            wav, n48 = (t.clone() for t in syn._synth_impl(text, emo, spk))
        want = eager._synth_impl(text, emo, spk)
        assert torch.equal(wav, want[0]) and torch.equal(n48, want[1])
    got = list(syn.streamer().stream("alpha bravo charlie"))
    ref = list(eager.streamer().stream("alpha bravo charlie"))
    assert len(got) == len(ref) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert syn._graphs.loops("synth") and not eager._graphs.loops()


def test_a_synthesis_reads_nothing_back_before_its_samples(dev):
    """``Synthesizer._synth_impl`` on the card's graph path: one upload and
    one graph launch, no synchronize and no device->host copy before the
    read that ``_run_tts`` makes; ``synthesize`` equals the eager
    synthesizer's bytes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from janus_tpu_torch.common.protocol import JanusPacket

    syn, eager = _receive_small(dev), _receive_small(dev, eager=True)
    syn.warmup()
    text = torch.zeros((1, 16), dtype=torch.long)
    emo = torch.zeros((1,), dtype=torch.long)
    torch.cuda.synchronize()
    with syn._graphs.lock:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            syn._synth_impl(text, emo, None)
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CPU]
    waits = [n for n in names if re.search(
        r"Synchronize|cudaMemcpy$|cudaMemcpy2D$|_local_scalar_dense|"
        r"aten::item", n)]
    assert not waits, waits
    assert sum(n.startswith("cudaGraphLaunch") for n in names) == 1
    pkt = JanusPacket(text="alpha bravo", prosody={"pitch": "High"})
    assert syn.synthesize(pkt) == eager.synthesize(pkt)
    assert syn._graphs.holders("synth") and not eager._graphs.holders()


def test_capture_beside_a_collection_that_frees_another_graph(dev):
    """A graph torn down by the capturing thread during a capture
    invalidates the capture (``CUDAGraph.cpp ... operation not permitted
    when stream is capturing (function reset)``, then error 901). A dead
    holder once waited in a cycle with its graph for the cyclic collector,
    which could run inside a later capture and tear it down there (seen
    beside another thread's work, after earlier tests' graphs): a dropped
    holder now goes at once, so a collection inside a capture finds no
    graph to tear down."""
    import gc
    import weakref

    from janus_tpu_torch.runtime.step_graph import StepGraph

    class Holder:
        def __init__(self, before_step):
            self.x = torch.ones(1024, device=dev)
            self.before_step = before_step
            self.graph = StepGraph(self.step, dev)

        def step(self):
            self.before_step()
            self.x.mul_(2).add_(1)

    gc.collect()  # earlier tests' garbage, outside any capture
    dead = Holder(lambda: None)
    gone = weakref.ref(dead)
    del dead
    assert gone() is None
    steps = []

    def collect_in_the_capture():
        steps.append(1)
        if len(steps) == 2:  # the capture, after the warm-up
            gc.collect()

    live = Holder(collect_in_the_capture)
    assert len(steps) == 2
    live.graph.replay()
    torch.cuda.synchronize()
    # ones, then the warm-up (3), then one replay (7)
    assert torch.equal(live.x, torch.full_like(live.x, 7.0))


def _byte_order_bpe(tmp_path):
    """A ``BpeTokenizer`` over the demo recognizer's 261 ids: id ``b`` is
    the GPT-2 symbol of byte ``b``, then the specials, whose
    ``sot_sequence`` is four ids (256, 258, 259, 260)."""
    import json

    from janus_tpu_torch.models.tokenizer import (BpeTokenizer,
                                                  _bytes_to_unicode)

    b2u = _bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    vocab.update({"<|startoftranscript|>": 256, "<|endoftext|>": 257,
                  "<|en|>": 258, "<|transcribe|>": 259,
                  "<|notimestamps|>": 260})
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    return BpeTokenizer.from_files(str(tmp_path / "vocab.json"),
                                   str(tmp_path / "merges.txt"))


def test_bpe_encoder_four_token_prompt_on_the_card(dev, tmp_path):
    """``SemanticEncoder(tokenizer=bpe)`` with the committed demo
    recognizer: the four-token prompt's packets on the card (the decode
    replayed from a graph keyed on ``prompt_len`` 4, and eagerly) equal
    the CPU's byte for byte."""
    from janus_tpu_torch.audio.synthetic import render_text
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.models.zoo import load_demo
    from janus_tpu_torch.runtime.codec import SemanticEncoder

    bpe = _byte_order_bpe(tmp_path)
    assert bpe.sot_sequence() == [256, 258, 259, 260] and bpe.eot == 257
    b = load_demo(base=JanusConfig())
    phrases = [render_text(t, 48_000, seed=s) for s, t in
               enumerate(("alpha bravo", "fox golf hotel", "kilo lima"))]

    def packets(device, eager=False):
        enc = SemanticEncoder(b.config, b.asr_params, tokenizer=bpe,
                              buckets=(96_000,), device=device, eager=eager)
        pkts = [enc.encode_packet(p, timestamp=1.0) for p in phrases]
        return enc, [None if p is None else p.serialize() for p in pkts]

    card, graphed = packets("cuda")
    # the greedy holders' keys (and the fronts', which end with theirs)
    keys = [k[-10:] for k in card._graphs._holders]
    assert keys and all(k[0] == "greedy" and k[5] == 4 for k in keys)
    assert card._graphs.replays > 0
    assert len(card._graphs.holders("encode")) == 1
    _, eager = packets("cuda", eager=True)
    _, cpu = packets("cpu")
    assert graphed == eager == cpu
    assert sum(p is not None for p in cpu) >= 2


# -- the decode steps' kernels: layer norm and decode attention -------------

@pytest.mark.parametrize("shape,x_dtype,p_dtype", [
    ((8, 1, 1280), torch.bfloat16, torch.bfloat16),   # the decode step
    ((8, 1, 1280), torch.float32, torch.bfloat16),    # the TTS step
    ((2, 300, 1280), torch.bfloat16, torch.bfloat16),
    ((3, 7, 128), torch.float32, torch.float32),      # the demo width
    ((5, 77), torch.float32, torch.float32),          # no 16-byte chunks
    ((3, 4096), torch.bfloat16, torch.float32),       # a block a row
    ((2, 8192), torch.float32, torch.float32),        # the widest row
])
def test_layer_norm_kernel_matches_plain(dev, shape, x_dtype, p_dtype):
    """fp32 within 1e-5; bf16 within one bf16 ulp of the plain version
    beyond that fp32 bar (where scale * n cancels the bias, the two row
    sums' orders decide the last bits)."""
    from janus_tpu_torch.ops.layers import (LN_KERNEL, layer_norm,
                                            layer_norm_plain)

    rng = np.random.default_rng(shape[-1])
    d = shape[-1]
    x = torch.from_numpy((3 * rng.standard_normal(shape) + 1).astype(
        np.float32)).to(dev, x_dtype)
    sc, bi = (torch.from_numpy((m + 0.1 * rng.standard_normal(d)).astype(
        np.float32)).to(dev, p_dtype) for m in (1.0, 0.0))
    before = LN_KERNEL.launches
    out = layer_norm(x, sc, bi)
    torch.cuda.synchronize()
    assert LN_KERNEL.launches == before + 1
    ref = layer_norm_plain(x, sc, bi)
    assert out.dtype == x_dtype and out.shape == x.shape
    diff = (out.float() - ref.float()).abs()
    if x_dtype == torch.float32:
        assert float(diff.max()) <= 1e-5
    else:
        r = ref.float().abs().clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(r)) - 7)
        assert bool((diff <= ulp + 1e-5).all())
    assert torch.equal(out, layer_norm(x, sc, bi))


def test_layer_norm_kernel_gradient_is_the_plain_one(dev):
    """Under autograd the forward is the kernel's and the gradient the
    plain body's, as ``_FlashAttention`` does for K2."""
    from janus_tpu_torch.ops.layers import (LN_KERNEL, layer_norm,
                                            layer_norm_plain)

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((4, 5, 64), generator=g, device=dev, requires_grad=True)
    sc = torch.randn(64, generator=g, device=dev, requires_grad=True)
    bi = torch.randn(64, generator=g, device=dev, requires_grad=True)
    before = LN_KERNEL.launches
    out = layer_norm(x, sc, bi)
    assert LN_KERNEL.launches == before + 1
    gy = torch.randn_like(out)
    got = torch.autograd.grad(out, (x, sc, bi), gy)
    want = torch.autograd.grad(layer_norm_plain(x, sc, bi), (x, sc, bi), gy)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b,h,tq,t,dh,q_dtype,kv_dtype,fill", [
    (8, 20, 1, 25, 64, torch.bfloat16, torch.bfloat16, 12),   # self step
    (8, 20, 4, 28, 64, torch.bfloat16, torch.bfloat16, 0),    # prefill
    (8, 20, 1, 500, 64, torch.bfloat16, torch.bfloat16, None),  # cross
    (8, 20, 4, 500, 64, torch.bfloat16, torch.bfloat16, None),
    (8, 20, 1, 291, 64, torch.float32, torch.bfloat16, 163),  # TTS step
    (3, 4, 1, 48, 32, torch.float32, torch.float32, 5),       # the demo
    (2, 3, 3, 77, 128, torch.float32, torch.float32, 60),
    (2, 3, 16, 200, 128, torch.bfloat16, torch.float32, 100),
])
def test_decode_attention_kernel_matches_plain(dev, b, h, tq, t, dh, q_dtype,
                                               kv_dtype, fill):
    """Within K2's bars of the plain version (fp32 2e-5; bf16 rtol 2^-6 +
    5e-3), the fill point on the device or the host alike, and slots past
    the fill (an earlier prompt's, here NaN) never read."""
    from janus_tpu_torch.ops.decode_attention import (KERNEL,
                                                      decode_attention,
                                                      decode_attention_plain)

    rng = np.random.default_rng(t + tq)

    def arr(shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(
            np.float32)).to(dev)

    q = arr((b, h, tq, dh)).to(q_dtype)
    k, v = arr((b, h, t, dh), 2.0).to(kv_dtype), arr((b, h, t, dh)).to(
        kv_dtype)
    bf = torch.bfloat16 in (q_dtype, kv_dtype)
    rtol, atol = (2 ** -6, 5e-3) if bf else (0.0, 2e-5)
    ref = decode_attention_plain(q, k, v, fill)
    for pos in ((None,) if fill is None
                else (fill, torch.tensor(fill, device=dev))):
        before = KERNEL.launches
        out = decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        assert KERNEL.launches == before + 1
        assert out.dtype == q_dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                   atol=atol)
        if fill is not None:
            k2, v2 = k.clone(), v.clone()
            k2[..., fill + tq:, :] = float("nan")
            v2[..., fill + tq:, :] = float("nan")
            assert torch.equal(decode_attention(q, k2, v2, pos), out)


@pytest.mark.parametrize("b,h,tq,t,dh,q_dtype,kv_dtype,fill", [
    (8, 20, 1, 25, 64, torch.bfloat16, torch.bfloat16, 12),   # self step
    (8, 20, 4, 28, 64, torch.bfloat16, torch.bfloat16, 0),    # prefill
    (8, 20, 1, 291, 64, torch.float32, torch.bfloat16, 163),  # TTS step
    (1, 20, 1, 291, 64, torch.float32, torch.bfloat16, 35),   # TTS b = 1
    (3, 4, 1, 48, 32, torch.float32, torch.float32, 5),       # the demo
    (2, 3, 16, 200, 128, torch.bfloat16, torch.float32, 100),  # 4 chunks
    (2, 3, 2, 1500, 64, torch.bfloat16, torch.bfloat16, 3),   # 8 splits
    (2, 5, 1, 40, 48, torch.float32, torch.bfloat16, 39),     # the last slot
])
def test_decode_attention_writes_the_cache_it_attends(dev, b, h, tq, t, dh,
                                                      q_dtype, kv_dtype,
                                                      fill):
    """With the new rows the kernel writes the cache as ``write_at`` does
    (bit for bit, every other slot untouched) and gives the kernel's
    result over the written cache bit for bit, within the bars of the
    plain fused call; slots past the new rows (NaN) are never read."""
    from janus_tpu_torch.ops.attention import KVCache
    from janus_tpu_torch.ops.decode_attention import (KERNEL,
                                                      decode_attention,
                                                      decode_attention_plain)

    rng = np.random.default_rng(t + tq)

    def arr(shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(
            np.float32)).to(dev)

    q = arr((b, h, tq, dh)).to(q_dtype)
    k, v = arr((b, h, t, dh), 2.0).to(kv_dtype), arr((b, h, t, dh)).to(
        kv_dtype)
    k_new, v_new = arr((b, h, tq, dh), 2.0).to(q_dtype), arr(
        (b, h, tq, dh)).to(q_dtype)
    bf = torch.bfloat16 in (q_dtype, kv_dtype)
    rtol, atol = (2 ** -6, 5e-3) if bf else (0.0, 2e-5)
    for pos in (fill, torch.tensor(fill, device=dev)):
        ref = KVCache(k.clone(), v.clone(), fill)
        if isinstance(pos, torch.Tensor):
            ref.write_at(k_new, v_new, pos)
        else:
            ref.append_lockstep(k_new, v_new)
        want = decode_attention(q, ref.k, ref.v, pos)
        # the kernel's caches hold NaN past the new rows: never read
        k1, v1 = k.clone(), v.clone()
        k1[..., fill + tq:, :] = float("nan")
        v1[..., fill + tq:, :] = float("nan")
        before = KERNEL.launches
        out = decode_attention(q, k1, v1, pos, k_new, v_new)
        torch.cuda.synchronize()
        assert KERNEL.launches == before + 1
        assert torch.equal(out, want)
        assert torch.equal(k1[..., :fill + tq, :], ref.k[..., :fill + tq, :])
        assert torch.equal(v1[..., :fill + tq, :], ref.v[..., :fill + tq, :])
        assert bool(k1[..., fill + tq:, :].isnan().all())
        k2, v2 = k.clone(), v.clone()
        plain = decode_attention_plain(q, k2, v2, pos, k_new, v_new)
        torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                                   atol=atol)
        assert torch.equal(decode_attention(q, k1, v1, pos, k_new, v_new),
                           out)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_decode_attention_any_split_plan_holds_the_bar(dev, splits):
    """Each cluster size the kernel takes, at the 10 s cross-attention and
    the TTS step's cache with its new row: within K2's bf16 bar (the plan
    forced through the wrapper's private launcher)."""
    from janus_tpu_torch.ops.decode_attention import (_kernel,
                                                      decode_attention_plain)

    g = torch.Generator(device=dev).manual_seed(splits)
    q = torch.randn((8, 20, 1, 64), generator=g, device=dev)
    k, v = (torch.randn((8, 20, 500, 64), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    out = _kernel(q.to(torch.bfloat16), k, v, None, None, None, splits)
    ref = decode_attention_plain(q.to(torch.bfloat16), k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -6,
                               atol=5e-3)
    kn, vn = (torch.randn((8, 20, 1, 64), generator=g, device=dev)
              for _ in range(2))
    pos = torch.tensor(163, device=dev)
    out = _kernel(q, k[..., :291, :].clone(), v[..., :291, :].clone(), pos,
                  kn, vn, splits)
    ref = decode_attention_plain(q, k[..., :291, :].clone(),
                                 v[..., :291, :].clone(), pos, kn, vn)
    torch.testing.assert_close(out, ref, rtol=2 ** -6, atol=5e-3)


@pytest.mark.parametrize("shape,delta_shape,x_dtype,d_dtype,p_dtype", [
    ((8, 1, 1280), (8, 1, 1280), torch.bfloat16, torch.bfloat16,
     torch.bfloat16),                                  # recognizer step
    ((8, 1, 1280), (1, 1280), torch.float32, torch.bfloat16,
     torch.bfloat16),                                  # the AR step's
    ((8, 1, 1280), (8, 1, 1280), torch.float32, torch.float32,
     torch.bfloat16),
    ((2, 300, 1280), (300, 1280), torch.bfloat16, torch.bfloat16,
     torch.bfloat16),                                  # encoder positions
    ((5, 77), (5, 77), torch.float32, torch.float32,
     torch.float32),                   # no 16-byte chunks: add, then norm
    ((3, 4096), (3, 4096), torch.bfloat16, torch.bfloat16, torch.float32),
])
def test_add_layer_norm_kernel_matches_the_unfused_pair(
        dev, shape, delta_shape, x_dtype, d_dtype, p_dtype):
    """One launch of the kernel (a width of no whole 16-byte chunks: the
    add, then the kernel): the sum bit-equal to PyTorch's add, the norm
    bit-equal to the layer-norm kernel over that sum (and so within its
    bars of the plain version), two launches equal."""
    from janus_tpu_torch.ops.layers import (LN_KERNEL, add_layer_norm,
                                            layer_norm_fused,
                                            layer_norm_plain)

    rng = np.random.default_rng(shape[-1] + len(delta_shape))
    d = shape[-1]
    x = torch.from_numpy((3 * rng.standard_normal(shape) + 1).astype(
        np.float32)).to(dev, x_dtype)
    delta = torch.from_numpy(rng.standard_normal(delta_shape).astype(
        np.float32)).to(dev, d_dtype)
    sc, bi = (torch.from_numpy((m + 0.1 * rng.standard_normal(d)).astype(
        np.float32)).to(dev, p_dtype) for m in (1.0, 0.0))
    before = LN_KERNEL.launches
    r, y = add_layer_norm(x, delta, sc, bi)
    torch.cuda.synchronize()
    assert LN_KERNEL.launches == before + 1
    assert torch.equal(r, x + delta)
    assert torch.equal(y, layer_norm_fused(x + delta, sc, bi))
    ref = layer_norm_plain(r, sc, bi)
    diff = (y.float() - ref.float()).abs()
    if x_dtype == torch.float32:
        assert float(diff.max()) <= 1e-5
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            ref.float().abs().clamp_min(2.0 ** -126))) - 7)
        assert bool((diff <= ulp + 1e-5).all())
    r2, y2 = add_layer_norm(x, delta, sc, bi)
    assert torch.equal(r2, r) and torch.equal(y2, y)


def test_fused_decoder_layers_equal_the_unfused_pairs_on_the_card(
        dev, monkeypatch):
    """Two decoder layers on the card, bf16: the prefill, a host-position
    and a device-position step through the fused kernels give the logits
    and caches of the residual adds, layer norms, cache writes and decode
    attentions launched apart, bit for bit."""
    from janus_tpu_torch.models import asr
    from janus_tpu_torch.ops.decode_attention import decode_attention
    from janus_tpu_torch.ops.layers import layer_norm

    cfg, params, enc, prompt = _graph_asr(dev)
    prompt = torch.cat([prompt, prompt + 3, prompt - 9, prompt + 1], dim=1)

    def run():
        state = asr.init_decode_state(params, cfg, enc, max_len=8,
                                      dtype=torch.bfloat16)
        out = [asr.decoder_prefill(params, cfg, prompt, state)[0]]
        out.append(asr.decoder_step(params, cfg, prompt[:, 1], state)[0])
        out.append(asr._decoder_forward(
            params, cfg, prompt[:, 2:3], torch.tensor(state.fill, device=dev),
            state)[0])
        return out, state

    def add_layer_norm(x, delta, scale, bias, eps=1e-5):
        r = x + delta
        return r, layer_norm(r, scale, bias, eps)

    def attend_cache(q, cache, k_new, v_new, pos=None):
        if pos is None:
            cache.append_lockstep(k_new, v_new)
            at = cache.length - k_new.shape[-2]
        else:
            cache.write_at(k_new, v_new, pos)
            at = pos
        return decode_attention(q, cache.k, cache.v, at)

    fused, fs = run()
    monkeypatch.setattr(asr, "add_layer_norm", add_layer_norm)
    monkeypatch.setattr(asr, "attend_cache", attend_cache)
    unfused, us = run()
    for a, b in zip(fused, unfused):
        assert torch.equal(a, b)
    for a, b in zip(fs.self_caches, us.self_caches):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


def test_decode_attention_replays_with_the_fill_it_finds(dev):
    """Captured once, replayed with the device fill point moved: each
    replay equals a direct launch at that fill."""
    from janus_tpu_torch.ops.decode_attention import decode_attention

    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((4, 6, 1, 64), (4, 6, 30, 64), (4, 6, 30, 64)))
    pos = torch.tensor(2, device=dev)
    out = torch.empty_like(q)
    out.copy_(decode_attention(q, k, v, pos))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(decode_attention(q, k, v, pos))
    for fill in (0, 7, 29):
        pos.fill_(fill)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, decode_attention(q, k, v, fill))


def test_int8_step_launches_the_int8_linear_in_its_graph(dev):
    """Under dynamic-int8 weights the captured recognizer step runs the
    int8 linear kernel for its six linears a decoder layer (fused q/k/v,
    self out, cross q, cross out, fc1, fc2) and replays bit-equal to the
    eager loop, which runs the kernel too."""
    from janus_tpu_torch.models.asr import greedy_decode
    from janus_tpu_torch.ops.int8_linear import KERNEL as INT8
    from janus_tpu_torch.runtime.step_graph import StepGraphs

    cfg, params, enc, prompt = _graph_asr(dev, int8=True)
    graphs = StepGraphs()
    kw = dict(max_new=12, cache_dtype=torch.bfloat16, cross_kv_int8=True)
    before = INT8.launches
    want = greedy_decode(params, cfg, enc, prompt, 257, eager=True, **kw)
    assert INT8.launches > before
    got = greedy_decode(params, cfg, enc, prompt, 257, graphs=graphs, **kw)
    assert torch.equal(got, want)
    counts = {k.name: n[0] for k, n in graphs.graphs()[0].counts.items()}
    assert counts == {"cross_attn_int8": cfg.decoder_layers,
                      "layer_norm": 3 * cfg.decoder_layers + 1,
                      "decode_attn": cfg.decoder_layers,
                      "int8_linear": 6 * cfg.decoder_layers}


def test_decode_steps_launch_the_new_kernels_in_their_graphs(dev):
    """The captured recognizer and TTS steps run the layer norm and the
    decode attention (3 norms a decoder layer and the final one, self and
    cross attention; 2 norms a TTS layer and the final one, its
    self-attention), and replay bit-equal to the eager loops."""
    from janus_tpu_torch.common.config import TTSConfig
    from janus_tpu_torch.models.asr import greedy_decode
    from janus_tpu_torch.models.params import cast_floating
    from janus_tpu_torch.models.tts import init_tts, tts_generate
    from janus_tpu_torch.runtime.step_graph import StepGraphs

    cfg, params, enc, prompt = _graph_asr(dev)
    graphs = StepGraphs()
    kw = dict(max_new=12, cache_dtype=torch.bfloat16)
    got = greedy_decode(params, cfg, enc, prompt, 257, graphs=graphs, **kw)
    want = greedy_decode(params, cfg, enc, prompt, 257, eager=True, **kw)
    assert torch.equal(got, want)
    counts = {k.name: n[0] for k, n in graphs.graphs()[0].counts.items()}
    assert counts == {"layer_norm": 3 * cfg.decoder_layers + 1,
                      "decode_attn": 2 * cfg.decoder_layers}

    tcfg = TTSConfig(**{**_GRAPH_TTS, "num_heads": 2}, dtype="bfloat16")
    tparams = cast_floating(init_tts(torch.Generator(device=dev).manual_seed(
        0), tcfg), torch.bfloat16)
    text = torch.zeros((2, 8), dtype=torch.long, device=dev)
    emo = torch.zeros((2,), dtype=torch.long, device=dev)
    tgraphs = StepGraphs()
    got = tts_generate(tparams, tcfg, text, emo, stop_threshold=2.0,
                       graphs=tgraphs)
    want = tts_generate(tparams, tcfg, text, emo, stop_threshold=2.0,
                        eager=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    counts = {k.name: n[0] for k, n in tgraphs.graphs()[0].counts.items()}
    # and the mixed-dtype linear: the prenet's two (fc1 with its GELU),
    # q/k/v in one, out, fc1 with its GELU and fc2 a layer, the two heads
    # in one
    assert counts == {"layer_norm": 2 * tcfg.layers + 1,
                      "decode_attn": tcfg.layers,
                      "mixed_linear": 4 * tcfg.layers + 3}


def _traced(fn, busy: bool = False):
    """``fn()`` with the tracer on; its spans (the store cleared before).
    ``busy``: the card is left working on products when tracing starts, so
    that the period's anchor is taken behind a full queue."""
    from janus_tpu_torch.runtime import profiling

    profiling.take()
    if busy:
        a = torch.randn(4096, 4096, device="cuda")
        for _ in range(40):
            a = torch.tanh(a @ a)
    profiling.enable()
    try:
        fn()
    finally:
        profiling.disable()
    torch.cuda.synchronize()
    return profiling.take()


# the anchor's host time is read just before its event is recorded: a
# device time may lead the truth by that call's latency
_ANCHOR_SLACK_NS = 50_000


def test_device_spans_lie_inside_their_launch_and_request(dev):
    """On the card, each device span of an encode, a synthesis and a stream
    starts after its launching span starts and ends before its request's
    last span ends, on the host's clock; the synthesis launch's three parts
    tile its device span, the WHILE part with the steps the loop ran."""
    from janus_tpu_torch.common.protocol import JanusPacket

    enc = _front_encoders(dev, False)[0]
    syn = _receive_small(dev, stop_bias=-5.0)   # every loop runs to its cap
    packet = JanusPacket(text="alpha bravo")

    def work():
        enc.encode_batch_submit(_front_phrases(0)).result()
        syn.synthesize(packet)
        list(syn.synthesize_streaming(packet))

    work()   # captures and builds outside the traced part
    recs = [s for s in _traced(work, busy=True)
            if not s["name"].startswith("setup.")]
    ends = {}
    for s in recs:
        ends[s["request"]] = max(ends.get(s["request"], 0), s["end_ns"])
    devs = [s for s in recs if s["device_start_ns"] is not None]
    assert {s["name"] for s in devs} >= {
        "encode.front", "encode.loop", "synth.launch", "synth.prefill",
        "synth.loop", "synth.tail", "stream.prefill", "stream.emit"}
    by_id = {s["id"]: s for s in recs}
    for s in devs:
        launch = s if s["end_ns"] > s["start_ns"] else by_id[s["parent"]]
        assert s["device_start_ns"] + _ANCHOR_SLACK_NS >= launch["start_ns"]
        assert s["device_start_ns"] <= s["device_end_ns"]
        assert s["device_end_ns"] <= ends[s["request"]] + _ANCHOR_SLACK_NS
    launch = next(s for s in recs if s["name"] == "synth.launch")
    parts = [next(s for s in recs if s["name"] == n and s["parent"] ==
                  launch["id"]) for n in ("synth.prefill", "synth.loop",
                                          "synth.tail")]
    assert parts[0]["device_start_ns"] == launch["device_start_ns"]
    assert parts[-1]["device_end_ns"] == launch["device_end_ns"]
    for a, b in zip(parts, parts[1:]):
        assert a["device_end_ns"] == b["device_start_ns"]
    assert parts[1]["attrs"]["steps"] >= 1
    loop = next(s for s in recs if s["name"] == "encode.loop")
    assert loop["attrs"]["trips"] >= 1


def test_tracing_leaves_the_graphs_and_their_output_as_they_were(dev):
    """With the tracer on, every loop's captured step and WHILE body and
    every chain keeps its census, and a synthesis, a stream and an encode give the bytes they
    give with it off; the synthesis's boundary nodes go back to the
    graph's own events once tracing is off."""
    from janus_tpu_torch.common.protocol import JanusPacket

    enc = _front_encoders(dev, False)[0]
    syn = _receive_small(dev)
    packet = JanusPacket(text="alpha bravo")

    def work():
        return (enc.encode_batch_submit(_front_phrases(1)).result(),
                syn.synthesize(packet),
                b"".join(syn.synthesize_streaming(packet)))

    def censuses():
        out = []
        for graphs in (enc._graphs, syn._graphs, syn.streamer()._graphs):
            out += [(lp.step_graph.census(), lp.census())
                    for lp in graphs.loops()]
            out += [c.census() for c in graphs.chains()]
        return out

    off = work()
    before = censuses()
    on = []
    _traced(lambda: on.append(work()))
    assert on[0] == off and censuses() == before
    h = syn._graphs.holders("synth")[0]
    assert work() == off
    assert h.loop._graph._marks is h.loop._graph._own_marks
