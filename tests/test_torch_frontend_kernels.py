"""The redesigned frontend kernels' arithmetic on the CPU.

The CUDA kernels (K1 fused log-mel, K3 YIN block sums) run only on the
card. What surrounds them is Python, and what they compute can be repeated
in PyTorch / numpy from the very tables and plans the wrappers hand them:

* K1: two real frames per complex transform, the four-step 16 x 25 FFT
  with its twiddles and roots of unity, the separation of the two spectra,
  the banded filterbank and the reflect padding done by index;
* K3: eight lags per thread over a sliding window of a row staged twice
  at an aligned pitch (the second copy skewed by 4 banks), each sum taken
  over ``i`` in index order, the sums leaving through an XOR swizzle.

Each emulation is held against the plain PyTorch version and against the
JAX package (its Pallas kernels in interpret mode), inputs from a numpy
seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janus_tpu.ops import mel_pallas as j_mel_pallas
from janus_tpu.ops import yin as j_yin
from janus_tpu.ops import yin_pallas as j_yin_pallas
from janus_tpu_torch.ops import mel as t_mel
from janus_tpu_torch.ops import mel_fused as t_mel_fused
from janus_tpu_torch.ops import yin as t_yin
from janus_tpu_torch.ops import yin_blocksums as t_yin_bs
from janus_tpu_torch.ops.stft import _reflect_pad

N_FFT, HOP, SR = 400, 160, 16_000


# -- K1 ---------------------------------------------------------------------

def reflect_index(j: np.ndarray, t_len: int) -> np.ndarray:
    """The kernel's ``reflected``: signal index of padded sample ``j`` (one
    reflection about either edge, the edge not repeated)."""
    j = np.abs(j)
    return np.where(j >= t_len, 2 * (t_len - 1) - j, j)


def small_dft(x: torch.Tensor, radix: int, roots: torch.Tensor,
              axis_a: int, axis_b: int) -> torch.Tensor:
    """The kernel's radix x radix DFT of length radix² = len(roots): the
    input index is ``radix·a + b`` over (axis_a, axis_b); the result holds
    output ``c + radix·d`` at (axis_a = c, axis_b = d)."""
    n = radix * radix
    idx = torch.arange(radix)
    inner = roots[(radix * idx[:, None] * idx[None, :]) % n]   # W_radix^(ac)
    twid = roots[(idx[:, None] * idx[None, :]) % n]            # W_n^(bc)
    x = x.movedim((axis_a, axis_b), (-2, -1))                  # [..., a, b]
    u = torch.einsum("ca,...ab->...cb", inner, x)              # over a
    u = u * twid.T                                             # [c, b]
    out = torch.einsum("db,...cb->...cd", inner, u)            # over b
    return out.movedim((-2, -1), (axis_a, axis_b))


def emulate_mel_log10(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """``mel_log10(route="fft")`` step by step, from the wrapper's tables."""
    t = t_mel_fused._fft_tables_np(SR, n_mels)
    n_signals, t_len = audio.shape
    n_frames = t_len // HOP
    n_pairs = -(-n_frames // 2)
    # staged span with the reflect edge taken by index; a frame past the
    # last one (the odd pair's second) is zero
    frame = np.arange(2 * n_pairs)[:, None]
    pos = frame * HOP + np.arange(N_FFT)[None, :] - N_FFT // 2
    frames = audio[:, torch.from_numpy(reflect_index(pos, t_len))]
    frames = frames * torch.from_numpy(frame < n_frames)
    frames = frames.reshape(n_signals, n_pairs, 2, N_FFT)
    window = torch.from_numpy(t.window)
    z = torch.complex(window * frames[:, :, 0], window * frames[:, :, 1])
    # four-step: n = 25 n1 + n2, k = k1 + 16 k2
    z = z.reshape(n_signals, n_pairs, 4, 4, 25)        # n1 = 4a + b
    y = small_dft(z, 4, torch.from_numpy(t.root16), 2, 3)
    # slot (c, d) holds k1 = c + 4d
    y = y.permute(0, 1, 3, 2, 4).reshape(n_signals, n_pairs, 16, 25)
    y = y * torch.from_numpy(t.twiddle)                # W400^(n2 k1)
    y = y.reshape(n_signals, n_pairs, 16, 5, 5)        # n2 = 5a + b
    zz = small_dft(y, 5, torch.from_numpy(t.root25), 3, 4)
    # slot (c, d) holds k2 = c + 5d; Z[k1 + 16 k2]
    zz = zz.permute(0, 1, 4, 3, 2).reshape(n_signals, n_pairs, N_FFT)
    k = np.arange(N_FFT // 2 + 1)
    km = (N_FFT - k) % N_FFT
    za, zb = zz[..., k], zz[..., km]
    pa = 0.25 * ((za.real + zb.real) ** 2 + (za.imag - zb.imag) ** 2)
    pb = 0.25 * ((za.imag + zb.imag) ** 2 + (za.real - zb.real) ** 2)
    power = torch.stack([pa, pb], dim=2).reshape(n_signals, 2 * n_pairs, -1)
    mel = torch.zeros((n_signals, 2 * n_pairs, n_mels))
    for m in range(n_mels):
        s, n, o = int(t.start[m]), int(t.count[m]), int(t.offset[m])
        taps = torch.from_numpy(t.taps[o:o + n])
        mel[..., m] = (power[..., s:s + n] * taps).sum(-1)
    return torch.log10(torch.clamp_min(mel, 1e-10))[:, :n_frames]


def rfft_log10(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """log10(max(mel, 1e-10)) through ``torch.fft.rfft`` and the dense
    filterbank, before the floor and the scale."""
    frames = _reflect_pad(audio, N_FFT // 2).unfold(-1, N_FFT, HOP)[:, :-1]
    window = torch.from_numpy(t_mel_fused._hann_np(N_FFT))
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    fb = t_mel.mel_filterbank(SR, N_FFT, n_mels)
    return torch.log10(torch.clamp_min(power @ fb.T, 1e-10))


def _audio(shape, seed=0) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# batch 1; an odd frame count (51: the last pair is half empty); an odd
# signal length with an odd frame count (101 frames)
MEL_SHAPES = [(1, 16_000), (2, 8_160), (3, 16_283)]


# atol 5e-5 on log-mel: the bar the JAX package holds its own fused kernel
# to (tests/test_mel_pallas.py). An fp32 FFT's rounding is ~1e-7 of the
# largest bin, far inside it.
@pytest.mark.parametrize("n_mels", [1, 77, 80, 128])
@pytest.mark.parametrize("shape", MEL_SHAPES)
def test_mel_fft_emulation_matches_plain(shape, n_mels):
    audio = torch.from_numpy(_audio(shape))
    out = emulate_mel_log10(audio, n_mels)
    assert out.shape == (shape[0], shape[1] // HOP, n_mels)
    torch.testing.assert_close(out, rfft_log10(audio, n_mels), rtol=0,
                               atol=5e-5)
    torch.testing.assert_close(
        t_mel._floor_and_scale(out),
        t_mel.log_mel_spectrogram(audio, n_mels=n_mels), rtol=0, atol=5e-5)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("shape", MEL_SHAPES)
def test_mel_fft_emulation_matches_jax_kernel(shape, n_mels):
    audio = _audio(shape, seed=1)
    out = t_mel._floor_and_scale(
        emulate_mel_log10(torch.from_numpy(audio), n_mels)).numpy()
    ref = np.asarray(j_mel_pallas.log_mel_spectrogram_fused(
        jnp.asarray(audio), n_mels=n_mels, force=True))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=5e-5)


@pytest.mark.parametrize("n_mels", [1, 2, 40, 77, 80, 128])
@pytest.mark.parametrize("sample_rate", [16_000, 8_000, 48_000])
def test_banded_filterbank_expands_to_the_dense_one(sample_rate, n_mels):
    t = t_mel_fused._fft_tables_np(sample_rate, n_mels)
    dense = t_mel._mel_filterbank_np(sample_rate, N_FFT, n_mels, 0.0,
                                     sample_rate / 2.0)
    rebuilt = np.zeros_like(dense)
    for m in range(n_mels):
        s, n, o = int(t.start[m]), int(t.count[m]), int(t.offset[m])
        assert 0 <= s and s + n <= N_FFT // 2 + 1
        rebuilt[m, s:s + n] = t.taps[o:o + n]
    np.testing.assert_array_equal(rebuilt, dense)
    assert int(t.count.sum()) == t.taps.size <= t_mel_fused._MAX_TAPS
    # rows without a tap (filters narrower than a bin) stay empty
    assert np.array_equal(t.count == 0, ~dense.any(axis=1))


def test_banded_filterbank_keeps_empty_filters():
    """The case the kernel's count-0 path exists for: at 48 kHz the lowest
    of 128 filters are narrower than a 120 Hz bin and have no tap; at
    16 kHz every filter has one."""
    assert (t_mel_fused._fft_tables_np(48_000, 128).count == 0).any()
    assert (t_mel_fused._fft_tables_np(SR, 128).count > 0).all()


def test_fft_tables_layout():
    """The packed table has the word layout the source declares, and the
    roots are the unit roots."""
    table, roots = t_mel_fused._fft_tables(SR, 128, torch.device("cpu"))
    t = t_mel_fused._fft_tables_np(SR, 128)
    table = table.numpy()
    assert table.shape == (2000,) and roots.shape == (82,)
    np.testing.assert_array_equal(table[:400], t.window)
    np.testing.assert_array_equal(table[400:800],
                                  t.twiddle.real.reshape(-1))
    np.testing.assert_array_equal(table[800:1200],
                                  t.twiddle.imag.reshape(-1))
    np.testing.assert_array_equal(table[1200:1200 + t.taps.size], t.taps)
    ints = table[1616:].view(np.int32).reshape(3, 128)
    np.testing.assert_array_equal(ints, [t.start, t.count, t.offset])
    j = np.arange(25)
    np.testing.assert_allclose(roots[32:57] + 1j * roots[57:],
                               np.exp(-2j * np.pi * j / 25), atol=1e-7)
    np.testing.assert_allclose(roots[:16] + 1j * roots[16:32],
                               np.exp(-2j * np.pi * j[:16] / 16), atol=1e-7)


@pytest.mark.parametrize("t_len", [201, 320, 16_123])
def test_reflect_by_index_equals_reflect_pad(t_len):
    x = torch.from_numpy(_audio((2, t_len), seed=2))
    j = np.arange(-N_FFT // 2, t_len + N_FFT // 2)
    by_index = x[:, torch.from_numpy(reflect_index(j, t_len))]
    assert torch.equal(by_index, _reflect_pad(x, N_FFT // 2))


def test_mel_route_and_what_it_rejects():
    assert t_mel_fused.mel_route(400) == "fft"
    assert t_mel_fused.mel_route(512) == "dense"
    assert t_mel_fused.mel_route(160) == "dense"
    with pytest.raises(ValueError):
        t_mel_fused.mel_route(1)
    # the launcher takes CUDA tensors only, whatever the route
    with pytest.raises(ValueError):
        t_mel_fused.mel_log10(torch.zeros(2, 1600), route="fft")


# -- K3 ---------------------------------------------------------------------

def swz(j):
    """The kernel's swizzle of a word index of the sums."""
    return j ^ ((j >> 3) & 4)


def emulate_block_sums_tiled(x: np.ndarray, nblk: int, hop: int,
                             n_lags: int) -> np.ndarray:
    """The tiled kernel's loop on one signal ``x[T]``: rows staged twice at
    the plan's pitch (copy 1 four words further), eight lags per item over
    a 12-sample register window read from the copy its lag group takes,
    chunks of four steps of ``i`` and the ``hop % 4`` trailing steps, sums
    written out through the swizzle."""
    plan = t_yin_bs.plan_rows(hop, n_lags)
    rows, groups, pitch = plan.rows, plan.groups, plan.pitch
    lags_pad = 8 * groups
    t_len = x.shape[0]
    out = np.zeros((nblk, n_lags), np.float32)
    j = np.arange(pitch)
    for blk0 in range(0, nblk, rows):
        n_rows = min(rows, nblk - blk0)
        skewed = rows * pitch + 4
        xs = np.full(2 * skewed, np.nan, np.float32)   # nan: never staged
        for r in range(n_rows):
            g = (blk0 + r) * hop + j
            v = np.where(g < t_len, x[np.minimum(g, t_len - 1)],
                         np.float32(0))
            xs[r * pitch + j] = v
            xs[skewed + r * pitch + j] = v
        item = np.arange(n_rows * groups)
        row = ((item // groups) * pitch)[:, None]
        group = (item % groups)[:, None]
        wp = row + 8 * group + ((group >> 2) & 1) * skewed
        acc = np.zeros((item.size, 8), np.float32)
        w = xs[wp + np.arange(12)]
        hop4 = hop & ~3
        for i in range(0, hop4, 4):
            nw = xs[wp + i + 12 + np.arange(4)]
            a = xs[row + i + np.arange(4)]
            for s in range(4):
                acc = a[:, s:s + 1] * w[:, s:s + 8] + acc
            w = np.concatenate([w[:, 4:], nw], axis=1)
        for s in range(hop - hop4):
            acc = xs[row + hop4 + s] * w[:, s:s + 8] + acc
        sums = np.zeros(rows * lags_pad, np.float32)
        at = (item // groups)[:, None] * lags_pad + 8 * group
        sums[swz(at + np.arange(8))] = acc
        for rr in range(n_rows):
            out[blk0 + rr] = sums[swz(rr * lags_pad + np.arange(n_lags))]
    return out


# 402 and 1202 lags leave 2 lags in the last group of 8; 403 leaves 3; the
# row counts (98, 50) are no multiples of the plans' 5 rows; hop 170 has two
# trailing steps. rtol = atol = 2e-4 is the JAX package's own bar
# (tests/test_ops_yin.py): the versions differ in the order and the fusing
# of fp32 sums of up to 512 products.
@pytest.mark.parametrize("buf,hop,n_lags_out,t", [
    (1360, 170, 402, 16_000), (1360, 170, 403, 3_000),
    (4096, 512, 1202, 24_000), (4096, 512, 2048, 6_000)])
def test_block_sums_tiled_emulation(buf, hop, n_lags_out, t):
    audio = np.random.default_rng(11).standard_normal((2, t)).astype(
        np.float32)
    jpad, n_hops = j_yin._pad_stream(jnp.asarray(audio), buf, hop)
    tpad, _ = t_yin._pad_stream(torch.from_numpy(audio), buf, hop)
    nblk = n_hops + (buf // 2) // hop - 1
    out = np.stack([emulate_block_sums_tiled(row, nblk, hop, n_lags_out)
                    for row in tpad.numpy()])
    plain = t_yin_bs.block_sums_plain(tpad, nblk, hop, n_lags_out).numpy()
    ref = np.asarray(j_yin._block_sums_xla(jpad, nblk, hop, n_lags_out))
    ref_kernel = np.asarray(j_yin_pallas.block_sums(
        jpad, nblk, hop, n_lags_out, interpret=True))
    assert out.shape == plain.shape == (2, nblk, n_lags_out)
    np.testing.assert_allclose(out, plain, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out, ref[..., :n_lags_out], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(out, ref_kernel[..., :n_lags_out], rtol=2e-4,
                               atol=2e-4)


def test_block_sums_tiled_emulation_signal_shorter_than_a_span():
    """Samples past the end of the signal read as zero."""
    x = np.random.default_rng(3).standard_normal(300).astype(np.float32)
    out = emulate_block_sums_tiled(x, 3, 170, 402)
    plain = t_yin_bs.block_sums_plain(torch.from_numpy(x)[None], 3, 170, 402)
    np.testing.assert_allclose(out, plain[0].numpy(), rtol=2e-4, atol=2e-4)


def test_a_quarter_warp_covers_all_banks():
    """Eight lanes loading 16 bytes at a stride of 32 bytes hit 32 banks:
    the row window through the skewed second copy (whatever lag group the
    quarter-warp starts at, whatever the step), the sums through the XOR
    swizzle, which is a permutation that keeps 16-byte groups whole."""
    lane = np.arange(8)
    skewed = 5 * 608 + 4
    for first_group in range(9):
        group = first_group + lane
        for step in (0, 12, 168):
            words = (8 * group + ((group >> 2) & 1) * skewed + step
                     )[:, None] + np.arange(4)
            assert np.unique(words % 32).size == 32
    j = np.arange(4096)
    s = swz(j)
    assert np.array_equal(np.sort(s), j)
    assert np.array_equal(s[::4] % 4, np.zeros(1024))
    assert np.array_equal(s[1::4], s[::4] + 1)
    for start in (0, 8, 408, 1208):
        words = swz(start + 8 * lane)[:, None] + np.arange(4)
        assert np.unique(words % 32).size == 32


@pytest.mark.parametrize("hop,n_lags,rows", [(170, 402, 5), (512, 1202, 5),
                                             (512, 2048, 1), (160, 8, 16)])
def test_plan_rows(hop, n_lags, rows):
    plan = t_yin_bs.plan_rows(hop, n_lags)
    assert plan.rows == rows
    assert plan.groups * 8 >= n_lags > (plan.groups - 1) * 8
    assert plan.pitch % 32 == 0
    assert plan.pitch >= -(-hop // 4) * 4 + 8 * plan.groups + 8
    assert plan.smem_bytes == 32 + 4 * plan.rows * (
        2 * plan.pitch + 8 * plan.groups)
    assert plan.smem_bytes <= 232_448


def test_plan_rows_raises_beyond_shared_memory():
    # one row alone may take more than half the limit ...
    big = t_yin_bs.plan_rows(4096, 9_000)
    assert big.rows == 1 and 232_448 // 2 < big.smem_bytes <= 232_448
    # ... but not more than all of it
    with pytest.raises(ValueError):
        t_yin_bs.plan_rows(8192, 30_000)
    with pytest.raises(ValueError):
        t_yin_bs.plan_rows(0, 402)


def test_block_sums_route_is_checked_on_the_cpu_too():
    x = torch.zeros(1, 2000)
    assert t_yin_bs.block_sums(x, 3, 170, 402, route="simple").shape == (
        1, 3, 402)
    with pytest.raises(ValueError):
        t_yin_bs.block_sums(x, 3, 170, 402, route="fast")
