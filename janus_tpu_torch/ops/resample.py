"""Anti-aliased polyphase resampling with a Kaiser-windowed sinc FIR:
integer decimation as banded fp32 matmuls (48 kHz -> 16 kHz on the send
path), integer upsampling as per-phase chains of shifted multiply-adds
(the vocoder's rate -> 48 kHz on the receive path), and the general
rational case as one strided convolution over the zero-stuffed signal."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["fir_lowpass_taps", "resample_poly", "decimate_48k_to_16k",
           "naive_decimate"]


@functools.lru_cache(maxsize=None)
def fir_lowpass_taps(num_taps: int, cutoff: float, beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed sinc low-pass taps; ``cutoff`` in normalized
    frequency (1.0 = Nyquist of the input rate)."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(num_taps, beta)
    h /= np.sum(h)
    return h.astype(np.float32)


def naive_decimate(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Plain strided decimation, for parity experiments with the
    reference's ``[::3]`` path only; aliases by design."""
    return x[..., ::factor]


def _upsample_fir(x: torch.Tensor, up: int,
                  num_taps_per_phase: int = 32) -> torch.Tensor:
    """Integer upsampling: ``y[up·q + p] = Σ_k h[p + D − up·k]·x[q + k]``.

    Each output phase is a FIR of about ``num_taps_per_phase`` taps,
    written as an explicit chain of shifted elementwise products and sums,
    ``k`` ascending from ``-reach`` to ``reach`` with zero taps skipped.
    Every output is accumulated in that one order whatever its position,
    and each product and each sum is a separate correctly rounded
    operation, so a chunk evaluated with enough halo is bit-identical to
    the same span of the whole signal (streaming synthesis relies on it)."""
    num_taps = num_taps_per_phase * up + 1  # odd, exact center D
    taps = (fir_lowpass_taps(num_taps, 1.0 / up) * up).astype(np.float32)
    d = (num_taps - 1) // 2

    batch_shape = tuple(x.shape[:-1])
    t = x.shape[-1]
    xf = x.reshape(-1, t)
    reach = (num_taps + up - 1) // up
    xp = F.pad(xf, (reach, reach))
    y = xf.new_zeros((xf.shape[0], t, up))
    for p in range(up):
        acc = None
        for k in range(-reach, reach + 1):
            hidx = p + d - up * k
            if 0 <= hidx < num_taps and taps[hidx] != 0.0:
                term = xp[:, reach + k: reach + k + t] * float(taps[hidx])
                acc = term if acc is None else acc.add_(term)
        if acc is not None:
            y[:, :, p] = acc
    return y.reshape(batch_shape + (t * up,))


def resample_poly(x: torch.Tensor, up: int, down: int,
                  num_taps_per_phase: int = 32) -> torch.Tensor:
    """Rational-rate polyphase resampler for ``[..., T]`` signals.

    A zero-phase windowed-sinc FIR is designed at the virtual upsampled
    rate: output sample m is ``y[m] = Σ_j h[m·down + D − j·up] · x[j]``
    with D the filter center. ``up / down`` is reduced by its gcd first (an
    unreduced 16000/44100 would design 32·16000 + 1 taps). Integer
    down-factors take the banded-matmul decimator, integer up-factors the
    per-phase chains, anything else a strided convolution over the
    zero-stuffed signal."""
    g = int(np.gcd(up, down))
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    if up == 1:
        return _decimate_fir(x, down, num_taps_per_phase * down)
    if down == 1:
        return _upsample_fir(x, up, num_taps_per_phase)

    num_taps = num_taps_per_phase * up + 1  # odd length, exact center D
    taps = fir_lowpass_taps(num_taps, min(1.0 / down, 1.0 / up)) * up
    delay = (num_taps - 1) // 2

    t = x.shape[-1]
    out_len = (t * up) // down
    # y[m] = Σ_j h[m·down + D − j·up]·x[j] is the correlation of the
    # up-dilated x (``up - 1`` zeros between samples) with the reversed
    # taps, left-padded by D and read at stride ``down``.
    dilated_len = (t - 1) * up + 1
    pad_lo = delay
    pad_hi = max(0, (out_len - 1) * down + num_taps - 1 - pad_lo
                 - (dilated_len - 1))
    batch_shape = tuple(x.shape[:-1])
    xf = x.float().reshape(-1, 1, t)
    dilated = xf.new_zeros((xf.shape[0], 1, pad_lo + dilated_len + pad_hi))
    dilated[:, :, pad_lo: pad_lo + dilated_len: up] = xf
    kern = torch.from_numpy(np.ascontiguousarray(taps[::-1]).astype(
        np.float32)).to(x.device).reshape(1, 1, num_taps)
    out = F.conv1d(dilated, kern, stride=down)
    return out[:, 0, :out_len].reshape(batch_shape + (out_len,))


def _decimate_fir_conv(x: torch.Tensor, factor: int,
                       num_taps: int) -> torch.Tensor:
    """Integer decimation as a convolution over ``factor`` phase channels:
    the ablation and parity reference for :func:`_decimate_fir`. The signal
    is folded into ``factor`` phases and convolved with the matching tap
    phases; the taps are symmetric, so no kernel reversal is needed."""
    num_taps = int(np.ceil(num_taps / factor) * factor) + 1
    padded_len = int(np.ceil(num_taps / factor) * factor)
    taps = np.zeros(padded_len, dtype=np.float32)
    taps[:num_taps] = fir_lowpass_taps(num_taps, 1.0 / factor)
    half = num_taps // 2
    k = padded_len // factor

    batch_shape = tuple(x.shape[:-1])
    t = x.shape[-1]
    out_len = t // factor
    xf = x.float().reshape(-1, t)
    xp = F.pad(xf, (half, padded_len - half))
    tp = xp.shape[-1] - (xp.shape[-1] % factor)
    # u[b, p, s] = xp[b, factor*s + p], kern[0, p, k] = h[factor*k + p]
    u = xp[:, :tp].reshape(-1, tp // factor, factor).transpose(1, 2)
    kern = torch.from_numpy(np.ascontiguousarray(
        taps.reshape(k, factor).T)).to(x.device).reshape(1, factor, k)
    y = F.conv1d(u, kern)
    return y[:, 0, :out_len].reshape(batch_shape + (out_len,))


@functools.lru_cache(maxsize=None)
def _decimate_matmul_weights(factor: int, num_taps: int,
                             block_out: int) -> tuple[np.ndarray, int, int]:
    """Banded tap matrix ``W[i, m] = h[i - factor·m]``, the (rounded-odd)
    tap count and the frame overlap."""
    num_taps_r = int(np.ceil(num_taps / factor) * factor) + 1
    taps = fir_lowpass_taps(num_taps_r, 1.0 / factor)
    overlap = num_taps_r - 1                      # multiple of ``factor``
    width = factor * block_out + overlap
    w = np.zeros((width, block_out), dtype=np.float32)
    for m in range(block_out):
        w[factor * m: factor * m + num_taps_r, m] = taps
    return w, num_taps_r, overlap


def _decimate_fir(x: torch.Tensor, factor: int, num_taps: int,
                  block_out: int = 256) -> torch.Tensor:
    """``y[m] = Σ_j h[j]·x[factor·m + j − D]`` evaluated ``block_out``
    outputs at a time: ``y = c_f @ W[:chunk] + head_{f+1} @ W[chunk:]``
    over non-overlapping chunks of the padded signal (two fp32 matmuls)."""
    w_np, num_taps_r, overlap = _decimate_matmul_weights(
        factor, num_taps, block_out)
    half = num_taps_r // 2
    chunk = factor * block_out
    w = torch.from_numpy(w_np).to(x.device)
    w_main, w_tail = w[:chunk], w[chunk:]

    batch_shape = x.shape[:-1]
    t = x.shape[-1]
    out_len = t // factor
    n_frames = -(-out_len // block_out)
    need = chunk * (n_frames + 1)
    xf = x.float().reshape(-1, t)
    xp = F.pad(xf, (half, need - t - half))
    c2 = xp.reshape(xf.shape[0], n_frames + 1, chunk)
    y = (torch.matmul(c2[:, :n_frames], w_main)
         + torch.matmul(c2[:, 1:, :overlap], w_tail))
    return (y.reshape(xf.shape[0], n_frames * block_out)[:, :out_len]
            .reshape(tuple(batch_shape) + (out_len,)))


def decimate_48k_to_16k(x: torch.Tensor) -> torch.Tensor:
    """48 kHz -> 16 kHz with anti-aliasing."""
    return _decimate_fir(x, 3, 96)
