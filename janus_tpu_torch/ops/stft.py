"""Short-time Fourier transform primitives (framing as a strided view,
then a batched rFFT) and the windowed overlap-add inverse. Signals are
``[T]`` or ``[..., T]``."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["hann_window", "frame_signal", "stft", "istft"]


@functools.lru_cache(maxsize=None)
def _hann_np(n_fft: int) -> np.ndarray:
    # Periodic Hann, the analysis window of Whisper-style frontends.
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
            ).astype(np.float32)


def hann_window(n_fft: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.from_numpy(_hann_np(n_fft)).to(device=device, dtype=dtype)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Overlapping frames ``[..., n_frames, frame_length]`` (a view)."""
    if x.shape[-1] < frame_length:
        return x.new_zeros(tuple(x.shape[:-1]) + (0, frame_length))
    return x.unfold(-1, frame_length, hop)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy-style ``reflect`` padding of the last axis (edge not repeated)."""
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return y.reshape(tuple(lead) + (y.shape[-1],))


def stft(x: torch.Tensor, n_fft: int, hop: int,
         window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Centered (reflect-padded) complex STFT ``[..., n_frames,
    n_fft//2 + 1]``."""
    if window is None:
        window = hann_window(n_fft, dtype=x.dtype, device=x.device)
    x = _reflect_pad(x, n_fft // 2)
    frames = frame_signal(x, n_fft, hop)
    return torch.fft.rfft(frames * window, n=n_fft, dim=-1)


def istft(spec: torch.Tensor, n_fft: int, hop: int,
          window: Optional[torch.Tensor] = None,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse of the centered STFT: windowed overlap-add with the
    summed-squared-window (COLA) normalization, the centering pad trimmed.
    ``spec`` is complex ``[..., n_frames, n_fft//2 + 1]``; the result is
    float32 ``[..., hop * (n_frames - 1)]`` (cut to ``length``)."""
    if window is None:
        window = hann_window(n_fft, device=spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    n_frames = frames.shape[-2]
    out_len = n_fft + hop * (n_frames - 1)
    batch_shape = tuple(frames.shape[:-2])
    flat = frames.reshape(-1, n_frames, n_fft)
    w2 = window.float() ** 2

    if n_fft % hop == 0:
        # With ratio = n_fft / hop every hop-wide slot of the output gets
        # exactly ``ratio`` frame pieces, so overlap-add is ``ratio``
        # elementwise adds of frame-shifted pieces. They are added in
        # ascending m for every slot, wherever the slot lies: a chunk of
        # frames with enough halo gives the very samples the whole signal
        # gives (what chunked streaming synthesis relies on).
        ratio = n_fft // hop
        n_slots = n_frames + ratio - 1
        chunks = flat.reshape(-1, n_frames, ratio, hop)
        w2 = w2.reshape(ratio, hop)
        acc = flat.new_zeros((flat.shape[0], n_slots, hop))
        wacc = flat.new_zeros((n_slots, hop))
        for m in range(ratio):
            acc[:, m:m + n_frames] += chunks[:, :, m, :]
            wacc[m:m + n_frames] += w2[m]
        wav = acc.reshape(-1, n_slots * hop)
        wsq = wacc.reshape(n_slots * hop)
    else:
        # Scatter overlap-add for frame lengths the hop does not divide
        # (neither the demo vocoder's 640/160 nor the default 1024/256).
        # ``index_add_`` on a CUDA tensor accumulates with atomics, so this
        # route is not reproducible from run to run on the card.
        idx = (hop * torch.arange(n_frames, device=spec.device)[:, None]
               + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
        wav = flat.new_zeros((flat.shape[0], out_len))
        wav.index_add_(1, idx, flat.reshape(flat.shape[0], -1))
        wsq = flat.new_zeros((out_len,))
        wsq.index_add_(0, idx, w2.repeat(n_frames))
    wav = wav / torch.clamp_min(wsq, 1e-8)

    wav = wav.reshape(batch_shape + (out_len,))
    wav = wav[..., n_fft // 2: out_len - n_fft // 2]
    if length is not None:
        wav = wav[..., :length]
    return wav
