"""Fused log-mel frontend: the CUDA kernel ``csrc/mel_fused.cu`` (K1).

Replaces ``janus_tpu/ops/mel_pallas.py:_kernel`` (``log_mel_spectrogram_
fused``). The kernel writes ``log10(max(mel, 1e-10))`` per frame: a
window-folded fp32 matmul DFT, the power spectrum and the Slaney mel
projection, fused so the spectrum never reaches device memory. Its bound
on the H100 is bytes (~9 MB of audio in and log-mel out at the 8 x 10 s
flagship batch, ~0.003 ms; a real FFT plus the sparse mel taps is only
~0.1 GFLOP); its dense matmul-DFT does ~3 GFLOP of fp32 work, far above
that. The source note says how its frequency tiling deals with banks too
large for shared memory. The per-signal (max - 8)
floor and the (x + 4) / 4 scale stay here in PyTorch, as in JAX.

On a CPU tensor :func:`log_mel_spectrogram_fused` computes the plain
FFT-path version (:func:`janus_tpu_torch.ops.mel.log_mel_spectrogram`);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from janus_tpu_torch.ops import cuda_build
from janus_tpu_torch.ops.mel import (_floor_and_scale, _mel_filterbank_np,
                                     log_mel_spectrogram)
from janus_tpu_torch.ops.stft import _hann_np, _reflect_pad

__all__ = ["log_mel_spectrogram_fused", "mel_log10", "KERNEL"]

KERNEL = cuda_build.KERNELS["mel_fused"]

_MAX_MELS = 128
# mel_log10(x, n_signals, lp, n_frames, hop, n_fft, cos, sin, n_freq_pad,
#           fbt, n_mels, out, stream)
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
             + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 2)


@functools.lru_cache(maxsize=None)
def _dft_mats_np(n_fft: int, sample_rate: int, n_mels: int):
    """Window-folded DFT banks ``[n_fft, n_freqs]`` (designed in float64,
    cast to float32) and the transposed filterbank ``[n_freqs, n_mels]``."""
    n_freqs = n_fft // 2 + 1
    window = _hann_np(n_fft).astype(np.float64)
    n = np.arange(n_fft)[:, None]
    f = np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * n * f / n_fft
    cos = (window[:, None] * np.cos(ang)).astype(np.float32)
    sin = (window[:, None] * -np.sin(ang)).astype(np.float32)
    fbt = np.ascontiguousarray(_mel_filterbank_np(
        sample_rate, n_fft, n_mels, 0.0, sample_rate / 2.0).T)
    return cos, sin, fbt


@functools.lru_cache(maxsize=None)
def _banks(n_fft: int, sample_rate: int, n_mels: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device)
                 for a in _dft_mats_np(n_fft, sample_rate, n_mels))


def mel_log10(audio: torch.Tensor, sample_rate: int = 16_000,
              n_fft: int = 400, hop: int = 160,
              n_mels: int = 80) -> torch.Tensor:
    """Kernel launch: ``audio[..., T]`` (CUDA, fp32) → ``log10(max(mel,
    1e-10))`` ``[..., n_frames, n_mels]`` with the final frame dropped."""
    if audio.device.type != "cuda":
        raise ValueError("mel_log10 launches a CUDA kernel; got a tensor on "
                         f"{audio.device}")
    if audio.dtype != torch.float32:
        raise TypeError(f"mel_log10 takes float32 audio, got {audio.dtype}")
    if not 1 <= n_mels <= _MAX_MELS:
        raise ValueError(f"n_mels must be in [1, {_MAX_MELS}], got {n_mels}")
    lead = audio.shape[:-1]
    x = _reflect_pad(audio.reshape(-1, audio.shape[-1]), n_fft // 2)
    x = x.contiguous()
    n_signals, lp = x.shape
    n_frames = (lp - n_fft) // hop  # 1 + (lp - n_fft)//hop, final dropped
    if n_frames < 1:
        raise ValueError("signal shorter than two frames")
    cos, sin, fbt = _banks(n_fft, sample_rate, n_mels, audio.device)
    out = torch.empty((n_signals * n_frames, n_mels), dtype=torch.float32,
                      device=audio.device)
    fn = cuda_build.entry(KERNEL, "mel_log10", _ARGTYPES)
    KERNEL.launches += 1
    code = fn(x.data_ptr(), n_signals, lp, n_frames, hop, n_fft,
              cos.data_ptr(), sin.data_ptr(), cos.shape[1], fbt.data_ptr(),
              n_mels, out.data_ptr(),
              torch.cuda.current_stream(audio.device).cuda_stream)
    cuda_build.check_launch(KERNEL, code)
    return out.reshape(tuple(lead) + (n_frames, n_mels))


def log_mel_spectrogram_fused(audio: torch.Tensor, sample_rate: int = 16_000,
                              n_fft: int = 400, hop: int = 160,
                              n_mels: int = 80) -> torch.Tensor:
    """Drop-in for :func:`log_mel_spectrogram` (same features, same
    layout ``[..., n_frames, n_mels]``)."""
    if audio.device.type == "cpu":
        return log_mel_spectrogram(audio, sample_rate, n_fft, hop, n_mels)
    return _floor_and_scale(
        mel_log10(audio.float(), sample_rate, n_fft, hop, n_mels))
