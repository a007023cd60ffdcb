"""Fused log-mel frontend: the CUDA kernel ``csrc/mel_fused.cu`` (K1).

Replaces ``janus_tpu/ops/mel_pallas.py:_kernel`` (``log_mel_spectrogram_
fused``). The kernel writes ``log10(max(mel, 1e-10))`` per frame with
nothing between the audio and the log-mel in device memory. Its bound on
the H100 is bytes (~9 MB of audio in and log-mel out at the 8 x 10 s
flagship batch, ~0.003 ms; a real FFT plus the filterbank's nonzero taps
is only ~0.1 GFLOP), so the design does little work per frame:

* route ``"fft"`` (n_fft 400, the only value the send path uses): two real
  frames per complex transform, a four-step 16 x 25 FFT in registers and
  shared memory, and a banded filterbank (each Slaney triangle is one
  contiguous run of bins). The audio is read unpadded: the reflect edge is
  an index reflection inside the kernel. Every table the kernel reads (Hann
  window, twiddles, roots of unity, packed taps) is designed here in
  float64 and handed over as float32 (:func:`_fft_tables_np`);
* route ``"dense"`` (any other n_fft): the window-folded matmul DFT with a
  dense filterbank product on a reflect-padded copy, ~40x the arithmetic at
  n_fft 400. ``mel_log10(..., route="dense")`` times it on the same tensor.

The per-signal (max - 8) floor and the (x + 4) / 4 scale stay here in
PyTorch, as in JAX.

On a CPU tensor :func:`log_mel_spectrogram_fused` computes the plain
FFT-path version (:func:`janus_tpu_torch.ops.mel.log_mel_spectrogram`);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from janus_tpu_torch.ops import cuda_build
from janus_tpu_torch.ops.mel import (_floor_and_scale, _mel_filterbank_np,
                                     log_mel_spectrogram)
from janus_tpu_torch.ops.stft import _hann_np, _reflect_pad

__all__ = ["log_mel_spectrogram_fused", "mel_log10", "mel_route", "ROUTES",
           "KERNEL"]

KERNEL = cuda_build.KERNELS["mel_fused"]

ROUTES = ("fft", "dense")
_MAX_MELS = 128
_FFT_N, _FFT_N1, _FFT_N2 = 400, 16, 25   # 400 = 16 x 25
_MAX_TAPS = 416                          # as MAX_TAPS in the source
# mel_log10_fft(x, n_signals, row_stride, t_len, n_frames, hop, tables,
#               roots, n_mels, out, stream)
_FFT_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
# mel_log10_dense(x, n_signals, lp, n_frames, hop, n_fft, cos, sin,
#                 n_freqs, fbt, n_mels, out, stream)
_DENSE_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)


def mel_route(n_fft: int) -> str:
    """Which kernel takes a frame length: ``"fft"`` for 400 (= 16 x 25, the
    factorisation the FFT kernel is written for), ``"dense"`` otherwise."""
    if n_fft < 2:
        raise ValueError(f"n_fft must be at least 2, got {n_fft}")
    return "fft" if n_fft == _FFT_N else "dense"


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


class FFTTables(NamedTuple):
    """What the FFT kernel reads, float32 / int32."""
    window: np.ndarray    # [400] periodic Hann
    twiddle: np.ndarray   # [16, 25] complex64, W400^(n2 k1) at [k1, n2]
    root16: np.ndarray    # [16] complex64, exp(-2 pi i j / 16)
    root25: np.ndarray    # [25] complex64, exp(-2 pi i j / 25)
    start: np.ndarray     # [n_mels] first bin of each mel's run of taps
    count: np.ndarray     # [n_mels] taps in the run (0: an empty filter)
    offset: np.ndarray    # [n_mels] where the run starts in ``taps``
    taps: np.ndarray      # packed runs, the dense filterbank's own values


def _unit_roots(n: int) -> np.ndarray:
    return np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _fft_tables_np(sample_rate: int, n_mels: int) -> FFTTables:
    """The FFT route's tables for n_fft 400, designed in float64."""
    n2, k1 = np.arange(_FFT_N2)[None, :], np.arange(_FFT_N1)[:, None]
    twiddle = np.exp(-2j * np.pi * (n2 * k1) / _FFT_N).astype(np.complex64)
    fb = _mel_filterbank_np(sample_rate, _FFT_N, n_mels, 0.0,
                            sample_rate / 2.0)
    start = np.zeros(n_mels, np.int32)
    count = np.zeros(n_mels, np.int32)
    offset = np.zeros(n_mels, np.int32)
    runs = []
    total = 0
    for m in range(n_mels):
        nz = np.flatnonzero(fb[m])
        offset[m] = total
        if nz.size:
            start[m], count[m] = nz[0], nz[-1] - nz[0] + 1
            runs.append(fb[m, nz[0]:nz[-1] + 1])
            total += int(count[m])
    taps = (np.concatenate(runs) if runs else np.zeros(0)).astype(np.float32)
    if total > _MAX_TAPS:
        raise ValueError(f"the banded filterbank has {total} taps; the "
                         f"kernel's table holds {_MAX_TAPS}")
    return FFTTables(_hann_np(_FFT_N), twiddle, _unit_roots(_FFT_N1),
                     _unit_roots(_FFT_N2), start, count, offset, taps)


@functools.lru_cache(maxsize=None)
def _fft_tables(sample_rate: int, n_mels: int, device: torch.device):
    """(device table in the kernel's word layout, host roots) — the roots
    travel as a kernel parameter, so they stay a host array."""
    t = _fft_tables_np(sample_rate, n_mels)
    taps = np.zeros(_MAX_TAPS, np.float32)
    taps[:t.taps.size] = t.taps

    def ints(a):
        padded = np.zeros(_MAX_MELS, np.int32)
        padded[:a.size] = a
        return padded.view(np.float32)

    tw = t.twiddle.reshape(-1)
    table = np.concatenate([t.window, tw.real, tw.imag, taps, ints(t.start),
                            ints(t.count), ints(t.offset)]).astype(np.float32)
    roots = np.ascontiguousarray(np.concatenate(
        [t.root16.real, t.root16.imag, t.root25.real, t.root25.imag]
    ).astype(np.float32))
    return torch.from_numpy(table).to(device), roots


def mel_log10(audio: torch.Tensor, sample_rate: int = 16_000,
              n_fft: int = 400, hop: int = 160, n_mels: int = 80,
              route: Optional[str] = None) -> torch.Tensor:
    """Kernel launch: ``audio[..., T]`` (CUDA, fp32) → ``log10(max(mel,
    1e-10))`` ``[..., n_frames, n_mels]`` with the final frame dropped.
    ``route`` forces a kernel (``"dense"`` takes every n_fft; it is how the
    two are timed on the same tensor); by default :func:`mel_route` picks."""
    if audio.device.type != "cuda":
        raise ValueError("mel_log10 launches a CUDA kernel; got a tensor on "
                         f"{audio.device}")
    if audio.dtype != torch.float32:
        raise TypeError(f"mel_log10 takes float32 audio, got {audio.dtype}")
    if not 1 <= n_mels <= _MAX_MELS:
        raise ValueError(f"n_mels must be in [1, {_MAX_MELS}], got {n_mels}")
    picked = mel_route(n_fft)
    if route is None:
        route = picked
    elif route not in ROUTES or (route == "fft" and picked != "fft"):
        raise ValueError(f"mel route {route!r} does not take n_fft {n_fft}")
    lead = audio.shape[:-1]
    t_len = audio.shape[-1]
    # 1 + (T + 2 (n_fft // 2) - n_fft) // hop frames, the final one dropped
    n_frames = (t_len + 2 * (n_fft // 2) - n_fft) // hop
    if n_frames < 1 or t_len <= n_fft // 2:
        raise ValueError("signal shorter than two frames")
    x = audio.reshape(-1, t_len)
    n_signals = x.shape[0]
    out = torch.empty((n_signals * n_frames, n_mels), dtype=torch.float32,
                      device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    if route == "fft":
        if x.stride(1) != 1 or (n_signals > 1 and x.stride(0) < t_len):
            x = x.contiguous()
        table, roots = _fft_tables(sample_rate, n_mels, audio.device)
        fn = cuda_build.entry(KERNEL, "mel_log10_fft", _FFT_ARGTYPES)
        KERNEL.launches += 1
        code = fn(x.data_ptr(), n_signals, x.stride(0), t_len, n_frames, hop,
                  table.data_ptr(), roots.ctypes.data, n_mels,
                  out.data_ptr(), stream)
    else:
        x = _reflect_pad(x, n_fft // 2).contiguous()
        cos, sin, fbt = _banks(n_fft, sample_rate, n_mels, audio.device)
        fn = cuda_build.entry(KERNEL, "mel_log10_dense", _DENSE_ARGTYPES)
        KERNEL.launches += 1
        code = fn(x.data_ptr(), n_signals, x.shape[1], n_frames, hop, n_fft,
                  cos.data_ptr(), sin.data_ptr(), cos.shape[1],
                  fbt.data_ptr(), n_mels, out.data_ptr(), stream)
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
