"""Plain signal processing of the send and receive paths, as the
configurations state it: the int16 wire, masked RMS, the 48 -> 16 kHz
Kaiser-sinc decimator, YIN pitch, the Whisper log-mel, the Vocos-style
inverse STFT and the 24 -> 48 kHz polyphase upsampler.

Written from the published definitions, in float64, with no FFT tricks
where a direct sum is affordable (the YIN difference function is summed
lag by lag). It imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["int16_wire", "rms", "decimate_3", "yin_f0", "log_mel",
           "hann", "istft", "upsample_2", "kaiser_sinc"]

F64 = torch.float64


def int16_wire(audio: torch.Tensor) -> torch.Tensor:
    """Float PCM through the int16 wire and back: round(x * 32768),
    clipped, over 32768."""
    q = torch.clamp(torch.round(audio.to(F64) * 32768.0), -32768, 32767)
    return q / 32768.0


def rms(audio: torch.Tensor, n_valid: torch.Tensor,
        dtype=F64) -> torch.Tensor:
    """Root mean square of each row over its first ``n_valid`` samples,
    computed in ``dtype``."""
    idx = torch.arange(audio.shape[-1], device=audio.device)
    m = (idx[None, :] < n_valid[:, None]).to(dtype)
    x = audio.to(dtype)
    return torch.sqrt((x * x * m).sum(-1) / m.sum(-1).clamp_min(1.0))


def kaiser_sinc(num_taps: int, cutoff: float, beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed sinc low-pass of unit DC gain; ``cutoff`` in units of
    the input's Nyquist frequency."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(num_taps, beta)
    return h / h.sum()


def decimate_3(audio: torch.Tensor) -> torch.Tensor:
    """48 -> 16 kHz: a 97-tap Kaiser-sinc low-pass at a third of the band,
    centred, every third output kept: ``y[m] = sum_j h[j] x[3m + j - 48]``,
    ``len // 3`` outputs."""
    taps = 97
    h = torch.from_numpy(kaiser_sinc(taps, 1.0 / 3)).to(audio.device, F64)
    x = F.pad(audio.to(F64)[:, None, :], (taps // 2, taps // 2))
    y = F.conv1d(x, h.view(1, 1, -1), stride=3)[:, 0]
    return y[:, :audio.shape[-1] // 3]


def yin_f0(audio16: torch.Tensor, n_hops_valid: torch.Tensor,
           buf: int = 1360, hop: int = 170, tolerance: float = 0.8,
           fmin: float = 40.0, fmax: float = 1000.0,
           sample_rate: int = 16_000, dtype=F64) -> torch.Tensor:
    """Mean voiced F0 (Hz, 0 when no hop is voiced) of each row by YIN
    (de Cheveigne and Kawahara 2002) in aubio's streaming layout: window
    k holds the ``buf`` samples that end at hop boundary ``(k+1)·hop``
    (zeros before the signal), ``d(tau) = sum_{j<buf/2} (w[j] -
    w[j+tau])^2``, the cumulative-mean normalisation, the first lag in
    ``[sr/fmax, sr/fmin]`` below ``tolerance`` that is a two-sided local
    minimum, refined by a parabola; only the first ``n_hops_valid`` hops
    of each row count. The difference function is summed in ``dtype``."""
    x = audio16.to(dtype)
    t = x.shape[-1]
    n_hops = -(-t // hop)
    total = buf - hop + n_hops * hop
    xp = F.pad(x, (buf - hop, total - (buf - hop) - t))
    win = xp.unfold(-1, buf, hop)[:, :n_hops]             # [B, H, buf]
    n_lags = buf // 2
    p_lo = max(2, int(sample_rate / fmax))
    p_hi = min(n_lags - 4, int(sample_rate / fmin))
    n_out = min(n_lags, p_hi + 2)
    a = win[..., :n_lags]
    d = torch.stack([((a - win[..., tau:tau + n_lags]) ** 2).sum(-1)
                     for tau in range(n_out)], dim=-1).to(F64)  # [B, H, n_out]
    tau = torch.arange(n_out, device=x.device, dtype=F64)
    running = torch.cumsum(d, -1) - d[..., :1]
    y = torch.where(running > 0, d * tau / running.clamp_min(1e-300),
                    torch.ones_like(d))
    y[..., 0] = 1.0
    nxt = torch.cat([y[..., 1:], y[..., :1]], -1)
    prv = torch.cat([y[..., -1:], y[..., :-1]], -1)
    lag = torch.arange(n_out, device=x.device)
    in_range = (lag >= p_lo) & (lag <= p_hi)
    cand = in_range & (y < tolerance) & (y < nxt) & (y <= prv)
    has = cand.any(-1)
    pos = torch.argmax(cand.to(torch.int8), -1)
    p = pos.clamp(1, n_out - 2)
    s0, s1, s2 = (torch.gather(y, -1, (p + o)[..., None])[..., 0]
                  for o in (-1, 0, 1))
    den = s0 - 2 * s1 + s2
    period = p.to(F64) + torch.where(den.abs() > 1e-12, 0.5 * (s0 - s2) / den,
                                     torch.zeros_like(den))
    f0 = torch.where(has & (period > 0), sample_rate / period.clamp_min(1e-6),
                     torch.zeros_like(period))
    hop_idx = torch.arange(n_hops, device=x.device)
    voiced = (f0 > 0) & (hop_idx[None, :] < n_hops_valid[:, None])
    count = voiced.sum(-1)
    return torch.where(count > 0, (f0 * voiced).sum(-1) / count.clamp_min(1),
                       torch.zeros(count.shape, dtype=F64, device=x.device))


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                                * (m - 15.0)),
                    m * (200.0 / 3))


def mel_filters(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-normalised triangular filters ``[n_mels, n_fft//2 + 1]``
    over 0 .. sr/2 (librosa's default, which Whisper uses)."""
    freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2),
                                n_mels + 2))
    fb = np.zeros((n_mels, len(freqs)))
    for i in range(n_mels):
        lo, c, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (freqs - lo) / (c - lo)
        down = (hi - freqs) / (hi - c)
        fb[i] = np.maximum(0.0, np.minimum(up, down)) * 2.0 / (hi - lo)
    return fb


def hann(n: int, device) -> torch.Tensor:
    """Periodic Hann window."""
    k = torch.arange(n, device=device, dtype=F64)
    return 0.5 - 0.5 * torch.cos(2 * math.pi * k / n)


def log_mel(audio16: torch.Tensor, n_frames: int, n_mels: int,
            n_fft: int = 400, hop: int = 160) -> torch.Tensor:
    """Whisper's log-mel ``[B, n_frames, n_mels]`` of 16 kHz audio padded
    or cut to ``n_frames * hop`` samples: centred reflect-padded STFT with
    a periodic Hann window, power, the last frame dropped, Slaney mel,
    log10 clamped at 1e-10, floored at the signal's max - 8, (x + 4) / 4."""
    x = audio16.to(F64)
    target = n_frames * hop
    x = F.pad(x, (0, max(0, target - x.shape[-1])))[:, :target]
    x = F.pad(x[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop) * hann(n_fft, x.device)
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    power = power[:, :-1]
    fb = torch.from_numpy(mel_filters(16_000, n_fft, n_mels)).to(x.device)
    lm = torch.log10(torch.clamp_min(power @ fb.T, 1e-10))
    lm = torch.maximum(lm, lm.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (lm + 4.0) / 4.0


def istft(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Vocos's inverse STFT: each frame's inverse real FFT windowed by a
    periodic Hann window, overlap-added, divided by the summed squared
    window, ``n_fft // 2`` trimmed from both ends. The last frame is
    repeated ``n_fft // hop`` times first, so that ``T`` frames give
    ``T * hop`` samples."""
    t = spec.shape[-2]
    spec = torch.cat([spec, spec[:, -1:].expand(-1, n_fft // hop, -1)], 1)
    w = hann(n_fft, spec.device)
    frames = torch.fft.irfft(spec.to(torch.complex128), n=n_fft, dim=-1) * w
    n = frames.shape[1]
    out_len = n_fft + hop * (n - 1)
    wav = torch.zeros(frames.shape[0], out_len, dtype=F64,
                      device=spec.device)
    wsq = torch.zeros(out_len, dtype=F64, device=spec.device)
    for i in range(n):
        wav[:, i * hop:i * hop + n_fft] += frames[:, i]
        wsq[i * hop:i * hop + n_fft] += w * w
    wav = wav / wsq.clamp_min(1e-8)
    return wav[:, n_fft // 2:out_len - n_fft // 2][:, :t * hop]


def upsample_2(x: torch.Tensor, taps_per_phase: int = 32) -> torch.Tensor:
    """Rate x2: zeros stuffed between samples, then a centred Kaiser-sinc
    low-pass at half the band with gain 2 (``taps_per_phase * 2 + 1``
    taps)."""
    n_taps = taps_per_phase * 2 + 1
    h = torch.from_numpy(kaiser_sinc(n_taps, 0.5) * 2.0).to(x.device, F64)
    u = torch.zeros(x.shape[0], 2 * x.shape[-1], dtype=F64, device=x.device)
    u[:, ::2] = x.to(F64)
    d = n_taps // 2
    return F.conv1d(F.pad(u[:, None], (d, d)), h.view(1, 1, -1))[:, 0]
