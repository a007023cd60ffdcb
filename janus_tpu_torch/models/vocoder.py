"""Generative vocoder: mel → waveform via an iSTFT head (Vocos-style).

The backbone stays at mel frame rate (ConvNeXt-style 1-D blocks:
depthwise conv k7 + pointwise MLP + layer scale) and two linear heads
predict log-magnitude and phase (a cos/sin pair) per STFT bin; the
waveform is reconstructed with one windowed overlap-add inverse STFT.
Everything is parallel over frames: a handful of matmuls and one batched
inverse real FFT (the reference outsourced waveform generation to a cloud
service; reference: backend/services/synthesizer.py:191-207).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from janus_tpu_torch.common.config import VocoderConfig
from janus_tpu_torch.models.params import _init_ln, _normal, _zeros
from janus_tpu_torch.ops.layers import gelu, layer_norm, linear
from janus_tpu_torch.ops.stft import hann_window, istft

__all__ = ["init_vocoder", "vocoder_waveform", "vocoder_spectra",
           "spectra_to_waveform", "vocoder_halo_frames"]

Params = Dict


def _init_block(g: torch.Generator, d: int, k: int = 7, mlp: int = 3) -> Params:
    return {
        "dwconv": {"w": _normal(g, (k, d), scale=0.1), "b": _zeros(g, d)},
        "ln": _init_ln(g, d),
        "pw1": {"w": _normal(g, (d, mlp * d)), "b": _zeros(g, mlp * d)},
        "pw2": {"w": _normal(g, (mlp * d, d)), "b": _zeros(g, d)},
        "gamma": torch.full((d,), 1e-2, device=g.device),
    }


def init_vocoder(generator: torch.Generator, cfg: VocoderConfig,
                 n_mels: int = 80) -> Params:
    """Random tree on the generator's device, float32."""
    g, d = generator, cfg.d_model
    n_bins = cfg.n_fft // 2 + 1
    return {
        "embed": {"w": _normal(g, (n_mels, d)), "b": _zeros(g, d)},
        "blocks": [_init_block(g, d) for _ in range(cfg.layers)],
        "ln_out": _init_ln(g, d),
        "mag_head": {"w": _normal(g, (d, n_bins)), "b": _zeros(g, n_bins)},
        "phase_head": {"w": _normal(g, (d, 2 * n_bins)),
                       "b": _zeros(g, 2 * n_bins)},
    }


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Depthwise 1-D conv over ``[..., T, D]`` with kernel ``[K, D]``,
    same-padded, as a sum of K shifted scalings added in ascending ``i``.
    Not a library depthwise convolution: its algorithm, and so its
    rounding, may change with the length, and a chunk of frames with halo
    must give what the whole sequence gives."""
    k = w.shape[0]
    half = k // 2
    t = x.shape[-2]
    xp = F.pad(x, (0, 0, half, half))
    y = xp[..., 0:t, :] * w[0]
    for i in range(1, k):
        y = y + xp[..., i:i + t, :] * w[i]
    return y + b


def vocoder_spectra(params: Params, cfg: VocoderConfig,
                    mel: torch.Tensor) -> torch.Tensor:
    """``mel[..., T, n_mels] -> complex64 spec[..., T, n_fft//2+1]``.

    The frame-local half of the vocoder: ConvNeXt backbone + mag/phase
    heads. Frame f's spectrum depends only on mel frames within
    ``3 * layers`` (depthwise k=7: 3 per block), which chunked streaming
    synthesis exploits (:mod:`janus_tpu_torch.runtime.streaming_tts`)."""
    x = linear(mel, params["embed"]["w"], params["embed"]["b"])
    for blk in params["blocks"]:
        h = _depthwise_conv(x, blk["dwconv"]["w"], blk["dwconv"]["b"])
        h = layer_norm(h, **blk["ln"])
        h = linear(gelu(linear(h, blk["pw1"]["w"], blk["pw1"]["b"])),
                   blk["pw2"]["w"], blk["pw2"]["b"])
        x = x + blk["gamma"] * h
    x = layer_norm(x, **params["ln_out"])

    log_mag = linear(x, params["mag_head"]["w"], params["mag_head"]["b"])
    mag = torch.exp(torch.clamp(log_mag, -14.0, 6.0))
    ph = linear(x, params["phase_head"]["w"], params["phase_head"]["b"])
    n_bins = cfg.n_fft // 2 + 1
    cos_p, sin_p = ph[..., :n_bins], ph[..., n_bins:]
    norm = torch.rsqrt(cos_p ** 2 + sin_p ** 2 + 1e-7)
    # torch.complex takes no bf16 parts: the parts are formed in the
    # activations' dtype and widened, as promotion to complex64 does
    return torch.complex((mag * cos_p * norm).float(),
                         (mag * sin_p * norm).float())


def spectra_to_waveform(cfg: VocoderConfig, spec: torch.Tensor,
                        length: Optional[int] = None,
                        tail_repeat: bool = True) -> torch.Tensor:
    """Windowed overlap-add iSTFT of vocoder spectra.

    With ``tail_repeat`` the final frame is repeated ``n_fft // hop``
    times so that the centered iSTFT's edge trim still yields the full
    ``T * hop`` samples (the utterance-end flush). Chunked synthesis
    passes ``tail_repeat=False`` for interior chunks (the next chunk's
    halo is that context) and slices the overlap region itself."""
    t = spec.shape[-2]
    if tail_repeat:
        extra = cfg.n_fft // cfg.hop_length
        tail = spec[..., -1:, :].expand(
            tuple(spec.shape[:-2]) + (extra, spec.shape[-1]))
        spec = torch.cat([spec, tail], dim=-2)
    wav = istft(spec, n_fft=cfg.n_fft, hop=cfg.hop_length,
                window=hann_window(cfg.n_fft, device=spec.device))
    out_len = length if length is not None else t * cfg.hop_length
    return wav[..., :out_len]


def vocoder_waveform(params: Params, cfg: VocoderConfig, mel: torch.Tensor,
                     length: Optional[int] = None) -> torch.Tensor:
    """``mel[..., T, n_mels] -> waveform[..., T*hop]``."""
    spec = vocoder_spectra(params, cfg, mel)
    return spectra_to_waveform(cfg, spec, length=length)


def vocoder_halo_frames(cfg: VocoderConfig) -> int:
    """Mel frames of one-sided context for exact chunked backbone output
    (each ConvNeXt block's depthwise k=7 conv adds 3 frames per side)."""
    return 3 * cfg.layers
