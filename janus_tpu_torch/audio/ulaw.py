"""Continuous-curve μ-law (μ = 255) companding for the host→device audio
wire (``RuntimeConfig.encode_transfer_ulaw``): one byte per sample, half
the int16 wire, at ~35-38 dB quantization SNR for speech-level signals.
Opt-in, since it is not bit-exact. The host encodes in numpy; the device
decodes in torch.

The port of ``janus_tpu/audio/ulaw.py``.
"""

from __future__ import annotations

import numpy as np
import torch

_MU = 255.0

__all__ = ["ulaw_encode", "ulaw_decode"]


def ulaw_encode(x: np.ndarray) -> np.ndarray:
    """float32 waveform in [-1, 1] → uint8 codes (host side, numpy)."""
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


def ulaw_decode(q: torch.Tensor) -> torch.Tensor:
    """uint8 codes → float32 waveform (on ``q``'s device). The divisors
    are tensors: CUDA divides by a Python scalar as a product with its
    reciprocal, which can miss the CPU's IEEE quotient by an ulp."""
    half, mu = (torch.full((), c, device=q.device) for c in (127.5, _MU))
    y = q.float() / half - 1.0
    return torch.sign(y) * ((1.0 + _MU) ** y.abs() - 1.0) / mu
