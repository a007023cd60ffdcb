"""Speaker encoder for voice cloning.

The reference clones voices by shipping raw reference-audio bytes to the
cloud TTS (reference: backend/services/synthesizer.py:183-200). Here the
reference audio is embedded locally: log-mel statistics (mean ‖ std over
time) are projected to a d-dimensional speaker vector consumed by the TTS
[SPK] slot. Deterministic pooling means hot-reloading a new reference file
(reference: synthesizer.py:90-104) just recomputes one embedding.
"""

from __future__ import annotations

from typing import Dict

import torch

from janus_tpu_torch.models.params import _normal, _zeros
from janus_tpu_torch.ops.layers import gelu, linear
from janus_tpu_torch.ops.mel import log_mel_spectrogram

__all__ = ["init_speaker_encoder", "speaker_embed"]

Params = Dict


def init_speaker_encoder(generator: torch.Generator, n_mels: int = 80,
                         d_out: int = 512) -> Params:
    g = generator
    return {
        "fc1": {"w": _normal(g, (2 * n_mels, d_out)), "b": _zeros(g, d_out)},
        "fc2": {"w": _normal(g, (d_out, d_out)), "b": _zeros(g, d_out)},
    }


def speaker_embed(params: Params, audio_16k: torch.Tensor,
                  n_mels: int = 80) -> torch.Tensor:
    """``audio_16k[..., T] -> speaker vector [..., d_out]`` (L2-normalized).
    The log-mel is the plain FFT-path one, as in the JAX package."""
    mel = log_mel_spectrogram(audio_16k, n_mels=n_mels)
    # the population deviation (jnp.std's default), not torch's sample one
    stats = torch.cat([mel.mean(dim=-2), mel.std(dim=-2, correction=0)],
                      dim=-1)
    h = gelu(linear(stats, params["fc1"]["w"], params["fc1"]["b"]))
    v = linear(h, params["fc2"]["w"], params["fc2"]["b"])
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-6)
