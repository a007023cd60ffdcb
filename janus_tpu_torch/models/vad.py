"""Voice activity detection: the send path's gate.

Two backends behind one interface, as in the JAX package:

- ``energy``: a deterministic adaptive-noise-floor gate, no weights (the
  default runtime gate);
- ``model``: a small MLP over 64 log band energies of the chunk's
  spectrum, for deployments with a learned gate. Weights in the JAX
  package's layout (``fc1``, ``fc2``, ``out``); the JAX package's
  ``init_vad`` weights come across with
  :func:`~janus_tpu_torch.models.params.params_from_jax`.

:class:`VoiceActivityDetector` scores one 48 kHz chunk at a time on its
device: decimation to 16 kHz, then the gate. The energy gate's noise
floor is a 0-dim fp32 tensor on that device, updated in fp32 exactly as
the JAX package updates its ``jnp`` scalar (a Python float would update
in float64 and drift from it over a long stream). One host read a chunk:
the probability.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from janus_tpu_torch.common.config import VADConfig
from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.models.params import tree_to
from janus_tpu_torch.ops.layers import gelu, linear
from janus_tpu_torch.ops.resample import decimate_48k_to_16k

__all__ = ["init_vad", "vad_model_prob", "energy_gate_prob",
           "VoiceActivityDetector"]

Params = Dict

_N_BANDS = 64
_HIDDEN = 64


def _spectral_features(chunk_16k: torch.Tensor) -> torch.Tensor:
    """Log band-energy features ``[..., n_bands]`` from ``[..., T]`` audio:
    the rfft magnitude, adjacent bins averaged into 64 bands."""
    spec = torch.fft.rfft(chunk_16k.float(), dim=-1).abs()
    n_freqs = spec.shape[-1]
    usable = (n_freqs // _N_BANDS) * _N_BANDS
    bands = spec[..., :usable].reshape(
        tuple(spec.shape[:-1]) + (_N_BANDS, -1)).mean(-1)
    return torch.log1p(bands * 100.0)


def init_vad(generator: torch.Generator,
             cfg: Optional[VADConfig] = None) -> Params:
    """Seeded weights of the JAX package's shapes (normal, scale 0.1; zero
    biases) on the generator's device. The JAX package's own ``init_vad``
    draws from JAX's generator, which no torch seed reproduces: carry its
    weights across with ``params_from_jax`` to match it."""
    def normal(shape):
        return 0.1 * torch.randn(shape, generator=generator,
                                 device=generator.device)

    def zeros(n):
        return torch.zeros((n,), device=generator.device)

    return {
        "fc1": {"w": normal((_N_BANDS, _HIDDEN)), "b": zeros(_HIDDEN)},
        "fc2": {"w": normal((_HIDDEN, _HIDDEN)), "b": zeros(_HIDDEN)},
        "out": {"w": normal((_HIDDEN, 1)), "b": zeros(1)},
    }


def vad_model_prob(params: Params, chunk_16k: torch.Tensor) -> torch.Tensor:
    """Speech probability ``[...]`` for 16 kHz chunk(s) ``[..., T]``."""
    f = _spectral_features(chunk_16k)
    h = gelu(linear(f, params["fc1"]["w"], params["fc1"]["b"]))
    h = gelu(linear(h, params["fc2"]["w"], params["fc2"]["b"]))
    logit = linear(h, params["out"]["w"], params["out"]["b"])[..., 0]
    return torch.sigmoid(logit)


def energy_gate_prob(chunk_16k: torch.Tensor, noise_floor: torch.Tensor,
                     gate_rms: float = 0.015
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic gate: probability from the margin between the chunk's
    RMS and an exponentially tracked noise floor. Returns
    ``(prob, new_floor)``, both fp32.

    The floor falls fast (silence) and rises slowly, so steady background
    noise is rejected while speech onsets pass; the (0, 1) probability
    keeps the 0.5-threshold contract."""
    x = chunk_16k.float()
    rms = torch.sqrt(torch.mean(x * x, dim=-1))
    new_floor = torch.where(
        rms < noise_floor,
        0.5 * noise_floor + 0.5 * rms,     # fall fast
        0.99 * noise_floor + 0.01 * rms,   # rise slowly
    )
    threshold = torch.clamp_min(3.0 * new_floor, gate_rms)
    prob = torch.sigmoid(8.0 * (rms / torch.clamp_min(threshold, 1e-6) - 1.0))
    return prob, new_floor


class VoiceActivityDetector:
    """``is_speech(chunk) -> bool`` on 48 kHz float32 chunks, thresholded
    at ``cfg.threshold``. Without ``params`` the energy gate runs whatever
    ``cfg.backend`` says; with them, the model. ``reset`` restores the
    energy gate's noise floor."""

    def __init__(self, cfg: Optional[VADConfig] = None,
                 params: Optional[Params] = None,
                 sample_rate: int = 48_000, device="cuda") -> None:
        self.device = resolve_device(device)
        self.cfg = cfg or VADConfig()
        self.sample_rate = sample_rate
        self.params = None if params is None else tree_to(params, self.device)
        backend = self.cfg.backend if params is None else "model"
        if params is None and backend == "model":
            backend = "energy"  # no weights -> deterministic gate
        self.backend = backend
        self.reset()

    @torch.no_grad()
    def _prob(self, chunk: torch.Tensor) -> torch.Tensor:
        chunk16 = (decimate_48k_to_16k(chunk) if self.sample_rate == 48_000
                   else chunk)
        if self.backend == "model":
            return vad_model_prob(self.params, chunk16)
        prob, self._floor = energy_gate_prob(chunk16, self._floor,
                                             self.cfg.energy_gate_rms)
        return prob

    def speech_prob(self, chunk: np.ndarray) -> float:
        x = torch.from_numpy(np.ascontiguousarray(chunk, dtype=np.float32))
        return float(self._prob(x.to(self.device)))

    def is_speech(self, chunk: np.ndarray) -> bool:
        return self.speech_prob(chunk) > self.cfg.threshold

    def reset(self) -> None:
        self._floor = torch.tensor(1e-3, dtype=torch.float32,
                                   device=self.device)
