"""The controls' lower precisions: a weight matrix rounded with one
symmetric scale per output channel (its last axis) to int8 or to fp8
(e4m3, the H100's 8-bit float), then widened again. A reference run
through one stands in for a program that computes in the nearest
precision below the configuration's bfloat16."""

from __future__ import annotations

import torch

__all__ = ["int8_weight", "fp8_weight"]


def _scale(w: torch.Tensor, top: float) -> torch.Tensor:
    dims = tuple(range(w.dim() - 1))
    return w.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / top


def int8_weight(w: torch.Tensor) -> torch.Tensor:
    s = _scale(w, 127.0)
    return torch.clamp(torch.round(w / s), -127, 127) * s


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    s = _scale(w, 448.0)
    return (w / s).to(torch.float8_e4m3fn).to(w.dtype) * s
