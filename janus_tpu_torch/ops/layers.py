"""Functional NN primitives with the JAX package's layouts and numerics:
fp32 accumulation, layer norm in fp32, exact-erf GELU, NWC/WIO convs."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from janus_tpu_torch.ops.quant import (DynQuantizedWeight, QuantizedWeight,
                                       dequant, linear_int8_dynamic)
from janus_tpu_torch.parallel.collectives import exit_model, model_size

__all__ = [
    "linear",
    "row_linear",
    "layer_norm",
    "gelu",
    "conv1d",
    "embedding_lookup",
    "sinusoid_positions",
]


def linear(x: torch.Tensor, w,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[..., d_in] @ w[d_in, d_out] (+ b)``, result in ``x.dtype``.

    ``w`` may be a :class:`~janus_tpu_torch.ops.quant.DynQuantizedWeight`
    (the full int8 path) or a :class:`~janus_tpu_torch.ops.quant.
    QuantizedWeight` (dequantized to ``x.dtype``, then the plain product),
    as the JAX package's ``linear`` dispatches them."""
    if isinstance(w, DynQuantizedWeight):
        return linear_int8_dynamic(x, w, b)
    if isinstance(w, QuantizedWeight):
        w = dequant(w, x.dtype)
    if w.dtype != x.dtype:
        # Mixed dtypes, as when the receive side feeds its fp32 mel buffer
        # through bf16 parameters: the JAX package promotes both operands
        # for the product, adds the bias in fp32 and returns ``x.dtype``
        # (the activations' dtype wins, never the weights').
        ct = torch.promote_types(x.dtype, w.dtype)
        x2 = x.reshape(-1, x.shape[-1]).to(ct)
        y = (torch.matmul(x2, w.to(ct)) if b is None
             else torch.addmm(b.to(ct), x2, w.to(ct)))
        return y.to(x.dtype).reshape(tuple(x.shape[:-1]) + (w.shape[-1],))
    if b is None:
        return torch.matmul(x, w)
    # Cast-back point: the JAX package keeps the product in fp32, adds the
    # bias in fp32 and rounds once. ``addmm`` does the same: cuBLAS(Lt)
    # adds the bias in its fp32 accumulator (bias epilogue, or beta = 1 on
    # a bias-filled output) and rounds to ``x.dtype`` once. Parameters are
    # cast to the compute dtype, so ``b.to(x.dtype)`` loses nothing.
    y = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return y.reshape(tuple(x.shape[:-1]) + (w.shape[-1],))


def row_linear(x: torch.Tensor, w,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`linear` whose ``w`` is split by rows over the ``model``
    dimension of the current mesh (row parallel, see
    :func:`~janus_tpu_torch.parallel.collectives.use_mesh`): the partial
    products are summed over it, then the bias, which every rank holds
    whole, is added once, in fp32. Without tensor parallelism, exactly
    :func:`linear`."""
    if model_size() == 1:
        return linear(x, w, b)
    y = exit_model(linear(x, w))
    return y if b is None else (y.float() + b.float()).to(y.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    ct = torch.promote_types(x.dtype, torch.float32)  # fp32, or fp64
    xf = x.to(ct)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.to(ct) + bias.to(ct)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """1-D convolution over ``x[..., T, C_in]`` (NWC) with ``w[K, C_in,
    C_out]`` (WIO), batched over any leading axes."""
    lead = x.shape[:-2]
    xb = x.reshape((-1,) + tuple(x.shape[-2:])).transpose(1, 2)
    y = F.conv1d(xb, w.permute(2, 1, 0), None, stride=stride, padding=padding)
    y = y.transpose(1, 2)
    if b is not None:
        # cuDNN hands back the product already rounded to a bf16 input's
        # dtype, so under bf16 the stem rounds twice (product, then
        # product + bias): one bf16 ulp apart at most; fp32 is identical
        y = (y.float() + b.float()).to(x.dtype)
    return y.reshape(tuple(lead) + tuple(y.shape[-2:]))


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def sinusoid_positions(length: int, channels: int,
                       max_timescale: float = 10_000.0,
                       device="cpu") -> torch.Tensor:
    """Whisper-style sinusoidal position embedding ``[length, channels]``:
    first half sin, second half cos, log-spaced timescales (float64 numpy,
    cast to float32)."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    emb = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)
