"""Int8 quantization for inference: int8 recognizer weights and int8
cross-attention K/V.

The port of ``janus_tpu/ops/quant.py``. The reference application ran its
recognizer int8 through CTranslate2 (``compute_type='int8'``); the same
deployment here is :func:`quantize_tree` over the recognizer's tree plus
``asr.decode_cross_kv_int8`` for the decode loop's cross K/V.

- :class:`QuantizedWeight`: per-output-channel symmetric int8 weights and
  fp32 scales; :func:`janus_tpu_torch.ops.layers.linear` dequantizes them
  and runs the ordinary product (weight-only mode).
- :class:`DynQuantizedWeight`: the same storage, routed by ``linear`` to
  :func:`linear_int8_dynamic` (per-row dynamic activation scales, int8 x
  int8 -> int32, fp32 rescale): the plain version on the CPU, the kernel of
  :mod:`janus_tpu_torch.ops.int8_linear` on the card, which reads the
  weight K-contiguous (:func:`column_major`, once for a tree). The type is
  the dispatch tag.
- :class:`QuantKV` / :class:`QuantKVT`: int8 K or V with per-position
  scales, token-major or head-dim-major (the layout of the K4 kernel,
  :mod:`janus_tpu_torch.ops.cross_attn`).

Every quantizer computes in its input's dtype, as the JAX package does: a
bf16 weight takes its ``amax``, ``scale`` and ``w / scale`` in bf16 and
only then casts ``scale`` to fp32, so quantizing before or after a bf16
cast gives different int8 values. ``torch.round`` and ``jnp.round`` both
round half to even.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from janus_tpu_torch.ops.int8_linear import (_round_int8, _scale_of,
                                             int8_linear, int8_linear_plain)

__all__ = [
    "QuantizedWeight",
    "DynQuantizedWeight",
    "QuantKV",
    "QuantKVT",
    "quantize_weight",
    "quantize_kv",
    "quantize_kv_t",
    "dequant",
    "dequant_kv",
    "linear_int8_dynamic",
    "quantize_tree",
    "column_major",
]


class QuantizedWeight(NamedTuple):
    """``q[d_in, d_out]`` int8 with per-output-channel ``scale[d_out]``;
    weight-only mode (dequantized inside ``linear``)."""

    q: torch.Tensor
    scale: torch.Tensor


class DynQuantizedWeight(NamedTuple):
    """Storage of :class:`QuantizedWeight`, tagged for the full int8 path
    (:func:`linear_int8_dynamic`)."""

    q: torch.Tensor
    scale: torch.Tensor


class QuantKV(NamedTuple):
    """int8 K or V ``q[..., T, Dh]`` with per-position fp32
    ``scale[..., T, 1]``."""

    q: torch.Tensor
    scale: torch.Tensor


class QuantKVT(NamedTuple):
    """int8 K or V stored head-dim-major, ``q[..., Dh, T]``, with
    per-position fp32 ``scale[..., T]``: the K4 kernel's layout, built once
    at decode-state init. :func:`quantize_kv_t` gives ``q`` as the first
    ``T`` columns of rows padded to a multiple of 16 bytes, so that every
    row starts 16-byte aligned for the kernel's vector loads; shapes and
    values are those of the dense layout."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize_kv(x: torch.Tensor) -> QuantKV:
    """Symmetric per-position int8 quantization over the head dim."""
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=-1, keepdim=True))
    return QuantKV(q=_round_int8(xf / scale), scale=scale)


_ROW_ALIGN = 16  # bytes: the K4 kernel's widest load


def empty_kv_t(lead: tuple, t: int, dh: int, device) -> QuantKVT:
    """A zeroed :class:`QuantKVT` for ``[*lead, T, Dh]``: ``q[*lead, Dh,
    T]`` whose rows are stored ``_ROW_ALIGN``-byte aligned (zero padding
    past ``T``, outside the view), ``scale[*lead, T]`` fp32."""
    rows = torch.zeros(tuple(lead) + (dh, -(-t // _ROW_ALIGN) * _ROW_ALIGN),
                       dtype=torch.int8, device=device)
    scale = torch.zeros(tuple(lead) + (t,), dtype=torch.float32,
                        device=device)
    return QuantKVT(q=rows[..., :t], scale=scale)


def quantize_kv_t(x: torch.Tensor,
                  out: Optional[QuantKVT] = None) -> QuantKVT:
    """Per-position int8 quantization of ``[..., T, Dh]`` into the
    head-dim-major layout of :func:`empty_kv_t`, written into ``out`` (a
    decode loop's static buffers) or into a new one."""
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=-1))
    q = _round_int8(xf / scale[..., None])
    if out is None:
        out = empty_kv_t(q.shape[:-2], *q.shape[-2:], device=q.device)
    out.q.copy_(q.transpose(-1, -2))
    out.scale.copy_(scale)
    return out


def dequant_kv(x, dtype=torch.bfloat16):
    """QuantKV / QuantKVT -> dense ``[..., T, Dh]`` in ``dtype``; a dense
    tensor passes through unchanged."""
    if isinstance(x, QuantKV):
        return (x.q.float() * x.scale).to(dtype)
    if isinstance(x, QuantKVT):
        dense = x.q.float() * x.scale[..., None, :]
        return dense.transpose(-1, -2).to(dtype)
    return x


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """Symmetric per-output-channel int8 quantization of ``[d_in, d_out]``,
    computed in ``w``'s dtype."""
    scale = _scale_of(w.abs().amax(dim=0))
    return QuantizedWeight(q=_round_int8(w / scale), scale=scale.float())


def dequant(qw, dtype=torch.float32) -> torch.Tensor:
    return (qw.q.float() * qw.scale).to(dtype)


def linear_int8_dynamic(x: torch.Tensor, qw,
                        b: Optional[torch.Tensor] = None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full int8 path: per-row dynamic activation quantization, int8 x
    int8 -> int32 (exact), then ``acc * x_scale * w_scale`` and the bias
    in fp32 and one cast to ``x.dtype``, in the JAX package's order. ``qw``
    is any ``(q, scale)`` pair. A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (its weight K-contiguous, see
    :func:`column_major`) or raises. ``out`` (contiguous, of the result's
    shape and dtype) takes the result: the kernel writes it there."""
    if x.device.type == "cpu":
        y = int8_linear_plain(x, qw, b)
        return y if out is None else out.copy_(y)
    return int8_linear(x, qw, b, out=out)


def quantize_tree(params: Any, min_size: int = 4096,
                  mode: str = "weight") -> Any:
    """Replace every 2-D floating weight leaf named ``.../w`` with at least
    ``min_size`` elements by a quantized pair (embeddings, norms, biases
    and convs untouched). ``mode='weight'`` gives :class:`QuantizedWeight`,
    ``mode='dynamic'`` :class:`DynQuantizedWeight`."""
    from janus_tpu_torch.models.params import map_with_paths

    if mode not in ("weight", "dynamic"):
        raise ValueError(f"unknown quantization mode: {mode!r}")
    cls = QuantizedWeight if mode == "weight" else DynQuantizedWeight

    def maybe_quant(path: str, leaf):
        if (path.endswith("/w") and isinstance(leaf, torch.Tensor)
                and leaf.ndim == 2 and leaf.is_floating_point()
                and leaf.numel() >= min_size):
            return cls(*quantize_weight(leaf))
        return leaf

    return map_with_paths(maybe_quant, params)


def column_major(params: Any) -> Any:
    """Every :class:`DynQuantizedWeight` of the tree with ``q[K, N]`` stored
    K-contiguous, as the int8 kernel reads it: the transposed view of a
    ``[N, K]`` copy (strides ``(1, K)``), made once. Shapes, values, types
    and every other leaf are unchanged; a weight already K-contiguous is
    kept as it is, and the caller's tree is not modified. Run it after
    :func:`janus_tpu_torch.models.params.prepare_decode_params` (its
    concatenation of q/k/v is row-major)."""
    if isinstance(params, DynQuantizedWeight):
        q = params.q
        if q.t().is_contiguous():
            return params
        return DynQuantizedWeight(q.t().contiguous().t(), params.scale)
    if isinstance(params, dict):
        return {k: column_major(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)) and not hasattr(params, "_fields"):
        return type(params)(column_major(v) for v in params)
    return params  # a tensor, or another NamedTuple, kept as it is
