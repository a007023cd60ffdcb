"""Decode cross-attention over int8 K/V: the CUDA kernel
``csrc/cross_attn_int8.cu`` (K4).

Replaces ``janus_tpu/ops/cross_attn.py:_kernel`` (``_cross_bh`` /
``cross_attention_kv``). K and V are :class:`~janus_tpu_torch.ops.quant.
QuantKVT` (int8 ``[..., H, Dh, T]``, fp32 ``scale[..., H, T]``), built once
at decode-state init; the decode loop re-reads them every token, and the
kernel reads them as int8 (10.9 MB per large-v3 layer and step with the
scales, against 20.5 MB of dense bf16), folding the K scales into the
score columns and the V scales into the probability columns.

:func:`cross_attention_int8_plain` is the Pallas kernel's own math in
PyTorch: fp32 ``q`` against int8 ``K``, scores times ``Dh^-1/2`` then
times the K scale, a max-subtracted ``exp``, ``p * v_scale`` against int8
``V``, divided by ``max(l, 1e-30)`` and cast to ``q.dtype``. It is not the
JAX package's route off the TPU (``attend`` over ``dequant_kv(·,
q.dtype)``), which rounds the dequantized K/V and ``p`` to ``q.dtype``
and so differs from the kernel in bf16; the two agree in fp32 up to the
order of the sums, which is where the tests compare the packages.

The kernel splits T over a cluster of blocks (:func:`plan_splits`) and
reads K/V with the widest load their alignment allows (:func:`load_bytes`:
16 bytes over the padded rows :func:`~janus_tpu_torch.ops.quant.
quantize_kv_t` allocates, else 4, else 1).

On a CPU tensor :func:`cross_attention_int8` computes the plain version;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from janus_tpu_torch.ops import cuda_build
from janus_tpu_torch.ops.attention import attend
from janus_tpu_torch.ops.decode_attention import decode_attention
from janus_tpu_torch.ops.quant import QuantKV, QuantKVT, dequant_kv

__all__ = ["cross_attention_kv", "cross_attention_int8",
           "cross_attention_int8_plain", "plan_splits", "load_bytes",
           "KERNEL"]

KERNEL = cuda_build.KERNELS["cross_attn_int8"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
TILE = 128       # positions a block takes at a time
MAX_SPLITS = 4   # blocks per (batch, head): clusters of 8 schedule worse
# cross_attn_int8(q, kq, ks, vq, vs, out, bh, tq, t_len, dh, dtype, scale,
#                 k_row, v_row, splits, vec, stream)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


def cross_attention_int8_plain(q: torch.Tensor, k: QuantKVT,
                               v: QuantKVT) -> torch.Tensor:
    """``q[..., H, tq, Dh]`` over int8 K/V → ``[..., H, tq, Dh]`` in
    ``q.dtype``, in the Pallas kernel's arithmetic."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.q.float()) * scale      # [..., H, tq, T]
    s = s * k.scale[..., None, :].float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p * v.scale[..., None, :].float(),
                     v.q.float().transpose(-1, -2))
    return (o / torch.clamp_min(l, 1e-30)).to(q.dtype)


def plan_splits(t: int) -> int:
    """Blocks that share one (batch, head): the largest power of two that
    is at most :data:`MAX_SPLITS` and at most the number of
    :data:`TILE`-position tiles, so every block has a tile to read (4 at
    T 500, one tile each, and at T 1500, three tiles each)."""
    tiles = -(-t // TILE)
    splits = 1
    while splits * 2 <= min(MAX_SPLITS, tiles):
        splits *= 2
    return splits


def load_bytes(*alignments: int) -> int:
    """Widest load (16, 4 or 1 bytes) that every pointer and row stride in
    ``alignments`` is a multiple of."""
    for width in (16, 4):
        if all(a % width == 0 for a in alignments):
            return width
    return 1


def _rows(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """int8 ``[..., Dh, T]`` as the kernel takes it: rows of unit stride, one
    stride between all consecutive rows. Returns the tensor (a dense copy
    only if it is laid out otherwise) and the row stride in bytes."""
    shape, stride = x.shape, x.stride()
    t, row = shape[-1], stride[-2]
    if x.is_contiguous():
        return x, t
    ok = shape[-2] > 1 and row >= t and (stride[-1] == 1 or t == 1)
    want = row * shape[-2]
    for i in range(len(shape) - 3, -1, -1):
        ok = ok and (shape[i] == 1 or stride[i] == want)
        want *= shape[i]
    if ok:
        return x, row
    return x.contiguous(), t


def cross_attention_int8(q: torch.Tensor, k: QuantKVT,
                         v: QuantKVT) -> torch.Tensor:
    """K4: the plain version for a CPU tensor, the kernel for a CUDA one."""
    dev = q.device
    if dev.type == "cpu":
        return cross_attention_int8_plain(q, k, v)
    if dev.type != "cuda":
        raise ValueError(f"cross_attention_int8: unsupported device {dev}")
    dtype = _DTYPES.get(q.dtype)
    if dtype is None:
        raise TypeError(f"cross_attn_int8 takes float32 or bfloat16 q, got "
                        f"{q.dtype}")
    shape = q.shape
    tq, dh = shape[-2], shape[-1]
    if dh not in _HEAD_DIMS:
        raise ValueError(f"cross_attn_int8 head_dim must be one of "
                         f"{_HEAD_DIMS}, got {dh}")
    kq, ks, vq, vs = k.q, k.scale, v.q, v.scale
    t = kq.shape[-1]
    q_shape, s_shape = shape[:-2] + (dh, t), shape[:-2] + (t,)
    if (kq.shape != q_shape or vq.shape != q_shape or ks.shape != s_shape
            or vs.shape != s_shape):
        raise ValueError(f"k/v shapes {tuple(kq.shape)}, {tuple(ks.shape)}, "
                         f"{tuple(vq.shape)}, {tuple(vs.shape)} do not match "
                         f"q {tuple(shape)} and T {t}")
    if (kq.dtype != torch.int8 or vq.dtype != torch.int8
            or ks.dtype != torch.float32 or vs.dtype != torch.float32):
        raise TypeError("k/v: int8 q with float32 scales expected, got "
                        f"{kq.dtype}, {ks.dtype}, {vq.dtype}, {vs.dtype}")
    if not (kq.device == ks.device == vq.device == vs.device == dev):
        raise ValueError(f"k/v are not on {dev}")
    if not q.is_contiguous():
        q = q.contiguous()
    (kq, k_row), (vq, v_row) = _rows(kq), _rows(vq)
    if not ks.is_contiguous():
        ks = ks.contiguous()
    if not vs.is_contiguous():
        vs = vs.contiguous()
    k_ptr, v_ptr = kq.data_ptr(), vq.data_ptr()
    out = torch.empty_like(q)
    fn = cuda_build.entry(KERNEL, "cross_attn_int8", _ARGTYPES)
    # QK^T and PV (4 T Dh a query row) plus the score scaling, max, exp,
    # sum and V-scale fold (~6 a score)
    KERNEL.launched(q.numel() // dh * (4.0 * t * dh + 6.0 * t),
                    2 * q.numel() * q.element_size() + kq.numel() + vq.numel()
                    + 4 * (ks.numel() + vs.numel()))
    code = fn(q.data_ptr(), k_ptr, ks.data_ptr(), v_ptr, vs.data_ptr(),
              out.data_ptr(), q.numel() // (tq * dh), tq, t, dh, dtype,
              dh ** -0.5, k_row, v_row, plan_splits(t),
              load_bytes(k_ptr, v_ptr, k_row, v_row),
              torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(KERNEL, code)
    return out


def cross_attention_kv(q: torch.Tensor, k, v) -> torch.Tensor:
    """Cross-attention ``[..., H, tq, Dh]`` over dense ``[..., H, T, Dh]``
    K/V (:func:`attend`'s arithmetic, through
    :func:`~janus_tpu_torch.ops.decode_attention.decode_attention`: its
    kernel at decode widths on the card), :class:`QuantKV` (``attend`` over
    the K/V dequantized to ``q.dtype``) or :class:`QuantKVT` (K4), as the
    JAX package dispatches them."""
    if isinstance(k, QuantKVT):
        return cross_attention_int8(q, k, v)
    if isinstance(k, QuantKV):
        return attend(q, dequant_kv(k, q.dtype), dequant_kv(v, q.dtype))
    return decode_attention(q, k, v)
