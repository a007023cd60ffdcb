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

On a CPU tensor :func:`cross_attention_int8` computes the plain version;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from janus_tpu_torch.ops import cuda_build
from janus_tpu_torch.ops.attention import attend
from janus_tpu_torch.ops.quant import QuantKV, QuantKVT, dequant_kv

__all__ = ["cross_attention_kv", "cross_attention_int8",
           "cross_attention_int8_plain", "KERNEL"]

KERNEL = cuda_build.KERNELS["cross_attn_int8"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def cross_attention_int8(q: torch.Tensor, k: QuantKVT,
                         v: QuantKVT) -> torch.Tensor:
    """K4: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if q.device.type == "cpu":
        return cross_attention_int8_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"cross_attention_int8: unsupported device "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"cross_attn_int8 takes float32 or bfloat16 q, got "
                        f"{q.dtype}")
    *lead, h, tq, dh = q.shape
    t = k.q.shape[-1]
    for name, x in (("k", k), ("v", v)):
        if x.q.dtype != torch.int8 or x.scale.dtype != torch.float32:
            raise TypeError(f"{name}: int8 q with float32 scales expected, "
                            f"got {x.q.dtype}, {x.scale.dtype}")
        if (tuple(x.q.shape) != (*lead, h, dh, t)
                or tuple(x.scale.shape) != (*lead, h, t)):
            raise ValueError(f"{name} shapes {tuple(x.q.shape)}, "
                             f"{tuple(x.scale.shape)} do not match q "
                             f"{tuple(q.shape)} and T {t}")
        if x.q.device != q.device or x.scale.device != q.device:
            raise ValueError(f"{name} is not on {q.device}")
    bh = q.numel() // (tq * dh)
    qc = q.contiguous()
    kq, ks, vq, vs = (x.contiguous() for x in (k.q, k.scale, v.q, v.scale))
    out = torch.empty_like(qc)
    fn = cuda_build.library(KERNEL).cross_attn_int8
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    KERNEL.launches += 1
    code = fn(qc.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
              vs.data_ptr(), out.data_ptr(), bh, tq, t, dh, _DTYPES[q.dtype],
              dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch(KERNEL, code)
    return out


def cross_attention_kv(q: torch.Tensor, k, v) -> torch.Tensor:
    """Cross-attention ``[..., H, tq, Dh]`` over dense ``[..., H, T, Dh]``
    K/V (:func:`attend`), :class:`QuantKV` (``attend`` over the K/V
    dequantized to ``q.dtype``) or :class:`QuantKVT` (K4), as the JAX
    package dispatches them."""
    if isinstance(k, QuantKVT):
        return cross_attention_int8(q, k, v)
    if isinstance(k, QuantKV):
        return attend(q, dequant_kv(k, q.dtype), dequant_kv(v, q.dtype))
    return attend(q, k, v)
