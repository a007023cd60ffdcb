"""Fused attention: the CUDA kernels of ``csrc/flash_attn.cu`` (K2, forward).

Replaces ``janus_tpu/ops/flash.py:_kernel`` (``_flash_bh`` /
``flash_attention``): QKᵀ·Dh^-½, key-padding (and optional causal) mask,
fp32 softmax, probabilities cast to ``v.dtype`` before PV. Bound on the
H100: ~0.012 ms per large-v3 encoder layer (41 MB of bf16 q, k, v, o;
its 10 GFLOP take ~0.010 ms at the bf16 tensor-core rate).

Two kernels, picked by :func:`flash_route` from ``(dtype, head_dim)``:

- ``"wgmma"``: bf16 at Dh 64, the large-v3 encoder. Both products on the
  tensor cores (``wgmma``, fp32 accumulators), K/V tiles staged by
  ``cp.async`` while the previous tile is multiplied, P kept in registers.
- ``"simt"``: fp32 at any supported Dh, and Dh 32. The demo checkpoint
  runs fp32 at Dh 32 and its packets must stay byte-equal between the card
  and the CPU; TF32 tensor cores would cost about three decimal digits
  there, so those shapes stay on the fp32 pipes.

:func:`flash_attention` is differentiable through an
``autograd.Function`` whose backward is the exact plain-PyTorch attention
gradient, the counterpart of the JAX package's ``_flash_bwd`` (the
backward kernel comes with training). On a CPU tensor the forward is the
plain version (:func:`attend_bh`); on a CUDA tensor it launches a kernel
or raises. A custom boolean mask goes to :func:`attend`, as the reference
dispatches it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from janus_tpu_torch.ops import cuda_build
from janus_tpu_torch.ops.attention import attend, causal_mask

__all__ = ["flash_attention", "flash_forward", "flash_route", "attend_bh",
           "KERNEL"]

KERNEL = cuda_build.KERNELS["flash_attn"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)  # the demo and large-v3
ROUTES = ("wgmma", "simt")
# flash_attn_fwd(q, k, v, o, bh, tq, tk, head_dim, dtype, causal, stream)
_SIMT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p])
# flash_attn_fwd_wgmma(q, k, v, o, bh, tq, tk, head_dim, causal, stream)
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])


def attend_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    """Plain version over ``[BH, T, Dh]`` (one head per row)."""
    mask = (causal_mask(q.shape[1], k.shape[1], device=q.device)
            if causal else None)
    return attend(q[:, None], k[:, None], v[:, None], mask)[:, 0]


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel takes ``(dtype, head_dim)``: ``"wgmma"`` for bf16 at
    Dh 64, ``"simt"`` for fp32 and for Dh 32; anything else raises."""
    if dtype not in _DTYPES:
        raise TypeError("flash kernel takes float32 or bfloat16 q/k/v, got "
                        f"{dtype}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of {_HEAD_DIMS},"
                         f" got {head_dim}")
    if dtype == torch.bfloat16 and head_dim == 64:
        return "wgmma"
    return "simt"


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' 16-byte copies need
    (a copy only where the tensor is not already so)."""
    if not x.is_contiguous():
        return x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False,
                  route: Optional[str] = None) -> torch.Tensor:
    """``[BH, Tq, Dh] x [BH, Tk, Dh]`` attention forward. ``route`` forces
    a kernel (``"simt"`` takes every supported input; it is how the two
    kernels are timed on the same tensors); by default
    :func:`flash_route` picks."""
    if q.device.type == "cpu":
        return attend_bh(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward: unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash kernel takes q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    bh, tq, dh = q.shape
    tk = k.shape[1]
    picked = flash_route(q.dtype, dh)
    if route is None:
        route = picked
    elif route not in ROUTES or (route == "wgmma" and picked != "wgmma"):
        raise ValueError(f"flash route {route!r} does not take {q.dtype} at "
                         f"head_dim {dh}")
    if k.shape != (bh, tk, dh) or v.shape != (bh, tk, dh):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # QK^T and PV; causal: the lower triangle with its diagonal
    flops = 4.0 * bh * dh * (tq * (tq + 1) / 2 if causal else tq * tk)
    nbytes = 2 * (tq + tk) * bh * dh * q.element_size()
    if route == "wgmma":
        fn = cuda_build.entry(KERNEL, "flash_attn_fwd_wgmma", _WGMMA_ARGTYPES)
        KERNEL.launched(flops, nbytes)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  bh, tq, tk, dh, int(causal), stream)
    else:
        fn = cuda_build.entry(KERNEL, "flash_attn_fwd", _SIMT_ARGTYPES)
        KERNEL.launched(flops, nbytes)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  bh, tq, tk, dh, _DTYPES[q.dtype], int(causal), stream)
    cuda_build.check_launch(KERNEL, code)
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            ref = attend_bh(qq, kk, vv, ctx.causal)
            dq, dk, dv = torch.autograd.grad(ref, (qq, kk, vv), g)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for :func:`attend` on ``[..., H, T, Dh]`` tensors."""
    if mask is not None:
        return attend(q, k, v, mask)
    *lead, h, t, dh = q.shape
    qf = q.reshape(-1, t, dh)
    kf = k.reshape(-1, k.shape[-2], dh)
    vf = v.reshape(-1, v.shape[-2], dh)
    out = _FlashAttention.apply(qf, kf, vf, causal)
    return out.reshape(*lead, h, t, dh)
