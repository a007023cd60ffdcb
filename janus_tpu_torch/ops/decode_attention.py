"""Dense attention at decode widths: the CUDA kernel ``csrc/decode_attn.cu``.

The port's own kernel (the JAX package's ``attend``, ``janus_tpu/ops/
attention.py:43``, is compiled by XLA on the TPU; no Pallas kernel). It
takes the decode loops' attention: the recognizer's self-attention over
its KV cache and its dense cross-attention (the step and the prompt
prefill, 1 or 4 query rows), and the TTS AR step's self-attention (fp32
queries over a bf16 cache). :func:`attend` widens the whole cache to fp32
in memory on every call; the kernel reads it once in its own dtype.

Semantics: exactly :func:`~janus_tpu_torch.ops.attention.attend` with the
caches' mask (:func:`~janus_tpu_torch.ops.attention.fill_mask`: key j is
seen by query row i iff ``j <= pos + i``, ``pos`` the fill point before the
step's write) or with
no mask: fp32 logits times ``Dh^-1/2``, the row max, ``exp``, the sum and
the normalisation, the probabilities rounded to ``v.dtype`` after the
normalisation, the PV product accumulated in fp32, the output rounded to
``q.dtype``. ``pos`` may be a 0-dim int64 tensor on the device (read there
by the kernel, so a captured step needs no host read) or a host int.

:func:`decode_route` picks, from what a call can see on the host:
``"kernel"`` on a CUDA device with no gradient asked for, at most
:data:`MAX_ROWS` query rows, a head dim in :data:`HEAD_DIMS`, fp32 or bf16
and a key length the kernel's shared memory holds; ``"attend"`` for other
CUDA calls (the TTS prefill's wide prompt, training); ``"plain"`` on the
CPU. ``"attend"`` and ``"plain"`` run :func:`decode_attention_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from janus_tpu_torch.ops import cuda_build
from janus_tpu_torch.ops.attention import attend, fill_mask

__all__ = ["decode_attention", "decode_attention_plain", "decode_route",
           "plan_splits", "tile_positions", "lanes_per_position", "KERNEL",
           "MAX_ROWS",
           "HEAD_DIMS"]

KERNEL = cuda_build.KERNELS["decode_attn"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 48, 64, 128)   # 48: the demo TTS
MAX_ROWS = 16        # query rows a call may have
THREADS = 128        # threads of a block
PASSES = 8           # passes of the block over a tile
# blocks (a cluster) per (batch, head): 2 (the kernel takes up to 4; see
# csrc/decode_attn.cu for the measurement)
MAX_SPLITS = 2
_SMEM_LIMIT = 48 * 1024
# decode_attn(q, k, v, out, batch, heads, tq, t_len, dh, q_dtype, kv_dtype,
#             q_str, k_str, v_str, o_str, pos_dev, pos_host, masked, scale,
#             splits, stream)
_STRIDES = ctypes.c_longlong * 3
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.POINTER(ctypes.c_longlong)] * 4
             + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

Pos = Optional[Union[int, torch.Tensor]]


def lanes_per_position(kv_dtype: torch.dtype, head_dim: int) -> int:
    """Lanes that read one key's row: its 16-byte chunks, rounded up to a
    power of two (8 at bf16 and Dh 64 or 48)."""
    chunks = head_dim * torch.empty((), dtype=kv_dtype).element_size() // 16
    lanes = 1
    while lanes < chunks:
        lanes *= 2
    return lanes


def tile_positions(kv_dtype: torch.dtype, head_dim: int) -> int:
    """Key positions in one tile: :data:`PASSES` passes of the block's 128
    threads, :func:`lanes_per_position` to a position (128 at bf16 and
    Dh 64)."""
    return PASSES * THREADS // lanes_per_position(kv_dtype, head_dim)


def plan_splits(t: int, kv_dtype: torch.dtype, head_dim: int) -> int:
    """Blocks that share one (batch, head): the largest power of two that
    is at most :data:`MAX_SPLITS` and at most the number of tiles (2 at
    T 500 in bf16 at Dh 64, one at the self-attention caches' 25)."""
    tiles = -(-t // tile_positions(kv_dtype, head_dim))
    splits = 1
    while splits * 2 <= min(MAX_SPLITS, tiles):
        splits *= 2
    return splits


def _smem_bytes(tq: int, t: int, kv_dtype: torch.dtype, dh: int) -> int:
    """Shared memory a block takes: its scores and its reductions."""
    rows = 1 if tq == 1 else 4
    tile = tile_positions(kv_dtype, dh)
    tiles = -(-t // tile)
    local = -(-tiles // plan_splits(t, kv_dtype, dh)) * tile
    return 4 * (rows * local + 4 * rows + 4 * rows * dh + 2 * rows
                + rows * dh)


def decode_route(device: torch.device, tq: int, t: int, dh: int,
                 requires_grad: bool, dtypes=(torch.bfloat16,
                                             torch.bfloat16)) -> str:
    """``"kernel"``, ``"attend"`` or ``"plain"`` for a call with ``tq``
    query rows over ``t`` keys at head dim ``dh``; ``dtypes`` is
    ``(q.dtype, k.dtype)``."""
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {device}")
    q_dtype, kv_dtype = dtypes
    if (requires_grad or not 1 <= tq <= MAX_ROWS or dh not in HEAD_DIMS
            or q_dtype not in _DTYPES or kv_dtype not in _DTYPES
            or _smem_bytes(tq, t, kv_dtype, dh) > _SMEM_LIMIT):
        return "attend"
    return "kernel"


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: Pos = None) -> torch.Tensor:
    """The plain version: :func:`attend` with the caches' mask at ``pos``
    (:func:`~janus_tpu_torch.ops.attention.fill_mask`; None: no mask)."""
    mask = (None if pos is None
            else fill_mask(pos, q.shape[-2], k.shape[-2], q.device))
    return attend(q, k, v, mask)


def _as4(x: torch.Tensor) -> torch.Tensor:
    """``[..., H, T, Dh]`` as ``[B, H, T, Dh]`` (a view where the leading
    axes merge, as a 4-d tensor's always do)."""
    return x.reshape((-1,) + tuple(x.shape[-3:]))


def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            pos: Pos) -> torch.Tensor:
    if not (q.device == k.device == v.device):
        raise ValueError("decode_attention: q, k, v on different devices")
    if k.dtype != v.dtype:
        raise TypeError(f"decode_attention kernel: k {k.dtype} and v "
                        f"{v.dtype} differ")
    if k.shape != v.shape or k.shape[:-2] != q.shape[:-2] or (
            k.shape[-1] != q.shape[-1]):
        raise ValueError(f"decode_attention: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    lead = tuple(q.shape[:-3])
    q4 = _as4(q)
    if q4.stride(-1) != 1:
        q4 = q4.contiguous()
    # the kernel reads K/V rows in 16-byte chunks: a dense, aligned copy
    # only where the layout does not allow that
    chunk = 16 // k.element_size()
    k4, v4 = (x if x.stride(-1) == 1 and x.data_ptr() % 16 == 0
              and not any(s % chunk for s in x.stride()[:3])
              else x.clone(memory_format=torch.contiguous_format)
              for x in (_as4(k), _as4(v)))
    b, h, tq, dh = q4.shape
    t = k4.shape[-2]
    # written as [B, tq, H, Dh], so that merging the heads is a view
    out = torch.empty((b, tq, h, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int64 or pos.numel() != 1 or (
                pos.device != q.device):
            raise TypeError(f"decode_attention: pos must be one int64 on "
                            f"{q.device}, got {pos.dtype} on {pos.device}")
        pos_dev, pos_host, seen = pos.data_ptr(), 0, t
    elif pos is None:
        pos_dev, pos_host, seen = None, 0, t
    else:
        pos_dev, pos_host = None, int(pos)
        seen = min(t, pos_host + tq)
    splits = plan_splits(t, k.dtype, dh)
    fn = cuda_build.entry(KERNEL, "decode_attn", _ARGTYPES)
    bh = b * h
    # QK^T and PV over the keys read (4 Dh a key and row) plus ~5 a score
    # (scale, max, exp, sum, normalise); q and the keys read once, the
    # output written once
    KERNEL.launched(bh * tq * seen * (4.0 * dh + 5.0),
                    bh * (2 * tq * dh * q.element_size()
                          + 2 * seen * dh * k.element_size()))
    code = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
              b, h, tq, t, dh, _DTYPES[q.dtype], _DTYPES[k.dtype],
              _STRIDES(*q4.stride()[:3]), _STRIDES(*k4.stride()[:3]),
              _STRIDES(*v4.stride()[:3]), _STRIDES(*out.stride()[:3]),
              pos_dev, pos_host, int(pos is not None), dh ** -0.5, splits,
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch(KERNEL, code)
    return out.reshape(lead + (h, tq, dh))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Pos = None) -> torch.Tensor:
    """``q[..., H, tq, Dh]`` over ``k, v[..., H, T, Dh]`` with the caches'
    mask at ``pos`` (an int64 0-dim device tensor or an int; None: no
    mask), routed by :func:`decode_route`: the kernel, or the plain
    version."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    route = decode_route(q.device, q.shape[-2], k.shape[-2], q.shape[-1],
                         grad, (q.dtype, k.dtype))
    if route == "kernel":
        return _kernel(q, k, v, pos)
    return decode_attention_plain(q, k, v, pos)
