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

With the step's new rows (``k_new``, ``v_new``: ``[..., H, tq, Dh]``) the
call first writes them into the caches ``k``, ``v`` at ``pos .. pos + tq -
1``, rounded to the caches' dtype, as
:meth:`~janus_tpu_torch.ops.attention.KVCache.write_at` does: the kernel
writes them itself and scores those keys from the rounded values, bit-equal
to the write and then the call without them (the JAX package writes its
cache and attends inside one compiled step, ``janus_tpu/ops/attention.py:
135-136``). :func:`attend_cache` is that call on a
:class:`~janus_tpu_torch.ops.attention.KVCache`, at a device position or
at the cache's own fill count, which it advances.

:func:`decode_route` picks, from what a call can see on the host:
``"kernel"`` on a CUDA device with no gradient asked for, at most
:data:`MAX_ROWS` query rows, a head dim in :data:`HEAD_DIMS`, fp32 or bf16
and a block's scores within :data:`SCORE_BYTES` of shared memory;
``"attend"`` for other CUDA calls (the TTS prefill's wide prompt,
training); ``"plain"`` on the CPU. ``"attend"`` and ``"plain"`` run
:func:`decode_attention_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from janus_tpu_torch.ops import cuda_build
from janus_tpu_torch.ops.attention import KVCache, attend, fill_mask

__all__ = ["decode_attention", "decode_attention_plain", "attend_cache",
           "decode_route", "plan_splits", "score_bytes", "keys_per_pass",
           "lanes_per_position", "KERNEL", "MAX_ROWS", "HEAD_DIMS",
           "SCORE_BYTES"]

KERNEL = cuda_build.KERNELS["decode_attn"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 48, 64, 128)   # 48: the demo TTS
MAX_ROWS = 16        # query rows a call may have
THREADS = 128        # threads of a block
MAX_SPLITS = 8       # blocks (a cluster) per (batch, head)
# a block's keys that call for another split (see plan_splits)
SPLIT_KEYS = 128
# a block's scores the kernel always has shared memory for beside its
# other arrays and a ring of the smallest slots (SCORE_BYTES in
# csrc/decode_attn.cu, which asserts that)
SCORE_BYTES = 160 * 1024
# decode_attn(q, k, v, out, k_new, v_new, batch, heads, tq, t_len, dh,
#             q_dtype, kv_dtype, q_str, k_str, v_str, o_str, kn_str, vn_str,
#             pos_dev, pos_host, masked, scale, splits, stream)
_STRIDES = ctypes.c_longlong * 3
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.POINTER(ctypes.c_longlong)] * 6
             + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

Pos = Optional[Union[int, torch.Tensor]]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def lanes_per_position(kv_dtype: torch.dtype, head_dim: int) -> int:
    """Lanes that read one key's row: its 16-byte chunks, rounded up to a
    power of two (8 at bf16 and Dh 64 or 48)."""
    chunks = head_dim * _itemsize(kv_dtype) // 16
    lanes = 1
    while lanes < chunks:
        lanes *= 2
    return lanes


def keys_per_pass(kv_dtype: torch.dtype, head_dim: int) -> int:
    """Keys the block's 128 threads score in one pass (16 at bf16 and
    Dh 64)."""
    return THREADS // lanes_per_position(kv_dtype, head_dim)


def plan_splits(t: int, kv_dtype: torch.dtype, head_dim: int,
                tq: int = 1) -> int:
    """Blocks that share one (batch, head): the fewest (a power of two, at
    most :data:`MAX_SPLITS`) that leave a block at most
    :data:`SPLIT_KEYS` of the ``t`` keys, twice that for blocks of 4 query
    rows (4 at T 500 for one row, 2 for the 4-row prefill; 8 at T 1500;
    one at the self-attention caches' 25). Measured on the H100: fewer
    splits leave the T 1500 rows' blocks too long (``chip_smoke.py``'s
    split rows); more make the 4-row prefill's clusters spill into a
    second wave."""
    keys = SPLIT_KEYS * (1 if tq == 1 else 2)
    splits = 1
    while splits < MAX_SPLITS and -(-t // splits) > keys:
        splits *= 2
    return splits


def score_bytes(t: int, tq: int, kv_dtype: torch.dtype, dh: int) -> int:
    """The fp32 scores a block of the kernel holds in shared memory: its
    query rows (1, or a chunk of 4) times its share of the ``t`` keys
    under :func:`plan_splits`. The kernel plans its K/V ring around them
    (``plan_chunk`` in ``csrc/decode_attn.cu``) and has room for one
    whenever they are at most :data:`SCORE_BYTES`."""
    rows = 1 if tq == 1 else 4
    return 4 * rows * -(-t // plan_splits(t, kv_dtype, dh, tq))


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
            or score_bytes(t, tq, kv_dtype, dh) > SCORE_BYTES):
        return "attend"
    return "kernel"


def _write_rows(k: torch.Tensor, v: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, pos) -> None:
    """The new rows into the caches at ``pos``: exactly
    :meth:`~janus_tpu_torch.ops.attention.KVCache.write_at` for a device
    position, :meth:`~janus_tpu_torch.ops.attention.KVCache.
    append_lockstep` for a host int (which raises on an overflow)."""
    if isinstance(pos, torch.Tensor):
        KVCache(k, v).write_at(k_new, v_new, pos)
    else:
        KVCache(k, v, int(pos)).append_lockstep(k_new, v_new)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: Pos = None, k_new: Optional[torch.Tensor] = None,
                           v_new: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The plain version: the new rows written (where given), then
    :func:`attend` with the caches' mask at ``pos``
    (:func:`~janus_tpu_torch.ops.attention.fill_mask`; None: no mask)."""
    if k_new is not None:
        _write_rows(k, v, k_new, v_new, pos)
    mask = (None if pos is None
            else fill_mask(pos, q.shape[-2], k.shape[-2], q.device))
    return attend(q, k, v, mask)


def _as4(x: torch.Tensor) -> torch.Tensor:
    """``[..., H, T, Dh]`` as ``[B, H, T, Dh]`` (a view where the leading
    axes merge, as a 4-d tensor's always do)."""
    return x.reshape((-1,) + tuple(x.shape[-3:]))


def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: Pos,
            k_new: Optional[torch.Tensor], v_new: Optional[torch.Tensor],
            splits: int) -> torch.Tensor:
    """The launch, with ``splits`` blocks a (batch, head) (a power of two
    up to :data:`MAX_SPLITS`; :func:`plan_splits` on the route, another
    plan only to time it)."""
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
    # only where the layout does not allow that (caches it writes must)
    chunk = 16 // k.element_size()

    def rows(x):
        # a view, so that the kernel's writes land in the caches
        x = _as4(x) if k_new is None else x.view((-1,) + tuple(x.shape[-3:]))
        if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and not any(
                s % chunk for s in x.stride()[:3]):
            return x
        if k_new is not None:
            raise ValueError("decode_attention: the kernel cannot write "
                             "caches whose rows are not 16-byte chunks")
        return x.clone(memory_format=torch.contiguous_format)

    k4, v4 = rows(k), rows(v)
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
    if k_new is not None:
        kn4, vn4 = (x if x.stride(-1) == 1 else x.contiguous()
                    for x in (_as4(k_new), _as4(v_new)))
        kn_ptr, vn_ptr = kn4.data_ptr(), vn4.data_ptr()
        kn_str, vn_str = kn4.stride()[:3], vn4.stride()[:3]
        new = tq
    else:
        kn_ptr = vn_ptr = None
        kn_str = vn_str = (0, 0, 0)
        new = 0
    fn = cuda_build.entry(KERNEL, "decode_attn", _ARGTYPES)
    bh = b * h
    # QK^T and PV over the keys read (4 Dh a key and row) plus ~5 a score
    # (scale, max, exp, sum, normalise); q, the cache's keys and the new
    # rows read once, the output and the new rows written once
    KERNEL.launched(bh * tq * seen * (4.0 * dh + 5.0),
                    bh * (2 * tq * dh * q.element_size()
                          + 2 * (seen - new) * dh * k.element_size()
                          + 2 * new * dh * (q.element_size()
                                            + k.element_size())))
    code = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
              kn_ptr, vn_ptr, b, h, tq, t, dh, _DTYPES[q.dtype],
              _DTYPES[k.dtype], _STRIDES(*q4.stride()[:3]),
              _STRIDES(*k4.stride()[:3]), _STRIDES(*v4.stride()[:3]),
              _STRIDES(*out.stride()[:3]), _STRIDES(*kn_str),
              _STRIDES(*vn_str), pos_dev, pos_host, int(pos is not None),
              dh ** -0.5, splits,
              torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch(KERNEL, code)
    return out.reshape(lead + (h, tq, dh))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Pos = None, k_new: Optional[torch.Tensor] = None,
                     v_new: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q[..., H, tq, Dh]`` over ``k, v[..., H, T, Dh]`` with the caches'
    mask at ``pos`` (an int64 0-dim device tensor or an int; None: no
    mask), routed by :func:`decode_route`: the kernel, or the plain
    version. With ``k_new``, ``v_new`` (``[..., H, tq, Dh]``) the caches
    are first written at ``pos`` (see the module); on the kernel route the
    kernel writes them where the rows are in ``q``'s dtype, else they are
    written as :meth:`~janus_tpu_torch.ops.attention.KVCache.write_at`
    writes them before the launch."""
    if (k_new is None) != (v_new is None):
        raise ValueError("decode_attention: k_new and v_new go together")
    if k_new is not None:
        if pos is None:
            raise ValueError("decode_attention: new rows need the fill "
                             "point pos")
        if k_new.shape != q.shape or v_new.shape != q.shape:
            raise ValueError(f"decode_attention: new rows {tuple(k_new.shape)}"
                             f", {tuple(v_new.shape)} for q {tuple(q.shape)}")
        # at a host position, raise before a write past the caches, as
        # append_lockstep does (a device position is its caller's to check)
        if not isinstance(pos, torch.Tensor) and (
                int(pos) + q.shape[-2] > k.shape[-2]):
            raise ValueError(f"KV cache overflow: {int(pos)} + "
                             f"{q.shape[-2]} > capacity {k.shape[-2]}")
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, k_new, v_new))
    route = decode_route(q.device, q.shape[-2], k.shape[-2], q.shape[-1],
                         grad, (q.dtype, k.dtype))
    if route != "kernel":
        return decode_attention_plain(q, k, v, pos, k_new, v_new)
    if k_new is not None and not (k_new.dtype == v_new.dtype == q.dtype):
        _write_rows(k, v, k_new, v_new, pos)
        k_new = v_new = None
    return _kernel(q, k, v, pos, k_new, v_new,
                   plan_splits(k.shape[-2], k.dtype, q.shape[-1], q.shape[-2]))


def attend_cache(q: torch.Tensor, cache: KVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor,
                 pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step's rows ``k_new``, ``v_new`` into ``cache`` and ``q``
    attending over it with the caches' mask, in one call of
    :func:`decode_attention`: at the 0-dim device position ``pos`` (a
    captured step; the cache's ``length`` is the caller's to keep), or at
    the cache's ``length``, which then advances (raising before a write
    past the cache, as ``append_lockstep`` does)."""
    if pos is not None:
        return decode_attention(q, cache.k, cache.v, pos, k_new, v_new)
    out = decode_attention(q, cache.k, cache.v, cache.length, k_new, v_new)
    cache.length += k_new.shape[-2]
    return out
