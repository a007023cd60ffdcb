"""Multi-head attention over ``[..., H, T, Dh]`` tensors and the lockstep
decode cache.

:func:`attend` is the semantics reference: fp32 logits and softmax, masked
logits filled with -1e30, probabilities cast to ``v.dtype`` before the
PV product (which accumulates in fp32), output in ``q.dtype``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["split_heads", "merge_heads", "attend", "KVCache", "causal_mask",
           "fill_mask"]


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[..., T, D] -> [..., H, T, D/H]``"""
    *lead, t, d = x.shape
    return x.reshape(*lead, t, num_heads, d // num_heads).movedim(-2, -3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[..., H, T, Dh] -> [..., T, H*Dh]``"""
    x = x.movedim(-3, -2)
    *lead, t, h, dh = x.shape
    return x.reshape(*lead, t, h * dh)


def causal_mask(q_len: int, k_len: int, device="cpu") -> torch.Tensor:
    """Boolean ``[q_len, k_len]``: query i attends keys j <= i."""
    qi = torch.arange(q_len, device=device)[:, None]
    kj = torch.arange(k_len, device=device)[None, :]
    return kj <= qi


def fill_mask(pos, q_len: int, t_max: int, device) -> torch.Tensor:
    """The decode caches' mask ``[1, q_len, t_max]`` for ``q_len`` queries
    written at the fill point ``pos`` (an int, or a 0-dim device tensor,
    never read back): query i attends keys j <= pos + i, the values of
    :meth:`KVCache.valid_mask` after the write."""
    kj = torch.arange(t_max, device=device)[None, :]
    qi = pos + torch.arange(q_len, device=device)[:, None]
    return ((kj <= qi) & (kj < pos + q_len))[None]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor] = None,
           scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention; ``mask`` broadcasts against
    ``[..., H, Tq, Tk]`` (True = attend)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


class KVCache:
    """Static-capacity decode cache: ``k``/``v`` are ``[..., H, T_max,
    Dh]`` and ``length`` is the fill count every lane shares (decode lanes
    advance in lockstep). Unfilled slots hold zeros and are masked out.

    Unlike the JAX package's immutable cache, appends write ``k``/``v`` in
    place and advance ``length`` on this object."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, length: int = 0):
        self.k = k
        self.v = v
        self.length = length

    @classmethod
    def create(cls, batch_shape: Tuple[int, ...], num_heads: int,
               max_len: int, head_dim: int, dtype=torch.float32,
               device="cpu") -> "KVCache":
        shape = tuple(batch_shape) + (num_heads, max_len, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)

    def append_lockstep(self, k_new: torch.Tensor,
                        v_new: torch.Tensor) -> "KVCache":
        """Write ``[..., H, T_new, Dh]`` at the shared fill point."""
        t_new = k_new.shape[-2]
        start, t_max = self.length, self.k.shape[-2]
        # JAX's dynamic_update_slice clamps an out-of-range start so the
        # write lands inside the buffer (at t_max - t_new); a torch slice
        # would silently shrink instead. Neither may happen: callers size
        # the cache to prompt + max_new, as greedy_decode does.
        if start + t_new > t_max:
            raise ValueError(
                f"KV cache overflow: {start} + {t_new} > capacity {t_max}")
        self.k[..., start:start + t_new, :] = k_new.to(self.k.dtype)
        self.v[..., start:start + t_new, :] = v_new.to(self.v.dtype)
        self.length = start + t_new
        return self

    def write_at(self, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> None:
        """Write ``[..., H, T_new, Dh]`` at the fill point ``pos``, a 0-dim
        int64 tensor on the cache's device: the step variant that a CUDA
        graph captures, which never reads the position back. ``length`` is
        left alone; the caller keeps the count on the host and raises
        before a write past ``T_max`` (on the card an index out of range is
        caught only by the device). The decode steps write through
        :func:`~janus_tpu_torch.ops.decode_attention.attend_cache`, whose
        kernel stores what this stores."""
        idx = pos + torch.arange(k_new.shape[-2], device=self.k.device)
        self.k.index_copy_(-2, idx, k_new.to(self.k.dtype))
        self.v.index_copy_(-2, idx, v_new.to(self.v.dtype))

    def valid_mask(self, q_len: int) -> torch.Tensor:
        """Causal mask ``[1, q_len, T_max]`` for queries appended at the
        end of the filled region (post-append ``length``)."""
        t_max = self.k.shape[-2]
        kj = torch.arange(t_max, device=self.k.device)[None, :]
        filled = kj < self.length
        qi = (self.length - q_len
              + torch.arange(q_len, device=self.k.device)[:, None])
        return ((kj <= qi) & filled)[None]
