"""Ulysses-style sequence parallelism: all-to-all head↔sequence resharding.

An alternative to ring attention for encoder self-attention: one
all-to-all re-shards ``[B, H, T/s, Dh]`` (every head, this rank's stretch
of the sequence) into ``[B, H/s, T, Dh]`` (this rank's heads, the whole
sequence), ordinary full-sequence attention runs on those heads, and a
second all-to-all restores the sequence split. Two collectives per
attention: cheaper than a ring when the head count divides well and T is
moderate. The attention is the plain :func:`~..ops.attention.attend`, as
the JAX package's body is.
"""

from __future__ import annotations

import torch

from janus_tpu_torch.ops.attention import attend, causal_mask
from janus_tpu_torch.parallel.collectives import all_to_all, axis_size

__all__ = ["ulysses_attention"]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis_name: str = "seq",
                      causal: bool = False) -> torch.Tensor:
    """Exact attention over this rank's ``[B, H, T_blk, Dh]`` blocks of a
    sequence split over ``axis_name``; H must be divisible by the
    dimension's size. Returns this rank's block of the output."""
    n = axis_size(mesh, axis_name)
    if q.shape[1] % n != 0:
        raise ValueError(f"heads={q.shape[1]} not divisible by "
                         f"|{axis_name}|={n}")

    def seq_to_head(x):
        return all_to_all(x, mesh, axis_name, split_dim=1, concat_dim=2)

    qh, kh, vh = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    mask = None
    if causal:
        t = qh.shape[-2]
        mask = causal_mask(t, t, device=q.device)
    out = attend(qh, kh, vh, mask)
    return all_to_all(out, mesh, axis_name, split_dim=2, concat_dim=1)
