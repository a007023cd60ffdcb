"""Ring attention: sequence-parallel exact attention by rotating K/V blocks.

Each rank of the ``seq`` dimension holds the Q/K/V block ``[B, H, T/s,
Dh]`` of its stretch of the sequence. K/V blocks travel around the ring
(:func:`~.collectives.ppermute`, to rank + 1) while each rank accumulates
its queries' attention in streaming-softmax form: fp32 running max and
denominator, with guards for fully masked rows, and causal masking by
global block index — the JAX package's ``_local_ring_attention`` term for
term. Numerically exact, with O(T/s) memory per rank.

On a data × seq mesh each data group runs its own ring: the ``seq``
dimension's process group holds the ranks of one ``(data, model)``
coordinate. The body is plain PyTorch, as the JAX package's is
(``einsum``, no Pallas kernel). Forward only, as every use of it there.
"""

from __future__ import annotations

import torch

from janus_tpu_torch.parallel.collectives import axis_index, axis_size, ppermute

__all__ = ["ring_attention"]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis_name: str = "seq",
                   causal: bool = False) -> torch.Tensor:
    """Exact attention of this rank's query block over every rank's K/V
    blocks along ``axis_name``. ``q, k, v`` are ``[B, H, T_blk, Dh]``
    blocks of a sequence split evenly over the ring; the output is this
    rank's block, in ``q.dtype``."""
    n = axis_size(mesh, axis_name)
    me = axis_index(mesh, axis_name)
    scale = q.shape[-1] ** -0.5
    t_blk = q.shape[-2]

    qf = q.float() * scale
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32,
                      device=q.device)
    m = torch.full(q.shape[:-1], -torch.inf, dtype=torch.float32,
                   device=q.device)                      # running max
    l = torch.zeros(q.shape[:-1], dtype=torch.float32,   # noqa: E741
                    device=q.device)                     # running denom
    ar = torch.arange(t_blk, device=q.device)

    k_blk, v_blk = k, v
    for step in range(n):
        src = (me - step) % n  # which shard this block is
        s = torch.einsum("bhtd,bhsd->bhts", qf, k_blk.float())
        if causal:
            qi = me * t_blk + ar[:, None]
            kj = src * t_blk + ar[None, :]
            s = s.masked_fill(kj > qi, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)  # noqa: E741
        acc = acc * corr[..., None] + torch.einsum("bhts,bhsd->bhtd", p,
                                                   v_blk.float())
        m = m_new
        if step < n - 1:
            k_blk = ppermute(k_blk, mesh, axis_name)
            v_blk = ppermute(v_blk, mesh, axis_name)

    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)
