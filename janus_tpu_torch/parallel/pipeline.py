"""Pipeline parallelism: the GPipe microbatch schedule over a mesh
dimension.

Layer groups (stages) live on the ranks of the ``stage`` dimension;
microbatches flow stage to stage with :func:`~.collectives.ppermute` in
the S + M − 1 step schedule, so that at steady state every stage computes
a different microbatch. Stage functions must be homogeneous (the same
computation, per-stage params): a transformer split into equal layer
groups, which is how :func:`split_encoder_stages` carves the ASR encoder.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from janus_tpu_torch.models.params import (flatten_with_paths, map_tree,
                                           unflatten_from_paths)
from janus_tpu_torch.parallel.collectives import (all_reduce, axis_index,
                                                  axis_size, ppermute)

__all__ = ["pipeline_apply", "split_encoder_stages", "stack_stage_params"]


def stack_stage_params(stage_params: List[Any]) -> Any:
    """Stack per-stage param trees along a new leading stage axis."""
    flats = [dict(flatten_with_paths(t)) for t in stage_params]
    return unflatten_from_paths({k: torch.stack([f[k] for f in flats])
                                 for k in flats[0]})


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any, x: torch.Tensor, mesh,
                   axis_name: str = "stage",
                   n_microbatches: Optional[int] = None) -> torch.Tensor:
    """Run ``x[B, ...]`` (the same on every rank) through S pipelined
    stages; every rank returns the whole result.

    ``stacked_params`` has a leading stage axis of length S (see
    :func:`stack_stage_params`); this rank takes its own stage.
    ``stage_fn(params_for_stage, microbatch)`` must preserve the
    microbatch shape. Microbatches default to the stage count."""
    s = axis_size(mesh, axis_name)
    m = n_microbatches or s
    b = x.shape[0]
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    me = axis_index(mesh, axis_name)
    params_here = map_tree(lambda a: a[me], stacked_params)

    micro = x.reshape(m, b // m, *x.shape[1:])
    # the last stage deposits each finished microbatch into a zero buffer;
    # an all-reduce over the stage dimension then replicates the result
    # (the other stages contribute zeros)
    buf = torch.zeros_like(micro[0])
    out = torch.zeros_like(micro)
    for t in range(s + m - 1):
        mb = t - me
        if 0 <= mb < m:  # this stage has a microbatch at step t
            y = stage_fn(params_here, micro[mb] if me == 0 else buf)
            if me == s - 1:
                out[mb] = y
        else:
            y = buf
        buf = ppermute(y, mesh, axis_name)
    return all_reduce(out, mesh, axis_name).reshape(b, *x.shape[1:])


def split_encoder_stages(params: dict,
                         n_stages: int) -> Tuple[List[dict], Callable]:
    """Carve ASR encoder blocks into ``n_stages`` equal layer groups.

    Returns (per-stage params list, stage_fn(p, x, num_heads)). The conv
    stem, positional embedding and final LN stay outside the pipeline (run
    on the stage-0 input and after the last stage by the caller)."""
    from janus_tpu_torch.models.asr import _attention, _mlp
    from janus_tpu_torch.ops.layers import layer_norm

    blocks = params["encoder"]["blocks"]
    if len(blocks) % n_stages != 0:
        raise ValueError(
            f"{len(blocks)} blocks not divisible into {n_stages} stages")
    per = len(blocks) // n_stages
    stage_params = [{"blocks": blocks[i * per:(i + 1) * per]}
                    for i in range(n_stages)]

    def stage_fn(p, x, num_heads: int):
        for blk in p["blocks"]:
            x = x + _attention(blk["attn"], layer_norm(x, **blk["attn_ln"]),
                               num_heads)
            x = x + _mlp(blk["mlp"], layer_norm(x, **blk["mlp_ln"]))
        return x

    return stage_params, stage_fn
