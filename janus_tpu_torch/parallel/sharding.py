"""Parameter partition rules: path-regex → partition spec.

Tensor parallelism follows the Megatron pattern mapped onto the ``model``
mesh dimension: QKV and MLP-up project *onto* the sharded dimension
(column parallel), attention-out and MLP-down project *from* it (row
parallel), so each transformer block needs one all-reduce per sublayer
(:func:`~.collectives.exit_model`). Embeddings and norms stay replicated.

A spec is a tuple with one entry per leading dimension of the leaf: the
mesh dimension it is split over, or ``None``; ``()`` is replicated (JAX's
``P()``). The tables are the JAX package's, entry for entry. Rules match
the slash-joined paths of :func:`janus_tpu_torch.models.params.
map_with_paths`. As there, the vocoder's head rules
(``.*/(mag_head|phase_head)/…``) need a segment before the head's name,
which the top-level ``mag_head/w`` lacks, so both heads stay replicated.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from janus_tpu_torch.models.params import map_with_paths
from janus_tpu_torch.parallel.collectives import (all_gather, axis_index,
                                                  axis_size)

__all__ = [
    "ASR_PARTITION_RULES",
    "TTS_PARTITION_RULES",
    "VOCODER_PARTITION_RULES",
    "partition_spec_for",
    "tree_partition_specs",
    "shard_params",
    "gather_params",
]

Spec = Tuple[Optional[str], ...]
Rules = Sequence[Tuple[str, Spec]]

# fmt: off
ASR_PARTITION_RULES: Rules = (
    # attention: column-parallel QKV, row-parallel out
    (r".*/(attn|cross)/(q|k|v)/w$",   (None, "model")),
    (r".*/(attn|cross)/(q|k|v)/b$",   ("model",)),
    (r".*/(attn|cross)/out/w$",       ("model", None)),
    (r".*/(attn|cross)/out/b$",       ()),
    # MLP: column-parallel up, row-parallel down
    (r".*/mlp/fc1/w$",                (None, "model")),
    (r".*/mlp/fc1/b$",                ("model",)),
    (r".*/mlp/fc2/w$",                ("model", None)),
    (r".*/mlp/fc2/b$",                ()),
    # conv stem / embeddings / norms replicated
    (r".*",                           ()),
)

TTS_PARTITION_RULES: Rules = (
    (r".*/attn/(q|k|v)/w$",           (None, "model")),
    (r".*/attn/(q|k|v)/b$",           ("model",)),
    (r".*/attn/out/w$",               ("model", None)),
    (r".*/mlp/fc1/w$",                (None, "model")),
    (r".*/mlp/fc1/b$",                ("model",)),
    (r".*/mlp/fc2/w$",                ("model", None)),
    (r".*",                           ()),
)

VOCODER_PARTITION_RULES: Rules = (
    (r".*/pw1/w$",                    (None, "model")),
    (r".*/pw1/b$",                    ("model",)),
    (r".*/pw2/w$",                    ("model", None)),
    (r".*/(mag_head|phase_head)/w$",  (None, "model")),
    (r".*/(mag_head|phase_head)/b$",  ("model",)),
    (r".*",                           ()),
)
# fmt: on


def partition_spec_for(path: str, rules: Rules) -> Spec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return spec
    return ()


def tree_partition_specs(params: Any, rules: Rules) -> Any:
    """Tree of specs mirroring ``params``; a spec longer than its leaf's
    rank becomes replicated."""

    def spec_for(path: str, leaf: Any) -> Spec:
        spec = partition_spec_for(path, rules)
        if len(spec) > np.ndim(leaf):
            return ()
        return spec

    return map_with_paths(spec_for, params)


def _as_tensor(leaf: Any) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.array(leaf))


def shard_params(params: Any, mesh, rules: Rules) -> Any:
    """This rank's shard of every leaf (a tensor; a copy where the leaf is
    split, so that the whole leaf can be freed). A split dimension must
    divide evenly, as ``jax.device_put`` requires."""

    def shard(path: str, leaf: Any) -> torch.Tensor:
        t = _as_tensor(leaf)
        spec = partition_spec_for(path, rules)
        if len(spec) > t.ndim:
            return t
        for dim, name in enumerate(spec):
            n = axis_size(mesh, name) if name is not None else 1
            if n == 1:
                continue
            if t.shape[dim] % n:
                raise ValueError(
                    f"{path}: dimension {dim} of size {t.shape[dim]} is not "
                    f"divisible by |{name}|={n}")
            size = t.shape[dim] // n
            t = t.narrow(dim, axis_index(mesh, name) * size, size).clone()
        return t

    return map_with_paths(shard, params)


def gather_params(params: Any, mesh, rules: Rules) -> Any:
    """The inverse of :func:`shard_params`: every leaf whole on every rank
    (all-gathers over the split dimensions), for checkpoints and tests."""

    def gather(path: str, t: torch.Tensor) -> torch.Tensor:
        spec = partition_spec_for(path, rules)
        if len(spec) > t.ndim:
            return t
        for dim, name in enumerate(spec):
            if name is not None:
                t = all_gather(t, mesh, name, dim=dim)
        return t

    return map_with_paths(gather, params)
