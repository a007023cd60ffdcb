"""Parameter trees: path flattening, the npz loader and writer, the
bridges from and to the JAX package's trees, the seeded ASR initializer
and the decode-layout QKV fusion.

Params are nested dicts of tensors with the JAX package's layouts (linear
``w[d_in, d_out]``, conv ``w[K, C_in, C_out]``) and per-layer ``blocks``
lists, so a tree moves between the two packages leaf for leaf. A
quantized weight (:mod:`janus_tpu_torch.ops.quant`) is a NamedTuple node
``(q, scale)``: the maps below descend into it and rebuild its type.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from janus_tpu_torch.common.config import ASRConfig
from janus_tpu_torch.ops.quant import DynQuantizedWeight, QuantizedWeight

__all__ = [
    "flatten_with_paths",
    "unflatten_from_paths",
    "map_tree",
    "map_with_paths",
    "tree_to",
    "cast_floating",
    "load_npz_params",
    "save_npz",
    "params_from_jax",
    "params_to_jax",
    "init_asr",
    "fuse_qkv",
    "prepare_decode_params",
]

Params = Dict


def flatten_with_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Yield ``('encoder/blocks/0/attn/q/w', leaf)`` pairs."""
    if isinstance(tree, dict):
        for k in tree:
            yield from flatten_with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def unflatten_from_paths(pairs: Dict[str, Any]) -> Any:
    """Inverse of :func:`flatten_with_paths` (lists re-materialized from
    integer path segments)."""
    root: Dict[str, Any] = {}
    for path, value in pairs.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def map_with_paths(fn: Callable[[str, Any], Any], tree: Any,
                   prefix: str = "") -> Any:
    """Structure-preserving map over the leaves of dicts, lists and
    NamedTuples (rebuilt as their own type; other tuples become lists);
    ``fn`` sees each leaf's slash-joined path and the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [map_with_paths(fn, v, f"{prefix}{i}/")
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if _is_namedtuple(tree) else items
    return fn(prefix[:-1], tree)


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """:func:`map_with_paths` without the paths."""
    return map_with_paths(lambda _, leaf: fn(leaf), tree)


def tree_to(tree: Any, device) -> Any:
    """Every leaf (tensor or array-like) as a tensor on ``device``."""

    def leaf(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        return t.to(device)

    return map_tree(leaf, tree)


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast floating leaves only (integer leaves untouched). A quantized
    weight's ``scale`` is cast too, as ``jax.tree.map`` does in the JAX
    package: under bf16 the fp32 scales are rounded to bf16."""
    return map_tree(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def load_npz_params(path: str, device="cpu") -> Params:
    """Load a flat fp16 npz checkpoint (``path/with/slashes -> array``)
    into a float32 tree on ``device``."""
    with np.load(path) as data:
        pairs = {k: torch.from_numpy(data[k].astype(np.float32)).to(device)
                 for k in data.files}
    return unflatten_from_paths(pairs)


def save_npz(path: str, params: Params) -> None:
    """Write the zoo's checkpoint format: a flat npz keyed by tree path,
    floating leaves as fp16 (read back by :func:`load_npz_params` here and
    by the JAX package's ``load_npz_params``)."""
    flat = {}
    for k, v in flatten_with_paths(params):
        a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v))
        flat[k] = (a.astype(np.float16) if np.issubdtype(a.dtype, np.floating)
                   else a)
    np.savez(path, **flat)


def _unstack_blocks(tree: Any) -> Any:
    """Layer-stacked ``blocks`` (a dict of ``[L, ...]`` leaves) → list of
    per-layer dicts; per-layer lists pass through."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "blocks" and isinstance(v, dict):
                _, first = next(flatten_with_paths(v))
                n_layers = int(np.asarray(first).shape[0])
                v = [map_tree(lambda a, i=i: a[i], v)
                     for i in range(n_layers)]
            out[k] = _unstack_blocks(v)
        return out
    if _is_namedtuple(tree):
        return tree
    if isinstance(tree, (list, tuple)):
        return [_unstack_blocks(v) for v in tree]
    return tree


# the JAX package's quantized-weight types, by name (the port imports
# nothing of it), and the port's type of the same name
_QUANT_TYPES = {"QuantizedWeight": QuantizedWeight,
                "DynQuantizedWeight": DynQuantizedWeight}


def _port_types(tree: Any) -> Any:
    """JAX ``QuantizedWeight`` / ``DynQuantizedWeight`` nodes → the port's
    NamedTuples of the same name (numpy leaves)."""
    if isinstance(tree, dict):
        return {k: _port_types(v) for k, v in tree.items()}
    cls = _QUANT_TYPES.get(type(tree).__name__)
    if cls is not None:
        return cls(*(np.asarray(a) for a in tree))
    if isinstance(tree, (list, tuple)):
        return [_port_types(v) for v in tree]
    return np.asarray(tree)


def params_from_jax(tree: Any, device="cpu") -> Params:
    """The JAX package's parameter tree — numpy arrays in nested dicts and
    lists, per-layer or layer-stacked, quantized or not — as the port's
    tree of tensors on ``device`` (stacked blocks become per-layer lists,
    quantized weights the port's types of the same name)."""
    return tree_to(_unstack_blocks(_port_types(tree)), device)


def params_to_jax(tree: Any) -> Any:
    """The inverse of :func:`params_from_jax` for dense trees: the same
    nested dicts and per-layer ``blocks`` lists, every leaf a numpy array
    on the host, as the JAX package's functions take them."""
    def leaf(t):
        if isinstance(t, (QuantizedWeight, DynQuantizedWeight)):
            raise TypeError("params_to_jax takes dense trees; quantize on "
                            "the JAX side instead")
        return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t))

    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_namedtuple(tree):
        return [params_to_jax(v) for v in tree]
    return leaf(tree)


# --------------------------------------------------------------------------
# seeded initialization (shapes of janus_tpu.models.asr.init_asr)
# --------------------------------------------------------------------------

def _normal(g: torch.Generator, shape, scale: float = 0.02) -> torch.Tensor:
    return scale * torch.randn(shape, generator=g, device=g.device)


def _zeros(g: torch.Generator, n: int) -> torch.Tensor:
    return torch.zeros(n, device=g.device)


def _init_attn(g: torch.Generator, d: int) -> Params:
    return {
        "q": {"w": _normal(g, (d, d)), "b": _zeros(g, d)},
        "k": {"w": _normal(g, (d, d))},
        "v": {"w": _normal(g, (d, d)), "b": _zeros(g, d)},
        "out": {"w": _normal(g, (d, d)), "b": _zeros(g, d)},
    }


def _init_ln(g: torch.Generator, d: int) -> Params:
    return {"scale": torch.ones(d, device=g.device), "bias": _zeros(g, d)}


def _init_mlp(g: torch.Generator, d: int, ratio: int) -> Params:
    return {
        "fc1": {"w": _normal(g, (d, ratio * d)), "b": _zeros(g, ratio * d)},
        "fc2": {"w": _normal(g, (ratio * d, d)), "b": _zeros(g, d)},
    }


def init_asr(generator: torch.Generator, cfg: ASRConfig) -> Params:
    """Random Whisper-class tree (normal 0.02 weights, zero biases, unit
    norm scales) on the generator's device, float32."""
    g, d = generator, cfg.d_model
    enc_blocks = [
        {"attn_ln": _init_ln(g, d), "attn": _init_attn(g, d),
         "mlp_ln": _init_ln(g, d), "mlp": _init_mlp(g, d, cfg.mlp_ratio)}
        for _ in range(cfg.encoder_layers)
    ]
    dec_blocks = [
        {"attn_ln": _init_ln(g, d), "attn": _init_attn(g, d),
         "cross_ln": _init_ln(g, d), "cross": _init_attn(g, d),
         "mlp_ln": _init_ln(g, d), "mlp": _init_mlp(g, d, cfg.mlp_ratio)}
        for _ in range(cfg.decoder_layers)
    ]
    return {
        "encoder": {
            "conv1": {"w": _normal(g, (3, cfg.n_mels, d)), "b": _zeros(g, d)},
            "conv2": {"w": _normal(g, (3, d, d)), "b": _zeros(g, d)},
            "blocks": enc_blocks,
            "ln_post": _init_ln(g, d),
        },
        "decoder": {
            "token_emb": _normal(g, (cfg.vocab_size, d)),
            "pos_emb": _normal(g, (cfg.max_target_positions, d)),
            "blocks": dec_blocks,
            "ln": _init_ln(g, d),
        },
    }


# --------------------------------------------------------------------------
# decode layout
# --------------------------------------------------------------------------

def fuse_qkv(attn: Params) -> Params:
    """Self-attention q/k/v → one ``[d, 3d]`` projection ``qkv`` with the
    bias-less K slot zero-filled: the same output columns, one matmul.
    Quantized pairs concatenate ``q`` and ``scale`` along the output-channel
    axis, which the biases and the per-channel scales share."""
    q, k, v = attn["q"], attn["k"], attn["v"]
    wq, wk, wv = q["w"], k["w"], v["w"]
    if isinstance(wq, (QuantizedWeight, DynQuantizedWeight)):
        w = type(wq)(torch.cat([wq.q, wk.q, wv.q], dim=-1),
                     torch.cat([wq.scale, wk.scale, wv.scale], dim=-1))
    else:
        w = torch.cat([wq, wk, wv], dim=-1)
    b = torch.cat([q["b"], k.get("b", torch.zeros_like(q["b"])), v["b"]],
                  dim=-1)
    return {"qkv": {"w": w, "b": b}, "out": attn["out"]}


def prepare_decode_params(params: Params) -> Params:
    """Fuse every decoder block's self-attention q/k/v (idempotent)."""
    dec = params["decoder"]
    blocks = [b if "qkv" in b["attn"] else {**b, "attn": fuse_qkv(b["attn"])}
              for b in dec["blocks"]]
    return {**params, "decoder": {**dec, "blocks": blocks}}
