"""Seeded weights for the program and the reference alike, in the
program's tree layout, made on the device in a few large calls.

A tree is described by a list of leaves ``(path, shape, init)``, where
``init`` is ``(mean, std)`` of a normal draw (std 0 for a constant). All
leaves that share an ``init`` are views of one buffer of the serving
dtype, filled by one ``normal_`` call from a generator seeded with the
configuration's weight seed; each leaf starts on a 128-byte boundary.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["asr_leaves", "tts_leaves", "vocoder_leaves", "make_tree",
           "count_params"]

Leaf = Tuple[str, Tuple[int, ...], Tuple[float, float]]

W = (0.0, 0.02)       # weight matrices and embeddings
B = (0.0, 0.02)       # biases: drawn too, so that a dropped one shows
ONE = (1.0, 0.02)     # norm scales


def _attn(p: str, d: int) -> List[Leaf]:
    return [(f"{p}/q/w", (d, d), W), (f"{p}/q/b", (d,), B),
            (f"{p}/k/w", (d, d), W),
            (f"{p}/v/w", (d, d), W), (f"{p}/v/b", (d,), B),
            (f"{p}/out/w", (d, d), W), (f"{p}/out/b", (d,), B)]


def _ln(p: str, d: int) -> List[Leaf]:
    return [(f"{p}/scale", (d,), ONE), (f"{p}/bias", (d,), B)]


def _mlp(p: str, d: int, width: int) -> List[Leaf]:
    return [(f"{p}/fc1/w", (d, width), W), (f"{p}/fc1/b", (width,), B),
            (f"{p}/fc2/w", (width, d), W), (f"{p}/fc2/b", (d,), B)]


def asr_leaves(c: dict) -> List[Leaf]:
    """A Whisper tree: conv stem, encoder and decoder blocks."""
    d, ff = c["d_model"], c["d_model"] * c["mlp_ratio"]
    out: List[Leaf] = [
        ("encoder/conv1/w", (3, c["n_mels"], d), W),
        ("encoder/conv1/b", (d,), B),
        ("encoder/conv2/w", (3, d, d), W), ("encoder/conv2/b", (d,), B)]
    for i in range(c["encoder_layers"]):
        p = f"encoder/blocks/{i}"
        out += (_ln(f"{p}/attn_ln", d) + _attn(f"{p}/attn", d)
                + _ln(f"{p}/mlp_ln", d) + _mlp(f"{p}/mlp", d, ff))
    out += _ln("encoder/ln_post", d)
    out += [("decoder/token_emb", (c["vocab_size"], d), W),
            ("decoder/pos_emb", (c["max_target_positions"], d), W)]
    for i in range(c["decoder_layers"]):
        p = f"decoder/blocks/{i}"
        out += (_ln(f"{p}/attn_ln", d) + _attn(f"{p}/attn", d)
                + _ln(f"{p}/cross_ln", d) + _attn(f"{p}/cross", d)
                + _ln(f"{p}/mlp_ln", d) + _mlp(f"{p}/mlp", d, ff))
    return out + _ln("decoder/ln", d)


def tts_leaves(c: dict, text_vocab: int, stop_bias: float) -> List[Leaf]:
    """The acoustic transformer; the stop head's bias is the constant
    ``stop_bias``."""
    d, ff = c["d_model"], c["d_model"] * c["mlp_ratio"]
    r_mels = c["reduction"] * c["n_mels"]
    tokens = text_vocab + 12 + 2      # text, 12 emotions, BOA, SPK
    max_pos = c["max_text_tokens"] + c["max_mel_frames"] // c["reduction"] + 8
    out: List[Leaf] = [
        ("token_emb", (tokens, d), W), ("pos_emb", (max_pos, d), W),
        ("prenet/fc1/w", (r_mels, d), W), ("prenet/fc1/b", (d,), B),
        ("prenet/fc2/w", (d, d), W), ("prenet/fc2/b", (d,), B),
        ("spk_proj/w", (d, d), W), ("spk_proj/b", (d,), B)]
    for i in range(c["layers"]):
        p = f"blocks/{i}"
        out += (_ln(f"{p}/attn_ln", d) + _attn(f"{p}/attn", d)
                + _ln(f"{p}/mlp_ln", d) + _mlp(f"{p}/mlp", d, ff))
    return out + _ln("ln", d) + [
        ("mel_head/w", (d, r_mels), W), ("mel_head/b", (r_mels,), B),
        ("stop_head/w", (d, 1), W), ("stop_head/b", (1,), (stop_bias, 0.0))]


def vocoder_leaves(c: dict, n_mels: int) -> List[Leaf]:
    """The Vocos-style vocoder (depthwise k7 kernels drawn at 0.1, layer
    scale 0.01)."""
    d, bins = c["d_model"], c["n_fft"] // 2 + 1
    out: List[Leaf] = [("embed/w", (n_mels, d), W), ("embed/b", (d,), B)]
    for i in range(c["layers"]):
        p = f"blocks/{i}"
        out += [(f"{p}/dwconv/w", (7, d), (0.0, 0.1)),
                (f"{p}/dwconv/b", (d,), B)] + _ln(f"{p}/ln", d) + [
            (f"{p}/pw1/w", (d, 3 * d), W), (f"{p}/pw1/b", (3 * d,), B),
            (f"{p}/pw2/w", (3 * d, d), W), (f"{p}/pw2/b", (d,), B),
            (f"{p}/gamma", (d,), (0.01, 0.0))]
    return out + _ln("ln_out", d) + [
        ("mag_head/w", (d, bins), W), ("mag_head/b", (bins,), B),
        ("phase_head/w", (d, 2 * bins), W), ("phase_head/b", (2 * bins,), B)]


def count_params(leaves: Sequence[Leaf]) -> int:
    n = 0
    for _, shape, _ in leaves:
        k = 1
        for s in shape:
            k *= s
        n += k
    return n


def _insert(tree: dict, path: str, value: torch.Tensor) -> None:
    parts = path.split("/")
    node = tree
    for i, key in enumerate(parts[:-1]):
        nxt_is_index = parts[i + 1].isdigit()
        if key.isdigit():
            idx = int(key)
            while len(node) <= idx:
                node.append({} if not nxt_is_index else [])
            node = node[idx]
        else:
            node = node.setdefault(key, [] if nxt_is_index else {})
    node[parts[-1]] = value


def make_tree(leaves: Sequence[Leaf], seed: int, device, dtype) -> dict:
    """The tree of ``leaves``, drawn from ``seed`` on ``device``."""
    align = 128 // torch.empty((), dtype=dtype).element_size()
    groups: Dict[Tuple[float, float], List[Leaf]] = {}
    for leaf in leaves:
        groups.setdefault(leaf[2], []).append(leaf)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: dict = {}
    for init in sorted(groups):
        members = groups[init]
        sizes = [count_params([m]) for m in members]
        offsets, total = [], 0
        for n in sizes:
            offsets.append(total)
            total += -(-n // align) * align
        buf = torch.empty(total, dtype=dtype, device=device)
        mean, std = init
        if std > 0:
            buf.normal_(mean, std, generator=gen)
        else:
            buf.fill_(mean)
        for (path, shape, _), off, n in zip(members, offsets, sizes):
            _insert(tree, path, buf[off:off + n].view(shape))
    return tree
