"""Plain Whisper (Radford et al. 2022, the large-v3 geometry): the conv
stem and pre-norm encoder, and the decoder run teacher-forced over a
prompt and the tokens a program served, giving the logits at every
served position. Float32 with TF32 off, no cache, no fused projection,
no kernel; weights are read from the tree the benchmark made (the
program's layout: ``w[d_in, d_out]``, conv ``w[K, C_in, C_out]``).

``weights`` may be a function that maps a weight matrix to the one to
use (the controls quantise there); biases, norms and embeddings stay as
they are.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["encode", "decoder_logits", "sinusoids"]

Weights = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _w(t: torch.Tensor, weights: Weights) -> torch.Tensor:
    t = t.float()
    return weights(t) if weights is not None else t


def _lin(x, p, weights: Weights):
    y = x @ _w(p["w"], weights)
    return y + p["b"].float() if "b" in p else y


def _ln(x, p, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), eps)


def _heads(x, h):
    b, t, d = x.shape
    return x.view(b, t, h, d // h).transpose(1, 2)


def _attend(q, k, v, heads: int, causal: bool):
    q, k, v = (_heads(t, heads) for t in (q, k, v))
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        tq, tk = s.shape[-2:]
        s = s.masked_fill(torch.ones(tq, tk, dtype=torch.bool,
                                     device=s.device).triu(1), -math.inf)
    o = torch.softmax(s, -1) @ v
    b, h, t, dh = o.shape
    return o.transpose(1, 2).reshape(b, t, h * dh)


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's encoder positions: sin then cos over log-spaced
    timescales up to 10000."""
    inc = np.log(10_000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], 1)).float()


def _gelu(x):
    return F.gelu(x, approximate="none")


@torch.no_grad()
def encode(tree: dict, heads: int, mel: torch.Tensor,
           weights: Weights = None) -> torch.Tensor:
    """``mel[B, T, n_mels]`` -> encoder output ``[B, T // 2, d]``."""
    enc = tree["encoder"]
    x = mel.float().transpose(1, 2)
    x = _gelu(F.conv1d(x, _w(enc["conv1"]["w"], weights).permute(2, 1, 0),
                       enc["conv1"]["b"].float(), padding=1))
    x = _gelu(F.conv1d(x, _w(enc["conv2"]["w"], weights).permute(2, 1, 0),
                       enc["conv2"]["b"].float(), stride=2, padding=1))
    x = x.transpose(1, 2)
    x = x + sinusoids(x.shape[1], x.shape[2]).to(x.device)
    for blk in enc["blocks"]:
        h = _ln(x, blk["attn_ln"])
        a = blk["attn"]
        x = x + _lin(_attend(_lin(h, a["q"], weights), _lin(h, a["k"], weights),
                             _lin(h, a["v"], weights), heads, False),
                     a["out"], weights)
        h = _ln(x, blk["mlp_ln"])
        x = x + _lin(_gelu(_lin(h, blk["mlp"]["fc1"], weights)),
                     blk["mlp"]["fc2"], weights)
    return _ln(x, enc["ln_post"])


@torch.no_grad()
def decoder_logits(tree: dict, heads: int, enc: torch.Tensor,
                   tokens: torch.Tensor, weights: Weights = None,
                   kv: Optional[list] = None) -> torch.Tensor:
    """Teacher-forced decoder over ``tokens[B, L]`` (the prompt, then the
    served tokens but the last) against ``enc[B, T, d]``: logits ``[B, L,
    vocab]`` of the tied embedding, position i predicting token i + 1.
    ``kv``, where given, receives each layer's self-attention keys and
    values ``([B, L, d], [B, L, d])``: what a decoder caches."""
    dec = tree["decoder"]
    emb = dec["token_emb"].float()
    x = emb[tokens] + dec["pos_emb"].float()[:tokens.shape[1]]
    for blk in dec["blocks"]:
        h = _ln(x, blk["attn_ln"])
        a = blk["attn"]
        k, v = _lin(h, a["k"], weights), _lin(h, a["v"], weights)
        if kv is not None:
            kv.append((k, v))
        x = x + _lin(_attend(_lin(h, a["q"], weights), k, v, heads, True),
                     a["out"], weights)
        h = _ln(x, blk["cross_ln"])
        c = blk["cross"]
        x = x + _lin(_attend(_lin(h, c["q"], weights), _lin(enc, c["k"], weights),
                             _lin(enc, c["v"], weights), heads, False),
                     c["out"], weights)
        h = _ln(x, blk["mlp_ln"])
        x = x + _lin(_gelu(_lin(h, blk["mlp"]["fc1"], weights)),
                     blk["mlp"]["fc2"], weights)
    return _ln(x, dec["ln"]) @ emb.T
