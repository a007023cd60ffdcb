"""Whisper-class recognizer: conv stem + pre-LN transformer encoder, KV-
cached greedy text decoder with tied-embedding fp32 logits.

Plain functions over the parameter trees of :mod:`.params` (the JAX
package's layouts). Layer loops are Python loops; the encoder's self-
attention goes through the fused attention kernel (:mod:`..ops.flash`);
with ``cross_kv_int8`` the decoder's cross-attention runs over int8 K/V
through the K4 kernel (:mod:`..ops.cross_attn`).

Under a mesh (:func:`~..parallel.collectives.use_mesh`) the parameters
are this rank's shards by ``ASR_PARTITION_RULES`` and every attention and
MLP is tensor-parallel over ``model``: H / tp local heads, column-parallel
q/k/v and ``fc1``, row-parallel ``out`` and ``fc2`` (one all-reduce per
sublayer), in the encoder and in the decoder's self- and cross-attention.
``encode_audio(..., sp_mesh=)`` runs the encoder sequence-parallel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from janus_tpu_torch.common.config import ASRConfig
from janus_tpu_torch.ops.attention import KVCache, attend, merge_heads, split_heads
from janus_tpu_torch.ops.cross_attn import cross_attention_kv
from janus_tpu_torch.ops.flash import flash_attention
from janus_tpu_torch.ops.layers import (conv1d, embedding_lookup, gelu,
                                        layer_norm, linear, row_linear,
                                        sinusoid_positions)
from janus_tpu_torch.ops.mel_fused import log_mel_spectrogram_fused
from janus_tpu_torch.ops.quant import quantize_kv_t
from janus_tpu_torch.parallel.collectives import (all_gather, axis_index,
                                                  axis_size, enter_model,
                                                  local_heads)
from janus_tpu_torch.parallel.ring_attention import ring_attention

__all__ = [
    "encode_audio",
    "DecodeState",
    "init_decode_state",
    "decoder_prefill",
    "decoder_step",
    "greedy_decode",
    "prepare_mel",
    "transcribe_mel",
]

Params = Dict


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------

def _attention(p: Params, x: torch.Tensor, num_heads: int,
               sp_mesh=None) -> torch.Tensor:
    x = enter_model(x)
    heads = local_heads(num_heads, p["q"]["w"])
    q = split_heads(linear(x, p["q"]["w"], p["q"]["b"]), heads)
    k = split_heads(linear(x, p["k"]["w"], p["k"].get("b")), heads)
    v = split_heads(linear(x, p["v"]["w"], p["v"]["b"]), heads)
    # No mask: frames past a phrase's end (zero audio padded to the bucket)
    # are attended like real frames, exactly as the JAX encoder does —
    # results match it, and a phrase's text may depend on its bucket.
    if sp_mesh is not None:
        # frames split over "seq": exact attention by the K/V ring
        o = ring_attention(q, k, v, sp_mesh, axis_name="seq")
    else:
        o = flash_attention(q, k, v)
    return row_linear(merge_heads(o), p["out"]["w"], p["out"]["b"])


def _mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = enter_model(x)
    return row_linear(gelu(linear(x, p["fc1"]["w"], p["fc1"]["b"])),
                      p["fc2"]["w"], p["fc2"]["b"])


def encode_audio(params: Params, cfg: ASRConfig, mel: torch.Tensor,
                 sp_mesh=None) -> torch.Tensor:
    """``mel[..., T, n_mels] -> enc[..., T//2, d_model]`` (T even).

    With ``sp_mesh`` (a mesh with a ``seq`` dimension) the encoder runs
    sequence-parallel: the conv stem runs replicated on the whole mel (as
    the JAX package's GSPMD program shards only after it), each rank keeps
    its stretch of the T/2 encoder frames with sinusoid positions at the
    stretch's global offset, self-attention is exact through
    :func:`~..parallel.ring_attention.ring_attention`, and the output is
    all-gathered over ``seq``, so every rank returns it whole. T/2 must
    divide by the ``seq`` size."""
    enc = params["encoder"]
    if sp_mesh is not None:
        n = axis_size(sp_mesh, "seq")
        t = mel.shape[-2] // 2
        if mel.shape[-2] % 2 or t % n:
            raise ValueError(f"{mel.shape[-2]} mel frames: the {t} encoder "
                             f"frames do not split over |seq|={n}")
    x = gelu(conv1d(mel, enc["conv1"]["w"], enc["conv1"]["b"], stride=1,
                    padding=1))
    x = gelu(conv1d(x, enc["conv2"]["w"], enc["conv2"]["b"], stride=2,
                    padding=1))
    pos = sinusoid_positions(x.shape[-2], cfg.d_model, device=x.device)
    if sp_mesh is not None:
        me = axis_index(sp_mesh, "seq")
        lo, hi = me * t // n, (me + 1) * t // n
        x, pos = x[..., lo:hi, :], pos[lo:hi]
    x = x + pos.to(x.dtype)
    for blk in enc["blocks"]:
        x = x + _attention(blk["attn"], layer_norm(x, **blk["attn_ln"]),
                           cfg.num_heads, sp_mesh=sp_mesh)
        x = x + _mlp(blk["mlp"], layer_norm(x, **blk["mlp_ln"]))
    x = layer_norm(x, **enc["ln_post"])
    if sp_mesh is not None:
        x = all_gather(x, sp_mesh, "seq", dim=-2)
    return x


# --------------------------------------------------------------------------
# decoder
# --------------------------------------------------------------------------

class DecodeState:
    """Per-layer self-attention caches (written in place) plus per-layer
    cross-attention K/V precomputed from the encoder output: dense
    ``[..., H, T, Dh]`` tensors or int8 :class:`~..ops.quant.QuantKVT`."""

    def __init__(self, self_caches: List[KVCache], cross_k: List,
                 cross_v: List):
        self.self_caches = self_caches
        self.cross_k = cross_k
        self.cross_v = cross_v

    @property
    def fill(self) -> int:
        """Fill count every lane shares (layers advance together)."""
        return self.self_caches[0].length


def init_decode_state(params: Params, cfg: ASRConfig, enc: torch.Tensor,
                      max_len: Optional[int] = None, dtype=torch.float32,
                      cross_kv_int8: bool = False) -> DecodeState:
    """``cross_kv_int8`` stores each layer's cross K/V int8 with
    per-position scales in the head-dim-major layout of the K4 kernel
    (:func:`~..ops.quant.quantize_kv_t`)."""
    batch_shape = tuple(enc.shape[:-2])
    if max_len is None:
        max_len = cfg.max_target_positions
    blocks = params["decoder"]["blocks"]
    heads = local_heads(cfg.num_heads, blocks[0]["cross"]["k"]["w"])
    head_dim = cfg.d_model // cfg.num_heads
    enc = enter_model(enc)
    caches, ks, vs = [], [], []
    for blk in blocks:
        caches.append(KVCache.create(batch_shape, heads, max_len,
                                     head_dim, dtype=dtype, device=enc.device))
        p = blk["cross"]
        ks.append(split_heads(linear(enc, p["k"]["w"], p["k"].get("b")),
                              heads))
        vs.append(split_heads(linear(enc, p["v"]["w"], p["v"]["b"]), heads))
    if cross_kv_int8:
        ks = [quantize_kv_t(k) for k in ks]
        vs = [quantize_kv_t(v) for v in vs]
    return DecodeState(caches, ks, vs)


def _self_qkv(blk: Params, cfg: ASRConfig, x: torch.Tensor):
    """Pre-norm + self-attention projections (fused ``qkv`` when the tree
    was prepared by :func:`..params.prepare_decode_params`)."""
    h = enter_model(layer_norm(x, **blk["attn_ln"]))
    p = blk["attn"]
    if "qkv" in p:
        heads = local_heads(cfg.num_heads, p["qkv"]["w"], parts=3)
        qkv = linear(h, p["qkv"]["w"], p["qkv"]["b"]).chunk(3, dim=-1)
        return tuple(split_heads(t, heads) for t in qkv)
    heads = local_heads(cfg.num_heads, p["q"]["w"])
    return (split_heads(linear(h, p["q"]["w"], p["q"]["b"]), heads),
            split_heads(linear(h, p["k"]["w"], p["k"].get("b")), heads),
            split_heads(linear(h, p["v"]["w"], p["v"]["b"]), heads))


def _decoder_layer(blk: Params, cfg: ASRConfig, x: torch.Tensor,
                   cache: KVCache, cross_k, cross_v,
                   t_new: int) -> torch.Tensor:
    """Cached self-attn → cross-attn → MLP (the cache is appended to in
    place)."""
    q, k, v = _self_qkv(blk, cfg, x)
    cache.append_lockstep(k, v)
    mask = cache.valid_mask(t_new)
    p = blk["attn"]
    x = x + row_linear(merge_heads(attend(q, cache.k, cache.v, mask)),
                       p["out"]["w"], p["out"]["b"])
    h = enter_model(layer_norm(x, **blk["cross_ln"]))
    pc = blk["cross"]
    qc = split_heads(linear(h, pc["q"]["w"], pc["q"]["b"]),
                     local_heads(cfg.num_heads, pc["q"]["w"]))
    x = x + row_linear(merge_heads(cross_attention_kv(qc, cross_k, cross_v)),
                       pc["out"]["w"], pc["out"]["b"])
    return x + _mlp(blk["mlp"], layer_norm(x, **blk["mlp_ln"]))


def _decoder_forward(params: Params, cfg: ASRConfig, tokens: torch.Tensor,
                     pos_offset: int, state: DecodeState
                     ) -> Tuple[torch.Tensor, DecodeState]:
    """``tokens[..., T_new]`` through the decoder, appending to the caches
    in place. Returns fp32 logits ``[..., T_new, vocab]`` and the state."""
    dec = params["decoder"]
    t_new = tokens.shape[-1]
    positions = pos_offset + torch.arange(t_new, device=tokens.device)
    x = embedding_lookup(dec["token_emb"], tokens)
    x = x + embedding_lookup(dec["pos_emb"], positions)
    for i, blk in enumerate(dec["blocks"]):
        x = _decoder_layer(blk, cfg, x, state.self_caches[i],
                           state.cross_k[i], state.cross_v[i], t_new)
    x = layer_norm(x, **dec["ln"])
    # tied embedding, products accumulated in fp32
    logits = torch.matmul(x.float(), dec["token_emb"].float().T)
    return logits, state


def decoder_prefill(params: Params, cfg: ASRConfig, prompt: torch.Tensor,
                    state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """The prompt in one pass; logits of its last position."""
    logits, state = _decoder_forward(params, cfg, prompt, 0, state)
    return logits[..., -1, :], state


def decoder_step(params: Params, cfg: ASRConfig, token: torch.Tensor,
                 state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """One autoregressive step: ``token[...]`` → logits ``[..., vocab]``."""
    logits, state = _decoder_forward(params, cfg, token[..., None],
                                     state.fill, state)
    return logits[..., 0, :], state


@torch.no_grad()
def greedy_decode(params: Params, cfg: ASRConfig, enc: torch.Tensor,
                  prompt: torch.Tensor, eot_id: int,
                  max_new: Optional[int] = None,
                  cache_dtype=torch.float32,
                  cross_kv_int8: bool = False) -> torch.Tensor:
    """Batched greedy search: ``[B, max_new]`` int32 tokens, padded with
    ``eot_id`` after each lane finishes; stops once every lane has
    emitted eot (one host sync per step reads that flag).
    ``cross_kv_int8`` as in :func:`init_decode_state`. Runs without
    autograd: with parameters that require gradients, a graph over every
    layer and step would otherwise be held until the tokens are read."""
    if max_new is None:
        max_new = cfg.max_decode_tokens
    cache_len = prompt.shape[-1] + max_new
    state = init_decode_state(params, cfg, enc, max_len=cache_len,
                              dtype=cache_dtype, cross_kv_int8=cross_kv_int8)
    first_logits, state = decoder_prefill(params, cfg, prompt, state)
    first_tok = torch.argmax(first_logits, dim=-1).to(torch.int32)

    batch = prompt.shape[0]
    out = torch.full((batch, max_new), eot_id, dtype=torch.int32,
                     device=enc.device)
    out[:, 0] = first_tok
    done = first_tok == eot_id
    for step in range(1, max_new):
        if bool(done.all()):
            break
        logits, state = decoder_step(params, cfg, out[:, step - 1].long(),
                                     state)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, eot_id), nxt)
        out[:, step] = nxt
        done = done | (nxt == eot_id)
    return out


# --------------------------------------------------------------------------
# frontend
# --------------------------------------------------------------------------

def prepare_mel(audio_16k: torch.Tensor, cfg: ASRConfig,
                pad_to_frames: Optional[int] = None) -> torch.Tensor:
    """16 kHz audio ``[..., T]`` → log-mel ``[..., frames, n_mels]``,
    padded/trimmed to a static frame count (default 30 s)."""
    if pad_to_frames is None:
        pad_to_frames = 2 * cfg.max_source_positions
    target = pad_to_frames * cfg.hop_length
    t = audio_16k.shape[-1]
    if t < target:
        audio_16k = F.pad(audio_16k, (0, target - t))
    else:
        audio_16k = audio_16k[..., :target]
    return log_mel_spectrogram_fused(audio_16k, n_fft=cfg.n_fft,
                                     hop=cfg.hop_length, n_mels=cfg.n_mels)


@torch.no_grad()
def transcribe_mel(params: Params, cfg: ASRConfig, mel: torch.Tensor,
                   prompt: torch.Tensor, eot_id: int,
                   max_new: Optional[int] = None,
                   cache_dtype=torch.float32) -> torch.Tensor:
    """mel ``[B, frames, n_mels]`` → token ids ``[B, max_new]``: the
    encoder, then the greedy decode."""
    enc = encode_audio(params, cfg, mel)
    return greedy_decode(params, cfg, enc, prompt, eot_id, max_new,
                         cache_dtype=cache_dtype)
