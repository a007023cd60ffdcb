"""LLM-conditioned TTS acoustic model.

An autoregressive decoder-only transformer in place of the reference's
cloud TTS call (reference: backend/services/synthesizer.py:177-207):

    [SPK] [EMO] text-bytes [BOA] → mel frame groups … [stop]

- One transformer attends causally over the whole prompt + audio prefix;
  text enters through token embeddings, generated mel re-enters through a
  prenet projection, so text and audio share every layer.
- Emotion is a reserved token id: the categorical prosody tags of the
  wire packet select it.
- The speaker slot [SPK] carries the voice-cloning vector of
  :mod:`janus_tpu_torch.models.speaker`.
- ``reduction`` mel frames are emitted per step; a stop head ends
  generation inside a fixed frame budget.

Generation is KV-cached: the prompt is prefilled in one pass, then each
step appends exactly one position. Parameters are a tree of tensors with
per-layer ``blocks`` (see :mod:`janus_tpu_torch.models.params`); caches
are written in place.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from janus_tpu_torch.common.config import TTSConfig
from janus_tpu_torch.models.params import (_init_attn, _init_ln, _init_mlp,
                                           _normal, _zeros)
from janus_tpu_torch.ops.attention import (KVCache, attend, merge_heads,
                                           split_heads)
from janus_tpu_torch.ops.layers import (embedding_lookup, gelu, layer_norm,
                                        linear)

__all__ = [
    "EMOTIONS",
    "emotion_id",
    "special_ids",
    "init_tts",
    "tts_forward",
    "tts_generate",
    "tts_prefill",
    "tts_decode_chunk",
    "prestack_tts",
    "TTSState",
    "audio_pos_base",
    "text_bucket",
    "text_buckets",
]

Params = Dict

# Emotion vocabulary: union of the send-side TTS tags
# (reference: backend/services/synthesizer.py:158-175), the API overrides
# (reference: backend/api/types.py:18-21), and the receive-side UI tags.
EMOTIONS = (
    "neutral", "excited", "joyful", "whispering", "shouting", "sad",
    "relaxed", "panicked", "serious", "calm", "angry", "auto",
)

# The sampling loops read their ``done`` flags back (a device -> host
# wait) once every this many steps, not every step. A finished lane writes
# zeros and keeps its count, so leaving the loop late changes nothing.
_DONE_CHECK_EVERY = 8


def emotion_id(tag: str) -> int:
    tag = tag.lower()
    return EMOTIONS.index(tag) if tag in EMOTIONS else 0


class _SpecialIds:
    """Token-space layout: [0, text_vocab) bytes+text specials, then
    emotions, then control tokens."""

    def __init__(self, text_vocab: int):
        self.emotion_base = text_vocab
        self.boa = text_vocab + len(EMOTIONS)      # begin-of-audio
        self.spk = text_vocab + len(EMOTIONS) + 1  # speaker slot
        self.total = text_vocab + len(EMOTIONS) + 2


def special_ids(text_vocab: int) -> _SpecialIds:
    return _SpecialIds(text_vocab)


def init_tts(generator: torch.Generator, cfg: TTSConfig,
             text_vocab: int = 261) -> Params:
    """Random tree (normal 0.02 weights, zero biases, unit norm scales) on
    the generator's device, float32."""
    g, d = generator, cfg.d_model
    ids = special_ids(text_vocab)
    blocks = [
        {"attn_ln": _init_ln(g, d), "attn": _init_attn(g, d),
         "mlp_ln": _init_ln(g, d), "mlp": _init_mlp(g, d, cfg.mlp_ratio)}
        for _ in range(cfg.layers)
    ]
    r_mels = cfg.reduction * cfg.n_mels
    max_pos = cfg.max_text_tokens + cfg.max_mel_frames // cfg.reduction + 8
    return {
        "token_emb": _normal(g, (ids.total, d)),
        "pos_emb": _normal(g, (max_pos, d)),
        "prenet": {
            "fc1": {"w": _normal(g, (r_mels, d)), "b": _zeros(g, d)},
            "fc2": {"w": _normal(g, (d, d)), "b": _zeros(g, d)},
        },
        "spk_proj": {"w": _normal(g, (d, d)), "b": _zeros(g, d)},
        "blocks": blocks,
        "ln": _init_ln(g, d),
        "mel_head": {"w": _normal(g, (d, r_mels)), "b": _zeros(g, r_mels)},
        "stop_head": {"w": _normal(g, (d, 1)), "b": _zeros(g, 1)},
    }


def prestack_tts(params: Params) -> Params:
    """Kept by name for callers of the JAX package's ``prestack_tts``: the
    port's layer loop is plain Python over per-layer ``blocks``, so there
    is nothing to stack (a layer-stacked tree from the JAX package is
    unstacked by :func:`~janus_tpu_torch.models.params.params_from_jax`)."""
    return params


def _embed_mel(params: Params, mel_groups: torch.Tensor) -> torch.Tensor:
    """``[..., S, r*n_mels] -> [..., S, d]`` prenet."""
    p = params["prenet"]
    h = gelu(linear(mel_groups, p["fc1"]["w"], p["fc1"]["b"]))
    return linear(h, p["fc2"]["w"], p["fc2"]["b"])


def _block(blk: Params, x: torch.Tensor, num_heads: int, cache: KVCache,
           mask: Optional[torch.Tensor]):
    """One pre-norm block over ``x[B, S, d]``, appending to ``cache`` in
    place. ``mask`` is the causal mask of an earlier layer of this pass
    (every layer's cache has the same capacity and fill) or None; the
    mask used is returned beside the output."""
    h = layer_norm(x, **blk["attn_ln"])
    p = blk["attn"]
    q = split_heads(linear(h, p["q"]["w"], p["q"]["b"]), num_heads)
    k = split_heads(linear(h, p["k"]["w"], p["k"].get("b")), num_heads)
    v = split_heads(linear(h, p["v"]["w"], p["v"]["b"]), num_heads)
    cache.append_lockstep(k, v)
    if mask is None:
        mask = cache.valid_mask(x.shape[-2])
    x = x + linear(merge_heads(attend(q, cache.k, cache.v, mask)),
                   p["out"]["w"], p["out"]["b"])
    h = layer_norm(x, **blk["mlp_ln"])
    h = linear(gelu(linear(h, blk["mlp"]["fc1"]["w"], blk["mlp"]["fc1"]["b"])),
               blk["mlp"]["fc2"]["w"], blk["mlp"]["fc2"]["b"])
    return x + h, mask


class TTSState(NamedTuple):
    """Per-layer KV caches, written in place as generation advances."""

    caches: Tuple[KVCache, ...]

    @property
    def fill(self) -> int:
        return self.caches[0].length


def _make_state(cfg: TTSConfig, batch: int, cache_len: int,
                dtype=torch.float32, device="cpu") -> TTSState:
    head_dim = cfg.d_model // cfg.num_heads
    return TTSState(tuple(
        KVCache.create((batch,), cfg.num_heads, cache_len, head_dim,
                       dtype=dtype, device=device)
        for _ in range(cfg.layers)))


def text_bucket(n: int, max_text_tokens: int, floor: int = 8) -> int:
    """Smallest power-of-two text width ≥ n (≥ ``floor``, capped at
    ``max_text_tokens``). Serving pads prompts to these buckets and
    training jitters prompt widths over the same set, so any bucket is an
    in-distribution prompt length."""
    b = floor
    while b < n and b < max_text_tokens:
        b *= 2
    return min(b, max_text_tokens)


def text_buckets(max_text_tokens: int, floor: int = 8) -> Tuple[int, ...]:
    """All serving text buckets for a config (see :func:`text_bucket`)."""
    out = []
    b = floor
    while b < max_text_tokens:
        out.append(b)
        b *= 2
    out.append(max_text_tokens)
    return tuple(out)


def audio_pos_base(cfg: TTSConfig) -> int:
    """First position index of the audio stream.

    Audio tokens get positions ``audio_pos_base + group_index`` whatever
    the prompt's actual length, so generation dynamics are identical for
    any text length ≤ ``max_text_tokens``."""
    return cfg.max_text_tokens + 3  # [SPK] [EMO] text [BOA]


def _pos_rows(params: Params, start: int, n: int) -> torch.Tensor:
    """Rows ``[start, start + n)`` of the position table. A gather in the
    JAX package clamps an index past the table; here that is an error."""
    table = params["pos_emb"]
    if start < 0 or start + n > table.shape[0]:
        raise ValueError(
            f"positions {start}..{start + n - 1} lie outside the position "
            f"table of {table.shape[0]} rows (max_text_tokens + "
            f"max_mel_frames // reduction + 8)")
    return table[start:start + n]


def _forward_embedded(params: Params, cfg: TTSConfig, x: torch.Tensor,
                      pos: torch.Tensor, state: TTSState
                      ) -> Tuple[torch.Tensor, torch.Tensor, TTSState]:
    """Shared trunk over already-embedded inputs ``[B, S, d]`` and their
    position rows ``pos[S, d]``. Returns (mel_out [B, S, r*n_mels],
    stop_logit [B, S], state); the caches are appended to in place."""
    x = x + pos
    mask = None
    for blk, cache in zip(params["blocks"], state.caches):
        x, mask = _block(blk, x, cfg.num_heads, cache, mask)
    x = layer_norm(x, **params["ln"])
    mel = linear(x, params["mel_head"]["w"], params["mel_head"]["b"])
    stop = linear(x, params["stop_head"]["w"], params["stop_head"]["b"])[..., 0]
    return mel, stop, state


def _prompt_embedding(params: Params, cfg: TTSConfig, text_ids: torch.Tensor,
                      emotion: torch.Tensor, speaker: Optional[torch.Tensor],
                      text_vocab: int) -> torch.Tensor:
    """Build ``[B, P, d]`` prompt: [SPK] [EMO] text [BOA]."""
    ids = special_ids(text_vocab)
    b = text_ids.shape[0]
    text_ids = text_ids.long()
    emo_tok = ids.emotion_base + emotion.long()  # [B]
    spk_tok = torch.full((b,), ids.spk, dtype=torch.long,
                         device=text_ids.device)
    boa_tok = torch.full((b,), ids.boa, dtype=torch.long,
                         device=text_ids.device)
    seq = torch.cat([spk_tok[:, None], emo_tok[:, None], text_ids,
                     boa_tok[:, None]], dim=1)
    x = embedding_lookup(params["token_emb"], seq)
    if speaker is not None:
        spk_emb = linear(speaker, params["spk_proj"]["w"],
                         params["spk_proj"]["b"])
        # out of place: slot 0 plus the projected vector, in x's dtype
        x = torch.cat([x[:, :1] + spk_emb[:, None].to(x.dtype), x[:, 1:]],
                      dim=1)
    return x


def tts_forward(params: Params, cfg: TTSConfig, text_ids: torch.Tensor,
                emotion: torch.Tensor, mel_groups: torch.Tensor,
                speaker: Optional[torch.Tensor] = None, text_vocab: int = 261,
                mel_inputs: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced pass.

    ``text_ids[B, Lt]``, ``mel_groups[B, S, r*n_mels]`` (targets). Returns
    (mel_pred[B, S, r*n_mels], stop_logits[B, S]): position i predicts
    group i from prompt + groups < i. ``mel_inputs`` optionally replaces
    the teacher-forced audio prefix (noise-corrupted prefixes in training;
    the targets stay ``mel_groups``). The caches of this pass are fp32."""
    prompt = _prompt_embedding(params, cfg, text_ids, emotion, speaker,
                               text_vocab)
    # shift mel right: inputs are groups [:-1], the first audio input is
    # the BOA slot
    src = mel_groups if mel_inputs is None else mel_inputs
    mel_in = _embed_mel(params, src[:, :-1, :])
    x = torch.cat([prompt, mel_in], dim=1)  # promotes like jnp.concatenate

    b, total, p = text_ids.shape[0], x.shape[1], prompt.shape[1]
    # prompt at 0..P-1; audio groups at the fixed base (audio_pos_base)
    pos = torch.cat([_pos_rows(params, 0, p),
                     _pos_rows(params, audio_pos_base(cfg), total - p)])
    state = _make_state(cfg, b, total, device=x.device)
    mel, stop, _ = _forward_embedded(params, cfg, x, pos, state)
    # outputs at positions [p-1, total): predictions for each mel group
    return mel[:, p - 1:, :], stop[:, p - 1:]


def tts_prefill(params: Params, cfg: TTSConfig, text_ids: torch.Tensor,
                emotion: torch.Tensor, speaker: Optional[torch.Tensor] = None,
                max_groups: Optional[int] = None, text_vocab: int = 261,
                stop_threshold: float = 0.5
                ) -> Tuple[torch.Tensor, torch.Tensor, TTSState]:
    """Prompt prefill: ``(group0[B, r*n_mels], done[B], state)``, the
    first step of :func:`tts_generate` with the KV state exposed, so that
    a caller can drive generation in chunks (streaming synthesis).

    The generation caches are in ``cfg.dtype`` whatever the parameters'
    dtype (the fp32 caches are the teacher-forced pass's only)."""
    if max_groups is None:
        max_groups = cfg.max_mel_frames // cfg.reduction
    b = text_ids.shape[0]
    prompt = _prompt_embedding(params, cfg, text_ids, emotion, speaker,
                               text_vocab)
    state = _make_state(cfg, b, prompt.shape[1] + max_groups,
                        dtype=getattr(torch, cfg.dtype), device=prompt.device)
    mel0, stop0, state = _forward_embedded(
        params, cfg, prompt, _pos_rows(params, 0, prompt.shape[1]), state)
    first = mel0[:, -1, :]  # prediction for group 0
    done = torch.sigmoid(stop0[:, -1]) > stop_threshold
    return first, done, state


def _step(params: Params, cfg: TTSConfig, state: TTSState,
          prev: torch.Tensor, done: torch.Tensor, group: int,
          stop_threshold: float):
    """One AR step: ``prev[B, r*n_mels]`` (group ``group``) in, group
    ``group + 1`` out (zeros for a finished lane), and the new flags."""
    x = _embed_mel(params, prev[:, None, :])
    # audio group g sits at the fixed position base + g, whatever the
    # prompt length (audio_pos_base)
    pos = _pos_rows(params, audio_pos_base(cfg) + group, 1)
    mel, stop, _ = _forward_embedded(params, cfg, x, pos, state)
    nxt = mel[:, 0, :].float().masked_fill(done[:, None], 0.0)
    return nxt, done | (torch.sigmoid(stop[:, 0]) > stop_threshold)


def tts_generate(params: Params, cfg: TTSConfig, text_ids: torch.Tensor,
                 emotion: torch.Tensor, speaker: Optional[torch.Tensor] = None,
                 max_groups: Optional[int] = None, text_vocab: int = 261,
                 stop_threshold: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached autoregressive sampling.

    Returns ``(mel[B, max_groups*r, n_mels], n_frames[B])``: generated
    frames in float32 (zeros after a lane's stop) and the per-sequence
    valid frame count. Every step re-enters through the prenet from the
    float32 output buffer, so under bf16 parameters the steps run float32
    activations against bf16 weights, as in the JAX package."""
    if max_groups is None:
        max_groups = cfg.max_mel_frames // cfg.reduction
    b = text_ids.shape[0]
    r_mels = cfg.reduction * cfg.n_mels
    first, done, state = tts_prefill(
        params, cfg, text_ids, emotion, speaker=speaker,
        max_groups=max_groups, text_vocab=text_vocab,
        stop_threshold=stop_threshold)

    out = torch.zeros((b, max_groups, r_mels), dtype=torch.float32,
                      device=first.device)
    out[:, 0, :] = first
    n_groups = torch.ones((b,), dtype=torch.int32, device=first.device)
    for step in range(1, max_groups):
        # the JAX loop tests ``all(done)`` before every step; here the
        # flags are read back every _DONE_CHECK_EVERY steps only
        if step % _DONE_CHECK_EVERY == 1 and bool(done.all()):
            break
        was_done = done
        nxt, done = _step(params, cfg, state, out[:, step - 1, :], done,
                          step - 1, stop_threshold)
        out[:, step, :] = nxt
        n_groups = torch.where(was_done, n_groups, step + 1)
    mel = out.reshape(b, max_groups * cfg.reduction, cfg.n_mels)
    return mel, n_groups * cfg.reduction


def tts_decode_chunk(params: Params, cfg: TTSConfig, state: TTSState,
                     prev_group: torch.Tensor, done: torch.Tensor,
                     start_group: int, n_steps: int,
                     stop_threshold: float = 0.5):
    """Generate ``n_steps`` further mel groups from a prefilled state.

    ``prev_group[B, r*n_mels]`` is the last generated group (input to the
    first step) and ``start_group`` its index. Returns ``(groups[B,
    n_steps, r*n_mels], dones[B, n_steps], last_group, done, state)`` with
    zeros after each sequence's stop, matching what :func:`tts_generate`
    writes into its output buffer. ``dones[:, i]`` is the flag BEFORE
    group i was emitted (True: that group is padding zeros). No flag is
    read back here: the caller reads ``dones`` once per chunk."""
    prev = prev_group.float()
    groups, dones = [], []
    for step in range(n_steps):
        dones.append(done)
        prev, done = _step(params, cfg, state, prev, done,
                           int(start_group) + step, stop_threshold)
        groups.append(prev)
    return (torch.stack(groups, dim=1), torch.stack(dones, dim=1), prev,
            done, state)
