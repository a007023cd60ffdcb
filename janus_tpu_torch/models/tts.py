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
are written in place. Under a mesh
(:func:`~janus_tpu_torch.parallel.collectives.use_mesh`) the blocks are
tensor-parallel over ``model`` by ``TTS_PARTITION_RULES``: local heads,
column-parallel q/k/v and ``fc1``, row-parallel ``out`` and ``fc2``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from janus_tpu_torch.common.config import TTSConfig
from janus_tpu_torch.models.params import (_init_attn, _init_ln, _init_mlp,
                                           _normal, _zeros)
from janus_tpu_torch.ops.attention import KVCache, merge_heads, split_heads
from janus_tpu_torch.ops.decode_attention import attend_cache
from janus_tpu_torch.ops.layers import (add_layer_norm, embedding_lookup,
                                        linear, linear_gelu, linear_group,
                                        row_linear)
from janus_tpu_torch.parallel.collectives import enter_model, local_heads
from janus_tpu_torch.runtime.step_graph import (LoopGraph, StepChain,
                                                StepGraph, StepGraphs,
                                                default_graphs, use_graphs)

__all__ = [
    "EMOTIONS",
    "emotion_id",
    "special_ids",
    "init_tts",
    "tts_forward",
    "tts_generate",
    "tts_prefill",
    "tts_decode_chunk",
    "ARGraph",
    "ar_graph",
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
    h = linear_gelu(mel_groups, p["fc1"]["w"], p["fc1"]["b"])
    return linear(h, p["fc2"]["w"], p["fc2"]["b"])


def _block(blk: Params, x: torch.Tensor, delta: torch.Tensor,
           num_heads: int, cache: KVCache,
           fill: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block over ``x + delta`` (``[B, S, d]``; ``delta``: the
    output before it, not yet added), appending to ``cache`` in place (at
    the device position ``fill`` when one is given, else at the cache's
    fill count, which advances). Each residual add is taken into the norm
    that reads the sum (:func:`~..ops.layers.add_layer_norm`); returns
    ``(x, delta)`` with the MLP's output pending. The attention writes the
    step's K/V and sees the caches' causal mask at the fill point (the
    decode kernel on the card for a step, ``attend`` for a wide
    prompt). q, k and v read the same rows: one launch of the mixed
    kernel where it takes them (:func:`~..ops.layers.linear_group`), and
    fc1's GELU in its epilogue (:func:`~..ops.layers.linear_gelu`)."""
    x, h = add_layer_norm(x, delta, **blk["attn_ln"])
    h = enter_model(h)
    p = blk["attn"]
    heads = local_heads(num_heads, p["q"]["w"])
    q, k, v = (split_heads(t, heads) for t in linear_group(
        h, [(p["q"]["w"], p["q"]["b"]), (p["k"]["w"], p["k"].get("b")),
            (p["v"]["w"], p["v"]["b"])]))
    x, h = add_layer_norm(x, row_linear(
        merge_heads(attend_cache(q, cache, k, v, fill)), p["out"]["w"],
        p["out"]["b"]), **blk["mlp_ln"])
    h = enter_model(h)
    return x, row_linear(linear_gelu(h, blk["mlp"]["fc1"]["w"],
                                     blk["mlp"]["fc1"]["b"]),
                         blk["mlp"]["fc2"]["w"], blk["mlp"]["fc2"]["b"])


class TTSState(NamedTuple):
    """Per-layer KV caches, written in place as generation advances. A
    state that :func:`tts_prefill` filled on the card also names the
    :class:`ARGraph` whose static caches it holds and that holder's
    ``epoch`` at the prefill (a later prefill on the holder refills it)."""

    caches: Tuple[KVCache, ...]
    graph: Optional["ARGraph"] = None
    epoch: int = 0

    @property
    def fill(self) -> int:
        return self.caches[0].length


def _make_state(params: Params, cfg: TTSConfig, batch: int, cache_len: int,
                dtype=torch.float32, device="cpu") -> TTSState:
    head_dim = cfg.d_model // cfg.num_heads
    heads = local_heads(cfg.num_heads, params["blocks"][0]["attn"]["q"]["w"])
    return TTSState(tuple(
        KVCache.create((batch,), heads, cache_len,
                       head_dim, dtype=dtype, device=device)
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
                      pos: torch.Tensor, state: TTSState,
                      fill: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, TTSState]:
    """Shared trunk over already-embedded inputs ``[B, S, d]`` and their
    position rows ``pos[S, d]``. Returns (mel_out [B, S, r*n_mels],
    stop_logit [B, S], state); the caches are appended to in place, at
    their ``length`` or, for a captured step, at the 0-dim device tensor
    ``fill`` (``length`` is then the caller's to keep)."""
    # the position rows are the first block's pending delta
    delta = pos
    for blk, cache in zip(params["blocks"], state.caches):
        x, delta = _block(blk, x, delta, cfg.num_heads, cache, fill)
    _, x = add_layer_norm(x, delta, **params["ln"])
    # the two heads read the same rows: one launch where the kernel takes
    # them
    mel, stop = linear_group(x, [
        (params["mel_head"]["w"], params["mel_head"]["b"]),
        (params["stop_head"]["w"], params["stop_head"]["b"])])
    return mel, stop[..., 0], state


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
    state = _make_state(params, cfg, b, total, device=x.device)
    mel, stop, _ = _forward_embedded(params, cfg, x, pos, state)
    # outputs at positions [p-1, total): predictions for each mel group
    return mel[:, p - 1:, :], stop[:, p - 1:]


def tts_prefill(params: Params, cfg: TTSConfig, text_ids: torch.Tensor,
                emotion: torch.Tensor, speaker: Optional[torch.Tensor] = None,
                max_groups: Optional[int] = None, text_vocab: int = 261,
                stop_threshold: float = 0.5, *, eager: bool = False,
                graphs: Optional[StepGraphs] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, TTSState]:
    """Prompt prefill: ``(group0[B, r*n_mels], done[B], state)``, the
    first step of :func:`tts_generate` with the KV state exposed, so that
    a caller can drive generation in chunks (streaming synthesis).

    The generation caches are in ``cfg.dtype`` whatever the parameters'
    dtype (the fp32 caches are the teacher-forced pass's only). On the
    card (unless ``eager``, or under a mesh of more than one rank) the
    prefill is one replay of the captured prefill of an :class:`ARGraph`
    from ``graphs`` (or the module's own), into its static caches, whose
    captured step :func:`tts_decode_chunk` then launches (group0 then
    comes in float32)."""
    if max_groups is None:
        max_groups = cfg.max_mel_frames // cfg.reduction
    if use_graphs(text_ids.device, eager):
        return _prefill_graphed(params, cfg, text_ids, emotion, speaker,
                                max_groups, text_vocab, stop_threshold,
                                graphs or default_graphs("tts"))
    b = text_ids.shape[0]
    prompt = _prompt_embedding(params, cfg, text_ids, emotion, speaker,
                               text_vocab)
    state = _make_state(params, cfg, b, prompt.shape[1] + max_groups,
                        dtype=getattr(torch, cfg.dtype), device=prompt.device)
    first, done = _prefill(params, cfg, prompt, state, stop_threshold)
    return first, done, state


def _prefill(params: Params, cfg: TTSConfig, prompt: torch.Tensor,
             state: TTSState, stop_threshold: float):
    mel0, stop0, _ = _forward_embedded(
        params, cfg, prompt, _pos_rows(params, 0, prompt.shape[1]), state)
    first = mel0[:, -1, :]  # prediction for group 0
    return first, torch.sigmoid(stop0[:, -1]) > stop_threshold


def _step(params: Params, cfg: TTSConfig, state: TTSState,
          prev: torch.Tensor, done: torch.Tensor, group, stop_threshold: float,
          fill: Optional[torch.Tensor] = None):
    """One AR step: ``prev[B, r*n_mels]`` (group ``group``) in, group
    ``group + 1`` out (zeros for a finished lane), and the new flags. For
    a captured step ``group`` and ``fill`` (the caches' fill point) are
    0-dim device tensors."""
    x = _embed_mel(params, prev[:, None, :])
    # audio group g sits at the fixed position base + g, whatever the
    # prompt length (audio_pos_base)
    if fill is None:
        pos = _pos_rows(params, audio_pos_base(cfg) + group, 1)
    else:
        pos = params["pos_emb"].index_select(
            0, (group + audio_pos_base(cfg)).reshape(1))
    mel, stop, _ = _forward_embedded(params, cfg, x, pos, state, fill)
    nxt = mel[:, 0, :].float().masked_fill(done[:, None], 0.0)
    return nxt, done | (torch.sigmoid(stop[:, 0]) > stop_threshold)


def tts_generate(params: Params, cfg: TTSConfig, text_ids: torch.Tensor,
                 emotion: torch.Tensor, speaker: Optional[torch.Tensor] = None,
                 max_groups: Optional[int] = None, text_vocab: int = 261,
                 stop_threshold: float = 0.5, *, eager: bool = False,
                 graphs: Optional[StepGraphs] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached autoregressive sampling.

    Returns ``(mel[B, max_groups*r, n_mels], n_frames[B])``: generated
    frames in float32 (zeros after a lane's stop) and the per-sequence
    valid frame count. Every step re-enters through the prenet from the
    float32 output buffer, so under bf16 parameters the steps run float32
    activations against bf16 weights, as in the JAX package.

    On the card the prefill is one replay of the captured prefill of an
    :class:`ARGraph` (from ``graphs``, or the module's own) and the steps
    one launch of its loop graph: a WHILE conditional node around the
    captured step, whose condition, ``~all(done)`` within the budget, the
    card tests before every step, as the JAX package's ``lax.while_loop``
    tests its own; bit-equal to the eager steps.
    Nothing is read back before ``mel`` and ``n_frames`` are returned (the
    loop's trip count is read when the graphs are settled). On the CPU,
    with ``eager=True`` or under a mesh of more than one rank the steps
    run eagerly from Python, the flags read back before every step."""
    if max_groups is None:
        max_groups = cfg.max_mel_frames // cfg.reduction
    b = text_ids.shape[0]
    r_mels = cfg.reduction * cfg.n_mels
    if use_graphs(text_ids.device, eager):
        return _generate_graphed(params, cfg, text_ids, emotion, speaker,
                                 max_groups, text_vocab, stop_threshold,
                                 graphs or default_graphs("tts"))
    first, done, state = tts_prefill(
        params, cfg, text_ids, emotion, speaker=speaker,
        max_groups=max_groups, text_vocab=text_vocab,
        stop_threshold=stop_threshold, eager=True)

    out = torch.zeros((b, max_groups, r_mels), dtype=torch.float32,
                      device=first.device)
    out[:, 0, :] = first
    n_groups = torch.ones((b,), dtype=torch.int32, device=first.device)
    for step in range(1, max_groups):
        # the JAX loop tests ``all(done)`` before every step
        if bool(done.all()):
            break
        was_done = done
        nxt, done = _step(params, cfg, state, out[:, step - 1, :], done,
                          step - 1, stop_threshold)
        out[:, step, :] = nxt
        n_groups = torch.where(was_done, n_groups, step + 1)
    mel = out.reshape(b, max_groups * cfg.reduction, cfg.n_mels)
    return mel, n_groups * cfg.reduction


def _prefill_graphed(params, cfg, text_ids, emotion, speaker, max_groups,
                     text_vocab, stop_threshold, graphs: StepGraphs):
    """:func:`tts_prefill` through an :class:`ARGraph` of ``graphs``: its
    prefill replayed over the static caches (on the CPU run eagerly over
    them)."""
    with graphs.lock:
        return ar_graph(graphs, params, cfg, text_ids.shape[0],
                        text_ids.shape[1] + 3, max_groups, stop_threshold,
                        text_ids.device, text_vocab, _dtype_of(speaker)
                        ).prefill(text_ids, emotion, speaker)


def _generate_graphed(params, cfg, text_ids, emotion, speaker, max_groups,
                      text_vocab, stop_threshold, graphs: StepGraphs):
    """:func:`tts_generate` through an :class:`ARGraph` of ``graphs``: one
    replay of its prefill, then one run of its loop graph (on the CPU both
    eagerly), whose trips are deferred to :meth:`~janus_tpu_torch.runtime.
    step_graph.StepGraphs.settle`."""
    b = text_ids.shape[0]
    with graphs.lock:
        h = ar_graph(graphs, params, cfg, b, text_ids.shape[1] + 3,
                     max_groups, stop_threshold, text_ids.device, text_vocab,
                     _dtype_of(speaker))
        h.prefill(text_ids, emotion, speaker)
        trips = h.run_loop()
        if h.loop is not None:
            h.loop.defer(trips)
        mel = h.out[:, :max_groups].reshape(
            b, max_groups * cfg.reduction, cfg.n_mels).clone()
        return mel, h.n_groups * cfg.reduction


def _dtype_of(t: Optional[torch.Tensor]) -> Optional[torch.dtype]:
    return None if t is None else t.dtype


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
    read back here: the caller reads ``dones`` once per chunk. A state
    that :func:`tts_prefill` filled on the card launches its
    :class:`ARGraph`'s step ``n_steps`` times in one chain, as the JAX
    package's ``lax.scan`` runs every step of the chunk (``start_group``
    must then be the number of steps taken since the prefill, as a
    streaming caller's is)."""
    if state.graph is not None:
        h = state.graph
        with h.lock:
            return h.chunk(state, prev_group, done, int(start_group),
                           n_steps)
    prev = prev_group.float()
    groups, dones = [], []
    for step in range(n_steps):
        dones.append(done)
        prev, done = _step(params, cfg, state, prev, done,
                           int(start_group) + step, stop_threshold)
        groups.append(prev)
    return (torch.stack(groups, dim=1), torch.stack(dones, dim=1), prev,
            done, state)


class ARGraph:
    """The AR loop's static state for one batch, text bucket, speaker dtype
    (or none), budget and tree, and its prefill and step captured over it:
    the prompt's inputs (``text_ids[b, bucket]`` and ``emotion[b]``, one
    int64 buffer that a pinned twin fills in one copy; ``speaker[b, d]``
    where the key has one), the KV caches (in ``cfg.dtype``), the group fed
    to the step (float32, as the eager loop re-enters from its output
    buffer), the ``done`` flags, the group index (a device counter the step
    advances; the fill point is the prompt width past it), and the output
    buffers every step writes: the groups (``out``, one column past the
    budget so that a step may run to the caches' end), the flags before
    each step (``dones``) and the valid group count.

    :attr:`prefill_graph` is everything :func:`tts_prefill` does on the
    device, captured: the prompt's embedding, the caches zeroed, the
    prefill, the counters set, the loop's ``trips`` zeroed. :meth:`prefill`
    uploads the inputs and replays it; what it changes on the host (the
    epoch, the step count, each cache's fill count) :meth:`prefill` sets
    outside the graph, since a captured function's Python runs once, at
    the capture. :attr:`graph` is the step captured: :meth:`advance`
    replays it once (the host refuses a step that would write past the
    caches or read past the position table), and :meth:`chunk` serves
    :func:`tts_decode_chunk` with one launch of a :class:`~janus_tpu_torch.
    runtime.step_graph.StepChain` of its steps (one chain a chunk length).
    :attr:`loop` is the ``while_loop`` of :func:`tts_generate`
    (:class:`~janus_tpu_torch.runtime.step_graph.LoopGraph` of at most
    ``max_groups - 1`` steps around that graph), whose exit the card
    decides: :meth:`run_loop`. A budget whose loop would read past the
    position table raises here, before any capture."""

    def __init__(self, graphs: StepGraphs, params: Params, cfg: TTSConfig,
                 batch: int, prompt_len: int, max_groups: int,
                 stop_threshold: float, device: torch.device,
                 text_vocab: int = 261,
                 speaker: Optional[torch.dtype] = None):
        self.params, self.cfg = params, cfg
        self.prompt_len, self.max_groups = prompt_len, max_groups
        self.stop_threshold = stop_threshold
        self.text_vocab = text_vocab
        self.lock = graphs.lock
        rows = params["pos_emb"].shape[0]
        # the loop's last step reads this position row
        last = audio_pos_base(cfg) + max_groups - 2
        if max_groups > 1 and last >= rows:
            raise ValueError(
                f"position {last} lies outside the position table of {rows} "
                f"rows (max_text_tokens + max_mel_frames // reduction + 8)")
        bucket = prompt_len - 3
        self.inputs = torch.zeros((batch, bucket + 1), dtype=torch.long,
                                  device=device)
        self.text_ids, self.emotion = self.inputs[:, :bucket], self.inputs[
            :, bucket]
        self.speaker = (None if speaker is None else torch.zeros(
            (batch, cfg.d_model), dtype=speaker, device=device))
        pinned = device.type == "cuda"
        self._twin = torch.zeros((batch, bucket + 1), dtype=torch.long,
                                 pin_memory=pinned)
        self._uploaded = torch.cuda.Event() if pinned else None
        self.caches = _make_state(params, cfg, batch, prompt_len + max_groups,
                                  dtype=getattr(torch, cfg.dtype),
                                  device=device).caches
        r_mels = cfg.reduction * cfg.n_mels
        self.prev = torch.zeros((batch, r_mels), device=device)
        self.done = torch.zeros((batch,), dtype=torch.bool, device=device)
        self.group = torch.zeros((), dtype=torch.long, device=device)
        self.out = torch.zeros((batch, max_groups + 1, r_mels), device=device)
        self.dones = torch.zeros((batch, max_groups), dtype=torch.bool,
                                 device=device)
        self.n_groups = torch.ones((batch,), dtype=torch.int32, device=device)
        self.steps = 0   # steps taken since the prefill (the host's count)
        self.epoch = 0   # prefills so far
        self.chains: Dict[int, StepChain] = {}
        args = graphs.capture_args(device)
        self.graph = StepGraph(self._step, device, keep=True, **args)
        self.loop = (LoopGraph(self.graph, self.done, max_groups - 1)
                     if max_groups > 1 else None)
        self.prefill_graph = StepGraph(self._prefill, device, keep=True,
                                       **args)
        self.side_graphs = [self.prefill_graph]

    def _step(self) -> None:
        nxt, done = _step(self.params, self.cfg, TTSState(self.caches),
                          self.prev, self.done, self.group,
                          self.stop_threshold,
                          fill=self.group + self.prompt_len)
        self.out.index_copy_(1, (self.group + 1).reshape(1), nxt[:, None])
        self.dones.index_copy_(1, self.group.reshape(1), self.done[:, None])
        self.n_groups.copy_(torch.where(self.done, self.n_groups,
                                        (self.group + 2).to(torch.int32)))
        self.prev.copy_(nxt)
        self.done.copy_(done)
        self.group.add_(1)

    def _prefill(self) -> None:
        """The prompt from the static inputs prefilled into the zeroed
        caches, and the counters the loop starts from."""
        for c in self.caches:
            c.k.zero_()
            c.v.zero_()
            c.length = 0
        prompt = _prompt_embedding(self.params, self.cfg, self.text_ids,
                                   self.emotion, self.speaker,
                                   self.text_vocab)
        first, done = _prefill(self.params, self.cfg, prompt,
                               TTSState(self.caches), self.stop_threshold)
        self.out.zero_()
        self.out[:, 0] = first
        self.dones.zero_()
        self.n_groups.fill_(1)
        self.prev.copy_(first)
        self.done.copy_(done)
        self.group.zero_()
        if self.loop is not None:
            self.loop.trips.zero_()

    def load(self, text_ids: torch.Tensor, emotion: torch.Tensor,
             speaker: Optional[torch.Tensor]) -> None:
        """The prompt's inputs into the static buffers: host tensors through
        the pinned twin in one non-blocking copy (the twin rewritten only
        once its last copy has read it), device tensors by a copy on the
        device."""
        if (speaker is None) != (self.speaker is None):
            raise ValueError("this holder was built "
                             f"{'with' if self.speaker is not None else 'without'}"
                             " a speaker vector")
        if self._uploaded is not None and text_ids.device.type == "cpu":
            if not self._uploaded.query():
                self._uploaded.synchronize()
            self._twin[:, :-1] = text_ids
            self._twin[:, -1] = emotion
            self.inputs.copy_(self._twin, non_blocking=True)
            self._uploaded.record()
        else:
            self.text_ids.copy_(text_ids)
            self.emotion.copy_(emotion)
        if speaker is not None:
            self.speaker.copy_(speaker, non_blocking=True)

    def begin(self) -> TTSState:
        """The host's side of a prefill (the device's is :attr:`prefill_graph`
        or a graph that runs it): a new epoch, no step taken, each cache
        filled through the prompt; the generation state."""
        self.epoch += 1
        for c in self.caches:
            c.length = self.prompt_len
        self.steps = 0
        return TTSState(self.caches, self, self.epoch)

    def prefill(self, text_ids: torch.Tensor, emotion: torch.Tensor,
                speaker: Optional[torch.Tensor] = None):
        """The prompt (``text_ids[B, bucket]``, ``emotion[B]``, ``speaker``
        as the key says) prefilled into the static caches: one upload and
        one replay of :attr:`prefill_graph`; returns :func:`tts_prefill`'s
        ``(group0, done, state)`` (group0 in float32, as the output buffer
        holds it)."""
        self.load(text_ids, emotion, speaker)
        self.prefill_graph.replay()
        state = self.begin()
        return self.out[:, 0].clone(), self.done.clone(), state

    def run_loop(self) -> torch.Tensor:
        """The steps after :meth:`prefill`: one run of :attr:`loop`, nothing
        read back; the run's trips (a copy). The host's step count is then
        unknown (None): :meth:`advance` and :meth:`chunk` wait for a
        :meth:`prefill`."""
        self.steps = None
        if self.loop is None:
            return torch.zeros((), dtype=torch.int32, device=self.out.device)
        return self.loop.run()

    def _fits(self) -> int:
        """Steps after the prefill that stay inside the caches and the
        position table."""
        return min(self.max_groups, self.params["pos_emb"].shape[0]
                   - audio_pos_base(self.cfg))

    def advance(self) -> None:
        """One step: a replay (on the CPU, the step run eagerly)."""
        self.run_steps(1)

    def chain(self, n: int) -> StepChain:
        """The chain of ``n`` steps (``n`` >= 2), built at its first
        request (a stream's warm-up builds its chunk lengths')."""
        c = self.chains.get(n)
        if c is None:
            c = self.chains[n] = StepChain(self.graph, n)
        return c

    def run_steps(self, n: int) -> None:
        """``n`` steps: one replay of the step, or one launch of the chain
        of ``n``. The host runs the steps that stay inside the caches and
        the position table, then refuses the first that would not, as
        ``n`` single steps would."""
        g = self.steps
        if g is None:
            raise RuntimeError("the step count after a loop run is the "
                               "device's: prefill before stepping")
        ok = max(0, min(n, self._fits() - g))
        if ok == 1:
            self.graph.replay()
        elif ok:
            self.chain(ok).run()
        self.steps += ok
        if ok == n:
            return
        g += ok
        if g >= self.max_groups:
            raise ValueError(f"KV cache overflow: {self.prompt_len + g} + 1 "
                             f"> capacity {self.prompt_len + self.max_groups}")
        raise ValueError(
            f"position {audio_pos_base(self.cfg) + g} lies outside the "
            f"position table of {self.params['pos_emb'].shape[0]} rows "
            f"(max_text_tokens + max_mel_frames // reduction + 8)")

    def chunk(self, state: TTSState, prev_group: torch.Tensor,
              done: torch.Tensor, start_group: int, n_steps: int):
        if state.epoch != self.epoch:
            raise RuntimeError("this generation state's caches were "
                               "refilled by a later prefill")
        if start_group != self.steps:
            raise ValueError(f"start_group {start_group}: {self.steps} steps "
                             f"were taken since the prefill")
        self.prev.copy_(prev_group)
        self.done.copy_(done)
        self.run_steps(n_steps)
        lo = start_group
        return (self.out[:, lo + 1:lo + 1 + n_steps].clone(),
                self.dones[:, lo:lo + n_steps].clone(), self.prev.clone(),
                self.done.clone(), state)


def ar_graph(graphs: StepGraphs, params: Params, cfg: TTSConfig, batch: int,
             prompt_len: int, max_groups: int, stop_threshold: float,
             device: torch.device, text_vocab: int = 261,
             speaker: Optional[torch.dtype] = None, tree=None) -> ARGraph:
    """The :class:`ARGraph` of ``graphs`` for this shape (``speaker``: the
    speaker vector's dtype, None for none) and tree, captured at its first
    request (so a streamer can capture its text buckets up front). ``tree``
    is the tree the caller's holders serve where it holds more than
    ``params`` (a streamer's: the TTS's and the vocoder's). Call with
    ``graphs.lock`` held."""
    key = ("ar", cfg, batch, prompt_len, max_groups, float(stop_threshold),
           text_vocab, speaker)
    return graphs.holder(params if tree is None else tree, key,
                         lambda: ARGraph(graphs, params, cfg, batch,
                                         prompt_len, max_groups,
                                         stop_threshold, device, text_vocab,
                                         speaker))
