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
from janus_tpu_torch.ops.attention import KVCache, merge_heads, split_heads
from janus_tpu_torch.ops.cross_attn import cross_attention_kv
from janus_tpu_torch.ops.decode_attention import attend_cache
from janus_tpu_torch.ops.flash import flash_attention
from janus_tpu_torch.ops.layers import (add_layer_norm, conv1d,
                                        embedding_lookup, gelu, linear,
                                        linear_into, row_linear,
                                        sinusoid_positions)
from janus_tpu_torch.ops.mel_fused import log_mel_spectrogram_fused
from janus_tpu_torch.ops.quant import QuantKVT, empty_kv_t, quantize_kv_t
from janus_tpu_torch.parallel.collectives import (all_gather, axis_index,
                                                  axis_size, enter_model,
                                                  local_heads)
from janus_tpu_torch.parallel.ring_attention import ring_attention
from janus_tpu_torch.runtime.step_graph import (LoopGraph, StepGraph,
                                                StepGraphs, default_graphs,
                                                use_graphs)

__all__ = [
    "encode_audio",
    "DecodeState",
    "init_decode_state",
    "decoder_prefill",
    "decoder_step",
    "greedy_decode",
    "GreedyGraph",
    "greedy_graph",
    "greedy_key",
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
    # each residual add is taken into the norm that reads its sum: a
    # sublayer's output stays pending (delta) until the next norm
    delta = pos.to(x.dtype)
    for blk in enc["blocks"]:
        x, h = add_layer_norm(x, delta, **blk["attn_ln"])
        x, h = add_layer_norm(x, _attention(blk["attn"], h, cfg.num_heads,
                                            sp_mesh=sp_mesh),
                              **blk["mlp_ln"])
        delta = _mlp(blk["mlp"], h)
    _, x = add_layer_norm(x, delta, **enc["ln_post"])
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
    caches = [KVCache.create(batch_shape, heads, max_len, head_dim,
                             dtype=dtype, device=enc.device) for _ in blocks]
    return DecodeState(caches, *_cross_kv(params, cfg, enc, cross_kv_int8))


def _cross_kv(params: Params, cfg: ASRConfig, enc: torch.Tensor,
              cross_kv_int8: bool, out: Optional[Tuple[List, List]] = None
              ) -> Tuple[List, List]:
    """Each decoder layer's cross-attention K and V of ``enc``, written in
    place into ``out`` (a :class:`DecodeState`'s ``(cross_k, cross_v)``,
    a decode loop's static buffers) or into new buffers of that layout
    (:func:`_cross_kv_buffers`), with no second copy: a dense K/V is the
    product's own output (:func:`~..ops.layers.linear_into`), an int8 one
    is quantized layer by layer into its :class:`~..ops.quant.QuantKVT`."""
    if out is None:
        out = _cross_kv_buffers(params, cfg, enc, cross_kv_int8)
    blocks = params["decoder"]["blocks"]
    heads = local_heads(cfg.num_heads, blocks[0]["cross"]["k"]["w"])
    enc = enter_model(enc)
    for blk, dk, dv in zip(blocks, *out):
        for p, dst in ((blk["cross"]["k"], dk), (blk["cross"]["v"], dv)):
            if isinstance(dst, QuantKVT):
                quantize_kv_t(split_heads(linear(enc, p["w"], p.get("b")),
                                          heads), out=dst)
            else:
                linear_into(enc, p["w"], p.get("b"), merge_heads(dst))
    return out


def _cross_kv_buffers(params: Params, cfg: ASRConfig, enc: torch.Tensor,
                      cross_kv_int8: bool) -> Tuple[List, List]:
    """Uninitialised cross K and V buffers for ``enc[..., T, d]``, one
    each a decoder layer: dense ``[..., H, T, Dh]`` head views of one
    ``[..., T, H·Dh]`` tensor in ``enc``'s dtype (the layout of the
    product), or int8 :class:`~..ops.quant.QuantKVT` in the K4 kernel's
    padded layout."""
    blocks = params["decoder"]["blocks"]
    heads = local_heads(cfg.num_heads, blocks[0]["cross"]["k"]["w"])
    dh = cfg.d_model // cfg.num_heads
    lead, t = tuple(enc.shape[:-2]), enc.shape[-2]

    def one():
        if cross_kv_int8:
            return empty_kv_t(lead + (heads,), t, dh, enc.device)
        return split_heads(torch.empty(lead + (t, heads * dh),
                                       dtype=enc.dtype, device=enc.device),
                           heads)

    return [one() for _ in blocks], [one() for _ in blocks]


def _self_qkv(blk: Params, cfg: ASRConfig, h: torch.Tensor):
    """Self-attention projections of the normed input ``h`` (fused ``qkv``
    when the tree was prepared by :func:`..params.prepare_decode_params`)."""
    h = enter_model(h)
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
                   delta: torch.Tensor, cache: KVCache, cross_k, cross_v,
                   pos: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cached self-attn → cross-attn → MLP over the layer's input ``x +
    delta`` (``delta``: the sublayer output before it, not yet added).
    Each residual add is taken into the norm that reads the sum
    (:func:`~..ops.layers.add_layer_norm`); returns ``(x, delta)`` with
    the MLP's output pending. The step's K/V are written into the cache
    by the attention call (:func:`~..ops.decode_attention.attend_cache`):
    at the device position ``pos`` when one is given, else at the cache's
    fill count, which advances."""
    x, h = add_layer_norm(x, delta, **blk["attn_ln"])
    q, k, v = _self_qkv(blk, cfg, h)
    p = blk["attn"]
    x, h = add_layer_norm(x, row_linear(
        merge_heads(attend_cache(q, cache, k, v, pos)), p["out"]["w"],
        p["out"]["b"]), **blk["cross_ln"])
    h = enter_model(h)
    pc = blk["cross"]
    qc = split_heads(linear(h, pc["q"]["w"], pc["q"]["b"]),
                     local_heads(cfg.num_heads, pc["q"]["w"]))
    x, h = add_layer_norm(x, row_linear(
        merge_heads(cross_attention_kv(qc, cross_k, cross_v)),
        pc["out"]["w"], pc["out"]["b"]), **blk["mlp_ln"])
    return x, _mlp(blk["mlp"], h)


def _decoder_forward(params: Params, cfg: ASRConfig, tokens: torch.Tensor,
                     pos_offset, state: DecodeState,
                     head: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, DecodeState]:
    """``tokens[..., T_new]`` through the decoder, appending to the caches
    in place. Returns fp32 logits ``[..., T_new, vocab]`` and the state.

    ``pos_offset`` is the caches' fill count: a Python int (the caches'
    own ``length``, advanced here), or a 0-dim int64 device tensor for a
    captured step, which writes there and leaves ``length`` to the
    caller. ``head`` is the tied embedding in fp32 where the caller keeps
    one (a captured step's, made once); by default it is widened here."""
    dec = params["decoder"]
    t_new = tokens.shape[-1]
    pos = pos_offset if isinstance(pos_offset, torch.Tensor) else None
    positions = pos_offset + torch.arange(t_new, device=tokens.device)
    # the position rows are the first layer's pending delta
    x = embedding_lookup(dec["token_emb"], tokens)
    delta = embedding_lookup(dec["pos_emb"], positions)
    for i, blk in enumerate(dec["blocks"]):
        x, delta = _decoder_layer(blk, cfg, x, delta, state.self_caches[i],
                                  state.cross_k[i], state.cross_v[i], pos)
    _, x = add_layer_norm(x, delta, **dec["ln"])
    # tied embedding, products accumulated in fp32
    if head is None:
        head = dec["token_emb"].float()
    logits = torch.matmul(x.float(), head.T)
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
                  cross_kv_int8: bool = False, *, eager: bool = False,
                  graphs: Optional[StepGraphs] = None) -> torch.Tensor:
    """Batched greedy search: ``[B, max_new]`` int32 tokens, padded with
    ``eot_id`` after each lane finishes. ``cross_kv_int8`` as in
    :func:`init_decode_state`. Runs without autograd: with parameters
    that require gradients, a graph over every layer and step would
    otherwise be held until the tokens are read.

    On the card the prefill runs eagerly (its width is the prompt's) and
    the steps are one launch of a loop graph (:class:`GreedyGraph`, from
    ``graphs``, the caller's :class:`~janus_tpu_torch.runtime.step_graph.
    StepGraphs`, or the module's own): a WHILE conditional node around the
    captured step, whose condition, ``~all(done)`` within ``max_new - 1``
    steps, the card tests before every step, as the JAX package's
    ``lax.while_loop`` tests its own. The function returns once the run is
    enqueued, having read nothing back; the loop's trip count is read
    when its graphs are settled (:meth:`~janus_tpu_torch.runtime.
    step_graph.StepGraphs.settle`). On the CPU, with ``eager=True``, or
    under a mesh of more than one rank, the steps run eagerly from Python
    and the flags are read back before every step."""
    if max_new is None:
        max_new = cfg.max_decode_tokens
    if use_graphs(enc.device, eager):
        return _greedy_graphed(params, cfg, enc, prompt, eot_id, max_new,
                               cache_dtype, cross_kv_int8,
                               graphs or default_graphs("asr"))
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


def _greedy_graphed(params, cfg, enc, prompt, eot_id, max_new, cache_dtype,
                    cross_kv_int8, graphs: StepGraphs) -> torch.Tensor:
    """:func:`greedy_decode` through a :class:`GreedyGraph` of ``graphs``:
    :meth:`GreedyGraph.prime`, then its loop graph (on the CPU the same
    loop runs eagerly over the static buffers). The run's trips are
    deferred to :meth:`~janus_tpu_torch.runtime.step_graph.StepGraphs.
    settle`."""
    with graphs.lock:
        h = greedy_graph(graphs, params, cfg, prompt.shape[0], enc.shape[-2],
                         enc.dtype, prompt.shape[-1], max_new, cache_dtype,
                         cross_kv_int8, eot_id, enc.device)
        tokens, trips = h.decode(enc, prompt)
        if h.loop is not None:
            h.loop.defer(trips)
        return tokens


class GreedyGraph:
    """The greedy loop's static state for one shape and one tree, and its
    step captured over it: the self caches, the cross K/V (dense, or int8
    :class:`~janus_tpu_torch.ops.quant.QuantKVT` in the K4 kernel's
    padded layout), the token fed to the step, the fill position (a
    device counter the step advances), the ``done`` flags and the output
    buffer (one column past ``max_new``). The static cross K/V are built
    by :func:`init_decode_state` itself, so they have the eager path's
    layout and strides.

    :meth:`prime` fills it for one call with device work only, which a
    caller may capture (the encoder's front graph does): the self caches
    zeroed, the cross K/V of ``enc`` written in place into the static
    buffers, the prefill, the first token, the loop's ``trips`` zeroed.
    :attr:`graph` is the step captured; :attr:`loop` the ``while_loop``
    after the prime (:class:`~janus_tpu_torch.runtime.step_graph.LoopGraph`
    of at most ``max_new - 1`` steps around that graph; none at ``max_new``
    1), whose exit the card decides: :meth:`run_loop` launches it and reads
    nothing back; :meth:`decode` is the two. :meth:`advance` replays one
    step alone (for traces of a step), which the host refuses when it
    would write past the caches or read past the position table. A shape
    whose loop would read past the position table raises here, before any
    capture."""

    def __init__(self, graphs: StepGraphs, params: Params, cfg: ASRConfig,
                 batch: int, enc_frames: int, enc_dtype, prompt_len: int,
                 max_new: int, cache_dtype, cross_kv_int8: bool, eot_id: int,
                 device: torch.device):
        self.params, self.cfg = params, cfg
        self.prompt_len, self.max_new = prompt_len, max_new
        self.cross_kv_int8, self.eot_id = cross_kv_int8, eot_id
        self.cache_len = prompt_len + max_new
        rows = params["decoder"]["pos_emb"].shape[0]
        # the loop's last step reads this position (its caches hold it)
        last = prompt_len + max_new - 2
        if max_new > 1 and last >= rows:
            raise ValueError(f"position {last} lies outside the decoder's "
                             f"position table of {rows} rows")
        enc = torch.zeros((batch, enc_frames, cfg.d_model), dtype=enc_dtype,
                          device=device)
        self.state = init_decode_state(params, cfg, enc,
                                       max_len=self.cache_len,
                                       dtype=cache_dtype,
                                       cross_kv_int8=cross_kv_int8)
        self.tok = torch.zeros((batch,), dtype=torch.long, device=device)
        self.pos = torch.full((), prompt_len, dtype=torch.long, device=device)
        self.done = torch.zeros((batch,), dtype=torch.bool, device=device)
        # one column past max_new, so that a step may run to the caches'
        # end
        self.out = torch.full((batch, max_new + 1), eot_id,
                              dtype=torch.int32, device=device)
        self.fill = prompt_len
        # the tied head's table widened once for the tree, not every step
        # (the same fp32 values the eager step widens per call)
        self.head = graphs.derived("asr_head_fp32", lambda: params[
            "decoder"]["token_emb"].float())
        self.graph = StepGraph(self._step, device, keep=True,
                               **graphs.capture_args(device))
        self.loop = (LoopGraph(self.graph, self.done, max_new - 1)
                     if max_new > 1 else None)

    def _step(self) -> None:
        logits, _ = _decoder_forward(self.params, self.cfg, self.tok[:, None],
                                     self.pos, self.state, self.head)
        nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
        nxt = torch.where(self.done, torch.full_like(nxt, self.eot_id), nxt)
        col = (self.pos - (self.prompt_len - 1)).reshape(1)
        self.out.index_copy_(1, col, nxt[:, None])
        torch.logical_or(self.done, nxt == self.eot_id, out=self.done)
        self.tok.copy_(nxt)
        self.pos.add_(1)

    def advance(self) -> None:
        """One step: a replay (on the CPU, the step run eagerly)."""
        if self.fill is None:
            raise RuntimeError("the fill point after a loop run is the "
                               "device's: prime before stepping")
        rows = self.params["decoder"]["pos_emb"].shape[0]
        if self.fill + 1 > self.cache_len:
            raise ValueError(f"KV cache overflow: {self.fill} + 1 > "
                             f"capacity {self.cache_len}")
        if self.fill >= rows:
            raise ValueError(f"position {self.fill} lies outside the "
                             f"decoder's position table of {rows} rows")
        self.graph.replay()
        self.fill += 1

    def prime(self, enc: torch.Tensor, prompt: torch.Tensor) -> None:
        """The start of :func:`greedy_decode` of ``enc`` on the static
        state, as device work over static tensors only (no read-back, no
        upload): a capture of it replays it for the next ``enc``."""
        st = self.state
        for c in st.self_caches:
            c.k.zero_()
            c.v.zero_()
            c.length = 0
        _cross_kv(self.params, self.cfg, enc, self.cross_kv_int8,
                  out=(st.cross_k, st.cross_v))
        first_logits, _ = decoder_prefill(self.params, self.cfg, prompt, st)
        first = torch.argmax(first_logits, dim=-1).to(torch.int32)
        self.out.fill_(self.eot_id)
        self.out[:, 0] = first
        self.done.copy_(first == self.eot_id)
        self.tok.copy_(first)
        self.pos.fill_(self.prompt_len)
        if self.loop is not None:
            self.loop.trips.zero_()
        self.fill = self.prompt_len  # the host's count, for advance()

    def run_loop(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The steps after :meth:`prime`: one run of :attr:`loop`, nothing
        read back. Returns the tokens ``[B, max_new]`` and the run's trips
        (int32), copies that the next call does not overwrite. The fill
        point is then the device's: :meth:`advance` waits for a
        :meth:`prime`."""
        if self.loop is None:
            trips = torch.zeros((), dtype=torch.int32, device=self.out.device)
        else:
            trips = self.loop.run()
        self.fill = None
        return self.out[:, :self.max_new].clone(), trips

    def decode(self, enc: torch.Tensor, prompt: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:func:`greedy_decode` of ``enc`` on the static state: the tokens
        and the trips, as :meth:`run_loop`."""
        self.prime(enc, prompt)
        return self.run_loop()


def greedy_key(cfg: ASRConfig, batch: int, enc_frames: int, enc_dtype,
               prompt_len: int, max_new: int, cache_dtype,
               cross_kv_int8: bool, eot_id: int) -> tuple:
    """The key of a :class:`GreedyGraph` in its :class:`~janus_tpu_torch.
    runtime.step_graph.StepGraphs` (its kind first)."""
    return ("greedy", cfg, batch, enc_frames, enc_dtype, prompt_len,
            max_new, cache_dtype, cross_kv_int8, eot_id)


def greedy_graph(graphs: StepGraphs, params: Params, cfg: ASRConfig,
                 batch: int, enc_frames: int, enc_dtype, prompt_len: int,
                 max_new: int, cache_dtype, cross_kv_int8: bool, eot_id: int,
                 device: torch.device) -> GreedyGraph:
    """The :class:`GreedyGraph` of ``graphs`` for this shape and tree,
    captured at its first request (so an encoder can capture its buckets
    up front). Call with ``graphs.lock`` held."""
    key = greedy_key(cfg, batch, enc_frames, enc_dtype, prompt_len, max_new,
                     cache_dtype, cross_kv_int8, eot_id)
    return graphs.holder(params, key, lambda: GreedyGraph(
        graphs, params, cfg, batch, enc_frames, enc_dtype, prompt_len,
        max_new, cache_dtype, cross_kv_int8, eot_id, device))


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
