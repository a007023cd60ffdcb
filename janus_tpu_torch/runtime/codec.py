"""The semantic encoder: phrase audio → JanusPacket, on the card.

The send path of ``janus_tpu.runtime.codec.SemanticEncoder`` in PyTorch:
int16 (or μ-law) wire decode, masked RMS energy, anti-aliased decimation
to 16 kHz, YIN pitch at the 16 kHz serving geometry or at 48 kHz
(block-sum kernel), log-mel (fused mel kernel), the Whisper encoder
(fused attention kernel), a fused-QKV KV-cached greedy decode (int8
cross K/V through the K4 kernel under ``asr.decode_cross_kv_int8``),
then host-side token decode and the MessagePack packet. Phrases are
padded into duration buckets and the batch to the next power of two, as
in the JAX package.

The JAX package jits the whole encode into one program per bucket, its
greedy loop a ``lax.while_loop`` that ends on the device. On the card the
port runs everything before the greedy loop (the wire decode, the
frontend, the encoder, the cross K/V, the prefill and the first token) as
one replay of a captured :class:`EncodeGraph` per (bucket, padded batch,
wire dtype), then one run of the loop's graph, whose exit the card
decides: an encode is one upload and two graph launches, with nothing
read back before :meth:`PendingEncode.result`. ``eager=True``, the CPU and
a mesh of more than one rank run :meth:`SemanticEncoder._encode_impl` op
by op, which is the oracle the graph is held to.

With a ``mesh`` the encode is the JAX package's pod layout, written as
explicit SPMD: the lanes are split over ``data`` (each data rank runs the
frontend, K1 and K3, on its own lanes, as ``shard_map`` does there), the
recognizer is tensor-parallel over ``model``, a ``seq`` dimension runs
the encoder sequence-parallel, and the results are all-gathered over
``data``.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from janus_tpu_torch.audio.ulaw import ulaw_decode, ulaw_encode
from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.common.protocol import JanusMode, JanusPacket
from janus_tpu_torch.models import asr as asr_mod
from janus_tpu_torch.models.params import (cast_floating, init_asr,
                                           prepare_decode_params, tree_to)
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.ops.energy import ENERGY_TAGS, classify_energy, rms_energy
from janus_tpu_torch.ops.quant import column_major
from janus_tpu_torch.ops.resample import decimate_48k_to_16k
from janus_tpu_torch.ops.yin import (PITCH_TAGS, classify_pitch,
                                     mean_voiced_pitch, yin_track)
from janus_tpu_torch.parallel.collectives import (all_gather, axis_index,
                                                  axis_size, use_mesh)
from janus_tpu_torch.parallel.sharding import (ASR_PARTITION_RULES,
                                               shard_params)
from janus_tpu_torch.runtime.profiling import span
from janus_tpu_torch.runtime.step_graph import (StepGraph, StepGraphs,
                                                use_graphs)

__all__ = ["SemanticEncoder", "PendingEncode", "EncodeGraph", "encode_front",
           "duration_bucket", "mel_frame_budget", "DEFAULT_BUCKETS"]


class PendingEncode:
    """Handle to an encode whose device work may still be running.
    ``is_ready`` polls a CUDA event recorded after the work; ``result``
    waits, fetches and decodes (idempotent). Where the greedy loop ran as
    a captured loop, ``loop`` is its :class:`~janus_tpu_torch.runtime.
    step_graph.LoopGraph` and ``trips`` the run's count on the device,
    read back after the tokens and accounted there. ``request`` is the
    submit's request id, which the harvest's span carries; ``loop_span``
    the span of the loop's launch, whose ``trips`` the harvest sets."""

    __slots__ = ("_encoder", "_arrays", "_b_real", "_event", "_out",
                 "_loop", "_trips", "_request", "_loop_span")

    def __init__(self, encoder, arrays, b_real: int, event=None, loop=None,
                 trips=None, request=None, loop_span=None):
        self._encoder = encoder
        self._arrays = arrays
        self._b_real = b_real
        self._event = event
        self._loop = loop
        self._trips = trips
        self._request = request
        self._loop_span = loop_span
        self._out = None

    @classmethod
    def done(cls, results: list) -> "PendingEncode":
        p = cls(None, None, 0)
        p._out = results
        return p

    def is_ready(self) -> bool:
        if self._out is not None or self._event is None:
            return True
        return self._event.query()

    def result(self) -> list:
        if self._out is None:
            with span("encode.harvest", request=self._request,
                      batch=self._b_real):
                self._out = self._encoder._finalize(self._arrays,
                                                    self._b_real)
                if self._loop is not None:
                    # the loop's bodies that ran (the tokens' read waited)
                    trips = int(self._trips)
                    self._loop.account(trips)
                    if self._loop_span is not None:
                        self._loop_span.set(trips=trips)
            self._arrays = None
            self._event = None
            self._loop = self._trips = self._loop_span = None
        return self._out


def mel_frame_budget(acfg, bucket: int) -> int:
    """16 kHz mel frame budget for a 48 kHz sample bucket (even, ≥2,
    capped at the encoder window)."""
    n16 = min(bucket // 3 // acfg.hop_length, 2 * acfg.max_source_positions)
    return max(2, n16 - (n16 % 2))


# Phrase duration buckets in 48 kHz samples; bucket[i+1] ≈ 2·bucket[i].
DEFAULT_BUCKETS = tuple(48_000 * s for s in (2, 4, 8, 15, 30))


def duration_bucket(n_samples: int,
                    buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n_samples <= b:
            return b
    return buckets[-1]


def encode_front(params, cfg: JanusConfig, compute_dtype,
                 audio_48k: torch.Tensor, n_valid: torch.Tensor,
                 n_16k_frames: int, sp_mesh=None) -> Tuple[torch.Tensor, ...]:
    """The encode before its decode loop, as the JAX package's
    ``_encode_impl`` runs it: ``audio_48k[B, T48]`` in the wire dtype
    (int16, μ-law uint8 or float32, zero-padded) and ``n_valid[B]`` →
    (enc ``[B, n_16k_frames // 2, d_model]``, energy_code[B],
    pitch_code[B], mean_f0[B], rms[B]). Device work only, no read-back and
    no upload, so :class:`EncodeGraph` captures it."""
    acfg, pcfg = cfg.asr, cfg.prosody
    if audio_48k.dtype == torch.int16:
        # int16 wire: the exact inverse of the capture-side
        # int16 -> float32 / 32768 conversion; divide (not multiply by
        # 1/32768) to round like the reference
        audio_48k = audio_48k.float() / 32768.0
    elif audio_48k.dtype == torch.uint8:
        audio_48k = ulaw_decode(audio_48k)

    t48 = audio_48k.shape[-1]
    sample_mask = (torch.arange(t48, device=audio_48k.device)[None, :]
                   < n_valid[:, None])
    rms = rms_energy(audio_48k, sample_mask)
    energy_code = classify_energy(rms, pcfg.energy_quiet, pcfg.energy_loud)

    audio_16k = decimate_48k_to_16k(audio_48k)
    if pcfg.yin_rate == 16_000:
        track = yin_track(audio_16k, 16_000, pcfg.yin_window_16k,
                          pcfg.yin_hop_16k, pcfg.yin_tolerance,
                          fmin=pcfg.fmin_hz, fmax=pcfg.fmax_hz)
        # ceil for both: the decimator emits ceil(n / 3) samples
        n16 = -(-n_valid // 3)
        n_hops = -(-n16 // pcfg.yin_hop_16k)
    else:
        # the native capture rate (aubio's 4096/512 geometry)
        track = yin_track(audio_48k, cfg.audio.sample_rate,
                          pcfg.yin_window, pcfg.hop, pcfg.yin_tolerance,
                          fmin=pcfg.fmin_hz, fmax=pcfg.fmax_hz)
        n_hops = -(-n_valid // pcfg.hop)
    f0 = mean_voiced_pitch(track, n_valid=n_hops)
    pitch_code = classify_pitch(f0, pcfg.pitch_deep_hz, pcfg.pitch_high_hz)

    mel = asr_mod.prepare_mel(audio_16k, acfg, pad_to_frames=n_16k_frames)
    enc = asr_mod.encode_audio(params, acfg, mel.to(compute_dtype),
                               sp_mesh=sp_mesh)
    return enc, energy_code, pitch_code, f0, rms


class EncodeGraph:
    """The send path for one (bucket, padded batch, wire dtype) and one
    tree as two captured graphs, as the JAX package compiles its encode
    per shape: the front (a :class:`~janus_tpu_torch.runtime.step_graph.
    StepGraph`) and the greedy loop (the :class:`~janus_tpu_torch.models.
    asr.GreedyGraph`'s :class:`~janus_tpu_torch.runtime.step_graph.
    LoopGraph`, which the card ends).

    It owns the static inputs (``audio[b, bucket]`` in the wire dtype and
    ``n_valid[b]``, each with ``slots`` pinned host twins used in turn, one
    for each encode that may be in flight, so that a submit does not wait
    for an earlier encode's upload), the static outputs (``enc``,
    ``energy_code``, ``pitch_code``, ``f0``, ``rms``; allocated outside the
    graphs' pool) and the :class:`~janus_tpu_torch.models.asr.GreedyGraph`
    of its shape. Its front runs :func:`encode_front` (K3, K1, and K2 with
    the encoder's products), then :meth:`GreedyGraph.prime`: the cross K/V
    written in place into the loop's static buffers, the self caches
    zeroed, the prefill, the first token, the loop's trips zeroed. On the
    CPU both run eagerly over the same buffers. It holds what it needs of
    its encoder, not the encoder (which owns it)."""

    def __init__(self, graphs: StepGraphs, params, cfg: JanusConfig,
                 compute_dtype, prompt: torch.Tensor, eot: int, bucket: int,
                 batch: int, wire_dtype: torch.dtype, device: torch.device,
                 slots: int = 1):
        acfg = cfg.asr
        self.params, self.cfg, self.compute_dtype = params, cfg, compute_dtype
        self.n_frames = mel_frame_budget(acfg, bucket)
        self.greedy = asr_mod.greedy_graph(
            graphs, params, acfg, batch, self.n_frames // 2, compute_dtype,
            prompt.shape[-1], acfg.max_decode_tokens, compute_dtype,
            acfg.decode_cross_kv_int8, eot, device)
        self.prompt = prompt.expand(batch, prompt.shape[-1])
        pinned = device.type == "cuda"
        self.audio = torch.zeros((batch, bucket), dtype=wire_dtype,
                                 device=device)
        self.n_valid = torch.zeros((batch,), dtype=torch.long, device=device)
        # each twin's event is recorded after its upload: a twin is
        # rewritten only once its copies have read it
        self.twins = [(torch.zeros((batch, bucket), dtype=wire_dtype,
                                   pin_memory=pinned),
                       torch.zeros((batch,), dtype=torch.long,
                                   pin_memory=pinned),
                       torch.cuda.Event() if pinned else None)
                      for _ in range(max(1, slots))]
        self.uploads = 0
        self.upload_waits = 0  # uploads that found their twin still read
        self.trips = None      # the last run's loop trips (a device copy)
        self.loop_span = None  # the last run's loop span (its trips unset)
        self.enc = torch.zeros((batch, self.n_frames // 2, acfg.d_model),
                               dtype=compute_dtype, device=device)
        self.energy_code = torch.zeros((batch,), dtype=torch.int32,
                                       device=device)
        self.pitch_code = torch.zeros_like(self.energy_code)
        self.f0 = torch.zeros((batch,), dtype=torch.float32, device=device)
        self.rms = torch.zeros_like(self.f0)
        before = graphs.pool_bytes()
        self.graph = StepGraph(self._step, device,
                               **graphs.capture_args(device))
        # what this capture added to the shared pool
        self.pool_bytes = graphs.pool_bytes() - before

    def _step(self) -> None:
        out = encode_front(self.params, self.cfg, self.compute_dtype,
                           self.audio, self.n_valid, self.n_frames)
        for dst, src in zip((self.enc, self.energy_code, self.pitch_code,
                             self.f0, self.rms), out):
            dst.copy_(src)
        self.greedy.prime(self.enc, self.prompt)

    def run(self, audio: np.ndarray, n_valid: np.ndarray):
        """One encode of a padded wire batch: one non-blocking upload from
        the next pinned twin into the static inputs, one replay of the
        front, one run of the greedy loop; nothing read back. Returns
        (tokens, energy_code, pitch_code, f0, rms), copies of the static
        outputs that the next call may overwrite; the loop's trips, a copy
        too, are :attr:`trips`, and the loop's span :attr:`loop_span`.
        Call with the graphs' lock held."""
        with span("encode.upload"):
            host_audio, host_n_valid, uploaded = self.twins[
                self.uploads % len(self.twins)]
            self.uploads += 1
            if uploaded is not None and not uploaded.query():
                self.upload_waits += 1
                uploaded.synchronize()
            host_audio.numpy()[...] = audio
            host_n_valid.numpy()[...] = n_valid
            self.audio.copy_(host_audio, non_blocking=True)
            self.n_valid.copy_(host_n_valid, non_blocking=True)
            if uploaded is not None:
                uploaded.record()
        with span("encode.front", device=self.audio.device):
            self.graph.replay()
        with span("encode.loop", device=self.audio.device) as loop_span:
            tokens, self.trips = self.greedy.run_loop()
        self.loop_span = loop_span
        return (tokens,) + tuple(t.clone() for t in (
            self.energy_code, self.pitch_code, self.f0, self.rms))

    @property
    def host_audio(self) -> torch.Tensor:
        """The pinned twin of the last upload (the first before any)."""
        return self.twins[(self.uploads - 1) % len(self.twins)][0]

    @property
    def host_n_valid(self) -> torch.Tensor:
        return self.twins[(self.uploads - 1) % len(self.twins)][1]


class SemanticEncoder:
    """Batched phrase → (text, prosody) encoder with a host-side packet
    assembler. ``asr_params`` is a tree of tensors or arrays in the
    package's layout (see :mod:`janus_tpu_torch.models.params`), possibly
    quantized by :func:`janus_tpu_torch.ops.quant.quantize_tree`; without
    one the recognizer is initialized from seed 0.

    ``mesh`` (:func:`janus_tpu_torch.parallel.mesh.build_mesh`) serves on
    every rank of it, each rank constructing the encoder with the same
    arguments and calling ``encode_batch`` with the same phrases: the
    lanes are split over ``data``, the weights are this rank's shards by
    ``ASR_PARTITION_RULES`` (tensor-parallel over ``model``), a ``seq``
    dimension above 1 runs the encoder sequence-parallel, and every rank
    returns the whole batch's results."""

    def __init__(self, cfg: Optional[JanusConfig] = None, asr_params=None,
                 tokenizer=None, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 device="cuda", mesh=None, eager: bool = False) -> None:
        self.device = resolve_device(device)
        # the greedy loop's path on the card: its captured step (False) or
        # the eager Python loop (True), see asr.greedy_decode
        self.eager = eager
        self._graphs = StepGraphs()
        self._prompts: dict = {}
        self.cfg = cfg or JanusConfig()
        self.tokenizer = tokenizer or ByteTokenizer()
        if asr_params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            asr_params = init_asr(gen, self.cfg.asr)
        self.mesh = mesh
        if mesh is not None:
            asr_params = shard_params(asr_params, mesh, ASR_PARTITION_RULES)
        params = tree_to(asr_params, self.device)
        self._compute_dtype = getattr(torch, self.cfg.asr.dtype)
        if self._compute_dtype != torch.float32:
            # matmuls still accumulate fp32; norms and softmax run fp32
            params = cast_floating(params, self._compute_dtype)
        # the decode layout (fused q/k/v) once; under a mesh the tree keeps
        # the per-layer q/k/v that the partition rules name, as in the JAX
        # package
        params = prepare_decode_params(params) if mesh is None else params
        # dynamic-int8 weights K-contiguous for the card's int8 kernel, once
        # (after the fusion, whose concatenation is row-major)
        self.params = (column_major(params) if self.device.type == "cuda"
                       else params)
        self.buckets = tuple(buckets)

    def mel_frame_budget(self, bucket: int) -> int:
        return mel_frame_budget(self.cfg.asr, bucket)

    # -- device path -------------------------------------------------------

    # Autograd off inside the method: grad mode is thread-local, and the
    # engine calls ``encode_batch`` from an executor thread.
    @torch.no_grad()
    def _encode_impl(self, audio_48k: torch.Tensor, n_valid: torch.Tensor,
                     n_16k_frames: int) -> Tuple[torch.Tensor, ...]:
        """``audio_48k[B, T48]`` in the wire dtype (zero-padded),
        ``n_valid[B]`` true lengths → (tokens[B, N], energy_code[B],
        pitch_code[B], mean_f0[B], rms[B]), op by op: the eager path, and
        the oracle of :class:`EncodeGraph`."""
        data = axis_size(self.mesh, "data")
        if data > 1:
            # this data rank's lanes (the batch is padded to tile "data")
            lane = axis_index(self.mesh, "data")
            audio_48k = audio_48k.chunk(data)[lane]
            n_valid = n_valid.chunk(data)[lane]
        acfg = self.cfg.asr
        sp_mesh = self.mesh if axis_size(self.mesh, "seq") > 1 else None
        with use_mesh(self.mesh):
            with span("encode.front", device=audio_48k.device):
                enc, *prosody = encode_front(
                    self.params, self.cfg, self._compute_dtype, audio_48k,
                    n_valid, n_16k_frames, sp_mesh=sp_mesh)
            prompt = self._prompt(enc.device).expand(audio_48k.shape[0], -1)
            with span("encode.loop", device=audio_48k.device):
                tokens = asr_mod.greedy_decode(
                    self.params, acfg, enc, prompt, self.tokenizer.eot,
                    max_new=acfg.max_decode_tokens,
                    cache_dtype=self._compute_dtype,
                    cross_kv_int8=acfg.decode_cross_kv_int8,
                    eager=self.eager, graphs=self._graphs)
        out = (tokens, *prosody)
        if data > 1:
            out = tuple(all_gather(a, self.mesh, "data") for a in out)
        return out

    def _prompt(self, device: torch.device) -> torch.Tensor:
        """The tokenizer's prompt ``[L]`` on ``device``, made once."""
        p = self._prompts.get(device)
        if p is None:
            p = self._prompts[device] = torch.tensor(
                self.tokenizer.sot_sequence(), dtype=torch.long,
                device=device)
        return p

    def _graphed(self) -> bool:
        """Whether an encode replays its :class:`EncodeGraph` (see
        :func:`~janus_tpu_torch.runtime.step_graph.use_graphs`)."""
        with use_mesh(self.mesh):
            return use_graphs(self.device, self.eager)

    def encode_graph(self, bucket: int, batch: int) -> EncodeGraph:
        """The :class:`EncodeGraph` of ``bucket`` samples at ``batch``
        padded lanes in the configured wire dtype, captured at its first
        request. Call with ``self._graphs.lock`` held."""
        rt = self.cfg.runtime
        wire_dtype = (torch.uint8 if rt.encode_transfer_ulaw else
                      torch.int16 if rt.encode_transfer_int16 else
                      torch.float32)
        acfg, sot = self.cfg.asr, self.tokenizer.sot_sequence()
        key = ("encode", bucket, batch, wire_dtype) + asr_mod.greedy_key(
            acfg, batch, self.mel_frame_budget(bucket) // 2,
            self._compute_dtype, len(sot), acfg.max_decode_tokens,
            self._compute_dtype, acfg.decode_cross_kv_int8,
            self.tokenizer.eot)
        return self._graphs.holder(self.params, key, lambda: EncodeGraph(
            self._graphs, self.params, self.cfg, self._compute_dtype,
            self._prompt(self.device), self.tokenizer.eot, bucket, batch,
            wire_dtype, self.device, slots=rt.max_inflight_encodes + 1))

    # -- host path ---------------------------------------------------------

    def encode_batch(self, phrases: Sequence[np.ndarray]) -> list:
        """48 kHz float32 phrases (ragged) → per-phrase dicts
        {text, prosody, f0, rms}."""
        return self.encode_batch_submit(phrases).result()

    def encode_batch_submit(self, phrases: Sequence[np.ndarray]) -> PendingEncode:
        """Launch the encode; harvest with :meth:`PendingEncode.result`.
        On the card's graph path it returns once the work is enqueued, as
        the JAX package's submit does: one upload, the front's replay and
        one run of the greedy loop's graph, whose exit the card decides,
        with nothing read back, so the whole encode may still be running
        when the handle comes back. The eager path (``eager=True``, the
        CPU, a mesh of more than one rank) reads the ``done`` flags back
        before every step, so it returns once the last step is
        enqueued."""
        if not phrases:
            return PendingEncode.done([])
        max_bucket = self.buckets[-1]
        if any(len(p) > max_bucket for p in phrases):
            return PendingEncode.done(
                self._encode_with_splitting(phrases, max_bucket))
        with span("encode.submit", batch=len(phrases)) as submit:
            return self._submit(phrases, submit)

    def _submit(self, phrases: Sequence[np.ndarray], submit) -> PendingEncode:
        with span("encode.pad"):
            bucket = duration_bucket(max(len(p) for p in phrases),
                                     self.buckets)
            b_real = len(phrases)
            b_pad = 1 << (b_real - 1).bit_length()  # next power of two
            data = axis_size(self.mesh, "data")
            # lanes tile the data dimension (one phrase through data=4
            # still ships 4 lanes, 3 of them zero audio)
            b_pad = max(b_pad, data)
            b_pad += (-b_pad) % data
            batch = np.zeros((b_pad, bucket), dtype=np.float32)
            n_valid = np.zeros((b_pad,), dtype=np.int64)
            for i, p in enumerate(phrases):
                p = np.asarray(p, dtype=np.float32)[:bucket]
                batch[i, :len(p)] = p
                n_valid[i] = len(p)
            if self.cfg.runtime.encode_transfer_ulaw:
                batch = ulaw_encode(batch)
            elif self.cfg.runtime.encode_transfer_int16:
                batch = np.clip(np.round(batch * 32768.0),
                                -32768, 32767).astype(np.int16)
        submit.set(bucket=bucket)
        loop = trips = loop_span = None
        if self._graphed():
            with torch.no_grad(), use_mesh(self.mesh), self._graphs.lock:
                holder = self.encode_graph(bucket, b_pad)
                arrays = holder.run(batch, n_valid)
                loop, trips = holder.greedy.loop, holder.trips
                loop_span = holder.loop_span
        else:
            with span("encode.upload"):
                audio = torch.from_numpy(batch).to(self.device)
                nv = torch.from_numpy(n_valid).to(self.device)
            arrays = self._encode_impl(audio, nv,
                                       self.mel_frame_budget(bucket))
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return PendingEncode(self, arrays, b_real, event, loop, trips,
                             submit.request, loop_span)

    def _finalize(self, arrays, b_real: int) -> list:
        with span("encode.read"):
            tokens, e_code, p_code, f0, rms = (a.cpu().numpy()
                                               for a in arrays)
        with span("encode.detok"):
            out = []
            for i in range(b_real):
                ids = tokens[i]
                cut = np.where(ids == self.tokenizer.eot)[0]
                if cut.size:
                    ids = ids[:cut[0]]
                out.append({
                    "text": self.tokenizer.decode(ids).strip(),
                    "prosody": {"energy": ENERGY_TAGS[int(e_code[i])],
                                "pitch": PITCH_TAGS[int(p_code[i])]},
                    "f0": float(f0[i]),
                    "rms": float(rms[i]),
                })
        return out

    def _encode_with_splitting(self, phrases: Sequence[np.ndarray],
                               max_bucket: int) -> list:
        """Chunk overlong phrases, encode all chunks in one batch, merge."""
        pcfg = self.cfg.prosody
        segments: list = []
        spans: list = []
        for p in phrases:
            p = np.asarray(p, dtype=np.float32)
            start = len(segments)
            lengths = []
            for off in range(0, len(p), max_bucket):
                seg = p[off:off + max_bucket]
                segments.append(seg)
                lengths.append(len(seg))
            spans.append((start, len(lengths), lengths))

        seg_results = self.encode_batch(segments)
        out = []
        for start, count, lengths in spans:
            chunk = seg_results[start:start + count]
            if count == 1:
                out.append(chunk[0])
                continue
            total = float(sum(lengths))
            text = " ".join(r["text"] for r in chunk
                            if r["text"].strip()).strip()
            rms = float(np.sqrt(sum((r["rms"] ** 2) * n for r, n in
                                    zip(chunk, lengths)) / max(total, 1.0)))
            voiced = [(r["f0"], n) for r, n in zip(chunk, lengths)
                      if r["f0"] > 0]
            f0 = (sum(f * n for f, n in voiced) / sum(n for _, n in voiced)
                  if voiced else 0.0)
            energy = ("Quiet" if rms < pcfg.energy_quiet
                      else "Normal" if rms < pcfg.energy_loud else "Loud")
            pitch = ("Normal" if f0 <= 0 else
                     "Deep" if f0 < pcfg.pitch_deep_hz else
                     "Normal" if f0 < pcfg.pitch_high_hz else "High")
            out.append({"text": text,
                        "prosody": {"energy": energy, "pitch": pitch},
                        "f0": float(f0), "rms": rms})
        return out

    def encode_packet(self, phrase: np.ndarray,
                      mode: JanusMode = JanusMode.SEMANTIC_VOICE,
                      override_emotion: str = "Auto",
                      timestamp: Optional[float] = None
                      ) -> Optional[JanusPacket]:
        """One phrase → packet; an empty transcript gives no packet."""
        res = self.encode_batch([phrase])[0]
        if not res["text"].strip():
            return None
        return JanusPacket(
            text=res["text"], mode=mode, prosody=res["prosody"],
            override_emotion=override_emotion,
            timestamp=timestamp if timestamp is not None else time.time())

    def warmup(self, bucket: Optional[int] = None) -> None:
        """Run one silent phrase of ``bucket`` samples (default the
        smallest bucket) through the whole encode: cuBLAS handles, the
        kernels' build and load, and the allocator's pools are set up
        before the first real phrase. On the graph path the front and the
        decode step of one phrase in every bucket are captured too, so that
        no capture happens inside a live turn (other batch sizes are
        captured at their first encode)."""
        b = bucket or self.buckets[0]
        with span("setup.warmup"):
            self.encode_batch([np.zeros(b, dtype=np.float32)])
            if not self._graphed():
                return
            with torch.no_grad(), use_mesh(self.mesh), self._graphs.lock:
                for bucket_ in self.buckets:
                    self.encode_graph(bucket_, 1)
