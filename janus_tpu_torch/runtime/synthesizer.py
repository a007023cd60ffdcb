"""The semantic decoder: JanusPacket → PCM audio bytes.

Mode routing, emotion prompting, voice-clone hot reload and the failure
ladder mirror the reference synthesizer
(reference: backend/services/synthesizer.py:106-255):

- MORSE_CODE  → local sine synthesis (bit-identical timings)
- TEXT_ONLY   → fast TTS (no emotion tag unless an override is active)
- SEMANTIC    → emotion-prompted TTS; the (pitch, energy) → tag table is
  the reference's, including its dead 'Low' branches
- semantic failure → fast TTS; fast-TTS failure → b''

The synthesis itself runs the TTS transformer, the iSTFT vocoder and the
resampler to 48 kHz. Text pads only to the next power-of-two bucket:
audio tokens sit at a fixed position base
(:func:`~janus_tpu_torch.models.tts.audio_pos_base`), so any bucket is an
in-distribution prompt length. Output is 48 kHz mono int16 PCM bytes.

The JAX package jits the whole synthesis (prompt embedding, prefill, the
AR ``while_loop``, vocoder, iSTFT, resampler) into one program per text
bucket. On the card the port runs it as one launch of a
:class:`SynthGraph` per (bucket, batch, speaker or none): the captured
prefill, the AR loop's WHILE node and the captured tail in one graph,
after one pinned upload, nothing read back before ``_run_tts`` reads the
samples. ``eager=True``, the CPU and a mesh of more than one rank issue it
op by op (:meth:`Synthesizer._synth_impl`), the oracle the graph is held
to.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from janus_tpu_torch.audio.decode import read_audio
from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.common.protocol import JanusMode, JanusPacket
from janus_tpu_torch.models import tts as tts_mod
from janus_tpu_torch.models import vocoder as voc_mod
from janus_tpu_torch.models.params import tree_to
from janus_tpu_torch.models.speaker import init_speaker_encoder, speaker_embed
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.ops.morse import morse_audio
from janus_tpu_torch.ops.resample import decimate_48k_to_16k, resample_poly
from janus_tpu_torch.parallel.collectives import use_mesh
from janus_tpu_torch.parallel.sharding import (TTS_PARTITION_RULES,
                                               VOCODER_PARTITION_RULES,
                                               shard_params)
from janus_tpu_torch.runtime.emotion import tts_emotion_tag
from janus_tpu_torch.runtime.profiling import span
from janus_tpu_torch.runtime.step_graph import (LoopGraph, StepGraph,
                                                StepGraphs, use_graphs)

logger = logging.getLogger(__name__)

__all__ = ["Synthesizer", "SynthGraph", "vocode_48k", "rate_ratio"]


def rate_ratio(sample_rate: int) -> Tuple[int, int]:
    """``(up, down)`` from the vocoder's rate to 48 kHz playback."""
    g = math.gcd(48_000, sample_rate)
    return 48_000 // g, sample_rate // g


def vocode_48k(vocoder_params, cfg: JanusConfig, mel: torch.Tensor,
               n_frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The synthesis after the AR loop: ``mel[B, T, n_mels]`` and
    ``n_frames[B]`` → ``(wav48[B, T48], n48[B])`` (vocode, then resample
    to 48 kHz)."""
    wav = voc_mod.vocoder_waveform(vocoder_params, cfg.vocoder, mel)
    up, down = rate_ratio(cfg.vocoder.sample_rate)
    wav48 = (resample_poly(wav, up=up, down=down)
             if (up, down) != (1, 1) else wav)
    return wav48, n_frames * cfg.vocoder.hop_length * up // down


class SynthGraph:
    """The synthesis for one (text bucket, batch, speaker dtype or none) and
    one tree as one graph, as the JAX package jits ``_synth_impl`` per
    bucket: the :class:`~janus_tpu_torch.models.tts.ARGraph` of its shape
    (its static inputs, caches and buffers, the captured prefill and step)
    and the tail (:func:`vocode_48k` over the holder's output buffer,
    captured, writing the static ``wav48[b, T48]`` and ``n48[b]``), built
    into one :class:`~janus_tpu_torch.runtime.step_graph.LoopGraph`: the
    prefill, the WHILE node around the step, the tail, with an event record
    node at each boundary of the WHILE part (outside its body), which a
    traced launch points at its span's events. :meth:`run` is one upload
    and one launch; on the CPU the same functions run eagerly over the same
    buffers. ``pool_bytes`` is what its captures added to the
    shared pool. It holds what it needs of its synthesizer, not the
    synthesizer (which owns it)."""

    def __init__(self, graphs: StepGraphs, tts_params, vocoder_params,
                 cfg: JanusConfig, bucket: int, batch: int,
                 speaker: Optional[torch.dtype], text_vocab: int,
                 device: torch.device):
        tcfg = cfg.tts
        self.cfg, self.vocoder_params = cfg, vocoder_params
        before = graphs.pool_bytes()
        max_groups = tcfg.max_mel_frames // tcfg.reduction
        self.ar = tts_mod.ARGraph(graphs, tts_params, tcfg, batch,
                                  bucket + 3, max_groups, 0.5, device,
                                  text_vocab, speaker)
        up, down = rate_ratio(cfg.vocoder.sample_rate)
        frames = max_groups * tcfg.reduction
        wav_dtype = torch.promote_types(
            vocoder_params["mag_head"]["w"].dtype, torch.float32)
        self.wav48 = torch.zeros(
            (batch, frames * cfg.vocoder.hop_length * up // down),
            dtype=wav_dtype, device=device)
        self.n48 = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.tail = StepGraph(self._tail, device, keep=True,
                              **graphs.capture_args(device))
        self.graph = self.ar.graph
        self.side_graphs = [self.ar.prefill_graph, self.tail]
        self.loop = (LoopGraph(self.ar.graph, self.ar.done, max_groups - 1,
                               before=self.ar.prefill_graph, after=self.tail,
                               trips=self.ar.loop.trips)
                     if self.ar.loop is not None else None)
        self.pool_bytes = graphs.pool_bytes() - before

    def _tail(self) -> None:
        ar, tcfg = self.ar, self.cfg.tts
        b = ar.out.shape[0]
        mel = ar.out[:, :ar.max_groups].reshape(
            b, ar.max_groups * tcfg.reduction, tcfg.n_mels).contiguous()
        wav48, n48 = vocode_48k(self.vocoder_params, self.cfg, mel,
                                ar.n_groups * tcfg.reduction)
        self.wav48.copy_(wav48)
        self.n48.copy_(n48)

    def run(self, text_ids: torch.Tensor, emotion: torch.Tensor,
            speaker: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One synthesis: the inputs uploaded (host tensors through the
        pinned twin, one non-blocking copy), then one launch (prefill, AR
        loop, tail); nothing read back. Returns the static ``(wav48,
        n48)``, which the next run overwrites: read them with the graphs'
        lock held. The loop's trips are deferred to :meth:`~janus_tpu_torch.
        runtime.step_graph.StepGraphs.settle`. Traced as ``synth.launch``
        (a device span) and its parts ``synth.prefill``, ``synth.loop``
        (whose ``steps`` the settle sets) and ``synth.tail``."""
        self.ar.load(text_ids, emotion, speaker)
        if self.loop is None:
            with span("synth.launch", device=self.n48.device):
                self.ar.prefill_graph.replay()
                self.tail.replay()
        else:
            with span("synth.launch", device=self.n48.device) as launch:
                marks = launch.marks(2)
                self.loop.mark(marks)
                trips = self.loop.run()
            _, loop_part, _ = launch.parts(
                ("synth.prefill", "synth.loop", "synth.tail"), marks)
            self.loop.defer(trips, loop_part)
        self.ar.begin()
        self.ar.steps = None
        return self.wav48, self.n48


class Synthesizer:
    """Packet → audio bytes, API-compatible with the reference service.

    Parameter trees are tensors or arrays in the package's layout, used in
    the dtype they come in (generation caches are in ``cfg.tts.dtype``);
    without them the models are initialized from ``rng_seed``.
    ``default_speaker_vec`` is the voice used when no reference audio is
    enrolled (speaker-conditioned checkpoints are trained with a vector in
    the [SPK] slot, so unconditioned generation is off-distribution).

    With a ``mesh`` (every rank of it constructing the synthesizer with
    the same arguments and synthesizing the same packets) the TTS and
    vocoder weights are this rank's shards by ``TTS_PARTITION_RULES`` and
    ``VOCODER_PARTITION_RULES``, and generation is tensor-parallel over
    ``model``; every rank returns the same audio. Generation draws no
    random numbers, so the ranks need no shared generator."""

    def __init__(
        self,
        cfg: Optional[JanusConfig] = None,
        tts_params=None,
        vocoder_params=None,
        speaker_params=None,
        reference_audio_path: Optional[str] = None,
        rng_seed: int = 0,
        default_speaker_vec=None,
        device="cuda",
        mesh=None,
        eager: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        # the AR loop's path on the card: its captured step (False) or the
        # eager Python loop (True), see tts.tts_generate
        self.eager = eager
        self._graphs = StepGraphs()
        self.cfg = cfg or JanusConfig()
        self.tokenizer = ByteTokenizer()

        def gen(seed: int) -> torch.Generator:
            return torch.Generator(device=self.device).manual_seed(seed)

        tcfg = self.cfg.tts
        if tts_params is None:
            tts_params = tts_mod.init_tts(
                gen(rng_seed), tcfg, text_vocab=self.tokenizer.vocab_size)
        if vocoder_params is None:
            vocoder_params = voc_mod.init_vocoder(
                gen(rng_seed + 1), self.cfg.vocoder, n_mels=tcfg.n_mels)
        if speaker_params is None:
            speaker_params = init_speaker_encoder(
                gen(rng_seed + 2), n_mels=tcfg.n_mels, d_out=tcfg.d_model)
        self.mesh = mesh
        if mesh is not None:
            tts_params = shard_params(tts_params, mesh, TTS_PARTITION_RULES)
            vocoder_params = shard_params(vocoder_params, mesh,
                                          VOCODER_PARTITION_RULES)
        self.tts_params = tree_to(tts_params, self.device)
        self.vocoder_params = tree_to(vocoder_params, self.device)
        self.speaker_params = tree_to(speaker_params, self.device)

        self._default_speaker_vec = (
            torch.from_numpy(np.array(default_speaker_vec, dtype=np.float32)
                             ).to(self.device)
            if default_speaker_vec is not None else None)
        self._reference_audio_path = reference_audio_path
        self._reference_audio_mtime: Optional[float] = None
        self._speaker_vec: Optional[torch.Tensor] = None
        if reference_audio_path:
            self._load_reference_audio(reference_audio_path)
        self._streamer = None  # lazy StreamingSynthesizer (shares params)

    # -- voice cloning (reference: synthesizer.py:67-104) ------------------

    def _load_reference_audio(self, path: str) -> None:
        try:
            if os.path.exists(path):
                # the verify endpoint saves the browser upload verbatim, so
                # the container is sniffed, not taken from the name
                audio, sr = read_audio(path)
                audio = torch.from_numpy(np.ascontiguousarray(
                    audio, dtype=np.float32)).to(self.device)
                if sr == 48_000:
                    audio16 = decimate_48k_to_16k(audio)
                elif sr == 16_000:
                    audio16 = audio
                else:
                    audio16 = resample_poly(audio, up=16_000, down=sr)
                self._speaker_vec = speaker_embed(
                    self.speaker_params, audio16, n_mels=self.cfg.tts.n_mels)
                self._reference_audio_mtime = os.path.getmtime(path)
            else:
                self._speaker_vec = None
                self._reference_audio_mtime = None
        except Exception as e:  # degrade, never crash synthesis
            logger.warning("Could not load reference audio from %s: %s",
                           path, e)
            self._speaker_vec = None
            self._reference_audio_mtime = None

    def _check_and_reload_reference_audio(self) -> None:
        path = self._reference_audio_path
        if path and os.path.exists(path):
            mtime = os.path.getmtime(path)
            if (self._reference_audio_mtime is None
                    or mtime != self._reference_audio_mtime):
                self._load_reference_audio(path)

    # -- device path -------------------------------------------------------

    def _graphed(self) -> bool:
        """Whether a synthesis launches its :class:`SynthGraph` (see
        :func:`~janus_tpu_torch.runtime.step_graph.use_graphs`)."""
        with use_mesh(self.mesh):
            return use_graphs(self.device, self.eager)

    def synth_graph(self, bucket: int, batch: int,
                    speaker: Optional[torch.dtype]) -> SynthGraph:
        """The :class:`SynthGraph` of ``bucket`` text tokens at ``batch``
        lanes with a speaker vector of dtype ``speaker`` (None: none),
        captured at its first request. Call with ``self._graphs.lock``
        held."""
        key = ("synth", bucket, batch, speaker)
        return self._graphs.holder(self._tree(), key, lambda: SynthGraph(
            self._graphs, self.tts_params, self.vocoder_params, self.cfg,
            bucket, batch, speaker, self.tokenizer.vocab_size, self.device))

    def _tree(self) -> dict:
        return {"tts": self.tts_params, "vocoder": self.vocoder_params}

    def _synth_impl(self, text_ids: torch.Tensor, emotion: torch.Tensor,
                    speaker: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(wav48[B, T48], n48[B])``: generate, vocode, resample. On the
        graph path one launch of the :class:`SynthGraph` of the shape after
        one upload (``text_ids`` and ``emotion`` may lie on the host; the
        results are the holder's static buffers, valid until the next
        synthesis: read them with ``self._graphs.lock`` held); otherwise
        the same functions issued op by op."""
        if self._graphed():
            with self._graphs.lock:
                return self.synth_graph(
                    text_ids.shape[1], text_ids.shape[0],
                    None if speaker is None else speaker.dtype).run(
                        text_ids, emotion, speaker)
        text_ids, emotion = (t.to(self.device) for t in (text_ids, emotion))
        with use_mesh(self.mesh), span("synth.launch", device=self.device):
            mel, n_frames = tts_mod.tts_generate(
                self.tts_params, self.cfg.tts, text_ids, emotion,
                speaker=speaker, text_vocab=self.tokenizer.vocab_size,
                eager=True)
            return vocode_48k(self.vocoder_params, self.cfg, mel, n_frames)

    def _speaker_arg(self) -> Optional[torch.Tensor]:
        if self._speaker_vec is not None:
            return self._speaker_vec
        return self._default_speaker_vec

    def _run_tts(self, prompt_text: str, emotion_tag: str) -> bytes:
        ids = self.tokenizer.encode(prompt_text)[: self.cfg.tts.max_text_tokens]
        # pad only to the next power-of-two text bucket (see text_bucket)
        bucket = tts_mod.text_bucket(len(ids), self.cfg.tts.max_text_tokens)
        padded = np.full((1, bucket), self.tokenizer.pad, dtype=np.int64)
        padded[0, : len(ids)] = ids
        emo = torch.tensor([tts_mod.emotion_id(emotion_tag)],
                           dtype=torch.long)
        speaker = self._speaker_arg()
        if speaker is not None:
            speaker = speaker[None, :]
        # Text-proportional duration guard: an AR stop-head miss must not
        # emit unbounded trailing audio (looping is the classic failure of
        # autoregressive acoustic models).
        cap = int((0.35 + self.cfg.tts.max_seconds_per_text_token * len(ids))
                  * 48_000)
        # the lock keeps the graph path's static results until they are
        # read; the inputs go up from the host (one pinned upload there)
        with span("synth.request"):
            with torch.no_grad(), self._graphs.lock:
                wav, n_samples = self._synth_impl(torch.from_numpy(padded),
                                                  emo, speaker)
                n = int(n_samples[0])
                pcm = wav[0, : max(min(n, cap), 0)].cpu().numpy()
            # the AR loop's bodies that ran (read after the samples)
            self._graphs.settle()
            pcm = np.clip(pcm, -1.0, 1.0)
            return (pcm * 32767.0).astype(np.int16).tobytes()

    def _resolve_emotion(self, packet: JanusPacket) -> str:
        if packet.override_emotion and packet.override_emotion != "Auto":
            return packet.override_emotion
        prosody = packet.prosody or {}
        return tts_emotion_tag(prosody.get("pitch", "Normal"),
                               prosody.get("energy", "Normal"))

    def synthesize_streaming(self, packet: JanusPacket):
        """Yield PCM16 byte chunks as mel groups are generated: first
        audio after one decode chunk instead of the full budget.
        Concatenated chunks equal :meth:`synthesize`'s output for the
        semantic/text modes; Morse is instant and yields once."""
        if packet.mode == JanusMode.MORSE_CODE:
            yield morse_audio(packet.text)
            return
        self._check_and_reload_reference_audio()
        if packet.mode == JanusMode.TEXT_ONLY:
            tag = (packet.override_emotion
                   if packet.override_emotion
                   and packet.override_emotion != "Auto" else "neutral")
        else:
            tag = self._resolve_emotion(packet)
        streamer = self.streamer()
        emitted = False
        try:
            chunks = streamer.stream_pcm16(packet.text, tag,
                                                 speaker=self._speaker_arg())
            while True:
                # the mesh is set while a chunk is computed, not while the
                # caller holds it
                with use_mesh(self.mesh):
                    chunk = next(chunks, None)
                if chunk is None:
                    break
                emitted = True
                yield chunk
        except Exception as e:
            logger.error("streaming synthesis failed: %s", e)
            if not emitted:  # reference fallback ladder, chunk-free
                fallback = self._generate_fast_tts(packet.text,
                                                   packet.override_emotion)
                if fallback:
                    yield fallback

    def streamer(self):
        """The :class:`~janus_tpu_torch.runtime.streaming_tts.
        StreamingSynthesizer` of :meth:`synthesize_streaming`, made at the
        first request on this synthesizer's weights."""
        if self._streamer is None:
            from janus_tpu_torch.runtime.streaming_tts import (
                StreamingSynthesizer)

            self._streamer = StreamingSynthesizer(
                self.cfg, tts_params=self.tts_params,
                vocoder_params=self.vocoder_params, device=self.device,
                eager=self.eager)
        return self._streamer

    def warmup(self) -> None:
        """On the graph path, capture the synthesis of one prompt in every
        text bucket with the speaker vector in use (:class:`SynthGraph`:
        the prefill, the AR step and loop, the tail) for :meth:`synthesize`,
        and the stream's graphs for :meth:`synthesize_streaming`
        (:meth:`~janus_tpu_torch.runtime.streaming_tts.StreamingSynthesizer.
        warmup`), so that no capture happens inside a live turn."""
        if not self._graphed():
            return
        speaker = self._speaker_arg()
        spk = None if speaker is None else speaker.dtype
        with torch.no_grad(), use_mesh(self.mesh), self._graphs.lock, \
                span("setup.warmup"):
            for bucket in tts_mod.text_buckets(self.cfg.tts.max_text_tokens):
                self.synth_graph(bucket, 1, spk)
        self.streamer().warmup(speaker=spk)

    # -- public API (reference: synthesizer.py:106-255) --------------------

    def synthesize(self, packet: JanusPacket) -> bytes:
        if packet.mode == JanusMode.MORSE_CODE:
            return morse_audio(packet.text)
        if packet.mode == JanusMode.TEXT_ONLY:
            return self._generate_fast_tts(packet.text,
                                           packet.override_emotion)
        if packet.mode == JanusMode.SEMANTIC_VOICE:
            return self._generate_semantic_audio(packet)
        raise ValueError(f"Unknown packet mode: {packet.mode}")

    def _generate_semantic_audio(self, packet: JanusPacket) -> bytes:
        self._check_and_reload_reference_audio()
        emotion = self._resolve_emotion(packet)
        try:
            return self._run_tts(packet.text, emotion)
        except Exception as e:
            logger.error("Synthesis error: %s", e)
            return self._generate_fast_tts(packet.text,
                                           packet.override_emotion)

    def _generate_fast_tts(self, text: str,
                           emotion: Optional[str] = None) -> bytes:
        self._check_and_reload_reference_audio()
        tag = emotion if (emotion and emotion != "Auto") else "neutral"
        try:
            return self._run_tts(text, tag)
        except Exception as e:
            logger.error("Fast TTS error: %s", e)
            return b""
