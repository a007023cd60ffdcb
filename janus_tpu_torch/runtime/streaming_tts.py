"""Streaming TTS: emit waveform chunks while mel groups are still being
generated.

The reference's turnaround was a full cloud round trip: nothing played
until the whole clip came back. Here the decode side is chunked end to
end:

1. the TTS transformer generates mel in chunks of ``chunk_groups``
   KV-cached steps (:func:`janus_tpu_torch.models.tts.tts_decode_chunk`)
   instead of one loop over the whole budget;
2. the vocoder backbone is frame-local (ConvNeXt k=7: a halo of 3·layers
   frames), so each chunk's spectra are computed from the chunk plus halo
   (:func:`janus_tpu_torch.models.vocoder.vocoder_spectra`);
3. the iSTFT and the polyphase resampler to 48 kHz get the same halo
   treatment (window span / FIR reach), and both sum in an order that
   does not depend on position, so every emitted chunk is the
   corresponding slice of the non-streaming ``Synthesizer`` output: to
   the bit through the iSTFT and the resampler, and to rounding through
   the backbone's matmuls, which see ``chunk + 2·halo`` rows here and all
   rows there (``tests/test_torch_synth.py`` holds 3e-5).

Turnaround: first audio after prompt prefill + one chunk of groups + one
chunk vocode, instead of the full generation budget. The mel and spectra
buffers stay on the device; a chunk reads back its ``dones`` flags and
the samples it emits, nothing else.

The JAX package compiles the stream's prefill, its chunk (a ``lax.scan``
of ``n`` steps), the spectra, the iSTFT and the resampler. On the card
the port replays the prefill of an :class:`~janus_tpu_torch.models.tts.
ARGraph`, launches a chain of its captured step a chunk, and replays one
captured emission a chunk index (:class:`StreamGraph`: the spectra pieces
that emission computes, the iSTFT and the resampler over the streamer's
static mel and spectra buffers; the windows are fixed by the index for a
given budget). ``eager=True``, the CPU and a mesh of more than one rank run
the same functions eagerly over buffers of their own.
"""

from __future__ import annotations

import time
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.models import tts as tts_mod
from janus_tpu_torch.models import vocoder as voc_mod
from janus_tpu_torch.models.params import tree_to
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.ops.resample import resample_poly
from janus_tpu_torch.runtime.profiling import span
from janus_tpu_torch.runtime.step_graph import (StepGraph, StepGraphs,
                                                use_graphs)
from janus_tpu_torch.runtime.synthesizer import rate_ratio

__all__ = ["StreamingSynthesizer", "StreamGraph", "Emission",
           "emission_plan"]

# One-sided input-sample halo for exact interior polyphase resampling
# (windowed-sinc reach is num_taps/up ≈ 33 source samples; 128 is ample).
_RESAMPLE_HALO = 128


class Emission(NamedTuple):
    """What the stream's chunk ``[a, b)`` (vocoder frames) computes.
    ``pieces``: the spectra pieces first needed here, each ``(pa, pb,
    m_lo, m_hi)`` (frames ``[pa, pb)`` from mel ``[m_lo, m_hi)``; the last
    piece of the budget also writes the utterance-end flush); ``mel_end``:
    the mel frames that must exist before it; ``s0:s1``: the spectra its
    iSTFT reads; ``w0:w1``: the samples of that iSTFT the resampler reads;
    ``lo``: the first resampled sample kept, ``n`` the samples kept."""

    a: int
    b: int
    pieces: Tuple[Tuple[int, int, int, int], ...]
    mel_end: int
    s0: int
    s1: int
    w0: int
    w1: int
    lo: int
    n: int


def emission_plan(t_frames: int, chunk_frames: int, halo: int, ratio: int,
                  hop: int, up: int, down: int) -> List[Emission]:
    """The windows of every chunk index of a stream over ``t_frames`` mel
    frames (``halo``: the backbone's one-sided reach; ``ratio``: n_fft //
    hop, the iSTFT's frame halo and the flush), in order: chunk ``i``
    computes the spectra pieces that its iSTFT reads and no earlier chunk
    computed, so the windows depend on the index alone."""
    out, spec_have, a = [], 0, 0
    while a < t_frames:
        b = min(a + chunk_frames, t_frames)
        target = min(b + ratio + 1, t_frames)
        pieces, mel_end = [], min(t_frames, b + halo)
        while spec_have < target:
            pa = spec_have
            pb = min(pa + chunk_frames, t_frames)
            m_hi = min(t_frames, pb + halo)
            pieces.append((pa, pb, max(0, pa - halo), m_hi))
            mel_end = max(mel_end, m_hi)
            spec_have = pb if pb < t_frames else t_frames + ratio
        s0 = max(0, a - ratio - 1)
        s1 = min(t_frames + ratio, b + ratio + 1)
        # local sample l of the iSTFT == absolute sample s0*hop + l; the
        # right halo clamps to the FULL signal length (t_frames*hop): the
        # fused path slices the waveform there before resampling, so its
        # resampler sees zero right-padding, not the iSTFT flush tail
        core_lo, core_hi = a * hop, b * hop
        rh_l = min(_RESAMPLE_HALO, core_lo - s0 * hop)
        hi_abs = min(core_hi + _RESAMPLE_HALO, t_frames * hop)
        out.append(Emission(a, b, tuple(pieces), mel_end, s0, s1,
                            core_lo - s0 * hop - rh_l, hi_abs - s0 * hop,
                            rh_l * up // down, (core_hi - core_lo) * up
                            // down))
        a = b
    return out


class StreamGraph:
    """The stream's vocoder side for one budget and one tree: the static
    mel (``[1, T, n_mels]``, zeroed at each stream's start, as the fused
    path's output buffer is zero past the stop) and spectra buffers, the
    static output of one emission, and on the card one captured emission
    graph a chunk index (:func:`emission_plan`), replayed by :meth:`emit`.
    Without ``graphs`` (the eager path) nothing is captured and
    :meth:`emit` runs the same function over the same buffers."""

    def __init__(self, vocoder_params, cfg: JanusConfig, chunk_frames: int,
                 device: torch.device, graphs: Optional[StepGraphs] = None):
        tcfg, vcfg = cfg.tts, cfg.vocoder
        self.vocoder_params, self.vcfg = vocoder_params, vcfg
        r = tcfg.reduction
        self.t_frames = (tcfg.max_mel_frames // r) * r   # the full budget
        ratio = vcfg.n_fft // vcfg.hop_length
        self.up, self.down = rate_ratio(vcfg.sample_rate)
        self.plan = emission_plan(self.t_frames, chunk_frames,
                                  voc_mod.vocoder_halo_frames(vcfg), ratio,
                                  vcfg.hop_length, self.up, self.down)
        self.mel = torch.zeros((1, self.t_frames, tcfg.n_mels), device=device)
        self.spec = torch.zeros((1, self.t_frames + ratio,
                                 vcfg.n_fft // 2 + 1), dtype=torch.complex64,
                                device=device)
        self.out48 = torch.zeros((1, max(e.n for e in self.plan)),
                                 device=device)
        self.epoch = 0
        self.side_graphs: List[StepGraph] = []
        self.pool_bytes = 0
        if graphs is not None:
            before = graphs.pool_bytes()
            args = graphs.capture_args(device)
            self.side_graphs = [StepGraph(self._emit, device, args=(i,),
                                          **args)
                                for i in range(len(self.plan))]
            self.pool_bytes = graphs.pool_bytes() - before

    def begin(self) -> int:
        """A new stream over the buffers: the mel zeroed; its epoch."""
        self.mel.zero_()
        self.epoch += 1
        return self.epoch

    def _emit(self, i: int) -> None:
        e, t = self.plan[i], self.t_frames
        for pa, pb, m_lo, m_hi in e.pieces:
            spec = voc_mod.vocoder_spectra(self.vocoder_params, self.vcfg,
                                           self.mel[:, m_lo:m_hi, :])
            self.spec[:, pa:pb, :] = spec[:, pa - m_lo: pb - m_lo, :]
            if pb == t:  # utterance-end flush (spec tail repeat)
                self.spec[:, t:, :] = self.spec[:, t - 1:t, :]
        wav = voc_mod.spectra_to_waveform(self.vcfg, self.spec[:, e.s0:e.s1, :],
                                          tail_repeat=False)
        span = wav[:, e.w0:e.w1]
        if (self.up, self.down) != (1, 1):
            out = resample_poly(span, up=self.up, down=self.down)
        else:
            out = span
        self.out48[:, :e.n].copy_(out[:, e.lo:e.lo + e.n])

    def emit(self, i: int, epoch: int) -> torch.Tensor:
        """Chunk ``i``'s 48 kHz samples (a view of the static output, which
        the next emission overwrites), from the spectra its pieces compute
        over the mel generated so far: a replay of its graph, or on the
        eager path its function."""
        if epoch != self.epoch:
            raise RuntimeError("the stream's buffers were taken by a later "
                               "stream")
        if self.side_graphs:
            self.side_graphs[i].replay()
        else:
            self._emit(i)
        return self.out48[0, :self.plan[i].n]


class StreamingSynthesizer:
    """Chunked text→audio with parity to the fused synthesis path.

    ``stream()`` yields 48 kHz float32 waveform chunks; ``synthesize``-
    style int16 bytes come from :meth:`stream_pcm16`.
    """

    def __init__(self, cfg: Optional[JanusConfig] = None, tts_params=None,
                 vocoder_params=None, chunk_groups: int = 16,
                 rng_seed: int = 0, stop_threshold: float = 0.5,
                 device="cuda", eager: bool = False) -> None:
        self.device = resolve_device(device)
        # the path on the card: captured graphs (False) or the same
        # functions issued op by op (True), see tts.tts_prefill
        self.eager = eager
        self._graphs = StepGraphs()
        self.cfg = cfg or JanusConfig()
        self.tokenizer = ByteTokenizer()

        def gen(seed: int) -> torch.Generator:
            return torch.Generator(device=self.device).manual_seed(seed)

        if tts_params is None:
            tts_params = tts_mod.init_tts(
                gen(rng_seed), self.cfg.tts,
                text_vocab=self.tokenizer.vocab_size)
        if vocoder_params is None:
            vocoder_params = voc_mod.init_vocoder(
                gen(rng_seed + 1), self.cfg.vocoder,
                n_mels=self.cfg.tts.n_mels)
        self.tts_params = tree_to(tts_params, self.device)
        self.vocoder_params = tree_to(vocoder_params, self.device)
        self.chunk_groups = int(chunk_groups)
        self.stop_threshold = float(stop_threshold)

    # -- the holders --------------------------------------------------------

    def _graphed(self) -> bool:
        return use_graphs(self.device, self.eager)

    def _tree(self) -> dict:
        return {"tts": self.tts_params, "vocoder": self.vocoder_params}

    def ar_graph(self, bucket: int, speaker: Optional[torch.dtype]):
        """The :class:`~janus_tpu_torch.models.tts.ARGraph` of a one-lane
        prompt of ``bucket`` text tokens (speaker vector of dtype
        ``speaker``, None: none), captured at its first request. Call with
        ``self._graphs.lock`` held."""
        tcfg = self.cfg.tts
        return tts_mod.ar_graph(
            self._graphs, self.tts_params, tcfg, 1, bucket + 3,
            tcfg.max_mel_frames // tcfg.reduction, self.stop_threshold,
            self.device, self.tokenizer.vocab_size, speaker,
            tree=self._tree())

    def stream_graph(self) -> StreamGraph:
        """The streamer's :class:`StreamGraph`, its emissions captured at
        the first request. Call with ``self._graphs.lock`` held."""
        return self._graphs.holder(self._tree(), ("emit",), lambda:
                                   StreamGraph(self.vocoder_params, self.cfg,
                                               self._chunk_frames(),
                                               self.device, self._graphs))

    def _chunk_frames(self) -> int:
        return self.chunk_groups * self.cfg.tts.reduction

    # -- streaming ----------------------------------------------------------

    def stream(self, text: str, emotion_tag: str = "neutral",
               speaker=None) -> Iterator[np.ndarray]:
        """Yield 48 kHz float32 chunks; their concatenation is the
        non-streaming synthesis of the same prompt. Traced as one
        ``stream.request``: its ``stream.prefill``, and a chunk's
        ``stream.decode`` (its ``steps``), ``stream.dones`` (the flags'
        read), ``stream.emit`` and ``stream.read`` (the samples' read,
        whose end is the chunk's arrival on the host)."""
        req = span("stream.request")
        try:
            yield from self._stream(req, text, emotion_tag, speaker)
        finally:
            req.close()

    @torch.no_grad()
    def _stream(self, req, text: str, emotion_tag: str,
                speaker) -> Iterator[np.ndarray]:
        tcfg, vcfg, dev = self.cfg.tts, self.cfg.vocoder, self.device
        r = tcfg.reduction
        max_groups = tcfg.max_mel_frames // r

        ids = self.tokenizer.encode(text)[: tcfg.max_text_tokens]
        bucket = tts_mod.text_bucket(len(ids), tcfg.max_text_tokens)
        padded = np.full((1, bucket), self.tokenizer.pad, np.int64)
        padded[0, : len(ids)] = ids
        emo = torch.tensor([tts_mod.emotion_id(emotion_tag)],
                           dtype=torch.long)
        spk = None
        if speaker is not None:
            spk = torch.as_tensor(speaker, dtype=torch.float32).to(dev)[None, :]

        graphed = self._graphed()
        lock = self._graphs.lock
        with lock, span("stream.prefill", parent=req, device=dev):
            if graphed:
                out = self.stream_graph()
                first, done, state = self.ar_graph(
                    bucket, None if spk is None else spk.dtype).prefill(
                        torch.from_numpy(padded), emo, spk)
            else:
                # buffers of this stream's own
                out = StreamGraph(self.vocoder_params, self.cfg,
                                  self._chunk_frames(), dev)
                first, done, state = tts_mod.tts_prefill(
                    self.tts_params, tcfg, torch.from_numpy(padded).to(dev),
                    emo.to(dev), speaker=spk,
                    text_vocab=self.tokenizer.vocab_size,
                    stop_threshold=self.stop_threshold, eager=True)
            epoch = out.begin()
            # the mel buffer covers the FULL budget (like tts_generate's
            # zero-filled output buffer, so parity holds after the stop)
            out.mel[0, 0:r, :] = first.reshape(r, tcfg.n_mels)
        groups_have = 1          # mel groups in the buffer
        n_valid_groups = 1       # groups before the stop fired
        stopped = bool(done[0])
        emitted48 = 0
        prev = first

        def gen_more():
            nonlocal prev, done, state, groups_have, stopped, n_valid_groups
            lo = groups_have
            hi = min(lo + self.chunk_groups, max_groups)
            # never a step past the budget: the caches hold prompt +
            # max_groups positions and a write beyond them raises (the JAX
            # package runs the full chunk and drops the surplus groups)
            with span("stream.decode", parent=req, device=dev,
                      steps=hi - lo):
                groups, dones, prev, done, state = tts_mod.tts_decode_chunk(
                    self.tts_params, tcfg, state, prev, done, lo - 1,
                    n_steps=hi - lo, stop_threshold=self.stop_threshold)
                out.mel[0, lo * r: hi * r, :] = groups[0].reshape(
                    -1, tcfg.n_mels)
            if not stopped:
                with span("stream.dones", parent=req):
                    d = dones[0].cpu().numpy()   # done BEFORE each group
                n_valid_groups = lo + int(np.argmax(d)) if d.any() else hi
                stopped = bool(d.any())
            groups_have = hi

        samples_per_frame48 = vcfg.hop_length * out.up // out.down
        # same text-proportional duration guard as the fused path
        # (Synthesizer._run_tts): parity requires identical clipping
        cap48 = int((0.35 + tcfg.max_seconds_per_text_token * len(ids))
                    * 48_000)
        for i, e in enumerate(out.plan):
            with lock:
                # generate through the mel this chunk's spectra read first,
                # so any stop inside [a, b) is known BEFORE the emission
                # limit is fixed (zeros after the stop are already the
                # right values, as in tts_generate)
                while (groups_have * r < e.mel_end
                       and groups_have < max_groups and not stopped):
                    gen_more()
                n48 = min((n_valid_groups if stopped else max_groups)
                          * r * samples_per_frame48, cap48)
                if emitted48 >= n48:
                    break
                take = min(e.n, n48 - emitted48)
                with span("stream.emit", parent=req, device=dev):
                    pcm = out.emit(i, epoch)[:take]
                # a copy: the static output is the next emission's
                with span("stream.read", parent=req):
                    chunk = pcm.to("cpu", copy=True).numpy()
            emitted48 += len(chunk)
            if len(chunk):
                yield chunk
            if emitted48 >= n48:
                break

    def warmup(self, speaker: Optional[torch.dtype] = None) -> None:
        """On the graph path, capture the AR prefill and step of a one-lane
        prompt in every text bucket (with a speaker vector of dtype
        ``speaker``, or none), build their chains of the stream's chunk
        lengths, and capture the emission of every chunk index, so that no
        capture or graph build happens inside a live turn."""
        if not self._graphed():
            return
        max_groups = self.cfg.tts.max_mel_frames // self.cfg.tts.reduction
        # the chunks after the prefill's group: chunk_groups steps each,
        # the last one what is left
        lengths = {min(self.chunk_groups, max_groups - lo)
                   for lo in range(1, max_groups, self.chunk_groups)} - {1}
        with torch.no_grad(), self._graphs.lock, span("setup.warmup"):
            for bucket in tts_mod.text_buckets(self.cfg.tts.max_text_tokens):
                h = self.ar_graph(bucket, speaker)
                for n in sorted(lengths):
                    h.chain(n)
            self.stream_graph()

    def stream_pcm16(self, text: str, emotion_tag: str = "neutral",
                     speaker=None) -> Iterator[bytes]:
        for chunk in self.stream(text, emotion_tag, speaker=speaker):
            yield (np.clip(chunk, -1.0, 1.0) * 32767.0).astype(
                np.int16).tobytes()

    def turnaround(self, text: str, emotion_tag: str = "neutral",
                   speaker=None) -> Tuple[float, float, int]:
        """(seconds to the FIRST audio chunk, seconds to full audio,
        samples); a chunk counts when its samples are on the host."""
        t0 = time.perf_counter()
        first_t = None
        total = 0
        for chunk in self.stream(text, emotion_tag, speaker=speaker):
            if first_t is None:
                first_t = time.perf_counter() - t0
            total += len(chunk)
        return (first_t or 0.0), time.perf_counter() - t0, total
