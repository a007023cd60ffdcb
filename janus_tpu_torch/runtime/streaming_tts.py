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
"""

from __future__ import annotations

import math
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.models import tts as tts_mod
from janus_tpu_torch.models import vocoder as voc_mod
from janus_tpu_torch.models.params import tree_to
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.ops.resample import resample_poly

__all__ = ["StreamingSynthesizer"]

# One-sided input-sample halo for exact interior polyphase resampling
# (windowed-sinc reach is num_taps/up ≈ 33 source samples; 128 is ample).
_RESAMPLE_HALO = 128


class StreamingSynthesizer:
    """Chunked text→audio with parity to the fused synthesis path.

    ``stream()`` yields 48 kHz float32 waveform chunks; ``synthesize``-
    style int16 bytes come from :meth:`stream_pcm16`.
    """

    def __init__(self, cfg: Optional[JanusConfig] = None, tts_params=None,
                 vocoder_params=None, chunk_groups: int = 16,
                 rng_seed: int = 0, stop_threshold: float = 0.5,
                 device="cuda") -> None:
        self.device = resolve_device(device)
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
        vcfg = self.cfg.vocoder
        self._hb = voc_mod.vocoder_halo_frames(vcfg)      # backbone halo
        self._hi = vcfg.n_fft // vcfg.hop_length          # iSTFT frame halo
        self._extra = vcfg.n_fft // vcfg.hop_length       # utterance-end flush
        g = math.gcd(48_000, vcfg.sample_rate)
        self._up, self._down = 48_000 // g, vcfg.sample_rate // g

    # -- streaming ----------------------------------------------------------

    @torch.no_grad()
    def stream(self, text: str, emotion_tag: str = "neutral",
               speaker=None) -> Iterator[np.ndarray]:
        """Yield 48 kHz float32 chunks; their concatenation is the
        non-streaming synthesis of the same prompt."""
        tcfg, vcfg, dev = self.cfg.tts, self.cfg.vocoder, self.device
        r = tcfg.reduction
        max_groups = tcfg.max_mel_frames // r
        t_frames = max_groups * r            # the full mel budget
        hop = vcfg.hop_length

        ids = self.tokenizer.encode(text)[: tcfg.max_text_tokens]
        bucket = tts_mod.text_bucket(len(ids), tcfg.max_text_tokens)
        padded = np.full((1, bucket), self.tokenizer.pad, np.int64)
        padded[0, : len(ids)] = ids
        emo = torch.tensor([tts_mod.emotion_id(emotion_tag)],
                           dtype=torch.long, device=dev)
        spk = None
        if speaker is not None:
            spk = torch.as_tensor(speaker, dtype=torch.float32).to(dev)[None, :]

        first, done, state = tts_mod.tts_prefill(
            self.tts_params, tcfg, torch.from_numpy(padded).to(dev), emo,
            speaker=spk, text_vocab=self.tokenizer.vocab_size,
            stop_threshold=self.stop_threshold)

        # buffers over the FULL budget (like tts_generate's zero-filled
        # output buffer, so parity holds after the stop)
        mel_buf = torch.zeros((1, t_frames, tcfg.n_mels), device=dev)
        n_bins = vcfg.n_fft // 2 + 1
        spec_buf = torch.zeros((1, t_frames + self._extra, n_bins),
                               dtype=torch.complex64, device=dev)
        mel_buf[0, 0:r, :] = first.reshape(r, tcfg.n_mels)
        groups_have = 1          # mel groups in the buffer
        n_valid_groups = 1       # groups before the stop fired
        stopped = bool(done[0])
        spec_have = 0            # spectra computed through this frame
        emitted48 = 0
        prev = first

        chunk_frames = self.chunk_groups * r

        def gen_more():
            nonlocal prev, done, state, groups_have, stopped, n_valid_groups
            lo = groups_have
            hi = min(lo + self.chunk_groups, max_groups)
            # never a step past the budget: the caches hold prompt +
            # max_groups positions and a write beyond them raises (the JAX
            # package runs the full chunk and drops the surplus groups)
            groups, dones, prev, done, state = tts_mod.tts_decode_chunk(
                self.tts_params, tcfg, state, prev, done, lo - 1,
                n_steps=hi - lo, stop_threshold=self.stop_threshold)
            mel_buf[0, lo * r: hi * r, :] = groups[0].reshape(-1, tcfg.n_mels)
            if not stopped:
                d = dones[0].cpu().numpy()   # done BEFORE each group
                n_valid_groups = lo + int(np.argmax(d)) if d.any() else hi
                stopped = bool(d.any())
            groups_have = hi

        def spec_through(frame: int):
            """Compute spectra for frames [spec_have, frame)."""
            nonlocal spec_have
            while spec_have < frame:
                a = spec_have
                b = min(a + chunk_frames, t_frames)
                m_lo = max(0, a - self._hb)
                m_hi = min(t_frames, b + self._hb)
                # mel through m_hi must exist (zeros after the stop are
                # already the right values, as in tts_generate)
                while (groups_have * r < m_hi and groups_have < max_groups
                       and not stopped):
                    gen_more()
                spec = voc_mod.vocoder_spectra(self.vocoder_params, vcfg,
                                               mel_buf[:, m_lo:m_hi, :])
                spec_buf[:, a:b, :] = spec[:, a - m_lo: b - m_lo, :]
                spec_have = b
                if b == t_frames:  # utterance-end flush (spec tail repeat)
                    spec_buf[:, t_frames:, :] = spec_buf[:, t_frames - 1:
                                                         t_frames, :]
                    spec_have = t_frames + self._extra

        def emit(a_frame: int, b_frame: int, n48_limit: int) -> np.ndarray:
            """48 kHz samples for vocoder frames [a, b)."""
            spec_through(min(b_frame + self._hi + 1, t_frames))
            s0 = max(0, a_frame - self._hi - 1)
            s1 = min(t_frames + self._extra, b_frame + self._hi + 1)
            wav = voc_mod.spectra_to_waveform(vcfg, spec_buf[:, s0:s1, :],
                                              tail_repeat=False)
            # local sample l == absolute sample s0*hop + l
            core_lo = a_frame * hop
            core_hi = b_frame * hop
            rh_l = min(_RESAMPLE_HALO, core_lo - s0 * hop)
            # the right halo clamps to the FULL signal length
            # (t_frames*hop): the fused path slices the waveform there
            # before resampling, so its resampler sees zero right-padding,
            # not the iSTFT flush tail
            hi_abs = min(core_hi + _RESAMPLE_HALO, t_frames * hop)
            span = wav[:, core_lo - s0 * hop - rh_l: hi_abs - s0 * hop]
            if (self._up, self._down) != (1, 1):
                out = resample_poly(span, up=self._up, down=self._down)
                lo = rh_l * self._up // self._down
                n = (core_hi - core_lo) * self._up // self._down
                out = out[:, lo: lo + n]
            else:
                out = span[:, rh_l: rh_l + (core_hi - core_lo)]
            take = min(out.shape[1], n48_limit)
            return out[0, :take].cpu().numpy()

        samples_per_frame48 = hop * self._up // self._down
        # same text-proportional duration guard as the fused path
        # (Synthesizer._run_tts): parity requires identical clipping
        cap48 = int((0.35 + tcfg.max_seconds_per_text_token * len(ids))
                    * 48_000)
        a = 0
        while a < t_frames:
            b = min(a + chunk_frames, t_frames)
            # generate through this chunk's spec halo first, so any stop
            # inside [a, b) is known BEFORE the emission limit is fixed
            need_groups = min(max_groups,
                              -(-min(t_frames, b + self._hb) // r))
            while groups_have < need_groups and not stopped:
                gen_more()
            n48 = min((n_valid_groups if stopped else max_groups)
                      * r * samples_per_frame48, cap48)
            if emitted48 >= n48:
                break
            chunk = emit(a, b, n48 - emitted48)
            emitted48 += len(chunk)
            if len(chunk):
                yield chunk
            if emitted48 >= n48:
                break
            a = b

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
