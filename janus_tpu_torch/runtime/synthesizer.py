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
from janus_tpu_torch.runtime.emotion import tts_emotion_tag

logger = logging.getLogger(__name__)

__all__ = ["Synthesizer"]


class Synthesizer:
    """Packet → audio bytes, API-compatible with the reference service.

    Parameter trees are tensors or arrays in the package's layout, used in
    the dtype they come in (generation caches are in ``cfg.tts.dtype``);
    without them the models are initialized from ``rng_seed``.
    ``default_speaker_vec`` is the voice used when no reference audio is
    enrolled (speaker-conditioned checkpoints are trained with a vector in
    the [SPK] slot, so unconditioned generation is off-distribution)."""

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
    ) -> None:
        self.device = resolve_device(device)
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

    def _synth_impl(self, text_ids: torch.Tensor, emotion: torch.Tensor,
                    speaker: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(wav48[B, T48], n48[B])``: generate, vocode, resample."""
        mel, n_frames = tts_mod.tts_generate(
            self.tts_params, self.cfg.tts, text_ids, emotion,
            speaker=speaker, text_vocab=self.tokenizer.vocab_size)
        wav = voc_mod.vocoder_waveform(self.vocoder_params, self.cfg.vocoder,
                                       mel)
        # vocoder rate -> 48 kHz playback
        sr = self.cfg.vocoder.sample_rate
        g = math.gcd(48_000, sr)
        up, down = 48_000 // g, sr // g
        wav48 = (resample_poly(wav, up=up, down=down)
                 if (up, down) != (1, 1) else wav)
        n48 = n_frames * self.cfg.vocoder.hop_length * up // down
        return wav48, n48

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
                           dtype=torch.long, device=self.device)
        speaker = self._speaker_arg()
        if speaker is not None:
            speaker = speaker[None, :]
        with torch.no_grad():
            wav, n_samples = self._synth_impl(
                torch.from_numpy(padded).to(self.device), emo, speaker)
        n = int(n_samples[0])
        # Text-proportional duration guard: an AR stop-head miss must not
        # emit unbounded trailing audio (looping is the classic failure of
        # autoregressive acoustic models).
        cap = int((0.35 + self.cfg.tts.max_seconds_per_text_token * len(ids))
                  * 48_000)
        pcm = wav[0, : max(min(n, cap), 0)].cpu().numpy()
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
        if self._streamer is None:
            from janus_tpu_torch.runtime.streaming_tts import (
                StreamingSynthesizer)

            self._streamer = StreamingSynthesizer(
                self.cfg, tts_params=self.tts_params,
                vocoder_params=self.vocoder_params, device=self.device)
        emitted = False
        try:
            for chunk in self._streamer.stream_pcm16(
                    packet.text, tag, speaker=self._speaker_arg()):
                emitted = True
                yield chunk
        except Exception as e:
            logger.error("streaming synthesis failed: %s", e)
            if not emitted:  # reference fallback ladder, chunk-free
                fallback = self._generate_fast_tts(packet.text,
                                                   packet.override_emotion)
                if fallback:
                    yield fallback

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
