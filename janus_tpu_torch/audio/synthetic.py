"""Deterministic synthetic audio, numpy only.

A copy of the JAX package's tone-language renderer (``render_text`` and
the helpers it calls, from ``janus_tpu/train/synthetic_task.py``) and its
speech-like test signals (``tone``, ``voiced_phrase``, ``conversation``,
``chunk_stream``, from ``janus_tpu/audio/synthetic.py``), so the port can speak the demo
checkpoint's language without the JAX package. Same seeds, same samples.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

__all__ = [
    "WORDS",
    "char_frequency",
    "speaker_timbre",
    "render_text",
    "tone",
    "voiced_phrase",
    "conversation",
    "chunk_stream",
]

# Small closed vocabulary: enough structure to be language-like, small
# enough to overfit quickly on CPU in tests.
WORDS = (
    "alpha", "bravo", "charlie", "delta", "echo", "fox", "golf", "hotel",
    "india", "juliet", "kilo", "lima", "mike", "nov", "oscar", "papa",
)

CHAR_SECONDS = 0.06      # per-character tone duration
WORD_GAP_SECONDS = 0.04  # silence between words
BASE_F0 = 120.0
F0_STEP = 24.0


def char_frequency(c: str) -> float:
    """Character → fundamental frequency (a–z mapped to a log-ish ladder)."""
    idx = max(0, min(ord(c.lower()) - ord("a"), 25))
    return BASE_F0 + F0_STEP * idx


# "Speakers": harmonic gain profiles (timbres) applied on top of the base
# (amp, amp/2, amp/4) stack. Speaker 0 = identity = the original voice, so
# existing checkpoints keep their training distribution.
SPEAKER_TIMBRES = (
    (1.0, 1.0, 1.0),    # default voice
    (1.0, 0.2, 2.4),    # hollow (3rd-harmonic heavy)
    (0.4, 2.0, 0.8),    # nasal (2nd-harmonic dominant)
    (1.0, 0.0, 0.0),    # pure tone
)


def speaker_timbre(speaker: int) -> Tuple[float, float, float]:
    """Harmonic gain profile for an arbitrary speaker index. Indices
    0..3 return the fixed :data:`SPEAKER_TIMBRES` (checkpoint compat);
    higher indices get deterministic pseudo-random timbres, giving the
    hard corpus an open set of voices."""
    if speaker < len(SPEAKER_TIMBRES):
        return SPEAKER_TIMBRES[speaker % len(SPEAKER_TIMBRES)]
    r = np.random.default_rng(9000 + speaker)
    return (float(r.uniform(0.3, 1.2)), float(r.uniform(0.0, 2.2)),
            float(r.uniform(0.0, 2.2)))


# Emotion → (amplitude scale, speaking-rate scale, vibrato depth, tremolo
# depth): how the corpus *renders* the emotion tags of the wire protocol
# (reference tags: backend/services/synthesizer.py:158-175). Deliberately
# NO F0 scaling: in the tone language the character F0 ladder IS the text
# content, so an emotion that shifted F0 would corrupt the transcript —
# exactly as a real TTS keeps phonemes intelligible while varying affect.
# (Round-2 rendering scaled F0 and broke round-trip WER; see docs/PARITY.md.)
# Vibrato depth is capped ≤ 0.015: the ladder step at 'z' (720 Hz) is
# 24/720 ≈ 3.3%, so deeper vibrato would cross character boundaries.
EMOTION_RENDERING = {
    #              amp   rate  vibrato tremolo
    "neutral":    (1.00, 1.00, 0.000, 0.00),
    "excited":    (1.60, 1.15, 0.012, 0.30),
    "joyful":     (1.15, 1.10, 0.012, 0.20),
    "whispering": (0.35, 0.95, 0.000, 0.10),
    "shouting":   (1.80, 1.05, 0.000, 0.00),
    "sad":        (0.70, 0.85, 0.008, 0.10),
    "relaxed":    (1.00, 0.90, 0.000, 0.00),
    "panicked":   (1.60, 1.30, 0.015, 0.35),
    "serious":    (1.10, 0.90, 0.000, 0.00),
    "calm":       (0.85, 0.90, 0.000, 0.00),
    "angry":      (1.70, 1.10, 0.000, 0.40),
    "auto":       (1.00, 1.00, 0.000, 0.00),
}

VIBRATO_HZ = 6.0
TREMOLO_HZ = 5.0


def render_text(text: str, sample_rate: int = 16_000, amp: float = 0.3,
                noise: float = 0.002, seed: int = 0,
                speaker: int = 0, emotion: str = "neutral",
                rate: float = 1.0, hop_quantize: int = 0) -> np.ndarray:
    """Deterministic waveform for a text string.

    ``speaker`` selects a harmonic timbre profile (voice identity, any
    index via :func:`speaker_timbre`); ``emotion`` modulates amplitude /
    rate / vibrato / tremolo per :data:`EMOTION_RENDERING` while leaving
    the character F0 ladder untouched; ``rate`` is an additional
    speaking-rate multiplier (>1 = faster) for corpus difficulty.

    ``hop_quantize`` (samples) rounds char/gap durations to that grid.
    The DECODE-stack corpora (TTS targets, vocoder pool) must pass their
    mel hop here: the vocoder learns phase only because every tone onset
    lands on the analysis grid — rate-scaled durations off the grid shift
    target phase by sub-hop offsets that are invisible in mel, capping
    copy-synthesis SNR near 13 dB (round-3 regression). ASR corpora keep
    the default 0 (continuous rates are part of their difficulty)."""
    rng = np.random.default_rng(seed)
    h1, h2, h3 = speaker_timbre(speaker)
    amp_scale, rate_scale, vib, trem = EMOTION_RENDERING.get(
        emotion, (1.0, 1.0, 0.0, 0.0))
    amp = amp * amp_scale
    total_rate = max(rate * rate_scale, 1e-3)
    segs: List[np.ndarray] = []
    n_char = max(16, int(CHAR_SECONDS / total_rate * sample_rate))
    n_gap = max(8, int(WORD_GAP_SECONDS / total_rate * sample_rate))
    if hop_quantize > 0:
        n_char = max(hop_quantize, round(n_char / hop_quantize) * hop_quantize)
        n_gap = max(hop_quantize, round(n_gap / hop_quantize) * hop_quantize)
    for w, word in enumerate(text.split()):
        if w > 0:
            segs.append(np.zeros(n_gap, dtype=np.float32))
        for c in word:
            f0 = char_frequency(c)
            t = np.arange(n_char) / sample_rate
            # phase-modulated vibrato: instantaneous frequency
            # f0 * (1 + vib*cos(2π f_v t)) — char identity preserved
            phase = 2 * np.pi * f0 * t
            if vib > 0:
                phase = phase + (f0 * vib / VIBRATO_HZ) * np.sin(
                    2 * np.pi * VIBRATO_HZ * t)
            x = (
                amp * h1 * np.sin(phase)
                + (amp / 2) * h2 * np.sin(2 * phase)
                + (amp / 4) * h3 * np.sin(3 * phase)
            )
            if trem > 0:
                x = x * (1.0 - trem / 2 + (trem / 2) * np.cos(
                    2 * np.pi * TREMOLO_HZ * t))
            # short fade to avoid clicks (keeps the spectrum clean)
            ramp = min(32, n_char // 4)
            env = np.ones(n_char)
            env[:ramp] = np.linspace(0, 1, ramp)
            env[-ramp:] = np.linspace(1, 0, ramp)
            segs.append((x * env).astype(np.float32))
    if not segs:
        return np.zeros(n_char, dtype=np.float32)
    audio = np.concatenate(segs)
    if noise > 0:
        audio = audio + noise * rng.standard_normal(len(audio)).astype(np.float32)
    return audio.astype(np.float32)


def tone(freq: float, seconds: float, sample_rate: int = 48_000,
         amp: float = 0.5) -> np.ndarray:
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def voiced_phrase(f0: float = 180.0, seconds: float = 1.5,
                  sample_rate: int = 48_000, amp: float = 0.1,
                  harmonics: int = 3, vibrato_hz: float = 5.0,
                  seed: int = 0) -> np.ndarray:
    """Speech-like signal: harmonic stack on f0 with mild vibrato and an
    amplitude envelope — voiced enough for YIN, energetic enough for VAD."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    phase = 2 * np.pi * f0 * t + 0.3 * np.sin(2 * np.pi * vibrato_hz * t)
    x = np.zeros(n, dtype=np.float64)
    for h in range(1, harmonics + 1):
        x += (amp / h) * np.sin(h * phase)
    env = 0.6 + 0.4 * np.sin(np.pi * np.minimum(t / seconds, 1.0))
    x *= env
    x += 0.002 * rng.standard_normal(n)
    return x.astype(np.float32)


def conversation(turns: int = 3, speech_seconds: float = 2.0,
                 silence_seconds: float = 1.0, sample_rate: int = 48_000,
                 f0: float = 200.0, amp: float = 0.3,
                 seed: int = 0) -> np.ndarray:
    """Alternating speech/silence turns: ``turns`` voiced phrases of
    ``speech_seconds``, each followed by ``silence_seconds`` of zeros."""
    parts: List[np.ndarray] = []
    for i in range(turns):
        parts.append(voiced_phrase(f0 + 20 * i, speech_seconds, sample_rate,
                                   amp, seed=seed + i))
        parts.append(np.zeros(int(silence_seconds * sample_rate), np.float32))
    return np.concatenate(parts)


def chunk_stream(audio: np.ndarray, chunk_samples: int = 1536
                 ) -> Iterator[np.ndarray]:
    """Slice a signal into mic-cadence chunks (last partial chunk dropped,
    like a real capture stream)."""
    for i in range(0, len(audio) - chunk_samples + 1, chunk_samples):
        yield audio[i : i + chunk_samples]
