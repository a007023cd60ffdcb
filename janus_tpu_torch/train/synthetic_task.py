"""Synthetic speech corpus: a deterministic, learnable audio "language".

With no pretrained checkpoints to fetch, this corpus is what the demo
models learn: each character is a fixed harmonic stack on a
character-specific F0, words are concatenated character tones, and
utterances are word sequences with gaps. The ASR learns
frequency→character transcription, the TTS text→mel generation and the
vocoder mel→waveform inversion, so the whole codec round-trips real text
end to end (the basis of the WER/SNR gates in :mod:`..eval.roundtrip`).

The port's copy of the JAX package's ``train/synthetic_task.py``. The
renderer itself lives in :mod:`janus_tpu_torch.audio.synthetic` (one copy
of ``render_text``); this module adds the hard-corpus vocabulary, the
batch sampler and the TTS mel targets. The same numpy seed gives the same
arrays as the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from janus_tpu_torch.audio.synthetic import (EMOTION_RENDERING,
                                             SPEAKER_TIMBRES, WORDS,
                                             char_frequency, render_text,
                                             speaker_timbre)
from janus_tpu_torch.ops.mel import log_mel_spectrogram

__all__ = [
    "WORDS",
    "HARD_WORDS",
    "SPEAKER_TIMBRES",
    "EMOTION_RENDERING",
    "make_word_list",
    "char_frequency",
    "speaker_timbre",
    "render_text",
    "sample_text",
    "sample_batch",
    "mel_targets_for",
    "add_noise_snr",
]


def make_word_list(n_words: int = 256, seed: int = 1234,
                   min_syllables: int = 2, max_syllables: int = 4) -> tuple:
    """Deterministic pronounceable vocabulary of ``n_words`` unique
    CV-syllable words (e.g. 'bakilo', 'zumepa'): the hard corpus's word
    inventory. At 256+ words the ASR can no longer pattern-match a handful
    of templates; it must track the per-character frequency ladder through
    speaker, rate and noise variation."""
    cons = "bdfgjklmnprstvz"
    vowels = "aeiou"
    rng = np.random.default_rng(seed)
    words: List[str] = []
    seen = set()
    while len(words) < n_words:
        n_syl = int(rng.integers(min_syllables, max_syllables + 1))
        w = "".join(
            cons[int(rng.integers(0, len(cons)))]
            + vowels[int(rng.integers(0, len(vowels)))]
            for _ in range(n_syl)
        )
        if w not in seen:
            seen.add(w)
            words.append(w)
    return tuple(words)


HARD_WORDS = make_word_list(256)


def add_noise_snr(audio: np.ndarray, snr_db: float, seed: int = 0) -> np.ndarray:
    """Additive white noise at a target SNR (dB) relative to signal power."""
    rng = np.random.default_rng(seed)
    p_sig = float(np.mean(audio.astype(np.float64) ** 2)) + 1e-12
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    return (audio + np.sqrt(p_noise) *
            rng.standard_normal(len(audio))).astype(np.float32)


def sample_text(rng: np.random.Generator, min_words: int = 1,
                max_words: int = 3,
                vocab: Tuple[str, ...] = WORDS) -> str:
    n = int(rng.integers(min_words, max_words + 1))
    return " ".join(vocab[int(i)] for i in rng.integers(0, len(vocab), n))


def sample_batch(
    rng: np.random.Generator,
    batch: int,
    tokenizer,
    sample_rate: int = 16_000,
    max_seconds: float = 2.0,
    max_tokens: int = 32,
    augment: bool = False,
    vocab: Tuple[str, ...] = WORDS,
    min_words: int = 1,
    max_words: int = 3,
    n_speakers: int = 1,
    rate_range: Tuple[float, float] = (1.0, 1.0),
    snr_db_range: Optional[Tuple[float, float]] = None,
    clean_prob: float = 0.0,
    emotions: Tuple[str, ...] = ("neutral",),
    hop_quantize: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Batch for ASR training: (audio[B, T], tokens[B, L], mask[B, L], texts).

    tokens = [sot] text-bytes [eot], padded with eot; mask marks sot..eot
    inclusive (loss behind each real prediction target). ``augment=True``
    adds random leading silence (the VAD pre-roll a serving phrase carries)
    and ±30% gain so the model matches the live segmenter's output.

    The hard-corpus knobs (``vocab=HARD_WORDS``, ``n_speakers``,
    ``rate_range``, ``snr_db_range``, ``emotions``) sample per-utterance
    speaker timbres, speaking rates, additive-noise SNRs and emotion
    renderings."""
    t_max = int(max_seconds * sample_rate)
    audio = np.zeros((batch, t_max), dtype=np.float32)
    tokens = np.full((batch, max_tokens), tokenizer.eot, dtype=np.int32)
    mask = np.zeros((batch, max_tokens), dtype=np.float32)
    texts: List[str] = []
    for i in range(batch):
        text = sample_text(rng, min_words, max_words, vocab=vocab)
        texts.append(text)
        rate = float(rng.uniform(*rate_range))
        spk = int(rng.integers(0, n_speakers))
        emo = emotions[int(rng.integers(0, len(emotions)))]
        wav = render_text(text, sample_rate, seed=int(rng.integers(1 << 30)),
                          speaker=spk, emotion=emo, rate=rate,
                          hop_quantize=hop_quantize)
        if snr_db_range is not None:
            # One draw from the main stream whatever the clean/noisy
            # outcome; the decision, the SNR and the noise seed come from a
            # child generator, so the render-seed stream is the same for
            # every (clean_prob, outcome) and seeded noisy-row WERs stay
            # comparable across recipes.
            nrng = np.random.default_rng(int(rng.integers(1 << 30)))
            if nrng.random() >= clean_prob:
                # clean_prob: the share of utterances rendered with no
                # added noise, so the noise-free eval row stays in the
                # training distribution
                snr = float(nrng.uniform(*snr_db_range))
                wav = add_noise_snr(wav, snr, seed=int(nrng.integers(1 << 30)))
        offset = 0
        if augment:
            offset = int(rng.integers(0, int(0.5 * sample_rate)))
            wav = wav * float(rng.uniform(0.7, 1.3))
        end = min(offset + len(wav), t_max)
        audio[i, offset:end] = wav[: end - offset]
        ids = [tokenizer.sot] + tokenizer.encode(text)[: max_tokens - 2] + [tokenizer.eot]
        tokens[i, : len(ids)] = ids
        mask[i, : len(ids)] = 1.0
    return audio, tokens, mask, texts


def mel_targets_for(texts: List[str], n_mels: int, reduction: int,
                    max_groups: int, sample_rate: int = 16_000,
                    n_fft: int = 400, hop: int = 160,
                    speakers: Optional[List[int]] = None,
                    emotions: Optional[List[str]] = None,
                    tail_silence_frames: int = 4,
                    device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """TTS training targets: (mel_groups[B, S, r*n_mels], mask[B, S]).

    Every render is zero-padded to one length and featurized in batches of
    64 on ``device`` with the plain log-mel (as the JAX package does);
    masks use each render's own frame count, so the padding never reaches
    the loss.

    ``tail_silence_frames`` extends each target by that many real silence
    frames before the stop flag (default 4 = vocoder n_fft/hop): the iSTFT
    head rebuilds a frame's samples from windows reaching ``n_fft/hop``
    frames ahead, so a sequence that ends at full amplitude forces the
    end-flush to extrapolate. A TTS that generates its own silence tail
    gives the vocoder true end context."""
    b = len(texts)
    if speakers is None:
        speakers = [0] * b
    if emotions is None:
        emotions = ["neutral"] * b
    tail = tail_silence_frames * hop
    wavs = [
        np.pad(
            render_text(t, sample_rate, seed=0, speaker=speakers[i],
                        emotion=emotions[i],
                        hop_quantize=hop),  # deterministic, phase on grid
            (0, tail),
        )
        for i, t in enumerate(texts)
    ]
    # one length: enough for max_groups everywhere (frames = len // hop)
    t_max = max(max(len(w) for w in wavs),
                (max_groups * reduction + 1) * hop)
    t_max = -(-t_max // hop) * hop
    out = np.zeros((b, max_groups, reduction * n_mels), dtype=np.float32)
    mask = np.zeros((b, max_groups), dtype=np.float32)
    for lo in range(0, b, 64):
        chunk = wavs[lo : lo + 64]
        padded = np.zeros((len(chunk), t_max), dtype=np.float32)
        for j, w in enumerate(chunk):
            padded[j, : len(w)] = w
        with torch.no_grad():
            mels = log_mel_spectrogram(
                torch.from_numpy(padded).to(device), sample_rate, n_fft, hop,
                n_mels).cpu().numpy()  # [c, T//hop, mels]
        for j, w in enumerate(chunk):
            n_frames = ((len(w) // hop) // reduction) * reduction
            groups = mels[j, :n_frames].reshape(-1, reduction * n_mels)
            s = min(len(groups), max_groups)
            out[lo + j, :s] = groups[:s]
            mask[lo + j, :s] = 1.0
    return out, mask
