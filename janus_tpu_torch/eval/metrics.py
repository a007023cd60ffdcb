"""Quality metrics the reference never measured (BASELINE.md: WER, SNR and
prosody correlation are all "not published"): edit-distance WER/CER for
the transcription path, segmental SNR for reconstruction, and categorical
prosody agreement for the emotion channel.

A copy of the JAX package's ``eval/metrics.py`` (numpy only), so the port
scores its transcripts without that package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["word_error_rate", "character_error_rate", "snr_db", "prosody_agreement"]


def _edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance, O(len(ref)*len(hyp)) with two rows."""
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(
                prev[j] + 1,          # deletion
                cur[j - 1] + 1,       # insertion
                prev[j - 1] + (r != h),  # substitution
            )
        prev = cur
    return prev[-1]


def word_error_rate(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    """Corpus WER: total edit distance over total reference words."""
    errors = 0
    words = 0
    for ref, hyp in zip(references, hypotheses):
        r, h = ref.split(), hyp.split()
        errors += _edit_distance(r, h)
        words += len(r)
    return errors / max(words, 1)


def character_error_rate(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    errors = 0
    chars = 0
    for ref, hyp in zip(references, hypotheses):
        errors += _edit_distance(list(ref), list(hyp))
        chars += len(ref)
    return errors / max(chars, 1)


def snr_db(reference: np.ndarray, estimate: np.ndarray) -> float:
    """Signal-to-noise ratio in dB over the overlapping prefix."""
    n = min(len(reference), len(estimate))
    ref = np.asarray(reference[:n], dtype=np.float64)
    est = np.asarray(estimate[:n], dtype=np.float64)
    noise = ref - est
    p_sig = np.sum(ref**2)
    p_noise = np.sum(noise**2)
    if p_noise == 0:
        return float("inf")
    return float(10.0 * np.log10(max(p_sig, 1e-20) / p_noise))


def prosody_agreement(
    references: Sequence[Tuple[str, str]], hypotheses: Sequence[Tuple[str, str]]
) -> float:
    """Fraction of (energy, pitch) categorical pairs that match exactly —
    the wire carries only these categories, so agreement measures the
    emotion channel end to end."""
    if not references:
        return 1.0
    hits = sum(1 for r, h in zip(references, hypotheses) if tuple(r) == tuple(h))
    return hits / len(references)
