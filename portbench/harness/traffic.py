"""Request generators, driven by a traffic file's parameters and the
run's seed. Every seed gets the same sizes (a fixed grid of lengths, the
whole grid in each batch or cycle) in another order, with its own
content, so that seeds change what is said and not how much work it is.

``voiced_phrase`` and ``WORDS`` are copied from the program's
``audio/synthetic.py`` (the JAX package's speech-like test signal and
closed vocabulary), so that the yardstick does not move with it.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

__all__ = ["WORDS", "voiced_phrase", "grid", "phrase_pool", "phrase_batches",
           "text_of", "packets", "PROSODY"]

WORDS = (
    "alpha", "bravo", "charlie", "delta", "echo", "fox", "golf", "hotel",
    "india", "juliet", "kilo", "lima", "mike", "nov", "oscar", "papa",
)

PROSODY = [(p, e) for p in ("Deep", "Normal", "High")
           for e in ("Quiet", "Normal", "Loud")]


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


def grid(lo: float, hi: float, n: int) -> np.ndarray:
    return np.linspace(lo, hi, n)


def phrase_pool(t: dict, seed: int) -> List[List[np.ndarray]]:
    """``pool[i][v]``: variant v of the phrase of the i-th grid length
    (``t["seconds"]`` over ``t["batch"]`` points, ``t["variants"]``
    variants), f0 and amplitude drawn uniformly from ``t["f0_hz"]`` and
    ``t["amp"]``."""
    rng = np.random.default_rng([seed, 1])
    lengths = grid(*t["seconds"], t["batch"])
    return [[voiced_phrase(float(rng.uniform(*t["f0_hz"])), float(s),
                           amp=float(rng.uniform(*t["amp"])),
                           seed=int(rng.integers(2 ** 31)))
             for _ in range(t["variants"])] for s in lengths]


def phrase_batches(t: dict, seed: int, pool) -> Iterator[List[np.ndarray]]:
    """Endless batches: every grid length once a batch, a variant of each
    drawn from the seed, in an order drawn from the seed."""
    rng = np.random.default_rng([seed, 2])
    n = len(pool)
    while True:
        order = rng.permutation(n)
        yield [pool[i][int(rng.integers(len(pool[i])))] for i in order]


def text_of(n_bytes: int, rng: np.random.Generator) -> str:
    """Words of the closed vocabulary, cut or padded with one more word
    to exactly ``n_bytes`` bytes."""
    words: List[str] = []
    while len(" ".join(words)) < n_bytes:
        words.append(WORDS[int(rng.integers(len(WORDS)))])
    return " ".join(words)[:n_bytes].rstrip().ljust(n_bytes, "a")


def packets(t: dict, seed: int) -> Iterator[dict]:
    """Endless packets: text lengths in cycles over the whole grid
    ``t["text_bytes"]`` (every length once a cycle, the order drawn from
    the seed), words and prosody drawn from the seed."""
    rng = np.random.default_rng([seed, 3])
    lo, hi = t["text_bytes"]
    lengths = np.arange(lo, hi + 1)
    while True:
        for n in rng.permutation(lengths):
            pitch, energy = PROSODY[int(rng.integers(len(PROSODY)))]
            yield {"text": text_of(int(n), rng), "pitch": pitch,
                   "energy": energy}
