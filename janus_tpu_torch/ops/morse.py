"""Morse code audio synthesis.

Byte-exact re-implementation of the reference's local sine-tone morse
generator (reference: backend/services/synthesizer.py:56-65, 257-326):
800 Hz tone, dot 0.1 s / dash 0.3 s, 0.1 s intra-symbol gap, 0.3 s
inter-letter gap, 0.7 s word gap, amplitude 0.5·32767, int16 PCM at
48 kHz. Timing/waveform math matches ``np.linspace(0, d, n, False)``
sample placement so output bytes are identical.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["MORSE_TABLE", "text_to_morse", "morse_audio"]

SAMPLE_RATE = 48_000
FREQUENCY = 800.0
AMPLITUDE = 0.5

MORSE_TABLE = {
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".", "F": "..-.",
    "G": "--.", "H": "....", "I": "..", "J": ".---", "K": "-.-", "L": ".-..",
    "M": "--", "N": "-.", "O": "---", "P": ".--.", "Q": "--.-", "R": ".-.",
    "S": "...", "T": "-", "U": "..-", "V": "...-", "W": ".--", "X": "-..-",
    "Y": "-.--", "Z": "--..",
    "0": "-----", "1": ".----", "2": "..---", "3": "...--", "4": "....-",
    "5": ".....", "6": "-....", "7": "--...", "8": "---..", "9": "----.",
    " ": " ",
}


def text_to_morse(text: str) -> str:
    """Human-readable dot/dash string (letters space-separated, words '/')."""
    words = []
    for word in text.upper().split(" "):
        words.append(" ".join(MORSE_TABLE[c] for c in word if c in MORSE_TABLE))
    return " / ".join(w for w in words)


@functools.lru_cache(maxsize=8)
def _tone(duration: float) -> np.ndarray:
    n = int(duration * SAMPLE_RATE)
    t = np.linspace(0, duration, n, False)
    wave = np.sin(2 * np.pi * FREQUENCY * t)
    return (wave * 32767 * AMPLITUDE).astype(np.int16)


def _silence(duration: float) -> np.ndarray:
    return np.zeros(int(duration * SAMPLE_RATE), dtype=np.int16)


def morse_audio(text: str) -> bytes:
    """int16 PCM bytes; empty text or no encodable characters → b''."""
    segments = []
    text_upper = text.upper()
    for char in text_upper:
        if char not in MORSE_TABLE:
            continue
        pattern = MORSE_TABLE[char]
        if pattern == " ":
            segments.append(_silence(0.7))
            continue
        for i, symbol in enumerate(pattern):
            if symbol == ".":
                segments.append(_tone(0.1))
            elif symbol == "-":
                segments.append(_tone(0.3))
            else:
                continue
            if i < len(pattern) - 1:
                segments.append(_silence(0.1))
        # Reference quirk kept for bit-parity: the inter-letter gap is
        # skipped whenever the character VALUE equals the final character
        # (not just at the final position), e.g. "SOS" gets no gap after
        # its first S (reference: backend/services/synthesizer.py:319-321).
        if char != text_upper[-1]:
            segments.append(_silence(0.3))
    if not segments:
        return b""
    return np.concatenate(segments).tobytes()
