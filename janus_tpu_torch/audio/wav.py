"""Minimal dependency-free WAV I/O (stdlib ``wave`` + numpy).

Covers the framework's needs: mono/stereo PCM16 read (stereo is averaged
to mono), float32 normalized output, PCM16 write. The reference leaned on
FFmpeg-through-faster-whisper for decoding uploads (reference:
backend/services/transcriber.py:66-91); WAV is the supported interchange
format here.
"""

from __future__ import annotations

import io
import wave
from typing import Tuple, Union

import numpy as np

__all__ = ["read_wav", "write_wav", "pcm16_to_float", "float_to_pcm16"]


def pcm16_to_float(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0


def float_to_pcm16(audio: np.ndarray) -> bytes:
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16).tobytes()


def read_wav(path_or_bytes: Union[str, bytes]) -> Tuple[np.ndarray, int]:
    """Returns (float32 mono audio in [-1, 1], sample_rate)."""
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    with wave.open(src, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        frames = w.readframes(w.getnframes())
    if width == 2:
        audio = np.frombuffer(frames, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        audio = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        audio = np.frombuffer(frames, dtype=np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width: {width}")
    if n_ch > 1:
        audio = audio.reshape(-1, n_ch).mean(axis=1)
    return audio, sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 [-1,1] (or int16) mono audio as PCM16 WAV."""
    if audio.dtype != np.int16:
        audio = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(audio.tobytes())
