"""Capture and playback service.

48 kHz mono int16 in 1536-sample (32 ms) chunks; ``read_chunk`` returns
float32 normalized by 32768; ``write_chunk`` takes bytes or float32/int16
arrays. Sound hardware is optional: without PyAudio (or without a device)
the service runs in mock mode, where reads pace real time and return
silence and writes are dropped. This is capture hardware, not the compute
device: it has nothing to do with the card.

:class:`StreamAudioService` replays a float32 signal at capture cadence
(tests, benchmarks, file-driven sessions) and keeps what is played for
inspection.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Union

import numpy as np

__all__ = ["AudioService", "StreamAudioService"]


class AudioService:
    """Microphone/speaker service with a mock mode."""

    SAMPLE_RATE = 48_000
    CHUNK_SAMPLES = 1536
    CHANNELS = 1

    def __init__(self, use_hardware: bool = True) -> None:
        self._pa = None
        self._in_stream = None
        self._out_stream = None
        self.mock_mode = True
        if use_hardware:
            try:  # PyAudio is optional
                import pyaudio  # type: ignore

                self._pa = pyaudio.PyAudio()
                self._in_stream = self._pa.open(
                    format=pyaudio.paInt16, channels=1, rate=self.SAMPLE_RATE,
                    input=True, frames_per_buffer=self.CHUNK_SAMPLES,
                )
                self._out_stream = self._pa.open(
                    format=pyaudio.paInt16, channels=1, rate=self.SAMPLE_RATE,
                    output=True, frames_per_buffer=self.CHUNK_SAMPLES,
                )
                self.mock_mode = False
            except Exception:
                self.mock_mode = True

    @property
    def chunk_seconds(self) -> float:
        return self.CHUNK_SAMPLES / self.SAMPLE_RATE

    def read_chunk(self) -> np.ndarray:
        """float32 chunk in [-1, 1]; mock mode paces real time and returns
        silence."""
        if self.mock_mode:
            time.sleep(self.chunk_seconds)
            return np.zeros(self.CHUNK_SAMPLES, dtype=np.float32)
        data = self._in_stream.read(self.CHUNK_SAMPLES, exception_on_overflow=False)
        return np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0

    def write_chunk(self, audio: Union[bytes, np.ndarray]) -> None:
        """bytes are written raw; float arrays are scaled to int16."""
        data = self._coerce(audio)
        if self.mock_mode:
            return
        self._out_stream.write(data)

    @staticmethod
    def _coerce(audio: Union[bytes, np.ndarray]) -> bytes:
        if isinstance(audio, bytes):
            return audio
        arr = np.asarray(audio)
        if arr.dtype == np.int16:
            return arr.tobytes()
        return (np.clip(arr.astype(np.float32), -1.0, 1.0) * 32767).astype(np.int16).tobytes()

    def close(self) -> None:
        for s in (self._in_stream, self._out_stream):
            try:
                if s is not None:
                    s.stop_stream()
                    s.close()
            except Exception:
                pass
        if self._pa is not None:
            try:
                self._pa.terminate()
            except Exception:
                pass


class StreamAudioService(AudioService):
    """Array-driven capture and captured playback."""

    def __init__(self, input_audio: Optional[np.ndarray] = None,
                 realtime: bool = False, end_of_stream: bool = True) -> None:
        """``realtime=True`` paces reads at one chunk period each.
        ``end_of_stream=True`` makes ``read_chunk`` return None once the
        input is consumed (capture producers treat that as the end of the
        stream); False pads silence forever, like a live microphone."""
        self.mock_mode = True
        self._pa = None
        self._in_stream = None
        self._out_stream = None
        self._input = (
            np.asarray(input_audio, dtype=np.float32)
            if input_audio is not None else np.zeros(0, np.float32)
        )
        self._pos = 0
        self._realtime = realtime
        self._end_of_stream = end_of_stream
        self._lock = threading.Lock()
        self.written_chunks: List[bytes] = []

    def set_input(self, audio: np.ndarray) -> None:
        with self._lock:
            self._input = np.asarray(audio, dtype=np.float32)
            self._pos = 0

    @property
    def exhausted(self) -> bool:
        return self._pos >= len(self._input)

    def read_chunk(self) -> Optional[np.ndarray]:
        if self._realtime:
            time.sleep(self.chunk_seconds)
        with self._lock:
            if self._end_of_stream and self._pos >= len(self._input):
                return None
            start, end = self._pos, self._pos + self.CHUNK_SAMPLES
            chunk = self._input[start:end]
            self._pos = end
        if len(chunk) < self.CHUNK_SAMPLES:
            chunk = np.pad(chunk, (0, self.CHUNK_SAMPLES - len(chunk)))
        return chunk.astype(np.float32)

    def write_chunk(self, audio: Union[bytes, np.ndarray]) -> None:
        self.written_chunks.append(self._coerce(audio))

    @property
    def written_audio(self) -> np.ndarray:
        if not self.written_chunks:
            return np.zeros(0, np.float32)
        return np.frombuffer(b"".join(self.written_chunks), dtype=np.int16).astype(
            np.float32
        ) / 32768.0
