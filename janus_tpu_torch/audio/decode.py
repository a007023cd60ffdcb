"""Container-sniffing audio decode for uploads: WAV, WebM/Opus, Ogg/Opus.

First-party replacement for the reference's FFmpeg-through-faster-whisper
upload decode (reference: backend/services/transcriber.py:66-91). The
browser's voice-clone recording arrives as ``audio/webm;codecs=opus``
(reference: frontend/components/VoiceCloner.tsx:61-63); Firefox emits
Ogg/Opus; tests and tools use WAV. All three decode here with no
external processes: WAV via the stdlib, Opus via ctypes to the system
libopus (:mod:`janus_tpu_torch.audio.opus`). Without libopus a WebM or
Ogg upload raises ``RuntimeError`` (the synthesizer treats any unreadable
reference file as "no clone voice").

Returns float32 mono in [-1, 1] plus the native sample rate (Opus always
decodes at 48 kHz — the framework's rate, so no resample is needed on
the upload path).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from janus_tpu_torch.audio.ogg import demux_ogg_opus, is_ogg
from janus_tpu_torch.audio.opus import SAMPLE_RATE, OpusDecoder, opus_available
from janus_tpu_torch.audio.wav import read_wav
from janus_tpu_torch.audio.webm import demux_webm_opus, is_webm

__all__ = ["read_audio", "sniff_format"]


def sniff_format(data: bytes) -> str:
    """'wav' | 'webm' | 'ogg' | 'unknown' from magic bytes."""
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if is_webm(data):
        return "webm"
    if is_ogg(data):
        return "ogg"
    return "unknown"


def read_audio(path_or_bytes: Union[str, bytes]) -> Tuple[np.ndarray, int]:
    """Decode an upload -> (float32 mono audio in [-1, 1], sample_rate)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    fmt = sniff_format(data)
    if fmt == "wav":
        return read_wav(data)
    if fmt in ("webm", "ogg"):
        if not opus_available():
            raise RuntimeError(
                f"{fmt} upload needs libopus, which is missing on this host"
            )
        if fmt == "webm":
            info, packets = demux_webm_opus(data)
            channels, pre_skip = info["channels"], info["pre_skip"]
        else:
            head, packets = demux_ogg_opus(data)
            channels, pre_skip = head["channels"], head["pre_skip"]
        dec = OpusDecoder(channels=channels)
        try:
            pcm = dec.decode_stream(packets, pre_skip=pre_skip)
        finally:
            dec.close()
        return pcm, SAMPLE_RATE
    raise ValueError(
        "unsupported audio container (expected WAV, WebM/Opus or Ogg/Opus)")
