"""Container-sniffing audio decode for uploads.

WAV decodes through the stdlib (:mod:`janus_tpu_torch.audio.wav`). The
browser's voice-clone recording arrives as WebM/Opus and Firefox's as
Ogg/Opus: both containers are recognised, but their demuxers and the
libopus binding are not part of this package yet, so reading one raises
``NotImplementedError`` (the synthesizer treats any unreadable reference
file as "no clone voice").

Returns float32 mono in [-1, 1] plus the file's sample rate.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from janus_tpu_torch.audio.wav import read_wav

__all__ = ["read_audio", "sniff_format"]

_EBML_MAGIC = b"\x1a\x45\xdf\xa3"
_OGG_MAGIC = b"OggS"


def sniff_format(data: bytes) -> str:
    """'wav' | 'webm' | 'ogg' | 'unknown' from magic bytes."""
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if data[:4] == _EBML_MAGIC:
        return "webm"
    if data[:4] == _OGG_MAGIC:
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
        raise NotImplementedError(
            f"{fmt}/Opus uploads are not decoded by this package yet; "
            "convert the recording to WAV")
    raise ValueError(
        "unsupported audio container (expected WAV, WebM/Opus or Ogg/Opus)")
