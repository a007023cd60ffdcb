"""First-party ctypes bindings to the system libopus (decode + encode).

The reference delegated uploaded-clip decode to FFmpeg via faster-whisper
(reference: backend/services/transcriber.py:66-91); the browser records
``audio/webm;codecs=opus`` (reference: frontend/components/VoiceCloner.tsx:61-63).
This module is the codec half of the first-party replacement: raw Opus
packet decode/encode against ``libopus.so`` with no Python package
dependencies. Container demux lives in :mod:`janus_tpu_torch.audio.ogg` and
:mod:`janus_tpu_torch.audio.webm`; the entry point is
:func:`janus_tpu_torch.audio.decode.read_audio`.

Opus decoders always run at 48 kHz here (Opus's native clock, and the
framework's sample rate), so decoded uploads feed the encoder without
resampling. The encoder exists for test fixtures and any future outbound
Opus path.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import List, Optional

import numpy as np

__all__ = [
    "opus_available",
    "OpusDecoder",
    "OpusEncoder",
    "parse_opus_head",
    "build_opus_head",
]

SAMPLE_RATE = 48_000
# 120 ms at 48 kHz — the longest possible Opus frame (RFC 6716 §2.1.4).
_MAX_FRAME_SAMPLES = 5760

_OPUS_APPLICATION_VOIP = 2048
_OPUS_GET_LOOKAHEAD_REQUEST = 4027
_OPUS_SET_BITRATE_REQUEST = 4002

_lib: Optional[ctypes.CDLL] = None
_lib_checked = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    for name in ("libopus.so.0", "libopus.so", ctypes.util.find_library("opus")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        _bind(lib)
        _lib = lib
        break
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.opus_decoder_create.restype = c.c_void_p
    lib.opus_decoder_create.argtypes = [c.c_int32, c.c_int, c.POINTER(c.c_int)]
    lib.opus_decoder_destroy.restype = None
    lib.opus_decoder_destroy.argtypes = [c.c_void_p]
    lib.opus_decode_float.restype = c.c_int
    lib.opus_decode_float.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int32,
        c.POINTER(c.c_float), c.c_int, c.c_int,
    ]
    lib.opus_encoder_create.restype = c.c_void_p
    lib.opus_encoder_create.argtypes = [
        c.c_int32, c.c_int, c.c_int, c.POINTER(c.c_int),
    ]
    lib.opus_encoder_destroy.restype = None
    lib.opus_encoder_destroy.argtypes = [c.c_void_p]
    lib.opus_encode_float.restype = c.c_int32
    lib.opus_encode_float.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.c_int, c.c_char_p, c.c_int32,
    ]
    # opus_encoder_ctl is varargs: fixed argtypes cover the handle +
    # request so the 64-bit pointer isn't truncated; variadic extras are
    # passed as explicit ctypes values at the call sites.
    lib.opus_encoder_ctl.restype = c.c_int
    lib.opus_encoder_ctl.argtypes = [c.c_void_p, c.c_int]


def opus_available() -> bool:
    """True when a usable libopus is present on this host."""
    return _load() is not None


class OpusDecoder:
    """Stateful packet-stream decoder (one per audio track)."""

    def __init__(self, channels: int = 1, sample_rate: int = SAMPLE_RATE):
        lib = _load()
        if lib is None:
            raise RuntimeError("libopus not available on this host")
        self._lib = lib
        self.channels = int(channels)
        self.sample_rate = int(sample_rate)
        err = ctypes.c_int()
        self._dec = lib.opus_decoder_create(
            self.sample_rate, self.channels, ctypes.byref(err)
        )
        if err.value != 0 or not self._dec:
            raise RuntimeError(f"opus_decoder_create failed: {err.value}")

    def decode(self, packet: bytes) -> np.ndarray:
        """Decode one Opus packet -> float32 [n, channels] PCM."""
        out = np.empty(_MAX_FRAME_SAMPLES * self.channels, dtype=np.float32)
        n = self._lib.opus_decode_float(
            self._dec, packet, len(packet),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _MAX_FRAME_SAMPLES, 0,
        )
        if n < 0:
            raise ValueError(f"opus_decode_float error {n}")
        return out[: n * self.channels].reshape(n, self.channels)

    def decode_stream(self, packets: List[bytes], pre_skip: int = 0) -> np.ndarray:
        """Decode a packet sequence -> mono float32, pre-skip trimmed.

        ``pre_skip`` is the encoder-lookahead sample count declared in the
        container (OpusHead field / Matroska CodecDelay, RFC 7845 §4.2).
        """
        chunks = [self.decode(p) for p in packets]
        if not chunks:
            return np.zeros(0, dtype=np.float32)
        pcm = np.concatenate(chunks, axis=0).mean(axis=1)
        return np.ascontiguousarray(pcm[int(pre_skip):])

    def close(self) -> None:
        if getattr(self, "_dec", None):
            self._lib.opus_decoder_destroy(self._dec)
            self._dec = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class OpusEncoder:
    """VOIP-tuned encoder, used to build test fixtures of browser uploads."""

    FRAME_SAMPLES = 960  # 20 ms at 48 kHz, MediaRecorder's default cadence

    def __init__(self, channels: int = 1, bitrate: int = 32_000):
        lib = _load()
        if lib is None:
            raise RuntimeError("libopus not available on this host")
        self._lib = lib
        self.channels = int(channels)
        err = ctypes.c_int()
        self._enc = lib.opus_encoder_create(
            SAMPLE_RATE, self.channels, _OPUS_APPLICATION_VOIP, ctypes.byref(err)
        )
        if err.value != 0 or not self._enc:
            raise RuntimeError(f"opus_encoder_create failed: {err.value}")
        lib.opus_encoder_ctl(
            self._enc, ctypes.c_int(_OPUS_SET_BITRATE_REQUEST),
            ctypes.c_int32(bitrate),
        )

    @property
    def lookahead(self) -> int:
        """Encoder delay in samples — the container's pre-skip value."""
        out = ctypes.c_int32()
        self._lib.opus_encoder_ctl(
            self._enc, ctypes.c_int(_OPUS_GET_LOOKAHEAD_REQUEST),
            ctypes.byref(out),
        )
        return int(out.value)

    def encode(self, pcm: np.ndarray) -> List[bytes]:
        """Mono float32 -> list of 20 ms Opus packets (zero-padded tail)."""
        pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
        frame = self.FRAME_SAMPLES
        pad = (-len(pcm)) % frame
        if pad:
            pcm = np.concatenate([pcm, np.zeros(pad, dtype=np.float32)])
        buf = ctypes.create_string_buffer(4000)
        packets = []
        for i in range(0, len(pcm), frame):
            chunk = np.ascontiguousarray(pcm[i : i + frame])
            n = self._lib.opus_encode_float(
                self._enc,
                chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frame, buf, len(buf),
            )
            if n < 0:
                raise ValueError(f"opus_encode_float error {n}")
            packets.append(buf.raw[:n])
        return packets

    def close(self) -> None:
        if getattr(self, "_enc", None):
            self._lib.opus_encoder_destroy(self._enc)
            self._enc = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def parse_opus_head(data: bytes) -> dict:
    """Parse an OpusHead identification header (RFC 7845 §5.1)."""
    if len(data) < 19 or data[:8] != b"OpusHead":
        raise ValueError("not an OpusHead packet")
    return {
        "version": data[8],
        "channels": data[9],
        "pre_skip": int.from_bytes(data[10:12], "little"),
        "input_sample_rate": int.from_bytes(data[12:16], "little"),
        "output_gain": int.from_bytes(data[16:18], "little", signed=True),
        "mapping_family": data[18],
    }


def build_opus_head(
    channels: int, pre_skip: int, input_sample_rate: int = SAMPLE_RATE
) -> bytes:
    """Build a mapping-family-0 OpusHead (RFC 7845 §5.1)."""
    return (
        b"OpusHead"
        + bytes([1, channels])
        + int(pre_skip).to_bytes(2, "little")
        + int(input_sample_rate).to_bytes(4, "little")
        + (0).to_bytes(2, "little")  # output gain 0 dB
        + bytes([0])  # mapping family 0: mono/stereo
    )
