"""Typed configuration tree of the PyTorch port.

A copy of the JAX package's frozen dataclass tree (same fields, same
defaults, same presets such as ``ASRConfig.large_v3``), kept here so the
port imports nothing of ``janus_tpu``. Fields that only steer XLA
compilation (``scan_layers``, ``scan_unroll``) are carried for config
parity and ignored by the port, whose layer loops are plain Python.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields, is_dataclass, replace
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "AudioConfig",
    "SegmenterConfig",
    "VADConfig",
    "ProsodyConfig",
    "LinkConfig",
    "ASRConfig",
    "TTSConfig",
    "VocoderConfig",
    "MeshConfig",
    "RuntimeConfig",
    "ServerConfig",
    "JanusConfig",
]


@dataclass(frozen=True)
class AudioConfig:
    """Capture/playback format (reference: backend/services/audio_io.py:28-31)."""

    sample_rate: int = 48_000
    chunk_samples: int = 1536           # 32 ms at 48 kHz
    channels: int = 1
    model_sample_rate: int = 16_000     # rate the ASR frontend consumes

    @property
    def chunk_seconds(self) -> float:
        return self.chunk_samples / self.sample_rate


@dataclass(frozen=True)
class SegmenterConfig:
    """Phrase segmentation state machine
    (reference: backend/services/engine.py:439-504)."""

    pre_roll_chunks: int = 10           # deque of chunks kept before speech onset
    silence_threshold_chunks: int = 15  # ~500 ms of silence ends a phrase
    min_phrase_samples: int = 1536 * 6  # buffers shorter than this are dropped


@dataclass(frozen=True)
class VADConfig:
    """Speech gate (reference: backend/services/vad.py:11-77)."""

    threshold: float = 0.5
    frame_samples: int = 512            # model frame at 16 kHz
    backend: str = "model"              # "model" (conv-GRU) or "energy"
    energy_gate_rms: float = 0.015      # floor used by the energy backend


@dataclass(frozen=True)
class ProsodyConfig:
    """YIN pitch + RMS energy extraction and categorical thresholds
    (reference: backend/services/prosody.py:32-99)."""

    yin_window: int = 4096
    hop: int = 512
    yin_tolerance: float = 0.8
    fmin_hz: float = 40.0
    fmax_hz: float = 1000.0
    # Serving runs pitch tracking on the anti-aliased 16 kHz stream the mel
    # frontend already produces: the bounded search (fmax 1 kHz) needs no
    # bandwidth above 8 kHz, and signal/window/lag-grid all shrink 3x
    # (~27x less work than 48 kHz tracking). The 16 kHz
    # geometry is the 48 kHz window/hop scaled to the same durations
    # (85.0 ms window vs 85.3, 10.63 ms hop vs 10.67). Set yin_rate=0 to
    # track at the native 48 kHz capture rate (exact aubio-geometry path,
    # still available for parity study); docs/PARITY.md documents the
    # deviation. f0 agreement between the two paths is asserted in
    # tests/test_ops_yin.py::test_serving_16k_geometry_matches_48k.
    yin_rate: int = 16_000
    yin_window_16k: int = 1360
    yin_hop_16k: int = 170
    energy_quiet: float = 0.05          # rms <  -> 'Quiet'
    energy_loud: float = 0.15           # rms >= -> 'Loud'
    pitch_deep_hz: float = 120.0        # mean f0 <  -> 'Deep'
    pitch_high_hz: float = 200.0        # mean f0 >= -> 'High'


@dataclass(frozen=True)
class LinkConfig:
    """Constrained-link transport
    (reference: backend/services/link_simulator.py:19-20, engine.py:156-162)."""

    baud_rate: int = 300
    target_ip: str = "127.0.0.1"
    target_port: int = 5005
    receiver_port: int = 5005
    use_tcp: bool = False
    progress_ticks: int = 20

    @property
    def bytes_per_second(self) -> float:
        return self.baud_rate / 8.0


@dataclass(frozen=True)
class ASRConfig:
    """Whisper-class speech recognizer. Defaults are the 'tiny' geometry;
    presets below give base/small/large-v3 sizes
    (reference delegated this to faster-whisper `base.en`:
    backend/services/transcriber.py:23-27)."""

    n_mels: int = 80
    n_fft: int = 400
    hop_length: int = 160
    max_source_positions: int = 1500    # 30 s of mel frames after conv stem
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    num_heads: int = 6
    mlp_ratio: int = 4
    vocab_size: int = 51_864
    max_target_positions: int = 448
    max_decode_tokens: int = 64         # greedy decode budget for a phrase
    dtype: str = "bfloat16"
    # The JAX package compiles one lax.scan block body for deep models when
    # this is set. Carried for configuration parity: the port's layer loops
    # are plain Python either way.
    scan_layers: bool = False
    # The JAX package's unroll factor for its layer scans (1 = pure loop),
    # which changes no result. Carried for configuration parity and
    # ignored by the port.
    scan_unroll: int = 1
    # Serving decode loop: store each layer's cross-attention K/V as int8
    # with per-position scales and attend over them without materialising
    # a dequantized copy (the port's hand-written cross-attention kernel
    # on a CUDA tensor, its plain version on the CPU). Halves the largest
    # per-token stream that is not weights. Default OFF (caches in the
    # compute dtype, exact); the approximation bounds are tested in
    # tests/test_torch_int8.py.
    decode_cross_kv_int8: bool = False

    @classmethod
    def tiny(cls) -> "ASRConfig":
        return cls()

    @classmethod
    def base(cls) -> "ASRConfig":
        return cls(d_model=512, encoder_layers=6, decoder_layers=6, num_heads=8)

    @classmethod
    def small(cls) -> "ASRConfig":
        return cls(d_model=768, encoder_layers=12, decoder_layers=12, num_heads=12)

    @classmethod
    def demo(cls) -> "ASRConfig":
        """Geometry of the committed ``checkpoints/demo_asr.npz`` (the JAX
        package's ``train/demo.py:demo_asr_config``; byte vocabulary)."""
        return cls(
            n_mels=80, d_model=128, encoder_layers=2, decoder_layers=2,
            num_heads=4, vocab_size=261, max_source_positions=128,
            max_target_positions=48, max_decode_tokens=32, dtype="float32",
        )

    @classmethod
    def large_v3(cls) -> "ASRConfig":
        return cls(
            n_mels=128,
            d_model=1280,
            encoder_layers=32,
            decoder_layers=32,
            num_heads=20,
            vocab_size=51_866,
            scan_layers=True,
        )


@dataclass(frozen=True)
class TTSConfig:
    """LLM-conditioned acoustic transformer: autoregressive mel-frame decoder
    prompted with text + emotion tag (replaces the reference's cloud TTS;
    reference: backend/services/synthesizer.py:158-207)."""

    d_model: int = 512
    layers: int = 8
    num_heads: int = 8
    mlp_ratio: int = 4
    n_mels: int = 80
    reduction: int = 2                  # mel frames emitted per decode step
    max_text_tokens: int = 256
    max_mel_frames: int = 1024
    dtype: str = "bfloat16"
    scan_layers: bool = False           # parity field (see ASRConfig)
    scan_unroll: int = 1                # parity field (see ASRConfig)
    # Synthesis duration guard: hard cap on emitted audio per prompt token
    # (plus a 0.35 s floor) — bounds the damage of an AR stop-head miss
    # (runaway looping). Generous vs normal speech (~0.06-0.09 s/char).
    max_seconds_per_text_token: float = 0.15

    @classmethod
    def flagship(cls) -> "TTSConfig":
        """Fish-Audio-class acoustic model (~0.6B parameters), the serving
        geometry the flagship synthesis measurements use. ``scan_layers``
        is set as in the JAX package (one compiled block body there;
        carried for parity here). ``reduction=4``: an AR step at this
        scale costs about the same whatever the number of frames it
        emits, so four mel frames per step halve the step count of r=2;
        r=2..5 is the usual reduction range of acoustic models."""
        return cls(d_model=1280, layers=30, num_heads=20, scan_layers=True,
                   reduction=4)


@dataclass(frozen=True)
class VocoderConfig:
    """iSTFT-head vocoder (Vocos-style): conv backbone predicts magnitude and
    phase, waveform is reconstructed with an inverse STFT — no giant
    transposed convs."""

    n_fft: int = 1024
    hop_length: int = 256
    d_model: int = 512
    layers: int = 8
    sample_rate: int = 24_000
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh axes. data = concurrent sessions (DP), model = TP over
    heads/MLP, seq = sequence/context parallelism over mel frames."""

    data: int = 1
    model: int = 1
    seq: int = 1
    axis_names: Tuple[str, str, str] = ("data", "model", "seq")


@dataclass(frozen=True)
class RuntimeConfig:
    """Host runtime: batched sessions + queue depths
    (reference queue depths: backend/services/engine.py:428, 187)."""

    max_sessions: int = 32
    audio_queue_depth: int = 100
    playback_queue_depth: int = 100
    ducking_level: float = 0.25
    executor_workers: int = 2
    # Runtime overlap (SURVEY §2.4): encode programs are dispatched
    # asynchronously and harvested on later ticks, so the tick loop keeps
    # running VAD/segmentation for batch N+1 while batch N's encode is in
    # flight on the device. 0 = synchronous (harvest same tick).
    max_inflight_encodes: int = 2
    # Double-buffered VAD dispatch: tick N dispatches the newest chunks'
    # VAD program and consumes tick N-1's result, so the per-tick
    # device->host sync overlaps the next dispatch (and, on hardware, the
    # VAD compute itself). Costs one chunk (32 ms) of end-of-phrase
    # detection latency — negligible vs the 500 ms silence threshold.
    pipelined_vad: bool = True
    # Receiver plays synthesized audio chunk-by-chunk as the TTS generates
    # (streaming turnaround) instead of waiting for the full clip.
    streaming_playback: bool = True
    # Ship encode batches to the device as int16 PCM (half the bytes of
    # float32) and convert on-device. Capture is int16-native (the
    # reference's AudioService converts int16 -> float32/32768,
    # reference backend/services/audio_io.py:125-128), so the round trip
    # is EXACT for capture-native audio; synthetic float inputs see one
    # +-1.5e-5 quantization, far below the corpus noise floor. The
    # 10 s x batch-8 bucket is 15.4 MB per call as float32.
    encode_transfer_int16: bool = True
    # Opt-in 8-bit G.711-style mu-law wire format (overrides int16):
    # halves transfer again at ~35-38 dB quantization SNR — far above the
    # hard corpus's gated noise floors (WER holds at snr0=0dB additive
    # noise), but no longer bit-exact for capture audio, so OFF by
    # default. Worth flipping only where the host<->device link bounds
    # the encode.
    encode_transfer_ulaw: bool = False


@dataclass(frozen=True)
class ServerConfig:
    """Control-plane server (reference: backend/server.py, docs/API.md)."""

    host: str = "127.0.0.1"
    port: int = 8000
    ws_path: str = "/ws/janus"
    verify_phrase: str = "The quick brown fox jumps over the lazy dog."
    verify_threshold: float = 0.8
    reference_audio_path: str = "reference_audio.wav"


@dataclass(frozen=True)
class JanusConfig:
    """The whole deployment as one value."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    segmenter: SegmenterConfig = field(default_factory=SegmenterConfig)
    vad: VADConfig = field(default_factory=VADConfig)
    prosody: ProsodyConfig = field(default_factory=ProsodyConfig)
    link: LinkConfig = field(default_factory=LinkConfig)
    asr: ASRConfig = field(default_factory=ASRConfig)
    tts: TTSConfig = field(default_factory=TTSConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    server: ServerConfig = field(default_factory=ServerConfig)

    # -- overrides ---------------------------------------------------------

    def override(self, **dotted: Any) -> "JanusConfig":
        """Return a copy with dotted-path overrides, e.g.
        ``cfg.override(**{"link.baud_rate": 1200, "asr.d_model": 512})``."""
        cfg = self
        for path, value in dotted.items():
            cfg = _set_path(cfg, path.split("."), value)
        return cfg

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "JanusConfig":
        """Build a config honoring the reference's environment variables
        (reference: backend/services/engine.py:415-417,
        backend/scripts/receiver_main.py:102-110)."""
        e = os.environ if env is None else env
        cfg = cls()
        target_ip = e.get("TARGET_IP", cfg.link.target_ip)
        use_tcp = e.get("USE_TCP", "").lower() in ("1", "true", "yes") or (
            "ngrok" in target_ip  # reference auto-enables TCP through ngrok
        )
        return cfg.override(**{
            "link.target_ip": target_ip,
            "link.target_port": int(e.get("TARGET_PORT", cfg.link.target_port)),
            "link.receiver_port": int(e.get("RECEIVER_PORT", cfg.link.receiver_port)),
            "link.use_tcp": use_tcp,
            "server.reference_audio_path": e.get(
                "REFERENCE_AUDIO_PATH", cfg.server.reference_audio_path
            ),
        })

    @classmethod
    def from_cli(cls, argv: Optional[list] = None,
                 base: Optional["JanusConfig"] = None) -> "JanusConfig":
        """Apply ``--set path=value`` overrides from the command line, e.g.
        ``--set link.baud_rate=1200 --set asr.d_model=512``. Values parse as
        JSON first (ints/floats/bools), falling back to strings."""
        import argparse
        import json

        parser = argparse.ArgumentParser(add_help=False)
        parser.add_argument("--set", action="append", default=[], dest="sets")
        ns, _unknown = parser.parse_known_args(argv)
        cfg = base if base is not None else cls.from_env()
        overrides: Dict[str, Any] = {}
        for item in ns.sets:
            if "=" not in item:
                raise ValueError(f"--set expects path=value, got {item!r}")
            path, raw = item.split("=", 1)
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            overrides[path] = value
        return cfg.override(**overrides)

    def to_flat_dict(self) -> Dict[str, Any]:
        """Flatten to dotted keys — for logging/hashing a deployment."""
        out: Dict[str, Any] = {}

        def rec(prefix: str, obj: Any) -> None:
            for f in fields(obj):
                v = getattr(obj, f.name)
                key = f"{prefix}{f.name}"
                if is_dataclass(v):
                    rec(key + ".", v)
                else:
                    out[key] = v

        rec("", self)
        return out


def _set_path(obj: Any, path: list, value: Any) -> Any:
    if len(path) == 1:
        if not any(f.name == path[0] for f in fields(obj)):
            raise KeyError(f"unknown config field: {path[0]}")
        return replace(obj, **{path[0]: value})
    child = getattr(obj, path[0])
    return replace(obj, **{path[0]: _set_path(child, path[1:], value)})
