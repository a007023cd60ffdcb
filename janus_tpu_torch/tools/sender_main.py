"""Standalone sender: microphone (or file) → packets on the wire.

The command-line twin of the engine's send path, with no control plane,
for testing across machines. Configured from the environment like
:meth:`JanusConfig.from_env` (``TARGET_IP``, ``TARGET_PORT``,
``USE_TCP``, ...). The encoder and the VAD run on ``--device`` (the card
by default; ``--device cpu`` asks for the CPU).

Usage::

    python -m janus_tpu_torch.tools.sender_main [--file audio.wav] [--demo]
        [--mode semantic|text_only|morse] [--idle-exit SECONDS]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import queue
import threading
import time
from typing import Optional

import numpy as np

from janus_tpu_torch.audio.io import AudioService, StreamAudioService
from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.logging_util import setup_logging
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.models.vad import VoiceActivityDetector
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.runtime.emotion import api_mode_to_protocol
from janus_tpu_torch.runtime.engine import audio_producer
from janus_tpu_torch.runtime.link import LinkSimulator
from janus_tpu_torch.runtime.segmenter import PhraseSegmenter, SegmenterEvent

logger = logging.getLogger(__name__)

__all__ = ["main_loop", "main"]


def main_loop(
    cfg: JanusConfig,
    audio_service: AudioService,
    encoder: Optional[SemanticEncoder] = None,
    vad: Optional[VoiceActivityDetector] = None,
    link: Optional[LinkSimulator] = None,
    stop_event: Optional[threading.Event] = None,
    mode: str = "semantic",
    max_idle_seconds: float = 0.0,
    device="cuda",
) -> int:
    """Blocking send loop; returns the packets sent. An encoder or VAD not
    given is built on ``device``. ``max_idle_seconds`` > 0 exits after that
    long without audio; the loop also ends when the capture ends, after
    flushing what the segmenter holds."""
    encoder = encoder or SemanticEncoder(cfg, device=device)
    vad = vad or VoiceActivityDetector(cfg.vad, sample_rate=cfg.audio.sample_rate,
                                       device=device)
    link = link or LinkSimulator(cfg.link)
    stop_event = stop_event or threading.Event()
    segmenter = PhraseSegmenter(cfg.segmenter)

    audio_queue: "queue.Queue" = queue.Queue(maxsize=cfg.runtime.audio_queue_depth)
    producer = threading.Thread(
        target=audio_producer, args=(audio_service, audio_queue, stop_event),
        daemon=True,
    )
    producer.start()

    sent = 0
    last_audio = time.monotonic()
    non_vad = mode in ("morse", "text_only")
    try:
        while not stop_event.is_set():
            try:
                chunk = audio_queue.get(timeout=0.1)
                last_audio = time.monotonic()
            except queue.Empty:
                stream_ended = not producer.is_alive()  # capture hit EOF
                idled = (max_idle_seconds
                         and time.monotonic() - last_audio > max_idle_seconds)
                if stream_ended or idled:
                    # flush whatever is buffered, then exit
                    r = segmenter.flush()
                    if r.event is SegmenterEvent.PHRASE_READY:
                        sent += _process(encoder, link, cfg, r.phrase, mode)
                    break
                continue

            is_speech = vad.is_speech(chunk) or non_vad
            r = segmenter.push_streaming(chunk, is_speech)
            if r.event is SegmenterEvent.PHRASE_READY:
                sent += _process(encoder, link, cfg, r.phrase, mode)
    finally:
        stop_event.set()
        link.close()
    return sent


def _process(encoder: SemanticEncoder, link: LinkSimulator, cfg: JanusConfig,
             phrase: np.ndarray, mode: str) -> int:
    result = encoder.encode_batch([phrase])[0]
    if not result["text"].strip():
        logger.info("empty transcript for %.2fs phrase — packet dropped",
                    len(phrase) / cfg.audio.sample_rate)
        return 0
    packet = JanusPacket(
        text=result["text"],
        mode=api_mode_to_protocol(mode),
        prosody=result["prosody"],
    )
    payload = packet.serialize()
    logger.info("TX %dB %r %s", len(payload), result["text"], result["prosody"])
    link.transmit(payload)
    return 1


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--file", help="48 kHz WAV file to stream instead of "
                                       "the microphone")
    parser.add_argument("--mode", default="semantic",
                        choices=("semantic", "text_only", "morse"))
    parser.add_argument("--idle-exit", type=float, default=0.0,
                        help="exit after N seconds without audio")
    parser.add_argument("--demo", action="store_true",
                        help="use the committed tone-language demo recognizer")
    parser.add_argument("--device", default="cuda",
                        help="device for the encoder and the VAD "
                             "(default: cuda)")
    args = parser.parse_args()
    setup_logging(log_dir=None)

    cfg = JanusConfig.from_env()
    encoder = None
    if args.demo:
        from janus_tpu_torch.models.zoo import load_demo

        bundle = load_demo(base=cfg)
        cfg = bundle.config
        encoder = SemanticEncoder(cfg, asr_params=bundle.asr_params,
                                  device=args.device)
    if args.file:
        from janus_tpu_torch.audio.wav import read_wav

        audio, sr = read_wav(args.file)
        if sr != cfg.audio.sample_rate:
            raise SystemExit(f"expected {cfg.audio.sample_rate} Hz WAV, got {sr}")
        service: AudioService = StreamAudioService(audio, realtime=True)
    else:
        service = AudioService()
    sent = main_loop(cfg, service, encoder=encoder, mode=args.mode,
                     max_idle_seconds=args.idle_exit, device=args.device)
    logger.info("done: %d packets", sent)


if __name__ == "__main__":
    main()
