"""Standalone receiver: packets on the wire → speaker.

The command-line twin of the engine's receive path: UDP (0.5 s poll) or
framed TCP, emotion inference, synthesis of the whole packet, threaded
playback. Configured from the environment (``RECEIVER_PORT``,
``USE_TCP``, ...); the synthesizer runs on ``--device`` (the card by
default; ``--device cpu`` asks for the CPU).

Usage::

    RECEIVER_PORT=5005 python -m janus_tpu_torch.tools.receiver_main
        [--demo] [--idle-exit SECONDS] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import queue
import threading
import time
from typing import Optional

from janus_tpu_torch.audio.io import AudioService
from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.logging_util import setup_logging
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.common.state import EngineState
from janus_tpu_torch.runtime.emotion import ui_emotion_tag
from janus_tpu_torch.runtime.engine import playback_worker
from janus_tpu_torch.runtime.link import PacketListener
from janus_tpu_torch.runtime.synthesizer import Synthesizer

logger = logging.getLogger(__name__)

__all__ = ["receive_loop", "main"]


def receive_loop(
    cfg: JanusConfig,
    audio_service: AudioService,
    synthesizer: Optional[Synthesizer] = None,
    listener: Optional[PacketListener] = None,
    stop_event: Optional[threading.Event] = None,
    max_idle_seconds: float = 0.0,
    device="cuda",
) -> int:
    """Blocking receive loop; returns the packets played. A synthesizer not
    given is built on ``device``. ``max_idle_seconds`` > 0 exits after that
    long without a packet."""
    synthesizer = synthesizer or Synthesizer(
        cfg, reference_audio_path=cfg.server.reference_audio_path,
        device=device)
    listener = listener or PacketListener(
        cfg.link.receiver_port, use_tcp=cfg.link.use_tcp
    )
    stop_event = stop_event or threading.Event()
    state = EngineState()
    state.control.ducking_enabled = False

    playback_queue: "queue.Queue" = queue.Queue(maxsize=cfg.runtime.playback_queue_depth)
    player = threading.Thread(
        target=playback_worker,
        args=(audio_service, playback_queue, state, stop_event),
        daemon=True,
    )
    player.start()

    played = 0
    last_rx = time.monotonic()
    try:
        while not stop_event.is_set():
            payload = listener.receive()
            if payload is None:
                if max_idle_seconds and time.monotonic() - last_rx > max_idle_seconds:
                    break
                continue
            last_rx = time.monotonic()
            try:
                packet = JanusPacket.deserialize(payload)
            except Exception as e:
                logger.warning("corrupt packet (%dB): %s", len(payload), e)
                continue
            prosody = packet.prosody or {}
            emotion = (
                packet.override_emotion if packet.override_emotion != "Auto"
                else ui_emotion_tag(prosody.get("pitch", "Normal"),
                                    prosody.get("energy", "Normal"))
            )
            logger.info("RX %dB %r [%s]", len(payload), packet.text, emotion)
            try:
                audio = synthesizer.synthesize(packet)
            except Exception as e:
                logger.error("synthesis failed: %s", e)
                continue
            if audio:
                try:
                    playback_queue.put_nowait(audio)
                    played += 1
                except queue.Full:
                    logger.warning("playback queue full — dropping")
    finally:
        stop_event.set()
        listener.close()
        # let the playback worker drain briefly
        deadline = time.monotonic() + 1.0
        while not playback_queue.empty() and time.monotonic() < deadline:
            time.sleep(0.05)
    return played


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--idle-exit", type=float, default=0.0)
    parser.add_argument("--demo", action="store_true",
                        help="use the committed tone-language demo TTS/vocoder")
    parser.add_argument("--device", default="cuda",
                        help="device for the synthesizer (default: cuda)")
    args = parser.parse_args()
    setup_logging(log_dir=None)
    cfg = JanusConfig.from_env()
    synthesizer = None
    if args.demo:
        from janus_tpu_torch.models.zoo import load_demo

        bundle = load_demo(base=cfg)
        cfg = bundle.config
        synthesizer = Synthesizer(cfg, tts_params=bundle.tts_params,
                                  vocoder_params=bundle.vocoder_params,
                                  speaker_params=bundle.speaker_params,
                                  default_speaker_vec=bundle.default_speaker_vec,
                                  reference_audio_path=cfg.server.reference_audio_path,
                                  device=args.device)
    played = receive_loop(cfg, AudioService(), synthesizer=synthesizer,
                          max_idle_seconds=args.idle_exit, device=args.device)
    logger.info("done: %d packets played", played)


if __name__ == "__main__":
    main()
