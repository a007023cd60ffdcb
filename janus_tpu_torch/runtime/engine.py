"""Engine orchestration: the full-duplex send ("smart ear") and receive
("mouthpiece") loops.

Send: microphone chunks flow producer thread → queue → segmenter (PTT or
VAD-gated streaming) → encode → packet → throttled link. Receive: packets
flow listener → emotion inference → synthesis → playback queue → ducking
→ speaker. The device work runs inside :class:`SemanticEncoder`,
:class:`VoiceActivityDetector` and :class:`Synthesizer`; the loops stay
on the host.

The encode runs on an executor thread (``loop.run_in_executor``). Grad
mode is thread-local, so the encoder and the VAD disable autograd inside
their own methods, not around these call sites.

As in the JAX package: packet summaries report the real serialized byte
count, and the control plane's "auto" emotion override maps to the
protocol's "Auto" sentinel.
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
import time
from typing import Optional

import numpy as np

from janus_tpu_torch.audio.io import AudioService
from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.common.state import EngineState
from janus_tpu_torch.models.vad import VoiceActivityDetector
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.runtime.emotion import (
    api_emotion_to_protocol,
    api_mode_to_protocol,
    protocol_mode_to_api,
    ui_emotion_tag,
)
from janus_tpu_torch.runtime.link import LinkSimulator, PacketListener
from janus_tpu_torch.runtime.segmenter import PhraseSegmenter, SegmenterEvent
from janus_tpu_torch.runtime.synthesizer import Synthesizer

logger = logging.getLogger(__name__)

__all__ = [
    "audio_producer",
    "smart_ear_loop",
    "receiver_loop",
    "playback_worker",
    "apply_ducking_if_needed",
]


# --------------------------------------------------------------------------
# send path
# --------------------------------------------------------------------------

def audio_producer(audio_service: AudioService, audio_queue: "queue.Queue",
                   stop_event: threading.Event) -> None:
    """Capture thread: chunks into ``audio_queue`` until stopped or the
    capture ends (``read_chunk`` returns None). A chunk that finds the
    queue full for 0.5 s is dropped."""
    while not stop_event.is_set():
        try:
            chunk = audio_service.read_chunk()
            if chunk is None:  # end of a file/stream-backed capture
                break
            audio_queue.put(chunk, timeout=0.5)
        except queue.Full:
            continue
        except Exception as e:
            logger.error("audio producer error: %s", e)
            time.sleep(0.1)


async def smart_ear_loop(
    audio_service: AudioService,
    state: EngineState,
    encoder: SemanticEncoder,
    vad: VoiceActivityDetector,
    link: LinkSimulator,
    stop_event: threading.Event,
    cfg: Optional[JanusConfig] = None,
) -> None:
    """Async send pipeline, steered by ``state.control``."""
    cfg = cfg or JanusConfig()
    audio_queue: "queue.Queue" = queue.Queue(maxsize=cfg.runtime.audio_queue_depth)
    producer = threading.Thread(
        target=audio_producer, args=(audio_service, audio_queue, stop_event),
        daemon=True,
    )
    producer.start()
    segmenter = PhraseSegmenter(cfg.segmenter)
    loop = asyncio.get_running_loop()

    try:
        while not stop_event.is_set():
            try:
                chunk = audio_queue.get_nowait()
            except queue.Empty:
                await asyncio.sleep(0.01)
                continue

            control = state.control
            result = None

            if control.is_recording:
                control.is_talking = True
                result = segmenter.push_ptt(chunk, held=True)
            elif segmenter.ptt_held:  # PTT just released
                control.is_talking = False
                result = segmenter.push_ptt(chunk, held=False)
            elif control.is_streaming:
                # morse/text modes bypass the VAD gate
                non_vad = control.mode in ("morse", "text_only")
                # the VAD runs first even in non-VAD modes, so that its
                # adaptive noise floor keeps tracking
                is_speech = vad.is_speech(chunk) or non_vad
                result = segmenter.push_streaming(chunk, is_speech)
                if result.event is SegmenterEvent.PHRASE_START:
                    control.is_talking = True
                elif result.event in (SegmenterEvent.PHRASE_READY,
                                      SegmenterEvent.PHRASE_DROPPED):
                    control.is_talking = False
            else:
                control.is_talking = False

            if result is None or result.event is not SegmenterEvent.PHRASE_READY:
                continue

            phrase = result.phrase
            t0 = time.perf_counter()
            encoded = await loop.run_in_executor(
                None, lambda: encoder.encode_batch([phrase])[0]
            )
            logger.info(
                "encoded %.2fs phrase in %.0fms: %r",
                len(phrase) / cfg.audio.sample_rate,
                1e3 * (time.perf_counter() - t0),
                encoded["text"],
            )
            if not encoded["text"].strip():
                continue  # an empty transcript sends nothing

            packet = JanusPacket(
                text=encoded["text"],
                mode=api_mode_to_protocol(control.mode),
                prosody=encoded["prosody"],
                override_emotion=api_emotion_to_protocol(control.emotion_override),
            )
            payload = packet.serialize()
            await loop.run_in_executor(None, link.transmit, payload)

            await _emit_events(
                state,
                text=encoded["text"],
                mode=control.mode,
                avg_pitch_hz=encoded.get("f0"),
                avg_energy=encoded.get("rms"),
                packet_bytes=len(payload),
                emotion=None,
            )
    finally:
        stop_event.set()


# --------------------------------------------------------------------------
# receive path
# --------------------------------------------------------------------------

def apply_ducking_if_needed(audio_bytes: bytes, state: EngineState) -> bytes:
    """Scale int16 playback while the local user is talking."""
    control = state.control
    if not (control.ducking_enabled and control.is_talking) or not audio_bytes:
        return audio_bytes
    pcm = np.frombuffer(audio_bytes, dtype=np.int16).astype(np.float32)
    pcm *= control.ducking_level
    return np.clip(pcm, -32768, 32767).astype(np.int16).tobytes()


def playback_worker(audio_service: AudioService, playback_queue: "queue.Queue",
                    state: EngineState, stop_event: threading.Event) -> None:
    """Drain synthesized audio to the speaker."""
    while not stop_event.is_set():
        try:
            audio = playback_queue.get(timeout=0.2)
        except queue.Empty:
            continue
        try:
            audio_service.write_chunk(apply_ducking_if_needed(audio, state))
        except Exception as e:
            logger.error("playback error: %s", e)


def receiver_loop(
    audio_service: AudioService,
    state: EngineState,
    synthesizer: Synthesizer,
    listener: PacketListener,
    stop_event: threading.Event,
    event_loop: Optional[asyncio.AbstractEventLoop] = None,
    cfg: Optional[JanusConfig] = None,
) -> None:
    """Threaded receive pipeline; with ``cfg.runtime.streaming_playback``
    each synthesized chunk is queued for playback as it is generated."""
    cfg = cfg or JanusConfig()
    playback_queue: "queue.Queue" = queue.Queue(maxsize=cfg.runtime.playback_queue_depth)
    player = threading.Thread(
        target=playback_worker,
        args=(audio_service, playback_queue, state, stop_event),
        daemon=True,
    )
    player.start()

    while not stop_event.is_set():
        payload = listener.receive()
        if payload is None:
            continue
        try:
            packet = JanusPacket.deserialize(payload)
        except Exception as e:
            logger.warning("corrupt packet dropped (%d bytes): %s", len(payload), e)
            continue

        prosody = packet.prosody or {}
        if packet.override_emotion != "Auto":
            emotion = packet.override_emotion
        else:
            emotion = ui_emotion_tag(
                prosody.get("pitch", "Normal"), prosody.get("energy", "Normal")
            )

        if event_loop is not None:
            asyncio.run_coroutine_threadsafe(
                _emit_events(
                    state,
                    text=packet.text,
                    mode=protocol_mode_to_api(packet.mode),
                    avg_pitch_hz=None,
                    avg_energy=None,
                    packet_bytes=len(payload),
                    emotion=emotion,
                ),
                event_loop,
            )

        if cfg.runtime.streaming_playback:
            # chunks reach the speaker while later mel groups are still
            # being generated: the turnaround is one decode chunk, not the
            # whole clip
            try:
                for chunk in synthesizer.synthesize_streaming(packet):
                    if not chunk:
                        continue
                    try:
                        playback_queue.put_nowait(chunk)
                    except queue.Full:
                        logger.warning("playback queue full — dropping chunk")
            except Exception as e:
                logger.error("synthesis failed, packet skipped: %s", e)
            continue

        try:
            audio = synthesizer.synthesize(packet)
        except Exception as e:
            logger.error("synthesis failed, packet skipped: %s", e)
            continue
        if not audio:
            continue
        try:
            playback_queue.put_nowait(audio)
        except queue.Full:
            logger.warning("playback queue full — dropping audio")


# --------------------------------------------------------------------------
# UI events
# --------------------------------------------------------------------------

async def _emit_events(state: EngineState, *, text: str, mode: str,
                       avg_pitch_hz, avg_energy, packet_bytes: int,
                       emotion) -> None:
    """Queue transcript and packet-summary events for the control plane."""
    now_ms = int(time.time() * 1000)
    await state.transcript_queue().put({
        "type": "transcript",
        "text": text,
        "start_ms": None,
        "end_ms": now_ms,
        "avg_pitch_hz": avg_pitch_hz,
        "avg_energy": avg_energy,
    })
    await state.packet_queue().put({
        "type": "packet_summary",
        "bytes": packet_bytes,  # the real wire size
        "mode": mode,
        "created_at_ms": now_ms,
        "emotion": emotion,
        "snippet": text[:80] if text else None,
    })
