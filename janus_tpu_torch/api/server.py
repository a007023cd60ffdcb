"""Application server: wires the engine loops under the control plane.

The lifespan mirrors the reference app factory (reference:
backend/server.py:39-137): start the audio service, spawn the async send
loop and the threaded receive loop, serve REST + WS on one port, and shut
everything down gracefully (stop event → thread join → task cancel →
audio close). The encoder, the VAD and the synthesizer run on ``device``
(the card unless the caller asks for ``"cpu"``); an encoder or
synthesizer passed in keeps its own device.

Run: ``python -m janus_tpu_torch.api.server [--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import threading
from typing import Optional

import numpy as np
import torch

from janus_tpu_torch.api.dashboard import DASHBOARD_HTML
from janus_tpu_torch.api.endpoints import health_check, make_voice_verify_handler
from janus_tpu_torch.api.http import HttpServer, Request, Response
from janus_tpu_torch.api.socket_manager import handle_janus_ws
from janus_tpu_torch.api.ws import accept_handshake
from janus_tpu_torch.audio.decode import read_audio
from janus_tpu_torch.audio.io import AudioService
from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.state import EngineState
from janus_tpu_torch.models.vad import VoiceActivityDetector
from janus_tpu_torch.ops.resample import resample_poly
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.runtime.engine import receiver_loop, smart_ear_loop
from janus_tpu_torch.runtime.link import LinkSimulator, PacketListener
from janus_tpu_torch.runtime.synthesizer import Synthesizer

logger = logging.getLogger(__name__)

__all__ = ["JanusServer", "main"]


class JanusServer:
    def __init__(self, cfg: Optional[JanusConfig] = None,
                 audio_service: Optional[AudioService] = None,
                 encoder: Optional[SemanticEncoder] = None,
                 synthesizer: Optional[Synthesizer] = None,
                 device="cuda") -> None:
        self.cfg = cfg or JanusConfig.from_env()
        self.state = EngineState()
        self.encoder = encoder or SemanticEncoder(self.cfg, device=device)
        self.synthesizer = synthesizer or Synthesizer(
            self.cfg, reference_audio_path=self.cfg.server.reference_audio_path,
            device=device)
        self.vad = VoiceActivityDetector(self.cfg.vad,
                                         sample_rate=self.cfg.audio.sample_rate,
                                         device=self.encoder.device)
        self.audio = audio_service or AudioService()
        self.stop_event = threading.Event()
        self.http = HttpServer(self.cfg.server.host, self.cfg.server.port)
        self._ear_task: Optional[asyncio.Task] = None
        self._recv_thread: Optional[threading.Thread] = None
        self._link: Optional[LinkSimulator] = None
        self._listener: Optional[PacketListener] = None

        self.http.route("GET", "/api/health", health_check)

        async def dashboard(_request: Request) -> Response:
            return Response(
                body=DASHBOARD_HTML.encode(),
                headers={"Content-Type": "text/html; charset=utf-8"},
            )

        self.http.route("GET", "/", dashboard)
        # second page of the reference frontend (frontend/app/telemetry/):
        # same single-file app, boots on the telemetry tab
        self.http.route("GET", "/telemetry", dashboard)
        self.http.route(
            "POST", "/api/voice/verify",
            make_voice_verify_handler(self.transcribe_file, self.cfg.server),
        )

        async def ws_entry(reader, writer, request: Request):
            ws = await accept_handshake(reader, writer, request.headers)
            await handle_janus_ws(ws, self.state)

        self.http.websocket(self.cfg.server.ws_path, ws_entry)

    def transcribe_file(self, path: str) -> str:
        """The transcript of an upload. Sniffs WAV / WebM-Opus / Ogg-Opus —
        the formats the reference accepted via FFmpeg (reference:
        backend/services/transcriber.py:66-91; the browser records
        audio/webm;codecs=opus, VoiceCloner.tsx:61-63); a rate other than
        48 kHz is resampled on the encoder's device."""
        audio, sr = read_audio(path)
        if sr != 48_000:
            with torch.no_grad():
                x = torch.from_numpy(np.ascontiguousarray(
                    audio, dtype=np.float32)).to(self.encoder.device)
                audio = resample_poly(x, up=48_000, down=sr).cpu().numpy()
        return self.encoder.encode_batch([audio])[0]["text"]

    # -- lifecycle ---------------------------------------------------------

    async def start(self, start_engine: bool = True) -> None:
        await self.http.start()
        logger.info("control plane on %s:%d", self.cfg.server.host, self.http.bound_port)
        if start_engine:
            self._link = LinkSimulator(self.cfg.link)
            self._listener = PacketListener(
                self.cfg.link.receiver_port, use_tcp=self.cfg.link.use_tcp
            )
            self._ear_task = asyncio.create_task(
                smart_ear_loop(self.audio, self.state, self.encoder, self.vad,
                               self._link, self.stop_event, self.cfg)
            )
            loop = asyncio.get_running_loop()
            self._recv_thread = threading.Thread(
                target=receiver_loop,
                args=(self.audio, self.state, self.synthesizer, self._listener,
                      self.stop_event, loop, self.cfg),
                daemon=True,
            )
            self._recv_thread.start()

    async def stop(self) -> None:
        """Graceful shutdown (reference: backend/server.py:89-108)."""
        self.stop_event.set()
        if self._recv_thread is not None:
            self._recv_thread.join(timeout=2)
        if self._ear_task is not None:
            self._ear_task.cancel()
            try:
                await self._ear_task
            except (asyncio.CancelledError, Exception):
                pass
        for closable in (self._link, self._listener):
            if closable is not None:
                closable.close()
        await self.http.stop()
        self.audio.close()


async def _serve(server: JanusServer) -> None:
    await server.start()
    try:
        await asyncio.Event().wait()
    finally:
        await server.stop()


def main() -> None:
    from janus_tpu_torch.common.logging_util import setup_logging

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="device for the encoder, the VAD and the "
                             "synthesizer (default: cuda)")
    args = parser.parse_args()
    setup_logging()
    asyncio.run(_serve(JanusServer(device=args.device)))


if __name__ == "__main__":
    main()
