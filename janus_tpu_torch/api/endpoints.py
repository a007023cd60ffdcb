"""REST endpoints: health check and voice-clone verification.

Parity with the reference (reference: backend/api/endpoints.py:22-86):
``GET /api/health`` → ``{"status": "ok"}``; ``POST /api/voice/verify``
takes a multipart audio upload (frontend field name ``audio_file``,
VoiceCloner.tsx:111), transcribes it, fuzzy-matches against the pangram
phrase at a 0.8 ratio, and on success saves the file as the voice-cloning
reference audio (picked up by the synthesizer's mtime hot-reload).

The response is the reference wire contract the real frontend branches on
(VoiceCloner.tsx:125-137 tests ``data.status === 'verified'`` exactly):
``{"status": "verified"}`` on success, ``{"status": "failed",
"transcript": ...}`` otherwise — including on transcription *errors*,
which the reference also reports as a 200 "failed" with the error string
as the transcript (endpoints.py:74-78). Richer diagnostic fields
(``similarity``, ``expected_phrase``, ``transcript`` on success) are
added on top; the frontend ignores unknown keys.

Unlike the reference — which instantiated a fresh Whisper model per
request (endpoints.py:55, a documented quirk) — the encoder is shared.
"""

from __future__ import annotations

import difflib
import logging
import os
import tempfile
from typing import Callable, Optional

from janus_tpu_torch.api.http import Request, Response, parse_multipart
from janus_tpu_torch.common.config import ServerConfig

logger = logging.getLogger(__name__)

__all__ = ["health_check", "make_voice_verify_handler"]


async def health_check(_request: Request) -> Response:
    return Response.json({"status": "ok"})


def make_voice_verify_handler(
    transcribe_file: Callable[[str], str],
    cfg: Optional[ServerConfig] = None,
    save_path: Optional[str] = None,
) -> Callable:
    """Build the verify handler around any file-transcription callable."""
    cfg = cfg or ServerConfig()
    target = save_path or cfg.reference_audio_path

    async def verify_voice(request: Request) -> Response:
        content_type = request.headers.get("content-type", "")
        if "multipart/form-data" not in content_type:
            return Response.json({"detail": "expected multipart upload"}, 400)
        try:
            parts = parse_multipart(request.body, content_type)
        except ValueError as e:
            return Response.json({"detail": str(e)}, 400)
        part = (
            parts.get("audio_file")  # the reference frontend's field name
            or parts.get("file")
            or parts.get("audio")
            or next(iter(parts.values()), None)
        )
        if part is None:
            return Response.json({"detail": "no file part"}, 400)
        _filename, data = part

        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
            tmp.write(data)
            tmp_path = tmp.name
        try:
            transcript = transcribe_file(tmp_path)
        except Exception as e:
            # Reference behavior: errors surface as a 200 "failed" response
            # with the error text as the transcript (endpoints.py:74-78).
            logger.error("verify transcription failed: %s", e)
            os.unlink(tmp_path)
            return Response.json({"status": "failed", "transcript": str(e)})

        ratio = difflib.SequenceMatcher(
            None, transcript.lower().strip(), cfg.verify_phrase.lower()
        ).ratio()
        verified = ratio >= cfg.verify_threshold
        if verified:
            with open(target, "wb") as f:
                f.write(data)
            logger.info("voice verified (ratio=%.3f) -> %s", ratio, target)
        os.unlink(tmp_path)
        body = {
            "status": "verified" if verified else "failed",
            "transcript": transcript,
            "similarity": round(ratio, 4),
            "expected_phrase": cfg.verify_phrase,
        }
        return Response.json(body)

    return verify_voice
