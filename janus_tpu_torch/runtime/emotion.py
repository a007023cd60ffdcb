"""Mode and emotion mapping tables.

The reference keeps two parallel mode enums (API strings vs wire ints) and
two emotion tables (send-side TTS prompt tags, receive-side UI tags); the
mappings here reproduce them exactly so observable behavior is preserved.
"""

from __future__ import annotations

from janus_tpu_torch.common.protocol import JanusMode

__all__ = [
    "API_MODES",
    "api_mode_to_protocol",
    "protocol_mode_to_api",
    "api_emotion_to_protocol",
    "tts_emotion_tag",
    "ui_emotion_tag",
]

API_MODES = ("semantic", "text_only", "morse")

_API_TO_PROTO = {
    "semantic": JanusMode.SEMANTIC_VOICE,
    "text_only": JanusMode.TEXT_ONLY,
    "morse": JanusMode.MORSE_CODE,
}
_PROTO_TO_API = {v: k for k, v in _API_TO_PROTO.items()}


def api_mode_to_protocol(api_mode: str) -> JanusMode:
    """(reference: backend/services/engine.py:315-330; unknown → semantic)"""
    return _API_TO_PROTO.get(api_mode, JanusMode.SEMANTIC_VOICE)


def protocol_mode_to_api(mode: JanusMode) -> str:
    """(reference: backend/services/engine.py:333-348; unknown → semantic)"""
    return _PROTO_TO_API.get(JanusMode(mode), "semantic")


def api_emotion_to_protocol(api_emotion: str) -> str:
    """API override ("auto"/"relaxed"/"panicked") → packet override.

    The reference passes the lowercase API enum straight into the packet,
    so ``'o': 'auto'`` leaks onto the wire even when no override is active
    (reference: backend/services/engine.py:545-548 vs protocol.py:74-76
    which only suppresses the exact string "Auto"). We normalize "auto" to
    the protocol's "Auto" sentinel — a deliberate, documented deviation
    that restores the protocol's own contract and saves 7 wire bytes.
    """
    return "Auto" if api_emotion.lower() == "auto" else api_emotion


def tts_emotion_tag(pitch: str, energy: str) -> str:
    """Send/synthesis-side prompt tag from categorical prosody
    (reference: backend/services/synthesizer.py:158-175 — including the
    original's dead 'Low'-pitch branches, kept verbatim for behavioral
    parity since the extractor emits 'Deep', never 'Low')."""
    if pitch == "High" and energy == "Loud":
        return "excited"
    if pitch == "High" and energy == "Normal":
        return "joyful"
    if pitch == "High" and energy in ("Quiet", "Low"):
        return "whispering"
    if pitch == "Low" and energy == "Loud":
        return "shouting"
    if pitch == "Low" and energy == "Low":
        return "sad"
    if pitch == "Low" and energy == "Normal":
        return "relaxed"
    if energy == "Loud":
        return "shouting"
    if energy in ("Quiet", "Low"):
        return "whispering"
    return "relaxed"


def ui_emotion_tag(pitch: str, energy: str) -> str:
    """Receive-side UI tag (reference: backend/services/engine.py:240-251)."""
    if pitch == "High" and energy == "Loud":
        return "Excited"
    if pitch == "High" and energy == "Normal":
        return "Joyful"
    if pitch == "Low" and energy == "Loud":
        return "Panicked"
    if pitch == "Low" and energy in ("Quiet", "Low"):
        return "Serious"
    return "Neutral"
