"""Shared engine control state and UI event queues.

A mutable control block written by the control plane and read by the
engine loops, plus lazily created asyncio queues carrying transcript and
packet-summary events to the UI (the JAX package's ``common/state.py``,
same fields and defaults). State is scoped to an :class:`EngineState`
instance; a module-global one is kept for callers that import it.
Host only.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Optional

__all__ = [
    "ControlState",
    "EngineState",
    "engine_state",
    "get_transcript_queue",
    "get_packet_queue",
    "reset_queues",
]


@dataclass
class ControlState:
    """Live engine controls.

    ``mode`` / ``emotion_override`` use the API string enums ("semantic",
    "text_only", "morse"; "auto", "relaxed", "panicked"); the wire
    protocol uses the int enum, mapped in
    :mod:`janus_tpu_torch.runtime.engine`.
    """

    mode: str = "semantic"
    is_streaming: bool = False
    is_recording: bool = False
    emotion_override: str = "auto"
    ducking_enabled: bool = True
    ducking_level: float = 0.25
    is_talking: bool = False

    def reset_transient(self) -> None:
        """Reset the per-connection flags (on a control-plane disconnect)."""
        self.is_streaming = False
        self.is_recording = False
        self.is_talking = False


class EngineState:
    """A control block plus event queues created lazily, so that they bind
    to the event loop that first uses them."""

    def __init__(self) -> None:
        self.control = ControlState()
        self._transcript_queue: Optional[asyncio.Queue] = None
        self._packet_queue: Optional[asyncio.Queue] = None

    def transcript_queue(self) -> asyncio.Queue:
        if self._transcript_queue is None:
            self._transcript_queue = asyncio.Queue()
        return self._transcript_queue

    def packet_queue(self) -> asyncio.Queue:
        if self._packet_queue is None:
            self._packet_queue = asyncio.Queue()
        return self._packet_queue

    def reset_queues(self) -> None:
        """Drop the queues (the next accessor rebinds them to the running
        loop) and restore the default controls."""
        self._transcript_queue = None
        self._packet_queue = None
        self.control = ControlState()


# Module-global instance, for callers that import the state directly.
engine_state = EngineState()


def get_transcript_queue() -> asyncio.Queue:
    return engine_state.transcript_queue()


def get_packet_queue() -> asyncio.Queue:
    return engine_state.packet_queue()


def reset_queues() -> None:
    engine_state.reset_queues()
