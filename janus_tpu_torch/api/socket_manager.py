"""The /ws/janus control socket.

Protocol parity with the reference manager (reference:
backend/api/socket_manager.py:19-187): on connect the full control-state
snapshot is pushed; a receive loop applies partial ControlMessages
(None = no change); a send loop races the transcript and packet queues
with FIRST_COMPLETED; disconnect resets the transient control flags.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from janus_tpu_torch.api.types import ControlMessage, ControlStateMessage
from janus_tpu_torch.api.ws import ConnectionClosed, WebSocketConnection
from janus_tpu_torch.common.state import EngineState

logger = logging.getLogger(__name__)

__all__ = ["handle_janus_ws", "control_state_message", "apply_control_message"]


def control_state_message(state: EngineState) -> str:
    c = state.control
    return ControlStateMessage(
        is_streaming=c.is_streaming,
        is_recording=c.is_recording,
        mode=c.mode,
        emotion_override=c.emotion_override,
    ).model_dump_json()


def apply_control_message(state: EngineState, msg: ControlMessage) -> None:
    """Partial update: only non-None fields mutate state
    (reference: backend/api/socket_manager.py:112-136)."""
    c = state.control
    if msg.is_streaming is not None:
        c.is_streaming = msg.is_streaming
    if msg.is_recording is not None:
        c.is_recording = msg.is_recording
    if msg.mode is not None:
        c.mode = msg.mode.value
    if msg.emotion_override is not None:
        c.emotion_override = msg.emotion_override.value


async def _recv_loop(ws: WebSocketConnection, state: EngineState) -> None:
    while True:
        raw = await ws.recv_text()
        try:
            payload = json.loads(raw)
            if payload.get("type") == "control":
                apply_control_message(state, ControlMessage(**payload))
                await ws.send_text(control_state_message(state))
            else:
                logger.debug("ignoring ws message type=%r", payload.get("type"))
        except ConnectionClosed:
            raise
        except Exception as e:
            logger.warning("bad control message: %s", e)


async def _send_loop(ws: WebSocketConnection, state: EngineState) -> None:
    """Race both event queues (reference: socket_manager.py:152-166)."""
    tq = state.transcript_queue()
    pq = state.packet_queue()
    t_task: Optional[asyncio.Task] = None
    p_task: Optional[asyncio.Task] = None
    try:
        while True:
            if t_task is None:
                t_task = asyncio.create_task(tq.get())
            if p_task is None:
                p_task = asyncio.create_task(pq.get())
            done, _pending = await asyncio.wait(
                {t_task, p_task}, return_when=asyncio.FIRST_COMPLETED
            )
            if t_task in done:
                await ws.send_text(json.dumps(t_task.result()))
                t_task = None
            if p_task in done:
                await ws.send_text(json.dumps(p_task.result()))
                p_task = None
    finally:
        for task in (t_task, p_task):
            if task is not None:
                task.cancel()


async def handle_janus_ws(ws: WebSocketConnection, state: EngineState) -> None:
    try:
        await ws.send_text(control_state_message(state))
        recv = asyncio.create_task(_recv_loop(ws, state))
        send = asyncio.create_task(_send_loop(ws, state))
        done, pending = await asyncio.wait(
            {recv, send}, return_when=asyncio.FIRST_COMPLETED
        )
        for task in pending:
            task.cancel()
        for task in done:  # retrieve, else asyncio logs "never retrieved"
            try:
                task.result()
            except (ConnectionClosed, asyncio.CancelledError):
                pass
    except ConnectionClosed:
        pass
    finally:
        # reference resets transient flags on disconnect
        state.control.reset_transient()
        await ws.close()
