"""RFC 6455 WebSocket server framing (stdlib-only).

Implements the server half of the protocol used by the dashboard socket
(reference: backend/api/socket_manager.py): handshake (Sec-WebSocket-Key →
Accept), masked client frame decoding, text/close/ping/pong handling, and
unmasked server frame encoding. No extensions, no fragmentation support
beyond continuation reassembly — exactly what a JSON control channel needs.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import struct

__all__ = ["accept_handshake", "WebSocketConnection", "ConnectionClosed"]

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BIN, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA


class ConnectionClosed(Exception):
    pass


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


async def accept_handshake(reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter,
                           headers) -> "WebSocketConnection":
    key = headers.get("sec-websocket-key")
    if not key:
        raise ValueError("missing Sec-WebSocket-Key")
    response = (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(key)}\r\n"
        "\r\n"
    )
    writer.write(response.encode())
    await writer.drain()
    return WebSocketConnection(reader, writer)


class WebSocketConnection:
    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self._reader = reader
        self._writer = writer
        self._send_lock = asyncio.Lock()
        self.closed = False

    # -- receive -----------------------------------------------------------

    async def recv_text(self) -> str:
        """Next text message (transparently answers pings)."""
        buffer = b""
        while True:
            fin, opcode, payload = await self._read_frame()
            if opcode == OP_PING:
                await self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                await self.close()
                raise ConnectionClosed()
            if opcode in (OP_TEXT, OP_BIN, OP_CONT):
                buffer += payload
                if fin:
                    return buffer.decode("utf-8", "replace")

    async def _read_frame(self):
        try:
            head = await self._reader.readexactly(2)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            self.closed = True
            raise ConnectionClosed()
        fin = bool(head[0] & 0x80)
        opcode = head[0] & 0x0F
        masked = bool(head[1] & 0x80)
        length = head[1] & 0x7F
        if length == 126:
            length = struct.unpack(">H", await self._reader.readexactly(2))[0]
        elif length == 127:
            length = struct.unpack(">Q", await self._reader.readexactly(8))[0]
        mask = await self._reader.readexactly(4) if masked else b"\x00" * 4
        payload = await self._reader.readexactly(length)
        if masked:
            payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        return fin, opcode, payload

    # -- send --------------------------------------------------------------

    async def send_text(self, text: str) -> None:
        await self._send_frame(OP_TEXT, text.encode("utf-8"))

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self.closed:
            raise ConnectionClosed()
        length = len(payload)
        if length < 126:
            head = struct.pack(">BB", 0x80 | opcode, length)
        elif length < 1 << 16:
            head = struct.pack(">BBH", 0x80 | opcode, 126, length)
        else:
            head = struct.pack(">BBQ", 0x80 | opcode, 127, length)
        async with self._send_lock:
            try:
                self._writer.write(head + payload)
                await self._writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                self.closed = True
                raise ConnectionClosed()

    async def close(self, code: int = 1000) -> None:
        if not self.closed:
            self.closed = True
            try:
                await self._send_lock.acquire()
                self._writer.write(struct.pack(">BBH", 0x88, 2, code))
                await self._writer.drain()
            except Exception:
                pass
            finally:
                if self._send_lock.locked():
                    self._send_lock.release()
            try:
                self._writer.close()
            except Exception:
                pass
