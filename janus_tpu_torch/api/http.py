"""Minimal asyncio HTTP/1.1 server core.

The reference rode FastAPI/uvicorn (reference: backend/server.py:111-137);
this package depends on neither, so the control plane runs on a purpose-built
~200-line async HTTP core: request-line + header parsing, Content-Length
bodies, multipart/form-data file extraction (for the voice-verify upload),
JSON responses, and an upgrade hook that hands WebSocket handshakes to
:mod:`janus_tpu_torch.api.ws`. One port serves REST and WS, like the reference.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = ["Request", "Response", "HttpServer", "parse_multipart"]

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024

_STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
    401: "Unauthorized", 404: "Not Found", 405: "Method Not Allowed",
    413: "Payload Too Large", 500: "Internal Server Error",
    101: "Switching Protocols",
}


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]
    body: bytes = b""

    def json(self):
        return json.loads(self.body.decode("utf-8"))


@dataclass
class Response:
    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    @classmethod
    def json(cls, obj, status: int = 200) -> "Response":
        body = json.dumps(obj).encode("utf-8")
        return cls(status=status, body=body,
                   headers={"Content-Type": "application/json"})

    @classmethod
    def text(cls, s: str, status: int = 200) -> "Response":
        return cls(status=status, body=s.encode(),
                   headers={"Content-Type": "text/plain; charset=utf-8"})

    def encode(self) -> bytes:
        # CORS-* like the reference (backend/server.py:126-133)
        headers = {
            "Access-Control-Allow-Origin": "*",
            "Access-Control-Allow-Methods": "*",
            "Access-Control-Allow-Headers": "*",
            "Content-Length": str(len(self.body)),
            "Connection": "close",
            **self.headers,
        }
        head = f"HTTP/1.1 {self.status} {_STATUS_TEXT.get(self.status, '')}\r\n"
        head += "".join(f"{k}: {v}\r\n" for k, v in headers.items())
        return head.encode() + b"\r\n" + self.body


Handler = Callable[[Request], Awaitable[Response]]
WsHandler = Callable[[asyncio.StreamReader, asyncio.StreamWriter, Request],
                     Awaitable[None]]


def parse_multipart(body: bytes, content_type: str) -> Dict[str, Tuple[str, bytes]]:
    """Extract multipart/form-data parts: name -> (filename, data).

    Splits on the exact RFC 2046 delimiter ``CRLF--boundary`` so binary
    payloads whose last bytes happen to be CR/LF survive byte-exact
    (the voice-clone upload is saved verbatim as the reference audio).
    """
    m = re.search(r'boundary="?([^";,]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    boundary = b"--" + m.group(1).encode()
    segments = body.split(b"\r\n" + boundary)
    # The first boundary opens the body with no preceding CRLF.
    if segments[0].startswith(boundary):
        segments[0] = segments[0][len(boundary):]
    parts: Dict[str, Tuple[str, bytes]] = {}
    for seg in segments:
        if seg[:2] == b"--":  # closing delimiter
            continue
        if seg[:2] == b"\r\n":
            seg = seg[2:]
        if b"\r\n\r\n" not in seg:
            continue
        header_blob, data = seg.split(b"\r\n\r\n", 1)
        headers = header_blob.decode("utf-8", "replace")
        name_m = re.search(r'name="([^"]+)"', headers)
        file_m = re.search(r'filename="([^"]*)"', headers)
        if name_m:
            parts[name_m.group(1)] = (file_m.group(1) if file_m else "", data)
    return parts


class HttpServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        self.host = host
        self.port = port
        self._routes: Dict[Tuple[str, str], Handler] = {}
        self._ws_routes: Dict[str, WsHandler] = {}
        self._server: Optional[asyncio.AbstractServer] = None

    def route(self, method: str, path: str, handler: Handler) -> None:
        self._routes[(method.upper(), path)] = handler

    def websocket(self, path: str, handler: WsHandler) -> None:
        self._ws_routes[path] = handler

    @property
    def bound_port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            request = await self._read_request(reader)
            if request is None:
                writer.close()
                return

            if (request.headers.get("upgrade", "").lower() == "websocket"
                    and request.path in self._ws_routes):
                await self._ws_routes[request.path](reader, writer, request)
                return

            handler = self._routes.get((request.method, request.path))
            if handler is None:
                if request.method == "OPTIONS":  # CORS preflight
                    response = Response(status=204)
                else:
                    response = Response.json({"detail": "Not Found"}, status=404)
            else:
                try:
                    response = await handler(request)
                except Exception as e:
                    logger.exception("handler error on %s", request.path)
                    response = Response.json({"detail": str(e)}, status=500)
            writer.write(response.encode())
            await writer.drain()
            writer.close()
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        except Exception:
            logger.exception("connection error")
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader: asyncio.StreamReader) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        if len(head) > MAX_HEADER_BYTES:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        path, _, query_str = target.partition("?")
        query = {}
        for pair in query_str.split("&"):
            if "=" in pair:
                k, v = pair.split("=", 1)
                query[k] = v
        body = b""
        n = int(headers.get("content-length", "0") or "0")
        if n > MAX_BODY_BYTES:
            return None
        if n:
            body = await reader.readexactly(n)
        return Request(method=method.upper(), path=path, query=query,
                       headers=headers, body=body)
