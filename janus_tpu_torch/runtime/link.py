"""Constrained-link transport: the simulated 300 bps radio channel.

- 300 baud → 37.5 B/s of airtime, slept **before** the actual send;
- UDP fire-and-forget datagrams, or TCP with a 4-byte big-endian length
  prefix counted against the airtime budget;
- ``recv_exact`` loops until exactly n bytes arrive (an empty read means
  the peer closed).

The pacer sleeps against a monotonic deadline in ``progress_ticks`` steps
(the same total airtime, immune to sleep drift) and reports progress to
an optional callback; ``transmit`` is thread-safe. The bytes on the wire
are the JAX package's. Host only.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable, Optional

from janus_tpu_torch.common.config import LinkConfig

__all__ = ["LinkSimulator", "recv_exact", "frame", "unframe_header", "PacketListener"]

HEADER = struct.Struct(">I")


def frame(payload: bytes) -> bytes:
    """4-byte big-endian length prefix + payload (TCP framing)."""
    return HEADER.pack(len(payload)) + payload


def unframe_header(header: bytes) -> int:
    return HEADER.unpack(header)[0]


def recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None if the peer closes mid-read."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class LinkSimulator:
    """Throttled sender."""

    def __init__(self, cfg: Optional[LinkConfig] = None,
                 progress: Optional[Callable[[float], None]] = None) -> None:
        self.cfg = cfg or LinkConfig()
        self._progress = progress
        self._lock = threading.Lock()
        self.bytes_sent = 0
        self.packets_sent = 0
        if self.cfg.use_tcp:
            self.socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                self.socket.connect((self.cfg.target_ip, self.cfg.target_port))
            except (ConnectionRefusedError, OSError):
                pass  # a refused connection is not fatal; sends fail later
        else:
            self.socket = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def airtime(self, n_bytes: int) -> float:
        return n_bytes / self.cfg.bytes_per_second

    def transmit(self, payload: bytes) -> None:
        """Sleep the payload's airtime, then send."""
        framed = frame(payload) if self.cfg.use_tcp else payload
        delay = self.airtime(len(framed))
        self._pace(delay)
        with self._lock:
            try:
                if self.cfg.use_tcp:
                    self.socket.sendall(framed)
                else:
                    self.socket.sendto(
                        framed, (self.cfg.target_ip, self.cfg.target_port)
                    )
                self.bytes_sent += len(framed)
                self.packets_sent += 1
            except OSError:
                pass  # dropped, as a radio link drops

    def _pace(self, duration: float) -> None:
        ticks = max(self.cfg.progress_ticks, 1)
        deadline = time.monotonic()
        for i in range(ticks):
            deadline += duration / ticks
            remaining = deadline - time.monotonic()
            if remaining > 0:
                time.sleep(remaining)
            if self._progress is not None:
                self._progress((i + 1) / ticks)

    def close(self) -> None:
        try:
            self.socket.close()
        except OSError:
            pass


class PacketListener:
    """Receive side: UDP datagrams or a single framed TCP connection.
    Port 0 binds an ephemeral port (read it back from :attr:`port`)."""

    def __init__(self, port: int, use_tcp: bool = False,
                 host: str = "0.0.0.0", timeout: float = 0.5) -> None:
        self.use_tcp = use_tcp
        self._timeout = timeout
        self._conn: Optional[socket.socket] = None
        if use_tcp:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self._sock.listen(1)
            self._sock.settimeout(timeout)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self._sock.settimeout(timeout)

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def receive(self) -> Optional[bytes]:
        """One packet payload, or None on timeout/disconnect."""
        try:
            if not self.use_tcp:
                data, _addr = self._sock.recvfrom(4096)
                return data
            if self._conn is None:
                conn, _addr = self._sock.accept()
                conn.settimeout(self._timeout)
                self._conn = conn
            header = recv_exact(self._conn, 4)
            if header is None:
                self._conn.close()
                self._conn = None
                return None
            return recv_exact(self._conn, unframe_header(header))
        except socket.timeout:
            return None
        except OSError:
            return None

    def close(self) -> None:
        for s in (self._conn, self._sock):
            try:
                if s is not None:
                    s.close()
            except OSError:
                pass
