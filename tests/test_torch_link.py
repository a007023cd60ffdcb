"""The port's link against the JAX package's: framing bytes and airtime
equal, UDP and TCP loopback between the two packages in both directions,
pacing, refused connections, listener timeouts and the progress callback
(after ``tests/test_transport.py``)."""

import socket
import threading
import time

import pytest

from janus_tpu.common.config import LinkConfig as JLinkConfig
from janus_tpu.runtime import link as j_link
from janus_tpu_torch.common.config import LinkConfig
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.runtime import link as t_link

PAYLOADS = (b"", b"hello janus", bytes(range(256)) * 3)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_frame_bytes_equal(payload):
    framed = t_link.frame(payload)
    assert framed == j_link.frame(payload)
    assert t_link.unframe_header(framed[:4]) == len(payload)
    assert framed[4:] == payload


@pytest.mark.parametrize("baud,n", [(300, 150), (4800, 61), (48_000, 1)])
def test_airtime_equal(baud, n):
    ours = t_link.LinkSimulator(LinkConfig(baud_rate=baud, target_port=59999))
    ref = j_link.LinkSimulator(JLinkConfig(baud_rate=baud, target_port=59999))
    assert ours.airtime(n) == ref.airtime(n)
    if baud == 300:
        assert ours.airtime(n) == pytest.approx(4.0)
    ours.close()
    ref.close()


def _listener(pkg, use_tcp):
    return (t_link if pkg == "torch" else j_link).PacketListener(
        0, use_tcp=use_tcp)


def _link(pkg, **kw):
    if pkg == "torch":
        return t_link.LinkSimulator(LinkConfig(**kw))
    return j_link.LinkSimulator(JLinkConfig(**kw))


@pytest.mark.parametrize("tx,rx", [("torch", "torch"), ("torch", "jax"),
                                   ("jax", "torch")])
def test_udp_transmit_throttles_and_delivers(tx, rx):
    listener = _listener(rx, use_tcp=False)
    link = _link(tx, baud_rate=4800, target_ip="127.0.0.1",
                 target_port=listener.port, use_tcp=False)
    payload = JanusPacket(text="udp test", timestamp=1.0).serialize()
    t0 = time.monotonic()
    link.transmit(payload)
    elapsed = time.monotonic() - t0
    assert elapsed >= 0.9 * len(payload) / link.cfg.bytes_per_second
    assert listener.receive() == payload
    assert link.bytes_sent == len(payload) and link.packets_sent == 1
    link.close()
    listener.close()


@pytest.mark.parametrize("tx,rx", [("torch", "torch"), ("torch", "jax"),
                                   ("jax", "torch")])
def test_tcp_transmit_framed(tx, rx):
    listener = _listener(rx, use_tcp=True)
    received = []

    def recv():
        for _ in range(20):
            p = listener.receive()
            if p is not None:
                received.append(p)
                return

    t = threading.Thread(target=recv)
    t.start()
    time.sleep(0.05)
    link = _link(tx, baud_rate=48_000, target_ip="127.0.0.1",
                 target_port=listener.port, use_tcp=True)
    payload = JanusPacket(text="tcp framed", timestamp=2.0).serialize()
    link.transmit(payload)
    t.join(timeout=5)
    assert received == [payload]
    assert link.bytes_sent == len(payload) + 4  # the header is on the air
    link.close()
    listener.close()


def test_recv_exact_fragmented_and_closed():
    a, b = socket.socketpair()
    try:
        b.sendall(b"abc")
        timer = threading.Timer(0.05, lambda: b.sendall(b"defg"))
        timer.start()
        assert t_link.recv_exact(a, 7) == b"abcdefg"
        timer.join()
        b.close()
        assert t_link.recv_exact(a, 1) is None
    finally:
        a.close()


@pytest.mark.parametrize("use_tcp", [False, True])
def test_refused_connection_is_swallowed(use_tcp):
    link = t_link.LinkSimulator(LinkConfig(baud_rate=480_000,
                                           target_ip="127.0.0.1",
                                           target_port=1, use_tcp=use_tcp))
    link.transmit(b"x" * 10)  # must not raise
    assert link.packets_sent == (0 if use_tcp else 1)
    link.close()


@pytest.mark.parametrize("use_tcp", [False, True])
def test_listener_timeout_returns_none(use_tcp):
    listener = t_link.PacketListener(0, use_tcp=use_tcp, timeout=0.1)
    assert listener.port > 0
    assert listener.receive() is None
    listener.close()


def test_progress_callback_ticks():
    ticks = []
    listener = t_link.PacketListener(0, use_tcp=False)
    cfg = LinkConfig(baud_rate=192_000, target_ip="127.0.0.1",
                     target_port=listener.port)
    link = t_link.LinkSimulator(cfg, progress=ticks.append)
    link.transmit(b"x" * 24)
    assert len(ticks) == cfg.progress_ticks
    assert ticks == sorted(ticks) and ticks[-1] == pytest.approx(1.0)
    link.close()
    listener.close()
