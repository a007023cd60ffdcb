"""The host runtime in the port against the JAX package (after
``tests/test_native.py``, ``tests/test_watchdog.py`` and the timer and
trace cases of ``tests/test_sessions.py``): the native ring buffer,
deframer and pacer, on the C++ library and on the pure-Python fallback,
give the JAX package's outputs on the same pushes, feeds and clock
readings; the library builds into ``build/janus_tpu_torch/``, never into
the package; the watchdog alarms as the JAX one does; ``trace`` writes a
trace that holds the program's spans. The tracer itself:
``tests/test_torch_profiling.py``."""

import json
import os
import threading
import time

import numpy as np
import pytest

import janus_tpu.native as j_native
import janus_tpu.runtime.watchdog as j_watchdog
import janus_tpu_torch.native as t_native
import janus_tpu_torch.runtime.profiling as t_profiling
import janus_tpu_torch.runtime.watchdog as t_watchdog
from janus_tpu.runtime.link import frame

PATHS = ["native", "fallback"]


def _packages(monkeypatch, path):
    """Both native modules, forced onto ``path``."""
    if path == "fallback":
        for m in (t_native, j_native):
            monkeypatch.setattr(m, "load_library", lambda: None)
    else:
        assert t_native.HAVE_NATIVE and j_native.HAVE_NATIVE
    return t_native, j_native


def test_library_builds_into_the_build_dir(tmp_path, monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "janus_tpu_torch", "native")
    assert t_native.HAVE_NATIVE
    assert str(t_native.LIB_PATH) == os.path.join(
        root, "build", "janus_tpu_torch", "libjanus_host.so")
    assert t_native.LIB_PATH.exists()
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    # the build itself, into a fresh directory
    target = tmp_path / "build" / "libjanus_host.so"
    monkeypatch.setattr(t_native, "LIB_PATH", target)
    assert t_native._stale() and t_native._try_build()
    assert target.exists() and not t_native._stale()
    assert os.listdir(target.parent) == ["libjanus_host.so"]


@pytest.mark.parametrize("path", PATHS)
def test_ring_buffer_equals_jax(monkeypatch, path):
    t, j = _packages(monkeypatch, path)
    rng = np.random.default_rng(0)
    rings = [m.RingBuffer(300) for m in (t, j)]
    assert rings[0].native == (path == "native")
    for step in range(200):
        if rng.random() < 0.55:
            data = rng.standard_normal(int(rng.integers(1, 160))).astype(
                np.float32)
            assert rings[0].push(data) == rings[1].push(data)
        else:
            n = int(rng.integers(1, 160))
            got, ref = (r.pop(n) for r in rings)
            assert (got is None) == (ref is None)
            if got is not None:
                np.testing.assert_array_equal(got, ref)
        assert len(rings[0]) == len(rings[1])


def test_native_ring_buffer_threaded_spsc():
    rb = t_native.RingBuffer(1 << 14)
    assert rb.native
    total, chunk, received = 100_000, 512, []

    def producer():
        sent = 0
        while sent < total:
            if rb.push(np.arange(sent, sent + chunk, dtype=np.float32)):
                sent += chunk

    def consumer():
        got = 0
        while got < total:
            out = rb.pop(chunk)
            if out is not None:
                received.append(out[0])
                got += chunk

    threads = [threading.Thread(target=f) for f in (producer, consumer)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    np.testing.assert_array_equal(
        np.asarray(received), np.arange(0, total, chunk, dtype=np.float32)[
            :len(received)])
    assert len(received) == -(-total // chunk)


@pytest.mark.parametrize("path", PATHS)
def test_deframer_equals_jax(monkeypatch, path):
    t, j = _packages(monkeypatch, path)
    packets = [b"alpha", b"x" * 300, b"", b"final", bytes(range(256)) * 5]
    stream = b"".join(frame(p) for p in packets)
    outs = []
    for m in (t, j):
        d, got = m.Deframer(), []
        for i in range(0, len(stream), 7):  # awkward fragments
            d.feed(stream[i:i + 7])
            while (p := d.pop()) is not None:
                got.append(p)
        outs.append(got)
    assert outs[0] == outs[1] == packets


@pytest.mark.parametrize("path", PATHS)
def test_pacer_equals_jax(monkeypatch, path):
    """The same byte counts at the same clock readings owe the same
    sleeps."""
    t, j = _packages(monkeypatch, path)
    clock = [0.0, 0.0, 0.1, 0.1, 2.0, 2.05, 9.0, 9.0]
    sizes = [500, 500, 140, 60, 1000, 10, 37, 2000]
    owed = []
    for m in (t, j):
        for bps, burst in ((1000.0, 0.0), (37.5, 1000.0)):
            p = m.Pacer(bps, burst)
            ticks = iter(clock)
            p._time = lambda: next(ticks)
            owed.append([p.acquire(n) for n in sizes])
    assert owed[:2] == owed[2:]
    assert owed[0][0] == pytest.approx(0.5) and owed[1][0] == 0.0


def _stall_scenario(m):
    """The stall sequence of ``tests/test_watchdog.py``: a healthy beat, a
    stall that alarms once, recovery, a second stall."""
    alarms = []
    wd = m.Watchdog(on_stall=lambda name, age: alarms.append(name))
    healthy = wd.register("loop", interval=0.2, grace=3.0)
    stalled = wd.register("recv", interval=0.02, grace=2.0)
    seen = []
    healthy.beat()
    time.sleep(0.1)
    seen.append(wd.check())
    seen.append(wd.check())  # no repeat while still stalled
    stalled.beat()
    healthy.beat()
    seen.append(wd.check())
    time.sleep(0.1)
    healthy.beat()
    seen.append(wd.check())  # re-alarms after recovery + a new stall
    wd.unregister("recv")
    time.sleep(0.05)
    healthy.beat()
    seen.append(wd.check())
    return seen, alarms, list(wd.stalls)


def test_watchdog_alarms_as_jax():
    ours, ref = (_stall_scenario(m) for m in (t_watchdog, j_watchdog))
    assert ours == ref
    assert ours[0] == [["recv"], [], [], ["recv"], []]


def test_watchdog_background_thread():
    for m in (t_watchdog, j_watchdog):
        wd = m.Watchdog(poll=0.02)
        wd.register("x", interval=0.02, grace=1.5)
        wd.start()
        time.sleep(0.15)
        wd.stop()
        assert "x" in wd.stalls and wd._thread is None


def test_trace_noop_and_chrome_trace(tmp_path):
    import torch

    with t_profiling.trace(None):
        x = 1 + 1
    assert x == 2
    t_profiling.take()
    assert t_profiling.span("encode.pad") is t_profiling.NOOP
    with t_profiling.trace(str(tmp_path / "tr")):
        with t_profiling.span("encode.submit", batch=2):
            with t_profiling.span("encode.pad"):
                torch.ones(64).sum()
    assert t_profiling.span("encode.pad") is t_profiling.NOOP
    recs = t_profiling.take()
    assert [s["name"] for s in recs] == ["encode.submit", "encode.pad"]
    assert recs[1]["parent"] == recs[0]["id"]
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    names = {e.get("name") for e in events}
    assert {"janus.encode.submit", "janus.encode.pad"} <= names
