"""The port's tracer (``janus_tpu_torch.runtime.profiling``) on the CPU:
off, a span is one shared no-op that makes no CUDA call; on, spans nest,
share their request's id, time themselves and their children on the
host's clock, live in a bounded ring, and ``report`` sums them and puts
the card's idle gaps down to the host span open when each ended; the
encode, the synthesis and the stream each give one tree under one
request id. The device side (timing events on the host's clock, the
synthesis launch's parts) is held on the card in
``tests/test_torch_cuda.py``."""

import collections
import sys
import threading

import numpy as np
import pytest
import torch

from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.runtime import codec, profiling, streaming_tts
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.runtime.streaming_tts import StreamingSynthesizer
from janus_tpu_torch.runtime.synthesizer import Synthesizer


@pytest.fixture(autouse=True)
def clean():
    profiling.disable()
    profiling.take()
    yield
    profiling.disable()
    profiling.take()


def _names(recs):
    return [s["name"] for s in recs]


def test_off_is_one_shared_noop_with_no_cuda_call(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("a CUDA call while tracing is off")

    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(torch.cuda, "synchronize", refused)
    monkeypatch.setattr(torch.cuda, "current_stream", refused)
    a = profiling.span("encode.submit", batch=8)
    b = profiling.span("encode.front", device=torch.device("cuda", 0))
    assert a is b is profiling.NOOP
    with profiling.span("stream.request", request=7) as s:
        s.set(steps=3)
        assert s.marks(2) is None
        assert s.parts(("x", "y"), None) == (profiling.NOOP,) * 2
    s.close()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_setup_spans_are_recorded_when_off():
    with profiling.span("setup.capture", steps=4):
        assert profiling.span("stream.decode") is profiling.NOOP
    (rec,) = profiling.spans()
    assert rec["name"] == "setup.capture" and rec["attrs"] == {"steps": 4}
    assert rec["end_ns"] >= rec["start_ns"] and rec["device"] is None


def test_nesting_gives_parent_ids():
    profiling.enable()
    with profiling.span("a") as a:
        with profiling.span("b") as b:
            with profiling.span("c") as c:
                pass
        with profiling.span("d") as d:
            pass
    loose = profiling.span("e", parent=b)
    with profiling.span("f") as f:
        pass
    loose.close()
    by = {s["name"]: s for s in profiling.spans()}
    assert by["a"]["parent"] is None
    assert by["b"]["parent"] == by["d"]["parent"] == a.id
    assert by["c"]["parent"] == b.id and by["e"]["parent"] == b.id
    # a bare span is not the thread's innermost: f is a root
    assert by["f"]["parent"] is None and f.id == by["f"]["id"]
    assert c.id != d.id


def test_one_request_shares_one_id():
    profiling.enable()
    with profiling.span("encode.submit") as sub:
        with profiling.span("encode.pad") as pad:
            pass
    with profiling.span("encode.harvest", request=sub.request) as har:
        with profiling.span("encode.read") as read:
            pass
    with profiling.span("synth.request") as other:
        pass
    assert sub.request == pad.request == har.request == read.request
    assert other.request != sub.request
    assert {s["request"] for s in profiling.spans()} == {sub.request,
                                                        other.request}


def test_self_time_on_a_scripted_clock(monkeypatch):
    ticks = iter([0, 100, 250, 400, 1000, 1300, 1600, 2000])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    profiling.enable()
    with profiling.span("outer"):            # 0 .. 2000
        with profiling.span("inner"):        # 100 .. 250
            pass
        with profiling.span("inner"):        # 400 .. 1000
            pass
        with profiling.span("other"):        # 1300 .. 1600
            pass
    rep = profiling.report()
    assert rep["inner"]["count"] == 2
    assert rep["inner"]["total_ms"] == pytest.approx(750 / 1e6)
    assert rep["other"]["total_ms"] == pytest.approx(300 / 1e6)
    assert rep["outer"]["total_ms"] == pytest.approx(2000 / 1e6)
    assert rep["outer"]["self_ms"] == pytest.approx((2000 - 750 - 300) / 1e6)
    assert rep["outer"]["device_ms"] == 0.0


def test_attributes_set_after_close():
    profiling.enable()
    with profiling.span("encode.loop", batch=8) as loop:
        pass
    loop.set(trips=23)
    (rec,) = profiling.spans()
    assert rec["attrs"] == {"batch": 8, "trips": 23}


def test_ring_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=3))
    profiling.enable()
    for i in range(5):
        with profiling.span(f"s{i}"):
            pass
    assert _names(profiling.spans()) == ["s2", "s3", "s4"]
    assert profiling.dropped() == 2


def test_threads_keep_their_own_trees():
    """Eight threads open nested spans at once, the interpreter switching
    often: every span is kept once, with its own thread's parent and
    request."""
    profiling.enable()
    per, n = 200, 8
    errors = []

    def worker(k):
        try:
            for _ in range(per):
                with profiling.span(f"outer{k}") as o:
                    with profiling.span(f"inner{k}") as i:
                        assert i.parent == o.id and i.request == o.request
        except AssertionError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    recs = profiling.spans()
    assert len(recs) == 2 * per * n == len({s["id"] for s in recs})
    by_id = {s["id"]: s for s in recs}
    for s in recs:
        if s["name"].startswith("inner"):
            outer = by_id[s["parent"]]
            assert outer["name"] == "outer" + s["name"][5:]
            assert outer["request"] == s["request"]
    assert len({s["request"] for s in recs}) == per * n


def test_take_reads_and_clears():
    profiling.enable()
    with profiling.span("a"):
        pass
    assert _names(profiling.take()) == ["a"]
    assert profiling.spans() == [] and profiling.dropped() == 0
    profiling.disable()
    assert profiling.span("a") is profiling.NOOP


def test_a_host_span_has_no_marks_or_parts():
    profiling.enable()
    with profiling.span("synth.launch", device="cpu") as launch:
        assert launch.marks(2) is None
    assert launch.parts(("p", "q"), None) == (profiling.NOOP,) * 2
    assert profiling.spans()[0]["device"] is None


def _rec(i, name, t0, t1, parent=None, d=None):
    return {"id": i, "parent": parent, "request": 1, "name": name,
            "start_ns": t0, "end_ns": t1, "device": 0 if d else None,
            "device_start_ns": d[0] if d else None,
            "device_end_ns": d[1] if d else None, "attrs": {}}


def test_report_puts_idle_gaps_on_the_host_span_open_when_they_end():
    ms = 1_000_000
    store = [
        _rec(1, "stream.request", 0, 100 * ms),
        _rec(2, "stream.decode", 1 * ms, 2 * ms, 1, (2 * ms, 30 * ms)),
        _rec(3, "stream.dones", 3 * ms, 31 * ms, 1),
        # the card idles from 30 to 40 ms: the host was in stream.emit
        _rec(4, "stream.emit", 39 * ms, 41 * ms, 1, (40 * ms, 50 * ms)),
        _rec(5, "stream.read", 41 * ms, 51 * ms, 1),
        # idle 50 .. 70 ms, ending inside decode (inside the request)
        _rec(6, "stream.decode", 69 * ms, 71 * ms, 1, (70 * ms, 90 * ms)),
        # a device part with no host extent, inside the decode's device span
        _rec(7, "synth.loop", 71 * ms, 71 * ms, 6, (75 * ms, 85 * ms)),
    ]
    rep = profiling.report(store)
    assert rep["stream.emit"]["idle_ms"] == pytest.approx(10.0)
    assert rep["stream.decode"]["idle_ms"] == pytest.approx(20.0)
    assert rep["stream.request"]["idle_ms"] == 0.0
    assert rep["stream.decode"]["device_ms"] == pytest.approx(48.0)
    assert rep["synth.loop"]["total_ms"] == 0.0
    assert rep["stream.request"]["self_ms"] == pytest.approx(
        100 - 1 - 28 - 2 - 10 - 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_report_idle_attribution_equals_a_scan_of_every_host_span(seed):
    """One walk over the host spans puts each gap where a scan of all of
    them does: the latest-begun host span open when the gap ended."""
    rng = np.random.default_rng(seed)
    store, i = [], 0
    for _ in range(300):
        i += 1
        t0 = int(rng.integers(0, 10_000))
        t1 = t0 + int(rng.integers(1, 400))
        dev = None
        if rng.random() < 0.4:
            d0 = int(rng.integers(0, 10_000))
            dev = (d0, d0 + int(rng.integers(1, 50)))
        store.append(_rec(i, f"n{i % 7}", t0, t1, None, dev))
    hosts = sorted(store, key=lambda s: s["start_ns"])
    want = {}
    reach = None
    for s in sorted((s for s in store if s["device_start_ns"] is not None),
                    key=lambda s: s["device_start_ns"]):
        t = s["device_start_ns"]
        if reach is not None and t > reach:
            inner = None
            for h in hosts:
                if h["start_ns"] <= t <= h["end_ns"]:
                    inner = h
            if inner is not None:
                want[inner["name"]] = want.get(inner["name"], 0) + t - reach
        reach = s["device_end_ns"] if reach is None else max(
            reach, s["device_end_ns"])
    rep = profiling.report(store)
    assert want
    for name, e in rep.items():
        assert e["idle_ms"] == pytest.approx(want.get(name, 0) / 1e6)


def _tiny():
    return JanusConfig().override(**{
        "asr.d_model": 64, "asr.encoder_layers": 1,
        "asr.decoder_layers": 1, "asr.num_heads": 4, "asr.n_mels": 16,
        "asr.vocab_size": 261, "asr.max_source_positions": 512,
        "asr.max_target_positions": 32, "asr.max_decode_tokens": 4,
        "tts.d_model": 64, "tts.layers": 2, "tts.num_heads": 4,
        "tts.n_mels": 16, "tts.max_text_tokens": 32,
        "tts.max_mel_frames": 32, "vocoder.d_model": 64,
        "vocoder.layers": 2, "vocoder.n_fft": 256, "vocoder.hop_length": 64,
        "vocoder.sample_rate": 24_000})


def _tree(recs):
    """``{name: [parent's name, ...]}`` and the requests of ``recs``."""
    by_id = {s["id"]: s for s in recs}
    tree = {}
    for s in recs:
        parent = by_id.get(s["parent"])
        tree.setdefault(s["name"], []).append(
            parent["name"] if parent else None)
    return tree, {s["request"] for s in recs}


@pytest.mark.parametrize("graphed", [False, True])
def test_encode_gives_one_tree_under_one_request(monkeypatch, graphed):
    if graphed:
        # the graph path on the CPU: the holder's steps run eagerly
        monkeypatch.setattr(codec, "use_graphs",
                            lambda device, eager=False: not eager)
    enc = SemanticEncoder(_tiny(), buckets=(24_000,), device="cpu")
    phrases = [np.zeros(9_000, np.float32), np.zeros(20_000, np.float32)]
    profiling.enable()
    pending = enc.encode_batch_submit(phrases)
    results = pending.result()
    recs = profiling.spans()
    assert len(results) == 2
    tree, requests = _tree(recs)
    assert len(requests) == 1
    assert tree == {"encode.submit": [None], "encode.pad": ["encode.submit"],
                    "encode.upload": ["encode.submit"],
                    "encode.front": ["encode.submit"],
                    "encode.loop": ["encode.submit"],
                    "encode.harvest": [None],
                    "encode.read": ["encode.harvest"],
                    "encode.detok": ["encode.harvest"]}
    by = {s["name"]: s for s in recs}
    assert by["encode.submit"]["attrs"] == {"batch": 2, "bucket": 24_000}
    if graphed:
        assert by["encode.loop"]["attrs"]["trips"] == \
            enc._graphs.loops()[0].trips_run


def test_synthesis_gives_one_tree_under_one_request():
    syn = Synthesizer(_tiny(), device="cpu")
    profiling.enable()
    pcm = syn.synthesize(JanusPacket(text="alpha"))
    tree, requests = _tree(profiling.spans())
    assert len(pcm) > 0 and len(requests) == 1
    assert tree == {"synth.request": [None],
                    "synth.launch": ["synth.request"]}


def test_stream_gives_one_tree_under_one_request(monkeypatch):
    monkeypatch.setattr(streaming_tts, "use_graphs",
                        lambda device, eager=False: not eager)
    cfg = _tiny()
    syn = Synthesizer(cfg, device="cpu")
    # never stops, four groups a chunk: every part of a chunk runs
    syn._streamer = StreamingSynthesizer(
        cfg, tts_params=syn.tts_params, vocoder_params=syn.vocoder_params,
        chunk_groups=4, stop_threshold=2.0, device="cpu")
    profiling.enable()
    chunks = list(syn.synthesize_streaming(JanusPacket(text="alpha bravo")))
    recs = profiling.spans()
    tree, requests = _tree(recs)
    assert len(requests) == 1 and len(chunks) >= 2
    assert set(tree) == {"stream.request", "stream.prefill", "stream.decode",
                         "stream.dones", "stream.emit", "stream.read"}
    assert tree["stream.request"] == [None]
    assert all(p == ["stream.request"] * len(p) for n, p in tree.items()
               if n != "stream.request")
    assert len(tree["stream.read"]) == len(chunks)
    steps = [s["attrs"]["steps"] for s in recs if s["name"] == "stream.decode"]
    assert sum(steps) == syn._streamer._graphs.steps > 0
