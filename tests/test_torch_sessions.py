"""The batched multi-session runtime in the port against the JAX package
(after ``tests/test_sessions.py``): the same four capture streams, fed one
32 ms chunk per session per tick into each package's ``SessionManager``
over its demo bundle, give byte-equal packets (timestamps fixed) in the
same order, synchronous and overlapped, across a snapshot and restore,
and under the learned VAD with the JAX package's ``init_vad`` weights.
On a tiny random configuration (as there): failures isolated per session
at dispatch and at completion, no audio lost during snapshots, harvest
deferred while an encode is in flight, and the lifecycle."""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

import janus_tpu.runtime.sessions as j_sessions
from janus_tpu.models import vad as j_vad
from janus_tpu.models import zoo as j_zoo
from janus_tpu.runtime.codec import SemanticEncoder as JEncoder
from janus_tpu_torch.audio.synthetic import conversation, render_text
from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.models import zoo as t_zoo
from janus_tpu_torch.models.params import params_from_jax
from janus_tpu_torch.runtime import sessions as t_sessions
from janus_tpu_torch.runtime.codec import PendingEncode, SemanticEncoder

CHUNK = 1536
MODES = {"sync": {"runtime.max_inflight_encodes": 0,
                  "runtime.pipelined_vad": False},
         "overlapped": {"runtime.max_inflight_encodes": 2,
                        "runtime.pipelined_vad": True}}


def session_streams() -> dict:
    """Four sessions: s0 and s1 end their phrase on the same tick (one
    batch of two), s2 and s3 on ticks of their own."""
    a = render_text("alpha bravo", 48_000, seed=0)
    silence = np.zeros(48_000, np.float32)
    return {
        "s0": np.concatenate([a, silence]),
        "s1": np.concatenate([0.6 * a, silence]),
        "s2": np.concatenate([render_text("fox golf hotel", 48_000, seed=1),
                              silence]),
        "s3": np.concatenate([np.zeros(24_000, np.float32),
                              render_text("kilo lima", 48_000, seed=2),
                              silence]),
    }


def fixed(pkt) -> bytes:
    return dataclasses.replace(pkt, timestamp=1.0).serialize()


def drive(manager, streams, snapshot_at=None, make_manager=None):
    """Push one chunk per session, then tick, until every stream is in;
    then flush. ``snapshot_at`` snapshots there, round-trips the snapshot
    through JSON and restores it into ``make_manager()``. Returns
    ``[(session, packet bytes)]`` in harvest order and the manager."""
    out = []
    for sid in streams:
        manager.add_session(sid)
    n_ticks = max(-(-len(a) // CHUNK) for a in streams.values())
    for k in range(n_ticks):
        if k == snapshot_at:
            snap = json.loads(json.dumps(manager.snapshot()))
            manager = make_manager()
            manager.restore(snap)
        for sid, audio in streams.items():
            piece = audio[k * CHUNK:(k + 1) * CHUNK]
            if len(piece):
                assert manager.push_audio(sid, piece)
        out += manager.tick()
    # the ring's last partial chunk stays buffered, as in the JAX package
    out += manager.flush()
    return [(sid, fixed(p)) for sid, p in out], manager


@pytest.fixture(scope="module")
def demo():
    """Each package's demo encoder, warmed up at batch 1 and 2 (the JAX
    package compiles a program per batch shape)."""
    jb = j_zoo.load_demo(base=None)
    tb = t_zoo.load_demo(base=JanusConfig())
    jenc = JEncoder(jb.config, asr_params=jb.asr_params, buckets=(96_000,))
    tenc = SemanticEncoder(tb.config, asr_params=tb.asr_params,
                           buckets=(96_000,), device="cpu")
    for enc in (jenc, tenc):
        for b in (1, 2):
            enc.encode_batch([np.zeros(96_000, np.float32)] * b)
    return {"jax": (jb.config, jenc), "torch": (tb.config, tenc)}


def _managers(demo, overrides, vad_params=None):
    """Factories of each package's manager over its demo encoder."""
    (jcfg, jenc), (tcfg, tenc) = demo["jax"], demo["torch"]
    jcfg, tcfg = jcfg.override(**overrides), tcfg.override(**overrides)
    jvad = tvad = None
    if vad_params is not None:
        jvad, tvad = vad_params, params_from_jax(vad_params)
    return (lambda: j_sessions.SessionManager(jcfg, encoder=jenc,
                                              vad_params=jvad),
            lambda: t_sessions.SessionManager(tcfg, encoder=tenc,
                                              vad_params=tvad))


@pytest.mark.parametrize("mode", ["sync", "overlapped"])
def test_packets_equal_jax(demo, mode, monkeypatch):
    overrides = {**MODES[mode], "vad.backend": "energy"}
    make_j, make_t = _managers(demo, overrides)
    streams = session_streams()
    tenc, sizes = demo["torch"][1], []
    submit = type(tenc).encode_batch_submit
    monkeypatch.setattr(tenc, "encode_batch_submit", lambda phrases: (
        sizes.append(len(phrases)), submit(tenc, phrases))[1])
    ours, manager = drive(make_t(), streams)
    ref, _ = drive(make_j(), streams)
    assert ours == ref
    assert sorted(sizes) == [1, 1, 2]  # s0 and s1 share one batch
    assert sorted(sid for sid, _ in ours) == ["s0", "s1", "s2", "s3"]
    stats = manager.stats()
    assert all(st["phrases_encoded"] == 1 and st["packets"] == 1
               for st in stats.values())
    assert manager.inflight_encodes == 0 and manager.device.type == "cpu"


def test_snapshot_restore_mid_phrase_gives_the_same_packets(demo):
    """A snapshot taken mid-phrase (tick 20: s0's phrase has begun),
    serialised and restored into a fresh manager, gives the packets of the
    run without it, as the JAX package does."""
    overrides = {**MODES["overlapped"], "vad.backend": "energy"}
    make_j, make_t = _managers(demo, overrides)
    streams = session_streams()
    ours, _ = drive(make_t(), streams, snapshot_at=20, make_manager=make_t)
    ref, _ = drive(make_j(), streams, snapshot_at=20, make_manager=make_j)
    plain, _ = drive(make_t(), streams)
    assert ours == ref == plain


def test_model_vad_equals_jax(demo):
    """The learned gate under ``vad.backend == "model"``, with the JAX
    package's ``init_vad(0)`` weights converted: the batched scores within
    the 1e-5 of ``tests/test_torch_vad_segmenter.py``, then the packets."""
    jp = j_vad.init_vad(0)
    make_j, make_t = _managers(demo, MODES["overlapped"], vad_params=jp)
    tm, jm = make_t(), make_j()
    assert tm._use_model_vad and jm._use_model_vad
    streams = session_streams()
    chunks = [a[40 * CHUNK:41 * CHUNK] for a in streams.values()]
    for s in ("a", "b", "c", "d"):
        for m in (tm, jm):
            m.add_session(s)
    got = [a.numpy() for a in tm._dispatch_vad(chunks, list(tm.sessions.values()))]
    ref = [np.asarray(a) for a in jm._dispatch_vad(chunks, list(jm.sessions.values()))]
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], ref[1])
    ours, _ = drive(make_t(), streams)
    theirs, _ = drive(make_j(), streams)
    assert ours == theirs and len(ours) == 4


def test_energy_vad_dispatch_equals_jax(demo):
    """The batched energy gate's probabilities and floors, on chunks of
    speech and silence from floors that differ by session."""
    make_j, make_t = _managers(demo, {"vad.backend": "energy"})
    tm, jm = make_t(), make_j()
    streams = session_streams()
    chunks = [a[k * CHUNK:(k + 1) * CHUNK]
              for k, a in zip((3, 10, 40, 60), streams.values())]
    for m in (tm, jm):
        for i, s in enumerate("abcd"):
            m.add_session(s).vad_floor = float(np.float32(10.0 ** -(i + 1)))
    got = [a.numpy() for a in tm._dispatch_vad(chunks, list(tm.sessions.values()))]
    ref = [np.asarray(a) for a in jm._dispatch_vad(chunks, list(jm.sessions.values()))]
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)


# -- a tiny random configuration, as tests/test_sessions.py ----------------

def tiny_cfg():
    return JanusConfig().override(**{
        "asr.d_model": 64, "asr.encoder_layers": 1, "asr.decoder_layers": 1,
        "asr.num_heads": 4, "asr.n_mels": 16, "asr.vocab_size": 261,
        "asr.max_source_positions": 512, "asr.max_target_positions": 32,
        "asr.max_decode_tokens": 4,
    })


class FixedText(SemanticEncoder):
    # _finalize is the host-decode hook shared by the sync and the
    # submit paths, so the fixed text applies to both
    def _finalize(self, arrays, b_real):
        out = super()._finalize(arrays, b_real)
        for i, r in enumerate(out):
            r["text"] = f"phrase {i}"
        return out


@pytest.fixture(scope="module")
def manager():
    cfg = tiny_cfg()
    return t_sessions.SessionManager(
        cfg, encoder=FixedText(cfg, buckets=(48_000 * 4,), device="cpu"))


def test_sessions_lifecycle(manager):
    s = manager.add_session("a")
    assert s.session_id == "a" and s.ring.native
    with pytest.raises(KeyError):
        manager.add_session("a")
    manager.remove_session("a")
    assert "a" not in manager.sessions


def test_session_limit():
    cfg = tiny_cfg().override(**{"runtime.max_sessions": 2})
    m = t_sessions.SessionManager(
        cfg, encoder=FixedText(cfg, buckets=(48_000,), device="cpu"))
    m.add_session("a")
    m.add_session("b")
    with pytest.raises(RuntimeError, match="session limit"):
        m.add_session("c")


def _run_isolation_case(manager, monkeypatch, poison_at):
    """One poisoned session must not take down the others' packets."""
    manager.add_session("good")
    manager.add_session("bad")
    for sid in ("good", "bad"):
        manager.push_audio(sid, conversation(turns=1, speech_seconds=1.0,
                                             silence_seconds=1.0, amp=0.3))

    real_submit = type(manager.encoder).encode_batch_submit
    single_calls = []

    class ExplodingPending(PendingEncode):
        def __init__(self):
            pass

        def is_ready(self):
            return True

        def result(self):
            raise RuntimeError("batched encode crashed at completion")

    def submit_hook(phrases):
        if len(phrases) > 1:
            if poison_at == "dispatch":
                raise RuntimeError("batched encode crashed at dispatch")
            return ExplodingPending()
        # per-phrase retries run in session order: poison the second one
        single_calls.append(len(phrases))
        if len(single_calls) == 2:
            raise RuntimeError("poisoned phrase")
        return real_submit(manager.encoder, phrases)

    monkeypatch.setattr(manager.encoder, "encode_batch_submit", submit_hook)
    packets = []
    for _ in range(80):
        packets.extend(manager.tick())
    packets.extend(manager.flush())
    sids = {sid for sid, _ in packets}
    assert "good" in sids  # survivor unaffected
    assert "bad" not in sids  # poisoned session degraded alone
    assert len(single_calls) >= 2  # fallback path actually exercised
    manager.remove_session("good")
    manager.remove_session("bad")


@pytest.mark.parametrize("poison_at", ["dispatch", "completion"])
def test_failure_isolation(manager, monkeypatch, caplog, poison_at):
    with caplog.at_level("ERROR", logger="janus_tpu_torch.runtime.sessions"):
        _run_isolation_case(manager, monkeypatch, poison_at)
    assert any("isolating" in r.getMessage() for r in caplog.records)


def test_capture_during_snapshot_loses_nothing(manager):
    """A capture thread pushing on a tight cadence across repeated
    snapshots loses no sample and keeps the order."""
    manager.add_session("snapper")
    s = manager.sessions["snapper"]
    accepted = []
    stop = threading.Event()

    def pusher():
        i = 0
        while not stop.is_set():
            chunk = np.full(192, float(i % 997), dtype=np.float32)
            if manager.push_audio("snapper", chunk):
                accepted.append(chunk)
            i += 1
            time.sleep(0.0005)

    t = threading.Thread(target=pusher)
    t.start()
    try:
        for _ in range(50):
            manager.snapshot()
        time.sleep(0.01)
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()
    drained = s.ring.pop(len(s.ring))
    assert drained is not None
    np.testing.assert_array_equal(drained, np.concatenate(accepted))
    assert not s.paused and not s.spill
    manager.remove_session("snapper")


def test_overlap_defers_harvest_until_device_done(manager, monkeypatch):
    """tick() does not block on an unfinished encode: the packet appears
    on a later tick once the handle reports done, and flush() drains."""
    manager.add_session("ov")
    manager.push_audio("ov", conversation(turns=1, speech_seconds=1.0,
                                          silence_seconds=1.0, amp=0.3))
    real_submit = type(manager.encoder).encode_batch_submit

    class SlowPending:
        def __init__(self, inner, not_ready_polls=3):
            self.inner = inner
            self.polls_left = not_ready_polls

        def is_ready(self):
            if self.polls_left > 0:
                self.polls_left -= 1
                return False
            return True

        def result(self):
            return self.inner.result()

    submitted = []

    def submit_hook(phrases):
        p = SlowPending(real_submit(manager.encoder, phrases))
        submitted.append(p)
        return p

    monkeypatch.setattr(manager.encoder, "encode_batch_submit", submit_hook)
    packets, dispatch_tick, harvest_tick = [], None, None
    for k in range(200):
        got = manager.tick()
        packets.extend(got)
        if submitted and dispatch_tick is None:
            dispatch_tick = k
        if got and harvest_tick is None:
            harvest_tick = k
            break
    assert dispatch_tick is not None and harvest_tick > dispatch_tick
    assert manager.inflight_encodes == 0
    assert packets and packets[0][0] == "ov"
    assert manager.flush() == []
    manager.remove_session("ov")


def test_dispatch_vad_stays_on_the_device_without_grad(manager):
    """The VAD pass returns tensors on the encoder's device (no host read)
    and records no autograd graph, from any thread."""
    manager.add_session("g")
    out = []
    with torch.enable_grad():
        th = threading.Thread(target=lambda: out.append(manager._dispatch_vad(
            [np.ones(CHUNK, np.float32)], [manager.sessions["g"]])))
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    probs, floors = out[0]
    assert isinstance(probs, torch.Tensor) and probs.device == manager.device
    assert not probs.requires_grad and tuple(floors.shape) == (1,)
    manager.remove_session("g")
