"""The live duplex link in the port against the JAX package on the CPU:
the CLI pair (``sender_main.main_loop`` → localhost UDP →
``receiver_main.receive_loop``) and the engine's loops
(``smart_ear_loop``, ``receiver_loop``) under asyncio, fed the same
rendered stream through each package's demo bundle; the three-turn and
Morse runs of ``tests/test_e2e_local.py`` on its small random
configuration; and the playback ducking."""

import asyncio
import dataclasses
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import janus_tpu.audio.io as j_io
import janus_tpu.common.protocol as j_protocol
import janus_tpu.common.state as j_state
import janus_tpu.models.vad as j_vad
import janus_tpu.runtime.engine as j_engine
import janus_tpu.runtime.link as j_link
import janus_tpu.tools.receiver_main as j_rx
import janus_tpu.tools.sender_main as j_tx
from janus_tpu.models import zoo as j_zoo
from janus_tpu.runtime.codec import SemanticEncoder as JEncoder
from janus_tpu.runtime.synthesizer import Synthesizer as JSynthesizer
import janus_tpu_torch.audio.io as t_io
import janus_tpu_torch.common.protocol as t_protocol
import janus_tpu_torch.common.state as t_state
import janus_tpu_torch.models.vad as t_vad
import janus_tpu_torch.runtime.engine as t_engine
import janus_tpu_torch.runtime.link as t_link
import janus_tpu_torch.tools.receiver_main as t_rx
import janus_tpu_torch.tools.sender_main as t_tx
from janus_tpu_torch.audio.synthetic import conversation, render_text
from janus_tpu_torch.common.config import JanusConfig
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.models import zoo as t_zoo
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.runtime.synthesizer import Synthesizer

DEMO_TEXTS = ("alpha bravo", "fox golf hotel", "kilo lima")
PKG = {
    "jax": SimpleNamespace(io=j_io, protocol=j_protocol, state=j_state,
                           vad=j_vad, engine=j_engine, link=j_link, rx=j_rx,
                           tx=j_tx, vad_kw={}),
    "torch": SimpleNamespace(io=t_io, protocol=t_protocol, state=t_state,
                             vad=t_vad, engine=t_engine, link=t_link,
                             rx=t_rx, tx=t_tx, vad_kw={"device": "cpu"}),
}


def demo_stream() -> np.ndarray:
    """The three demo phrases, each followed by 1 s of silence."""
    parts = []
    for seed, text in enumerate(DEMO_TEXTS):
        parts += [render_text(text, 48_000, seed=seed),
                  np.zeros(48_000, np.float32)]
    return np.concatenate(parts)


def fast_link(cfg, port):
    """The fast link of ``tests/test_e2e_local.py``, and a capture queue
    that holds a whole stream: a capture faster than real time must not
    drop a chunk while the loop encodes (that would change the phrases)."""
    return cfg.override(**{"link.baud_rate": 48_000,
                           "link.target_ip": "127.0.0.1",
                           "link.target_port": port,
                           "link.receiver_port": port,
                           "runtime.audio_queue_depth": 1_000})


def _pcm(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32767.0


def _recording_listener(m):
    """The package's ``PacketListener``, keeping every payload it returns."""
    class Recording(m.link.PacketListener):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.payloads = []

        def receive(self):
            payload = super().receive()
            if payload is not None:
                self.payloads.append(payload)
            return payload

    return Recording(0, use_tcp=False, timeout=0.2)


def run_cli_duplex(m, cfg, encoder, synth, audio, mode="semantic",
                   rx_idle=60.0):
    """``main_loop`` → UDP → ``receive_loop`` in a second thread; the
    receiver is stopped once it has played what was sent. Its idle exit
    is only a backstop against a hang: its clock starts with the thread,
    and on a loaded CPU the first encode can take longer than the few
    seconds of ``tests/test_e2e_local.py``. Returns (sent, played,
    payloads, played chunks)."""
    listener = _recording_listener(m)
    cfg = fast_link(cfg, listener.port)
    mic, speaker = m.io.StreamAudioService(audio), m.io.StreamAudioService()
    stop_rx = threading.Event()
    played = []
    rx = threading.Thread(target=lambda: played.append(m.rx.receive_loop(
        cfg, speaker, synthesizer=synth, listener=listener,
        stop_event=stop_rx, max_idle_seconds=rx_idle)), daemon=True)
    rx.start()
    vad = m.vad.VoiceActivityDetector(cfg.vad, sample_rate=48_000,
                                      **m.vad_kw)
    sent = m.tx.main_loop(cfg, mic, encoder=encoder, vad=vad,
                          link=m.link.LinkSimulator(cfg.link), mode=mode,
                          max_idle_seconds=2.0)
    deadline = time.monotonic() + 60
    while (len(speaker.written_chunks) < sent and rx.is_alive()
           and time.monotonic() < deadline):
        time.sleep(0.05)
    stop_rx.set()
    rx.join(timeout=60)
    assert not rx.is_alive()
    return sent, played[0], listener.payloads, list(speaker.written_chunks)


@pytest.fixture(scope="module")
def demo():
    """Both packages' demo bundles, warmed up (the JAX package compiles its
    programs on first use)."""
    jb = j_zoo.load_demo(base=None)
    tb = t_zoo.load_demo(base=JanusConfig())
    jenc = JEncoder(jb.config, asr_params=jb.asr_params, buckets=(96_000,))
    tenc = SemanticEncoder(tb.config, asr_params=tb.asr_params,
                           buckets=(96_000,), device="cpu")
    jsyn = JSynthesizer(jb.config, tts_params=jb.tts_params,
                        vocoder_params=jb.vocoder_params,
                        speaker_params=jb.speaker_params,
                        default_speaker_vec=jb.default_speaker_vec)
    tsyn = Synthesizer(tb.config, tts_params=tb.tts_params,
                       vocoder_params=tb.vocoder_params,
                       speaker_params=tb.speaker_params,
                       default_speaker_vec=tb.default_speaker_vec,
                       device="cpu")
    for enc in (jenc, tenc):
        enc.warmup()
    jsyn.synthesize(j_protocol.JanusPacket(text="warm up now"))
    return {"jax": (jb.config, jenc, jsyn), "torch": (tb.config, tenc, tsyn)}


def _without_time(m, payload) -> bytes:
    pkt = m.protocol.JanusPacket.deserialize(payload)
    return dataclasses.replace(pkt, timestamp=1.0).serialize()


def test_demo_duplex_equals_jax(demo):
    audio = demo_stream()
    runs = {name: run_cli_duplex(PKG[name], *demo[name], audio)
            for name in ("jax", "torch")}
    (sent, played, payloads, chunks) = runs["torch"]
    (j_sent, j_played, j_payloads, j_chunks) = runs["jax"]
    assert sent == j_sent == 3 and played == j_played == 3
    assert ([_without_time(PKG["torch"], p) for p in payloads]
            == [_without_time(PKG["jax"], p) for p in j_payloads])
    assert [JanusPacket.deserialize(p).text for p in payloads][0]
    assert len(chunks) == len(j_chunks) == 3
    for got, ref in zip(chunks, j_chunks):
        assert len(got) == len(ref) > 0
        assert np.abs(_pcm(got) - _pcm(ref)).max() <= 1e-3


def run_engine_loops(m, cfg, encoder, synth, audio, n_packets=3):
    """``smart_ear_loop`` under asyncio and ``receiver_loop`` in a thread,
    each with its own ``EngineState``; returns both states' events."""
    listener = m.link.PacketListener(0, use_tcp=False, timeout=0.2)
    cfg = fast_link(cfg, listener.port)
    mic, speaker = m.io.StreamAudioService(audio), m.io.StreamAudioService()
    tx_state, rx_state = m.state.EngineState(), m.state.EngineState()
    tx_state.control.is_streaming = True
    vad = m.vad.VoiceActivityDetector(cfg.vad, sample_rate=48_000,
                                      **m.vad_kw)
    link = m.link.LinkSimulator(cfg.link)
    stop = threading.Event()

    async def main():
        loop = asyncio.get_running_loop()
        rx = threading.Thread(target=m.engine.receiver_loop, args=(
            speaker, rx_state, synth, listener, stop, loop, cfg), daemon=True)
        rx.start()
        tx = asyncio.create_task(m.engine.smart_ear_loop(
            mic, tx_state, encoder, vad, link, stop, cfg))
        deadline = loop.time() + 90
        while loop.time() < deadline and not tx.done() and (
                tx_state.packet_queue().qsize() < n_packets
                or rx_state.packet_queue().qsize() < n_packets):
            await asyncio.sleep(0.05)
        stop.set()
        await tx
        await loop.run_in_executor(None, rx.join, 60)
        await asyncio.sleep(0.1)  # events the receiver posted last

        def drain(q):
            out = []
            while not q.empty():
                out.append(q.get_nowait())
            return out

        return [(drain(s.transcript_queue()), drain(s.packet_queue()))
                for s in (tx_state, rx_state)]

    try:
        return asyncio.run(main()), speaker.written_chunks
    finally:
        link.close()
        listener.close()


TIME_FIELDS = ("end_ms", "created_at_ms")
CLOSE_FIELDS = {"avg_pitch_hz": 1e-2, "avg_energy": 1e-6}


def _same_events(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in g:
            if k in TIME_FIELDS:
                assert isinstance(g[k], int)
            elif k in CLOSE_FIELDS and r[k] is not None:
                assert abs(g[k] - r[k]) <= CLOSE_FIELDS[k], (k, g[k], r[k])
            else:
                assert g[k] == r[k], (k, g[k], r[k])


def test_engine_loops_emit_the_jax_events(demo):
    audio = demo_stream()
    (ours, chunks) = run_engine_loops(PKG["torch"], *demo["torch"], audio)
    (ref, j_chunks) = run_engine_loops(PKG["jax"], *demo["jax"], audio)
    for side in range(2):          # sender, receiver
        for kind in range(2):      # transcripts, packet summaries
            _same_events(ours[side][kind], ref[side][kind])
    assert [e["snippet"] for e in ours[0][1]] == [
        e["snippet"] for e in ours[1][1]]
    assert chunks and all(chunks)  # streaming playback reached the speaker


@pytest.mark.parametrize("talking,enabled,level", [
    (True, True, 0.25), (True, True, 0.7), (False, True, 0.25),
    (True, False, 0.25)])
def test_ducking_bit_equal(talking, enabled, level):
    pcm = np.random.default_rng(4).integers(-32768, 32767, 4096,
                                            dtype=np.int16).tobytes()
    out = []
    for m in (PKG["torch"], PKG["jax"]):
        state = m.state.EngineState()
        state.control.is_talking = talking
        state.control.ducking_enabled = enabled
        state.control.ducking_level = level
        out.append(m.engine.apply_ducking_if_needed(pcm, state))
        assert m.engine.apply_ducking_if_needed(b"", state) == b""
    assert out[0] == out[1]
    assert (out[0] == pcm) == (not (talking and enabled))


# -- the small random configuration of tests/test_e2e_local.py --------------

def e2e_cfg(port=0, baud=48_000):
    return JanusConfig().override(**{
        "link.baud_rate": baud,
        "link.target_ip": "127.0.0.1",
        "link.target_port": port,
        "link.receiver_port": port,
        "asr.d_model": 64, "asr.encoder_layers": 1, "asr.decoder_layers": 1,
        "asr.num_heads": 4, "asr.n_mels": 16, "asr.vocab_size": 261,
        "asr.max_source_positions": 512, "asr.max_target_positions": 32,
        "asr.max_decode_tokens": 4,
        "tts.d_model": 32, "tts.layers": 1, "tts.num_heads": 4,
        "tts.n_mels": 16, "tts.max_mel_frames": 16,
        "vocoder.d_model": 32, "vocoder.layers": 1, "vocoder.n_fft": 256,
        "vocoder.hop_length": 64,
    })


class FixedTextEncoder(SemanticEncoder):
    """The whole encode, with a fixed transcript (random weights give
    none)."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        self.counter = 0

    def encode_batch(self, phrases):
        out = super().encode_batch(phrases)
        for r in out:
            self.counter += 1
            r["text"] = f"test message {self.counter}"
        return out


@pytest.fixture(scope="module")
def small():
    cfg = e2e_cfg()
    encoder = FixedTextEncoder(cfg, buckets=(48_000 * 4,), device="cpu")
    encoder.warmup()
    return cfg, encoder, Synthesizer(cfg, device="cpu")


def test_full_duplex_three_turns_over_udp(small):
    """Three speech turns give three packets sent, synthesized and played:
    no deadlock after the first turn."""
    cfg, encoder, synth = small
    audio = conversation(turns=3, speech_seconds=2.0, silence_seconds=1.0,
                         amp=0.3)
    first = encoder.counter
    sent, played, payloads, chunks = run_cli_duplex(
        PKG["torch"], cfg, encoder, synth, audio)
    assert sent == 3 and played == 3
    assert [JanusPacket.deserialize(p).text for p in payloads] == [
        f"test message {first + i}" for i in (1, 2, 3)]
    assert len(chunks) == 3 and all(len(c) > 0 for c in chunks)


def test_morse_mode_end_to_end(small):
    cfg, encoder, synth = small
    audio = conversation(turns=1, speech_seconds=1.0, silence_seconds=1.0,
                         amp=0.3)
    sent, played, payloads, chunks = run_cli_duplex(
        PKG["torch"], cfg, encoder, synth, audio, mode="morse")
    assert sent >= 1 and played == sent
    assert all(JanusPacket.deserialize(p).mode.name == "MORSE_CODE"
               for p in payloads)
    pcm = _pcm(b"".join(chunks))
    assert len(pcm) > 48_000 and np.abs(pcm).max() > 0.4


def test_corrupt_packet_skipped_not_fatal(small):
    cfg, _, synth = small
    listener = t_link.PacketListener(0, use_tcp=False, timeout=0.2)
    speaker = t_io.StreamAudioService()
    played = []
    rx = threading.Thread(target=lambda: played.append(t_rx.receive_loop(
        fast_link(cfg, listener.port), speaker, synthesizer=synth,
        listener=listener, max_idle_seconds=2.0)), daemon=True)
    rx.start()
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.sendto(b"\xff\xfe garbage not msgpack", ("127.0.0.1", listener.port))
    s.sendto(JanusPacket(text="after garbage", prosody={
        "energy": "Normal", "pitch": "Normal"}).serialize(),
        ("127.0.0.1", listener.port))
    s.close()
    rx.join(timeout=30)
    assert played == [1]


def test_streaming_playback_reaches_the_speaker(small):
    """``receiver_loop`` with streaming playback (the default) and with
    whole-packet playback."""
    cfg, _, synth = small
    for streaming in (True, False):
        c = cfg.override(**{"runtime.streaming_playback": streaming})
        listener = t_link.PacketListener(0, use_tcp=False, timeout=0.2)
        speaker, state = t_io.StreamAudioService(), t_state.EngineState()
        stop = threading.Event()
        rx = threading.Thread(target=t_engine.receiver_loop, args=(
            speaker, state, synth, listener, stop, None, c), daemon=True)
        rx.start()
        link = t_link.LinkSimulator(fast_link(c, listener.port).link)
        link.transmit(JanusPacket(text="hello there").serialize())
        deadline = time.monotonic() + 30
        while not speaker.written_chunks and time.monotonic() < deadline:
            time.sleep(0.05)
        stop.set()
        rx.join(timeout=30)
        link.close()
        listener.close()
        assert speaker.written_chunks and not rx.is_alive()
