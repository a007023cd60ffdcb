"""The control plane in the port against the JAX package (after
``tests/test_api.py``, ``tests/test_dashboard.py`` and
``tests/test_server_engine.py``): the message schemas accept and reject
what the JAX package's pydantic models do, ``control_state`` serialises to
the same bytes, the multipart parser, the WebSocket accept key, the
dashboard and the verify endpoint agree; the port's ``JanusServer`` serves
health, CORS, the dashboard and the WebSocket control protocol on the CPU,
to ``chip_smoke.py``'s stdlib client and to the ``websockets`` client; and
the unified server's live duplex gives the JAX server's WebSocket events
and plays audio."""

import asyncio
import json
import time

import numpy as np
import pytest

import chip_smoke
import janus_tpu.api.endpoints as j_endpoints
import janus_tpu.api.http as j_http
import janus_tpu.api.socket_manager as j_socket
import janus_tpu.api.types as j_types
import janus_tpu.api.ws as j_ws
import janus_tpu.common.state as j_state
import janus_tpu_torch.api.endpoints as t_endpoints
import janus_tpu_torch.api.http as t_http
import janus_tpu_torch.api.socket_manager as t_socket
import janus_tpu_torch.api.types as t_types
import janus_tpu_torch.api.ws as t_ws
import janus_tpu_torch.common.state as t_state
from janus_tpu_torch.audio.io import StreamAudioService
from janus_tpu_torch.audio.synthetic import conversation, voiced_phrase
from janus_tpu_torch.audio.wav import write_wav
from janus_tpu_torch.common.config import JanusConfig, ServerConfig
from janus_tpu_torch.runtime.codec import SemanticEncoder

# -- message schemas -------------------------------------------------------

BOOLS = [True, False, 1, 0, 1.0, 0.0, 2, -1, 0.5, "true", "True", "TRUE",
         "yes", "on", "1", "off", "0", "f", "t", "n", "y", "no", "false",
         " true", "maybe", "", "1.0", "2", None, b"true", [], {}]
MODES = ["semantic", "text_only", "morse", "SEMANTIC", "x", " semantic",
         None, 1, b"semantic"]
EMOTIONS = ["auto", "relaxed", "panicked", "Auto", "calm", None]


def _outcome(cls, **kw):
    """The validated fields (enums by value), or "rejected"."""
    try:
        m = cls(**kw)
    except ValueError:  # pydantic's ValidationError is a ValueError
        return "rejected"
    return {k: getattr(v, "value", v) for k, v in m.model_dump().items()}


CONTROL_CASES = (
    [{"is_streaming": v} for v in BOOLS]
    + [{"is_recording": v} for v in BOOLS[:12]]
    + [{"mode": v} for v in MODES]
    + [{"emotion_override": v} for v in EMOTIONS]
    + [{"unknown": 1, "mode": "morse"}, {"type": "Control"},
       {"type": None}, {"type": b"control"}, {"type": "transcript"}, {}])


@pytest.mark.parametrize("fields", CONTROL_CASES, ids=repr)
def test_control_message_accepts_what_pydantic_accepts(fields):
    kw = {"type": "control", **fields}
    ours = _outcome(t_types.ControlMessage, **kw)
    assert ours == _outcome(j_types.ControlMessage, **kw)
    if fields in ({"is_streaming": 2}, {"is_streaming": "maybe"},
                  {"mode": "SEMANTIC"}, {"mode": "x"}):
        assert ours == "rejected"
    if fields in ({"is_streaming": v} for v in (1, 0, 1.0, "true", "yes",
                                               "on", "1", "off")):
        assert ours != "rejected"


@pytest.mark.parametrize("kw", [
    {"text": "hello", "start_ms": 3, "end_ms": 4.0, "avg_pitch_hz": 180,
     "avg_energy": "0.5"},
    {"text": "é ünïcode", "avg_pitch_hz": float("nan")},
    {"text": b"bytes", "end_ms": " 7"},
    {"text": 1}, {"text": None}, {}, {"text": "x", "start_ms": 1.5},
    {"text": "x", "type": "packet_summary"}], ids=repr)
def test_transcript_message_equals_pydantic(kw):
    ours = _outcome(t_types.TranscriptMessage, **kw)
    assert ours == _outcome(j_types.TranscriptMessage, **kw)
    if ours != "rejected":
        assert (t_types.TranscriptMessage(**kw).model_dump_json()
                == j_types.TranscriptMessage(**kw).model_dump_json())


@pytest.mark.parametrize("kw", [
    {"bytes": 59, "mode": "semantic", "created_at_ms": 1, "emotion": "Calm",
     "snippet": "hi"},
    {"bytes": "59", "mode": "morse", "created_at_ms": 2.0},
    {"bytes": 59, "mode": "MORSE", "created_at_ms": 1},
    {"bytes": 59.5, "mode": "semantic", "created_at_ms": 1},
    {"mode": "semantic", "created_at_ms": 1}], ids=repr)
def test_packet_summary_message_equals_pydantic(kw):
    ours = _outcome(t_types.PacketSummaryMessage, **kw)
    assert ours == _outcome(j_types.PacketSummaryMessage, **kw)
    if ours != "rejected":
        assert (t_types.PacketSummaryMessage(**kw).model_dump_json()
                == j_types.PacketSummaryMessage(**kw).model_dump_json())


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("recording", [False, True])
@pytest.mark.parametrize("mode,emotion", [("semantic", "auto"),
                                          ("text_only", "relaxed"),
                                          ("morse", "panicked")])
def test_control_state_json_byte_equal(streaming, recording, mode, emotion):
    states = (t_state.EngineState(), j_state.EngineState())
    for st in states:
        c = st.control
        c.is_streaming, c.is_recording = streaming, recording
        c.mode, c.emotion_override = mode, emotion
    ours = t_socket.control_state_message(states[0])
    assert ours == j_socket.control_state_message(states[1])
    assert json.loads(ours)["type"] == "control_state" and " " not in ours


def test_apply_control_message_equals_jax():
    msgs = [{"type": "control", "is_streaming": "on"},
            {"type": "control", "is_recording": 1, "mode": "morse"},
            {"type": "control", "emotion_override": "panicked"},
            {"type": "control", "is_streaming": None, "mode": "text_only"}]
    states = (t_state.EngineState(), j_state.EngineState())
    for msg in msgs:
        t_socket.apply_control_message(states[0],
                                       t_types.ControlMessage(**msg))
        j_socket.apply_control_message(states[1],
                                       j_types.ControlMessage(**msg))
        assert vars(states[0].control) == vars(states[1].control)


# -- HTTP, WebSocket framing, dashboard ------------------------------------

@pytest.mark.parametrize("payload", [b"plain", b"ends in crlf\r\n",
                                     bytes(range(256)) * 4, b""])
def test_parse_multipart_and_accept_key_agree(payload):
    boundary = "----WebKitFormBoundaryAbC123"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="note"\r\n\r\nhello\r\n'
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="audio_file"; filename="recording.webm"\r\n'
            f"Content-Type: audio/webm;codecs=opus\r\n\r\n").encode() \
        + payload + f"\r\n--{boundary}--\r\n".encode()
    for ctype in (f"multipart/form-data; boundary={boundary}",
                  f'multipart/form-data; boundary="{boundary}"'):
        ours = t_http.parse_multipart(body, ctype)
        assert ours == j_http.parse_multipart(body, ctype)
        assert ours["audio_file"] == ("recording.webm", payload)
    for m in (t_http, j_http):
        with pytest.raises(ValueError):
            m.parse_multipart(body, "multipart/form-data")
    for key in ("dGhlIHNhbXBsZSBub25jZQ==", "x3JJHMbDL1EzLkh9GBhXDw=="):
        assert t_ws.accept_key(key) == j_ws.accept_key(key)
    assert t_ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="  # RFC 6455 §1.3


def test_response_encoding_equals_jax():
    for m in (t_http, j_http):
        assert m.MAX_BODY_BYTES == t_http.MAX_BODY_BYTES
    for args in (({"status": "ok"},), ({"detail": "x"}, 404)):
        assert (t_http.Response.json(*args).encode()
                == j_http.Response.json(*args).encode())
    assert (t_http.Response.text("hi", 500).encode()
            == j_http.Response.text("hi", 500).encode())


def test_dashboard_html_equals_jax():
    from janus_tpu.api.dashboard import DASHBOARD_HTML as ref
    from janus_tpu_torch.api.dashboard import DASHBOARD_HTML

    assert DASHBOARD_HTML == ref


def _multipart_request(m, data: bytes, field="audio_file"):
    body, ctype = chip_smoke.multipart(field, "recording.wav", data,
                                       "audio/wav")
    return m.Request(method="POST", path="/api/voice/verify", query={},
                     headers={"content-type": ctype}, body=body)


PANGRAM = "The quick brown fox jumps over the lazy dog."


@pytest.mark.parametrize("heard", [
    PANGRAM, "the quick brown fox jumps over the lazy", "hello there",
    "  " + PANGRAM.upper() + " ", RuntimeError("decoder exploded"),
    "no multipart", "no file part"], ids=repr)
def test_verify_response_equals_jax(tmp_path, heard):
    """The same upload through each package's handler, with one injected
    transcriber: the same status, body, headers and saved file."""
    upload = b"RIFF fake upload bytes \r\n"
    results = []
    for name, m, ep in (("torch", t_http, t_endpoints),
                        ("jax", j_http, j_endpoints)):
        target = tmp_path / f"{name}.wav"

        def transcribe(path):
            with open(path, "rb") as f:
                assert f.read() == upload
            if isinstance(heard, Exception):
                raise heard
            return heard

        handler = ep.make_voice_verify_handler(transcribe, ServerConfig(),
                                               save_path=str(target))
        if heard == "no multipart":
            req = m.Request(method="POST", path="/api/voice/verify",
                            query={}, headers={"content-type": "text/plain"},
                            body=upload)
        elif heard == "no file part":
            req = m.Request(method="POST", path="/api/voice/verify",
                            query={}, headers={
                                "content-type": "multipart/form-data; "
                                                "boundary=xyz"},
                            body=b"--xyz--\r\n")
        else:
            req = _multipart_request(m, upload)
        r = asyncio.run(handler(req))
        results.append((r.status, r.body, r.headers,
                        target.read_bytes() if target.exists() else None))
    assert results[0] == results[1]
    status, body, _, saved = results[0]
    if heard == PANGRAM:
        assert json.loads(body)["status"] == "verified" and saved == upload
    if isinstance(heard, Exception):
        assert status == 200 and json.loads(body) == {
            "status": "failed", "transcript": "decoder exploded"}


# -- the port's server on the CPU ------------------------------------------

TINY = {  # the small random configuration of tests/test_api.py
    "server.port": 0,
    "asr.d_model": 64, "asr.encoder_layers": 1, "asr.decoder_layers": 1,
    "asr.num_heads": 4, "asr.n_mels": 16, "asr.vocab_size": 261,
    "asr.max_source_positions": 256, "asr.max_target_positions": 32,
    "asr.max_decode_tokens": 4,
    "tts.d_model": 32, "tts.layers": 1, "tts.num_heads": 4, "tts.n_mels": 16,
    "tts.max_mel_frames": 8,
    "vocoder.d_model": 32, "vocoder.layers": 1, "vocoder.n_fft": 256,
    "vocoder.hop_length": 64,
}


def tiny_overrides(tmp_ref, **extra):
    return {**TINY, "server.reference_audio_path": str(tmp_ref), **extra}


@pytest.fixture
def server(tmp_path):
    """The port's JanusServer, control plane only, on a free port."""
    from janus_tpu_torch.api.server import JanusServer

    cfg = JanusConfig().override(**tiny_overrides(tmp_path / "ref.wav"))
    srv = JanusServer(cfg, audio_service=StreamAudioService(),
                      encoder=SemanticEncoder(cfg, buckets=(48_000,),
                                              device="cpu"),
                      device="cpu")
    with chip_smoke.serving(srv, start_engine=False) as loop:
        srv.loop = loop
        yield srv


def _get(srv, path, method="GET"):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", srv.http.bound_port,
                                      timeout=30)
    try:
        conn.request(method, path)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def test_server_routes(server):
    assert chip_smoke.http_json(server.http.bound_port, "/api/health") == (
        200, {"status": "ok"})
    status, headers, _ = _get(server, "/api/health")
    assert headers["Access-Control-Allow-Origin"] == "*"
    assert _get(server, "/nope")[0] == 404
    assert _get(server, "/api/health", "OPTIONS")[0] == 204
    from janus_tpu_torch.api.dashboard import DASHBOARD_HTML

    for path in ("/", "/telemetry"):
        status, headers, body = _get(server, path)
        assert status == 200 and body == DASHBOARD_HTML.encode()
        assert headers["Content-Type"].startswith("text/html")


def test_server_voice_verify_flow(server, tmp_path, monkeypatch):
    """Untrained weights fail the pangram; a perfect transcription
    verifies and saves the upload verbatim (``tests/test_api.py``)."""
    wav = tmp_path / "up.wav"
    write_wav(str(wav), voiced_phrase(seconds=0.3), 48_000)
    body, ctype = chip_smoke.multipart("audio_file", "recording.wav",
                                       wav.read_bytes(), "audio/wav")
    port = server.http.bound_port
    status, resp = chip_smoke.http_json(port, "/api/voice/verify", body,
                                        ctype)
    assert status == 200 and resp["status"] == "failed"
    monkeypatch.setattr(server.encoder, "encode_batch", lambda phrases: [
        {"text": PANGRAM, "prosody": {"energy": "Normal", "pitch": "Normal"},
         "f0": 0.0, "rms": 0.0}])
    status, resp = chip_smoke.http_json(port, "/api/voice/verify", body,
                                        ctype)
    assert resp["status"] == "verified"
    assert (tmp_path / "ref.wav").read_bytes() == wav.read_bytes()


def test_transcribe_file_resamples_other_rates(server, tmp_path, monkeypatch):
    """A 44.1 kHz upload reaches the encoder at 48 kHz."""
    seen = []
    monkeypatch.setattr(server.encoder, "encode_batch", lambda phrases: (
        seen.append(len(phrases[0])), [{"text": "x"}])[1])
    path = tmp_path / "a.wav"
    write_wav(str(path), voiced_phrase(seconds=0.5, sample_rate=44_100),
              44_100)
    assert server.transcribe_file(str(path)) == "x"
    assert abs(seen[0] - 24_000) <= 1


@pytest.mark.parametrize("client", ["stdlib", "websockets"])
def test_websocket_control_roundtrip(server, client):
    port = server.http.bound_port
    if client == "stdlib":
        ws = chip_smoke.WsClient(port)
        send, recv = ws.send_json, ws.recv_json
    else:
        from websockets.sync.client import connect

        ws = connect(f"ws://127.0.0.1:{port}/ws/janus")
        send = lambda obj: ws.send(json.dumps(obj))  # noqa: E731
        recv = lambda timeout=5: json.loads(ws.recv(timeout=timeout))  # noqa: E731
    try:
        snap = recv()
        assert snap == {"type": "control_state", "is_streaming": False,
                        "is_recording": False, "mode": "semantic",
                        "emotion_override": "auto"}
        send({"type": "control", "is_streaming": True})
        assert recv()["is_streaming"] is True
        assert server.state.control.is_streaming is True
        if client == "websockets":
            ws.send("not json at all")  # logged and ignored
        send({"type": "control", "is_streaming": "maybe"})  # rejected
        send({"type": "control", "mode": "morse",
              "emotion_override": "panicked"})
        ack = recv()
        assert (ack["mode"], ack["emotion_override"], ack["is_streaming"]) \
            == ("morse", "panicked", True)
    finally:
        ws.close()
    # disconnect resets the transient flags; the mode persists
    for _ in range(50):
        if not server.state.control.is_streaming:
            break
        time.sleep(0.1)
    assert server.state.control.is_streaming is False
    assert server.state.control.mode == "morse"


def test_websocket_event_fanout(server):
    from janus_tpu_torch.runtime.engine import _emit_events

    ws = chip_smoke.WsClient(server.http.bound_port)
    try:
        ws.recv_json()
        asyncio.run_coroutine_threadsafe(_emit_events(
            server.state, text="wire check", mode="semantic",
            avg_pitch_hz=180.0, avg_energy=0.07, packet_bytes=61,
            emotion="relaxed"), server.loop).result(timeout=5)
        got = {m["type"]: m for m in (ws.recv_json(), ws.recv_json())}
    finally:
        ws.close()
    assert got["transcript"]["text"] == "wire check"
    assert got["packet_summary"]["bytes"] == 61


# -- the unified server's live duplex, against the JAX server --------------

def _duplex_events(make_server, mic):
    """Start ``make_server`` with the engine, open the WS, start
    streaming, collect events until both the sent and the received
    packet's summaries arrived and the speaker holds audio."""
    srv = make_server()
    with chip_smoke.serving(srv):
        ws = chip_smoke.WsClient(srv.http.bound_port)
        events = [ws.recv_json()]
        ws.send_json({"type": "control", "is_streaming": True})
        deadline = time.time() + 90
        try:
            while time.time() < deadline and not (
                    sum(e["type"] == "packet_summary" for e in events) >= 2
                    and mic.written_chunks):
                try:
                    events.append(ws.recv_json(timeout=1.0))
                except TimeoutError:
                    continue
        finally:
            ws.close()
    return events


def test_unified_backend_duplex_gives_the_jax_events(tmp_path):
    """Both servers, each fed the same real-time mic (lead silence, one
    spoken turn, silence) with the transcript fixed as in
    ``tests/test_server_engine.py``: the same WS event types, texts and
    packet sizes, and audio at the virtual speaker."""
    from janus_tpu.api.server import JanusServer as JServer
    from janus_tpu.audio.io import StreamAudioService as JStream
    from janus_tpu.common.config import JanusConfig as JConfig
    from janus_tpu.runtime.codec import SemanticEncoder as JEncoder
    from janus_tpu.runtime.synthesizer import Synthesizer as JSynthesizer
    from janus_tpu_torch.api.server import JanusServer
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    audio = np.concatenate([
        np.zeros(2 * 48_000, np.float32),
        conversation(turns=1, speech_seconds=1.5, silence_seconds=1.0,
                     amp=0.3)])

    def fixed_text(cls):
        class FixedText(cls):
            def encode_batch(self, phrases):
                out = super().encode_batch(phrases)
                for i, r in enumerate(out):
                    r["text"] = f"server test {i}"
                return out
        return FixedText

    runs = {}
    for name in ("torch", "jax"):
        port = chip_smoke.free_udp_port()
        extra = {"link.baud_rate": 48_000, "link.target_ip": "127.0.0.1",
                 "link.target_port": port, "link.receiver_port": port}
        overrides = tiny_overrides(tmp_path / f"{name}.wav", **extra)
        if name == "torch":
            cfg = JanusConfig().override(**overrides)
            mic = StreamAudioService(audio, realtime=True)
            enc = fixed_text(SemanticEncoder)(cfg, buckets=(48_000 * 4,),
                                              device="cpu")
            enc.warmup()
            syn = Synthesizer(cfg, device="cpu")
            make = lambda: JanusServer(cfg, audio_service=mic, encoder=enc,  # noqa: E731
                                       synthesizer=syn, device="cpu")
        else:
            jcfg = JConfig().override(**overrides)
            mic = JStream(audio, realtime=True)
            enc = fixed_text(JEncoder)(jcfg, buckets=(48_000 * 4,))
            enc.warmup()
            syn = JSynthesizer(jcfg)
            make = lambda: JServer(jcfg, audio_service=mic, encoder=enc,  # noqa: E731
                                   synthesizer=syn)
        events = _duplex_events(make, mic)
        runs[name] = (events, list(mic.written_chunks))

    def shape(events):
        return [(e["type"], e.get("text"), e.get("bytes"), e.get("mode"))
                for e in events if e["type"] != "control_state"]

    ours, ref = runs["torch"][0], runs["jax"][0]
    assert sorted(shape(ours), key=repr) == sorted(shape(ref), key=repr)
    assert [e["type"] for e in ours[:2]] == ["control_state"] * 2
    texts = [e["text"] for e in ours if e["type"] == "transcript"]
    assert texts == ["server test 0"] * 2  # the sent and the received
    assert runs["torch"][1] and runs["jax"][1]

