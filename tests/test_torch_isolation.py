"""The port stands alone: importing every module of ``janus_tpu_torch``
(and ``chip_smoke``) loads neither JAX nor the JAX package (nor optax or
orbax), nor pydantic or a WebSocket package, which the card's machine need
not have."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import janus_tpu_torch
names = ["janus_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(janus_tpu_torch.__path__,
                                          "janus_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.split(".")[0] in ("optax", "orbax")
             or m == "janus_tpu" or m.startswith("janus_tpu."))
third_party = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("pydantic", "pydantic_core",
                                            "websockets"))
print(json.dumps({"modules": names, "bad": bad, "third_party": third_party}))
"""

_TYPES_PROBE = r"""
import json, sys
import janus_tpu_torch.api.types
print(json.dumps(sorted(m for m in sys.modules if m.startswith("pydantic"))))
"""


def _probe(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_janus_tpu():
    res = _probe(_PROBE)
    assert res["bad"] == []
    assert res["third_party"] == []  # no pydantic, no websockets
    assert len(res["modules"]) >= 81
    for name in ("janus_tpu_torch.train.synthetic_task",
                 "janus_tpu_torch.train.losses",
                 "janus_tpu_torch.train.trainer",
                 "janus_tpu_torch.train.checkpoint",
                 "janus_tpu_torch.train.demo",
                 "janus_tpu_torch.train.retrain_demo",
                 "janus_tpu_torch.eval.metrics",
                 "janus_tpu_torch.eval.roundtrip",
                 "janus_tpu_torch.models.import_whisper",
                 "janus_tpu_torch.tools.encode_profile",
                 "janus_tpu_torch.tools.flagship_check",
                 "janus_tpu_torch.runtime.engine",
                 "janus_tpu_torch.tools.sender_main",
                 "janus_tpu_torch.tools.receiver_main",
                 "janus_tpu_torch.models.vad",
                 "janus_tpu_torch.runtime.sessions",
                 "janus_tpu_torch.api.server",
                 "janus_tpu_torch.native",
                 "janus_tpu_torch.audio.webm"):
        assert name in res["modules"]


def test_api_types_import_no_pydantic():
    assert _probe(_TYPES_PROBE) == []


def _entry_points():
    from janus_tpu_torch.api.server import JanusServer
    from janus_tpu_torch.models.vad import VoiceActivityDetector
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.sessions import SessionManager
    from janus_tpu_torch.runtime.streaming_tts import StreamingSynthesizer
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    return {"SemanticEncoder": SemanticEncoder, "Synthesizer": Synthesizer,
            "StreamingSynthesizer": StreamingSynthesizer,
            "VoiceActivityDetector": VoiceActivityDetector,
            "SessionManager": SessionManager, "JanusServer": JanusServer}


@pytest.mark.parametrize("entry", ["SemanticEncoder", "Synthesizer",
                                   "StreamingSynthesizer",
                                   "VoiceActivityDetector", "SessionManager",
                                   "JanusServer"])
def test_entry_point_needs_a_card_unless_cpu_asked(monkeypatch, entry):
    cls = _entry_points()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls()
    if entry == "VoiceActivityDetector":
        assert cls(device="cpu").device.type == "cpu"
    if entry == "SessionManager":
        from janus_tpu_torch.common.config import JanusConfig

        cfg = JanusConfig().override(**{
            "asr.d_model": 64, "asr.encoder_layers": 1,
            "asr.decoder_layers": 1, "asr.num_heads": 4, "asr.n_mels": 16,
            "asr.vocab_size": 261})
        assert cls(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ["train_demo_asr", "train_demo_tts",
                                   "train_demo_vocoder", "evaluate_asr",
                                   "train_vocoder", "profile_encode"])
def test_training_and_eval_entry_points_need_a_card(monkeypatch, entry):
    from janus_tpu_torch.common.config import ASRConfig, JanusConfig
    from janus_tpu_torch.models.tokenizer import ByteTokenizer
    from janus_tpu_torch.tools import encode_profile
    from janus_tpu_torch.train import demo, retrain_demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "train_demo_asr": lambda: demo.train_demo_asr(steps=1),
        "train_demo_tts": lambda: demo.train_demo_tts(steps=1),
        "train_demo_vocoder": lambda: demo.train_demo_vocoder(steps=1),
        "evaluate_asr": lambda: demo.evaluate_asr(
            {}, ASRConfig.demo(), ByteTokenizer()),
        "train_vocoder": lambda: retrain_demo.train_vocoder(1, 1),
        "profile_encode": lambda: encode_profile.profile_encode(
            {}, JanusConfig()),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


@pytest.mark.parametrize("loop", ["sender", "receiver"])
def test_cli_loops_build_their_models_on_the_card(monkeypatch, loop):
    """Given no encoder or synthesizer, ``main_loop`` and ``receive_loop``
    build them on the card, so without one they raise (and the CPU is
    taken only when asked for)."""
    from janus_tpu_torch.audio.io import StreamAudioService
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.runtime.link import PacketListener
    from janus_tpu_torch.tools.receiver_main import receive_loop
    from janus_tpu_torch.tools.sender_main import main_loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = JanusConfig()
    listener = PacketListener(0, timeout=0.05)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            if loop == "sender":
                main_loop(cfg, StreamAudioService())
            else:
                receive_loop(cfg, StreamAudioService(), listener=listener)
    finally:
        listener.close()
