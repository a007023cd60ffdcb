"""The port stands alone: importing every module of ``janus_tpu_torch``
(and ``chip_smoke``) loads neither JAX nor the JAX package."""

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
             or m == "janus_tpu" or m.startswith("janus_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_janus_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert len(res["modules"]) >= 38


@pytest.mark.parametrize("entry", ["SemanticEncoder", "Synthesizer",
                                   "StreamingSynthesizer"])
def test_entry_point_needs_a_card_unless_cpu_asked(monkeypatch, entry):
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.streaming_tts import StreamingSynthesizer
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        {"SemanticEncoder": SemanticEncoder, "Synthesizer": Synthesizer,
         "StreamingSynthesizer": StreamingSynthesizer}[entry]()
