"""The benchmark's plain references against the program at tiny widths on
the CPU (both in float32 there, so they agree to rounding), and the
isolation of the references and the harness from JAX and, for the
references, from the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import weights as W
from portbench.reference import dsp, tts as rtts, whisper as rwhisper

ROOT = Path(__file__).resolve().parents[2]

TINY_ASR = {"n_mels": 80, "d_model": 64, "encoder_layers": 2,
            "decoder_layers": 2, "num_heads": 4, "mlp_ratio": 4,
            "vocab_size": 261, "max_target_positions": 48}
TINY_TTS = {"d_model": 64, "layers": 2, "num_heads": 4, "mlp_ratio": 4,
            "n_mels": 80, "reduction": 4, "max_text_tokens": 256,
            "max_mel_frames": 64}
TINY_VOC = {"n_fft": 1024, "hop_length": 256, "d_model": 32, "layers": 2,
            "sample_rate": 24_000}


def _phrases(n: int, seconds: float) -> list:
    rng = np.random.default_rng(3)
    t = np.arange(int(seconds * 48_000)) / 48_000
    out = []
    for i in range(n):
        f0 = 100.0 + 60.0 * i
        x = sum((0.1 / h) * np.sin(2 * np.pi * h * f0 * t) for h in (1, 2, 3))
        out.append((x + 0.002 * rng.standard_normal(len(t))).astype(np.float32))
    return out


def test_front_and_decode_match_the_program():
    from janus_tpu_torch.common.config import ASRConfig, JanusConfig
    from janus_tpu_torch.runtime.codec import SemanticEncoder

    acfg = ASRConfig(**{k: TINY_ASR[k] for k in TINY_ASR if k != "mlp_ratio"},
                     max_decode_tokens=6, dtype="float32")
    cfg = JanusConfig().override(asr=acfg)
    tree = W.make_tree(W.asr_leaves(TINY_ASR), 5, "cpu", torch.float32)
    enc = SemanticEncoder(cfg, asr_params=tree, buckets=(96_000,),
                          device="cpu")
    phrases = _phrases(2, 1.0)
    pending = enc.encode_batch_submit(phrases)
    tokens, e_code, p_code, f0, rms = (a.numpy() for a in pending._arrays)

    audio = np.zeros((2, 96_000), np.float32)
    for i, p in enumerate(phrases):
        audio[i, :len(p)] = p
    n_valid = torch.tensor([len(p) for p in phrases])
    x = dsp.int16_wire(torch.from_numpy(audio))
    np.testing.assert_allclose(dsp.rms(x, n_valid).numpy(), rms, rtol=1e-5)
    x16 = dsp.decimate_3(x)
    hops = -(-(-(-n_valid // 3)) // 170)
    ref_f0 = dsp.yin_f0(x16, hops).numpy()
    np.testing.assert_allclose(ref_f0, f0, rtol=1e-4)
    mel = dsp.log_mel(x16, 200, 80).float()
    e = rwhisper.encode(tree, 4, mel)
    seq = torch.cat([torch.full((2, 1), 256), torch.from_numpy(
        tokens[:, :-1]).long()], 1)
    logits = rwhisper.decoder_logits(tree, 4, e, seq)
    served = torch.from_numpy(tokens).long()
    gap = logits.max(-1).values - logits.gather(-1, served[..., None])[..., 0]
    assert float(gap.max()) < 1e-4


def test_receive_path_matches_the_program():
    from janus_tpu_torch.common.config import (JanusConfig, TTSConfig,
                                               VocoderConfig)
    from janus_tpu_torch.models import tts as tts_mod
    from janus_tpu_torch.runtime.synthesizer import vocode_48k

    tcfg = TTSConfig(**{k: TINY_TTS[k] for k in TINY_TTS if k != "mlp_ratio"},
                     dtype="float32")
    vcfg = VocoderConfig(**TINY_VOC, dtype="float32")
    cfg = JanusConfig().override(tts=tcfg, vocoder=vcfg)
    tt = W.make_tree(W.tts_leaves(TINY_TTS, 261, -5.0), 7, "cpu",
                     torch.float32)
    vt = W.make_tree(W.vocoder_leaves(TINY_VOC, 80), 8, "cpu", torch.float32)
    text = b"alpha bravo"
    prompt = rtts.prompt_ids(text, 16, "joyful", 261, 258)
    ids = prompt[2:-1][None]
    mel, n = tts_mod.tts_generate(tt, tcfg, ids, torch.tensor([2]),
                                  text_vocab=261, eager=True)
    groups = mel[0].reshape(16, 320)
    pred = rtts.predict_groups(tt, 4, prompt, groups, 259)
    assert float((pred - groups).abs().max()) < 1e-4 * float(
        groups.abs().max())
    wav48, _ = vocode_48k(vt, cfg, mel, n)
    ref = rtts.pcm48(vt, 1024, 256, mel[0])
    assert float((ref - wav48[0].double()).abs().max()) < 1e-4


ISOLATION = """
import sys, importlib
sys.path.insert(0, {root!r})
for m in {mods!r}:
    importlib.import_module(m)
top = {{name.split(".")[0] for name in sys.modules}}
print(sorted(top & {banned!r}))
"""


@pytest.mark.parametrize("mods,banned", [
    (["portbench.reference.dsp", "portbench.reference.whisper",
      "portbench.reference.tts", "portbench.reference.quant"],
     {"jax", "jaxlib", "flax", "janus_tpu", "janus_tpu_torch"}),
    (["portbench.harness.runner", "portbench.harness.trace",
      "portbench.harness.work", "portbench.drivers.asr_encode",
      "portbench.drivers.tts_stream", "portbench.drivers.tts_synth"],
     {"jax", "jaxlib", "flax", "janus_tpu"}),
])
def test_imports_load_no_forbidden_module(mods, banned):
    out = subprocess.run(
        [sys.executable, "-c", ISOLATION.format(root=str(ROOT), mods=mods,
                                                banned=banned)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().replace("'", '"')) == []
