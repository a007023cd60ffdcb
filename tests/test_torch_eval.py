"""The port's evaluation gates and corpus against the JAX package on the
CPU: the metrics, ``sample_batch`` and ``mel_targets_for`` on the same
numpy seeds, the demo round trip (``evaluate_roundtrip``) on the
committed checkpoints, and the Whisper import on a state dict built
here."""

import types

import numpy as np
import pytest
import torch

from janus_tpu.eval import metrics as j_metrics
from janus_tpu.eval import roundtrip as j_roundtrip
from janus_tpu.models import import_whisper as j_import
from janus_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from janus_tpu.runtime.codec import SemanticEncoder as JSemanticEncoder
from janus_tpu.train import demo as j_demo
from janus_tpu.train import synthetic_task as j_task
from janus_tpu_torch.eval import metrics, roundtrip
from janus_tpu_torch.models import import_whisper
from janus_tpu_torch.models import zoo
from janus_tpu_torch.models.params import (flatten_with_paths,
                                           params_from_jax)
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.train import demo, synthetic_task


def test_metrics_equal_jax():
    rng = np.random.default_rng(0)
    words = ["alpha", "bravo", "kilo", "lima", "nov"]
    refs = [" ".join(rng.choice(words, int(rng.integers(1, 5))))
            for _ in range(20)]
    hyps = [" ".join(w for w in r.split() if rng.random() > 0.2)
            + (" kilo" if rng.random() > 0.7 else "") for r in refs]
    assert metrics.word_error_rate(refs, hyps) == \
        j_metrics.word_error_rate(refs, hyps)
    assert metrics.character_error_rate(refs, hyps) == \
        j_metrics.character_error_rate(refs, hyps)
    x = rng.standard_normal(4000)
    for est in (x, x + 0.1 * rng.standard_normal(4000), x[:3000]):
        assert metrics.snr_db(x, est) == j_metrics.snr_db(x, est)
    pros = [("Loud", "High"), ("Quiet", "Normal")]
    for hyp in (pros, [pros[0], ("Quiet", "Deep")], []):
        assert metrics.prosody_agreement(pros[:len(hyp)], hyp) == \
            j_metrics.prosody_agreement(pros[:len(hyp)], hyp)


def test_corpus_constants_equal_jax():
    assert synthetic_task.HARD_WORDS == j_task.HARD_WORDS
    assert synthetic_task.make_word_list(40, seed=7, min_syllables=1) == \
        j_task.make_word_list(40, seed=7, min_syllables=1)
    assert synthetic_task.SPEAKER_TIMBRES == j_task.SPEAKER_TIMBRES
    assert demo.STANDARD_CORPUS == j_demo.STANDARD_CORPUS
    assert demo.HARD_CORPUS == j_demo.HARD_CORPUS
    for name in ("demo_asr_config", "hard_asr_config", "demo_tts_config",
                 "hard_tts_config", "demo_vocoder_config"):
        mine, theirs = getattr(demo, name)(), getattr(j_demo, name)()
        assert vars(mine) == vars(theirs), name
    a = (np.random.default_rng(3).standard_normal(800) * 0.2).astype(np.float32)
    np.testing.assert_array_equal(synthetic_task.add_noise_snr(a, 7.0, seed=2),
                                  j_task.add_noise_snr(a, 7.0, seed=2))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("corpus", ["standard", "hard"])
def test_sample_batch_equal_jax(seed, corpus):
    knobs = dict(demo.STANDARD_CORPUS if corpus == "standard"
                 else demo.HARD_CORPUS)
    kw = dict(max_seconds=3.84 if corpus == "hard" else 2.0, max_tokens=48,
              augment=seed == 1, **knobs)
    mine = synthetic_task.sample_batch(np.random.default_rng(seed), 6,
                                       ByteTokenizer(), **kw)
    theirs = j_task.sample_batch(np.random.default_rng(seed), 6,
                                 JByteTokenizer(), **kw)
    for a, b in zip(mine[:3], theirs[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert mine[3] == theirs[3]


def test_mel_targets_equal_jax():
    texts = ["alpha bravo", "kilo", "mike nov oscar"]
    kw = dict(speakers=[0, 2, 3], emotions=["neutral", "excited", "sad"])
    mine = synthetic_task.mel_targets_for(texts, 80, 2, 40, **kw)
    theirs = j_task.mel_targets_for(texts, 80, 2, 40, **kw)
    np.testing.assert_array_equal(mine[1], theirs[1])
    np.testing.assert_allclose(mine[0], np.asarray(theirs[0]), rtol=0,
                               atol=5e-5)


def _recording(monkeypatch, cls):
    """Record every transcript ``cls.encode_batch`` returns."""
    seen = []
    orig = cls.encode_batch

    def encode_batch(self, phrases):
        out = orig(self, phrases)
        seen.extend(r["text"] for r in out)
        return out

    monkeypatch.setattr(cls, "encode_batch", encode_batch)
    return seen


def test_demo_roundtrip_equal_jax(monkeypatch):
    """``evaluate_roundtrip(n_utterances=2)`` on the committed demo
    checkpoints: every transcript the encoder produced along the way is
    the JAX package's, and every metric but the two wall-clock times
    within 1e-3."""
    ck = zoo.REPO_ROOT + "/checkpoints/"
    j_seen = _recording(monkeypatch, JSemanticEncoder)
    t_seen = _recording(monkeypatch, SemanticEncoder)
    jkw = dict(tts_params=j_roundtrip.load_npz_params(ck + "demo_tts.npz"),
               tts_cfg=j_demo.demo_tts_config(),
               vocoder_params=j_roundtrip.load_npz_params(
                   ck + "demo_vocoder.npz"),
               vocoder_cfg=j_demo.demo_vocoder_config())
    theirs = j_roundtrip.evaluate_roundtrip(
        j_roundtrip.load_npz_params(ck + "demo_asr.npz"),
        j_demo.demo_asr_config(), n_utterances=2, **jkw)
    tkw = dict(tts_params=roundtrip.load_npz_params(ck + "demo_tts.npz"),
               tts_cfg=demo.demo_tts_config(),
               vocoder_params=roundtrip.load_npz_params(
                   ck + "demo_vocoder.npz"),
               vocoder_cfg=demo.demo_vocoder_config())
    mine = roundtrip.evaluate_roundtrip(
        roundtrip.load_npz_params(ck + "demo_asr.npz"),
        demo.demo_asr_config(), n_utterances=2, device="cpu", **tkw)
    assert t_seen == j_seen and len(t_seen) >= 10
    assert sorted(mine) == sorted(theirs)
    for key, ref in theirs.items():
        if key.startswith("tts_turnaround") or key == "tts_full_synthesis_s":
            continue
        if isinstance(ref, (dict, str, bool)):
            assert mine[key] == ref, key
        else:
            assert abs(mine[key] - ref) <= 1e-3, (key, mine[key], ref)


def _hf_state_dict(n_enc=2, n_dec=1, d=16, n_mels=8, vocab=40, n_pos=12):
    rng = np.random.default_rng(11)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"model.encoder.conv1.weight": arr(d, n_mels, 3),
          "model.encoder.conv1.bias": arr(d),
          "model.encoder.conv2.weight": arr(d, d, 3),
          "model.encoder.conv2.bias": arr(d),
          "model.encoder.layer_norm.weight": arr(d),
          "model.encoder.layer_norm.bias": arr(d),
          "model.decoder.embed_tokens.weight": arr(vocab, d),
          "model.decoder.embed_positions.weight": arr(n_pos, d),
          "model.decoder.layer_norm.weight": arr(d),
          "model.decoder.layer_norm.bias": arr(d)}

    def attn(prefix):
        for proj in ("q", "k", "v", "out"):
            sd[f"{prefix}.{proj}_proj.weight"] = arr(d, d)
            if proj != "k":  # Whisper's k_proj has no bias
                sd[f"{prefix}.{proj}_proj.bias"] = arr(d)

    def block(prefix, norms):
        for n in norms:
            sd[f"{prefix}.{n}.weight"], sd[f"{prefix}.{n}.bias"] = arr(d), arr(d)
        sd[f"{prefix}.fc1.weight"], sd[f"{prefix}.fc1.bias"] = arr(4 * d, d), arr(4 * d)
        sd[f"{prefix}.fc2.weight"], sd[f"{prefix}.fc2.bias"] = arr(d, 4 * d), arr(d)

    for i in range(n_enc):
        p = f"model.encoder.layers.{i}"
        attn(f"{p}.self_attn")
        block(p, ("self_attn_layer_norm", "final_layer_norm"))
    for i in range(n_dec):
        p = f"model.decoder.layers.{i}"
        attn(f"{p}.self_attn")
        attn(f"{p}.encoder_attn")
        block(p, ("self_attn_layer_norm", "encoder_attn_layer_norm",
                  "final_layer_norm"))
    return sd


def test_import_whisper_tree_equal_jax():
    sd = _hf_state_dict()
    mine = import_whisper.params_from_hf_state_dict(sd)
    theirs = params_from_jax(j_import.params_from_hf_state_dict(sd))
    flat_m, flat_t = dict(flatten_with_paths(mine)), dict(
        flatten_with_paths(theirs))
    assert sorted(flat_m) == sorted(flat_t)
    assert isinstance(mine["encoder"]["blocks"], list)
    assert len(mine["encoder"]["blocks"]) == 2
    for k, v in flat_m.items():
        assert v.dtype == torch.float32 and torch.equal(v, flat_t[k]), k
    # torch tensors in, the same tree out
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    for k, v in flatten_with_paths(
            import_whisper.params_from_hf_state_dict(tsd)):
        assert torch.equal(v, flat_m[k])
    hf = types.SimpleNamespace(num_mel_bins=128, max_source_positions=1500,
                               d_model=1280, encoder_layers=32,
                               decoder_layers=32, encoder_attention_heads=20,
                               vocab_size=51866, max_target_positions=448)
    assert vars(import_whisper.asr_config_from_hf(hf)) == vars(
        j_import.asr_config_from_hf(hf))
