"""The port's hard-corpus bundle against the JAX package on the CPU: the
stored speaker encoders are the JAX package's seed-42 initializers, the
bundle's configuration and default voice are the JAX bundle's, and the
hard recognizer transcribes fresh hard-corpus utterances as the JAX one
does."""

import dataclasses
import os

import numpy as np
import pytest

from janus_tpu.models import zoo as j_zoo
from janus_tpu.models.params import flatten_with_paths as j_flatten
from janus_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from janus_tpu.train import demo as j_demo
from janus_tpu_torch.models import zoo
from janus_tpu_torch.models.params import load_npz_params
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.train import demo


@pytest.mark.parametrize("name,cfg", [
    ("demo_speaker_hard.npz", j_demo.hard_tts_config),
    ("demo_speaker_fp32.npz", j_demo.demo_tts_config)])
def test_stored_speaker_encoder_is_the_jax_initializer(name, cfg):
    """float32, bit for bit the JAX package's ``init_speaker_encoder(42,
    d_out=d_model)``; the enrollment vectors agree within 1e-5."""
    j_params, j_vecs = j_demo.demo_speaker_vectors(cfg())
    with np.load(os.path.join(zoo.REPO_ROOT, "checkpoints", name)) as data:
        stored = {k: data[k] for k in data.files}
    flat = dict(j_flatten(j_params))
    assert sorted(stored) == sorted(flat)
    for k, v in flat.items():
        assert stored[k].dtype == np.float32
        np.testing.assert_array_equal(stored[k], np.asarray(v), err_msg=k)
    _, vecs = demo.demo_speaker_vectors(cfg())
    for mine, theirs in zip(vecs, j_vecs):
        np.testing.assert_allclose(mine, np.asarray(theirs), rtol=0,
                                   atol=1e-5)


def test_load_demo_hard_equals_jax():
    assert zoo.hard_available() == j_zoo.hard_available()
    mine, theirs = zoo.load_demo_hard(), j_zoo.load_demo_hard()
    assert dataclasses.asdict(mine.config) == dataclasses.asdict(
        theirs.config)
    np.testing.assert_allclose(mine.default_speaker_vec,
                               np.asarray(theirs.default_speaker_vec),
                               rtol=0, atol=1e-5)
    for field in ("asr_params", "tts_params", "vocoder_params",
                  "speaker_params"):
        got = dict(j_flatten(getattr(mine, field)))
        ref = dict(j_flatten(getattr(theirs, field)))
        assert sorted(got) == sorted(ref), field
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=f"{field}/{k}")


def test_hard_asr_transcripts_equal_jax():
    """Two fresh hard-corpus utterances (clean and at 5 dB SNR) through
    each package's ``evaluate_asr``: the same references and the same
    transcripts."""
    path = os.path.join(zoo.REPO_ROOT, "checkpoints", "demo_asr_hard.npz")
    for snr in (None, (5.0, 5.0)):
        corpus = dict(demo.HARD_CORPUS, clean_prob=0.0)
        if snr is None:
            corpus.pop("snr_db_range")
        else:
            corpus["snr_db_range"] = snr
        _, mine = demo.evaluate_asr(load_npz_params(path),
                                    demo.hard_asr_config(), ByteTokenizer(),
                                    n_utterances=2, seed=321, corpus=corpus,
                                    max_seconds=3.84, device="cpu")
        _, theirs = j_demo.evaluate_asr(
            j_zoo.load_demo_hard().asr_params, j_demo.hard_asr_config(),
            JByteTokenizer(), n_utterances=2, seed=321, corpus=corpus,
            max_seconds=3.84)
        assert mine == theirs
        assert all(isinstance(h, str) for _, h in mine)
