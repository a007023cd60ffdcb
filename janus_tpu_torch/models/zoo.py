"""Model zoo: the committed demo checkpoints as one bundle.

``load_demo()`` returns the tone-language demo models (recognizer, TTS,
vocoder, speaker encoder) and their configuration, and ``load_demo_hard()``
the hard-corpus bundle (256-word recognizer and TTS), ready to plug into
:class:`~janus_tpu_torch.runtime.codec.SemanticEncoder` and
:class:`~janus_tpu_torch.runtime.synthesizer.Synthesizer`. The parameter
trees are float32 tensors on the CPU; the entry points move them.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass
from typing import Any, Optional

import torch

from janus_tpu_torch.audio.synthetic import render_text
from janus_tpu_torch.common.config import (ASRConfig, JanusConfig, TTSConfig,
                                           VocoderConfig)
from janus_tpu_torch.models.params import load_npz_params
from janus_tpu_torch.models.speaker import speaker_embed

__all__ = ["ModelBundle", "load_demo", "demo_available", "load_demo_hard",
           "hard_available", "demo_tts_config",
           "hard_tts_config", "hard_asr_config", "demo_vocoder_config", "ENROLLMENT_PHRASE",
           "REPO_ROOT"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CKPT_DIR = os.path.join(REPO_ROOT, "checkpoints")

ENROLLMENT_PHRASE = "alpha bravo"  # fixed utterance used to enroll a voice


def demo_tts_config() -> TTSConfig:
    """Geometry of ``checkpoints/demo_tts.npz``."""
    return TTSConfig(d_model=192, layers=4, num_heads=4, n_mels=80,
                     reduction=2, max_text_tokens=48, max_mel_frames=192)


def hard_tts_config() -> TTSConfig:
    """Geometry of ``checkpoints/demo_tts_hard.npz`` (256-word corpus, up
    to 5-word prompts: a 320-frame budget never truncates a target)."""
    return TTSConfig(d_model=256, layers=6, num_heads=8, n_mels=80,
                     reduction=2, max_text_tokens=48, max_mel_frames=320)


def hard_asr_config() -> ASRConfig:
    """Geometry of ``checkpoints/demo_asr_hard.npz`` (the hard corpus:
    256 words, 16 speakers, 0.8-1.25x rates, noise, up to 5 words; a
    3.84 s encoder window and a wider model than the demo's)."""
    return ASRConfig(
        n_mels=80, d_model=192, encoder_layers=3, decoder_layers=3,
        num_heads=6, vocab_size=261, max_source_positions=192,
        max_target_positions=64, max_decode_tokens=48, dtype="float32",
    )


def demo_vocoder_config() -> VocoderConfig:
    """Geometry of ``checkpoints/demo_vocoder.npz``: trained at 16 kHz with
    the mel frontend's hop, so TTS mel feeds it with no resampling."""
    return VocoderConfig(n_fft=640, hop_length=160, d_model=256, layers=8,
                         sample_rate=16_000)


@dataclass
class ModelBundle:
    config: JanusConfig
    asr_params: Optional[Any] = None
    tts_params: Optional[Any] = None
    vocoder_params: Optional[Any] = None
    speaker_params: Optional[Any] = None
    default_speaker_vec: Optional[Any] = None


def demo_available(ckpt_dir: str = _CKPT_DIR) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, "demo_asr.npz"))


def _with_sections(cfg: JanusConfig, **sections) -> JanusConfig:
    for name, section in sections.items():
        cfg = cfg.override(**{f"{name}.{k}": v
                              for k, v in asdict(section).items()})
    return cfg


def load_demo(ckpt_dir: str = _CKPT_DIR,
              base: Optional[JanusConfig] = None) -> ModelBundle:
    """The committed tone-language demo bundle. The default voice is
    synthetic speaker 0's enrollment embedding."""
    cfg = base if base is not None else JanusConfig.from_env()
    cfg = _with_sections(cfg, asr=ASRConfig.demo(), tts=demo_tts_config(),
                         vocoder=demo_vocoder_config())
    bundle = ModelBundle(config=cfg)
    for field, name in (("asr_params", "demo_asr.npz"),
                        ("tts_params", "demo_tts.npz"),
                        ("vocoder_params", "demo_vocoder.npz"),
                        ("speaker_params", "demo_speaker.npz")):
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            setattr(bundle, field, load_npz_params(path))
    if bundle.speaker_params is not None:
        ref = render_text(ENROLLMENT_PHRASE, 16_000, seed=0, speaker=0)
        bundle.default_speaker_vec = speaker_embed(
            bundle.speaker_params, torch.from_numpy(ref),
            n_mels=cfg.tts.n_mels).numpy()
    return bundle


def hard_available(ckpt_dir: str = _CKPT_DIR) -> bool:
    return (os.path.exists(os.path.join(ckpt_dir, "demo_asr_hard.npz"))
            and os.path.exists(os.path.join(ckpt_dir, "demo_tts_hard.npz")))


def load_demo_hard(ckpt_dir: str = _CKPT_DIR,
                   base: Optional[JanusConfig] = None) -> ModelBundle:
    """The hard-corpus bundle: the 256-word/16-speaker recognizer and the
    hard-corpus TTS, sharing the demo vocoder (trained on arbitrary
    character strings, not corpus words). The speaker encoder is the one
    of the TTS's width, ``checkpoints/demo_speaker_hard.npz`` (float32),
    and the default voice synthetic speaker 0's enrollment embedding."""
    from janus_tpu_torch.train.demo import demo_speaker_vectors

    cfg = base if base is not None else JanusConfig.from_env()
    cfg = _with_sections(cfg, asr=hard_asr_config(), tts=hard_tts_config(),
                         vocoder=demo_vocoder_config())
    bundle = ModelBundle(config=cfg)
    for field, name in (("asr_params", "demo_asr_hard.npz"),
                        ("tts_params", "demo_tts_hard.npz"),
                        ("vocoder_params", "demo_vocoder.npz")):
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            setattr(bundle, field, load_npz_params(path))
    spk_params, vecs = demo_speaker_vectors(cfg.tts, ckpt_dir=ckpt_dir)
    bundle.speaker_params = spk_params
    bundle.default_speaker_vec = vecs[0]
    return bundle
