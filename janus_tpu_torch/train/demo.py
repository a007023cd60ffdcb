"""Train the functional demo models on the synthetic tone language.

Small but working checkpoints, the stand-in for pretrained weights: after a
few hundred steps the ASR transcribes the tone language exactly, so the
codec produces real text end to end. The port's copy of the JAX
package's ``train/demo.py``: the same corpus draws from the same numpy
seeds, the same losses and the same optimizer
(:class:`~janus_tpu_torch.train.trainer.Trainer`). Initial weights come
from ``torch.Generator`` and so differ from the JAX package's; carry
weights across with ``params_from_jax`` to start from the same point.

Everything runs on ``device`` (default the card): the ASR step computes
its log-mel with the fused kernel and its encoder self-attention with the
flash kernel, the utterance pool is decimated on the device in one call.

CLI::

    python -m janus_tpu_torch.train.demo --steps 600 --out checkpoints/demo_asr_torch
    python -m janus_tpu_torch.train.demo --device cpu --steps 20 --batch 4
"""

from __future__ import annotations

import argparse
import logging
import os
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from janus_tpu_torch.common.config import ASRConfig, TTSConfig, VocoderConfig
from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.eval.metrics import word_error_rate
from janus_tpu_torch.models import tts as tts_mod
from janus_tpu_torch.models.asr import prepare_mel, transcribe_mel
from janus_tpu_torch.models.params import (init_asr, load_npz_params,
                                           save_npz, tree_to)
from janus_tpu_torch.models.speaker import init_speaker_encoder, speaker_embed
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.models.vocoder import init_vocoder
from janus_tpu_torch.models.zoo import (_CKPT_DIR, ENROLLMENT_PHRASE,
                                        demo_tts_config, demo_vocoder_config,
                                        hard_asr_config, hard_tts_config)
from janus_tpu_torch.ops.mel import log_mel_spectrogram
from janus_tpu_torch.ops.resample import decimate_48k_to_16k, resample_poly
from janus_tpu_torch.train.losses import asr_loss, tts_loss, vocoder_loss
from janus_tpu_torch.train.synthetic_task import (HARD_WORDS, SPEAKER_TIMBRES,
                                                  mel_targets_for,
                                                  render_text, sample_batch,
                                                  sample_text)
from janus_tpu_torch.train.trainer import Trainer

logger = logging.getLogger(__name__)

__all__ = ["demo_asr_config", "hard_asr_config", "demo_tts_config",
           "hard_tts_config", "demo_vocoder_config", "STANDARD_CORPUS",
           "HARD_CORPUS", "ENROLLMENT_PHRASE", "build_asr_pool",
           "train_demo_asr", "evaluate_asr", "demo_speaker_vectors",
           "train_demo_tts", "train_demo_vocoder", "main"]


def demo_asr_config() -> ASRConfig:
    """Geometry of ``checkpoints/demo_asr.npz``: small enough to train on
    a CPU in minutes, structured like the real thing."""
    return ASRConfig.demo()


# Corpus knobs shared by the standard retrain and the roundtrip eval: the
# demo ASR must transcribe everything the demo TTS can render (all emotion
# renderings across the 4 fixed speaker timbres).
STANDARD_CORPUS = dict(
    n_speakers=4,
    rate_range=(0.95, 1.05),
    emotions=("neutral", "excited", "joyful", "whispering", "shouting",
              "sad", "relaxed", "panicked", "serious", "calm", "angry"),
    # the decode stack renders on the mel hop grid (render_text
    # hop_quantize); the ASR that transcribes its output trains on the
    # same distribution
    hop_quantize=160,
)

HARD_CORPUS = dict(
    vocab=HARD_WORDS,
    n_speakers=16,
    rate_range=(0.8, 1.25),
    # up to 40 dB, plus a 25% no-noise share: train-time noise otherwise
    # makes the noise-free eval row out of distribution
    snr_db_range=(8.0, 40.0),
    clean_prob=0.25,
    min_words=1,
    max_words=5,
    emotions=("neutral", "excited", "joyful", "whispering", "shouting",
              "sad", "relaxed", "panicked", "serious", "calm", "angry"),
)


def _bg_render(fn, label: str = "pool"):
    """Run ``fn`` (a pool builder) in a daemon thread; the returned join()
    yields its result, or re-renders synchronously if the thread raised,
    so a render failure does not surface hundreds of steps later."""
    box: dict = {}

    def work():
        try:
            box["out"] = fn()
        except Exception as e:  # noqa: BLE001 — captured, re-raised at join
            box["err"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()

    def join():
        t.join()
        if "err" in box:
            logger.warning("background %s render failed (%s); "
                           "re-rendering synchronously", label, box["err"])
            return fn()
        return box["out"]

    return join


@torch.no_grad()
def _decimate_pool(audio: np.ndarray, device) -> torch.Tensor:
    """Serving-path frontend for a rendered pool: up to 48 kHz (the
    capture rate), then the SemanticEncoder's anti-aliased decimation back
    to 16 kHz, in one call on ``device``. Returns the pool there."""
    a = torch.from_numpy(np.ascontiguousarray(audio)).to(device)
    return decimate_48k_to_16k(resample_poly(a, up=3, down=1))


def build_asr_pool(rng, pool_n: int, tok, cfg: ASRConfig,
                   max_seconds: float, corpus: dict, device="cpu"):
    """Pre-rendered utterance pool (audio16[N, T] on ``device``,
    tokens[N, L], mask[N, L], texts): the train loop only indexes it."""
    audio, tokens, mask, texts = sample_batch(
        rng, pool_n, tok, max_seconds=max_seconds,
        max_tokens=cfg.max_target_positions, augment=True, **corpus)
    return _decimate_pool(audio, device), tokens, mask, texts


def train_demo_asr(
    steps: int = 600,
    batch: int = 16,
    seed: int = 0,
    cfg: Optional[ASRConfig] = None,
    learning_rate=1e-3,
    log_every: int = 50,
    corpus: Optional[dict] = None,
    max_seconds: float = 2.0,
    pool_n: Optional[int] = None,
    pool_refresh_every: Optional[int] = None,
    init_params=None,
    save_every: Optional[int] = None,
    save_path: Optional[str] = None,
    device="cuda",
):
    """Returns (params, cfg, tokenizer, history). ``corpus`` forwards
    hard-corpus knobs to :func:`sample_batch`; the default is the
    single-voice neutral task.

    ``pool_refresh_every`` re-renders the utterance pool every N steps in
    a background thread (a fixed pool of a few thousand utterances
    memorizes the hard corpus). ``learning_rate`` may be a schedule
    (:func:`~janus_tpu_torch.train.trainer.warmup_cosine_decay_schedule`).
    ``init_params`` warm-starts a continuation run."""
    dev = resolve_device(device)
    cfg = cfg or demo_asr_config()
    tok = ByteTokenizer()
    params = (tree_to(init_params, dev) if init_params is not None else
              init_asr(torch.Generator(device=dev).manual_seed(seed), cfg))
    n_frames = 2 * cfg.max_source_positions

    def loss_fn(p, audio16, tokens, mask):
        mel = prepare_mel(audio16, cfg, pad_to_frames=n_frames)
        return asr_loss(p, cfg, mel, tokens, mask)

    trainer = Trainer(loss_fn, learning_rate=learning_rate)
    state = trainer.create_state(params)

    rng = np.random.default_rng(seed)
    pool_n = pool_n or max(512, 4 * batch)
    pool_audio, pool_tokens, pool_mask, _ = build_asr_pool(
        rng, pool_n, tok, cfg, max_seconds, corpus or {}, device=dev)

    def render_next(render_seed: int):
        def build():
            r = np.random.default_rng(render_seed)
            return sample_batch(
                r, pool_n, tok, max_seconds=max_seconds,
                max_tokens=cfg.max_target_positions, augment=True,
                **(corpus or {}))

        return _bg_render(build, label="asr")

    renderer = render_next(seed + 1) if pool_refresh_every else None

    history = []  # device scalars, read once at the end
    t0 = time.time()
    for step in range(steps):
        if (pool_refresh_every and step and step % pool_refresh_every == 0
                and renderer is not None):
            audio16, pool_tokens, pool_mask, _texts = renderer()
            pool_audio = _decimate_pool(audio16, dev)
            renderer = render_next(seed + 1 + step)
        idx = rng.choice(pool_n, size=batch, replace=False)
        state, metrics = trainer.train_step(
            state, pool_audio[torch.from_numpy(idx).to(dev)],
            pool_tokens[idx], pool_mask[idx])
        history.append(metrics["loss"])
        if log_every and step % log_every == 0:
            logger.info("step %d loss=%.4f acc=%.3f (%.1fs)", step,
                        float(metrics["loss"]), float(metrics["asr_acc"]),
                        time.time() - t0)
        if save_every and save_path and step and step % save_every == 0:
            # a crash late in a long run must never cost the whole run
            save_npz(save_path, state.params)
            logger.info("checkpoint snapshot @%d -> %s", step, save_path)
    return state.params, cfg, tok, [float(h) for h in history]


def evaluate_asr(params, cfg: ASRConfig, tok: ByteTokenizer,
                 n_utterances: int = 16, seed: int = 123,
                 corpus: Optional[dict] = None,
                 max_seconds: float = 2.0, device="cuda") -> Tuple[float, list]:
    """Greedy-decode fresh utterances; returns (WER, [(ref, hyp), ...]).
    ``corpus`` selects the evaluation distribution (the training knobs;
    e.g. ``{**HARD_CORPUS, 'snr_db_range': (5.0, 5.0)}`` for WER under
    noise)."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    rng = np.random.default_rng(seed)
    audio, _tokens, _mask, texts = sample_batch(
        rng, n_utterances, tok, max_seconds=max_seconds,
        max_tokens=cfg.max_target_positions, **(corpus or {}))
    with torch.no_grad():
        mel = prepare_mel(torch.from_numpy(audio).to(dev), cfg,
                          pad_to_frames=2 * cfg.max_source_positions)
    prompt = torch.full((n_utterances, 1), tok.sot, dtype=torch.long,
                        device=dev)
    out = transcribe_mel(params, cfg, mel, prompt, tok.eot).cpu().numpy()
    hyps = []
    for row in out:
        cut = np.where(row == tok.eot)[0]
        ids = row[: cut[0]] if cut.size else row
        hyps.append(tok.decode(ids).strip())
    wer = word_error_rate(texts, hyps)
    return wer, list(zip(texts, hyps))


# The speaker encoders of the committed bundles, by TTS width: the JAX
# package draws them from its PRNG (seed 42), which no torch seed
# reproduces, so they are stored unrounded (float32).
_SPEAKER_FILES = {192: "demo_speaker_fp32.npz", 256: "demo_speaker_hard.npz"}


def demo_speaker_vectors(cfg: Optional[TTSConfig] = None, spk_seed: int = 42,
                         ckpt_dir: str = _CKPT_DIR):
    """(speaker_encoder_params, [vec per synthetic speaker]) on the CPU.
    With the default seed and a stored encoder for ``cfg.d_model``, the
    encoder is the JAX package's; otherwise it is drawn from a
    ``torch.Generator`` seeded ``spk_seed``. Serving recomputes identical
    embeddings from any reference audio of the same timbre."""
    cfg = cfg or demo_tts_config()
    name = _SPEAKER_FILES.get(cfg.d_model)
    path = os.path.join(ckpt_dir, name) if name else None
    if spk_seed == 42 and path and os.path.exists(path):
        spk_params = load_npz_params(path)
    else:
        spk_params = init_speaker_encoder(
            torch.Generator().manual_seed(spk_seed), n_mels=cfg.n_mels,
            d_out=cfg.d_model)
    vecs = []
    with torch.no_grad():
        for s in range(len(SPEAKER_TIMBRES)):
            ref = render_text(ENROLLMENT_PHRASE, 16_000, seed=0, speaker=s)
            vecs.append(speaker_embed(spk_params, torch.from_numpy(ref),
                                      n_mels=cfg.n_mels).numpy())
    return spk_params, vecs


def train_demo_tts(steps: int = 800, batch: int = 16, seed: int = 0,
                   cfg: Optional[TTSConfig] = None, learning_rate=1e-3,
                   log_every: int = 100, multi_speaker: bool = True,
                   tf_input_noise: float = 0.35,
                   pool_refresh_every: Optional[int] = None,
                   pool_n: Optional[int] = None,
                   emotion_weights: Optional[dict] = None,
                   corpus: Optional[dict] = None,
                   init_params=None,
                   save_every: Optional[int] = None,
                   save_path: Optional[str] = None,
                   device="cuda"):
    """Teacher-forced text->mel training on the tone language; with
    ``multi_speaker`` the model is conditioned on the enrollment
    encoder's speaker embeddings (functional voice cloning).

    ``tf_input_noise``: Gaussian noise on the teacher-forced mel prefix
    (relative to the pool's mel std; targets stay clean): at inference the
    prefix is the model's own imperfect output, and clean-prefix training
    drifts into word loops on multi-word prompts.

    ``pool_refresh_every`` re-renders the text pool every N steps in a
    background thread. ``corpus`` forwards ``vocab`` / ``min_words`` /
    ``max_words`` to :func:`sample_text` (``dict(vocab=HARD_WORDS,
    max_words=5)`` with :func:`hard_tts_config` trains the hard-corpus
    TTS). Each step trains at a random serving text bucket that fits, so
    every width the synthesizer pads to is in distribution."""
    dev = resolve_device(device)
    cfg = cfg or demo_tts_config()
    tok = ByteTokenizer()
    params = (tree_to(init_params, dev) if init_params is not None else
              tts_mod.init_tts(torch.Generator(device=dev).manual_seed(seed),
                               cfg, text_vocab=tok.vocab_size))
    n_speakers = len(SPEAKER_TIMBRES) if multi_speaker else 1
    _spk_params, spk_vecs = demo_speaker_vectors(cfg)
    spk_matrix = np.stack(spk_vecs)  # [n_speakers, d]

    def loss_fn(p, text, emo, mels, mask, spk, noisy):
        return tts_loss(p, cfg, text, emo, mels, mask, speaker=spk,
                        text_vocab=tok.vocab_size, mel_inputs=noisy)

    trainer = Trainer(loss_fn, learning_rate=learning_rate)
    state = trainer.create_state(params)

    rng = np.random.default_rng(seed)
    max_groups = cfg.max_mel_frames // cfg.reduction
    buckets = tts_mod.text_buckets(cfg.max_text_tokens)
    pool_n = pool_n or max(512, 4 * batch)

    # emotion sampling: optionally oversample the tags whose renders are
    # hardest (the fast and slow rates)
    emotions = tts_mod.EMOTIONS
    emo_p = np.ones(len(emotions))
    for name, w in (emotion_weights or {}).items():
        emo_p[emotions.index(name)] = w
    emo_p = emo_p / emo_p.sum()

    text_kw = {k: (corpus or {})[k]
               for k in ("vocab", "min_words", "max_words") if k in (corpus or {})}

    def build_pool(r: np.random.Generator) -> dict:
        texts = [sample_text(r, **text_kw) for _ in range(pool_n)]
        speakers = r.integers(0, n_speakers, pool_n).tolist()
        emos = [emotions[int(i)]
                for i in r.choice(len(emotions), pool_n, p=emo_p)]
        mels, mask = mel_targets_for(
            texts, cfg.n_mels, cfg.reduction, max_groups,
            speakers=speakers, emotions=emos, device=dev)
        return {
            "ids": [tok.encode(t)[: cfg.max_text_tokens] for t in texts],
            "emo": np.asarray([tts_mod.emotion_id(e) for e in emos], np.int32),
            "spk": spk_matrix[speakers].astype(np.float32),
            "mels": mels, "mask": mask,
        }

    pool = build_pool(rng)
    noise_std = tf_input_noise * float(pool["mels"][pool["mask"] > 0].std())

    def render_next(render_seed: int):
        return _bg_render(
            lambda: build_pool(np.random.default_rng(render_seed)),
            label="tts")

    renderer = render_next(seed + 1) if pool_refresh_every else None

    history = []
    t0 = time.time()
    for step in range(steps):
        if (pool_refresh_every and step and step % pool_refresh_every == 0
                and renderer is not None):
            pool = renderer()
            renderer = render_next(seed + 1 + step)
        idx = rng.choice(pool_n, size=batch, replace=False)
        longest = max(len(pool["ids"][i]) for i in idx)
        fitting = [b for b in buckets if b >= longest] or [buckets[-1]]
        width = int(fitting[int(rng.integers(0, len(fitting)))])
        text_ids = np.full((batch, width), tok.pad, np.int32)
        for row, i in enumerate(idx):
            ids = pool["ids"][i][:width]
            text_ids[row, : len(ids)] = ids
        mels = pool["mels"][idx]
        noisy = (mels + noise_std * rng.standard_normal(mels.shape)
                 .astype(np.float32)) if noise_std > 0 else mels
        state, metrics = trainer.train_step(
            state, text_ids, pool["emo"][idx], mels, pool["mask"][idx],
            pool["spk"][idx], noisy)
        history.append(metrics["loss"])
        if log_every and step % log_every == 0:
            logger.info("tts step %d loss=%.4f (%.1fs)", step,
                        float(metrics["loss"]), time.time() - t0)
        if save_every and save_path and step and step % save_every == 0:
            save_npz(save_path, state.params)
            logger.info("tts checkpoint snapshot @%d -> %s", step, save_path)
    return state.params, cfg, tok, [float(h) for h in history]


def train_demo_vocoder(steps: int = 600, batch: int = 8, seed: int = 0,
                       cfg: Optional[VocoderConfig] = None,
                       learning_rate=2e-3, log_every: int = 100,
                       device="cuda"):
    """mel -> waveform inversion on the tone-language domain. Returns
    (params, cfg, history)."""
    dev = resolve_device(device)
    cfg = cfg or demo_vocoder_config()
    n_mels = 80
    params = init_vocoder(torch.Generator(device=dev).manual_seed(seed), cfg,
                          n_mels=n_mels)

    def loss_fn(p, mel, wav):
        return vocoder_loss(p, cfg, mel, wav)

    trainer = Trainer(loss_fn, learning_rate=learning_rate)
    state = trainer.create_state(params)

    rng = np.random.default_rng(seed)
    t_frames = 96
    t_samples = t_frames * cfg.hop_length
    emotions = tts_mod.EMOTIONS
    history = []
    t0 = time.time()
    for step in range(steps):
        wavs = np.zeros((batch, t_samples), np.float32)
        for i in range(batch):
            w = render_text(sample_text(rng), cfg.sample_rate,
                            seed=int(rng.integers(1 << 30)),
                            speaker=int(rng.integers(0, 4)),
                            emotion=emotions[int(rng.integers(0, len(emotions)))],
                            hop_quantize=cfg.hop_length)
            wavs[i, : min(len(w), t_samples)] = w[:t_samples]
        wav_t = torch.from_numpy(wavs).to(dev)
        with torch.no_grad():
            mel = log_mel_spectrogram(wav_t, cfg.sample_rate, 400,
                                      cfg.hop_length, n_mels)[:, :t_frames, :]
        state, metrics = trainer.train_step(state, mel, wav_t)
        history.append(metrics["loss"])
        if log_every and step % log_every == 0:
            logger.info("voc step %d loss=%.4f l1=%.4f (%.1fs)", step,
                        float(metrics["loss"]), float(metrics["voc_l1"]),
                        time.time() - t0)
    return state.params, cfg, [float(h) for h in history]


def main(argv=None) -> None:
    from janus_tpu_torch.train.checkpoint import save_params

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--out", default="checkpoints/demo_asr_torch")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    params, cfg, tok, history = train_demo_asr(args.steps, args.batch,
                                               device=args.device)
    wer, pairs = evaluate_asr(params, cfg, tok, device=args.device)
    logger.info("final loss=%.4f  WER=%.3f", history[-1], wer)
    for ref, hyp in pairs[:5]:
        logger.info("  ref=%r hyp=%r", ref, hyp)
    save_params(args.out, params)
    logger.info("saved -> %s", args.out)


if __name__ == "__main__":
    main()
