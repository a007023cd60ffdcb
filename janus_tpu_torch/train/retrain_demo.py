"""Retrain the demo checkpoints with the long-budget recipes.

The port's copy of the JAX package's ``train/retrain_demo.py``: cosine-
annealed AdamW (:func:`~janus_tpu_torch.train.trainer.
warmup_cosine_decay_schedule`), refreshed pools and the emotion weights
of the committed checkpoints. It writes the zoo's flat fp16 npz
(:func:`save_npz`), which both packages load.

    python -m janus_tpu_torch.train.retrain_demo --what vocoder --voc-steps 4000
    python -m janus_tpu_torch.train.retrain_demo --what asr,asr_hard --device cpu
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.eval.metrics import snr_db
from janus_tpu_torch.models import tts as tts_mod
from janus_tpu_torch.models.params import load_npz_params, save_npz, tree_to
from janus_tpu_torch.models.vocoder import init_vocoder, vocoder_waveform
from janus_tpu_torch.ops.mel import log_mel_spectrogram
from janus_tpu_torch.train.losses import vocoder_loss
from janus_tpu_torch.train.synthetic_task import render_text, sample_text
from janus_tpu_torch.train.trainer import (Trainer,
                                           warmup_cosine_decay_schedule)

__all__ = ["train_vocoder", "quick_copy_snr", "save_npz", "main",
           "TTS_EMOTION_WEIGHTS"]

logger = logging.getLogger("janus.retrain")

# Off-rate tags (fast: excited/panicked; slow: relaxed/serious/calm/sad)
# are where the roundtrip failures lived; both rate directions are
# weighted alike.
TTS_EMOTION_WEIGHTS = {
    "excited": 2.0, "panicked": 2.2, "relaxed": 1.8, "serious": 1.5,
    "calm": 1.5, "sad": 1.4, "angry": 1.4, "whispering": 1.3,
    "joyful": 1.2, "shouting": 1.2,
}


def _random_chars_text(r: np.random.Generator) -> str:
    """Uniform random character strings (not corpus words): the vocoder
    must invert mel for any character sequence the TTS can emit."""
    return " ".join(
        "".join(chr(ord("a") + int(c)) for c in r.integers(0, 26, int(r.integers(2, 8))))
        for _ in range(int(r.integers(1, 4)))
    )


def train_vocoder(steps: int, batch: int, seed: int = 0,
                  log_every: int = 200, device="cuda"):
    """Long-budget vocoder training: cosine-decayed AdamW and random
    hop-aligned window crops over the multi-speaker, multi-emotion tone
    corpus. Returns (params, cfg, history)."""
    from janus_tpu_torch.train.demo import demo_vocoder_config

    dev = resolve_device(device)
    cfg = demo_vocoder_config()
    n_mels = 80
    params = init_vocoder(torch.Generator(device=dev).manual_seed(seed), cfg,
                          n_mels=n_mels)
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=2e-3, warmup_steps=min(100, steps // 10),
        decay_steps=steps, end_value=2e-5)  # phase fine-tuning needs a low tail
    t_frames = 96

    def loss_fn(p, wav):
        with torch.no_grad():
            mel = log_mel_spectrogram(wav, cfg.sample_rate, 400,
                                      cfg.hop_length, n_mels)[:, :t_frames, :]
        return vocoder_loss(p, cfg, mel, wav)

    trainer = Trainer(loss_fn, learning_rate=schedule)
    state = trainer.create_state(params)

    rng = np.random.default_rng(seed)
    t_samples = t_frames * cfg.hop_length
    emotions = tts_mod.EMOTIONS
    pool_n = 512
    pool = []
    for _ in range(pool_n):
        w = render_text(
            sample_text(rng) if rng.random() < 0.5 else _random_chars_text(rng),
            cfg.sample_rate,
            seed=int(rng.integers(1 << 30)),
            speaker=int(rng.integers(0, 4)),
            emotion=emotions[int(rng.integers(0, len(emotions)))],
            # tone onsets must land on the analysis grid or target phase
            # is invisible in mel (see render_text)
            hop_quantize=cfg.hop_length,
        )
        if len(w) < t_samples:
            w = np.pad(w, (0, t_samples - len(w)))
        pool.append(w.astype(np.float32))

    history = []
    t0 = time.time()
    hop = cfg.hop_length
    for step in range(steps):
        wavs = np.zeros((batch, t_samples), np.float32)
        for i, j in enumerate(rng.choice(pool_n, size=batch, replace=False)):
            w = pool[j]
            # crops on the hop grid: the corpus is phase-deterministic on
            # it, so per-frame target phase is a function of mel context
            off = hop * int(rng.integers(0, (len(w) - t_samples) // hop + 1))
            wavs[i] = w[off : off + t_samples]
        state, metrics = trainer.train_step(state, wavs)
        history.append(metrics["loss"])
        if log_every and step % log_every == 0:
            logger.info("voc step %d loss=%.4f l1=%.4f cplx=%.4f (%.1fs)",
                        step, float(metrics["loss"]), float(metrics["voc_l1"]),
                        float(metrics["voc_cplx"]), time.time() - t0)
    return state.params, cfg, [float(h) for h in history]


@torch.no_grad()
def quick_copy_snr(voc_params, vcfg, n_mels: int = 80, device="cuda") -> float:
    """The roundtrip eval's copy-synthesis SNR for one utterance.

    The waveform is featurized with its zero continuation (``n_fft/hop``
    trailing silence frames, the centered-analysis convention): without
    them the end-flush must extrapolate past the final full-amplitude
    frame and the last hop dominates the error."""
    dev = resolve_device(device)
    wav = render_text("tiko ma selo", vcfg.sample_rate, seed=0)
    tail = (vcfg.n_fft // vcfg.hop_length) * vcfg.hop_length
    wavp = torch.from_numpy(np.pad(wav, (0, tail))).to(dev)
    mel = log_mel_spectrogram(wavp, vcfg.sample_rate, 400, vcfg.hop_length,
                              n_mels)
    recon = vocoder_waveform(tree_to(voc_params, dev), vcfg, mel,
                             length=len(wavp)).cpu().numpy()
    return snr_db(wav, recon[: len(wav)])


def main(argv=None) -> None:
    from janus_tpu_torch.train import demo as demo_mod

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--what", default="tts,vocoder",
                    help="comma list: tts, vocoder, asr, asr_hard, tts_hard")
    ap.add_argument("--tts-steps", type=int, default=12000)
    ap.add_argument("--voc-steps", type=int, default=12000)
    ap.add_argument("--asr-steps", type=int, default=4000)
    ap.add_argument("--hard-steps", type=int, default=12000)
    ap.add_argument("--hard-tts-steps", type=int, default=16000)
    ap.add_argument("--hard-warm-start", action="store_true",
                    help="asr_hard: continue from the committed checkpoint "
                         "instead of retraining from scratch")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out-dir", default="checkpoints")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = args.device
    what = {w.strip() for w in args.what.split(",")}

    if "asr" in what:
        # STANDARD_CORPUS: the ASR must transcribe every emotion rendering
        # the demo TTS can produce; the pool refreshes (a fixed pool
        # memorizes)
        schedule = warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=1e-3,
            warmup_steps=min(200, args.asr_steps // 10),
            decay_steps=args.asr_steps, end_value=5e-5)
        params, cfg, tok, hist = demo_mod.train_demo_asr(
            args.asr_steps, args.batch, corpus=demo_mod.STANDARD_CORPUS,
            pool_n=1024, pool_refresh_every=300, learning_rate=schedule,
            device=dev)
        wer, _ = demo_mod.evaluate_asr(params, cfg, tok,
                                       corpus=demo_mod.STANDARD_CORPUS,
                                       device=dev)
        logger.info("asr final loss=%.4f WER=%.3f", hist[-1], wer)
        save_npz(f"{args.out_dir}/demo_asr.npz", params)

    if "asr_hard" in what:
        # the hard corpus with training noise down to 2 dB; a warm start
        # continues the committed checkpoint at a lower peak
        noisy_corpus = dict(demo_mod.HARD_CORPUS)
        noisy_corpus["snr_db_range"] = (2.0, 40.0)
        init = None
        peak = 1e-3
        ckpt = f"{args.out_dir}/demo_asr_hard.npz"
        if args.hard_warm_start and os.path.exists(ckpt):
            init = load_npz_params(ckpt)
            peak = 3e-4
        schedule = warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=peak,
            warmup_steps=min(300, args.hard_steps // 10),
            decay_steps=args.hard_steps, end_value=5e-5)
        params, cfg, tok, hist = demo_mod.train_demo_asr(
            args.hard_steps, args.batch, cfg=demo_mod.hard_asr_config(),
            corpus=noisy_corpus, max_seconds=3.84, pool_n=2048,
            pool_refresh_every=400, learning_rate=schedule, init_params=init,
            save_every=2000, save_path=ckpt, device=dev)
        save_npz(ckpt, params)
        for label, snr in (("clean", None), ("snr10", (10.0, 10.0)),
                           ("snr5", (5.0, 5.0)), ("snr0", (0.0, 0.0))):
            corpus = dict(demo_mod.HARD_CORPUS)
            corpus["clean_prob"] = 0.0
            corpus["snr_db_range"] = snr
            if snr is None:
                corpus.pop("snr_db_range")
            wer, pairs = demo_mod.evaluate_asr(
                params, cfg, tok, n_utterances=32, corpus=corpus,
                max_seconds=3.84, device=dev)
            logger.info("asr_hard WER[%s]=%.3f  (e.g. ref=%r hyp=%r)",
                        label, wer, pairs[0][0], pairs[0][1])

    def tts_schedule(steps: int, peak: float = 1e-3):
        # annealed: a constant rate plateaus in a noisy basin, and the
        # final quality is a draw of where the last step lands
        return warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=peak,
            warmup_steps=min(200, steps // 10),
            decay_steps=steps, end_value=1e-5)

    if "tts" in what:
        params, cfg, tok, hist = demo_mod.train_demo_tts(
            steps=args.tts_steps, batch=args.batch,
            pool_refresh_every=1200,
            learning_rate=tts_schedule(args.tts_steps),
            emotion_weights=TTS_EMOTION_WEIGHTS,
            save_every=2000, save_path=f"{args.out_dir}/demo_tts.npz",
            device=dev)
        logger.info("tts final loss=%.4f", hist[-1])
        save_npz(f"{args.out_dir}/demo_tts.npz", params)

    if "tts_hard" in what:
        params, cfg, tok, hist = demo_mod.train_demo_tts(
            steps=args.hard_tts_steps, batch=args.batch,
            cfg=demo_mod.hard_tts_config(),
            corpus=dict(vocab=demo_mod.HARD_WORDS, min_words=1, max_words=5),
            pool_n=768, pool_refresh_every=800,
            learning_rate=tts_schedule(args.hard_tts_steps),
            emotion_weights=TTS_EMOTION_WEIGHTS,
            save_every=2000, save_path=f"{args.out_dir}/demo_tts_hard.npz",
            device=dev)
        logger.info("tts_hard final loss=%.4f", hist[-1])
        save_npz(f"{args.out_dir}/demo_tts_hard.npz", params)

    if "vocoder" in what:
        params, vcfg, hist = train_vocoder(args.voc_steps,
                                           max(args.batch // 2, 4), device=dev)
        # save first: a failed diagnostic must never lose the training run
        save_npz(f"{args.out_dir}/demo_vocoder.npz", params)
        snr = quick_copy_snr(params, vcfg, device=dev)
        logger.info("vocoder final loss=%.4f copy-SNR=%.2f dB", hist[-1], snr)

    logger.info("done -> %s", args.out_dir)


if __name__ == "__main__":
    main()
