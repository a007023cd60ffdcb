"""Round-trip codec evaluation on the synthetic tone language.

Measures the full semantic loop:

    text ──render──▶ speech ──SemanticEncoder──▶ packet
         ◀──WER──── re-transcribed ◀──ASR── reconstructed ◀──TTS+vocoder──

Reported: transcription WER (speech→packet), round-trip WER
(packet→speech→text), categorical prosody agreement across the wire, mean
packet size and airtime at 300 bps, copy-synthesis SNR of the vocoder,
streaming turnaround, and with trained TTS weights the per-emotion round
trip and the voice-clone identity. The port's copy of the JAX package's
``eval/roundtrip.py``: the same draws, the same metrics, on the port's
:class:`~janus_tpu_torch.runtime.codec.SemanticEncoder` and
:class:`~janus_tpu_torch.runtime.synthesizer.Synthesizer` (on the card
they run the fused log-mel, flash-attention and YIN kernels).

CLI::

    python -m janus_tpu_torch.eval.roundtrip --min-snr 24
    python -m janus_tpu_torch.eval.roundtrip --device cpu --n 4
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
from typing import Dict, List

import numpy as np
import torch

from janus_tpu_torch.common.config import ASRConfig, JanusConfig
from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.common.protocol import JanusPacket
from janus_tpu_torch.eval.metrics import (prosody_agreement, snr_db,
                                          word_error_rate)
from janus_tpu_torch.models import tts as tts_mod
from janus_tpu_torch.models import vocoder as voc_mod
from janus_tpu_torch.models.params import load_npz_params, tree_to
from janus_tpu_torch.models.speaker import speaker_embed
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.models.zoo import _with_sections
from janus_tpu_torch.ops.mel import log_mel_spectrogram
from janus_tpu_torch.ops.resample import resample_poly
from janus_tpu_torch.runtime.codec import SemanticEncoder
from janus_tpu_torch.runtime.streaming_tts import StreamingSynthesizer
from janus_tpu_torch.runtime.synthesizer import Synthesizer
from janus_tpu_torch.train.synthetic_task import render_text, sample_text

logger = logging.getLogger(__name__)

__all__ = ["load_npz_params", "evaluate_roundtrip", "REACHABLE_EMOTIONS",
           "evaluate_emotion_roundtrip", "evaluate_voice_clone_identity",
           "evaluate_hard_roundtrip", "evaluate_hard_asr", "main"]


def _pcm(audio_bytes: bytes) -> np.ndarray:
    return np.frombuffer(audio_bytes, dtype=np.int16).astype(np.float32) / 32768.0


def _resample(wav: np.ndarray, up: int, down: int, dev) -> np.ndarray:
    g = math.gcd(up, down)
    with torch.no_grad():
        return resample_poly(torch.from_numpy(np.ascontiguousarray(
            wav, dtype=np.float32)).to(dev), up=up // g,
            down=down // g).cpu().numpy()


@torch.no_grad()
def evaluate_roundtrip(
    asr_params,
    asr_cfg: ASRConfig,
    n_utterances: int = 16,
    seed: int = 7,
    tts_params=None,
    tts_cfg=None,
    vocoder_params=None,
    vocoder_cfg=None,
    device="cuda",
) -> Dict:
    """Returns the metric dict. TTS/vocoder params default to random
    weights (the reconstruction numbers then measure the untrained lower
    bound; transcription metrics are unaffected)."""
    from janus_tpu_torch.train.demo import demo_speaker_vectors

    dev = resolve_device(device)
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    texts = [sample_text(rng) for _ in range(n_utterances)]

    # --- speech -> packet (transcription + prosody) ---
    cfg = JanusConfig()
    sr = cfg.audio.sample_rate
    phrases = [_resample(render_text(t, 16_000, seed=i), 3, 1, dev)
               for i, t in enumerate(texts)]
    encoder = SemanticEncoder(_with_sections(cfg, asr=asr_cfg),
                              asr_params=asr_params, device=dev)
    results = encoder.encode_batch(phrases)
    hyps = [r["text"] for r in results]
    tx_wer = word_error_rate(texts, hyps)

    packets = [JanusPacket(text=r["text"], prosody=r["prosody"], timestamp=0.0)
               for r in results]
    sizes = [p.wire_size() for p in packets]

    # --- packet -> speech -> text (round trip) ---
    synth_cfg = cfg
    if tts_cfg is not None:
        synth_cfg = _with_sections(synth_cfg, tts=tts_cfg)
    if vocoder_cfg is not None:
        synth_cfg = _with_sections(synth_cfg, vocoder=vocoder_cfg)
    default_vec = None
    if tts_params is not None:
        # speaker-conditioned demo TTS: synthesize in the default voice
        default_vec = demo_speaker_vectors(synth_cfg.tts)[1][0]
    synth = Synthesizer(synth_cfg, tts_params=tts_params,
                        vocoder_params=vocoder_params,
                        default_speaker_vec=default_vec, device=dev)
    rt_hyps: List[str] = []
    for p in packets:
        pcm = _pcm(synth.synthesize(p))
        # whatever came back is transcribed: a correctly synthesized short
        # word (e.g. 'nov' at 0.18 s) must count
        rt_hyps.append(encoder.encode_batch([pcm])[0]["text"] if len(pcm)
                       else "")
    rt_wer = word_error_rate(texts, rt_hyps)

    # --- prosody across the wire ---
    ref_pros = [(r["prosody"]["energy"], r["prosody"]["pitch"]) for r in results]
    wire = [JanusPacket.deserialize(p.serialize()).prosody for p in packets]
    pros_agree = prosody_agreement(
        ref_pros, [(w.get("energy"), w.get("pitch")) for w in wire])

    # --- vocoder copy-synthesis SNR (tone-language domain) ---
    # Averaged over several utterances, zero-padded to one length, each
    # keeping >= n_fft/hop frames of its zero continuation (the
    # centered-analysis end context); scored over its own samples.
    voc_sr = synth_cfg.vocoder.sample_rate
    wavs_v: List[np.ndarray] = []
    for i, t in enumerate(texts[: min(4, len(texts))]):
        w16 = render_text(t, 16_000, seed=i)
        w = _resample(w16, voc_sr, 16_000, dev) if voc_sr != 16_000 else w16
        wavs_v.append(w.astype(np.float32))
    hop = synth_cfg.vocoder.hop_length
    tail = (synth_cfg.vocoder.n_fft // hop) * hop
    pad_len = -(-(max(len(w) for w in wavs_v) + tail) // hop) * hop
    batch = np.zeros((len(wavs_v), pad_len), np.float32)
    for i, w in enumerate(wavs_v):
        batch[i, : len(w)] = w
    mel_v = log_mel_spectrogram(torch.from_numpy(batch).to(dev), voc_sr, 400,
                                hop, synth_cfg.tts.n_mels)
    recon = voc_mod.vocoder_waveform(synth.vocoder_params, synth_cfg.vocoder,
                                     mel_v, length=pad_len).cpu().numpy()
    per_utt_snr = [snr_db(w, recon[i, : len(w)]) for i, w in enumerate(wavs_v)]

    # --- streaming turnaround (time to first audio vs full clip) ---
    streamer = StreamingSynthesizer(
        synth_cfg, tts_params=synth.tts_params,
        vocoder_params=synth.vocoder_params, chunk_groups=16, device=dev)
    turn_text = packets[0].text or texts[0]
    spk = synth._speaker_arg()
    list(streamer.stream(turn_text, speaker=spk))  # warm-up
    first_s, total_s, _n = streamer.turnaround(turn_text, speaker=spk)

    # --- prompt-padding robustness (text-length-invariant positions) ---
    pad_match = None
    if tts_params is not None:
        def synth_at_width(width: int) -> np.ndarray:
            ids = tok.encode(turn_text)[:width]
            padded = np.full((1, width), tok.pad, np.int64)
            padded[0, : len(ids)] = ids
            mel, n_frames = tts_mod.tts_generate(
                synth.tts_params, synth_cfg.tts,
                torch.from_numpy(padded).to(dev),
                torch.zeros((1,), dtype=torch.long, device=dev),
                speaker=None if spk is None else spk[None, :],
                text_vocab=tok.vocab_size)
            wav = voc_mod.vocoder_waveform(synth.vocoder_params,
                                           synth_cfg.vocoder, mel)
            n = int(n_frames[0]) * synth_cfg.vocoder.hop_length
            wav = wav[0, :n].cpu().numpy()
            if synth_cfg.vocoder.sample_rate != sr:
                wav = _resample(wav, sr, synth_cfg.vocoder.sample_rate, dev)
            return wav.astype(np.float32)

        w_small = tts_mod.text_bucket(len(tok.encode(turn_text)),
                                      synth_cfg.tts.max_text_tokens)
        w_full = synth_cfg.tts.max_text_tokens
        if w_small != w_full:
            wav_a, wav_b = synth_at_width(w_small), synth_at_width(w_full)
            if min(len(wav_a), len(wav_b)) >= 1536 * 6:
                ta = encoder.encode_batch([wav_a])[0]["text"]
                tb = encoder.encode_batch([wav_b])[0]["text"]
                pad_match = bool(ta == tb)

    out = {
        "transcription_wer": round(tx_wer, 4),
        "roundtrip_wer": round(rt_wer, 4),
        "prosody_agreement": round(pros_agree, 4),
        "mean_packet_bytes": round(float(np.mean(sizes)), 1),
        "mean_airtime_s_at_300bps": round(float(np.mean(sizes)) / 37.5, 3),
        "vocoder_copy_snr_db": round(float(np.mean(per_utt_snr)), 2),
        "vocoder_copy_snr_min_db": round(float(np.min(per_utt_snr)), 2),
        "tts_turnaround_first_audio_s": round(first_s, 4),
        "tts_full_synthesis_s": round(total_s, 4),
        "n_utterances": n_utterances,
    }
    if pad_match is not None:
        out["tts_padding_transcript_match"] = pad_match
    if tts_params is not None:
        out.update(evaluate_emotion_roundtrip(synth, encoder))
        out.update(evaluate_voice_clone_identity(
            synth.tts_params, synth_cfg.tts, synth.vocoder_params,
            synth_cfg.vocoder, device=dev))
    return out


# Wire-reachable semantic emotion tags and a prosody combo that produces
# each ('sad' needs pitch 'Low', which the extractor never emits).
REACHABLE_EMOTIONS = (
    ("excited", ("High", "Loud")),
    ("joyful", ("High", "Normal")),
    ("whispering", ("High", "Quiet")),
    ("shouting", ("Normal", "Loud")),
    ("relaxed", ("Normal", "Normal")),
)


def evaluate_emotion_roundtrip(synth, encoder, text: str = "kilo echo papa") -> Dict:
    """Per-emotion round trip through the synthesizer: every
    wire-reachable emotion tag must still transcribe to the original text
    (emotion modulates affect, never content)."""
    matches = {}
    for tag, (pitch, energy) in REACHABLE_EMOTIONS:
        p = JanusPacket(text=text, prosody={"energy": energy, "pitch": pitch},
                        timestamp=0.0)
        pcm = _pcm(synth.synthesize(p))
        hyp = encoder.encode_batch([pcm])[0]["text"] if len(pcm) else ""
        matches[tag] = bool(hyp == text)
    return {
        "emotion_roundtrip_match": round(sum(matches.values()) / len(matches), 4),
        "emotion_roundtrip_by_tag": matches,
    }


@torch.no_grad()
def evaluate_voice_clone_identity(tts_params, tts_cfg, vocoder_params,
                                  vocoder_cfg, text: str = "lima oscar",
                                  device="cuda") -> Dict:
    """Closed-set speaker identification of cloned audio: synthesize
    ``text`` conditioned on each enrolled speaker's embedding, re-embed the
    waveform, and check that the nearest enrollment is the target."""
    from janus_tpu_torch.train.demo import demo_speaker_vectors

    dev = resolve_device(device)
    tok = ByteTokenizer()
    spk_params, vecs = demo_speaker_vectors(tts_cfg)
    spk_params = tree_to(spk_params, dev)
    tts_params = tree_to(tts_params, dev)
    vocoder_params = tree_to(vocoder_params, dev)
    enroll = np.stack(vecs)  # [S, d]

    ids = tok.encode(text)
    width = tts_mod.text_bucket(len(ids), tts_cfg.max_text_tokens)
    padded = np.full((1, width), tok.pad, np.int64)
    padded[0, : len(ids)] = ids
    correct, sims = 0, []
    for s in range(len(vecs)):
        mel, nf = tts_mod.tts_generate(
            tts_params, tts_cfg, torch.from_numpy(padded).to(dev),
            torch.zeros((1,), dtype=torch.long, device=dev),
            speaker=torch.from_numpy(enroll[s])[None, :].to(dev),
            text_vocab=tok.vocab_size)
        wav = voc_mod.vocoder_waveform(vocoder_params, vocoder_cfg, mel)
        n = int(nf[0]) * vocoder_cfg.hop_length
        emb = speaker_embed(spk_params, wav[0, :n],
                            n_mels=tts_cfg.n_mels).cpu().numpy()
        cos = enroll @ emb  # embeddings are L2-normalized
        sims.append(float(cos[s]))
        correct += int(np.argmax(cos) == s)
    return {
        "voice_clone_identity": f"{correct}/{len(vecs)}",
        "voice_clone_identity_frac": round(correct / len(vecs), 4),
        "voice_clone_target_cos_mean": round(float(np.mean(sims)), 4),
    }


def evaluate_hard_roundtrip(bundle=None, n_utterances: int = 24,
                            seed: int = 97, device="cuda") -> Dict:
    """Full wire path on the hard corpus: a fresh hard utterance (16
    speakers, 0.8–1.25× rates, emotion renderings) → SemanticEncoder (hard
    ASR) → JanusPacket bytes → Synthesizer (hard TTS + vocoder, default
    voice, emotion from the packet's prosody) → re-encode → WER."""
    from janus_tpu_torch.models import zoo
    from janus_tpu_torch.train.demo import HARD_CORPUS

    dev = resolve_device(device)
    if bundle is None:
        bundle = zoo.load_demo_hard()
    cfg = bundle.config
    rng = np.random.default_rng(seed)
    vocab = HARD_CORPUS["vocab"]
    emotions = HARD_CORPUS["emotions"]

    texts, phrases = [], []
    for _ in range(n_utterances):
        t = sample_text(rng, 1, 5, vocab=vocab)
        texts.append(t)
        wav16 = render_text(
            t, 16_000, seed=int(rng.integers(1 << 30)),
            speaker=int(rng.integers(0, HARD_CORPUS["n_speakers"])),
            emotion=emotions[int(rng.integers(0, len(emotions)))],
            rate=float(rng.uniform(*HARD_CORPUS["rate_range"])))
        phrases.append(_resample(wav16, 3, 1, dev))

    encoder = SemanticEncoder(cfg, asr_params=bundle.asr_params,
                              buckets=(48_000 * 4,), device=dev)
    results = encoder.encode_batch(phrases)
    tx_wer = word_error_rate(texts, [r["text"] for r in results])

    synth = Synthesizer(cfg, tts_params=bundle.tts_params,
                        vocoder_params=bundle.vocoder_params,
                        default_speaker_vec=np.asarray(
                            bundle.default_speaker_vec), device=dev)
    rt_hyps: List[str] = []
    tags: Dict[str, int] = {}
    for r in results:
        p = JanusPacket(text=r["text"], prosody=r["prosody"], timestamp=0.0)
        p = JanusPacket.deserialize(p.serialize())  # through the real wire
        tag = synth._resolve_emotion(p)
        tags[tag] = tags.get(tag, 0) + 1
        pcm = _pcm(synth.synthesize(p))
        rt_hyps.append(encoder.encode_batch([pcm])[0]["text"] if len(pcm)
                       else "")
    return {
        "hard_roundtrip_wer": round(word_error_rate(texts, rt_hyps), 4),
        "hard_roundtrip_tx_wer": round(tx_wer, 4),
        "hard_roundtrip_n": n_utterances,
        "hard_roundtrip_emotion_tags": tags,
    }


def evaluate_hard_asr(params, cfg, n_utterances: int = 32, seed: int = 321,
                      device="cuda") -> Dict:
    """WER of the hard-corpus ASR (256 words, 16 speakers, 0.8-1.25x
    rates, emotion renderings) clean and under additive noise."""
    from janus_tpu_torch.train.demo import HARD_CORPUS, evaluate_asr

    tok = ByteTokenizer()
    out: Dict = {"hard_vocab_words": len(HARD_CORPUS["vocab"]),
                 "hard_n_speakers": HARD_CORPUS["n_speakers"]}
    for label, snr in (("clean", None), ("snr10", (10.0, 10.0)),
                       ("snr5", (5.0, 5.0)), ("snr0", (0.0, 0.0))):
        corpus = dict(HARD_CORPUS)
        corpus["clean_prob"] = 0.0  # pin each row's noise level exactly
        if snr is None:
            corpus.pop("snr_db_range", None)
        else:
            corpus["snr_db_range"] = snr
        wer, _ = evaluate_asr(params, cfg, tok, n_utterances=n_utterances,
                              seed=seed, corpus=corpus, max_seconds=3.84,
                              device=device)
        out[f"hard_wer_{label}"] = round(wer, 4)
    return out


def main(argv=None) -> None:
    from janus_tpu_torch.models import zoo
    from janus_tpu_torch.train.demo import (demo_asr_config, demo_tts_config,
                                            demo_vocoder_config,
                                            hard_asr_config)

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--asr-ckpt", default="checkpoints/demo_asr.npz")
    parser.add_argument("--tts-ckpt", default="checkpoints/demo_tts.npz")
    parser.add_argument("--voc-ckpt", default="checkpoints/demo_vocoder.npz")
    parser.add_argument("--hard-ckpt", default="checkpoints/demo_asr_hard.npz")
    parser.add_argument("--n", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    parser.add_argument(
        "--min-snr", type=float,
        default=float(os.environ.get("JANUS_MIN_SNR", "nan")),
        help="fail (exit 1) when the vocoder copy-synthesis SNR falls "
             "below this floor")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    kw: Dict = {}
    if os.path.exists(args.tts_ckpt):
        kw["tts_params"] = load_npz_params(args.tts_ckpt)
        kw["tts_cfg"] = demo_tts_config()
    if os.path.exists(args.voc_ckpt):
        kw["vocoder_params"] = load_npz_params(args.voc_ckpt)
        kw["vocoder_cfg"] = demo_vocoder_config()
    metrics = evaluate_roundtrip(load_npz_params(args.asr_ckpt),
                                 demo_asr_config(), n_utterances=args.n,
                                 device=args.device, **kw)
    if os.path.exists(args.hard_ckpt):
        metrics.update(evaluate_hard_asr(load_npz_params(args.hard_ckpt),
                                         hard_asr_config(),
                                         device=args.device))
    if zoo.hard_available():
        metrics.update(evaluate_hard_roundtrip(device=args.device))
    print(json.dumps(metrics, indent=2))
    if args.min_snr == args.min_snr:  # not NaN: the floor is armed
        if metrics["vocoder_copy_snr_db"] < args.min_snr:
            raise SystemExit(
                f"copy-synthesis SNR {metrics['vocoder_copy_snr_db']} dB "
                f"below the {args.min_snr} dB floor")


if __name__ == "__main__":
    main()
