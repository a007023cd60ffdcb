"""Per-stage profile of the send path's device work.

Times each stage of :meth:`SemanticEncoder._encode_impl
<janus_tpu_torch.runtime.codec.SemanticEncoder._encode_impl>` on its own
(YIN, RMS, decimate + log-mel, the encoder, the greedy decode) on random
audio, so optimization effort goes where the milliseconds are. On the card
a stage's time is CUDA-event time over ``k`` back-to-back calls, the
device synchronised before and after, the best of ``reps`` groups; on the
CPU (only when asked for) it is the host clock around the same loop.

Usage: ``python -m janus_tpu_torch.tools.encode_profile [--batch 8]
[--seconds 10] [--flagship] [--device cuda]``; prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from janus_tpu_torch.common.config import ASRConfig, JanusConfig
from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.models import asr as asr_mod
from janus_tpu_torch.models.params import (cast_floating, init_asr,
                                           prepare_decode_params)
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.ops.energy import rms_energy
from janus_tpu_torch.ops.resample import decimate_48k_to_16k
from janus_tpu_torch.ops.yin import yin_track
from janus_tpu_torch.runtime.codec import mel_frame_budget

__all__ = ["stage_ms", "profile_encode", "main"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def stage_ms(fn: Callable[[], object], device: torch.device, k: int = 10,
             reps: int = 3) -> float:
    """Best per-call milliseconds of ``fn`` over ``reps`` groups of ``k``
    calls, after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / k
        else:
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            ms = 1e3 * (time.perf_counter() - t0) / k
        best = min(best, ms)
    return best


@torch.no_grad()
def profile_encode(params, cfg: JanusConfig, batch: int = 8,
                   seconds: float = 10.0, device="cuda") -> Dict:
    """Stage times of the encode at ``batch`` phrases of ``seconds`` with
    ``params`` already built as :class:`SemanticEncoder` holds them (cast
    to ``cfg.asr.dtype``, decoder QKV fused). Returns the JSON record."""
    dev = resolve_device(device)
    acfg, pcfg = cfg.asr, cfg.prosody
    dtype = getattr(torch, acfg.dtype)
    bucket = int(48_000 * seconds)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((batch, bucket)) * 0.1)
                             .astype(np.float32)).to(dev)
    audio_s = batch * seconds
    n16 = mel_frame_budget(acfg, bucket)
    tok = ByteTokenizer()

    stages: Dict[str, float] = {}
    if pcfg.yin_rate == 16_000:
        a16 = decimate_48k_to_16k(audio)
        stages["yin"] = stage_ms(lambda: yin_track(
            a16, 16_000, pcfg.yin_window_16k, pcfg.yin_hop_16k,
            pcfg.yin_tolerance, fmin=pcfg.fmin_hz, fmax=pcfg.fmax_hz), dev)
    else:
        stages["yin"] = stage_ms(lambda: yin_track(
            audio, cfg.audio.sample_rate, pcfg.yin_window, pcfg.hop,
            pcfg.yin_tolerance, fmin=pcfg.fmin_hz, fmax=pcfg.fmax_hz), dev)
    stages["rms"] = stage_ms(lambda: rms_energy(audio, None), dev)

    def mel_fn():
        return asr_mod.prepare_mel(decimate_48k_to_16k(audio), acfg,
                                   pad_to_frames=n16)

    stages["decimate+mel"] = stage_ms(mel_fn, dev)
    mel = mel_fn().to(dtype)
    stages["encoder"] = stage_ms(
        lambda: asr_mod.encode_audio(params, acfg, mel), dev, k=3)
    enc = asr_mod.encode_audio(params, acfg, mel)
    prompt = torch.tensor(tok.sot_sequence(), dtype=torch.long,
                          device=dev).expand(batch, 1)
    stages["greedy_decode"] = stage_ms(lambda: asr_mod.greedy_decode(
        params, acfg, enc, prompt, tok.eot, max_new=acfg.max_decode_tokens,
        cache_dtype=dtype, cross_kv_int8=acfg.decode_cross_kv_int8),
        dev, k=2)

    total = sum(stages.values())
    for name, ms in stages.items():
        log(f"{name:>14}: {ms:8.2f} ms  ({100 * ms / total:5.1f}%)  "
            f"rtf={ms / 1e3 / audio_s:.6f}")
    return {
        "metric": "encode_stage_profile",
        "stages_ms": stages,
        "sum_ms": total,
        "sum_rtf": total / 1e3 / audio_s,
        "batch": batch, "seconds": seconds,
        "geometry": f"d{acfg.d_model}/L{acfg.encoder_layers}",
        "platform": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--flagship", action="store_true",
                    help="large-v3 geometry instead of the default tiny")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = JanusConfig()
    if args.flagship:
        cfg = dataclasses.replace(cfg, asr=ASRConfig.large_v3())
    cfg = cfg.override(**{"asr.max_decode_tokens": 24})
    params = prepare_decode_params(cast_floating(
        init_asr(torch.Generator(device=dev).manual_seed(0), cfg.asr),
        getattr(torch, cfg.asr.dtype)))
    print(json.dumps(profile_encode(params, cfg, args.batch, args.seconds,
                                    device=dev)), flush=True)


if __name__ == "__main__":
    main()
