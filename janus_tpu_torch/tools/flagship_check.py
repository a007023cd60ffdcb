"""Check of the flagship (Whisper large-v3 geometry) encoder on the card.

Runs the 635M-parameter encoder in bf16 on random mel at ``--frames``
(3000 = the canonical 30 s window) and ``--batch``, optionally with
``--layers`` encoder layers; ``--decode`` adds the KV-cached greedy
decode, ``--int8`` quantizes the weights per channel (int8 storage) and,
with ``--decode``, keeps the cross-attention K/V int8 as the serving
option ``asr.decode_cross_kv_int8`` does (the int8 cross-attention
kernel). Where the JAX package reports compile seconds, the port reports
the first call's milliseconds (kernel build and load, cuBLAS set-up).

Usage::

    python -m janus_tpu_torch.tools.flagship_check [--layers N] [--batch B] [--decode] [--int8]

Prints one JSON line: first-call ms, step ms and the encode RTF (and the
transcribe RTF with ``--decode``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from janus_tpu_torch.common.config import ASRConfig
from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.models import asr
from janus_tpu_torch.models.params import (cast_floating,
                                           flatten_with_paths, init_asr)
from janus_tpu_torch.ops.quant import quantize_tree
from janus_tpu_torch.tools.encode_profile import stage_ms

__all__ = ["check_flagship", "main"]

_EOT = 50257  # the Whisper vocabulary's end-of-text id


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _synced_ms(fn, dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, 1e3 * (time.perf_counter() - t0)


@torch.no_grad()
def check_flagship(params, cfg: ASRConfig, frames: int = 3000,
                   batch: int = 1, decode: bool = False, int8: bool = False,
                   max_new: int = 16, device="cuda") -> Dict:
    """The check on ``params`` already built (a bf16 tree; ``int8``
    quantizes a copy of it). Returns the JSON record."""
    dev = resolve_device(device)
    if int8:
        params = quantize_tree(params)
    n_params = sum(t.numel() for _, t in
                   flatten_with_paths(params["encoder"]))
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal(
        (batch, frames, cfg.n_mels)).astype(np.float32)).to(dev).to(
            torch.bfloat16)

    out, first_ms = _synced_ms(lambda: asr.encode_audio(params, cfg, mel),
                               dev)
    log(f"first call: {first_ms:.1f} ms, out shape {tuple(out.shape)}")
    step_ms = stage_ms(lambda: asr.encode_audio(params, cfg, mel), dev)
    audio_s = batch * frames * cfg.hop_length / 16_000
    result = {
        "metric": "flagship_encode_rtf",
        "value": step_ms / 1e3 / audio_s,
        "unit": "compute_s_per_audio_s",
        "geometry": f"large-v3/{cfg.encoder_layers}L",
        "params_m": round(n_params / 1e6, 1),
        "int8": int8,
        "first_call_ms": first_ms,
        "step_ms": step_ms,
        "batch": batch, "frames": frames,
        "platform": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
    }
    if decode:
        prompt = torch.zeros((batch, 1), dtype=torch.long, device=dev)

        def transcribe():
            enc = asr.encode_audio(params, cfg, mel)
            return asr.greedy_decode(params, cfg, enc, prompt, _EOT,
                                     max_new=max_new,
                                     cache_dtype=torch.bfloat16,
                                     cross_kv_int8=int8)

        toks, result["transcribe_first_call_ms"] = _synced_ms(transcribe, dev)
        result["transcribe_ms"] = stage_ms(transcribe, dev, k=2, reps=2)
        result["transcribe_rtf"] = result["transcribe_ms"] / 1e3 / audio_s
        result["tokens_shape"] = list(toks.shape)
    return result


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None,
                    help="override encoder layer count (default: full 32)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frames", type=int, default=3000,
                    help="mel frames (3000 = canonical 30 s window)")
    ap.add_argument("--decode", action="store_true",
                    help="also run the KV-cached greedy decode")
    ap.add_argument("--int8", action="store_true",
                    help="per-channel int8 weights (and int8 cross K/V "
                         "with --decode)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ASRConfig.large_v3()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, encoder_layers=args.layers)
    log(f"geometry: d_model={cfg.d_model} layers={cfg.encoder_layers} "
        f"heads={cfg.num_heads} n_mels={cfg.n_mels}")
    params = cast_floating(init_asr(torch.Generator(device=dev).manual_seed(0),
                                    cfg), torch.bfloat16)
    print(json.dumps(check_flagship(
        params, cfg, frames=args.frames, batch=args.batch,
        decode=args.decode, int8=args.int8, max_new=args.max_new,
        device=dev)), flush=True)


if __name__ == "__main__":
    main()
