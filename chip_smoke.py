#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's send and receive paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the four hand-written CUDA
kernels from ``janus_tpu_torch/csrc`` (one ``nvcc`` per source, all at
once, into ``build/janus_tpu_torch/``) and runs these phases, each
printing one JSON line per result:

1. device  — the card, its power limit, the kernel build time;
2. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes, with times, the card's bound and, where one
   PyTorch call computes the same function, that call's time. Every
   kernel is timed as device time (``kernel_ms``: launches replayed from a
   CUDA graph) and as an eager loop (``eager_ms``, which the host bounds
   when the kernel is shorter than its wrapper call, ``host_us``); K1, K2
   and K3 also through their earlier kernel on the same inputs
   (``dense_ms``, ``simt_ms``, ``simple_ms``);
3. demo    — the committed demo recognizer through ``SemanticEncoder`` on
   the card and on the CPU: the packets must be byte-equal; then the same
   under the int8 configuration (``quantize_tree`` weights in each mode,
   ``asr.decode_cross_kv_int8``), which must launch the K4 kernel;
4. flagship — Whisper large-v3 (random weights from seed 0, bf16) encoding
   8 phrases of 10 s through ``SemanticEncoder.encode_batch``: per-stage
   and end-to-end times, launches of each kernel in that run, and the
   encoder output against a plain-version pass;
5. flagship int8 — the same model with dynamic-int8 weights and int8
   cross K/V (the analogue of CTranslate2 ``compute_type='int8'``): times,
   launches (K4 once per decoder layer and forward), one decode step's
   logits against the plain cross-attention, token agreement with phase 4;
6. receive_demo — the committed demo TTS, vocoder and speaker encoder
   through ``Synthesizer`` on the card and on the CPU (Morse bytes equal;
   TTS modes: the same sample count and the PCM within a stated bar),
   ``synthesize_streaming`` against ``synthesize`` on the card, and the
   round trip phrase → packet → speech → packet, card against CPU;
7. receive_flagship — ``TTSConfig.flagship()`` (d 1280, 30 layers, random
   bf16 weights from seed 0) with the default vocoder: generate + vocode +
   resample over the full budget of 256 groups at b = 8 and b = 1, stage
   times, one traced AR step, and prefill + 4 groups against the CPU;
8. receive_stream — ``StreamingSynthesizer`` at that width: seconds to
   first audio and in all, and the stream against the fused path;
9. the ``kernels`` summary line. The receive side runs no hand-written
   kernel (the JAX package's has no Pallas kernel either), so its phases
   add no row there.

Then the card's name and power limit as ``nvidia-smi`` prints them, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no result; it also exits
non-zero without a card or without the package beside it. It imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

# H100 SXM data sheet (dense): fp32 outside the tensor cores, bf16 tensor
# cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

SR = 48_000
FLAGSHIP_BATCH = 8
FLAGSHIP_SECONDS = 10.0
MEL_SECONDS = (10, 30)           # K1 at the 10 s bucket and the 30 s window
FLASH_T = (500, 1500)            # K2 at the 10 s bucket and the 30 s window
CROSS_T = (500, 1500)            # K4 at the 10 s bucket and the 30 s window
DEMO_TEXTS = ("alpha bravo", "fox golf hotel", "kilo lima")
DEMO_TIMESTAMP = 1_700_000_000.25
RECEIVE_BATCHES = (8, 1)
RECEIVE_GROUPS = 256             # the flagship TTS's full budget: 1024 frames
RECEIVE_STREAM_FRAMES = 512      # the streaming run's mel budget


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound_ms(ops: float, op_peak: float, nbytes: float):
    t_ops, t_bytes = ops / op_peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def profile_step(torch, step, steps: int = 3) -> dict:
    """``step()``, timed bare (median of ``steps``) and then traced once
    under ``torch.profiler``: the kernels the device ran, the host's
    kernel-launch calls, the device's busy time, and its idle share of the
    bare step's wall time. The trace is a reading, not a check: without
    device events it reports nulls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_ms = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                   and e.name.startswith("cudaLaunchKernel"))
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    return {"wall_ms": wall_ms, "wall_ms_all": walls,
            "device_events": len(device), "host_kernel_launches": launches,
            "device_busy_ms": busy_ms if device else None,
            "device_idle_share": (max(0.0, 1.0 - busy_ms / wall_ms)
                                  if device else None)}


def profile_decode_step(torch, asr_mod, params, acfg, enc, prompt,
                        steps: int = 3, cross_kv_int8: bool = False) -> dict:
    """One greedy decode step of the recognizer through
    :func:`profile_step`."""
    state = asr_mod.init_decode_state(params, acfg, enc,
                                      max_len=prompt.shape[-1] + steps + 1,
                                      dtype=torch.bfloat16,
                                      cross_kv_int8=cross_kv_int8)
    _, state = asr_mod.decoder_prefill(params, acfg, prompt, state)
    tok = prompt[:, -1]
    return profile_step(
        torch, lambda: asr_mod.decoder_step(params, acfg, tok, state), steps)


def synced_ms(torch, fn):
    """``(fn(), ms)`` with the device synchronised around the call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def pcm_float(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32767.0


class ErrorRecords(logging.Handler):
    """Keeps every record at ERROR or above: the synthesizer's ladder
    logs a failure and degrades, which must not pass for success here."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def receive_demo(torch, dev) -> None:
    """The demo checkpoints through ``Synthesizer`` on the card and on the
    CPU, streaming against fused on the card, and the round trip."""
    from janus_tpu_torch.audio.synthetic import render_text
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.common.protocol import JanusMode, JanusPacket
    from janus_tpu_torch.models.zoo import load_demo
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    bundle = load_demo(base=JanusConfig())
    synths = {d: Synthesizer(
        bundle.config, tts_params=bundle.tts_params,
        vocoder_params=bundle.vocoder_params,
        speaker_params=bundle.speaker_params,
        default_speaker_vec=bundle.default_speaker_vec, device=d)
        for d in ("cuda", "cpu")}
    packets = [
        JanusPacket(text="SOS", mode=JanusMode.MORSE_CODE),
        JanusPacket(text=DEMO_TEXTS[2], mode=JanusMode.TEXT_ONLY),
        JanusPacket(text=DEMO_TEXTS[0], mode=JanusMode.SEMANTIC_VOICE,
                    prosody={"pitch": "High", "energy": "Loud"})]
    # fp32 weights, bf16 generation caches: a cached value may round to the
    # neighbouring bf16 on one side, which the later steps carry
    bar = 1e-2
    rows = []
    for pkt in packets:
        got, ref = (synths[d].synthesize(pkt) for d in ("cuda", "cpu"))
        check(len(got) > 0 and len(got) == len(ref),
              f"receive_demo '{pkt.text}': {len(got)} bytes on the card, "
              f"{len(ref)} on the CPU")
        if pkt.mode == JanusMode.MORSE_CODE:
            check(got == ref, "receive_demo: Morse bytes differ")
            err = 0.0
        else:
            err = float(np.abs(pcm_float(got) - pcm_float(ref)).max())
            check(err <= bar, f"receive_demo '{pkt.text}': PCM differs by "
                  f"{err} of full scale (bar {bar})")
        rows.append({"mode": pkt.mode.name, "text": pkt.text,
                     "samples": len(got) // 2, "max_abs_err": err,
                     "peak": float(np.abs(pcm_float(got)).max())})

    # streaming against fused on the card: the float streams agree to
    # rounding (bar 1e-4 of full scale), and int16 truncation can turn
    # any difference into one step
    stream_bar = 1e-4 + 1.0 / 32767.0
    pkt = packets[2]
    whole = synths["cuda"].synthesize(pkt)
    chunks = list(synths["cuda"].synthesize_streaming(pkt))
    joined = b"".join(chunks)
    check(len(chunks) > 1 and all(chunks), f"receive_demo: streamed "
          f"{len(chunks)} chunks")
    check(len(joined) == len(whole), f"receive_demo: streamed "
          f"{len(joined)} bytes, fused {len(whole)}")
    stream_err = float(np.abs(pcm_float(joined) - pcm_float(whole)).max())
    check(stream_err <= stream_bar, f"receive_demo: stream differs from "
          f"fused by {stream_err} (bar {stream_bar})")

    # phrase -> packet -> speech -> packet again, card against CPU
    encoders = {d: SemanticEncoder(bundle.config, bundle.asr_params,
                                   buckets=(96_000,), device=d)
                for d in ("cuda", "cpu")}
    trips = []
    for seed, text in enumerate(DEMO_TEXTS):
        phrase = render_text(text, SR, seed=seed)
        heard = {}
        for d in ("cuda", "cpu"):
            first = encoders[d].encode_packet(phrase,
                                              timestamp=DEMO_TIMESTAMP)
            check(first is not None, f"receive_demo: no packet for '{text}'")
            pcm = synths[d].synthesize(first)
            check(len(pcm) > 0, f"receive_demo: empty speech for '{text}'")
            second = encoders[d].encode_packet(pcm_float(pcm),
                                               timestamp=DEMO_TIMESTAMP)
            heard[d] = (first.text, None if second is None else second.text)
        check(heard["cuda"] == heard["cpu"], f"receive_demo: round trip of "
              f"'{text}' gives {heard['cuda']} on the card, {heard['cpu']} "
              f"on the CPU")
        trips.append({"spoken": text, "first": heard["cuda"][0],
                      "second": heard["cuda"][1],
                      "second_cpu": heard["cpu"][1]})
    emit({"phase": "receive_demo", "bar": bar, "packets": rows,
          "stream_chunks": len(chunks), "stream_vs_fused_max_abs": stream_err,
          "stream_bar": stream_bar, "round_trip": trips})


def receive_flagship(torch, dev):
    """Flagship TTS + default vocoder, random bf16 weights: generate +
    vocode + resample over the full budget at b = 8 and b = 1. Returns
    what :func:`receive_stream` reuses."""
    from janus_tpu_torch.common.config import TTSConfig, VocoderConfig
    from janus_tpu_torch.models import tts as tts_mod
    from janus_tpu_torch.models import vocoder as voc_mod
    from janus_tpu_torch.models.params import (cast_floating,
                                               flatten_with_paths, tree_to)
    from janus_tpu_torch.models.tokenizer import ByteTokenizer
    from janus_tpu_torch.ops.resample import resample_poly

    tok = ByteTokenizer()
    tcfg, vcfg = TTSConfig.flagship(), VocoderConfig()
    up = 48_000 // vcfg.sample_rate
    t0 = time.perf_counter()
    tts_params = cast_floating(tts_mod.init_tts(
        torch.Generator(device=dev).manual_seed(0), tcfg,
        text_vocab=tok.vocab_size), torch.bfloat16)
    voc_params = cast_floating(voc_mod.init_vocoder(
        torch.Generator(device=dev).manual_seed(1), vcfg,
        n_mels=tcfg.n_mels), torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in flatten_with_paths(tts_params))
    max_groups = RECEIVE_GROUPS
    n_frames = max_groups * tcfg.reduction
    lane_seconds = n_frames * vcfg.hop_length / vcfg.sample_rate

    def generate(text, emo):
        return tts_mod.tts_generate(
            tts_params, tcfg, text, emo, max_groups=max_groups,
            text_vocab=tok.vocab_size, stop_threshold=2.0)  # full budget

    def vocode(mel):
        wav = voc_mod.vocoder_waveform(voc_params, vcfg, mel)
        return resample_poly(wav, up=up, down=1)

    out = {"phase": "receive_flagship",
           "model": "TTSConfig.flagship() + VocoderConfig() (random, seeds "
                    "0 and 1)", "dtype": "bfloat16 weights, bfloat16 caches, "
           "float32 step activations", "tts_params_m": n_params / 1e6,
           "max_groups": max_groups, "lane_seconds": lane_seconds,
           "init_s": round(init_s, 3), "batches": {}}
    with torch.no_grad():
        for b in RECEIVE_BATCHES:
            text = torch.zeros((b, 32), dtype=torch.long, device=dev)
            emo = torch.zeros((b,), dtype=torch.long, device=dev)
            vocode(generate(text, emo)[0])  # warm-up
            torch.cuda.reset_peak_memory_stats()
            e2e = []
            for _ in range(3):
                wav, ms = synced_ms(torch, lambda: vocode(
                    generate(text, emo)[0]))
                e2e.append(ms)
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            check(tuple(wav.shape) == (b, n_frames * vcfg.hop_length * up)
                  and bool(torch.isfinite(wav).all()),
                  f"receive_flagship b={b}: waveform {tuple(wav.shape)}")
            # the same stages, one at a time, synchronised around each
            _, prefill_ms = synced_ms(torch, lambda: tts_mod.tts_prefill(
                tts_params, tcfg, text, emo, max_groups=max_groups,
                text_vocab=tok.vocab_size, stop_threshold=2.0))
            (mel, frames), gen_ms = synced_ms(torch,
                                              lambda: generate(text, emo))
            check(frames.tolist() == [n_frames] * b,
                  f"receive_flagship b={b}: n_frames {frames.tolist()}")
            spec, spectra_ms = synced_ms(torch, lambda: voc_mod.
                                         vocoder_spectra(voc_params, vcfg,
                                                         mel))
            wav24, istft_ms = synced_ms(torch, lambda: voc_mod.
                                        spectra_to_waveform(vcfg, spec))
            _, resample_ms = synced_ms(torch, lambda: resample_poly(
                wav24, up=up, down=1))
            # one AR step, traced
            first, done, state = tts_mod.tts_prefill(
                tts_params, tcfg, text, emo, max_groups=8,
                text_vocab=tok.vocab_size, stop_threshold=2.0)
            at = [0]

            def ar_step():
                tts_mod.tts_decode_chunk(tts_params, tcfg, state, first, done,
                                         at[0], n_steps=1, stop_threshold=2.0)
                at[0] += 1

            ar_trace = profile_step(torch, ar_step)
            best = min(e2e)
            out["batches"][str(b)] = {
                "e2e_ms": e2e, "rtf_per_lane_second": best / 1e3
                / (b * lane_seconds), "peak_mem_gib": peak_gib,
                "stage_ms": {"prefill": prefill_ms, "generate": gen_ms,
                             "ar_loop": gen_ms - prefill_ms,
                             "ar_step": (gen_ms - prefill_ms)
                             / (max_groups - 1),
                             "vocoder_spectra": spectra_ms,
                             "istft": istft_ms, "resample_24k_48k":
                             resample_ms},
                "ar_step_trace": ar_trace,
                "wav_peak": float(wav.abs().max())}

        # prefill + 4 groups at b = 1, the card against the CPU, bf16
        # weights on both: 5e-2 relative, the bar of the recognizer's
        # encoder-vs-plain check (bf16 roundings through 30 layers)
        def first_groups(params, device):
            text = torch.zeros((1, 32), dtype=torch.long, device=device)
            emo = torch.zeros((1,), dtype=torch.long, device=device)
            first, done, state = tts_mod.tts_prefill(
                params, tcfg, text, emo, max_groups=8,
                text_vocab=tok.vocab_size, stop_threshold=2.0)
            groups, *_ = tts_mod.tts_decode_chunk(
                params, tcfg, state, first, done, 0, n_steps=4,
                stop_threshold=2.0)
            return torch.cat([first.float()[:, None], groups], dim=1).cpu()

        (on_card, card_ms) = synced_ms(torch, lambda: first_groups(
            tts_params, dev))
        t0 = time.perf_counter()
        on_cpu = first_groups(tree_to(tts_params, "cpu"), "cpu")
        cpu_s = time.perf_counter() - t0
    rel = float((on_card - on_cpu).norm() / on_cpu.norm())
    check(bool(torch.isfinite(on_card).all()) and rel <= 5e-2,
          f"receive_flagship: prefill + 4 groups differ from the CPU by "
          f"{rel} relative")
    out["first_groups_vs_cpu"] = {
        "bar_rel": 5e-2, "rel": rel,
        "max_abs": float((on_card - on_cpu).abs().max()),
        "ref_peak": float(on_cpu.abs().max()), "cpu_s": round(cpu_s, 2)}
    emit(out)
    return tcfg, vcfg, tts_params, voc_params


def receive_stream(torch, dev, tcfg, vcfg, tts_params, voc_params) -> None:
    """``StreamingSynthesizer`` at flagship width: first audio, total, and
    the stream against the fused path."""
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.models import tts as tts_mod
    from janus_tpu_torch.models import vocoder as voc_mod
    from janus_tpu_torch.ops.resample import resample_poly
    from janus_tpu_torch.runtime.streaming_tts import StreamingSynthesizer

    scfg = dataclasses.replace(
        JanusConfig(), vocoder=vcfg,
        tts=dataclasses.replace(tcfg, max_mel_frames=RECEIVE_STREAM_FRAMES))
    # random-weight stop logits sit near 0; a hard negative bias makes the
    # stream run to the duration cap every time
    stop = tts_params["stop_head"]
    params = {**tts_params, "stop_head": {
        **stop, "b": torch.full_like(stop["b"], -5.0)}}
    streamer = StreamingSynthesizer(scfg, tts_params=params,
                                    vocoder_params=voc_params,
                                    chunk_groups=16, device="cuda")
    text = "status report follows all clear"
    chunks = list(streamer.stream(text))  # warm-up, and the comparison
    got = np.concatenate(chunks)
    torch.cuda.synchronize()
    turns = [streamer.turnaround(text) for _ in range(2)]
    first_s, total_s, n48 = min(turns, key=lambda t: t[0])

    # the fused path on the same prompt, as Synthesizer._run_tts runs it
    tok = streamer.tokenizer
    ids = tok.encode(text)[: scfg.tts.max_text_tokens]
    padded = np.full((1, tts_mod.text_bucket(
        len(ids), scfg.tts.max_text_tokens)), tok.pad, np.int64)
    padded[0, : len(ids)] = ids
    with torch.no_grad():
        (mel, frames), fused_gen_ms = synced_ms(
            torch, lambda: tts_mod.tts_generate(
                params, scfg.tts, torch.from_numpy(padded).to(dev),
                torch.zeros((1,), dtype=torch.long, device=dev),
                text_vocab=tok.vocab_size))
        wav, fused_voc_ms = synced_ms(torch, lambda: resample_poly(
            voc_mod.vocoder_waveform(voc_params, vcfg, mel),
            up=48_000 // vcfg.sample_rate, down=1))
    cap = int((0.35 + scfg.tts.max_seconds_per_text_token * len(ids))
              * 48_000)
    n_fused = min(int(frames[0]) * vcfg.hop_length * 48_000
                  // vcfg.sample_rate, cap)
    ref = wav[0, :n_fused].cpu().numpy()
    check(len(chunks) > 1 and n48 == len(got) == len(ref),
          f"receive_stream: {len(chunks)} chunks, {len(got)} samples "
          f"streamed, {n48} timed, {len(ref)} fused")
    # bf16 vocoder weights, fp32 activations: the chunked backbone runs
    # its GEMMs over chunk + 2 halo rows, the fused one over all rows
    bar = 2e-2
    err = float(np.abs(got - ref).max())
    check(bool(np.isfinite(got).all()) and err <= bar,
          f"receive_stream: stream differs from fused by {err} (bar {bar})")
    emit({"phase": "receive_stream", "text": text, "chunk_groups": 16,
          "max_mel_frames": scfg.tts.max_mel_frames, "chunks": len(chunks),
          "first_audio_s": first_s, "total_s": total_s,
          "audio_s": n48 / 48_000, "turnarounds": turns,
          "fused_ms": {"generate": fused_gen_ms, "vocode_resample":
                       fused_voc_ms},
          "stream_vs_fused_max_abs": err, "bar": bar,
          "wav_peak": float(np.abs(ref).max())})


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    try:
        import janus_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout that holds janus_tpu_torch/",
              file=sys.stderr)
        sys.exit(1)

    from janus_tpu_torch.common.device import resolve_device
    from janus_tpu_torch.ops import cuda_build

    dev = resolve_device("cuda")

    def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
        """Device time of one ``fn()``: ``iters`` calls captured in a CUDA
        graph and replayed, so that no host time lies between launches."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (iters * replays)

    def yardstick_ms(fn, iters: int = 20):
        """(ms, how) of a plain version or a library call: device time from
        a graph replay where the call can be captured, else an eager loop."""
        try:
            return graph_ms(fn, iters=iters), "graph"
        except RuntimeError:
            torch.cuda.synchronize()
            return time_ms(fn, iters=iters), "eager"

    def wrapper_us(fn, calls: int = 500) -> float:
        """Host time of one wrapper call: ``calls`` of them with no
        synchronise between."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        return us

    def max_abs(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    def worst_ratio(out, ref, rtol: float, atol: float) -> float:
        """Worst |out - ref| / (atol + rtol |ref|): a check is <= 1."""
        ref = ref.float()
        return float(((out.float() - ref).abs()
                      / (atol + rtol * ref.abs())).max())

    # -- 1. device ---------------------------------------------------------
    smi = nvidia_smi_line()
    build_s = cuda_build.build_all()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": round(build_s, 3)})

    summary = {}
    gen = torch.Generator(device=dev).manual_seed(1234)

    # -- 2. kernels against their plain versions --------------------------
    from janus_tpu_torch.ops.mel import (_floor_and_scale,
                                         log_mel_spectrogram, mel_filterbank)
    from janus_tpu_torch.ops.mel_fused import KERNEL as MEL
    from janus_tpu_torch.ops.mel_fused import (log_mel_spectrogram_fused,
                                               mel_log10, mel_route)

    def mel_features(audio, n_mels, route):
        return _floor_and_scale(mel_log10(audio, n_mels=n_mels, route=route))

    for seconds in MEL_SECONDS:
        for n_mels in (128, 80):
            audio = 0.1 * torch.randn((FLAGSHIP_BATCH, seconds * 16_000),
                                      generator=gen, device=dev)
            out = log_mel_spectrogram_fused(audio, n_mels=n_mels)
            ref = log_mel_spectrogram(audio, n_mels=n_mels)
            dense = mel_features(audio, n_mels, "dense")
            torch.cuda.synchronize()
            err, dense_err = max_abs(out, ref), max_abs(dense, ref)
            # the least work log-mel needs, not the matmul-DFT's: a real FFT
            # per frame (2.5 n log2 n), |X|^2, the filterbank's nonzero
            # taps and one log per mel
            n_frames, n_freqs = out.shape[-2] * FLAGSHIP_BATCH, 201
            fb_nnz = int((mel_filterbank(16_000, 400, n_mels) != 0).sum())
            ops = n_frames * (2.5 * 400 * np.log2(400) + 3 * n_freqs
                              + 2 * fb_nnz + n_mels)
            nbytes = 4 * (audio.numel() + out.numel())
            b_ms, b_by = bound_ms(ops, PEAK_FP32, nbytes)
            plain_ms, plain_how = yardstick_ms(
                lambda: log_mel_spectrogram(audio, n_mels=n_mels))
            # kernel_ms, dense_ms: the launch alone (mel_log10), device time;
            # fused_ms: with the floor and the scale, as the path calls it
            row = {"phase": "kernel", "name": "mel_fused",
                   "batch": FLAGSHIP_BATCH,
                   "seconds": seconds, "n_mels": n_mels,
                   "route": mel_route(400), "atol": 5e-5,
                   "max_err": err, "dense_max_err": dense_err,
                   "kernel_ms": graph_ms(lambda: mel_log10(
                       audio, n_mels=n_mels)),
                   "eager_ms": time_ms(lambda: mel_log10(
                       audio, n_mels=n_mels)),
                   "host_us": wrapper_us(lambda: mel_log10(
                       audio, n_mels=n_mels)),
                   "dense_ms": graph_ms(lambda: mel_log10(
                       audio, n_mels=n_mels, route="dense"), iters=5),
                   "fused_ms": graph_ms(lambda: log_mel_spectrogram_fused(
                       audio, n_mels=n_mels)),
                   "plain_ms": plain_ms, "plain_timing": plain_how,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            emit(row)
            check(err <= 5e-5, f"mel_fused {seconds}s/{n_mels} err {err}")
            check(dense_err <= 5e-5, f"mel_fused dense route {seconds}s/"
                  f"{n_mels} err {dense_err}")
            check(torch.equal(out, log_mel_spectrogram_fused(
                audio, n_mels=n_mels)) and torch.equal(dense, mel_features(
                    audio, n_mels, "dense")),
                f"mel_fused {seconds}s/{n_mels}: two launches differ")
            check(row["kernel_ms"] < row["dense_ms"],
                  f"mel_fused {seconds}s/{n_mels}: the FFT kernel "
                  f"({row['kernel_ms']} ms) is no faster than the dense one "
                  f"({row['dense_ms']} ms)")
            if seconds == MEL_SECONDS[0] and n_mels == 128:
                summary["mel_fused"] = row

    # an odd signal length, a batch of 1, an odd frame count (the last pair
    # of frames is half empty), 1 and 77 mels, rows that are not contiguous
    for shape, n_mels, sliced in (((3, 16_123), 77, False),
                                  ((1, 16_000), 1, False),
                                  ((2, 8_160), 128, False),
                                  ((4, 20_000), 80, True)):
        audio = 0.1 * torch.randn(shape, generator=gen, device=dev)
        if sliced:
            audio = audio[:, 3:16_003]
        ref = log_mel_spectrogram(audio, n_mels=n_mels)
        errs = {route: max_abs(mel_features(audio, n_mels, route), ref)
                for route in ("fft", "dense")}
        emit({"phase": "kernel", "name": "mel_fused", "shape": list(shape),
              "n_mels": n_mels, "frames": ref.shape[-2], "sliced": sliced,
              "atol": 5e-5, "max_err": errs})
        check(max(errs.values()) <= 5e-5,
              f"mel_fused {shape}/{n_mels} err {errs}")

    from janus_tpu_torch.ops.flash import KERNEL as FLASH
    from janus_tpu_torch.ops.flash import (attend_bh, flash_forward,
                                           flash_route)

    bh, dh = FLAGSHIP_BATCH * 20, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # bf16: the output is rounded to bf16 (rtol: two bf16 ulps of |ref|, an
    # ulp being at most 2^-7 of the value), and each version rounds p to
    # bf16 before PV, the kernel against the running row max (atol: it
    # shows where outputs cancel to near zero; 3.9e-3 at most on the H100
    # without a mask, 1.6e-2 causal, where early rows see few keys)
    flash_bars = {torch.float32: (0.0, 2e-5, PEAK_FP32),
                  torch.bfloat16: (2 ** -6, 5e-3, PEAK_BF16)}
    flash_rows = [(t, dtype, False) for t in FLASH_T
                  for dtype in (torch.float32, torch.bfloat16)]
    flash_rows.append((FLASH_T[0], torch.bfloat16, True))
    for t, dtype, causal in flash_rows:
        rtol, atol, peak = flash_bars[dtype]
        q, k, v = (torch.randn((bh, t, dh), generator=gen,
                               device=dev).to(dtype) for _ in range(3))
        out = flash_forward(q, k, v, causal)
        ref = attend_bh(q, k, v, causal)
        torch.cuda.synchronize()
        err = max_abs(out, ref)
        tol_ratio = worst_ratio(out, ref, rtol, atol)
        # causal: the lower triangle (with its diagonal) of the products
        ops = 4.0 * bh * dh * (t * (t + 1) / 2 if causal else t * t)
        nbytes = 4 * q.numel() * q.element_size()
        b_ms, b_by = bound_ms(ops, peak, nbytes)
        # the library yardstick on [B, H, T, Dh], the layout its fused
        # backends take
        q4, k4, v4 = (x.view(FLAGSHIP_BATCH, 20, t, dh) for x in (q, k, v))
        route = flash_route(dtype, dh)
        row = {"phase": "kernel", "name": "flash_attn", "bh": bh, "t": t,
               "head_dim": dh, "dtype": str(dtype).split(".")[-1],
               "causal": causal, "route": route,
               "rtol": rtol, "atol": atol, "max_err": err,
               "tol_ratio": tol_ratio,
               "kernel_ms": graph_ms(lambda: flash_forward(q, k, v, causal)),
               "eager_ms": time_ms(lambda: flash_forward(q, k, v, causal)),
               "simt_ms": graph_ms(lambda: flash_forward(
                   q, k, v, causal, route="simt"), iters=5),
               "plain_ms": graph_ms(lambda: attend_bh(q, k, v, causal),
                                    iters=5),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": graph_ms(lambda: sdpa(q4, k4, v4,
                                                   is_causal=causal))}
        emit(row)
        check(tol_ratio <= 1.0, f"flash_attn t={t} {dtype} causal={causal} "
              f"err {err} beyond rtol {rtol} atol {atol}")
        if route == "wgmma":
            check(row["kernel_ms"] < row["simt_ms"],
                  f"flash_attn t={t}: the tensor-core kernel "
                  f"({row['kernel_ms']} ms) is no faster than the SIMT one "
                  f"({row['simt_ms']} ms)")
        if t == FLASH_T[0] and dtype == torch.bfloat16 and not causal:
            summary["flash_attn"] = row

    # key length != query length, a ragged last tile, one query row
    rtol, atol, _ = flash_bars[torch.bfloat16]
    for fbh, tq_, tk_ in ((2, 130, 500), (2, 1, 65), (3, 64, 52)):
        q = torch.randn((fbh, tq_, dh), generator=gen,
                        device=dev).to(torch.bfloat16)
        k, v = (torch.randn((fbh, tk_, dh), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        tol_ratio = worst_ratio(flash_forward(q, k, v), attend_bh(
            q, k, v, False), rtol, atol)
        emit({"phase": "kernel", "name": "flash_attn", "bh": fbh, "tq": tq_,
              "tk": tk_, "head_dim": dh, "dtype": "bfloat16",
              "route": flash_route(torch.bfloat16, dh),
              "tol_ratio": tol_ratio})
        check(tol_ratio <= 1.0, f"flash_attn tq={tq_} tk={tk_} beyond rtol "
              f"{rtol} atol {atol}")

    from janus_tpu_torch.ops.yin import _pad_stream, _search_bounds
    from janus_tpu_torch.ops.yin_blocksums import KERNEL as YIN
    from janus_tpu_torch.ops.yin_blocksums import (_rows_view, block_sums,
                                                   block_sums_plain,
                                                   plan_rows)

    audio16 = 0.1 * torch.randn((FLAGSHIP_BATCH,
                                 int(FLAGSHIP_SECONDS * 16_000)),
                                generator=gen, device=dev)
    padded, n_hops = _pad_stream(audio16, 1360, 170)
    nblk, hop, n_lags = n_hops + 3, 170, 402
    out = block_sums(padded, nblk, hop, n_lags)
    simple = block_sums(padded, nblk, hop, n_lags, route="simple")
    ref = block_sums_plain(padded, nblk, hop, n_lags)
    first, rows = _rows_view(padded, nblk, hop, n_lags)
    groups = FLAGSHIP_BATCH * nblk
    rows_c = rows.reshape(1, groups, -1).contiguous()
    first_c = first.reshape(groups, 1, hop).contiguous()

    def grouped_conv():
        return torch.nn.functional.conv1d(rows_c, first_c, groups=groups)

    lib_out = grouped_conv().reshape(out.shape)
    torch.cuda.synchronize()
    err = max_abs(out, ref)
    rel_ok = bool(((out - ref).abs() <= 2e-4 + 2e-4 * ref.abs()).all())
    ops = 2.0 * FLAGSHIP_BATCH * nblk * n_lags * hop
    nbytes = 4 * (padded.numel() + out.numel())
    b_ms, b_by = bound_ms(ops, PEAK_FP32, nbytes)
    plain_ms, plain_how = yardstick_ms(
        lambda: block_sums_plain(padded, nblk, hop, n_lags), iters=3)
    library_ms, library_how = yardstick_ms(grouped_conv, iters=3)
    row = {"phase": "kernel", "name": "yin_block_sums",
           "batch": FLAGSHIP_BATCH, "seconds": FLAGSHIP_SECONDS,
           "nblk": nblk, "hop": hop, "n_lags": n_lags, "route": "tiled",
           "rows_per_block": plan_rows(hop, n_lags).rows,
           "rtol": 2e-4, "atol": 2e-4, "max_err": err,
           "equals_simple": bool(torch.equal(out, simple)),
           "library_max_err": max_abs(lib_out, ref),
           "kernel_ms": graph_ms(lambda: block_sums(padded, nblk, hop,
                                                    n_lags)),
           "eager_ms": time_ms(lambda: block_sums(padded, nblk, hop,
                                                  n_lags)),
           "host_us": wrapper_us(lambda: block_sums(padded, nblk, hop,
                                                    n_lags)),
           "simple_ms": graph_ms(lambda: block_sums(
               padded, nblk, hop, n_lags, route="simple")),
           "plain_ms": plain_ms, "plain_timing": plain_how,
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms, "library_timing": library_how}
    emit(row)
    check(rel_ok, f"yin_block_sums outside rtol/atol 2e-4 (max err {err})")
    check(row["equals_simple"], "yin_block_sums: the tiled and the simple "
          "kernel differ on the same input")
    check(torch.equal(out, block_sums(padded, nblk, hop, n_lags)),
          "yin_block_sums: two launches differ")
    check(row["kernel_ms"] < row["simple_ms"],
          f"yin_block_sums: the tiled kernel ({row['kernel_ms']} ms) is no "
          f"faster than the simple one ({row['simple_ms']} ms)")
    summary["yin_block_sums"] = row

    # the 48 kHz geometry with its own lag count; a lag count that leaves 3
    # of a thread's 8 lags; row counts that are no multiple of the plan's;
    # a signal shorter than one row's span
    lags48 = _search_bounds(4096, 48_000, 40.0, 1000.0)[2]
    for buf, hop_, lags_, shape in ((4096, 512, lags48, (2, 96_000)),
                                    (4096, 512, 2048, (1, 20_000)),
                                    (1360, 170, 403, (3, 3_000)),
                                    (1360, 170, 17, (2, 5_000)),
                                    (1360, 170, 402, (1, 300))):
        audio = 0.1 * torch.randn(shape, generator=gen, device=dev)
        padded_, hops_ = _pad_stream(audio, buf, hop_)
        nblk_ = hops_ + (buf // 2) // hop_ - 1
        ref = block_sums_plain(padded_, nblk_, hop_, lags_)
        tiled = block_sums(padded_, nblk_, hop_, lags_)
        equal = bool(torch.equal(tiled, block_sums(padded_, nblk_, hop_,
                                                   lags_, route="simple")))
        tol_ratio = worst_ratio(tiled, ref, 2e-4, 2e-4)
        emit({"phase": "kernel", "name": "yin_block_sums", "buf": buf,
              "hop": hop_, "n_lags": lags_, "shape": list(shape),
              "nblk": nblk_, "rows_per_block": plan_rows(hop_, lags_).rows,
              "tol_ratio": tol_ratio, "equals_simple": equal})
        check(tol_ratio <= 1.0 and equal, f"yin_block_sums {buf}/{hop_}/"
              f"{lags_} {shape}: tol_ratio {tol_ratio}, equal {equal}")

    from janus_tpu_torch.ops.cross_attn import KERNEL as CROSS
    from janus_tpu_torch.ops.cross_attn import (_rows,
                                                cross_attention_int8,
                                                cross_attention_int8_plain,
                                                load_bytes, plan_splits)
    from janus_tpu_torch.ops.quant import QuantKVT, quantize_kv_t

    def k4_load_bytes(kq, vq) -> int:
        """Bytes per load the wrapper picks for these K/V."""
        (kr, k_row), (vr, v_row) = _rows(kq.q), _rows(vq.q)
        return load_bytes(kr.data_ptr(), vr.data_ptr(), k_row, v_row)

    h = 20
    # fp32: the order of the sums is the only difference. bf16: both
    # versions compute in fp32 and round once, so one bf16 ulp of the
    # output (at most 2^-7 of |ref|). Both are tighter than the JAX
    # package's own bar for this kernel (atol = rtol = 2e-3).
    cross_bars = ((torch.float32, 0.0, 2e-5), (torch.bfloat16, 2 ** -7, 1e-5))
    for t in CROSS_T:
        for dtype, rtol, atol in cross_bars:
            q = torch.randn((FLAGSHIP_BATCH, h, 1, dh), generator=gen,
                            device=dev).to(dtype)
            k_dense, v_dense = (torch.randn((FLAGSHIP_BATCH, h, t, dh),
                                            generator=gen, device=dev)
                                for _ in range(2))
            kq, vq = quantize_kv_t(k_dense), quantize_kv_t(v_dense)
            out = cross_attention_int8(q, kq, vq)
            ref = cross_attention_int8_plain(q, kq, vq)
            torch.cuda.synchronize()
            err = max_abs(out, ref)
            tol_ratio = worst_ratio(out, ref, rtol, atol)
            # QK^T and PV (4 T Dh per query row) plus the score scaling,
            # max, exp, sum and V-scale fold (~6 per score)
            ops = FLAGSHIP_BATCH * h * (4.0 * t * dh + 6.0 * t)
            nbytes = (2 * q.numel() * q.element_size() + 2 * kq.q.numel()
                      + 2 * 4 * kq.scale.numel())
            b_ms, b_by = bound_ms(ops, PEAK_FP32, nbytes)
            kd, vd = k_dense.to(torch.bfloat16), v_dense.to(torch.bfloat16)
            qd = q.to(torch.bfloat16)
            row = {"phase": "kernel", "name": "cross_attn_int8",
                   "batch": FLAGSHIP_BATCH, "heads": h, "tq": 1, "t": t,
                   "head_dim": dh, "dtype": str(dtype).split(".")[-1],
                   "splits": plan_splits(t),
                   "load_bytes": k4_load_bytes(kq, vq),
                   "rtol": rtol, "atol": atol, "max_err": err,
                   "tol_ratio": tol_ratio,
                   "kernel_ms": graph_ms(lambda: cross_attention_int8(
                       q, kq, vq), iters=50),
                   "eager_ms": time_ms(lambda: cross_attention_int8(
                       q, kq, vq), iters=50),
                   "host_us": wrapper_us(lambda: cross_attention_int8(
                       q, kq, vq), calls=1000),
                   "plain_ms": graph_ms(lambda: cross_attention_int8_plain(
                       q, kq, vq), iters=50),
                   "bound_ms": b_ms, "bound_by": b_by,
                   # no single PyTorch call takes int8 K/V with per-position
                   # scales; SDPA over the dense bf16 K/V is context only
                   "library_ms": None,
                   "dense_sdpa_ms": graph_ms(lambda: sdpa(qd, kd, vd),
                                             iters=50)}
            emit(row)
            check(tol_ratio <= 1.0, f"cross_attn_int8 t={t} {dtype} err "
                  f"{err} beyond rtol {rtol} atol {atol}")
            check(torch.equal(out, cross_attention_int8(q, kq, vq)),
                  f"cross_attn_int8 t={t} {dtype}: two launches differ")
            if t == CROSS_T[0] and dtype == torch.bfloat16:
                summary["cross_attn_int8"] = row

    # other shapes and layouts: a T that is no multiple of 4 or 16, a prompt
    # of several rows, two blocks and one block per (batch, head), rows
    # packed densely (4-byte and 1-byte loads)
    for t, tq_ in ((499, 1), (499, 3), (500, 5), (200, 1), (77, 1)):
        for dtype, rtol, atol in cross_bars:
            q = torch.randn((2, 5, tq_, dh), generator=gen,
                            device=dev).to(dtype)
            kq, vq = (quantize_kv_t(torch.randn((2, 5, t, dh), generator=gen,
                                                device=dev))
                      for _ in range(2))
            ref = cross_attention_int8_plain(q, kq, vq)
            packed = tuple(QuantKVT(x.q.contiguous(), x.scale)
                           for x in (kq, vq))
            for layout, (kk, vv) in (("padded", (kq, vq)),
                                     ("packed", packed)):
                tol_ratio = worst_ratio(cross_attention_int8(q, kk, vv), ref,
                                        rtol, atol)
                emit({"phase": "kernel", "name": "cross_attn_int8",
                      "batch": 2, "heads": 5, "tq": tq_, "t": t,
                      "head_dim": dh, "dtype": str(dtype).split(".")[-1],
                      "layout": layout, "splits": plan_splits(t),
                      "load_bytes": k4_load_bytes(kk, vv),
                      "tol_ratio": tol_ratio})
                check(tol_ratio <= 1.0, f"cross_attn_int8 t={t} tq={tq_} "
                      f"{dtype} {layout} beyond rtol {rtol} atol {atol}")

    # -- 3. demo checkpoint: card and CPU give the same packets ------------
    from janus_tpu_torch.audio.synthetic import render_text, voiced_phrase
    from janus_tpu_torch.common.config import ASRConfig, JanusConfig
    from janus_tpu_torch.models.params import load_npz_params
    from janus_tpu_torch.runtime.codec import SemanticEncoder

    demo_cfg = dataclasses.replace(JanusConfig(), asr=ASRConfig.demo())
    demo_params = load_npz_params(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "checkpoints",
        "demo_asr.npz"))

    def demo_packets(cfg, params) -> list:
        """The demo phrases through ``SemanticEncoder`` on the card and on
        the CPU; the packets must be byte-equal."""
        gpu_enc = SemanticEncoder(cfg, params, buckets=(96_000,),
                                  device="cuda")
        cpu_enc = SemanticEncoder(cfg, params, buckets=(96_000,),
                                  device="cpu")
        transcripts = []
        for seed, text in enumerate(DEMO_TEXTS):
            phrase = render_text(text, SR, seed=seed)
            pg = gpu_enc.encode_packet(phrase, timestamp=DEMO_TIMESTAMP)
            pc = cpu_enc.encode_packet(phrase, timestamp=DEMO_TIMESTAMP)
            check((pg is None) == (pc is None),
                  f"demo packet presence '{text}'")
            if pg is not None:
                check(pg.serialize() == pc.serialize(),
                      f"demo packets differ for '{text}': {pg} vs {pc}")
            transcripts.append({
                "spoken": text, "heard": None if pg is None else pg.text,
                "prosody": None if pg is None else pg.prosody,
                "bytes": None if pg is None else pg.wire_size()})
        check(any(t["heard"] for t in transcripts), "demo produced no packet")
        return transcripts

    emit({"phase": "demo", "packets_byte_equal_cpu": True,
          "transcripts": demo_packets(demo_cfg, demo_params)})

    # the int8 configuration: quantized weights in each mode, int8 cross K/V
    from janus_tpu_torch.ops.quant import quantize_tree

    int8_cfg = demo_cfg.override(**{"asr.decode_cross_kv_int8": True})
    for mode in ("weight", "dynamic"):
        CROSS.launches = 0
        transcripts = demo_packets(int8_cfg,
                                   quantize_tree(demo_params, mode=mode))
        check(CROSS.launches > 0, f"int8 demo ({mode}) never launched K4")
        emit({"phase": "demo_int8", "mode": mode,
              "packets_byte_equal_cpu": True,
              "cross_attn_int8_launches": CROSS.launches,
              "transcripts": transcripts})

    # -- 4. flagship: large-v3 through encode_batch ------------------------
    from janus_tpu_torch.models import asr as asr_mod
    from janus_tpu_torch.ops.attention import attend
    from janus_tpu_torch.ops.energy import classify_energy, rms_energy
    from janus_tpu_torch.ops.resample import decimate_48k_to_16k
    from janus_tpu_torch.ops.yin import mean_voiced_pitch, yin_track

    fcfg = dataclasses.replace(JanusConfig(), asr=ASRConfig.large_v3())
    fcfg = fcfg.override(**{"asr.max_decode_tokens": 24})
    bucket = int(SR * FLAGSHIP_SECONDS)
    t0 = time.perf_counter()
    fenc = SemanticEncoder(fcfg, buckets=(bucket,), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    phrases = [voiced_phrase(f0=140.0 + 15 * i, seconds=FLAGSHIP_SECONDS,
                             amp=0.12, seed=i)
               for i in range(FLAGSHIP_BATCH)]
    fenc.encode_batch(phrases)  # warm-up: cuBLAS/cuDNN handles, allocator

    kernels = (MEL, FLASH, YIN, CROSS)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = fenc.encode_batch(phrases)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    launches = {k.name: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches["mel_fused"] >= 1, f"mel_fused launches {launches}")
    check(launches["flash_attn"] == fcfg.asr.encoder_layers,
          f"flash_attn launches {launches}")
    check(launches["yin_block_sums"] >= 1, f"yin launches {launches}")
    check(len(results) == FLAGSHIP_BATCH
          and all(np.isfinite(r["f0"]) and np.isfinite(r["rms"])
                  and r["f0"] > 0 for r in results),
          f"flagship results {results}")

    e2e = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fenc.encode_batch(phrases)
        torch.cuda.synchronize()
        e2e.append(1e3 * (time.perf_counter() - t0))

    # the same stages, one at a time, synchronised around each
    acfg, pcfg = fcfg.asr, fcfg.prosody
    batch = np.stack([np.clip(np.round(p * 32768.0), -32768, 32767)
                      .astype(np.int16) for p in phrases])
    stage_ms: dict = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage_ms.setdefault(name, []).append(
            1e3 * (time.perf_counter() - t0))
        return out

    n16 = fenc.mel_frame_budget(bucket)
    for _ in range(3):
        a48 = stage("h2d_wire", lambda: torch.from_numpy(batch).to(dev)
                    .float() / 32768.0)
        stage("rms", lambda: classify_energy(rms_energy(a48)))
        a16 = stage("decimate", lambda: decimate_48k_to_16k(a48))
        stage("yin", lambda: mean_voiced_pitch(yin_track(
            a16, 16_000, pcfg.yin_window_16k, pcfg.yin_hop_16k,
            pcfg.yin_tolerance, fmin=pcfg.fmin_hz, fmax=pcfg.fmax_hz)))
        mel = stage("mel", lambda: asr_mod.prepare_mel(
            a16, acfg, pad_to_frames=n16))
        enc = stage("encoder", lambda: asr_mod.encode_audio(
            fenc.params, acfg, mel.to(torch.bfloat16)))
        prompt = torch.full((FLAGSHIP_BATCH, 1), fenc.tokenizer.sot,
                            dtype=torch.long, device=dev)
        dense_tokens = stage("decode", lambda: asr_mod.greedy_decode(
            fenc.params, acfg, enc, prompt, fenc.tokenizer.eot,
            max_new=acfg.max_decode_tokens, cache_dtype=torch.bfloat16))

    decode_step = profile_decode_step(torch, asr_mod, fenc.params, acfg, enc,
                                      prompt)

    # encoder output against a pass through the plain versions on the card
    with mock.patch.object(asr_mod, "log_mel_spectrogram_fused",
                           lambda audio, **kw: log_mel_spectrogram(audio,
                                                                   **kw)), \
            mock.patch.object(asr_mod, "flash_attention",
                              lambda q, k, v: attend(q, k, v)):
        mel_p = asr_mod.prepare_mel(a16, acfg, pad_to_frames=n16)
        enc_p = asr_mod.encode_audio(fenc.params, acfg,
                                     mel_p.to(torch.bfloat16))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(enc.float()).all())
          and tuple(enc.shape) == (FLAGSHIP_BATCH, n16 // 2, acfg.d_model),
          f"encoder output {tuple(enc.shape)}")
    diff = (enc.float() - enc_p.float())
    rel = float(diff.norm() / enc_p.float().norm())
    # bf16 keeps 8 mantissa bits (2^-8 ~ 3.9e-3 per rounding); 32 residual
    # layers of independently rounded activations stay well under 5e-2
    check(rel <= 5e-2, f"encoder vs plain relative error {rel}")
    audio_s = FLAGSHIP_BATCH * FLAGSHIP_SECONDS
    best = min(e2e)
    emit({"phase": "flagship", "model": "whisper-large-v3 (random, seed 0)",
          "dtype": acfg.dtype, "batch": FLAGSHIP_BATCH,
          "seconds": FLAGSHIP_SECONDS, "max_decode_tokens": 24,
          "init_s": round(init_s, 3), "first_encode_ms": first_ms,
          "e2e_ms": e2e, "rtf": best / 1e3 / audio_s,
          "stage_ms": {k: min(v) for k, v in stage_ms.items()},
          "peak_mem_gib": peak_gib, "launches": launches,
          "encoder_vs_plain_max_abs": float(diff.abs().max()),
          "encoder_vs_plain_rel": rel, "decode_step": decode_step,
          "texts": [r["text"] for r in results][:2],
          "f0": [r["f0"] for r in results]})

    # -- 5. flagship int8: dynamic-int8 weights, int8 cross K/V ------------
    from janus_tpu_torch.models.params import cast_floating, init_asr

    eot = fenc.tokenizer.eot
    del fenc
    torch.cuda.empty_cache()
    qcfg = fcfg.override(**{"asr.decode_cross_kv_int8": True})
    t0 = time.perf_counter()
    # the phase-4 weights, cast to bf16 and then quantized (the JAX
    # package's flagship tool quantizes after its bf16 cast, too)
    qparams = quantize_tree(cast_floating(init_asr(
        torch.Generator(device=dev).manual_seed(0), qcfg.asr),
        torch.bfloat16), mode="dynamic")
    qenc = SemanticEncoder(qcfg, qparams, buckets=(bucket,), device="cuda")
    del qparams
    torch.cuda.synchronize()
    q_init_s = time.perf_counter() - t0
    qenc.encode_batch(phrases)  # warm-up

    forwards = [0]
    decoder_forward = asr_mod._decoder_forward

    def counted_forward(*args, **kwargs):
        forwards[0] += 1
        return decoder_forward(*args, **kwargs)

    all_kernels = (MEL, FLASH, YIN, CROSS)
    for k in all_kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(asr_mod, "_decoder_forward", counted_forward):
        q_results = qenc.encode_batch(phrases)
    torch.cuda.synchronize()
    q_first_ms = 1e3 * (time.perf_counter() - t0)
    q_launches = {k.name: k.launches for k in all_kernels}
    q_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(q_launches["mel_fused"] >= 1, f"int8 mel launches {q_launches}")
    check(q_launches["flash_attn"] == qcfg.asr.encoder_layers,
          f"int8 flash_attn launches {q_launches}")
    check(q_launches["yin_block_sums"] >= 1, f"int8 yin {q_launches}")
    check(forwards[0] >= 1 and q_launches["cross_attn_int8"]
          == qcfg.asr.decoder_layers * forwards[0],
          f"cross_attn_int8 launches {q_launches} for {forwards[0]} "
          f"decoder forwards")
    check(len(q_results) == FLAGSHIP_BATCH
          and all(np.isfinite(r["f0"]) and np.isfinite(r["rms"])
                  for r in q_results), f"int8 flagship results {q_results}")

    q_e2e = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qenc.encode_batch(phrases)
        torch.cuda.synchronize()
        q_e2e.append(1e3 * (time.perf_counter() - t0))

    # the two stages the int8 weights and K/V change, once each
    stage_ms = {}
    q_enc = stage("encoder", lambda: asr_mod.encode_audio(
        qenc.params, acfg, mel.to(torch.bfloat16)))
    q_tokens = stage("decode", lambda: asr_mod.greedy_decode(
        qenc.params, acfg, q_enc, prompt, eot,
        max_new=acfg.max_decode_tokens, cache_dtype=torch.bfloat16,
        cross_kv_int8=True))
    q_decode_step = profile_decode_step(torch, asr_mod, qenc.params, acfg,
                                        q_enc, prompt, cross_kv_int8=True)

    def first_step_logits(cross=None) -> "torch.Tensor":
        """Prefill and one decode step of the int8 flagship; ``cross``
        replaces the decoder's cross-attention."""
        with mock.patch.object(asr_mod, "cross_attention_kv",
                               cross or asr_mod.cross_attention_kv):
            state = asr_mod.init_decode_state(
                qenc.params, acfg, q_enc, max_len=prompt.shape[-1] + 1,
                dtype=torch.bfloat16, cross_kv_int8=True)
            _, state = asr_mod.decoder_prefill(qenc.params, acfg, prompt,
                                               state)
            logits, _ = asr_mod.decoder_step(qenc.params, acfg,
                                             prompt[:, -1], state)
        return logits.float()

    # every K4 call of that step against the plain version on the same
    # inputs, at the kernel phase's bf16 bar (one bf16 ulp)
    on_path = {"calls": 0, "elements": 0, "differing": 0, "worst": 0.0}

    def checked_cross(q, k, v):
        out = cross_attention_int8(q, k, v)
        ref = cross_attention_int8_plain(q, k, v).float()
        on_path["calls"] += 1
        on_path["elements"] += out.numel()
        on_path["differing"] += int((out.float() != ref).sum())
        on_path["worst"] = max(on_path["worst"], float(
            ((out.float() - ref).abs() / (1e-5 + 2 ** -7 * ref.abs())).max()))
        return out

    def plain_fp64(q, k, v):
        """The plain version's arithmetic in float64: the control."""
        s = torch.matmul(q.double(), k.q.double()) * q.shape[-1] ** -0.5
        p = torch.exp(s * k.scale[..., None, :].double()
                      - (s * k.scale[..., None, :].double()).amax(
                          -1, keepdim=True))
        o = torch.matmul(p * v.scale[..., None, :].double(),
                         v.q.double().transpose(-1, -2))
        return (o / p.sum(-1, keepdim=True)).to(q.dtype)

    logits_k = first_step_logits()
    logits_c = first_step_logits(checked_cross)
    logits_p = first_step_logits(cross_attention_int8_plain)
    logits_64 = first_step_logits(plain_fp64)
    torch.cuda.synchronize()

    def rel(a, b) -> float:
        return float((a - b).norm() / b.norm())

    check(bool(torch.isfinite(logits_k).all()), "int8 logits not finite")
    check(bool(torch.equal(logits_k, logits_c)), "K4 is not deterministic")
    check(on_path["calls"] == 2 * qcfg.asr.decoder_layers
          and on_path["worst"] <= 1.0,
          f"K4 on the decode path outside one bf16 ulp of plain {on_path}")
    # The logits pass 64 decoder layers of bf16 activations, each linear
    # quantizing its input to int8 per row: a rounding-level difference
    # flips some of those roundings (a 1/127-of-amax step each), so the
    # plain version itself sits ~1e-2 from its own float64 evaluation
    # (plain_vs_fp64). The bar is that of the encoder-vs-plain check.
    rel_logits = rel(logits_k, logits_p)
    check(rel_logits <= 5e-2, f"int8 step logits vs plain {rel_logits}")
    agree = float((q_tokens == dense_tokens).float().mean())

    # the library int8 product of the dynamic linears (``torch._int_mm``)
    # at the decode step's fc2 shape (8 rows padded to 17) and the
    # encoder's fc1 shape, with the weight row-major (as the tree stores
    # it) and column-major
    int_mm_ms = {}
    for m, k, n in ((17, 5120, 1280), (FLAGSHIP_BATCH * n16 // 2, 1280,
                                       5120)):
        a, w = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8)
                for shape in ((m, k), (k, n)))
        w_cols = w.t().contiguous().t()
        int_mm_ms[f"{m}x{k}x{n}"] = {
            "row_major": time_ms(lambda: torch._int_mm(a, w), iters=20),
            "col_major": time_ms(lambda: torch._int_mm(a, w_cols),
                                 iters=20)}
    emit({"phase": "flagship_int8",
          "model": "whisper-large-v3 (random, seed 0)",
          "weights": "quantize_tree(mode='dynamic') after the bf16 cast",
          "cross_kv": "int8 (QuantKVT)", "batch": FLAGSHIP_BATCH,
          "seconds": FLAGSHIP_SECONDS, "max_decode_tokens": 24,
          "init_s": round(q_init_s, 3), "first_encode_ms": q_first_ms,
          "e2e_ms": q_e2e, "rtf": min(q_e2e) / 1e3 / audio_s,
          "stage_ms": {k: min(v) for k, v in stage_ms.items()},
          "peak_mem_gib": q_peak_gib, "launches": q_launches,
          "decoder_forwards": forwards[0],
          "step_logits_vs_plain_rel": rel_logits,
          "step_logits_vs_plain_max_abs": float(
              (logits_k - logits_p).abs().max()),
          "step_logits_kernel_vs_fp64_rel": rel(logits_k, logits_64),
          "step_logits_plain_vs_fp64_rel": rel(logits_p, logits_64),
          "step_cross_attn_vs_plain": on_path,
          "token_agreement_with_dense": agree, "int_mm_ms": int_mm_ms,
          "decode_step": q_decode_step,
          "texts": [r["text"] for r in q_results][:2]})

    # -- 6-8. the receive side ---------------------------------------------
    del qenc, q_enc
    torch.cuda.empty_cache()
    errors = ErrorRecords()
    for name in ("synthesizer", "streaming_tts"):
        logging.getLogger(f"janus_tpu_torch.runtime.{name}").addHandler(errors)
    receive_demo(torch, dev)
    receive_stream(torch, dev, *receive_flagship(torch, dev))
    check(not errors.records, f"the synthesizer logged errors: "
          f"{errors.records}")
    torch.cuda.empty_cache()

    # -- 9. kernels summary ------------------------------------------------
    # launches: K1-K3 from the flagship run, K4 from the int8 flagship run
    launches["cross_attn_int8"] = q_launches["cross_attn_int8"]
    line = []
    for k in all_kernels:
        row = summary[k.name]
        line.append({"name": k.name, "route": "cuda",
                     "source": f"janus_tpu_torch/csrc/{k.name}.cu",
                     "replaces": k.replaces, "launches": launches[k.name],
                     "max_abs_err": row["max_err"], "ms": row["kernel_ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    emit({"kernels": line})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
