#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's send path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the four hand-written CUDA
kernels from ``janus_tpu_torch/csrc`` (one ``nvcc`` per source, all at
once, into ``build/janus_tpu_torch/``) and runs these phases, each
printing one JSON line per result:

1. device  — the card, its power limit, the kernel build time;
2. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes, with times, the card's bound and, where one
   PyTorch call computes the same function, that call's time. K2 and K4
   are timed as device time (``kernel_ms``: launches replayed from a CUDA
   graph) and as an eager loop (``eager_ms``, which the host bounds when
   the kernel is shorter than its wrapper call); K2 also through its SIMT
   kernel on the same inputs (``simt_ms``), K4 with the wrapper's host
   time (``host_us``);
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
6. the ``kernels`` summary line.

Then the card's name and power limit as ``nvidia-smi`` prints them, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no result; it also exits
non-zero without a card or without the package beside it. It imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
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


def profile_decode_step(torch, asr_mod, params, acfg, enc, prompt,
                        steps: int = 3, cross_kv_int8: bool = False) -> dict:
    """One greedy decode step, timed bare (median of ``steps``) and then
    traced once under ``torch.profiler``: the kernels the device ran, the
    host's kernel-launch calls, the device's busy time, and its idle share
    of the bare step's wall time. The trace is a reading, not a check:
    without device events it reports nulls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = asr_mod.init_decode_state(params, acfg, enc,
                                      max_len=prompt.shape[-1] + steps + 1,
                                      dtype=torch.bfloat16,
                                      cross_kv_int8=cross_kv_int8)
    _, state = asr_mod.decoder_prefill(params, acfg, prompt, state)
    tok = prompt[:, -1]
    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asr_mod.decoder_step(params, acfg, tok, state)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall_ms = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        asr_mod.decoder_step(params, acfg, tok, state)
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
    from janus_tpu_torch.ops.mel import log_mel_spectrogram, mel_filterbank
    from janus_tpu_torch.ops.mel_fused import KERNEL as MEL
    from janus_tpu_torch.ops.mel_fused import log_mel_spectrogram_fused

    for seconds in MEL_SECONDS:
        for n_mels in (128, 80):
            audio = 0.1 * torch.randn((FLAGSHIP_BATCH, seconds * 16_000),
                                      generator=gen, device=dev)
            out = log_mel_spectrogram_fused(audio, n_mels=n_mels)
            ref = log_mel_spectrogram(audio, n_mels=n_mels)
            torch.cuda.synchronize()
            err = max_abs(out, ref)
            # the least work log-mel needs, not the matmul-DFT's: a real FFT
            # per frame (2.5 n log2 n), |X|^2, the filterbank's nonzero
            # taps and one log per mel
            n_frames, n_freqs = out.shape[-2] * FLAGSHIP_BATCH, 201
            fb_nnz = int((mel_filterbank(16_000, 400, n_mels) != 0).sum())
            ops = n_frames * (2.5 * 400 * np.log2(400) + 3 * n_freqs
                              + 2 * fb_nnz + n_mels)
            nbytes = 4 * (audio.numel() + out.numel())
            b_ms, b_by = bound_ms(ops, PEAK_FP32, nbytes)
            row = {"phase": "kernel", "name": "mel_fused",
                   "batch": FLAGSHIP_BATCH,
                   "seconds": seconds, "n_mels": n_mels, "atol": 5e-5,
                   "max_err": err,
                   "kernel_ms": time_ms(lambda: log_mel_spectrogram_fused(
                       audio, n_mels=n_mels)),
                   "plain_ms": time_ms(lambda: log_mel_spectrogram(
                       audio, n_mels=n_mels)),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            emit(row)
            check(err <= 5e-5, f"mel_fused {seconds}s/{n_mels} err {err}")
            if seconds == MEL_SECONDS[0] and n_mels == 128:
                summary["mel_fused"] = row

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

    from janus_tpu_torch.ops.yin import _pad_stream
    from janus_tpu_torch.ops.yin_blocksums import KERNEL as YIN
    from janus_tpu_torch.ops.yin_blocksums import (_rows_view, block_sums,
                                                   block_sums_plain)

    audio16 = 0.1 * torch.randn((FLAGSHIP_BATCH,
                                 int(FLAGSHIP_SECONDS * 16_000)),
                                generator=gen, device=dev)
    padded, n_hops = _pad_stream(audio16, 1360, 170)
    nblk, hop, n_lags = n_hops + 3, 170, 402
    out = block_sums(padded, nblk, hop, n_lags)
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
    row = {"phase": "kernel", "name": "yin_block_sums",
           "batch": FLAGSHIP_BATCH, "seconds": FLAGSHIP_SECONDS, "nblk": nblk, "hop": hop, "n_lags": n_lags,
           "rtol": 2e-4, "atol": 2e-4, "max_err": err,
           "library_max_err": max_abs(lib_out, ref),
           "kernel_ms": time_ms(lambda: block_sums(padded, nblk, hop,
                                                   n_lags)),
           "plain_ms": time_ms(lambda: block_sums_plain(padded, nblk, hop,
                                                        n_lags), iters=3),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(grouped_conv, iters=3)}
    emit(row)
    check(rel_ok, f"yin_block_sums outside rtol/atol 2e-4 (max err {err})")
    summary["yin_block_sums"] = row

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
            # the wrapper alone: 1000 calls with no synchronise between them
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                cross_attention_int8(q, kq, vq)
            host_us = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
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
                   "host_us": host_us,
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

    # -- 6. kernels summary ------------------------------------------------
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
