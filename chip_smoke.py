#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's send, receive and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the nine hand-written CUDA
kernels from ``janus_tpu_torch/csrc`` (one ``nvcc`` per source, all at
once, into ``build/janus_tpu_torch/``) and runs these phases, each
printing one JSON line per result:

1. device  — the card, its power limit, the kernel build time;
2. kernels — each kernel (the decode loops' condition too) against its
   plain PyTorch version on the card at
   the main path's shapes, with times, the card's bound and, where one
   PyTorch call computes the same function, that call's time. Every
   kernel is timed as device time (``kernel_ms``: launches replayed from a
   CUDA graph) and as an eager loop (``eager_ms``, which the host bounds
   when the kernel is shorter than its wrapper call, ``host_us``); K1, K2
   and K3 also through their earlier kernel on the same inputs
   (``dense_ms``, ``simt_ms``, ``simple_ms``); the decode steps' layer
   norm and decode attention (the port's own kernels) at the steps' and
   the encoder's shapes, against ``F.layer_norm`` and SDPA at bf16: the
   layer norm with the residual add taken in (``add_layer_norm``: r equal
   to PyTorch's add bit for bit, against the add and the norm apart), the
   decode attention at every split plan of the 10 s and 30 s
   cross-attention, and writing the cache itself (the cache equal to
   ``write_at``'s and the output to write-then-attend's, bit for bit); the
   dynamic-int8 linear (the port's own kernel) at every shape of the int8
   path, equal to its plain version bit for bit, beside the path it
   replaced (``before_ms``: the eager quantization, ``torch._int_mm`` on
   the row-major weight, padded to 17 rows below that, and the rescale)
   and ``torch._int_mm`` alone on either layout (``int_mm_ms``), each
   kernel of a call traced (``device_us``: two, the quantization and a
   product); the mixed linear (the port's own kernel) at every shape of
   the AR step within 1e-5 (sum |x w| + |b|) of its plain version, warm
   and cold, beside ``addmm`` over a widened weight, its launches over
   several weights (q/k/v, the two heads) and fc1 with the GELU in its
   epilogue beside the separate launches they replace, each programmatic
   and not after the kernel before it in the step (``pdl_ms``,
   ``no_pdl_ms``), and a weight written just before a programmatic call
   read as a synchronised call reads it;
3. demo    — the committed demo recognizer through ``SemanticEncoder`` on
   the card and on the CPU: the packets must be byte-equal; then the same
   under the int8 configuration (``quantize_tree`` weights in each mode,
   ``asr.decode_cross_kv_int8``), which must launch the K4 kernel, and in
   the dynamic mode the int8 linear;
4. flagship — Whisper large-v3 (random weights from seed 0, bf16) encoding
   8 phrases of 10 s through ``SemanticEncoder.encode_batch``: per-stage
   and end-to-end times, launches of each kernel in that run, and the
   encoder output against a plain-version pass. The greedy loop runs
   replayed from its CUDA graph and eagerly (``eager=True``) in turns on
   the same inputs: equal results and tokens; one step of each traced
   (host calls, busy ms, idle share, and the top device kernels by time
   and by count: ``by_op``), the graphs' capture ms and pool; the
   captured step's launches (97 layer norms, 64 decode attentions), at
   most 460 kernels, no add over floating values and no ``index_copy_``
   but the output column's. Everything before the loop (the wire decode,
   the frontend, the encoder, the cross K/V, the prefill) is one replay
   of a captured ``EncodeGraph``: its results bit-equal to the same front
   issued op by op (``front.bits_*``: the encoder output, tokens, codes,
   f0, rms), both timed in turns at b 8 x 10 s and at one 2 s phrase
   (``turns_*_ms``), the host's calls of each (``encode_host_calls``),
   one replayed front traced by ``tools/trace_step.py`` (``trace_*``:
   kernels, busy, span, wall) and each front's capture ms and pool MiB;
4b. whisper_dropin — the drop-in path of a Whisper checkpoint on phase
   4's weights: a synthetic large-v3-shaped ``vocab.json`` /
   ``merges.txt`` (51,866 ids, the specials at large-v3's ids) through
   ``BpeTokenizer.from_files`` (round trips, host µs of encode and
   decode); the tree as an HF-named fp32 state dict back through
   ``params_from_hf_state_dict`` (host seconds and memory; every leaf
   bit-equal after the encoder's fusion); ``SemanticEncoder(tokenizer=
   bpe)`` with the four-token ``sot_sequence``, captured by ``warmup``
   at ``prompt_len`` 4 and replayed against eager in turns (equal tokens
   and packets, ``encode_batch_submit`` at b = 8, K1-K3 launched, the
   captured front bit-equal to the eager one), then the same under the
   int8 configuration (K4 launched);
5. flagship int8 — the same model with dynamic-int8 weights and int8
   cross K/V (the analogue of CTranslate2 ``compute_type='int8'``): times,
   launches (K4 once per decoder layer and forward, the replayed steps'
   counted through the captured step's 32; the int8 linear six a decoder
   layer, 192 in the captured step), one decode step's logits against the
   plain cross-attention, token agreement with phase 4, and the replayed
   loop against the eager one as in phase 4; the replayed step traced
   (at most 600 kernels) beside the same step captured with the linear
   as it ran before its kernel (``decode_step_graph_before``); the
   captured front against the eager one as in phase 4 (bits, turns at
   b 8, host calls);
6. receive_demo — the committed demo TTS, vocoder and speaker encoder
   through ``Synthesizer`` on the card and on the CPU (Morse bytes equal;
   TTS modes: the same sample count and the PCM within a stated bar),
   ``synthesize_streaming`` against ``synthesize`` on the card, and the
   round trip phrase → packet → speech → packet, card against CPU;
7. receive_flagship — ``TTSConfig.flagship()`` (d 1280, 30 layers, random
   bf16 weights from seed 0) with the default vocoder:
   ``Synthesizer._synth_impl`` over the full budget of 256 groups at b = 8
   and b = 1, one launch of its ``SynthGraph`` (the captured prefill, the
   AR loop's WHILE node, the captured vocoder, iSTFT and resampler) and
   ``eager=True`` in turns (PCM equal bit for bit), at most 3 graph
   launches and no device->host read before the samples, each stage's
   device ms (prefill, loop, tail) and the eager stages, the new graphs'
   capture ms and pool, one traced AR step of each, prefill + 4
   groups against the CPU, the captured AR step's launches (61 layer
   norms, 30 decode attentions, 123 mixed linears: q/k/v and the two heads
   one launch each, fc1's GELU in its epilogue; at most 260 kernels, no
   float add, no GELU kernel, no ``index_copy_`` but the holder's two
   output writes) and the size of its once-widened weights;
8. receive_stream — ``StreamingSynthesizer`` at that width, captured (the
   prefill replayed, a chain of steps a chunk, one emission graph a chunk
   index) and eager in turns: seconds to first audio and in all, the host's
   calls a chunk, the two streams equal, and the stream against the fused
   path;
8b. device_loop — the decode loops as the reference compiles them, each
   a WHILE node around the captured step whose exit the card decides
   (``csrc/loop_graph.cu``): at flagship width and b = 8, on copies of
   the trees pushed so that every lane ends at step 2, 9 or 17, or never
   (``eot_at``, ``stop_at``), the trips (== the step) and device ms of the
   recognizer's and the AR loop, their tokens, mel and ``n_frames`` equal
   to the eager loop's; each loop traced against its step replayed alone,
   and a run that finds every lane done; ``encode_batch_submit`` at b 8 x
   10 s and b 1 x 2 s: its return ms, ``is_ready()`` right after, no
   synchronize or device->host copy in it (the profiler's host calls),
   at most two graph launches, and its result equal to ``encode_batch``;
9. duplex_demo — the live link with the committed demo bundle: three
   rendered phrases through ``sender_main.main_loop`` (VAD, segmenter,
   encode, packet, link at 48000 baud) → localhost UDP →
   ``receiver_main.receive_loop`` in a second thread → captured playback,
   once on the card and once on the CPU: counts, transcripts and PCM
   card against CPU, and K1-K3 launched;
10. duplex_flagship — the same link at full width in one process: the
   large-v3 recognizer of phase 4 (its full encode; only the transcript
   is fixed, random weights give none) and the flagship TTS + vocoder of
   phase 7 behind ``engine.receiver_loop`` with streaming playback, a
   three-turn conversation captured in real time, the energy VAD and the
   default 300 bps link: per-turn latencies, VAD time a chunk, the
   capture queue and the kernels' launches; once with both loops
   replayed from their graphs (captured up front by the ``warmup``
   methods) and once eagerly, the packets of both synthesized alike;
11. sessions_flagship — the multi-session serving runtime at large-v3
   width on phase 4's weights (2 s bucket, 24 decode tokens): encode
   batch scaling at b = 1, 8, 32, 64 with one traced decode step at
   b = 64, then ``SessionManager``'s tick loop over 32 sessions fed
   through ``push_audio`` one 32 ms chunk a tick, synchronous and
   overlapped (``overlap_speedup``), on the native ring buffers; the
   scaling and the tick loop with the decode replayed and eager, and the
   scaling with the front captured and eager in turns;
12. server_demo — ``JanusServer`` with the demo bundle on the card and on
   the CPU: health, the WebSocket control plane through a stdlib client,
   a spoken phrase through the live duplex on loopback UDP, the phrase
   uploaded to ``/api/voice/verify`` as WAV and (with libopus) as
   WebM/Opus and Ogg/Opus, and the saved clone reference through the
   speaker encoder and one cloned synthesis;
13. encode_profile and flagship_check — ``tools.encode_profile`` (stage
   times of the encode, 8 phrases of 10 s) and ``tools.flagship_check
   --decode --int8`` (the encoder at 3000 frames, the transcribe, int8
   weights and cross K/V) on phase 4's large-v3 weights;
14. train_demo — the demo ASR, TTS and vocoder, 3 optimizer steps each on
   one fixed batch from the same seeded weights on the card and on the
   CPU (losses within 1e-3 relative), then ``train_demo_asr(steps=3)``
   through its entry point and its npz back through ``load_npz_params``;
15. train_flagship — Whisper large-v3 at full width in float32 (weights
   from ``init_asr`` on the card): 5 ``Trainer.train_step`` on 2
   utterances in the 30 s window (finite losses, the last below the
   first), step ms, peak memory, and one step traced (launches, busy,
   idle, top ops, K2's forward kernel and ``_FlashAttention.backward``
   shares);
16. zoo_gates — the seven quality gates of
   ``tests/test_zoo_checkpoints.py`` on the committed checkpoints, on the
   card, at their floors;
17. parallel_flagship — the mesh layouts at full width in a world of one
   card (a one-rank NCCL group; the ``(1, 1, 1)`` mesh issues no
   collective): ``SemanticEncoder(mesh=...)`` on phase 4's large-v3
   weights, 8 phrases of 10 s, packets byte-equal to ``mesh=None``;
   ``Synthesizer(mesh=...)`` with the flagship TTS over 32 groups, PCM
   equal to ``mesh=None``; 2 steps of the mesh ``Trainer`` on large-v3
   fp32, losses within 1e-6 relative of ``train_flagship``'s; and
   ``eval.scaling.analyze_encode_scaling`` at N = 1 on the card;
18. parallel_ranks — two ranks on the one card through ``run_ranks``
   (gloo carrying CUDA tensors), at demo width: Ulysses attention at
   seq 2, the tensor-parallel encoder at model 2 and ``SemanticEncoder``
   at data 2, each against its unsharded run on the card. Ring attention
   and the pipeline are left out: gloo refuses point-to-point sends of
   CUDA tensors (``GLOO_P2P_REFUSAL``). Then the ranks' forkserver and
   resource tracker are stopped, and no child process of the script may
   be left running;
19. the ``kernels`` summary line: each kernel's launches by phase (K1-K3
   from the flagship encode, the drop-in encodes, the receive phases, the
   tick loop's overlapped run, the tools, the card's server run, the
   training phases, the gates and the two parallel phases; K4 from the
   int8 flagship encode and ``flagship_check --int8``; the layer norm and
   the decode attention wherever they ran; the int8 linear from the
   dynamic int8 demo, the drop-in's int8 encode and the int8 flagship),
   the kernels inside replayed decode steps counted.

Then the card's name and power limit as ``nvidia-smi`` prints them, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no result; it also exits
non-zero without a card or without the package beside it. It imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import dataclasses
import hashlib
import http.client
import json
import logging
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

# H100 SXM data sheet (dense): fp32 outside the tensor cores, bf16 tensor
# cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
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
CHUNK_MS = 1536 / 48               # the capture chunk period, 32 ms
SESSION_BATCHES = (1, 8, 32, 64)   # encode batch scaling (bench.py:287-311)
SESSION_COUNT = 32                 # the serving tick loop (bench.py:484-541)
SESSION_BUCKET = 96_000            # the 2 s duration bucket
VERIFY_PHRASE = "fox golf hotel"
TRAIN_DEMO_STEPS = 3
TRAIN_DEMO_BATCH = 8
TRAIN_DEMO_LR = 1e-4
TRAIN_FLAGSHIP_BATCH = 2           # utterances, in the 30 s window
TRAIN_FLAGSHIP_STEPS = 5
TRAIN_FLAGSHIP_LR = 1e-4
PARALLEL_GROUPS = 32               # the flagship TTS budget under a mesh
PARALLEL_TRAIN_STEPS = 2
# mesh against mesh=None in turns, three of each (the host's spread
# between two calls is ~20 %)
PARALLEL_ORDER = ("none", "mesh", "mesh", "none", "none", "mesh")
# what gloo answers a point-to-point send of a CUDA tensor (PyTorch 2.11,
# one H100 host): the ring and the pipeline need NCCL and two cards
GLOO_P2P_REFUSAL = ("RuntimeError: [/pytorch/third_party/gloo/gloo/transport"
                    "/tcp/pair.cc:339] writev [127.0.0.1]:36177: Bad address")
UPLOAD_TYPES = {"wav": "audio/wav", "webm": "audio/webm;codecs=opus",
                "ogg": "audio/ogg;codecs=opus"}
# Whisper large-v3's language tokens (<|en|> first): only their count
# and the first one's id matter to the synthetic pair
WHISPER_LANGUAGE_COUNT = 100
DROPIN_TEXTS = ("hello world", " The quick brown fox jumps over the lazy dog.",
                "naïve café — 日本語 🙂", "  two  spaces", "")
DROPIN_TRANSCRIPT_TOKENS = 24


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def child_processes() -> list:
    """``[(pid, command line)]`` of this process's children still alive."""
    pids = []
    for task in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{task}/children") as f:
            pids += [int(p) for p in f.read().split()]
    out = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                out.append((pid, f.read().replace(b"\0", b" ").decode()[:120]))
        except FileNotFoundError:
            pass
    return out


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
    api_calls = sum(1 for e in events if e.device_type == DeviceType.CPU
                    and HOST_API.match(e.name))
    graph_launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                         and e.name.startswith("cudaGraphLaunch"))
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    # the union of the kernels' intervals: programmatic launches overlap
    # the kernel before them, which a sum of their times counts twice
    span_us, reach = 0.0, None
    for e in sorted(device, key=lambda e: e.time_range.start):
        start, end = e.time_range.start, e.time_range.end
        if reach is None or start > reach:
            span_us, reach = span_us + end - start, end
        elif end > reach:
            span_us, reach = span_us + end - reach, end
    return {"wall_ms": wall_ms, "wall_ms_all": walls,
            "device_events": len(device),
            "float_adds": sum(1 for e in device if FLOAT_ADD.search(e.name)),
            "gelu_kernels": sum(1 for e in device
                                if "gelu" in e.name.lower()),
            "index_copies": sum(1 for e in device
                                if "index_copy" in e.name),
            "host_kernel_launches": launches,
            "host_graph_launches": graph_launches,
            "host_calls": launches + graph_launches,
            "host_api_calls": api_calls,
            "device_busy_ms": busy_ms if device else None,
            "device_span_ms": span_us / 1e3 if device else None,
            "device_idle_share": (max(0.0, 1.0 - span_us / 1e3 / wall_ms)
                                  if device else None),
            "by_op": by_op(device)}


# the host's calls that put work on the device: kernel launches through
# the runtime API (cuda*) and the low-level API (cu*, which cuBLAS uses),
# graph launches, copies and fills
HOST_API = re.compile(r"cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                      r"GraphLaunch|Memcpy|Memset)")


# PyTorch's add (or subtraction) kernel over floating values: what a
# residual add launches, and what add_layer_norm takes into the norm
FLOAT_ADD = re.compile(r"Functor\w*_add<(float|double|c10::BFloat16|"
                       r"c10::Half)>")


def by_op(device_events, top: int = 12) -> dict:
    """The traced step's device kernels by name: the ``top`` by total
    device time and the ``top`` by count, each as ``[name, count in the
    step, total ms]`` (names cut to 120 characters)."""
    ops: dict = {}
    for e in device_events:
        n, us = ops.get(e.name, (0, 0.0))
        ops[e.name] = (n + 1, us + e.time_range.elapsed_us())
    rows = [[name[:120], n, us / 1e3] for name, (n, us) in ops.items()]
    return {"kinds": len(rows),
            "by_time": sorted(rows, key=lambda r: -r[2])[:top],
            "by_count": sorted(rows, key=lambda r: (-r[1], -r[2]))[:top]}


def device_us(torch, fn, calls: int = 20) -> dict:
    """The kernels ``fn()`` runs on the device, traced over ``calls``
    calls: mean device us a call by kernel name (the function's name
    without its namespace and arguments)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out: dict = {}
    # a profiler session on the card now and then records no device event
    # at all (seen once in a 4000-row call): such a session is traced again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = re.search(r"(?:^|::)(\w+)[<(]", e.name)
                key = name.group(1) if name else e.name[:60]
                out[key] = (out.get(key, 0.0)
                            + e.time_range.elapsed_us() / calls)
        if out:
            break
    return out


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


def profile_graph_step(torch, holder) -> dict:
    """One replayed decode step through :func:`profile_step`: the holder
    (a ``GreedyGraph`` or an ``ARGraph``) is rewound to the end of its
    prefill first, so the four steps profiled write inside its caches."""
    if hasattr(holder, "pos"):
        holder.pos.fill_(holder.prompt_len)
        holder.fill = holder.prompt_len
    else:
        holder.group.zero_()
        holder.steps = 0
    return profile_step(torch, holder.advance)


def graph_stats(graphs) -> dict:
    """Capture ms and pool MiB of a caller's step graphs and its other
    graphs (the prefills, tails and emissions), its loop graphs' and
    chains' build ms (a WHILE node or a chain around captured graphs: no
    pool of their own), its graph launches and the decode steps they
    ran."""
    gs, loops = graphs.graphs(), graphs.loops()
    side, chains = graphs.side_graphs(), graphs.chains()
    return {"graphs": len(gs), "capture_ms": [g.capture_ms for g in gs],
            "side_graphs": len(side),
            "side_capture_ms": [g.capture_ms for g in side],
            "pool_mib": graphs.pool_bytes() / 2 ** 20,
            "loops": len(loops), "loop_build_ms": [lp.build_ms
                                                   for lp in loops],
            "chains": {c.n: c.build_ms for c in chains},
            "replays": graphs.replays, "steps": graphs.steps}


def front_stats(enc) -> list:
    """Each captured front (``EncodeGraph``) of an encoder: its bucket,
    padded batch and wire dtype, capture ms, the MiB its capture added to
    the graphs' shared pool, and its replays."""
    return [{"bucket": h.audio.shape[1], "batch": h.audio.shape[0],
             "wire": str(h.audio.dtype).replace("torch.", ""),
             "capture_ms": h.graph.capture_ms,
             "pool_mib": h.pool_bytes / 2 ** 20, "replays": h.graph.replays}
            for h in enc._graphs.holders("encode")]


def greedy_keys(enc) -> list:
    """The keys of an encoder's greedy holders (batch at 2, prompt_len at
    5)."""
    return [k for k in enc._graphs._holders if k[0] == "greedy"]


def check_fronts(name, enc) -> list:
    """The encoder's encodes went through its captured fronts: at least
    one front, and every encode a replay of one."""
    fronts = front_stats(enc)
    check(fronts and sum(f["replays"] for f in fronts) > 0,
          f"{name}: no encode replayed a captured front ({fronts})")
    return fronts


def eager_front(enc):
    """The encoder with its front issued op by op from Python and its
    greedy loop still replayed (the send path before the front was
    captured): a context."""
    return mock.patch.object(enc, "_graphed", lambda: False)


def front_bits(torch, enc, phrases, name) -> dict:
    """One encode of ``phrases`` through the captured front and one through
    the eager front: the tokens, the energy and pitch codes, f0 and rms
    bit-equal, and the front's encoder output bit-equal to
    ``encode_front`` run eagerly on the same uploaded inputs."""
    from janus_tpu_torch.runtime.codec import duration_bucket, encode_front

    graph = enc.encode_batch_submit(phrases)._arrays
    with eager_front(enc):
        eager = enc.encode_batch_submit(phrases)._arrays
    bucket = duration_bucket(max(len(p) for p in phrases), enc.buckets)
    with torch.no_grad(), enc._graphs.lock:
        h = enc.encode_graph(bucket, 1 << (len(phrases) - 1).bit_length())
        ref = encode_front(enc.params, enc.cfg, enc._compute_dtype, h.audio,
                           h.n_valid, h.n_frames)[0]
        enc_equal = torch.equal(h.enc, ref)
    names = ("tokens", "energy_code", "pitch_code", "f0", "rms")
    equal = {n: torch.equal(a, b) for n, a, b in zip(names, graph, eager)}
    equal["enc"] = enc_equal
    check(all(equal.values()), f"{name}: the captured front differs from "
          f"the eager one: {equal}")
    return equal


def front_turns(torch, enc, phrases, name, rounds: int = 3) -> dict:
    """ms of encodes of ``phrases`` through the captured front and through
    the eager front (the loop replayed in both), in turns (graph, eager,
    eager, graph, ...), after one of each: equal results throughout."""
    ref = enc.encode_batch(phrases)
    with eager_front(enc):
        check(enc.encode_batch(phrases) == ref, f"{name}: eager front")
    ms = {"graph": [], "eager": []}
    for eager in (False, True, True, False) * rounds:
        with eager_front(enc) if eager else contextlib.nullcontext():
            res, t = synced_ms(torch, lambda: enc.encode_batch(phrases))
        ms["eager" if eager else "graph"].append(t)
        check(res == ref, f"{name}: the {'eager' if eager else 'captured'} "
              f"front gives {res}, the first {ref}")
    return ms


def front_host_calls(torch, enc, bucket: int, batch: int) -> dict:
    """The front of (bucket, batch) issued op by op from Python over its
    static buffers, against one replay of its capture (``profile_step``):
    the host's calls, kernels, wall, device busy, span and idle share."""
    keys = ("host_api_calls", "host_calls", "device_events", "wall_ms",
            "device_busy_ms", "device_span_ms", "device_idle_share")
    with torch.no_grad(), enc._graphs.lock:
        h = enc.encode_graph(bucket, batch)
        eager = profile_step(torch, h._step)
        graph = profile_step(torch, h.graph.replay)
    return {"eager": {k: eager[k] for k in keys},
            "captured": {k: graph[k] for k in keys}}


def int8_linear_before(torch, x, qw, b=None):
    """The dynamic-int8 linear as the port ran it before its kernel, ~15
    eager launches: the per-row quantization, ``torch._int_mm`` (cuBLASLt
    takes more than 16 rows, so fewer are zero-padded to 17) and the
    rescale. A yardstick only: the port no longer calls it."""
    from janus_tpu_torch.ops.int8_linear import _round_int8, _scale_of

    xf = x.float()
    x_scale = _scale_of(xf.abs().amax(dim=-1, keepdim=True))
    xq = _round_int8(xf / x_scale).reshape(-1, x.shape[-1])
    m = xq.shape[0]
    if m < 17:
        xq = torch.cat([xq, torch.zeros((17 - m, xq.shape[1]),
                                        dtype=xq.dtype, device=xq.device)])
    acc = torch._int_mm(xq, qw.q)[:m].reshape(tuple(x.shape[:-1])
                                              + (qw.q.shape[-1],))
    y = acc.float() * x_scale * qw.scale
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def row_major(params):
    """The tree with every dynamic-int8 weight stored row-major (as the
    tree held it before ``column_major``): a copy for the yardstick."""
    from janus_tpu_torch.ops.quant import DynQuantizedWeight

    if isinstance(params, DynQuantizedWeight):
        return DynQuantizedWeight(params.q.contiguous(), params.scale)
    if isinstance(params, dict):
        return {k: row_major(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)) and not hasattr(params, "_fields"):
        return type(params)(row_major(v) for v in params)
    return params


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


class WsClient:
    """A minimal WebSocket client on the standard library (the card's
    machine need not have a WebSocket package): the RFC 6455 handshake,
    masked text frames out, unmasked frames in."""

    _GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

    def __init__(self, port: int, path: str = "/ws/janus",
                 host: str = "127.0.0.1", timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        key = base64.b64encode(os.urandom(16)).decode()
        self._sock.sendall((
            f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
            "\r\n").encode())
        while b"\r\n\r\n" not in self._buf:
            self._fill()
        head, self._buf = self._buf.split(b"\r\n\r\n", 1)
        accept = base64.b64encode(hashlib.sha1(
            (key + self._GUID).encode()).digest()).decode()
        check(head.startswith(b"HTTP/1.1 101")
              and f"Sec-WebSocket-Accept: {accept}".encode() in head,
              f"websocket handshake answered {head!r}")

    def _fill(self) -> None:
        data = self._sock.recv(65536)
        if not data:
            raise ConnectionError("the server closed the websocket")
        self._buf += data

    def _frame(self):
        """(first byte, payload) of the next whole frame; the buffer is
        consumed only once the frame is complete, so a timeout loses
        nothing."""
        while True:
            buf = self._buf
            if len(buf) >= 2:
                n, off = buf[1] & 0x7F, 2
                ext = {126: 2, 127: 8}.get(n, 0)
                if len(buf) >= off + ext:
                    if ext:
                        n = int.from_bytes(buf[off:off + ext], "big")
                        off += ext
                    if len(buf) >= off + n:
                        self._buf = buf[off + n:]
                        return buf[0], buf[off:off + n]
            self._fill()

    def send_json(self, obj) -> None:
        payload = json.dumps(obj).encode()
        n = len(payload)
        if n < 126:
            head = bytes([0x81, 0x80 | n])
        elif n < 1 << 16:
            head = bytes([0x81, 0x80 | 126]) + n.to_bytes(2, "big")
        else:
            head = bytes([0x81, 0x80 | 127]) + n.to_bytes(8, "big")
        mask = os.urandom(4)
        self._sock.sendall(head + mask + bytes(
            b ^ mask[i % 4] for i, b in enumerate(payload)))

    def recv_json(self, timeout: float = 5.0):
        """The next text message, parsed; ``TimeoutError`` when none
        arrives within ``timeout`` seconds."""
        self._sock.settimeout(timeout)
        message = b""
        while True:
            first, payload = self._frame()
            opcode = first & 0x0F
            if opcode == 0x8:
                raise ConnectionError("the server closed the websocket")
            if opcode in (0x0, 0x1):
                message += payload
                if first & 0x80:
                    return json.loads(message)

    def close(self) -> None:
        try:
            self._sock.sendall(bytes([0x88, 0x82]) + b"\x00" * 4
                               + (1000).to_bytes(2, "big"))
        except OSError:
            pass
        self._sock.close()


def http_json(port: int, path: str, body: bytes = None,
              content_type: str = None, timeout: float = 120.0):
    """``(status, parsed JSON)`` of a GET (no body) or POST to the local
    server, on ``http.client`` (no proxy is ever consulted)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET" if body is None else "POST", path, body=body,
                     headers={"Content-Type": content_type}
                     if content_type else {})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def multipart(field: str, filename: str, data: bytes, content_type: str):
    """A multipart/form-data body of one file part, as a browser's
    ``FormData`` sends it, and its Content-Type."""
    boundary = "----janusform" + os.urandom(8).hex()
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="{field}"; filename="{filename}"\r\n'
            f"Content-Type: {content_type}\r\n\r\n").encode() + data + (
                f"\r\n--{boundary}--\r\n").encode()
    return body, f"multipart/form-data; boundary={boundary}"


@contextlib.contextmanager
def serving(server, start_engine: bool = True):
    """Run ``server`` (a ``JanusServer``) on an asyncio loop in a thread;
    yield the loop, then stop the server and join the thread."""
    loop = asyncio.new_event_loop()
    started, state = threading.Event(), {}

    async def main():
        state["stop"] = asyncio.Event()
        try:
            await server.start(start_engine=start_engine)
        except BaseException as e:
            state["error"] = e
            started.set()
            raise
        started.set()
        await state["stop"].wait()
        await server.stop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(main())
        finally:
            loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    check(started.wait(60) and "error" not in state,
          f"the server did not start: {state.get('error')}")
    try:
        yield loop
    finally:
        loop.call_soon_threadsafe(state["stop"].set)
        thread.join(timeout=60)
        check(not thread.is_alive(), "the server thread did not stop")


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


def synth_host_calls(torch, syn, text, emo) -> dict:
    """One ``Synthesizer._synth_impl`` under the profiler's host trace, up
    to the read ``_run_tts`` makes (``n48``): the host's API calls that put
    work on the device, its graph launches, and the waits or device->host
    reads before that read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.no_grad(), syn._graphs.lock:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            wav, n48 = syn._synth_impl(text, emo, None)
        n = int(n48[0])
    calls = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    torch.cuda.synchronize()
    return {"host_api_calls": sum(1 for c in calls if HOST_API.match(c)),
            "graph_launches": sum(c.startswith("cudaGraphLaunch")
                                  for c in calls),
            "kernel_launches": sum(c.startswith("cudaLaunchKernel")
                                   for c in calls),
            "waits_before_read": [c for c in calls if HOST_WAIT.search(c)],
            "n48": n}


def host_api_calls(torch, fn) -> int:
    """The host's API calls that put work on the device in one ``fn()``
    (the profiler's host trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and HOST_API.match(e.name))


def receive_flagship(torch, dev):
    """Flagship TTS + default vocoder, random bf16 weights:
    ``Synthesizer._synth_impl`` over the full budget at b = 8 and b = 1,
    through its captured synthesis (one launch of a ``SynthGraph``: the
    prefill, the AR loop's WHILE node, the vocoder tail) and issued op by
    op (``eager=True``), in turns, the PCM bit-equal; each stage's device
    ms, the host's calls before the read, the new graphs' capture ms and
    pool. Returns what :func:`receive_stream` reuses."""
    from janus_tpu_torch.common.config import (JanusConfig, TTSConfig,
                                               VocoderConfig)
    from janus_tpu_torch.models import tts as tts_mod
    from janus_tpu_torch.models import vocoder as voc_mod
    from janus_tpu_torch.models.params import (cast_floating,
                                               flatten_with_paths, tree_to)
    from janus_tpu_torch.models.tokenizer import ByteTokenizer
    from janus_tpu_torch.ops.mixed_linear import KERNEL as MIXED_KERNEL
    from janus_tpu_torch.ops.resample import resample_poly
    from janus_tpu_torch.runtime.synthesizer import Synthesizer, vocode_48k
    from janus_tpu_torch.tools.trace_step import trace_replays

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
    cfg = dataclasses.replace(JanusConfig(), vocoder=vcfg, tts=dataclasses.
                              replace(tcfg, max_mel_frames=n_frames))
    # random-weight stop logits sit near 0; a hard negative bias runs every
    # lane to the full budget (the synthesizer's threshold is 0.5)
    stop = tts_params["stop_head"]
    params = {**tts_params, "stop_head": {
        **stop, "b": torch.full_like(stop["b"], -5.0)}}
    syns = {eager: Synthesizer(cfg, tts_params=params,
                               vocoder_params=voc_params, device="cuda",
                               eager=eager) for eager in (False, True)}
    graphs = syns[False]._graphs

    out = {"phase": "receive_flagship",
           "model": "TTSConfig.flagship() + VocoderConfig() (random, seeds "
                    "0 and 1), stop bias -5", "dtype": "bfloat16 weights, "
           "bfloat16 caches, float32 step activations",
           "entry": "Synthesizer._synth_impl (SynthGraph vs eager=True)",
           "tts_params_m": n_params / 1e6, "max_groups": max_groups,
           "lane_seconds": lane_seconds, "init_s": round(init_s, 3),
           "batches": {}}
    with torch.no_grad():
        for b in RECEIVE_BATCHES:
            # the inputs on the host, as _run_tts hands them over
            text = torch.zeros((b, 32), dtype=torch.long)
            emo = torch.zeros((b,), dtype=torch.long)

            def synth(eager):
                syn = syns[eager]
                with syn._graphs.lock:
                    wav, n48 = syn._synth_impl(text, emo, None)
                    return wav.clone(), n48.clone()

            pool0 = graphs.pool_bytes()
            (ref, n48), first_ms = synced_ms(torch, lambda: synth(False))
            synth(True)  # warm-up of the eager path
            torch.cuda.reset_peak_memory_stats()
            # the captured synthesis and the eager one, in turns: the same
            # PCM bit for bit
            e2e, e2e_eager = [], []
            for eager in (False, True, False):
                (wav, n), ms = synced_ms(torch, lambda: synth(eager))
                (e2e_eager if eager else e2e).append(ms)
                check(torch.equal(wav, ref) and torch.equal(n, n48),
                      f"receive_flagship b={b}: the "
                      f"{'eager' if eager else 'captured'} synthesis "
                      f"differs from the first captured one by "
                      f"{float((wav - ref).abs().max())}")
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            check(tuple(ref.shape) == (b, n_frames * vcfg.hop_length * up)
                  and bool(torch.isfinite(ref).all())
                  and n48.tolist() == [n_frames * vcfg.hop_length * up] * b,
                  f"receive_flagship b={b}: waveform {tuple(ref.shape)}, "
                  f"n48 {n48.tolist()}")
            calls = synth_host_calls(torch, syns[False], text, emo)
            check(calls["graph_launches"] <= 3
                  and not calls["waits_before_read"],
                  f"receive_flagship b={b}: a captured synthesis made "
                  f"{calls['graph_launches']} graph launches and waited "
                  f"{calls['waits_before_read']} before its read")
            with graphs.lock:
                h = syns[False].synth_graph(32, b, None)
                # each stage of the captured synthesis alone, device ms
                stage = {"prefill": [], "loop": [], "tail": []}
                for _ in range(3):
                    stage["prefill"].append(
                        event_ms(torch, h.ar.prefill_graph.replay)[1])
                    trips, ms = event_ms(torch, h.ar.loop.run)
                    stage["loop"].append(ms)
                    h.ar.loop.account(int(trips))
                    stage["tail"].append(event_ms(torch, h.tail.replay)[1])
                h.ar.steps = None
                traces = {
                    "prefill": trace_replays(h.ar.prefill_graph.replay, dev,
                                             rounds=3, per_round=4),
                    "tail": trace_replays(h.tail.replay, dev, rounds=3,
                                          per_round=4)}
                ar_trace_graph = profile_graph_step(torch, h.ar)
                new_graphs = {
                    "prefill_capture_ms": h.ar.prefill_graph.capture_ms,
                    "tail_capture_ms": h.tail.capture_ms,
                    "step_capture_ms": h.ar.graph.capture_ms,
                    "synth_loop_build_ms": h.loop.build_ms,
                    "pool_mib": h.pool_bytes / 2 ** 20,
                    "pool_mib_since_shape": (graphs.pool_bytes() - pool0)
                    / 2 ** 20}
            # the stages the parent issued op by op around its loop graph
            # (the prefill, then the vocoder, the iSTFT and the resampler
            # over the loop's mel), synchronised around each, and the
            # host's calls of the prefill and of the tail
            eager_stage: dict = {}
            text_d, emo_d = text.to(dev), emo.to(dev)
            mel = h.ar.out[:, :max_groups].reshape(
                b, n_frames, tcfg.n_mels).contiguous()
            for _ in range(2):
                _, ms = synced_ms(torch, lambda: tts_mod.tts_prefill(
                    params, cfg.tts, text_d, emo_d, text_vocab=tok.vocab_size,
                    eager=True))
                eager_stage.setdefault("prefill", []).append(ms)
                spec, ms = synced_ms(torch, lambda: voc_mod.vocoder_spectra(
                    voc_params, vcfg, mel))
                eager_stage.setdefault("vocoder_spectra", []).append(ms)
                wav24, ms = synced_ms(torch, lambda: voc_mod.
                                      spectra_to_waveform(vcfg, spec))
                eager_stage.setdefault("istft", []).append(ms)
                _, ms = synced_ms(torch, lambda: resample_poly(
                    wav24, up=up, down=1))
                eager_stage.setdefault("resample_24k_48k", []).append(ms)
            calls_eager = {name: host_api_calls(torch, fn) for name, fn in (
                ("prefill", lambda: tts_mod.tts_prefill(
                    params, cfg.tts, text_d, emo_d,
                    text_vocab=tok.vocab_size, eager=True)),
                ("tail", lambda: vocode_48k(voc_params, cfg, mel,
                                            h.ar.n_groups * tcfg.reduction)))}
            # one AR step, traced
            first, done, state = tts_mod.tts_prefill(
                tts_params, tcfg, text_d, emo_d, max_groups=8,
                text_vocab=tok.vocab_size, stop_threshold=2.0, eager=True)
            at = [0]

            def ar_step():
                tts_mod.tts_decode_chunk(tts_params, tcfg, state, first, done,
                                         at[0], n_steps=1, stop_threshold=2.0)
                at[0] += 1

            ar_trace = profile_step(torch, ar_step)
            best = min(e2e)
            out["batches"][str(b)] = {
                "e2e_ms": e2e, "e2e_eager_ms": e2e_eager,
                "first_call_ms": first_ms,
                "rtf_per_lane_second": best / 1e3
                / (b * lane_seconds), "peak_mem_gib": peak_gib,
                "pcm_graph_equals_eager": True,
                "stage_ms": {**stage, "ar_step": [
                    t / (max_groups - 1) for t in stage["loop"]]},
                "stage_ms_eager": eager_stage,
                "host_calls_before_read": calls,
                "host_calls_eager_prefill_and_tail": calls_eager,
                "new_graphs": new_graphs, "trace": traces,
                "ar_step_trace": ar_trace,
                "ar_step_trace_graph": ar_trace_graph,
                "wav_peak": float(ref.abs().max())}
            del mel, spec, wav24, wav, ref, h
            torch.cuda.empty_cache()

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
        # 16 groups at b = 8 through the kernel against the plain route
        # (the weight widened per call) put in its place: the JAX
        # package's bar for bf16 weights, 1e-2 and equal n_frames
        from janus_tpu_torch.ops import layers as layers_mod

        text = torch.zeros((FLAGSHIP_BATCH, 32), dtype=torch.long,
                           device=dev)
        emo = torch.zeros((FLAGSHIP_BATCH,), dtype=torch.long, device=dev)
        kw = dict(max_groups=16, text_vocab=tok.vocab_size,
                  stop_threshold=2.0, eager=True)
        k_mel, k_frames = tts_mod.tts_generate(tts_params, tcfg, text, emo,
                                               **kw)
        with mock.patch.object(layers_mod, "mixed_route",
                               lambda *a, **k_: "widen"):
            before = MIXED_KERNEL.launches
            p_mel, p_frames = tts_mod.tts_generate(tts_params, tcfg, text,
                                                   emo, **kw)
            check(MIXED_KERNEL.launches == before, "receive_flagship: the "
                  "plain route launched the mixed linear")
        kernel_vs_plain = float((k_mel - p_mel).abs().max())
        check(torch.equal(k_frames, p_frames) and kernel_vs_plain <= 1e-2,
              f"receive_flagship: 16 groups through the kernel differ from "
              f"the plain route by {kernel_vs_plain} (bar 1e-2), n_frames "
              f"{k_frames.tolist()} against {p_frames.tolist()}")
        out["kernel_vs_plain_16_groups"] = {
            "bar": 1e-2, "max_abs": kernel_vs_plain,
            "n_frames_equal": True, "mel_peak": float(p_mel.abs().max())}
    rel = float((on_card - on_cpu).norm() / on_cpu.norm())
    check(bool(torch.isfinite(on_card).all()) and rel <= 5e-2,
          f"receive_flagship: prefill + 4 groups differ from the CPU by "
          f"{rel} relative")
    out["first_groups_vs_cpu"] = {
        "bar_rel": 5e-2, "rel": rel,
        "max_abs": float((on_card - on_cpu).abs().max()),
        "ref_peak": float(on_cpu.abs().max()), "cpu_s": round(cpu_s, 2)}
    out["graph"] = graph_stats(graphs)  # reads the loops' trips back
    check(out["graph"]["loops"] == len(RECEIVE_BATCHES)
          and out["graph"]["steps"] > 0, f"receive_flagship: the synthesis "
          f"loops {out['graph']}")
    # every replayed AR step: 2 layer norms a layer and the final one, the
    # self-attention of each layer, and every linear through the mixed
    # kernel over the bf16 tree itself (the graphs derive no copy of it):
    # the prenet's two (fc1 with its GELU), q/k/v in one launch, out, fc1
    # with its GELU and fc2 a layer, the mel and stop heads in one
    ar_counts = [{k.name: n[0] for k, n in g.counts.items()}
                 for g in graphs.graphs()]
    check(ar_counts and all(c == {"layer_norm": 2 * tcfg.layers + 1,
                                  "decode_attn": tcfg.layers,
                                  "mixed_linear": 4 * tcfg.layers + 3}
                            for c in ar_counts),
          f"receive_flagship: the captured AR steps launch {ar_counts}")
    out["captured_step_launches"] = ar_counts[0]
    out["tts_derived_gib"] = sum(
        t.numel() * t.element_size() for d in graphs._derived.values()
        for _, t in flatten_with_paths(d)) / 2 ** 30
    check(out["tts_derived_gib"] == 0, f"receive_flagship: the graphs hold "
          f"{out['tts_derived_gib']} GiB derived from the TTS tree")
    trace8 = out["batches"][str(RECEIVE_BATCHES[0])]["ar_step_trace_graph"]
    # the captured AR step: at most 260 kernels (566 before the residual
    # adds went into the norms and the cache writes into the attention,
    # 320 before q/k/v and the heads shared launches and fc1 took its
    # GELU), no add over floating values, no GELU kernel, and no
    # index_copy_ but the holder's two output writes
    check(trace8["device_events"] is None
          or (trace8["device_events"] <= 260 and trace8["float_adds"] == 0
              and trace8["gelu_kernels"] == 0
              and trace8["index_copies"] <= 2),
          f"receive_flagship: the replayed AR step ran "
          f"{trace8['device_events']} kernels, {trace8['float_adds']} float "
          f"adds, {trace8['gelu_kernels']} GELU kernels, "
          f"{trace8['index_copies']} index copies")
    out["nvidia_smi"] = nvidia_smi_line()
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
    streamer, eager_streamer = (
        StreamingSynthesizer(scfg, tts_params=params,
                             vocoder_params=voc_params, chunk_groups=16,
                             device="cuda", eager=eager)
        for eager in (False, True))
    text = "status report follows all clear"
    t0 = time.perf_counter()
    streamer.warmup()
    warmup_s = time.perf_counter() - t0
    chunks = list(streamer.stream(text))  # warm-up, and the comparison
    got = np.concatenate(chunks)
    eager_chunks = list(eager_streamer.stream(text))
    check(len(eager_chunks) == len(chunks) and all(
        np.array_equal(a, b) for a, b in zip(chunks, eager_chunks)),
        "receive_stream: the replayed and the eager stream differ")
    torch.cuda.synchronize()
    # captured and eager in turns
    turns, eager_turns = [], []
    for eager in (False, True, True, False):
        (eager_turns if eager else turns).append(
            (eager_streamer if eager else streamer).turnaround(text))
    first_s, total_s, n48 = min(turns, key=lambda t: t[0])
    # the host's calls of one stream, captured and eager, a chunk
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    host_calls = {}
    for name, s_ in (("captured", streamer), ("eager", eager_streamer)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            n_chunks = len(list(s_.stream(text)))
        calls = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CPU]
        host_calls[name] = {
            "chunks": n_chunks,
            "host_api_calls_a_chunk": sum(1 for c in calls
                                          if HOST_API.match(c)) / n_chunks,
            "graph_launches_a_chunk": sum(c.startswith("cudaGraphLaunch")
                                          for c in calls) / n_chunks}
    with streamer._graphs.lock:
        em = streamer.stream_graph()
        emit_stats = {"emissions": len(em.side_graphs),
                      "capture_ms": [g.capture_ms for g in em.side_graphs],
                      "pool_mib": em.pool_bytes / 2 ** 20}

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
          "eager_turnarounds": eager_turns,
          "eager_first_audio_s": min(t[0] for t in eager_turns),
          "eager_total_s": min(t[1] for t in eager_turns),
          "stream_graph_equals_eager": True, "host_calls": host_calls,
          "emissions": emit_stats,
          "warmup_s": warmup_s, "graph": graph_stats(streamer._graphs),
          "nvidia_smi": nvidia_smi_line(),
          "fused_ms": {"generate": fused_gen_ms, "vocode_resample":
                       fused_voc_ms},
          "stream_vs_fused_max_abs": err, "bar": bar,
          "wav_peak": float(np.abs(ref).max())})


def packet_key(payload: bytes) -> tuple:
    """A received packet's content, its timestamp left out."""
    from janus_tpu_torch.common.protocol import JanusPacket

    p = JanusPacket.deserialize(payload)
    return (p.text, str(p.mode), sorted((p.prosody or {}).items()),
            p.override_emotion)


def demo_phrases_stream() -> np.ndarray:
    """The three demo phrases, each followed by 1 s of silence."""
    from janus_tpu_torch.audio.synthetic import render_text

    parts = []
    for seed, text in enumerate(DEMO_TEXTS):
        parts += [render_text(text, SR, seed=seed), np.zeros(SR, np.float32)]
    return np.concatenate(parts)


def run_duplex(cfg, encoder, synthesizer, audio, device, *,
               realtime=False, streaming=False, fixed_text=None,
               timeout_s=120.0) -> dict:
    """The live link through the port's own loops, timed from outside:
    ``sender_main.main_loop`` on this thread (capture thread, VAD,
    segmenter, encode, packet, throttled link) → localhost UDP → a receiver
    thread (``receiver_main.receive_loop``, or ``engine.receiver_loop``
    with streaming playback) → captured playback. The loops are not
    changed: the capture, the VAD, the encoder, the link, the listener,
    the synthesizer and the speaker are wrapped to record when each event
    happened. ``fixed_text`` replaces the transcript (after the whole
    encode ran). The receiver is stopped once every packet sent is
    synthesized and played."""
    from janus_tpu_torch.audio.io import StreamAudioService
    from janus_tpu_torch.common.protocol import JanusPacket
    from janus_tpu_torch.common.state import EngineState
    from janus_tpu_torch.models.vad import VoiceActivityDetector
    from janus_tpu_torch.runtime import engine
    from janus_tpu_torch.runtime.link import LinkSimulator, PacketListener
    from janus_tpu_torch.tools.receiver_main import receive_loop
    from janus_tpu_torch.tools.sender_main import main_loop

    clock = time.perf_counter
    rec = {"reads": [], "vad": [], "encodes": [], "sent": [], "rx": [],
           "synth": [], "writes": []}

    class Mic(StreamAudioService):
        def read_chunk(self):
            chunk = super().read_chunk()
            if chunk is not None:
                rec["reads"].append((clock(), chunk))
            return chunk

    class Speaker(StreamAudioService):
        def write_chunk(self, audio):
            super().write_chunk(audio)
            rec["writes"].append((clock(), self.written_chunks[-1]))

    class Listener(PacketListener):
        def receive(self):
            payload = super().receive()
            if payload is not None:
                rec["rx"].append((clock(), payload))
            return payload

    class Link(LinkSimulator):
        def transmit(self, payload):
            t0 = clock()
            super().transmit(payload)
            rec["sent"].append({"handed": t0, "done": clock(),
                                "payload": payload})

    class Encoder:
        def encode_batch(self, phrases):
            t0 = clock()
            out = encoder.encode_batch(phrases)
            for r in out:
                if fixed_text is not None:
                    r["text"] = fixed_text(len(rec["encodes"]) + 1)
                rec["encodes"].append({"ready": t0, "done": clock(),
                                       "text": r["text"],
                                       "phrase_s": len(phrases[0]) / SR})
            return out

    vad = VoiceActivityDetector(cfg.vad, sample_rate=SR, device=device)
    is_speech = vad.is_speech

    def timed_is_speech(chunk):
        t0 = clock()
        out = is_speech(chunk)
        rec["vad"].append((t0, clock() - t0, chunk))
        return out

    vad.is_speech = timed_is_speech

    name = "synthesize_streaming" if streaming else "synthesize"
    synth_fn = getattr(synthesizer, name)

    def timed_stream(packet):
        entry = {"start": clock(), "chunks": []}
        rec["synth"].append(entry)
        for chunk in synth_fn(packet):
            if chunk:
                entry["chunks"].append(len(chunk))
            yield chunk
        entry["end"] = clock()

    def timed_synthesize(packet):
        entry = {"start": clock(), "chunks": []}
        rec["synth"].append(entry)
        audio = synth_fn(packet)
        if audio:
            entry["chunks"].append(len(audio))
        entry["end"] = clock()
        return audio

    setattr(synthesizer, name, timed_stream if streaming else timed_synthesize)
    listener = Listener(0, timeout=0.2)
    cfg = cfg.override(**{"link.target_ip": "127.0.0.1",
                          "link.target_port": listener.port,
                          "link.receiver_port": listener.port})
    mic, speaker = Mic(audio, realtime=realtime), Speaker()
    stop, played = threading.Event(), []
    if streaming:
        rx = threading.Thread(target=engine.receiver_loop, args=(
            speaker, EngineState(), synthesizer, listener, stop, None, cfg),
            daemon=True)
    else:
        rx = threading.Thread(target=lambda: played.append(receive_loop(
            cfg, speaker, synthesizer=synthesizer, listener=listener,
            stop_event=stop, max_idle_seconds=timeout_s)), daemon=True)
    try:
        rx.start()
        t_start = clock()
        sent = main_loop(cfg, mic, encoder=Encoder(), vad=vad,
                         link=Link(cfg.link), max_idle_seconds=2.0)
        t_sender = clock()
        deadline = t_sender + timeout_s
        while clock() < deadline and rx.is_alive():
            done = [e for e in rec["synth"] if "end" in e]
            if len(done) >= sent and len(rec["writes"]) >= sum(
                    len(e["chunks"]) for e in done):
                break
            time.sleep(0.02)
        stop.set()
        rx.join(timeout=60)
        check(not rx.is_alive(), "duplex: the receiver thread did not stop")
    finally:
        delattr(synthesizer, name)
        listener.close()
    t_end = clock()

    # played chunks belong to packets in order (FIFO playback queue)
    writes, turns = list(rec["writes"]), []
    encodes = [e for e in rec["encodes"] if e["text"].strip()]
    for i, entry in enumerate(rec["synth"]):
        mine, writes = writes[:len(entry["chunks"])], writes[len(entry["chunks"]):]
        rx_t, payload = rec["rx"][i]
        turn = {"received_text": JanusPacket.deserialize(payload).text,
                "payload": payload,
                "packet_bytes": len(payload),
                "synth_s": entry.get("end", t_end) - entry["start"],
                "chunks": len(mine),
                "audio_s": sum(len(c) for _, c in mine) / 2 / SR,
                "pcm": b"".join(c for _, c in mine)}
        if mine:
            turn["received_to_first_chunk_s"] = mine[0][0] - rx_t
            turn["received_to_last_chunk_s"] = mine[-1][0] - rx_t
        if i < len(rec["sent"]) and i < len(encodes):
            s_, e_ = rec["sent"][i], encodes[i]
            turn.update({
                "sent_text": JanusPacket.deserialize(s_["payload"]).text,
                "phrase_s": e_["phrase_s"],
                "encode_ms": 1e3 * (e_["done"] - e_["ready"]),
                "ready_to_link_ms": 1e3 * (s_["handed"] - e_["ready"]),
                "airtime_s": s_["done"] - s_["handed"],
                "airtime_nominal_s": len(s_["payload"])
                / cfg.link.bytes_per_second,
                "link_to_received_s": rx_t - s_["done"],
                "phrase_ready_to_first_audio_s": (
                    mine[0][0] - e_["ready"] if mine else None)})
        turns.append(turn)

    # capture queue: the VAD takes chunks in the order they were read, so a
    # chunk read and never taken was dropped by the producer (its put timed
    # out), which it did before its next read
    reads = [t for t, _ in rec["reads"]]
    events, k = [], 0  # (time, change of the queue's depth)
    for t0, _, chunk in rec["vad"]:
        while rec["reads"][k][1] is not chunk:
            events.append((reads[k + 1], -1))
            k += 1
        events.append((t0, -1))
        k += 1
    dropped = k - len(rec["vad"])
    events += [(t, +1) for t in reads]
    depth = high_water = 0
    for _, change in sorted(events, key=lambda e: (e[0], e[1])):
        depth += change
        high_water = max(high_water, depth)
    vad_ms = [1e3 * d for _, d, _ in rec["vad"]]
    gaps = np.diff(reads) * 1e3 if len(reads) > 1 else [0.0]
    return {"sent": sent, "vad": vad.backend,
            "played": (played[0] if played else
                       sum(1 for e in rec["synth"] if e["chunks"])),
            "turns": turns, "sender_s": t_sender - t_start,
            "total_s": t_end - t_start,
            "chunks_read": len(reads), "chunks_vad": len(vad_ms),
            "chunks_dropped": dropped,
            "chunks_left_in_queue": len(reads) - k,
            "queue_high_water": high_water,
            "vad_ms_mean": float(np.mean(vad_ms)) if vad_ms else None,
            "vad_ms_max": float(np.max(vad_ms)) if vad_ms else None,
            "vad_chunks_over_period": sum(v > CHUNK_MS for v in vad_ms),
            "capture_gap_ms_max": float(np.max(gaps))}


def duplex_demo(torch, kernels) -> None:
    """The demo bundle over the live link, on the card and on the CPU."""
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.models.zoo import load_demo
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    bundle = load_demo(base=JanusConfig())
    # a capture faster than real time: the queue holds the whole stream, so
    # that no chunk is dropped while the loop encodes
    cfg = bundle.config.override(**{"link.baud_rate": 48_000,
                                    "runtime.audio_queue_depth": 1_000})
    audio = demo_phrases_stream()
    runs, launches = {}, {}
    for device in ("cuda", "cpu"):
        enc = SemanticEncoder(cfg, bundle.asr_params, buckets=(96_000,),
                              device=device)
        syn = Synthesizer(cfg, tts_params=bundle.tts_params,
                          vocoder_params=bundle.vocoder_params,
                          speaker_params=bundle.speaker_params,
                          default_speaker_vec=bundle.default_speaker_vec,
                          device=device)
        enc.warmup()
        if device == "cuda":
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
        runs[device] = run_duplex(cfg, enc, syn, audio, device,
                                  timeout_s=60.0)
        if device == "cuda":
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in kernels}
    card, cpu = runs["cuda"], runs["cpu"]
    for device, r in runs.items():
        check(r["sent"] == 3 and r["played"] == 3 and len(r["turns"]) == 3,
              f"duplex_demo on {device}: {r['sent']} sent, {r['played']} "
              f"played")
    heard = [t["received_text"] for t in card["turns"]]
    check(heard == [t["received_text"] for t in cpu["turns"]],
          f"duplex_demo: the card heard {heard}, the CPU "
          f"{[t['received_text'] for t in cpu['turns']]}")
    bar, errs = 1e-2, []
    for a, b in zip(card["turns"], cpu["turns"]):
        check(len(a["pcm"]) == len(b["pcm"]) > 0, f"duplex_demo: "
              f"{len(a['pcm'])} bytes played on the card, {len(b['pcm'])} "
              f"on the CPU")
        errs.append(float(np.abs(pcm_float(a["pcm"])
                                 - pcm_float(b["pcm"])).max()))
    check(max(errs) <= bar, f"duplex_demo: PCM card vs CPU {errs} (bar {bar})")
    for name in ("mel_fused", "flash_attn", "yin_block_sums"):
        check(launches[name] > 0, f"duplex_demo never launched {name}: "
              f"{launches}")

    def brief(r):
        return {k: v for k, v in r.items() if k != "turns"} | {
            "turns": [{k: v for k, v in t.items()
                       if k not in ("pcm", "payload")} for t in r["turns"]]}

    emit({"phase": "duplex_demo", "nvidia_smi": nvidia_smi_line(),
          "link_baud": cfg.link.baud_rate, "spoken": list(DEMO_TEXTS),
          "heard": heard, "misread": [s for s, h in zip(DEMO_TEXTS, heard)
                                      if s != h],
          "pcm_card_vs_cpu_max_abs": errs, "bar": bar,
          "samples": [len(t["pcm"]) // 2 for t in card["turns"]],
          "launches": launches, "card": brief(card), "cpu": brief(cpu)})


def duplex_flagship(torch, kernels, asr_params, tcfg, vcfg, tts_params,
                    voc_params) -> None:
    """The live link at full width on one card: the phase-4 recognizer
    weights and the phase-7 TTS + vocoder weights, reused; once with both
    loops replayed from their graphs and once eagerly, on the same
    capture."""
    from janus_tpu_torch.audio.synthetic import conversation
    from janus_tpu_torch.common.config import ASRConfig, JanusConfig
    from janus_tpu_torch.common.protocol import JanusPacket
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    cfg = dataclasses.replace(JanusConfig(), tts=tcfg, vocoder=vcfg,
                              asr=ASRConfig.large_v3())
    cfg = cfg.override(**{"asr.max_decode_tokens": 24})
    # random-weight stop logits sit near 0; a hard negative bias makes each
    # packet play to its duration cap (0.35 s + 0.15 s a text token)
    stop = tts_params["stop_head"]
    params = {**tts_params, "stop_head": {
        **stop, "b": torch.full_like(stop["b"], -5.0)}}
    audio = conversation(turns=3, speech_seconds=2.0, silence_seconds=1.0)

    def fixed(n):
        return f"test message {n}"

    runs, syns = {}, {}
    for mode in ("graph", "eager"):
        eager = mode == "eager"
        # the default buckets, on the tensors phase 4 built (no copy)
        enc = SemanticEncoder(cfg, asr_params=asr_params, device="cuda",
                              eager=eager)
        syn = Synthesizer(cfg, tts_params=params, vocoder_params=voc_params,
                          device="cuda", eager=eager)
        t0 = time.perf_counter()
        enc.warmup(bucket=48_000 * 4)  # the bucket of a 2 s turn
        syn.warmup()
        list(syn.synthesize_streaming(JanusPacket(text="warm up")))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0

        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        r = run_duplex(cfg, enc, syn, audio, "cuda", realtime=True,
                       streaming=True, fixed_text=fixed, timeout_s=180.0)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        check(r["sent"] == 3 and r["played"] == 3 and len(r["turns"]) == 3,
              f"duplex_flagship ({mode}): {r['sent']} sent, {r['played']} "
              f"played")
        for i, t in enumerate(r["turns"]):
            check(t.get("sent_text") == t["received_text"] == fixed(i + 1)
                  and t["audio_s"] > 0, f"duplex_flagship ({mode}) turn {i}:"
                  f" sent {t.get('sent_text')!r}, played "
                  f"{t['received_text']!r}, {t['audio_s']} s")
        for name in ("mel_fused", "flash_attn", "yin_block_sums"):
            check(launches[name] > 0, f"duplex_flagship ({mode}) never "
                  f"launched {name}: {launches}")
        runs[mode] = {
            "warmup_s": warm_s,
            "fronts": (front_stats(enc) if eager
                       else check_fronts("duplex_flagship", enc)),
            "graph": {"encoder": graph_stats(enc._graphs),
                      "synthesizer": graph_stats(syn.streamer()._graphs)},
            "turns": [{k: v for k, v in t.items()
                       if k not in ("pcm", "payload")} for t in r["turns"]],
            **{k: v for k, v in r.items() if k != "turns"},
            "launches": launches, "peak_mem_gib": peak_gib}
        runs[mode]["played"] = [(packet_key(t["payload"]), t["pcm"])
                                for t in r["turns"]]
        runs[mode]["payloads"] = [t["payload"] for t in r["turns"]]
        syns[mode] = syn
        del enc
        torch.cuda.empty_cache()
    # the capture runs in real time, so the two runs may cut the phrases
    # apart (a chunk dropped while the send loop blocks): a turn whose
    # packet came out equal must have played equal PCM, and every packet
    # of the graph run, synthesized again by both synthesizers, gives the
    # same PCM bit for bit
    same_packet = []
    for (pa, a), (pb, b) in zip(runs["graph"].pop("played"),
                                runs["eager"].pop("played")):
        same_packet.append(pa == pb)
        check(pa != pb or a == b, "duplex_flagship: one packet, different "
              "PCM from the replayed and the eager loops")
    for payload in runs["graph"].pop("payloads"):
        pkt = JanusPacket.deserialize(payload)
        check(b"".join(syns["graph"].synthesize_streaming(pkt))
              == b"".join(syns["eager"].synthesize_streaming(pkt)),
              f"duplex_flagship: {pkt} synthesized by the replayed and the "
              f"eager loop differ")
    del syns, runs["eager"]["payloads"]
    emit({"phase": "duplex_flagship", "nvidia_smi": nvidia_smi_line(),
          "asr": "whisper-large-v3 (random, seed 0; phase-4 weights), "
                 "bfloat16, max_decode_tokens 24, default buckets",
          "tts": "TTSConfig.flagship() + VocoderConfig() (phase-7 weights, "
                 "bfloat16), stop bias -5, streaming playback",
          "capture": "conversation(turns=3, speech 2.0 s, silence 1.0 s), "
                     "real time",
          "link_baud": cfg.link.baud_rate, "chunk_period_ms": CHUNK_MS,
          "packets_equal_by_turn": same_packet,
          "pcm_graph_equals_eager": True, **runs["graph"],
          "eager": runs["eager"]})


# device->host reads and waits the host may not make between a submit's
# start and its result (the profiler's names of the runtime calls and of
# PyTorch's scalar read)
HOST_WAIT = re.compile(r"Synchronize|^cudaMemcpy$|^cudaMemcpy2D$|"
                       r"_local_scalar_dense|^aten::item$")


def eot_at(torch, params, step: int, eot: int):
    """The recognizer tree with the decoder's position row ``step`` pushed
    far along the eot embedding: with a one-token prompt every lane emits
    eot at that step (``tests/test_torch_decode_graphs.py::_asr_eot_at``)."""
    dec = dict(params["decoder"])
    pos = dec["pos_emb"].clone()
    e = dec["token_emb"][eot].float()
    pos[step] += (1000.0 * e / e.norm()).to(pos.dtype)
    return {**params, "decoder": {**dec, "pos_emb": pos}}


def stop_at(torch, params, tcfg, step):
    """The TTS tree whose stop head reads one channel of the final norm
    and fires at AR step ``step`` in every lane, where that step's
    position row is pushed far along the channel; at none for None
    (``tests/test_torch_decode_graphs.py::_tts_stop_at``). The norm's
    output there is near sqrt(d) in that channel and near N(0, 1) at the
    other steps: the head's bias, -sqrt(d) / 2, parts the two."""
    from janus_tpu_torch.models.tts import audio_pos_base

    pos = params["pos_emb"].clone()
    if step is not None:
        pos[audio_pos_base(tcfg) + step - 1, 5] += 1000.0
    head = params["stop_head"]
    w = torch.zeros_like(head["w"])
    w[5, 0] = 1.0
    bias = -0.5 * pos.shape[1] ** 0.5
    return {**params, "pos_emb": pos,
            "stop_head": {"w": w, "b": torch.full_like(head["b"], bias)}}


def event_ms(torch, fn) -> tuple:
    """``(fn(), device ms)`` between two CUDA events around the call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


# the forced exits of both decode loops (every lane ends at that step;
# None: never)
LOOP_EXITS = (1, 2, 7, 8, 9, 17, None)


def loop_parts_check(name, parts) -> None:
    """The loop's body holds its step's own nodes and every edge of it: the
    body's census is the step graph's, every programmatic edge kept, and
    the condition kernel after them (one node, one edge more); no child
    graph node. A chain of ``trips`` steps holds each edge once a step."""
    census, trips = parts["census"], parts["trips"]
    step, body, chain = census["step"], census["body"], census["chain"]
    want = dict(step, nodes=step["nodes"] + 1, kernels=step["kernels"] + 1,
                edges=step["edges"] + 1)
    check(body == want and chain["programmatic_edges"]
          == trips * step["programmatic_edges"] and chain["children"] == 0,
          f"device_loop: {name}'s body {body} or chain {chain} does not hold "
          f"its step's nodes and edges {step}")


def device_loop(torch, kernels, asr_params, fcfg, tcfg, tts_params) -> dict:
    """The decode loops as the reference compiles them: each a WHILE node
    whose body holds the captured step's own nodes, its exit decided on
    the card. At flagship width (large-v3 and the flagship TTS, b = 8), on
    copies of the trees whose position row (the recognizer) or stop head
    (the TTS) is pushed so that every lane ends at step ``LOOP_EXITS``, or
    never: the loop's trips (== the step) and device ms, its tokens, mel
    and ``n_frames`` against the eager loop's bit for bit; at the never
    exit the loop against a chain of its steps and the step replayed as
    often (``trace_loop_parts``: the per-body costs and the programmatic
    edges of the body against the step's), and a run that skips at once.
    Then the submit: its return ms at b 8 x 10 s and b 1 x 2 s,
    ``is_ready()`` right after, and no wait or device->host copy in it
    (the profiler's host calls). Returns the phase's kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from janus_tpu_torch.audio.synthetic import voiced_phrase
    from janus_tpu_torch.models import asr as asr_mod
    from janus_tpu_torch.models import tts as tts_mod
    from janus_tpu_torch.models.tokenizer import ByteTokenizer
    from janus_tpu_torch.ops.resample import decimate_48k_to_16k
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.step_graph import StepGraphs
    from janus_tpu_torch.tools.trace_step import trace_loop_parts

    from janus_tpu_torch.common import device as device_mod

    dev = device_mod.resolve_device("cuda")
    bf = torch.bfloat16
    acfg = fcfg.asr
    reset_launches(kernels)
    out = {"phase": "device_loop", "nvidia_smi": nvidia_smi_line(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "route": "WHILE conditional node whose body holds the captured "
                    "step's own nodes and edges (csrc/loop_graph.cu)"}

    # (a) the recognizer's loop at forced exits, b 8 x 10 s
    enc = SemanticEncoder(fcfg, asr_params=asr_params,
                          buckets=(SESSION_BUCKET, int(SR * FLAGSHIP_SECONDS)),
                          device="cuda")
    phrases = [voiced_phrase(f0=140.0 + 15 * i, seconds=FLAGSHIP_SECONDS,
                             amp=0.12, seed=i) for i in range(FLAGSHIP_BATCH)]
    audio = torch.from_numpy(np.stack(phrases)).to(dev)
    n16 = enc.mel_frame_budget(int(SR * FLAGSHIP_SECONDS))
    with torch.no_grad():
        mel = asr_mod.prepare_mel(decimate_48k_to_16k(audio), acfg,
                                  pad_to_frames=n16)
        encoded = asr_mod.encode_audio(enc.params, acfg, mel.to(bf))
    eot = enc.tokenizer.eot
    prompt = torch.full((FLAGSHIP_BATCH, 1), enc.tokenizer.sot,
                        dtype=torch.long, device=dev)
    greedy = {}
    for k in LOOP_EXITS:
        tree = enc.params if k is None else eot_at(torch, enc.params, k, eot)
        graphs = StepGraphs()
        with torch.no_grad(), graphs.lock:
            h = asr_mod.greedy_graph(graphs, tree, acfg, FLAGSHIP_BATCH,
                                     encoded.shape[-2], bf, 1,
                                     acfg.max_decode_tokens, bf, False, eot,
                                     dev)
            eager = asr_mod.greedy_decode(
                tree, acfg, encoded, prompt, eot,
                max_new=acfg.max_decode_tokens, cache_dtype=bf, eager=True)
            ms = []
            for _ in range(3):
                h.prime(encoded, prompt)
                (tokens, trips), t = event_ms(torch, h.run_loop)
                ms.append(t)
                check(torch.equal(tokens, eager), f"device_loop: the "
                      f"recognizer's loop graph differs from the eager loop "
                      f"(exit {k})")
            want = acfg.max_decode_tokens - 1 if k is None else k
            row = {"trips": int(trips), "loop_ms": ms,
                   "step_capture_ms": h.graph.capture_ms,
                   "loop_build_ms": h.loop.build_ms,
                   "pool_mib": graphs.pool_bytes() / 2 ** 20}
            check(int(trips) == want, f"device_loop: the recognizer's loop "
                  f"ran {int(trips)} steps, the while_loop {want} (exit {k})")
            if k is None:
                # the loop traced against a chain of its steps and the
                # step replayed as often, and a run whose lanes are all
                # done before it
                parts = trace_loop_parts(
                    h.loop, lambda: h.prime(encoded, prompt), h.advance,
                    int(trips), dev)
                loop_parts_check("the recognizer's loop", parts)
                row["loop_trace"] = parts.pop("a_loop")
                row["step_trace"] = parts.pop("c1_step")
                row["parts"] = parts
                row["step_span_in_loop_ms"] = (
                    row["loop_trace"]["span_ms"] / max(int(trips), 1))
                h.done.fill_(True)
                h.loop.trips.zero_()
                _, t = event_ms(torch, lambda: [h.loop.run()
                                                for _ in range(100)])
                row["skipped_run_us"] = 10.0 * t
                check(int(h.loop.trips) == 0, "device_loop: a loop whose "
                      "lanes were all done ran a step")
            greedy["never" if k is None else str(k)] = row
        del graphs, h
    out["greedy_b8_10s"] = greedy
    torch.cuda.empty_cache()

    # (b) the submit: its return, nothing read back, its result
    one = [voiced_phrase(f0=150.0, seconds=2.0, amp=0.12, seed=0)]
    submits = {}
    for name, phr in (("b8_10s", phrases), ("b1_2s", one)):
        want = enc.encode_batch(phr)  # captures the shape's graphs
        ret, ready, total = [], [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = enc.encode_batch_submit(phr)
            ret.append(1e3 * (time.perf_counter() - t0))
            ready.append(pending.is_ready())
            res = pending.result()
            total.append(1e3 * (time.perf_counter() - t0))
            check(res == want, f"device_loop: a submit's result at {name} "
                  f"differs from encode_batch's")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pending = enc.encode_batch_submit(phr)
        calls = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CPU]
        res = pending.result()
        waits = [n for n in calls if HOST_WAIT.search(n)]
        # the enqueue alone: the upload and the two launches, the host's
        # padding and wire conversion left out
        with torch.no_grad(), enc._graphs.lock:
            holder = enc.encode_graph(enc.buckets[0 if name == "b1_2s"
                                                  else 1], len(phr))
            batch = holder.host_audio.numpy().copy()
            n_valid = holder.host_n_valid.numpy().copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            holder.run(batch, n_valid)
            enqueue_ms = 1e3 * (time.perf_counter() - t0)
            holder.greedy.loop.account(int(holder.trips))
        submits[name] = {
            "submit_return_ms": ret, "ready_after_submit": ready,
            "result_ms": total, "enqueue_ms": enqueue_ms,
            "host_waits": waits,
            "graph_launches": sum(n.startswith("cudaGraphLaunch")
                                  for n in calls),
            "host_api_calls": sum(1 for n in calls if HOST_API.match(n))}
        check(not waits and res == want, f"device_loop: the submit at {name} "
              f"waited on the device ({waits})")
        check(submits[name]["graph_launches"] <= 2, f"device_loop: a submit "
              f"made {submits[name]['graph_launches']} graph launches")
    out["submit"] = submits
    # three submits at b 8 x 10 s in a row, none harvested before the
    # third: the uploads that waited for an earlier encode's copy with one
    # pinned twin, and with one twin an encode in flight (the encoder's)
    want8 = enc.encode_batch(phrases)
    with enc._graphs.lock:
        holder = enc.encode_graph(enc.buckets[1], FLAGSHIP_BATCH)
    twins, waits = holder.twins, {}
    for n in (1, len(twins)):
        holder.twins = twins[:n]
        torch.cuda.synchronize()
        before = holder.upload_waits
        pending = [enc.encode_batch_submit(phrases) for _ in range(3)]
        waits[str(n)] = holder.upload_waits - before
        check(all(p_.result() == want8 for p_ in pending), "device_loop: "
              "three submits in a row gave another result")
    holder.twins = twins
    out["upload_waits_three_submits"] = waits
    check(waits[str(len(twins))] == 0, f"device_loop: a submit waited for "
          f"an upload with a twin an encode in flight ({waits})")
    check(not any(submits["b8_10s"]["ready_after_submit"]),
          "device_loop: an encode at b 8 x 10 s was ready as its submit "
          "returned")
    out["encoder_graph"] = graph_stats(enc._graphs)
    del enc, encoded, mel, audio
    torch.cuda.empty_cache()

    # (c) the AR loop at forced stops, b 8, the flagship's 256 groups
    vocab = ByteTokenizer().vocab_size
    text = torch.zeros((FLAGSHIP_BATCH, 32), dtype=torch.long, device=dev)
    emo = torch.zeros((FLAGSHIP_BATCH,), dtype=torch.long, device=dev)
    ar = {}
    for k in LOOP_EXITS:
        tree = stop_at(torch, tts_params, tcfg, k)
        graphs = StepGraphs()
        kw = dict(max_groups=RECEIVE_GROUPS, text_vocab=vocab,
                  stop_threshold=0.5)
        with torch.no_grad():
            mel_g, n_g = tts_mod.tts_generate(tree, tcfg, text, emo,
                                              graphs=graphs, **kw)
            mel_e, n_e = tts_mod.tts_generate(tree, tcfg, text, emo,
                                              eager=True, **kw)
            check(torch.equal(mel_g, mel_e) and torch.equal(n_g, n_e),
                  f"device_loop: the AR loop graph differs from the eager "
                  f"loop (stop {k})")
            with graphs.lock:
                (h,) = graphs.holders("ar")
                ms = []
                for _ in range(3):
                    h.prefill(text, emo)
                    trips, t = event_ms(torch, h.run_loop)
                    ms.append(t)
            graphs.settle()
        want = RECEIVE_GROUPS - 1 if k is None else k
        check(int(trips) == want and n_g.tolist() == [
            (want + 1) * tcfg.reduction] * FLAGSHIP_BATCH,
            f"device_loop: the AR loop ran {int(trips)} steps, the "
            f"while_loop {want} (stop {k}); n_frames {n_g.tolist()}")
        row = {"trips": int(trips), "loop_ms": ms,
               "n_frames": int(n_g[0]), "step_capture_ms": h.graph.capture_ms,
               "loop_build_ms": h.loop.build_ms,
               "pool_mib": graphs.pool_bytes() / 2 ** 20}
        if k is None:
            def rewind():
                h.prev.copy_(saved[0])
                h.done.copy_(saved[1])
                h.group.zero_()
                h.loop.trips.zero_()

            with graphs.lock:
                h.prefill(text, emo)
                saved = [t_.clone() for t_ in (h.prev, h.done)]

                def rewind_step():
                    rewind()
                    h.steps = 0

                parts = trace_loop_parts(h.loop, rewind_step, h.advance,
                                         int(trips), dev)
                loop_parts_check("the AR loop", parts)
                row["loop_trace"] = parts.pop("a_loop")
                row["step_trace"] = parts.pop("c1_step")
                row["parts"] = parts
                rewind()
                h.done.fill_(True)
                h.loop.run()
                check(int(h.loop.trips) == 0, "device_loop: an AR loop whose "
                      "lanes were all done ran a step")
            row["step_span_in_loop_ms"] = (row["loop_trace"]["span_ms"]
                                           / max(int(trips), 1))
        ar["never" if k is None else str(k)] = row
        del graphs, h, tree, mel_g, mel_e
        torch.cuda.empty_cache()
    out["ar_b8_256_groups"] = ar
    out["launches"] = read_launches(kernels)
    check(out["launches"]["loop_graph"] > 0, f"device_loop: launches "
          f"{out['launches']}")
    emit(out)
    return out["launches"]


def sessions_flagship(torch, kernels, asr_params) -> dict:
    """The multi-session serving runtime at large-v3 width on the phase-4
    weights: (a) encode batch scaling, (b) the serving tick loop,
    synchronous and overlapped, (c) the native ring buffers. Returns the
    overlapped run's kernel launches."""
    from janus_tpu_torch.audio.synthetic import conversation, voiced_phrase
    from janus_tpu_torch.common.config import ASRConfig, JanusConfig
    from janus_tpu_torch.models import asr as asr_mod
    from janus_tpu_torch.native import HAVE_NATIVE
    from janus_tpu_torch.ops.resample import decimate_48k_to_16k
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.sessions import SessionManager

    cfg = dataclasses.replace(JanusConfig(), asr=ASRConfig.large_v3())
    cfg = cfg.override(**{"asr.max_decode_tokens": 24})
    acfg = cfg.asr
    errors = ErrorRecords()
    sessions_log = logging.getLogger("janus_tpu_torch.runtime.sessions")
    sessions_log.addHandler(errors)

    def read_launches():
        torch.cuda.synchronize()
        return {k.name: k.launches for k in kernels}

    def reset_launches():
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0

    def check_launches(where, launches, batches, captured=0):
        # a front captured inside the window ran once eagerly first (its
        # warm-up), then replayed
        check(launches["mel_fused"] >= batches
              and launches["flash_attn"]
              == acfg.encoder_layers * (batches + captured)
              and launches["yin_block_sums"] >= batches,
              f"sessions_flagship {where}: launches {launches} for "
              f"{batches} encode batches, {captured} fronts captured")

    # (a) batch scaling: ms per encode_batch, best of 2 after a warm-up
    # (which captures the decode step), then once with the eager loop
    enc = SemanticEncoder(cfg, asr_params=asr_params,
                          buckets=(SESSION_BUCKET,), device="cuda")
    enc_eager = SemanticEncoder(cfg, asr_params=asr_params,
                                buckets=(SESSION_BUCKET,), device="cuda",
                                eager=True)
    scaling = {}
    for b in SESSION_BATCHES:
        phrases = [voiced_phrase(f0=150.0 + 3 * i, seconds=2.0, amp=0.12,
                                 seed=i) for i in range(b)]
        first = enc.encode_batch(phrases)  # warm-up
        reset_launches()
        times = [synced_ms(torch, lambda: enc.encode_batch(phrases))[1]
                 for _ in range(2)]
        launches = read_launches()
        check_launches(f"b={b}", launches, 2)
        res, eager_ms = synced_ms(torch, lambda: enc_eager.encode_batch(
            phrases))
        check(res == first, f"sessions_flagship b={b}: the eager encode "
              f"gives {res}, the replayed one {first}")
        front_ms = front_turns(torch, enc, phrases, f"sessions_flagship "
                               f"b={b}", rounds=1)
        scaling[str(b)] = {"encode_ms": times, "best_ms": min(times),
                           "front_turns_ms": front_ms,
                           "audio_s_per_s": b * 2.0 / (min(times) / 1e3),
                           "eager_ms": eager_ms,
                           "eager_audio_s_per_s": b * 2.0 / (eager_ms / 1e3),
                           "launches": launches}
    # one decode step at b = 64, traced
    b = SESSION_BATCHES[-1]
    with torch.no_grad():
        audio = torch.from_numpy(np.stack([voiced_phrase(
            f0=150.0 + 3 * i, seconds=2.0, amp=0.12, seed=i)
            for i in range(b)])).to(enc.device)
        mel = asr_mod.prepare_mel(decimate_48k_to_16k(audio), acfg,
                                  pad_to_frames=enc.mel_frame_budget(
                                      SESSION_BUCKET))
        encoded = asr_mod.encode_audio(enc.params, acfg,
                                       mel.to(torch.bfloat16))
        prompt = torch.full((b, 1), enc.tokenizer.sot, dtype=torch.long,
                            device=enc.device)
        step = profile_decode_step(torch, asr_mod, enc.params, acfg, encoded,
                                   prompt)
        with enc._graphs.lock:
            step_graph = profile_graph_step(torch, asr_mod.greedy_graph(
                enc._graphs, enc.params, acfg, b, encoded.shape[-2],
                encoded.dtype, 1, acfg.max_decode_tokens, torch.bfloat16,
                False, enc.tokenizer.eot, enc.device))
    scaling_graph = graph_stats(enc._graphs)
    scaling_fronts = check_fronts("sessions_flagship", enc)
    del enc, enc_eager, audio, mel, encoded
    torch.cuda.empty_cache()

    # (b) the serving tick loop: 32 sessions, one 32 ms chunk per session
    # per tick through push_audio; the transcript fixed at the host-decode
    # hook (random weights give none), as bench.py:487-492 does
    class FixedText(SemanticEncoder):
        def _finalize(self, arrays, b_real):
            out = super()._finalize(arrays, b_real)
            for r in out:
                r["text"] = "status report follows"
            return out

    serve_encs = {mode: FixedText(cfg, asr_params=asr_params,
                                  buckets=(SESSION_BUCKET,), device="cuda",
                                  eager=mode == "eager")
                  for mode in ("graph", "eager")}
    streams = [conversation(turns=2, speech_seconds=0.8 + 0.05 * (i % 8),
                            silence_seconds=0.7, f0=130.0 + 4 * i, amp=0.3,
                            seed=i) for i in range(SESSION_COUNT)]
    chunk = cfg.audio.chunk_samples
    total_audio_s = sum(len(a) for a in streams) / SR
    n_ticks = max(len(a) for a in streams) // chunk + 40

    def run_mode(mode_cfg, serve_enc) -> dict:
        submit = serve_enc.encode_batch_submit
        mgr = SessionManager(mode_cfg, encoder=serve_enc)
        sizes, tick_vad_ms, vad_ms, submit_ms = [], [], [0.0], []

        def timed_submit(phrases):
            sizes.append(len(phrases))
            t0 = time.perf_counter()
            out = submit(phrases)
            submit_ms.append(1e3 * (time.perf_counter() - t0))
            return out

        def upload_waits():
            return sum(h.upload_waits
                       for h in serve_enc._graphs.holders("encode"))

        serve_enc.encode_batch_submit = timed_submit
        waits0 = upload_waits()

        def timed(fn):
            def call(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                vad_ms[0] += 1e3 * (time.perf_counter() - t0)
                return out
            return call

        mgr._dispatch_vad = timed(mgr._dispatch_vad)
        mgr._consume_vad = timed(mgr._consume_vad)
        for i in range(SESSION_COUNT):
            mgr.add_session(f"s{i}")
        fronts = len(serve_enc._graphs.holders("encode"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        packets, t0 = 0, time.perf_counter()
        try:
            for k in range(n_ticks):
                for i, a in enumerate(streams):
                    piece = a[k * chunk:(k + 1) * chunk]
                    if len(piece):
                        check(mgr.push_audio(f"s{i}", piece),
                              f"sessions_flagship: ring of s{i} full")
                vad_ms[0] = 0.0
                packets += len(mgr.tick())
                tick_vad_ms.append(vad_ms[0])
            packets += len(mgr.flush())
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            del serve_enc.encode_batch_submit
        launches = read_launches()
        captured = len(serve_enc._graphs.holders("encode")) - fronts
        check_launches(f"tick loop ({mode_cfg.runtime.max_inflight_encodes} "
                       f"in flight)", launches, len(sizes), captured)
        return {"seconds": seconds, "packets": packets,
                "audio_s_per_s": total_audio_s / seconds,
                "encode_batches": len(sizes), "batch_sizes": sizes,
                "fronts_captured": captured,
                # a submit's return, and the uploads that waited for an
                # earlier encode's copy (one pinned twin an encode in
                # flight: none should)
                "submit_ms_mean": float(np.mean(submit_ms)),
                "submit_ms_max": float(np.max(submit_ms)),
                "upload_waits": upload_waits() - waits0,
                "vad_ms_per_tick_mean": float(np.mean(tick_vad_ms)),
                "vad_ms_per_tick_max": float(np.max(tick_vad_ms)),
                "launches": launches,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "native_rings": all(s.ring.native
                                    for s in mgr.sessions.values()),
                "per_session": {sid: [[p.prosody["pitch"], p.prosody["energy"]]
                                      for p in s.packets_out]
                                for sid, s in mgr.sessions.items()}}

    sync_cfg = cfg.override(**{"runtime.max_inflight_encodes": 0,
                               "runtime.pipelined_vad": False})
    over_cfg = cfg.override(**{"runtime.max_inflight_encodes": 2,
                               "runtime.pipelined_vad": True})
    graph_enc, eager_enc = serve_encs["graph"], serve_encs["eager"]
    graph_enc.warmup()  # the decode steps of one phrase, captured
    run_mode(sync_cfg, graph_enc)  # warm-up
    sync, over = run_mode(sync_cfg, graph_enc), run_mode(over_cfg, graph_enc)
    eager_sync = run_mode(sync_cfg, eager_enc)
    eager_over = run_mode(over_cfg, eager_enc)
    sessions_log.removeHandler(errors)
    check(not errors.records, f"sessions_flagship logged errors: "
          f"{errors.records}")
    runs = (("sync", sync), ("overlapped", over), ("eager sync", eager_sync),
            ("eager overlapped", eager_over))
    for name, r in runs:
        counts = {sid: len(v) for sid, v in r["per_session"].items()}
        check(r["packets"] > 0 and all(n == 2 for n in counts.values()),
              f"sessions_flagship {name}: packets per session {counts}")
        check(r["per_session"] == sync["per_session"],
              f"sessions_flagship: the prosody codes per session and turn of "
              f"the {name} run differ from the synchronous replayed run's")
    # (c) the native ring buffers
    check(HAVE_NATIVE and all(r["native_rings"] for _, r in runs),
          "sessions_flagship: the sessions did not ride the C++ ring buffer")

    def brief(r):
        return {k: v for k, v in r.items() if k != "per_session"}

    emit({"phase": "sessions_flagship", "nvidia_smi": nvidia_smi_line(),
          "asr": "whisper-large-v3 (random, seed 0; phase-4 weights), "
                 "bfloat16, max_decode_tokens 24, bucket 2 s",
          "scaling": scaling, "decode_step_b64": step,
          "decode_step_b64_graph": step_graph, "scaling_graph": scaling_graph,
          "scaling_fronts": scaling_fronts,
          "tick_loop_fronts": check_fronts("sessions tick loop", graph_enc),
          "tick_loop_graph": graph_stats(graph_enc._graphs),
          "tick_loop": {"sessions": SESSION_COUNT, "ticks": n_ticks,
                        "audio_s": total_audio_s,
                        "capture": "conversation(turns=2, speech 0.8 + "
                                   "0.05 (i % 8) s, silence 0.7 s, f0 130 + "
                                   "4 i), one 32 ms chunk a tick",
                        "sync": brief(sync), "overlapped": brief(over),
                        "overlap_speedup": sync["seconds"] / over["seconds"],
                        "eager_sync": brief(eager_sync),
                        "eager_overlapped": brief(eager_over),
                        "eager_overlap_speedup": eager_sync["seconds"]
                        / eager_over["seconds"],
                        "prosody_per_session": over["per_session"]},
          "have_native": HAVE_NATIVE})
    return over["launches"]


def free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def server_run(torch, bundle, phrase, uploads, device, tmp) -> dict:
    """``JanusServer`` with the demo bundle on ``device``: health, the WS
    control plane, a spoken phrase through the live duplex over loopback
    UDP to the virtual speaker, the verify uploads, then the clone."""
    from janus_tpu_torch.api.server import JanusServer
    from janus_tpu_torch.audio.io import StreamAudioService
    from janus_tpu_torch.common.protocol import JanusPacket
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    def synced(fn):
        if device == "cuda":
            return synced_ms(torch, fn)
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)

    port = free_udp_port()
    ref_path = os.path.join(tmp, f"reference_{device}")
    cfg = bundle.config.override(**{
        "server.port": 0, "server.reference_audio_path": ref_path,
        "server.verify_phrase": VERIFY_PHRASE, "link.baud_rate": 48_000,
        "link.target_ip": "127.0.0.1", "link.target_port": port,
        "link.receiver_port": port})
    # 2 s of silence (the WS client connects meanwhile), the phrase, 1 s
    mic = StreamAudioService(np.concatenate([
        np.zeros(2 * SR, np.float32), phrase, np.zeros(SR, np.float32)]),
        realtime=True)
    enc = SemanticEncoder(cfg, asr_params=bundle.asr_params,
                          buckets=(96_000,), device=device)
    enc.warmup()
    syn = Synthesizer(cfg, tts_params=bundle.tts_params,
                      vocoder_params=bundle.vocoder_params,
                      speaker_params=bundle.speaker_params,
                      default_speaker_vec=bundle.default_speaker_vec,
                      reference_audio_path=ref_path, device=device)
    srv = JanusServer(cfg, audio_service=mic, encoder=enc, synthesizer=syn,
                      device=device)
    events, verify, t0 = [], {}, time.perf_counter()
    with serving(srv):
        http_port = srv.http.bound_port
        health = http_json(http_port, "/api/health")
        ws = WsClient(http_port, cfg.server.ws_path)
        try:
            events.append(ws.recv_json())
            ws.send_json({"type": "control", "is_streaming": True})
            deadline = time.perf_counter() + 60
            # the sent and the received packet each give a transcript and
            # a packet summary; then the speaker must hold audio
            while time.perf_counter() < deadline and not (
                    sum(e["type"] == "packet_summary" for e in events) >= 2
                    and mic.written_chunks):
                try:
                    events.append(ws.recv_json(timeout=1.0))
                except TimeoutError:
                    continue
        finally:
            ws.close()
        duplex_s = time.perf_counter() - t0
        # playback done: the speaker's chunk count holds still for 1 s
        n = -1
        while n != len(mic.written_chunks) and time.perf_counter() < deadline:
            n = len(mic.written_chunks)
            time.sleep(1.0)
        for kind, blob in uploads.items():
            body, ctype = multipart("audio_file", f"recording.{kind}", blob,
                                    UPLOAD_TYPES[kind])
            (status, resp), ms = synced(lambda: http_json(
                http_port, "/api/voice/verify", body, ctype))
            verify[kind] = {"http": status, **resp, "ms": ms}
    check(health == (200, {"status": "ok"}), f"server_demo {device}: health "
          f"{health}")
    # the saved clone reference through the speaker encoder, then one
    # cloned synthesis
    check(os.path.exists(ref_path), f"server_demo {device}: no reference "
          f"saved ({verify})")
    _, load_ms = synced(lambda: syn._load_reference_audio(ref_path))
    check(syn._speaker_vec is not None, f"server_demo {device}: the saved "
          f"reference gave no clone voice")
    cloned, clone_synth_ms = synced(lambda: syn.synthesize(
        JanusPacket(text=VERIFY_PHRASE)))
    check(len(cloned) > 0, f"server_demo {device}: empty cloned speech")
    return {"events": events, "verify": verify, "duplex_s": duplex_s,
            "pcm": b"".join(mic.written_chunks), "clone_load_ms": load_ms,
            "clone_synth_ms": clone_synth_ms,
            "cloned_samples": len(cloned) // 2,
            "speaker_vec": syn._speaker_vec.float().cpu()}


def server_demo(torch, kernels) -> dict:
    """``JanusServer`` with the demo bundle, on the card and on the CPU.
    Returns the card run's kernel launches."""
    from janus_tpu_torch.audio.ogg import mux_ogg_opus
    from janus_tpu_torch.audio.opus import OpusEncoder, opus_available
    from janus_tpu_torch.audio.synthetic import render_text
    from janus_tpu_torch.audio.wav import write_wav
    from janus_tpu_torch.audio.webm import mux_webm_opus
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.models.zoo import load_demo

    bundle = load_demo(base=JanusConfig())
    phrase = render_text(VERIFY_PHRASE, SR, seed=1)
    errors = ErrorRecords()
    loggers = [logging.getLogger(f"janus_tpu_torch.{name}") for name in (
        "api.http", "api.endpoints", "api.socket_manager", "runtime.engine",
        "runtime.synthesizer", "runtime.streaming_tts")]
    for lg in loggers:
        lg.addHandler(errors)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "upload.wav")
        write_wav(wav, phrase, SR)
        with open(wav, "rb") as f:
            uploads = {"wav": f.read()}
        have_opus = opus_available()
        if have_opus:
            enc = OpusEncoder()
            packets, pre = enc.encode(phrase), enc.lookahead
            enc.close()
            uploads["webm"] = mux_webm_opus(packets, pre)
            uploads["ogg"] = mux_ogg_opus(packets, pre)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        card = server_run(torch, bundle, phrase, uploads, "cuda", tmp)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        cpu = server_run(torch, bundle, phrase, uploads, "cpu", tmp)
    for lg in loggers:
        lg.removeHandler(errors)
    check(not errors.records, f"server_demo logged errors: {errors.records}")

    def summary(r):
        return ([e.get("text") for e in r["events"]
                 if e["type"] == "transcript"],
                [e["bytes"] for e in r["events"]
                 if e["type"] == "packet_summary"],
                {k: v["status"] for k, v in r["verify"].items()})

    check(len(card["events"]) > 1
          and card["events"][0]["type"] == "control_state"
          and card["events"][1]["type"] == "control_state"
          and card["events"][1]["is_streaming"] is True,
          f"server_demo: control plane events {card['events'][:2]}")
    check(card["verify"]["wav"]["status"] == "verified",
          f"server_demo: the WAV upload was not verified: {card['verify']}")
    check(summary(card) == summary(cpu), f"server_demo: the card gives "
          f"{summary(card)}, the CPU {summary(cpu)}")
    transcripts, packet_bytes, statuses = summary(card)
    check(len(transcripts) == 2 and len(packet_bytes) == 2,
          f"server_demo: events {card['events']}")
    bar = 1e-2
    check(len(card["pcm"]) == len(cpu["pcm"]) > 0, f"server_demo: "
          f"{len(card['pcm'])} bytes played on the card, {len(cpu['pcm'])} "
          f"on the CPU")
    err = float(np.abs(pcm_float(card["pcm"]) - pcm_float(cpu["pcm"])).max())
    check(err <= bar, f"server_demo: PCM card vs CPU {err} (bar {bar})")
    vec_err = float((card["speaker_vec"] - cpu["speaker_vec"]).abs().max())
    for name in ("mel_fused", "flash_attn", "yin_block_sums"):
        check(launches[name] > 0, f"server_demo never launched {name}: "
              f"{launches}")

    def brief(r):
        return {"duplex_s": r["duplex_s"], "verify": r["verify"],
                "clone_load_ms": r["clone_load_ms"],
                "clone_synth_ms": r["clone_synth_ms"],
                "cloned_samples": r["cloned_samples"]}

    line = {"phase": "server_demo", "nvidia_smi": nvidia_smi_line(),
            "opus_available": have_opus, "uploads": sorted(uploads),
            "spoken": VERIFY_PHRASE, "events": card["events"],
            "transcripts": transcripts, "packet_bytes": packet_bytes,
            "verify_status": statuses,
            "pcm_card_vs_cpu_max_abs": err, "bar": bar,
            "samples": len(card["pcm"]) // 2,
            "clone_vec_card_vs_cpu_max_abs": vec_err,
            "clone_load_ms": card["clone_load_ms"],
            "card": brief(card), "cpu": brief(cpu), "launches": launches}
    if not have_opus:
        line["note"] = ("libopus is missing on this machine: WAV upload "
                        "only; the WebM/Ogg parity is held by the CPU tests")
    emit(line)
    return launches


def settle_loops() -> None:
    """Read back the trips of the loop runs that the bare model functions
    made on the module's own graphs (the tools call them), so that their
    bodies' launches are counted in the phase that ran them."""
    from janus_tpu_torch.runtime.step_graph import default_graphs

    for kind in ("asr", "tts"):
        default_graphs(kind).settle()


def reset_launches(kernels) -> None:
    settle_loops()
    for k in kernels:
        k.launches = 0


def read_launches(kernels) -> dict:
    settle_loops()
    return {k.name: k.launches for k in kernels}


def _device_ms(event) -> float:
    """Device time of a profiler event and its children, ms (the field's
    name moved between PyTorch releases)."""
    us = getattr(event, "device_time_total", None)
    if us is None:
        us = event.cuda_time_total
    return us / 1e3


def trace_train_step(torch, step, wall_ms: float) -> dict:
    """One training step traced under ``torch.profiler``: kernels, the
    host's launch calls, the device's busy time and idle share against the
    untraced step's wall time, the top device ops, and K2's share: the
    forward kernel's device time and the device time under
    ``_FlashAttention.backward`` (the plain attention's recompute and
    gradient). Nulls where the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not device:
        return {"device_events": 0, "traced_wall_ms": traced_ms,
                "device_busy_ms": None, "device_idle_share": None}
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    fwd = sum(e.time_range.elapsed_us() for e in device
              if "flash_fwd" in e.name) / 1e3
    bwd = sum(_device_ms(e) for e in events
              if e.device_type == DeviceType.CPU and e.name.startswith(
                  "autograd::engine::evaluate_function: "
                  "_FlashAttentionBackward"))
    ops = {}
    for e in device:
        ops[e.name] = ops.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
    return {"device_events": len(device),
            "host_kernel_launches": sum(
                1 for e in events if e.device_type == DeviceType.CPU
                and e.name.startswith("cudaLaunchKernel")),
            "traced_wall_ms": traced_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "k2_forward_ms": fwd, "k2_backward_ms": bwd,
            "k2_forward_share": fwd / busy, "k2_backward_share": bwd / busy,
            "top_ops_ms": [{"name": n[:120], "ms": ms} for n, ms in top]}


def train_demo(torch, kernels) -> dict:
    """The demo ASR, TTS and vocoder: 3 steps each on one fixed batch from
    the same seeded weights on the card and on the CPU (losses within
    1e-3 relative; the vocoder's gradient against float64 and its losses
    at lr 1e-3 are reported), then ``train_demo_asr(steps=3)`` through its entry
    point on the card and its npz back through ``load_npz_params``.
    Returns the card runs' kernel launches."""
    from janus_tpu_torch.common.device import resolve_device
    from janus_tpu_torch.models.asr import prepare_mel
    from janus_tpu_torch.models.params import (flatten_with_paths, init_asr,
                                               load_npz_params, map_tree,
                                               save_npz, tree_to)
    from janus_tpu_torch.models.tokenizer import ByteTokenizer
    from janus_tpu_torch.models.tts import EMOTIONS, emotion_id, init_tts
    from janus_tpu_torch.models.vocoder import init_vocoder
    from janus_tpu_torch.ops.mel import log_mel_spectrogram
    from janus_tpu_torch.train import demo
    from janus_tpu_torch.train.losses import asr_loss, tts_loss, vocoder_loss
    from janus_tpu_torch.train.synthetic_task import (mel_targets_for,
                                                      render_text,
                                                      sample_batch,
                                                      sample_text)
    from janus_tpu_torch.train.trainer import Trainer

    tok = ByteTokenizer()
    rng = np.random.default_rng(0)
    acfg = demo.demo_asr_config()
    tcfg, vcfg = demo.demo_tts_config(), demo.demo_vocoder_config()
    n_frames = 2 * acfg.max_source_positions

    def asr_fn(p, audio, tokens, mask):
        return asr_loss(p, acfg, prepare_mel(audio, acfg,
                                             pad_to_frames=n_frames),
                        tokens, mask)

    audio, tokens, mask, _ = sample_batch(
        rng, TRAIN_DEMO_BATCH, tok, max_tokens=acfg.max_target_positions,
        **demo.STANDARD_CORPUS)

    texts = [sample_text(rng) for _ in range(TRAIN_DEMO_BATCH)]
    emos = [EMOTIONS[i % len(EMOTIONS)] for i in range(TRAIN_DEMO_BATCH)]
    mels, gmask = mel_targets_for(texts, tcfg.n_mels, tcfg.reduction,
                                  tcfg.max_mel_frames // tcfg.reduction,
                                  emotions=emos)
    ids = np.full((TRAIN_DEMO_BATCH, 16), tok.pad, np.int64)
    for i, t in enumerate(texts):
        ids[i, :len(tok.encode(t)[:16])] = tok.encode(t)[:16]
    emo = np.array([emotion_id(e) for e in emos], np.int64)
    spk = np.stack(demo.demo_speaker_vectors(tcfg)[1])[
        np.arange(TRAIN_DEMO_BATCH) % 4].astype(np.float32)
    noisy = (mels + 0.1 * rng.standard_normal(mels.shape)).astype(np.float32)

    def tts_fn(p, *b):
        return tts_loss(p, tcfg, *b[:4], speaker=b[4], text_vocab=tok.vocab_size,
                        mel_inputs=b[5])

    t_samples = 96 * vcfg.hop_length
    wavs = np.zeros((4, t_samples), np.float32)
    for i in range(4):
        w = render_text(sample_text(rng), 16_000, seed=i, speaker=i,
                        hop_quantize=vcfg.hop_length)[:t_samples]
        wavs[i, :len(w)] = w

    # the vocoder's batch is (mel, wav), as train_demo_vocoder hands it
    # over, the mel made once on the CPU: both devices start from the same
    # input (the card's own log-mel differs from it by
    # ``vocoder_mel_card_vs_cpu_max_abs``)
    with torch.no_grad():
        wav_t = torch.from_numpy(wavs)
        voc_mel = log_mel_spectrogram(wav_t, 16_000, 400, vcfg.hop_length,
                                      80)[:, :96, :]
        mel_gap = float((log_mel_spectrogram(
            wav_t.to(resolve_device("cuda")), 16_000, 400, vcfg.hop_length,
            80)[:, :96, :].cpu() - voc_mel).abs().max())

    def voc_fn(p, mel, wav):
        return vocoder_loss(p, vcfg, mel, wav)

    cpu_gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    models = {
        "asr": (init_asr(cpu_gen(), acfg), asr_fn, (audio, tokens, mask)),
        "tts": (init_tts(cpu_gen(), tcfg, text_vocab=tok.vocab_size),
                tts_fn, (ids, emo, mels, gmask, spk, noisy)),
        "vocoder": (init_vocoder(cpu_gen(), vcfg, n_mels=80), voc_fn,
                    (voc_mel.numpy(), wavs)),
    }
    def trajectory(params, fn, batch, dev, lr):
        trainer = Trainer(fn, learning_rate=lr)
        state = trainer.create_state(tree_to(params, dev))
        hist = []
        for _ in range(TRAIN_DEMO_STEPS):
            state, m = trainer.train_step(state, *batch)
            hist.append(float(m["loss"]))
        return hist

    card, cpu = resolve_device("cuda"), torch.device("cpu")
    reset_launches(kernels)
    losses = {}
    for name, (params, fn, batch) in models.items():
        runs = {where: trajectory(params, fn, batch, dev, TRAIN_DEMO_LR)
                for where, dev in (("card", card), ("cpu", cpu))}
        rel = [abs(a - b) / abs(b) for a, b in zip(runs["card"], runs["cpu"])]
        losses[name] = {**runs, "rel": rel}
        check(all(np.isfinite(runs["card"])) and max(rel) <= 1e-3,
              f"train_demo {name}: card vs CPU losses {losses[name]}")

    # The vocoder's loss is ill-conditioned in float32: its log-magnitude
    # term weighs each STFT bin by 1/(|X| + 1e-5), so its gradient lies
    # up to ~1e-3 (of a leaf's largest magnitude) from a float64
    # evaluation on either device, and Adam's first steps move every
    # weight by ~lr whatever its gradient's size: at lr 1e-3 two float32
    # runs part faster than at TRAIN_DEMO_LR. Both are readings, not
    # checks: each device's gradient against a float64 CPU evaluation,
    # and the losses at lr 1e-3 (``vocoder_at_1e-3``).
    voc_params, voc_batch = models["vocoder"][0], models["vocoder"][2]

    def voc_grads(dev, dtype):
        p = map_tree(lambda t: t.to(dtype), tree_to(voc_params, dev))
        pairs = list(flatten_with_paths(p))
        leaves = [v.requires_grad_() for _, v in pairs]
        loss, _ = voc_fn(p, *(torch.from_numpy(b).to(dev).to(dtype)
                              for b in voc_batch))
        return {k: g.detach().double().cpu() for (k, _), g in zip(
            pairs, torch.autograd.grad(loss, leaves))}

    def worst(got, ref):
        return max(float((got[k] - ref[k]).abs().max()
                         / ref[k].abs().max().clamp_min(1e-30)) for k in ref)

    ref64 = voc_grads(cpu, torch.float64)
    grad_err = {"card": worst(voc_grads(card, torch.float32), ref64),
                "cpu": worst(voc_grads(cpu, torch.float32), ref64)}
    runs = {where: trajectory(voc_params, voc_fn, voc_batch, dev, 1e-3)
            for where, dev in (("card", card), ("cpu", cpu))}
    losses["vocoder_at_1e-3"] = {**runs, "rel": [
        abs(a - b) / abs(b) for a, b in zip(runs["card"], runs["cpu"])]}

    t0 = time.perf_counter()
    params, _, _, hist = demo.train_demo_asr(steps=TRAIN_DEMO_STEPS,
                                             pool_n=64, log_every=0,
                                             device="cuda")
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    launches = read_launches(kernels)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "asr.npz")
        save_npz(path, params)
        back = dict(flatten_with_paths(load_npz_params(path)))
    round_trip = all(torch.equal(back[k], v.detach().cpu().half().float())
                     for k, v in flatten_with_paths(params))
    check(len(hist) == TRAIN_DEMO_STEPS and all(np.isfinite(hist)),
          f"train_demo_asr history {hist}")
    check(round_trip and len(back) == len(list(flatten_with_paths(params))),
          "train_demo: save_npz -> load_npz_params did not round-trip")
    check(launches["mel_fused"] >= TRAIN_DEMO_STEPS
          and launches["flash_attn"] >= TRAIN_DEMO_STEPS
          * acfg.encoder_layers, f"train_demo launches {launches}")
    emit({"phase": "train_demo", "nvidia_smi": nvidia_smi_line(),
          "steps": TRAIN_DEMO_STEPS, "batch": TRAIN_DEMO_BATCH,
          "learning_rate": TRAIN_DEMO_LR, "losses": losses,
          "bar_rel": 1e-3, "vocoder_grad_vs_fp64_worst_leaf": grad_err,
          "vocoder_mel_card_vs_cpu_max_abs": mel_gap,
          "train_demo_asr": {"history": hist, "seconds": entry_s,
                             "npz_round_trip": round_trip},
          "launches": launches})
    return launches


def flagship_training(torch, mesh=None, rules=None):
    """Whisper large-v3 in float32 (``init_asr`` seed 0 on the card), a
    ``Trainer`` over it (on ``mesh`` with ``rules`` when given), its state,
    and one batch of ``sample_batch`` utterances (seed 0) in the entry
    point's 30 s window. Returns (cfg, trainer, state, batch, texts,
    params, init_s)."""
    from janus_tpu_torch.common.config import ASRConfig
    from janus_tpu_torch.common.device import resolve_device
    from janus_tpu_torch.models.asr import prepare_mel
    from janus_tpu_torch.models.params import flatten_with_paths, init_asr
    from janus_tpu_torch.models.tokenizer import ByteTokenizer
    from janus_tpu_torch.train.losses import asr_loss
    from janus_tpu_torch.train.synthetic_task import sample_batch
    from janus_tpu_torch.train.trainer import Trainer

    dev = resolve_device("cuda")
    cfg = dataclasses.replace(ASRConfig.large_v3(), dtype="float32")
    n_frames = 2 * cfg.max_source_positions
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_asr(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(t.numel() for _, t in flatten_with_paths(params))

    def loss_fn(p, audio, tokens, mask):
        return asr_loss(p, cfg, prepare_mel(audio, cfg,
                                            pad_to_frames=n_frames),
                        tokens, mask)

    trainer = Trainer(loss_fn, learning_rate=TRAIN_FLAGSHIP_LR, mesh=mesh,
                      rules=rules)
    state = trainer.create_state(params)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    audio, tokens, mask, texts = sample_batch(
        np.random.default_rng(0), TRAIN_FLAGSHIP_BATCH, ByteTokenizer(),
        max_tokens=cfg.max_target_positions)
    batch = tuple(torch.from_numpy(a).to(dev) for a in (audio, tokens, mask))
    return cfg, trainer, state, batch, texts, n_params, init_s


def train_flagship(torch, kernels):
    """Whisper large-v3 at full width in float32, weights from
    ``init_asr`` on the card: ``TRAIN_FLAGSHIP_STEPS`` steps of
    ``Trainer.train_step`` on one batch of ``sample_batch`` utterances in
    the entry point's 30 s window, then one step traced. Returns the
    launches of the untraced steps and the losses."""
    cfg, trainer, state, batch, texts, n_params, init_s = flagship_training(
        torch)
    n_frames = 2 * cfg.max_source_positions

    reset_launches(kernels)
    losses, norms, step_ms = [], [], []
    for _ in range(TRAIN_FLAGSHIP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, *batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = read_launches(kernels)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    wall_ms = float(np.median(step_ms[1:]))
    holder = [state]

    def step():
        holder[0], _ = trainer.train_step(holder[0], *batch)

    trace = trace_train_step(torch, step, wall_ms)
    del state, holder, trainer
    torch.cuda.empty_cache()
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"train_flagship: losses {losses}, grad norms {norms}")
    check(losses[-1] < losses[0], f"train_flagship: the loss on one batch "
          f"did not fall over {TRAIN_FLAGSHIP_STEPS} steps: {losses}")
    check(launches["mel_fused"] == TRAIN_FLAGSHIP_STEPS
          and launches["flash_attn"] == TRAIN_FLAGSHIP_STEPS
          * cfg.encoder_layers, f"train_flagship launches {launches}")
    emit({"phase": "train_flagship", "nvidia_smi": nvidia_smi_line(),
          "model": "whisper-large-v3 (random, init_asr seed 0), float32",
          "params": n_params, "batch": TRAIN_FLAGSHIP_BATCH,
          "mel_frames": n_frames, "tokens": cfg.max_target_positions,
          "texts": texts, "learning_rate": TRAIN_FLAGSHIP_LR,
          "init_s": init_s, "losses": losses, "grad_norms": norms,
          "step_ms": step_ms, "step_ms_median_2_on": wall_ms,
          "peak_mem_gib": peak_gib, "launches": launches, "trace": trace})
    return launches, losses


def zoo_gates(torch, kernels) -> dict:
    """The committed checkpoints' quality gates on the card, at the floors
    of ``tests/test_zoo_checkpoints.py``. Returns the launches."""
    from janus_tpu_torch.common.config import JanusConfig
    from janus_tpu_torch.eval.roundtrip import (evaluate_emotion_roundtrip,
                                                evaluate_hard_roundtrip,
                                                evaluate_voice_clone_identity)
    from janus_tpu_torch.models.tokenizer import ByteTokenizer
    from janus_tpu_torch.models.zoo import load_demo, load_demo_hard
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.synthesizer import Synthesizer
    from janus_tpu_torch.train import demo
    from janus_tpu_torch.train.retrain_demo import quick_copy_snr

    tok = ByteTokenizer()
    bundle = load_demo(base=JanusConfig())
    cfg = bundle.config
    gates, times = {}, {}
    reset_launches(kernels)

    def gate(name, fn, ok):
        t0 = time.perf_counter()
        value = fn()
        times[name] = time.perf_counter() - t0
        gates[name] = {"value": value, "pass": bool(ok(value))}

    gate("neutral_wer", lambda: demo.evaluate_asr(
        bundle.asr_params, demo.demo_asr_config(), tok, n_utterances=16,
        seed=123)[0], lambda v: v == 0.0)
    gate("emotion_rendering_wer", lambda: demo.evaluate_asr(
        bundle.asr_params, demo.demo_asr_config(), tok, n_utterances=24,
        seed=77, corpus=demo.STANDARD_CORPUS)[0], lambda v: v <= 0.08)
    gate("vocoder_copy_snr_db", lambda: quick_copy_snr(
        bundle.vocoder_params, demo.demo_vocoder_config()),
        lambda v: v >= 24.0)
    encoder = SemanticEncoder(cfg, asr_params=bundle.asr_params,
                              buckets=(48_000 * 2,), device="cuda")
    synth = Synthesizer(cfg, tts_params=bundle.tts_params,
                        vocoder_params=bundle.vocoder_params,
                        default_speaker_vec=demo.demo_speaker_vectors(
                            cfg.tts)[1][0], device="cuda")
    gate("emotion_roundtrip", lambda: evaluate_emotion_roundtrip(
        synth, encoder), lambda v: v["emotion_roundtrip_match"] == 1.0)
    gate("voice_clone_identity", lambda: evaluate_voice_clone_identity(
        bundle.tts_params, cfg.tts, bundle.vocoder_params, cfg.vocoder),
        lambda v: v["voice_clone_identity_frac"] == 1.0)
    hard = load_demo_hard(base=JanusConfig())

    def hard_wers():
        out = {}
        for label, snr in (("clean", None), ("snr10", (10.0, 10.0)),
                           ("snr5", (5.0, 5.0)), ("snr0", (0.0, 0.0))):
            corpus = dict(demo.HARD_CORPUS, clean_prob=0.0)
            if snr is None:
                corpus.pop("snr_db_range")
            else:
                corpus["snr_db_range"] = snr
            out[label] = demo.evaluate_asr(
                hard.asr_params, demo.hard_asr_config(), tok,
                n_utterances=24, seed=321, corpus=corpus,
                max_seconds=3.84)[0]
        return out

    floors = {"clean": 0.05, "snr10": 0.15, "snr5": 0.05, "snr0": 0.15}
    gate("hard_wer", hard_wers,
         lambda v: all(v[k] <= floors[k] for k in floors))
    gate("hard_roundtrip", lambda: evaluate_hard_roundtrip(
        hard, n_utterances=12, seed=555),
        lambda v: v["hard_roundtrip_wer"] <= 0.10)
    launches = read_launches(kernels)
    emit({"phase": "zoo_gates", "nvidia_smi": nvidia_smi_line(),
          "gates": gates, "seconds": times, "hard_floors": floors,
          "launches": launches})
    check(all(g["pass"] for g in gates.values()),
          f"zoo_gates: a gate missed its floor: {gates}")
    for name in ("mel_fused", "flash_attn", "yin_block_sums"):
        check(launches[name] > 0, f"zoo_gates never launched {name}")
    return launches


def packet_bytes(result: dict) -> bytes:
    """The wire bytes of an ``encode_batch`` result at a fixed timestamp."""
    from janus_tpu_torch.common.protocol import JanusPacket

    return JanusPacket(text=result["text"], prosody=result["prosody"],
                       timestamp=DEMO_TIMESTAMP).serialize()


def world_of_one():
    """A one-rank NCCL process group on the card (a ``FileStore`` in a
    fresh directory); the caller destroys it."""
    import torch.distributed as dist

    store = os.path.join(tempfile.mkdtemp(prefix="janus_world1_"), "store")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)


def parallel_flagship(torch, kernels, train_losses) -> dict:
    """The mesh layouts at full width in a world of one card (a one-rank
    NCCL group, the ``(1, 1, 1)`` mesh: no collective is issued):
    ``SemanticEncoder(mesh=...)`` on large-v3 bf16 (phase 4's weights from
    seed 0) against ``mesh=None`` (packets byte-equal), the flagship TTS
    through ``Synthesizer(mesh=...)`` over ``PARALLEL_GROUPS`` groups
    against ``mesh=None`` (PCM equal), ``PARALLEL_TRAIN_STEPS`` steps of
    the mesh ``Trainer`` on large-v3 fp32 against ``train_flagship``'s
    losses (1e-6 relative), and ``analyze_encode_scaling`` at N = 1 on the
    card. Returns the launches of the mesh encode and train steps."""
    import torch.distributed as dist

    from janus_tpu_torch.audio.synthetic import voiced_phrase
    from janus_tpu_torch.common.config import (ASRConfig, JanusConfig,
                                               MeshConfig, TTSConfig)
    from janus_tpu_torch.common.device import resolve_device
    from janus_tpu_torch.common.protocol import JanusPacket
    from janus_tpu_torch.eval.scaling import analyze_encode_scaling
    from janus_tpu_torch.models import tts as tts_mod
    from janus_tpu_torch.models import vocoder as voc_mod
    from janus_tpu_torch.models.params import cast_floating
    from janus_tpu_torch.models.tokenizer import ByteTokenizer
    from janus_tpu_torch.parallel.mesh import build_mesh
    from janus_tpu_torch.parallel.sharding import ASR_PARTITION_RULES
    from janus_tpu_torch.runtime.codec import SemanticEncoder
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    t_phase = time.perf_counter()
    dev = resolve_device("cuda")
    world_of_one()
    out = {"phase": "parallel_flagship", "world": dist.get_world_size(),
           "backend": dist.get_backend()}
    try:
        mesh = build_mesh(MeshConfig())
        out["mesh"] = str(mesh)

        # the encoder: mesh against mesh=None, timed in turns
        fcfg = dataclasses.replace(JanusConfig(), asr=ASRConfig.large_v3())
        fcfg = fcfg.override(**{"asr.max_decode_tokens": 24})
        bucket = int(SR * FLAGSHIP_SECONDS)
        phrases = [voiced_phrase(f0=140.0 + 15 * i, seconds=FLAGSHIP_SECONDS,
                                 amp=0.12, seed=i)
                   for i in range(FLAGSHIP_BATCH)]
        encoders = {"none": SemanticEncoder(fcfg, buckets=(bucket,),
                                            device="cuda"),
                    "mesh": SemanticEncoder(fcfg, buckets=(bucket,),
                                            device="cuda", mesh=mesh)}
        results, encode_ms = {}, {}
        for name, enc in encoders.items():
            enc.encode_batch(phrases)  # warm-up
        for name in PARALLEL_ORDER:
            if name == "mesh":
                reset_launches(kernels)
            results[name], ms = synced_ms(
                torch, lambda: encoders[name].encode_batch(phrases))
            encode_ms.setdefault(name, []).append(ms)
            if name == "mesh":
                launches = read_launches(kernels)
        del encoders
        torch.cuda.empty_cache()
        check([packet_bytes(r) for r in results["mesh"]]
              == [packet_bytes(r) for r in results["none"]],
              f"parallel_flagship: mesh packets differ from mesh=None: "
              f"{results['mesh']} vs {results['none']}")
        check(launches["mel_fused"] >= 1 and launches["yin_block_sums"] >= 1
              and launches["flash_attn"] == fcfg.asr.encoder_layers,
              f"parallel_flagship encode launches {launches}")
        out["encode"] = {"batch": FLAGSHIP_BATCH, "seconds": FLAGSHIP_SECONDS,
                         "ms": encode_ms, "packets_byte_equal": True,
                         "launches": dict(launches),
                         "texts": [r["text"] for r in results["mesh"]][:2]}

        # the synthesizer: the flagship TTS over a cut budget
        tok = ByteTokenizer()
        tcfg = dataclasses.replace(
            TTSConfig.flagship(),
            max_mel_frames=PARALLEL_GROUPS * TTSConfig.flagship().reduction)
        scfg = dataclasses.replace(JanusConfig(), tts=tcfg)
        tts_params = cast_floating(tts_mod.init_tts(
            torch.Generator(device=dev).manual_seed(0), tcfg,
            text_vocab=tok.vocab_size), torch.bfloat16)
        # a stop logit pinned low: the whole budget is generated
        tts_params["stop_head"]["b"].fill_(-5.0)
        voc_params = cast_floating(voc_mod.init_vocoder(
            torch.Generator(device=dev).manual_seed(1), scfg.vocoder,
            n_mels=tcfg.n_mels), torch.bfloat16)
        synths = {name: Synthesizer(scfg, tts_params=tts_params,
                                    vocoder_params=voc_params, device="cuda",
                                    mesh=mesh if name == "mesh" else None)
                  for name in ("none", "mesh")}
        pkt = JanusPacket(text="the mesh layout at full width",
                          prosody={"pitch": "High", "energy": "Loud"},
                          timestamp=DEMO_TIMESTAMP)
        pcm, synth_ms = {}, {}
        for name in ("none", "mesh"):
            synths[name].synthesize(pkt)  # warm-up
        for name in PARALLEL_ORDER:
            pcm[name], ms = synced_ms(torch,
                                      lambda: synths[name].synthesize(pkt))
            synth_ms.setdefault(name, []).append(ms)
        del synths, tts_params, voc_params
        torch.cuda.empty_cache()
        check(len(pcm["mesh"]) > 0 and pcm["mesh"] == pcm["none"],
              f"parallel_flagship: mesh PCM ({len(pcm['mesh'])} bytes) "
              f"differs from mesh=None ({len(pcm['none'])} bytes)")
        out["synthesize"] = {"groups": PARALLEL_GROUPS, "ms": synth_ms,
                             "pcm_bytes": len(pcm["mesh"]),
                             "pcm_equal": True}

        # the trainer: the mesh steps against train_flagship's losses
        cfg, trainer, state, batch, _, n_params, init_s = flagship_training(
            torch, mesh=mesh, rules=ASR_PARTITION_RULES)
        reset_launches(kernels)
        losses, step_ms = [], []
        for _ in range(PARALLEL_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, *batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
        train_launches = read_launches(kernels)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        del state, trainer
        torch.cuda.empty_cache()
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, train_losses)]
        check(max(rel) <= 1e-6, f"parallel_flagship: mesh losses {losses} vs "
              f"train_flagship's {train_losses[:len(losses)]}")
        out["train"] = {"params": n_params, "batch": TRAIN_FLAGSHIP_BATCH,
                        "losses": losses,
                        "train_flagship_losses": train_losses[:len(losses)],
                        "max_rel_diff": max(rel), "step_ms": step_ms,
                        "init_s": init_s, "peak_mem_gib": peak_gib,
                        "launches": dict(train_launches)}
        check(train_launches["flash_attn"]
              == PARALLEL_TRAIN_STEPS * cfg.encoder_layers,
              f"parallel_flagship train launches {train_launches}")
        for k, n in train_launches.items():
            launches[k] += n
    finally:
        dist.destroy_process_group()

    # the scaling rows at N = 1 on the card (a rank process of its own)
    rows = analyze_encode_scaling(device_counts=(1,), device="cuda")
    # the kernels' least work is in the row: the encoder's attention
    # (flash_attn) and the frontend (mel_fused, yin_block_sums)
    check(len(rows) == 1 and rows[0]["collective_bytes"] == {}
          and rows[0]["per_device_flops"] > 0
          and all(rows[0]["kernel_work"].get(k, {}).get("flops", 0) > 0
                  for k in ("mel_fused", "flash_attn", "yin_block_sums")),
          f"parallel_flagship scaling rows {rows}")
    out["scaling"] = rows
    out["seconds"] = time.perf_counter() - t_phase
    out["nvidia_smi"] = nvidia_smi_line()
    out["launches"] = launches
    emit(out)
    return launches


def parallel_ranks_body() -> dict:
    """One of two ranks on one card (gloo, CUDA tensors), at demo width:
    Ulysses attention at seq 2, the tensor-parallel ASR encoder at model 2
    on the demo weights, and ``SemanticEncoder`` at data 2 on the demo
    bundle, each against its unsharded run on the card. Ring attention
    and the pipeline are left out: gloo refuses point-to-point sends of
    CUDA tensors (``PERF.md`` §7)."""
    import torch
    import torch.distributed as dist

    from janus_tpu_torch.audio.synthetic import render_text
    from janus_tpu_torch.common.config import ASRConfig, JanusConfig, MeshConfig
    from janus_tpu_torch.common.device import resolve_device
    from janus_tpu_torch.models import asr as asr_mod
    from janus_tpu_torch.models.params import load_npz_params, tree_to
    from janus_tpu_torch.ops import cuda_build
    from janus_tpu_torch.ops.attention import attend
    from janus_tpu_torch.parallel import collectives as C
    from janus_tpu_torch.parallel.mesh import build_mesh
    from janus_tpu_torch.parallel.sharding import (ASR_PARTITION_RULES,
                                                   shard_params)
    from janus_tpu_torch.parallel.ulysses import ulysses_attention
    from janus_tpu_torch.runtime.codec import SemanticEncoder

    dev = resolve_device("cuda")
    kernels = list(cuda_build.KERNELS.values())
    rank = dist.get_rank()
    cfg = dataclasses.replace(JanusConfig(), asr=ASRConfig.demo())
    acfg = cfg.asr
    params = load_npz_params(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "checkpoints",
        "demo_asr.npz"))
    gen = torch.Generator(device=dev).manual_seed(99)
    out = {"rank": rank, "cases": {}}

    # Ulysses at seq 2: the demo encoder's attention shape
    mesh = build_mesh(MeshConfig(data=1, model=1, seq=2))
    head_dim = acfg.d_model // acfg.num_heads
    q, k, v = (torch.randn((2, acfg.num_heads, 100, head_dim),
                           generator=gen, device=dev) for _ in range(3))
    ref = attend(q, k, v)
    i = C.axis_index(mesh, "seq")
    with C.counting() as coll:
        got = C.all_gather(ulysses_attention(
            *(a[:, :, 50 * i:50 * (i + 1)] for a in (q, k, v)), mesh),
            mesh, "seq", dim=2)
    torch.cuda.synchronize()
    out["cases"]["ulysses_seq2"] = {
        "max_abs_err": float((got - ref).abs().max()), "atol": 2e-5,
        "collective_bytes": dict(coll)}

    # the tensor-parallel encoder at model 2 on the demo weights
    mesh = build_mesh(MeshConfig(data=1, model=2, seq=1))
    mel = torch.randn((2, 200, acfg.n_mels), generator=gen, device=dev)
    dense = tree_to(params, dev)
    ref = asr_mod.encode_audio(dense, acfg, mel)
    local = tree_to(shard_params(params, mesh, ASR_PARTITION_RULES), dev)
    reset_launches(kernels)
    with C.use_mesh(mesh), C.counting() as coll:
        got = asr_mod.encode_audio(local, acfg, mel)
    torch.cuda.synchronize()
    out["cases"]["tp_encoder_model2"] = {
        "max_abs_err": float((got - ref).abs().max()), "atol": 2e-4,
        "collective_bytes": dict(coll), "launches": read_launches(kernels)}

    # SemanticEncoder at data 2 on the demo bundle: packets byte-equal
    phrases = [render_text(t, SR, seed=s) for s, t in enumerate(DEMO_TEXTS)]
    plain = SemanticEncoder(cfg, params, buckets=(96_000,), device="cuda")
    sharded = SemanticEncoder(cfg, params, buckets=(96_000,), device="cuda",
                              mesh=build_mesh(MeshConfig(data=2)))
    reset_launches(kernels)
    with C.counting() as coll:
        res = sharded.encode_batch(phrases)
    launches = read_launches(kernels)
    ref = plain.encode_batch(phrases)

    out["cases"]["encoder_data2"] = {
        "packets_byte_equal": ([packet_bytes(r) for r in res]
                               == [packet_bytes(r) for r in ref]),
        "texts": [r["text"] for r in res], "collective_bytes": dict(coll),
        "launches": launches}
    return out


def parallel_ranks(torch) -> dict:
    """Two ranks on the one card through ``run_ranks``, which puts more
    ranks than cards on gloo (carrying CUDA tensors here):
    :func:`parallel_ranks_body` on each. Returns the kernels' launches
    summed over the ranks."""
    import chip_smoke  # the rank function by its module's name

    from janus_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(chip_smoke.parallel_ranks_body, 2, device="cuda",
                      timeout=600)
    launches = {}
    for r in ranks:
        for case, row in r["cases"].items():
            if "max_abs_err" in row:
                check(row["max_abs_err"] <= row["atol"],
                      f"parallel_ranks {case} rank {r['rank']}: {row}")
            if case == "encoder_data2":
                check(row["packets_byte_equal"],
                      f"parallel_ranks encoder_data2 rank {r['rank']}: {row}")
            for k, n in row.get("launches", {}).items():
                launches[k] = launches.get(k, 0) + n
    for r in ranks:
        enc = r["cases"]["encoder_data2"]["launches"]
        check(enc["mel_fused"] >= 1 and enc["yin_block_sums"] >= 1
              and enc["flash_attn"] >= 1,
              f"parallel_ranks: rank {r['rank']}'s encode launches {enc}")
    emit({"phase": "parallel_ranks", "ranks": ranks, "backend": "gloo",
          "left_out": {"ring_attention_seq2": GLOO_P2P_REFUSAL,
                       "pipeline_stage2": GLOO_P2P_REFUSAL},
          "seconds": time.perf_counter() - t0, "launches": launches,
          "nvidia_smi": nvidia_smi_line()})
    return launches


def profile_tools(torch, kernels, params, fcfg) -> dict:
    """``tools.encode_profile`` and ``tools.flagship_check`` (``--decode
    --int8``) on the large-v3 weights already built. Returns each one's
    launches."""
    from janus_tpu_torch.tools.encode_profile import profile_encode
    from janus_tpu_torch.tools.flagship_check import check_flagship

    by_phase = {}
    reset_launches(kernels)
    line = profile_encode(params, fcfg, batch=FLAGSHIP_BATCH,
                          seconds=FLAGSHIP_SECONDS, device="cuda")
    by_phase["encode_profile"] = read_launches(kernels)
    emit({"phase": "encode_profile", "nvidia_smi": nvidia_smi_line(), **line,
          "launches": by_phase["encode_profile"]})
    check(all(np.isfinite(v) and v > 0 for v in line["stages_ms"].values())
          and all(by_phase["encode_profile"][n] > 0 for n in
                  ("mel_fused", "flash_attn", "yin_block_sums")),
          f"encode_profile stages {line['stages_ms']}, launches "
          f"{by_phase['encode_profile']}")
    reset_launches(kernels)
    line = check_flagship(params, fcfg.asr, frames=3000, batch=1,
                          decode=True, int8=True, device="cuda")
    by_phase["flagship_check"] = read_launches(kernels)
    emit({"phase": "flagship_check", "nvidia_smi": nvidia_smi_line(), **line,
          "launches": by_phase["flagship_check"]})
    check(line["step_ms"] > 0 and line["tokens_shape"] == [1, 16]
          and by_phase["flagship_check"]["cross_attn_int8"] > 0,
          f"flagship_check {line}, launches {by_phase['flagship_check']}")
    return by_phase


def write_large_v3_pair(directory: str, seed: int = 0):
    """A synthetic ``vocab.json`` / ``merges.txt`` pair shaped like Whisper
    large-v3's: ids 0-255 the GPT-2 byte symbols, 256-50256 merges drawn
    from ``seed``, then the specials at large-v3's ids and the 1,501
    timestamps. Each merge joins two existing tokens into a new one: first
    every pair of the lowercase letters and the space symbol in a seeded
    order (so that merges reach real text), then pairs drawn three times
    in four from the first 4096 tokens made of those symbols, else from
    all tokens toward the short early ones. No merge starts with ``#``,
    which the loader reads as a comment. Returns the two paths."""
    from janus_tpu_torch.models.tokenizer import _bytes_to_unicode

    b2u = _bytes_to_unicode()
    tokens = list(b2u.values())
    check(not any(ch.isspace() for t in tokens for ch in t),
          "a byte symbol is whitespace")
    vocab = {t: i for i, t in enumerate(tokens)}
    letters = [b2u[b] for b in b" abcdefghijklmnopqrstuvwxyz"]
    rng = np.random.default_rng(seed)
    pairs = [(a, b) for a in letters for b in letters]
    merges = [pairs[i] for i in rng.permutation(len(pairs))]
    for a, b in merges:
        vocab[a + b] = len(tokens)
        tokens.append(a + b)
    texty = letters + [a + b for a, b in merges]
    while len(tokens) < 50_257:
        which = rng.random((4096, 2)) < 0.75
        frac = rng.random((4096, 2))
        for w, f in zip(which, frac):
            n = len(tokens)
            if n == 50_257:
                break
            a, b = (texty[int(fj * min(len(texty), 4096))] if wj
                    else tokens[int(fj * fj * n)] for wj, fj in zip(w, f))
            if a[0] == "#" or a + b in vocab:
                continue
            vocab[a + b] = n
            tokens.append(a + b)
            merges.append((a, b))
            if w.all():
                texty.append(a + b)
    specials = (["<|endoftext|>", "<|startoftranscript|>"]
                + ["<|en|>"] + [f"<|lang{i}|>" for i in
                                range(1, WHISPER_LANGUAGE_COUNT)]
                + ["<|translate|>", "<|transcribe|>", "<|startoflm|>",
                   "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>"]
                + [f"<|{i // 50}.{2 * (i % 50):02d}|>" for i in range(1501)])
    for s in specials:
        vocab[s] = len(vocab)
    vocab_path = os.path.join(directory, "vocab.json")
    merges_path = os.path.join(directory, "merges.txt")
    with open(vocab_path, "w") as f:
        json.dump(vocab, f)
    with open(merges_path, "w") as f:
        f.write("#version: 0.2\n")
        f.writelines(f"{a} {b}\n" for a, b in merges)
    return vocab_path, merges_path


def hf_state_dict(params) -> dict:
    """An ASR tree of the port (decoder q/k/v fused or not, any dtype, on
    any device) as a HuggingFace ``WhisperModel`` state dict of float32
    host arrays: the inverse of ``models/import_whisper.py``'s mapping
    (``Linear`` weights ``[out, in]``, ``Conv1d`` ``[out, in, k]``). A
    fused K bias must be zero: Whisper's ``k_proj`` has none."""
    sd = {}

    def put(name, t):
        sd[f"model.{name}"] = t.float().contiguous().cpu().numpy()

    def linear(name, p):
        put(f"{name}.weight", p["w"].t())
        if "b" in p:
            put(f"{name}.bias", p["b"])

    def norm(name, p):
        put(f"{name}.weight", p["scale"])
        put(f"{name}.bias", p["bias"])

    def attn(name, p):
        if "qkv" in p:
            d = p["qkv"]["w"].shape[0]
            w = p["qkv"]["w"].split(d, dim=-1)
            b = p["qkv"]["b"].split(d)
            check(not bool(b[1].any()), f"{name}: a nonzero fused K bias")
            p = {"q": {"w": w[0], "b": b[0]}, "k": {"w": w[1]},
                 "v": {"w": w[2], "b": b[2]}, "out": p["out"]}
        for proj in ("q", "k", "v", "out"):
            linear(f"{name}.{proj}_proj", p[proj])

    def mlp(name, p):
        linear(f"{name}.fc1", p["fc1"])
        linear(f"{name}.fc2", p["fc2"])

    enc, dec = params["encoder"], params["decoder"]
    for conv in ("conv1", "conv2"):
        put(f"encoder.{conv}.weight", enc[conv]["w"].permute(2, 1, 0))
        put(f"encoder.{conv}.bias", enc[conv]["b"])
    for i, blk in enumerate(enc["blocks"]):
        p = f"encoder.layers.{i}"
        norm(f"{p}.self_attn_layer_norm", blk["attn_ln"])
        attn(f"{p}.self_attn", blk["attn"])
        norm(f"{p}.final_layer_norm", blk["mlp_ln"])
        mlp(p, blk["mlp"])
    norm("encoder.layer_norm", enc["ln_post"])
    put("decoder.embed_tokens.weight", dec["token_emb"])
    put("decoder.embed_positions.weight", dec["pos_emb"])
    for i, blk in enumerate(dec["blocks"]):
        p = f"decoder.layers.{i}"
        norm(f"{p}.self_attn_layer_norm", blk["attn_ln"])
        attn(f"{p}.self_attn", blk["attn"])
        norm(f"{p}.encoder_attn_layer_norm", blk["cross_ln"])
        attn(f"{p}.encoder_attn", blk["cross"])
        norm(f"{p}.final_layer_norm", blk["mlp_ln"])
        mlp(p, blk["mlp"])
    norm("decoder.layer_norm", dec["ln"])
    return sd


def first_step_logits(torch, params, acfg, enc, prompt, cross=None):
    """Prefill ``prompt`` and take one decode step of a recognizer with
    int8 cross K/V; ``cross`` replaces the decoder's cross-attention."""
    from janus_tpu_torch.models import asr as asr_mod

    with mock.patch.object(asr_mod, "cross_attention_kv",
                           cross or asr_mod.cross_attention_kv):
        state = asr_mod.init_decode_state(
            params, acfg, enc, max_len=prompt.shape[-1] + 1,
            dtype=torch.bfloat16, cross_kv_int8=True)
        _, state = asr_mod.decoder_prefill(params, acfg, prompt, state)
        logits, _ = asr_mod.decoder_step(params, acfg, prompt[:, -1], state)
    return logits.float()


def checked_cross_attention():
    """A stand-in for the decoder's cross-attention that launches K4 and
    holds every call against the plain version on the same inputs, at the
    kernel phase's bf16 bar (one bf16 ulp). Returns it and its tally (the
    query rows ``tq`` it saw)."""
    from janus_tpu_torch.ops.cross_attn import (cross_attention_int8,
                                                cross_attention_int8_plain)

    tally = {"calls": 0, "elements": 0, "differing": 0, "worst": 0.0,
             "tq": []}

    def checked(q, k, v):
        out = cross_attention_int8(q, k, v)
        ref = cross_attention_int8_plain(q, k, v).float()
        tally["calls"] += 1
        tally["elements"] += out.numel()
        tally["differing"] += int((out.float() != ref).sum())
        tally["worst"] = max(tally["worst"], float(
            ((out.float() - ref).abs() / (1e-5 + 2 ** -7 * ref.abs())).max()))
        tally["tq"] = sorted(set(tally["tq"]) | {q.shape[-2]})
        return out

    return checked, tally


def peak_rss_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def whisper_dropin(torch, kernels, params, fcfg, phrases) -> dict:
    """The drop-in path of a Whisper checkpoint at large-v3 width: a
    synthetic large-v3-shaped BPE pair through ``BpeTokenizer.from_files``;
    phase 4's tree (``params``, bf16, decoder q/k/v fused) as an HF-named
    state dict through ``params_from_hf_state_dict``, bit-equal after the
    encoder's fusion; then ``SemanticEncoder(tokenizer=bpe)`` on the
    phrases with the four-token ``sot_sequence``: captured by ``warmup``
    and replayed against eager, dense and under int8. Returns each
    configuration's kernel launches."""
    import shutil

    from janus_tpu_torch.common.config import ASRConfig
    from janus_tpu_torch.common.device import resolve_device
    from janus_tpu_torch.models import asr as asr_mod
    from janus_tpu_torch.models.import_whisper import params_from_hf_state_dict
    from janus_tpu_torch.models.params import (cast_floating,
                                               flatten_with_paths, tree_to)
    from janus_tpu_torch.models.tokenizer import BpeTokenizer
    from janus_tpu_torch.ops.quant import quantize_tree
    from janus_tpu_torch.ops.resample import decimate_48k_to_16k
    from janus_tpu_torch.runtime.codec import SemanticEncoder

    t_phase = time.perf_counter()

    # -- the pair -----------------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="janus_bpe_")
    try:
        t0 = time.perf_counter()
        vocab_path, merges_path = write_large_v3_pair(tmp)
        pair_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bpe = BpeTokenizer.from_files(vocab_path, merges_path)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    sot = bpe.sot_sequence()
    check(bpe.vocab_size == 51_866 == ASRConfig.large_v3().vocab_size
          and fcfg.asr.vocab_size == bpe.vocab_size,
          f"the pair's vocab_size {bpe.vocab_size}")
    check(len(bpe.bpe_ranks) == 50_001, f"{len(bpe.bpe_ranks)} merges")
    check(sot == [50258, 50259, 50360, 50364] and bpe.eot == 50257,
          f"sot_sequence {sot}, eot {bpe.eot}")
    for text in DROPIN_TEXTS:
        check(bpe.decode(bpe.encode(text)) == text,
              f"BPE round trip of {text!r}")
    words = "the quick brown fox jumps over the lazy dog again".split()
    transcript, ids = "", []
    while len(ids) < DROPIN_TRANSCRIPT_TOKENS:
        transcript += " " + words[len(transcript) % len(words)]
        ids = bpe.encode(transcript)
    ids = ids[:DROPIN_TRANSCRIPT_TOKENS]
    line = bpe.decode(ids)
    t0 = time.perf_counter()
    check(bpe.encode(line) == ids, "the transcript's ids")
    encode_first_us = 1e6 * (time.perf_counter() - t0)

    def host_us(fn, calls: int = 200) -> float:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return 1e6 * (time.perf_counter() - t0) / calls

    tokenizer = {"vocab_size": bpe.vocab_size, "merges": len(bpe.bpe_ranks),
                 "sot_sequence": sot, "eot": bpe.eot,
                 "write_s": pair_s, "from_files_s": load_s,
                 "round_trips": len(DROPIN_TEXTS),
                 "transcript_tokens": len(ids),
                 "transcript_chars": len(line),
                 "encode_first_us": encode_first_us,
                 "encode_us": host_us(lambda: bpe.encode(line)),
                 "decode_us": host_us(lambda: bpe.decode(ids))}

    # -- the importer at full width ----------------------------------------
    rss0 = peak_rss_gib()
    t0 = time.perf_counter()
    sd = hf_state_dict(params)
    to_hf_s = time.perf_counter() - t0
    sd_gib = sum(a.nbytes for a in sd.values()) / 2 ** 30
    t0 = time.perf_counter()
    tree = params_from_hf_state_dict(sd)
    import_s = time.perf_counter() - t0
    del sd
    t0 = time.perf_counter()
    imported = tree_to(cast_floating(tree, torch.bfloat16),
                       resolve_device("cuda"))
    del tree
    torch.cuda.synchronize()
    to_card_s = time.perf_counter() - t0
    importer = {"state_dict_gib": sd_gib, "to_hf_s": to_hf_s,
                "params_from_hf_state_dict_s": import_s,
                "bf16_to_card_s": to_card_s,
                "peak_rss_gib_before": rss0, "peak_rss_gib": peak_rss_gib()}

    # -- the encode ---------------------------------------------------------
    bucket = int(SR * FLAGSHIP_SECONDS)
    benc = SemanticEncoder(fcfg, imported, tokenizer=bpe, buckets=(bucket,),
                           device="cuda")
    ref = dict(flatten_with_paths(params))
    got = dict(flatten_with_paths(benc.params))
    check(sorted(got) == sorted(ref)
          and all(got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k])
                  for k in ref),
          "the imported tree differs from phase 4's")
    importer["leaves_bit_equal"] = len(ref)
    del ref, got
    benc_eager = SemanticEncoder(fcfg, benc.params, tokenizer=bpe,
                                 buckets=(bucket,), device="cuda", eager=True)

    _, warmup_ms = synced_ms(torch, benc.warmup)
    keys = greedy_keys(benc)
    check(len(keys) == 1 and keys[0][2] == 1 and keys[0][5] == len(sot)
          and len(benc._graphs.holders("encode")) == 1,
          f"warmup captured {[(k[2], k[5]) for k in keys]} (batch, "
          f"prompt_len) and {front_stats(benc)}")
    benc_eager.warmup()

    def run(enc):
        """(packets, tokens) of one ``encode_batch_submit`` of the
        phrases, and its ms."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = enc.encode_batch_submit(phrases)
        tokens = pending._arrays[0]
        res = pending.result()
        ms = 1e3 * (time.perf_counter() - t0)
        return [packet_bytes(r) for r in res], tokens.cpu(), res, ms

    def graph_and_eager(enc, enc_eager, name):
        """The first graph encode (the b = 8 capture inside it), with the
        launches counted from 0; then eager and graph in turns: equal
        tokens and packets throughout."""
        acfg = enc.cfg.asr
        reset_launches(kernels)
        fronts = len(enc._graphs.holders("encode"))
        packets, tokens, res, first_ms = run(enc)
        launches = read_launches(kernels)
        # a front captured by this encode ran once eagerly before its
        # capture (its warm-up), then replayed
        captured = len(enc._graphs.holders("encode")) - fronts
        ms = {"graph": [], "eager": []}
        for eager in (True, False, True, False):
            p, t, _, m = run(enc_eager if eager else enc)
            ms["eager" if eager else "graph"].append(m)
            check(torch.equal(t, tokens) and p == packets,
                  f"{name}: the {'eager' if eager else 'graph'} encode "
                  f"differs from the first graph encode")
        _, sync_ms = synced_ms(torch, lambda: enc.encode_batch(phrases))
        check(enc.encode_batch(phrases) == res, f"{name}: encode_batch")
        check(tokens.shape == (FLAGSHIP_BATCH, acfg.max_decode_tokens)
              and len(packets) == FLAGSHIP_BATCH
              and all(np.isfinite(r["f0"]) and np.isfinite(r["rms"])
                      for r in res), f"{name}: results {res}")
        keys = greedy_keys(enc)
        check(all(k[5] == len(sot) for k in keys)
              and any(k[2] == FLAGSHIP_BATCH for k in keys),
              f"{name}: holders {[(k[2], k[5]) for k in keys]}")
        with enc._graphs.lock:
            holder = asr_mod.greedy_graph(
                enc._graphs, enc.params, acfg, FLAGSHIP_BATCH,
                enc.mel_frame_budget(bucket) // 2, torch.bfloat16, len(sot),
                acfg.max_decode_tokens, torch.bfloat16,
                acfg.decode_cross_kv_int8, bpe.eot, enc.device)
            check(holder.loop.runs > 0
                  and len(enc._graphs.holders("greedy")) == len(keys),
                  f"{name}: the b = 8 holder's loop never ran")
            step = profile_graph_step(torch, holder)
        bits = front_bits(torch, enc, phrases, name)
        check(launches["flash_attn"] == acfg.encoder_layers * (1 + captured),
              f"{name}: {launches['flash_attn']} flash_attn launches, "
              f"{captured} fronts captured")
        return launches, {
            "first_encode_ms": first_ms, "submit_ms": ms,
            "fronts_captured_by_first": captured,
            "encode_batch_ms": sync_ms,
            "holders": [{"batch": k[2], "prompt_len": k[5]} for k in keys],
            "decode_step_graph": step, "graph": graph_stats(enc._graphs),
            "front_bits": bits, "fronts": check_fronts(name, enc),
            "tokens_equal_eager": True, "packets_byte_equal_eager": True,
            "texts": [r["text"][:80] for r in res][:2],
            "tokens_row0": tokens[0].tolist()}

    launches, dense = graph_and_eager(benc, benc_eager, "whisper_dropin")
    check(all(launches[k] > 0 for k in
              ("mel_fused", "flash_attn", "yin_block_sums")),
          f"whisper_dropin launches {launches}")
    del benc, benc_eager
    torch.cuda.empty_cache()

    # -- the int8 configuration -------------------------------------------
    qcfg = fcfg.override(**{"asr.decode_cross_kv_int8": True})
    qenc = SemanticEncoder(qcfg, quantize_tree(imported, mode="dynamic"),
                           tokenizer=bpe, buckets=(bucket,), device="cuda")
    del imported
    qenc_eager = SemanticEncoder(qcfg, qenc.params, tokenizer=bpe,
                                 buckets=(bucket,), device="cuda", eager=True)
    qenc.warmup()
    qenc_eager.warmup()
    q_launches, int8 = graph_and_eager(qenc, qenc_eager,
                                       "whisper_dropin_int8")
    # every kernel of the recognizer, and not the TTS step's mixed linear
    check(all(n > 0 for name, n in q_launches.items()
              if name != "mixed_linear") and q_launches["mixed_linear"] == 0,
          f"whisper_dropin_int8 launches {q_launches}")

    # every K4 call of the prefill (four query rows) and of the first step
    # against the plain version, at the shapes the encode gives it
    acfg, dev = qcfg.asr, qenc.device
    a16 = decimate_48k_to_16k(torch.from_numpy(np.stack(phrases)).to(dev)
                              .float())
    q_enc = asr_mod.encode_audio(qenc.params, acfg, asr_mod.prepare_mel(
        a16, acfg, pad_to_frames=qenc.mel_frame_budget(bucket)).to(
            torch.bfloat16))
    prompt = torch.tensor(sot, device=dev).expand(FLAGSHIP_BATCH, len(sot))
    checked_cross, on_path = checked_cross_attention()
    logits_k = first_step_logits(torch, qenc.params, acfg, q_enc, prompt)
    logits_c = first_step_logits(torch, qenc.params, acfg, q_enc, prompt,
                                 checked_cross)
    check(bool(torch.isfinite(logits_k).all())
          and torch.equal(logits_k, logits_c)
          and on_path["calls"] == 2 * acfg.decoder_layers
          and on_path["tq"] == [1, len(sot)] and on_path["worst"] <= 1.0,
          f"whisper_dropin_int8: K4 on the {len(sot)}-token prefill and "
          f"first step outside one bf16 ulp of plain {on_path}")
    int8["k4_on_path"] = on_path
    del q_enc
    del qenc, qenc_eager
    torch.cuda.empty_cache()
    emit({"phase": "whisper_dropin", "nvidia_smi": nvidia_smi_line(),
          "phase_s": time.perf_counter() - t_phase,
          "model": "whisper-large-v3 (phase 4's random weights, seed 0) "
                   "through an HF-named state dict",
          "tokenizer": tokenizer, "importer": importer,
          "warmup_ms": warmup_ms, "batch": FLAGSHIP_BATCH,
          "seconds": FLAGSHIP_SECONDS,
          "max_decode_tokens": fcfg.asr.max_decode_tokens,
          "dense": {**dense, "launches": launches},
          "int8": {**int8, "launches": q_launches}})
    return {"whisper_dropin": launches, "whisper_dropin_int8": q_launches}


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
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "driver": driver[0] if driver else None,
          "kernel_build_s": round(build_s, 3)})

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
    # of several rows (the whisper_dropin prefill's four rows at full
    # width), two blocks and one block per (batch, head), rows packed
    # densely (4-byte and 1-byte loads)
    for b_, h_, t, tq_ in ((2, 5, 499, 1), (2, 5, 499, 3), (2, 5, 500, 5),
                           (FLAGSHIP_BATCH, h, CROSS_T[0], 4),
                           (2, 5, 200, 1), (2, 5, 77, 1)):
        for dtype, rtol, atol in cross_bars:
            q = torch.randn((b_, h_, tq_, dh), generator=gen,
                            device=dev).to(dtype)
            kq, vq = (quantize_kv_t(torch.randn((b_, h_, t, dh),
                                                generator=gen, device=dev))
                      for _ in range(2))
            ref = cross_attention_int8_plain(q, kq, vq)
            packed = tuple(QuantKVT(x.q.contiguous(), x.scale)
                           for x in (kq, vq))
            for layout, (kk, vv) in (("padded", (kq, vq)),
                                     ("packed", packed)):
                tol_ratio = worst_ratio(cross_attention_int8(q, kk, vv), ref,
                                        rtol, atol)
                emit({"phase": "kernel", "name": "cross_attn_int8",
                      "batch": b_, "heads": h_, "tq": tq_, "t": t,
                      "head_dim": dh, "dtype": str(dtype).split(".")[-1],
                      "layout": layout, "splits": plan_splits(t),
                      "load_bytes": k4_load_bytes(kk, vv),
                      "tol_ratio": tol_ratio})
                check(tol_ratio <= 1.0, f"cross_attn_int8 t={t} tq={tq_} "
                      f"{dtype} {layout} beyond rtol {rtol} atol {atol}")

    # -- the decode steps' two kernels (the port's own: no Pallas kernel) ---
    from janus_tpu_torch.ops.decode_attention import KERNEL as DECODE
    from janus_tpu_torch.ops.attention import KVCache
    from janus_tpu_torch.ops.decode_attention import _kernel as da_launch
    from janus_tpu_torch.ops.decode_attention import (decode_attention,
                                                      decode_attention_plain,
                                                      plan_splits as
                                                      da_splits)
    from janus_tpu_torch.ops.layers import LN_KERNEL as LNORM
    from janus_tpu_torch.ops.layers import (add_layer_norm_fused,
                                            layer_norm_fused,
                                            layer_norm_plain)

    def ln_check(out, ref) -> dict:
        """fp32: atol 1e-5. bf16: one bf16 ulp of |ref| beyond the fp32
        bar (an output where scale * n cancels the bias keeps few of its
        bits, and there the two row sums' orders decide the last ones)."""
        diff = (out.float() - ref.float()).abs()
        r = ref.float().abs()
        if out.dtype == torch.float32:
            return {"atol": 1e-5, "max_err": float(diff.max()),
                    "ok": bool((diff <= 1e-5).all()),
                    "n_differ": int((out != ref).sum())}
        ulp = torch.exp2(torch.floor(torch.log2(r.clamp_min(2.0 ** -126)))
                         - 7)
        ulps = diff / ulp
        return {"bar": "one bf16 ulp + 1e-5", "max_err": float(diff.max()),
                "ok": bool((diff <= ulp + 1e-5).all()),
                "n_differ": int((out != ref).sum()),
                "n_beyond_one_ulp": int((ulps > 1).sum()),
                "max_ulps": float(ulps.max()), "numel": out.numel()}

    # the decoder step's and the encoder's widths in bf16, the TTS step's
    # fp32 activations against bf16 parameters
    ln_rows = (((FLAGSHIP_BATCH, 1, 1280), torch.bfloat16, torch.bfloat16),
               ((FLAGSHIP_BATCH, 1500, 1280), torch.bfloat16, torch.bfloat16),
               ((FLAGSHIP_BATCH, 1, 1280), torch.float32, torch.bfloat16))
    for shape, x_dtype, p_dtype in ln_rows:
        d = shape[-1]
        x = (3 * torch.randn(shape, generator=gen, device=dev) + 1).to(x_dtype)
        sc = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(p_dtype)
        bi = (0.1 * torch.randn(d, generator=gen, device=dev)).to(p_dtype)
        out = layer_norm_fused(x, sc, bi)
        ref = layer_norm_plain(x, sc, bi)
        torch.cuda.synchronize()
        got = ln_check(out, ref)
        nbytes = (2 * x.numel() * x.element_size()
                  + 2 * d * sc.element_size())
        b_ms, b_by = bound_ms(8.0 * x.numel(), PEAK_FP32, nbytes)
        xb, sb, bb = (t.to(torch.bfloat16) for t in (x, sc, bi))
        row = {"phase": "kernel", "name": "layer_norm", "shape": list(shape),
               "x_dtype": str(x_dtype).split(".")[-1],
               "param_dtype": str(p_dtype).split(".")[-1], **got,
               "kernel_ms": graph_ms(lambda: layer_norm_fused(x, sc, bi),
                                     iters=50),
               "eager_ms": time_ms(lambda: layer_norm_fused(x, sc, bi),
                                   iters=50),
               "host_us": wrapper_us(lambda: layer_norm_fused(x, sc, bi)),
               "plain_ms": graph_ms(lambda: layer_norm_plain(x, sc, bi)),
               "bound_ms": b_ms, "bound_by": b_by,
               # F.layer_norm at bf16: a yardstick only
               "library_ms": graph_ms(lambda: torch.nn.functional.layer_norm(
                   xb, (d,), sb, bb), iters=50)}
        emit(row)
        check(got["ok"], f"layer_norm {shape} {x_dtype}/{p_dtype}: {got}")
        check(torch.equal(out, layer_norm_fused(x, sc, bi)),
              f"layer_norm {shape}: two launches differ")
        if shape[1] == 1 and x_dtype == torch.bfloat16:
            summary["layer_norm"] = row
    # widths that are no multiple of a 16-byte chunk, rows a block wide, the
    # widest row, and the vocoder's width
    for shape, x_dtype, p_dtype in (((5, 77), torch.float32, torch.float32),
                                    ((4, 1001), torch.bfloat16,
                                     torch.float32),
                                    ((3, 4096), torch.bfloat16,
                                     torch.bfloat16),
                                    ((2, 8192), torch.float32, torch.float32),
                                    ((9, 512), torch.float32,
                                     torch.bfloat16)):
        d = shape[-1]
        x = (3 * torch.randn(shape, generator=gen, device=dev) + 1).to(x_dtype)
        sc = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(p_dtype)
        bi = (0.1 * torch.randn(d, generator=gen, device=dev)).to(p_dtype)
        got = ln_check(layer_norm_fused(x, sc, bi),
                       layer_norm_plain(x, sc, bi))
        emit({"phase": "kernel", "name": "layer_norm", "shape": list(shape),
              "x_dtype": str(x_dtype).split(".")[-1],
              "param_dtype": str(p_dtype).split(".")[-1], **got})
        check(got["ok"], f"layer_norm {shape} {x_dtype}/{p_dtype}: {got}")

    # the residual add taken into the norm (add_layer_norm): the recognizer
    # step's bf16 rows, the AR step's fp32 activations against bf16
    # parameters, the encoder's rows; r must be PyTorch's add bit for bit,
    # the norm the layer norm's bar of the plain version over r
    bf, f32 = torch.bfloat16, torch.float32
    for shape, x_dtype, p_dtype in (((FLAGSHIP_BATCH, 1, 1280), bf, bf),
                                    ((FLAGSHIP_BATCH, 1, 1280), f32, bf),
                                    ((FLAGSHIP_BATCH, 1500, 1280), bf, bf)):
        d = shape[-1]
        x = (3 * torch.randn(shape, generator=gen, device=dev) + 1).to(x_dtype)
        dl = torch.randn(shape, generator=gen, device=dev).to(x_dtype)
        sc = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(p_dtype)
        bi = (0.1 * torch.randn(d, generator=gen, device=dev)).to(p_dtype)
        r, y = add_layer_norm_fused(x, dl, sc, bi)
        torch.cuda.synchronize()
        r_equal = torch.equal(r, x + dl)
        got = ln_check(y, layer_norm_plain(x + dl, sc, bi))
        # x and delta read once, r and y written once
        nbytes = (4 * x.numel() * x.element_size()
                  + 2 * d * sc.element_size())
        b_ms, b_by = bound_ms(9.0 * x.numel(), PEAK_FP32, nbytes)
        xb, db, sb, bb = (t.to(torch.bfloat16) for t in (x, dl, sc, bi))
        row = {"phase": "kernel", "name": "add_layer_norm",
               "shape": list(shape), "x_dtype": str(x_dtype).split(".")[-1],
               "param_dtype": str(p_dtype).split(".")[-1],
               "r_equals_torch_add": r_equal, **got,
               "kernel_ms": graph_ms(lambda: add_layer_norm_fused(
                   x, dl, sc, bi), iters=50),
               "host_us": wrapper_us(lambda: add_layer_norm_fused(
                   x, dl, sc, bi)),
               # the pair it replaces: PyTorch's add, then the kernel
               "unfused_ms": graph_ms(lambda: layer_norm_fused(
                   x + dl, sc, bi), iters=50),
               "plain_ms": graph_ms(lambda: layer_norm_plain(x + dl, sc, bi)),
               "bound_ms": b_ms, "bound_by": b_by,
               # the add and F.layer_norm at bf16: a yardstick only
               "library_ms": graph_ms(lambda: torch.nn.functional.layer_norm(
                   xb + db, (d,), sb, bb), iters=50)}
        emit(row)
        check(r_equal, f"add_layer_norm {shape} {x_dtype}: r is not the add")
        check(got["ok"], f"add_layer_norm {shape} {x_dtype}/{p_dtype}: {got}")
        r2, y2 = add_layer_norm_fused(x, dl, sc, bi)
        check(torch.equal(r2, r) and torch.equal(y2, y),
              f"add_layer_norm {shape}: two launches differ")

    def da_case(b, h, tq, t, dh, q_dtype, kv_dtype, view):
        """q, and K/V: a cache whose slots all hold values (those past the
        fill are an earlier prompt's), or the cross K/V as the heads of the
        encoder's projection split them (a strided view)."""
        q = torch.randn((b, h, tq, dh), generator=gen, device=dev).to(q_dtype)
        if view:
            k, v = (torch.randn((b, t, h * dh), generator=gen, device=dev)
                    .to(kv_dtype).reshape(b, t, h, dh).movedim(-2, -3)
                    for _ in range(2))
        else:
            k = (2 * torch.randn((b, h, t, dh), generator=gen,
                                 device=dev)).to(kv_dtype)
            v = torch.randn((b, h, t, dh), generator=gen,
                            device=dev).to(kv_dtype)
        return q, k, v

    # the recognizer's self-attention (step at the 1- and 4-token prompts'
    # caches, the 4-row prefill) and cross-attention (10 s bucket, step and
    # prefill; the 2 s bucket at b = 64), the TTS step's fp32 queries over
    # its bf16 cache (35-position prompt + 256 groups) at b = 8 and 1
    da_rows = (("self_step", 8, 20, 1, 25, 64, bf, bf, 12, False),
               ("self_step_prompt4", 8, 20, 1, 28, 64, bf, bf, 15, False),
               ("self_prefill4", 8, 20, 4, 28, 64, bf, bf, 0, False),
               ("cross_step", 8, 20, 1, 500, 64, bf, bf, None, True),
               ("cross_prefill4", 8, 20, 4, 500, 64, bf, bf, None, True),
               ("cross_step_b64_2s", 64, 20, 1, 100, 64, bf, bf, None, True),
               ("tts_step", 8, 20, 1, 291, 64, f32, bf, 35 + 128, False),
               ("tts_step_b1", 1, 20, 1, 291, 64, f32, bf, 35 + 128, False))
    da_bars = {f32: (0.0, 2e-5), bf: (2 ** -6, 5e-3)}
    for (case, b, h, tq, t, dh, q_dtype, kv_dtype, fill,
         view) in da_rows:
        q, k, v = da_case(b, h, tq, t, dh, q_dtype, kv_dtype, view)
        pos = None if fill is None else torch.tensor(fill, device=dev)
        out = decode_attention(q, k, v, pos)
        ref = decode_attention_plain(q, k, v, pos)
        torch.cuda.synchronize()
        rtol, atol = da_bars[torch.bfloat16 if bf in (q_dtype, kv_dtype)
                             else f32]
        tol_ratio = worst_ratio(out, ref, rtol, atol)
        # the keys this run needs: those up to the last row's fill point
        seen = t if fill is None else min(t, fill + tq)
        keys = tq * seen if fill is None else sum(
            min(t, fill + r + 1) for r in range(tq))
        ops = b * h * (4.0 * dh * keys + 5.0 * keys)
        nbytes = b * h * (2 * tq * dh * q.element_size()
                          + 2 * seen * dh * k.element_size())
        b_ms, b_by = bound_ms(ops, PEAK_FP32, nbytes)
        mask = (None if fill is None else
                torch.arange(t, device=dev)[None, :]
                <= fill + torch.arange(tq, device=dev)[:, None])
        qb_, kb_, vb_ = (x.to(torch.bfloat16) for x in (q, k, v))
        row = {"phase": "kernel", "name": "decode_attn", "case": case,
               "batch": b, "heads": h, "tq": tq, "t": t, "head_dim": dh,
               "fill": fill, "q_dtype": str(q_dtype).split(".")[-1],
               "kv_dtype": str(kv_dtype).split(".")[-1],
               "kv_strided_view": view,
               "splits": da_splits(t, kv_dtype, dh, tq),
               "rtol": rtol, "atol": atol, "max_err": max_abs(out, ref),
               "tol_ratio": tol_ratio,
               "kernel_ms": graph_ms(lambda: decode_attention(q, k, v, pos),
                                     iters=50),
               "eager_ms": time_ms(lambda: decode_attention(q, k, v, pos),
                                   iters=50),
               "host_us": wrapper_us(lambda: decode_attention(q, k, v, pos)),
               "plain_ms": graph_ms(lambda: decode_attention_plain(
                   q, k, v, pos), iters=20),
               "bound_ms": b_ms, "bound_by": b_by,
               # SDPA at bf16 with the same mask: a yardstick only
               "library_ms": graph_ms(lambda: sdpa(
                   qb_, kb_, vb_, attn_mask=mask), iters=50)}
        emit(row)
        check(tol_ratio <= 1.0, f"decode_attn {case} beyond rtol {rtol} "
              f"atol {atol}: {tol_ratio}")
        check(torch.equal(out, decode_attention(q, k, v, pos)),
              f"decode_attn {case}: two launches differ")
        if fill is not None:
            # stale slots past the fill never enter
            k2, v2 = k.clone(), v.clone()
            k2[..., fill + tq:, :] = float("nan")
            v2[..., fill + tq:, :] = float("nan")
            check(torch.equal(decode_attention(q, k2, v2, pos), out),
                  f"decode_attn {case}: slots past the fill changed it")
        if case == "cross_step":
            summary["decode_attn"] = row

    # the cluster's size at the 10 s and 30 s cross-attention: every plan
    # the kernel takes, on the same tensors, through the wrapper's private
    # launcher (the route's plan is da_splits)
    for t in CROSS_T:
        q, k, v = da_case(FLAGSHIP_BATCH, 20, 1, t, 64, bf, bf, True)
        ref = decode_attention_plain(q, k, v)
        for splits in (1, 2, 4, 8):
            out = da_launch(q, k, v, None, None, None, splits)
            tol_ratio = worst_ratio(out, ref, 2 ** -6, 5e-3)
            emit({"phase": "kernel", "name": "decode_attn",
                  "case": "split_plan", "t": t, "splits": splits,
                  "default_splits": da_splits(t, bf, 64),
                  "tol_ratio": tol_ratio,
                  "kernel_ms": graph_ms(lambda: da_launch(
                      q, k, v, None, None, None, splits), iters=50)})
            check(tol_ratio <= 1.0, f"decode_attn t={t} splits={splits}: "
                  f"{tol_ratio}")

    # the cache written by the kernel: the recognizer's self step and
    # prompt-4 prefill, the TTS step at b = 8 and 1 (its fp32 rows rounded
    # into the bf16 cache); the cache must equal write_at's and the output
    # write-then-attend's on the card, bit for bit
    for (case, b, h, tq, t, dh, q_dtype, kv_dtype, fill) in (
            ("self_step_write", 8, 20, 1, 25, 64, bf, bf, 12),
            ("self_prefill4_write", 8, 20, 4, 28, 64, bf, bf, 0),
            ("tts_step_write", 8, 20, 1, 291, 64, f32, bf, 35 + 128),
            ("tts_step_b1_write", 1, 20, 1, 291, 64, f32, bf, 35 + 128)):
        q, k, v = da_case(b, h, tq, t, dh, q_dtype, kv_dtype, False)
        kn, vn = (torch.randn((b, h, tq, dh), generator=gen, device=dev)
                  .to(q_dtype) for _ in range(2))
        pos = torch.tensor(fill, device=dev)
        ref = KVCache(k.clone(), v.clone())
        ref.write_at(kn, vn, pos)
        want = decode_attention(q, ref.k, ref.v, pos)
        # the kernel's caches hold NaN past the new rows: never read
        k1, v1 = k.clone(), v.clone()
        k1[..., fill + tq:, :] = float("nan")
        v1[..., fill + tq:, :] = float("nan")
        out = decode_attention(q, k1, v1, pos, kn, vn)
        torch.cuda.synchronize()
        cache_equal = bool(torch.equal(k1[..., :fill + tq, :],
                                       ref.k[..., :fill + tq, :])
                           and torch.equal(v1[..., :fill + tq, :],
                                           ref.v[..., :fill + tq, :])
                           and k1[..., fill + tq:, :].isnan().all()
                           and v1[..., fill + tq:, :].isnan().all())
        out_equal = torch.equal(out, want)
        plain = decode_attention_plain(q, k.clone(), v.clone(), pos, kn, vn)
        tol_ratio = worst_ratio(out, plain, 2 ** -6, 5e-3)
        # the keys before the fill read from the cache, the new rows read
        # and written, q read and the output written
        keys = sum(fill + r + 1 for r in range(tq))
        ops = b * h * (4.0 * dh * keys + 5.0 * keys)
        nbytes = b * h * (2 * tq * dh * q.element_size()
                          + 2 * fill * dh * k.element_size()
                          + 2 * tq * dh * (q.element_size()
                                           + k.element_size()))
        b_ms, b_by = bound_ms(ops, PEAK_FP32, nbytes)
        mask = (torch.arange(t, device=dev)[None, :]
                <= fill + torch.arange(tq, device=dev)[:, None])
        qb_, kb_, vb_ = (x.to(torch.bfloat16) for x in (q, ref.k, ref.v))

        def unfused():
            ref.write_at(kn, vn, pos)
            return decode_attention(q, ref.k, ref.v, pos)

        row = {"phase": "kernel", "name": "decode_attn", "case": case,
               "batch": b, "heads": h, "tq": tq, "t": t, "head_dim": dh,
               "fill": fill, "q_dtype": str(q_dtype).split(".")[-1],
               "kv_dtype": str(kv_dtype).split(".")[-1],
               "splits": da_splits(t, kv_dtype, dh, tq),
               "cache_equals_write_at": cache_equal,
               "out_equals_write_then_attend": out_equal,
               "tol_ratio": tol_ratio,
               "kernel_ms": graph_ms(lambda: decode_attention(
                   q, k1, v1, pos, kn, vn), iters=50),
               "unfused_ms": graph_ms(unfused, iters=50),
               "bound_ms": b_ms, "bound_by": b_by,
               # SDPA at bf16 over the written cache: a yardstick only
               "library_ms": graph_ms(lambda: sdpa(
                   qb_, kb_, vb_, attn_mask=mask), iters=50)}
        emit(row)
        check(cache_equal, f"decode_attn {case}: the written cache differs "
              f"from write_at's")
        check(out_equal, f"decode_attn {case}: the output differs from "
              f"write-then-attend's")
        check(tol_ratio <= 1.0, f"decode_attn {case}: {tol_ratio}")
    # other head dims and types, the widest query block, the 30 s window
    for b, h, tq, t, dh, q_dtype, kv_dtype, fill in (
            (3, 4, 1, 48, 32, f32, f32, 5), (3, 4, 11, 48, 32, f32, f32, 0),
            (2, 3, 3, 77, 128, f32, f32, 60),
            (2, 3, 16, 200, 128, bf, f32, 100),
            (8, 20, 1, 1500, 64, bf, bf, None),
            (2, 5, 2, 999, 32, bf, bf, None)):
        q, k, v = da_case(b, h, tq, t, dh, q_dtype, kv_dtype, False)
        rtol, atol = da_bars[torch.bfloat16 if bf in (q_dtype, kv_dtype)
                             else f32]
        for pos in ((None,) if fill is None
                    else (fill, torch.tensor(fill, device=dev))):
            out = decode_attention(q, k, v, pos)
            tol_ratio = worst_ratio(out, decode_attention_plain(q, k, v, pos),
                                    rtol, atol)
            check(torch.equal(out, decode_attention(q, k, v, pos)),
                  f"decode_attn b={b} tq={tq} t={t}: two launches differ")
            if fill is not None:
                # stale slots past the fill never enter
                k2, v2 = k.clone(), v.clone()
                k2[..., fill + tq:, :] = float("nan")
                v2[..., fill + tq:, :] = float("nan")
                check(torch.equal(decode_attention(q, k2, v2, pos), out),
                      f"decode_attn b={b} tq={tq} t={t}: slots past the "
                      f"fill changed it")
            emit({"phase": "kernel", "name": "decode_attn", "batch": b,
                  "heads": h, "tq": tq, "t": t, "head_dim": dh,
                  "fill": fill, "fill_on_device": isinstance(
                      pos, torch.Tensor),
                  "q_dtype": str(q_dtype).split(".")[-1],
                  "kv_dtype": str(kv_dtype).split(".")[-1],
                  "splits": da_splits(t, kv_dtype, dh, tq),
                  "tol_ratio": tol_ratio})
            check(tol_ratio <= 1.0, f"decode_attn b={b} tq={tq} t={t} "
                  f"dh={dh} {q_dtype}/{kv_dtype}: {tol_ratio}")

    # the dynamic-int8 linear at every shape of the int8 path (large-v3):
    # the decode steps' four weights at b = 1, 8, 64 and the 4-token
    # prefill at b = 8 (32 rows); the encoder's (and the prefill's cross
    # K/V) at 8 x 10 s (4000 rows) and the sessions' 2 s bucket at b = 64
    # (6400 rows). bf16 activations, scales and bias, as the flagship's
    # tree; an all-zero row. The kernel must equal the plain version bit for
    # bit, and at the decode step's b = 8 beat the path it replaced.
    from janus_tpu_torch.ops.int8_linear import KERNEL as INT8
    from janus_tpu_torch.ops.int8_linear import _launch as i8_launch
    from janus_tpu_torch.ops.int8_linear import (_sm_count, int8_linear,
                                                 int8_linear_plain, use_pdl)
    from janus_tpu_torch.ops.int8_linear import plan_splits as i8_splits
    from janus_tpu_torch.ops.quant import (DynQuantizedWeight, column_major,
                                           quantize_weight)

    def i8_tiles(m: int, n: int) -> dict:
        """The tile product's plan as its launcher makes it: tile rows and
        channels, persistent blocks."""
        import ctypes

        plan = (ctypes.c_int * 3)()
        cuda_build.check_launch(INT8, cuda_build.entry(
            INT8, "int8_linear_tiles",
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])(m, n, plan))
        return {"tile": [plan[0], plan[1]], "grid": plan[2], "cluster": 1}

    i8_decode = ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280))
    i8_encode = ((1280, 1280), (1280, 5120), (5120, 1280))
    i8_rows = ([(m, k, n) for m in (FLAGSHIP_BATCH, 1, 32, 64)
                for k, n in i8_decode]
               + [(m, k, n) for m in (FLAGSHIP_BATCH * 500, 64 * 100)
                  for k, n in i8_encode])
    for m, k, n in i8_rows:
        x = (2 * torch.randn((m, k), generator=gen, device=dev)).to(bf)
        x[0] = 0
        wq = quantize_weight(0.02 * torch.randn((k, n), generator=gen,
                                                device=dev))
        w_rows = DynQuantizedWeight(wq.q, wq.scale.to(bf))
        qw = column_major(w_rows)
        bias = (0.1 * torch.randn(n, generator=gen, device=dev)).to(bf)
        out = int8_linear(x, qw, bias)
        ref = int8_linear_plain(x, qw, bias)
        before = int8_linear_before(torch, x, w_rows, bias)
        torch.cuda.synchronize()
        equal, before_equal = torch.equal(out, ref), torch.equal(before, ref)
        # x, the weight, its scales and the bias read once, y written once
        nbytes = 2 * x.numel() + k * n + 2 * 2 * n + 2 * m * n
        b_ms, b_by = bound_ms(2.0 * m * k * n, PEAK_INT8, nbytes)
        a8 = torch.randint(-127, 128, (max(m, 17), k), generator=gen,
                           device=dev, dtype=torch.int8)
        row = {"phase": "kernel", "name": "int8_linear", "m": m, "k": k,
               "n": n, "x_dtype": "bfloat16", "param_dtype": "bfloat16",
               "splits": i8_splits(m, k, n, _sm_count(dev)),
               "pdl": use_pdl(m),
               "bit_equal_plain": equal, "before_bit_equal_plain":
               before_equal, "max_err": max_abs(out, ref),
               "kernel_ms": graph_ms(lambda: int8_linear(x, qw, bias),
                                     iters=50),
               "eager_ms": time_ms(lambda: int8_linear(x, qw, bias),
                                   iters=50),
               "host_us": wrapper_us(lambda: int8_linear(x, qw, bias)),
               "plain_ms": graph_ms(lambda: int8_linear_plain(x, qw, bias)),
               "before_ms": graph_ms(lambda: int8_linear_before(
                   torch, x, w_rows, bias)),
               "bound_ms": b_ms, "bound_by": b_by,
               # no single PyTorch call quantizes, multiplies and rescales;
               # torch._int_mm's product alone (more than 16 rows) on the
               # row-major and the K-contiguous weight
               "library_ms": None,
               "int_mm_ms": {"rows": a8.shape[0],
                             "row_major": graph_ms(lambda: torch._int_mm(
                                 a8, w_rows.q)),
                             "col_major": graph_ms(lambda: torch._int_mm(
                                 a8, qw.q))},
               # each kernel of a call, traced: mean device us a call
               "device_us": device_us(torch, lambda: int8_linear(
                   x, qw, bias))}
        row["launches_a_call"] = len(row["device_us"])
        # the launches with and without the programmatic attribute (without
        # it the product's weight loads wait for the quantization)
        row["pdl_ms"] = graph_ms(lambda: i8_launch(
            x, qw, bias, pdl=True)[0], iters=50)
        row["no_pdl_ms"] = graph_ms(lambda: i8_launch(
            x, qw, bias, pdl=False)[0], iters=50)
        if m > 64:
            # the persistent product's tile, blocks (one an SM, no more
            # than its tiles) and cluster
            row.update(i8_tiles(m, n))
        else:
            # each split plan
            row["splits_ms"] = {s_: graph_ms(lambda: i8_launch(
                x, qw, bias, splits=s_)[0], iters=50) for s_ in (2, 4, 8)}
        emit(row)
        check(equal, f"int8_linear {m}x{k}x{n}: the kernel differs from the "
              f"plain version ({row['max_err']})")
        check(before_equal, f"int8_linear {m}x{k}x{n}: the yardstick "
              f"differs from the plain version")
        check(torch.equal(out, int8_linear(x, qw, bias)),
              f"int8_linear {m}x{k}x{n}: two launches differ")
        # the card traces (every profiled phase reads its kernels): a call
        # is two kernels, the quantization and a product
        check(row["launches_a_call"] == 2,
              f"int8_linear {m}x{k}x{n}: a call ran {row['device_us']}")
        if m == FLAGSHIP_BATCH:
            check(row["kernel_ms"] < row["before_ms"],
                  f"int8_linear {m}x{k}x{n}: {row['kernel_ms']} ms, not "
                  f"under the path it replaced ({row['before_ms']} ms)")
        if (m, k, n) == (FLAGSHIP_BATCH, 1280, 5120):
            summary["int8_linear"] = row
        del x, wq, w_rows, qw, out, ref, before, a8
    torch.cuda.empty_cache()

    # the mixed-dtype linear at every shape of the AR step (the flagship
    # TTS: the prenet 320 -> 1280 and 1280 -> 1280, q/k/v/out, fc1, fc2,
    # the mel head 1280 -> 320 and the stop head 1280 -> 1): fp32 rows at
    # b = 8 and 1 (and 16, 64) against bf16 weights and bf16 biases, as the
    # step multiplies them. Each within 1e-5 (sum |x w| + |b|) of the plain
    # version; the yardstick is one torch.addmm over a copy of the weight
    # widened before timing (the path the step took before the kernel)
    from janus_tpu_torch.ops.layers import layer_norm_fused
    from janus_tpu_torch.ops.mixed_linear import KERNEL as MIXED
    from janus_tpu_torch.ops.mixed_linear import _launch as mx_launch
    from janus_tpu_torch.ops.mixed_linear import _sm_count as mx_sms
    from janus_tpu_torch.ops.mixed_linear import (_launch_group,
                                                  mixed_linear,
                                                  mixed_linear_group,
                                                  mixed_linear_plain,
                                                  plan_group, use_pdl,
                                                  vector_loads)
    from janus_tpu_torch.ops.mixed_linear import plan_splits as mx_splits

    def mx_chain(m, k, members, gelu=False):
        """The call after the kernel that precedes it in the step (a
        layer norm of the rows; for fc2's K of 5120, fc1 with its GELU),
        both in one graph, launched programmatically and not: the
        chain's ms, and the preceding kernel's alone."""
        src = torch.randn((m, 1280 if k == 5120 else k), generator=gen,
                          device=dev)
        scale = torch.ones(src.shape[1], device=dev).to(bf)
        shift = torch.zeros(src.shape[1], device=dev).to(bf)
        w1 = (0.02 * torch.randn((1280, 5120), generator=gen,
                                 device=dev)).to(bf)

        def before(pdl):
            h = layer_norm_fused(src, scale, shift)
            if k == 5120:
                h = mx_launch(h, w1, None, gelu=True, pdl=pdl)
            return h

        def chain(pdl):
            return _launch_group(before(pdl), members, gelu=gelu, pdl=pdl)

        out = {"pdl": use_pdl(m),
               "pdl_ms": graph_ms(lambda: chain(True), iters=50),
               "no_pdl_ms": graph_ms(lambda: chain(False), iters=50),
               "before_ms": graph_ms(lambda: before(True), iters=50)}
        check(all(torch.equal(a, c) for a, c in zip(chain(True),
                                                    chain(False))),
              f"mixed_linear {m}x{k}: the programmatic chain differs")
        return out

    mx_shapes = ((320, 1280), (1280, 1280), (1280, 5120), (5120, 1280),
                 (1280, 320), (1280, 1))
    for m in (FLAGSHIP_BATCH, 1, 16, 64):
        for k, n in mx_shapes:
            x = 2 * torch.randn((m, k), generator=gen, device=dev)
            w = (0.02 * torch.randn((k, n), generator=gen, device=dev)).to(bf)
            bias = (0.1 * torch.randn(n, generator=gen, device=dev)).to(bf)
            out = mixed_linear(x, w, bias)
            ref = mixed_linear_plain(x, w, bias)
            exact = x.double() @ w.double() + bias.double()
            torch.cuda.synchronize()
            mag = x.double().abs() @ w.double().abs() + bias.double().abs()
            tol_ratio = float(((out.double() - ref.double()).abs()
                               / (1e-5 * mag)).max())
            # x, the bf16 weight and bias read once, y written once
            nbytes = 4 * m * k + 2 * k * n + 2 * n + 4 * m * n
            b_ms, b_by = bound_ms(2.0 * m * k * n, PEAK_FP32, nbytes)
            wide = w.float()
            row = {"phase": "kernel", "name": "mixed_linear", "m": m,
                   "k": k, "n": n, "x_dtype": "float32",
                   "w_dtype": "bfloat16", "bias_dtype": "bfloat16",
                   "splits": mx_splits(m, k, n, mx_sms(dev)),
                   "vector_loads": vector_loads(n, w.stride(0),
                                                w.data_ptr()),
                   "bar": "1e-5 (sum |x w| + |b|)", "tol_ratio": tol_ratio,
                   "max_err": max_abs(out, ref),
                   "kernel_vs_fp64_max": float((out.double() - exact)
                                               .abs().max()),
                   "plain_vs_fp64_max": float((ref.double() - exact)
                                              .abs().max()),
                   "kernel_ms": graph_ms(lambda: mixed_linear(x, w, bias),
                                         iters=50),
                   "eager_ms": time_ms(lambda: mixed_linear(x, w, bias),
                                       iters=50),
                   "host_us": wrapper_us(lambda: mixed_linear(x, w, bias)),
                   "plain_ms": graph_ms(lambda: mixed_linear_plain(
                       x, w, bias)),
                   "bound_ms": b_ms, "bound_by": b_by,
                   # one PyTorch call over the weight widened beforehand:
                   # a yardstick only, the port does not call it
                   "library_ms": graph_ms(lambda: torch.addmm(
                       bias.float(), x, wide), iters=50)}
            # the weight read from device memory, as a step reads it: one
            # call on each of enough copies to overflow the 50 MB L2
            copies = [w.clone() for _ in range(min(64, 1 + int(
                64e6 // (2 * k * n))))]

            def cold():
                for wc in copies:
                    mixed_linear(x, wc, bias)

            row["cold_ms"] = graph_ms(cold, iters=2) / len(copies)
            del copies
            if m in (FLAGSHIP_BATCH, 1):
                row["splits_ms"] = {s_: graph_ms(lambda: mx_launch(
                    x, w, bias, splits=s_), iters=50) for s_ in (1, 2, 4, 8)}
            row.update(mx_chain(m, k, [(w, bias)]))
            emit(row)
            check(tol_ratio <= 1.0, f"mixed_linear {m}x{k}x{n}: outside "
                  f"1e-5 (sum |x w| + |b|) of plain ({tol_ratio})")
            check(torch.equal(out, mixed_linear(x, w, bias)),
                  f"mixed_linear {m}x{k}x{n}: two launches differ")
            if (m, k, n) == (FLAGSHIP_BATCH, 1280, 5120):
                summary["mixed_linear"] = row
            del x, w, bias, out, ref, exact, mag, wide
    torch.cuda.empty_cache()

    # the step's launches over several weights (q/k/v, k without a bias;
    # the mel and stop heads, 16-byte and value-at-a-time tiles in one
    # launch) and fc1 with the GELU in its epilogue, at b = 8 and 1: each
    # output within 1e-5 (sum |x w| + |b|) of its plain version; beside
    # them the separate launches they replace (the members one a launch;
    # fc1, then PyTorch's GELU), the plain versions, and the library's
    # separate addmm calls over widened weights (and its GELU)
    mx_groups = {"qkv": [(1280, True), (1280, False), (1280, True)],
                 "heads": [(320, True), (1, True)], "fc1_gelu": [(5120, True)]}
    for m in (FLAGSHIP_BATCH, 1):
        for name, spec in mx_groups.items():
            k, gelu = 1280, name == "fc1_gelu"
            x = 2 * torch.randn((m, k), generator=gen, device=dev)
            members = [((0.02 * torch.randn((k, n), generator=gen,
                                            device=dev)).to(bf),
                        (0.1 * torch.randn(n, generator=gen,
                                           device=dev)).to(bf) if has_b
                        else None) for n, has_b in spec]
            wides = [(w.float(), None if b is None else b.float())
                     for w, b in members]

            def launch():
                return _launch_group(x, members, gelu=gelu)

            def separate():
                if gelu:
                    w, b = members[0]
                    return [torch.nn.functional.gelu(mixed_linear(x, w, b))]
                return [mixed_linear(x, w, b) for w, b in members]

            def plain():
                return [mixed_linear_plain(x, w, b, gelu) for w, b in members]

            def library():
                ys = [torch.mm(x, w) if b is None else torch.addmm(b, x, w)
                      for w, b in wides]
                return ([torch.nn.functional.gelu(y) for y in ys] if gelu
                        else ys)

            outs = (mixed_linear_group(x, members) if not gelu
                    else [mixed_linear(x, *members[0], gelu=True)])
            refs = plain()
            torch.cuda.synchronize()
            ratio = 0.0
            for y, r, (w, b) in zip(outs, refs, members):
                mag = x.double().abs() @ w.double().abs()
                if b is not None:
                    mag = mag + b.double().abs()
                ratio = max(ratio, float(((y.double() - r.double()).abs()
                                          / (1e-5 * mag)).max()))
            ns = [w.shape[1] for w, _ in members]
            plan = plan_group(m, k, ns, mx_sms(dev))
            nbytes = 4 * m * k + sum(2 * k * n + 4 * m * n
                                     + (0 if b is None else 2 * n)
                                     for (w, b), n in zip(members, ns))
            b_ms, b_by = bound_ms(sum(2.0 * m * k * n for n in ns),
                                  PEAK_FP32, nbytes)
            row = {"phase": "kernel", "name": "mixed_linear", "group": name,
                   "m": m, "k": k, "n": ns, "gelu": gelu,
                   "tiles": plan.tiles, "splits": plan.splits,
                   "bar": "1e-5 (sum |x w| + |b|)", "tol_ratio": ratio,
                   "max_err": max(max_abs(y, r) for y, r in zip(outs, refs)),
                   "kernel_ms": graph_ms(launch, iters=50),
                   "separate_ms": graph_ms(separate, iters=50),
                   "eager_ms": time_ms(launch, iters=50),
                   "host_us": wrapper_us(launch),
                   "plain_ms": graph_ms(plain),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": graph_ms(library, iters=50)}
            copies = [[(w.clone(), b) for w, b in members]
                      for _ in range(min(64, 1 + int(64e6 // (
                          2 * k * sum(ns)))))]

            def cold():
                for mem in copies:
                    _launch_group(x, mem, gelu=gelu)

            row["cold_ms"] = graph_ms(cold, iters=2) / len(copies)
            del copies
            row["splits_ms"] = {s_: graph_ms(lambda: _launch_group(
                x, members, splits=s_, gelu=gelu), iters=50)
                for s_ in (1, 2, 4, 8)}
            row.update(mx_chain(m, k, members, gelu))
            emit(row)
            check(ratio <= 1.0, f"mixed_linear {name} m={m}: outside 1e-5 "
                  f"(sum |x w| + |b|) of plain ({ratio})")
            check(all(torch.equal(a, c) for a, c in zip(outs, launch())),
                  f"mixed_linear {name} m={m}: two launches differ")
            del x, members, wides, outs, refs
    torch.cuda.empty_cache()

    # a weight that the layer norm writes just before a programmatic call
    # (the norm lets its dependents start once its rows are read; the call
    # asks the L2 cache for the weight before its wait): bit-equal to the
    # call made after a synchronize, each round's weight where the last
    # one lay
    x = 2 * torch.randn((FLAGSHIP_BATCH, 1280), generator=gen, device=dev)
    scale = (0.05 * torch.randn(1280, generator=gen, device=dev)).to(bf)
    shift = (0.01 * torch.randn(1280, generator=gen, device=dev)).to(bf)
    srcs = [torch.randn((1280, 1280), generator=gen, device=dev).to(bf)
            for _ in range(8)]
    got = []
    for src in srcs:
        w = layer_norm_fused(src, scale, shift)
        got.append(mx_launch(x, w, None, pdl=True))
        del w
    torch.cuda.synchronize()
    same = []
    for src, y in zip(srcs, got):
        w = layer_norm_fused(src, scale, shift)
        torch.cuda.synchronize()
        same.append(torch.equal(y, mx_launch(x, w, None, pdl=False)))
    emit({"phase": "kernel", "name": "mixed_linear",
          "weight_written_just_before": same})
    check(all(same), f"mixed_linear: a weight written just before the "
          f"programmatic call was read stale ({same})")
    del x, srcs, got

    # the decode loops' condition kernel (the port's own: the while_loop's
    # cond, which the loop graphs' WHILE node tests on the card) against
    # its plain version at the flagship's lanes: the trip count and the
    # value it sets, for done and live lanes, before, at and past the limit
    from janus_tpu_torch.ops.loop_graph import KERNEL as LOOP
    from janus_tpu_torch.ops.loop_graph import (loop_condition,
                                                loop_condition_plain)

    errs = []
    for p in (0.0, 0.5, 1.0):
        done = torch.rand(FLAGSHIP_BATCH, generator=gen, device=dev) < p
        for trips, limit, add in ((0, 23, 0), (22, 23, 1), (5, 255, 1),
                                  (255, 255, 0)):
            t = torch.tensor(trips, dtype=torch.int32, device=dev)
            got = loop_condition(done, t.clone(), limit, add)
            want = loop_condition_plain(done, t, limit, add)
            errs.append(max(abs(int(got[0]) - int(want[0])),
                            abs(int(got[1]) - int(want[1]))))
    done = torch.zeros(FLAGSHIP_BATCH, dtype=torch.bool, device=dev)
    t = torch.zeros((), dtype=torch.int32, device=dev)
    # the flags and the count read, the count and the value written; a
    # test a lane
    b_ms, b_by = bound_ms(FLAGSHIP_BATCH, PEAK_FP32, FLAGSHIP_BATCH + 12)
    row = {"phase": "kernel", "name": "loop_graph", "batch": FLAGSHIP_BATCH,
           "max_err": float(max(errs)), "cases": len(errs),
           "kernel_ms": graph_ms(lambda: loop_condition(done, t, 1 << 30,
                                                        1), iters=50),
           "eager_ms": time_ms(lambda: loop_condition(done, t, 1 << 30, 1),
                               iters=50),
           "host_us": wrapper_us(lambda: loop_condition(done, t, 1 << 30,
                                                        1)),
           "plain_ms": graph_ms(lambda: loop_condition_plain(
               done, t, 1 << 30, 1), iters=50),
           "bound_ms": b_ms, "bound_by": b_by,
           # no PyTorch call sets a graph's conditional handle
           "library_ms": None}
    emit(row)
    check(row["max_err"] == 0, f"loop_graph: the condition kernel differs "
          f"from its plain version ({errs})")
    summary["loop_graph"] = row
    del done, t

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
    demo_int8_launches = {}
    for mode in ("weight", "dynamic"):
        CROSS.launches = INT8.launches = 0
        transcripts = demo_packets(int8_cfg,
                                   quantize_tree(demo_params, mode=mode))
        check(CROSS.launches > 0, f"int8 demo ({mode}) never launched K4")
        # the dynamic weights take the int8 linear, the weight-only ones
        # the dense product over the dequantized weight
        check((INT8.launches > 0) == (mode == "dynamic"),
              f"int8 demo ({mode}) launched the int8 linear "
              f"{INT8.launches} times")
        demo_int8_launches[mode] = INT8.launches
        emit({"phase": "demo_int8", "mode": mode,
              "packets_byte_equal_cpu": True,
              "cross_attn_int8_launches": CROSS.launches,
              "int8_linear_launches": INT8.launches,
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
    # the 2 s bucket too, for the one-phrase encode of the front's turns
    fenc = SemanticEncoder(fcfg, buckets=(SESSION_BUCKET, bucket),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    phrases = [voiced_phrase(f0=140.0 + 15 * i, seconds=FLAGSHIP_SECONDS,
                             amp=0.12, seed=i)
               for i in range(FLAGSHIP_BATCH)]
    fenc.encode_batch(phrases)  # warm-up: cuBLAS/cuDNN handles, allocator

    kernels = (MEL, FLASH, YIN, CROSS, LNORM, DECODE, INT8, MIXED, LOOP)
    for k in kernels:
        k.launches = 0
    loop_base = sum(lp.runs + lp.trips_run
                    for lp in fenc._graphs.loops("greedy"))
    trips_base = sum(lp.trips_run for lp in fenc._graphs.loops("greedy"))
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
    # every replayed step: 3 layer norms a layer and the final one, the
    # self- and the cross-attention of each layer
    n_dec = fcfg.asr.decoder_layers
    step_counts = [{k.name: n[0] for k, n in g.counts.items()}
                   for g in fenc._graphs.graphs("greedy")]
    check(step_counts and all(c == {"layer_norm": 3 * n_dec + 1,
                                    "decode_attn": 2 * n_dec}
                              for c in step_counts),
          f"flagship: the captured steps launch {step_counts}")
    check(launches["layer_norm"] > 0 and launches["decode_attn"] > 0
          and launches["int8_linear"] == 0, f"flagship launches {launches}")
    # the loop's condition: once before its WHILE node, once after each
    # body that ran (24 tokens: 23 bodies under random weights, no eot)
    loops = fenc._graphs.loops("greedy")
    check(launches["loop_graph"] == sum(lp.runs + lp.trips_run
                                        for lp in loops) - loop_base
          and launches["decode_attn"] == 2 * n_dec * (
              sum(lp.trips_run for lp in loops) - trips_base + 1),
          f"flagship: launches {launches} for the loop's "
          f"{sum(lp.trips_run for lp in loops) - trips_base} bodies")
    check(len(results) == FLAGSHIP_BATCH
          and all(np.isfinite(r["f0"]) and np.isfinite(r["rms"])
                  and r["f0"] > 0 for r in results),
          f"flagship results {results}")

    # end to end with the decode replayed from its graph and eagerly, in
    # turns on the same phrases: the same results
    fenc_eager = SemanticEncoder(fcfg, fenc.params, buckets=(bucket,),
                                 device="cuda", eager=True)
    e2e, e2e_eager = [], []
    for eager in (False, True, False, True, False):
        res, ms = synced_ms(torch, lambda: (fenc_eager if eager else fenc)
                            .encode_batch(phrases))
        (e2e_eager if eager else e2e).append(ms)
        check(res == results, f"flagship: the {'eager' if eager else 'graph'}"
              f" encode gives {res}, the first {results}")

    # the front (everything before the greedy loop): one replay of its
    # capture against its ops issued from Python, bit for bit, in turns at
    # b 8 x 10 s and at one 2 s phrase; the host's calls of each; one
    # replayed front traced
    from janus_tpu_torch.tools.trace_step import trace_front

    one = [voiced_phrase(f0=150.0, seconds=2.0, amp=0.12, seed=0)]
    front = {"bits_b8": front_bits(torch, fenc, phrases, "flagship"),
             "bits_b1": front_bits(torch, fenc, one, "flagship b1"),
             "turns_b8_ms": front_turns(torch, fenc, phrases, "flagship"),
             "turns_b1_2s_ms": front_turns(torch, fenc, one, "flagship b1"),
             "encode_host_calls": front_host_calls(torch, fenc, bucket,
                                                   FLAGSHIP_BATCH),
             "encode_host_calls_b1": front_host_calls(torch, fenc,
                                                      SESSION_BUCKET, 1),
             "trace_b8": trace_front(fenc, bucket, FLAGSHIP_BATCH),
             "trace_b1_2s": trace_front(fenc, SESSION_BUCKET, 1),
             "fronts": check_fronts("flagship", fenc)}
    calls = front["encode_host_calls"]["captured"]
    check(calls["device_events"] in (None, 0) or calls["host_calls"] == 1,
          f"flagship: a replayed front made {calls['host_calls']} host calls")

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
            max_new=acfg.max_decode_tokens, cache_dtype=torch.bfloat16,
            graphs=fenc._graphs))
    eager_tokens = stage("decode_eager", lambda: asr_mod.greedy_decode(
        fenc.params, acfg, enc, prompt, fenc.tokenizer.eot,
        max_new=acfg.max_decode_tokens, cache_dtype=torch.bfloat16,
        eager=True))
    check(torch.equal(dense_tokens, eager_tokens), "flagship: the replayed "
          "decode's tokens differ from the eager loop's")

    decode_step = profile_decode_step(torch, asr_mod, fenc.params, acfg, enc,
                                      prompt)
    with fenc._graphs.lock:
        decode_step_graph = profile_graph_step(torch, asr_mod.greedy_graph(
            fenc._graphs, fenc.params, acfg, FLAGSHIP_BATCH, enc.shape[-2],
            enc.dtype, 1, acfg.max_decode_tokens, torch.bfloat16, False,
            fenc.tokenizer.eot, dev))

    # the captured step issues at most 460 kernels (2551 before the decode
    # steps' kernels, 596 before the residual adds went into the norms and
    # the cache writes into the attention), no add over floating values and
    # no index_copy_ but the output column's; the tied head's fp32 table,
    # made once for the tree
    check(decode_step_graph["device_events"] is None
          or (decode_step_graph["device_events"] <= 460
              and decode_step_graph["float_adds"] == 0
              and decode_step_graph["index_copies"] <= 1),
          f"flagship: the replayed step ran "
          f"{decode_step_graph['device_events']} kernels, "
          f"{decode_step_graph['float_adds']} float adds, "
          f"{decode_step_graph['index_copies']} index copies")
    head = fenc._graphs.derived("asr_head_fp32", None)
    head_gib = (head.numel() * head.element_size() / 2 ** 30
                if head is not fenc.params["decoder"]["token_emb"] else 0.0)

    # encoder output against a pass through the plain versions on the card
    with mock.patch.object(asr_mod, "log_mel_spectrogram_fused",
                           lambda audio, **kw: log_mel_spectrogram(audio,
                                                                   **kw)), \
            mock.patch.object(asr_mod, "flash_attention",
                              lambda q, k, v: attend(q, k, v)), \
            mock.patch.object(asr_mod, "add_layer_norm",
                              lambda x, d, scale, bias, eps=1e-5: (
                                  x + d, layer_norm_plain(x + d, scale, bias,
                                                          eps))):
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
          "e2e_ms": e2e, "e2e_eager_ms": e2e_eager,
          "rtf": best / 1e3 / audio_s,
          "stage_ms": {k: min(v) for k, v in stage_ms.items()},
          "peak_mem_gib": peak_gib, "launches": launches,
          "encoder_vs_plain_max_abs": float(diff.abs().max()),
          "encoder_vs_plain_rel": rel, "decode_step": decode_step,
          "decode_step_graph": decode_step_graph,
          "captured_step_launches": step_counts[0],
          "head_fp32_gib": head_gib,
          "graph": graph_stats(fenc._graphs), "front": front,
          "graph_tokens_equal_eager": True, "nvidia_smi": nvidia_smi_line(),
          "texts": [r["text"] for r in results][:2],
          "f0": [r["f0"] for r in results]})

    # -- 4b. whisper_dropin: a BPE pair, the importer, a 4-token prompt ---
    dropin_launches = whisper_dropin(torch, kernels, fenc.params, fcfg,
                                     phrases)

    # -- 5. flagship int8: dynamic-int8 weights, int8 cross K/V ------------
    from janus_tpu_torch.models.params import cast_floating, init_asr

    eot = fenc.tokenizer.eot
    flagship_asr_params = fenc.params  # reused by duplex_flagship
    del fenc, fenc_eager
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

    all_kernels = kernels
    for k in all_kernels:
        k.launches = 0
    fronts0 = sum(h.graph.replays for h in qenc._graphs.holders("encode"))
    steps0 = qenc._graphs.steps
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(asr_mod, "_decoder_forward", counted_forward):
        q_results = qenc.encode_batch(phrases)
    torch.cuda.synchronize()
    q_first_ms = 1e3 * (time.perf_counter() - t0)
    q_launches = {k.name: k.launches for k in all_kernels}
    q_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # the prefill's forward runs in the front's replay, every step in the
    # loop graph's bodies (their trips read back at the harvest)
    forwards[0] += (sum(h.graph.replays for h in qenc._graphs.holders(
        "encode")) - fronts0) + (qenc._graphs.steps - steps0)
    q_step_counts = {k.name: n[0] for g in qenc._graphs.graphs("greedy")
                     for k, n in g.counts.items()}
    check(q_launches["mel_fused"] >= 1, f"int8 mel launches {q_launches}")
    check(q_launches["flash_attn"] == qcfg.asr.encoder_layers,
          f"int8 flash_attn launches {q_launches}")
    check(q_launches["yin_block_sums"] >= 1, f"int8 yin {q_launches}")
    # K4 takes the cross-attention: the decode kernel the self-attention;
    # the int8 linear the six linears of each layer
    check(q_step_counts == {"cross_attn_int8": qcfg.asr.decoder_layers,
                            "layer_norm": 3 * qcfg.asr.decoder_layers + 1,
                            "decode_attn": qcfg.asr.decoder_layers,
                            "int8_linear": 6 * qcfg.asr.decoder_layers},
          f"the captured int8 step launches {q_step_counts}")
    check(q_launches["int8_linear"] > 0, f"int8 launches {q_launches}")
    check(forwards[0] > 1 and q_launches["cross_attn_int8"]
          == qcfg.asr.decoder_layers * forwards[0],
          f"cross_attn_int8 launches {q_launches} for {forwards[0]} "
          f"decoder forwards")
    check(len(q_results) == FLAGSHIP_BATCH
          and all(np.isfinite(r["f0"]) and np.isfinite(r["rms"])
                  for r in q_results), f"int8 flagship results {q_results}")

    qenc_eager = SemanticEncoder(qcfg, qenc.params, buckets=(bucket,),
                                 device="cuda", eager=True)
    q_e2e, q_e2e_eager = [], []
    for eager in (False, True, False, False):
        res, ms = synced_ms(torch, lambda: (qenc_eager if eager else qenc)
                            .encode_batch(phrases))
        (q_e2e_eager if eager else q_e2e).append(ms)
        check(res == q_results, f"flagship_int8: the "
              f"{'eager' if eager else 'graph'} encode gives {res}, the "
              f"first {q_results}")
    del qenc_eager
    q_front = {"bits_b8": front_bits(torch, qenc, phrases, "flagship_int8"),
               "turns_b8_ms": front_turns(torch, qenc, phrases,
                                          "flagship_int8"),
               "encode_host_calls": front_host_calls(torch, qenc, bucket,
                                                     FLAGSHIP_BATCH),
               "fronts": check_fronts("flagship_int8", qenc)}

    # the two stages the int8 weights and K/V change, three times each as
    # phase 4 times them (the eager decode once)
    stage_ms = {}
    for _ in range(3):
        q_enc = stage("encoder", lambda: asr_mod.encode_audio(
            qenc.params, acfg, mel.to(torch.bfloat16)))
        q_tokens = stage("decode", lambda: asr_mod.greedy_decode(
            qenc.params, acfg, q_enc, prompt, eot,
            max_new=acfg.max_decode_tokens, cache_dtype=torch.bfloat16,
            cross_kv_int8=True, graphs=qenc._graphs))
    q_tokens_eager = stage("decode_eager", lambda: asr_mod.greedy_decode(
        qenc.params, acfg, q_enc, prompt, eot,
        max_new=acfg.max_decode_tokens, cache_dtype=torch.bfloat16,
        cross_kv_int8=True, eager=True))
    check(torch.equal(q_tokens, q_tokens_eager), "flagship_int8: the "
          "replayed decode's tokens differ from the eager loop's")
    q_decode_step = profile_decode_step(torch, asr_mod, qenc.params, acfg,
                                        q_enc, prompt, cross_kv_int8=True)
    with qenc._graphs.lock:
        q_decode_step_graph = profile_graph_step(torch, asr_mod.greedy_graph(
            qenc._graphs, qenc.params, acfg, FLAGSHIP_BATCH,
            q_enc.shape[-2], q_enc.dtype, 1, acfg.max_decode_tokens,
            torch.bfloat16, True, eot, dev))
    # the int8 step's caches are written by the decode attention too; two
    # launches an int8 linear (593 kernels a step; 3664 before its kernel)
    check(q_decode_step_graph["device_events"] is None
          or (q_decode_step_graph["index_copies"] <= 1
              and q_decode_step_graph["device_events"] <= 600),
          f"flagship_int8: the replayed step ran "
          f"{q_decode_step_graph['device_events']} kernels, "
          f"{q_decode_step_graph['index_copies']} index copies")
    # the same step with the linear as it ran before its kernel (the eager
    # quantization, torch._int_mm on row-major weights, the rescale),
    # captured over a row-major copy of the weights: the trace to hold the
    # new one against
    from janus_tpu_torch.ops import layers as layers_mod
    from janus_tpu_torch.runtime.step_graph import StepGraphs

    rows_params, before_graphs = row_major(qenc.params), StepGraphs()
    with mock.patch.object(layers_mod, "linear_int8_dynamic",
                           lambda x, w, b=None: int8_linear_before(
                               torch, x, w, b)), before_graphs.lock:
        q_decode_step_before = profile_graph_step(torch, asr_mod.greedy_graph(
            before_graphs, rows_params, acfg, FLAGSHIP_BATCH,
            q_enc.shape[-2], q_enc.dtype, 1, acfg.max_decode_tokens,
            torch.bfloat16, True, eot, dev))
    del rows_params, before_graphs
    torch.cuda.empty_cache()

    # every K4 call of that step against the plain version on the same
    # inputs, at the kernel phase's bf16 bar (one bf16 ulp)
    checked_cross, on_path = checked_cross_attention()

    def plain_fp64(q, k, v):
        """The plain version's arithmetic in float64: the control."""
        s = torch.matmul(q.double(), k.q.double()) * q.shape[-1] ** -0.5
        p = torch.exp(s * k.scale[..., None, :].double()
                      - (s * k.scale[..., None, :].double()).amax(
                          -1, keepdim=True))
        o = torch.matmul(p * v.scale[..., None, :].double(),
                         v.q.double().transpose(-1, -2))
        return (o / p.sum(-1, keepdim=True)).to(q.dtype)

    def step_logits(cross=None):
        return first_step_logits(torch, qenc.params, acfg, q_enc, prompt,
                                 cross)

    logits_k = step_logits()
    logits_c = step_logits(checked_cross)
    logits_p = step_logits(cross_attention_int8_plain)
    logits_64 = step_logits(plain_fp64)
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
          "e2e_ms": q_e2e, "e2e_eager_ms": q_e2e_eager,
          "rtf": min(q_e2e) / 1e3 / audio_s,
          "captured_step_launches": q_step_counts,
          "graph": graph_stats(qenc._graphs), "front": q_front,
          "graph_tokens_equal_eager": True, "nvidia_smi": nvidia_smi_line(),
          "decode_step_graph": q_decode_step_graph,
          "decode_step_graph_before": q_decode_step_before,
          "stage_ms": {k: min(v) for k, v in stage_ms.items()},
          "stage_ms_all": stage_ms,
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
    # the receive side runs the decode steps' kernels (layer norm, decode
    # attention) in its prefill and AR steps
    receive_launches = {}
    for name, run in (("receive_demo", lambda: receive_demo(torch, dev)),
                      ("receive_flagship", lambda: receive_flagship(
                          torch, dev)),
                      ("receive_stream", lambda: receive_stream(
                          torch, dev, *flagship_tts))):
        reset_launches(all_kernels)
        got = run()
        if name == "receive_flagship":
            flagship_tts = got
        receive_launches[name] = read_launches(all_kernels)
        check(receive_launches[name]["layer_norm"] > 0
              and receive_launches[name]["decode_attn"] > 0,
              f"{name} launches {receive_launches[name]}")
    check(not errors.records, f"the synthesizer logged errors: "
          f"{errors.records}")
    torch.cuda.empty_cache()

    # -- 8b. device_loop: the loops' exits on the card, the submit ---------
    receive_launches["device_loop"] = device_loop(
        torch, all_kernels, flagship_asr_params, fcfg, flagship_tts[0],
        flagship_tts[2])
    torch.cuda.empty_cache()

    # -- 9-10. the live duplex link ----------------------------------------
    for name in ("runtime.engine", "tools.receiver_main",
                 "tools.sender_main"):
        logging.getLogger(f"janus_tpu_torch.{name}").addHandler(errors)
    duplex_demo(torch, all_kernels)
    duplex_flagship(torch, all_kernels, flagship_asr_params, *flagship_tts)
    check(not errors.records, f"the duplex loops logged errors: "
          f"{errors.records}")
    del flagship_tts
    torch.cuda.empty_cache()

    # -- 11-12. the serving surface ----------------------------------------
    by_phase = {"flagship": launches,
                "demo_int8": {"int8_linear": demo_int8_launches["dynamic"]},
                "flagship_int8": {k: q_launches[k] for k in (
                    "cross_attn_int8", "layer_norm", "decode_attn",
                    "int8_linear")},
                **dropin_launches, **receive_launches}
    by_phase["sessions_flagship"] = sessions_flagship(
        torch, all_kernels, flagship_asr_params)
    by_phase.update(profile_tools(torch, all_kernels, flagship_asr_params,
                                  fcfg))
    del flagship_asr_params
    torch.cuda.empty_cache()
    by_phase["server_demo"] = server_demo(torch, all_kernels)

    # -- 14-16. training and the evaluation gates ---------------------------
    by_phase["train_demo"] = train_demo(torch, all_kernels)
    by_phase["train_flagship"], train_losses = train_flagship(
        torch, all_kernels)
    by_phase["zoo_gates"] = zoo_gates(torch, all_kernels)

    # -- 17-18. the parallel layouts ---------------------------------------
    by_phase["parallel_flagship"] = parallel_flagship(torch, all_kernels,
                                                      train_losses)
    by_phase["parallel_ranks"] = parallel_ranks(torch)

    # every process this script started has ended: the kernel builds, the
    # ranks, and the forkserver and resource tracker behind them
    from janus_tpu_torch.parallel.launch import stop_rank_server

    stop_rank_server()
    check(not child_processes(),
          f"processes left running: {child_processes()}")

    # -- 19. kernels summary -----------------------------------------------
    # launches: K1-K3 from the flagship run, the receive phases, the tick
    # loop's overlapped run, the two tools, the card's server run, the
    # training phases, the gates and the parallel phases; K4 from the int8
    # flagship run and flagship_check --int8; the layer norm and the decode
    # attention from every phase that ran them; the int8 linear from the
    # dynamic int8 demo, the drop-in's int8 encode and the int8 flagship
    line = []
    for k in all_kernels:
        row = summary[k.name]
        counts = {p: c[k.name] for p, c in by_phase.items() if k.name in c}
        line.append({"name": k.name, "route": "cuda",
                     "source": f"janus_tpu_torch/csrc/{k.name}.cu",
                     "replaces": k.replaces,
                     "launches": sum(counts.values()),
                     "launches_by_phase": counts,
                     "max_abs_err": row["max_err"], "ms": row["kernel_ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    check(all(k["launches"] > 0 for k in line),
          f"a kernel of the path was never launched: "
          f"{[(k['name'], k['launches']) for k in line]}")
    emit({"kernels": line})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
