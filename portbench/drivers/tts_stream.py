"""The receive path as a listener gets it: ``Synthesizer.
synthesize_streaming(packet)``, one stream at a time, packet after
packet (a receiver working through its queue), in the program's own
chunks (``chunk_groups`` AR steps a chain launch).

A request is one packet: from the call to the last PCM chunk on the
host; its first audio is the first chunk on the host. Checked against
the plain reference as :mod:`portbench.harness.receive` sets out.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

from portbench.harness import receive as R
from portbench.harness.trace import note, profiled

FFT = re.compile(r"fft", re.IGNORECASE)


def _stream(syn, packet):
    """One packet: ``(t0, t_first, t_end, pcm bytes)``."""
    chunks = []
    t0 = time.perf_counter()
    t_first = None
    for chunk in syn.synthesize_streaming(packet):
        if t_first is None:
            t_first = time.perf_counter()
        chunks.append(chunk)
    t_end = time.perf_counter()
    return t0, t_first, t_end, b"".join(chunks)


def prepare(ctx) -> R.Program:
    syn, tt, vt, errors = R.build(ctx)
    streamer = syn.streamer()
    if ctx.device.type == "cuda":
        t = R.tts_dims(ctx.config)
        max_groups = t["max_mel_frames"] // t["reduction"]
        g = streamer.chunk_groups
        lengths = {min(g, max_groups - lo) for lo in range(1, max_groups, g)}
        with torch.no_grad(), streamer._graphs.lock:
            for bucket in R.buckets(ctx):
                h = streamer.ar_graph(bucket, None)
                for n in sorted(lengths - {1}):
                    h.chain(n)
            streamer.stream_graph()
    for packet in R.warm_packets(ctx):
        _stream(syn, packet)
    return R.Program(syn, tt, vt, errors, R.packets(ctx))


def _steps(program) -> int:
    return program.syn.streamer()._graphs.steps


def window(ctx, program, seconds):
    records = []
    steps0, errors0 = _steps(program), program.errors.count
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        p, packet = next(program.packets)
        before = program.errors.count
        t0, t_first, t_end, pcm = _stream(program.syn, packet)
        want = R.cap_samples(ctx, p["text"])
        ok = program.errors.count == before and len(pcm) == 2 * want
        program.pcm.append(pcm)
        records.append({"t0": t0, "t_first": t_first or t_end,
                        "t_end": t_end, "speech_s": len(pcm) / 2 / R.SR,
                        "ok": ok, "text": p["text"], "packet": p,
                        "request": packet})
    window_s = time.perf_counter() - start
    t = R.tts_dims(ctx.config)
    prompts = [R.text_bucket(len(r["text"]), t["max_text_tokens"]) + 3
               for r in records]
    hop48 = 2 * ctx.config["vocoder"]["hop_length"]
    frames = [-(-len(pcm) // 2 // hop48) for pcm in program.pcm]
    steps = _steps(program) - steps0
    return records, window_s, {
        "steps": steps, "errors": program.errors.count - errors0,
        "work": R.window_work(ctx, prompts, steps, frames)}


def traced(ctx, program):
    """``trace_packets`` more packets under the profiler, each annotated
    (``request``) and its first chunk's wait too (``first``). The readers
    get the AR steps (the chain launches: a request's graph launches
    after its prefill that hold no FFT kernel, which the emissions do)
    over the steps the program counted, the kernels before each first
    chunk, and the least time of the kernels held to their rooflines."""
    steps0 = _steps(program)
    prompts, steps = [], []
    t = R.tts_dims(ctx.config)
    with profiled(ctx.device) as out:
        for k in range(ctx.traffic["trace_packets"]):
            p, packet = next(program.packets)
            prompts.append(R.text_bucket(len(p["text"]),
                                         t["max_text_tokens"]) + 3)
            before = _steps(program)
            with note("request"):
                gen = program.syn.synthesize_streaming(packet)
                with note("first"):
                    next(gen)
                for _ in gen:
                    pass
            steps.append(_steps(program) - before)
    trace = out[0]
    requests = trace.notes_named("request")
    chains = [g for n in requests for g in trace.graph_launches(n)[1:]
              if not any(r["cat"] == "kernel" and FFT.search(r["name"])
                         for r in g)]
    firsts = [k for n in trace.notes_named("first")
              for k in [trace.kernels_under(n)] if k]
    return trace, {"spans": {"ar_step": (chains, _steps(program) - steps0),
                             "first_chunk": (firsts, len(firsts))},
                   "least_s": R.least_s(ctx, prompts, steps)}


def collect(ctx, program, records) -> list:
    """Each sampled packet served again (its PCM must equal the
    window's), with the mel the program generated for it."""
    picks = R.sample(ctx, records)
    served, mismatch = [], 0
    streamer = program.syn.streamer()
    t = R.tts_dims(ctx.config)
    r = t["reduction"]
    for i in picks:
        rec = records[i]
        _, _, _, pcm = _stream(program.syn, rec["request"])
        mismatch += int(pcm != program.pcm[i])
        with streamer._graphs.lock:
            mel = streamer.stream_graph().mel[0].to("cpu", copy=True)
        groups = mel.reshape(-1, r * t["n_mels"])
        n = int((groups.abs().sum(-1) > 0).nonzero().max()) + 1
        served.append((rec["packet"], np.frombuffer(program.pcm[i], np.int16),
                       mel, n))
    program.mismatch = mismatch
    return served


def check(ctx, program, records):
    return R.check(ctx, program, records, collect)


numbers = R.control_numbers
compared = R.compared
reseed = R.reseed
