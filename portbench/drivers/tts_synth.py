"""The receive path without streaming: ``Synthesizer.synthesize(packet)``
(the receiver's path with streaming playback off), one packet at a time.
Each synthesis runs the AR loop over the whole group budget whatever the
text, then the vocoder over it; the PCM is cut to the text's cap.

A request is one packet: from the call to its PCM on the host. Checked
against the plain reference as :mod:`portbench.harness.receive` sets
out.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import receive as R
from portbench.harness.trace import note, profiled


def _holder(program, text: str):
    t = program.syn.cfg.tts
    return program.syn.synth_graph(
        R.text_bucket(len(text.encode()), t.max_text_tokens), 1, None)


def prepare(ctx) -> R.Program:
    syn, tt, vt, errors = R.build(ctx)
    if ctx.device.type == "cuda":
        with torch.no_grad(), syn._graphs.lock:
            for bucket in R.buckets(ctx):
                syn.synth_graph(bucket, 1, None)
    for packet in R.warm_packets(ctx):
        syn.synthesize(packet)
    return R.Program(syn, tt, vt, errors, R.packets(ctx))


def _steps(program) -> int:
    return program.syn._graphs.steps


def window(ctx, program, seconds):
    records = []
    steps0, errors0 = _steps(program), program.errors.count
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        p, packet = next(program.packets)
        before = program.errors.count
        t0 = time.perf_counter()
        pcm = program.syn.synthesize(packet)
        t_end = time.perf_counter()
        ok = (program.errors.count == before
              and len(pcm) == 2 * R.cap_samples(ctx, p["text"]))
        program.pcm.append(pcm)
        records.append({"t0": t0, "t_end": t_end,
                        "speech_s": len(pcm) / 2 / R.SR, "ok": ok,
                        "text": p["text"], "packet": p, "request": packet})
    window_s = time.perf_counter() - start
    t = R.tts_dims(ctx.config)
    prompts = [R.text_bucket(len(r["text"]), t["max_text_tokens"]) + 3
               for r in records]
    frames = [t["max_mel_frames"] // t["reduction"] * t["reduction"]] * len(
        records)
    steps = _steps(program) - steps0
    return records, window_s, {
        "steps": steps, "errors": program.errors.count - errors0,
        "work": R.window_work(ctx, prompts, steps, frames)}


def traced(ctx, program):
    """``trace_packets`` more packets under the profiler, each annotated
    (``request``). The readers get the AR steps (the loop bodies: the
    trace's orphans, a conditional node's body carrying no host launch)
    over the steps the program counted, and the least time of the
    kernels held to their rooflines (each packet's steps as the program
    counted them)."""
    t = R.tts_dims(ctx.config)
    steps0 = _steps(program)
    prompts, steps = [], []
    with profiled(ctx.device) as out:
        for k in range(ctx.traffic["trace_packets"]):
            p, packet = next(program.packets)
            prompts.append(R.text_bucket(len(p["text"]),
                                         t["max_text_tokens"]) + 3)
            before = _steps(program)
            with note("request"):
                program.syn.synthesize(packet)
            steps.append(_steps(program) - before)
    trace = out[0]
    return trace, {"spans": {"ar_step": ([trace.orphans],
                                         _steps(program) - steps0)},
                   "least_s": R.least_s(ctx, prompts, steps)}


def collect(ctx, program, records) -> list:
    """Each sampled packet served again (its PCM must equal the
    window's), with the mel the program generated for it."""
    picks = R.sample(ctx, records)
    served, mismatch = [], 0
    t = R.tts_dims(ctx.config)
    r = t["reduction"]
    for i in picks:
        rec = records[i]
        pcm = program.syn.synthesize(rec["request"])
        mismatch += int(pcm != program.pcm[i])
        h = _holder(program, rec["text"])
        with program.syn._graphs.lock:
            mel = h.ar.out[0, :h.ar.max_groups].reshape(
                -1, t["n_mels"]).to("cpu", copy=True).float()
        served.append((rec["packet"], np.frombuffer(program.pcm[i], np.int16),
                       mel, mel.shape[0] // r))
    program.mismatch = mismatch
    return served


def check(ctx, program, records):
    return R.check(ctx, program, records, collect)


numbers = R.control_numbers
compared = R.compared
reseed = R.reseed
