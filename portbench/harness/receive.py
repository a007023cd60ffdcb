"""What the receive drivers share: the synthesizer under test built from
the configuration, the seed's packets, the failure rule, the sampling
of finished packets, and the comparison of served mel groups and PCM
with the plain reference.

Each served packet's PCM is judged twice: the reference, run
teacher-forced over the packet's prompt and the mel groups the program
served, predicts each group (``mel_gap``: the widest deviation over the
packet, in units of the reference's RMS over it), and the reference
vocoder, inverse STFT and upsampler turn the program's mel into 48 kHz
samples (``pcm_gap``: the widest deviation, full scale 1). The program's
mel is its own state: a sampled packet is served again after the
window, and its PCM must equal the window's bit for bit
(``rerun_mismatch``) before its mel is read.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from portbench.harness import weights as W
from portbench.harness import work

__all__ = ["Program", "build", "packets", "warm_packets", "cap_samples",
           "ErrorCount", "sample", "numbers", "tts_dims", "vocoder_dims",
           "window_work", "least_s", "check", "compared"]

SR = 48_000


def tts_dims(config: dict) -> dict:
    return dict(config["tts"])


def vocoder_dims(config: dict) -> dict:
    return dict(config["vocoder"])


class Program:
    """A receive cell's program under test: the synthesizer, the weights
    both sides read, the error counter, the seed's packets, and the PCM
    the window served."""

    def __init__(self, syn, tt, vt, errors, packets):
        self.syn, self.tt, self.vt, self.errors = syn, tt, vt, errors
        self.packets = packets
        self.pcm: list = []
        self.mismatch = 0


class ErrorCount(logging.Handler):
    """Counts the program's ERROR records: its synthesizer degrades a
    failure to a fallback or to empty audio and logs it."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.count = 0

    def emit(self, record):
        self.count += 1


def build(ctx):
    """``(synthesizer, tts tree, vocoder tree, errors)``: the program on
    the configuration's widths and weights (bfloat16, the stop head's
    bias the configuration's constant), speaker-free."""
    from janus_tpu_torch.common.config import (JanusConfig, TTSConfig,
                                               VocoderConfig)
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    c, port = ctx.config, ctx.config["port"]
    t, v = tts_dims(c), vocoder_dims(c)
    dtype = getattr(torch, c["dtype"])
    tcfg = TTSConfig(dtype=c["dtype"], **t)
    vcfg = VocoderConfig(dtype=c["dtype"], **v)
    cfg = JanusConfig().override(tts=tcfg, vocoder=vcfg)
    tt = W.make_tree(W.tts_leaves(t, port["text_vocab"], port["stop_bias"]),
                     port["weight_seed"], ctx.device, dtype)
    vt = W.make_tree(W.vocoder_leaves(v, t["n_mels"]),
                     port["weight_seed"] + 1, ctx.device, dtype)
    syn = Synthesizer(cfg, tts_params=tt, vocoder_params=vt,
                      device=ctx.device)
    if syn.tokenizer.vocab_size != port["text_vocab"] \
            or syn.tokenizer.pad != port["pad"]:
        raise ValueError("the program's text vocabulary differs from the "
                         "configuration's")
    errors = ErrorCount()
    logging.getLogger("janus_tpu_torch").addHandler(errors)
    return syn, tt, vt, errors


def packets(ctx):
    """The seed's packets as the program's ``JanusPacket``."""
    from janus_tpu_torch.common.protocol import JanusPacket
    from portbench.harness import traffic as T

    for p in T.packets(ctx.traffic, ctx.seed):
        yield p, JanusPacket(text=p["text"], prosody={
            "pitch": p["pitch"], "energy": p["energy"]})


def warm_packets(ctx):
    """One packet a text bucket of the traffic, at the longest text the
    traffic sends in it: every shape of the cell before the window."""
    from janus_tpu_torch.common.protocol import JanusPacket
    from portbench.harness import traffic as T

    rng = np.random.default_rng([ctx.seed, 6])
    lo, hi = ctx.traffic["text_bytes"]
    for b in buckets(ctx):
        n = max(k for k in range(lo, hi + 1)
                if text_bucket(k, tts_dims(ctx.config)["max_text_tokens"]) == b)
        yield JanusPacket(text=T.text_of(n, rng),
                          prosody={"pitch": "Normal", "energy": "Normal"})


def cap_samples(ctx, text: str) -> int:
    """The audio a packet delivers: the duration cap of its text (the stop
    head never fires under the configuration's stop bias)."""
    t = tts_dims(ctx.config)
    n = min(len(text.encode()), t["max_text_tokens"])
    return int((0.35 + ctx.config["port"]["seconds_per_text_byte"] * n) * SR)


def text_bucket(n: int, max_text: int) -> int:
    b = 8
    while b < n and b < max_text:
        b *= 2
    return min(b, max_text)


def buckets(ctx) -> list:
    lo, hi = ctx.traffic["text_bytes"]
    t = tts_dims(ctx.config)
    return sorted({text_bucket(n, t["max_text_tokens"])
                   for n in range(lo, hi + 1)})


def sample(ctx, records) -> list:
    """Finished packets drawn from the seed, the longest of them first."""
    done = [i for i, r in enumerate(records) if r["ok"]]
    if not done:
        return []
    longest = max(done, key=lambda i: (len(records[i]["text"]), -i))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([ctx.seed, 5])
    n = min(ctx.traffic["sample_packets"] - 1, len(rest))
    return [longest] + sorted(int(i) for i in rng.choice(rest, n,
                                                         replace=False))


def numbers(ctx, tt, vt, served: list, weights=None) -> dict:
    """``served``: ``(packet dict, pcm int16 array, mel [frames, n_mels]
    float32, groups generated)`` of each sampled packet. With
    ``weights`` (a lower-precision map of the weight matrices) the
    reference put in the program's place: its predictions and PCM over
    the same groups are judged instead of the program's."""
    from portbench.harness.precision import fp32_exact
    from portbench.reference import tts as rtts

    t, v, port = tts_dims(ctx.config), vocoder_dims(ctx.config), \
        ctx.config["port"]
    r_mels = t["reduction"] * t["n_mels"]
    mel_gap = pcm_gap = 0.0
    err2 = ref2 = 0.0
    groups_seen = 0
    with fp32_exact():
        for pkt, pcm, mel, n_groups in served:
            text = pkt["text"].encode()[:t["max_text_tokens"]]
            tag = rtts.emotion_tag(pkt["pitch"], pkt["energy"])
            prompt = rtts.prompt_ids(
                text, text_bucket(len(text), t["max_text_tokens"]), tag,
                port["text_vocab"], port["pad"])
            mel = mel.to(ctx.device)
            groups = mel[:n_groups * t["reduction"]].reshape(n_groups, r_mels)
            ref = rtts.predict_groups(tt, t["num_heads"], prompt, groups,
                                      t["max_text_tokens"] + 3)
            got = groups
            if weights is not None:
                got = rtts.predict_groups(tt, t["num_heads"], prompt, groups,
                                          t["max_text_tokens"] + 3, weights)
            rms = float(ref.pow(2).mean().sqrt())
            mel_gap = max(mel_gap, float((got - ref).abs().max()) / rms)
            err2 += float((got - ref).pow(2).sum())
            ref2 += float(ref.pow(2).sum())
            groups_seen += n_groups
            want = rtts.pcm48(vt, v["n_fft"], v["hop_length"], mel)
            want = want[:len(pcm)].clamp(-1.0, 1.0)
            if weights is None:
                have = torch.from_numpy(pcm.astype(np.float64) / 32767.0)
            else:
                have = rtts.pcm48(vt, v["n_fft"], v["hop_length"], mel,
                                  weights)[:len(pcm)].clamp(-1.0, 1.0)
            pcm_gap = max(pcm_gap, float((have.to(want.device) - want)
                                         .abs().max()))
    return {"mel_gap": mel_gap, "mel_rms_gap": (err2 / max(ref2, 1e-30)) ** 0.5,
            "pcm_gap": pcm_gap, "groups": groups_seen}


def window_work(ctx, prompts: list, steps: int, frames: list) -> dict:
    """Least work of the passes completed: a prefill of each request's
    prompt rows, the AR steps the program counted (at their mean cache
    fill, exact for the bytes, which grow linearly with it), the vocoder
    over each request's vocoded frames."""
    t, v = tts_dims(ctx.config), vocoder_dims(ctx.config)
    tally = work.Tally()
    for p in prompts:
        tally.add(work.tts_prefill(t, p))
    for f in frames:
        tally.add(work.vocoder_pass(v, t["n_mels"], f))
    if prompts and steps:
        fill = sum(prompts) / len(prompts) + steps / len(prompts) / 2 + 0.5
        tally.add(work.ar_step(t, 1, int(round(fill))), steps)
    return tally.as_dict()


def least_s(ctx, prompts: list, steps: list) -> dict:
    """Least time of the kernels the readers hold to their rooflines,
    over packets of ``prompts`` rows that ran ``steps`` AR steps each:
    the decode attention (every layer, each step at its cache fill) and
    the step's mixed linears."""
    t = tts_dims(ctx.config)
    dh = t["d_model"] // t["num_heads"]
    attn = sum(t["layers"] * work.least_s(work.decode_attention(
        1, t["num_heads"], 1, dh, p + g, q_bytes=4, kv_bytes=2,
        new_kv=True)) for p, n in zip(prompts, steps)
        for g in range(1, n + 1))
    linear = sum(work.least_s(work.mixed_linear(r, k, n, bias=b))
                 for r, k, n, b in work.ar_step_mixed_linears(t))
    return {"decode_attn": attn, "mixed_linear": sum(steps) * linear}


def check(ctx, program, records, collect):
    """``collect``'s packets through the reference once the program's
    state is freed (the weights, which both sides read, stay)."""
    served = collect(ctx, program, records)
    tt, vt = program.tt, program.vt
    program.syn = program.pcm = program.packets = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return compared(ctx, program, records, numbers(ctx, tt, vt, served))


def compared(ctx, program, records, nums) -> list:
    """``[(name, value, limit)]``: the failed requests, the re-served
    packets whose PCM differs, and the traffic's limits."""
    ctx.log(f"reference: {nums['groups']} served mel groups compared")
    failed = sum(1 for r in records if not r["ok"])
    limits = ctx.traffic["limits"]
    return [("failed_requests", float(failed), 0.0),
            ("rerun_mismatch", float(program.mismatch), 0.0)] + [
        (k, nums[k], limits[k]) for k in limits]


def reseed(ctx, program) -> None:
    """Point the program's packets at ``ctx.seed``."""
    program.packets = packets(ctx)
    program.pcm = []


def control_numbers(ctx, program, served, control: bool = False) -> dict:
    """The numbers of ``served``; with ``control`` those of the reference
    with fp8 weights put in the program's place (and, beside them under
    ``int8``, with int8 weights)."""
    from portbench.reference.quant import fp8_weight, int8_weight

    if not control:
        return numbers(ctx, program.tt, program.vt, served)
    out = numbers(ctx, program.tt, program.vt, served, fp8_weight)
    out["int8"] = numbers(ctx, program.tt, program.vt, served, int8_weight)
    return out
