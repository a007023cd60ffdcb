"""The send path under serving load: ``SemanticEncoder.
encode_batch_submit`` / ``PendingEncode.result`` with as many batches
in flight as the program's ``runtime.max_inflight_encodes`` (harvest the
oldest, then submit the next), phrases from the traffic's pool, one
duration bucket.

A request is one phrase: from its batch's submit call to its batch's
result on the host. Checked against the plain Whisper and DSP reference
(``portbench/reference``): each sampled batch is served again through
the same entry once the window has closed (its tokens must equal the
window's), and the program's own encoder output and decoder
self-attention caches are read from the encode's static buffers and
compared with the reference's as relative errors; beside them the
energy and pitch codes, the RMS of each phrase, and the widest gap by
which a served token's logit lies below the reference's best at its
position.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from portbench.harness import traffic as T
from portbench.harness import weights as W
from portbench.harness import work
from portbench.harness.trace import note, profiled

SR = 48_000


def model_dims(config: dict) -> dict:
    """The configuration's published keys under the harness's names."""
    return {"n_mels": config["num_mel_bins"], "d_model": config["d_model"],
            "encoder_layers": config["encoder_layers"],
            "decoder_layers": config["decoder_layers"],
            "num_heads": config["encoder_attention_heads"],
            "mlp_ratio": config["encoder_ffn_dim"] // config["d_model"],
            "vocab_size": config["vocab_size"],
            "max_source_positions": config["max_source_positions"],
            "max_target_positions": config["max_target_positions"]}


class Program:
    """The encoder under test, the weights both sides read, the seed's
    batches, and the encodes the program keeps in flight."""

    def __init__(self, encoder, tree, batches):
        self.encoder, self.tree, self.batches = encoder, tree, batches
        self.depth = encoder.cfg.runtime.max_inflight_encodes
        self.outputs: list = []
        self.mismatch = 0


def _dtype(config: dict):
    return getattr(torch, config["torch_dtype"])


def build_encoder(ctx, tree, quantized: bool = False):
    """The program: ``SemanticEncoder`` of the configuration's widths
    with the traffic's token budget and the port's defaults (int16 wire,
    default buckets and in-flight depth); ``quantized`` is its own
    dynamic-int8 path (int8 weights and cross K/V)."""
    from janus_tpu_torch.common.config import ASRConfig, JanusConfig
    from janus_tpu_torch.runtime.codec import SemanticEncoder

    m = model_dims(ctx.config)
    acfg = ASRConfig(n_mels=m["n_mels"], d_model=m["d_model"],
                     encoder_layers=m["encoder_layers"],
                     decoder_layers=m["decoder_layers"],
                     num_heads=m["num_heads"], mlp_ratio=m["mlp_ratio"],
                     vocab_size=m["vocab_size"],
                     max_source_positions=m["max_source_positions"],
                     max_target_positions=m["max_target_positions"],
                     max_decode_tokens=ctx.traffic["max_decode_tokens"],
                     dtype=ctx.config["torch_dtype"],
                     decode_cross_kv_int8=quantized)
    cfg = JanusConfig().override(asr=acfg)
    params = tree
    if quantized:
        from janus_tpu_torch.ops.quant import quantize_tree
        params = quantize_tree(tree, mode="dynamic")
    enc = SemanticEncoder(cfg, asr_params=params, device=ctx.device)
    port = ctx.config["port"]
    if (enc.tokenizer.sot_sequence() != port["prompt"]
            or enc.tokenizer.eot != port["eot"]):
        raise ValueError("the program's prompt or end token differs from "
                         "the configuration's")
    bucket = int(ctx.traffic["bucket_s"] * SR)
    if bucket not in enc.buckets:
        raise ValueError(f"bucket {bucket} is not one of the program's")
    return enc


def warm(ctx, enc, batches, n: int) -> None:
    """Capture the cell's one shape, then run ``n`` batches through the
    timed path."""
    if ctx.device.type == "cuda":
        with torch.no_grad(), enc._graphs.lock:
            enc.encode_graph(int(ctx.traffic["bucket_s"] * SR), _shape(ctx)[2])
    pending = deque()
    for _ in range(n):
        pending.append(enc.encode_batch_submit(next(batches)))
        if len(pending) >= enc.cfg.runtime.max_inflight_encodes:
            pending.popleft().result()
    while pending:
        pending.popleft().result()


def prepare(ctx) -> Program:
    tree = W.make_tree(W.asr_leaves(model_dims(ctx.config)),
                       ctx.config["port"]["weight_seed"], ctx.device,
                       _dtype(ctx.config))
    enc = build_encoder(ctx, tree)
    pool = T.phrase_pool(ctx.traffic, ctx.seed)
    warm_batches = T.phrase_batches(ctx.traffic, ctx.seed + 1, pool)
    warm(ctx, enc, warm_batches, ctx.traffic["warm_batches"])
    return Program(enc, tree, T.phrase_batches(ctx.traffic, ctx.seed, pool))


def _trips(enc) -> int:
    return sum(lp.trips_run for lp in enc._graphs.loops())


def _harvest(item, records, outputs):
    batch, t0, pending, submit_s = item
    tokens = pending._arrays[0] if pending._arrays is not None else None
    try:
        res = pending.result()
        ok = len(res) == len(batch)
    except RuntimeError:
        res, ok = None, False
    t_end = time.perf_counter()
    k = len(outputs)
    outputs.append((batch, tokens, res))
    for i, p in enumerate(batch):
        records.append({"t0": t0, "t_end": t_end, "speech_s": len(p) / SR,
                        "ok": ok, "batch": k, "lane": i,
                        "submit_s": submit_s})


def window(ctx, program, seconds):
    enc, depth = program.encoder, program.depth
    batches = program.batches
    records, outputs, inflight = [], [], deque()
    trips0 = _trips(enc)
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        batch = next(batches)
        t0 = time.perf_counter()
        pending = enc.encode_batch_submit(batch)
        inflight.append((batch, t0, pending, time.perf_counter() - t0))
        if len(inflight) >= depth:
            _harvest(inflight.popleft(), records, outputs)
    while inflight:
        _harvest(inflight.popleft(), records, outputs)
    window_s = time.perf_counter() - start
    program.outputs = outputs
    trips = _trips(enc) - trips0
    return records, window_s, {"batches": len(outputs), "trips": trips,
                               "work": _window_work(ctx, len(outputs), trips)}


def _shape(ctx):
    m = model_dims(ctx.config)
    bucket = int(ctx.traffic["bucket_s"] * SR)
    frames = min(bucket // 3 // 160, 2 * m["max_source_positions"])
    frames -= frames % 2
    b_pad = 1 << (ctx.traffic["batch"] - 1).bit_length()
    return m, frames, b_pad


def _window_work(ctx, n_batches: int, trips: int) -> dict:
    """Least work of the forward passes the window completed: an encoder
    pass, a prefill and the loop's steps a batch (every padded lane; the
    steps at the window's mean trips a batch)."""
    m, frames, b_pad = _shape(ctx)
    prompt = len(ctx.config["port"]["prompt"])
    enc_t = frames // 2
    tally = work.Tally()
    tally.add(work.encoder_pass(m, b_pad, frames), n_batches)
    tally.add(work.decoder_prefill(m, b_pad, prompt, enc_t), n_batches)
    steps = trips / max(n_batches, 1)
    for s in range(1, int(round(steps)) + 1):
        tally.add(work.decoder_step(m, b_pad, prompt + s, enc_t), n_batches)
    return tally.as_dict()


def _decode_attn_least_s(ctx, batches: int, trips: int) -> float:
    """Least time of the decode attention of ``batches`` encodes whose
    loops ran ``trips`` bodies in all: each layer's prefill (self and
    cross) and, every step, its self attention at the step's cache fill
    and its cross attention over the encoder's frames."""
    m, frames, b = _shape(ctx)
    p = len(ctx.config["port"]["prompt"])
    dh, L, H = m["d_model"] // m["num_heads"], m["decoder_layers"], \
        m["num_heads"]
    enc_t = frames // 2
    cross = work.least_s(work.decode_attention(b, H, 1, dh, enc_t))
    per_batch = L * (work.least_s(work.decode_attention(
        b, H, p, dh, p, new_kv=True)) + work.least_s(
        work.decode_attention(b, H, p, dh, enc_t)))
    for s in range(1, trips // max(batches, 1) + 1):
        per_batch += L * (work.least_s(work.decode_attention(
            b, H, 1, dh, p + s, new_kv=True)) + cross)
    return batches * per_batch


def traced(ctx, program):
    """``trace_batches`` more batches in flight as in the window, each
    submit and harvest annotated. The readers get the front (each
    submit's first graph launch) a batch, the loop bodies (the trace's
    orphans: a conditional node's body carries no host launch) over the
    trips that ran, and the least time of the decode attention."""
    enc, depth = program.encoder, program.depth
    trips0 = _trips(enc)
    n = ctx.traffic["trace_batches"]
    inflight = deque()
    with profiled(ctx.device) as out:
        for k in range(n):
            with note(f"submit.{k}"):
                inflight.append(enc.encode_batch_submit(next(program.batches)))
            if len(inflight) >= depth:
                with note("harvest"):
                    inflight.popleft().result()
        while inflight:
            with note("harvest"):
                inflight.popleft().result()
    trace, trips = out[0], _trips(enc) - trips0
    return trace, {"spans": trace_spans(trace, n, trips),
                   "least_s": {"decode_attn": _decode_attn_least_s(
                       ctx, n, trips)}}


def trace_spans(trace, batches: int, trips: int) -> dict:
    """The readers' groups of device work: the front a batch (each
    submit's first graph launch), and the loop bodies over ``trips``."""
    fronts = [g[0] for k in range(batches)
              for nt in trace.notes_named(f"submit.{k}")
              for g in [trace.graph_launches(nt)] if g]
    return {"front": (fronts, len(fronts)),
            "loop_body": ([trace.orphans], trips)}


# -- the check ---------------------------------------------------------------

def sample_batches(ctx, records) -> list:
    """Batches drawn from the seed among those the window finished."""
    done = sorted({r["batch"] for r in records if r["ok"]})
    rng = np.random.default_rng([ctx.seed, 4])
    n = min(ctx.traffic["sample_batches"], len(done))
    return sorted(int(i) for i in rng.choice(done, size=n, replace=False))


def collect(ctx, program, records) -> list:
    """Each sampled batch served again through the timed entry once the
    window has closed: its tokens must equal the window's
    (``rerun_mismatch``); then the program's own state of that encode is
    read from its static buffers: the encoder output, and each decoder
    layer's self-attention keys and values at the positions its loop
    filled. Host copies, one ``(phrases, tokens, results, enc, caches)``
    a batch."""
    enc = program.encoder
    bucket = int(ctx.traffic["bucket_s"] * SR)
    served, mismatch = [], 0
    for k in sample_batches(ctx, records):
        batch, tokens, res = program.outputs[k]
        pending = enc.encode_batch_submit(batch)
        again = pending._arrays[0]
        pending.result()
        mismatch += int(not torch.equal(again, tokens))
        b = len(batch)
        with torch.no_grad(), enc._graphs.lock:
            h = enc.encode_graph(bucket, tokens.shape[0])
            filled = h.greedy.prompt_len + int(h.trips)
            caches = [(c.k[:b, :, :filled].to("cpu", copy=True),
                       c.v[:b, :, :filled].to("cpu", copy=True))
                      for c in h.greedy.state.self_caches]
            enc_out = h.enc[:b].to("cpu", copy=True)
        served.append((batch, tokens[:b].cpu().numpy(), res, enc_out,
                       caches))
    program.mismatch = mismatch
    return served


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst lane's relative error: ``|got - ref| / |ref|`` over each
    lane's (the first axis's) elements."""
    d = (got.to(ref.device, torch.float32) - ref).flatten(1).norm(dim=1)
    return float((d / ref.flatten(1).norm(dim=1).clamp_min(1e-30)).max())


def reference_numbers(ctx, tree, served, device, lowered: bool = False
                      ) -> dict:
    """The comparison's numbers for one of :func:`collect`'s batches: the
    relative error of the program's encoder output and of its decoder
    self-attention keys and values (the worst lane and side; of the
    worst layer, ``kv_rel``, and of the first, ``kv_first_rel``, whose
    inputs are the embeddings alone, so that its error is one layer's
    precision and not the depth's), the
    served tokens' widest and summed logit gaps below the reference's
    best at their positions, and the RMS, mean F0 and codes of each
    phrase.

    ``lowered`` reads the control in the reference's own terms instead:
    the front's RMS and YIN summed in bfloat16 in the program's place,
    and the served tokens with one altered a lane (its third, to the next
    id) where the program produced them."""
    from portbench.reference import dsp, whisper

    phrases, tokens, results, enc_p, caches = served
    m, frames, _ = _shape(ctx)
    port = ctx.config["port"]
    bucket = int(ctx.traffic["bucket_s"] * SR)
    audio = np.zeros((len(phrases), bucket), np.float32)
    for i, p in enumerate(phrases):
        audio[i, :len(p)] = p
    n_valid = torch.tensor([len(p) for p in phrases], device=device)
    x = dsp.int16_wire(torch.from_numpy(audio).to(device))
    rms = dsp.rms(x, n_valid)
    x16 = dsp.decimate_3(x)
    hops = -(-(-(-n_valid // 3)) // 170)
    f0 = dsp.yin_f0(x16, hops)
    mel = dsp.log_mel(x16, frames, m["n_mels"]).float()
    enc = whisper.encode(tree, m["num_heads"], mel)
    served_t = torch.from_numpy(tokens).long().to(device)
    if lowered:
        served_t[:, 2] = (served_t[:, 2] + 1) % m["vocab_size"]
        low_rms = dsp.rms(x, n_valid, torch.bfloat16).double()
        low_f0 = dsp.yin_f0(x16, hops, dtype=torch.bfloat16)
        results = [{**r, "rms": float(low_rms[i]), "f0": float(low_f0[i])}
                   for i, r in enumerate(results)]
    prompt = torch.tensor(port["prompt"], device=device).expand(
        len(phrases), -1)
    seq = torch.cat([prompt, served_t[:, :-1]], 1)
    kv: list = []
    logits = whisper.decoder_logits(tree, m["num_heads"], enc, seq, kv=kv)
    logits = logits[:, prompt.shape[1] - 1:]
    gap = logits.max(-1).values - logits.gather(-1, served_t[..., None])[..., 0]
    # positions after a lane's end token were not served (padding)
    is_eot = served_t == port["eot"]
    after = (torch.cumsum(is_eot.int(), 1) - is_eot.int()) > 0
    gap = gap.masked_fill(after, 0.0)
    heads = m["num_heads"]
    kv_layers = []
    for (k_p, v_p), (k_r, v_r) in zip(caches, kv):
        filled = k_p.shape[2]
        worst = 0.0
        for got, ref in ((k_p, k_r), (v_p, v_r)):
            b, t, d = ref.shape
            ref = ref.view(b, t, heads, d // heads).transpose(1, 2)
            worst = max(worst, _rel(got, ref[:, :, :filled]))
        kv_layers.append(worst)
    pro = ctx.config["port"]["prosody"]

    def energy(r):
        return "Quiet" if r < pro["energy_quiet"] else (
            "Normal" if r < pro["energy_loud"] else "Loud")

    def pitch(f):
        return "Normal" if f <= 0 else "Deep" if f < pro["pitch_deep_hz"] \
            else "Normal" if f < pro["pitch_high_hz"] else "High"

    near = 1e-3
    mism = 0
    f0_err = rms_err = 0.0
    for i, res in enumerate(results):
        r, f = float(rms[i]), float(f0[i])
        rms_err = max(rms_err, abs(res["rms"] - r) / max(r, 1e-12))
        f0_err = max(f0_err, abs(res["f0"] - f) / max(f, 1.0))
        edge_e = min(abs(r - t) / t for t in (pro["energy_quiet"],
                                              pro["energy_loud"]))
        edge_p = min(abs(f - t) / t for t in (pro["pitch_deep_hz"],
                                              pro["pitch_high_hz"]))
        if edge_e > near and res["prosody"]["energy"] != energy(r):
            mism += 1
        if edge_p > near and res["prosody"]["pitch"] != pitch(f):
            mism += 1
    return {"enc_rel": _rel(enc_p, enc), "kv_rel": max(kv_layers),
            "kv_first_rel": kv_layers[0],
            "token_gap": float(gap.max()), "gap_sum": float(gap.sum()),
            "f0_rel": f0_err, "rms_rel": rms_err,
            "code_mismatch": float(mism), "tokens": int((~after).sum())}


def reseed(ctx, program) -> None:
    """Point the program's batches at ``ctx.seed`` (one process reading
    many seeds: ``portbench/tools/calibrate.py``)."""
    program.batches = T.phrase_batches(
        ctx.traffic, ctx.seed, T.phrase_pool(ctx.traffic, ctx.seed))
    program.outputs = []


def check(ctx, program, records):
    """The sampled batches through the reference, after the program's
    state is freed (the weights, which both sides read, stay)."""
    served = collect(ctx, program, records)
    tree = program.tree
    program.encoder = program.outputs = program.batches = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return compared(ctx, program, records, judge(ctx, tree, served))


def compared(ctx, program, records, nums) -> list:
    """``[(name, value, limit)]``: the failed requests, the re-served
    batches whose tokens differ, and the traffic's limits."""
    limits = ctx.traffic["limits"]
    ctx.log(f"reference: {nums['tokens']} served tokens compared; read, "
            f"not compared: " + ", ".join(
                f"{k} {v!r}" for k, v in nums.items() if k not in limits))
    failed = sum(1 for r in records if not r["ok"])
    return [("failed_requests", float(failed), 0.0),
            ("rerun_mismatch", float(program.mismatch), 0.0)] + [
        (k, nums[k], limits[k]) for k in limits]


def judge(ctx, tree, served, lowered: bool = False) -> dict:
    """The worst of each number over the sampled batches, the summed ones
    summed, TF32 off; ``token_gap_mean`` the served tokens' mean gap."""
    from portbench.harness.precision import fp32_exact

    worst: dict = {}
    with fp32_exact():
        for batch in served:
            nums = reference_numbers(ctx, tree, batch, ctx.device, lowered)
            for k, v in nums.items():
                worst[k] = (v + worst.get(k, 0) if k in ("tokens", "gap_sum")
                            else max(v, worst.get(k, v)))
    worst["token_gap_mean"] = worst.pop("gap_sum") / max(worst["tokens"], 1)
    return worst


def numbers(ctx, program, served, control: bool = False) -> dict:
    """The comparison's numbers of ``served`` (``collect``'s); with
    ``control`` the reference's own lower precision and a planted fault
    (:func:`reference_numbers`' ``lowered``). The model's control is a
    program of its own (:func:`control_program`)."""
    return judge(ctx, program.tree, served, lowered=control)


def control_program(ctx, program) -> Program:
    """The program's own lower-precision path, the control: dynamic int8
    weights and int8 cross K/V, warmed like the program."""
    enc = build_encoder(ctx, program.tree, quantized=True)
    pool = T.phrase_pool(ctx.traffic, ctx.seed)
    warm(ctx, enc, T.phrase_batches(ctx.traffic, ctx.seed + 1, pool),
         ctx.traffic["warm_batches"])
    return Program(enc, program.tree, None)
