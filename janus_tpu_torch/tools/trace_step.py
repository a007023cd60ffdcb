"""Trace one replayed AR step of the flagship TTS, or one replayed send
front of the large-v3 recognizer, on the card.

Builds ``TTSConfig.flagship()`` with random bf16 weights from a seed,
generates once through the captured step (:class:`~janus_tpu_torch.models.
tts.ARGraph`), rewinds the holder and traces one replay with
``torch.profiler``. Every kernel of the step is listed by name with its
grid and block, its count in the step and its device time; the matrix
products (cuBLAS's and the port's own linear kernels) are summed apart.
The step's timeline gives each kernel's start, end and the gap before it
(negative where a programmatic launch started before the kernel before
it ended), summed by the kind of the kernel and of the one before it
(norm, attention, GELU, mixed linear, other), and the device's span: the
union of the kernels' intervals, which a sum of their times overstates
once kernels overlap. Before the trace the step is timed bare on the
host's clock: ``wall_ms`` is the median over rounds of 16 replays (the
holder rewound before each round) of a round's time over its replays.

:func:`trace_front` does the same for the front an encoder replays
before its greedy loop (:class:`~janus_tpu_torch.runtime.codec.
EncodeGraph`: the frontend, the encoder, the cross K/V and the prefill);
:func:`trace_ar_loop` and :func:`trace_greedy_loop` split what a decode
loop's graph (:class:`~janus_tpu_torch.runtime.step_graph.LoopGraph`: the
WHILE node whose body holds the captured step's nodes, its condition
tested on the card) costs around its step (:func:`trace_loop_parts`: the
loop, a chain of its steps, the step replayed as often, the step at its
first position), the holder rewound to the end of its prefill before each;
:func:`trace_receive` the receive side's other captures (the AR prefill,
the synthesis tail, one emission of the stream) of
:class:`~janus_tpu_torch.runtime.synthesizer.SynthGraph` and
:class:`~janus_tpu_torch.runtime.streaming_tts.StreamGraph`;
:func:`trace_replays` any replay.

Usage: ``python -m janus_tpu_torch.tools.trace_step [--batch 8 1]
[--groups 256] [--front SECONDS] [--loop] [--receive] [--out
trace.json]``; prints one JSON line a batch (the full table goes to
``--out`` where given): the AR step, or with ``--loop`` the AR loop's
parts; with ``--front`` the recognizer's front, or with ``--loop`` its
greedy loop's parts after the front; with ``--receive`` the prefill, the
synthesis tail and one stream emission.
Needs a card: the profiler's device events are the measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from janus_tpu_torch.common.config import TTSConfig
from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.models import tts as tts_mod
from janus_tpu_torch.models.params import cast_floating
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.runtime.step_graph import StepGraphs

__all__ = ["PRODUCT", "KINDS", "kernel_rows", "kind_of", "timeline",
           "gaps_by_kind", "span_us", "launch_spans", "trace_replays",
           "trace_loop_parts", "trace_ar_step",
           "trace_front", "trace_ar_loop", "trace_greedy_loop",
           "trace_receive", "profiler_ready", "main"]

# the names of matrix-product kernels: cuBLAS / cuBLASLt (gemm, gemv,
# xmma, cutlass, nvjet) and the port's own linears
PRODUCT = re.compile(r"gemm|gemv|xmma|cutlass|nvjet|mixed_linear"
                     r"|stream_product|tile_product", re.IGNORECASE)


# a kernel's kind, by name: the step's own kernels and PyTorch's GELU
KINDS = (("norm", re.compile(r"layer_norm")),
         ("attention", re.compile(r"decode_attn|attention", re.IGNORECASE)),
         ("gelu", re.compile(r"gelu", re.IGNORECASE)),
         ("mixed linear", re.compile(r"mixed_linear")))


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if pattern.search(name):
            return kind
    return "other"


# the trace's device work: kernels, and the copies and memsets a graph
# holds as nodes of their own (inside a conditional body the card runs
# them as kernels)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kernels(trace: dict, cats=("kernel",)) -> List[dict]:
    return [e for e in trace.get("traceEvents", [])
            if e.get("cat") in cats]


def timeline(trace: dict) -> List[dict]:
    """The device work of a Chrome trace (kernels, copies, memsets) in
    order of start: ``{name, kind, launch, start_us, end_us, gap_us}``,
    times from the first event's start, the gap from the end of the event
    before (none for the first); ``launch`` is the host call that enqueued
    it (the profiler's correlation id: one a graph launch)."""
    events = sorted(_kernels(trace, DEVICE_CATS),
                    key=lambda e: float(e["ts"]))
    rows: List[dict] = []
    t0 = float(events[0]["ts"]) if events else 0.0
    for e in events:
        start = float(e["ts"]) - t0
        end = start + float(e.get("dur", 0.0))
        rows.append({"name": e["name"][:120], "kind": kind_of(e["name"]),
                     "launch": e.get("args", {}).get("correlation"),
                     "start_us": start, "end_us": end,
                     "gap_us": start - rows[-1]["end_us"] if rows else None})
    return rows


def launch_spans(rows: List[dict]) -> List[float]:
    """:func:`span_us` of each host launch's device work (rows grouped by
    ``launch``), in order of their first start."""
    groups: Dict[object, List[dict]] = {}
    for row in rows:
        groups.setdefault(row["launch"], []).append(row)
    return [span_us(g) for g in groups.values()]


def gaps_by_kind(rows: List[dict]) -> Dict[str, dict]:
    """Each kernel's gap and time by its kind and the kind of the kernel
    before it: ``{"<kind> after <kind>": {count, mean_us, mean_gap_us,
    min_gap_us, max_gap_us}}``."""
    out: Dict[str, dict] = {}
    for prev, row in zip(rows, rows[1:]):
        key = f"{row['kind']} after {prev['kind']}"
        acc = out.setdefault(key, {"count": 0, "us": 0.0, "gaps": []})
        acc["count"] += 1
        acc["us"] += row["end_us"] - row["start_us"]
        acc["gaps"].append(row["gap_us"])
    return {key: {"count": a["count"], "mean_us": a["us"] / a["count"],
                  "mean_gap_us": sum(a["gaps"]) / a["count"],
                  "min_gap_us": min(a["gaps"]), "max_gap_us": max(a["gaps"])}
            for key, a in sorted(out.items(), key=lambda kv: -kv[1]["count"])}


def span_us(rows: List[dict]) -> float:
    """The union of the kernels' intervals: the time the device ran at
    least one of them."""
    total, reach = 0.0, None
    for row in sorted(rows, key=lambda r: r["start_us"]):
        start, end = row["start_us"], row["end_us"]
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


def kernel_rows(trace: dict) -> List[dict]:
    """The device kernels of a Chrome trace (``export_chrome_trace``),
    grouped by name, grid and block: ``{name, grid, block, count,
    total_us}``, longest total first."""
    rows: Dict[tuple, dict] = {}
    for e in _kernels(trace):
        args = e.get("args", {})
        key = (e["name"], tuple(args.get("grid", ())),
               tuple(args.get("block", ())))
        row = rows.setdefault(key, {"name": key[0][:160],
                                    "grid": list(key[1]),
                                    "block": list(key[2]), "count": 0,
                                    "total_us": 0.0})
        row["count"] += 1
        row["total_us"] += float(e.get("dur", 0.0))
    return sorted(rows.values(), key=lambda r: -r["total_us"])


def profiler_ready(device: torch.device) -> None:
    """One empty profiler session on ``device``: run it before the graphs
    to be traced are built. A loop graph instantiated before a process's
    first profiler session had one body of its WHILE node recorded (234 of
    the AR loop's 59,407 kernels at b = 8); one built after it, all."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def trace_replays(replay: Callable[[], None], device: torch.device,
                  rewind: Callable[[], None] = lambda: None,
                  rounds: int = 9, per_round: int = 16,
                  out: Optional[str] = None,
                  timeline_rows: Optional[int] = None) -> dict:
    """``replay()`` (one replay of a captured graph) timed bare and then
    traced once: ``wall_ms`` is the median over ``rounds`` of a round's
    time over its ``per_round`` replays (``rewind()`` before each round
    and before the traced replay), then every kernel of the traced replay
    with its grid and block, the products summed apart, the timeline's
    gaps by kind, the device's span, and the spans of the host launches
    the replay made, summed (``launch_span_sum_ms``). ``out`` receives the
    record, the rows and the timeline (its first ``timeline_rows``
    events, where given)."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(rounds):
        rewind()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(per_round):
            replay()
        torch.cuda.synchronize(device)
        walls.append(1e3 * (time.perf_counter() - t0) / per_round)
    rewind()
    replay()
    torch.cuda.synchronize(device)
    rewind()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    rows, steps = kernel_rows(trace), timeline(trace)
    products = [r for r in rows if PRODUCT.search(r["name"])]
    spans = launch_spans(steps)
    record = {
        "device": torch.cuda.get_device_name(device),
        "wall_ms": sorted(walls)[len(walls) // 2],
        "kernels": sum(r["count"] for r in rows),
        "copies": len(steps) - sum(r["count"] for r in rows),
        "busy_ms": sum(r["total_us"] for r in rows) / 1e3,
        "span_ms": span_us(steps) / 1e3,
        "launches": len(spans),
        "launch_span_sum_ms": sum(spans) / 1e3,
        "first_to_last_ms": (steps[-1]["end_us"] / 1e3 if steps else 0.0),
        "gaps_ms": sum(r["gap_us"] for r in steps[1:]) / 1e3,
        "by_kind_pair": gaps_by_kind(steps),
        "products": sum(r["count"] for r in products),
        "products_ms": sum(r["total_us"] for r in products) / 1e3,
        "product_rows": products,
        "others": [r for r in rows if r not in products][:12],
    }
    if out:
        with open(out, "w") as f:
            json.dump({**record, "rows": rows,
                       "timeline": steps[:timeline_rows]}, f, indent=1)
    return record


@torch.no_grad()
def trace_loop_parts(loop, rewind: Callable[[], None],
                     advance: Callable[[], None], trips: int,
                     device: torch.device, out: Optional[str] = None
                     ) -> dict:
    """What a decode loop costs around its step, each run from the same
    state (``rewind()``) and traced: (a) one launch of ``loop`` (a
    :class:`~janus_tpu_torch.runtime.step_graph.LoopGraph` that runs
    ``trips`` bodies from that state); (b) one launch of a
    :class:`~janus_tpu_torch.runtime.step_graph.StepChain` of ``trips``
    steps (the same nodes, no condition); (c) the step replayed ``trips``
    times in a row (``advance()``), the spans of its replays summed, so
    that its positions match (a)'s and (b)'s; (c1) the step replayed once
    at the first position. Per body: ``while_ms`` = (a - b) / trips (the
    WHILE node and its condition), ``boundary_ms`` = (b - c) / trips (the
    step inside another graph against the step's own), ``growth_ms`` = c /
    trips - c1 (the later positions' longer caches: no loss). Beside them
    the norm -> mixed linear gaps of (a) and (c), the census of the step's
    graph, of the loop's body and of the chain (nodes, edges, programmatic
    edges), and the builds' ms."""
    from janus_tpu_torch.runtime.step_graph import StepChain

    def path(name):
        if not out:
            return None
        stem, ext = os.path.splitext(out)
        return f"{stem}_{name}{ext or '.json'}"

    def replays():
        for _ in range(trips):
            advance()

    chain = StepChain(loop.step_graph, trips)
    parts = {
        "a_loop": trace_replays(loop.run, device, rewind, rounds=3,
                                per_round=1, out=path("a_loop"),
                                timeline_rows=1500),
        "b_chain": trace_replays(chain.run, device, rewind, rounds=3,
                                 per_round=1, out=path("b_chain"),
                                 timeline_rows=1500),
        "c_replays": trace_replays(replays, device, rewind, rounds=3,
                                   per_round=1, out=path("c_replays"),
                                   timeline_rows=1500),
        "c1_step": trace_replays(advance, device, rewind, rounds=3,
                                 per_round=16, out=path("c1_step")),
    }
    n = max(trips, 1)
    a, b = parts["a_loop"]["span_ms"], parts["b_chain"]["span_ms"]
    c = parts["c_replays"]["launch_span_sum_ms"]
    c1 = parts["c1_step"]["span_ms"]

    def gap(name):
        pair = parts[name]["by_kind_pair"].get("mixed linear after norm")
        return None if pair is None else pair["mean_gap_us"]

    return {"trips": trips, **parts,
            "per_body_ms": {"a_loop": a / n, "b_chain": b / n,
                            "c_replays": c / n, "c1_step": c1},
            "while_ms": (a - b) / n, "boundary_ms": (b - c) / n,
            "growth_ms": c / n - c1,
            "norm_to_mixed_gap_us": {"a_loop": gap("a_loop"),
                                     "c_replays": gap("c_replays")},
            "census": {"step": loop.step_graph.census(),
                       "body": loop.census(), "chain": chain.census()},
            "build_ms": {"loop": loop.build_ms, "chain": chain.build_ms}}


@torch.no_grad()
def trace_ar_step(batch: int, groups: int = 256, prompt: int = 32,
                  device="cuda", out: Optional[str] = None) -> dict:
    """One replayed AR step at ``batch`` lanes, a ``prompt``-wide text and a
    budget of ``groups``, traced; returns the summary record."""
    dev = resolve_device(device)
    tok = ByteTokenizer()
    cfg = TTSConfig.flagship()
    params = cast_floating(tts_mod.init_tts(
        torch.Generator(device=dev).manual_seed(0), cfg,
        text_vocab=tok.vocab_size), torch.bfloat16)
    graphs = StepGraphs()
    text = torch.zeros((batch, prompt), dtype=torch.long, device=dev)
    emo = torch.zeros((batch,), dtype=torch.long, device=dev)
    tts_mod.tts_generate(params, cfg, text, emo, max_groups=groups,
                         text_vocab=tok.vocab_size, stop_threshold=2.0,
                         graphs=graphs)
    with graphs.lock:
        holder = tts_mod.ar_graph(graphs, params, cfg, batch, prompt + 3,
                                  groups, 2.0, dev)

        def rewind():
            holder.group.zero_()
            holder.steps = 0

        record = trace_replays(holder.advance, dev, rewind, out=out)
    return {"batch": batch, "groups": groups, "prompt": prompt, **record}


@torch.no_grad()
def trace_front(encoder, bucket: int, batch: int,
                out: Optional[str] = None) -> dict:
    """One replay of ``encoder``'s captured front (:class:`~janus_tpu_torch.
    runtime.codec.EncodeGraph`) at ``bucket`` samples and ``batch`` padded
    lanes, over whatever its static inputs hold (an encode before it
    captures it and leaves its audio there), traced; the summary record.
    A replay writes only static buffers, so replays need no rewind."""
    with encoder._graphs.lock:
        holder = encoder.encode_graph(bucket, batch)
        record = trace_replays(holder.graph.replay, encoder.device,
                               rounds=5, per_round=4, out=out)
    return {"bucket": bucket, "batch": batch, **record}


@torch.no_grad()
def trace_ar_loop(batch: int, groups: int = 256, prompt: int = 32,
                  device="cuda", out: Optional[str] = None) -> dict:
    """One launch of the AR loop's graph at ``batch`` lanes, a
    ``prompt``-wide text and a budget of ``groups`` (no stop: random
    weights, threshold 2), traced after one prefill; the holder is rewound
    to the end of that prefill before each launch. The summary record,
    with the loop's ``trips``."""
    dev = resolve_device(device)
    profiler_ready(dev)
    tok = ByteTokenizer()
    cfg = TTSConfig.flagship()
    params = cast_floating(tts_mod.init_tts(
        torch.Generator(device=dev).manual_seed(0), cfg,
        text_vocab=tok.vocab_size), torch.bfloat16)
    graphs = StepGraphs()
    with graphs.lock:
        holder = tts_mod.ar_graph(graphs, params, cfg, batch, prompt + 3,
                                  groups, 2.0, dev)
        text = torch.zeros((batch, prompt), dtype=torch.long, device=dev)
        emo = torch.zeros((batch,), dtype=torch.long, device=dev)
        holder.prefill(text, emo)
        saved = [t.clone() for t in (holder.prev, holder.done)]

        def rewind():
            holder.prev.copy_(saved[0])
            holder.done.copy_(saved[1])
            holder.group.zero_()
            holder.loop.trips.zero_()
            holder.steps = 0

        holder.loop.run()
        record = trace_loop_parts(holder.loop, rewind, holder.advance,
                                  int(holder.loop.trips), dev, out)
    return {"batch": batch, "groups": groups, "prompt": prompt, **record}


@torch.no_grad()
def trace_greedy_loop(encoder, bucket: int, batch: int,
                      out: Optional[str] = None) -> dict:
    """One launch of ``encoder``'s greedy loop graph at ``bucket`` samples
    and ``batch`` padded lanes, after a replay of its front over whatever
    its static inputs hold (the rewind: the front primes the loop), traced;
    the summary record, with the loop's ``trips``. Build ``encoder``'s
    graphs after :func:`profiler_ready`."""
    with encoder._graphs.lock:
        holder = encoder.encode_graph(bucket, batch)
        greedy = holder.greedy

        def rewind():
            holder.graph.replay()
            greedy.fill = greedy.prompt_len

        rewind()
        greedy.loop.run()
        record = trace_loop_parts(greedy.loop, rewind, greedy.advance,
                                  int(greedy.loop.trips), encoder.device,
                                  out)
    return {"bucket": bucket, "batch": batch, **record}


@torch.no_grad()
def trace_receive(batch: int, groups: int = 256, prompt: int = 32,
                  device="cuda", out: Optional[str] = None) -> dict:
    """The flagship TTS and the default vocoder (random bf16 weights from
    seeds 0 and 1) at ``batch`` lanes, a ``prompt``-wide text and a budget
    of ``groups``: one synthesis through its :class:`~janus_tpu_torch.
    runtime.synthesizer.SynthGraph` captures it, then its prefill replay
    and its tail replay are traced; at one lane a stream captures its
    emissions, and the first is traced. The records by name."""
    from janus_tpu_torch.common.config import JanusConfig, VocoderConfig
    from janus_tpu_torch.models import vocoder as voc_mod
    from janus_tpu_torch.runtime.streaming_tts import StreamingSynthesizer
    from janus_tpu_torch.runtime.synthesizer import Synthesizer

    dev = resolve_device(device)
    tok = ByteTokenizer()
    tcfg = dataclasses.replace(TTSConfig.flagship(),
                               max_mel_frames=groups
                               * TTSConfig.flagship().reduction)
    cfg = dataclasses.replace(JanusConfig(), tts=tcfg,
                              vocoder=VocoderConfig())
    tts = cast_floating(tts_mod.init_tts(
        torch.Generator(device=dev).manual_seed(0), tcfg,
        text_vocab=tok.vocab_size), torch.bfloat16)
    voc = cast_floating(voc_mod.init_vocoder(
        torch.Generator(device=dev).manual_seed(1), cfg.vocoder,
        n_mels=tcfg.n_mels), torch.bfloat16)
    syn = Synthesizer(cfg, tts_params=tts, vocoder_params=voc, device=dev)
    text = torch.zeros((batch, prompt), dtype=torch.long)
    emo = torch.zeros((batch,), dtype=torch.long)
    records = {}
    with syn._graphs.lock:
        syn._synth_impl(text, emo, None)
        h = syn.synth_graph(prompt, batch, None)
        for name, g in (("prefill", h.ar.prefill_graph), ("tail", h.tail)):
            stem, ext = os.path.splitext(out) if out else ("", "")
            records[name] = trace_replays(
                g.replay, dev, rounds=5, per_round=4,
                out=f"{stem}_{name}{ext or '.json'}" if out else None)
    syn._graphs.settle()
    if batch == 1:
        s = StreamingSynthesizer(cfg, tts_params=tts, vocoder_params=voc,
                                 device=dev)
        list(s.stream("status report follows all clear"))
        with s._graphs.lock:
            em = s.stream_graph()
            records["emit"] = trace_replays(em.side_graphs[0].replay, dev,
                                            rounds=5, per_round=4)
    return {"batch": batch, "groups": groups, "prompt": prompt, **records}


def _flagship_front(batch: int, seconds: float, device,
                    out: Optional[str] = None, loop: bool = False) -> dict:
    """The large-v3 recognizer (random bf16 weights from seed 0) encoding
    ``batch`` voiced phrases of ``seconds``, then its front (or its greedy
    loop) traced."""
    from janus_tpu_torch.audio.synthetic import voiced_phrase
    from janus_tpu_torch.common.config import ASRConfig, JanusConfig
    from janus_tpu_torch.runtime.codec import SemanticEncoder, duration_bucket

    cfg = dataclasses.replace(JanusConfig(), asr=ASRConfig.large_v3())
    cfg = cfg.override(**{"asr.max_decode_tokens": 24})
    phrases = [voiced_phrase(f0=140.0 + 15 * i, seconds=seconds, amp=0.12,
                             seed=i) for i in range(batch)]
    bucket = duration_bucket(len(phrases[0]))
    if loop:
        profiler_ready(resolve_device(device))
    enc = SemanticEncoder(cfg, buckets=(bucket,), device=device)
    enc.encode_batch(phrases)
    padded = 1 << (batch - 1).bit_length()
    if loop:
        return trace_greedy_loop(enc, bucket, padded, out)
    return trace_front(enc, bucket, padded, out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 1])
    ap.add_argument("--groups", type=int, default=256)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--front", type=float, default=None, metavar="SECONDS",
                    help="trace the large-v3 recognizer's captured front "
                         "(the encode before its greedy loop) at phrases of "
                         "SECONDS instead of the AR step")
    ap.add_argument("--loop", action="store_true",
                    help="trace a whole decode loop's graph launch: the AR "
                         "loop, or with --front the greedy loop")
    ap.add_argument("--receive", action="store_true",
                    help="trace the receive side's captures: the AR "
                         "prefill, the synthesis tail and (at one lane) a "
                         "stream emission")
    ap.add_argument("--out", default=None,
                    help="write each batch's full table to OUT with the "
                         "batch before the extension")
    args = ap.parse_args(argv)
    for b in args.batch:
        out = None
        if args.out:
            stem, ext = os.path.splitext(args.out)
            out = f"{stem}_b{b}{ext or '.json'}"
        if args.receive:
            record = trace_receive(b, args.groups, args.prompt, args.device,
                                   out)
        elif args.front:
            record = _flagship_front(b, args.front, args.device, out,
                                     args.loop)
        elif args.loop:
            record = trace_ar_loop(b, args.groups, args.prompt, args.device,
                                   out)
        else:
            record = trace_ar_step(b, args.groups, args.prompt, args.device,
                                   out)
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
