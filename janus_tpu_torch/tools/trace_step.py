"""Trace one replayed AR step of the flagship TTS on the card.

Builds ``TTSConfig.flagship()`` with random bf16 weights from a seed,
generates once through the captured step (:class:`~janus_tpu_torch.models.
tts.ARGraph`), rewinds the holder and traces one replay with
``torch.profiler``. Every kernel of the step is listed by name with its
grid and block, its count in the step and its device time; the matrix
products (cuBLAS's and the port's own linear kernels) are summed apart.

Usage: ``python -m janus_tpu_torch.tools.trace_step [--batch 8 1]
[--groups 256] [--out trace.json]``; prints one JSON line a batch (the
full table goes to ``--out`` where given). Needs a card: the profiler's
device events are the measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
from typing import Dict, List, Optional

import torch

from janus_tpu_torch.common.config import TTSConfig
from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.models import tts as tts_mod
from janus_tpu_torch.models.params import cast_floating
from janus_tpu_torch.models.tokenizer import ByteTokenizer
from janus_tpu_torch.runtime.step_graph import StepGraphs

__all__ = ["PRODUCT", "kernel_rows", "trace_ar_step", "main"]

# the names of matrix-product kernels: cuBLAS / cuBLASLt (gemm, gemv,
# xmma, cutlass) and the port's own linears
PRODUCT = re.compile(r"gemm|gemv|xmma|cutlass|mixed_linear|stream_product"
                     r"|tile_product", re.IGNORECASE)


def kernel_rows(trace: dict) -> List[dict]:
    """The device kernels of a Chrome trace (``export_chrome_trace``),
    grouped by name, grid and block: ``{name, grid, block, count,
    total_us}``, longest total first."""
    rows: Dict[tuple, dict] = {}
    for e in trace.get("traceEvents", []):
        if e.get("cat") != "kernel":
            continue
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


@torch.no_grad()
def trace_ar_step(batch: int, groups: int = 256, prompt: int = 32,
                  device="cuda", out: Optional[str] = None) -> dict:
    """One replayed AR step at ``batch`` lanes, a ``prompt``-wide text and a
    budget of ``groups``, traced; returns the summary record."""
    from torch.profiler import ProfilerActivity, profile

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
        holder.group.zero_()
        holder.steps = 0
        holder.advance()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            holder.advance()
            torch.cuda.synchronize(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            rows = kernel_rows(json.load(f))
    products = [r for r in rows if PRODUCT.search(r["name"])]
    record = {
        "batch": batch, "groups": groups, "prompt": prompt,
        "device": torch.cuda.get_device_name(dev),
        "kernels": sum(r["count"] for r in rows),
        "busy_ms": sum(r["total_us"] for r in rows) / 1e3,
        "products": sum(r["count"] for r in products),
        "products_ms": sum(r["total_us"] for r in products) / 1e3,
        "product_rows": products,
        "others": [r for r in rows if r not in products][:12],
    }
    if out:
        with open(out, "w") as f:
            json.dump({**record, "rows": rows}, f, indent=1)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 1])
    ap.add_argument("--groups", type=int, default=256)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="write each batch's full table to OUT with the "
                         "batch before the extension")
    args = ap.parse_args(argv)
    for b in args.batch:
        out = None
        if args.out:
            stem, ext = os.path.splitext(args.out)
            out = f"{stem}_b{b}{ext or '.json'}"
        print(json.dumps(trace_ar_step(b, args.groups, args.prompt,
                                       args.device, out)), flush=True)


if __name__ == "__main__":
    main()
