"""Multi-rank scaling analysis for the sharded encode program.

The JAX package derives per-device FLOPs and bytes from XLA's
``cost_analysis`` and parses the collectives out of the optimized HLO.
The port has no HLO and its collectives are explicit, so at every mesh
size N (a group of N ranks, :func:`~..parallel.launch.run_ranks`) it
counts, on rank 0, over one call of the encode program:

- per-device FLOPs (``torch.utils.flop_counter.FlopCounterMode``);
- bytes accessed: operand and result bytes of every aten op that is not a
  view (XLA's ``bytes accessed`` at op granularity). The hand-written
  kernels are launched through ``ctypes`` and are invisible to both
  counters, so on a card each launch adds the least work its wrapper
  records (:meth:`~..ops.cuda_build.Kernel.launched`), listed by kernel
  under ``kernel_work``. On the CPU the kernels' plain versions run and
  are counted as aten ops instead: the encoder's attention products
  count the same on both; the frontend's FFT and YIN sums are not
  products, so a CPU row counts none of their FLOPs;
- the result bytes of every collective, by op
  (:func:`~..parallel.collectives.counting`).

and combines them with :class:`H100Roofline`, data-sheet peaks of one
card used as a model's inputs, into a *modeled* weak-scaling efficiency:

    t_N  = max(flops_N / (peak · util), bytes_N / (hbm · util)) + link_N / nvlink
    eff  = t_1 / t_N          (per-data-group batch held constant)

Only the time conversion is a model; the counts are what this rank ran.
The audio frontend (decimation, YIN with K3, log-mel with K1) runs on
each data group's lanes on every rank of that group, and under ``seq``
the encoder's conv stem runs replicated on the whole mel: per-device
work that tp and sp do not shrink. Wall-clock rows time the same program on
the ranks (:func:`measure_wallclock_scaling`).

The card is the default device: N is then at most
``torch.cuda.device_count()``. With ``--device cpu`` the ranks are gloo
processes, up to 8, as the JAX module forces 8 virtual CPU devices.

Run: ``python -m janus_tpu_torch.eval.scaling --device cpu --full``
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from janus_tpu_torch.parallel.collectives import counting
from janus_tpu_torch.parallel.launch import run_ranks

__all__ = ["H100Roofline", "collective_bytes", "analyze_encode_scaling",
           "measure_wallclock_scaling", "run_full_suite", "main"]

CPU_RANKS = 8


@dataclasses.dataclass(frozen=True)
class H100Roofline:
    """NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit): the
    inputs of a model, not measurements."""

    peak_bf16_flops: float = 989e12      # tensor-core bf16 FLOP/s
    hbm_bw: float = 3.35e12              # HBM3 B/s
    link_bw: float = 450e9               # NVLink 4 B/s, per direction
    tensor_util: float = 0.5             # achievable fraction of peak
    hbm_util: float = 0.8


def collective_bytes(fn, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` on this rank and return the result
    bytes of the collectives it issued, by op."""
    with counting() as counts:
        fn(*args, **kwargs)
    return dict(counts)


class BytesAccessed(TorchDispatchMode):
    """Sums operand and result bytes over the aten ops run inside it
    (views move nothing and are skipped)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            leaves, _ = tree_flatten((args, kwargs, out))
            self.bytes += sum(t.numel() * t.element_size() for t in leaves
                              if isinstance(t, torch.Tensor))
        return out


def _modeled_time(flops: float, hbm: float, link: float,
                  rl: H100Roofline) -> float:
    compute = max(flops / (rl.peak_bf16_flops * rl.tensor_util),
                  hbm / (rl.hbm_bw * rl.hbm_util))
    return compute + link / rl.link_bw


def _max_ranks(device: str) -> int:
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        return torch.cuda.device_count()
    return CPU_RANKS


def _encode_rank(n: int, tp: int, sp: int, bucket: int, cfg,
                 per_device_batch: int, device: str, iters: int) -> Dict:
    """One rank of an N-rank encode: the serving program of
    ``SemanticEncoder`` on a ``(N / (tp·sp), tp, sp)`` mesh (none at N =
    1) over zero audio. ``iters`` = 0 counts one call; otherwise it times
    ``iters`` calls after a warm-up."""
    import torch.distributed as dist

    from janus_tpu_torch.common.config import JanusConfig, MeshConfig
    from janus_tpu_torch.ops import cuda_build
    from janus_tpu_torch.parallel.mesh import build_mesh
    from janus_tpu_torch.runtime.codec import SemanticEncoder

    cfg = cfg or JanusConfig()
    data = n // (tp * sp)
    mesh = (build_mesh(MeshConfig(data=data, model=tp, seq=sp))
            if n > 1 else None)
    # the counting call runs the decode loop eagerly: a replayed step
    # bypasses the dispatcher whose modes count the aten ops' work
    enc = SemanticEncoder(cfg, buckets=(bucket,), device=device, mesh=mesh,
                          eager=iters == 0)
    dev = enc.device
    batch = per_device_batch * data
    audio = torch.zeros((batch, bucket), dtype=torch.float32, device=dev)
    n_valid = torch.full((batch,), bucket, dtype=torch.long, device=dev)
    n16 = enc.mel_frame_budget(bucket)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def call():
        enc._encode_impl(audio, n_valid, n16)
        sync()

    # work every rank of a data group repeats whole: tp and sp leave it
    replicated = ["frontend"] + (["conv_stem"] if sp > 1 else [])
    row = {"devices": n, "tp": tp, "sp": sp, "batch": batch,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"), "replicated": replicated}
    if iters == 0:
        from torch.utils.flop_counter import FlopCounterMode

        kernels = cuda_build.KERNELS.values()
        before = {k.name: (k.launches, k.flops, k.bytes) for k in kernels}
        with FlopCounterMode(display=False) as flops, \
                BytesAccessed() as accessed, counting() as coll:
            call()
        work = {k.name: {"launches": k.launches - before[k.name][0],
                         "flops": k.flops - before[k.name][1],
                         "bytes": k.bytes - before[k.name][2]}
                for k in kernels if k.launches > before[k.name][0]}
        row.update(
            per_device_flops=float(flops.get_total_flops())
            + sum(w["flops"] for w in work.values()),
            per_device_hbm_bytes=float(accessed.bytes)
            + sum(w["bytes"] for w in work.values()),
            collective_bytes=dict(coll), link_bytes=float(sum(coll.values())),
            kernel_work=work)
        return row
    call()  # warm-up: kernel libraries, allocator, cuBLAS handles
    times = []
    for _ in range(iters):
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    row.update(wallclock_step_s=min(times), wallclock_all_s=times)
    return row


def _rows(device_counts, seconds, tp, sp, cfg, per_device_batch, device,
          iters) -> List[Dict]:
    bucket = int(48_000 * seconds)
    limit = _max_ranks(device)
    rows = []
    # always keep the N = 1 baseline: efficiency is relative to one
    # device, even when tp or sp > 1 (the unsharded program runs there)
    for n in sorted(set(device_counts) | {1}):
        if n > limit or (n > 1 and n % (tp * sp)):
            continue
        tp_n, sp_n = (tp, sp) if n > 1 else (1, 1)
        rows.append(run_ranks(_encode_rank, n, device=device, args=(
            n, tp_n, sp_n, bucket, cfg, per_device_batch, device,
            iters))[0])
    return rows


def analyze_encode_scaling(
    device_counts: Sequence[int] = (1, 2, 4, 8),
    seconds: float = 4.0,
    tp: int = 1,
    sp: int = 1,
    roofline: Optional[H100Roofline] = None,
    cfg=None,
    per_device_batch: int = 8,
    device: str = "cuda",
) -> List[Dict]:
    """Weak scaling of the semantic-encode program: the per-data-group
    batch held at ``per_device_batch`` phrases x ``seconds``; ``data``
    grows with N while ``tp`` (tensor parallel) and ``sp`` (ring
    attention) carve fixed dimensions out of each N."""
    rl = roofline or H100Roofline()
    rows = _rows(device_counts, seconds, tp, sp, cfg, per_device_batch,
                 device, iters=0)
    for r in rows:
        r["modeled_step_s"] = _modeled_time(r["per_device_flops"],
                                            r["per_device_hbm_bytes"],
                                            r["link_bytes"], rl)
    if rows:
        t1 = rows[0]["modeled_step_s"]
        for r in rows:
            r["modeled_weak_scaling_efficiency"] = round(
                t1 / r["modeled_step_s"], 4)
    return rows


def measure_wallclock_scaling(
    device_counts: Sequence[int] = (1, 2, 4, 8),
    seconds: float = 4.0,
    tp: int = 1,
    sp: int = 1,
    cfg=None,
    per_device_batch: int = 4,
    iters: int = 3,
    device: str = "cuda",
) -> List[Dict]:
    """Wall-clock weak scaling on the ranks, min of ``iters``.

    On the CPU the ranks share one host's cores, so perfect weak scaling
    shows as time growing with the total batch; the efficiency is taken
    against that ideal, ``eff_N = t_1 · (batch_N / batch_1) / t_N``, and
    isolates the overhead the split adds (collectives, the replicated
    frontend). On cards, one per rank, the ideal is flat time."""
    rows = _rows(device_counts, seconds, tp, sp, cfg, per_device_batch,
                 device, iters=iters)
    if rows:
        t1, b1 = rows[0]["wallclock_step_s"], max(rows[0]["batch"], 1)
        cpu = torch.device(device).type == "cpu"
        for r in rows:
            ideal = t1 * (r["batch"] / b1 if cpu else 1.0)
            r["wallclock_efficiency_vs_linear"] = round(
                ideal / r["wallclock_step_s"], 4)
    return rows


def _log_rows(label: str, rows: List[Dict]) -> None:
    for r in rows:
        eff = r.get("modeled_weak_scaling_efficiency",
                    r.get("wallclock_efficiency_vs_linear"))
        tail = (f"flops/dev={r['per_device_flops']:.3g}  "
                f"link={r['link_bytes']:.3g}B"
                if "per_device_flops" in r
                else f"step={r['wallclock_step_s'] * 1e3:.0f}ms")
        print(f"[{label}] N={r['devices']:>2} (tp={r['tp']} sp={r['sp']}) "
              f"batch={r['batch']:>3}  {tail}  eff={eff:.3f}",
              file=sys.stderr, flush=True)


def run_full_suite(seconds: float = 4.0, flagship: bool = False,
                   device: str = "cuda") -> Dict:
    """Modeled rows for every geometry that communicates (dp, tp2, sp2,
    and data x tp2 x sp2 with 8 ranks) plus wall-clock rows on the same
    ranks. Flagship (large-v3) rows are opt-in."""
    n_max = _max_ranks(device)
    suite: Dict[str, List[Dict]] = {}
    kw = dict(seconds=seconds, device=device)
    suite["modeled_dp"] = analyze_encode_scaling(**kw)
    suite["modeled_tp2"] = analyze_encode_scaling(tp=2, **kw)
    suite["modeled_sp2"] = analyze_encode_scaling(sp=2, **kw)
    if n_max >= 8:
        suite["modeled_hybrid_tp2_sp2"] = analyze_encode_scaling(
            device_counts=(1, 8), tp=2, sp=2, **kw)
    suite["wallclock_dp"] = measure_wallclock_scaling(**kw)
    suite["wallclock_tp2"] = measure_wallclock_scaling(
        device_counts=(1, 8), tp=2, **kw)
    suite["wallclock_sp2"] = measure_wallclock_scaling(
        device_counts=(1, 8), sp=2, **kw)
    for key, rows in suite.items():
        _log_rows(key, rows)

    # the model and the wall clock measure different things, but both
    # express an efficiency relative to N = 1: the delta bounds the
    # overhead the model does not see
    deltas = []
    for key in ("dp", "tp2", "sp2"):
        modeled = {r["devices"]: r["modeled_weak_scaling_efficiency"]
                   for r in suite.get(f"modeled_{key}", [])}
        for w in suite.get(f"wallclock_{key}", []):
            n = w["devices"]
            if n in modeled:
                deltas.append({
                    "geometry": key, "devices": n,
                    "modeled_eff": modeled[n],
                    "measured_eff": w["wallclock_efficiency_vs_linear"],
                    "delta": round(modeled[n]
                                   - w["wallclock_efficiency_vs_linear"], 4),
                })
    suite["model_vs_measured"] = deltas

    if flagship:
        from janus_tpu_torch.common.config import ASRConfig, JanusConfig

        fcfg = dataclasses.replace(JanusConfig(), asr=ASRConfig.large_v3())
        for key, geo in (("tp2", dict(tp=2)), ("sp2", dict(sp=2))):
            suite[f"modeled_flagship_{key}"] = analyze_encode_scaling(
                device_counts=(1, 8), cfg=fcfg, per_device_batch=2, **geo,
                **kw)
            _log_rows(f"flagship {key}", suite[f"modeled_flagship_{key}"])
    return suite


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None, help="write JSON artifact here")
    ap.add_argument("--full", action="store_true",
                    help="all geometries + wall-clock")
    ap.add_argument("--flagship", action="store_true",
                    help="with --full: add large-v3 modeled rows (slow)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (one rank per card) or cpu (gloo ranks)")
    args = ap.parse_args(argv)

    if args.full:
        suite = run_full_suite(seconds=args.seconds, flagship=args.flagship,
                               device=args.device)
        payload = {"metric": "encode_scaling_suite", "suite": suite}
        key = ("modeled_hybrid_tp2_sp2"
               if "modeled_hybrid_tp2_sp2" in suite else "modeled_tp2")
        largest = suite[key][-1]
        headline = {
            "metric": (f"modeled_weak_scaling_efficiency_{key}_at_"
                       f"{largest['devices']}"),
            "value": largest["modeled_weak_scaling_efficiency"],
            "unit": "fraction", "devices": largest["devices"],
            "device": largest["device"]}
    else:
        rows = analyze_encode_scaling(seconds=args.seconds, tp=args.tp,
                                      sp=args.sp, device=args.device)
        _log_rows("modeled", rows)
        payload = {"metric": "modeled_weak_scaling", "rows": rows}
        headline = {
            "metric": f"modeled_weak_scaling_efficiency_at_"
                      f"{rows[-1]['devices']}",
            "value": rows[-1]["modeled_weak_scaling_efficiency"],
            "unit": "fraction", "devices": rows[-1]["devices"],
            "device": rows[-1]["device"]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
    print(json.dumps(headline))


if __name__ == "__main__":
    main()
