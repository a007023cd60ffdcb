"""Read a cell's comparison over many seeds in one process, for the
program and for its control, to set the cell's limits and to see the
control fail them (the benchmark's own runs never run the control).

    python3 portbench/tools/calibrate.py --workload <cell> \
        --seeds 11 12 ... --seconds <s> [--control] [--lowered]

One set-up, then for each seed a short window at the cell's own load,
the sampled requests collected as a run collects them, their numbers
and the run's own judgement (``correct``: every number within the
traffic file's limit) for the program; with ``--control`` the same for
the program's own lower-precision path where the driver has one
(``control_program``: its own window, or else the driver's
``numbers(..., control=True)``); with ``--lowered`` the driver's
``numbers(..., control=True)`` over the program's requests
(``lowered``: the reference in the precision below the configuration's
put in the program's place, and any fault planted there). One JSON line
a seed on standard output. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--lowered", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "portbench"))
    from run import _cache_dirs

    _cache_dirs()
    import torch

    from janus_tpu_torch.ops import cuda_build
    from portbench.harness import lookup, runner

    if not torch.cuda.is_available():
        print("calibrate: needs an NVIDIA card", file=sys.stderr)
        return 2
    cuda_build.build_all()
    bench = lookup.load_benchmark(ROOT)
    cell = lookup.workload(bench, args.workload)
    ctx = runner.Context(ROOT, cell, lookup.config_of(bench, ROOT, cell),
                         lookup.traffic_of(cell), args.seeds[0],
                         args.seconds, False, torch.device("cuda:0"))
    drv = lookup.driver(ctx.traffic["driver"])
    t0 = time.perf_counter()
    program = drv.prepare(ctx)
    ctrl = None
    if args.control and hasattr(drv, "control_program"):
        ctrl = drv.control_program(ctx, program)
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for seed in args.seeds:
        ctx.seed = seed
        line = {"seed": seed}
        for side, prog in (("program", program), ("control", ctrl)):
            if prog is None:
                continue
            drv.reseed(ctx, prog)
            records, window_s, _ = drv.window(ctx, prog, args.seconds)
            served = drv.collect(ctx, prog, records)
            nums = drv.numbers(ctx, prog, served)
            checks = drv.compared(ctx, prog, records, nums)
            line[side] = nums
            line[side + "_correct"] = runner.correct_of(checks)
            line[side + "_attempted"] = len(records)
            if side == "program" and (args.lowered or (
                    args.control and ctrl is None)):
                low = drv.numbers(ctx, prog, served, control=True)
                line["lowered"] = low
                line["lowered_correct"] = runner.correct_of(
                    drv.compared(ctx, prog, records, low))
        print(json.dumps(line), flush=True)
        ctx.notes.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
