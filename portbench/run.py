"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (``janus_tpu_torch``).
Every cell runs on an NVIDIA card: without one (or with fewer cards than
the cell asks for) the run exits with code 2 and prints no result. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit); the checks are also the last lines of standard error.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port builds its kernels under ``build/janus_tpu_torch`` itself;
    the CUDA driver's JIT cache and any extension or Triton build go
    beside it."""
    cache = ROOT / "build" / "portbench"
    for var, sub in (("CUDA_CACHE_PATH", "cuda_jit"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from portbench.harness import lookup, runner

    bench = lookup.load_benchmark(ROOT)
    cell = lookup.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} NVIDIA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 2
    from janus_tpu_torch.ops import cuda_build

    cuda_build.build_all()
    result = runner.run_cell(ROOT, bench, args.workload, args.seed,
                             args.seconds, bool(args.trace), "cuda:0",
                             STARTED)
    loaded = runner.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for line in result.pop("notes"):
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
