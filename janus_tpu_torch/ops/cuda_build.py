"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/janus_tpu_torch/lib<name>.so`` at the repository root; the
library is loaded with ``ctypes``. A library is rebuilt when its source
is newer. Nothing here runs at import time: :func:`library` builds at a
kernel's first launch, :func:`build_all` builds every kernel with one
``nvcc`` process per source, all started together. :func:`entry` hands a
wrapper its C function with the ``ctypes`` signature set once, when the
function is first asked for, not at every launch. Each build and each
load is a ``setup.kernel`` span (``kernel``, ``built``) and counts in
:attr:`Kernel.builds` or :attr:`Kernel.loads`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

from janus_tpu_torch.runtime.profiling import span

__all__ = ["Kernel", "KERNELS", "library", "entry", "build_all",
           "check_launch", "BUILD_DIR", "CSRC_DIR"]

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "janus_tpu_torch"

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]


class Kernel:
    """One hand-written kernel: its source, its loaded library, and the
    count of launches its wrapper made (a plain integer; a caller resets
    it to 0 before a run and reads it after), with the least work those
    launches needed: ``flops`` (the operations of the function computed)
    and ``bytes`` (each input read once, each output written once);
    ``builds`` and ``loads`` count its library's builds and loads in this
    process."""

    def __init__(self, name: str, replaces: str):
        self.name = name
        self.replaces = replaces
        self.builds = 0
        self.loads = 0
        self.launches = 0
        self.flops = 0.0
        self.bytes = 0.0
        self._lib: Optional[ctypes.CDLL] = None
        self._entries: Dict[str, Callable] = {}

    @property
    def source(self) -> Path:
        return CSRC_DIR / f"{self.name}.cu"

    @property
    def library_path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}.so"

    def launched(self, flops: float, nbytes: float) -> None:
        """Count one launch of the kernel and the work it was given."""
        self.launches += 1
        self.flops += flops
        self.bytes += nbytes

    def stale(self) -> bool:
        so = self.library_path
        return not so.exists() or so.stat().st_mtime < self.source.stat().st_mtime


# every kernel of the port, by source name, with what it replaces: the
# Pallas kernel (file:line of its ``_kernel``), or for the port's own
# kernels the JAX function that XLA compiles on the TPU
KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    Kernel("mel_fused", "janus_tpu/ops/mel_pallas.py:68 (_kernel)"),
    Kernel("flash_attn", "janus_tpu/ops/flash.py:41 (_kernel)"),
    Kernel("yin_block_sums", "janus_tpu/ops/yin_pallas.py:42 (_kernel)"),
    Kernel("cross_attn_int8", "janus_tpu/ops/cross_attn.py:50 (_kernel)"),
    Kernel("layer_norm", "janus_tpu/ops/layers.py:46 layer_norm (one XLA "
           "fusion; no Pallas kernel)"),
    Kernel("decode_attn", "janus_tpu/ops/attention.py:43 attend at decode "
           "widths (XLA; no Pallas kernel)"),
    Kernel("int8_linear", "janus_tpu/ops/quant.py:144 linear_int8_dynamic "
           "(XLA int8 dot_general; no Pallas kernel)"),
    Kernel("mixed_linear", "janus_tpu/ops/layers.py:40 linear, mixed dtypes "
           "(XLA fuses the convert into the dot; no Pallas kernel)"),
    Kernel("loop_graph", "janus_tpu/models/asr.py:546 and janus_tpu/models/"
           "tts.py:393 lax.while_loop's cond (XLA; no Pallas kernel)"),
)}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on the machine with the card")


def _start_build(k: Kernel) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = k.library_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(k.source)]
    # builds run side by side: each span is closed, not nested
    traced = span("setup.kernel", kernel=k.name, built=1)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    proc.traced = traced  # type: ignore[attr-defined]
    return proc


def _finish_build(k: Kernel, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    proc.traced.close()  # type: ignore[attr-defined]
    tmp = proc.tmp_path  # type: ignore[attr-defined]
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed for {k.source}:\n{out}")
    os.replace(tmp, k.library_path)
    k.builds += 1


def build_all() -> float:
    """Build every stale kernel library (one nvcc per source, in
    parallel); returns the wall seconds it took."""
    t0 = time.perf_counter()
    procs = [(k, _start_build(k)) for k in KERNELS.values() if k.stale()]
    errors = []
    for k, p in procs:
        try:
            _finish_build(k, p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(k: Kernel) -> ctypes.CDLL:
    """The kernel's loaded library, built first if missing or stale."""
    if k._lib is None:
        if k.stale():
            _finish_build(k, _start_build(k))
        with span("setup.kernel", kernel=k.name, built=0):
            lib = ctypes.CDLL(str(k.library_path))
        k.loads += 1
        lib.jt_error_string.argtypes = [ctypes.c_int]
        lib.jt_error_string.restype = ctypes.c_char_p
        k._lib = lib
    return k._lib


def entry(k: Kernel, name: str, argtypes: Sequence) -> Callable:
    """The C launcher ``name`` of the kernel's library (every launcher
    returns a CUDA error code as ``int``), its signature set at the first
    request and the function kept for the later ones."""
    fn = k._entries.get(name)
    if fn is None:
        fn = getattr(library(k), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        k._entries[name] = fn
    return fn


def check_launch(k: Kernel, code: int) -> None:
    """Raise if the C launcher reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = library(k).jt_error_string(code).decode()
        raise RuntimeError(f"{k.name}: CUDA error {code}: {msg}")
