"""YIN block sums: the CUDA kernel ``csrc/yin_block_sums.cu`` (K3).

``bs[..., blk, τ] = Σ_{i<hop} x[blk·hop + i] · x[blk·hop + τ + i]`` over
the aubio slide-block stream layout, fp32. Replaces
``janus_tpu/ops/yin_pallas.py:_kernel`` (``block_sums``); the plain version
is the per-lag direct sum of ``janus_tpu/ops/yin.py:_block_sums_xla``,
the route the JAX package takes off the TPU. Bound on the H100: fp32
operations (~1 GFLOP at the 8 x 10 s flagship batch). Route ``"tiled"``
(the default) tiles the lag axis in registers: a thread owns eight
consecutive lags and a sliding window of the lagged samples, so one
16-byte shared-memory load feeds 16 FMAs and the FMA pipe, not the load
pipe, sets the pace; :func:`plan_rows` sizes a block's rows to its shared
memory and its 256 threads. Route ``"simple"`` is one thread per output
with two loads per FMA; both sum over ``i`` in index order with one
``fmaf`` chain per output, so their results are equal bit for bit, and
``block_sums(..., route="simple")`` times the two on the same tensor.

On a CPU tensor :func:`block_sums` computes the plain version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from janus_tpu_torch.ops import cuda_build

__all__ = ["block_sums", "block_sums_plain", "plan_rows", "RowPlan",
           "ROUTES", "KERNEL"]

KERNEL = cuda_build.KERNELS["yin_block_sums"]

ROUTES = ("tiled", "simple")
_TAU_CHUNK = 64  # lags per broadcast product in the plain version
_TL = 8                   # lags per thread, as TL in the source
_THREADS = 256            # threads per block, as NT in the source
_SMEM_LIMIT = 232_448     # bytes of shared memory a block can use (H100)
_MAX_ROWS = 16
_SKEW_BYTES = 32         # 4 words between the copies and before the sums
# yin_block_sums_tiled(x, n_signals, t_len, nblk, hop, n_lags, rows, groups,
#                      pitch, out, stream)
_TILED_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 2)
# yin_block_sums_simple(x, n_signals, t_len, nblk, hop, n_lags, out, stream)
_SIMPLE_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                    + [ctypes.c_void_p] * 2)


class RowPlan(NamedTuple):
    """How the tiled kernel lays a block out."""
    rows: int         # hop blocks (rows of sums) per thread block
    groups: int       # groups of 8 lags per row
    pitch: int        # words between staged rows in shared memory
    smem_bytes: int   # both copies of the staged rows plus the sums


def plan_rows(hop: int, n_lags: int) -> RowPlan:
    """Rows per block for the tiled kernel. Each row is staged on its own
    (``round4(hop) + 8·groups + 8`` words, rounded up to 32), twice (the
    second copy skewed by 4 banks), and its sums leave through shared
    memory too. Among the row counts that fit, and
    that leave room for two blocks on an SM where any does, take the one
    whose ``rows × groups`` work items fill whole passes of the block's
    256 threads best (the fewest rows on a tie). Raises if one row does
    not fit the 227 KB a block can use."""
    if hop < 1 or n_lags < 1:
        raise ValueError(f"hop and n_lags must be positive, got {hop}, "
                         f"{n_lags}")
    groups = -(-n_lags // _TL)
    pitch = -(-(-(-hop // 4) * 4 + _TL * groups + 8) // 32) * 32
    row_bytes = 4 * (2 * pitch + _TL * groups)
    if row_bytes + _SKEW_BYTES > _SMEM_LIMIT:
        raise ValueError(
            f"yin block sums: one row of hop {hop} and {n_lags} lags needs "
            f"{row_bytes} bytes of shared memory, over {_SMEM_LIMIT}")
    fits = min(_MAX_ROWS,
               max(1, (_SMEM_LIMIT // 2 - _SKEW_BYTES) // row_bytes))

    def fill(rows: int) -> float:
        items = rows * groups
        return items / (-(-items // _THREADS) * _THREADS)

    rows = max(range(1, fits + 1), key=lambda r: (fill(r), -r))
    return RowPlan(rows, groups, pitch, rows * row_bytes + _SKEW_BYTES)


def _rows_view(x: torch.Tensor, nblk: int, hop: int, n_lags_out: int):
    """``[b, T]`` → (leading samples ``[b, nblk, hop]``, row spans
    ``[b, nblk, hop - 1 + n_lags_out]``), zero-extending the tail."""
    span = hop - 1 + n_lags_out
    need = (nblk - 1) * hop + span
    if x.shape[-1] < need:
        x = F.pad(x, (0, need - x.shape[-1]))
    first = x[:, :nblk * hop].reshape(x.shape[0], nblk, hop)
    rows = x.unfold(-1, span, hop)[:, :nblk]
    return first, rows


def block_sums_plain(padded: torch.Tensor, nblk: int, hop: int,
                     n_lags_out: int) -> torch.Tensor:
    """Per-lag shifted-product sums ``[..., nblk, n_lags_out]`` in PyTorch
    (the plain version of the kernel)."""
    batch = padded.shape[:-1]
    x = padded.float().reshape(-1, padded.shape[-1])
    first, rows = _rows_view(x, nblk, hop, n_lags_out)
    out = torch.empty((x.shape[0], nblk, n_lags_out), dtype=torch.float32,
                      device=x.device)
    for t0 in range(0, n_lags_out, _TAU_CHUNK):
        tc = min(_TAU_CHUNK, n_lags_out - t0)
        seg = rows[..., t0:t0 + tc + hop - 1].unfold(-1, hop, 1)
        out[..., t0:t0 + tc] = (first[:, :, None, :] * seg).sum(-1)
    return out.reshape(tuple(batch) + (nblk, n_lags_out))


def block_sums(padded: torch.Tensor, nblk: int, hop: int,
               n_lags_out: int, route: str = "tiled") -> torch.Tensor:
    """``padded[..., T]`` → ``bs[..., nblk, n_lags_out]``. ``route`` picks
    the kernel on the card (``"simple"`` is the yardstick of the tiled
    one); a CPU tensor takes the plain version whatever the route."""
    if route not in ROUTES:
        raise ValueError(f"block_sums route must be one of {ROUTES}, got "
                         f"{route!r}")
    if padded.device.type == "cpu":
        return block_sums_plain(padded, nblk, hop, n_lags_out)
    if padded.device.type != "cuda":
        raise ValueError(f"block_sums: unsupported device {padded.device}")
    if padded.dtype != torch.float32:
        raise TypeError(f"block_sums takes float32, got {padded.dtype}")
    batch = padded.shape[:-1]
    x = padded.reshape(-1, padded.shape[-1]).contiguous()
    n_signals, t_len = x.shape
    out = torch.empty((n_signals, nblk, n_lags_out), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    flops = 2.0 * n_signals * nblk * n_lags_out * hop
    nbytes = 4 * (x.numel() + out.numel())
    if route == "tiled":
        plan = plan_rows(hop, n_lags_out)
        fn = cuda_build.entry(KERNEL, "yin_block_sums_tiled",
                              _TILED_ARGTYPES)
        KERNEL.launched(flops, nbytes)
        code = fn(x.data_ptr(), n_signals, t_len, nblk, hop, n_lags_out,
                  plan.rows, plan.groups, plan.pitch, out.data_ptr(), stream)
    else:
        fn = cuda_build.entry(KERNEL, "yin_block_sums_simple",
                              _SIMPLE_ARGTYPES)
        KERNEL.launched(flops, nbytes)
        code = fn(x.data_ptr(), n_signals, t_len, nblk, hop, n_lags_out,
                  out.data_ptr(), stream)
    cuda_build.check_launch(KERNEL, code)
    return out.reshape(tuple(batch) + (nblk, n_lags_out))
