"""YIN block sums: the CUDA kernel ``csrc/yin_block_sums.cu`` (K3).

``bs[..., blk, τ] = Σ_{i<hop} x[blk·hop + i] · x[blk·hop + τ + i]`` over
the aubio slide-block stream layout, fp32. Replaces
``janus_tpu/ops/yin_pallas.py:_kernel`` (``block_sums``); the plain version
is the per-lag direct sum of ``janus_tpu/ops/yin.py:_block_sums_xla``,
the route the JAX package takes off the TPU. Bound on the H100: fp32
operations (~1 GFLOP at the 8 x 10 s flagship batch); the kernel stages
each block of rows once in shared memory so the signal is read from HBM
once instead of once per lag.

On a CPU tensor :func:`block_sums` computes the plain version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from janus_tpu_torch.ops import cuda_build

__all__ = ["block_sums", "block_sums_plain", "KERNEL"]

KERNEL = cuda_build.KERNELS["yin_block_sums"]

_TAU_CHUNK = 64  # lags per broadcast product in the plain version
# yin_block_sums(x, n_signals, t_len, nblk, hop, n_lags_out, out, stream)
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)


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
               n_lags_out: int) -> torch.Tensor:
    """``padded[..., T]`` → ``bs[..., nblk, n_lags_out]``."""
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
    fn = cuda_build.entry(KERNEL, "yin_block_sums", _ARGTYPES)
    KERNEL.launches += 1
    code = fn(x.data_ptr(), n_signals, t_len, nblk, hop, n_lags_out,
              out.data_ptr(),
              torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(KERNEL, code)
    return out.reshape(tuple(batch) + (nblk, n_lags_out))
