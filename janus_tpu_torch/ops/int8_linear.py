"""The dynamic-int8 linear: the CUDA kernel ``csrc/int8_linear.cu``.

The port's own kernel (the JAX package's ``linear_int8_dynamic``,
``janus_tpu/ops/quant.py:144``, is one XLA fusion around an int8
``dot_general`` on the TPU; no Pallas kernel). :func:`int8_linear_plain` is
the function, in plain PyTorch about 15 launches a call:

- ``x_scale = max(amax_k |float(x)|, 1e-8) / 127`` per row (IEEE division);
- ``xq = int8(clamp(round_half_even(float(x) / x_scale), -127, 127))``;
- ``acc = xq @ q``, int32 and exact;
- ``y = (float(acc) * x_scale) * scale``, two roundings in that order, then
  ``+ float(b)``, then one cast to ``x.dtype``.

:func:`int8_linear` launches the kernel on a CUDA tensor: two launches, the
per-row quantization and the tensor-core product with the rescale, bias and
cast in its epilogue, bit-equal to the plain version (the int32 sums are
exact, so their order is free; every float operation is rounded as the plain
version rounds it). The product streams the weight for a decode step's few
rows (at most :data:`STREAM_ROWS`: ``plan_splits`` blocks a channel tile,
splitting K so that every SM streams) and walks the tiles of an encoder's
many on one persistent block an SM through warpgroup products (``wgmma``).
It reads the weight K-contiguous: ``q[K, N]`` with strides ``(1, K)``, the
transposed view of a ``[N, K]`` copy that
:func:`janus_tpu_torch.ops.quant.column_major` makes once for a tree; it
raises on a row-major weight rather than transposing it on every call.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from janus_tpu_torch.ops import cuda_build

__all__ = ["int8_linear", "int8_linear_plain", "plan_splits", "use_pdl",
           "k_contiguous", "KERNEL", "STREAM_ROWS", "STREAM_CHANNELS"]

KERNEL = cuda_build.KERNELS["int8_linear"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STREAM_ROWS = 64      # rows at or under which the weight is streamed
STREAM_CHANNELS = 64  # output channels of a streaming block
MAX_SPLITS = 8        # streaming blocks (a cluster) of one channel tile
K_STEP = 32           # bytes of k one tensor-core product takes
# rows up to which the streamed product overlaps the quantization: on the
# H100 faster at every decode shape at 8 rows and at most at 32, mixed at 64
# (chip_smoke.py's pdl_ms and no_pdl_ms)
PDL_ROWS = 32
# int8_linear_fwd(x, x_dtype, xq, xs, w, w_stride, ws, ws_dtype, bias,
#                 b_dtype, y, m, k, n, splits, pdl, stream)
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])

_DIVISORS: dict = {}


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` in ``amax``'s dtype, rounded as an IEEE
    division on every device: CUDA divides by a Python scalar as a product
    with its reciprocal, which can miss by an ulp, so the divisor is a
    tensor on ``amax``'s device. (The rule of every quantizer in
    :mod:`janus_tpu_torch.ops.quant` too.)"""
    key = (amax.dtype, amax.device)
    div = _DIVISORS.get(key)
    if div is None:
        div = _DIVISORS[key] = torch.full((), 127.0, dtype=amax.dtype,
                                          device=amax.device)
    return torch.clamp_min(amax, 1e-8) / div


def _round_int8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def _int8_product(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``xq[M, K] int8 @ q[K, N] int8 -> int32 [M, N]``, exact: the CPU's
    int8 product, or on the card a float64 product (every partial sum is an
    integer far below 2^53)."""
    if xq.device.type == "cpu":
        return torch._int_mm(xq, q)
    return torch.matmul(xq.double(), q.double()).to(torch.int32)


def int8_linear_plain(x: torch.Tensor, qw,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The function in plain PyTorch, in the JAX package's order; ``qw`` is
    any ``(q, scale)`` pair."""
    xf = x.float()
    x_scale = _scale_of(xf.abs().amax(dim=-1, keepdim=True))
    xq = _round_int8(xf / x_scale)
    acc = _int8_product(xq.reshape(-1, x.shape[-1]), qw.q)
    acc = acc.reshape(tuple(x.shape[:-1]) + (qw.q.shape[-1],))
    y = acc.float() * x_scale * qw.scale
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def k_contiguous(q: torch.Tensor) -> bool:
    """Whether ``q[K, N]`` is laid out as the kernel reads it: K contiguous
    (strides ``(1, K)`` or wider rows), rows 16-byte aligned."""
    return (q.dim() == 2 and q.stride(0) == 1 and q.stride(1) >= q.shape[0]
            and q.stride(1) % 16 == 0 and q.data_ptr() % 16 == 0)


def plan_splits(m: int, k: int, n: int, sms: int = 132) -> int:
    """The streaming product's blocks a channel tile (1, 2, 4 or 8, each a
    range of K of at least one k-step of 32): the fewest that give four
    blocks an SM of ``sms`` (on the H100 every decode shape of large-v3
    takes 8). 0 where ``m`` is above :data:`STREAM_ROWS` (the warpgroup
    product, which tiles the rows)."""
    if m > STREAM_ROWS:
        return 0
    tiles = -(-n // STREAM_CHANNELS)
    splits = 1
    while (splits < MAX_SPLITS and tiles * splits < 4 * sms
           and k // K_STEP >= 2 * splits):
        splits *= 2
    return splits


def use_pdl(m: int) -> bool:
    """Whether the product is launched programmatically (its weight loads
    then overlap the quantization): the streaming product up to
    :data:`PDL_ROWS` rows, the warpgroup product above :data:`STREAM_ROWS`
    (there the quantization is programmatic too, overlapping the kernel
    before it)."""
    return m <= PDL_ROWS or m > STREAM_ROWS


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _launch(x: torch.Tensor, qw, b: Optional[torch.Tensor],
            splits: Optional[int] = None, pdl: Optional[bool] = None,
            out: Optional[torch.Tensor] = None):
    """One call of the kernel: ``(y, xq, x_scale)``, the quantized rows and
    their scales as the first launch wrote them. ``splits`` and ``pdl``
    override :func:`plan_splits` (0: the warpgroup product, at any row
    count) and :func:`use_pdl`; ``y`` is ``out`` where one is given."""
    q, scale = qw.q, qw.scale
    if x.device.type != "cuda":
        raise ValueError(f"int8_linear kernel: {x.device} is not a CUDA "
                         f"device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_linear kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"int8_linear kernel: the weight is {q.dtype} of "
                        f"{q.dim()} dims, not 2-d int8")
    k, n = q.shape
    if x.shape[-1] != k or k % K_STEP:
        raise ValueError(f"int8_linear kernel: x {tuple(x.shape)} against a "
                         f"[{k}, {n}] weight (K a multiple of {K_STEP})")
    params = (scale,) if b is None else (scale, b)
    if any(t.device != x.device for t in (q,) + params):
        raise ValueError(f"int8_linear kernel: the weight is not on "
                         f"{x.device}")
    if any(t.dtype not in _DTYPES or tuple(t.shape) != (n,) for t in params):
        got = [(t.dtype, tuple(t.shape)) for t in params]
        raise TypeError(f"int8_linear kernel: scale and bias are [{n}] fp32 "
                        f"or bf16, got {got}")
    if not k_contiguous(q):
        raise ValueError(
            f"int8_linear kernel: the weight [{k}, {n}] has strides "
            f"{q.stride()}; it reads K contiguous (strides (1, {k})): "
            f"convert the tree once with janus_tpu_torch.ops.quant."
            f"column_major")
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # a view into a row: the kernel loads 16 bytes
        x2 = x2.clone()
    m = x2.shape[0]
    if out is None:
        y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    elif (out.dtype != x.dtype or out.device != x.device
          or tuple(out.shape) != tuple(x.shape[:-1]) + (n,)
          or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(
            f"int8_linear kernel: out {out.dtype} {tuple(out.shape)} on "
            f"{out.device} is not a contiguous, 16-byte aligned "
            f"{x.dtype} {tuple(x.shape[:-1]) + (n,)} on {x.device}")
    else:
        y = out.view(m, n)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m > 0:
        if splits is None:
            splits = plan_splits(m, k, n, _sm_count(x.device))
        if pdl is None:
            pdl = use_pdl(m)
        # a copy's kernel may run just before: both products read the
        # scales and bias only after they wait
        scale = scale.contiguous()
        b = None if b is None else b.contiguous()
        fn = cuda_build.entry(KERNEL, "int8_linear_fwd", _ARGTYPES)
        # the product's multiply-adds; x, the weight and its scales, the
        # bias read once, y written once
        KERNEL.launched(
            2.0 * m * k * n,
            x2.numel() * x2.element_size() + k * n
            + sum(t.numel() * t.element_size() for t in params)
            + y.numel() * y.element_size())
        code = fn(x2.data_ptr(), _DTYPES[x.dtype], xq.data_ptr(),
                  xs.data_ptr(), q.data_ptr(), q.stride(1), scale.data_ptr(),
                  _DTYPES[scale.dtype], None if b is None else b.data_ptr(),
                  0 if b is None else _DTYPES[b.dtype], y.data_ptr(), m, k,
                  n, splits, int(pdl),
                  torch.cuda.current_stream(x.device).cuda_stream)
        cuda_build.check_launch(KERNEL, code)
    lead = tuple(x.shape[:-1])
    return (y.reshape(lead + (n,)), xq.reshape(lead + (k,)),
            xs.reshape(lead + (1,)))


def int8_linear(x: torch.Tensor, qw,
                b: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on a CUDA tensor: fp32 or bf16 ``x[..., K]``, ``qw`` a
    ``(q, scale)`` pair with ``q[K, N]`` int8 K-contiguous (see
    :func:`k_contiguous`), K a multiple of 32, ``scale`` and ``b`` ``[N]``
    fp32 or bf16; anything else raises. ``out`` (contiguous ``[..., N]`` in
    x's dtype) is where the product writes ``y``."""
    return _launch(x, qw, b, out=out)[0]
