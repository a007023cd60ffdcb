"""The mixed-dtype linear: the CUDA kernel ``csrc/mixed_linear.cu``.

The port's own kernel (the JAX package's ``linear``, ``janus_tpu/ops/
layers.py:40``, is one ``jnp.dot`` with ``preferred_element_type=float32``;
under fp32 activations and bf16 weights XLA fuses the weight's convert
into the dot on the TPU; no Pallas kernel). The TTS's AR step re-enters
from its fp32 mel buffer, so every linear of the step multiplies fp32 rows
by bf16 weights. :func:`mixed_linear_plain` is the function in plain
PyTorch: both operands promoted (the weight widened to an fp32 copy on
every call), one product with the bias, the result in ``x.dtype``.

:func:`mixed_linear` launches the kernel on a CUDA tensor: fp32 ``x[...,
K]`` at 1 to :data:`MAX_ROWS` rows against a bf16 ``w[K, N]`` read
row-major as the tree holds it (N contiguous), an optional fp32 or bf16
bias. Each weight value is widened in registers and multiplied into fp32
sums; the bias is added once after the whole sum, as the JAX package adds
it. The weight streams over :func:`plan_splits` blocks a 64-column tile,
whose split-K partial sums are added in a fixed order: the same inputs
give the same bits on every launch (a captured step replays bit-equal to
the eager one). :func:`mixed_route` says which operands take the kernel;
:func:`~janus_tpu_torch.ops.layers.linear` widens per call above
:data:`MAX_ROWS` rows and for other dtype pairs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from janus_tpu_torch.ops import cuda_build

__all__ = ["mixed_linear", "mixed_linear_plain", "mixed_route",
           "plan_splits", "plan_rows", "vector_loads",
           "KERNEL", "MAX_ROWS", "COLUMNS"]

KERNEL = cuda_build.KERNELS["mixed_linear"]

MAX_ROWS = 64     # rows the kernel takes
COLUMNS = 64      # output columns of a block
MAX_SPLITS = 8    # blocks (a cluster) of one column tile
UNIT = 8          # a split's range of K starts on a multiple of 8
MIN_RANGE = 64    # k-rows a split takes at least
_BIAS = {torch.float32: 0, torch.bfloat16: 1}
# mixed_linear_fwd(x, w, ld, bias, b_dtype, y, m, k, n, splits, rows, vec,
#                  stream)
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def mixed_linear_plain(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)`` for operands of two dtypes, as the JAX package
    promotes them: both operands in the promoted dtype for the product,
    the bias added in it, the result in ``x.dtype`` (the activations'
    dtype wins, never the weights')."""
    ct = torch.promote_types(x.dtype, w.dtype)
    x2 = x.reshape(-1, x.shape[-1]).to(ct)
    y = (torch.matmul(x2, w.to(ct)) if b is None
         else torch.addmm(b.to(ct), x2, w.to(ct)))
    return y.to(x.dtype).reshape(tuple(x.shape[:-1]) + (w.shape[-1],))


def mixed_route(x_dtype: torch.dtype, w_dtype: torch.dtype, rows: int,
                n_contiguous: bool = True) -> str:
    """``"kernel"`` for fp32 rows against a bf16 weight laid out with N
    contiguous, at 1 to :data:`MAX_ROWS` rows; ``"widen"`` (the per-call
    promotion of :func:`mixed_linear_plain`) otherwise: no main-path call
    has more than 8 mixed rows, and the TTS prefill is bf16 x bf16."""
    if (x_dtype == torch.float32 and w_dtype == torch.bfloat16
            and 1 <= rows <= MAX_ROWS and n_contiguous):
        return "kernel"
    return "widen"


def plan_splits(m: int, k: int, n: int, sms: int = 132) -> int:
    """Blocks a 64-column tile (1, 2, 4 or 8, each a range of K): the
    fewest that put a block on every one of ``sms`` SMs, each range at
    least :data:`MIN_RANGE` k-rows (on the H100: 8 for the AR step's
    1280-wide outputs and its 320-wide head, 2 for fc1's 80 tiles, 4 for
    the prenet's K of 320; more splits add a cluster reduction and blocks
    that wait their turn). 0 where ``m`` is outside the kernel's rows."""
    if not 1 <= m <= MAX_ROWS:
        return 0
    tiles = -(-n // COLUMNS)
    splits = 1
    while (splits < MAX_SPLITS and tiles * splits < sms
           and k >= 2 * splits * MIN_RANGE):
        splits *= 2
    return splits


def plan_rows(m: int) -> int:
    """Rows of x a thread's group holds (1, 2, 4 or 8; at most 8 groups):
    ``m`` itself up to 2 rows, 4 up to 32, else 8. Groups of 4 rows were
    the fastest at 8, 16 and 32 rows on the H100 (fewer k-lanes, so fewer
    partial sums to add across the block, against the groups' repeated
    weight loads from L1)."""
    if m <= 2:
        return max(m, 1)
    return 4 if m <= 32 else 8


def vector_loads(n: int, ld: int, w_ptr: int) -> bool:
    """Whether the kernel loads the weight 16 bytes (8 values) at a time:
    N and the row stride multiples of 8, the weight 16-byte aligned;
    otherwise a value at a time, the ragged edge zero-filled."""
    return n % 8 == 0 and ld % 8 == 0 and w_ptr % 16 == 0


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            splits: Optional[int] = None,
            rows: Optional[int] = None) -> torch.Tensor:
    """One launch of the kernel; ``splits`` and ``rows`` override
    :func:`plan_splits` and :func:`plan_rows`."""
    if x.device.type != "cuda":
        raise ValueError(f"mixed_linear kernel: {x.device} is not a CUDA "
                         f"device")
    if x.dtype != torch.float32 or w.dtype != torch.bfloat16:
        raise TypeError(f"mixed_linear kernel takes float32 x against a "
                        f"bfloat16 weight, got {x.dtype}, {w.dtype}")
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"mixed_linear kernel: x {tuple(x.shape)} against "
                         f"a weight {tuple(w.shape)}")
    k, n = w.shape
    if w.stride(1) != 1 or w.stride(0) < n:
        raise ValueError(f"mixed_linear kernel: the weight [{k}, {n}] has "
                         f"strides {w.stride()}; it reads N contiguous")
    if b is not None and (b.dtype not in _BIAS or tuple(b.shape) != (n,)):
        raise TypeError(f"mixed_linear kernel: the bias is [{n}] fp32 or "
                        f"bf16, got {b.dtype} {tuple(b.shape)}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError(f"mixed_linear kernel: the weight is not on "
                         f"{x.device}")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    if m > MAX_ROWS:
        raise ValueError(f"mixed_linear kernel takes at most {MAX_ROWS} "
                         f"rows, got {m}")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m > 0:
        if splits is None:
            splits = plan_splits(m, k, n, _sm_count(x.device))
        if rows is None:
            rows = plan_rows(m)
        b = None if b is None else b.contiguous()
        fn = cuda_build.entry(KERNEL, "mixed_linear_fwd", _ARGTYPES)
        # the product's multiply-adds (and the bias's adds); x, the bf16
        # weight and the bias read once, y written once
        KERNEL.launched(
            2.0 * m * k * n + (0 if b is None else m * n),
            4 * m * k + 2 * k * n + 4 * m * n
            + (0 if b is None else n * b.element_size()))
        code = fn(x2.data_ptr(), w.data_ptr(), w.stride(0),
                  None if b is None else b.data_ptr(),
                  0 if b is None else _BIAS[b.dtype], y.data_ptr(), m, k, n,
                  splits, rows,
                  int(vector_loads(n, w.stride(0), w.data_ptr())),
                  torch.cuda.current_stream(x.device).cuda_stream)
        cuda_build.check_launch(KERNEL, code)
    return y.reshape(tuple(x.shape[:-1]) + (n,))


class _MixedLinear(torch.autograd.Function):
    """The kernel forward; the backward is the plain product's autograd
    gradient, as ``_LayerNorm`` does for the layer norm."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return _launch(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        with torch.enable_grad():
            xx, ww = (t.detach().requires_grad_() for t in (x, w))
            bb = None if b is None else b.detach().requires_grad_()
            ref = mixed_linear_plain(xx, ww, bb)
            ins = (xx, ww) if bb is None else (xx, ww, bb)
            grads = torch.autograd.grad(ref, ins, g)
        return grads if bb is not None else grads + (None,)


def mixed_linear(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)``: the plain version for a CPU tensor, the kernel for a
    CUDA one (through :class:`_MixedLinear` where a gradient is asked for);
    a CUDA input that the kernel does not take raises."""
    if x.device.type == "cpu":
        return mixed_linear_plain(x, w, b)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return _MixedLinear.apply(x, w, b)
    return _launch(x, w, b)
