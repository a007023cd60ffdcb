"""Functional NN primitives with the JAX package's layouts and numerics:
fp32 accumulation, layer norm in fp32, exact-erf GELU, NWC/WIO convs.

:func:`layer_norm` launches the fused kernel of ``csrc/layer_norm.cu`` on a
CUDA tensor (the JAX package's ``layer_norm`` is one XLA fusion on the TPU;
in PyTorch its plain body is about 12 launches) and runs the plain body,
:func:`layer_norm_plain`, on a CPU tensor; under autograd the kernel's
gradient is the plain body's."""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from janus_tpu_torch.ops import cuda_build
from janus_tpu_torch.ops.mixed_linear import (mixed_linear,
                                              mixed_linear_group,
                                              mixed_linear_plain, mixed_route)
from janus_tpu_torch.ops.quant import (DynQuantizedWeight, QuantizedWeight,
                                       dequant, linear_int8_dynamic)
from janus_tpu_torch.parallel.collectives import exit_model, model_size

__all__ = [
    "linear",
    "linear_into",
    "linear_gelu",
    "linear_group",
    "row_linear",
    "layer_norm",
    "layer_norm_plain",
    "layer_norm_fused",
    "add_layer_norm",
    "add_layer_norm_fused",
    "gelu",
    "conv1d",
    "embedding_lookup",
    "sinusoid_positions",
]


def linear(x: torch.Tensor, w,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[..., d_in] @ w[d_in, d_out] (+ b)``, result in ``x.dtype``.

    ``w`` may be a :class:`~janus_tpu_torch.ops.quant.DynQuantizedWeight`
    (the full int8 path) or a :class:`~janus_tpu_torch.ops.quant.
    QuantizedWeight` (dequantized to ``x.dtype``, then the plain product),
    as the JAX package's ``linear`` dispatches them.

    Operands of two dtypes are promoted as the JAX package promotes them
    (the activations' dtype wins). fp32 rows against a bf16 weight, as the
    TTS's AR step multiplies its fp32 mel re-entry through bf16 parameters,
    take :func:`~janus_tpu_torch.ops.mixed_linear.mixed_linear` where
    :func:`~janus_tpu_torch.ops.mixed_linear.mixed_route` names the kernel
    (at most 64 rows): on a CUDA tensor the port's own kernel, which reads
    the bf16 weight and widens it in registers; otherwise, and on the CPU,
    the weight is widened per call (``mixed_linear_plain``)."""
    if isinstance(w, DynQuantizedWeight):
        return linear_int8_dynamic(x, w, b)
    if isinstance(w, QuantizedWeight):
        w = dequant(w, x.dtype)
    if w.dtype != x.dtype:
        if _mixed_kernel(x, w):
            return mixed_linear(x, w, b)
        return mixed_linear_plain(x, w, b)
    if b is None:
        return torch.matmul(x, w)
    # Cast-back point: the JAX package keeps the product in fp32, adds the
    # bias in fp32 and rounds once. ``addmm`` does the same: cuBLAS(Lt)
    # adds the bias in its fp32 accumulator (bias epilogue, or beta = 1 on
    # a bias-filled output) and rounds to ``x.dtype`` once. Parameters are
    # cast to the compute dtype, so ``b.to(x.dtype)`` loses nothing.
    y = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return y.reshape(tuple(x.shape[:-1]) + (w.shape[-1],))


def linear_into(x: torch.Tensor, w, b: Optional[torch.Tensor],
                out: torch.Tensor) -> torch.Tensor:
    """:func:`linear` written into ``out`` (contiguous, of its shape and
    dtype) with the same ops, so the same bits, and no second buffer: the
    product's own output is ``out`` (the dense ``matmul`` / ``addmm`` with
    ``out=``, the int8 kernel's ``out``). A mixed-dtype product, and one
    that autograd records (``out=`` takes no gradient), is computed, then
    copied."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (x, w, b)):
        return out.copy_(linear(x, w, b))
    if isinstance(w, DynQuantizedWeight):
        return linear_int8_dynamic(x, w, b, out=out)
    if isinstance(w, QuantizedWeight):
        w = dequant(w, x.dtype)
    if w.dtype != x.dtype or not out.is_contiguous():
        return out.copy_(linear(x, w, b))
    if b is None:
        return torch.matmul(x, w, out=out)
    torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w,
                out=out.view(-1, w.shape[-1]))
    return out


def _mixed_kernel(x: torch.Tensor, w) -> bool:
    """Whether :func:`~janus_tpu_torch.ops.mixed_linear.mixed_route` names
    the mixed kernel for ``x`` against the plain tensor ``w``."""
    if not isinstance(w, torch.Tensor) or w.dtype == x.dtype:
        return False
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    return mixed_route(x.dtype, w.dtype, rows,
                       w.dim() == 2 and w.stride(-1) == 1) == "kernel"


def linear_gelu(x: torch.Tensor, w,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gelu(linear(x, w, b))`` (an MLP's first layer): where
    :func:`~janus_tpu_torch.ops.mixed_linear.mixed_route` names the mixed
    kernel, the GELU is taken in its epilogue (one launch, and on the CPU
    the same plain ops); otherwise :func:`linear`, then :func:`gelu`."""
    if _mixed_kernel(x, w):
        return mixed_linear(x, w, b, gelu=True)
    return gelu(linear(x, w, b))


def linear_group(x: torch.Tensor,
                 members: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]
                 ) -> List[torch.Tensor]:
    """``[linear(x, w, b) for (w, b) in members]`` for weights that read
    the same rows (q, k and v; the TTS's two heads): one launch of the
    mixed kernel (:func:`~janus_tpu_torch.ops.mixed_linear.
    mixed_linear_group`) where the route names it for every member,
    otherwise one :func:`linear` a member."""
    if all(_mixed_kernel(x, w) for w, _ in members):
        return mixed_linear_group(x, members)
    return [linear(x, w, b) for w, b in members]


def row_linear(x: torch.Tensor, w,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`linear` whose ``w`` is split by rows over the ``model``
    dimension of the current mesh (row parallel, see
    :func:`~janus_tpu_torch.parallel.collectives.use_mesh`): the partial
    products are summed over it, then the bias, which every rank holds
    whole, is added once, in fp32. Without tensor parallelism, exactly
    :func:`linear`."""
    if model_size() == 1:
        return linear(x, w, b)
    y = exit_model(linear(x, w))
    return y if b is None else (y.float() + b.float()).to(y.dtype)


LN_KERNEL = cuda_build.KERNELS["layer_norm"]
_LN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LN_MAX_WIDTH = 8192
# layer_norm_fwd(x, scale, bias, y, delta, delta_rows, d_dtype, r_out, rows,
#                d, x_dtype, p_dtype, eps, vec, stream)
_LN_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int]
                + [ctypes.c_void_p])


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """The JAX package's layer norm: x widened to fp32 (fp64 stays fp64),
    a two-pass mean and variance, the scale and bias in that dtype, one
    rounding to ``x.dtype``."""
    ct = torch.promote_types(x.dtype, torch.float32)  # fp32, or fp64
    xf = x.to(ct)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.to(ct) + bias.to(ct)).to(x.dtype)


def _ln_kernel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float, delta: Optional[torch.Tensor] = None):
    """One launch of the kernel: ``y``, or with ``delta`` ``(r, y)``."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm kernel: {x.device} is not a CUDA device")
    d = x.shape[-1]
    if x.dtype not in _LN_DTYPES or scale.dtype not in _LN_DTYPES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16 x and "
                        f"parameters, got {x.dtype}, {scale.dtype}")
    if bias.dtype != scale.dtype:
        raise TypeError(f"layer_norm kernel: scale {scale.dtype} and bias "
                        f"{bias.dtype} differ")
    if tuple(scale.shape) != (d,) or tuple(bias.shape) != (d,):
        raise ValueError(f"layer_norm kernel: scale {tuple(scale.shape)} and "
                         f"bias {tuple(bias.shape)} for width {d}")
    if not 1 <= d <= LN_MAX_WIDTH:
        raise ValueError(f"layer_norm kernel takes widths up to "
                         f"{LN_MAX_WIDTH}, got {d}")
    if not (scale.device == bias.device == x.device):
        raise ValueError(f"layer_norm: parameters are not on {x.device}")
    x = x.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    y = torch.empty_like(x)
    r = None if delta is None else torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y if r is None else (r, y)
    wide = 16 // x.element_size()
    if delta is None:
        vec = (wide if d % wide == 0 and x.data_ptr() % 16 == 0
               and y.data_ptr() % 16 == 0 else 1)
        d_ptr, d_rows, d_code, r_ptr, d_bytes, adds = None, 0, 0, None, 0, 0
    else:
        # the chunks the unfused pair's norm takes over a fresh r (the
        # width allows them: _fusable), inputs copied where they are not
        # aligned to one
        vec = wide
        delta = delta.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        if delta.data_ptr() % (vec * delta.element_size()):
            delta = delta.clone()
        d_ptr, d_rows = delta.data_ptr(), delta.numel() // d
        d_code, r_ptr = _LN_DTYPES[delta.dtype], r.data_ptr()
        d_bytes = delta.numel() * delta.element_size() \
            + x.numel() * x.element_size()
        adds = x.numel()
    fn = cuda_build.entry(LN_KERNEL, "layer_norm_fwd", _LN_ARGTYPES)
    # a sum, a deviation, its square and sum, then a subtraction and three
    # roundings' worth of multiply and add a value; a reciprocal root a row;
    # the residual's add a value (its delta read, r written)
    LN_KERNEL.launched(8.0 * x.numel() + rows + adds,
                       2 * x.numel() * x.element_size()
                       + 2 * d * scale.element_size() + d_bytes)
    code = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
              d_ptr, d_rows, d_code, r_ptr, rows, d, _LN_DTYPES[x.dtype],
              _LN_DTYPES[scale.dtype], eps, vec,
              torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(LN_KERNEL, code)
    return y if r is None else (r, y)


def layer_norm_fused(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """The kernel on a CUDA tensor: fp32 or bf16 ``x`` of width up to
    :data:`LN_MAX_WIDTH`, fp32 or bf16 ``scale`` and ``bias`` (one dtype);
    anything else raises."""
    return _ln_kernel(x, scale, bias, eps)


def _fusable(x: torch.Tensor, delta: torch.Tensor) -> bool:
    """Whether the kernel takes ``x + delta``: ``delta`` in ``x``'s dtype
    (or bf16 under fp32 ``x``: the sum is then fp32, as PyTorch promotes
    it), the shape of ``x``'s last axes (broadcast over the leading ones),
    and a width of whole 16-byte chunks of ``x``."""
    return (x.dtype in _LN_DTYPES and delta.device == x.device
            and x.shape[-1] % (16 // x.element_size()) == 0
            and (delta.dtype == x.dtype or (x.dtype == torch.float32
                                            and delta.dtype == torch.bfloat16))
            and 1 <= delta.dim() <= x.dim()
            and tuple(x.shape[x.dim() - delta.dim():]) == tuple(delta.shape))


def add_layer_norm_fused(x: torch.Tensor, delta: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5):
    """The kernel with the residual on a CUDA tensor: ``(r, y)``, ``r = x +
    delta`` rounded to ``x.dtype`` as PyTorch's add rounds it and ``y`` its
    layer norm, in one launch; ``delta`` as :func:`_fusable` says, the rest
    as :func:`layer_norm_fused` takes it; anything else raises."""
    if not _fusable(x, delta):
        raise TypeError(f"layer_norm kernel: cannot add delta "
                        f"{tuple(delta.shape)} {delta.dtype} to x "
                        f"{tuple(x.shape)} {x.dtype}")
    return _ln_kernel(x, scale, bias, eps, delta)


class _LayerNorm(torch.autograd.Function):
    """The kernel forward; the backward is the plain body's autograd
    gradient, as ``_FlashAttention`` does for K2."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return layer_norm_fused(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            xx, ss, bb = (t.detach().requires_grad_() for t in (x, scale,
                                                               bias))
            ref = layer_norm_plain(xx, ss, bb, ctx.eps)
            dx, ds, db = torch.autograd.grad(ref, (xx, ss, bb), g)
        return dx, ds, db, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis: the plain body for a CPU tensor, the
    kernel for a CUDA one (through :class:`_LayerNorm` where a gradient is
    asked for)."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return layer_norm_fused(x, scale, bias, eps)


def add_layer_norm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5):
    """``(r, layer_norm(r))`` with ``r = x + delta``: a residual add and the
    pre-norm that reads it. On a CUDA tensor, one launch of the kernel
    (:func:`add_layer_norm_fused`) where it takes the pair; otherwise (a
    ``delta`` of another dtype or shape), under autograd and on the CPU,
    the add and then :func:`layer_norm` (the plain body on the CPU,
    :class:`_LayerNorm` under autograd)."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, delta, scale, bias))
    if x.device.type == "cuda" and not grad and _fusable(x, delta):
        return add_layer_norm_fused(x, delta, scale, bias, eps)
    r = x + delta
    return r, layer_norm(r, scale, bias, eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """1-D convolution over ``x[..., T, C_in]`` (NWC) with ``w[K, C_in,
    C_out]`` (WIO), batched over any leading axes."""
    lead = x.shape[:-2]
    xb = x.reshape((-1,) + tuple(x.shape[-2:])).transpose(1, 2)
    y = F.conv1d(xb, w.permute(2, 1, 0), None, stride=stride, padding=padding)
    y = y.transpose(1, 2)
    if b is not None:
        # cuDNN hands back the product already rounded to a bf16 input's
        # dtype, so under bf16 the stem rounds twice (product, then
        # product + bias): one bf16 ulp apart at most; fp32 is identical
        y = (y.float() + b.float()).to(x.dtype)
    return y.reshape(tuple(lead) + tuple(y.shape[-2:]))


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def sinusoid_positions(length: int, channels: int,
                       max_timescale: float = 10_000.0,
                       device="cpu") -> torch.Tensor:
    """Whisper-style sinusoidal position embedding ``[length, channels]``:
    first half sin, second half cos, log-spaced timescales (float64 numpy,
    cast to float32). The table is made once per (shape, device) and
    shared by every caller, which must not write to it: an encode then
    uploads nothing, so a captured encode can run it."""
    return _sinusoid_table(int(length), int(channels), float(max_timescale),
                           torch.device(device))


@functools.lru_cache(maxsize=None)
def _sinusoid_table(length: int, channels: int, max_timescale: float,
                    device: torch.device) -> torch.Tensor:
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    emb = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)
