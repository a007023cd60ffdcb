"""The mixed-dtype linear: the CUDA kernel ``csrc/mixed_linear.cu``.

The port's own kernel (the JAX package's ``linear``, ``janus_tpu/ops/
layers.py:40``, is one ``jnp.dot`` with ``preferred_element_type=float32``;
under fp32 activations and bf16 weights XLA fuses the weight's convert
into the dot on the TPU; no Pallas kernel). The TTS's AR step re-enters
from its fp32 mel buffer, so every linear of the step multiplies fp32 rows
by bf16 weights. :func:`mixed_linear_plain` is the function in plain
PyTorch: both operands promoted (the weight widened to an fp32 copy on
every call), one product with the bias, the result in ``x.dtype``; with
``gelu`` the exact GELU of that.

:func:`mixed_linear` launches the kernel on a CUDA tensor: fp32 ``x[...,
K]`` at 1 to :data:`MAX_ROWS` rows against a bf16 ``w[K, N]`` read
row-major as the tree holds it (N contiguous), an optional fp32 or bf16
bias, and optionally the exact GELU in the kernel's epilogue (fc1's
calls). Each weight value is widened in registers and multiplied into fp32
sums; the bias is added once after the whole sum, as the JAX package adds
it. :func:`mixed_linear_group` is one launch for up to :data:`MAX_MEMBERS`
weights that read the same rows (q, k and v; the mel and stop heads), one
output a weight. The weight streams over :func:`plan_splits` (for a group
:func:`plan_group`) blocks a 64-column tile, whose split-K partial sums
are added in a fixed order: the same inputs give the same bits on every
launch (a captured step replays bit-equal to the eager one). Launches are
programmatic where :func:`use_pdl` says: the kernel starts while the
kernel before it runs, asks the L2 cache for its weight, and reads nothing
before that kernel has finished. :func:`mixed_route` says which operands
take the kernel; :func:`~janus_tpu_torch.ops.layers.linear` widens per
call above :data:`MAX_ROWS` rows and for other dtype pairs.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from janus_tpu_torch.ops import cuda_build

__all__ = ["mixed_linear", "mixed_linear_group", "mixed_linear_plain",
           "mixed_route", "plan_splits", "plan_group", "plan_rows",
           "use_pdl", "vector_loads", "GroupPlan", "KERNEL", "MAX_ROWS",
           "MAX_MEMBERS", "COLUMNS"]

KERNEL = cuda_build.KERNELS["mixed_linear"]

MAX_ROWS = 64     # rows the kernel takes
MAX_MEMBERS = 4   # weights a launch
COLUMNS = 64      # output columns of a block
MAX_SPLITS = 8    # blocks (a cluster) of one column tile
UNIT = 8          # a split's range of K starts on a multiple of 8
MIN_RANGE = 64    # k-rows a split takes at least
_BIAS = {torch.float32: 0, torch.bfloat16: 1}
# mixed_linear_fwd(x, m, k, count, members, splits, rows, act, pdl, stream);
# members: seven int64 a weight (w, ld, bias, b_dtype, y, n, vec)
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])

Member = Tuple[torch.Tensor, Optional[torch.Tensor]]


def mixed_linear_plain(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None,
                       gelu: bool = False) -> torch.Tensor:
    """``x @ w (+ b)`` for operands of two dtypes, as the JAX package
    promotes them: both operands in the promoted dtype for the product,
    the bias added in it, the result in ``x.dtype`` (the activations'
    dtype wins, never the weights'); with ``gelu``, the exact (erf) GELU
    of that result."""
    ct = torch.promote_types(x.dtype, w.dtype)
    x2 = x.reshape(-1, x.shape[-1]).to(ct)
    y = (torch.matmul(x2, w.to(ct)) if b is None
         else torch.addmm(b.to(ct), x2, w.to(ct)))
    y = y.to(x.dtype).reshape(tuple(x.shape[:-1]) + (w.shape[-1],))
    return F.gelu(y, approximate="none") if gelu else y


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
    1280-wide outputs, 2 for fc1's 80 tiles, 4 for the prenet's K of 320;
    more splits add a cluster reduction and blocks that wait their turn).
    0 where ``m`` is outside the kernel's rows."""
    return plan_group(m, k, [n], sms).splits


class GroupPlan(NamedTuple):
    """A launch over several weights: each member's first column tile in
    the grid, the tiles of all members, the blocks a tile and the rows a
    thread's group."""

    tile0: Tuple[int, ...]
    tiles: int
    splits: int
    rows: int


def plan_group(m: int, k: int, ns: Sequence[int],
               sms: int = 132) -> GroupPlan:
    """The plan of one launch over members of ``ns`` columns each: their
    64-column tiles one after another (a member's last tile may be
    ragged, and a member narrower than a tile has a tile of its own), the
    splits of :func:`plan_splits`'s rule over all the tiles (on the H100:
    4 for q/k/v's 60 tiles, 8 for the mel and stop heads' 6; 0 where
    ``m`` is outside the kernel's rows) and the rows of
    :func:`plan_rows`."""
    tile0, tiles = [], 0
    for n in ns:
        tile0.append(tiles)
        tiles += -(-n // COLUMNS)
    splits = 1 if 1 <= m <= MAX_ROWS else 0
    while (0 < splits < MAX_SPLITS and tiles * splits < sms
           and k >= 2 * splits * MIN_RANGE):
        splits *= 2
    return GroupPlan(tuple(tile0), tiles, splits, plan_rows(m))


def plan_rows(m: int) -> int:
    """Rows of x a thread's group holds (1, 2, 4 or 8; at most 8 groups):
    ``m`` itself up to 2 rows, 4 up to 32, else 8. Groups of 4 rows were
    the fastest at 8, 16 and 32 rows on the H100 (fewer k-lanes, so fewer
    partial sums to add across the block, against the groups' repeated
    weight loads from L1)."""
    if m <= 2:
        return max(m, 1)
    return 4 if m <= 32 else 8


def use_pdl(m: int) -> bool:
    """Whether a launch at ``m`` rows is programmatic (it starts while the
    kernel before it runs, asks the L2 cache for its weight and waits for
    that kernel before its first read): at every row count the kernel
    takes."""
    return 1 <= m <= MAX_ROWS


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


def _check_member(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor]) -> None:
    if w.dtype != torch.bfloat16:
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


def _launch_group(x: torch.Tensor, members: Sequence[Member],
                  splits: Optional[int] = None, rows: Optional[int] = None,
                  gelu: bool = False,
                  pdl: Optional[bool] = None) -> List[torch.Tensor]:
    """One launch of the kernel over ``members`` (``(w, b)`` pairs, ``b``
    may be None), one output each; ``splits``, ``rows`` and ``pdl``
    override :func:`plan_group` and :func:`use_pdl`."""
    if x.device.type != "cuda":
        raise ValueError(f"mixed_linear kernel: {x.device} is not a CUDA "
                         f"device")
    if x.dtype != torch.float32:
        raise TypeError(f"mixed_linear kernel takes float32 x against a "
                        f"bfloat16 weight, got {x.dtype}")
    if not 1 <= len(members) <= MAX_MEMBERS:
        raise ValueError(f"mixed_linear kernel takes 1 to {MAX_MEMBERS} "
                         f"weights a launch, got {len(members)}")
    for w, b in members:
        _check_member(x, w, b)
    k = x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    if m > MAX_ROWS:
        raise ValueError(f"mixed_linear kernel takes at most {MAX_ROWS} "
                         f"rows, got {m}")
    ys = [torch.empty((m, w.shape[1]), dtype=torch.float32, device=x.device)
          for w, _ in members]
    if m > 0:
        plan = plan_group(m, k, [w.shape[1] for w, _ in members],
                          _sm_count(x.device))
        desc, flops, nbytes = [], 0.0, 4 * m * k
        for (w, b), y in zip(members, ys):
            n = w.shape[1]
            b = None if b is None else b.contiguous()
            desc += [w.data_ptr(), w.stride(0),
                     0 if b is None else b.data_ptr(),
                     0 if b is None else _BIAS[b.dtype], y.data_ptr(), n,
                     int(vector_loads(n, w.stride(0), w.data_ptr()))]
            # the product's multiply-adds, the bias's adds and the GELU's
            # eight operations an output; the bf16 weight and the bias
            # read once, y written once (x once for the launch)
            flops += (2.0 * m * k * n + (0 if b is None else m * n)
                      + (8 * m * n if gelu else 0))
            nbytes += (2 * k * n + 4 * m * n
                       + (0 if b is None else n * b.element_size()))
        fn = cuda_build.entry(KERNEL, "mixed_linear_fwd", _ARGTYPES)
        KERNEL.launched(flops, nbytes)
        code = fn(x2.data_ptr(), m, k, len(members),
                  (ctypes.c_longlong * len(desc))(*desc),
                  plan.splits if splits is None else splits,
                  plan.rows if rows is None else rows, int(gelu),
                  int(use_pdl(m) if pdl is None else pdl),
                  torch.cuda.current_stream(x.device).cuda_stream)
        cuda_build.check_launch(KERNEL, code)
    return [y.reshape(tuple(x.shape[:-1]) + (y.shape[1],)) for y in ys]


def _launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            splits: Optional[int] = None, rows: Optional[int] = None,
            gelu: bool = False, pdl: Optional[bool] = None) -> torch.Tensor:
    """One launch of the kernel for one weight; ``splits``, ``rows`` and
    ``pdl`` override :func:`plan_splits`, :func:`plan_rows` and
    :func:`use_pdl`."""
    return _launch_group(x, [(w, b)], splits, rows, gelu, pdl)[0]


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


def _needs_grad(x: torch.Tensor, members: Sequence[Member]) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(
        t is not None and t.requires_grad for m in members for t in m))


def mixed_linear(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 gelu: bool = False) -> torch.Tensor:
    """``x @ w (+ b)``, with ``gelu`` its exact GELU: the plain version
    for a CPU tensor, the kernel for a CUDA one (the GELU in its epilogue;
    through :class:`_MixedLinear`, then PyTorch's GELU, where a gradient
    is asked for); a CUDA input that the kernel does not take raises."""
    if x.device.type == "cpu":
        return mixed_linear_plain(x, w, b, gelu)
    if _needs_grad(x, [(w, b)]):
        y = _MixedLinear.apply(x, w, b)
        return F.gelu(y, approximate="none") if gelu else y
    return _launch(x, w, b, gelu=gelu)


def mixed_linear_group(x: torch.Tensor,
                       members: Sequence[Member]) -> List[torch.Tensor]:
    """``[x @ w (+ b) for (w, b) in members]`` (``b`` may be None): on a
    CUDA tensor one launch of the kernel for up to :data:`MAX_MEMBERS`
    weights that read the rows ``x``; on the CPU, and where a gradient is
    asked for, one :func:`mixed_linear` a member (on the CPU exactly the
    separate :func:`mixed_linear_plain` calls)."""
    if x.device.type == "cpu" or _needs_grad(x, members):
        return [mixed_linear(x, w, b) for w, b in members]
    return _launch_group(x, members)
