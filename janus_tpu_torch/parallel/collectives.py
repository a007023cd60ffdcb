"""Collectives over one named dimension of a device mesh, and the ambient
mesh the models read.

The JAX package writes its parallel layouts as ``shard_map`` bodies
(``jax.lax.psum``, ``all_gather``, ``ppermute``, ``all_to_all``) or lets
GSPMD derive the collectives from sharded parameters. The port is
explicit SPMD: every rank runs the same program on its own shards and
calls these functions where the JAX program communicates.

- One function per collective, over the process group of one named
  dimension of a :class:`~torch.distributed.device_mesh.DeviceMesh`. A
  dimension of size 1 (or a mesh without it) issues no call, as XLA
  elides such collectives.
- Each counts the bytes of the result it produces on this rank, by op,
  under XLA's names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``collective-permute``, ``all-to-all``); :func:`counting` reads them
  for ``eval/scaling.py``.
- Tensor parallelism (TP) over the ``model`` dimension uses Megatron's
  pair of autograd functions: :func:`enter_model` (identity forward,
  all-reduce backward) where a column-parallel region begins and
  :func:`exit_model` (all-reduce forward, identity backward) where a
  row-parallel one ends.
- :func:`use_mesh` sets the mesh the model code reads (its ``model``
  dimension is TP; the parameters are then this rank's shards), as
  sharded parameters imply the layout under GSPMD.
  :func:`data_parallel` makes :func:`dp_sum` reduce over the batch's
  dimensions (``replica``, ``data``) inside a loss, so that a masked mean
  is the global batch's.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist

__all__ = [
    "DP_AXES",
    "axis_size",
    "axis_index",
    "mesh_shape",
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "ppermute",
    "all_to_all",
    "counting",
    "use_mesh",
    "current_mesh",
    "model_size",
    "column_width",
    "local_heads",
    "enter_model",
    "exit_model",
    "data_parallel",
    "dp_size",
    "dp_sum",
    "dp_mean",
]

# the dimensions a batch is split over, slowest first (parallel/distributed)
DP_AXES = ("replica", "data")

_counts: Optional[Dict[str, int]] = None  # set inside ``counting()``

# newer PyTorch releases name these two collectives ``*_single`` (the
# arguments are the same) and warn on the older names
_all_gather_flat = getattr(dist, "all_gather_single", None) or (
    dist.all_gather_into_tensor)
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or (
    dist.reduce_scatter_tensor)


def _count(op: str, t: torch.Tensor) -> None:
    if _counts is not None:
        _counts[op] = _counts.get(op, 0) + t.numel() * t.element_size()


@contextlib.contextmanager
def counting() -> Iterator[Dict[str, int]]:
    """Count the result bytes of every collective this rank issues inside
    the block: ``{op: bytes}``, ops that ran only."""
    global _counts
    outer, _counts = _counts, {}
    try:
        yield _counts
    finally:
        _counts = outer


# --------------------------------------------------------------------------
# mesh dimensions
# --------------------------------------------------------------------------

def mesh_shape(mesh) -> Dict[str, int]:
    """``{name: size}`` of a mesh's dimensions, as JAX's ``mesh.shape``."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, name: str) -> int:
    """Size of dimension ``name`` (1 without a mesh or without the
    dimension)."""
    return mesh_shape(mesh).get(name, 1)


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (0 on a dimension of size 1)."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(name)]


def _group(mesh, name: str):
    return mesh.get_group(name)


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """Sum of ``x`` over dimension ``name`` (``psum``), a new tensor."""
    if axis_size(mesh, name) == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, group=_group(mesh, name))
    _count("all-reduce", y)
    return y


def all_gather(x: torch.Tensor, mesh, name: str, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """The shards of ``name`` in rank order: concatenated along ``dim``
    (``tiled``) or stacked on a new leading axis (``all_gather``)."""
    n = axis_size(mesh, name)
    if n == 1:
        return x if tiled else x[None]
    xc = x.contiguous()
    flat = torch.empty(n * xc.numel(), dtype=xc.dtype, device=xc.device)
    _all_gather_flat(flat, xc.reshape(-1), group=_group(mesh, name))
    out = flat.view((n,) + tuple(xc.shape))
    _count("all-gather", out)
    if not tiled:
        return out
    return torch.cat(out.unbind(0), dim=dim)


def reduce_scatter(x: torch.Tensor, mesh, name: str,
                   dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``name``
    (``psum_scatter`` with ``tiled=True``)."""
    n = axis_size(mesh, name)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over |{name}|={n}")
    blocks = torch.stack(x.chunk(n, dim=dim))
    out = torch.empty_like(blocks[0])
    _reduce_scatter_flat(out.view(-1), blocks.reshape(-1),
                         group=_group(mesh, name))
    _count("reduce-scatter", out)
    return out


def ppermute(x: torch.Tensor, mesh, name: str, shift: int = 1) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` places on along ``name`` (a ring)
    and return what the rank ``shift`` places back sent."""
    n = axis_size(mesh, name)
    if n == 1:
        return x
    group = _group(mesh, name)
    me = axis_index(mesh, name)
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count("collective-permute", recv)
    return recv


def all_to_all(x: torch.Tensor, mesh, name: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(tiled=True)``: block j of ``x`` along
    ``split_dim`` goes to rank j, and the blocks received are concatenated
    along ``concat_dim`` in rank order."""
    n = axis_size(mesh, name)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of size {x.shape[split_dim]}"
                         f" does not split over |{name}|={n}")
    blocks = torch.stack(x.chunk(n, dim=split_dim))
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out.view(-1), blocks.reshape(-1),
                           group=_group(mesh, name))
    y = torch.cat(out.unbind(0), dim=concat_dim)
    _count("all-to-all", y)
    return y


# --------------------------------------------------------------------------
# the ambient mesh and tensor parallelism
# --------------------------------------------------------------------------

_MESH: contextvars.ContextVar = contextvars.ContextVar("janus_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Run the block with ``mesh`` as the models' mesh: their weights are
    this rank's shards under the partition rules, and the ``model``
    dimension is tensor-parallel. ``None`` is the one-device layout."""
    # the tensor-parallel degree is read once here: the models ask for it
    # several times a layer, and a DeviceMesh may rebuild its rank tensor
    # on every ``shape``
    token = _MESH.set(None if mesh is None
                      else (mesh, axis_size(mesh, "model")))
    try:
        yield
    finally:
        _MESH.reset(token)


def current_mesh():
    ambient = _MESH.get()
    return None if ambient is None else ambient[0]


def model_size() -> int:
    """Tensor-parallel degree of the current mesh (1 without one)."""
    ambient = _MESH.get()
    return 1 if ambient is None else ambient[1]


def column_width(w, full: int) -> int:
    """This rank's output width of the column-parallel weight ``w``
    ``[d_in, full / model]`` (or its quantized form), checked: a tree
    sharded for another tensor-parallel degree than the current mesh's
    (one run outside :func:`use_mesh`, say) raises instead of giving a
    wrong result."""
    tp = model_size()
    width = getattr(w, "q", w).shape[-1]
    if width * tp != full:
        raise ValueError(
            f"a column-parallel weight {width} wide is not 1/{tp} of {full}: "
            f"the tree was sharded for another tensor-parallel degree (run "
            f"it under use_mesh with the mesh it was sharded for)")
    return width


def local_heads(num_heads: int, w, parts: int = 1) -> int:
    """Attention heads on this rank: ``num_heads / model``. ``w`` is the
    rank's q or k projection weight (``parts`` = 3: q, k and v fused),
    whose width :func:`column_width` checks against its input's."""
    tp = model_size()
    if num_heads % tp:
        raise ValueError(f"heads={num_heads} not divisible by |model|={tp}")
    column_width(w, parts * getattr(w, "q", w).shape[-2])
    return num_heads // tp


class _EnterModel(torch.autograd.Function):
    """Identity forward; the gradient summed over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, "model"), None


class _ExitModel(torch.autograd.Function):
    """Partial products summed over ``model`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """Where a column-parallel region begins (``x`` replicated over
    ``model``): identity here, all-reduced gradient."""
    if model_size() == 1:
        return x
    return _EnterModel.apply(x, current_mesh())


def exit_model(x: torch.Tensor) -> torch.Tensor:
    """Where a row-parallel region ends: the partial products summed over
    ``model``; the gradient passes through unchanged."""
    if model_size() == 1:
        return x
    return _ExitModel.apply(x, current_mesh())


# --------------------------------------------------------------------------
# data parallelism inside a loss
# --------------------------------------------------------------------------

class DataParallel:
    """What :func:`data_parallel` yields: the mesh, and whether the loss
    reduced over the batch with :func:`dp_sum` or :func:`dp_mean`
    (``used``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.used = False

    @property
    def size(self) -> int:
        n = 1
        for name in DP_AXES:
            n *= axis_size(self.mesh, name)
        return n


_DP: contextvars.ContextVar = contextvars.ContextVar("janus_dp",
                                                     default=None)


@contextlib.contextmanager
def data_parallel(mesh) -> Iterator[DataParallel]:
    """Inside the block, :func:`dp_sum` sums over the mesh's batch
    dimensions. A loss written with it computes the global batch's value
    on every rank, and its gradient on a rank is that rank's share: the
    trainer sums the gradients over the batch dimensions."""
    state = DataParallel(mesh)
    token = _DP.set(state)
    try:
        yield state
    finally:
        _DP.reset(token)


class _DPSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        for name in DP_AXES:
            x = all_reduce(x, mesh, name)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def dp_size() -> int:
    """Ranks the batch is split over inside :func:`data_parallel` (1
    outside)."""
    state = _DP.get()
    return 1 if state is None else state.size


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch's ranks (``x`` itself outside
    :func:`data_parallel`); the gradient is passed through, each rank
    keeping its own share."""
    state = _DP.get()
    if state is None:
        return x
    state.used = True
    if state.size == 1:
        return x
    return _DPSum.apply(x, state.mesh)


def dp_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over the global batch (every rank holds an equal
    share); ``x.mean()`` outside :func:`data_parallel`."""
    state = _DP.get()
    if state is None:
        return x.mean()
    state.used = True
    if state.size == 1:
        return x.mean()
    return _DPSum.apply(x.sum(), state.mesh) / (x.numel() * state.size)
