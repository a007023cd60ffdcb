"""Device mesh construction.

Axes (see :class:`janus_tpu_torch.common.config.MeshConfig`):

- ``data``  — concurrent sessions / batch (DP)
- ``model`` — attention heads + MLP hidden (TP)
- ``seq``   — mel-frame/sequence dimension (SP: ring attention, Ulysses)

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, one device per rank, laid out
row-major as the JAX package reshapes its device list: rank
``(d * model + m) * seq + s`` sits at ``(d, m, s)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from janus_tpu_torch.common.config import MeshConfig

__all__ = ["build_mesh", "best_mesh_shape", "local_device_count",
           "mesh_from_ranks"]


def local_device_count() -> int:
    """Ranks of the default process group (1 without one): the devices a
    mesh can be laid over."""
    return dist.get_world_size() if dist.is_initialized() else 1


def best_mesh_shape(n_devices: int, model: int = 1,
                    seq: int = 1) -> Tuple[int, int, int]:
    """Fill the data axis with whatever model/seq don't use."""
    if n_devices % (model * seq) != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by model*seq={model * seq}")
    return (n_devices // (model * seq), model, seq)


def mesh_from_ranks(ranks: torch.Tensor,
                    names: Sequence[str]) -> DeviceMesh:
    """A mesh over the ranks in ``ranks`` (its shape is the mesh's). With
    no process group, a one-rank mesh needs none: no collective is issued
    over a dimension of size 1, so its groups are never made."""
    if not dist.is_initialized():
        if ranks.numel() != 1:
            raise ValueError(f"a mesh of {ranks.numel()} ranks needs a "
                             "process group")
        return DeviceMesh("cpu", ranks, mesh_dim_names=tuple(names),
                          _init_backend=False, _rank=0)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def build_mesh(cfg: Optional[MeshConfig] = None,
               devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """``cfg``'s mesh over ``devices`` (global ranks; default every rank
    of the default group)."""
    cfg = cfg or MeshConfig()
    if devices is None:
        devices = range(local_device_count())
    devices = list(devices)
    n = cfg.data * cfg.model * cfg.seq
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    ranks = torch.tensor(devices[:n]).reshape(cfg.data, cfg.model, cfg.seq)
    return mesh_from_ranks(ranks, cfg.axis_names)
