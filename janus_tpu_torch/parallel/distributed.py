"""Multi-host deployment: the ``torch.distributed`` bootstrap and the
hybrid ``('replica', 'data', 'model', 'seq')`` mesh.

- one process per card calls :func:`initialize_from_env` (coordinator
  address, process count and process id from the environment), after
  which the default process group spans every card of every host;
- :func:`build_hybrid_mesh` lays the ranks out with ``replica`` varying
  slowest. Ranks are numbered host by host, so with ``replica`` equal to
  the host count ``replica`` is the only dimension that crosses hosts:
  the gradient all-reduce over it is the one collective on the network,
  and ``data`` / ``model`` / ``seq`` stay on a host's NVLink;
- batches split over ``('replica', 'data')`` jointly (:func:`dp_spec`),
  parameters over ``model``, long sequences over ``seq``.
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from janus_tpu_torch.common.device import resolve_device
from janus_tpu_torch.parallel.collectives import DP_AXES
from janus_tpu_torch.parallel.mesh import local_device_count, mesh_from_ranks

__all__ = [
    "initialize_from_env",
    "num_slices",
    "build_hybrid_mesh",
    "dp_spec",
    "HYBRID_AXES",
]

logger = logging.getLogger("janus.distributed")

HYBRID_AXES: Tuple[str, str, str, str] = ("replica", "data", "model", "seq")


def initialize_from_env(env: Optional[dict] = None,
                        device="cuda") -> bool:
    """Join the process group named by the environment.

    Reads ``JANUS_COORDINATOR_ADDRESS`` (``host:port`` of rank 0),
    ``JANUS_NUM_PROCESSES`` and ``JANUS_PROCESS_ID`` (falling back to
    torchrun's ``WORLD_SIZE`` and ``RANK``). NCCL for a card, gloo when
    ``device`` is the CPU. No-op — returning False — when the coordinator
    is unset (single-process dev/test) or a group already exists."""
    env = dict(os.environ if env is None else env)
    addr = env.get("JANUS_COORDINATOR_ADDRESS")
    if not addr:
        return False
    if dist.is_initialized():
        return False
    world = env.get("JANUS_NUM_PROCESSES") or env.get("WORLD_SIZE")
    rank = env.get("JANUS_PROCESS_ID") or env.get("RANK")
    if world is None or rank is None:
        raise ValueError("JANUS_COORDINATOR_ADDRESS needs JANUS_NUM_PROCESSES "
                         "and JANUS_PROCESS_ID (or WORLD_SIZE and RANK)")
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(int(env.get("LOCAL_RANK", int(rank)
                                          % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=int(world), rank=int(rank))
    logger.info("torch.distributed initialized: process %d/%d (%s)",
                dist.get_rank(), dist.get_world_size(), backend)
    return True


def num_slices() -> int:
    """Distinct hosts among the default group's ranks (1 without one)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return 1
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return len(set(names))


def build_hybrid_mesh(replica: int = 1, data: int = 1, model: int = 1,
                      seq: int = 1):
    """The ``('replica', 'data', 'model', 'seq')`` mesh over the first
    ``replica * data * model * seq`` ranks, ``replica`` slowest."""
    n = local_device_count()
    want = replica * data * model * seq
    if want > n:
        raise ValueError(f"mesh needs {want} devices, have {n}")
    hosts = num_slices()
    if hosts > 1 and replica != hosts:
        logger.warning("replica=%d != host count %d: data/model/seq "
                       "collectives may cross hosts", replica, hosts)
    ranks = torch.arange(want).reshape(replica, data, model, seq)
    return mesh_from_ranks(ranks, HYBRID_AXES)


def dp_spec(mesh, ndim: int = 1) -> Tuple:
    """Batch spec: the leading axis over every data-parallel dimension of
    the mesh (``('replica', 'data')`` on hybrid meshes, ``'data'`` on
    plain ones), the rest replicated."""
    names = [n for n in DP_AXES if n in mesh.mesh_dim_names]
    lead = tuple(names) if len(names) > 1 else (names[0] if names else None)
    return (lead,) + (None,) * (ndim - 1)
