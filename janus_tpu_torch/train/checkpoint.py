"""Checkpoints of parameter trees and train state.

The JAX package writes Orbax directories; Orbax's layout is not available
to the port. A checkpoint here is a directory holding one ``torch.save``
of the tree (``tree.pt``: nested dicts and lists of tensors, ints and
floats), read back with ``torch.load(weights_only=True)``, which unpickles
nothing but those types. For a checkpoint both packages read, use the
zoo's flat npz (:func:`janus_tpu_torch.models.params.save_npz`).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from janus_tpu_torch.models.params import map_tree, tree_to
from janus_tpu_torch.train.trainer import TrainState

__all__ = ["save_params", "load_params", "save_train_state",
           "load_train_state"]

_FILE = "tree.pt"


def save_params(path: str, params: Any) -> None:
    """Write a tree to the directory ``path`` (created; an earlier
    checkpoint there is replaced). Tensors are saved from the host."""
    os.makedirs(path, exist_ok=True)
    tree = map_tree(lambda t: t.detach().cpu() if isinstance(
        t, torch.Tensor) else t, params)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def load_params(path: str, device: Optional[Any] = None) -> Any:
    """Read a tree written by :func:`save_params`; tensors on ``device``
    (default: the CPU)."""
    tree = torch.load(os.path.join(path, _FILE), map_location="cpu",
                      weights_only=True)
    return tree if device is None else tree_to(tree, device)


def save_train_state(path: str, state: TrainState) -> None:
    """Persist a :class:`~janus_tpu_torch.train.trainer.TrainState`."""
    save_params(path, {"params": state.params,
                       "opt_state": state.opt_state, "step": state.step})


def load_train_state(path: str, device: Optional[Any] = None) -> TrainState:
    tree = load_params(path)
    move = (lambda t: t) if device is None else (
        lambda t: tree_to(t, device))
    opt = tree["opt_state"]
    return TrainState(params=move(tree["params"]),
                      opt_state={"count": int(opt["count"]),
                                 "mu": move(opt["mu"]), "nu": move(opt["nu"])},
                      step=int(tree["step"]))
