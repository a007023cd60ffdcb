"""One-device trainer with the JAX package's optimizer written out.

The JAX package's :class:`Trainer` steps
``optax.chain(clip_by_global_norm(grad_clip), adamw(lr, weight_decay=wd))``
under ``jax.value_and_grad``. Here the same arithmetic runs on the leaves
of the parameter tree, in place, with ``torch._foreach`` ops:

- global-norm clipping with no epsilon: every gradient becomes
  ``(g / norm) * grad_clip`` unless ``norm < grad_clip``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so it is not
  used);
- Adam with b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction from count 1 (in float32, rounded as optax rounds it);
- decoupled weight decay ``wd * p`` added to the update of every leaf
  (optax's mask is None: biases and layer norms decay too);
- ``p <- p - lr * update``, ``lr`` a float or a schedule evaluated at the
  optimizer's count before the step.

Metrics are the loss function's, plus ``loss`` and the pre-clip
``grad_norm``, as 0-dim tensors on the parameters' device: reading one
waits for the device, so a loop reads them only where it logs.

One device only: the JAX package's mesh, partition rules and
``shard_batch`` belong to its ``parallel/`` package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from janus_tpu_torch.models.params import (flatten_with_paths, map_tree,
                                           unflatten_from_paths)

__all__ = ["TrainState", "Trainer", "warmup_cosine_decay_schedule",
           "global_norm"]

Schedule = Callable[[int], float]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# leaves updated per group of foreach calls: bounds the update's
# temporaries to a group's size (a large-v3 tree has ~900 leaves)
_GROUP = 64


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps``, constant after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={cos_steps}.")

    def warmup(count: int) -> float:
        if warmup_steps <= 0:
            return init_value
        frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def cosine(count: int) -> float:
        count = min(count, cos_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / cos_steps))
        return peak_value * ((1 - alpha) * decay ** exponent + alpha)

    def schedule(count: int) -> float:
        count = int(count)
        return warmup(count) if count < warmup_steps else cosine(
            count - warmup_steps)

    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32 as optax computes it (XLA raises
    a float32 base to an integer power by repeated squaring). In float32
    ``1 - 0.999 ** count`` keeps few digits, so the rounding must be the
    same for the update to be."""
    r, x = np.float32(1), np.float32(decay)
    while count:
        if count & 1:
            r = np.float32(r * x)
        x = np.float32(x * x)
        count >>= 1
    return float(np.float32(1) - r)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@dataclasses.dataclass
class TrainState:
    """``params`` and the Adam moments ``opt_state = {"count", "mu",
    "nu"}`` (trees of the params' structure); ``step`` counts steps."""

    params: Any
    opt_state: Dict[str, Any]
    step: int


def _leaves(tree: Any) -> Tuple[List[str], List[torch.Tensor]]:
    pairs = list(flatten_with_paths(tree))
    return [k for k, _ in pairs], [v for _, v in pairs]


class Trainer:
    def __init__(self, loss_fn: Callable[..., Tuple[torch.Tensor, Dict]],
                 learning_rate: Union[float, Schedule] = 3e-4,
                 weight_decay: float = 0.01, grad_clip: float = 1.0) -> None:
        """``loss_fn(params, *batch) -> (loss, metrics)``."""
        self._loss_fn = loss_fn
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    # -- state -------------------------------------------------------------

    def create_state(self, params: Any) -> TrainState:
        """Own copies of ``params`` (float32 leaves, detached) and zero
        moments on their device."""
        params = map_tree(lambda t: t.detach().clone(), params)
        zeros = lambda tree: map_tree(torch.zeros_like, tree)  # noqa: E731
        return TrainState(params=params,
                          opt_state={"count": 0, "mu": zeros(params),
                                     "nu": zeros(params)},
                          step=0)

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    # -- step --------------------------------------------------------------

    def train_step(self, state: TrainState, *batch) -> Tuple[TrainState, Dict]:
        """One step on ``batch`` (numpy arrays or tensors, moved to the
        parameters' device). The parameters and moments are updated in
        place; the returned state holds them and the advanced counts."""
        paths, params = _leaves(state.params)
        device = params[0].device
        batch = tuple(torch.from_numpy(np.ascontiguousarray(b)).to(device)
                      if isinstance(b, np.ndarray) else
                      b.to(device) if isinstance(b, torch.Tensor) else b
                      for b in batch)
        live = [p.detach().requires_grad_() for p in params]
        loss, metrics = self._loss_fn(
            unflatten_from_paths(dict(zip(paths, live))), *batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        del live
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]

        with torch.no_grad():
            norm = global_norm(grads)
            # (g / norm) * max_norm where the norm reaches max_norm, as
            # optax's select; g / 1 * 1 == g elsewhere
            keep = norm < self.grad_clip
            one = torch.ones((), device=device)
            div = torch.where(keep, one, norm)
            mul = torch.where(keep, one, torch.full_like(one, self.grad_clip))

            count = state.opt_state["count"] + 1
            lr = self._lr(state.opt_state["count"])
            bc1, bc2 = _bias_correction(_B1, count), _bias_correction(_B2, count)
            _, mu = _leaves(state.opt_state["mu"])
            _, nu = _leaves(state.opt_state["nu"])
            for lo in range(0, len(params), _GROUP):
                sl = slice(lo, lo + _GROUP)
                g, p, m, v = grads[sl], params[sl], mu[sl], nu[sl]
                torch._foreach_div_(g, div)
                torch._foreach_mul_(g, mul)
                torch._foreach_mul_(m, _B1)
                torch._foreach_add_(m, g, alpha=1 - _B1)
                torch._foreach_mul_(v, _B2)
                torch._foreach_addcmul_(v, g, g, value=1 - _B2)
                den = torch._foreach_div(v, bc2)
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, _EPS)
                upd = torch._foreach_div(m, bc1)
                torch._foreach_div_(upd, den)
                del den
                if self.weight_decay:
                    torch._foreach_add_(upd, p, alpha=self.weight_decay)
                torch._foreach_add_(p, upd, alpha=-lr)
                del upd
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=norm)
        opt_state = dict(state.opt_state, count=count)
        return TrainState(state.params, opt_state, state.step + 1), metrics
