"""The trainer, with the JAX package's optimizer written out.

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

With a ``mesh`` and partition ``rules`` (every rank of the mesh running
the same steps on the same global batch) the layout is the JAX package's
sharded trainer, written as explicit SPMD:

- the parameters and moments are this rank's shards by ``rules``, and the
  models run tensor-parallel over ``model``
  (:func:`~janus_tpu_torch.parallel.collectives.use_mesh`);
- :meth:`Trainer.shard_batch` takes this rank's slice of the batch's
  leading axis over ``dp_spec``'s dimensions (``replica`` × ``data``);
- the loss reduces over the global batch with
  :func:`~janus_tpu_torch.parallel.collectives.dp_sum` / ``dp_mean``, as
  every loss of :mod:`.losses` does (a masked mean is then the whole
  batch's), and the gradients are summed over ``replica`` × ``data``; a
  step whose loss did not is refused;
- the clipping norm is the whole gradient's: the squares of the split
  leaves summed over ``model``, the whole leaves counted once;
- the optimizer runs on the local shards.

``mesh=None`` is the one-device trainer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from janus_tpu_torch.models.params import (flatten_with_paths, map_tree,
                                           unflatten_from_paths)
from janus_tpu_torch.parallel.collectives import (DP_AXES, all_reduce,
                                                  axis_index, axis_size,
                                                  data_parallel, use_mesh)
from janus_tpu_torch.parallel.sharding import (partition_spec_for,
                                               shard_params)

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
                 weight_decay: float = 0.01, grad_clip: float = 1.0,
                 mesh=None, rules=None) -> None:
        """``loss_fn(params, *batch) -> (loss, metrics)``; ``rules`` (the
        partition rules of ``parallel/sharding.py``) go with a ``mesh``."""
        if mesh is not None and rules is None:
            raise ValueError("a mesh needs partition rules")
        self._loss_fn = loss_fn
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.mesh = mesh
        self.rules = rules

    # -- state -------------------------------------------------------------

    def create_state(self, params: Any) -> TrainState:
        """Own copies of ``params`` (float32 leaves, detached; this rank's
        shards under a mesh) and zero moments on their device."""
        if self.mesh is not None:
            params = shard_params(params, self.mesh, self.rules)
        params = map_tree(lambda t: t.detach().clone(), params)
        zeros = lambda tree: map_tree(torch.zeros_like, tree)  # noqa: E731
        return TrainState(params=params,
                          opt_state={"count": 0, "mu": zeros(params),
                                     "nu": zeros(params)},
                          step=0)

    def shard_batch(self, *batch) -> Tuple:
        """This rank's slice of each batch array's leading axis, split over
        the mesh's data-parallel dimensions (``replica`` slowest); 0-dim
        arrays whole. The batch itself without a mesh."""
        n, idx = 1, 0
        for name in DP_AXES:
            size = axis_size(self.mesh, name)
            n, idx = n * size, idx * size + axis_index(self.mesh, name)
        if n == 1:
            return batch
        out = []
        for b in batch:
            if np.ndim(b) == 0:
                out.append(b)
                continue
            if b.shape[0] % n:
                raise ValueError(f"batch of {b.shape[0]} does not split over "
                                 f"{n} data-parallel ranks")
            size = b.shape[0] // n
            out.append(b[idx * size:(idx + 1) * size])
        return tuple(out)

    def _grad_norm(self, paths: List[str],
                   grads: List[torch.Tensor]) -> torch.Tensor:
        """Norm of the whole gradient: a split leaf's squares summed over
        ``model``, a whole leaf's counted once."""
        if axis_size(self.mesh, "model") == 1:
            return global_norm(grads)
        split = torch.zeros((), device=grads[0].device)
        whole = torch.zeros((), device=grads[0].device)
        for path, g in zip(paths, grads):
            spec = partition_spec_for(path, self.rules)
            if len(spec) <= g.ndim and "model" in spec:
                split = split + g.square().sum()
            else:
                whole = whole + g.square().sum()
        return torch.sqrt(all_reduce(split, self.mesh, "model") + whole)

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
                      for b in self.shard_batch(*batch))
        live = [p.detach().requires_grad_() for p in params]
        with use_mesh(self.mesh), data_parallel(self.mesh) as dp:
            loss, metrics = self._loss_fn(
                unflatten_from_paths(dict(zip(paths, live))), *batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        del live
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]

        with torch.no_grad():
            if dp.size > 1:
                if not dp.used:
                    raise ValueError(
                        "under data parallelism the loss must reduce over "
                        "the batch with dp_sum or dp_mean: each rank's "
                        "gradient is then its share of the global loss's")
                for name in DP_AXES:
                    grads = [all_reduce(g, self.mesh, name) for g in grads]
            norm = self._grad_norm(paths, grads)
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
