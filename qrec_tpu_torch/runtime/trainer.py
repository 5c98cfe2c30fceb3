"""Per-epoch training loop (counterpart of the JAX package's
``runtime/trainer.py``, fixed-LR Adam mode).

Each epoch draws its batches from the sampler (or takes injected ones),
runs one Adam step per batch, and materializes the epoch's summed loss
once on the host, where ``check_finite`` gives the reference's NaN abort
(base/iterativeRecommender.py:84-87). With a :class:`BestTracker`, a quick
evaluation follows each epoch and the parameters of the epoch that wins
the tracker's vote are kept (``EpochLoop.run``'s tracker branch).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import ConvergenceError
from .profiling import StepTimer


def check_finite(loss: float) -> None:
    """NaN/Inf abort (base/iterativeRecommender.py:84-87)."""
    if math.isnan(loss) or math.isinf(loss):
        raise ConvergenceError(
            "Loss = NaN or Infinity: current settings does not fit the "
            "recommender! Change the settings and try again!"
        )


class BestTracker:
    """Majority-vote best-epoch tracking (base/iterativeRecommender.py:132-169).

    ``update`` returns True when the new metrics win the vote (more metrics
    at least as good as the best so far than worse); the training loop
    then stores a copy of the parameters in ``best_params``.
    """

    def __init__(self):
        self.best_epoch: Optional[int] = None
        self.best_metrics: Optional[Dict[str, float]] = None
        self.best_params: Optional[List[torch.Tensor]] = None

    def update(self, epoch: int, metrics: Dict[str, float]) -> bool:
        if self.best_metrics is None:
            self.best_epoch = epoch + 1
            self.best_metrics = dict(metrics)
            return True
        count = 0
        for k in self.best_metrics:
            if self.best_metrics[k] > metrics[k]:
                count += 1
            else:
                count -= 1
        if count < 0:
            self.best_epoch = epoch + 1
            self.best_metrics = dict(metrics)
            return True
        return False


def as_device_batches(batches: Sequence, device) -> tuple:
    """Numpy or tensor (users, pos, neg, weight) epoch arrays → device
    tensors (indices int64, weights f32)."""
    users, pos, neg, weight = batches
    idx = lambda a: torch.tensor(np.asarray(a), dtype=torch.int64, device=device)  # noqa: E731
    return (
        idx(users), idx(pos), idx(neg),
        torch.tensor(np.asarray(weight), dtype=torch.float32, device=device),
    )


def train(
    params: Sequence[torch.Tensor],
    loss_fn: Callable,
    sampler: Callable,
    *,
    max_epoch: int,
    lr: float,
    device,
    generator: torch.Generator,
    examples_per_epoch: int,
    emit: Optional[Callable] = None,
    epoch_batches: Optional[Sequence] = None,
    quick_eval: Optional[Callable] = None,
    tracker: Optional[BestTracker] = None,
) -> Tuple[List[float], StepTimer]:
    """Train ``params`` in place; return the per-epoch summed losses and the
    epoch timer.

    ``loss_fn(batch, generator) -> scalar`` for one (users, pos, neg,
    weight) batch; a model that needs random numbers in its loss draws them
    from ``generator``, the stream the sampler also uses.
    ``sampler(generator)`` returns an epoch's batches shaped
    ``(num_batches, batch_size)``. ``epoch_batches``, when given, replaces
    the sampler with one injected (users, pos, neg, weight) tuple of
    arrays per epoch. With ``tracker``, ``quick_eval() -> metrics`` runs
    after each epoch (outside its timing) and the parameters of a winning
    epoch are copied into ``tracker.best_params``.
    ``emit(epoch, loss, seconds, metrics)`` prints the epoch line.
    """
    # optax.adam's defaults
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    timer = StepTimer(examples_per_epoch, device)
    losses: List[float] = []
    for epoch in range(max_epoch):
        with timer:
            if epoch_batches is not None:
                batches = as_device_batches(epoch_batches[epoch], device)
            else:
                batches = sampler(generator)
            total = torch.zeros((), dtype=torch.float32, device=device)
            for step in range(batches[0].shape[0]):
                loss = loss_fn(tuple(t[step] for t in batches), generator)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                total = total + loss.detach()
            loss_val = float(total)
        check_finite(loss_val)
        losses.append(loss_val)
        metrics = quick_eval() if tracker is not None else None
        if emit is not None:
            emit(epoch, loss_val, timer.last, metrics)
        if metrics is not None and tracker.update(epoch, metrics):
            # copies: Adam updates the parameters in place
            tracker.best_params = [p.detach().clone() for p in params]
    return losses, timer
