"""Per-epoch training loop (counterpart of the JAX package's
``runtime/trainer.py``: its ``EpochLoop`` in both modes).

Each epoch draws its batches from the sampler (or takes injected ones),
runs one optimizer step per batch, and materializes the epoch's summed
loss once on the host, where ``check_finite`` gives the reference's NaN
abort (base/iterativeRecommender.py:84-87). Two modes:

* ``adam``: fixed-LR Adam (the reference's TF paths);
* ``bold``: SGD with the bold-driver learning rate and the ``|Δloss| <
  1e-3`` convergence rule (the reference's NumPy-SGD family,
  base/iterativeRecommender.py:56-63,82-102), in the JAX package's order
  after each epoch: the convergence check may end training, then the
  driver's update, its ``last_loss``, and the new rate on the optimizer.

With a :class:`BestTracker`, a quick evaluation follows each epoch and the
parameters of the epoch that wins the tracker's vote are kept
(``EpochLoop.run``'s tracker branch); a ``quick_eval`` without a tracker
only adds its measures to the epoch line (the rating models' MAE/RMSE).

Resume: after every epoch (and after the bold driver's update) ``train``
hands a ``checkpoint`` callback the loop's state (:func:`loop_state`: the
parameters, the optimizer's state, the bold driver's rate and
``last_loss``, the convergence monitor's ``last_loss``, the tracker's
best so far and the generator's state); a run given such a state as
``resume`` and its epoch as ``start_epoch`` goes on as the unbroken run
would have, bit for bit. The generator's state stands for the JAX
package's key fast-forward: the port's epochs draw from one running
generator where the JAX package folds the epoch into its key.
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


class BoldDriver:
    """Epoch-level learning-rate schedule (base/iterativeRecommender.py:56-63):
    x1.05 after a loss decrease, x0.5 otherwise, capped by ``max_lr``."""

    def __init__(self, init_lr: float, max_lr: float):
        self.lr = init_lr
        self.max_lr = max_lr
        self.last_loss = 0.0

    def update(self, epoch: int, loss: float) -> float:
        if epoch > 1:
            if abs(self.last_loss) > abs(loss):
                self.lr *= 1.05
            else:
                self.lr *= 0.5
        if self.lr > self.max_lr > 0:
            self.lr = self.max_lr
        return self.lr


class ConvergenceMonitor:
    """``|Δloss| < 1e-3`` + NaN abort (base/iterativeRecommender.py:82-102)."""

    def __init__(self, tol: float = 1e-3):
        self.tol = tol
        self.last_loss = 0.0

    def check(self, loss: float) -> bool:
        check_finite(loss)
        delta = self.last_loss - loss
        converged = abs(delta) < self.tol
        self.last_loss = loss
        return converged


def make_optimizer(params: Sequence[torch.Tensor], mode: str, lr: float) -> torch.optim.Optimizer:
    """``adam``: optax.adam's defaults; ``bold``: plain SGD, whose rate the
    bold driver sets after every epoch."""
    if mode == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if mode == "bold":
        return torch.optim.SGD(params, lr=lr)
    raise ValueError(f"unknown training mode {mode!r} (expected adam|bold)")


def step(optimizer: torch.optim.Optimizer, loss: torch.Tensor, params: Sequence[torch.Tensor]) -> None:
    """One optimizer step on the gradients of ``loss`` with respect to
    ``params`` alone (a GAN player's step: the other player's tables get no
    gradient)."""
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    optimizer.step()


class BestTracker:
    """Majority-vote best-epoch tracking (base/iterativeRecommender.py:132-169).

    ``update`` returns True when the new metrics win the vote (more metrics
    at least as good as the best so far than worse); the training loop
    then stores a copy of the parameters in ``best_params``. A tracker
    shared by the phases of a multi-phase fit numbers epochs across them:
    ``epoch_offset`` holds the epochs of the phases before the current one.
    """

    def __init__(self):
        self.best_epoch: Optional[int] = None
        self.best_metrics: Optional[Dict[str, float]] = None
        self.best_params: Optional[List[torch.Tensor]] = None
        self.epoch_offset = 0

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
    """Numpy or tensor epoch arrays, (users, pos, neg, weight) or (users,
    items, ratings, weight), → device tensors: integer arrays as int64
    indices, the others f32."""
    out = []
    for a in batches:
        a = np.asarray(a)
        dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
        out.append(torch.tensor(a, dtype=dtype, device=device))
    return tuple(out)


def loop_state(params, optimizer, bold, conv, tracker, generator) -> Dict:
    """What a resumed run restores, by reference (``torch.save`` copies)."""
    return {
        "params": [p.detach() for p in params],
        "optimizer": optimizer.state_dict(),
        "lr": bold.lr if bold is not None else None,
        "bold_last": bold.last_loss if bold is not None else None,
        "conv_last": conv.last_loss if conv is not None else None,
        "tracker": None if tracker is None else {
            "best_epoch": tracker.best_epoch, "best_metrics": tracker.best_metrics,
            "best_params": tracker.best_params},
        "generator": generator.get_state(),
    }


def restore_loop_state(state: Dict, params, optimizer, bold, conv, tracker, generator) -> None:
    """Put ``state`` (from :func:`loop_state`, on any device) back into a
    fresh loop: the parameters copied in place, the optimizer's state
    onto the parameters' device (``load_state_dict`` moves it), the bold
    mode's rate onto the optimizer as the driver's update sets it."""
    with torch.no_grad():
        for p, saved in zip(params, state["params"]):
            p.copy_(saved)
    optimizer.load_state_dict(state["optimizer"])
    if bold is not None:
        bold.lr, bold.last_loss = state["lr"], state["bold_last"]
        conv.last_loss = state["conv_last"]
        for group in optimizer.param_groups:
            group["lr"] = bold.lr
    if tracker is not None and state["tracker"] is not None:
        tracker.best_epoch = state["tracker"]["best_epoch"]
        tracker.best_metrics = state["tracker"]["best_metrics"]
        best = state["tracker"]["best_params"]
        tracker.best_params = None if best is None else [
            b.to(p.device) for b, p in zip(best, params)]
    generator.set_state(state["generator"])


def train(
    params: Sequence[torch.Tensor],
    loss_fn: Callable,
    sampler: Callable,
    *,
    max_epoch: int,
    lr: float,
    device,
    mode: str = "adam",
    max_lr: float = 0.0,
    generator: torch.Generator,
    examples_per_epoch: int,
    emit: Optional[Callable] = None,
    epoch_batches: Optional[Sequence] = None,
    quick_eval: Optional[Callable] = None,
    tracker: Optional[BestTracker] = None,
    after_step: Optional[Callable] = None,
    start_epoch: int = 0,
    resume: Optional[Dict] = None,
    checkpoint: Optional[Callable[[int, Dict], None]] = None,
) -> Tuple[List[float], StepTimer]:
    """Train ``params`` in place; return the per-epoch summed losses of the
    epochs run (fewer than ``max_epoch - start_epoch`` when the bold mode
    converges) and the epoch timer.

    ``loss_fn(batch, generator) -> scalar`` for one batch of the sampler's
    tuple; a model that needs random numbers in its loss draws them from
    ``generator``, the stream the sampler also uses.
    ``sampler(generator)`` returns an epoch's batches shaped
    ``(num_batches, batch_size)``. ``epoch_batches``, when given, replaces
    the sampler with one injected tuple of arrays per epoch (indexed by the
    epoch). ``mode``:
    ``adam`` at the fixed rate ``lr``, or ``bold`` (SGD from ``lr``, the
    bold driver capped at ``max_lr``, the convergence rule). With
    ``quick_eval() -> metrics``, the measures of each epoch (taken outside
    its timing) join its line; with ``tracker`` too, the parameters of a
    winning epoch are copied into ``tracker.best_params``.
    ``emit(epoch, loss, lr, seconds, metrics)`` prints the epoch line with
    the learning rate in force during the epoch. ``after_step()`` runs after
    every optimizer step (BUIR's momentum target). ``resume`` (a
    :func:`loop_state` saved after epoch ``start_epoch``) is restored
    before the first epoch, which is then ``start_epoch``;
    ``checkpoint(epoch, state)`` runs after every epoch that does not end
    the bold mode's training, once its rate is updated.
    """
    optimizer = make_optimizer(params, mode, lr)
    bold = BoldDriver(lr, max_lr) if mode == "bold" else None
    conv = ConvergenceMonitor() if mode == "bold" else None
    if resume is not None:
        restore_loop_state(resume, params, optimizer, bold, conv, tracker, generator)
    timer = StepTimer(examples_per_epoch, device)
    losses: List[float] = []
    for epoch in range(start_epoch, max_epoch):
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
                if after_step is not None:
                    after_step()
                total = total + loss.detach()
            loss_val = float(total)
        if conv is None:
            # the bold mode checks inside conv.check below
            check_finite(loss_val)
        losses.append(loss_val)
        metrics = quick_eval() if quick_eval is not None else None
        if emit is not None:
            emit(epoch, loss_val, bold.lr if bold else lr, timer.last, metrics)
        if tracker is not None and tracker.update(epoch + tracker.epoch_offset, metrics):
            # copies: the optimizer updates the parameters in place
            tracker.best_params = [p.detach().clone() for p in params]
        if conv is not None:
            if conv.check(loss_val):
                break
            new_lr = bold.update(epoch + 1, loss_val)
            bold.last_loss = loss_val
            for group in optimizer.param_groups:
                group["lr"] = new_lr
        if checkpoint is not None:
            checkpoint(epoch, loop_state(params, optimizer, bold, conv, tracker, generator))
    return losses, timer
