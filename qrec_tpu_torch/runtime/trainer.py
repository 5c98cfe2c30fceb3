"""Training loop (counterpart of the JAX package's ``runtime/trainer.py``:
its ``EpochLoop`` in both modes, its ``ChunkedLoop`` and its
``ChunkedEvalLoop``).

Each epoch draws its batches from the sampler (or takes injected ones),
runs one optimizer step per batch, and sums the epoch's loss on the
device. Three dispatch strategies, as in the JAX package:

* the per-epoch loop (``chunk=1``) materializes each epoch's loss on the
  host, where ``check_finite`` gives the reference's NaN abort
  (base/iterativeRecommender.py:84-87). Two modes:

  * ``adam``: fixed-LR Adam (the reference's TF paths); with nothing on
    the host reading an epoch's state (``pipelined``) epoch e's loss is
    read after epoch e+1 is enqueued (the JAX package's lag-1 loss);
  * ``bold``: SGD with the bold-driver learning rate and the ``|Δloss| <
    1e-3`` convergence rule (the reference's NumPy-SGD family,
    base/iterativeRecommender.py:56-63,82-102), in the JAX package's order
    after each epoch: the convergence check may end training, then the
    driver's update, its ``last_loss``, and the new rate on the optimizer.

  With a :class:`BestTracker`, a quick evaluation follows each epoch and
  the parameters of the epoch that wins the tracker's vote are kept
  (``EpochLoop.run``'s tracker branch); a ``quick_eval`` without a tracker
  only adds its measures to the epoch line (the rating models' MAE/RMSE);

* the chunked loop (``chunk=E``) runs E epochs a dispatch and reads the
  host once a chunk: the E losses, and with ``eval_vector`` (the chunked
  eval loop) each epoch's quick evaluation, whose majority vote and
  best-parameter selection run on the device and reach the tracker once,
  at the end (:class:`DeviceVote`). On a CUDA device an epoch is one CUDA
  graph (:class:`EpochProgram`: the sampler, the steps, the evaluation and
  the vote), captured once and replayed every epoch; on the CPU the same
  code runs as written. A capture or a replay that fails raises: there is
  no fallback to the per-epoch loop. The loop's committed state
  (:class:`LoopState`) is then the last chunk boundary.

The capture itself (a warm-up on a side stream under sync-debug "error",
rolled back, then the graph) is :class:`GraphProgram`'s, which
:class:`EpochProgram` extends and the loops of their own share: SGNS's
replayed steps (``ops/walks.py``), IF_BPR's epoch (``models/ifbpr.py``),
ESRF's phases and RSGAN's pretraining step and epoch
(``models/adversarial_social.py``), IRGAN's epoch (``models/gan.py``),
CFGAN's (``models/deep.py``) and the ALS models' (``models/als.py``). An
own loop's :class:`EpochProgram` runs its epoch function (``epoch_fn``) in
place of :func:`run_epoch`'s steps, over both players' optimizers (or none)
in one :class:`LoopState`; ESRF runs it through
:class:`ChunkedLoop`, the others through :func:`run_own_epochs`, which
reads the losses on the host only at the epochs they print
(:class:`PrintedLosses`).

Losses, parameters, the best epoch, its measures and its parameters are
the same bits whatever ``chunk`` is: every strategy runs one epoch through
:func:`run_epoch`, the generator draws the same stream (a CUDA graph
replays its draws from the generator's running state), and on a CUDA
device every loop steps one Adam (``runtime/adam.Adam``): plain
``torch.optim.Adam``'s arithmetic with its step count on the device, which
a CUDA graph can hold, in the per-epoch loop, a chunk, an own loop and on
a mesh alike.

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

import contextlib
import gc
import math
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import ConvergenceError
from ..ops import kernels as K
from ..parallel.collectives import all_reduce_sum, reduce_gradients
from .adam import Adam
from .profiling import StepTimer

# fixed metric order of the device-side quick evaluation (the JAX
# package's METRIC_KEYS, trainer.py:135): device_ranking_metrics' order
METRIC_KEYS = ("Precision", "Recall", "F1", "NDCG")


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
    """``adam``: optax.adam's defaults, as :class:`~.adam.Adam` (one
    arithmetic on a CUDA device, capturable); ``bold``: plain SGD, whose
    rate the bold driver sets after every epoch."""
    if mode == "adam":
        return Adam(params, lr=lr)
    if mode == "bold":
        return torch.optim.SGD(params, lr=lr)
    raise ValueError(f"unknown training mode {mode!r} (expected adam|bold)")


def init_adam_state(optimizer: Adam) -> None:
    """Adam's state and step scalars made before its first step, as that
    step makes them (:meth:`~.adam.Adam.prepare`): a CUDA graph's capture
    must not allocate them, and a chunk's snapshot needs the tensors."""
    optimizer.prepare()


# each optimizer's answers of the summed gradient flags on a mesh, by this
# rank's pattern of held gradients (``collectives.reduce_gradients``)
_REACHED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def reached_flags(optimizer: torch.optim.Optimizer) -> dict:
    """The dict that :func:`~..parallel.collectives.reduce_gradients` keeps
    its flag answers in for ``optimizer``'s steps: a fresh optimizer (a
    phase) starts without any."""
    return _REACHED.setdefault(optimizer, {})


def step(optimizer: torch.optim.Optimizer, loss: torch.Tensor, params: Sequence[torch.Tensor],
         mesh=None) -> None:
    """One optimizer step on the gradients of ``loss`` with respect to
    ``params`` alone (a GAN player's step: the other player's tables get no
    gradient). On a ``mesh`` ``loss`` is this rank's share and the
    gradients are summed over ``data`` before the step, as :func:`train`
    sums them."""
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    if mesh is not None:
        reduce_gradients(params, mesh, reached_flags(optimizer))
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


def load_batches(arrays: Sequence, buffers: Optional[tuple], device) -> tuple:
    """Numpy or tensor epoch arrays copied into fixed device ``buffers``
    (made at the first call, from the arrays' shapes and
    :func:`as_device_batches`' dtypes), which a CUDA graph reads where it
    was captured. Returns the buffers."""
    batches = as_device_batches(arrays, "cpu")
    if buffers is None:
        buffers = tuple(torch.empty_like(t, device=device) for t in batches)
    for buf, t in zip(buffers, batches):
        buf.copy_(t)
    return buffers


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


def run_epoch(params, optimizer, loss_fn: Callable, batches, generator: torch.Generator,
              after_step: Optional[Callable] = None, mesh=None) -> torch.Tensor:
    """One epoch of steps over ``batches`` (each tensor (num_batches, ...)):
    the epoch's summed loss as a 0-d device tensor (summed over ``data`` on
    a mesh). Every strategy runs its epochs through this function."""
    total = torch.zeros((), dtype=torch.float32, device=batches[0].device)
    for k in range(batches[0].shape[0]):
        loss = loss_fn(tuple(t[k] for t in batches), generator)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            reduce_gradients(params, mesh, reached_flags(optimizer))
        optimizer.step()
        if after_step is not None:
            after_step()
        total = total + loss.detach()
    if mesh is not None:
        all_reduce_sum(total, mesh.data_group)
    return total


class DeviceVote:
    """The tracker's majority vote kept on the device (the JAX package's
    ``ChunkedEvalLoop`` state, trainer.py:313-393): the best metrics vector
    in ``METRIC_KEYS`` order, the best epoch (1-based, as
    :class:`BestTracker`'s), the best parameters in buffers of their own,
    and the absolute index of the next epoch. Seeded from ``tracker`` when
    it holds a best already (a phase of a multi-phase fit), else from -inf,
    which makes the first epoch win; :meth:`write_back` hands the result to
    the tracker."""

    def __init__(self, params: Sequence[torch.Tensor], tracker: "BestTracker", next_epoch: int):
        device = params[0].device
        if tracker.best_metrics is not None and tracker.best_params is not None:
            self.vec = torch.tensor([tracker.best_metrics[k] for k in METRIC_KEYS],
                                    dtype=torch.float32, device=device)
            self.params = [b.detach().clone() for b in tracker.best_params]
            self.epoch = torch.full((), tracker.best_epoch, dtype=torch.int64, device=device)
        else:
            self.vec = torch.full((len(METRIC_KEYS),), -math.inf, dtype=torch.float32,
                                  device=device)
            self.params = [p.detach().clone() for p in params]
            self.epoch = torch.zeros((), dtype=torch.int64, device=device)
        self.next_epoch = torch.full((), next_epoch, dtype=torch.int64, device=device)

    def tensors(self) -> List[torch.Tensor]:
        return [self.vec, self.epoch, self.next_epoch, *self.params]

    def vote(self, vec: torch.Tensor, params: Sequence[torch.Tensor]) -> None:
        """:meth:`BestTracker.update` on the device: count = Σ(best > new) −
        Σ(best <= new), the epoch wins iff count < 0; the winner's
        parameters are selected into the buffers with ``where``."""
        win = torch.where(self.vec > vec, 1, -1).sum() < 0
        for b, p in zip(self.params, params):
            b.copy_(torch.where(win, p.detach(), b))
        self.vec.copy_(torch.where(win, vec, self.vec))
        self.epoch.copy_(torch.where(win, self.next_epoch + 1, self.epoch))
        self.next_epoch.add_(1)

    def write_back(self, tracker: "BestTracker") -> None:
        """The vote's result onto ``tracker`` (one host read), when its
        vector is finite, i.e. when some epoch won."""
        vec = self.vec.tolist()
        if all(math.isfinite(v) for v in vec):
            tracker.best_metrics = dict(zip(METRIC_KEYS, vec))
            tracker.best_epoch = int(self.epoch)
            tracker.best_params = self.params


class LoopState:
    """The chunked loops' committed state (the JAX package's ``LoopState``,
    trainer.py:242-267): the epoch and a copy, taken at that epoch's
    boundary, of everything an epoch changes in place, namely the parameters,
    the state of the optimizer (or of each of a sequence of them: both
    players' of a GAN), the generator's state, the device vote's and the
    ``extra`` tensors (BUIR's momentum target, SGNS's step counter, IF_BPR's
    thresholds); a loop that draws nothing inside its graph has no
    ``generator``. ``optimizer`` is the first optimizer, ``optimizers``
    all of them (none for the ALS loops, whose tables are ``params``).
    INVARIANT: ``commit`` runs only after the host has read a chunk's
    losses, which proves its dispatches ran; a chunk that fails calls
    ``rollback``, which puts the copy back in place, so the state is the
    last committed boundary's, bit for bit."""

    def __init__(self, epoch: int, params: Sequence[torch.Tensor], optimizer,
                 generator: Optional[torch.Generator], vote: Optional[DeviceVote] = None,
                 extra: Sequence[torch.Tensor] = ()):
        self.params = list(params)
        self.optimizers = list(optimizer) if isinstance(optimizer, (list, tuple)) else [optimizer]
        self.optimizer = self.optimizers[0] if self.optimizers else None
        self.generator = generator
        self.vote = vote
        self.extra = list(extra)
        self.commit(epoch)

    def tensors(self) -> List[torch.Tensor]:
        out = list(self.params)
        for opt in self.optimizers:
            for group in opt.param_groups:
                for p in group["params"]:
                    state = opt.state[p]
                    out += [state[k] for k in sorted(state) if isinstance(state[k], torch.Tensor)]
        return out + (self.vote.tensors() if self.vote is not None else []) + self.extra

    def commit(self, epoch: int) -> None:
        self.epoch = epoch
        self._saved = [t.detach().clone() for t in self.tensors()]
        self._generator = None if self.generator is None else self.generator.get_state()

    def rollback(self) -> None:
        with torch.no_grad():
            for t, saved in zip(self.tensors(), self._saved):
                t.copy_(saved)
        if self.generator is not None:
            self.generator.set_state(self._generator)


class GraphProgram:
    """A body of device work that a loop runs again and again (an epoch, or
    a few SGNS steps), and on a CUDA device its CUDA graph: ``body``, or a
    subclass's :meth:`body`. Neither may hold a reference back to the
    program's owner: a CUDA graph left in a reference cycle is freed by
    Python's cyclic collector at an arbitrary later time, and freeing it
    while another graph is being captured invalidates that capture.

    :meth:`capture` records the body once into a CUDA graph on a side
    stream, after one warm-up run on that stream (it sizes the kernels'
    scratch, which is kept per stream, and makes the libraries' handles)
    whose effects ``state`` rolls back, launch counts included; the state's
    generator, where it has one, is registered with the graph, so that
    every replay draws what an eager run would draw. No host read can hide
    in the body: the warm-up runs under CUDA's sync-debug mode "error", and
    the capture itself fails on one. The cyclic collector is paused over
    the capture. :meth:`run` replays the graph and counts its kernel
    launches (``ops/kernels.GraphLaunches``). On the CPU :meth:`run` runs
    the body as written. A capture or a replay that fails raises, the
    state rolled back to its committed boundary: nothing falls back to the
    eager loop."""

    def __init__(self, state: LoopState, device, body: Optional[Callable[[], None]] = None):
        self.state = state
        self.device = torch.device(device)
        self._body = body
        self.graph = None
        self.launches = None

    def body(self) -> None:
        self._body()

    def capture(self) -> None:
        """Warm up and capture at the state's committed boundary."""
        counts = K.launch_counts(K.ALL_KERNELS)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            try:
                with torch.cuda.stream(stream), _host_reads_refused():
                    self.body()
            finally:
                torch.cuda.current_stream(self.device).wait_stream(stream)
                K.set_launch_counts(counts)
            self.state.rollback()
            graph = torch.cuda.CUDAGraph()
            if self.state.generator is not None:
                graph.register_generator_state(self.state.generator)
            launches = K.GraphLaunches()
            with launches.record(), _collector_paused(), torch.cuda.graph(graph, stream=stream):
                self.body()
        except BaseException:
            self.state.rollback()
            raise
        self.graph, self.launches = graph, launches

    def run(self) -> None:
        if self.device.type != "cuda":
            self.body()
            return
        if self.graph is None:
            raise RuntimeError("GraphProgram.run before capture")
        try:
            self.graph.replay()
        except BaseException:
            self.state.rollback()
            raise
        self.launches.add()


class EpochProgram(GraphProgram):
    """One epoch as the chunked loops run it (a :class:`GraphProgram`): its
    batches (the sampler's, or the injected arrays copied into fixed
    buffers; None without a sampler), its steps (:func:`run_epoch`, or an
    own loop's ``epoch_fn(batches, generator) -> losses``, over the
    state's optimizers), the summed loss (or an own loop's losses, of
    ``loss_shape``) into ``loss``, and with a ``vote`` the quick evaluation
    (``evaluate() -> (4,) f32`` in ``METRIC_KEYS`` order) into ``vec`` and
    the vote. ``capture`` and ``run`` take the epoch, whose injected arrays
    they load first."""

    def __init__(self, state: LoopState, loss_fn: Optional[Callable], sampler: Optional[Callable],
                 device, *, epoch_batches: Optional[Sequence] = None,
                 after_step: Optional[Callable] = None, evaluate: Optional[Callable] = None,
                 epoch_fn: Optional[Callable] = None, loss_shape: Tuple[int, ...] = ()):
        super().__init__(state, device)
        self.loss_fn = loss_fn
        self.sampler = sampler
        self.epoch_batches = epoch_batches
        self.after_step = after_step
        self.evaluate = evaluate
        self.epoch_fn = epoch_fn
        self.loss = torch.zeros(loss_shape, dtype=torch.float32, device=self.device)
        self.vec = torch.zeros(len(METRIC_KEYS), dtype=torch.float32, device=self.device)
        self._batches = None

    def _load(self, epoch: int) -> None:
        """The injected arrays of ``epoch`` into the fixed buffers."""
        if self.epoch_batches is None:
            return
        self._batches = load_batches(self.epoch_batches[epoch], self._batches, self.device)

    def body(self) -> None:
        st = self.state
        if self.epoch_batches is not None:
            batches = self._batches
        else:
            batches = None if self.sampler is None else self.sampler(st.generator)
        if self.epoch_fn is not None:
            self.loss.copy_(self.epoch_fn(batches, st.generator))
        else:
            self.loss.copy_(run_epoch(st.params, st.optimizer, self.loss_fn, batches,
                                      st.generator, self.after_step))
        if self.evaluate is not None:
            with torch.no_grad():
                vec = self.evaluate()
                self.vec.copy_(vec)
                st.vote.vote(vec, st.params)

    def capture(self, epoch: int) -> None:
        """Warm up and capture at the committed boundary ``epoch``."""
        self._load(epoch)
        super().capture()

    def run(self, epoch: int) -> None:
        self._load(epoch)
        super().run()


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic garbage collector off over the block (a collection
    inside a capture could free a CUDA graph left in some reference cycle,
    which invalidates the capture), back on after it if it was on."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@contextlib.contextmanager
def _host_reads_refused():
    """CUDA's sync-debug mode "error" over the block: a host read inside
    it raises."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


class PrintedLosses:
    """An own loop's losses, ``width`` an epoch, kept in a device buffer
    and read on the host only at the epochs the loop prints, every
    ``every``-th and the last, where the JAX package's own loops read
    them: :meth:`put` copies an epoch's losses in on the device,
    :meth:`read` reads the rows not yet read, in one copy, when the epoch
    is a printed one, each loss checked for NaN there. A read proves the
    epochs before it ran, so it commits ``state`` (the loop's
    :class:`LoopState`, where it runs a program) at that boundary."""

    def __init__(self, epochs: int, every: int, device, width: int = 1,
                 state: Optional[LoopState] = None):
        self.epochs, self.every, self.state = epochs, every, state
        self.buf = torch.zeros((epochs, width), dtype=torch.float32, device=device)
        self.rows: List[List[float]] = []

    def put(self, epoch: int, losses: torch.Tensor) -> None:
        self.buf[epoch].copy_(losses)

    def read(self, epoch: int) -> Optional[List[float]]:
        """At a printed ``epoch``, the losses of the epochs since the last
        read, read and checked, and ``epoch``'s row returned; else None."""
        if (epoch + 1) % self.every and epoch != self.epochs - 1:
            return None
        for row in self.buf[len(self.rows):epoch + 1].tolist():
            for loss in row:
                check_finite(loss)
            self.rows.append(row)
        if self.state is not None:
            self.state.commit(epoch + 1)
        return self.rows[-1]


def run_own_epochs(params: Sequence[torch.Tensor], optimizers: Sequence, generator: torch.Generator,
                   epoch_fn: Callable, *, epochs: int, every: int, device, timer: StepTimer,
                   graphs: bool, emit: Callable[[int, List[float]], None],
                   sampler: Optional[Callable] = None, epoch_batches: Optional[Sequence] = None,
                   width: int = 1, context: Callable = contextlib.nullcontext) -> List[List[float]]:
    """``epochs`` epochs of an own loop (IRGAN's, CFGAN's, RSGAN's GAN
    epochs, the ALS models' epochs with no optimizer and no generator):
    ``epoch_fn(batches, generator) -> losses`` (``width`` of them)
    an epoch, on the sampler's batches, the injected ``epoch_batches`` or
    None. With ``graphs`` the epoch is an :class:`EpochProgram` over a
    :class:`LoopState` of ``params``, the ``optimizers`` and ``generator``, captured before
    the first epoch on a CUDA device (into ``timer.captures``) and replayed
    once an epoch; else the epochs run step by step. The losses wait in
    :class:`PrintedLosses`, read at every ``every``-th epoch and the last,
    where ``emit(epoch, row)`` prints the epoch's. ``context()`` is in
    force over the capture and every epoch. Returns every epoch's losses."""
    program = None
    if graphs:
        for opt in optimizers:
            init_adam_state(opt)
        program = EpochProgram(LoopState(0, params, list(optimizers), generator), None, sampler,
                               device, epoch_batches=epoch_batches, epoch_fn=epoch_fn,
                               loss_shape=(width,))
        if program.device.type == "cuda":
            with context(), timer.capture():
                program.capture(0)
    losses = PrintedLosses(epochs, every, device, width,
                           state=None if program is None else program.state)
    for epoch in range(epochs):
        with timer, context():
            if program is not None:
                program.run(epoch)
                losses.put(epoch, program.loss)
            else:
                if epoch_batches is not None:
                    batches = as_device_batches(epoch_batches[epoch], device)
                else:
                    batches = None if sampler is None else sampler(generator)
                losses.put(epoch, epoch_fn(batches, generator))
        row = losses.read(epoch)
        if row is not None:
            emit(epoch, row)
    return losses.rows


class ChunkedLoop:
    """``chunk`` epochs a dispatch, one host read a chunk (the JAX
    package's ``ChunkedLoop`` and, with a vote, its ``ChunkedEvalLoop``,
    trainer.py:281-393). The chunk's epochs write their losses (and
    measures) into one device buffer, which the host reads once after the
    last; the epoch lines follow, each with the chunk's wall / E (" incl.
    eval" when the evaluation ran inside). A failure inside a chunk rolls
    the state back to the chunk's start and propagates. ``program`` is an
    :class:`EpochProgram` or any program with its ``loss``, ``device``,
    ``graph``, ``capture(epoch)`` and ``run(epoch)`` (an ``evaluate``, if
    it has one, then fills ``vec``)."""

    def __init__(self, program: EpochProgram, chunk: int, *, timer: StepTimer,
                 emit: Optional[Callable], lr: float):
        self.program = program
        self.chunk = chunk
        self.timer = timer
        self.emit = emit
        self.lr = lr
        self.out = torch.zeros((chunk, 1 + len(METRIC_KEYS)), dtype=torch.float32,
                               device=program.device)

    def run(self, st: LoopState, max_epoch: int) -> List[float]:
        prog = self.program
        losses: List[float] = []
        if prog.device.type == "cuda" and prog.graph is None and st.epoch < max_epoch:
            try:
                with self.timer.capture():
                    prog.capture(st.epoch)
            except BaseException:
                st.rollback()
                raise
        fused = getattr(prog, "evaluate", None) is not None
        while st.epoch < max_epoch:
            e = min(self.chunk, max_epoch - st.epoch)
            try:
                with self.timer.chunk(e):
                    for k in range(e):
                        prog.run(st.epoch + k)
                        self.out[k, 0].copy_(prog.loss)
                        if fused:
                            self.out[k, 1:].copy_(prog.vec)
                    # the chunk's one host read: it proves the chunk ran
                    rows = self.out[:e].tolist()
            except BaseException:
                st.rollback()
                raise
            base = st.epoch
            st.commit(base + e)
            wall = self.timer.last
            for k, row in enumerate(rows):
                check_finite(row[0])
                losses.append(row[0])
                if self.emit is not None:
                    metrics = dict(zip(METRIC_KEYS, row[1:])) if fused else None
                    self.emit(base + k, row[0], self.lr, wall, metrics, eval_fused=fused)
        return losses


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
    mesh=None,
    chunk: int = 1,
    eval_vector: Optional[Callable] = None,
    extra: Sequence[torch.Tensor] = (),
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
    ``emit(epoch, loss, lr, seconds, metrics, eval_fused=False)`` prints
    the epoch line with the learning rate in force during the epoch.
    ``after_step()`` runs after every optimizer step (BUIR's momentum
    target); ``extra`` are the tensors besides the parameters that an epoch
    changes in place (BUIR's target), which a chunk that fails rolls back
    with them. ``resume`` (a :func:`loop_state` saved after epoch
    ``start_epoch``) is restored before the first epoch, which is then
    ``start_epoch``; ``checkpoint(epoch, state)`` runs after every epoch
    that does not end the bold mode's training, once its rate is updated.

    ``chunk`` > 1 runs the epochs in chunks of that many
    (:class:`ChunkedLoop`) when more than one epoch is left; it needs the
    ``adam`` mode and no checkpoint, resume or mesh, as the JAX package
    chunks. With a ``tracker`` it takes ``eval_vector() -> (4,) f32``, the
    quick evaluation in ``METRIC_KEYS`` order, in place of ``quick_eval``,
    and votes on the device. Without a chunk and without a ``quick_eval``,
    an ``adam`` run reads epoch e's loss after it has enqueued epoch e+1
    (lag-1: its line and its NaN abort come one epoch later). Its timer
    then does not synchronise, so the host enqueues epoch e+1 while the
    device finishes epoch e: epoch e's
    interval holds its enqueue and the wait for epoch e-1's loss, the last
    one also the wait for its own.

    On a ``mesh`` (``parallel/mesh.py``) each step's loss is this rank's
    share: the gradients are summed over ``data`` between the backward and
    the optimizer's step (GSPMD's gradient psum in the JAX package), and the
    epoch's total is summed over ``data`` before it reaches the host, so
    that every rank's bold driver, convergence rule and epoch line read the
    one-process loss, the same bits on every rank.
    """
    optimizer = make_optimizer(params, mode, lr)
    bold = BoldDriver(lr, max_lr) if mode == "bold" else None
    conv = ConvergenceMonitor() if mode == "bold" else None
    if resume is not None:
        restore_loop_state(resume, params, optimizer, bold, conv, tracker, generator)
    chunked = chunk > 1 and max_epoch - start_epoch > 1
    pipelined = not chunked and mode == "adam" and quick_eval is None
    timer = StepTimer(examples_per_epoch, device, sync=not pipelined)
    if chunked:
        if mode != "adam" or checkpoint is not None or resume is not None or mesh is not None:
            raise ValueError("train.chunk > 1 needs the adam mode, no checkpoint and no mesh")
        if tracker is not None and eval_vector is None:
            raise ValueError("a chunked run with a tracker needs eval_vector")
        init_adam_state(optimizer)
        vote = (DeviceVote(params, tracker, start_epoch + tracker.epoch_offset)
                if tracker is not None else None)
        st = LoopState(start_epoch, params, optimizer, generator, vote, extra)
        program = EpochProgram(st, loss_fn, sampler, device, epoch_batches=epoch_batches,
                               after_step=after_step,
                               evaluate=eval_vector if vote is not None else None)
        loop = ChunkedLoop(program, chunk, timer=timer, emit=emit, lr=lr)
        losses = loop.run(st, max_epoch)
        if vote is not None:
            vote.write_back(tracker)
        return losses, timer
    losses: List[float] = []
    pending = None  # lag-1: (epoch, device loss) not yet read
    for epoch in range(start_epoch, max_epoch):
        with timer:
            if epoch_batches is not None:
                batches = as_device_batches(epoch_batches[epoch], device)
            else:
                batches = sampler(generator)
            total = run_epoch(params, optimizer, loss_fn, batches, generator, after_step, mesh)
            if pipelined:
                # epoch e-1's loss, read once epoch e is enqueued; the last
                # epoch's own too
                ready = [] if pending is None else [pending]
                pending = (epoch, total)
                if epoch == max_epoch - 1:
                    ready, pending = ready + [pending], None
                read = [(e, float(t)) for e, t in ready]
            else:
                loss_val = float(total)
        if pipelined:
            for e, val in read:
                check_finite(val)
                losses.append(val)
                if emit is not None:
                    emit(e, val, lr, timer.times[e - start_epoch], None)
            if checkpoint is not None:
                checkpoint(epoch, loop_state(params, optimizer, bold, conv, tracker, generator))
            continue
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
