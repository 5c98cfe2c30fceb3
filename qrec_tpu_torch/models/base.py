"""Model base hierarchy (counterpart of the JAX package's ``models/base.py``;
reference base/recommender.py, base/iterativeRecommender.py,
base/graphRecommender.py).

A model is an ``nn.Module`` on one device: the CUDA device unless the
caller passes ``device="cpu"`` (``device.resolve_device``). It implements
``build() -> TrainSpec``; the inherited ``fit()`` trains with fixed-LR Adam
(runtime/trainer.py), with a per-epoch quick evaluation and best-epoch
selection when the spec asks for it, and ``finalize`` leaves the final user
and item factors in ``self.U`` / ``self.V`` for the full-catalog ranker.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import ModelConf, OptionConf
from ..data.dataset import Interactions
from ..device import resolve_device
from ..errors import ConfigError
from ..ops import sampling
from ..ops.metrics import device_ranking_metrics
from ..ops.topk import CatalogRanker
from ..runtime import trainer as T

DEFAULT_SEED = 2026


class TrainSpec:
    """A single-phase training problem: the parameters to train, the
    per-batch loss ``loss_fn(batch, generator)``, the epoch sampler, the map
    from trained parameters to the final (user, item) factors, and whether
    to evaluate every epoch and keep the best epoch's parameters."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        loss_fn: Callable,
        sampler: Callable,
        score_params_fn: Callable,
        track_best: bool = False,
    ):
        self.params = list(params)
        self.loss_fn = loss_fn
        self.sampler = sampler
        self.score_params_fn = score_params_fn
        self.track_best = track_best


class Recommender(nn.Module):
    """Root template (reference base/recommender.py:14-94)."""

    # full-catalog scoring batch (users per masked-scorer launch)
    eval_batch_size = 1024

    def __init__(self, conf: ModelConf, data: Interactions, fold: str = "[1]", device=None):
        super().__init__()
        self.config = conf
        self.data = data
        self.fold = fold
        self.device = resolve_device(device)
        self.model_name = conf["model.name"]
        self.eval_settings = conf.options("evaluation.setup")
        self.ranking = conf.options("item.ranking")
        self.num_users, self.num_items, self.train_size = data.trainingSize()
        self.seed = conf.get_int("seed", DEFAULT_SEED)
        self.U: Optional[torch.Tensor] = None
        self.V: Optional[torch.Tensor] = None
        self.read_configuration()

    def read_configuration(self) -> None:
        pass

    def model_args(self) -> Optional[OptionConf]:
        return self.config.model_options()

    def print_config(self) -> None:
        """Model banner (base/recommender.py:44-61)."""
        print("Model:", self.model_name)
        if self.config.contains("ratings"):
            print("Ratings dataset:", os.path.abspath(self.config["ratings"]))
        if self.eval_settings.contains("-testSet"):
            print("Test set:", os.path.abspath(self.eval_settings["-testSet"]))
        print(
            "Training set size: (user count: %d, item count %d, record count: %d)"
            % self.data.trainingSize()
        )
        print(
            "Test set size: (user count: %d, item count %d, record count: %d)"
            % self.data.testSize()
        )
        print("=" * 80)
        args = self.model_args()
        if args is not None:
            par = "  ".join(f"{k[1:]}:{args[k]}" for k in args.keys())
            print("Specific parameters:", par)
            print("=" * 80)

    def fit(self) -> None:
        pass


class IterativeRecommender(Recommender):
    """Adds embedding config, the training loop and the device-resident
    training arrays (base/iterativeRecommender.py)."""

    def read_configuration(self) -> None:
        super().read_configuration()
        self.emb_size = self.config.get_int("num.factors")
        self.max_epoch = self.config.get_int("num.max.epoch")
        lr_conf = self.config.options("learnRate")
        self.lrate = lr_conf.get_float("-init")
        self.max_lrate = lr_conf.get_float("-max")
        reg = self.config.options("reg.lambda")
        self.reg_u = reg.get_float("-u")
        self.reg_i = reg.get_float("-i")
        self.reg_b = reg.get_float("-b", 0.0)
        self.batch_size = self.config.get_int("batch_size", 2000)

    # -- init -------------------------------------------------------------
    def init_embeddings(self) -> dict:
        """Truncated normal σ=0.005 cut at ±2σ (deepRecommender.py:21-22),
        drawn on the CPU from ``seed`` so a seed gives the same tables on
        every device."""
        gen = torch.Generator().manual_seed(self.seed)
        out = {}
        for name, rows in (("user_emb", self.num_users), ("item_emb", self.num_items)):
            t = torch.empty((rows, self.emb_size), dtype=torch.float32)
            nn.init.trunc_normal_(t, std=0.005, a=-0.01, b=0.01, generator=gen)
            out[name] = t.to(self.device)
        return out

    # -- device-resident training arrays ----------------------------------
    @property
    def train_arrays(self) -> dict:
        if not hasattr(self, "_train_arrays"):
            d = self.data
            idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=self.device)  # noqa: E731
            self._train_arrays = {
                "u": idx(d.train_u),
                "i": idx(d.train_i),
                "indices": idx(d.u_indices),
                "indptr": idx(d.u_indptr),
            }
        return self._train_arrays

    @property
    def rated_bitmask(self) -> torch.Tensor:
        """Packed (U, ceil(I/32)) int32 rated-items bitmask on the device."""
        if not hasattr(self, "_rated_bitmask"):
            self._rated_bitmask = torch.from_numpy(
                sampling.pack_bitmask(
                    self.data.u_indptr, self.data.u_indices, self.num_users, self.num_items
                )
            ).to(self.device)
        return self._rated_bitmask

    def _auto_tries(self) -> int:
        """Smallest rejection-round count whose expected whole-epoch failure
        count stays below 1e-2, so the exact fallback essentially never runs;
        the per-sample failure probability is (deg_u/num_items)^t."""
        if not self.train_size:
            return 4
        deg = np.diff(self.data.u_indptr).astype(np.float64)
        ratio = deg / max(self.num_items, 1)
        for t in (4, 6, 8, 12):
            if float(np.sum(deg * ratio**t)) < 1e-2:
                return t
        return 16

    def pairwise_sampler(self) -> Callable:
        """generator -> (users, pos, neg, weight) batched epoch tensors."""
        num_tries = self._auto_tries()
        ta = self.train_arrays
        row_iters = sampling._bisect_iters(
            int(np.max(np.diff(self.data.u_indptr))) if self.train_size else 1
        )
        bitmask = self.rated_bitmask

        def sampler(gen: torch.Generator):
            return sampling.pairwise_epoch(
                gen, ta["u"], ta["i"], ta["indices"], ta["indptr"], bitmask,
                num_items=self.num_items, batch_size=self.batch_size,
                num_tries=num_tries, row_iters=row_iters,
            )

        return sampler

    # -- lifecycle --------------------------------------------------------
    def build(self) -> TrainSpec:
        raise NotImplementedError

    def finalize(self, spec: TrainSpec) -> None:
        """Map the trained parameters onto the final factors ``U`` / ``V``."""
        with torch.no_grad():
            users, items = spec.score_params_fn()
        self.U = users.contiguous()
        self.V = items.contiguous()

    # -- quick eval -------------------------------------------------------
    def _quick_ranker(self) -> Optional[CatalogRanker]:
        """The top-N ranker of the per-epoch evaluation, N = max(-topN) (10
        outside 1..100); None without ranking or test users."""
        if not self.ranking.isMainOn() or len(self.data.test_set_u) == 0:
            return None
        if not hasattr(self, "_ranker"):
            n = max(self.ranking.get_ints("-topN"))
            if n > 100 or n < 1:
                n = 10
            self._top_n = n
            self._ranker = CatalogRanker(
                self.data, k=n, device=self.device, batch_size=self.eval_batch_size
            )
        return self._ranker

    def quick_eval(self, spec: TrainSpec) -> dict:
        """Precision/Recall/F1/NDCG at the top N of the current parameters,
        ranked and measured on the device; one host copy of four numbers."""
        ranker = self._quick_ranker()
        with torch.no_grad():
            users, items = spec.score_params_fn()
        ids, _ = ranker.topk_device(users.contiguous(), items, self.rated_bitmask)
        dev = device_ranking_metrics(ids, ranker.test_ids, ranker.test_counts, [self._top_n])
        return {k: float(v) for k, v in dev[self._top_n].items()}

    def _emit(self, epoch: int, loss: float, wall: float, metrics: Optional[dict] = None) -> None:
        """Epoch line (iterativeRecommender.py:88-94), with the quick
        evaluation's measures when there is one."""
        eps = self.train_size / wall if wall > 0 else 0.0
        extra = "" if metrics is None else " " + " ".join(f"{k}:{v:.5f}" for k, v in metrics.items())
        print(
            f"{self.model_name} {self.fold} epoch {epoch + 1}: "
            f"loss = {loss:.4f} learning_rate = {self.lrate:.5f}{extra} "
            f"[{wall * 1e3:.1f} ms, {eps:,.0f} ex/s]"
        )

    def fit(self, epoch_batches: Optional[Sequence] = None) -> List[float]:
        """Train for ``num.max.epoch`` epochs and finalize. ``epoch_batches``
        injects one (users, pos, neg, weight) tuple of arrays per epoch in
        place of the sampler. When the spec tracks the best epoch, the
        parameters of the epoch that won the vote are restored before
        finalizing (base/iterativeRecommender.py:132-169). Returns the
        per-epoch losses."""
        spec = self.build()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        tracker = None
        if spec.track_best and self._quick_ranker() is not None:
            tracker = T.BestTracker()
        self.tracker = tracker
        self.epoch_losses, self.timer = T.train(
            spec.params, spec.loss_fn, spec.sampler,
            max_epoch=self.max_epoch, lr=self.lrate, device=self.device,
            generator=gen, examples_per_epoch=self.train_size,
            emit=self._emit, epoch_batches=epoch_batches,
            quick_eval=lambda: self.quick_eval(spec), tracker=tracker,
        )
        if tracker is not None and tracker.best_params is not None:
            print(
                f"{self.model_name} {self.fold} best epoch {tracker.best_epoch}: "
                + " | ".join(f"{k}:{v:.5f}" for k, v in tracker.best_metrics.items())
            )
            with torch.no_grad():
                for p, best in zip(spec.params, tracker.best_params):
                    p.copy_(best)
        self.finalize(spec)
        return self.epoch_losses


def check_graph_settings(conf: ModelConf) -> None:
    """Raise ConfigError for adjacency settings this port does not run: it
    has the factored dense joint adjacency and the sparse one."""
    backend = conf.get("graph.backend", "auto")
    if backend == "coo":
        raise ConfigError(
            "graph.backend=coo (DeviceCOO: f32 gather and segment_sum) is not ported "
            "yet (ROADMAP.md Queue 1 item 5); use auto|dense|pallas"
        )
    if backend not in ("auto", "dense", "pallas"):
        raise ConfigError(f"unknown graph.backend {backend!r} (expected auto|dense|coo|pallas)")
    quant = conf.get("graph.dense.quant", "auto")
    if quant not in ("auto", "factored"):
        raise ConfigError(
            f"graph.dense.quant={quant} is not ported yet (ROADMAP.md Queue 1: "
            "bf16 and legacy int8 DenseJoint forms); use auto|factored"
        )
    dual = conf.get("graph.dense.dual", "auto")
    if dual not in ("auto", "on", "off"):
        raise ConfigError(f"graph.dense.dual must be auto|on|off, got {dual!r}")


class GraphRecommender(IterativeRecommender):
    """Adds the joint adjacency on the device (base/graphRecommender.py:10-39;
    the JAX package's ``GraphRecommender.joint_adj``, ``models/base.py:866-1034``).

    ``graph.backend=dense``, or ``auto`` while ``num_users x num_items``
    fits ``graph.dense.limit``, builds the factored dense adjacency, which
    every propagation runs through on the dual kernel whatever
    ``graph.dense.dual`` says: the factored function is the one the JAX
    package computes, and the port has no other dense path.
    ``graph.backend=pallas``, or ``auto`` past the limit, builds the sparse
    one on the segment kernel: the JAX package's single-device choice on a
    TPU (off a TPU its ``auto`` gives ``DeviceCOO``, which is not ported)."""

    @property
    def joint_adj(self):
        if not hasattr(self, "_joint_adj"):
            from ..data.graph import joint_normalized_adjacency
            from ..ops.spmm import DENSE_JOINT_LIMIT, DenseJoint, SparseJoint

            check_graph_settings(self.config)
            try:
                limit = int(self.config.get("graph.dense.limit", DENSE_JOINT_LIMIT))
            except ValueError:
                raise ConfigError(
                    "graph.dense.limit must be an integer entry budget, got "
                    f"{self.config.get('graph.dense.limit')!r}"
                ) from None
            backend = self.config.get("graph.backend", "auto")
            dense = backend == "dense" or (
                backend == "auto" and self.num_users * self.num_items <= limit
            )
            if dense:
                self._joint_adj = DenseJoint.from_interactions(self.data, self.device)
                built = "DenseJoint factored int8, dual kernel"
            else:
                self._joint_adj = SparseJoint.from_host(
                    joint_normalized_adjacency(self.data), self.device, check_symmetric=False
                )
                built = "SparseJoint CSR, segment kernel"
            print(f"Graph backend: {built} (graph.backend={backend})")
        return self._joint_adj
