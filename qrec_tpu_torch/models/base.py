"""Model base hierarchy (counterpart of the JAX package's ``models/base.py``;
reference base/recommender.py, base/iterativeRecommender.py,
base/graphRecommender.py).

A model is an ``nn.Module`` on one device: the CUDA device unless the
caller passes ``device="cpu"`` (``device.resolve_device``). An iterative
model implements ``build() -> TrainSpec``; the inherited ``fit()`` trains
with fixed-LR Adam or bold-driver SGD (runtime/trainer.py), with a
per-epoch quick evaluation and best-epoch selection when the spec asks for
it (or the per-epoch MAE/RMSE of a rating run), and ``finalize`` leaves the
final user and item factors in ``self.U`` / ``self.V``. A model trained in
several phases (NeuMF, APR) overrides ``fit_phases`` and calls
``run_training`` once a phase. Every model gives the ranker its score form
(``score_form``; ``ops/topk.ScoreForm``, or ``ScoreBlock`` for a scorer
that is not a dot product) and predicts ratings with the reference's mean
fallbacks (``predict_ratings``).

Persistence, as in the JAX package (``qrec_tpu/models/base.py:138-172,
519-613``): ``save_model``/``load_model`` write and read an ``np.savez``
file of ``U``, ``V`` and the model's ``_extra_state`` under the JAX
package's keys, so a file of either package loads in the other; the
generic loop (``run_training``) saves a checkpoint every ``-every``
epochs under ``checkpoint.setup`` and resumes from the latest
(``runtime/checkpoint.py``). On a mesh rank 0 alone writes a saved model
or a step file and every rank waits for it; a resumed phase restores the
step that rank 0 saw, broadcast, on every rank.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import ModelConf, OptionConf
from ..data.dataset import Interactions
from ..device import resolve_device
from ..errors import ConfigError
from ..ops import sampling
from ..ops.metrics import device_ranking_metrics
from ..ops.topk import CatalogRanker, RandomScores, ScoreForm
from ..parallel.collectives import barrier, broadcast_int, split_range
from ..parallel.mesh import is_writer, mesh_from_config
from ..runtime import checkpoint as C
from ..runtime import trainer as T
from ..runtime.profiling import StepTimer, recorder, spanned

DEFAULT_SEED = 2026


class TrainSpec:
    """A single-phase training problem: the parameters to train, the
    per-batch loss ``loss_fn(batch, generator)``, the epoch sampler, the map
    from trained parameters to the final (user, item) factors, whether to
    evaluate every epoch and keep the best epoch's parameters, and the
    training mode (``adam`` or ``bold``, runtime/trainer.py). ``chunkable``
    says that the sampler, the loss and the score parameters read nothing
    from the host, so that ``train.chunk`` may run a chunk of epochs as one
    dispatch (on a CUDA device, as CUDA graphs)."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        loss_fn: Callable,
        sampler: Callable,
        score_params_fn: Callable,
        track_best: bool = False,
        mode: str = "adam",
        chunkable: bool = False,
    ):
        self.params = list(params)
        self.loss_fn = loss_fn
        self.sampler = sampler
        self.score_params_fn = score_params_fn
        self.track_best = track_best
        self.mode = mode
        self.chunkable = chunkable


class Recommender(nn.Module):
    """Root template (reference base/recommender.py:14-94)."""

    # full-catalog scoring batch (users per masked-scorer launch)
    eval_batch_size = 1024
    # the form of the training epochs, which no conf reads: None, one CUDA
    # graph an epoch on a CUDA device and the per-step loop elsewhere; True,
    # the captured form (run as written off a card); False, the per-step
    # loop. The own loops (ESRF, RSGAN, IRGAN, CFGAN, IF_BPR and the ALS
    # models) read it through ``own_loop_form``; a ``run_training`` phase
    # runs per epoch under False, and under None or True as ``train.chunk``
    # says (BUIR's)
    epoch_graphs: Optional[bool] = None
    # a model that needs the trust relation (SocialRecommender) gets it as
    # ``social``; the session refuses to run it without one
    requires_social = False

    def __init_subclass__(cls, **kwargs):
        """A model's construction is a ``model.init`` span and its
        ``finalize`` a ``model.finalize`` span, in whichever class they
        are defined (a call of the parent class's folds into it)."""
        super().__init_subclass__(**kwargs)
        for attr, name in (("__init__", "model.init"), ("finalize", "model.finalize")):
            if attr in cls.__dict__:
                setattr(cls, attr, spanned(name)(cls.__dict__[attr]))

    @spanned("model.init")
    def __init__(self, conf: ModelConf, data: Interactions, fold: str = "[1]", device=None,
                 social=None):
        super().__init__()
        self.config = conf
        self.data = data
        self.social = social
        self.fold = fold
        self.device = resolve_device(device)
        self.model_name = conf["model.name"]
        self.eval_settings = conf.options("evaluation.setup")
        self.ranking = conf.options("item.ranking")
        self.num_users, self.num_items, self.train_size = data.trainingSize()
        self.seed = conf.get_int("seed", DEFAULT_SEED)
        self.U: Optional[torch.Tensor] = None
        self.V: Optional[torch.Tensor] = None
        # the epoch timer of a trained model (runtime/trainer.py)
        self.timer = None
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

    def own_loop_form(self, epochs: int, collectives: bool = False) -> bool:
        """Whether an own loop of ``epochs`` epochs a phase runs in its
        captured form: where ``epoch_graphs`` says so, or with it None on
        a CUDA device where the loop runs more than one epoch. A loop whose
        steps hold ``collectives`` (ESRF's) runs per step on a mesh. Adam's
        arithmetic is the same in both forms (``runtime/adam.Adam``)."""
        if collectives and self.mesh is not None:
            return False
        if self.epoch_graphs is not None:
            return self.epoch_graphs
        return self.device.type == "cuda" and epochs > 1

    @property
    def mesh(self):
        """The ('data', 'model') mesh that the run asks for over more than
        one rank (``parallel/mesh.py``: ``parallel.setup=on [-model K]``,
        or on a CUDA device a launcher of more than one process with the
        setting absent; the JAX package's ``Recommender.mesh``,
        ``models/base.py:366-400``), else None: in one process the setting
        changes nothing. Every model runs there, each data rank's loss its
        share of the step's, but the own-loop, ALS and untrained models
        (CFGAN, IRGAN, RSGAN, IF_BPR, WRMF, ExpoMF, CoFactor, SERec,
        UserMean, ItemMean, MostPopular, Rand, UserKNN, ItemKNN and
        SlopeOne), which train whole on every rank from the same seed with
        no collective in the loop, as the JAX package's own loops read no
        mesh. Either way a ``ScoreForm`` ranks each rank's share of the
        test users through K2 and gathers the lists; score blocks and
        random scores rank whole on every rank, and a rating run predicts
        every test rating on every rank. Checkpoints, ``model.setup``'s
        ``-save`` and ``-load`` and ``-cv k -p`` run there: rank 0 alone
        writes a step file or a saved model, every rank reads them, and
        ``-cv``'s folds run in turn on the mesh."""
        if not hasattr(self, "_mesh"):
            self._mesh = mesh_from_config(self.config, self.device)
        return self._mesh

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

    # -- scoring ----------------------------------------------------------
    def score_form(self) -> Union[ScoreForm, RandomScores]:
        """What the full-catalog ranker scores (``ops/topk.py``): the final
        factors' dot products; biased and random scorers override it."""
        if self.U is None or self.V is None:
            raise RuntimeError(f"{self.model_name}: fit() before scoring")
        return ScoreForm(self.U, self.V)

    def _ids(self, users, items):
        uids = np.array([self.data.user.get(u, -1) for u in users], dtype=np.int64)
        iids = np.array([self.data.item.get(i, -1) for i in items], dtype=np.int64)
        return uids, iids

    def _mean_fallback(self, uids: np.ndarray, iids: np.ndarray, dot: np.ndarray) -> np.ndarray:
        """Reference fallback chain (iterativeRecommender.py:65-73): the
        prediction where both are known, else the user's mean, else the
        item's, else the global mean."""
        user_means = self.data.user_means[np.maximum(uids, 0)]
        item_means = self.data.item_means[np.maximum(iids, 0)]
        out = np.where(
            (uids >= 0) & (iids >= 0),
            dot,
            np.where(
                uids >= 0,
                user_means,
                np.where(iids >= 0, item_means, self.data.global_mean),
            ),
        )
        return out.astype(np.float64)

    def _at(self, ids: np.ndarray) -> torch.Tensor:
        """``ids`` as a device index, an unknown id (-1) read as row 0 (the
        fallback chain replaces what it gives)."""
        return torch.as_tensor(np.maximum(ids, 0), device=self.device)

    def _pair_dots(self, uids: np.ndarray, iids: np.ndarray) -> np.ndarray:
        """``U[u] · V[i]`` of each pair, in f32 on the device, as a float32
        numpy array."""
        with torch.no_grad():
            dot = (self.U[self._at(uids)] * self.V[self._at(iids)]).sum(dim=1)
        return dot.cpu().numpy()

    def predict_ratings(self, users, items) -> np.ndarray:
        """float64 predictions for the (user, item) name pairs."""
        uids, iids = self._ids(users, items)
        if self.U is not None and self.V is not None:
            dot = self._pair_dots(uids, iids)
        else:
            dot = np.zeros(len(uids))
        return self._mean_fallback(uids, iids, dot)

    # -- persistence (reference base/recommender.py:74-78; driven by
    # ``model.setup=-save/-load <path>``, runtime/session.py)
    def _extra_state(self) -> dict:
        """The arrays besides ``U``/``V`` that the model's ``score_form``
        and ``predict_ratings`` read, by their npz keys."""
        return {}

    def _set_extra_state(self, state: dict) -> None:
        pass

    def save_model(self, path: str) -> None:
        """``np.savez(path, U=..., V=..., **extras)`` (numpy appends
        ``.npz`` when ``path`` lacks it). On a mesh rank 0 alone writes the
        file, whose arrays every rank holds bit for bit, and every rank then
        waits for it (:func:`~qrec_tpu_torch.parallel.collectives.barrier`)."""
        if self.U is None or self.V is None:
            raise RuntimeError(f"{self.model_name}: nothing to save — fit() or load first")
        mesh = self.mesh
        if mesh is None or is_writer():
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            host = lambda t: t.detach().cpu().numpy()  # noqa: E731
            np.savez(path, U=host(self.U), V=host(self.V),
                     **{k: host(v) for k, v in self._extra_state().items()})
        if mesh is not None:
            barrier()

    def load_model(self, path: str) -> None:
        """The factors (and extras) of a saved model onto the device, in
        place of training; ``FileNotFoundError`` for a missing file. Every
        rank of a mesh reads the same file."""
        if not path.endswith(".npz"):
            path = path + ".npz"  # np.savez appends it on save
        with np.load(path) as z:
            arrays = {k: torch.from_numpy(z[k]).to(self.device) for k in z.files}
        if "U" not in arrays or "V" not in arrays:
            raise ValueError(f"{self.model_name}: {path} holds no U and V (it holds {sorted(arrays)})")
        u, v = arrays.pop("U"), arrays.pop("V")
        if u.shape[0] != self.num_users or v.shape[0] != self.num_items:
            raise ValueError(
                f"{self.model_name}: {path} holds {u.shape[0]} users and {v.shape[0]} items, "
                f"the training data {self.num_users} and {self.num_items}"
            )
        try:
            self._set_extra_state(arrays)
        except KeyError as e:
            raise ValueError(
                f"{self.model_name}: {path} holds no {e.args[0]!r} (it holds U, V and "
                f"{sorted(arrays)})"
            ) from None
        self.U, self.V = u, v


class SavedBiases:
    """Saves the final biases ``Bu``/``Bi`` beside the factors, under the
    JAX package's SVD keys ``user_bias``/``item_bias``
    (``qrec_tpu/models/mf.py:111-117``)."""

    def _extra_state(self) -> dict:
        return {"user_bias": self.Bu, "item_bias": self.Bi}

    def _set_extra_state(self, state: dict) -> None:
        self.Bu, self.Bi = state["user_bias"], state["item_bias"]


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
    def init_embeddings(self, kind: str = "normal", gen: Optional[torch.Generator] = None) -> dict:
        """``normal``: truncated normal σ=0.005 cut at ±2σ
        (deepRecommender.py:21-22); ``uniform``: U(0, 1)/3
        (iterativeRecommender.py:36-39). Drawn on the CPU from ``seed`` so a
        seed gives the same tables on every device (not the JAX package's
        draws: its PRNG is not reproduced); ``gen``, a CPU generator, draws
        them in its place, for a model that draws more tables after them."""
        gen = gen if gen is not None else torch.Generator().manual_seed(self.seed)
        out = {}
        for name, rows in (("user_emb", self.num_users), ("item_emb", self.num_items)):
            t = torch.empty((rows, self.emb_size), dtype=torch.float32)
            if kind == "normal":
                nn.init.trunc_normal_(t, std=0.005, a=-0.01, b=0.01, generator=gen)
            elif kind == "uniform":
                t = torch.rand(t.shape, generator=gen) / 3
            else:
                raise ValueError(f"unknown init {kind!r} (expected normal|uniform)")
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
                "r": torch.as_tensor(d.train_r, dtype=torch.float32, device=self.device),
                "indices": idx(d.u_indices),
                "indptr": idx(d.u_indptr),
            }
        return self._train_arrays

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

    def pairwise_sampler(self, shuffle: bool = True) -> Callable:
        """generator -> (users, pos, neg, weight) batched epoch tensors;
        ``shuffle=False`` keeps the training pairs in file order."""
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
                num_tries=num_tries, row_iters=row_iters, shuffle=shuffle,
            )

        return sampler

    def rating_sampler(self) -> Callable:
        """generator -> shuffled (users, items, ratings, weight) epoch
        tensors shaped (num_batches, batch_size) for the explicit-rating SGD
        models; ``weight`` zeroes the padded tail."""
        ta = self.train_arrays
        n, bs = self.train_size, self.batch_size
        num_batches = (n + bs - 1) // bs
        padded = num_batches * bs

        def sampler(gen: torch.Generator):
            perm = torch.randperm(n, generator=gen, device=self.device)
            pad = torch.cat([perm, perm.new_zeros(padded - n)])
            w = (torch.arange(padded, device=self.device) < n).float()
            shape = (num_batches, bs)
            return (ta["u"][pad].view(shape), ta["i"][pad].view(shape),
                    ta["r"][pad].view(shape), w.view(shape))

        return sampler

    def pointwise_sampler(self, num_negatives: int = 4) -> Callable:
        """generator -> (users, items, labels, weight) epoch tensors shaped
        ``(num_batches, batch_size * (1 + num_negatives))``: each shuffled
        positive, then ``num_negatives`` non-positive negatives
        (``ops/sampling.pointwise_epoch``)."""
        num_tries = self._auto_tries()
        ta = self.train_arrays
        row_iters = sampling._bisect_iters(
            int(np.max(np.diff(self.data.u_indptr))) if self.train_size else 1
        )
        bitmask = self.rated_bitmask

        def sampler(gen: torch.Generator):
            return sampling.pointwise_epoch(
                gen, ta["u"], ta["i"], ta["indices"], ta["indptr"], bitmask,
                num_items=self.num_items, batch_size=self.batch_size,
                num_negatives=num_negatives, num_tries=num_tries, row_iters=row_iters,
            )

        return sampler

    def _pairs(self, gen: torch.Generator, shuffle: bool = True):
        """(users, pos, weight) of one epoch's training pairs, shuffled or in
        file order, padded to whole batches (weight 0 on the pad): the
        epoch samplers of the social rankers and the walk family."""
        ta = self.train_arrays
        n = self.train_size
        padded = -(-n // self.batch_size) * self.batch_size
        perm = (torch.randperm(n, generator=gen, device=self.device) if shuffle
                else torch.arange(n, device=self.device))
        pad = torch.cat([perm, perm.new_zeros(padded - n)])
        w = (torch.arange(padded, device=self.device) < n).float()
        return ta["u"][pad], ta["i"][pad], w

    def _negatives(self, gen: torch.Generator, users: torch.Tensor, also_exclude=None):
        """One non-positive uniform item per user: 8 tries, then the exact
        draw (the JAX package's 8)."""
        ta = self.train_arrays
        row_iters = sampling._bisect_iters(int(np.max(np.diff(self.data.u_indptr))) if self.train_size else 1)
        return sampling.sample_negatives(gen, users, self.num_items, ta["indices"], ta["indptr"],
                                         self.rated_bitmask, 8, row_iters, also_exclude)

    def batch_share(self, batch):
        """This data rank's rows of a batch's tensors on a mesh
        (``torch.tensor_split``'s block), for the loss terms that are sums
        over the rows: its share of the step's loss (``parallel/mesh.py``);
        the whole batch without a mesh."""
        mesh = self.mesh
        if mesh is None:
            return batch
        return tuple(torch.tensor_split(t, mesh.data)[mesh.data_index] for t in batch)

    def row_share(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this data rank's ``torch.tensor_split`` block of
        n rows on a mesh, for a loss term that sums over rows other than a
        batch's (MHCN's users, SEPT's distinct users); (0, n) without a
        mesh."""
        mesh = self.mesh
        if mesh is None:
            return 0, n
        return split_range(n, mesh.data, mesh.data_index)

    @property
    def adds_table_terms(self) -> bool:
        """Whether this rank adds the loss terms over whole weight tables
        (the regularisers that are no sum over a batch's rows): every rank
        computes them whole, so on a mesh data rank 0 alone adds them, once,
        as one process does; every rank without a mesh."""
        mesh = self.mesh
        return mesh is None or mesh.data_index == 0

    def _batched(self, *tensors):
        shape = (-1, self.batch_size)
        return tuple(t.view(shape) for t in tensors)

    def dense_ratings(self) -> torch.Tensor:
        """The dense (U, I) f32 training rating matrix on the device (the
        row and column inputs of DMF, CDAE and CFGAN). Cached."""
        if not hasattr(self, "_dense_r"):
            self._dense_r = torch.from_numpy(self.data.dense_matrix()).to(self.device)
        return self._dense_r

    # -- lifecycle --------------------------------------------------------
    def prepare_graph(self) -> None:
        """Run the model's one-time host build (``build_graph``: motif, tie
        or friend-item matrices, edge similarities, ranks) once, with its
        seconds in ``graph_seconds``."""
        if not hasattr(self, "graph_seconds"):
            t0 = time.perf_counter()
            with recorder().span("graph.adjacency"):
                self.build_graph()
            self.graph_seconds = time.perf_counter() - t0

    def build_graph(self) -> None:
        pass

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
                self.data, k=n, device=self.device, bitmask=self.rated_bitmask,
                batch_size=self.eval_batch_size, mesh=self.mesh,
            )
        return self._ranker

    def quick_eval_vector(self, spec: TrainSpec) -> torch.Tensor:
        """Precision/Recall/F1/NDCG at the top N of the current parameters
        as a (4,) f32 device tensor in ``METRIC_KEYS`` order, ranked and
        measured on the device with no host read (the JAX package's
        ``quick_eval_vector``): the chunked eval loop runs it inside its
        epochs."""
        ranker = self._quick_ranker()
        self.finalize(spec)
        ids, _ = ranker.topk_device(self.score_form())
        dev = device_ranking_metrics(ids, ranker.test_ids, ranker.test_counts, [self._top_n],
                                     ranker.idcg)[self._top_n]
        return torch.stack([dev[k] for k in T.METRIC_KEYS])

    def quick_eval(self, spec: TrainSpec) -> dict:
        """:meth:`quick_eval_vector` read on the host: one copy of four
        numbers."""
        return dict(zip(T.METRIC_KEYS, self.quick_eval_vector(spec).tolist()))

    def _quick_rating_metrics(self, spec: TrainSpec) -> dict:
        """Per-epoch MAE/RMSE of a rating run (iterativeRecommender.py:91-94):
        the current parameters mapped onto the final factors (``finalize``,
        overwritten again when training ends) predict the test records,
        clipped to the rating scale."""
        if not hasattr(self, "_quick_rating_data"):
            test = self.data.test_data
            self._quick_rating_data = (
                [e[0] for e in test], [e[1] for e in test], np.asarray([float(e[2]) for e in test])
            )
        users, items, truth = self._quick_rating_data
        self.finalize(spec)
        preds = np.clip(self.predict_ratings(users, items), self.data.r_scale[0], self.data.r_scale[-1])
        err = preds - truth
        return {"MAE": float(np.mean(np.abs(err))), "RMSE": float(np.sqrt(np.mean(err**2)))}

    def _emit(self, epoch: int, loss: float, lr: float, wall: float,
              metrics: Optional[dict] = None, eval_fused: bool = False) -> None:
        """Epoch line (iterativeRecommender.py:88-94) with the learning rate
        in force during the epoch, and the per-epoch measures when there
        are any. A chunked run prints its epochs after the chunk, each with
        the chunk's wall / E; " incl. eval" marks a wall that holds the
        quick evaluation, which the chunk runs inside (the JAX package's
        ``_emit``)."""
        eps = self.train_size / wall if wall > 0 else 0.0
        extra = "" if metrics is None else " " + " ".join(f"{k}:{v:.5f}" for k, v in metrics.items())
        note = " incl. eval" if eval_fused else ""
        print(
            f"{self.model_name} {self.fold} epoch {epoch + 1}: "
            f"loss = {loss:.4f} learning_rate = {lr:.5f}{extra} "
            f"[{wall * 1e3:.1f} ms{note}, {eps:,.0f} ex/s]"
        )

    def fit(self, epoch_batches: Optional[Sequence] = None) -> List[float]:
        """Train every phase of the model and finalize it (``fit_phases``).
        ``epoch_batches`` injects one tuple of arrays per epoch in place of
        the sampler, numbered across the phases: a phase takes the entries
        after the epochs already run (``_epochs_done``). Returns the
        per-epoch losses of all phases, in order."""
        self.begin_fit(epoch_batches)
        try:
            with recorder().span("fit"):
                self.fit_phases()
        finally:
            recorder().end_fit()
        return self.epoch_losses

    def begin_fit(self, epoch_batches: Optional[Sequence] = None) -> None:
        """Reset the state that the phases of one fit share: the injected
        batches, the epochs run so far, the losses and the epoch timers;
        the recorder's spans from here to the fit's end belong to a new fit
        (``fit_id``)."""
        self.fit_id = recorder().begin_fit()
        self._epoch_batches = epoch_batches
        # cumulative over the phases of this fit (the JAX package's
        # ``_epochs_done``, models/base.py:525-535,597)
        self._epochs_done = 0
        self.epoch_losses: List[float] = []
        self.phase_losses: List[List[float]] = []
        self.phase_timers: List[StepTimer] = []
        self.timer = StepTimer(self.train_size, self.device)
        self.tracker = None
        # the checkpoint step a phase of this fit resumed from
        self.resumed_step = None

    def fit_phases(self) -> None:
        """One phase from ``build()`` (the JAX package's single-spec
        ``fit``): ``num.max.epoch`` epochs (fewer if the bold mode
        converges), then ``finalize``. ``evaluation.setup ... -tf`` trains a
        bold-mode spec with Adam, the reference's TF path
        (base/recommender.py:194-201). When the spec tracks the best epoch,
        a quick evaluation follows every epoch; a rating run with test
        records prints their MAE/RMSE every epoch."""
        with recorder().span("fit.spec"):
            spec = self.build()
        quick_eval = eval_vector = None
        if spec.track_best and self._quick_ranker() is not None:
            quick_eval = lambda: self.quick_eval(spec)  # noqa: E731
            eval_vector = lambda: self.quick_eval_vector(spec)  # noqa: E731
        elif not self.ranking.isMainOn() and len(self.data.test_data) > 0:
            quick_eval = lambda: self._quick_rating_metrics(spec)  # noqa: E731
        self.run_training(spec.params, spec.loss_fn, spec.sampler, mode=spec.mode,
                          track_best=spec.track_best, quick_eval=quick_eval,
                          chunkable=spec.chunkable, eval_vector=eval_vector)
        self.finalize(spec)

    def train_chunk(self) -> int:
        """``train.chunk``: epochs a dispatch, ``auto`` (the default) 8, 1
        the per-epoch loop (the JAX package's reading, values below 1 read
        as 1)."""
        raw = self.config.get("train.chunk", "auto").strip()
        if raw == "auto":
            return 8
        try:
            return max(1, int(raw))
        except ValueError:
            raise ConfigError(f"train.chunk must be auto or an integer, got {raw!r}") from None

    def _chunk_for(self, mode: str, chunkable: bool, chunk_eval: bool) -> int:
        """The chunk of one phase: ``train.chunk`` where the JAX package
        chunks (``qrec_tpu/models/base.py:767-785``): the ``adam`` mode,
        no per-epoch measure but the tracker's (whose vote then runs on
        the device), no checkpoint and no mesh; and only for a spec whose
        step reads no host (``chunkable``). Else 1, and a chunk above 1
        that the conf set is named, once a model, as run per epoch, with
        the reason."""
        chunk = self.train_chunk()
        why = None
        if mode != "adam":
            why = "the bold-driver mode reads every epoch's loss"
        elif not chunkable:
            why = "its step is not chunkable"
        elif not chunk_eval:
            why = "its per-epoch measures are read on the host"
        elif self._checkpointer() is not None:
            why = "checkpoint.setup saves every epoch's state"
        elif self.mesh is not None:
            why = "the run is on a mesh"
        if why is None:
            return chunk
        if chunk > 1 and self.config.get("train.chunk", "auto").strip() != "auto" \
                and not getattr(self, "_chunk_noted", False):
            self._chunk_noted = True
            print(f"{self.model_name} {self.fold} train.chunk={chunk} not applied, runs per "
                  f"epoch: {why}")
        return 1

    def run_training(
        self,
        params: Sequence[torch.Tensor],
        loss_fn: Callable,
        sampler: Callable,
        *,
        mode: str = "adam",
        track_best: bool = False,
        max_epoch: Optional[int] = None,
        quick_eval: Optional[Callable] = None,
        tracker: Optional[T.BestTracker] = None,
        return_best: bool = True,
        after_step: Optional[Callable] = None,
        chunkable: bool = False,
        eval_vector: Optional[Callable] = None,
    ) -> List[float]:
        """One training phase (the JAX package's ``run_training``,
        ``models/base.py:670-830``): ``max_epoch`` epochs (``num.max.epoch``
        by default) of ``loss_fn`` on ``sampler``'s batches, with a fresh
        optimizer and a fresh generator seeded ``seed + 1``, as every JAX
        phase starts from ``optimizer.init(params)`` and ``PRNGKey(seed +
        1)``. With ``track_best`` and a ``quick_eval``, the measures of every
        epoch go to ``tracker`` (a new one unless the caller shares one
        across phases, whose ``epoch_offset`` numbers the epochs), and the
        parameters of the epoch that won its vote are restored at the end
        unless ``return_best`` is off (a phase that hands its last
        parameters and its tracker to the next, SEPT's warm-up).
        ``after_step()`` runs after every optimizer step. Under
        ``checkpoint.setup`` the phase saves its loop state every ``-every``
        epochs under step ``_epochs_done + epoch + 1`` and first resumes
        from the latest step past ``_epochs_done``. A ``chunkable`` phase
        runs ``train.chunk`` epochs a dispatch where :meth:`_chunk_for`
        allows it (per epoch under ``epoch_graphs=False``), with
        ``eval_vector()`` (the quick evaluation as a (4,) device vector) in
        place of ``quick_eval`` when it tracks the best epoch; the model's
        buffers (BUIR's target) roll back with the parameters. Returns the
        losses of the epochs the phase ran."""
        max_epoch = max_epoch or self.max_epoch
        if mode == "bold" and self.eval_settings.contains("-tf"):
            mode = "adam"
        if track_best and quick_eval is not None and tracker is None:
            tracker = T.BestTracker()
        chunk_eval = quick_eval is None or (tracker is not None and eval_vector is not None)
        chunk = 1 if self.epoch_graphs is False else self._chunk_for(mode, chunkable, chunk_eval)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        done = self._epochs_done
        injected = None
        if self._epoch_batches is not None:
            injected = self._epoch_batches[done : done + max_epoch]
        start_epoch, resume = self._restore_checkpoint(max_epoch)
        losses, timer = T.train(
            params, loss_fn, sampler,
            max_epoch=max_epoch, lr=self.lrate, device=self.device,
            mode=mode, max_lr=self.max_lrate,
            generator=gen, examples_per_epoch=self.train_size,
            emit=self._emit, epoch_batches=injected,
            quick_eval=quick_eval, tracker=tracker, after_step=after_step,
            start_epoch=start_epoch, resume=resume, checkpoint=self._make_checkpoint_cb(),
            mesh=self.mesh, chunk=chunk, eval_vector=eval_vector,
            extra=list(self.buffers()),
        )
        self._epochs_done += start_epoch + len(losses)
        self.epoch_losses += losses
        self.phase_losses.append(losses)
        self.phase_timers.append(timer)
        self.timer.times += timer.times
        self.tracker = tracker
        if tracker is not None:
            tracker.epoch_offset += len(losses)
            if return_best and tracker.best_params is not None:
                print(
                    f"{self.model_name} {self.fold} best epoch {tracker.best_epoch}: "
                    + " | ".join(f"{k}:{v:.5f}" for k, v in tracker.best_metrics.items())
                )
                with torch.no_grad():
                    for p, best in zip(params, tracker.best_params):
                        p.copy_(best)
        return losses

    # -- checkpoint/resume ------------------------------------------------
    def _checkpointer(self) -> Optional[C.Checkpointer]:
        """``checkpoint.setup``'s checkpointer, made once per model; a
        cross-validation fold after the first keeps its steps in a
        subdirectory of its own (``fold_<k>``)."""
        if not hasattr(self, "_ckpt"):
            self._ckpt = C.from_config(self.config)
            self._ckpt_every = C.checkpoint_every(self.config)
            if self._ckpt is not None and self.fold != "[1]":
                self._ckpt = C.Checkpointer(
                    os.path.join(self._ckpt.directory, "fold_" + self.fold.strip("[]")),
                    self._ckpt.max_to_keep)
        return self._ckpt

    def _latest_step(self, ckpt: C.Checkpointer) -> Optional[int]:
        """The checkpointer's latest step; on a mesh rank 0's, broadcast, so
        that every rank restores the step that the writer saw."""
        latest = ckpt.latest_step()
        if self.mesh is None:
            return latest
        step = broadcast_int(-1 if latest is None else latest)
        return None if step < 0 else step

    def _restore_checkpoint(self, max_epoch: int):
        """(start epoch, loop state or None) of a phase of ``max_epoch``
        epochs: with a checkpoint past the epochs already run, the phase
        starts at ``min(latest - _epochs_done, max_epoch)``, from the
        checkpoint's state when it falls inside the phase; a checkpoint of a
        later phase skips this one whole (the later phase restores). On a
        mesh every rank restores the one file that rank 0 wrote: the loop
        state is the same on every rank."""
        ckpt = self._checkpointer()
        latest = self._latest_step(ckpt) if ckpt is not None else None
        if latest is None or latest <= self._epochs_done:
            return 0, None
        start_epoch = min(latest - self._epochs_done, max_epoch)
        if latest - self._epochs_done > max_epoch:
            return start_epoch, None
        state = ckpt.restore(latest)
        with torch.no_grad():
            for name, buf in self.named_buffers():
                buf.copy_(state["buffers"][name])
        self.resumed_step = latest
        print(f"{self.model_name} {self.fold} resumed from checkpoint step {latest} "
              f"(epoch {start_epoch}/{max_epoch})")
        return start_epoch, state

    def _make_checkpoint_cb(self) -> Optional[Callable]:
        """The loop's callback: every ``-every`` epochs the loop state and
        the model's buffers (BUIR's target) under step ``_epochs_done +
        epoch + 1``. On a mesh rank 0 alone writes the step (and prunes the
        old ones), and every rank waits for it."""
        ckpt = self._checkpointer()
        if ckpt is None or self._ckpt_every <= 0:
            return None
        done, every = self._epochs_done, self._ckpt_every
        mesh = self.mesh

        def save(epoch: int, state: dict) -> None:
            if (epoch + 1) % every == 0:
                if mesh is None or is_writer():
                    ckpt.save(done + epoch + 1, dict(state, buffers=dict(self.named_buffers())))
                if mesh is not None:
                    barrier()

        return save


GRAPH_BACKENDS = ("auto", "dense", "coo", "pallas")
DENSE_QUANTS = ("auto", "off", "int8", "factored")


def check_graph_settings(conf: ModelConf) -> None:
    """Raise ConfigError for an unknown adjacency setting, with the JAX
    package's messages (``qrec_tpu/models/base.py:928-935,976-983,1023-1029``)."""
    backend = conf.get("graph.backend", "auto")
    if backend not in GRAPH_BACKENDS:
        raise ConfigError(f"unknown graph.backend {backend!r} (expected auto|dense|coo|pallas)")
    quant = conf.get("graph.dense.quant", "auto")
    if quant not in DENSE_QUANTS:
        raise ConfigError(f"graph.dense.quant must be auto|off|int8|factored, got {quant!r}")
    dual = conf.get("graph.dense.dual", "auto")
    if dual not in ("auto", "on", "off"):
        raise ConfigError(f"graph.dense.dual must be auto|on|off, got {dual!r}")


_DENSE_BUILT = {
    "factored": "DenseJoint factored int8, dual kernel",
    "off": "DenseJoint bf16, dual kernel",
    "int8": "DenseJoint int8 per-row scale, dual kernel",
}


class GraphRecommender(IterativeRecommender):
    """Adds the joint adjacency on the device (base/graphRecommender.py:10-39;
    the JAX package's ``GraphRecommender.joint_adj``, ``models/base.py:866-1034``).

    ``graph.backend=dense``, or ``auto`` while ``num_users x num_items``
    fits ``graph.dense.limit``, builds the dense form that
    ``graph.dense.quant`` names: ``factored`` (and ``auto``, on every
    device), ``off`` (the bf16 Ŝ) or ``int8`` (the legacy per-row scale).
    Every one runs through the dual kernel whatever ``graph.dense.dual``
    says: the JAX package's two bf16 products and its dual kernel compute
    the same function up to summation order. ``graph.backend=pallas``, or
    ``auto`` past the limit, builds the sparse one on the segment kernel
    (the JAX package's single-device choice on a TPU); ``coo`` builds the
    f32 :class:`~qrec_tpu_torch.ops.spmm.DeviceCOO` (the JAX package's
    ``auto`` off a TPU).

    On a mesh (``parallel.setup``): a dense form is its item-column blocks
    over ``data`` on K1 (:class:`~qrec_tpu_torch.ops.spmm.ShardedDenseJoint`;
    the JAX package takes XLA's partitioned products there, not a kernel);
    the sparse form is its row blocks
    (:class:`~qrec_tpu_torch.ops.spmm.ShardedSparseJoint`); ``coo`` keeps
    the whole ``DeviceCOO`` on every rank, whose f32 backward is linear in
    the cotangent, so the ranks' shares keep the gradient invariant with no
    collective."""

    @property
    def joint_adj(self):
        if not hasattr(self, "_joint_adj"):
            with recorder().span("graph.adjacency"):
                self._build_joint_adj()
        return self._joint_adj

    def _build_joint_adj(self) -> None:
        from ..data.graph import joint_normalized_adjacency
        from ..ops.spmm import (
            DENSE_JOINT_LIMIT,
            DenseJoint,
            DeviceCOO,
            ShardedDenseJoint,
            ShardedSparseJoint,
            SparseJoint,
        )

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
        mesh = self.mesh
        if dense:
            quant = self.config.get("graph.dense.quant", "auto")
            quant = "factored" if quant == "auto" else quant
            self._joint_adj = DenseJoint.from_interactions(self.data, self.device, quant)
            built = _DENSE_BUILT[quant]
            if mesh is not None:
                self._joint_adj = ShardedDenseJoint.from_joint(self._joint_adj, mesh)
                built = f"ShardedDenseJoint item-column blocks over data, {built}"
        elif backend == "coo":
            self._joint_adj = DeviceCOO.from_host(
                joint_normalized_adjacency(self.data), self.device
            )
            built = "DeviceCOO f32 gather and segment sum"
        elif mesh is not None:
            self._joint_adj = ShardedSparseJoint.from_host(
                joint_normalized_adjacency(self.data), self.device, mesh
            )
            built = "ShardedSparseJoint CSR row blocks over data, segment kernel"
        else:
            self._joint_adj = SparseJoint.from_host(
                joint_normalized_adjacency(self.data), self.device, check_symmetric=False
            )
            built = "SparseJoint CSR, segment kernel"
        print(f"Graph backend: {built} (graph.backend={backend})")


class SocialRecommender(IterativeRecommender):
    """Adds the cleaned trust graph (``self.social``, a
    :class:`~qrec_tpu_torch.data.social.SocialGraph`) and ``-s``
    regularization (base/socialRecommender.py:43-46)."""

    requires_social = True

    def read_configuration(self) -> None:
        super().read_configuration()
        self.reg_s = self.config.options("reg.lambda").get_float("-s", 0.0)

    @property
    def social_arrays(self) -> dict:
        """The trust edges on the device: ``src``, ``dst`` int64, ``w`` f32."""
        if not hasattr(self, "_social_arrays"):
            src, dst, w = self.social.coo()
            self._social_arrays = {
                "src": torch.as_tensor(src, dtype=torch.int64, device=self.device),
                "dst": torch.as_tensor(dst, dtype=torch.int64, device=self.device),
                "w": torch.as_tensor(w, device=self.device),
            }
        return self._social_arrays
