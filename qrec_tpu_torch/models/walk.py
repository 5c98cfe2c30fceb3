"""The network-embedding (walk) family: CUNE_MF and CUNE_BPR (reference
model/rating/CUNE_MF.py, model/ranking/CUNE_BPR.py; the JAX package's
``models/walk.py``).

Pipeline, once before the first epoch (``build_graph``): the co-rating
user network, weighted random walks and their (center, context) pairs on
the host (``ops/walks``), SGNS user embeddings on the device, and each
active user's top-K cosine neighbours as implicit friends. Then:

* CUNE_MF: PMF with a one-sided pull of each user toward its implicit
  friends, over the full friend edge set every step, scaled by
  ``1/num_batches``, the friends' side a constant (CUNE_MF.py:283-307);
* CUNE_BPR: a two-tier BPR over the items of the implicit friends that the
  user did not rate, three draws per positive: ``i ≻ k`` with a unit
  margin, ``k ≻ j`` scaled by ``1/s``, plain BPR ``i ≻ j`` for a user
  without friend items (CUNE_BPR.py:292-341); it ranks through K2's fused
  top-k.

Both train on bold-driver SGD (Adam under ``-tf``, which chunks where the
ranking is on). Options come from the reference's dashed
keys (``CUNE-MF``, ``CUNE-BPR``). The SGNS draws come from
``skipgram_draws`` (``ops/walks.SkipgramDraws``), which a caller can
replace. Parameters: ``user_emb`` (U, d) and ``item_emb`` (I, d), U(0, 1)/3.

On a mesh each data rank's loss is its rows of the batch (``batch_share``,
every draw of CUNE_BPR cut alike) and, for CUNE_MF's pull, its block of
the friend edges (``row_share``), scaled by the whole run's
``1/num_batches``; the walks, SGNS and the friends are whole on every
rank, from the same seed.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..config import OptionConf
from ..ops import sampling
from ..ops.losses import bpr_loss
from ..ops.walks import (
    SkipgramDraws,
    cooccurrence_network,
    random_walks,
    skipgram_stats,
    topk_cosine_neighbors,
    train_skipgram,
    walk_pairs,
)
from ..runtime.profiling import StepTimer
from .base import IterativeRecommender, TrainSpec
from .social_ranking import _csr_tables


class _WalkBase(IterativeRecommender):
    """The walk → embedding → top-K friends pipeline, the tables and the
    bold-mode spec."""

    param_key = None  # the reference's dashed conf key, e.g. 'CUNE-BPR'
    skipgram_draws = SkipgramDraws  # the SGNS run's random inputs (replaceable)

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        for name, t in self.init_embeddings("uniform").items():
            setattr(self, name, nn.Parameter(t))

    def read_configuration(self) -> None:
        super().read_configuration()
        options = OptionConf(self.config[self.param_key])
        self.walk_count = options.get_int("-T")
        self.walk_length = options.get_int("-L")
        self.walk_dim = options.get_int("-l")
        self.win_size = options.get_int("-w")
        self.top_k = options.get_int("-k")
        self._options = options

    def implicit_friends(self) -> Tuple[np.ndarray, np.ndarray]:
        """(friend ids (A, k), active users (A,)) numpy arrays: each active
        user's top-K implicit friends. ``walk_stats`` keeps the host walk
        seconds, the walkers and pairs, the SGNS run's numbers
        (``ops/walks.skipgram_stats``: steps, seconds, capture seconds,
        steps a replayed graph) and the friend top-k's ms."""
        print("Building collaborative user network...")
        t0 = time.perf_counter()
        net = cooccurrence_network(self.data)
        print("Generating random deep walks...")
        rng = np.random.RandomState(self.seed)
        walks, active = random_walks(net, self.walk_count, self.walk_length, rng)
        centers, contexts = walk_pairs(walks, self.win_size)
        walk_s = time.perf_counter() - t0
        print("Generating user embedding...")
        sgns = StepTimer(len(centers), self.device)
        emb = train_skipgram(centers, contexts, self.num_users, self.walk_dim, active,
                             seed=self.seed, device=self.device, draws=self.skipgram_draws,
                             timer=sgns)
        print("Constructing similarity matrix...")
        k = min(self.top_k, max(len(active) - 1, 1))
        topk = StepTimer(0, self.device)
        with topk:
            ids, _ = topk_cosine_neighbors(emb, active, k)
        self.walk_stats = {
            "walk_s": walk_s, "walkers": len(walks), "pairs": len(centers),
            "sgns": [skipgram_stats(len(centers), sgns, self.device)],
            "topk_ms": topk.last * 1e3,
        }
        return ids.cpu().numpy(), active

    def friend_item_table(self, friend_ids: np.ndarray, active: np.ndarray) -> sp.csr_matrix:
        """(U, I) 0/1 CSR of the items of each user's implicit friends that
        the user did not rate (CUNE_BPR.py:284-296); ``friend_ids[r]`` are
        the friends of user ``active[r]``."""
        data = self.data
        rows = np.repeat(active, friend_ids.shape[1])
        r = sp.csr_matrix((np.ones_like(data.train_u, dtype=np.float32), (data.train_u, data.train_i)),
                          shape=(self.num_users, self.num_items))
        r.data[:] = 1.0
        f = sp.csr_matrix((np.ones(len(rows), dtype=np.float32), (rows, friend_ids.ravel())),
                          shape=(self.num_users, self.num_users))
        f.data[:] = 1.0
        fp = f @ r
        fp = fp - fp.multiply(r)
        fp.eliminate_zeros()
        fp = fp.tocsr()
        fp.data[:] = 1.0
        return fp

    def factors(self):
        return self.user_emb.detach(), self.item_emb.detach()

    def build(self) -> TrainSpec:
        """The host build and the bold-mode spec, which may chunk under
        ``-tf``; the training pairs and the rated bitmask that ``sampler``
        reads are put on the device here, before a chunked run's capture."""
        self.prepare_graph()
        self.train_arrays, self.rated_bitmask
        return TrainSpec(list(self.parameters()), self.loss, self.sampler,
                         score_params_fn=self.factors, mode="bold", chunkable=True)


class CUNE_MF(_WalkBase):
    """PMF plus the pull toward the top-K implicit friends
    (CUNE_MF.py:283-307)."""

    param_key = "CUNE-MF"

    def read_configuration(self) -> None:
        super().read_configuration()
        self.alpha = self._options.get_float("-a")

    def build_graph(self) -> None:
        friend_ids, active = self.implicit_friends()
        as_long = lambda a: torch.tensor(np.asarray(a), dtype=torch.int64, device=self.device)  # noqa: E731
        self.pull_src = as_long(np.repeat(active, friend_ids.shape[1]))
        self.pull_dst = as_long(friend_ids.ravel())

    def sampler(self, gen: torch.Generator):
        return self.rating_sampler()(gen)

    def loss(self, batch, gen=None) -> torch.Tensor:
        u, i, r, w = self.batch_share(batch)
        pu, qi = self.user_emb[u], self.item_emb[i]
        err = r - (pu * qi).sum(dim=1)
        rating = 0.5 * (w * err**2).sum() + 0.5 * (
            self.reg_u * (w[:, None] * pu**2).sum() + self.reg_i * (w[:, None] * qi**2).sum())
        num_batches = max(1, -(-self.train_size // self.batch_size))
        edges = slice(*self.row_share(self.pull_src.shape[0]))
        diff = self.user_emb[self.pull_src[edges]] - self.user_emb[self.pull_dst[edges]].detach()
        return rating + (1.0 / num_batches) * 0.5 * self.alpha * (diff**2).sum()


class CUNE_BPR(_WalkBase):
    """Two-tier BPR over the implicit friends' items, three draws per
    positive, L2 on the batch's rows with ``p`` counted once per draw
    (CUNE_BPR.py:292-341)."""

    param_key = "CUNE-BPR"
    n_draws = 3  # the reference samples 3 times per positive

    def read_configuration(self) -> None:
        super().read_configuration()
        self.s = self._options.get_float("-s")

    def build_graph(self) -> None:
        friend_ids, active = self.implicit_friends()
        fp = self.friend_item_table(friend_ids, active)
        self.fp_indptr, self.fp_indices, _ = _csr_tables(fp, self.device)

    def sampler(self, gen: torch.Generator):
        """(users, pos, the 3 friend items, the 3 negatives, has friend
        items, weight) epoch tensors shaped (num_batches, batch_size)."""
        users, pos, w = self._pairs(gen)
        ks = [sampling.sample_from_rows(gen, self.fp_indptr, self.fp_indices, users)[0]
              for _ in range(self.n_draws)]
        js = [self._negatives(gen, users) for _ in range(self.n_draws)]
        has_fp = self.fp_indptr[users + 1] > self.fp_indptr[users]
        return self._batched(users, pos, *ks, *js, has_fp, w)

    def loss(self, batch, gen=None) -> torch.Tensor:
        n = self.n_draws
        batch = self.batch_share(batch)
        u, i = batch[0], batch[1]
        ks, js = batch[2:2 + n], batch[2 + n:2 + 2 * n]
        has_fp, w = batch[-2].float(), batch[-1]
        p, q = self.user_emb[u], self.item_emb
        y_i = (p * q[i]).sum(dim=1)
        has = has_fp * w
        plain = (1.0 - has_fp) * w
        loss = 0.0
        reg_items = q[i] ** 2
        for k_ids, j_ids in zip(ks, js):
            y_k = (p * q[k_ids]).sum(dim=1)
            y_j = (p * q[j_ids]).sum(dim=1)
            loss = loss + bpr_loss(y_i, y_k, has)
            loss = loss + bpr_loss((y_k - y_j) / self.s, torch.zeros_like(y_k), has)
            loss = loss + bpr_loss(y_i, y_j, plain)
            reg_items = reg_items + q[k_ids] ** 2 + q[j_ids] ** 2
        reg = 0.5 * (self.reg_u * (w[:, None] * p**2).sum() * n
                     + self.reg_i * (w[:, None] * reg_items).sum())
        return loss + reg
