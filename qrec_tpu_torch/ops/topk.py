"""Batched full-catalog top-k ranking (counterpart of the JAX package's
``ops/topk.py``), on the fused masked top-k kernel: no (batch, I) score
block and no sort reach device memory.

A model hands the ranker its score form instead of the JAX package's
``(score_fn, params)``:

* :class:`ScoreForm` — ``user_emb @ item_embᵀ``, optionally biased as
  ``((dot + offset) + item_bias[i]) + user_bias[u]``: embedding models (no
  bias), SVD (``offset`` = the global mean and both biases) and MostPopular
  (width-1 zero tables and its popularity as ``item_bias``), all ranked by
  K2's fused top-k;
* :class:`ScoreBlock` — a model's own scorer ``fn(uids) -> (B, I)``, for
  the scorers that are not a dot product (NeuMF's towers, DMF's cosine,
  CDAE's decoder, CFGAN's generator): the JAX package ranks them through
  XLA (its general ``score_fn`` path, ``qrec_tpu/ops/topk.py:32-80``), and
  so does the port, with torch ops and a stable sort;
* :class:`RandomScores` — Rand's uniform scores, drawn per batch from a
  ``torch.Generator`` (the JAX package draws them with ``jax.random`` and
  takes ``lax.top_k``, both XLA: here ``torch.rand`` and a stable sort).

Semantics kept from the reference (base/recommender.py:143-160,
base/iterativeRecommender.py:75-80):

* train-rated items score 0, not -inf;
* users unseen in training (uid -1) score ``global_mean`` everywhere;
* ties go to the lowest item index first, like ``lax.top_k``: the ranking
  is a stable descending sort, so equal scores keep index order.

On a mesh (``parallel/mesh.py``) a score form is ranked as the JAX
package's ``pallas_catalog_topk(mesh=)`` ranks it
(``qrec_tpu/ops/topk.py:263-364``): the test users are cut over all ranks
and each rank runs K2 on its own; no merge is needed, since users
partition the output exactly. The port then gathers the lists, so every
rank holds the whole ranking (the JAX package's sharded result).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.collectives import gather_shards, split_range, split_sizes
from ..runtime.profiling import recorder, spanned
from .kernels import expand_bitmask, masked_catalog_topk
from .metrics import idcg_table

# rated items score 0, as the reference zeroes them (base/recommender.py:147-149)
MASK_VALUE = 0.0


class ScoreForm(NamedTuple):
    """Scores ``((user_emb[u] · item_emb[i] + offset) + item_bias[i]) +
    user_bias[u]``; ``user_emb`` (U, d), ``item_emb`` (I, d), the biases
    (I,) and (U,) f32, each optional (without either and with offset 0, the
    plain dot products)."""

    user_emb: torch.Tensor
    item_emb: torch.Tensor
    item_bias: Optional[torch.Tensor] = None
    user_bias: Optional[torch.Tensor] = None
    offset: float = 0.0


class ScoreBlock(NamedTuple):
    """Scores ``fn(uids)``: the (B, I) f32 block of the users ``uids`` (B,)
    int64 (all >= 0), computed on the ranker's device."""

    fn: Callable[[torch.Tensor], torch.Tensor]


class RandomScores(NamedTuple):
    """U(0, 1) scores for every (user, item), drawn from ``generator`` on the
    ranker's device, one (batch, I) block per batch."""

    generator: torch.Generator


class CatalogRanker:
    """Top-k over the whole catalog for a fixed test-user set, in user
    batches of ``batch_size`` (one kernel launch per batch). ``bitmask``
    (U, ceil(I/32)) int32 on ``device`` holds the train-rated items.

    With a ``mesh`` the test users of a :class:`ScoreForm` are cut over all
    W ranks of the default group in world-rank order, as
    ``torch.tensor_split`` cuts them (the JAX package shards its user
    blocks over every device): each rank runs K2 on its share only, in
    batches of ``batch_size`` (``ceil(n_loc / batch_size)`` launches), and
    the (n_loc, k) ids and scores are gathered over the default group in
    rank order, exactly, so every rank returns one process's lists. Score
    blocks and random scores (CFGAN's generator, Rand's draws) stay whole
    on every rank, each rank drawing the same numbers."""

    def __init__(self, data, k: int, device, bitmask: torch.Tensor, batch_size: int = 1024,
                 mesh=None):
        self.data = data
        self.k = int(k)
        self.device = torch.device(device)
        self.bitmask = bitmask
        self.batch_size = int(batch_size)
        ev = data.test_eval_arrays()
        self.names = ev["names"]
        self.uids = ev["uids"]
        # test items (-1 = pad/unseen) and counts for device_ranking_metrics
        self.test_ids = torch.as_tensor(ev["test_ids"], dtype=torch.int64, device=self.device)
        self.test_counts = torch.as_tensor(ev["test_counts"], dtype=torch.int64, device=self.device)
        self._uids = torch.as_tensor(self.uids, dtype=torch.int64, device=self.device)
        # device_ranking_metrics' IDCG table for lists of this ranker's length
        self.idcg = torch.from_numpy(idcg_table(min(self.k, data.num_items))).to(self.device)
        # this rank's test users and every rank's count, on a mesh
        self.mesh = mesh
        if mesh is not None:
            world, rank = dist.get_world_size(), dist.get_rank()
            self.user_sizes = split_sizes(len(self.uids), world)
            s0, s1 = split_range(len(self.uids), world, rank)
            self._local_uids = self._uids[s0:s1]
        # float32 like the JAX ranker's global-mean constant
        self.global_mean = float(np.float32(data.global_mean))

    @spanned("ranker.topk")
    def topk(self, form: Union[ScoreForm, ScoreBlock, RandomScores]) -> Tuple[np.ndarray, np.ndarray]:
        """(ids int32, scores f32) numpy arrays of shape (num_test_users, k)."""
        ids, scores = self.topk_device(form)
        with recorder().span("ranker.host_copy"):
            return ids.cpu().numpy().astype(np.int32), scores.cpu().numpy()

    @spanned("ranker.enqueue")
    def topk_device(self, form: Union[ScoreForm, ScoreBlock, RandomScores]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids int64, scores f32) tensors of shape (num_test_users, k) on
        ``self.device``, with no host copy; the form's tensors lie there."""
        num_items = self.data.num_items
        k = min(self.k, num_items)
        empty = (torch.empty((0, k), dtype=torch.int64, device=self.device),
                 torch.empty((0, k), dtype=torch.float32, device=self.device))
        if not len(self.uids):
            return empty
        if isinstance(form, RandomScores):
            return self._cat([
                self._block_topk(torch.rand((uids.shape[0], num_items), generator=form.generator,
                                            device=self.device), uids, k)
                for uids in self._batches(self._uids)])
        if isinstance(form, ScoreBlock):
            with torch.no_grad():
                return self._cat([self._block_topk(form.fn(uids.clamp(min=0)), uids, k)
                                  for uids in self._batches(self._uids)])
        user_emb, item_emb = form.user_emb.contiguous(), form.item_emb.contiguous()
        local = self._uids if self.mesh is None else self._local_uids
        out = [
            masked_catalog_topk(
                user_emb, item_emb, self.bitmask, uids, self.global_mean, k, MASK_VALUE,
                item_bias=form.item_bias, user_bias=form.user_bias, offset=form.offset,
            )
            for uids in self._batches(local)
        ]
        ids, scores = self._cat(out) if out else empty
        if self.mesh is None:
            return ids, scores
        return gather_shards(ids, self.user_sizes), gather_shards(scores, self.user_sizes)

    def _batches(self, uids: torch.Tensor):
        return [uids[s: s + self.batch_size] for s in range(0, uids.shape[0], self.batch_size)]

    @staticmethod
    def _cat(out):
        return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])

    def _block_topk(self, scores: torch.Tensor, uids: torch.Tensor, k: int):
        """Top-k of a (B, I) score block (Rand's uniform scores, Rand.py:10-15,
        or a :class:`ScoreBlock`): rated items at ``MASK_VALUE``, unseen users
        at the global mean, a stable descending sort (ties to the lower
        item, as ``lax.top_k``)."""
        rated = expand_bitmask(self.bitmask[uids.clamp(min=0)], scores.shape[1])
        scores = scores.masked_fill(rated, MASK_VALUE)
        scores = torch.where((uids < 0)[:, None], torch.full_like(scores, self.global_mean), scores)
        vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
        return ids[:, :k].clone(), vals[:, :k].clone()
