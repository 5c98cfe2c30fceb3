"""Batched full-catalog top-k ranking (counterpart of the JAX package's
``ops/topk.py``), on the fused masked top-k kernel: no (batch, I) score
block and no sort reach device memory.

Semantics kept from the reference (base/recommender.py:143-160,
base/iterativeRecommender.py:75-80):

* train-rated items score 0, not -inf;
* users unseen in training (uid -1) score ``global_mean`` everywhere;
* ties go to the lowest item index first, like ``lax.top_k``: the ranking
  is a stable descending sort, so equal scores keep index order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .kernels import masked_catalog_topk

# rated items score 0, as the reference zeroes them (base/recommender.py:147-149)
MASK_VALUE = 0.0


class CatalogRanker:
    """Top-k over the whole catalog for a fixed test-user set, in user
    batches of ``batch_size`` (one kernel launch per batch)."""

    def __init__(self, data, k: int, device, batch_size: int = 1024):
        self.data = data
        self.k = int(k)
        self.device = torch.device(device)
        self.batch_size = int(batch_size)
        ev = data.test_eval_arrays()
        self.names = ev["names"]
        self.uids = ev["uids"]
        # test items (-1 = pad/unseen) and counts for device_ranking_metrics
        self.test_ids = torch.as_tensor(ev["test_ids"], dtype=torch.int64, device=self.device)
        self.test_counts = torch.as_tensor(ev["test_counts"], dtype=torch.int64, device=self.device)
        self._uids = torch.as_tensor(self.uids, dtype=torch.int64, device=self.device)
        # float32 like the JAX ranker's global-mean constant
        self.global_mean = float(np.float32(data.global_mean))

    def topk(
        self, user_emb: torch.Tensor, item_emb: torch.Tensor, bitmask: torch.Tensor
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids int32, scores f32) numpy arrays of shape (num_test_users, k)."""
        ids, scores = self.topk_device(user_emb, item_emb, bitmask)
        return ids.cpu().numpy().astype(np.int32), scores.cpu().numpy()

    def topk_device(
        self, user_emb: torch.Tensor, item_emb: torch.Tensor, bitmask: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids int64, scores f32) tensors of shape (num_test_users, k) on
        ``self.device``, with no host copy.

        ``user_emb`` (U, d), ``item_emb`` (I, d) f32 and ``bitmask``
        (U, ceil(I/32)) int32 on ``self.device``."""
        b = len(self.names)
        k = min(self.k, item_emb.shape[0])
        user_emb, item_emb = user_emb.contiguous(), item_emb.contiguous()
        ids_out, scores_out = [], []
        for start in range(0, b, self.batch_size):
            ids, scores = masked_catalog_topk(
                user_emb, item_emb, bitmask, self._uids[start : start + self.batch_size],
                self.global_mean, k, MASK_VALUE,
            )
            ids_out.append(ids)
            scores_out.append(scores)
        if not ids_out:
            return (torch.empty((0, k), dtype=torch.int64, device=self.device),
                    torch.empty((0, k), dtype=torch.float32, device=self.device))
        return torch.cat(ids_out), torch.cat(scores_out)
