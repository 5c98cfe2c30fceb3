"""Batched full-catalog top-k ranking (counterpart of the JAX package's
``ops/topk.py``), on the masked-scorer kernel.

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

from .kernels import masked_catalog_scores

# rated items score 0, as the reference zeroes them (base/recommender.py:147-149)
MASK_VALUE = 0.0


class CatalogRanker:
    """Top-k over the whole catalog for a fixed test-user set, in user
    batches of ``batch_size`` (one scorer launch per batch)."""

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
        item_emb = item_emb.contiguous()
        ids_out, scores_out = [], []
        for start in range(0, b, self.batch_size):
            uids = self._uids[start : start + self.batch_size]
            safe = torch.clamp(uids, min=0)
            scores = masked_catalog_scores(
                user_emb[safe].contiguous(),
                item_emb,
                bitmask[safe].contiguous(),
                MASK_VALUE,
            )
            # unseen users score the global mean everywhere (no masking)
            scores = torch.where(
                (uids < 0)[:, None],
                torch.full_like(scores, self.global_mean),
                scores,
            )
            top_scores, top_ids = torch.sort(scores, dim=1, descending=True, stable=True)
            # copies, so the (batch, I) sort outputs are freed
            ids_out.append(top_ids[:, :k].clone())
            scores_out.append(top_scores[:, :k].clone())
        if not ids_out:
            return (torch.empty((0, k), dtype=torch.int64, device=self.device),
                    torch.empty((0, k), dtype=torch.float32, device=self.device))
        return torch.cat(ids_out), torch.cat(scores_out)
