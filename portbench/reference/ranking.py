"""The full-catalogue ranking and QRec's ranking measures, plain.

Scores are ``U[u] . V[i]``; an item the user rated in training scores 0.0
(QRec ``base/recommender.py:147-149``); a test user unseen in training gets
items 0..k-1. The list is the stable descending order's first k. The
measures are QRec's (``util/measure.py``): precision the hits over
users x N, recall the mean of hits / |test items|, F1 of the two, NDCG with
binary gains, the discount 1 / ln(position + 2) and the ideal DCG over
min(|test items|, N) positions.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch

from . import Precision
from .dataset import Dataset

BLOCK_USERS = 2048


@contextlib.contextmanager
def f32_products():
    """Float32 products: TF32 off for matrix products and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class Ranking:
    """A :class:`Dataset`'s test users and rated sets on ``device``."""

    def __init__(self, data: Dataset, device):
        self.device = torch.device(device)
        self.num_items = data.num_items
        self.uids = torch.as_tensor(data.test_uids, device=device)
        self.test_ids = torch.as_tensor(data.test_ids, device=device)
        self.test_counts = torch.as_tensor(data.test_counts, device=device)
        self.positives = torch.as_tensor(data.positives(), device=device)


def scores_of(ranking: Ranking, users: torch.Tensor, items: torch.Tensor, uids: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """(B, I) masked scores of the test users ``uids`` (all >= 0)."""
    with f32_products():
        s = users[uids].to(prec.dtype) @ items.to(prec.dtype).T
    rated = ranking.positives[uids]
    wide = torch.cat([s, s.new_zeros((s.shape[0], 1))], dim=1)
    wide.scatter_(1, rated, 0.0)
    return wide[:, : ranking.num_items]


def rank(ranking: Ranking, users: torch.Tensor, items: torch.Tensor, k: int,
         prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (B, k), scores (B, k)) of every test user, in test order."""
    ids, vals = [], []
    for s0 in range(0, ranking.uids.shape[0], BLOCK_USERS):
        uids = ranking.uids[s0: s0 + BLOCK_USERS]
        s = scores_of(ranking, users, items, uids.clamp(min=0), prec)
        top_v, top_i = torch.sort(s, dim=1, descending=True, stable=True)
        top_i, top_v = top_i[:, :k], top_v[:, :k].float()
        unseen = (uids < 0)[:, None]
        top_i = torch.where(unseen, torch.arange(k, device=s.device)[None, :], top_i)
        ids.append(top_i)
        vals.append(top_v)
    return torch.cat(ids), torch.cat(vals)


def measures(ranking: Ranking, ids: torch.Tensor, n: int) -> Dict[str, float]:
    """QRec's Precision, Recall, F1 and NDCG at ``n`` of the lists ``ids``."""
    test = ranking.test_ids
    hit = ((ids[:, :n, None] == test[:, None, :]) & (test[:, None, :] >= 0)).any(dim=2)
    hits = hit.sum(dim=1).double()
    counts = ranking.test_counts.double()
    b = ids.shape[0]
    prec = float(hits.sum()) / (b * n)
    rec = float((hits / counts.clamp(min=1)).mean())
    f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
    disc = 1.0 / np.log(np.arange(n) + 2.0)
    dcg = (hit.double() * torch.as_tensor(disc, device=ids.device)[None, :]).sum(dim=1)
    ideal = torch.as_tensor(np.concatenate([[0.0], np.cumsum(disc)]), device=ids.device)
    idcg = ideal[counts.long().clamp(max=n)]
    ndcg = float((dcg / idcg.clamp(min=1e-12)).mean())
    return {"Precision": prec, "Recall": rec, "F1": f1, "NDCG": ndcg}
