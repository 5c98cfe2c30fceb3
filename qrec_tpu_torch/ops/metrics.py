"""Ranking and rating metrics (counterpart of the JAX package's
``ops/metrics.py``).

``ranking_measure`` and ``rating_measure`` operate on the same structures as
the reference (util/measure.py) and produce identical output strings. The reference's
NDCG idiosyncrasies are kept (util/measure.py:69-82): binary relevance,
natural-log discount ``1/ln(n+2)``, and IDCG summed over the first
``min(|test_u|, N)`` positions. ``device_ranking_metrics`` computes the
same measures on tensors for the per-epoch quick evaluation.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..errors import EvaluationError


def hits(origin: Dict[str, dict], predicted: Dict[str, list]) -> Dict[str, int]:
    """Per-user hit counts (util/measure.py:14-21)."""
    hit_count = {}
    for user in origin:
        items = set(origin[user].keys())
        pred = {item[0] for item in predicted[user]}
        hit_count[user] = len(items & pred)
    return hit_count


def precision(hit_count: Dict[str, int], n: int) -> float:
    return sum(hit_count.values()) / (len(hit_count) * n)


def recall(hit_count: Dict[str, int], origin: Dict[str, dict]) -> float:
    recalls = [hit_count[u] / len(origin[u]) for u in hit_count]
    return sum(recalls) / len(recalls)


def f1(prec: float, rec: float) -> float:
    if (prec + rec) != 0:
        return 2 * prec * rec / (prec + rec)
    return 0


def ndcg(origin: Dict[str, dict], predicted: Dict[str, list], n: int) -> float:
    """Reference NDCG (util/measure.py:69-82)."""
    total = 0.0
    for user in predicted:
        dcg = 0.0
        idcg = 0.0
        for pos, item in enumerate(predicted[user]):
            if item[0] in origin[user]:
                dcg += 1.0 / math.log(pos + 2)
        for pos, _ in enumerate(list(origin[user].keys())[:n]):
            idcg += 1.0 / math.log(pos + 2)
        total += dcg / idcg
    return total / len(predicted)


def ranking_measure(
    origin: Dict[str, dict], rec_list: Dict[str, list], top_ns: Sequence[int]
) -> List[str]:
    """Reference-format measure lines (util/measure.py:23-49)."""
    measure: List[str] = []
    for n in top_ns:
        predicted = {user: rec_list[user][:n] for user in rec_list}
        if len(origin) != len(predicted):
            raise EvaluationError(
                "The Lengths of test set and predicted set do not match!"
            )
        hit_count = hits(origin, predicted)
        prec = precision(hit_count, n)
        rec = recall(hit_count, origin)
        measure.append("Top " + str(n) + "\n")
        measure.append("Precision:" + str(prec) + "\n")
        measure.append("Recall:" + str(rec) + "\n")
        measure.append("F1:" + str(f1(prec, rec)) + "\n")
        measure.append("NDCG:" + str(ndcg(origin, predicted, n)) + "\n")
    return measure


def rating_measure(res: Sequence[Sequence]) -> List[str]:
    """MAE/RMSE lines over [user, item, rating, prediction] records
    (util/measure.py:5-12,118-138)."""
    mae_err, rmse_err, count = 0.0, 0.0, 0
    for entry in res:
        mae_err += abs(entry[2] - entry[3])
        rmse_err += (entry[2] - entry[3]) ** 2
        count += 1
    mae = mae_err / count if count else mae_err
    rmse = math.sqrt(rmse_err / count) if count else rmse_err
    return ["MAE:" + str(mae) + "\n", "RMSE:" + str(rmse) + "\n"]


def parse_measure(measure: List[str]) -> Dict[str, Dict[str, float]]:
    """Parse measure lines into {'Top N': {'Precision': ...}} dicts."""
    out: Dict[str, Dict[str, float]] = {}
    current = "global"
    for line in measure:
        line = line.strip()
        if line.startswith("Top "):
            current = line
            out[current] = {}
            continue
        if ":" in line:
            k, v = line.split(":", 1)
            out.setdefault(current, {})[k] = float(v)
    return out


def idcg_table(max_n: int) -> np.ndarray:
    """``idcg_table[t] = sum_{n=0}^{t-1} 1/ln(n+2)`` for t in [0, max_n]."""
    terms = 1.0 / np.log(np.arange(max_n) + 2.0)
    return np.concatenate([[0.0], np.cumsum(terms)]).astype(np.float32)


def device_ranking_metrics(
    pred_ids: torch.Tensor,  # (B, N) top-N item ids per test user
    test_ids: torch.Tensor,  # (B, T) test items, -1 = pad/unseen
    test_counts: torch.Tensor,  # (B,) |test items| incl. unseen
    top_ns: Sequence[int],
    idcg: Optional[torch.Tensor] = None,
) -> Dict[int, Dict[str, torch.Tensor]]:
    """Precision/Recall/F1/NDCG@{top_ns} as 0-d f32 tensors on the inputs'
    device, with the reference's formulas: precision is the global hit sum
    over ``B*n`` (util/measure.py:52-54), recall the per-user mean of
    ``hits/|test|`` (util/measure.py:105-109), NDCG as above. ``idcg`` is
    :func:`idcg_table` of N on that device, which a caller that measures
    every epoch keeps (``CatalogRanker.idcg``): made here, it is a copy
    from the host at every call, which a CUDA graph cannot hold."""
    n_max = int(pred_ids.shape[1])
    device = pred_ids.device
    hit_at_pos = (
        (pred_ids[:, :, None] == test_ids[:, None, :]) & (test_ids[:, None, :] >= 0)
    ).any(dim=-1)  # (B, N)
    discounts = 1.0 / torch.log(torch.arange(n_max, dtype=torch.float32, device=device) + 2.0)
    table = torch.from_numpy(idcg_table(n_max)).to(device) if idcg is None else idcg
    if table.shape != (n_max + 1,):
        raise ValueError(f"idcg table of {tuple(table.shape)} entries for lists of {n_max}")
    b = pred_ids.shape[0]
    results = {}
    for n in top_ns:
        hits_n = hit_at_pos[:, :n].sum(dim=1)
        prec = hits_n.sum() / (b * n)
        rec = (hits_n / torch.clamp_min(test_counts, 1)).mean()
        f1_val = torch.where(prec + rec > 0, 2 * prec * rec / (prec + rec), torch.zeros_like(prec))
        dcg = (hit_at_pos[:, :n] * discounts[:n]).sum(dim=1)
        idcg = table[torch.clamp_max(test_counts, n).long()]
        ndcg_val = (dcg / torch.clamp_min(idcg, 1e-12)).mean()
        results[n] = {"Precision": prec, "Recall": rec, "F1": f1_val, "NDCG": ndcg_val}
    return results
