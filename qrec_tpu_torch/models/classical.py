"""Classical family: UserKNN, ItemKNN, SlopeOne, SVD++ and EE (reference
model/rating/{UserKNN,ItemKNN,SlopeOne,SVDPlusPlus,EE}.py; the JAX
package's ``models/classical.py``).

The memory-based models learn nothing. At prediction time they compute, on
the device, the similarity of each test entity against every entity
(``ops/similarity.py``'s pairwise forms) or SlopeOne's co-rating counts and
summed differences (masked products of the rating matrix), then predict
each test rating in a numpy float64 loop on the host with the reference's
fallbacks. They evaluate ratings only: ranking them raises
:class:`~qrec_tpu_torch.errors.EvaluationError`, as the reference does.

SVD++ and EE train on the bold driver (Adam under ``-tf``) over shuffled
rating batches. SVD++ ranks through K2's bias epilogue (``ScoreForm`` with
both biases and the global mean); EE's distance score is not a dot product,
so it ranks a ``ScoreBlock``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..device import f32_products
from ..errors import EvaluationError
from ..ops.similarity import pairwise_cosine_sp, pairwise_euclidean_sp, pairwise_pearson
from ..ops.spmm import segment_sum
from ..ops.topk import ScoreBlock, ScoreForm
from .base import IterativeRecommender, Recommender, SavedBiases, TrainSpec
from .mf import _l2

_SIM_FNS = {"pcc": pairwise_pearson, "cos": pairwise_cosine_sp, "euclidean": pairwise_euclidean_sp}


def neighbours(name: str, rows: torch.Tensor, ids: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(similarities f32, neighbour ids int64) numpy arrays (Q, k): the ``k``
    most similar rows of ``rows`` (N, ·) to each row ``ids`` (Q,) under the
    similarity ``name`` (cosine for an unknown name, as qmath.py:108-114
    dispatches), each row's own entry excluded. A stable descending sort
    cut at ``k`` keeps ``lax.top_k``'s order: the lower index first among
    equal values (Pearson's overlap rule gives many exact 1.0s)."""
    q = torch.as_tensor(ids, device=rows.device)
    with f32_products():
        sims = _SIM_FNS.get(name, pairwise_cosine_sp)(rows, rows[q])
    sims[torch.arange(len(ids), device=rows.device), q] = -torch.inf
    vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return vals[:, :k].cpu().numpy(), idx[:, :k].cpu().numpy()


class _KNN(Recommender):
    """Mean-centred weighted kNN over users (``by_user``) or items: the
    neighbours of each test entity on the device, the weighted mean offset
    of those that rated the pair on the host."""

    by_user = True

    def read_configuration(self) -> None:
        self.sim = self.config["similarity"]
        self.neighbors = self.config.get_int("num.neighbors")

    def predict_ratings(self, users, items) -> np.ndarray:
        data = self.data
        uids, iids = self._ids(users, items)
        r_np = data.dense_matrix()
        if self.by_user:
            own, other, means, n = uids, iids, data.user_means, data.num_users
            table = r_np
        else:
            own, other, means, n = iids, uids, data.item_means, data.num_items
            table = r_np.T
        uniq = np.unique(own[own >= 0])
        if len(uniq) == 0:
            return np.full(len(uids), data.global_mean)
        k = min(self.neighbors, max(n - 1, 1))
        rows = torch.from_numpy(np.ascontiguousarray(table)).to(self.device)
        top_sims, top_ids = neighbours(self.sim, rows, uniq, k)
        row_of = {int(e): j for j, e in enumerate(uniq)}
        out = np.empty(len(uids))
        for m, (e, o) in enumerate(zip(own, other)):
            if e < 0:
                # unknown entity: no similarity → global mean (UserKNN.py:44-48)
                out[m] = data.global_mean
                continue
            if o < 0:
                # unknown partner: no neighbour rated it → the entity's mean
                out[m] = means[e]
                continue
            j = row_of[int(e)]
            nbrs, s = top_ids[j], top_sims[j]
            r = table[nbrs, o]
            mask = r != 0
            ssum = float(np.sum(s[mask] * (r[mask] - means[nbrs][mask])))
            denom = float(np.sum(s[mask]))
            out[m] = means[e] if ssum == 0 else means[e] + ssum / denom
        return out

    def score_form(self):
        raise EvaluationError(f"Ranking for all items in {self.model_name} is not available.")


class UserKNN(_KNN):
    """Mean-centred weighted user kNN (UserKNN.py:28-66). Rating only (the
    reference refuses ranking, UserKNN.py:68-70)."""


class ItemKNN(_KNN):
    """Mean-centred weighted item kNN (ItemKNN.py:27-71). Rating only."""

    by_user = False


class SlopeOne(Recommender):
    """Item-pair mean rating differences weighted by co-rating counts
    (SlopeOne.py:12-54): the counts and differences of each test item
    against every item on the device, the prediction on the host."""

    def predict_ratings(self, users, items) -> np.ndarray:
        data = self.data
        r_np = data.dense_matrix()
        m_np = (r_np > 0).astype(np.float32)
        uids, iids = self._ids(users, items)
        uniq = np.unique(iids[iids >= 0])
        if len(uniq):
            r_d = torch.from_numpy(r_np).to(self.device)
            m_d = torch.from_numpy(m_np).to(self.device)
            cols = torch.as_tensor(uniq, device=self.device)
            with f32_products():
                # freq[a, j]: raters of both; diff_sum[a, j]: Σ (r_a − r_j)
                freq = m_d[:, cols].T @ m_d
                diff_sum = r_d[:, cols].T @ m_d - m_d[:, cols].T @ r_d
            diff = torch.where(freq > 0, diff_sum / torch.clamp_min(freq, 1), torch.zeros_like(freq))
            freq_np, diff_np = freq.cpu().numpy(), diff.cpu().numpy()
            row_of = {int(i): j for j, i in enumerate(uniq)}
        out = np.empty(len(uids))
        user_means, item_means = data.user_means, data.item_means
        for n, (u, i) in enumerate(zip(uids, iids)):
            if u >= 0 and i >= 0:
                j = row_of[int(i)]
                w = freq_np[j] * m_np[u]
                ssum = float(np.sum((r_np[u] + diff_np[j]) * w))
                fsum = float(np.sum(w))
                out[n] = ssum / fsum if fsum else user_means[u]
            elif u >= 0:
                # a known user and an unseen item: freqSum is 0 → the user's mean
                out[n] = user_means[u]
            elif i >= 0:
                out[n] = item_means[i]
            else:
                out[n] = data.global_mean
        return out


class _BiasedRating(SavedBiases, IterativeRecommender):
    """The U(0, 1)/3 tables, biases and extra tables from numpy's
    ``RandomState(seed)`` (the JAX package's draws bit for bit), the rating
    sampler in the bold mode, and predictions on the host in numpy, as the
    JAX package computes them. A saved model keeps its biases beside the
    factors, which the JAX package does not (its loaded SVD++ and EE lack
    them)."""

    bias_div = 1

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        for name, t in self.init_embeddings("uniform").items():
            setattr(self, name, nn.Parameter(t))
        rng = np.random.RandomState(self.seed)
        for name, shape in self.numpy_params():
            init = torch.from_numpy(rng.random_sample(shape).astype(np.float32) / self.bias_div)
            setattr(self, name, nn.Parameter(init.to(self.device)))
        self.Bu = self.Bi = None

    def numpy_params(self):
        return (("user_bias", self.num_users), ("item_bias", self.num_items))

    def build(self) -> TrainSpec:
        return TrainSpec(list(self.parameters()), self.loss, self.rating_sampler(),
                         score_params_fn=self.factors, mode="bold")

    def factors(self):
        return self.user_emb.detach(), self.item_emb.detach()

    def finalize(self, spec: TrainSpec) -> None:
        super().finalize(spec)
        self.Bu, self.Bi = self.user_bias.detach(), self.item_bias.detach()

    def _host(self, uids: np.ndarray, iids: np.ndarray):
        """(p_u, q_i, b_u, b_i) numpy rows of the final tables, an unknown id
        read as row 0."""
        u, i = np.maximum(uids, 0), np.maximum(iids, 0)
        return (self.U.cpu().numpy()[u], self.V.cpu().numpy()[i],
                self.Bu.cpu().numpy()[u], self.Bi.cpu().numpy()[i])

    def predict_ratings(self, users, items) -> np.ndarray:
        """The model's prediction, or the global mean where the user or the
        item is unknown."""
        uids, iids = self._ids(users, items)
        known = (uids >= 0) & (iids >= 0)
        pred = self.host_prediction(*self._host(uids, iids))
        return np.where(known, pred, self.data.global_mean).astype(np.float64)


class EE(_BiasedRating):
    """Euclidean embedding (EE.py:15-44): ``r̂ = μ + b_u + b_i − ‖p_u −
    q_i‖²``, the biases U(0, 1)/10 from numpy. The bold driver without
    ``-tf``; Adam on the true gradient under it (config/EE.conf's
    reference run, EE.py:38-67)."""

    bias_div = 10

    def loss(self, batch, gen=None) -> torch.Tensor:
        u, i, r, w = batch
        bu, bi = self.user_bias[u], self.item_bias[i]
        diff = self.user_emb[u] - self.item_emb[i]
        err = r - (self.data.global_mean + bu + bi - (diff**2).sum(dim=1))
        return 0.5 * (w * err**2).sum() + 0.5 * (
            self.reg_u * _l2(diff, w) + self.reg_b * ((w * bu**2).sum() + (w * bi**2).sum())
        )

    def host_prediction(self, pu, qi, bu, bi):
        return self.data.global_mean + bu + bi - np.sum((pu - qi) ** 2, axis=1)

    def _scores(self, uids: torch.Tensor) -> torch.Tensor:
        pu, q = self.U[uids], self.V
        with f32_products():
            d2 = (pu**2).sum(dim=1)[:, None] - 2 * pu @ q.T + (q**2).sum(dim=1)[None, :]
        return self._gm + self.Bu[uids][:, None] + self.Bi[None, :] - d2

    def score_form(self) -> ScoreBlock:
        """``μ + b_u + b_i − ‖p − q‖²`` of every item, ``‖p − q‖²`` expanded
        as ``‖p‖² − 2 p·q + ‖q‖²`` in the JAX package's order, μ in f32."""
        if self.U is None:
            raise RuntimeError(f"{self.model_name}: fit() before scoring")
        self._gm = float(np.float32(self.data.global_mean))
        return ScoreBlock(self._scores)


class SVDPlusPlus(_BiasedRating):
    """SVD++ (SVDPlusPlus.py): ``r̂ = (p_u + Σ_{j∈I_u} y_j / |I_u|)·q_i + μ
    + b_u + b_i``, the implicit factors ``Y`` (I, d) and the biases U(0, 1)
    from numpy. The implicit mean is a segment sum of ``Y``'s rows over each
    user's sorted training items; ``Y``'s L2 term is spread over the
    epoch's batches."""

    def read_configuration(self) -> None:
        super().read_configuration()
        self.reg_y = self.model_args().get_float("-y")

    def numpy_params(self):
        return super().numpy_params() + (("Y", (self.num_items, self.emb_size)),)

    def build(self) -> TrainSpec:
        d = self.data
        self.sel_i = torch.as_tensor(d.train_i[d.csr_sel], dtype=torch.int64, device=self.device)
        self.u_indptr = torch.as_tensor(d.u_indptr, dtype=torch.int64, device=self.device)
        self.deg = torch.as_tensor(np.maximum(np.diff(d.u_indptr), 1).astype(np.float32),
                                   device=self.device)
        self.reg_y_scale = 1.0 / max(1, (self.train_size + self.batch_size - 1) // self.batch_size)
        return super().build()

    def implicit_mean(self, y: torch.Tensor) -> torch.Tensor:
        """(U, d): the mean of ``y``'s rows over each user's training items."""
        return segment_sum(y[self.sel_i], self.u_indptr) / self.deg[:, None]

    def loss(self, batch, gen=None) -> torch.Tensor:
        u, i, r, w = batch
        imp = self.implicit_mean(self.Y)
        pu = self.user_emb[u] + imp[u]
        qi = self.item_emb[i]
        bu, bi = self.user_bias[u], self.item_bias[i]
        err = r - ((pu * qi).sum(dim=1) + self.data.global_mean + bu + bi)
        reg = 0.5 * (
            self.reg_u * _l2(self.user_emb[u], w) + self.reg_i * _l2(qi, w)
            + self.reg_b * ((w * bu**2).sum() + (w * bi**2).sum())
        )
        reg_y = self.reg_y_scale * 0.5 * self.reg_y * (self.Y**2).sum()
        return 0.5 * (w * err**2).sum() + reg + reg_y

    def factors(self):
        """``p_u`` plus the user's implicit mean (SVDPlusPlus.py's final
        user representation), and the item table."""
        return self.user_emb.detach() + self.implicit_mean(self.Y.detach()), self.item_emb.detach()

    def host_prediction(self, pu, qi, bu, bi):
        return np.sum(pu * qi, axis=1) + self.data.global_mean + bu + bi

    def score_form(self) -> ScoreForm:
        """``((U·Vᵀ + μ) + b_i) + b_u``, the JAX package's order
        (``qrec_tpu/models/classical.py:353-371``), μ in f32: K2's bias
        epilogue."""
        return ScoreForm(self.U, self.V, item_bias=self.Bi, user_bias=self.Bu,
                         offset=float(np.float32(self.data.global_mean)))
