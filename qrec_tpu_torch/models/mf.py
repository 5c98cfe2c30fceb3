"""Shallow matrix factorization: BasicMF, PMF, SVD and BPR (reference
model/rating/BasicMF.py, PMF.py, SVD.py, model/ranking/BPR.py; the JAX
package's ``models/mf.py``).

Each is a minibatch loss under the shared training loop in its ``bold``
mode: SGD with the bold-driver learning rate and the ``|Δloss| < 1e-3``
convergence rule (``evaluation.setup ... -tf`` trains with Adam instead).
The rating models sample shuffled (user, item, rating) batches; BPR samples
(user, positive, negative) triples. Parameters: ``user_emb`` (U, d) and
``item_emb`` (I, d), plus SVD's ``user_bias`` (U,) and ``item_bias`` (I,).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.losses import bpr_loss
from ..ops.topk import ScoreForm
from .base import IterativeRecommender, SavedBiases, TrainSpec


def _l2(x: torch.Tensor, w: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_b w_b ‖x_b‖² (without the ½), or Σ_b w_b (x_b² + y_b²) summed in
    that order, the JAX package's."""
    sq = x**2 if y is None else x**2 + y**2
    return (w[:, None] * sq).sum()


class _MF(IterativeRecommender):
    """The embedding tables, the score map and the spec shared by the family.
    On a mesh each data rank's loss is its rows of the batch
    (``batch_share``): every term is a sum over them."""

    track_best = False

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        tables = self.init_embeddings(self.init_kind())
        self.user_emb = nn.Parameter(tables["user_emb"])
        self.item_emb = nn.Parameter(tables["item_emb"])

    def init_kind(self) -> str:
        """U(0, 1)/3 tables (iterativeRecommender.py:36-39)."""
        return "uniform"

    def factors(self):
        """The final (users, items) factors: the tables themselves."""
        return self.user_emb.detach(), self.item_emb.detach()

    def build(self) -> TrainSpec:
        """The bold-mode spec; under ``-tf`` (Adam) it may chunk."""
        return TrainSpec(
            list(self.parameters()), self.loss, self.sampler(),
            score_params_fn=self.factors, track_best=self.track_best, mode="bold",
            chunkable=True,
        )

    def sampler(self):
        return self.rating_sampler()


class PMF(_MF):
    """L2-regularized MF (PMF.py:9-28): ``½ Σ w (r - p·q)² + ½ (regU Σ w‖p‖²
    + regI Σ w‖q‖²)`` over the batch's rows."""

    reg_in_loss = True

    def loss(self, batch, gen=None) -> torch.Tensor:
        u, i, r, w = self.batch_share(batch)
        pu, qi = self.user_emb[u], self.item_emb[i]
        err = r - (pu * qi).sum(dim=1)
        loss = 0.5 * (w * err**2).sum()
        if self.reg_in_loss:
            loss = loss + 0.5 * (self.reg_u * _l2(pu, w) + self.reg_i * _l2(qi, w))
        return loss


class BasicMF(PMF):
    """Plain MF on explicit ratings, no regularization (BasicMF.py:9-26):
    ``½ Σ w (r - p·q)²``."""

    reg_in_loss = False


class SVD(SavedBiases, _MF):
    """Biased MF with the global mean (SVD.py:13-35,76-82): ``r̂ = p·q + μ
    + b_u + b_i``. The biases start as U(0, 1)/5 from numpy's
    ``RandomState(seed)``, the JAX package's draws bit for bit; a saved
    model keeps them as ``user_bias``/``item_bias``."""

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        rng = np.random.RandomState(self.seed)
        for name, n in (("user_bias", self.num_users), ("item_bias", self.num_items)):
            init = torch.from_numpy(rng.random_sample(n).astype(np.float32) / 5)
            setattr(self, name, nn.Parameter(init.to(self.device)))
        self.Bu = self.Bi = None

    def loss(self, batch, gen=None) -> torch.Tensor:
        u, i, r, w = self.batch_share(batch)
        pu, qi = self.user_emb[u], self.item_emb[i]
        bu, bi = self.user_bias[u], self.item_bias[i]
        pred = (pu * qi).sum(dim=1) + self.data.global_mean + bu + bi
        err = r - pred
        return 0.5 * (w * err**2).sum() + 0.5 * (
            self.reg_u * _l2(pu, w) + self.reg_i * _l2(qi, w)
            + self.reg_b * ((w * bu**2).sum() + (w * bi**2).sum())
        )

    def finalize(self, spec: TrainSpec) -> None:
        super().finalize(spec)
        self.Bu, self.Bi = self.user_bias.detach(), self.item_bias.detach()

    def predict_ratings(self, users, items) -> np.ndarray:
        """The biased prediction, or the global mean where the user or the
        item is unknown (SVD.py:76-82: no per-user or per-item fallback)."""
        uids, iids = self._ids(users, items)
        known = (uids >= 0) & (iids >= 0)
        bias = (self.Bu[self._at(uids)] + self.Bi[self._at(iids)]).cpu().numpy()
        pred = self._pair_dots(uids, iids) + self.data.global_mean + bias
        return np.where(known, pred, self.data.global_mean).astype(np.float64)

    def score_form(self) -> ScoreForm:
        """``((U·Vᵀ + μ) + b_i) + b_u``, the JAX package's score order
        (``qrec_tpu/models/mf.py:130-150``), μ in f32."""
        return ScoreForm(self.U, self.V, item_bias=self.Bi, user_bias=self.Bu,
                         offset=float(np.float32(self.data.global_mean)))


class BPR(_MF):
    """Bayesian Personalized Ranking (BPR.py:19-53): the pairwise sigmoid
    loss with per-sample L2 on the touched factors.

    Under ``evaluation.setup ... -tf`` the reference's TF path
    (BPR.py:77-96): tables start as a truncated normal σ=0.005, the loss is
    ``-Σ w log(σ(s+ − s−) + 1e-6)`` plus ``regU ½ (‖U‖² + ‖V‖²)`` over the
    FULL tables, the training pairs come in file order (fresh negatives
    every epoch), and Adam trains it."""

    def read_configuration(self) -> None:
        super().read_configuration()
        self.tf_path = self.eval_settings.contains("-tf")

    def init_kind(self) -> str:
        return "normal" if self.tf_path else "uniform"

    def sampler(self):
        return self.pairwise_sampler(shuffle=not self.tf_path)

    def loss(self, batch, gen=None) -> torch.Tensor:
        """On a mesh, this data rank's share: its rows of the batch's sums
        (``batch_share``), and the ``-tf`` regulariser over the full tables,
        which is no sum over the rows, on data rank 0 alone."""
        u, i, j, w = self.batch_share(batch)
        pu, qi, qj = self.user_emb[u], self.item_emb[i], self.item_emb[j]
        pos = (pu * qi).sum(dim=1)
        neg = (pu * qj).sum(dim=1)
        if self.tf_path:
            loss = -(w * torch.log(torch.sigmoid(pos - neg) + 1e-6)).sum()
            if not self.adds_table_terms:
                return loss
            reg = self.reg_u * 0.5 * ((self.user_emb**2).sum() + (self.item_emb**2).sum())
        else:
            loss = bpr_loss(pos, neg, w)
            reg = 0.5 * (self.reg_u * _l2(pu, w) + self.reg_i * _l2(qi, w, qj))
        return loss + reg
