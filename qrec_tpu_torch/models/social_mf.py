"""Social MF rating family: SoRec, SoReg, SocialMF, RSTE, LOCABAL, SREE and
SocialFD (reference model/rating/{SoRec,SoReg,SocialMF,RSTE,LOCABAL,SREE,
SocialFD}.py; the JAX package's ``models/social_mf.py``).

Each is an explicit-rating model on bold-driver SGD (runtime/trainer.py):
a rating term over the shuffled minibatch plus a social term over the full
trust edge arrays, evaluated once a batch and scaled by ``1/num_batches``,
so that its weight per epoch matches the reference's one social pass an
epoch. Where the reference's hand-written updates treat a quantity as a
constant, it is detached where the JAX package stops its gradient:
SocialMF's followee mean, RSTE's social dot product, and the followees'
rows in SREE's and SocialFD's pull.

The host constants (SoRec's trust weights, SoReg's Pearson and LOCABAL's
cosine edge similarities, LOCABAL's PageRank weights, the followee-mean
operator of SocialMF and RSTE) are built once in ``build_graph``. SoRec's
``Z``, LOCABAL's ``H`` and SREE's and SocialFD's biases and ``H`` come from
numpy's ``RandomState(seed)``, the JAX package's values bit for bit; the
(U, d) and (I, d) tables are U(0, 1)/3 from the port's generator. SREE and
SocialFD score by distance, so they predict ratings with their own formula
and rank a :class:`~qrec_tpu_torch.ops.topk.ScoreBlock`. No model of the
family runs a kernel but K2's top-k, and that only when ranked.

On a mesh each data rank's loss is its share of the step's: its rows of
the batch (``batch_share``), its block of the trust edges or of the users
for a social term that sums over them (``row_share``), and a squared norm
of a whole table (SoRec's ``Z``, LOCABAL's ``H``) on data rank 0 alone
(``adds_table_terms``). The scale ``social_scale`` is the whole run's on
every rank; the host constants, the followee mean and RSTE's final blend
are whole on every rank.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..data.graph import COO
from ..errors import ConvergenceError
from ..ops.similarity import edge_cosine_sp, edge_pearson_sp
from ..ops.spmm import DeviceCOO, spmm
from ..ops.topk import ScoreBlock
from .base import SavedBiases, SocialRecommender, TrainSpec
from .mf import _l2


def pagerank(relation, alpha: float = 0.85, max_iter: int = 100, tol: float = 1e-6) -> Dict[str, float]:
    """The PageRank of every user of ``relation``'s directed graph, as
    ``networkx.pagerank(g, alpha)`` computes it on a ``DiGraph`` built edge
    by edge from the rows (u1, u2, weight): nodes in order of first
    appearance (u1, then u2, of each row), a repeated edge once with weight
    1, each row divided by its out-degree, the mass of dangling nodes and
    the teleport spread uniformly, and the power iteration stopped once its
    L1 change falls below ``N · tol``. The numpy and scipy operations are
    networkx's, in its order, so the values agree bit for bit."""
    succ: Dict[str, Dict[str, None]] = {}
    for u1, u2, _ in relation:
        succ.setdefault(u1, {})
        succ.setdefault(u2, {})
        succ[u1].setdefault(u2, None)
    nodes = list(succ)
    n = len(nodes)
    if n == 0:
        return {}
    index = {u: k for k, u in enumerate(nodes)}
    rows = [index[u] for u, vs in succ.items() for _ in vs]
    cols = [index[v] for vs in succ.values() for v in vs]
    a = sp.coo_array((np.ones(len(rows)), (rows, cols)), shape=(n, n), dtype=float).asformat("csr")
    s = a.sum(axis=1)
    s[s != 0] = 1.0 / s[s != 0]
    a = sp.dia_array((s.T, 0), shape=a.shape).tocsr() @ a
    x = np.repeat(1.0 / n, n)
    p = np.repeat(1.0 / n, n)
    dangling = np.where(s == 0)[0]
    for _ in range(max_iter):
        last = x
        x = alpha * (x @ a + sum(x[dangling]) * p) + (1 - alpha) * p
        if np.absolute(x - last).sum() < n * tol:
            return dict(zip(nodes, map(float, x)))
    raise ConvergenceError(f"PageRank did not converge in {max_iter} iterations")


def rank_weights(pr: Dict[str, float]) -> Dict[str, float]:
    """``1 / (1 + log(rank + 1))`` by descending PageRank, ties in node
    order (a stable sort), LOCABAL.py:25-33."""
    ranked = sorted(pr.items(), key=lambda d: d[1], reverse=True)
    return {user: 1.0 / (1 + math.log(ind + 1)) for ind, (user, _) in enumerate(ranked)}


class _SocialMF(SocialRecommender):
    """What the seven share: the U(0, 1)/3 tables (divided by
    ``table_div``), the rating sampler, the bold mode, the host build before
    the first epoch and the rating term."""

    table_div = 1

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        for name, t in self.init_embeddings("uniform").items():
            setattr(self, name, nn.Parameter(t / self.table_div))
        n_batches = max(1, (self.train_size + self.batch_size - 1) // self.batch_size)
        # a full-edge social term evaluated once a batch (the JAX package's
        # _social_scale, social_mf.py:30-34)
        self.social_scale = 1.0 / n_batches
        self._rng = np.random.RandomState(self.seed)

    def _numpy_param(self, name: str, shape, div: float = 1) -> None:
        """A parameter of U(0, 1)/div from ``RandomState(seed)``, the next
        draw of the JAX package's stream."""
        init = torch.from_numpy(self._rng.random_sample(shape).astype(np.float32) / div)
        setattr(self, name, nn.Parameter(init.to(self.device)))

    def _edge_similarity(self, fn) -> torch.Tensor:
        s = self.social_arrays
        dense = torch.from_numpy(self.data.dense_matrix()).to(self.device)
        return fn(dense, s["src"], s["dst"])

    def _followee_mean(self) -> None:
        """The row-normalized followee matrix (each edge its weight over its
        source's summed weights) as a ``DeviceCOO``, and whether a user
        follows anyone."""
        src, dst, w = self.social.coo()
        out_w = np.zeros(self.num_users, dtype=np.float32)
        np.add.at(out_w, src, w)
        norm_w = w / np.maximum(out_w[src], 1e-12)
        shape = (self.num_users, self.num_users)
        self.followee_op = DeviceCOO.from_host(COO.from_scipy(sp.coo_matrix((norm_w, (src, dst)), shape)),
                                               self.device)
        self.has_followees = torch.as_tensor((out_w > 0).astype(np.float32), device=self.device)

    def factors(self):
        return self.user_emb.detach(), self.item_emb.detach()

    def build(self) -> TrainSpec:
        """The host build and the bold-mode spec, which may chunk under
        ``-tf``; the trust edges the losses read are put on the device here,
        before a chunked run's capture."""
        self.prepare_graph()
        self.social_arrays
        return TrainSpec(list(self.parameters()), self.loss, self.rating_sampler(),
                         score_params_fn=self.factors, mode="bold", chunkable=True)

    def fit_term(self, pu, qi, pred, r, w, coeff: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``½ Σ w (r - pred)² + ½ (regU Σ w‖p‖² + regI Σ w‖q‖²)``, each
        error weighted by ``coeff`` too where given."""
        err = r - pred
        sq = w * err**2 if coeff is None else w * coeff * err**2
        return 0.5 * sq.sum() + 0.5 * (self.reg_u * _l2(pu, w) + self.reg_i * _l2(qi, w))

    def edge_share(self) -> slice:
        """This data rank's block of the trust edges (``row_share``), for a
        social term that sums over them; every edge without a mesh."""
        return slice(*self.row_share(self.social_arrays["src"].shape[0]))

    def _batch_rows(self, batch):
        u, i, r, w = self.batch_share(batch)
        pu, qi = self.user_emb[u], self.item_emb[i]
        return u, pu, qi, r, w


class SoRec(_SocialMF):
    """Ratings and trust co-factorized with the shared user table and
    relation factors ``Z`` (U, d), U(0, 1)/10 from numpy; each trust edge's
    target weight is ``sqrt(d⁻(v) / (d⁺(u) + d⁻(v)))`` (SoRec.py:42-60)."""

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        self._numpy_param("Z", (self.num_users, self.emb_size), 10)

    def read_configuration(self) -> None:
        super().read_configuration()
        self.reg_z = self.model_args().get_float("-z")

    def build_graph(self) -> None:
        src, dst, w = self.social.coo()
        vminus = self.social.in_degree[dst]
        denom = self.social.out_degree[src] + vminus
        with np.errstate(invalid="ignore", divide="ignore"):
            trust_w = np.where(denom > 0, np.sqrt(vminus / np.maximum(denom, 1)), 1.0)
        self.target = torch.as_tensor((trust_w * w).astype(np.float32), device=self.device)

    def loss(self, batch, gen=None) -> torch.Tensor:
        _, pu, qi, r, w = self._batch_rows(batch)
        s, edges = self.social_arrays, self.edge_share()
        src, dst = s["src"][edges], s["dst"][edges]
        e = self.target[edges] - (self.user_emb[src] * self.Z[dst]).sum(dim=1)
        social = 0.5 * self.reg_s * (e**2).sum()
        if self.adds_table_terms:
            social = social + 0.5 * self.reg_z * (self.Z**2).sum()
        return self.fit_term(pu, qi, (pu * qi).sum(dim=1), r, w) + self.social_scale * social


class SoReg(_SocialMF):
    """A social regularizer pulling followers toward followees with weight
    ``(pearson + trust) / 2`` (SoReg.py:35-36,54-72)."""

    def read_configuration(self) -> None:
        super().read_configuration()
        self.alpha = self.model_args().get_float("-alpha")

    def build_graph(self) -> None:
        self.sim = (self._edge_similarity(edge_pearson_sp) + self.social_arrays["w"]) / 2.0

    def loss(self, batch, gen=None) -> torch.Tensor:
        _, pu, qi, r, w = self._batch_rows(batch)
        s, edges = self.social_arrays, self.edge_share()
        diff = self.user_emb[s["src"][edges]] - self.user_emb[s["dst"][edges]]
        social = self.social_scale * 0.5 * self.alpha * (self.sim[edges, None] * diff**2).sum()
        return self.fit_term(pu, qi, (pu * qi).sum(dim=1), r, w) + social


class SocialMF(_SocialMF):
    """Trust propagation: each user pulled toward the weighted mean of its
    followees, the mean a constant as in the reference's update rule
    (SocialMF.py:26-43)."""

    def build_graph(self) -> None:
        self._followee_mean()

    def loss(self, batch, gen=None) -> torch.Tensor:
        _, pu, qi, r, w = self._batch_rows(batch)
        p, rows = self.user_emb, slice(*self.row_share(self.num_users))
        mean = spmm(self.followee_op, p.detach())
        diff = (p[rows] - mean[rows]) * self.has_followees[rows, None]
        social = self.social_scale * 0.5 * self.reg_s * (diff**2).sum()
        return self.fit_term(pu, qi, (pu * qi).sum(dim=1), r, w) + social


class RSTE(_SocialMF):
    """Trust ensemble: ``α p·q + (1-α) mean_followees(p)·q`` for a user with
    followees, ``p·q`` otherwise (RSTE.py:22-58). The gradient flows only
    through the α term, as in the reference; the final user factors are the
    blend ``α p + (1-α) mean``."""

    def read_configuration(self) -> None:
        super().read_configuration()
        self.alpha = self.model_args().get_float("-alpha")

    def build_graph(self) -> None:
        self._followee_mean()

    def loss(self, batch, gen=None) -> torch.Tensor:
        u, pu, qi, r, w = self._batch_rows(batch)
        mean = spmm(self.followee_op, self.user_emb.detach())
        dot = (pu * qi).sum(dim=1)
        blend = self.alpha * dot + (1 - self.alpha) * (mean[u] * qi).sum(dim=1)
        pred = torch.where(self.has_followees[u] > 0, blend, dot)
        return self.fit_term(pu, qi, pred, r, w)

    def finalize(self, spec: TrainSpec) -> None:
        with torch.no_grad():
            p = self.user_emb
            blended = self.alpha * p + (1 - self.alpha) * spmm(self.followee_op, p)
            self.U = torch.where(self.has_followees[:, None] > 0, blended, p).contiguous()
            self.V = self.item_emb.detach().contiguous()


class LOCABAL(_SocialMF):
    """Local and global social context (LOCABAL.py:23-84): each rating's
    error weighted by ``1 + w_u``, w_u the user's PageRank weight
    (:func:`rank_weights`, the reference applies both the weighted and the
    plain update), and a matrix ``H`` (d, d), U(0, 1) from numpy, fitted so
    that ``p_u H p_vᵀ`` matches the cosine similarity of each trust edge."""

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        self._numpy_param("H", (self.emb_size, self.emb_size))

    def read_configuration(self) -> None:
        super().read_configuration()
        self.alpha = self.model_args().get_float("-alpha")

    def build_graph(self) -> None:
        coeff = np.ones(self.num_users, dtype=np.float32)
        for user, wv in rank_weights(pagerank(self.social.relation)).items():
            if user in self.data.user:
                coeff[self.data.user[user]] += wv
        self.coeff = torch.as_tensor(coeff, device=self.device)
        self.sim = self._edge_similarity(edge_cosine_sp)

    def loss(self, batch, gen=None) -> torch.Tensor:
        u, pu, qi, r, w = self._batch_rows(batch)
        p, s, edges = self.user_emb, self.social_arrays, self.edge_share()
        phq = ((p[s["src"][edges]] @ self.H) * p[s["dst"][edges]]).sum(dim=1)
        social = 0.5 * self.alpha * ((self.sim[edges] - phq) ** 2).sum()
        if self.adds_table_terms:
            social = social + 0.5 * self.reg_s * (self.H**2).sum()
        return (self.fit_term(pu, qi, (pu * qi).sum(dim=1), r, w, self.coeff[u])
                + self.social_scale * social)


class _DistanceMF(SavedBiases, _SocialMF):
    """SREE's and SocialFD's prediction ``μ + b_u + b_i - dist(p_u, q_i)``
    and its score block, ``dist`` the squared distance after ``self.proj``
    (the identity for SREE, SocialFD's ``H``). A saved model keeps its
    biases (and SocialFD its ``H``) beside the factors, which the JAX
    package does not."""

    def finalize(self, spec: TrainSpec) -> None:
        super().finalize(spec)
        self.Bu, self.Bi = self.user_bias.detach(), self.item_bias.detach()

    def projection(self) -> Optional[torch.Tensor]:
        return None

    def predict_ratings(self, users, items) -> np.ndarray:
        """The distance prediction, or the global mean where the user or the
        item is unknown; on the host in numpy, as the JAX package computes
        it."""
        uids, iids = self._ids(users, items)
        known = (uids >= 0) & (iids >= 0)
        host = lambda t, ids: t.cpu().numpy()[np.maximum(ids, 0)]  # noqa: E731
        diff = host(self.U, uids) - host(self.V, iids)
        h = self.projection()
        if h is not None:
            diff = diff @ h.cpu().numpy()
        dist = np.sum(diff**2, axis=1)
        pred = self.data.global_mean + host(self.Bu, uids) + host(self.Bi, iids) - dist
        return np.where(known, pred, self.data.global_mean).astype(np.float64)

    def _scores(self, uids: torch.Tensor) -> torch.Tensor:
        x, y = self.U[uids], self.V
        h = self.projection()
        if h is not None:
            x, y = x @ h, y @ h
        d2 = (x**2).sum(dim=1)[:, None] - 2 * x @ y.T + (y**2).sum(dim=1)[None, :]
        return self._gm + self.Bu[uids][:, None] + self.Bi[None, :] - d2

    def score_form(self) -> ScoreBlock:
        """``μ + b_u + b_i - ‖x - y‖²`` of every item, ``‖x - y‖²`` expanded
        as ``‖x‖² - 2 x·y + ‖y‖²`` in the JAX package's order, μ in f32."""
        if self.U is None:
            raise RuntimeError(f"{self.model_name}: fit() before scoring")
        self._gm = float(np.float32(self.data.global_mean))
        return ScoreBlock(self._scores)


class SREE(_DistanceMF):
    """Social regularized Euclidean embedding (SREE.py:27-60): ``r̂ = μ + b_u
    + b_i - ‖p_u - q_i‖²``, the biases U(0, 1)/10 from numpy, and each user
    pulled toward its followees (their rows constant).

    Ranked, it scores ``μ + b_u + b_i - ‖p_u - q_i‖²``: the reference's
    ranking path (SREE.py:74-80) *adds* the distance, an apparent sign bug
    that neither package reproduces; SREE ships as a rating model in
    config/SREE.conf."""

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        self._numpy_param("user_bias", self.num_users, 10)
        self._numpy_param("item_bias", self.num_items, 10)
        self.Bu = self.Bi = None

    def read_configuration(self) -> None:
        super().read_configuration()
        self.alpha = self.model_args().get_float("-alpha")

    def loss(self, batch, gen=None) -> torch.Tensor:
        u, i, r, w = self.batch_share(batch)
        p = self.user_emb
        bu, bi = self.user_bias[u], self.item_bias[i]
        diff = p[u] - self.item_emb[i]
        err = r - (self.data.global_mean + bu + bi - (diff**2).sum(dim=1))
        rating = 0.5 * (w * err**2).sum() + 0.5 * (
            self.reg_u * _l2(diff, w) + self.reg_b * ((w * bu**2).sum() + (w * bi**2).sum())
        )
        s, edges = self.social_arrays, self.edge_share()
        sdiff = p[s["src"][edges]] - p[s["dst"][edges]].detach()
        social = self.social_scale * 0.5 * self.alpha * (s["w"][edges, None] * sdiff**2).sum()
        return rating + social


class SocialFD(_DistanceMF):
    """Metric-learning MF (SocialFD.py:24-116) on the distance ``d =
    ‖(x - y) H‖²``: the tables U(0, 1)/30, ``H`` (d, d) and the biases
    U(0, 1)/5 from numpy; ratings above 0.7 pull a pair together (``+ηα
    d``), ratings at most 0.5 push it apart within the unit ball (``-ηα
    min(d, 1)``), and followees pull with weight ``ηβ`` (their rows
    constant)."""

    table_div = 10

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        self._numpy_param("H", (self.emb_size, self.emb_size), 5)
        self._numpy_param("user_bias", self.num_users, 5)
        self._numpy_param("item_bias", self.num_items, 5)
        self.Bu = self.Bi = None

    def read_configuration(self) -> None:
        super().read_configuration()
        args = self.model_args()
        self.alpha = args.get_float("-alpha")
        self.eta = args.get_float("-eta")
        self.beta = args.get_float("-beta")

    def projection(self) -> torch.Tensor:
        return self.H.detach()

    def _extra_state(self) -> dict:
        return dict(super()._extra_state(), H=self.H.detach())

    def _set_extra_state(self, state: dict) -> None:
        super()._set_extra_state(state)
        with torch.no_grad():
            self.H.copy_(state["H"])

    def loss(self, batch, gen=None) -> torch.Tensor:
        u, i, r, w = self.batch_share(batch)
        x, y = self.user_emb[u], self.item_emb[i]
        bu, bi = self.user_bias[u], self.item_bias[i]
        d = (((x - y) @ self.H) ** 2).sum(dim=1)
        err = r - (self.data.global_mean + bu + bi - d)
        high, low = (r > 0.7).float(), (r <= 0.5).float()
        regime = self.eta * self.alpha * (w * (high * d - low * torch.minimum(d, torch.ones_like(d)))).sum()
        reg = 0.5 * (self.reg_u * _l2(x, w) + self.reg_i * _l2(y, w)
                     + self.reg_u * (w * bu**2).sum() + self.reg_i * (w * bi**2).sum())
        s, edges = self.social_arrays, self.edge_share()
        sdiff = self.user_emb[s["src"][edges]] - self.user_emb[s["dst"][edges]].detach()
        social = self.social_scale * self.eta * self.beta * (((sdiff @ self.H) ** 2).sum(dim=1)).sum()
        return 0.5 * (w * err**2).sum() + regime + reg + social
