"""Social and hypergraph graph family: MHCN, SEPT, BUIR, DiffNet and DHCF
(reference model/ranking/{MHCN,SEPT,BUIR,DiffNet,DHCF}.py; the JAX
package's ``models/social_graph.py``).

The motif, view and hypergraph matrices are built once on the host with
scipy, by the JAX package's formulas. Each becomes an auxiliary operator on
the device (:func:`aux_operator`): a ``DeviceCOO`` (f32 gather and segment
sum) or, under ``graph.aux.dense=on`` and within one model's shared
:class:`DenseBudget`, a bf16 ``DenseMat``. The joint user-item adjacency
is ``GraphRecommender.joint_adj`` (the dual kernel by default); BUIR's
dropout views ride the segment kernel (or a ``DeviceCOO`` under
``graph.backend=coo``), SEPT's augmented graph, which is not symmetric,
always a ``DeviceCOO``. Every model ranks through the fused top-k.

Each model's random inputs of a step come from its ``draw(generator)``
(MHCN's permutations, SEPT's group keeps, BUIR's edge keeps, DHCF's
dropout masks) and go into ``step_loss(batch, draws)``, so a caller can
inject other draws.

No step of the five reads the host, so they train ``train.chunk`` epochs
a dispatch (``TrainSpec.chunkable``): on a CUDA device one CUDA graph an
epoch, with MHCN's and SEPT's quick evaluation and vote inside (SEPT's two
phases share one tracker) and BUIR's target update after every step (the
target, a buffer, rolls back with the parameters).

All five train on a mesh (``parallel/mesh.py``). Every rank draws the same
numbers and holds every auxiliary operator whole, so the forward through
them is replicated (the JAX package leaves these products to GSPMD, no
Pallas route); the joint adjacency and BUIR's views are sharded over
``data`` as ``GraphRecommender.joint_adj`` and ``view_adjacency`` make
them. Each rank's loss is its share: a sum over a batch's rows takes this
data rank's rows (``batch_share``), a sum over user rows its block of them
(``row_share``: MHCN's mutual information, SEPT's neighbour
discrimination), and a term over a whole table is added on data rank 0
alone (``adds_table_terms``). The backward through a replicated
``DeviceCOO`` is linear in the cotangent, so the shares' gradients sum to
one process's; a ``DenseMat``'s rounds its result to bf16, so it sums the
shares over ``data`` first (``ops/spmm.DenseMatmul``).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from ..data.graph import joint_bipartite_coo
from ..errors import ConfigError
from ..ops.losses import _l2n, bpr_loss, unique_padded
from ..ops.spmm import (
    DenseMat,
    DeviceCOO,
    lightgcn_propagate,
    renormalize_vals,
    spmm,
    view_adjacency,
)
from ..runtime import trainer as T
from .base import GraphRecommender, SocialRecommender, TrainSpec


def _sym_norm(m: sp.spmatrix) -> sp.csr_matrix:
    rowsum = np.asarray(m.sum(axis=1)).ravel()
    d_inv = np.power(rowsum, -0.5, where=rowsum > 0, out=np.zeros_like(rowsum))
    d = sp.diags(d_inv)
    return (d @ m @ d).tocsr()


def _row_norm(m: sp.spmatrix) -> sp.csr_matrix:
    rowsum = np.asarray(m.sum(axis=1)).ravel()
    d_inv = np.power(rowsum, -1.0, where=rowsum > 0, out=np.zeros_like(rowsum))
    return (sp.diags(d_inv) @ m).tocsr()


# dense entries that one model's auxiliary matrices may hold in all (the
# JAX package's value: 64 M entries, 128 MB of bf16)
AUX_DENSE_LIMIT = 64_000_000


class DenseBudget:
    """Dense entries left for one model's auxiliary matrices: each
    ``aux_operator`` call takes its matrix's entries from the pool while
    they fit, and a matrix that does not fit falls to ``DeviceCOO``, so the
    order of the calls decides which (MHCN: h_s, h_j, h_p, r, then rᵀ)."""

    def __init__(self, total: int = AUX_DENSE_LIMIT):
        self.remaining = total

    def take(self, entries: int) -> bool:
        if entries <= self.remaining:
            self.remaining -= entries
            return True
        return False


def aux_operator(m: sp.spmatrix, budget: Optional[DenseBudget], mode: str, device, mesh=None):
    """The device operator of an auxiliary matrix (the JAX package's
    ``_dev``). ``mode`` is ``graph.aux.dense``: ``on`` makes a bf16
    ``DenseMat`` of every matrix within ``AUX_DENSE_LIMIT`` and the budget,
    ``off`` and ``auto`` a ``DeviceCOO``. The JAX package's ``auto`` goes
    dense on a TPU only, where a random gather runs at a small share of the
    memory rate; on a card ``auto`` takes its choice for every other
    device. Either is whole on every rank of a ``mesh``."""
    if mode not in ("auto", "on", "off"):
        raise ConfigError(f"graph.aux.dense must be auto|on|off, got {mode!r}")
    entries = m.shape[0] * m.shape[1]
    if mode == "on" and entries <= AUX_DENSE_LIMIT and (budget is None or budget.take(entries)):
        return DenseMat.from_scipy(m, device, mesh)
    return DeviceCOO.from_scipy(m, device)


def _l2(*xs: torch.Tensor) -> torch.Tensor:
    """tf.nn.l2_loss summed over ``xs``."""
    return sum(0.5 * (x**2).sum() for x in xs)


def _log_sigmoid_loss(x: torch.Tensor) -> torch.Tensor:
    return -torch.log(torch.sigmoid(x) + 1e-12)


def mhcn_channel_mim(em: torch.Tensor, edge: torch.Tensor, perms,
                     rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """MHCN's hierarchical mutual-information term of one channel
    (MHCN.py hierarchical_self_supervision; the JAX package's
    ``mhcn_channel_mim``): pairwise-ranking MIM between the gated users
    ``em`` and their propagation ``edge``, locally against row-shuffled
    rows and globally against the channel's mean readout. ``perms`` = (r1,
    (c2, r2), (c3, r3)): a row permutation, then two column-then-row
    permutations. ``rows`` = [start, stop) sums the term over those user
    rows only (a data rank's share on a mesh), all of them by default; the
    readout is the mean of every row."""
    r1, (c2, r2), (c3, r3) = perms
    a, b = rows if rows is not None else (0, em.shape[0])
    e, g = em[a:b], edge[a:b]
    pos = (e * g).sum(dim=1)
    neg1 = (em[r1[a:b]] * g).sum(dim=1)
    neg2 = (edge[:, c2][r2[a:b]] * e).sum(dim=1)
    local = (_log_sigmoid_loss(pos - neg1) + _log_sigmoid_loss(neg1 - neg2)).sum()
    graph = edge.mean(dim=0)
    pos_g = g @ graph
    neg_g = edge[:, c3][r3[a:b]] @ graph
    return local + _log_sigmoid_loss(pos_g - neg_g).sum()


def sept_neighbor_ssl(aug_n, friend_n, share_n, rec_n, um, ins_cnt: int,
                      rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """SEPT's pseudo-label neighbour discrimination (SEPT.py:220-268; the
    JAX package's ``sept_neighbor_ssl``): each view's softmax over its
    similarities to the augmented encoding labels the users, the other two
    views vote a top-``ins_cnt`` positive set, and an InfoNCE at temperature
    0.1 pulls each view's users to their voted neighbours. The inputs are
    row-normalized encodings of the batch's distinct users; ``um`` masks the
    pad slots (copies of user 0) out of the softmax, the top-k and the
    denominator, where they would take the positives. ``rows`` = [start,
    stop) sums the term over those users' rows only (a data rank's share
    on a mesh), all of them by default: a row's softmaxes, positives and
    InfoNCE read only its own similarities, and the columns (the augmented
    encodings and the pad mask) stay whole."""
    col_bias = torch.where(um > 0, 0.0, -1e30)[None, :]
    a, b = rows if rows is not None else (0, friend_n.shape[0])
    friend_n, share_n, rec_n, row_mask = friend_n[a:b], share_n[a:b], rec_n[a:b], um[a:b]

    def label_prob(emb):
        return torch.softmax(emb @ aug_n.T + col_bias, dim=1)

    p_social, p_share, p_rec = label_prob(friend_n), label_prob(share_n), label_prob(rec_n)

    def neighbor_dis(positive, emb):
        pos_scores = (emb[:, None, :] * aug_n[positive]).sum(dim=2)
        ttl = emb @ aug_n.T + col_bias
        pos_sum = torch.exp(pos_scores / 0.1).sum(dim=1)
        ttl_sum = torch.exp(ttl / 0.1).sum(dim=1)
        return -(row_mask * torch.log(pos_sum / ttl_sum + 1e-12)).sum()

    def top(p1, p2):
        return torch.topk((p1 + p2) / 2, ins_cnt, dim=1).indices

    return (
        neighbor_dis(top(p_share, p_rec), friend_n)
        + neighbor_dis(top(p_social, p_rec), share_n)
        + neighbor_dis(top(p_social, p_share), rec_n)
    )


def buir_pair_loss(q_u, q_i, t_u, t_i, w) -> torch.Tensor:
    """BUIR's symmetric cross-prediction loss (BUIR.py:128-143): each side's
    online prediction against the other side's momentum target, as a cosine
    distance of normalized rows, halved and weighted by ``w``."""
    loss = 1 - (_l2n(q_u) * _l2n(t_i)).sum(dim=1)
    loss = loss + 1 - (_l2n(q_i) * _l2n(t_u)).sum(dim=1)
    return (w * loss / 2).sum()


def _binary_interactions(data) -> sp.csr_matrix:
    """(U, I) 0/1 matrix of the training pairs (a duplicate counts once)."""
    y = sp.csr_matrix(
        (np.ones_like(data.train_u, dtype=np.float32), (data.train_u, data.train_i)),
        shape=(data.num_users, data.num_items),
    )
    y.data[:] = 1.0
    return y


def triangle_motifs(social, data):
    """``(s, yy, [a1, ..., a9])``: the binary (U, U) trust matrix s, the
    co-purchase counts yy = y yᵀ of the (U, I) rating matrix y (a duplicate
    rating counts twice) and the motif counts of MHCN.py:54-85 and
    ESRF.py:53-81, with b = s ∘ sᵀ the reciprocated links and u = s - b the
    one-way ones; a1-a7 the seven social triangle motifs, a8 and a9 the
    co-purchases over b and u (a9 not symmetrized: MHCN adds its transpose,
    ESRF does not)."""
    src, dst, _ = social.coo()
    s = sp.csr_matrix((np.ones(len(src), dtype=np.float32), (src, dst)),
                      shape=(data.num_users, data.num_users))
    y = sp.csr_matrix((np.ones_like(data.train_u, dtype=np.float32), (data.train_u, data.train_i)),
                      shape=(data.num_users, data.num_items))
    b = s.multiply(s.T)
    u = s - b
    c1 = (u @ u).multiply(u.T)
    a1 = c1 + c1.T
    c2 = (b @ u).multiply(u.T) + (u @ b).multiply(u.T) + (u @ u).multiply(b)
    a2 = c2 + c2.T
    c3 = (b @ b).multiply(u) + (b @ u).multiply(b) + (u @ b).multiply(b)
    a3 = c3 + c3.T
    a4 = (b @ b).multiply(b)
    c5 = (u @ u).multiply(u) + (u @ u.T).multiply(u) + (u.T @ u).multiply(u)
    a5 = c5 + c5.T
    a6 = (u @ b).multiply(u) + (b @ u.T).multiply(u.T) + (u.T @ u).multiply(b)
    a7 = (u.T @ b).multiply(u.T) + (b @ u).multiply(u) + (u @ u.T).multiply(b)
    yy = y @ y.T
    return s, yy, [a1, a2, a3, a4, a5, a6, a7, yy.multiply(b), yy.multiply(u)]


class _GraphModel(GraphRecommender):
    """What the five models share: construction with an optional trust
    graph, the auxiliary-matrix mode and the BPR-style rec loss; each
    builds its host matrices in ``build_graph`` (timed by
    ``prepare_graph``). All five train on a mesh (the module's docstring
    gives the rule of each loss term)."""

    track_best = False

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        self._init_gen = torch.Generator().manual_seed(self.seed)

    def read_configuration(self) -> None:
        super().read_configuration()
        self.aux_mode = self.config.get("graph.aux.dense", "auto")
        if self.aux_mode not in ("auto", "on", "off"):
            raise ConfigError(f"graph.aux.dense must be auto|on|off, got {self.aux_mode!r}")

    def _param(self, name: str, t: torch.Tensor) -> None:
        setattr(self, name, nn.Parameter(t))

    def _embeddings(self) -> None:
        for name, t in self.init_embeddings("normal").items():
            self._param(name, t)

    def _xavier(self, shape) -> torch.Tensor:
        """Glorot-uniform (the limit of ``jax.nn.initializers.glorot_uniform``
        for a 2-D shape), drawn on the CPU from the model's init generator."""
        t = torch.empty(shape, dtype=torch.float32)
        nn.init.xavier_uniform_(t, generator=self._init_gen)
        return t.to(self.device)

    @staticmethod
    def dot_loss(users, items, batch, reg_u: float) -> torch.Tensor:
        """DiffNet's and DHCF's ``-Σ w log σ(pos - neg)`` with the L2 of the
        batch rows scaled by ``w``."""
        u, i, j, w = batch
        pu, qi, qj = users[u], items[i], items[j]
        y = (pu * qi).sum(dim=1) - (pu * qj).sum(dim=1)
        loss = -(w * torch.log(torch.sigmoid(y) + 1e-12)).sum()
        wc = w[:, None]
        return loss + reg_u * (_l2(pu * wc) + _l2(qi * wc) + _l2(qj * wc))

    def loss(self, batch, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.step_loss(batch, self.draw(gen))

    def draw(self, gen: Optional[torch.Generator]):
        return None


class MHCN(SocialRecommender, _GraphModel):
    """Multi-channel hypergraph convolution with self-gating, channel
    attention and hierarchical mutual-information SSL (MHCN.py; the JAX
    package's ``MHCN``, ``models/social_graph.py:229-431``). Parameters:
    ``user_emb``, ``item_emb``, ``gating{c}``/``gating_bias{c}`` and
    ``sgating{c}``/``sgating_bias{c}`` (c = 0..3), ``attention`` (1, d) and
    ``attention_mat`` (d, d)."""

    track_best = True
    weight_keys = (
        [f"gating{c}" for c in range(4)] + [f"gating_bias{c}" for c in range(4)]
        + [f"sgating{c}" for c in range(4)] + [f"sgating_bias{c}" for c in range(4)]
        + ["attention", "attention_mat"]
    )

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        d = self.emb_size
        self._embeddings()
        for c in range(4):
            self._param(f"gating{c}", self._xavier((d, d)))
            self._param(f"gating_bias{c}", self._xavier((1, d)))
        for c in range(4):
            self._param(f"sgating{c}", self._xavier((d, d)))
            self._param(f"sgating_bias{c}", self._xavier((1, d)))
        self._param("attention", self._xavier((1, d)))
        self._param("attention_mat", self._xavier((d, d)))

    def read_configuration(self) -> None:
        super().read_configuration()
        args = self.model_args()
        self.n_layers = args.get_int("-n_layer")
        self.ss_rate = args.get_float("-ss_rate")

    def motif_matrices(self):
        """The triangle-motif algebra, cached on disk under the system's
        temporary directory by a hash of the interactions and relations (a
        one-time host cost of O(nnz · degree))."""
        key_src = np.concatenate(
            [self.data.train_u, self.data.train_i, self.social.src, self.social.dst]
        ).tobytes()
        digest = hashlib.sha1(key_src).hexdigest()[:16]
        cache = os.path.join(tempfile.gettempdir(), f"qrec_torch_motifs_{digest}.pkl")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)
        result = self.compute_motif_matrices()
        tmp = f"{cache}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, cache)
        return result

    def compute_motif_matrices(self):
        """(h_s, h_j, h_p), the algebra of MHCN.py:54-85 verbatim."""
        _, yy, (a1, a2, a3, a4, a5, a6, a7, a8, a9) = triangle_motifs(self.social, self.data)
        a9 = a9 + a9.T
        a10 = yy - a8 - a9
        h_s = _row_norm(a1 + a2 + a3 + a4 + a5 + a6 + a7)
        h_j = _row_norm(a8 + a9)
        h_p = _row_norm(a10.multiply(a10 > 1))
        return h_s, h_j, h_p

    def joint_r(self) -> sp.csr_matrix:
        """(U, I) with r / sqrt(|I_u|) / sqrt(|U_i|) (MHCN.py:46-52)."""
        du = np.maximum(np.diff(self.data.u_indptr), 1).astype(np.float32)
        di = np.maximum(np.diff(self.data.i_indptr), 1).astype(np.float32)
        d = self.data
        vals = d.train_r / np.sqrt(du[d.train_u]) / np.sqrt(di[d.train_i])
        return sp.csr_matrix((vals, (d.train_u, d.train_i)), shape=(self.num_users, self.num_items))

    def build_graph(self) -> None:
        budget = DenseBudget()
        aux = lambda m: aux_operator(m, budget, self.aux_mode, self.device, self.mesh)  # noqa: E731
        self.h_s, self.h_j, self.h_p = (aux(m) for m in self.motif_matrices())
        r = self.joint_r()
        self.r_op = aux(r)
        self.rt_op = aux(r.T)

    def gate(self, em, c: int, s: str = "") -> torch.Tensor:
        return em * torch.sigmoid(em @ getattr(self, f"{s}gating{c}") + getattr(self, f"{s}gating_bias{c}"))

    def channel_attention(self, *chans) -> torch.Tensor:
        scores = torch.stack(
            [(self.attention * (c @ self.attention_mat)).sum(dim=1) for c in chans], dim=1
        )
        score = torch.softmax(scores, dim=1)
        return sum(score[:, k : k + 1] * chans[k] for k in range(len(chans)))

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(users (U, d), items (I, d)) after ``n_layers`` of the three
        hypergraph channels, the simple channel and the item propagation."""
        u1, u2, u3 = (self.gate(self.user_emb, c) for c in range(3))
        simple = self.gate(self.user_emb, 3)
        items = self.item_emb
        acc1, acc2, acc3, acc_s, acc_i = u1, u2, u3, simple, items
        for _ in range(self.n_layers):
            mixed = self.channel_attention(u1, u2, u3) + simple / 2
            u1 = spmm(self.h_s, u1)
            acc1 = acc1 + _l2n(u1)
            u2 = spmm(self.h_j, u2)
            acc2 = acc2 + _l2n(u2)
            u3 = spmm(self.h_p, u3)
            acc3 = acc3 + _l2n(u3)
            new_items = spmm(self.rt_op, mixed)
            acc_i = acc_i + _l2n(new_items)
            simple = spmm(self.r_op, items)
            acc_s = acc_s + _l2n(simple)
            items = new_items
        return self.channel_attention(acc1, acc2, acc3) + acc_s / 2, acc_i

    def draw(self, gen: torch.Generator):
        """The step's random inputs: for each of the three channels, a row
        permutation and two (column, row) permutation pairs."""
        perm = lambda n: torch.randperm(n, generator=gen, device=self.device)  # noqa: E731
        u, d = self.num_users, self.emb_size
        return [(perm(u), (perm(d), perm(u)), (perm(d), perm(u))) for _ in range(3)]

    def step_loss(self, batch, perms) -> torch.Tensor:
        """On a mesh this data rank's share: the BPR term over its rows of
        the batch, the mutual information over its block of the user rows,
        and the L2 of the weights and tables, which is no sum over rows, on
        data rank 0 alone."""
        u, i, j, w = self.batch_share(batch)
        users, items = self()
        pu, qi, qj = users[u], items[i], items[j]
        loss = bpr_loss((pu * qi).sum(dim=1), (pu * qj).sum(dim=1), w)
        if self.adds_table_terms:
            reg = 0.001 * sum(_l2(getattr(self, k)) for k in self.weight_keys)
            loss = loss + (reg + self.reg_u * (_l2(self.user_emb) + _l2(self.item_emb)))
        rows = self.row_share(self.num_users)
        ss = 0.0
        for c, h in enumerate((self.h_s, self.h_j, self.h_p)):
            em = self.gate(users, c, "s")
            ss = ss + mhcn_channel_mim(em, spmm(h, em), perms[c], rows)
        return loss + self.ss_rate * ss

    def build(self) -> TrainSpec:
        self.prepare_graph()
        return TrainSpec(list(self.parameters()), self.loss, self.pairwise_sampler(),
                         score_params_fn=self.forward, track_best=True, chunkable=True)


class SEPT(SocialRecommender, _GraphModel):
    """Tri-view social SSL with pseudo-label neighbour discrimination
    (SEPT.py; the JAX package's ``SEPT``, ``models/social_graph.py:433-607``):
    ``max(1, max_epoch // 3)`` epochs of the rec loss alone, then the joint
    loss, with one best-epoch tracker over both phases. The friend and
    sharing views are auxiliary operators, the rec view the joint
    adjacency; the augmented view drops whole interactions and social edges
    (one keep flag per group) from the combined user-item and directed
    social graph and renormalizes it every step."""

    track_best = True

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        for name, rows in (("user_emb", self.num_users), ("item_emb", self.num_items)):
            t = torch.empty((rows, self.emb_size), dtype=torch.float32)
            # truncated normal at ±2σ, σ = 0.005 / 2
            nn.init.trunc_normal_(t, std=0.0025, a=-0.005, b=0.005, generator=self._init_gen)
            self._param(name, t.to(self.device))

    def read_configuration(self) -> None:
        super().read_configuration()
        args = self.model_args()
        self.n_layers = args.get_int("-n_layer")
        self.ss_rate = args.get_float("-ss_rate")
        self.drop_rate = args.get_float("-drop_rate")
        self.instance_cnt = args.get_int("-ins_cnt")

    def views(self):
        """(social, sharing) user-user views, symmetric-normalized."""
        src, dst, _ = self.social.coo()
        s = sp.csr_matrix(
            (np.ones(len(src), dtype=np.float32), (src, dst)),
            shape=(self.num_users, self.num_users),
        )
        bs = s.multiply(s)  # the reference's literal "bidirectional" matrix
        y = _binary_interactions(self.data)
        eye = sp.eye(self.num_users, dtype=np.float32)
        social = (bs @ bs).multiply(bs) + eye
        sharing = (y @ y.T).multiply(bs) + eye
        return _sym_norm(social), _sym_norm(sharing)

    def combined_graph(self):
        """(rows, cols, group ids, groups, nodes): the joint user-item
        structure and the directed social edges, lexsorted; both directions
        of an interaction share its group, each social edge is its own
        (SEPT.py:80-113)."""
        rows, cols, edge_ids, n = joint_bipartite_coo(self.data)
        src, dst, _ = self.social.coo()
        n_int = int(edge_ids.max()) + 1 if len(edge_ids) else 0
        rows_c = np.concatenate([rows, src])
        cols_c = np.concatenate([cols, dst])
        ids_c = np.concatenate([edge_ids, n_int + np.arange(len(src), dtype=np.int32)])
        order = np.lexsort((cols_c, rows_c))
        return (rows_c[order].astype(np.int32), cols_c[order].astype(np.int32),
                ids_c[order].astype(np.int64), n_int + len(src), n)

    def build_graph(self) -> None:
        budget = DenseBudget()
        self.social_op, self.sharing_op = (
            aux_operator(m, budget, self.aux_mode, self.device, self.mesh) for m in self.views()
        )
        self.joint_adj
        rows, cols, ids, self.n_groups, n = self.combined_graph()
        self.aug_structure = view_adjacency(rows, cols, n, self.device, "coo")
        self.aug_groups = torch.as_tensor(ids, device=self.device)

    def encode_views(self):
        """(friend (U, d), sharing (U, d), users (U, d), items (I, d))."""
        friend = share = self.user_emb
        acc_f, acc_s = friend, share
        ego = torch.cat([self.user_emb, self.item_emb])
        acc_e = ego
        for _ in range(self.n_layers):
            friend = spmm(self.social_op, friend)
            acc_f = acc_f + _l2n(friend)
            share = spmm(self.sharing_op, share)
            acc_s = acc_s + _l2n(share)
            ego = spmm(self.joint_adj, ego)
            acc_e = acc_e + _l2n(ego)
        nu = self.num_users
        return acc_f, acc_s, acc_e[:nu], acc_e[nu:]

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        _, _, users, items = self.encode_views()
        return users, items

    def encode_aug(self, keep: torch.Tensor) -> torch.Tensor:
        """Users of the augmented view whose groups ``keep`` (bool, one per
        group) holds, renormalized."""
        adj = self.aug_structure
        vals = renormalize_vals(adj.rows, adj.cols, keep[self.aug_groups].float(), adj.num_rows)
        e = torch.cat([self.user_emb, self.item_emb])
        acc = e
        for _ in range(self.n_layers):
            e = spmm(adj, e, vals)
            acc = acc + _l2n(e)
        return acc[: self.num_users]

    def _rec(self, users, items, batch) -> torch.Tensor:
        """BPR over the batch's rows (this data rank's on a mesh) and the
        tables' L2 (data rank 0 alone on a mesh)."""
        u, i, j, w = self.batch_share(batch)
        pu, qi, qj = users[u], items[i], items[j]
        rec = bpr_loss((pu * qi).sum(dim=1), (pu * qj).sum(dim=1), w)
        if not self.adds_table_terms:
            return rec
        return rec + self.reg_u * (_l2(self.user_emb) + _l2(self.item_emb))

    def rec_loss(self, batch, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """The warm-up phase's loss (no random input)."""
        _, _, users, items = self.encode_views()
        return self._rec(users, items, batch)

    def draw(self, gen: torch.Generator) -> torch.Tensor:
        """The joint step's random input: a Bernoulli(1 - drop_rate) keep
        flag per group of the combined graph."""
        return torch.rand(self.n_groups, generator=gen, device=self.device) < 1.0 - self.drop_rate

    def step_loss(self, batch, keep) -> torch.Tensor:
        """The joint phase's loss. The distinct users come from the WHOLE
        batch, the same set on every rank of a mesh (splitting the batch
        first would change the set, and so the function); each data rank
        sums the neighbour discrimination over its block of them."""
        friend, share, users, items = self.encode_views()
        rec = self._rec(users, items, batch)
        aug_u = self.encode_aug(keep)
        uu, um = unique_padded(batch[0])
        ssl = sept_neighbor_ssl(
            _l2n(aug_u[uu]), _l2n(friend[uu]), _l2n(share[uu]), _l2n(users[uu]), um,
            self.instance_cnt, self.row_share(len(uu)),
        )
        return rec + self.ss_rate * ssl

    def fit_phases(self) -> None:
        """The warm-up, then the joint phase, one tracker over both: the
        joint phase's device vote (a chunked run's) is seeded from what the
        warm-up wrote back, its epochs numbered after the warm-up's."""
        self.prepare_graph()
        spec = TrainSpec(list(self.parameters()), self.loss, self.pairwise_sampler(),
                         score_params_fn=self.forward, track_best=True, chunkable=True)
        quick_eval = eval_vector = None
        tracker = None
        if self._quick_ranker() is not None:
            quick_eval = lambda: self.quick_eval(spec)  # noqa: E731
            eval_vector = lambda: self.quick_eval_vector(spec)  # noqa: E731
            tracker = T.BestTracker()
        warm = max(1, int(self.max_epoch / 3))
        self.run_training(spec.params, self.rec_loss, spec.sampler, track_best=True,
                          max_epoch=warm, quick_eval=quick_eval, tracker=tracker,
                          return_best=False, chunkable=True, eval_vector=eval_vector)
        self.run_training(spec.params, self.loss, spec.sampler, track_best=True,
                          max_epoch=max(1, self.max_epoch - warm), quick_eval=quick_eval,
                          tracker=tracker, chunkable=True, eval_vector=eval_vector)
        self.finalize(spec)


class BUIR(_GraphModel):
    """Bootstrapped user-item representations (BUIR.py; the JAX package's
    ``BUIR``, ``models/social_graph.py:609-723``): an online LightGCN encoder
    with a tanh predictor and a momentum target encoder, each over its own
    edge-dropout view of the joint graph, trained on the symmetric cosine
    loss with the target updated after every step (``target ← τ·target +
    (1-τ)·online``). The final scores are ``q_i·o_u + o_i·q_u``, ranked as
    the pair (o_u‖q_u, q_i‖o_i). Parameters: ``user_emb``, ``item_emb``
    (glorot), ``W`` (d, d), ``b`` (1, d); buffers ``target.user_emb``,
    ``target.item_emb``."""

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        d = self.emb_size
        self._param("user_emb", self._xavier((self.num_users, d)))
        self._param("item_emb", self._xavier((self.num_items, d)))
        self._param("W", self._xavier((d, d)))
        self._param("b", self._xavier((1, d)))
        self.target = nn.Module()
        self.target.register_buffer("user_emb", self.user_emb.detach().clone())
        self.target.register_buffer("item_emb", self.item_emb.detach().clone())

    def read_configuration(self) -> None:
        super().read_configuration()
        args = self.model_args()
        self.n_layers = args.get_int("-n_layer")
        self.tau = args.get_float("-tau")
        self.drop_rate = args.get_float("-drop_rate")

    def build_graph(self) -> None:
        """The views' structure (on a mesh the row blocks of the segment
        kernel, or a whole ``DeviceCOO`` under ``coo``), with every edge's
        (rows, cols) kept on the model: a row block holds no rows, and each
        view's values are renormalized over every edge."""
        rows, cols, edge_ids, n = joint_bipartite_coo(self.data)
        backend = self.config.get("graph.backend", "auto")
        self.view_adj = view_adjacency(rows, cols, n, self.device, backend, self.mesh)
        as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.view_edges = (as_t(rows), as_t(cols))
        self.edge_ids = torch.as_tensor(edge_ids.astype(np.int64), device=self.device)
        self.n_edges = len(self.data.csr_sel)
        self.joint_adj

    def dropped_propagate(self, emb_u, emb_i, keep) -> torch.Tensor:
        adj = self.view_adj
        vals = renormalize_vals(*self.view_edges, keep[self.edge_ids].float(), adj.num_rows)
        return lightgcn_propagate(adj, torch.cat([emb_u, emb_i]), self.n_layers, vals)

    def predict(self, e: torch.Tensor) -> torch.Tensor:
        return torch.tanh(e @ self.W + self.b)

    def draw(self, gen: torch.Generator):
        """The step's random inputs: a keep flag per interaction for the
        online view, then one for the target view."""
        keep = 1.0 - self.drop_rate
        return tuple(torch.rand(self.n_edges, generator=gen, device=self.device) < keep
                     for _ in range(2))

    def step_loss(self, batch, draws) -> torch.Tensor:
        """The cosine loss over the batch's rows (this data rank's on a
        mesh); both views propagate whole on every rank."""
        u, i, _, w = self.batch_share(batch)
        keep_o, keep_t = draws
        nu = self.num_users
        online = self.dropped_propagate(self.user_emb, self.item_emb, keep_o)
        with torch.no_grad():
            tgt = self.dropped_propagate(self.target.user_emb, self.target.item_emb, keep_t)
        q = self.predict(online)
        return buir_pair_loss(q[:nu][u], q[nu:][i], tgt[:nu][u], tgt[nu:][i], w)

    @torch.no_grad()
    def update_target(self) -> None:
        for name in ("user_emb", "item_emb"):
            t = getattr(self.target, name)
            t.copy_(t * self.tau + getattr(self, name) * (1 - self.tau))

    def _emit(self, epoch: int, loss: float, lr: float, wall: float,
              metrics: Optional[dict] = None, eval_fused: bool = False) -> None:
        """Every fifth epoch and the last (BUIR.py's print)."""
        if (epoch + 1) % 5 == 0 or epoch == self.max_epoch - 1:
            print(f"{self.model_name} {self.fold} epoch {epoch + 1}: loss = {loss:.4f}")

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(o_u‖q_u, q_i‖o_i) from the online encoder on the full graph."""
        nu = self.num_users
        online = lightgcn_propagate(self.joint_adj, torch.cat([self.user_emb, self.item_emb]),
                                    self.n_layers)
        q = self.predict(online)
        return (torch.cat([online[:nu], q[:nu]], dim=1),
                torch.cat([q[nu:], online[nu:]], dim=1))

    def fit_phases(self) -> None:
        """One phase, ``train.chunk`` epochs a dispatch (the JAX package's
        one jitted scan an epoch, read every fifth epoch): on a card one
        CUDA graph an epoch, the target's update after every step inside
        it and the target rolled back with the parameters."""
        self.prepare_graph()
        params = [self.user_emb, self.item_emb, self.W, self.b]
        self.run_training(params, self.loss, self.pairwise_sampler(),
                          after_step=self.update_target, chunkable=True)
        self.finalize(TrainSpec(params, self.loss, None, score_params_fn=self.forward))


class DiffNet(SocialRecommender, _GraphModel):
    """Social influence diffusion (DiffNet.py; the JAX package's
    ``DiffNet``, ``models/social_graph.py:726-802``): users diffused over the
    out-degree-normalized trust matrix through concat + W + ReLU layers, the
    final user the diffused one plus the row-normalized ratings times the
    items. Parameters: ``user_emb``, ``item_emb``, ``W{k}`` (2d, d)."""

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        self._embeddings()
        for k in range(self.n_layers):
            self._param(f"W{k}", self._xavier((2 * self.emb_size, self.emb_size)))

    def read_configuration(self) -> None:
        super().read_configuration()
        self.n_layers = self.model_args().get_int("-n_layer")

    def build_graph(self) -> None:
        src, dst, _ = self.social.coo()
        out_deg = np.bincount(src, minlength=self.num_users).astype(np.float32)
        s_mat = sp.csr_matrix(
            (1.0 / np.maximum(out_deg[src], 1), (src, dst)), shape=(self.num_users, self.num_users)
        )
        du = np.maximum(np.diff(self.data.u_indptr), 1).astype(np.float32)
        d = self.data
        a_mat = sp.csr_matrix(
            (1.0 / du[d.train_u], (d.train_u, d.train_i)), shape=(self.num_users, self.num_items)
        )
        budget = DenseBudget()
        self.s_op = aux_operator(s_mat, budget, self.aux_mode, self.device, self.mesh)
        self.a_op = aux_operator(a_mat, budget, self.aux_mode, self.device, self.mesh)

    def encode(self) -> torch.Tensor:
        u = self.user_emb
        for k in range(self.n_layers):
            u = F.relu(torch.cat([spmm(self.s_op, u), u], dim=1) @ getattr(self, f"W{k}"))
        return u + spmm(self.a_op, self.item_emb)

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encode(), self.item_emb.detach()

    def step_loss(self, batch, draws=None) -> torch.Tensor:
        """Every term a sum over the batch's rows (this data rank's on a
        mesh)."""
        return self.dot_loss(self.encode(), self.item_emb, self.batch_share(batch), self.reg_u)

    def build(self) -> TrainSpec:
        self.prepare_graph()
        return TrainSpec(list(self.parameters()), self.loss, self.pairwise_sampler(),
                         score_params_fn=self.forward, chunkable=True)


class DHCF(_GraphModel):
    """Dual-channel hypergraph CF (DHCF.py; the JAX package's ``DHCF``,
    ``models/social_graph.py:804-893``): the user and item hypergraphs
    ``D_v^-1/2 H D_e^-1 Hᵀ D_v^-1/2`` of the rating matrix, residual
    transforms with leaky ReLU, message dropout (keep 0.9) on every layer
    while training and the L2-normalized layers concatenated (width 3d).
    Parameters: ``user_emb``, ``item_emb``,
    ``layer{k}`` (d, d)."""

    n_layers = 2  # fixed in the reference (DHCF.py:58)
    keep_prob = 0.9

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        self._embeddings()
        for k in range(self.n_layers):
            self._param(f"layer{k}", self._xavier((self.emb_size, self.emb_size)))

    @staticmethod
    def hyper_norm(h: sp.spmatrix) -> sp.csr_matrix:
        d_v = np.asarray(h.sum(axis=1)).ravel()
        d_e = np.asarray(h.sum(axis=0)).ravel()
        dv = sp.diags(np.power(d_v, -0.5, where=d_v > 0, out=np.zeros_like(d_v)))
        de = sp.diags(np.power(d_e, -1.0, where=d_e > 0, out=np.zeros_like(d_e)))
        return (dv @ h @ de @ h.T @ dv).tocsr()

    def build_graph(self) -> None:
        a = _binary_interactions(self.data)
        budget = DenseBudget()
        mesh = self.mesh
        self.a_u = aux_operator(self.hyper_norm(a), budget, self.aux_mode, self.device, mesh)
        self.a_i = aux_operator(self.hyper_norm(a.T.tocsr()), budget, self.aux_mode, self.device,
                                mesh)

    def encode(self, masks: Optional[Sequence] = None):
        """(users (U, 3d), items (I, 3d)); ``masks`` holds a (U, d) and an
        (I, d) bool keep mask per layer, None for no dropout (scoring)."""
        u, v = self.user_emb, self.item_emb
        all_u, all_v = [u], [v]
        for k in range(self.n_layers):
            # every layer propagates the base embeddings, each its own
            # product as in the JAX package: a DenseMat rounds each
            # product's gradient to bf16 before the two are added
            new_u, new_v = spmm(self.a_u, self.user_emb), spmm(self.a_i, self.item_emb)
            w = getattr(self, f"layer{k}")
            u = F.leaky_relu(new_u @ w + u, negative_slope=0.01)
            v = F.leaky_relu(new_v @ w + v, negative_slope=0.01)
            if masks is not None:
                mu, mv = masks[k]
                u = torch.where(mu, u / self.keep_prob, torch.zeros_like(u))
                v = torch.where(mv, v / self.keep_prob, torch.zeros_like(v))
            u, v = _l2n(u), _l2n(v)
            all_u.append(u)
            all_v.append(v)
        return torch.cat(all_u, dim=1), torch.cat(all_v, dim=1)

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encode(None)

    def draw(self, gen: torch.Generator) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The step's random inputs: Bernoulli(0.9) (U, d) and (I, d) masks
        per layer."""
        rand = lambda n: torch.rand((n, self.emb_size), generator=gen, device=self.device)  # noqa: E731
        return [(rand(self.num_users) < self.keep_prob, rand(self.num_items) < self.keep_prob)
                for _ in range(self.n_layers)]

    def step_loss(self, batch, masks) -> torch.Tensor:
        """The batch's terms over its rows (this data rank's on a mesh), the
        layers' L2 on data rank 0 alone; the dropout masks are whole and the
        same on every rank."""
        users, items = self.encode(masks)
        loss = self.dot_loss(users, items, self.batch_share(batch), self.reg_u)
        if not self.adds_table_terms:
            return loss
        return loss + self.reg_u * sum(_l2(getattr(self, f"layer{k}")) for k in range(self.n_layers))

    def build(self) -> TrainSpec:
        self.prepare_graph()
        return TrainSpec(list(self.parameters()), self.loss, self.pairwise_sampler(),
                         score_params_fn=self.forward, chunkable=True)
