"""Graph CF family: LightGCN, SGL and SimGCL (reference
model/ranking/LightGCN.py, SGL.py, SimGCL.py; the JAX package's
``models/graph.py``).

Every propagation, of the main graph and of SGL's augmented views, runs
through the joint operator on the dual kernel (``ops/spmm.joint_matmul``);
the contrastive losses run on the InfoNCE kernels
(``ops/losses.infonce_dispatch``). As in the JAX package, SGL's views and
SimGCL's noise are drawn afresh for every step, from the trainer's
generator.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.losses import bpr_loss, check_ssl_backend, infonce_dispatch, unique_padded
from ..ops.spmm import (
    factored_edge_drop_view,
    factored_node_drop_view,
    joint_matmul,
    lightgcn_propagate,
)
from .base import GraphRecommender, TrainSpec


def _l2(x: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tf.nn.l2_loss semantics: sum(x**2)/2 (optionally row-weighted)."""
    if w is None:
        return 0.5 * (x**2).sum()
    return 0.5 * (w[:, None] * x**2).sum()


def _rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]`` for the contrastive batches of ``unique_padded``, whose
    pad slots repeat one id hundreds of times. ``index_select``'s backward
    adds rows with atomics; advanced indexing's sorts the ids and walks
    each run of duplicates serially, which took more device time per
    SimGCL epoch than the dual kernel on an H100. The pad rows' gradients
    are exactly zero, so the atomic order cannot change a sum."""
    return x.index_select(0, ids)


class LightGCN(GraphRecommender):
    """K-layer linear propagation with layer-mean readout + BPR
    (LightGCN.py:11-41). Parameters: ``user_emb`` (U, d), ``item_emb`` (I, d)."""

    track_best = False

    def __init__(self, conf, data, fold: str = "[1]", device="cpu"):
        super().__init__(conf, data, fold=fold, device=device)
        init = self.init_embeddings()
        self.user_emb = nn.Parameter(init["user_emb"])
        self.item_emb = nn.Parameter(init["item_emb"])

    def read_configuration(self) -> None:
        super().read_configuration()
        args = self.model_args()
        self.n_layers = args.get_int("-n_layer", 2) if args else 2

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Propagated (users (U, d), items (I, d))."""
        ego = torch.cat([self.user_emb, self.item_emb])
        out = lightgcn_propagate(self.joint_adj, ego, self.n_layers)
        return out[: self.num_users], out[self.num_users :]

    def rec_loss(self, users, items, batch) -> torch.Tensor:
        """BPR on the batch's (user, pos, neg) triples + their L2."""
        u, i, j, w = batch
        pu, qi, qj = users[u], items[i], items[j]
        pos = (pu * qi).sum(dim=1)
        neg = (pu * qj).sum(dim=1)
        reg = self.reg_u * (_l2(pu, w) + _l2(qi, w) + _l2(qj, w))
        return bpr_loss(pos, neg, w) + reg

    def loss(self, batch, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.rec_loss(*self(), batch)

    def build(self) -> TrainSpec:
        return TrainSpec(
            [self.user_emb, self.item_emb],
            self.loss,
            self.pairwise_sampler(),
            score_params_fn=self.forward,
            track_best=self.track_best,
        )


class SGL(LightGCN):
    """Self-supervised graph learning: LightGCN + two node- or edge-dropped
    views of the graph + merged-batch InfoNCE (SGL.py), on the factored
    dense adjacency only (the JAX package's ``dense_views`` branch).

    A view keeps the binary R and changes its scales (node drop, aug type
    0) or masks R's edges with a pair hash (edge drop, aug type 1; aug type
    2 draws a fresh edge view per layer), then propagates through the dual
    kernel like the main graph (``ops/spmm.factored_*_view``)."""

    track_best = True

    def read_configuration(self) -> None:
        super().read_configuration()
        args = self.model_args()
        self.ssl_reg = args.get_float("-lambda")
        self.drop_rate = args.get_float("-droprate")
        self.aug_type = args.get_int("-augtype")
        self.ssl_temp = args.get_float("-temp")
        self.n_layers = args.get_int("-n_layer")
        check_ssl_backend(self.config)

    @property
    def edges(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, cols) of R's nonzeros, row-major."""
        if not hasattr(self, "_edges"):
            self._edges = torch.nonzero(self.joint_adj.r, as_tuple=True)
        return self._edges

    def draw_view(self, gen: torch.Generator) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """One view's random inputs: (keep_u, keep_i) bool node draws for
        aug type 0; uniform 32-bit (ru, ci) hash inputs, held in int64, for
        edge drop, one pair per layer for aug type 2."""
        u, i, dev = self.num_users, self.num_items, self.device
        if self.aug_type == 0:
            keep = 1.0 - self.drop_rate
            return [(torch.rand(u, generator=gen, device=dev) < keep,
                     torch.rand(i, generator=gen, device=dev) < keep)]
        draws = self.n_layers if self.aug_type == 2 else 1
        return [
            (torch.randint(0, 2**32, (u,), generator=gen, device=dev, dtype=torch.int64),
             torch.randint(0, 2**32, (i,), generator=gen, device=dev, dtype=torch.int64))
            for _ in range(draws)
        ]

    def draw(self, gen: torch.Generator):
        """The step's random inputs: both views'."""
        return self.draw_view(gen), self.draw_view(gen)

    def encode_view(self, bits) -> Tuple[torch.Tensor, torch.Tensor]:
        adj = self.joint_adj
        if self.aug_type == 0:
            views = [factored_node_drop_view(adj, *bits[0])] * self.n_layers
        else:
            views = [factored_edge_drop_view(adj, self.edges, ru, ci, self.drop_rate)
                     for ru, ci in bits]
            views = views * (self.n_layers // len(views))
        e = torch.cat([self.user_emb, self.item_emb])
        acc = e
        for view in views:
            e = joint_matmul(view, e)
            acc = acc + e
        out = acc / (self.n_layers + 1)
        return out[: self.num_users], out[self.num_users :]

    def step_loss(self, batch, draws) -> torch.Tensor:
        u, i, _, _ = batch
        rec = self.rec_loss(*self(), batch)
        s1u, s1i = self.encode_view(draws[0])
        s2u, s2i = self.encode_view(draws[1])
        uu, um = unique_padded(u)
        iu, im = unique_padded(i)
        merge1 = torch.cat([_rows(s1u, uu), _rows(s1i, iu)])
        merge2 = torch.cat([_rows(s2u, uu), _rows(s2i, iu)])
        mask = torch.cat([um, im])
        return rec + self.ssl_reg * infonce_dispatch(merge1, merge2, mask, self.ssl_temp)

    def loss(self, batch, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.step_loss(batch, self.draw(gen))


class SimGCL(LightGCN):
    """LightGCN with uniform-noise-perturbed contrastive encoders
    (SimGCL.py:22-111). Noise: e += sign(e) * ε * l2norm(U(0,1)) per layer.

    The readout averages the K propagated layers WITHOUT the ego layer
    (SimGCL.py:22-28). The main encoder and both perturbed ones share the
    first propagation and then run as one (N, 3d) stream, one dual-kernel
    call per layer (the JAX package's ``encode_all``)."""

    cl_temp = 0.2  # hard-coded in the reference (SimGCL.py:74-77)
    track_best = True

    def read_configuration(self) -> None:
        super().read_configuration()
        args = self.model_args()
        self.cl_rate = args.get_float("-lambda")
        self.eps = args.get_float("-eps")
        self.n_layers = args.get_int("-n_layer")
        check_ssl_backend(self.config)

    def init_embeddings(self) -> dict:
        """Xavier/glorot uniform (SimGCL.py:42-44), drawn on the CPU from
        ``seed``."""
        gen = torch.Generator().manual_seed(self.seed)
        out = {}
        for name, rows in (("user_emb", self.num_users), ("item_emb", self.num_items)):
            t = torch.empty((rows, self.emb_size), dtype=torch.float32)
            nn.init.xavier_uniform_(t, generator=gen)
            out[name] = t.to(self.device)
        return out

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Main encoder: mean of the K propagated layers, no ego layer."""
        e = torch.cat([self.user_emb, self.item_emb])
        acc = None
        for _ in range(self.n_layers):
            e = joint_matmul(self.joint_adj, e)
            acc = e if acc is None else acc + e
        out = acc / self.n_layers
        return out[: self.num_users], out[self.num_users :]

    def draw(self, gen: torch.Generator) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The step's random inputs: U(0, 1) noise of shape (N, d) for each
        layer, for the two perturbed encoders."""
        shape = (self.num_users + self.num_items, self.emb_size)
        return [
            (torch.rand(shape, generator=gen, device=self.device),
             torch.rand(shape, generator=gen, device=self.device))
            for _ in range(self.n_layers)
        ]

    def _perturb(self, e: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        noise = noise / (torch.linalg.vector_norm(noise, dim=1, keepdim=True) + 1e-12)
        return e + torch.sign(e) * noise * self.eps

    def encode_all(self, noise: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        """[(users, items)] of the main encoder and the two perturbed ones."""
        d = self.emb_size
        z = joint_matmul(self.joint_adj, torch.cat([self.user_emb, self.item_emb]))
        states = [z, self._perturb(z, noise[0][0]), self._perturb(z, noise[0][1])]
        accs = list(states)
        for k in range(1, self.n_layers):
            zs = joint_matmul(self.joint_adj, torch.cat(states, dim=1)).split(d, dim=1)
            states = [zs[0], self._perturb(zs[1], noise[k][0]), self._perturb(zs[2], noise[k][1])]
            accs = [a + s for a, s in zip(accs, states)]
        nu = self.num_users
        return [(o[:nu], o[nu:]) for o in (a / self.n_layers for a in accs)]

    def step_loss(self, batch, noise) -> torch.Tensor:
        u, i, _, _ = batch
        (users, items), (p1u, p1i), (p2u, p2i) = self.encode_all(noise)
        rec = self.rec_loss(users, items, batch)
        uu, um = unique_padded(u)
        iu, im = unique_padded(i)
        cl = infonce_dispatch(_rows(p1u, uu), _rows(p2u, uu), um, self.cl_temp)
        cl = cl + infonce_dispatch(_rows(p1i, iu), _rows(p2i, iu), im, self.cl_temp)
        return rec + self.cl_rate * cl

    def loss(self, batch, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.step_loss(batch, self.draw(gen))
