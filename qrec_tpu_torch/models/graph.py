"""Graph CF family: LightGCN, NGCF, SGL and SimGCL (reference
model/ranking/LightGCN.py, NGCF.py, SGL.py, SimGCL.py; the JAX package's
``models/graph.py``).

Every propagation, of the main graph and of SGL's augmented views, runs
through ``ops/spmm.spmm``: on the dual kernel over the factored dense
adjacency, or on the segment kernel over the sparse one
(``GraphRecommender.joint_adj`` picks); the contrastive losses run on the
InfoNCE kernels (``ops/losses.infonce_dispatch``). As in the JAX package,
SGL's views, SimGCL's noise and NGCF's message dropout are drawn afresh for
every step, from the trainer's generator. All four train on a mesh
(``parallel/mesh.py``): the adjacency, SGL's views of it and the InfoNCE
are sharded over ``data`` (``GraphRecommender.joint_adj``), every rank
draws the same numbers, and each rank's loss is its share.

No step reads the host, so the four train ``train.chunk`` epochs a
dispatch (``TrainSpec.chunkable``): on a CUDA device one CUDA graph an
epoch, whose draws replay from the trainer's generator, with SimGCL's and
SGL's quick evaluation and vote inside (``runtime/trainer.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.graph import joint_bipartite_coo
from ..ops.losses import bpr_loss, check_ssl_backend, infonce_dispatch, unique_padded
from ..ops.spmm import (
    DenseJoint,
    ShardedDenseJoint,
    factored_edge_drop_view,
    factored_node_drop_view,
    lightgcn_propagate,
    spmm,
    subgraph_vals,
    view_adjacency,
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

    def __init__(self, conf, data, fold: str = "[1]", device=None):
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
        """BPR on the batch's (user, pos, neg) triples + their L2: sums over
        the rows, so on a mesh this data rank's rows (``batch_share``)."""
        u, i, j, w = self.batch_share(batch)
        pu, qi, qj = users[u], items[i], items[j]
        pos = (pu * qi).sum(dim=1)
        neg = (pu * qj).sum(dim=1)
        reg = self.reg_u * (_l2(pu, w) + _l2(qi, w) + _l2(qj, w))
        return bpr_loss(pos, neg, w) + reg

    def loss(self, batch, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.rec_loss(*self(), batch)

    def prepare_graph(self) -> None:
        """Build the adjacency on the host and the device before training,
        as the JAX package's ``build`` does: set-up, not epoch 1's time."""
        self.joint_adj

    def build(self) -> TrainSpec:
        self.prepare_graph()
        return TrainSpec(
            list(self.parameters()),
            self.loss,
            self.pairwise_sampler(),
            score_params_fn=self.forward,
            track_best=self.track_best,
            chunkable=True,
        )


class NGCF(LightGCN):
    """Graph CF with W1/W2 transforms, bi-interaction, message dropout and
    an L2-normalized layer concat (NGCF.py:9-63): layer k computes
    ``side = Â e``, ``e ← leaky_relu((side + e) W_k_1 + (e ⊙ side) W_k_2)``
    (slope 0.01), drops messages with keep 0.9 (inverted dropout, while
    training only) and appends ``e / ‖e‖``; the un-normalized, dropped-out
    ``e`` feeds the next layer. Scoring tables are (U, 3d) and (I, 3d).
    Parameters: ``user_emb``, ``item_emb`` and the (d, d) glorot
    ``W_{k}_1``, ``W_{k}_2``; the two transforms are plain products."""

    keep_prob = 0.9  # message dropout keep (NGCF.py:37)

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        gen = torch.Generator().manual_seed(self.seed + 17)
        d = self.emb_size
        for k in range(self.n_layers):
            for j in (1, 2):
                w = torch.empty((d, d), dtype=torch.float32)
                nn.init.xavier_uniform_(w, generator=gen)
                setattr(self, f"W_{k}_{j}", nn.Parameter(w.to(self.device)))

    def read_configuration(self) -> None:
        super().read_configuration()
        self.n_layers = 2  # fixed in the reference (NGCF.py:19)

    def encode(self, masks: Optional[Sequence[torch.Tensor]] = None):
        """(users (U, 3d), items (I, 3d)); ``masks`` holds one (N, d) bool
        keep mask per layer, None for no dropout (scoring)."""
        ego = torch.cat([self.user_emb, self.item_emb])
        layers = [ego]
        for k in range(self.n_layers):
            side = spmm(self.joint_adj, ego)
            summed = (side + ego) @ getattr(self, f"W_{k}_1")
            bi = (ego * side) @ getattr(self, f"W_{k}_2")
            ego = F.leaky_relu(summed + bi, negative_slope=0.01)
            if masks is not None:
                ego = torch.where(masks[k], ego / self.keep_prob, torch.zeros_like(ego))
            layers.append(ego / (torch.linalg.vector_norm(ego, dim=1, keepdim=True) + 1e-12))
        out = torch.cat(layers, dim=1)
        return out[: self.num_users], out[self.num_users :]

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encode(None)

    def draw(self, gen: torch.Generator) -> List[torch.Tensor]:
        """The step's random inputs: a Bernoulli(keep) (N, d) mask per layer."""
        shape = (self.num_users + self.num_items, self.emb_size)
        return [torch.rand(shape, generator=gen, device=self.device) < self.keep_prob
                for _ in range(self.n_layers)]

    def step_loss(self, batch, masks) -> torch.Tensor:
        return self.rec_loss(*self.encode(masks), batch)

    def loss(self, batch, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.step_loss(batch, self.draw(gen))


class SGL(LightGCN):
    """Self-supervised graph learning: LightGCN + two node- or edge-dropped
    views of the graph + merged-batch InfoNCE (SGL.py).

    On the factored dense adjacency (the JAX package's ``dense_views``
    branch; the bf16 and legacy int8 forms take the sparse views, as there) a view keeps the binary R and changes its scales (node drop,
    aug type 0) or masks R's edges with a pair hash (edge drop, aug type 1;
    aug type 2 draws a fresh edge view per layer), then propagates through
    the dual kernel like the main graph (``ops/spmm.factored_*_view``). On
    the sparse adjacency a view is a vector of renormalized edge values
    over the joint structure of ``joint_bipartite_coo`` (node keeps, or one
    keep flag per interaction, ``ops/spmm.subgraph_vals``) and propagates
    through the segment kernel (through torch ops on a ``DeviceCOO`` under
    ``graph.backend=coo``)."""

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

    def prepare_graph(self) -> None:
        super().prepare_graph()
        if self.dense_views:
            self.edges
        else:
            self.view_structure

    @property
    def dense_views(self) -> bool:
        """Views of the factored form are factored tables (the JAX
        package's ``dense_views``: a ``DenseJoint`` with a column scale);
        every other form takes edge values over ``view_adjacency``."""
        adj = self.joint_adj
        return isinstance(adj, (DenseJoint, ShardedDenseJoint)) and adj.form == "factored"

    @property
    def edges(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense views: (rows, cols) of R's nonzeros, row-major (on a mesh,
        of the rank's item-column block, with local columns)."""
        if not hasattr(self, "_edges"):
            self._edges = torch.nonzero(self.joint_adj.r, as_tuple=True)
        return self._edges

    @property
    def view_structure(self):
        """Sparse views: the joint structure of ``joint_bipartite_coo`` (on
        the segment kernel, its row blocks on a mesh, or a ``DeviceCOO``
        under ``graph.backend=coo``), the interaction id of every edge, the
        number of interactions and the (rows, cols) of every edge. Built
        from the host's CSR: never the (U, I) R."""
        if not hasattr(self, "_view_structure"):
            rows, cols, edge_ids, n = joint_bipartite_coo(self.data)
            backend = self.config.get("graph.backend", "auto")
            as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
            self._view_structure = (
                view_adjacency(rows, cols, n, self.device, backend, self.mesh),
                as_t(edge_ids),
                len(self.data.csr_sel),
                (as_t(rows), as_t(cols)),
            )
        return self._view_structure

    def draw_view(self, gen: torch.Generator):
        """One view's random inputs: (keep_u, keep_i) bool node draws for
        aug type 0; for edge drop, one draw per layer for aug type 2 and one
        for the view otherwise: uniform 32-bit (ru, ci) hash inputs, held
        in int64, on the dense adjacency; a bool keep flag per interaction
        on the sparse one."""
        u, i, dev = self.num_users, self.num_items, self.device
        keep = 1.0 - self.drop_rate
        if self.aug_type == 0:
            return [(torch.rand(u, generator=gen, device=dev) < keep,
                     torch.rand(i, generator=gen, device=dev) < keep)]
        draws = self.n_layers if self.aug_type == 2 else 1
        if not self.dense_views:
            e = self.view_structure[2]
            return [torch.rand(e, generator=gen, device=dev) < keep for _ in range(draws)]
        return [
            (torch.randint(0, 2**32, (u,), generator=gen, device=dev, dtype=torch.int64),
             torch.randint(0, 2**32, (i,), generator=gen, device=dev, dtype=torch.int64))
            for _ in range(draws)
        ]

    def draw(self, gen: torch.Generator):
        """The step's random inputs: both views'."""
        return self.draw_view(gen), self.draw_view(gen)

    def view_layers(self, bits) -> List[Tuple[object, Optional[torch.Tensor]]]:
        """(adjacency, edge values or None) of every layer of one view."""
        if self.dense_views:
            adj = self.joint_adj
            if self.aug_type == 0:
                layers = [(factored_node_drop_view(adj, *bits[0]), None)]
            else:
                layers = [(factored_edge_drop_view(adj, self.edges, ru, ci, self.drop_rate), None)
                          for ru, ci in bits]
        else:
            adj, edge_ids, _, (rows, cols) = self.view_structure
            n, aug = adj.num_rows, self.aug_type
            layers = [(adj, subgraph_vals(rows, cols, edge_ids, n, aug, keep)) for keep in bits]
        return layers * (self.n_layers // len(layers))

    def encode_view(self, bits) -> Tuple[torch.Tensor, torch.Tensor]:
        e = torch.cat([self.user_emb, self.item_emb])
        acc = e
        for adj, vals in self.view_layers(bits):
            e = spmm(adj, e, vals)
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
        ssl = infonce_dispatch(merge1, merge2, mask, self.ssl_temp, self.mesh)
        return rec + self.ssl_reg * ssl

    def loss(self, batch, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.step_loss(batch, self.draw(gen))


class SimGCL(LightGCN):
    """LightGCN with uniform-noise-perturbed contrastive encoders
    (SimGCL.py:22-111). Noise: e += sign(e) * ε * l2norm(U(0,1)) per layer.

    The readout averages the K propagated layers WITHOUT the ego layer
    (SimGCL.py:22-28). The main encoder and both perturbed ones share the
    first propagation and then run as one (N, 3d) stream, one kernel call
    per layer (the JAX package's ``encode_all``)."""

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
            e = spmm(self.joint_adj, e)
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
        z = spmm(self.joint_adj, torch.cat([self.user_emb, self.item_emb]))
        states = [z, self._perturb(z, noise[0][0]), self._perturb(z, noise[0][1])]
        accs = list(states)
        for k in range(1, self.n_layers):
            zs = spmm(self.joint_adj, torch.cat(states, dim=1)).split(d, dim=1)
            states = [zs[0], self._perturb(zs[1], noise[k][0]), self._perturb(zs[2], noise[k][1])]
            accs = [a + s for a, s in zip(accs, states)]
        nu = self.num_users
        return [(o[:nu], o[nu:]) for o in (a / self.n_layers for a in accs)]

    def step_loss(self, batch, noise) -> torch.Tensor:
        """BPR and L2 on the batch's rows, and the InfoNCE of the distinct
        users and items of the WHOLE batch: on a mesh ``rec_loss`` takes
        this data rank's rows, and the contrastive sets, built from the whole
        batch on every rank, go to the row-sharded InfoNCE (splitting the
        batch first would change the sets, and so the function)."""
        u, i, _, _ = batch
        (users, items), (p1u, p1i), (p2u, p2i) = self.encode_all(noise)
        rec = self.rec_loss(users, items, batch)
        uu, um = unique_padded(u)
        iu, im = unique_padded(i)
        mesh = self.mesh
        cl = infonce_dispatch(_rows(p1u, uu), _rows(p2u, uu), um, self.cl_temp, mesh)
        cl = cl + infonce_dispatch(_rows(p1i, iu), _rows(p2i, iu), im, self.cl_temp, mesh)
        return rec + self.cl_rate * cl

    def loss(self, batch, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.step_loss(batch, self.draw(gen))
