"""LightGCN and SimGCL in plain PyTorch: propagation, losses, Adam, the
pairwise sampler's draws, and a training run that follows the system's
first epochs.

The arithmetic is the published models' as QRec trains them
(``model/ranking/LightGCN.py``, ``model/ranking/SimGCL.py``):

* propagation through ``D^-1/2 [[0, R], [R^T, 0]] D^-1/2`` with R the
  binary training matrix (a pair once) and degrees clamped to 1; its
  operands rounded to :class:`~portbench.reference.Precision`'s ``operand``
  after the degree scale on the input side, its sums in float32, and the
  backward the same product of the cotangent (the matrix is symmetric);
* LightGCN: the layer mean with the ego layer, BPR ``-log(1e-7 +
  sigmoid(pos - neg))`` and ``reg * sum(x^2) / 2`` of the batch's rows;
* SimGCL: the layer mean without the ego layer; two perturbed encoders,
  ``e + sign(e) * eps * noise / |noise|`` at every layer on uniform noise;
  InfoNCE at temperature 0.2 over the distinct users and the distinct
  items of the batch, ``lambda`` times the sum of the two;
* Adam at lr, 0.9, 0.999, 1e-8, with bias corrections.

The random stream: the system draws every epoch's batches and every step's
noise from one generator seeded ``seed + 1`` on its device. The reference
makes the same calls on a generator of its own with that seed, in the same
order and of the same shapes (:func:`sample_epoch`, the noise in
:func:`train`), so both sides see the same numbers; how they turn into
batches (the shuffle, the first untried item that the user has not rated,
else the k-th unrated item) is worked out here again.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import Precision
from .dataset import Dataset
from .ranking import Ranking, f32_products, measures, rank


class Adjacency:
    """The normalised joint adjacency of a :class:`Dataset` on ``device``,
    as R and its transpose in CSR form with the two degree scales."""

    def __init__(self, data: Dataset, device):
        u, i = data.num_users, data.num_items
        rows = torch.as_tensor(data.rows, device=device)
        cols = torch.as_tensor(data.cols, device=device)
        ones = torch.ones(len(data.rows), dtype=torch.float32, device=device)
        with warnings.catch_warnings():
            # torch's notes that sparse CSR is in beta and unchecked
            warnings.simplefilter("ignore", UserWarning)
            self.r = torch.sparse_coo_tensor(torch.stack([rows, cols]), ones,
                                             (u, i)).coalesce().to_sparse_csr()
            self.rt = torch.sparse_coo_tensor(torch.stack([cols, rows]), ones,
                                              (i, u)).coalesce().to_sparse_csr()
        self.su = torch.as_tensor(1.0 / np.sqrt(np.maximum(data.deg_u, 1)), dtype=torch.float32,
                                  device=device)[:, None]
        self.si = torch.as_tensor(1.0 / np.sqrt(np.maximum(data.deg_i, 1)), dtype=torch.float32,
                                  device=device)[:, None]
        self.num_users = u

    def apply(self, x: torch.Tensor, prec: Precision) -> torch.Tensor:
        nu = self.num_users
        su, si = self.su.to(x.dtype), self.si.to(x.dtype)
        xu = (x[:nu] * su).to(prec.operand).to(torch.float32)
        xi = (x[nu:] * si).to(prec.operand).to(torch.float32)
        ou = torch.sparse.mm(self.r, xi) * self.su
        oi = torch.sparse.mm(self.rt, xu) * self.si
        return torch.cat([ou, oi]).to(prec.dtype)


class _Propagate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj, prec):
        ctx.adj, ctx.prec = adj, prec
        return adj.apply(x, prec)

    @staticmethod
    def backward(ctx, grad):
        return ctx.adj.apply(grad, ctx.prec), None, None


def propagate(adj: Adjacency, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return _Propagate.apply(x, adj, prec)


class Model(NamedTuple):
    """What a configuration says of the model."""

    name: str  # LightGCN | SimGCL
    layers: int
    reg: float
    lr: float
    batch_size: int
    top_n: int
    cl_rate: float = 0.0
    eps: float = 0.0
    temperature: float = 0.2


def encode(model: Model, adj: Adjacency, emb: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The scoring tables ((U + I), d) of the main encoder."""
    if model.name == "LightGCN":
        acc = e = emb
        for _ in range(model.layers):
            e = propagate(adj, e, prec)
            acc = acc + e
        return acc / (model.layers + 1)
    acc, e = None, emb
    for _ in range(model.layers):
        e = propagate(adj, e, prec)
        acc = e if acc is None else acc + e
    return acc / model.layers


def _perturb(e: torch.Tensor, noise: torch.Tensor, eps: float) -> torch.Tensor:
    noise = noise / (torch.linalg.vector_norm(noise, dim=1, keepdim=True) + 1e-12)
    return e + torch.sign(e) * noise * eps


def simgcl_views(model: Model, adj: Adjacency, emb: torch.Tensor, noise, prec: Precision):
    """(main, view 1, view 2) tables of SimGCL's three encoders."""
    states = None
    accs = None
    e = emb
    for k in range(model.layers):
        if states is None:
            z = propagate(adj, e, prec)
            states = [z, _perturb(z, noise[k][0], model.eps), _perturb(z, noise[k][1], model.eps)]
        else:
            states = [propagate(adj, states[0], prec),
                      _perturb(propagate(adj, states[1], prec), noise[k][0], model.eps),
                      _perturb(propagate(adj, states[2], prec), noise[k][1], model.eps)]
        accs = list(states) if accs is None else [a + s for a, s in zip(accs, states)]
    return [a / model.layers for a in accs]


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp_min((x * x).sum(dim=1, keepdim=True), 1e-12))


def infonce(view1: torch.Tensor, view2: torch.Tensor, temperature: float) -> torch.Tensor:
    """Sum over the rows of InfoNCE between aligned views, every other row
    a negative."""
    v1, v2 = _l2n(view1), _l2n(view2)
    logits = (v1 @ v2.T) / temperature
    return (torch.logsumexp(logits, dim=1) - torch.diagonal(logits)).sum()


def rec_loss(model: Model, tables: torch.Tensor, nu: int, batch) -> torch.Tensor:
    u, i, j, w = batch
    pu, qi, qj = tables[u], tables[nu + i], tables[nu + j]
    pos = (pu * qi).sum(dim=1)
    neg = (pu * qj).sum(dim=1)
    bpr = (-torch.log(1e-7 + torch.sigmoid(pos - neg)) * w).sum()
    l2 = 0.5 * (w[:, None] * (pu * pu + qi * qi + qj * qj)).sum()
    return bpr + model.reg * l2


def step_loss(model: Model, adj: Adjacency, emb: torch.Tensor, batch, noise,
              prec: Precision) -> torch.Tensor:
    nu = adj.num_users
    if model.name == "LightGCN":
        return rec_loss(model, encode(model, adj, emb, prec), nu, batch)
    main, v1, v2 = simgcl_views(model, adj, emb, noise, prec)
    rec = rec_loss(model, main, nu, batch)
    users = torch.unique(batch[0])
    items = torch.unique(batch[1])
    cl = infonce(v1[users], v2[users], model.temperature)
    cl = cl + infonce(v1[nu + items], v2[nu + items], model.temperature)
    return rec + model.cl_rate * cl


class Adam:
    """Adam on a list of tensors, state in their dtype."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, 0.9, 0.999, 1e-8
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps))


def sample_epoch(gen: torch.Generator, data: Dataset, batch_size: int, tries: int,
                 positives: torch.Tensor, device):
    """One epoch's (users, pos, neg, weight) batches, (num_batches,
    batch_size) each: the training pairs shuffled and padded to whole
    batches with pair 0 at weight 0; each user's negative the first of
    ``tries`` uniform items that the user has not rated, else the k-th
    unrated item, k uniform below the count of unrated items. Draws, in
    order: the shuffle, the tries, one float64 uniform a pair."""
    n = len(data.train_u)
    perm = torch.randperm(n, generator=gen, device=device)
    num_batches = -(-n // batch_size)
    padded = num_batches * batch_size
    idx = torch.cat([perm, torch.zeros(padded - n, dtype=perm.dtype, device=device)])
    users = torch.as_tensor(data.train_u, device=device)[idx]
    pos = torch.as_tensor(data.train_i, device=device)[idx]
    weight = (torch.arange(padded, device=device) < n).float()
    cands = torch.randint(0, data.num_items, (padded, tries), generator=gen, device=device,
                          dtype=torch.int64)
    u01 = torch.rand((padded,), generator=gen, device=device, dtype=torch.float64)
    rated_rows = positives[users]  # (padded, max degree), padded with num_items
    hit = (rated_rows[:, None, :] == cands[:, :, None]).any(dim=2)
    ok = ~hit
    first = ok.to(torch.int8).argmax(dim=1)
    chosen = cands.gather(1, first[:, None])[:, 0]
    deg = (rated_rows < data.num_items).sum(dim=1)
    span = torch.clamp(data.num_items - deg, min=1)
    k = torch.minimum((u01 * span).long(), span - 1)
    # the k-th unrated item: k + the number of rated items p_t with
    # p_t - t <= k (p_t - t counts the unrated items below p_t)
    below = rated_rows - torch.arange(rated_rows.shape[1], device=device)[None, :]
    exact = k + ((below <= k[:, None]) & (rated_rows < data.num_items)).sum(dim=1)
    neg = torch.where(ok.any(dim=1), chosen, exact)
    shape = (num_batches, batch_size)
    return users.view(shape), pos.view(shape), neg.view(shape), weight.view(shape)


class Followed(NamedTuple):
    """What the reference's run gives after its epochs."""

    losses: List[float]
    measures: List[Dict[str, float]]
    tables: List[torch.Tensor]  # user, item embeddings
    moments: List[torch.Tensor]  # Adam's first moments
    unique: List[float]  # mean distinct users, items a step


def train(model: Model, data: Dataset, init: Sequence[torch.Tensor], seed: int, epochs: int,
          prec: Precision, device, *, evaluate: bool = False, fault: Optional[str] = None,
          adj: Optional[Adjacency] = None) -> Followed:
    """``epochs`` epochs from the tables ``init`` (user, item), drawing from
    a generator seeded ``seed + 1`` on ``device``. With ``evaluate`` each
    epoch ends with the ranking measures at ``model.top_n``. ``fault``
    ``half_batch`` plants a fault in place of the system: each step's loss
    on the first half of the batch only, doubled (a mean over the rest)."""
    adj = adj if adj is not None else Adjacency(data, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    tables = [t.detach().to(device=device, dtype=prec.dtype).clone().requires_grad_(True)
              for t in init]
    opt = Adam(tables, model.lr)
    positives = torch.as_tensor(data.positives(), device=device)
    tries = data.rejection_tries()
    ranking = Ranking(data, device) if evaluate else None
    n_nodes = data.num_users + data.num_items
    d = init[0].shape[1]
    losses, ms = [], []
    uniq_u, uniq_i = [], []
    with f32_products():
        for _ in range(epochs):
            batches = sample_epoch(gen, data, model.batch_size, tries, positives, device)
            total = torch.zeros((), dtype=torch.float32, device=device)
            for k in range(batches[0].shape[0]):
                batch = tuple(t[k] for t in batches)
                noise = None
                if model.name == "SimGCL":
                    noise = [(torch.rand((n_nodes, d), generator=gen, device=device).to(prec.dtype),
                              torch.rand((n_nodes, d), generator=gen, device=device).to(prec.dtype))
                             for _ in range(model.layers)]
                if fault == "half_batch":
                    half = model.batch_size // 2
                    batch = tuple(t[:half] for t in batch)
                emb = torch.cat(tables)
                loss = step_loss(model, adj, emb, batch, noise, prec)
                if fault == "half_batch":
                    loss = loss * 2
                grads = torch.autograd.grad(loss, tables)
                opt.step(grads)
                total = total + loss.detach().float()
                uniq_u.append(int(torch.unique(batch[0]).numel()))
                uniq_i.append(int(torch.unique(batch[1]).numel()))
            losses.append(float(total))
            if ranking is not None:
                with torch.no_grad():
                    out = encode(model, adj, torch.cat(tables), prec)
                    ids, _ = rank(ranking, out[: data.num_users], out[data.num_users:], model.top_n,
                                  prec)
                    ms.append(measures(ranking, ids, model.top_n))
    return Followed(losses, ms, [t.detach() for t in tables], [m.detach() for m in opt.m],
                    [float(np.mean(uniq_u)), float(np.mean(uniq_i))])


def gap_of_norms(ours: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
                 keep: Sequence[bool]) -> float:
    """The worst leaf's |‖ours‖ - ‖ref‖| against the larger of ‖ref‖ and the
    median kept leaf's ‖ref‖, over the leaves ``keep`` marks."""
    norms = [(float(torch.linalg.vector_norm(a.double())), float(torch.linalg.vector_norm(b.double())))
             for a, b in zip(ours, ref)]
    kept = [n for n, k in zip(norms, keep) if k]
    if not kept:
        return math.inf
    median = float(np.median([r for _, r in kept]))
    return max(abs(o - r) / max(r, median, 1e-30) for o, r in kept)
