"""IF_BPR: implicit-friend BPR over meta-path walks (reference
model/ranking/IF_BPR.py; the JAX package's ``models/ifbpr.py``).

Pipeline: typed walks along five meta-paths (UIU, UFU, UTU, UFIU, UFUIU)
over the positive interactions and the trust relation, and again over the
negative feedback, on the host; SGNS embeddings of each channel on the
device; each user's positive and negative top-K implicit friends
(:func:`friend_lists`, which RSGAN shares); then a four-tier preference
chain ``P ≻ Joint ≻ PS ≻ rand ≻ Neg`` whose joint tier is admitted by a
per-user similarity threshold, learned from the tier's gradient and moved
at the end of every epoch (IF_BPR.py ``optimization_thres``). On a CUDA
device an epoch (the sampler, the steps with their threshold sums, the
threshold update) is one CUDA graph, replayed once an epoch, and the
host reads the losses at the printed epochs, as the JAX package's one
jitted scan an epoch does.

Negative feedback comes from ``<ratings>_n.txt`` beside the rating file
(IF_BPR.py:35-44); where it is absent the negative channel and tier are
empty. The host pipeline (relation nets, interaction matrices, walks, tier
tables) is numpy and scipy, the JAX package's bit for bit; the walkers of
the five meta-paths draw in order from one ``RandomState(seed)``, the
positive channel first. Parameters: ``user_emb`` (U, d), 0.1 everywhere,
and ``item_emb`` (I, d), numpy's ``RandomState(seed).random_sample / 3``,
the JAX package's tables bit for bit. The per-user threshold sums of an
epoch are segment sums over each batch sorted by user (no atomics), so a
seeded run repeats them bit for bit on the card. It ranks through K2's
fused top-k.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..ops import sampling
from ..ops.spmm import segment_sum
from ..ops.walks import (
    SkipgramDraws,
    skipgram_stats,
    topk_cosine_neighbors,
    train_skipgram,
    walk_pairs,
)
from ..runtime import trainer as T
from ..runtime.profiling import StepTimer
from .base import SocialRecommender
from .social_ranking import _csr_tables

META_PATHS = [("UIU", 10), ("UFU", 8), ("UTU", 8), ("UFIU", 5), ("UFUIU", 5)]


def _weighted_csr(pairs_dict, n: int) -> sp.csr_matrix:
    """(n, n) CSR from {node: [(neighbour, weight), ...]}."""
    rows, cols, vals = [], [], []
    for u, lst in pairs_dict.items():
        for v, w in lst:
            rows.append(u)
            cols.append(v)
            vals.append(w)
    return sp.csr_matrix((np.array(vals, dtype=np.float32), (rows, cols)), shape=(n, n))


def _step(csr: sp.csr_matrix, cur: np.ndarray, rng: np.random.RandomState):
    """One vectorised weighted step of every walker: (next, ok), a walker
    at a node without edges staying where it is with ok false."""
    indptr, indices, data = csr.indptr, csr.indices, csr.data
    deg = np.diff(indptr)
    ok = deg[cur] > 0
    flat_cum = np.cumsum(data.astype(np.float64))
    row_base = np.concatenate([[0.0], flat_cum])[indptr]
    row_total = np.asarray(csr.sum(axis=1)).ravel()
    safe = np.where(ok, cur, 0)
    targets = row_base[safe] + rng.random_sample(len(cur)) * row_total[safe]
    pos = np.minimum(np.searchsorted(flat_cum, targets, side="right"), len(indices) - 1)
    nxt = indices[pos].astype(np.int32)
    return np.where(ok, nxt, cur).astype(np.int32), ok


def relation_nets(data, social) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """UF (follows) and UT (followed by) user nets, each link weighted by
    the two users' common neighbours + 1 (IF_BPR.py:93-111)."""
    nu = data.num_users

    def side(links):
        return {data.user[u]: {data.user[v] for v in links[u]} for u in links if u in data.user}

    nets = []
    for sets in (side(social.followees), side(social.followers)):
        pairs = defaultdict(list)
        for u, vs in sets.items():
            for v in vs:
                if v in sets and u != v:
                    pairs[u].append((v, len(sets[u] & sets[v]) + 1))
        nets.append(_weighted_csr(pairs, nu))
    return nets[0], nets[1]


def read_negative_feedback(ratings_path: str, data) -> Tuple[np.ndarray, np.ndarray]:
    """(users, items) int32 of ``<ratings>_n.txt`` beside the rating file,
    the pairs of known users and items; empty where there is no file."""
    path = ratings_path[:-4] + "_n.txt"
    neg_u, neg_i = [], []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                toks = line.strip().split()
                if len(toks) >= 2 and toks[0] in data.user and toks[1] in data.item:
                    neg_u.append(data.user[toks[0]])
                    neg_i.append(data.item[toks[1]])
    return np.array(neg_u, dtype=np.int32), np.array(neg_i, dtype=np.int32)


def interaction_csrs(users, items, num_users: int, num_items: int):
    """(U→I, I→U) uniform-choice CSRs of an edge list."""
    ui = sp.csr_matrix((np.ones(len(users), dtype=np.float32), (users, items)),
                       shape=(num_users, num_items))
    return ui.tocsr(), ui.T.tocsr()


def meta_path_walks(ui, iu, uf, ut, rng: np.random.RandomState, num_users: int,
                    walk_length: int) -> Tuple[np.ndarray, List[Tuple[str, int]]]:
    """Typed walks over one channel, item tokens offset by ``num_users``:
    each meta-path's walkers start ``count`` times from every user and
    repeat its steps ``walk_length // steps`` times; a walker that reaches a
    dead end is dropped, and every walk is cut to the shortest width.
    Returns (walks, [(meta-path, walkers kept), ...])."""
    nu = num_users
    walks_all, kept = [], []
    for mp, cnt in META_PATHS:
        steps = mp[1:]
        repeats = max(1, walk_length // len(steps))
        starts = np.repeat(np.arange(nu, dtype=np.int32), cnt)
        cur = starts.copy()
        last_type = "U"
        seq = [starts + 0]
        valid = np.ones(len(cur), dtype=bool)
        for _ in range(repeats):
            for tp in steps:
                if tp == "I":
                    nxt, ok = _step(ui, cur, rng)
                    token = nxt + nu
                elif tp == "U" and last_type == "I":
                    nxt, ok = _step(iu, cur, rng)
                    token = nxt
                elif tp == "T" or (tp == "U" and last_type == "T"):
                    nxt, ok = _step(ut, cur, rng)
                    token = nxt
                else:  # 'F', or 'U' after U/F (IF_BPR.py:127-153)
                    nxt, ok = _step(uf, cur, rng)
                    token = nxt
                cur = np.where(ok, nxt, cur).astype(np.int32)
                valid &= ok
                seq.append(token.astype(np.int32))
                last_type = tp
        walk = np.stack(seq, axis=1)
        walks_all.append(walk[valid])
        kept.append((mp, int(valid.sum())))
    width = min(w.shape[1] for w in walks_all)
    return np.concatenate([w[:, :width] for w in walks_all], axis=0), kept


class FriendLists(NamedTuple):
    """Each user's implicit friends: the positive channel's top-k ids and
    similarities (U, k), the negative channel's ids (or None), the initial
    thresholds and mean similarities (U,), the negative feedback (users,
    items), and the pipeline's ``stats``."""

    p_ids: np.ndarray
    p_sims: np.ndarray
    n_ids: Optional[np.ndarray]
    threshold: np.ndarray
    avg_sim: np.ndarray
    negative: Tuple[np.ndarray, np.ndarray]
    stats: dict


def friend_lists(data, social, seed: int, walk_length: int, dim: int, window: int, top_k: int,
                 device, negative: Tuple[np.ndarray, np.ndarray],
                 draws=SkipgramDraws) -> FriendLists:
    """Positive and negative implicit friends of every user (IF_BPR.py;
    RSGAN.py:221-224 seeds its friends with them): meta-path walks over
    the vocabulary of users and items, 3 SGNS epochs per channel seeded
    ``seed``, and the top-k cosine neighbours among all users. The threshold
    of a user starts at its ``min(k//2, k-1)``-th similarity, its mean
    similarity over the first ``max(1, k//2)``. ``negative`` is the
    negative feedback (users, items); ``draws`` gives the SGNS runs' random
    inputs."""
    nu, ni = data.num_users, data.num_items
    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    uf, ut = relation_nets(data, social)
    pos_ui, pos_iu = interaction_csrs(data.train_u, data.train_i, nu, ni)
    stats = {"walk_s": time.perf_counter() - t0, "walkers": [], "pairs": [], "sgns": []}

    def embed(ui, iu):
        t0 = time.perf_counter()
        walks, kept = meta_path_walks(ui, iu, uf, ut, rng, nu, walk_length)
        centers, contexts = walk_pairs(walks, window)
        active = np.unique(walks.ravel())
        stats["walk_s"] += time.perf_counter() - t0
        stats["walkers"].append(kept)
        stats["pairs"].append(len(centers))
        if len(walks) == 0:
            return None
        timer = StepTimer(len(centers), device)
        emb = train_skipgram(centers, contexts, nu + ni, dim, active, epochs=3, seed=seed,
                             device=device, draws=draws, timer=timer)
        stats["sgns"].append(skipgram_stats(len(centers), timer, device))
        return emb[:nu]

    print("Generating meta-path walks / embeddings (positive)...")
    w_pos = embed(pos_ui, pos_iu)
    k = min(top_k, max(nu - 1, 1))
    users_all = np.arange(nu, dtype=np.int64)
    topk = StepTimer(0, device)
    with topk:
        p_ids, p_sims = topk_cosine_neighbors(w_pos, users_all, k)
    stats["topk_ms"] = topk.last * 1e3
    p_ids, p_sims = p_ids.cpu().numpy(), p_sims.cpu().numpy()
    threshold = p_sims[:, min(k // 2, k - 1)].copy()
    avg_sim = p_sims[:, :max(1, k // 2)].mean(axis=1)
    n_ids = None
    if len(negative[0]):
        print("Generating meta-path walks / embeddings (negative)...")
        neg_ui, neg_iu = interaction_csrs(negative[0], negative[1], nu, ni)
        g_neg = embed(neg_ui, neg_iu)
        if g_neg is not None:
            n_ids = topk_cosine_neighbors(g_neg, users_all, k)[0].cpu().numpy()
    return FriendLists(p_ids, p_sims, n_ids, threshold, avg_sim, negative, stats)


def joint_mask(p_ids: np.ndarray, n_ids: Optional[np.ndarray]) -> np.ndarray:
    """(U, k) bool: the positive friends that are also negative friends
    (the true friends), or all of them without a negative channel."""
    if n_ids is None:
        return np.ones_like(p_ids, dtype=bool)
    mask = np.zeros_like(p_ids, dtype=bool)
    for u in range(len(p_ids)):
        inter = set(p_ids[u]) & set(n_ids[u])
        mask[u] = np.isin(p_ids[u], list(inter))
    return mask


def user_sums(users: torch.Tensor, values: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(U, c) sums of ``values`` (B, c) over each user's rows, ``bounds``
    = arange(U + 1): a stable sort by user, then segment sums in batch
    order, with no atomics."""
    order = torch.sort(users, stable=True).indices
    return segment_sum(values[order], torch.searchsorted(users[order], bounds))


class IF_BPR(SocialRecommender):
    """The four-tier chain over implicit friends with the adaptive joint
    threshold, trained by its own loop under one Adam. On a mesh its
    training is replicated: every rank builds the friends and trains the
    whole model from the same seed."""

    skipgram_draws = SkipgramDraws  # the SGNS runs' random inputs (replaceable)

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        user = torch.full((self.num_users, self.emb_size), 0.1)
        rng = np.random.RandomState(self.seed)
        item = torch.from_numpy(rng.random_sample((self.num_items, self.emb_size)).astype(np.float32) / 3)
        self.user_emb = nn.Parameter(user.to(self.device))
        self.item_emb = nn.Parameter(item.to(self.device))

    def read_configuration(self) -> None:
        super().read_configuration()
        options = self.model_args()
        self.walk_length = options.get_int("-L")
        self.walk_dim = options.get_int("-l")
        self.win_size = options.get_int("-w")
        self.top_k = options.get_int("-k")
        self.alpha = options.get_float("-a")
        self.neg_count = options.get_int("-neg", 5)

    def implicit_friends(self) -> FriendLists:
        negative = read_negative_feedback(self.config["ratings"], self.data)
        return friend_lists(self.data, self.social, self.seed, self.walk_length, self.walk_dim,
                            self.win_size, self.top_k, self.device, negative,
                            draws=self.skipgram_draws)

    def tier_tables(self, friends: FriendLists):
        """(joint, ps, neg) CSRs and the joint tier's per-user strongest
        similarity (U,) f32, the JAX package's host build: the items of a
        user's true (joint) and positive-only (ps) friends that the user
        did not rate, and the negative feedback of its negative friends."""
        nu, ni = self.num_users, self.num_items
        true_mask = joint_mask(friends.p_ids, friends.n_ids)
        r = sp.csr_matrix((np.ones_like(self.data.train_u, dtype=np.float32),
                           (self.data.train_u, self.data.train_i)), shape=(nu, ni))
        r.data[:] = 1.0

        def tier(mask):
            rows, cols = np.nonzero(mask)
            t = sp.csr_matrix((friends.p_sims[rows, cols].astype(np.float32),
                               (rows, friends.p_ids[rows, cols].astype(np.int64))), shape=(nu, nu))
            items = t @ r
            simmax = np.asarray(t.max(axis=1).todense()).ravel() if t.nnz else np.zeros(nu)
            items = items - items.multiply(r)
            items.eliminate_zeros()
            return items.tocsr(), simmax.astype(np.float32)

        joint, simmax = tier(true_mask)
        ps, _ = tier(~true_mask)
        neg_u, neg_i = friends.negative
        if friends.n_ids is not None and len(neg_u):
            rn = sp.csr_matrix((np.ones(len(neg_u), dtype=np.float32), (neg_u, neg_i)), shape=(nu, ni))
            n_ids = friends.n_ids
            fsel = sp.csr_matrix((np.ones(n_ids.size, dtype=np.float32),
                                  (np.repeat(np.arange(nu), n_ids.shape[1]), n_ids.ravel())),
                                 shape=(nu, nu))
            neg = (fsel @ rn) - (fsel @ rn).multiply(r)
            neg.eliminate_zeros()
            neg = neg.tocsr()
        else:
            neg = sp.csr_matrix((nu, ni), dtype=np.float32)
        return joint, ps, neg, simmax, true_mask

    def build_graph(self) -> None:
        friends = self.implicit_friends()
        self.friends, self.walk_stats = friends, friends.stats
        joint, ps, neg, simmax, true_mask = self.tier_tables(friends)
        # an empty tier samples nothing: ``sample_from_rows`` gives has = 0
        self.tables = [_csr_tables(m, self.device)[:2] for m in (joint, ps, neg)]
        dev = lambda a, dtype=torch.float32: torch.tensor(np.asarray(a), dtype=dtype, device=self.device)  # noqa: E731
        self.joint_simmax = dev(simmax)
        self.p_sims = dev(friends.p_sims)
        nu, k = friends.p_ids.shape
        self.pull_src = dev(np.repeat(np.arange(nu), k), torch.int64)
        self.pull_dst = dev(friends.p_ids.ravel(), torch.int64)
        self.pull_sim = dev(friends.p_sims.ravel())
        self.pull_true = dev(true_mask.ravel().astype(np.float32))
        self._user_range = torch.arange(self.num_users + 1, device=self.device)
        self.num_batches = -(-self.train_size // self.batch_size)
        # the sampler's tables, on the device before an epoch's capture
        self.train_arrays, self.rated_bitmask

    def sampler(self, gen: torch.Generator):
        """(users, pos, joint item, its similarity, ps item, neg item,
        random negative, the three has-masks, weight) epoch tensors shaped
        (num_batches, batch_size)."""
        users, pos, w = self._pairs(gen)
        (k_it, k_has, _), (p_it, p_has, _), (n_it, n_has, _) = (
            sampling.sample_from_rows(gen, indptr, indices, users) for indptr, indices in self.tables)
        # the contributing friend's similarity, as the user's strongest
        # joint friend's (the reference keeps one arbitrary contributing
        # friend per item, IF_BPR.py:291-301)
        k_sim = self.joint_simmax[users]
        r_it = self._negatives(gen, users)
        return self._batched(users, pos, k_it, k_sim, p_it, n_it, r_it, k_has, p_has, n_has, w)

    def step_loss(self, batch, thr: torch.Tensor, avg: torch.Tensor):
        """(loss, (acc, cnt)): the batch's loss, and per user the summed
        threshold derivative and joint-tier count (constants)."""
        u, i, k_it, k_sim, p_it, n_it, r_it, k_has, p_has, n_has, w = batch
        k_has, p_has, n_has = k_has.bool(), p_has.bool(), n_has.bool()
        p, q = self.user_emb[u], self.item_emb
        score = lambda items: (p * q[items]).sum(dim=1)  # noqa: E731
        y_i = score(i)
        thr_u, avg_u = thr[u], avg[u]
        # the adaptive-threshold joint tier (optimization_thres)
        qualifies = k_has & (k_sim >= thr_u)
        gap = avg_u - thr_u
        g_theta = torch.sigmoid((k_sim - thr_u) / torch.where(gap.abs() > 1e-6, gap, 1e-6))
        y_k = score(k_it)
        m_joint = qualifies.float() * w
        margin = (y_i - y_k) / (1 + g_theta)
        loss = -(m_joint * torch.log(torch.sigmoid(margin) + 1e-10)).sum()
        with torch.no_grad():
            # the threshold's derivative (IF_BPR.py optimization_thres tail)
            s_val = torch.sigmoid(margin)
            t_deriv = (-g_theta * (1 - g_theta) * (1 - s_val) * (y_i - y_k) * (k_sim - avg_u)
                       / torch.clamp_min(gap**2, 1e-8) / (1 + g_theta) ** 2 + 0.005 * thr_u)
            sums = user_sums(u, torch.stack([t_deriv * m_joint, m_joint], dim=1), self._user_range)
        # the rest of the chain, last ≻ ps ≻ rand ≻ neg, skipping a tier the
        # user lacks
        last_y = torch.where(qualifies, y_k, y_i)
        for items, has in ((p_it, p_has), (r_it, None), (n_it, n_has)):
            y = score(items)
            m = w if has is None else has.float() * w
            loss = loss - (m * torch.log(torch.sigmoid(last_y - y) + 1e-10)).sum()
            last_y = y if has is None else torch.where(has, y, last_y)
        reg = 0.5 * (self.reg_u * (w[:, None] * p**2).sum()
                     + self.reg_i * (w[:, None] * (q[i] ** 2 + q[r_it] ** 2)).sum())
        # the one-sided pull toward true friends above the threshold, over
        # the full edge set, scaled per batch
        pull_w = self.pull_true * (self.pull_sim > thr[self.pull_src]).float()
        diff = self.user_emb[self.pull_src] - self.user_emb[self.pull_dst].detach()
        pull = 0.5 * self.alpha * (pull_w[:, None] * diff**2).sum() / self.num_batches
        return loss + reg + pull, (sums[:, 0], sums[:, 1])

    def update_threshold(self, thr, avg, acc, cnt):
        """The end-of-epoch threshold step and the mean similarity of the
        friends that now qualify (IF_BPR.py:363-371)."""
        new_thr = torch.where(cnt > 0, thr - self.lrate * acc / torch.clamp_min(cnt, 1), thr)
        qual = (self.p_sims >= new_thr[:, None]).float()
        qual_cnt = qual.sum(dim=1)
        new_avg = torch.where(qual_cnt > 0, (self.p_sims * qual).sum(dim=1) / torch.clamp_min(qual_cnt, 1),
                              new_thr)
        return new_thr, new_avg

    def train_epoch(self, optimizer, batches, thr, avg):
        """One epoch of steps on ``batches``: (summed loss, thr, avg, acc)
        after the epoch's threshold update."""
        acc = cnt = torch.zeros(self.num_users, device=self.device)
        total = torch.zeros((), device=self.device)
        params = [self.user_emb, self.item_emb]
        for step in range(batches[0].shape[0]):
            loss, (a, c) = self.step_loss(tuple(t[step] for t in batches), thr, avg)
            T.step(optimizer, loss, params)
            acc, cnt = acc + a, cnt + c
            total = total + loss.detach()
        thr, avg = self.update_threshold(thr, avg, acc, cnt)
        return total, thr, avg, acc

    def fit_phases(self) -> None:
        """``num.max.epoch`` epochs under one Adam, the threshold moved
        after each. Where the run has more than one epoch
        (``own_loop_form``) an epoch (the sampler, the steps with their
        threshold sums, the threshold update and the summed loss) is one
        CUDA graph on a card (:class:`_EpochGraph`), captured before the
        first epoch and replayed once an epoch, and Adam is capturable in
        both forms. Each epoch's loss waits in a device buffer; the
        host reads the losses at the epochs it prints, every 5th and the
        last, as the JAX package does, each checked for NaN there."""
        self.prepare_graph()
        optimizer = T.make_optimizer([self.user_emb, self.item_emb], "adam", self.lrate)
        graphs, capturable = self.own_loop_form(self.max_epoch)
        if capturable:
            T.make_capturable(optimizer)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        thr, avg = (torch.tensor(a, dtype=torch.float32, device=self.device)
                    for a in (self.friends.threshold, self.friends.avg_sim))
        graph = _EpochGraph(self, optimizer, gen, thr, avg) if graphs else None
        if graph is not None and self.device.type == "cuda":
            graph.load(0)
            with self.timer.capture():
                graph.capture()
        losses = T.PrintedLosses(self.max_epoch, 5, self.device,
                                  state=None if graph is None else graph.state)
        self.thresholds = []
        for epoch in range(self.max_epoch):
            with self.timer:
                if graph is not None:
                    graph.load(epoch)
                    graph.run()
                    total, thr, avg = graph.loss, graph.thr.clone(), graph.avg.clone()
                else:
                    if self._epoch_batches is not None:
                        batches = T.as_device_batches(self._epoch_batches[epoch], self.device)
                    else:
                        batches = self.sampler(gen)
                    total, thr, avg, self.acc = self.train_epoch(optimizer, batches, thr, avg)
                losses.put(epoch, total)
            self.thresholds.append((thr, avg))
            row = losses.read(epoch)
            if row is not None:
                print(f"{self.model_name} {self.fold} epoch {epoch + 1}: loss = {row[0]:.4f}")
        if graph is not None:
            self.acc = graph.acc.clone()
        self.epoch_losses = [row[0] for row in losses.rows]
        self.phase_losses = [self.epoch_losses]
        self.U, self.V = self.user_emb.detach().clone(), self.item_emb.detach().clone()


class _EpochGraph(T.GraphProgram):
    """IF_BPR's epoch (a ``runtime/trainer.GraphProgram`` over the tables,
    Adam's state, the thresholds and the generator, committed before the
    first epoch) in fixed buffers: the thresholds ``thr`` and ``avg``,
    which the steps read and the update overwrites, the last step's sums
    ``acc`` and the summed ``loss``; injected batches are copied into
    buffers of their own (``trainer.load_batches``). :meth:`run` runs
    :meth:`body` once an epoch, as a replayed CUDA graph on a card."""

    def __init__(self, model: IF_BPR, optimizer, gen: torch.Generator, thr, avg):
        self.model, self.optimizer, self.gen = model, optimizer, gen
        self.thr, self.avg = thr.clone(), avg.clone()
        self.acc = torch.zeros(model.num_users, device=model.device)
        self.loss = torch.zeros((), device=model.device)
        self._batches = None
        T.init_adam_state(optimizer)
        super().__init__(T.LoopState(0, [model.user_emb, model.item_emb], optimizer, gen,
                                     extra=[self.thr, self.avg]), model.device)

    def load(self, epoch: int) -> None:
        """The injected batches of ``epoch`` into their buffers."""
        injected = self.model._epoch_batches
        if injected is not None:
            self._batches = T.load_batches(injected[epoch], self._batches, self.model.device)

    def body(self) -> None:
        model = self.model
        batches = self._batches if model._epoch_batches is not None else model.sampler(self.gen)
        total, thr, avg, acc = model.train_epoch(self.optimizer, batches, self.thr, self.avg)
        self.thr.copy_(thr)
        self.avg.copy_(avg)
        self.acc.copy_(acc)
        self.loss.copy_(total)
