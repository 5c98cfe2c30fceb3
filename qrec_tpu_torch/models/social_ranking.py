"""Social ranking family: SBPR and TBPR (reference model/ranking/SBPR.py and
TBPR.py; the JAX package's ``models/social_ranking.py``).

Both extend BPR with tiers of social evidence, on bold-driver SGD:

* SBPR: the items that a user's followees consumed and the user did not
  form a middle tier, ``i ≻ k ≻ j``, the margin on (i, k) scaled by ``1 /
  (S_uk + 1)`` with S_uk the followees' count of k (SBPR.py:111-137);
* TBPR: Jaccard tie strengths split the followees at their median into
  strong and weak ties, and the items only strong ties, only weak ties or
  both consumed chain as ``i ≻ joint ≻ weak ≻ strong ≻ negative``, a tier a
  user lacks skipped (TBPR.py:135-160). The reference never updates the
  split (its θ update is dead code), so the tie sets are built once.

The friend-item and tie-item tables are built once on the host with scipy
products of the trust and rating matrices (``build_graph``) and sampled on
the device (``ops/sampling.sample_from_rows``). Both rank through K2's
fused top-k.

On a mesh each data rank's loss is its rows of the batch
(``batch_share``): every term of both losses is a sum over them. The
tables are built whole on every rank, and every rank draws the same
batches.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..ops import sampling
from ..ops.losses import bpr_loss
from .base import SocialRecommender, TrainSpec
from .social_graph import _binary_interactions


def _csr_tables(mat: sp.csr_matrix, device):
    """(indptr, indices) int64 and data f32 of a CSR matrix on ``device``,
    each row's columns sorted as ``csr_member``'s bisection needs (scipy's
    products leave them unsorted); the data end with one 0 more, so an
    empty table can be read at 0."""
    mat = mat.sorted_indices()
    as_long = lambda a: torch.as_tensor(a.astype(np.int64), device=device)  # noqa: E731
    vals = np.concatenate([mat.data.astype(np.float32), np.zeros(1, np.float32)])
    return as_long(mat.indptr), as_long(mat.indices), torch.as_tensor(vals, device=device)


class _SocialBPR(SocialRecommender):
    """The (U, d) and (I, d) tables, the bold mode, the host build before
    the first epoch and the epoch order of the training pairs."""

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        for name, t in self.init_embeddings(self.init_kind()).items():
            setattr(self, name, nn.Parameter(t))

    def init_kind(self) -> str:
        return "uniform"

    def factors(self):
        return self.user_emb.detach(), self.item_emb.detach()

    def build(self) -> TrainSpec:
        """The host build and the bold-mode spec, which may chunk under
        ``-tf``; the training pairs and the rated bitmask that ``sampler``
        reads are put on the device here, before a chunked run's capture."""
        self.prepare_graph()
        self.train_arrays, self.rated_bitmask
        return TrainSpec(list(self.parameters()), self.loss, self.sampler,
                         score_params_fn=self.factors, mode="bold", chunkable=True)


class SBPR(_SocialBPR):
    """Social BPR with the followees' items as a middle tier. Users without
    friend items fall back to plain BPR ``i ≻ j``, with L2 on the batch's
    rows. A negative is drawn in 8 tries that avoid the user's positives
    and friend items, then exactly among the non-positives.

    Under ``evaluation.setup ... -tf``, the reference's TF path
    (SBPR.py:73-123; its numpy path fails upstream): a truncated-normal
    init, the training pairs in file order, a random middle item for a user
    without friend items (with S_uk 0), ``log(σ(x) + 1e-6)``, Adam, and no
    regularization: the reference puts its reg term on a line of its own
    after the loss statement, so it never enters the loss. Both
    paths are kept."""

    def read_configuration(self) -> None:
        super().read_configuration()
        self.tf_path = self.eval_settings.contains("-tf")

    def init_kind(self) -> str:
        return "normal" if self.tf_path else "uniform"

    def friend_items(self) -> sp.csr_matrix:
        """(U, I) counts of the followees who consumed each item (trust
        weights summed), the user's own positives removed (SBPR.py:15-29)."""
        r = _binary_interactions(self.data)
        fp = self.social.scipy_adjacency() @ r
        fp = fp - fp.multiply(r)
        fp.eliminate_zeros()
        return fp.tocsr()

    def build_graph(self) -> None:
        fp = self.friend_items()
        self.fp_indptr, self.fp_indices, self.fp_vals = _csr_tables(fp, self.device)
        self.fp_iters = sampling._bisect_iters(int(np.max(np.diff(fp.indptr))) if fp.nnz else 1)

    def _friend_item_member(self, users, items):
        return sampling.csr_member(self.fp_indices, self.fp_indptr, users, items, self.fp_iters)

    def sampler(self, gen: torch.Generator):
        """(users, pos, middle, neg, S_uk, has friend items, weight) epoch
        tensors shaped (num_batches, batch_size)."""
        users, pos, w = self._pairs(gen, shuffle=not self.tf_path)
        k_items, has_fp, idx = sampling.sample_from_rows(gen, self.fp_indptr, self.fp_indices, users)
        if self.tf_path:
            rand_k = torch.randint(0, self.num_items, users.shape, generator=gen, device=self.device)
            k_items = torch.where(has_fp, k_items, rand_k)
        suk = torch.where(has_fp, self.fp_vals[idx], 0.0)
        neg = self._negatives(gen, users, self._friend_item_member)
        return self._batched(users, pos, k_items, neg, suk, has_fp, w)

    def loss(self, batch, gen=None) -> torch.Tensor:
        u, i, k, j, suk, has_fp, w = self.batch_share(batch)
        pu, qi, qk, qj = self.user_emb[u], self.item_emb[i], self.item_emb[k], self.item_emb[j]
        yi, yk, yj = (pu * qi).sum(dim=1), (pu * qk).sum(dim=1), (pu * qj).sum(dim=1)
        y_ik = (yi - yk) / (suk + 1.0)
        y_kj = yk - yj
        if self.tf_path:
            return -(w * (torch.log(torch.sigmoid(y_ik) + 1e-6)
                          + torch.log(torch.sigmoid(y_kj) + 1e-6))).sum()
        has = has_fp.float()
        zero = torch.zeros_like(y_ik)
        loss = (bpr_loss(y_ik, zero, has * w) + bpr_loss(y_kj, zero, has * w)
                + bpr_loss(yi, yj, (1.0 - has) * w))
        reg = 0.5 * (self.reg_u * (w[:, None] * pu**2).sum()
                     + self.reg_i * (w[:, None] * (qi**2 + qj**2 + qk**2)).sum())
        return loss + reg


class TBPR(_SocialBPR):
    """Strong- and weak-tie BPR (TBPR.py) with the chain ``i ≻ joint ≻ weak
    ≻ strong ≻ negative``; L2 on the batch's rows and on the tier items a
    user has."""

    def read_configuration(self) -> None:
        super().read_configuration()
        self.reg_t = self.model_args().get_float("-regT")

    def tie_sets(self):
        """(joint, weak, strong) (U, I) 0/1 CSRs: Jaccard tie strengths of
        the trust edges, split at their median (strong above it), the items
        each side's followees consumed less the user's own, and the items of
        both sides taken out of each into ``joint`` (TBPR.py:20-42,107-135)."""
        src, dst, _ = self.social.coo()
        nu = self.num_users
        f = sp.csr_matrix((np.ones(len(src), dtype=np.float32), (src, dst)), shape=(nu, nu))
        f.data[:] = 1.0
        inter = np.asarray(f[src].multiply(f[dst]).sum(axis=1)).ravel()
        deg = np.asarray(f.sum(axis=1)).ravel()
        union = deg[src] + deg[dst] - inter
        strength = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
        theta = np.median(strength) if len(strength) else 0.0
        strong_mask = strength > theta
        r = _binary_interactions(self.data)

        def tie_items(mask):
            t = sp.csr_matrix((np.ones(mask.sum(), dtype=np.float32), (src[mask], dst[mask])),
                              shape=(nu, nu))
            items = t @ r
            items = items - items.multiply(r)
            items.eliminate_zeros()
            items.data[:] = 1.0
            return items.tocsr()

        strong, weak = tie_items(strong_mask), tie_items(~strong_mask)
        joint = strong.multiply(weak).tocsr()
        joint.eliminate_zeros()
        strong, weak = (strong - joint).tocsr(), (weak - joint).tocsr()
        strong.eliminate_zeros()
        weak.eliminate_zeros()
        return joint, weak, strong

    def build_graph(self) -> None:
        self.tables = [_csr_tables(m, self.device)[:2] for m in self.tie_sets()]

    def sampler(self, gen: torch.Generator):
        """(users, pos, joint, weak, strong, their three has-masks, neg,
        weight) epoch tensors shaped (num_batches, batch_size)."""
        users, pos, w = self._pairs(gen)
        picks, masks = [], []
        for indptr, indices in self.tables:
            item, has, _ = sampling.sample_from_rows(gen, indptr, indices, users)
            picks.append(item)
            masks.append(has)
        neg = self._negatives(gen, users)
        return self._batched(users, pos, *picks, *masks, neg, w)

    def loss(self, batch, gen=None) -> torch.Tensor:
        u, i, jt, wk, st, m_j, m_w, m_s, k, w = self.batch_share(batch)
        p, q = self.user_emb[u], self.item_emb
        score = lambda items: (p * q[items]).sum(dim=1)  # noqa: E731
        last_y = score(i)
        loss = 0.0
        reg_items = q[i] ** 2 + q[k] ** 2
        # the chain, skipping a tier the user lacks (TBPR.py:146-160)
        for item, mask in ((jt, m_j), (wk, m_w), (st, m_s)):
            mask = mask.bool()
            y = score(item)
            loss = loss + bpr_loss(last_y, y, mask.float() * w)
            last_y = torch.where(mask, y, last_y)
            reg_items = reg_items + torch.where(mask[:, None], q[item] ** 2, 0.0)
        loss = loss + bpr_loss(last_y, score(k), w)
        reg = 0.5 * (self.reg_u * (w[:, None] * p**2).sum() + self.reg_i * (w[:, None] * reg_items).sum())
        return loss + reg
