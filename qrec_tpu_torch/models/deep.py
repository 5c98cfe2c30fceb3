"""Deep CF family: NeuMF, DMF, CDAE, CFGAN and APR (reference
model/ranking/NeuMF.py, DMF.py, CDAE.py, CFGAN.py, APR.py; the JAX
package's ``models/deep.py``). IRGAN is in ``gan.py``.

NeuMF and APR train in phases that share one model, each phase through
``run_training`` with a fresh Adam; DMF and CDAE are single-phase specs;
CFGAN alternates its discriminator and generator under two Adams. Tables
start Xavier/glorot uniform (APR: the truncated normal of
``init_embeddings``), drawn on the CPU from ``seed``, not the JAX package's
draws. Every other random number of a model comes from its ``draw``
method, from the trainer's generator: DMF's and CDAE's epoch batches,
CFGAN's users and Bernoulli masks (the JAX package's masks with the same
expected counts as the reference's host loops, e.g. CDAE.py:23-43).

NeuMF's, APR's, DMF's and CDAE's steps read nothing from the host, so
their phases train ``train.chunk`` epochs a dispatch (on a CUDA device one
CUDA graph an epoch, ``runtime/trainer.py``); a phase of one epoch runs
per epoch, as in the JAX package. NeuMF's GMF and MLP phases leave the
other tower's parameters without a gradient, which Adam skips.

NeuMF, DMF, CDAE and CFGAN rank through a :class:`ScoreBlock` of their own
scorer, as the JAX package ranks them through XLA; APR ranks ``U·Vᵀ``
through the masked top-k kernel.

On a mesh NeuMF, DMF, CDAE and APR train data-parallel: each data rank's
loss is its share of the step's (``parallel/mesh.py``), the terms that sum
over a batch's rows on its rows (``batch_share``), the terms over whole
tables on data rank 0 alone (``adds_table_terms``). CFGAN trains whole on
every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.topk import ScoreBlock
from ..runtime import trainer as T
from .base import IterativeRecommender, TrainSpec

_EPS = 10e-10  # NeuMF.py's log guard


def xavier(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """A glorot-uniform (fan_in, fan_out) f32 table on the CPU."""
    t = torch.empty(shape, dtype=torch.float32)
    nn.init.xavier_uniform_(t, generator=gen)
    return t


def _parameters(module: nn.Module, tables: dict) -> None:
    """Register each of ``tables`` on ``module``'s device, by its JAX name."""
    for name, t in tables.items():
        setattr(module, name, nn.Parameter(t.to(module.device)))


def _l2(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ of each tensor's sum of squares, added in order."""
    return sum((t**2).sum() for t in tensors)


class NeuMF(IterativeRecommender):
    """GMF + a 3-layer ReLU MLP, fused in one sigmoid head (NeuMF.py:44-76),
    trained in three phases on pointwise batches (4 negatives a positive):
    GMF for ``num.max.epoch`` epochs, the MLP for max(1, maxEpoch // 2), the
    fused model for max(1, maxEpoch // 5) (NeuMF.py:79-100). Parameters:
    ``PG``, ``QG`` (GMF), ``PM``, ``QM`` (MLP) (U or I, d); ``h_mf``,
    ``h_mlp`` (d,); ``W1`` (2d, 5d), ``W2`` (5d, 2d), ``W3`` (2d, d) and
    their biases ``b1..b3``, applied as ``h @ W + b``."""

    # pairs through the towers per ranking batch: batch x I
    eval_batch_size = 32

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        gen = torch.Generator().manual_seed(self.seed)
        d, nu, ni = self.emb_size, self.num_users, self.num_items
        _parameters(self, {
            "PG": xavier(gen, (nu, d)), "QG": xavier(gen, (ni, d)),
            "PM": xavier(gen, (nu, d)), "QM": xavier(gen, (ni, d)),
            "h_mf": xavier(gen, (d, 1))[:, 0], "h_mlp": xavier(gen, (d, 1))[:, 0],
            "W1": xavier(gen, (2 * d, 5 * d)), "b1": torch.zeros(5 * d),
            "W2": xavier(gen, (5 * d, 2 * d)), "b2": torch.zeros(2 * d),
            "W3": xavier(gen, (2 * d, d)), "b3": torch.zeros(d),
        })

    def mlp_tower(self, um: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        h = torch.cat([um, im], dim=-1)
        h = F.relu(h @ self.W1 + self.b1)
        h = F.relu(h @ self.W2 + self.b2)
        return F.relu(h @ self.W3 + self.b3)

    def y_mf(self, u, i) -> torch.Tensor:
        return torch.sigmoid((self.PG[u] * self.QG[i]) @ self.h_mf)

    def y_mlp(self, u, i) -> torch.Tensor:
        return torch.sigmoid(self.mlp_tower(self.PM[u], self.QM[i]) @ self.h_mlp)

    def y_neu(self, u, i) -> torch.Tensor:
        gmf = self.PG[u] * self.QG[i]
        mlp = self.mlp_tower(self.PM[u], self.QM[i])
        return torch.sigmoid(0.5 * (gmf @ self.h_mf) + 0.5 * (mlp @ self.h_mlp))

    @staticmethod
    def _ce(y, r, w) -> torch.Tensor:
        return -(w * (r * torch.log(y + _EPS) + (1 - r) * torch.log(1 - y + _EPS))).sum()

    def _mf_reg(self, u, i) -> torch.Tensor:
        """The GMF tower's L2 on the batch's rows and, on data rank 0
        alone, on the whole ``h_mf``."""
        reg = 0.5 * (self.PG[u] ** 2).sum() + 0.5 * (self.QG[i] ** 2).sum()
        if self.adds_table_terms:
            reg = reg + 0.5 * (self.h_mf**2).sum()
        return self.reg_u * reg

    def loss_mf(self, batch, gen=None) -> torch.Tensor:
        u, i, r, w = self.batch_share(batch)
        return self._ce(self.y_mf(u, i), r, w) + self._mf_reg(u, i)

    def loss_mlp(self, batch, gen=None) -> torch.Tensor:
        u, i, r, w = self.batch_share(batch)
        return self._ce(self.y_mlp(u, i), r, w)

    def loss_neu(self, batch, gen=None) -> torch.Tensor:
        u, i, r, w = self.batch_share(batch)
        reg = self._mf_reg(u, i)
        if self.adds_table_terms:
            h_neu = torch.cat([0.5 * self.h_mf, 0.5 * self.h_mlp])
            reg = reg + self.reg_u * 0.5 * (h_neu**2).sum()
        return self._ce(self.y_neu(u, i), r, w) + reg

    def fit_phases(self) -> None:
        params = list(self.parameters())
        sampler = self.pointwise_sampler()
        print("pretraining... (GMF)")
        self.run_training(params, self.loss_mf, sampler, chunkable=True)
        print("pretraining... (MLP)")
        self.run_training(params, self.loss_mlp, sampler, max_epoch=max(1, self.max_epoch // 2),
                          chunkable=True)
        print("training... (NeuMF)")
        self.run_training(params, self.loss_neu, sampler, max_epoch=max(1, self.max_epoch // 5),
                          chunkable=True)

    def scores(self, uids: torch.Tensor) -> torch.Tensor:
        """(B, I): the fused prediction of every (user, item) pair."""
        n = self.num_items
        items = torch.arange(n, device=self.device).repeat(uids.shape[0])
        return self.y_neu(uids.repeat_interleave(n), items).view(-1, n)

    def score_form(self) -> ScoreBlock:
        return ScoreBlock(self.scores)

    def predict_ratings(self, users, items) -> np.ndarray:
        uids, iids = self._ids(users, items)
        with torch.no_grad():
            y = self.y_neu(self._at(uids), self._at(iids)).cpu().numpy()
        return self._mean_fallback(uids, iids, y)


class DMF(IterativeRecommender):
    """Deep matrix factorization (DMF.py:44-115): a user tower over each
    user's rating row and an item tower over each item's rating column (two
    ReLU layers, 256 and 512 wide), scored by cosine, with a cross-entropy
    on the raw ratings as targets (DMF.py:85) against 5 uniform (user, item)
    negatives a positive, drawn with no rejection. Parameters: ``uW1`` (I,
    256), ``uW2`` (256, 512), ``ub2`` (512,), ``iW1`` (U, 256), ``iW2``,
    ``ib2``."""

    hidden = (256, 512)
    negative_sp = 5

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        gen = torch.Generator().manual_seed(self.seed)
        h1, h2 = self.hidden
        _parameters(self, {
            "uW1": xavier(gen, (self.num_items, h1)), "uW2": xavier(gen, (h1, h2)),
            "ub2": xavier(gen, (1, h2))[0],
            "iW1": xavier(gen, (self.num_users, h1)), "iW2": xavier(gen, (h1, h2)),
            "ib2": xavier(gen, (1, h2))[0],
        })

    @property
    def dense_ratings_t(self) -> torch.Tensor:
        """The (I, U) item columns, cached."""
        if not hasattr(self, "_dense_rt"):
            self._dense_rt = self.dense_ratings().T.contiguous()
        return self._dense_rt

    def user_tower(self, rows: torch.Tensor) -> torch.Tensor:
        return F.relu(F.relu(rows @ self.uW1) @ self.uW2 + self.ub2)

    def item_tower(self, cols: torch.Tensor) -> torch.Tensor:
        return F.relu(F.relu(cols @ self.iW1) @ self.iW2 + self.ib2)

    def draw(self, gen: torch.Generator):
        """An epoch's batches: max(1, n // batch) batches of shuffled
        training pairs with their ratings (the remainder dropped), and 5
        uniform (user, item) negatives a positive."""
        ta, bs, dev = self.train_arrays, self.batch_size, self.device
        nb = max(1, self.train_size // bs)
        perm = torch.randperm(self.train_size, generator=gen, device=dev)[: nb * bs]
        m = nb * bs * self.negative_sp
        u_neg = torch.randint(0, self.num_users, (m,), generator=gen, device=dev)
        i_neg = torch.randint(0, self.num_items, (m,), generator=gen, device=dev)
        return (ta["u"][perm].view(nb, bs), ta["i"][perm].view(nb, bs), ta["r"][perm].view(nb, bs),
                u_neg.view(nb, -1), i_neg.view(nb, -1))

    def loss(self, batch, gen=None) -> torch.Tensor:
        """The cross-entropy of this data rank's positives and negatives
        (each cut by ``batch_share``: the loss sums over both) and, on data
        rank 0 alone, the L2 of every parameter."""
        u_pos, i_pos, r_pos, u_neg, i_neg = self.batch_share(batch)
        u = torch.cat([u_pos, u_neg])
        i = torch.cat([i_pos, i_neg])
        r = torch.cat([r_pos, torch.zeros(u_neg.shape, device=r_pos.device)])
        uo = self.user_tower(self.dense_ratings()[u])
        io = self.item_tower(self.dense_ratings_t[i])
        cos = (uo * io).sum(dim=1) / (
            torch.linalg.vector_norm(uo, dim=1) * torch.linalg.vector_norm(io, dim=1) + 1e-12
        )
        y = torch.clamp_min(cos, 1e-6)
        ce = -(r * torch.log(y) + (1 - r) * torch.log(torch.clamp_min(1 - y, 1e-6))).sum()
        if not self.adds_table_terms:
            return ce
        return ce + self.reg_u * 0.5 * _l2(self.parameters())

    def build(self) -> TrainSpec:
        """The spec; the dense rating rows and columns and the training
        pairs that ``draw`` reads are put on the device here, before a
        chunked run's capture, not first inside its warm-up epoch."""
        self.dense_ratings_t
        self.train_arrays
        return TrainSpec(list(self.parameters()), self.loss, self.draw, score_params_fn=None,
                         chunkable=True)

    def finalize(self, spec: Optional[TrainSpec] = None) -> None:
        """The towers of every user row and item column."""
        with torch.no_grad():
            self.U = self.user_tower(self.dense_ratings())
            self.V = self.item_tower(self.dense_ratings_t)

    def scores(self, uids: torch.Tensor) -> torch.Tensor:
        """(B, I) cosines of the users' and every item's tower outputs."""
        u = self.U[uids]
        dots = u @ self.V.T
        nu = torch.linalg.vector_norm(u, dim=1, keepdim=True)
        nv = torch.linalg.vector_norm(self.V, dim=1)[None, :]
        return dots / (nu * nv + 1e-12)

    def score_form(self) -> ScoreBlock:
        return ScoreBlock(self.scores)


class _RatingRows(IterativeRecommender):
    """A model fed whole rating rows: the dense ratings and their 0/1
    rated mask on the device."""

    @property
    def rated(self) -> torch.Tensor:
        """(U, I) f32: 1 where the user rated the item. Cached."""
        if not hasattr(self, "_rated"):
            self._rated = (self.dense_ratings() > 0).float()
        return self._rated


class CDAE(_RatingRows):
    """Collaborative denoising autoencoder with a per-user input embedding
    (CDAE.py:13-96): ``-co`` keeps each input with that probability, ``-nh``
    hidden units. One random user batch an epoch; negatives are Bernoulli
    with p = clip(5 deg(u) / I) over the unrated items. Parameters: ``V``
    (U, nh), ``enc_w`` (I, nh), ``enc_b`` (nh,), ``dec_w`` (nh, I),
    ``dec_b`` (I,)."""

    negative_sp = 5

    def read_configuration(self) -> None:
        super().read_configuration()
        args = self.model_args()
        self.corruption_level = args.get_float("-co")
        self.n_hidden = args.get_int("-nh")

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        gen = torch.Generator().manual_seed(self.seed)
        nh = self.n_hidden
        _parameters(self, {
            "V": xavier(gen, (self.num_users, nh)),
            "enc_w": xavier(gen, (self.num_items, nh)), "enc_b": xavier(gen, (1, nh))[0],
            "dec_w": xavier(gen, (nh, self.num_items)), "dec_b": xavier(gen, (1, self.num_items))[0],
        })

    def forward(self, x: torch.Tensor, uids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        enc = torch.sigmoid((mask * x) @ self.enc_w + self.enc_b + self.V[uids])
        return torch.sigmoid(enc @ self.dec_w + self.dec_b)

    def draw(self, gen: torch.Generator):
        """An epoch's one batch, shaped (1, batch, ...): uniform users, the
        corruption mask (keep with probability ``-co``, CDAE.py:90-92) and
        the Bernoulli negatives."""
        bs, ni, dev = self.batch_size, self.num_items, self.device
        uids = torch.randint(0, self.num_users, (1, bs), generator=gen, device=dev)
        mask = torch.rand((1, bs, ni), generator=gen, device=dev) < self.corruption_level
        deg = self.rated.sum(dim=1)
        p = torch.clamp(self.negative_sp * deg[uids[0]] / ni, 0.0, 1.0)
        negm = torch.rand((1, bs, ni), generator=gen, device=dev) < p[:, None]
        return uids, mask.float(), negm.float()

    def loss(self, batch, gen=None) -> torch.Tensor:
        """The cross-entropy's mean over the batch's (B, I) entries and the
        L2 of the weights and of the batch's user rows. On a mesh the mean
        is this data rank's sum over its rows divided by the whole batch's
        count, and the weights' L2 is data rank 0's alone."""
        count = batch[1].numel()
        uids, mask, negm = self.batch_share(batch)
        x = self.dense_ratings()[uids]
        pos = self.rated[uids]
        negative = negm * (1 - pos)
        pred = torch.clamp_min(self(x, uids, mask) * mask, 1e-6)
        ce = -(pos * mask) * torch.log(pred) - (negative * mask) * torch.log(torch.clamp_min(1 - pred, 1e-6))
        reg = (self.V[uids] ** 2).sum()
        if self.adds_table_terms:
            reg = _l2((self.enc_w, self.dec_w, self.enc_b, self.dec_b)) + reg
        return ce.sum() / count + self.reg_u * 0.5 * reg

    def build(self) -> TrainSpec:
        """The spec; the dense rating rows and their rated mask are made
        here, before a chunked run's capture, not first inside its warm-up
        epoch."""
        self.rated
        return TrainSpec(list(self.parameters()), self.loss, self.draw, score_params_fn=None,
                         chunkable=True)

    def finalize(self, spec: Optional[TrainSpec] = None) -> None:
        pass

    def scores(self, uids: torch.Tensor) -> torch.Tensor:
        """(B, I): the decoder's output on the users' uncorrupted rows."""
        x = self.dense_ratings()[uids]
        return self(x, uids, torch.ones_like(x))

    def score_form(self) -> ScoreBlock:
        return ScoreBlock(self.scores)


class CFGAN(_RatingRows):
    """Conditional GAN over whole rating rows (CFGAN.py:46-127): the
    generator G(c) = σ(c W + b) proposes a row from the user's row c, the
    discriminator D(x, c) = σ([x, c] W + b) scores it. The G loss adds the
    zero-reconstruction penalty α/2 Σ (n_zr ⊙ fake)² over sampled unrated
    columns; partial masking keeps the positives and sampled unrated
    columns of the fake row. One batch an epoch: one D step, then three G
    steps on the same batch, under separate Adams. Parameters: ``g.W1``
    (I, I), ``g.b1`` (I,), ``d.W1`` (2I, 1), ``d.b1`` (1,). On a mesh its
    training is replicated: every rank trains the whole model from the
    same seed and ranks every test user."""

    s_zr = 0.001
    s_pm = 0.001
    alpha = 0.01
    g_steps = 3

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        gen = torch.Generator().manual_seed(self.seed)
        ni = self.num_items
        self.g = nn.ParameterDict({"W1": xavier(gen, (ni, ni)), "b1": torch.zeros(ni)}).to(self.device)
        self.d = nn.ParameterDict({"W1": xavier(gen, (2 * ni, 1)), "b1": torch.zeros(1)}).to(self.device)

    def generate(self, c: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(c @ self.g["W1"] + self.g["b1"])

    def discriminate(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(torch.cat([x, c], dim=1) @ self.d["W1"] + self.d["b1"])

    def d_loss(self, c, mask, fake=None) -> torch.Tensor:
        """−mean[log D(c, c) + log(1 − D(G(c) ⊙ mask, c))] (CFGAN.py:108);
        ``fake`` = G(c) ⊙ mask when the caller has it."""
        if fake is None:
            fake = self.generate(c) * mask
        d_real = self.discriminate(c, c)
        d_fake = self.discriminate(fake, c)
        return -torch.mean(torch.log(d_real + 10e-5) + torch.log(1.0 - d_fake + 10e-5))

    def g_loss(self, c, mask, n_zr) -> torch.Tensor:
        """mean log(1 − D(fake, c)) + α/2 Σ (n_zr ⊙ fake)² (CFGAN.py:109)."""
        fake = self.generate(c) * mask
        d_fake = self.discriminate(fake, c)
        zr = self.alpha * 0.5 * ((n_zr * fake) ** 2).sum()
        return torch.mean(torch.log(1.0 - d_fake + 10e-5)) + zr

    def draw(self, gen: torch.Generator):
        """An epoch's random inputs: ``batch_size`` uniform users and two
        (batch, I) bool Bernoulli draws, at ``s_zr`` (zero reconstruction)
        and ``s_pm`` (partial masking)."""
        shape = (self.batch_size, self.num_items)
        uids = torch.randint(0, self.num_users, (self.batch_size,), generator=gen, device=self.device)
        zr = torch.rand(shape, generator=gen, device=self.device) < self.s_zr
        pm = torch.rand(shape, generator=gen, device=self.device) < self.s_pm
        return uids, zr, pm

    def batch(self, draws):
        """(c, mask, n_zr) of an epoch's draws: the users' rows, the
        positives plus the sampled unrated columns, the sampled unrated
        columns of the zero-reconstruction term."""
        uids, zr, pm = draws
        c = self.dense_ratings()[uids]
        pos = self.rated[uids]
        return c, pos + pm.float() * (1 - pos), zr.float() * (1 - pos)

    def train_epoch(self, gen: torch.Generator, g_opt, d_opt) -> torch.Tensor:
        """One epoch: its batch from ``gen``'s draws, one D step, then
        ``g_steps`` G steps on the same batch; the D loss and the last G
        loss as a (2,) tensor."""
        g_params, d_params = list(self.g.values()), list(self.d.values())
        c, mask, n_zr = self.batch(self.draw(gen))
        with torch.no_grad():
            fake = self.generate(c) * mask
        dl = self.d_loss(c, mask, fake)
        T.step(d_opt, dl, d_params)
        for _ in range(self.g_steps):
            gl = self.g_loss(c, mask, n_zr)
            T.step(g_opt, gl, g_params)
        return torch.stack([dl.detach(), gl.detach()])

    def fit_phases(self) -> None:
        """``num.max.epoch`` epochs under the two Adams. Where the run has
        more than one epoch (``own_loop_form``) an epoch is one CUDA graph on a
        card, captured before the first and replayed once an epoch, as the
        JAX package runs one jitted epoch. The losses are read on the host
        at the epochs printed, every 20th and the last, as the JAX package
        reads them."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        g_opt = T.make_optimizer(list(self.g.values()), "adam", self.lrate)
        d_opt = T.make_optimizer(list(self.d.values()), "adam", self.lrate)
        # the rating rows and their mask, on the device before a capture
        self.rated
        graphs = self.own_loop_form(self.max_epoch)

        def emit(epoch, row):
            print(f"{self.model_name} {self.fold} epoch {epoch + 1}: "
                  f"D_loss = {row[0]:.4f} G_loss = {row[1]:.4f}")

        rows = T.run_own_epochs(
            [*self.g.values(), *self.d.values()], [g_opt, d_opt], gen,
            lambda _, g: self.train_epoch(g, g_opt, d_opt), epochs=self.max_epoch, every=20,
            device=self.device, timer=self.timer, graphs=graphs, emit=emit, width=2)
        self.epoch_losses, self.g_losses = [r[0] for r in rows], [r[1] for r in rows]
        self.phase_losses.append(self.epoch_losses)

    def scores(self, uids: torch.Tensor) -> torch.Tensor:
        """(B, I): the generator's row for each user's rating row."""
        return self.generate(self.dense_ratings()[uids])

    def score_form(self) -> ScoreBlock:
        return ScoreBlock(self.scores)


class APR(IterativeRecommender):
    """Adversarial personalized ranking (APR.py:43-53,100-121): BPR with a
    softplus for max(1, maxEpoch // 2) epochs, then as long again with the
    FGSM-perturbed loss: Δ = ε ∇/‖∇‖ for each gathered user, positive and
    negative row of the batch, taken with respect to those rows (so a user
    twice in a batch gets one Δ per row) and held constant. Parameters:
    ``user_emb`` (U, d), ``item_emb`` (I, d), truncated normal σ=0.005.
    On a mesh both losses take this data rank's rows of the batch: the
    softplus loss sums over rows, so a row's Δ depends on that row alone
    and a share's Δ are one process's, with no collective."""

    def read_configuration(self) -> None:
        super().read_configuration()
        args = self.model_args()
        self.eps = args.get_float("-eps")
        self.reg_adv = args.get_float("-regA")
        self.adv_epoch = args.get_int("-advEpoch")

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        tables = self.init_embeddings("normal")
        self.user_emb = nn.Parameter(tables["user_emb"])
        self.item_emb = nn.Parameter(tables["item_emb"])

    @staticmethod
    def softplus_bpr(pu, qi, qj, w) -> torch.Tensor:
        y = (pu * qi).sum(dim=1) - (pu * qj).sum(dim=1)
        return (w * F.softplus(-y)).sum()

    def _rows(self, batch):
        u, i, j, w = self.batch_share(batch)
        return self.user_emb[u], self.item_emb[i], self.item_emb[j], w

    def _reg(self, pu, qi) -> torch.Tensor:
        return self.reg_u * 0.5 * ((pu**2).sum() + (qi**2).sum())

    def base_loss(self, batch, gen=None) -> torch.Tensor:
        pu, qi, qj, w = self._rows(batch)
        return self.softplus_bpr(pu, qi, qj, w) + self._reg(pu, qi)

    def perturbations(self, loss: torch.Tensor, rows) -> Tuple[torch.Tensor, ...]:
        """Δ = ε ∇/‖∇‖ of ``loss`` for each row of ``rows`` (the batch's
        gathered user, positive and negative rows), held constant."""
        grads = torch.autograd.grad(loss, rows, retain_graph=True)
        return tuple(self.eps * g / (torch.linalg.vector_norm(g, dim=1, keepdim=True) + 1e-12)
                     for g in grads)

    def adv_loss(self, batch, gen=None) -> torch.Tensor:
        pu, qi, qj, w = self._rows(batch)
        loss = self.softplus_bpr(pu, qi, qj, w)
        du, di, dj = self.perturbations(loss, (pu, qi, qj))
        adv = self.softplus_bpr(pu + du, qi + di, qj + dj, w)
        return loss + self._reg(pu, qi) + self.reg_adv * adv

    def fit_phases(self) -> None:
        params = list(self.parameters())
        sampler = self.pairwise_sampler()
        epochs = max(1, self.max_epoch // 2)
        print("pretraining...")
        self.run_training(params, self.base_loss, sampler, max_epoch=epochs, chunkable=True)
        print("adversarial training...")
        self.run_training(params, self.adv_loss, sampler, max_epoch=epochs, chunkable=True)
        self.U, self.V = self.user_emb.detach(), self.item_emb.detach()
