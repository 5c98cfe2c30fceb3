"""IRGAN: a minimax generator and discriminator over the catalog, the
generator trained by policy gradient with importance sampling
(model/ranking/IRGAN.py; the JAX package's ``models/gan.py``).

The reference loops user by user on the host for the discriminator's
negatives (IRGAN.py:80-100) and the generator's updates (IRGAN.py:141-168);
as in the JAX package, every step here covers all users at once: the
catalog logits of every user, categorical samples padded to a static count
per user (2 and 3 per positive of the largest degree) with a mask for each
user's own count. The samples come from ``draw``: ``torch.multinomial``
with replacement, the distribution the JAX package draws by Gumbel-max
(``jax.random.categorical``) without its (k, U, I) block of uniforms.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.topk import ScoreForm
from ..runtime import trainer as T
from .base import IterativeRecommender

TEMPERATURE = 0.2  # IRGAN.py:87
SAMPLE_LAMBDA = 0.2  # IRGAN.py:143


def generator_sampling_dist(prob, pos_pad, pos_mask, deg, lam: float = SAMPLE_LAMBDA):
    """Importance-sampling proposal pn = (1-λ)·softmax + λ·uniform over the
    user's positives (IRGAN.py:146-153): each positive of a user gains
    λ/|pos|. ``pos_pad`` (U, maxdeg) int64 holds the positives padded with
    item 0, ``pos_mask`` (U, maxdeg) f32 their validity, ``deg`` (U,) f32
    the counts."""
    bump = lam / torch.clamp_min(deg, 1.0)
    return ((1 - lam) * prob).scatter_add_(1, pos_pad, bump[:, None] * pos_mask)


def importance_reward(d_logits, prob, pn, sample):
    """Policy-gradient reward 2·(σ(D) − 0.5), importance-corrected by
    prob / pn at the sampled items (IRGAN.py:155-160)."""
    reward = 2 * (torch.sigmoid(d_logits) - 0.5)
    return reward * prob.gather(1, sample) / torch.clamp_min(pn.gather(1, sample), 1e-20)


def _uniform(gen: torch.Generator, shape, scale: float = 0.05) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-scale, scale, generator=gen)


class IRGAN(IterativeRecommender):
    """Each epoch takes 5 discriminator steps and 10 generator steps, each
    on fresh samples under its own Adam. The discriminator's negatives are
    drawn from the generator's softmax at temperature 0.2 over the unrated
    items, 2 a positive; the generator samples 3 a positive from its
    importance proposal and is rewarded by the discriminator. Ranking takes
    the discriminator's ``U·Vᵀ + item_bias`` (IRGAN.py:176-180). Parameters:
    ``gen.*`` and ``dis.*``, each ``user_emb`` (U, d), ``item_emb`` (I, d)
    U(-0.05, 0.05) and ``item_bias`` (I,) zeros. On a mesh its training is
    replicated: every rank trains the whole model from the same seed."""

    eval_batch_size = 512
    d_steps, g_steps = 5, 10

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        gen = torch.Generator().manual_seed(self.seed)
        d, nu, ni = self.emb_size, self.num_users, self.num_items
        for name in ("gen", "dis"):
            tables = {"user_emb": _uniform(gen, (nu, d)), "item_emb": _uniform(gen, (ni, d)),
                      "item_bias": torch.zeros(ni)}
            setattr(self, name, nn.ParameterDict(tables).to(self.device))
        deg = np.diff(self.data.u_indptr)
        max_deg = int(deg.max()) if self.train_size else 1
        # the padded (U, max_deg) positives, item 0 in the padding
        slot = np.arange(max_deg)[None, :]
        valid = slot < deg[:, None]
        pad = np.zeros((nu, max_deg), dtype=np.int64)
        pad[valid] = self.data.u_indices
        self.pos_pad = torch.as_tensor(pad, device=self.device)
        self.pos_mask = torch.as_tensor(valid, dtype=torch.float32, device=self.device)
        self.deg = torch.as_tensor(deg, dtype=torch.float32, device=self.device)
        self.k_neg = 2 * max_deg  # IRGAN.py:91
        self.k_gen = 3 * max_deg  # IRGAN.py:155

    @staticmethod
    def all_logits(params: nn.ParameterDict) -> torch.Tensor:
        """(U, I): every user's ``U·Vᵀ + item_bias``."""
        return params["user_emb"] @ params["item_emb"].T + params["item_bias"][None, :]

    def draw(self, probs: torch.Tensor, k: int, rng: torch.Generator) -> torch.Tensor:
        """(U, k) int64: k items a user drawn with replacement from each row
        of ``probs`` (U, I)."""
        return torch.multinomial(probs, k, replacement=True, generator=rng)

    def _reg(self, params: nn.ParameterDict) -> torch.Tensor:
        return self.reg_u * 0.5 * (
            (params["user_emb"] ** 2).sum() + (params["item_emb"] ** 2).sum()
            + (params["item_bias"] ** 2).sum()
        )

    @staticmethod
    def _pair_logits(params: nn.ParameterDict, items: torch.Tensor) -> torch.Tensor:
        """(U, n): each user's logit of its n ``items`` (U, n)."""
        v = params["item_emb"][items]
        return (params["user_emb"][:, None, :] * v).sum(-1) + params["item_bias"][items]

    def d_inputs(self, rng: torch.Generator):
        """A discriminator step's negatives (U, k_neg) from the generator's
        tempered softmax with the positives masked out, and their mask
        (2 a positive)."""
        with torch.no_grad():
            logits = self.all_logits(self.gen) / TEMPERATURE
            mask = torch.zeros_like(logits).scatter_add_(1, self.pos_pad, -1e30 * self.pos_mask)
            negs = self.draw(torch.softmax(logits + mask, dim=1), self.k_neg, rng)
        neg_mask = (torch.arange(self.k_neg, device=self.device)[None, :] < 2 * self.deg[:, None]).float()
        return negs, neg_mask

    def d_loss(self, negs: torch.Tensor, neg_mask: torch.Tensor) -> torch.Tensor:
        """Softplus cross-entropy of every user's positives against its
        negatives, plus L2 of the discriminator's tables."""
        pos_ce = self.pos_mask * F.softplus(-self._pair_logits(self.dis, self.pos_pad))
        neg_ce = neg_mask * F.softplus(self._pair_logits(self.dis, negs))
        return pos_ce.sum() + neg_ce.sum() + self._reg(self.dis)

    def g_inputs(self, rng: torch.Generator):
        """A generator step's samples (U, k_gen) from the importance
        proposal, their importance-corrected rewards and the mask of the
        samples that count (3 a positive); the rewards are masked."""
        with torch.no_grad():
            prob = torch.log_softmax(self.all_logits(self.gen), dim=1).exp()
            pn = generator_sampling_dist(prob, self.pos_pad, self.pos_mask, self.deg)
            sample = self.draw(pn, self.k_gen, rng)
            samp_mask = (torch.arange(self.k_gen, device=self.device)[None, :]
                         < 3 * self.deg[:, None]).float()
            reward = importance_reward(self._pair_logits(self.dis, sample), prob, pn, sample)
        return sample, reward * samp_mask, samp_mask

    def g_loss(self, sample: torch.Tensor, reward: torch.Tensor, samp_mask: torch.Tensor) -> torch.Tensor:
        """The policy gradient −Σ log p(sample)·reward over the samples that
        count, plus L2 of the generator's tables."""
        log_prob = torch.log_softmax(self.all_logits(self.gen), dim=1)
        pg = -(log_prob.gather(1, sample) * reward).sum() / torch.clamp_min(samp_mask.sum(), 1.0)
        return pg + self._reg(self.gen)

    def train_epoch(self, rng: torch.Generator, d_opt, g_opt) -> torch.Tensor:
        """One epoch: ``d_steps`` discriminator steps, then ``g_steps``
        generator steps, each on fresh samples from ``rng``; the last D and
        G losses as a (2,) tensor."""
        d_params, g_params = list(self.dis.values()), list(self.gen.values())
        for _ in range(self.d_steps):
            dl = self.d_loss(*self.d_inputs(rng))
            T.step(d_opt, dl, d_params)
        for _ in range(self.g_steps):
            gl = self.g_loss(*self.g_inputs(rng))
            T.step(g_opt, gl, g_params)
        return torch.stack([dl.detach(), gl.detach()])

    def fit_phases(self) -> None:
        """``num.max.epoch`` epochs under the two Adams. Where the run has
        more than one epoch (``own_loop_form``) an epoch is one CUDA graph on a
        card, captured before the first and replayed once an epoch, as the
        JAX package runs jitted steps. The losses are read on the host at
        the epochs printed, every 5th and the last, as the JAX package
        reads them."""
        rng = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        d_opt = T.make_optimizer(list(self.dis.values()), "adam", self.lrate)
        g_opt = T.make_optimizer(list(self.gen.values()), "adam", self.lrate)
        graphs = self.own_loop_form(self.max_epoch)

        def emit(epoch, row):
            print(f"{self.model_name} {self.fold} epoch {epoch + 1}: "
                  f"D_loss = {row[0]:.4f} G_loss = {row[1]:.4f}")

        rows = T.run_own_epochs(
            [*self.dis.values(), *self.gen.values()], [d_opt, g_opt], rng,
            lambda _, gen: self.train_epoch(gen, d_opt, g_opt), epochs=self.max_epoch, every=5,
            device=self.device, timer=self.timer, graphs=graphs, emit=emit, width=2)
        self.epoch_losses, self.g_losses = [r[0] for r in rows], [r[1] for r in rows]
        self.phase_losses.append(self.epoch_losses)
        self.U = self.dis["user_emb"].detach()
        self.V = self.dis["item_emb"].detach()
        self.item_bias = self.dis["item_bias"].detach()

    def score_form(self) -> ScoreForm:
        """The discriminator's ``U·Vᵀ + item_bias``: K2's top-k with its
        item-bias epilogue (offset 0, no user bias)."""
        return ScoreForm(self.U, self.V, item_bias=self.item_bias)

    def _extra_state(self) -> dict:
        """The item bias the ranking adds (the JAX package saves U and V
        alone, and its loaded IRGAN has no bias to rank with)."""
        return {"item_bias": self.item_bias}

    def _set_extra_state(self, state: dict) -> None:
        self.item_bias = state["item_bias"]
