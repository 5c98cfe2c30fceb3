"""ESRF: enhancing social recommendation with adversarial graph
refinement (reference model/ranking/ESRF.py; the JAX package's
``models/adversarial_social.py``, whose RSGAN seeds its friends through
IF_BPR's meta-path walks and comes with them, ROADMAP slice 5).

A motif-GCN generator proposes K alternative neighbours for a segment of
``min(100, U)`` users by concrete selection (K Gumbel-softmax draws over
all users, summed to a soft multi-hot row; the segment bounds the (seg, K,
U) block, as the reference's workaround for memory, ESRF.py:104-113). A
LightGCN discriminator over the joint adjacency (the dual kernel on the
dense forms) trains in three phases of ``max_epoch // 3`` epochs: plain BPR;
then with the segment's generated neighbourhoods added to its users at
every layer; then the minimax, where each discriminator step is followed by
a generator step on the updated tables, the generator rewarded when the
neighbours' scores beat the user's own. The discriminator trains under
Adam(lr), the generator under Adam(5·lr), one optimizer each for the whole
fit, and one generator seeded ``seed + 1`` draws every epoch's batches and
every step's segment start and Gumbel uniforms (``draw``). The final
factors are the discriminator's propagation without the social term.
Parameters: ``d.user_emb``, ``d.item_emb`` (truncated normal), then
``g.relation_emb`` (U, d) (truncated normal) and ``g.selector`` (K, U)
(Glorot), all drawn from one CPU generator seeded ``seed``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.losses import _l2n, bpr_loss
from ..ops.spmm import spmm
from ..runtime import trainer as T
from ..runtime.profiling import StepTimer
from .base import GraphRecommender, SocialRecommender
from .social_graph import _row_norm, aux_operator, triangle_motifs


def gumbel_softmax(uniforms: torch.Tensor, logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """The reference's ``gumbel_softmax`` (ESRF.py:12-17) on given U(0, 1)
    draws: a softmax over the last axis first, then its log plus Gumbel
    noise, then the tempered softmax."""
    eps = 1e-10
    noise = -torch.log(-torch.log(uniforms + eps) + eps)
    y = torch.log(torch.softmax(logits, dim=-1) + eps) + noise
    return torch.softmax(y / temperature, dim=-1)


class ESRF(SocialRecommender, GraphRecommender):
    n_layers_g = 2  # the generator's motif layers (ESRF.py:95)
    segment = 100
    temperature = 0.2
    PHASES = (("pretraining...", False, False),
              ("normal training with social relations...", True, False),
              ("adversarial training...", True, True))

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        gen = torch.Generator().manual_seed(self.seed)
        self.d = nn.ParameterDict(self.init_embeddings("normal", gen))
        relation = torch.empty((self.num_users, self.emb_size))
        nn.init.trunc_normal_(relation, std=0.005, a=-0.01, b=0.01, generator=gen)
        selector = torch.empty((self.k_sel, self.num_users))
        nn.init.xavier_uniform_(selector, generator=gen)
        self.g = nn.ParameterDict({"relation_emb": relation, "selector": selector}).to(self.device)

    def read_configuration(self) -> None:
        super().read_configuration()
        args = self.model_args()
        self.k_sel = args.get_int("-K")
        self.beta = args.get_float("-beta")
        self.n_layers = args.get_int("-n_layer")

    def motif_adjacency(self):
        """S plus the nine social motifs (a9 one-way) and the co-purchases
        of more than 5 items between distinct users, row-normalized
        (ESRF.py:53-81), a scipy CSR."""
        s, yy, motifs = triangle_motifs(self.social, self.data)
        a10 = yy.tolil()
        a10.setdiag(0)
        a10 = a10.tocsr()
        a = s
        for m in motifs + [a10.multiply(a10 > 5)]:
            a = a + m
        return _row_norm(a.tocsr())

    def build_graph(self) -> None:
        # the JAX package's default ``auto``: a DeviceCOO on the card
        self.motif = aux_operator(self.motif_adjacency(), None, "auto", self.device)
        self.joint_adj
        self.seg = min(self.segment, self.num_users)
        self._seg_rows = torch.arange(self.seg, device=self.device)

    def draw(self, gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """One generated neighbourhood's random inputs: the segment start,
        uniform on [0, max(U - seg, 1)), and the (seg, K, U) Gumbel
        uniforms."""
        start = torch.randint(0, max(self.num_users - self.seg, 1), (), generator=gen,
                              device=self.device)
        uniforms = torch.rand((self.seg, self.k_sel, self.num_users), generator=gen,
                              device=self.device)
        return start, uniforms

    def alt_neighborhood(self, start: torch.Tensor, uniforms: torch.Tensor):
        """(alt (seg, U), rows (seg,)): the segment's soft multi-hot
        alternative neighbourhoods and the users they belong to."""
        e = self.g["relation_emb"]
        acc = x = e
        for _ in range(self.n_layers_g):
            x = spmm(self.motif, x)
            acc = acc + _l2n(x)
        emb = acc / (self.n_layers_g + 1)
        rows = start + self._seg_rows
        alpha = (emb[rows] @ emb.T)[:, None, :] * self.g["selector"][None, :, :]
        return gumbel_softmax(uniforms, alpha, self.temperature).sum(dim=1), rows

    def encode(self, user: torch.Tensor, item: torch.Tensor, alt: Optional[torch.Tensor] = None,
               rows: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(users, items) after ``n_layers`` of the joint adjacency with the
        layer-normalized readout; with ``alt``, every layer adds ``alt @
        users / K`` of its input to the segment's rows."""
        nu = self.num_users
        ego = torch.cat([user, item])
        acc = ego
        for _ in range(self.n_layers):
            new = spmm(self.joint_adj, ego)
            if alt is not None:
                social = alt @ ego[:nu] / self.k_sel
                ego = torch.cat([new[:nu].index_add(0, rows, social), new[nu:]])
            else:
                ego = new
            acc = acc + _l2n(ego)
        return acc[:nu], acc[nu:]

    def _friend_scores(self, alt, rows, users, u, qi) -> torch.Tensor:
        """``(alt_full[u] @ users / K) · q_i``, alt_full the (U, U) rows of
        ``alt`` at the segment's users and 0 elsewhere, not materialized."""
        start = rows[0]
        inside = (u >= start) & (u < start + self.seg)
        seg_friends = (alt @ users)[torch.clamp(u - start, 0, self.seg - 1)]
        friends = torch.where(inside[:, None], seg_friends, 0.0) / self.k_sel
        return (friends * qi).sum(dim=1)

    def d_loss(self, batch, draws, social: bool, adversarial: bool) -> torch.Tensor:
        """The discriminator's BPR loss with L2 on the batch's rows; with
        ``social``, the generated neighbourhood of ``draws`` (a constant) in
        the propagation; ``adversarial`` adds β times the BPR loss of the
        user's own score over its neighbours'."""
        u, i, j, w = batch
        alt = rows = None
        if social:
            with torch.no_grad():
                alt, rows = self.alt_neighborhood(*draws)
        users, items = self.encode(self.d["user_emb"], self.d["item_emb"], alt, rows)
        pu, qi, qj = users[u], items[i], items[j]
        y_ui, y_uj = (pu * qi).sum(dim=1), (pu * qj).sum(dim=1)
        wc = w[:, None]
        loss = bpr_loss(y_ui, y_uj, w) + self.reg_u * 0.5 * (
            (wc * pu**2).sum() + (wc * qi**2).sum() + (wc * qj**2).sum())
        if adversarial:
            loss = loss + self.beta * bpr_loss(y_ui, self._friend_scores(alt, rows, users, u, qi), w)
        return loss

    def g_loss(self, batch, draws) -> torch.Tensor:
        """The generator's loss, β times the BPR loss of the neighbours'
        score over the user's own, the discriminator's tables constants."""
        u, i, _, w = batch
        alt, rows = self.alt_neighborhood(*draws)
        users, items = self.encode(self.d["user_emb"].detach(), self.d["item_emb"].detach(), alt, rows)
        pu, qi = users[u], items[i]
        y_ui = (pu * qi).sum(dim=1)
        return self.beta * bpr_loss(self._friend_scores(alt, rows, users, u, qi), y_ui, w)

    def optimizers(self):
        """Adam(lr) on the discriminator, Adam(5·lr) on the generator."""
        return (T.make_optimizer(list(self.d.values()), "adam", self.lrate),
                T.make_optimizer(list(self.g.values()), "adam", self.lrate * 5))

    def run_phase(self, phase: int, epochs: int, gen: torch.Generator, d_opt, g_opt,
                  sampler) -> None:
        """``epochs`` epochs of phase ``phase`` (0 plain, 1 social, 2
        adversarial), numbered after the epochs already run; an epoch's
        loss is the sum of its discriminator losses."""
        banner, social, adversarial = self.PHASES[phase]
        print(banner)
        d_params, g_params = list(self.d.values()), list(self.g.values())
        timer = StepTimer(self.train_size, self.device)
        losses = []
        for _ in range(epochs):
            with timer:
                if self._epoch_batches is not None:
                    batches = T.as_device_batches(self._epoch_batches[self._epochs_done], self.device)
                else:
                    batches = sampler(gen)
                total = torch.zeros((), device=self.device)
                for step in range(batches[0].shape[0]):
                    batch = tuple(t[step] for t in batches)
                    loss = self.d_loss(batch, self.draw(gen) if social else None, social, adversarial)
                    T.step(d_opt, loss, d_params)
                    if adversarial:
                        T.step(g_opt, self.g_loss(batch, self.draw(gen)), g_params)
                    total = total + loss.detach()
                loss_val = float(total)
            T.check_finite(loss_val)
            losses.append(loss_val)
            self._emit(self._epochs_done, loss_val, self.lrate, timer.last)
            self._epochs_done += 1
        print(f"{self.model_name} {self.fold} phase {phase + 1}: loss = {losses[-1]:.4f}")
        self.epoch_losses += losses
        self.phase_losses.append(losses)
        self.phase_timers.append(timer)
        self.timer.times += timer.times

    def fit_phases(self) -> None:
        self.prepare_graph()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        d_opt, g_opt = self.optimizers()
        sampler = self.pairwise_sampler()
        for phase in range(len(self.PHASES)):
            self.run_phase(phase, max(1, self.max_epoch // 3), gen, d_opt, g_opt, sampler)
        with torch.no_grad():
            users, items = self.encode(self.d["user_emb"], self.d["item_emb"])
        self.U, self.V = users.contiguous(), items.contiguous()
