"""The adversarial social family, ESRF and RSGAN (reference
model/ranking/ESRF.py and RSGAN.py; the JAX package's
``models/adversarial_social.py``).

ESRF: enhancing social recommendation with adversarial graph refinement.

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
(Glorot), all drawn from one CPU generator seeded ``seed``. On a mesh ESRF
trains data-parallel: both players' losses take this data rank's rows of
the batch (``batch_share``), every rank draws the same segment and
uniforms and builds the generated neighbourhood whole (the motif
``DeviceCOO``'s backward is linear in the cotangent), the joint adjacency
is the mesh's form (K1 on item-column blocks for a dense one), and each
player's gradients are summed over ``data`` before its step.

RSGAN: a CDAE-like generator reads each user's seeded friends (the first 30
positive implicit friends of IF_BPR's meta-path pipeline, plus those that
are also negative friends, :func:`~.ifbpr.friend_lists`) and proposes
virtual friends by a Gumbel softmax over all users; their rated items
(the (I, U) rating matrix as a ``DeviceCOO``), weighted by a learned (U, I)
item selection, give a virtual item by a second Gumbel softmax. The
discriminator trains the social BPR chain ``i ≻ virtual item ≻ j`` and the
generator is rewarded where the virtual item outscores the positive. The
generator pretrains for 30 full-profile Adam steps on its reconstruction;
then every step is a generator step followed by a discriminator step on the
updated generator, each under its own Adam(lr), each with its own (B, U)
and (B, I) uniforms (``draw``). Parameters: ``g.V`` (U, 200), ``g.enc_w``
(U, 200), ``g.dec_w`` (200, U) (Glorot, from a CPU generator seeded
``seed``), ``g.enc_b``, ``g.dec_b`` (zeros), ``g.item_selection`` (U, I)
(0.01), then ``d.user_emb``, ``d.item_emb`` (truncated normal).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..device import f32_products
from ..ops.losses import _l2n, bpr_loss
from ..ops.spmm import spmm
from ..ops.walks import SkipgramDraws
from ..parallel.collectives import all_reduce_sum
from ..runtime import trainer as T
from ..runtime.profiling import StepTimer
from .base import GraphRecommender, SocialRecommender
from .deep import xavier
from .ifbpr import friend_lists, read_negative_feedback
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

    @property
    def user_emb(self) -> torch.Tensor:
        """The discriminator's user table, the ego rows that the joint
        adjacency propagates (as a graph model's ``user_emb``)."""
        return self.d["user_emb"]

    @property
    def item_emb(self) -> torch.Tensor:
        """The discriminator's item table (see ``user_emb``)."""
        return self.d["item_emb"]

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
        u, i, j, w = self.batch_share(batch)
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
        u, i, _, w = self.batch_share(batch)
        alt, rows = self.alt_neighborhood(*draws)
        users, items = self.encode(self.d["user_emb"].detach(), self.d["item_emb"].detach(), alt, rows)
        pu, qi = users[u], items[i]
        y_ui = (pu * qi).sum(dim=1)
        return self.beta * bpr_loss(self._friend_scores(alt, rows, users, u, qi), y_ui, w)

    def optimizers(self):
        """Adam(lr) on the discriminator, Adam(5·lr) on the generator."""
        return (T.make_optimizer(list(self.d.values()), "adam", self.lrate),
                T.make_optimizer(list(self.g.values()), "adam", self.lrate * 5))

    def train_epoch(self, phase: int, batches, gen: torch.Generator, d_opt, g_opt) -> torch.Tensor:
        """One epoch of phase ``phase`` (0 plain, 1 social, 2 adversarial)
        on ``batches``: each step a discriminator step, followed in the
        adversarial phase by a generator step on the updated tables, each
        on draws of its own; returns the sum of the discriminator's losses.
        On a mesh every step of either player sums its gradients over
        ``data``, and the total is summed over ``data``."""
        _, social, adversarial = self.PHASES[phase]
        mesh = self.mesh
        d_params, g_params = list(self.d.values()), list(self.g.values())
        total = torch.zeros((), device=self.device)
        for step in range(batches[0].shape[0]):
            batch = tuple(t[step] for t in batches)
            loss = self.d_loss(batch, self.draw(gen) if social else None, social, adversarial)
            T.step(d_opt, loss, d_params, mesh)
            if adversarial:
                T.step(g_opt, self.g_loss(batch, self.draw(gen)), g_params, mesh)
            total = total + loss.detach()
        if mesh is not None:
            all_reduce_sum(total, mesh.data_group)
        return total

    def run_phase(self, phase: int, epochs: int, gen: torch.Generator, d_opt, g_opt,
                  sampler, state: Optional[T.LoopState] = None) -> None:
        """``epochs`` epochs of phase ``phase``, numbered after the epochs
        already run; an epoch's loss is the sum of its discriminator
        losses. With ``state`` (both players' tables, both Adams and the
        generator, committed at the phase's start) the phase's epoch is one
        program (``runtime/trainer.EpochProgram``: on a card one CUDA graph,
        captured at the phase's start) run through ``ChunkedLoop``,
        ``train.chunk`` epochs a dispatch: one host read a chunk, the epoch
        lines after it. Without, the per-step loop reads every epoch's
        loss."""
        print(self.PHASES[phase][0])
        timer = StepTimer(self.train_size, self.device)
        if state is not None:
            program = T.EpochProgram(
                state, None, sampler, self.device, epoch_batches=self._epoch_batches,
                epoch_fn=lambda batches, g: self.train_epoch(phase, batches, g, d_opt, g_opt))
            loop = T.ChunkedLoop(program, self._chunk_for("adam", True, True), timer=timer,
                                 emit=self._emit, lr=self.lrate)
            losses = loop.run(state, self._epochs_done + epochs)
            self._epochs_done += len(losses)
        else:
            losses = []
            for _ in range(epochs):
                with timer:
                    if self._epoch_batches is not None:
                        batches = T.as_device_batches(self._epoch_batches[self._epochs_done],
                                                      self.device)
                    else:
                        batches = sampler(gen)
                    loss_val = float(self.train_epoch(phase, batches, gen, d_opt, g_opt))
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
        """The three phases of ``max(1, max_epoch // 3)`` epochs under the
        two Adams. Where a phase runs more than one epoch
        (``own_loop_form``), off a mesh, each phase's epoch is one CUDA
        graph on a card, as the
        JAX package runs one jitted scan an epoch; both Adams are then
        capturable, in the per-step loop too, so that both forms step the
        same arithmetic. On a mesh, whose steps hold collectives, every
        phase runs per step under plain Adam."""
        self.prepare_graph()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        d_opt, g_opt = self.optimizers()
        sampler = self.pairwise_sampler()
        epochs = max(1, self.max_epoch // 3)
        graphs, capturable = self.own_loop_form(epochs, collectives=True)
        state = None
        if capturable:
            for opt in (d_opt, g_opt):
                T.make_capturable(opt)
        if graphs:
            for opt in (d_opt, g_opt):
                T.init_adam_state(opt)
            state = T.LoopState(self._epochs_done, [*self.d.values(), *self.g.values()],
                                [d_opt, g_opt], gen)
        for phase in range(len(self.PHASES)):
            self.run_phase(phase, epochs, gen, d_opt, g_opt, sampler, state)
        with torch.no_grad():
            users, items = self.encode(self.d["user_emb"], self.d["item_emb"])
        self.U, self.V = users.contiguous(), items.contiguous()


class RSGAN(SocialRecommender):
    """Social GAN with a Gumbel-softmax CDAE generator of virtual friends
    (RSGAN.py), its friends seeded by IF_BPR's meta-path pipeline. On a
    mesh its training is replicated: every rank builds the friends and
    trains the whole model from the same seed."""

    hidden = 200
    seed_top_k = 100
    seed_keep = 30
    temperature = 0.1
    pretrain_steps = 30  # RSGAN.py:344-349
    skipgram_draws = SkipgramDraws  # the seeding SGNS runs' random inputs (replaceable)

    def __init__(self, conf, data, fold: str = "[1]", device=None, social=None):
        super().__init__(conf, data, fold=fold, device=device, social=social)
        gen = torch.Generator().manual_seed(self.seed)
        nu, ni, h = self.num_users, self.num_items, self.hidden
        self.g = nn.ParameterDict({
            "V": xavier(gen, (nu, h)), "enc_w": xavier(gen, (nu, h)), "enc_b": torch.zeros(h),
            "dec_w": xavier(gen, (h, nu)), "dec_b": torch.zeros(nu),
            "item_selection": torch.full((nu, ni), 0.01),
        }).to(self.device)
        self.d = nn.ParameterDict(self.init_embeddings("normal", gen))

    def seeded_friends(self) -> np.ndarray:
        """(U, U) f32 0/1 profiles: each user's first 30 positive implicit
        friends, plus those also among its negative friends
        (RSGAN.py:221-224), by :func:`~.ifbpr.friend_lists` at walk length
        20, dimension 32, window 5 and top-k ``min(100, U - 1)``."""
        negative = read_negative_feedback(self.config["ratings"], self.data)
        friends = friend_lists(self.data, self.social, self.seed, 20, 32, 5,
                               min(self.seed_top_k, self.num_users - 1), self.device, negative,
                               draws=self.skipgram_draws)
        self.walk_stats = friends.stats
        nu = self.num_users
        seeds = np.zeros((nu, nu), dtype=np.float32)
        for u in range(nu):
            chosen = set(friends.p_ids[u][:self.seed_keep].tolist())
            if friends.n_ids is not None:
                chosen |= set(friends.p_ids[u]) & set(friends.n_ids[u])
            seeds[u, list(map(int, chosen))] = 1.0
        return seeds

    def build_graph(self) -> None:
        self.profiles = torch.tensor(self.seeded_friends(), device=self.device)
        # the (I, U) rating matrix that turns virtual friends into candidate
        # items (RSGAN.py:231-233), a DeviceCOO (the JAX package passes no
        # graph.aux.dense mode)
        iu = sp.csr_matrix((self.data.train_r, (self.data.train_i, self.data.train_u)),
                           shape=(self.num_items, self.num_users))
        self.iu = aux_operator(iu, None, "auto", self.device)
        self._all_users = torch.arange(self.num_users, device=self.device)

    def generate(self, x: torch.Tensor, uids: torch.Tensor) -> torch.Tensor:
        g = self.g
        layer = torch.sigmoid(x @ g["enc_w"] + g["enc_b"] + g["V"][uids])
        return torch.sigmoid(layer @ g["dec_w"] + g["dec_b"])

    def recon_loss(self) -> torch.Tensor:
        """The generator's pretraining loss on every user's full profile:
        clipped cross-entropy plus L2 on the weights and biases."""
        x, g = self.profiles, self.g
        pred = torch.clamp_min(x * self.generate(x, self._all_users), 1e-6)
        ce = -x * torch.log(pred) - (1 - x) * torch.log(torch.clamp_min(1 - pred, 1e-6))
        reg = self.reg_u * 0.5 * ((g["enc_w"] ** 2).sum() + (g["dec_w"] ** 2).sum()
                                  + (g["enc_b"] ** 2).sum() + (g["dec_b"] ** 2).sum())
        return ce.sum() + reg

    def draw(self, gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step's Gumbel uniforms: (B, U) for the virtual friends and
        (B, I) for the virtual items."""
        b = self.batch_size
        return (torch.rand((b, self.num_users), generator=gen, device=self.device),
                torch.rand((b, self.num_items), generator=gen, device=self.device))

    def virtual_items(self, u: torch.Tensor, draws) -> torch.Tensor:
        """(B, d): the discriminator's embedding of each user's virtual
        item."""
        friend_u, item_u = draws
        out = self.generate(self.profiles[u], u)
        vf = gumbel_softmax(friend_u, out, self.temperature)
        cand = spmm(self.iu, vf.T).T
        vi = gumbel_softmax(item_u, cand * self.g["item_selection"][u], self.temperature)
        return vi @ self.d["item_emb"].detach()

    def d_loss(self, batch, draws) -> torch.Tensor:
        """``i ≻ virtual item ≻ j`` with L2 on the batch's rows, the virtual
        item a constant."""
        u, i, j, w = batch
        pu, qi, qj = self.d["user_emb"][u], self.d["item_emb"][i], self.d["item_emb"][j]
        with torch.no_grad():
            vie = self.virtual_items(u, draws)
        y_v = (pu * vie).sum(dim=1)
        y_uf = (pu * qi).sum(dim=1) - y_v
        y_fs = y_v - (pu * qj).sum(dim=1)
        loss = bpr_loss(y_uf, torch.zeros_like(y_uf), w) + bpr_loss(y_fs, torch.zeros_like(y_fs), w)
        wc = w[:, None]
        return loss + self.reg_u * 0.5 * ((wc * pu**2).sum() + (wc * qi**2).sum() + (wc * qj**2).sum())

    def g_loss(self, batch, draws) -> torch.Tensor:
        """``30 Σ w (p·q_i - p·v)``: the generator gains where the virtual
        item outscores the positive; the discriminator's tables constants."""
        u, i, _, w = batch
        pu, qi = self.d["user_emb"][u].detach(), self.d["item_emb"][i].detach()
        y_uf = (pu * qi).sum(dim=1) - (pu * self.virtual_items(u, draws)).sum(dim=1)
        return 30.0 * (w * y_uf).sum()

    def optimizers(self):
        """Adam(lr) on the generator, Adam(lr) on the discriminator."""
        return (T.make_optimizer(list(self.g.values()), "adam", self.lrate),
                T.make_optimizer(list(self.d.values()), "adam", self.lrate))

    def pretrain_step(self, g_opt) -> torch.Tensor:
        """One full-profile pretraining step of the generator; its loss.
        ``item_selection`` takes no part, but its Adam step count advances
        on a zero gradient, as optax's does."""
        params = list(self.g.values())
        loss = self.recon_loss()
        for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True)):
            p.grad = torch.zeros_like(p) if g is None else g
        g_opt.step()
        return loss.detach()

    def pretrain(self, g_opt, program: Optional[T.EpochProgram] = None) -> list:
        """The generator's ``pretrain_steps`` full-profile steps, their
        losses kept on the device and read once after the last (the JAX
        package reads none); with ``program`` (one step, on a card a CUDA
        graph) each step a run of it. The products in f32 throughout, the
        replays too."""
        losses = torch.zeros(self.pretrain_steps, device=self.device)
        with f32_products():
            for k in range(self.pretrain_steps):
                if program is not None:
                    program.run(k)
                    losses[k].copy_(program.loss)
                else:
                    losses[k].copy_(self.pretrain_step(g_opt))
        out = losses.tolist()
        for loss in out:
            T.check_finite(loss)
        return out

    def train_epoch(self, gen: torch.Generator, g_opt, d_opt, batches) -> torch.Tensor:
        """One epoch: each step a generator step, then a discriminator step
        on the updated generator, each on its own draws, the products in
        f32; returns the summed discriminator loss."""
        g_params, d_params = list(self.g.values()), list(self.d.values())
        total = torch.zeros((), device=self.device)
        with f32_products():
            for step in range(batches[0].shape[0]):
                batch = tuple(t[step] for t in batches)
                T.step(g_opt, self.g_loss(batch, self.draw(gen)), g_params)
                loss = self.d_loss(batch, self.draw(gen))
                T.step(d_opt, loss, d_params)
                total = total + loss.detach()
        return total

    def fit_phases(self) -> None:
        """The generator's pretraining, then ``num.max.epoch`` GAN epochs.
        Where the run has more than one epoch (``own_loop_form``), a
        pretraining step is one CUDA graph on a card, replayed
        ``pretrain_steps`` times, and a GAN epoch another, replayed once an
        epoch, as the JAX package runs a jitted step and one jitted scan an
        epoch; both Adams are then capturable (the generator's from its
        first pretraining step), in the per-step loop too. The epochs'
        losses are read on the host at the epochs printed, every 5th and
        the last; f32 products are in force over the captures and the
        replays."""
        self.prepare_graph()
        g_opt, d_opt = self.optimizers()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        graphs, capturable = self.own_loop_form(self.max_epoch)
        self.pretrain_timer = StepTimer(self.num_users, self.device)
        pre = None
        if capturable:
            for opt in (g_opt, d_opt):
                T.make_capturable(opt)
        if graphs:
            T.init_adam_state(g_opt)
            pre = T.EpochProgram(T.LoopState(0, list(self.g.values()), g_opt, None), None, None,
                                 self.device, epoch_fn=lambda *_: self.pretrain_step(g_opt))
            if self.device.type == "cuda":
                with f32_products(), self.pretrain_timer.capture():
                    pre.capture(0)
        print("pretraining for generator...")
        with self.pretrain_timer:
            self.pretrain_losses = self.pretrain(g_opt, pre)
        # the pretraining graph freed now, not during the epoch's capture
        del pre
        print("Training GAN...")

        def emit(epoch, row):
            print(f"{self.model_name} {self.fold} epoch {epoch + 1}: D_loss = {row[0]:.4f}")

        rows = T.run_own_epochs(
            [*self.g.values(), *self.d.values()], [g_opt, d_opt], gen,
            lambda batches, g: self.train_epoch(g, g_opt, d_opt, batches), epochs=self.max_epoch,
            every=5, device=self.device, timer=self.timer, graphs=graphs, emit=emit,
            sampler=self.pairwise_sampler(), epoch_batches=self._epoch_batches,
            context=f32_products)
        self.epoch_losses = [r[0] for r in rows]
        self.phase_losses = [self.epoch_losses]
        self.U = self.d["user_emb"].detach().clone()
        self.V = self.d["item_emb"].detach().clone()
