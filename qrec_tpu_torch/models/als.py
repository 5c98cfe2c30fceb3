"""ALS family: WRMF, ExpoMF, CoFactor and SERec (reference
model/ranking/WRMF.py, ExpoMF.py, CoFactor.py, SERec.py; the JAX package's
``models/als.py``).

Each epoch alternates batched weighted-ridge solves on the device
(``ops/als.py``): users against the item factors, then items against the
new user factors. WRMF weighs each entry ``1 + 10r``; ExpoMF and SERec weigh
it by the exposure posterior and update the exposure prior ``mu`` (per
item for ExpoMF; per user and item for SERec, boosted by what the user's
followees were exposed to); CoFactor adds each item's SPPMI context blocks
to its solve and fits the context factors ``g`` and biases ``w``, ``c``.
The SPPMI matrix is built once on the host with numpy and scipy, the JAX
package's arrays bit for bit; its per-item context blocks are segment sums
over its row-sorted edges (``ops/spmm.segment_sum``: no atomics, so a
seeded run repeats bit for bit).

The initial tables come from :meth:`_ALS.init_tables`, one dict named as
the JAX package names them (``x``, ``y``; ``theta``, ``beta``, ``mu``; and
CoFactor's ``g``, ``w``, ``c``): numpy's ``RandomState(seed)`` draws equal
the JAX package's bit for bit, the ``U(0, 1)·10/3`` tables of WRMF and
CoFactor come from a ``torch.Generator`` seeded with ``seed`` (the JAX
package draws them with ``jax.random``). The first solve overwrites ``x``,
so only ``y`` reaches a result. Each epoch runs inside the synchronised
``StepTimer`` in ``self.timer``; the final tables rank as ``ScoreForm(U,
V)``, K2's fused top-k.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp
import torch

from ..device import f32_products
from ..ops.als import exposure_posterior, solve_factors
from ..ops.spmm import segment_sum
from ..runtime.profiling import StepTimer
from .base import IterativeRecommender, SocialRecommender


class _ALS(IterativeRecommender):
    """The epoch loop: the initial tables, the device constants
    (``prepare``), one timed ``epoch`` at a time, the progress line, and
    the final factors from the tables named in ``factors``."""

    factors = ("x", "y")

    def init_tables(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def prepare(self) -> None:
        r = self.dense_ratings()
        self.rated = (r > 0).float()

    def epoch(self, t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def report(self, epoch: int) -> None:
        """Every fifth epoch and the last (ExpoMF.py's progress line)."""
        if (epoch + 1) % 5 == 0 or epoch == self.max_epoch - 1:
            print(f"{self.model_name} {self.fold} epoch {epoch + 1}")

    def _uniform_tables(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """``x`` (U, d) and ``y`` (I, d), U(0, 1)·10/3 (WRMF.py:14-15)."""
        shapes = (("x", self.num_users), ("y", self.num_items))
        return {k: torch.rand((n, self.emb_size), generator=gen) * 10 / 3 for k, n in shapes}

    def fit(self) -> None:
        self.prepare()
        t = {k: v.to(self.device) for k, v in self.init_tables().items()}
        self.timer = StepTimer(self.train_size, self.device)
        self.epoch_losses = []
        for epoch in range(self.max_epoch):
            with self.timer:
                t = self.epoch(t)
            self.report(epoch)
        self.tables = t
        self.U, self.V = (t[k].contiguous() for k in self.factors)


class WRMF(_ALS):
    """Implicit ALS with confidence ``1 + 10r`` (WRMF.py:17-67); each epoch
    prints the squared error over the rated entries. On a mesh its training
    is replicated: every rank solves the whole tables from the same seed."""

    def init_tables(self) -> Dict[str, torch.Tensor]:
        return self._uniform_tables(torch.Generator().manual_seed(self.seed))

    def prepare(self) -> None:
        super().prepare()
        self.conf = 1.0 + 10.0 * self.dense_ratings()

    def epoch(self, t):
        x = solve_factors(t["y"], self.conf, self.rated, self.reg_u)
        y = solve_factors(x, self.conf.T, self.rated.T, self.reg_u)
        with f32_products():
            loss = float(torch.sum(self.rated * (self.rated - x @ y.T) ** 2))
        self.epoch_losses.append(loss)
        return {"x": x, "y": y}

    def report(self, epoch: int) -> None:
        print(f"{self.model_name} {self.fold} epoch {epoch + 1}: loss = {self.epoch_losses[-1]:.4f}")


class ExpoMF(_ALS):
    """Exposure-aware probabilistic MF trained by EM (ExpoMF.py): the
    exposure posterior weighs both solves, and the per-item prior ``mu``
    (I,) follows the summed posterior. On a mesh its training is
    replicated: every rank solves the whole tables from the same seed."""

    factors = ("theta", "beta")
    lam_theta = 1e-5
    lam_beta = 1e-5
    lam_y = 1.0
    init_mu = 0.01
    a_prior = 1.0
    b_prior = 99.0
    init_std = 0.01

    def init_tables(self) -> Dict[str, torch.Tensor]:
        """``theta`` (U, d) and ``beta`` (I, d), N(0, init_std²) from numpy,
        and ``mu`` at ``init_mu``."""
        rng, d = np.random.RandomState(self.seed), self.emb_size
        t = {k: torch.from_numpy((self.init_std * rng.randn(n, d)).astype(np.float32))
             for k, n in (("theta", self.num_users), ("beta", self.num_items))}
        t["mu"] = torch.full(self.mu_shape(), self.init_mu, dtype=torch.float32)
        return t

    def mu_shape(self):
        return (self.num_items,)

    def solve_both(self, t):
        """theta against beta, then beta against the new theta, each under
        the exposure posterior of the tables at hand; returns them with the
        posterior of the new pair."""
        theta, beta, mu, lam_y = t["theta"], t["beta"], t["mu"], self.lam_y
        a_u = exposure_posterior(theta, beta, self.rated, lam_y, mu)
        theta = solve_factors(beta, a_u, self.rated, self.lam_theta / lam_y)
        a_u = exposure_posterior(theta, beta, self.rated, lam_y, mu)
        beta = solve_factors(theta, a_u.T, self.rated.T, self.lam_beta / lam_y)
        return theta, beta, exposure_posterior(theta, beta, self.rated, lam_y, mu)

    def epoch(self, t):
        theta, beta, a = self.solve_both(t)
        a_sum = torch.sum(a, dim=0)
        mu = (self.a_prior + a_sum - 1) / (self.a_prior + self.b_prior + self.num_users - 2)
        return {"theta": theta, "beta": beta, "mu": mu}


class SERec(SocialRecommender, ExpoMF):
    """Social-exposure ExpoMF, the reference's boost variant
    (SERec.py:15-100): the prior ``mu`` (U, I) of (u, i) grows with how much
    u's followees were exposed to i, through the dense ``trust (U, U) @
    a_sum (U, I)`` product. On a mesh its training is replicated: every
    rank solves the whole tables from the same seed."""

    lam_y = 0.01
    s_boost = 2.2
    init_std = 0.5

    def mu_shape(self):
        return (self.num_users, self.num_items)

    def prepare(self) -> None:
        super().prepare()
        self.trust = torch.from_numpy(
            self.social.scipy_adjacency().toarray().astype(np.float32)).to(self.device)

    def epoch(self, t):
        theta, beta, a = self.solve_both(t)
        s = self.s_boost
        # the reference tiles the summed posterior per user before the
        # boost (SERec.py:88-92)
        a_sum = torch.sum(a, dim=0)[None, :].expand(t["mu"].shape)
        with f32_products():
            s_sum = self.trust @ a_sum
        mu = (self.a_prior + a_sum + (s - 1) * s_sum - 1) / (
            self.a_prior + self.b_prior + (s - 1) * s_sum + self.num_users - 2
        )
        return {"theta": theta, "beta": beta, "mu": mu}


class CoFactor(_ALS):
    """WRMF plus SPPMI item-context co-factorization (CoFactor.py): each
    item's solve adds its context blocks ``Σ_j g_j g_jᵀ`` and ``Σ_j (m_ij −
    w_i − c_j) g_j`` over its SPPMI neighbours j; the context factors ``g``
    (I, d) and biases ``w``, ``c`` (I,) follow, an item without context
    keeping its old values. On a mesh its training is replicated: every
    rank solves the whole tables from the same seed."""

    def read_configuration(self) -> None:
        super().read_configuration()
        args = self.model_args()
        self.neg_count = max(1, args.get_int("-k"))
        self.reg_r = args.get_float("-gamma")
        self.filter = args.get_int("-filter")

    def build_sppmi(self):
        """(rows, cols, values) of the SPPMI matrix, sorted by row
        (CoFactor.py:30-82): co-occurrence counts of item pairs above
        ``-filter`` among items with at least ``-filter`` raters, shifted
        by ``log -k``, clipped at 0 and scaled to a maximum of 1."""
        r = sp.csr_matrix(
            (np.ones_like(self.data.train_u, dtype=np.float32),
             (self.data.train_u, self.data.train_i)),
            shape=(self.num_users, self.num_items),
        )
        r.data[:] = 1.0
        raters = np.asarray(r.sum(axis=0)).ravel()
        keep = raters >= self.filter
        co = (r.T @ r).tocoo()
        mask = (co.row != co.col) & keep[co.row] & keep[co.col] & (co.data > self.filter)
        rows, cols, counts = co.row[mask], co.col[mask], co.data[mask]
        freq = np.zeros(self.num_items, dtype=np.float64)
        np.add.at(freq, rows, counts)
        d_total = freq.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            val = np.log(counts * d_total / np.maximum(freq[rows] * freq[cols], 1e-12)) - np.log(
                self.neg_count)
        val = np.maximum(val, 0.0)
        keep2 = val > 0
        rows, cols, val = rows[keep2], cols[keep2], val[keep2]
        if len(val):
            val = val / val.max()
        order = np.argsort(rows, kind="stable")
        return rows[order].astype(np.int32), cols[order].astype(np.int32), val[order].astype(np.float32)

    def build_graph(self) -> None:
        rows, cols, vals = self.build_sppmi()
        self.sppmi_edges = len(rows)
        count = np.bincount(rows, minlength=self.num_items)
        as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.sp_rows, self.sp_cols = as_t(rows.astype(np.int64)), as_t(cols.astype(np.int64))
        self.sp_vals = as_t(vals)
        self.sp_indptr = as_t(np.concatenate([[0], np.cumsum(count)]).astype(np.int64))
        self.ctx_count = as_t(count.astype(np.float32))
        self.has_ctx = self.ctx_count > 0

    def init_tables(self) -> Dict[str, torch.Tensor]:
        t = self._uniform_tables(torch.Generator().manual_seed(self.seed))
        rng = np.random.RandomState(self.seed)
        draw = lambda shape: torch.from_numpy(rng.random_sample(shape).astype(np.float32) / 10)  # noqa: E731
        t["w"] = draw(self.num_items)
        t["c"] = draw(self.num_items)
        t["g"] = draw((self.num_items, self.emb_size))
        return t

    def prepare(self) -> None:
        super().prepare()
        self.conf = 1.0 + 10.0 * self.dense_ratings()
        self.prepare_graph()

    def epoch(self, t):
        y, g, w, c = t["y"], t["g"], t["w"], t["c"]
        rows, cols, vals = self.sp_rows, self.sp_cols, self.sp_vals
        seg = lambda v: segment_sum(v, self.sp_indptr)  # noqa: E731
        x = solve_factors(y, self.conf, self.rated, self.reg_u)
        # the item update with the SPPMI blocks (CoFactor.py:115-158)
        gam, bet = g[cols], y[cols]
        g1 = seg(gam[:, :, None] * gam[:, None, :])
        m1 = seg((vals - w[rows] - c[cols])[:, None] * gam)
        g2 = seg(bet[:, :, None] * bet[:, None, :])
        m2 = seg((vals - w[cols] - c[rows])[:, None] * bet)
        y_new = solve_factors(x, self.conf.T, self.rated.T, self.reg_u, extra_a=g1, extra_b=m1)
        eye = torch.eye(y.shape[1], device=y.device)
        g_new = torch.linalg.solve_ex(g2 + self.reg_r * eye, m2[:, :, None])[0][:, :, 0]
        g_new = torch.where(self.has_ctx[:, None], g_new, g)
        upd_w = seg(vals - torch.sum(y_new[rows] * gam, dim=1) - c[cols])
        upd_c = seg(vals - torch.sum(bet * g_new[rows], dim=1) - w[cols])
        count = torch.clamp_min(self.ctx_count, 1)
        w_new = torch.where(self.has_ctx, upd_w / count, w)
        c_new = torch.where(self.has_ctx, upd_c / count, c)
        return {"x": x, "y": y_new, "g": g_new, "w": w_new, "c": c_new}
