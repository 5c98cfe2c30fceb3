"""Baselines that learn nothing: UserMean, ItemMean, MostPopular and Rand
(reference model/rating/UserMean.py, ItemMean.py, model/ranking/
MostPopular.py, Rand.py; the JAX package's ``models/baselines.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.topk import RandomScores, ScoreForm
from .base import Recommender


class UserMean(Recommender):
    """Each user's training mean, the global mean for an unknown user
    (UserMean.py:7-11). Rating only. On a mesh its training (none) is
    replicated: every rank predicts every test rating."""

    def predict_ratings(self, users, items) -> np.ndarray:
        uids, _ = self._ids(users, items)
        means = self.data.user_means[np.maximum(uids, 0)]
        return np.where(uids >= 0, means, self.data.global_mean).astype(np.float64)


class ItemMean(Recommender):
    """Each item's training mean, the global mean for an unknown item
    (ItemMean.py:6-10). Rating only. On a mesh its training (none) is
    replicated: every rank predicts every test rating."""

    def predict_ratings(self, users, items) -> np.ndarray:
        _, iids = self._ids(users, items)
        means = self.data.item_means[np.maximum(iids, 0)]
        return np.where(iids >= 0, means, self.data.global_mean).astype(np.float64)


class MostPopular(Recommender):
    """Items ranked by their training count (MostPopular.py:9-20); an item
    nobody rated in training scores U(0, 1) noise from numpy's
    ``RandomState(seed)``, the JAX package's draws bit for bit. The buffer
    ``scores`` (I,) holds them after ``fit``. On a mesh its training is
    replicated (every rank draws the same noise) and K2 ranks each rank's
    share of the test users."""

    def __init__(self, conf, data, fold: str = "[1]", device=None):
        super().__init__(conf, data, fold=fold, device=device)
        self.register_buffer("scores", torch.zeros(self.num_items, device=self.device))

    def fit(self) -> None:
        pop = np.diff(self.data.i_indptr).astype(np.float32)
        noise = np.random.RandomState(self.seed).random_sample(self.num_items).astype(np.float32)
        self.scores.copy_(torch.from_numpy(np.where(pop > 0, pop, noise)))

    def score_form(self) -> ScoreForm:
        """Every user scores the same vector: width-1 zero tables make the
        dot products +0, and ``+0 + scores`` is ``scores`` exactly."""
        zeros = lambda n: torch.zeros((n, 1), device=self.device)  # noqa: E731
        return ScoreForm(zeros(self.num_users), zeros(self.num_items), item_bias=self.scores)


class Rand(Recommender):
    """Uniform random scores (Rand.py:10-15), drawn from the model's
    generator seeded with ``seed``: not the JAX package's draws, whose PRNG
    the port does not reproduce. On a mesh its training is replicated:
    every rank draws the same scores and ranks every test user."""

    def fit(self) -> None:
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

    def score_form(self) -> RandomScores:
        return RandomScores(self.generator)
