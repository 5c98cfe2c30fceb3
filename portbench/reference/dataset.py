"""QRec's data semantics, worked out again from the benchmark's records.

* :class:`Dataset` — user and item ids in first-appearance order of the
  training records (QRec ``data/rating.py:48-54``), the rated sets with
  duplicates once, the test users in first-appearance order of the test
  records with their item ids (-1 for an item unseen in training).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np


class Dataset:
    """The ids, arrays and sets of one split."""

    def __init__(self, train: Sequence[Tuple[str, str]], test: Sequence[Tuple[str, str]]):
        self.user: Dict[str, int] = {}
        self.item: Dict[str, int] = {}
        tu = np.empty(len(train), dtype=np.int64)
        ti = np.empty(len(train), dtype=np.int64)
        for k, (u, i) in enumerate(train):
            tu[k] = self.user.setdefault(u, len(self.user))
            ti[k] = self.item.setdefault(i, len(self.item))
        self.train_u, self.train_i = tu, ti
        self.num_users, self.num_items = len(self.user), len(self.item)
        key = np.unique(tu * self.num_items + ti)
        self.rows = key // self.num_items
        self.cols = key % self.num_items
        self.deg_u = np.bincount(self.rows, minlength=self.num_users)
        self.deg_i = np.bincount(self.cols, minlength=self.num_items)
        tests: "OrderedDict[str, List[str]]" = OrderedDict()
        for u, i in test:
            items = tests.setdefault(u, [])
            if i not in items:
                items.append(i)
        self.test_names = list(tests)
        self.test_uids = np.array([self.user.get(u, -1) for u in tests], dtype=np.int64)
        width = max((len(v) for v in tests.values()), default=1)
        self.test_ids = np.full((len(tests), width), -1, dtype=np.int64)
        for b, items in enumerate(tests.values()):
            self.test_ids[b, : len(items)] = [self.item.get(i, -1) for i in items]
        self.test_counts = np.array([len(v) for v in tests.values()], dtype=np.int64)

    def positives(self) -> np.ndarray:
        """(U, max degree) each user's rated items ascending, padded with
        ``num_items``."""
        width = max(int(self.deg_u.max()), 1)
        out = np.full((self.num_users, width), self.num_items, dtype=np.int64)
        start = np.concatenate([[0], np.cumsum(self.deg_u)[:-1]])
        slot = np.arange(len(self.rows)) - start[self.rows]
        out[self.rows, slot] = self.cols
        return out

    def rejection_tries(self) -> int:
        """The uniform tries a negative gets before the exact draw: the
        smallest of 4, 6, 8 and 12 whose expected count of queries in an
        epoch that miss with every try, sum_u deg_u (deg_u / I)^t, stays
        below 1e-2, else 16 (the rule of the system's pairwise sampler,
        ``qrec_tpu_torch/models/base.py:368-379``, copied: it sets how
        many numbers the sampler draws)."""
        deg = self.deg_u.astype(np.float64)
        ratio = deg / max(self.num_items, 1)
        for t in (4, 6, 8, 12):
            if float(np.sum(deg * ratio**t)) < 1e-2:
                return t
        return 16
