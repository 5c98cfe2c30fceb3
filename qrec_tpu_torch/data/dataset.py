"""Array-native interaction store replacing the reference's ``data/rating.py``.

The reference keeps train/test data as dict-of-dicts (``trainSet_u`` etc.,
data/rating.py:17-20,56-67) and materializes dense rows per lookup. We build
contiguous int32/float32 numpy arrays once — COO triples plus CSR indexed
both by user and by item — which the device training/eval paths upload.
This is host code, identical in behaviour to the JAX package's
``data/dataset.py``; the parity tests hold the two array for array.

Parity-critical semantics preserved exactly:

* user/item name→id maps assigned in training-data first-appearance order
  (data/rating.py:48-54), so recommendation lists map back to the same names;
* rating-scale set, user/item/global means (data/rating.py:58-60,84-97);
* ``-val`` validation carve-out: shuffle training data, first fraction becomes
  the test set (data/rating.py:37-41);
* ``-cold`` cold-start filter: drop test users with more than ``threshold``
  training ratings (data/rating.py:69-82);
* ``-predict`` mode: test data is a bare user list (data/rating.py:62-63).
"""

from __future__ import annotations

import random as _random
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ModelConf, OptionConf
from ..runtime.profiling import spanned


class Interactions:
    """Central data object every model sees (reference ``Rating``)."""

    @spanned("data.interactions")
    def __init__(
        self,
        config: ModelConf,
        training_data: List[list],
        test_data: List[list],
        seed: int = 0,
    ):
        self.config = config
        self.eval_settings = OptionConf(config["evaluation.setup"])
        self.predict_mode = self.eval_settings.contains("-predict")

        self.training_data = [list(e) for e in training_data]
        self.test_data = list(test_data)

        # -val carve-out (data/rating.py:37-41): sample from the (shuffled)
        # training data to form a validation set used as the test set.
        if self.eval_settings.contains("-val"):
            rng = _random.Random(seed)
            rng.shuffle(self.training_data)
            separation = int(
                len(self.training_data) * float(self.eval_settings["-val"])
            )
            self.test_data = self.training_data[:separation]
            self.training_data = self.training_data[separation:]

        # ---- id maps in first-appearance order (data/rating.py:48-54) ----
        self.user: Dict[str, int] = {}
        self.item: Dict[str, int] = {}
        self.id2user: Dict[int, str] = {}
        self.id2item: Dict[int, str] = {}

        scale = set()
        n = len(self.training_data)
        train_u = np.empty(n, dtype=np.int32)
        train_i = np.empty(n, dtype=np.int32)
        train_r = np.empty(n, dtype=np.float32)
        # train dict views kept for exact-parity host paths (e.g. KNN and
        # rating prediction with duplicate handling)
        self.train_set_u: Dict[str, Dict[str, float]] = defaultdict(dict)
        self.train_set_i: Dict[str, Dict[str, float]] = defaultdict(dict)
        for k, entry in enumerate(self.training_data):
            user_name, item_name, rating = entry
            if user_name not in self.user:
                uid = len(self.user)
                self.user[user_name] = uid
                self.id2user[uid] = user_name
            if item_name not in self.item:
                iid = len(self.item)
                self.item[item_name] = iid
                self.id2item[iid] = item_name
            train_u[k] = self.user[user_name]
            train_i[k] = self.item[item_name]
            train_r[k] = float(rating)
            self.train_set_u[user_name][item_name] = rating
            self.train_set_i[item_name][user_name] = rating
            scale.add(float(rating))
        self.r_scale = sorted(scale)
        self.train_u = train_u
        self.train_i = train_i
        self.train_r = train_r

        # ---- test set, keyed by raw names (data/rating.py:61-67) ----
        self.test_set_u: "OrderedDict[str, Dict[str, float]]" = OrderedDict()
        self.test_set_i: Dict[str, Dict[str, float]] = defaultdict(dict)
        if self.predict_mode:
            for entry in self.test_data:
                self.test_set_u[entry] = {}
        else:
            for entry in self.test_data:
                user_name, item_name, rating = entry[0], entry[1], entry[2]
                self.test_set_u.setdefault(user_name, {})[item_name] = rating
                self.test_set_i[item_name][user_name] = rating

        # ---- cold-start filter (data/rating.py:69-82) ----
        if self.eval_settings.contains("-cold"):
            threshold = int(self.eval_settings["-cold"])
            removed = {
                u
                for u in self.test_set_u
                if u in self.train_set_u and len(self.train_set_u[u]) > threshold
            }
            for u in removed:
                del self.test_set_u[u]
            self.test_data = [e for e in self.test_data if e[0] not in removed]

        # ---- means (data/rating.py:84-97) ----
        self.num_users = len(self.user)
        self.num_items = len(self.item)
        counts_u = np.bincount(train_u, minlength=self.num_users).astype(np.float32)
        counts_i = np.bincount(train_i, minlength=self.num_items).astype(np.float32)
        sums_u = np.bincount(train_u, weights=train_r, minlength=self.num_users)
        sums_i = np.bincount(train_i, weights=train_r, minlength=self.num_items)
        with np.errstate(invalid="ignore", divide="ignore"):
            self.user_means = np.where(
                counts_u > 0, sums_u / np.maximum(counts_u, 1), 0.0
            ).astype(np.float32)
            self.item_means = np.where(
                counts_i > 0, sums_i / np.maximum(counts_i, 1), 0.0
            ).astype(np.float32)
        self.global_mean = (
            float(self.user_means[counts_u > 0].mean()) if self.num_users else 0.0
        )

        # ---- CSR by user and by item (replaces dict-of-dict lookups) ----
        # Duplicate (u, i) pairs keep the *last* rating like the reference's
        # dict assignment (data/rating.py:56-57); we deduplicate keeping the
        # final occurrence so CSR membership tests match dict semantics.
        order = np.lexsort((np.arange(n)[::-1], train_i, train_u)) if n else np.array([], dtype=np.int64)
        if n:
            su, si = train_u[order], train_i[order]
            keep = np.ones(n, dtype=bool)
            keep[1:] = (su[1:] != su[:-1]) | (si[1:] != si[:-1])
            # 'order' sorts duplicates by descending original index first, so
            # the kept row is the last-written rating.
            sel = order[keep]
            sel = sel[np.lexsort((train_i[sel], train_u[sel]))]
        else:
            sel = order
        self.csr_sel = sel  # indices into train arrays, (u, i)-sorted, deduped
        uu, ii, rr = train_u[sel], train_i[sel], train_r[sel]
        self.u_indptr = np.zeros(self.num_users + 1, dtype=np.int32)
        np.cumsum(np.bincount(uu, minlength=self.num_users), out=self.u_indptr[1:])
        self.u_indices = ii.astype(np.int32)  # sorted within each user row
        self.u_values = rr.astype(np.float32)
        order_i = np.lexsort((uu, ii))
        self.i_indptr = np.zeros(self.num_items + 1, dtype=np.int32)
        np.cumsum(np.bincount(ii, minlength=self.num_items), out=self.i_indptr[1:])
        self.i_indices = uu[order_i].astype(np.int32)
        self.i_values = rr[order_i].astype(np.float32)

        self._test_eval_cache = None

    # ---- reference-compatible surface ----------------------------------
    def trainingSize(self) -> Tuple[int, int, int]:  # noqa: N802
        return (self.num_users, self.num_items, len(self.training_data))

    def testSize(self) -> Tuple[int, int, int]:  # noqa: N802
        return (len(self.test_set_u), len(self.test_set_i), len(self.test_data))

    def contains(self, u: str, i: str) -> bool:
        return u in self.user and i in self.train_set_u[u]

    def containsUser(self, u: str) -> bool:  # noqa: N802
        return u in self.user

    def containsItem(self, i: str) -> bool:  # noqa: N802
        return i in self.item

    def userRated(self, u: str):  # noqa: N802
        return list(self.train_set_u[u].keys()), list(self.train_set_u[u].values())

    def itemRated(self, i: str):  # noqa: N802
        return list(self.train_set_i[i].keys()), list(self.train_set_i[i].values())

    def rating(self, u: str, i: str) -> float:
        if self.contains(u, i):
            return self.train_set_u[u][i]
        return -1.0

    def ratingScale(self) -> Tuple[float, float]:  # noqa: N802
        return (self.r_scale[0], self.r_scale[1])

    def elemCount(self) -> int:  # noqa: N802
        return len(self.training_data)

    # ---- array-native accessors -----------------------------------------
    def user_row_ids(self, uid: int) -> np.ndarray:
        """Sorted item ids rated by user ``uid``."""
        return self.u_indices[self.u_indptr[uid] : self.u_indptr[uid + 1]]

    def item_col_ids(self, iid: int) -> np.ndarray:
        return self.i_indices[self.i_indptr[iid] : self.i_indptr[iid + 1]]

    def dense_matrix(self) -> np.ndarray:
        """Dense |U|×|I| rating matrix (reference data/rating.py:158-168)."""
        m = np.zeros((self.num_users, self.num_items), dtype=np.float32)
        m[self.train_u, self.train_i] = self.train_r
        return m

    def test_eval_arrays(self, max_test_items: Optional[int] = None):
        """Padded arrays for device-side ranking evaluation.

        Returns a dict with, for the B test users in insertion order:
          ``names``   list[str] length B
          ``uids``    (B,) int32, -1 when the user is unseen in training
          ``test_ids``(B, T) int32 test item train-ids, -1 padding/unseen items
          ``test_counts`` (B,) int32 — |test items| including unseen items
                       (denominator of recall / IDCG, measure.py:79-80,107)
        """
        if self._test_eval_cache is not None and max_test_items is None:
            return self._test_eval_cache
        names = list(self.test_set_u.keys())
        b = len(names)
        counts = np.array(
            [len(self.test_set_u[u]) for u in names], dtype=np.int32
        )
        t = int(max_test_items or (counts.max() if b else 1) or 1)
        test_ids = np.full((b, t), -1, dtype=np.int32)
        for bi, uname in enumerate(names):
            for ti, item_name in enumerate(self.test_set_u[uname]):
                if ti >= t:
                    break
                test_ids[bi, ti] = self.item.get(item_name, -1)
        uids = np.array(
            [self.user.get(u, -1) for u in names], dtype=np.int32
        )
        out = {
            "names": names,
            "uids": uids,
            "test_ids": test_ids,
            "test_counts": counts,
        }
        if max_test_items is None:
            self._test_eval_cache = out
        return out
