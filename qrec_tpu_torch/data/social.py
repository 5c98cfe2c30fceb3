"""Trust graph of the social models (counterpart of the JAX package's
``data/social.py``; reference data/social.py and the cleaning in
base/socialRecommender.py:9-41).

Relations whose users lack ratings are dropped, and the rest become
(src, dst, weight) arrays in the rating users' id space, which is what the
social models' host algebra reads. Without ``data`` the store keeps the
reference's own first-appearance user order (data/social.py:21-24).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

from .dataset import Interactions


class SocialGraph:
    """Trust-relation store: followees/followers dicts and id-space arrays."""

    def __init__(self, relation: List[list], data: Optional[Interactions] = None):
        self.followees: Dict[str, Dict[str, float]] = defaultdict(dict)
        self.followers: Dict[str, Dict[str, float]] = defaultdict(dict)
        if data is not None:
            self.relation = [r for r in relation if r[0] in data.user and r[1] in data.user]
            user_map = data.user
        else:
            self.relation = list(relation)
            user_map = {}
            for u1, u2, _ in self.relation:
                user_map.setdefault(u1, len(user_map))
                user_map.setdefault(u2, len(user_map))
        self.user = user_map
        self.num_users = data.num_users if data is not None else len(user_map)
        n = len(self.relation)
        self.src = np.empty(n, dtype=np.int32)
        self.dst = np.empty(n, dtype=np.int32)
        self.weight_arr = np.empty(n, dtype=np.float32)
        for k, (u1, u2, w) in enumerate(self.relation):
            self.followees[u1][u2] = w
            self.followers[u2][u1] = w
            self.src[k] = user_map[u1]
            self.dst[k] = user_map[u2]
            self.weight_arr[k] = float(w)
        self.out_degree = np.bincount(self.src, minlength=self.num_users).astype(np.float32)
        self.in_degree = np.bincount(self.dst, minlength=self.num_users).astype(np.float32)

    # ---- the reference's surface -----------------------------------------
    def getFollowees(self, u: str) -> Dict[str, float]:  # noqa: N802
        return self.followees.get(u, {})

    def getFollowers(self, u: str) -> Dict[str, float]:  # noqa: N802
        return self.followers.get(u, {})

    def hasFollowee(self, u1: str, u2: str) -> bool:  # noqa: N802
        return u2 in self.followees.get(u1, {})

    def hasFollower(self, u1: str, u2: str) -> bool:  # noqa: N802
        return u2 in self.followers.get(u1, {})

    def weight(self, u1: str, u2: str) -> float:
        return self.followees.get(u1, {}).get(u2, 0)

    def trustSize(self):  # noqa: N802
        return (len(self.user), len(self.relation))

    # ---- arrays -----------------------------------------------------------
    def coo(self):
        """(src, dst, weight) int32/float32 arrays in rating-user id space."""
        return self.src, self.dst, self.weight_arr

    def scipy_adjacency(self) -> sp.csr_matrix:
        """U×U sparse trust matrix (rows follow, cols followed)."""
        return sp.csr_matrix(
            (self.weight_arr, (self.src, self.dst)), shape=(self.num_users, self.num_users)
        )
