"""Train/test split protocols with reference semantics
(util/dataSplit.py:9-44).

``data_split`` takes an explicit ``random.Random`` so runs are
reproducible; the same generator gives the same split as the JAX package's.
``cross_validation`` is deterministic.
"""

from __future__ import annotations

import random as _random
from typing import Iterator, List, Optional, Tuple


def data_split(
    data: List[list],
    test_ratio: float = 0.3,
    binarized: bool = False,
    rng: Optional[_random.Random] = None,
) -> Tuple[List[list], List[list]]:
    """Bernoulli split at ``test_ratio``.

    Out-of-range ratios fall back to 0.3 like the reference. With
    ``binarized``, zero-rating records are dropped from the *test* side only.
    """
    if test_ratio >= 1 or test_ratio <= 0:
        test_ratio = 0.3
    rng = rng or _random.Random()
    train: List[list] = []
    test: List[list] = []
    for entry in data:
        if rng.random() < test_ratio:
            if binarized:
                if entry[2]:
                    test.append(entry)
            else:
                test.append(entry)
        else:
            train.append(entry)
    return train, test


def cross_validation(
    data: List[list],
    k: int,
    binarized: bool = False,
) -> Iterator[Tuple[List[list], List[list]]]:
    """Modulo-interleaved k folds (util/dataSplit.py:29-44): record ``ind``
    is fold ``ind % k``'s test record. ``k`` outside [2, 10] falls back to 3
    like the reference; with ``binarized`` only records with a true rating
    reach a test fold."""
    if k <= 1 or k > 10:
        k = 3
    for i in range(k):
        train: List[list] = []
        test: List[list] = []
        for ind, line in enumerate(data):
            if ind % k == i:
                if binarized:
                    if line[2]:
                        test.append(line[:])
                else:
                    test.append(line[:])
            else:
                train.append(line[:])
        yield train, test
