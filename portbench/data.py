"""Synthetic interaction data of the benchmark's shapes, and the rating
files that the system under test reads.

The two generators are frozen copies:

* :func:`lastfm_records` of ``chip_smoke.lastfm_records``
  (``chip_smoke.py:298-315``): the lastfm shape of QRec's README
  (``README.md:466-475``: 1,892 users x 17,632 items x 92,834
  interactions), every user and item at least once, zipf(0.9) item
  popularity, unique pairs;
* :func:`yelp_matrix` of ``chip_smoke.yelp_matrix``
  (``chip_smoke.py:318-330``), itself ``bench.build_yelp_scale``'s draw
  (``bench.py:65-90``): the shape of QRec's Yelp (``README.md:477-486``:
  19,539 users x 21,266 items x 450,884 interactions), zipf(0.9) items,
  unique pairs.

Both take the seed as an argument where the originals fixed it. A config's
``dataset`` block names its generator, its sizes, its ``structure_seed``
and its test share. The generator draws one structure from the
``structure_seed``, the same for every run, with an exact split of it into
training and test records; the run's seed then renames the users and the
items and orders the records. So every seed trains the same graph up to
the names, the same pairs in the same number of steps, and ranks the same
test users: the seed changes the inputs, not the amount of work.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple

import numpy as np


def lastfm_records(seed: int, users: int = 1892, items: int = 17632, nnz: int = 92834,
                   zipf: float = 0.9):
    """lastfm-shaped implicit ratings: every user and item at least once,
    the rest with zipf item popularity; unique (user, item) pairs."""
    rng = np.random.default_rng(seed)
    u0 = np.concatenate([np.arange(users), rng.integers(0, users, size=items - users)])
    i0 = rng.permutation(items)
    p = np.arange(1, items + 1, dtype=np.float64) ** -zipf
    p /= p.sum()
    u1 = rng.integers(0, users, size=nnz * 2)
    i1 = rng.choice(items, size=nnz * 2, p=p)
    first = u0.astype(np.int64) * items + i0
    rest = np.setdiff1d(np.unique(u1.astype(np.int64) * items + i1), first)
    rng.shuffle(rest)
    key = np.concatenate([first, rest[: nnz - len(first)]])
    rng.shuffle(key)
    return (key // items).astype(np.int64), (key % items).astype(np.int64)


def yelp_matrix(seed: int, users: int = 19539, items: int = 21266, nnz: int = 450884,
                zipf: float = 0.9):
    """The zipf generator of the shape of QRec's Yelp."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, users, size=int(nnz * 1.6))
    p = np.arange(1, items + 1, dtype=np.float64) ** -zipf
    p /= p.sum()
    i = rng.choice(items, size=len(u), p=p)
    key = np.unique(u.astype(np.int64) * items + i)
    rng.shuffle(key)
    key = key[:nnz]
    return key // items, key % items


GENERATORS = {"lastfm_records": lastfm_records, "yelp_matrix": yelp_matrix}


class Interactions(NamedTuple):
    """The interactions the benchmark drew, in file order (user and item
    names are decimal strings), and the records it holds out as the test
    file."""

    users: np.ndarray
    items: np.ndarray
    test_users: np.ndarray
    test_items: np.ndarray


class Files(NamedTuple):
    ratings: str
    test: str


def draw(dataset: Dict, seed: int) -> Interactions:
    """The ``dataset`` block's interactions for ``seed``: the structure of
    ``structure_seed`` and its exact split, renamed and ordered by
    ``seed``."""
    gen = GENERATORS[dataset["generator"]]
    base = dataset["structure_seed"]
    users, items = gen(base, dataset["users"], dataset["items"], dataset["interactions"],
                       dataset["zipf"])
    n = len(users)
    n_test = int(round(n * dataset["test_ratio"]))
    is_test = np.zeros(n, dtype=bool)
    is_test[np.random.default_rng([base, 1]).permutation(n)[:n_test]] = True
    rng = np.random.default_rng(seed)
    user_names = rng.permutation(dataset["users"])
    item_names = rng.permutation(dataset["items"])
    order = rng.permutation(n)
    u, i, t = user_names[users[order]], item_names[items[order]], is_test[order]
    return Interactions(u[~t], i[~t], u[t], i[t])


def _write(path: str, users: np.ndarray, items: np.ndarray) -> None:
    with open(path, "w") as f:
        f.writelines(f"{a} {b} 1\n" for a, b in zip(users.tolist(), items.tolist()))


def write_files(inter: Interactions, directory: str) -> Files:
    """The rating file and the test file under ``directory``, which the
    caller makes: ``user item 1`` lines."""
    ratings = os.path.join(directory, "ratings.txt")
    test = os.path.join(directory, "test.txt")
    _write(ratings, inter.users, inter.items)
    _write(test, inter.test_users, inter.test_items)
    return Files(ratings, test)
