"""Rating-file IO with the reference's parsing semantics (util/io.py).

The pure-Python branch of the JAX package's ``io.load_ratings``: rating
triples with configurable column order, delimiter and header
(util/io.py:31-76), optional binarize-with-threshold (util/io.py:61-65), trust relations
honouring ``social.setup`` (util/io.py:88-111), ``-predict`` user lists (util/io.py:79-85) and result-file writing
(util/io.py:18-28). Records stay plain
``[user, item, rating]`` lists so the split semantics match exactly.
"""

from __future__ import annotations

import os
import re
from typing import List, Sequence

from .config import ModelConf, OptionConf
from .errors import DataFormatError

_DEFAULT_DELIM = " |,|\t"


def write_file(directory: str, filename: str, content: Sequence[str]) -> None:
    """Write lines to ``directory/filename`` creating dirs (util/io.py:18-23)."""
    if not os.path.exists(directory):
        os.makedirs(directory)
    with open(os.path.join(directory, filename), "w") as f:
        f.writelines(content)


def load_ratings(
    conf: ModelConf,
    path: str,
    binarized: bool = False,
    threshold: float = 3.0,
) -> List[list]:
    """Parse rating triples honoring ``ratings.setup`` (util/io.py:31-76).

    ``-columns a b [c]`` selects user/item/rating columns; a missing rating
    column defaults every rating to 1. With ``binarized`` the record is
    dropped when ``rating < threshold`` and set to 1 otherwise.
    """
    rating_conf = OptionConf(conf["ratings.setup"])
    order = rating_conf["-columns"].strip().split()
    delim = rating_conf.get("-delim", _DEFAULT_DELIM)
    if len(order) < 2:
        raise DataFormatError("The rating file is not in a correct format (need >=2 columns).")
    u_col, i_col = int(order[0]), int(order[1])
    r_col = int(order[2]) if len(order) >= 3 else -1

    with open(path) as f:
        lines = f.readlines()
    if rating_conf.contains("-header"):
        lines = lines[1:]
    pattern = re.compile(delim)
    data: List[list] = []
    for line_no, line in enumerate(lines):
        items = pattern.split(line.strip())
        try:
            user_id = items[u_col]
            item_id = items[i_col]
            if r_col < 0:
                rating = 1.0
            else:
                rating = float(items[r_col])
            if binarized:
                if float(items[r_col]) < threshold:
                    continue
                rating = 1.0
        except (ValueError, IndexError) as e:
            raise DataFormatError(
                f"Malformed rating line {line_no} in {path}: {line.strip()!r} "
                "(did you forget -header in ratings.setup?)"
            ) from e
        data.append([user_id, item_id, rating])
    return data


def load_relations(conf: ModelConf, path: str) -> List[list]:
    """Trust edges ``[user1, user2, weight]`` honouring ``social.setup``
    (util/io.py:88-111): ``-columns a b [c]`` selects the two users and the
    weight (1 without a third column), ``-header`` skips the first line."""
    social_conf = OptionConf(conf["social.setup"])
    with open(path) as f:
        lines = f.readlines()
    if social_conf.contains("-header"):
        lines = lines[1:]
    order = social_conf["-columns"].strip().split()
    if len(order) < 2:
        raise DataFormatError("The social file is not in a correct format (need >=2 columns).")
    u1_col, u2_col = int(order[0]), int(order[1])
    w_col = int(order[2]) if len(order) >= 3 else -1
    pattern = re.compile(_DEFAULT_DELIM)
    relation: List[list] = []
    for line_no, line in enumerate(lines):
        items = pattern.split(line.strip())
        try:
            weight = 1.0 if w_col < 0 else float(items[w_col])
            relation.append([items[u1_col], items[u2_col], weight])
        except (ValueError, IndexError) as e:
            raise DataFormatError(
                f"Malformed relation line {line_no} in {path}: {line.strip()!r}"
            ) from e
    return relation


def load_user_list(path: str) -> List[str]:
    """The users of a ``-predict`` run: the first field of each non-blank
    line (util/io.py:79-85)."""
    users = []
    with open(path) as f:
        for line in f:
            stripped = line.strip()
            if stripped:
                users.append(stripped.split()[0])
    return users
