"""Final evaluation and result files (reference: base/recommender.py
evalRanking :127-179 and evalRatings :96-125; the JAX package's
``runtime/evaluator.py``).

Writes the top-N recommendation list with ``*`` hit markers, the
rating-prediction file and the measure file in the reference's format, and
records the measures in the run log. A ``-predict`` run writes the list and
measures nothing. In a multi-GPU run the ranking is cut by test user over
the ranks (``ops/topk.CatalogRanker``) and rank 0 alone writes the files
(``parallel/mesh.is_writer``).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

from ..config import ModelConf
from ..errors import EvaluationError
from ..io import write_file
from ..log import Log, timestamp
from ..ops import metrics as M
from ..ops.topk import CatalogRanker
from ..parallel.mesh import is_writer


def clamp_rating(pred: float, r_scale) -> float:
    """checkRatingBoundary (base/recommender.py:88-94): clamp to the rating
    scale, else round to 3 decimals."""
    if pred > r_scale[-1]:
        return r_scale[-1]
    if pred < r_scale[0]:
        return r_scale[0]
    return round(pred, 3)


def evaluate(model, data, conf: ModelConf, fold: str = "[1]", log: Optional[Log] = None) -> List[str]:
    if conf.options("item.ranking").isMainOn():
        return eval_ranking(model, data, conf, fold, log)
    return eval_ratings(model, data, conf, fold, log)


def _write_measure(measure, conf, fold, log, current_time) -> None:
    """The measure file (when ``output.setup`` is on), the log and the
    printed result, for either evaluation."""
    output = conf.options("output.setup")
    if output.isMainOn() and is_writer():
        file_name = conf["model.name"] + "@" + current_time + "-measure" + fold + ".txt"
        write_file(output["-dir"], file_name, measure)
    if log is not None:
        log.add("###Evaluation Results###")
        log.add(measure)
    print("The result of %s %s:\n%s" % (conf["model.name"], fold, "".join(measure)))


def eval_ranking(model, data, conf, fold="[1]", log=None) -> List[str]:
    ranking = conf.options("item.ranking")
    if not ranking.contains("-topN"):
        raise EvaluationError("No correct evaluation metric is specified!")
    top = ranking.get_ints("-topN")
    n = max(top)
    if n > 100 or n < 1:
        print("N can not be larger than 100! It has been reassigned to 10")
        n = 10
    output = conf.options("output.setup")

    # on a mesh each rank ranks its share of the test users, and every
    # rank receives the whole lists
    ranker = CatalogRanker(data, k=n, device=model.device, bitmask=model.rated_bitmask,
                           batch_size=model.eval_batch_size, mesh=model.mesh)
    t0 = time.perf_counter()
    ids, scores = ranker.topk(model.score_form())
    model.rank_seconds = time.perf_counter() - t0  # topk ends in a host copy

    rec_list = {}
    rec_output = [
        "userId: recommendations in (itemId, ranking score) pairs, * "
        "means the item matches.\n"
    ]
    for b, user in enumerate(ranker.names):
        items = [
            (data.id2item[int(iid)], float(s))
            for iid, s in zip(ids[b], scores[b])
        ]
        rec_list[user] = items
        line = user + ":" + "".join(
            f" ({name},{score})" + ("*" if name in data.test_set_u[user] else "")
            for name, score in items
        )
        rec_output.append(line + "\n")

    current_time = timestamp()
    if output.isMainOn() and is_writer():
        out_dir = output["-dir"]
        file_name = (
            conf["model.name"] + "@" + current_time + "-top-" + str(n)
            + "items" + fold + ".txt"
        )
        write_file(out_dir, file_name, rec_output)
        print("The result has been output to ", os.path.abspath(out_dir), ".")
    if conf.options("evaluation.setup").contains("-predict"):
        # -predict writes the lists and measures nothing (base/recommender.py:170-172)
        return []
    measure = M.ranking_measure(data.test_set_u, rec_list, top)
    _write_measure(measure, conf, fold, log, current_time)
    return measure


def eval_ratings(model, data, conf, fold="[1]", log=None) -> List[str]:
    """The rating-prediction file (each prediction clamped to the rating
    scale or rounded to 3 decimals) and MAE/RMSE over the test records;
    their seconds in ``model.rating_seconds``."""
    t0 = time.perf_counter()
    output = conf.options("output.setup")
    users = [e[0] for e in data.test_data]
    items = [e[1] for e in data.test_data]
    ratings = [e[2] for e in data.test_data]
    preds = model.predict_ratings(users, items)
    res = ["userId  itemId  original  prediction\n"]
    records = []
    for u, i, r, p in zip(users, items, ratings, preds):
        pred = clamp_rating(float(p), data.r_scale)
        records.append([u, i, r, pred])
        res.append(f"{u} {i} {r} {pred}\n")
    current_time = timestamp()
    if output.isMainOn() and is_writer():
        out_dir = output["-dir"]
        file_name = (
            conf["model.name"] + "@" + current_time
            + "-rating-predictions" + fold + ".txt"
        )
        write_file(out_dir, file_name, res)
        print("The result has been output to ", os.path.abspath(out_dir), ".")
    measure = M.rating_measure(records)
    model.rating_seconds = time.perf_counter() - t0
    _write_measure(measure, conf, fold, log, current_time)
    return measure
