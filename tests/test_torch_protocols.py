"""The reference's protocols in the PyTorch port against the JAX package:
``cross_validation``'s folds, the averaged fold measures and the
cross-validation summary file, ``-cv 5`` and ``-predict`` run end to end
(MostPopular ranks the same in both packages: its noise comes from numpy),
the ``-predict`` user list and its data, and MostPopular's and the rating
baselines' runs under ``-ap``. Everything here is exact: the host code is
the same and MostPopular's scores are integers or numpy draws."""

import numpy as np
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu import io as jio
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.split import cross_validation as jcross_validation
from qrec_tpu.runtime import session as jsession
from qrec_tpu_torch import ModelConf, QRec, io
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.split import cross_validation
from qrec_tpu_torch.runtime import session


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _records(n=97, seed=0):
    rng = np.random.RandomState(seed)
    # ratings 0 (a false rating under -b) to 4
    return [[f"u{rng.randint(12)}", f"i{rng.randint(30)}", float(rng.randint(0, 5))]
            for _ in range(n)]


@pytest.mark.parametrize("binarized", [False, True])
@pytest.mark.parametrize("k", list(range(1, 12)))
def test_cross_validation_matches_jax(k, binarized):
    data = _records()
    got = list(cross_validation(data, k, binarized=binarized))
    want = list(jcross_validation(data, k, binarized=binarized))
    assert got == want
    assert len(got) == (k if 2 <= k <= 10 else 3)
    if binarized:
        assert all(r[2] for _, test in got for r in test)


def _write_ratings(tmp_path, users=24, items=40, per_user=9):
    rng = np.random.RandomState(3)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(
        f"u{u} i{i} {rng.randint(1, 6)}\n"
        for u in range(users)
        for i in rng.choice(items, size=per_user, replace=False)
    ))
    return path


def _conf(tmp_path, name, evaluation, out, ranking="on -topN 5,10", results="results"):
    return {
        "ratings": str(_write_ratings(tmp_path)),
        "ratings.setup": "-columns 0 1 2",
        "model.name": name,
        "evaluation.setup": evaluation,
        "item.ranking": ranking,
        "num.factors": "4",
        "num.max.epoch": "1",
        "batch_size": "32",
        "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.01 -i 0.01 -b 0.2 -s 0.2",
        "output.setup": f"{out} -dir {tmp_path / results}/",
    }


def _files(tmp_path, results="results"):
    return sorted(p.name for p in (tmp_path / results).iterdir())


def _untimed(name):
    """A result file's name without its ``@YYYY-MM-DD HH-MM-SS-`` stamp."""
    model, rest = name.split("@", 1)
    return model + "@" + rest[len("2026-10-17 06-00-06-"):]


def test_cv_summary_matches_jax_for_the_same_fold_measures(tmp_path, monkeypatch):
    """Both sessions average the same fold measures into the same strings,
    and write the summary file with ``output.setup`` off."""
    folds = [
        ["Top 5\n", f"Precision:{0.1 + j / 7}\n", f"Recall:{j / 3}\n", "F1:0.25\n",
         f"NDCG:{1 / (j + 3)}\n", "Top 10\n", f"Precision:{j / 11}\n", "Recall:0.1\n",
         "F1:0.3\n", f"NDCG:{0.2 / (j + 1)}\n"]
        for j in range(4)
    ]

    def fold_of(fold):
        return folds[int(fold.strip("[]")) - 1]

    monkeypatch.setattr(jsession, "run_fold", lambda c, tr, te, rel, fold, seed: (fold_of(fold), None))
    monkeypatch.setattr(session, "run_fold",
                        lambda c, tr, te, rel, fold, seed, dev: (fold_of(fold), None))
    conf = _conf(tmp_path, "MostPopular", "-cv 4", "off")
    want = jsession.QRec(jconfig.ModelConf(conf)).execute()
    jax_files = _files(tmp_path)
    for name in jax_files:
        (tmp_path / "results" / name).unlink()
    got = QRec(ModelConf(conf), device="cpu").execute()
    assert got == want == session.average_folds(folds)
    assert len(jax_files) == 1 and jax_files[0].endswith("-4-fold-cv.txt")
    files = _files(tmp_path)
    assert len(files) == 1 and files[0].endswith("-4-fold-cv.txt")
    assert (tmp_path / "results" / files[0]).read_text() == "".join(want)


@pytest.mark.parametrize("extra", ["", " -b 3 -p"])
def test_cv_5_runs_and_matches_jax(tmp_path, extra, capsys):
    """``-cv 5`` end to end: five folds one after another (``-p`` says a
    card cannot be shared and runs them so), their lists and measures, and
    the summary; MostPopular gives the JAX package's strings exactly (the
    JAX side without ``-p``, which on the CPU spawns a process a fold)."""
    want = jsession.QRec(jconfig.ModelConf(_conf(
        tmp_path, "MostPopular", "-cv 5" + extra.replace(" -p", ""), "on", results="jax"))).execute()
    capsys.readouterr()
    got = QRec(ModelConf(_conf(tmp_path, "MostPopular", "-cv 5" + extra, "on")),
               device="cpu").execute()
    out = capsys.readouterr().out
    assert got == want
    assert ("cannot be shared" in out) == ("-p" in extra)
    files, jax_files = _files(tmp_path), _files(tmp_path, "jax")
    assert len(files) == 11  # five lists, five measure files, the summary
    assert sorted(map(_untimed, files)) == sorted(map(_untimed, jax_files))
    jax_text = {_untimed(f): (tmp_path / "jax" / f).read_text() for f in jax_files}
    for f in files:
        assert (tmp_path / "results" / f).read_text() == jax_text[_untimed(f)], f
    assert sum(f.endswith("-5-fold-cv.txt") for f in files) == 1
    for fold in range(1, 6):
        assert sum(f.endswith(f"-top-10items[{fold}].txt") for f in files) == 1


def test_cv_outside_2_to_10_raises(tmp_path):
    from qrec_tpu_torch.errors import EvaluationError

    with pytest.raises(EvaluationError):
        QRec(ModelConf(_conf(tmp_path, "MostPopular", "-cv 11", "off")), device="cpu").execute()


def test_predict_writes_the_list_alone_as_jax(tmp_path):
    """``-predict users.txt``: the list file of the listed users (an unknown
    one ranked at the global mean), no measures; line for line the JAX
    package's list."""
    users = tmp_path / "users.txt"
    users.write_text("u3\nu0 extra\n\nghost\nu7\n")
    conf = _conf(tmp_path, "MostPopular", f"-predict {users}", "on", ranking="on -topN 10")
    want = jsession.QRec(jconfig.ModelConf(conf)).execute()
    (jax_list,) = [(tmp_path / "results" / f).read_text() for f in _files(tmp_path)]
    for name in _files(tmp_path):
        (tmp_path / "results" / name).unlink()
    rec = QRec(ModelConf(conf), device="cpu")
    got = rec.execute()
    assert got == want == []
    files = _files(tmp_path)
    assert len(files) == 1 and files[0].endswith("-top-10items[1].txt")
    text = (tmp_path / "results" / files[0]).read_text()
    assert text == jax_list
    lines = text.splitlines()
    assert [line.split(":")[0] for line in lines[1:]] == ["u3", "u0", "ghost", "u7"]
    assert "*" not in "".join(lines[1:])


def test_user_list_and_predict_data_match_jax(tmp_path):
    path = tmp_path / "users.txt"
    path.write_text("a b\n\n  c\nd\t1\n")
    assert io.load_user_list(str(path)) == jio.load_user_list(str(path)) == ["a", "c", "d"]
    conf = _conf(tmp_path, "BPR", f"-predict {path}", "off")
    train = [[f"u{k % 5}", f"i{k % 7}", 1.0] for k in range(30)] + [["a", "i1", 1.0]]
    users = ["a", "c", "d"]
    jd = JInteractions(jconfig.ModelConf(conf), train, users)
    td = Interactions(ModelConf(conf), train, users)
    assert td.predict_mode and jd.predict_mode
    assert list(td.test_set_u.items()) == list(jd.test_set_u.items())
    for key, value in jd.test_eval_arrays().items():
        np.testing.assert_array_equal(np.asarray(td.test_eval_arrays()[key]), np.asarray(value))


@pytest.mark.parametrize("name,ranking", [("MostPopular", "on -topN 5,10"),
                                          ("UserMean", "off -topN 5"),
                                          ("ItemMean", "off -topN 5")])
def test_baseline_runs_match_jax(tmp_path, name, ranking):
    conf = _conf(tmp_path, name, "-ap 0.25", "off", ranking=ranking)
    want = jsession.QRec(jconfig.ModelConf(conf), seed=5).execute()
    got = QRec(ModelConf(conf), seed=5, device="cpu").execute()
    assert got == want


def test_split_seed_matches_jax(tmp_path):
    conf = _conf(tmp_path, "MostPopular", "-ap 0.25", "off")
    want = jsession.QRec(jconfig.ModelConf(conf), seed=9)
    got = QRec(ModelConf(conf), seed=9, device="cpu")
    assert got.training_data == want.training_data and got.test_data == want.test_data
