"""The classical slice of the PyTorch port (UserKNN, ItemKNN, SlopeOne, SVD++,
EE) and the pairwise similarities against the JAX package, on the CPU: the
three pairwise forms with their edge cases, the KNN neighbours and
predictions on data whose k-th neighbour ties, SlopeOne's predictions,
SVD++'s and EE's first step and three bold epochs on the JAX sampler's
batches, their rankings, and the bundled ``config/`` files end to end.

Tolerances: the pairwise forms within rtol 1e-5 and atol 1e-6 (the same
f32 products summed in another order); the neighbour ids equal and the
predictions within rtol 1e-6 (numpy float64 on the host from f32
similarities); the first step's loss and gradients within rtol 1e-5 and
atol 1e-6; after three epochs the tables within 1e-4 and the epoch losses
within rtol 1e-3 (the bounds of tests/test_torch_mf.py; measured: the
similarities 1.1e-7 relative, the KNN and SlopeOne predictions equal bit
for bit, the first step's loss 1.0e-7 relative and its gradients 1.0e-7
of their largest entry, after three epochs the tables 6e-8 apart and the
losses 1.7e-7 relative).
"""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.split import data_split
from qrec_tpu.models import classical as jcl
from qrec_tpu.ops import similarity as jsim
from qrec_tpu.ops.topk import CatalogRanker as JRanker
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.errors import EvaluationError
from qrec_tpu_torch.models import classical as tcl
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops import similarity as tsim
from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreBlock, ScoreForm
from qrec_tpu_torch.runtime import trainer as T

CONFIG = Path(__file__).resolve().parents[1] / "config"
F32 = dict(rtol=1e-5, atol=1e-6)
SIMS = ["pcc", "cos", "euclidean", "jaccard"]  # an unknown name falls back to cosine
TRAINED = ["EE", "SVDPlusPlus"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the pairwise similarities
# ---------------------------------------------------------------------------


def _edge_rows():
    """30 x 20 integer ratings, with a row of no rating (no overlap), a
    constant row sharing items with row 4 (Pearson's zero denominator), a
    row rated only where row 6 is not (no overlap, cosine 0), and rows
    whose common squares differ in sign (the Euclidean form's negative
    totals)."""
    rng = np.random.RandomState(4)
    dense = (rng.randint(1, 6, size=(30, 20)) * (rng.rand(30, 20) < 0.35)).astype(np.float32)
    dense[0] = 0
    dense[1] = np.where(dense[4] > 0, 3.0, 0.0)
    dense[2] = np.where(dense[6] > 0, 0.0, 2.0)
    dense[3] = np.where(dense[5] > 0, 1.0, 0.0)  # smaller than row 5 on its support
    return dense


@pytest.mark.parametrize("fn", ["pairwise_pearson", "pairwise_cosine_sp", "pairwise_euclidean_sp"])
def test_pairwise_similarities_match_jax(fn):
    dense = _edge_rows()
    q = np.array([0, 1, 2, 3, 4, 5, 6, 17, 29])
    want = np.asarray(getattr(jsim, fn)(jnp.asarray(dense), jnp.asarray(dense[q])))
    got = getattr(tsim, fn)(torch.from_numpy(dense), torch.from_numpy(dense[q]))
    assert got.dtype == torch.float32 and got.shape == (len(q), 30)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    got = got.numpy()
    assert (got[0] == 0).all()  # no rating: no overlap, no denominator, no total
    assert got[2, 6] == 0  # no overlap
    if fn == "pairwise_pearson":
        assert got[1, 4] == 1.0 and got[4, 1] == 1.0  # overlap, zero denominator
    if fn == "pairwise_euclidean_sp":
        assert got[3, 5] < 0 and got[5, 3] > 0  # Σ (x_q² − x_r²) keeps its sign


# ---------------------------------------------------------------------------
# the memory-based models
# ---------------------------------------------------------------------------


def _sparse_split():
    """40 users x 30 items, 4 integer ratings a user: most pairs share one
    item, which makes Pearson ±1, cosine 1 and equal Euclidean totals exact,
    so the k-th neighbour ties; plus test pairs of an unknown user and an
    unknown item."""
    rng = np.random.RandomState(9)
    records = [[f"u{u}", f"i{i}", float(rng.randint(1, 6))]
               for u in range(40) for i in rng.choice(30, size=4, replace=False)]
    train, test = data_split(records, 0.2, rng=random.Random(1))
    test += [["ghost", "i1", 3.0], [train[0][0], "nothing", 2.0], ["ghost", "nothing", 1.0]]
    return train, test


def _conf(name, extra=None):
    base = {
        "ratings": "unused", "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2", "item.ranking": "off -topN 10", "num.factors": "6",
        "num.max.epoch": "3", "batch_size": "32", "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.01 -i 0.02 -b 0.05 -s 0.2", "similarity": "pcc",
        "num.neighbors": "3", "output.setup": "off -dir ./results/", "seed": "11",
        "SVDPlusPlus": "-y 0.01",
    }
    base.update(extra or {})
    return base


def _both(name, extra=None, split=None):
    train, test = split or _sparse_split()
    conf = _conf(name, extra)
    jd = JInteractions(jconfig.ModelConf(conf), train, test)
    td = Interactions(ModelConf(conf), train, test)
    return (getattr(jcl, name)(jconfig.ModelConf(conf), jd),
            getattr(tcl, name)(ModelConf(conf), td, device="cpu"))


def _pairs(data):
    return [e[0] for e in data.test_data], [e[1] for e in data.test_data]


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("name", ["UserKNN", "ItemKNN"])
def test_knn_neighbours_and_predictions_match_jax_at_tied_kth(name, sim):
    jmodel, tmodel = _both(name, {"similarity": sim})
    dense = tmodel.data.dense_matrix()
    rows = dense if name == "UserKNN" else dense.T
    ids = np.arange(len(rows))
    k = tmodel.neighbors
    jsims = jcl._sim_fn(sim)(jnp.asarray(rows), jnp.asarray(rows))
    jsims = jsims.at[ids, ids].set(-jnp.inf)
    jvals, jids = jax.lax.top_k(jsims, k + 1)
    jvals, jids = np.asarray(jvals), np.asarray(jids)
    # the data ties at the k-th neighbour in many rows
    assert (jvals[:, k - 1] == jvals[:, k]).sum() >= 5
    vals, nbrs = tcl.neighbours(sim, torch.from_numpy(np.ascontiguousarray(rows)), ids, k)
    np.testing.assert_array_equal(nbrs, jids[:, :k])
    np.testing.assert_allclose(vals, jvals[:, :k], **F32)
    users, items = _pairs(jmodel.data)
    want = jmodel.predict_ratings(users, items)
    got = tmodel.predict_ratings(users, items)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] == tmodel.data.global_mean


def test_slopeone_predictions_match_jax():
    jmodel, tmodel = _both("SlopeOne")
    users, items = _pairs(jmodel.data)
    want = jmodel.predict_ratings(users, items)
    got = tmodel.predict_ratings(users, items)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] == tmodel.data.global_mean
    uid = tmodel.data.user[users[-2]]
    assert got[-2] == tmodel.data.user_means[uid]  # known user, unseen item


@pytest.mark.parametrize("name", ["UserKNN", "ItemKNN"])
def test_ranking_a_knn_model_raises(tmp_path, name):
    rng = np.random.RandomState(0)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(f"u{u} i{i} {rng.randint(1, 6)}\n"
                            for u in range(20) for i in rng.choice(15, 5, replace=False)))
    conf = ModelConf({**_conf(name, {"item.ranking": "on -topN 10"}), "ratings": str(path)})
    with pytest.raises(EvaluationError, match=f"Ranking for all items in {name} is not available."):
        QRec(conf, seed=1, device="cpu").execute()


# ---------------------------------------------------------------------------
# the trained models
# ---------------------------------------------------------------------------


def _rated_split():
    """Explicit ratings of 0.5-4.0, 24 users x 8 of 30 items, split 3:1."""
    rng = np.random.RandomState(5)
    records = [[f"u{u}", f"i{i}", float(rng.randint(1, 9)) / 2]
               for u in range(24) for i in rng.choice(30, size=8, replace=False)]
    return data_split(records, 0.25, rng=random.Random(2))


def _trained(name):
    """(JAX model, its built spec, the port's model with the JAX
    parameters) on :func:`_rated_split`."""
    jmodel, tmodel = _both(name, split=_rated_split())
    spec = jmodel.build()
    tmodel.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in spec.params.items()}, "cpu"))
    return jmodel, spec, tmodel


@pytest.mark.parametrize("name", TRAINED)
def test_numpy_drawn_tables_equal_jax(name):
    """The biases (and SVD++'s Y) come from RandomState(seed) in both."""
    jmodel, tmodel = _both(name)
    spec = jmodel.build()
    drawn = [k for k in spec.params if k not in ("user_emb", "item_emb")]
    assert drawn
    for key in drawn:
        np.testing.assert_array_equal(getattr(tmodel, key).detach().numpy(), np.asarray(spec.params[key]))
    assert sorted(dict(tmodel.named_parameters())) == sorted(spec.params)


@pytest.mark.parametrize("name", TRAINED)
def test_first_step_loss_and_gradients_match_jax(name):
    _, spec, tmodel = _trained(name)
    tmodel.build()
    batch = tuple(np.asarray(a)[0] for a in spec.sampler(jax.random.PRNGKey(3)))
    jloss, jgrads = jax.value_and_grad(spec.loss_fn)(spec.params, batch, jax.random.PRNGKey(0))
    loss = tmodel.loss(T.as_device_batches(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **F32)
    for key, p in tmodel.named_parameters():
        want = np.asarray(jgrads[key])
        np.testing.assert_allclose(p.grad.numpy(), want, **F32, err_msg=key)


def _jax_bold_epochs(jmodel, spec, epochs):
    """The JAX package's bold-mode epoch loop: (epoch batches, losses,
    final parameters)."""
    optimizer = optax.inject_hyperparams(optax.sgd)(learning_rate=jmodel.lrate)
    run_epoch = jtrainer.make_epoch_runner(spec.loss_fn, optimizer)
    params, opt_state = spec.params, optimizer.init(spec.params)
    bold, conv = jtrainer.BoldDriver(jmodel.lrate, jmodel.max_lrate), jtrainer.ConvergenceMonitor()
    rng = jax.random.PRNGKey(0)
    batches, losses = [], []
    for epoch in range(epochs):
        rng, rs, rt = jax.random.split(rng, 3)
        b = spec.sampler(rs)
        batches.append(tuple(np.asarray(a) for a in b))
        params, opt_state, loss = run_epoch(params, opt_state, b, rt)
        losses.append(float(loss))
        if conv.check(losses[-1]):
            break
        lr = bold.update(epoch + 1, losses[-1])
        bold.last_loss = losses[-1]
        opt_state = jtrainer._set_lr(opt_state, lr)
    return batches, losses, params


@pytest.mark.parametrize("name", TRAINED)
def test_three_bold_epochs_on_injected_batches_match_jax(name):
    jmodel, spec, tmodel = _trained(name)
    batches, jlosses, params = _jax_bold_epochs(jmodel, spec, 3)
    losses = tmodel.fit(epoch_batches=batches)
    assert len(losses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[key]), atol=1e-4, err_msg=key)
    jmodel.finalize(params, spec)
    # SVD++'s user factors carry the implicit mean of Y
    np.testing.assert_allclose(tmodel.U.numpy(), np.asarray(jmodel.U), atol=1e-4)
    np.testing.assert_allclose(tmodel.V.numpy(), np.asarray(jmodel.V), atol=1e-4)
    users, items = _pairs(jmodel.data)
    users, items = users + ["ghost"], items + ["i0"]
    np.testing.assert_allclose(tmodel.predict_ratings(users, items),
                               jmodel.predict_ratings(users, items), rtol=1e-5)


@pytest.mark.parametrize("name", TRAINED)
def test_rankings_match_jax(name):
    """EE's score block and SVD++'s biased score form (K2's bias epilogue,
    its plain version here) against the JAX ranker's ``score_fn`` and
    ``lax.top_k``, at the JAX parameters."""
    jmodel, spec, tmodel = _trained(name)
    jmodel.finalize(spec.params, spec)
    tmodel.finalize(tmodel.build())
    jids, jscores = JRanker(jmodel.data, k=10, batch_size=16).topk(*jmodel.score_fn_params())
    form = tmodel.score_form()
    assert isinstance(form, ScoreBlock if name == "EE" else ScoreForm)
    if name == "SVDPlusPlus":
        assert form.item_bias is not None and form.user_bias is not None and form.offset != 0
    ranker = CatalogRanker(tmodel.data, k=10, device="cpu", bitmask=tmodel.rated_bitmask, batch_size=16)
    tids, tscores = ranker.topk(form)
    np.testing.assert_allclose(tscores, np.asarray(jscores), **F32)
    rows_equal = (tids == np.asarray(jids)).all(1)
    gap = np.abs(tscores - np.asarray(jscores)).max(1)
    assert (rows_equal | (gap <= 1e-5)).all() and rows_equal.mean() > 0.9


# ---------------------------------------------------------------------------
# the bundled configs on the CPU
# ---------------------------------------------------------------------------

# the RMSE ceilings of tests/test_classical_models.py:44-54
CEILINGS = {"UserKNN": 1.5, "ItemKNN": 1.6, "SlopeOne": 1.6, "EE": 1.7, "SVD++": 1.7}


@pytest.mark.parametrize("name", list(CEILINGS))
def test_bundled_config_runs_on_cpu(tmp_path, capsys, name):
    """``config/<name>.conf`` (SVD++ under its display name) at
    tests/test_classical_models.py's size and settings: planted blocks of
    3-5 ratings, 25 epochs of d=8, batch 64, 10 neighbours; the
    rating-predictions and measure files."""
    rng = np.random.RandomState(0)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(f"u{u} i{i} {rng.randint(3, 6)}\n" for u in range(40)
                            for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)))
    conf = ModelConf(str(CONFIG / f"{name}.conf"))
    for key, value in (("ratings", str(path)), ("evaluation.setup", "-ap 0.2"),
                       ("num.factors", "8"), ("num.max.epoch", "25"), ("batch_size", "64"),
                       ("learnRate", "-init 0.01 -max 1"),
                       ("reg.lambda", "-u 0.01 -i 0.01 -b 0.1 -s 0.1"), ("num.neighbors", "10"),
                       ("seed", "7"), ("output.setup", f"on -dir {tmp_path / 'out'}/")):
        conf[key] = value
    rec = QRec(conf, seed=3, device="cpu")
    parsed = metrics.parse_measure(rec.execute())["global"]
    assert parsed["RMSE"] < CEILINGS[name], parsed
    if name in ("EE", "SVD++"):
        assert "RMSE:" in capsys.readouterr().out and len(rec.model.timer.times) >= 2
    assert len(list((tmp_path / "out").iterdir())) == 2
