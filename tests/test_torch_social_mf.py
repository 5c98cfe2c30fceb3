"""The social MF rating slice of the PyTorch port (SoRec, SoReg, SocialMF,
RSTE, LOCABAL, SREE, SocialFD) and its helpers against the JAX package, on
the CPU: the numpy-drawn tables, each model's loss and gradients at the JAX
parameters on one JAX batch, three bold-driver epochs on the batches the
JAX sampler drew, SREE's and SocialFD's predictions and score blocks, the
edge similarities, the normalized matrices, LOCABAL's PageRank weights, and
the bundled ``config/`` files end to end at a small size.

Data: the planted blocks of the JAX package's tests/test_social_models.py
(40 users, two blocks of 15 items, 10 ratings of 3-5 a user, 3 trust links
inside each user's block). Tolerances: the first step's loss and gradients
within rtol 1e-5 and atol 1e-6 (the same f32 terms summed in another
order); after three epochs the tables within 1e-4 and the epoch losses
within rtol 1e-3 (the bounds of tests/test_torch_mf.py; measured on this
data: at most 2e-7 on the tables and 2e-7 relative on the losses)."""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import optax
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data import graph as jgraph
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.social import SocialGraph as JSocialGraph
from qrec_tpu.data.split import data_split
from qrec_tpu.models import social_mf as jsm
from qrec_tpu.ops import similarity as jsim
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data import graph as tgraph
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.social import SocialGraph
from qrec_tpu_torch.models import social_mf as tsm
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops import similarity as tsim
from qrec_tpu_torch.ops.topk import ScoreBlock
from qrec_tpu_torch.runtime import trainer as T

CONFIG = Path(__file__).resolve().parents[1] / "config"
F32 = dict(rtol=1e-5, atol=1e-6)
ARGS = {
    "SoRec": "-z 0.01", "SoReg": "-alpha 0.1", "SocialMF": "", "RSTE": "-alpha 0.7",
    "LOCABAL": "-alpha 0.2", "SREE": "-alpha 0.02", "SocialFD": "-alpha 0.02 -eta 0.1 -beta 0.1",
}
MODELS = list(ARGS)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rows():
    """(rating rows, trust rows) of tests/test_social_models.py's data."""
    rng = np.random.RandomState(0)
    ratings = [[f"u{u}", f"i{i}", float(rng.randint(3, 6))]
               for u in range(40) for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)]
    trust = [[f"u{u}", f"u{f}", 1.0] for u in range(40)
             for f in rng.choice(20, size=3, replace=False) + (0 if u < 20 else 20) if f != u]
    return ratings, trust


def _files(tmp_path):
    ratings, trust = _rows()
    rp, tp = tmp_path / "ratings.txt", tmp_path / "trust.txt"
    rp.write_text("".join(f"{u} {i} {int(r)}\n" for u, i, r in ratings))
    tp.write_text("".join(f"{u} {v} 1\n" for u, v, _ in trust))
    return str(rp), str(tp)


def _conf(name, extra=None):
    base = {
        "ratings": "unused", "ratings.setup": "-columns 0 1 2",
        "social": "unused", "social.setup": "-columns 0 1 2",
        "model.name": name, "evaluation.setup": "-ap 0.2", "item.ranking": "off -topN 10",
        "num.factors": "8", "num.max.epoch": "3", "batch_size": "64",
        "learnRate": "-init 0.02 -max 1", "reg.lambda": "-u 0.01 -i 0.01 -b 0.1 -s 0.1",
        "output.setup": "off -dir ./results/", "seed": "7",
    }
    if ARGS[name]:
        base[name] = ARGS[name]
    base.update(extra or {})
    return base


def _both(name, extra=None, load=True):
    """(JAX model, its built spec, the port's model) on the same split and
    relation, the port holding the JAX package's initial parameters."""
    ratings, trust = _rows()
    train, test = data_split(ratings, 0.2, rng=random.Random(3))
    conf = _conf(name, extra)
    jd = JInteractions(jconfig.ModelConf(conf), train, test)
    td = Interactions(ModelConf(conf), train, test)
    jmodel = getattr(jsm, name)(jconfig.ModelConf(conf), jd, social=JSocialGraph(trust, jd))
    tmodel = getattr(tsm, name)(ModelConf(conf), td, device="cpu", social=SocialGraph(trust, td))
    spec = jmodel.build()
    if load:
        tmodel.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in spec.params.items()},
                                               "cpu"))
    return jmodel, spec, tmodel


def _closure(fn, name):
    """A constant that a JAX loss function closes over."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[name]


# ---------------------------------------------------------------------------
# the models against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["SoRec", "LOCABAL", "SREE", "SocialFD"])
def test_numpy_drawn_tables_equal_jax(name):
    """SoRec's Z, LOCABAL's H and SREE's and SocialFD's biases and H come
    from RandomState(seed) in both packages."""
    _, spec, tmodel = _both(name, load=False)
    drawn = [k for k in spec.params if k not in ("user_emb", "item_emb")]
    assert drawn
    for key in drawn:
        np.testing.assert_array_equal(getattr(tmodel, key).detach().numpy(),
                                      np.asarray(spec.params[key]), err_msg=key)
    assert sorted(dict(tmodel.named_parameters())) == sorted(spec.params)


@pytest.mark.parametrize("name", MODELS)
def test_first_step_loss_and_gradients_match_jax(name):
    _, spec, tmodel = _both(name)
    tmodel.build()
    batch = tuple(np.asarray(a)[0] for a in spec.sampler(jax.random.PRNGKey(3)))
    jloss, jgrads = jax.value_and_grad(spec.loss_fn)(spec.params, batch, jax.random.PRNGKey(0))
    loss = tmodel.loss(T.as_device_batches(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **F32)
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[key]), **F32, err_msg=key)


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


@pytest.mark.parametrize("name", MODELS)
def test_three_bold_epochs_on_injected_batches_match_jax(name):
    jmodel, spec, tmodel = _both(name)
    batches, jlosses, params = _jax_bold_epochs(jmodel, spec, 3)
    losses = tmodel.fit(epoch_batches=batches)
    assert len(losses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[key]), atol=1e-4,
                                   err_msg=key)
    # the final factors (RSTE's blend of each user and its followees' mean)
    jmodel.finalize(params, spec)
    np.testing.assert_allclose(tmodel.U.numpy(), np.asarray(jmodel.U), atol=1e-4)
    np.testing.assert_allclose(tmodel.V.numpy(), np.asarray(jmodel.V), atol=1e-4)


@pytest.mark.parametrize("name", ["SREE", "SocialFD"])
def test_distance_models_predict_and_score_as_jax(name):
    """At the same parameters: the predictions of the test pairs (on the
    host, numpy in both) bit for bit, and the score block within the f32
    bound."""
    jmodel, spec, tmodel = _both(name)
    tspec = tmodel.build()
    jmodel.finalize(spec.params, spec)
    tmodel.finalize(tspec)
    users = [u for u, _, _ in jmodel.data.test_data] + ["nobody"]
    items = [i for _, i, _ in jmodel.data.test_data] + ["i0"]
    want = jmodel.predict_ratings(users, items)
    np.testing.assert_array_equal(tmodel.predict_ratings(users, items), want)
    assert want[-1] == jmodel.data.global_mean
    score_fn, params = jmodel.score_fn_params()
    uids = np.arange(tmodel.num_users)
    form = tmodel.score_form()
    assert isinstance(form, ScoreBlock)
    np.testing.assert_allclose(form.fn(torch.from_numpy(uids)).numpy(),
                               np.asarray(score_fn(params, jnp.asarray(uids))), **F32)


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["edge_pearson_sp", "edge_cosine_sp"])
@pytest.mark.parametrize("chunk", [512, 7])
def test_edge_similarities_match_jax(fn, chunk):
    """1,100 edges (three chunks of 512), rows with no rating, pairs with
    no common item and a zero-variance pair."""
    rng = np.random.RandomState(4)
    dense = (rng.randint(1, 6, size=(60, 40)) * (rng.rand(60, 40) < 0.3)).astype(np.float32)
    dense[3] = 0
    dense[5] = 0
    dense[7] = np.where(dense[8] > 0, 2.0, 0.0)  # the same items as user 8, one value
    src = rng.randint(0, 60, 1100)
    dst = rng.randint(0, 60, 1100)
    src[:4], dst[:4] = [3, 5, 7, 1], [4, 3, 8, 1]
    want = getattr(jsim, fn)(jnp.asarray(dense), jnp.asarray(src), jnp.asarray(dst), chunk=chunk)
    got = getattr(tsim, fn)(torch.from_numpy(dense), torch.from_numpy(src), torch.from_numpy(dst),
                            chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (1100,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert got[0] == 0 and got[1] == 0


@pytest.mark.parametrize("which,mode", [("interaction", "sym"), ("interaction", "row"),
                                        ("social", "row"), ("social", "sym")])
def test_normalized_matrices_match_jax(which, mode):
    jmodel, _, tmodel = _both("SocialMF", load=False)
    if which == "interaction":
        got = tgraph.normalized_interaction(tmodel.data, mode)
        want = jgraph.normalized_interaction(jmodel.data, mode)
    else:
        got = tgraph.normalized_social_adjacency(tmodel.social, mode)
        want = jgraph.normalized_social_adjacency(jmodel.social, mode)
    assert got.shape == want.shape and got.nnz > 0
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="mode"):
        tgraph.normalized_interaction(tmodel.data, "col")


RELATIONS = {
    # a 4-cycle and a symmetric star: equal ranks in exact arithmetic
    "ties": [["a", "b"], ["b", "c"], ["c", "d"], ["d", "a"], ["h", "s1"], ["s1", "h"],
             ["h", "s2"], ["s2", "h"], ["h", "s3"], ["s3", "h"]],
    # users who only receive links (dangling), a repeated edge, a self-link
    "dangling": [["u1", "t1"], ["u1", "t2"], ["u2", "t1"], ["u2", "u1"], ["u2", "u1"],
                 ["t2", "t2"], ["u3", "t3"], ["u4", "t3"]],
    "social test": [r[:2] for r in _rows()[1]],
}


@pytest.mark.parametrize("case", list(RELATIONS))
def test_pagerank_and_its_rank_weights_match_networkx(case):
    relation = [r + [1.0] for r in RELATIONS[case]]
    g = nx.DiGraph()
    for u1, u2, _ in relation:
        g.add_edge(u1, u2)
    want = nx.pagerank(g, alpha=0.85)
    got = tsm.pagerank(relation)
    assert list(got) == list(want) and got == want
    ranked = sorted(want.items(), key=lambda d: d[1], reverse=True)
    assert list(tsm.rank_weights(got)) == [u for u, _ in ranked]
    assert tsm.pagerank([]) == {}


def test_locabal_coefficients_equal_jax():
    """LOCABAL's per-user coefficient 1 + w_u (ties in node order) and its
    edge cosines against the constants of the JAX package's loss."""
    _, spec, tmodel = _both("LOCABAL")
    tmodel.build()
    np.testing.assert_array_equal(tmodel.coeff.numpy(), np.asarray(_closure(spec.loss_fn, "coeff_d")))
    assert (tmodel.coeff.numpy() > 1).sum() > 30
    np.testing.assert_allclose(tmodel.sim.numpy(), np.asarray(_closure(spec.loss_fn, "sim")), **F32)


# ---------------------------------------------------------------------------
# the bundled configs on the CPU
# ---------------------------------------------------------------------------

# the RMSE ceilings of tests/test_social_models.py:52-78, with its rates
CEILINGS = {"SoRec": 1.6, "SoReg": 1.6, "SocialMF": 1.6, "RSTE": 1.7, "LOCABAL": 1.7,
            "SREE": 1.7, "SocialFD": 1.8}
RATES = {"SREE": "-init 0.01 -max 1", "SocialFD": "-init 0.005 -max 1"}


@pytest.mark.parametrize("name", MODELS)
def test_bundled_config_runs_on_cpu(tmp_path, capsys, name):
    """``config/<name>.conf`` with its model arguments, at the JAX tests'
    small size: 25 epochs of d=8, batch 64, with the per-epoch MAE/RMSE
    lines and the two result files."""
    ratings, trust = _files(tmp_path)
    conf = ModelConf(str(CONFIG / f"{name}.conf"))
    for key, value in (("ratings", ratings), ("social", trust), ("num.factors", "8"),
                       ("num.max.epoch", "25"), ("batch_size", "64"),
                       ("learnRate", RATES.get(name, "-init 0.02 -max 1")),
                       ("reg.lambda", "-u 0.01 -i 0.01 -b 0.1 -s 0.1"),
                       ("output.setup", f"on -dir {tmp_path / 'out'}/")):
        conf[key] = value
    rec = QRec(conf, seed=3, device="cpu")
    parsed = metrics.parse_measure(rec.execute())["global"]
    assert parsed["RMSE"] < CEILINGS[name], parsed
    assert "RMSE:" in capsys.readouterr().out
    assert rec.model.graph_seconds >= 0 and len(rec.model.epoch_losses) >= 2
    assert len(list((tmp_path / "out").iterdir())) == 2
