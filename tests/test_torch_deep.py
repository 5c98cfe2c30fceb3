"""The deep and GAN slice of the PyTorch port (NeuMF, DMF, CDAE, CFGAN, APR,
IRGAN) against the JAX package: every loss and its gradients at the JAX
parameters on one fixed batch (IRGAN's on injected samples), NeuMF's three
phases and APR's two on the JAX sampler's batches, each scorer's score
block and ranking, the pointwise sampler, the multi-phase training entry,
and the planted-block quality floors of ``tests/test_deep_models.py``.

Tolerances: a loss within rtol 1e-5 and each gradient within rtol 1e-5,
atol 1e-6 (the same f32 terms summed in another order); after whole phases
the tables within 1e-4 and the epoch losses within rtol 1e-3 (Adam steps
of another framework's rounding, compounded); score blocks within 1e-5,
top-k ids equal except where near-equal scores (1e-5) swap."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.split import data_split
from qrec_tpu.models import deep as jdeep
from qrec_tpu.models import gan as jgan
from qrec_tpu.ops import topk as jtopk
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.models import MODELS, deep, gan
from qrec_tpu_torch.ops.metrics import parse_measure
from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreBlock
from qrec_tpu_torch.runtime import trainer as T

MODEL_ARGS = {"CDAE": "-co 0.8 -nh 16", "APR": "-eps 0.5 -regA 1 -advEpoch 2"}
JMODELS = {"NeuMF": jdeep.NeuMF, "DMF": jdeep.DMF, "CDAE": jdeep.CDAE, "CFGAN": jdeep.CFGAN,
           "APR": jdeep.APR, "IRGAN": jgan.IRGAN}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _conf(name, extra=None):
    base = {
        "ratings": "unused",
        "ratings.setup": "-columns 0 1 2",
        "model.name": name,
        "evaluation.setup": "-ap 0.25",
        "item.ranking": "on -topN 5",
        "num.factors": "6",
        "num.max.epoch": "4",
        "batch_size": "16",
        "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.01 -i 0.01 -b 0.2 -s 0.2",
        "output.setup": "off -dir ./results/",
        "train.chunk": "1",
        "seed": "11",
    }
    if name in MODEL_ARGS:
        base[name] = MODEL_ARGS[name]
    base.update(extra or {})
    return base


def _records(users=14, items=24, per_user=7, seed=5):
    rng = np.random.RandomState(seed)
    records = [[f"u{u}", f"i{i}", 1.0]
               for u in range(users) for i in rng.choice(items, size=per_user, replace=False)]
    return data_split(records, 0.25, rng=random.Random(2))


def both(name, extra=None):
    """The JAX model and the port's, on the same split."""
    train, test = _records()
    jconf, tconf = jconfig.ModelConf(_conf(name, extra)), ModelConf(_conf(name, extra))
    jmodel = JMODELS[name](jconf, JInteractions(jconf, train, test))
    tmodel = MODELS[name](tconf, Interactions(tconf, train, test), device="cpu")
    return jmodel, tmodel


def load(tmodel, params):
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu"))


def check_loss_and_grads(loss, params, jloss, jgrads):
    """``loss`` (the port's, before backward) against the JAX value and its
    gradients (a pytree) for the port's ``params`` {name: tensor}; a
    tensor the loss does not reach has a zero JAX gradient."""
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), "cpu")
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        got = torch.zeros_like(params[name]) if g is None else g
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def captured_fit(jmodel, monkeypatch):
    """Run the JAX model's ``fit`` with its phases captured: the loss of
    each phase and the epoch batches its sampler drew, and the loss of
    every epoch as the JAX loop emits it. Returns (phases [(loss_fn,
    max_epoch)], batches, losses)."""
    phases, batches, losses = [], [], []
    real_run = jmodel.run_training

    def run_training(params, loss_fn, sampler, **kw):
        phases.append((loss_fn, kw.get("max_epoch") or jmodel.max_epoch))

        def recording(rng):
            out = sampler(rng)
            batches.append(tuple(np.asarray(a) for a in out))
            return out

        return real_run(params, loss_fn, recording, **kw)

    def make_emit(max_epoch, log_every, rating_eval):
        return lambda epoch, loss, *a, **k: losses.append(float(loss))

    monkeypatch.setattr(jmodel, "run_training", run_training)
    monkeypatch.setattr(jmodel, "_make_emit", make_emit)
    jmodel.fit()
    return phases, batches, losses


# -- losses and gradients at the JAX parameters ------------------------------


def test_neumf_phase_losses_and_gradients_match_jax():
    jmodel, tmodel = both("NeuMF")
    params = jmodel._init_params()
    load(tmodel, params)
    batch = tuple(np.asarray(a)[0] for a in jmodel.pointwise_sampler()(jax.random.PRNGKey(3)))
    _, loss_mf, loss_mlp, loss_neu = jmodel._losses()
    tparams = dict(tmodel.named_parameters())
    for jloss_fn, loss_fn in ((loss_mf, tmodel.loss_mf), (loss_mlp, tmodel.loss_mlp),
                              (loss_neu, tmodel.loss_neu)):
        jloss, jgrads = jax.value_and_grad(jloss_fn)(params, batch, None)
        check_loss_and_grads(loss_fn(T.as_device_batches(batch, "cpu")), tparams, jloss, jgrads)


def test_apr_phase_losses_and_gradients_match_jax(monkeypatch):
    jmodel, tmodel = both("APR")
    params = jmodel.init_embeddings("normal")
    load(tmodel, params)
    phases, batches, _ = captured_fit(jmodel, monkeypatch)
    # trained tables: the FGSM deltas are not vanishingly small
    trained = {"user_emb": jnp.asarray(np.random.RandomState(0).randn(*params["user_emb"].shape) * 0.3,
                                       dtype=jnp.float32),
               "item_emb": jnp.asarray(np.random.RandomState(1).randn(*params["item_emb"].shape) * 0.3,
                                       dtype=jnp.float32)}
    load(tmodel, trained)
    tparams = dict(tmodel.named_parameters())
    batch = tuple(a[0] for a in batches[0])
    # a user twice in the batch gets one delta per row
    assert len(set(batch[0].tolist())) < len(batch[0])
    for (jloss_fn, _), loss_fn in zip(phases, (tmodel.base_loss, tmodel.adv_loss)):
        jloss, jgrads = jax.value_and_grad(jloss_fn)(trained, batch, None)
        check_loss_and_grads(loss_fn(T.as_device_batches(batch, "cpu")), tparams, jloss, jgrads)


@pytest.mark.parametrize("name", ["DMF", "CDAE"])
def test_spec_loss_and_gradients_match_jax(name):
    jmodel, tmodel = both(name)
    spec = jmodel.build()
    load(tmodel, spec.params)
    batch = tuple(np.asarray(a)[0] for a in spec.sampler(jax.random.PRNGKey(3)))
    jloss, jgrads = jax.value_and_grad(spec.loss_fn)(spec.params, batch, None)
    check_loss_and_grads(tmodel.loss(T.as_device_batches(batch, "cpu")),
                         dict(tmodel.named_parameters()), jloss, jgrads)


def _cfgan_case(jmodel, tmodel, seed=0):
    """Random G and D tables, a batch of users and Bernoulli draws (at 0.2,
    so both masks are busy); the port's batch and the JAX one, formed as
    ``CFGAN.fit``'s ``batch_data`` forms it."""
    rng = np.random.RandomState(seed)
    n = jmodel.num_items
    g = {"W1": rng.randn(n, n).astype(np.float32) * 0.2, "b1": rng.randn(n).astype(np.float32) * 0.1}
    d = {"W1": rng.randn(2 * n, 1).astype(np.float32) * 0.2, "b1": rng.randn(1).astype(np.float32) * 0.1}
    load(tmodel, {"g": g, "d": d})
    uids = rng.randint(0, jmodel.num_users, size=8)
    zr, pm = rng.rand(8, n) < 0.2, rng.rand(8, n) < 0.2
    c = np.asarray(jmodel.dense_ratings())[uids]
    pos = (c > 0).astype(np.float32)
    jbatch = (c, pos + pm * (1 - pos), zr * (1 - pos))
    tbatch = tmodel.batch((torch.as_tensor(uids), torch.as_tensor(zr), torch.as_tensor(pm)))
    for want, got in zip(jbatch, tbatch):
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    return g, d, jbatch, tbatch


def test_cfgan_d_and_g_losses_and_gradients_match_jax():
    jmodel, tmodel = both("CFGAN")
    g, d, jbatch, (c, mask, n_zr) = _cfgan_case(jmodel, tmodel)
    _, _, d_loss_fn, g_loss_fn = jdeep.cfgan_fns(tmodel.alpha)
    tparams = dict(tmodel.named_parameters())
    jloss, jgrads = jax.value_and_grad(d_loss_fn)(d, g, *jbatch)
    check_loss_and_grads(tmodel.d_loss(c, mask), {k: v for k, v in tparams.items() if k[0] == "d"},
                         jloss, {"d": jgrads})
    jloss, jgrads = jax.value_and_grad(g_loss_fn)(g, d, *jbatch)
    check_loss_and_grads(tmodel.g_loss(c, mask, n_zr),
                         {k: v for k, v in tparams.items() if k[0] == "g"}, jloss, {"g": jgrads})


def _irgan_jax_epoch(jmodel, injected, monkeypatch):
    """One JAX IRGAN epoch (5 D steps, 10 G steps) with ``injected[k]``
    (k, U) as every categorical draw of k samples, and every step's loss,
    gradients and input parameters captured."""
    captured = []
    real = jax.value_and_grad

    def spy(fn, *a, **kw):
        vg = real(fn, *a, **kw)

        def wrapped(params):
            out = vg(params)
            jax.debug.callback(lambda p, l, g: captured.append(
                jax.tree_util.tree_map(np.asarray, (p, l, g))), params, *out, ordered=True)
            return out

        return wrapped

    def categorical(key, logits, axis=-1, shape=None):
        return jnp.asarray(injected[shape[0]])

    monkeypatch.setattr(jax, "value_and_grad", spy)
    monkeypatch.setattr(jax.random, "categorical", categorical)
    jmodel.fit()
    monkeypatch.undo()
    return captured


def _irgan_initial(jmodel):
    """The JAX IRGAN's initial tables, drawn as its ``fit`` draws them."""
    ks = jax.random.split(jax.random.PRNGKey(jmodel.seed), 4)
    u, i, d = jmodel.num_users, jmodel.num_items, jmodel.emb_size
    table = lambda k, rows: jgan._uniform_init(k, (rows, d))  # noqa: E731
    return {"gen": {"user_emb": table(ks[0], u), "item_emb": table(ks[1], i), "item_bias": jnp.zeros(i)},
            "dis": {"user_emb": table(ks[2], u), "item_emb": table(ks[3], i), "item_bias": jnp.zeros(i)}}


def _irgan_injection(tmodel):
    """Samples for every D and G draw: negatives that are not positives,
    generator samples anywhere; keyed by their count k, as (U, k)."""
    rng = np.random.RandomState(4)
    u, n = tmodel.num_users, tmodel.num_items
    rated = tmodel.dense_ratings().numpy() > 0
    negs = np.stack([rng.choice(np.flatnonzero(~rated[x]), tmodel.k_neg) for x in range(u)])
    samples = rng.randint(0, n, size=(u, tmodel.k_gen))
    return {tmodel.k_neg: torch.as_tensor(negs), tmodel.k_gen: torch.as_tensor(samples)}


def test_irgan_d_and_g_losses_and_gradients_match_jax(monkeypatch):
    jmodel, tmodel = both("IRGAN", {"num.max.epoch": "1"})
    injected = _irgan_injection(tmodel)
    captured = _irgan_jax_epoch(jmodel, {k: v.numpy().T for k, v in injected.items()}, monkeypatch)
    assert len(captured) == tmodel.d_steps + tmodel.g_steps
    monkeypatch.setattr(tmodel, "draw", lambda probs, k, rng: injected[k])
    initial = _irgan_initial(jmodel)
    load(tmodel, initial)
    tparams = dict(tmodel.named_parameters())
    dis = {k: v for k, v in tparams.items() if k.startswith("dis.")}
    gen_ = {k: v for k, v in tparams.items() if k.startswith("gen.")}
    # the first D step, at the initial tables
    params, jloss, jgrads = captured[0]
    for key in params:
        np.testing.assert_array_equal(np.asarray(initial["dis"][key]), params[key])
    check_loss_and_grads(tmodel.d_loss(*tmodel.d_inputs(None)), dis, jloss, {"dis": jgrads})
    # the first G step: the initial generator, the discriminator after its
    # five steps (the JAX model's final one: G steps leave it as it is)
    load(tmodel, {"gen": initial["gen"], "dis": jmodel.dis})
    params, jloss, jgrads = captured[tmodel.d_steps]
    check_loss_and_grads(tmodel.g_loss(*tmodel.g_inputs(None)), gen_, jloss, {"gen": jgrads})


def test_irgan_epoch_on_injected_samples_matches_jax(monkeypatch, capsys):
    jmodel, tmodel = both("IRGAN", {"num.max.epoch": "1"})
    injected = _irgan_injection(tmodel)
    captured = _irgan_jax_epoch(jmodel, {k: v.numpy().T for k, v in injected.items()}, monkeypatch)
    monkeypatch.setattr(tmodel, "draw", lambda probs, k, rng: injected[k])
    load(tmodel, _irgan_initial(jmodel))
    tmodel.fit()
    np.testing.assert_allclose(tmodel.epoch_losses, [captured[tmodel.d_steps - 1][1]], rtol=1e-3)
    np.testing.assert_allclose(tmodel.g_losses, [captured[-1][1]], rtol=1e-3, atol=1e-6)
    want = params_from_jax({"gen": jax.tree_util.tree_map(np.asarray, jmodel.gen),
                            "dis": jax.tree_util.tree_map(np.asarray, jmodel.dis)}, "cpu")
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), atol=1e-4, err_msg=key)
    assert "IRGAN [1] epoch 1: D_loss = " in capsys.readouterr().out


def test_irgan_sampling_dist_and_reward_match_jax():
    rng = np.random.RandomState(2)
    u, n, maxdeg = 5, 9, 4
    prob = rng.dirichlet(np.ones(n), size=u).astype(np.float32)
    deg = np.array([4, 1, 0, 3, 2])
    pos_pad = np.zeros((u, maxdeg), dtype=np.int32)
    for x in range(u):
        pos_pad[x, : deg[x]] = rng.choice(n, deg[x], replace=False)
    pos_mask = (np.arange(maxdeg)[None] < deg[:, None]).astype(np.float32)
    want = jgan.generator_sampling_dist(jnp.asarray(prob), jnp.asarray(pos_pad), jnp.asarray(pos_mask),
                                        jnp.asarray(deg, dtype=jnp.float32))
    pn = gan.generator_sampling_dist(torch.as_tensor(prob), torch.as_tensor(pos_pad, dtype=torch.int64),
                                     torch.as_tensor(pos_mask), torch.as_tensor(deg, dtype=torch.float32))
    np.testing.assert_allclose(pn.numpy(), np.asarray(want), rtol=1e-6)
    sample = rng.randint(0, n, size=(u, 6))
    d_logits = rng.randn(u, 6).astype(np.float32)
    want = jgan.importance_reward(jnp.asarray(d_logits), jnp.asarray(prob), want, jnp.asarray(sample))
    got = gan.importance_reward(torch.as_tensor(d_logits), torch.as_tensor(prob), pn,
                                torch.as_tensor(sample, dtype=torch.int64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- phases on the JAX sampler's batches -------------------------------------


@pytest.mark.parametrize("name,phase_epochs", [("NeuMF", [4, 2, 1]), ("APR", [2, 2])])
def test_phases_on_injected_batches_match_jax(name, phase_epochs, monkeypatch, capsys):
    jmodel, tmodel = both(name)
    initial = jmodel._init_params() if name == "NeuMF" else jmodel.init_embeddings("normal")
    load(tmodel, initial)
    phases, batches, jlosses = captured_fit(jmodel, monkeypatch)
    assert [e for _, e in phases] == phase_epochs and len(batches) == sum(phase_epochs)
    capsys.readouterr()
    losses = tmodel.fit(epoch_batches=batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    assert [len(p) for p in tmodel.phase_losses] == phase_epochs
    assert tmodel._epochs_done == sum(phase_epochs)
    final = jmodel.params if name == "NeuMF" else {"user_emb": jmodel.U, "item_emb": jmodel.V}
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, final), "cpu")
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), atol=1e-4, err_msg=key)
    out = capsys.readouterr().out
    heads = (["pretraining... (GMF)", "pretraining... (MLP)", "training... (NeuMF)"]
             if name == "NeuMF" else ["pretraining...", "adversarial training..."])
    assert [line for line in out.splitlines() if line in heads] == heads


# -- score blocks and rankings -----------------------------------------------


def _scoring_pair(name):
    """(JAX model ready to score, port model ready to score) at the same
    parameters."""
    jmodel, tmodel = both(name)
    if name == "NeuMF":
        params = jmodel._init_params()
        jmodel.params, jmodel._y_neu = params, jmodel._losses()[0]
        load(tmodel, params)
    elif name in ("DMF", "CDAE"):
        spec = jmodel.build()
        jmodel.finalize(spec.params, spec)
        load(tmodel, spec.params)
        tmodel.finalize()
    elif name == "CFGAN":
        g, d, _, _ = _cfgan_case(jmodel, tmodel)
        jmodel._gen, jmodel.g_params = jdeep.cfgan_fns(tmodel.alpha)[0], g
    elif name == "APR":
        rng = np.random.RandomState(3)
        params = {k: rng.randn(n, 6).astype(np.float32)
                  for k, n in (("user_emb", jmodel.num_users), ("item_emb", jmodel.num_items))}
        jmodel.U, jmodel.V = jnp.asarray(params["user_emb"]), jnp.asarray(params["item_emb"])
        load(tmodel, params)
        tmodel.U, tmodel.V = tmodel.user_emb.detach(), tmodel.item_emb.detach()
    else:  # IRGAN: the discriminator's tables and a non-zero item bias
        initial = _irgan_initial(jmodel)
        initial["dis"]["item_bias"] = jnp.asarray(np.random.RandomState(3).randn(jmodel.num_items),
                                                  dtype=jnp.float32)
        load(tmodel, initial)
        dis = initial["dis"]
        jmodel.U, jmodel.V, jmodel.item_bias = dis["user_emb"], dis["item_emb"], dis["item_bias"]
        tmodel.U, tmodel.V = tmodel.dis["user_emb"].detach(), tmodel.dis["item_emb"].detach()
        tmodel.item_bias = tmodel.dis["item_bias"].detach()
    return jmodel, tmodel


@pytest.mark.parametrize("name", ["NeuMF", "DMF", "CDAE", "CFGAN"])
def test_score_block_matches_jax_score_fn(name):
    jmodel, tmodel = _scoring_pair(name)
    score_fn, params = jmodel.score_fn_params()
    uids = np.arange(jmodel.num_users)
    want = np.asarray(score_fn(params, jnp.asarray(uids, dtype=jnp.int32)))
    form = tmodel.score_form()
    assert isinstance(form, ScoreBlock)
    with torch.no_grad():
        got = form.fn(torch.as_tensor(uids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["NeuMF", "DMF", "CDAE", "CFGAN", "APR", "IRGAN"])
def test_ranking_matches_jax_ranker(name):
    """The whole ranking of the test users, in each model's
    ``eval_batch_size``: the JAX ranker's XLA top-k against the port's
    score block (NeuMF, DMF, CDAE, CFGAN) or K2's plain version (APR,
    IRGAN with its item bias)."""
    jmodel, tmodel = _scoring_pair(name)
    assert tmodel.eval_batch_size == jmodel.eval_batch_size
    score_fn, params = jmodel.score_fn_params()
    jranker = jtopk.CatalogRanker(jmodel.data, k=5, batch_size=jmodel.eval_batch_size)
    jids, jscores = jranker.topk(score_fn, params)
    ranker = CatalogRanker(tmodel.data, k=5, device="cpu", bitmask=tmodel.rated_bitmask,
                           batch_size=tmodel.eval_batch_size)
    ids, scores = ranker.topk(tmodel.score_form())
    np.testing.assert_allclose(scores, jscores, rtol=1e-5, atol=1e-5)
    same = (ids == jids).all(axis=1)
    near_tie = np.abs(np.diff(np.sort(jscores, axis=1), axis=1)).min(axis=1) <= 1e-5
    assert (same | near_tie).all()


def test_score_block_top_k_matches_jax_batch():
    """The shared block top-k: rated items at 0, unseen users (-1) at the
    global mean, ties to the lower item, as the JAX ranker's ``_topk_batch``
    does it (duplicated scores on purpose)."""
    _, tmodel = both("CDAE")
    data = tmodel.data
    rng = np.random.RandomState(0)
    scores = np.round(rng.rand(data.num_users, data.num_items), 1).astype(np.float32)
    uids = np.array([0, -1, 3, 5, -1, data.num_users - 1])
    rated = np.full((len(uids), data.num_items), data.num_items, dtype=np.int32)
    for b, u in enumerate(uids):
        if u >= 0:
            row = data.user_row_ids(int(u))
            rated[b, : len(row)] = row
    gm = np.float32(data.global_mean)
    jids, jvals = jtopk._topk_batch(lambda p, u: p[u], jnp.asarray(scores), jnp.asarray(uids),
                                    jnp.asarray(rated), jnp.asarray(gm), 7, data.num_items)
    ranker = CatalogRanker(data, k=7, device="cpu", bitmask=tmodel.rated_bitmask)
    table = torch.as_tensor(scores)
    ids, vals = ranker._block_topk(table[torch.as_tensor(uids).clamp(min=0)], torch.as_tensor(uids), 7)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("name", ["NeuMF", "DMF", "CDAE", "CFGAN", "APR", "IRGAN"])
def test_predict_ratings_match_jax(name):
    """Rating predictions at the same parameters, with the reference's
    fallbacks for an unknown user and an unknown item: NeuMF's fused head;
    the others' ``U·V`` (DMF's and IRGAN's final tables; none for CDAE and
    CFGAN, whose known pairs read 0), as in the JAX package."""
    jmodel, tmodel = _scoring_pair(name)
    data = tmodel.data
    users = [data.id2user[u] for u in range(data.num_users)] + ["nobody", data.id2user[0]]
    items = [data.id2item[i % data.num_items] for i in range(data.num_users)] + ["nothing"] * 2
    np.testing.assert_allclose(tmodel.predict_ratings(users, items),
                               jmodel.predict_ratings(users, items), rtol=1e-5, atol=1e-6)


# -- the pointwise sampler ---------------------------------------------------


def test_pointwise_epoch_layout_labels_weights_and_negatives():
    _, tmodel = both("NeuMF", {"batch_size": "20"})
    gen = torch.Generator().manual_seed(0)
    users, items, labels, weight = tmodel.pointwise_sampler()(gen)
    n, k = tmodel.train_size, 5
    nb = -(-n // 20)
    assert users.shape == items.shape == labels.shape == weight.shape == (nb, 20 * k)
    u, i, r, w = (t.reshape(-1, k) for t in (users, items, labels, weight))
    # each positive first, then its user's four negatives
    assert (u == u[:, :1]).all()
    assert (r[:, 0] == 1).all() and (r[:, 1:] == 0).all()
    # weights: 1 on the first n positives and their negatives, 0 on the pad
    assert (w == w[:, :1]).all() and int(w[:, 0].sum()) == n and (w[n:] == 0).all()
    rated = tmodel.dense_ratings() > 0
    assert rated[u[:n, 0], i[:n, 0]].all()
    assert not rated[u[:, 1:], i[:, 1:]].any()
    # the real rows hold every training pair once
    pairs = sorted(zip(u[:n, 0].tolist(), i[:n, 0].tolist()))
    assert pairs == sorted(zip(tmodel.data.train_u.tolist(), tmodel.data.train_i.tolist()))


def test_pointwise_epoch_shapes_match_jax():
    jmodel, tmodel = both("NeuMF")
    jb = jmodel.pointwise_sampler()(jax.random.PRNGKey(0))
    tb = tmodel.pointwise_sampler()(torch.Generator().manual_seed(0))
    assert [tuple(a.shape) for a in jb] == [tuple(t.shape) for t in tb]
    np.testing.assert_array_equal(np.asarray(jb[2]), tb[2].numpy())
    np.testing.assert_array_equal(np.asarray(jb[3]), tb[3].numpy())


# -- the multi-phase entry ---------------------------------------------------


def test_shared_tracker_numbers_epochs_across_phases(monkeypatch):
    """Two phases sharing one tracker: the best epoch is numbered across
    both (the JAX tracker's ``epoch_offset``), and ``_epochs_done`` counts
    both phases."""
    _, tmodel = both("APR")
    script = iter([{"Recall": r} for r in (0.1, 0.3, 0.2, 0.5, 0.4)])
    tracker = T.BestTracker()
    tmodel.begin_fit()
    params = list(tmodel.parameters())
    sampler = tmodel.pairwise_sampler()
    for epochs in (2, 3):
        tmodel.run_training(params, tmodel.base_loss, sampler, max_epoch=epochs,
                            track_best=True, quick_eval=lambda: next(script), tracker=tracker)
    assert tracker.best_epoch == 4 and tracker.epoch_offset == 5
    assert tmodel._epochs_done == 5 and [len(p) for p in tmodel.phase_losses] == [2, 3]


# -- end to end on planted blocks --------------------------------------------


def _write_block_dataset(tmp_path):
    """``tests/test_deep_models.py``'s planted blocks."""
    rng = np.random.RandomState(0)
    lines = []
    for u in range(40):
        block = 0 if u < 20 else 1
        for i in rng.choice(15, size=10, replace=False) + block * 15:
            lines.append(f"u{u} i{i} 1\n")
    p = tmp_path / "ratings.txt"
    p.write_text("".join(lines))
    return str(p)


PLANTED = [
    ("NeuMF", {"num.max.epoch": "20"}, 0.45),
    ("DMF", {"num.max.epoch": "15", "learnRate": "-init 0.001 -max 1"}, 0.45),
    ("CDAE", {"CDAE": "-co 0.8 -nh 32", "num.max.epoch": "150", "batch_size": "32"}, 0.45),
    ("APR", {"APR": "-eps 0.5 -regA 1 -advEpoch 10"}, 0.5),
    ("IRGAN", {"num.max.epoch": "30", "learnRate": "-init 0.02 -max 1"}, 0.4),
    ("CFGAN", {"num.max.epoch": "50", "batch_size": "32"}, None),
]


@pytest.mark.parametrize("name,extra,floor", PLANTED)
def test_deep_model_learns_blocks(tmp_path, name, extra, floor):
    """The JAX package's floors (``test_deep_model_learns_blocks``), and a
    CFGAN run whose adversarial dynamics get no floor there either; each
    writes its top-10 list and its measure file."""
    out = tmp_path / "results"
    conf = {
        "ratings": _write_block_dataset(tmp_path), "ratings.setup": "-columns 0 1 2",
        "model.name": name, "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10",
        "num.factors": "8", "num.max.epoch": "30", "batch_size": "64",
        "learnRate": "-init 0.01 -max 1", "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1",
        "output.setup": f"on -dir {out}/", "seed": "7", **extra,
    }
    recall = parse_measure(QRec(ModelConf(conf), seed=3, device="cpu").execute())["Top 10"]["Recall"]
    files = sorted(p.name for p in out.iterdir())
    assert any("-top-10items[1].txt" in f for f in files) and any("-measure[1].txt" in f for f in files)
    if floor is None:
        assert 0 <= recall <= 1
    else:
        assert recall > floor, (name, recall)
