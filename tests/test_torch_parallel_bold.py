"""Slice 7e of the port on the CPU: the bold-driver family (BasicMF, PMF,
SVD, SVD++, EE, SoRec, SoReg, SocialMF, RSTE, LOCABAL, SREE, SocialFD,
SBPR and its ``-tf`` path, TBPR, CUNE_MF, CUNE_BPR) trained data-parallel,
each data rank's loss its share of the step's.

* The shares, with no spawn: each model at the JAX package's initial
  parameters on one JAX batch, its ``mesh`` stubbed as data rank k of 2, 3
  and 4. The shares' losses sum to the one-process loss within rtol 1e-6,
  their gradients within 1e-6 of the largest entry: a term counted on
  every rank, or on none, fails here.
* Spawned gloo ranks (``test_torch_parallel_ranks.fits_and_runs``): four
  (data 2 x model 2) and three (data 3 x model 1, where the batch rows,
  the trust edges, the users and the friend edges cut unevenly and the rating
  sampler's padded tail lands on the last data rank). Three epochs on the
  JAX sampler's batches from the JAX package's initial parameters (the
  walk models' friends from the JAX package's own build), in one process
  of the port and in the JAX package: the data ranks' first-step shares
  sum to one process's first loss within rtol 1e-5; the first step's
  gradients after the step's reduction within rtol 1e-5 and 1e-6 of the
  largest entry of one process's; the losses within rtol 1e-3 and the
  tables within 1e-4 of one process's and the JAX package's (the drift
  bounds of ``tests/test_torch_mf.py``); every rank equal to rank 0 bit
  for bit.
* Sessions on the ranks (``QRec(conf).execute()`` on planted files): PMF
  and SocialMF under the bold driver until the convergence rule stops them
  (they stop at the same epoch on every rank and in one process), and SVD
  ranked through route 7 (K2 on each rank's share of the test users, the
  lists gathered), whose lists equal one process's ranking of the same
  factors bit for bit; rank 0 alone writes the result files.

SBPR's ``-tf`` path trains with Adam, in both packages, and is held to
the same bounds."""

import random
import types

import jax
import numpy as np
import optax
import pytest
import torch

import test_torch_classical as TCL
import test_torch_mf as TMF
import test_torch_parallel_ranks as R
import test_torch_social_mf as TSM
import test_torch_social_ranking as TSR
import test_torch_walks as TW
from test_torch_parallel_models import _equal
from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.social import SocialGraph as JSocialGraph
from qrec_tpu.data.split import data_split
from qrec_tpu.models import classical as jcl
from qrec_tpu.models import mf as jmf
from qrec_tpu.models import social_mf as jsm
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.social import SocialGraph
from qrec_tpu_torch.models import get_model
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreForm
from qrec_tpu_torch.runtime import trainer as T

SOCIAL_MF = ["SoRec", "SoReg", "SocialMF", "RSTE", "LOCABAL", "SREE", "SocialFD"]
# label -> family
LABELS = {"BasicMF": "mf", "PMF": "mf", "SVD": "mf", "SVD++": "classical", "EE": "classical",
          **{name: "social_mf" for name in SOCIAL_MF},
          "SBPR": "social_ranking", "SBPR-tf": "social_ranking", "TBPR": "social_ranking",
          "CUNE_MF": "walk", "CUNE_BPR": "walk"}
EPOCHS = 3
MESH = {4: "on -model 2", 3: "on"}
# sessions on the ranks: the bold runs that converge before num.max.epoch,
# and SVD ranked through route 7
CONVERGING = ["PMF", "SocialMF"]
MAX_EPOCH = 200


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # module-scoped: the module's runs sum on one thread, as the ranks do
    torch.set_num_threads(1)


def _problem(label):
    """(conf, train, test, trust rows or None, JAX model class) of each
    family's one-process parity test."""
    family = LABELS[label]
    name = label.split("-")[0]
    if family == "mf":
        train, test = TMF.rated_split()
        return TMF._conf(name), train, test, None, getattr(jmf, name)
    if family == "classical":
        train, test = TCL._rated_split()
        name = "SVDPlusPlus" if name == "SVD++" else name
        return TCL._conf(name), train, test, None, getattr(jcl, name)
    if family == "social_mf":
        ratings, trust = TSM._rows()
        train, test = data_split(ratings, 0.2, rng=random.Random(3))
        return TSM._conf(name), train, test, trust, getattr(jsm, name)
    if family == "social_ranking":
        ratings, trust = TSR._rows(name)
        train, test = data_split(ratings, 0.2, rng=random.Random(3))
        extra = TSR.TF if label.endswith("-tf") else None
        return TSR._conf(name, extra), train, test, trust, TSR.J_MODELS[name]
    train, test = data_split(TW._records(name == "CUNE_MF"), 0.2, rng=random.Random(3))
    return TW._conf(name), train, test, None, TW.J_MODELS[name]


def _jax_epochs(jmodel, spec, adam):
    """The JAX package's epoch loop: bold-driver SGD with the convergence
    rule, or fixed-rate Adam (SBPR's ``-tf`` path,
    ``qrec_tpu/models/base.py:513-516,709-710``). Returns (epoch batches,
    losses, final parameters)."""
    if adam:
        optimizer = optax.adam(jmodel.lrate)
    else:
        optimizer = optax.inject_hyperparams(optax.sgd)(learning_rate=jmodel.lrate)
    run_epoch = jtrainer.make_epoch_runner(spec.loss_fn, optimizer)
    params, opt_state = spec.params, optimizer.init(spec.params)
    bold, conv = jtrainer.BoldDriver(jmodel.lrate, jmodel.max_lrate), jtrainer.ConvergenceMonitor()
    rng = jax.random.PRNGKey(0)
    batches, losses = [], []
    for epoch in range(EPOCHS):
        rng, rs, rt = jax.random.split(rng, 3)
        b = spec.sampler(rs)
        batches.append(tuple(np.asarray(a) for a in b))
        params, opt_state, loss = run_epoch(params, opt_state, b, rt)
        losses.append(float(loss))
        if adam:
            continue
        if conv.check(losses[-1]):
            break
        lr = bold.update(epoch + 1, losses[-1])
        bold.last_loss = losses[-1]
        opt_state = jtrainer._set_lr(opt_state, lr)
    return batches, losses, params


def _case(label):
    """The port's fit case of ``label`` (conf, split, relation, the JAX
    initial parameters, the JAX sampler's batches, the walk models'
    friends) and the JAX package's run (losses, final tables)."""
    conf, train, test, trust, jcls = _problem(label)
    jconf = jconfig.ModelConf(conf)
    jd = JInteractions(jconf, train, test)
    jmodel = jcls(jconf, jd, social=JSocialGraph(trust, jd)) if trust else jcls(jconf, jd)
    friends = []
    if LABELS[label] == "walk":  # the friends of the JAX package's build, handed to the port
        real = jmodel.implicit_friends
        jmodel.implicit_friends = lambda: friends.append(real()) or friends[0]
    spec = jmodel.build()
    init = {k: np.asarray(v) for k, v in spec.params.items()}
    batches, losses, params = _jax_epochs(jmodel, spec, label.endswith("-tf"))
    case = {"conf": conf, "train": train, "test": test, "relation": trust, "params": init,
            "batches": batches, "friends": friends[0] if friends else None}
    return case, {"losses": losses, "tables": {k: np.asarray(v) for k, v in params.items()}}


def _port_model(case):
    """The port's model of ``case`` at the JAX initial parameters, built
    (its host tables, SVD++'s segment arrays, the friends)."""
    conf = ModelConf(case["conf"])
    data = Interactions(conf, case["train"], case["test"])
    kwargs = {}
    if case["relation"] is not None:
        kwargs["social"] = SocialGraph(case["relation"], data)
    model = get_model(case["conf"]["model.name"])(conf, data, device="cpu", **kwargs)
    model.load_state_dict(params_from_jax(case["params"], "cpu"))
    if case["friends"] is not None:
        model.implicit_friends = lambda: case["friends"]
    model.build()
    return model


def _session_confs(tmp):
    """The session runs on the planted files of ``tests/test_torch_social_mf.py``
    (40 users, two blocks of 15 items, ratings 3-5, 3 trust links a user):
    PMF and SocialMF until they converge, SVD ranked at top-10."""
    ratings, trust = TSM._files(tmp)
    confs = {}
    for name in CONVERGING + ["SVD"]:
        conf = TSM._conf("SocialMF", {"ratings": ratings, "social": trust, "model.name": name,
                                      "num.max.epoch": str(MAX_EPOCH)})
        if name != "SocialMF":
            for key in ("social", "social.setup"):
                conf.pop(key)
        label = f"{name}-converges"
        if name == "SVD":
            conf.update({"item.ranking": "on -topN 10", "num.max.epoch": "3"})
            label = "SVD-ranked"
        confs[label] = conf
    return confs


@pytest.fixture(scope="module")
def problems():
    """Each label's case and the JAX package's run of it."""
    cases, jax_runs = {}, {}
    for label in LABELS:
        cases[label], jax_runs[label] = _case(label)
    return cases, jax_runs


@pytest.fixture(scope="module")
def trained(problems, tmp_path_factory):
    """One process of the port, four ranks and three ranks: the fits, then
    the sessions (one process's in this process)."""
    cases = problems[0]
    one = {label: R.fit_case(case) for label, case in cases.items()}
    tmp = tmp_path_factory.mktemp("bold_sessions")
    sessions = _session_confs(tmp)
    one_sessions = {}
    for label, conf in sessions.items():
        out = tmp / "one" / label
        one_sessions[label] = R.replicated_run(dict(conf, **{"output.setup": f"on -dir {out}/"}))
    ranks = {}
    for world, setup in MESH.items():
        on_mesh = {label: dict(case, conf=dict(case["conf"], **{"parallel.setup": setup}))
                   for label, case in cases.items()}
        runs = {label: (dict(conf, **{"parallel.setup": setup,
                                      "out_dir": str(tmp / f"ranks{world}")}), None)
                for label, conf in sessions.items()}
        ranks[world] = R.spawn(R.fits_and_runs, world, tmp_path_factory.mktemp(f"bold{world}"),
                               on_mesh, runs)
    return one, one_sessions, ranks, sessions


# ---------------------------------------------------------------------------
# (a) the shares sum to the whole loss: a stubbed mesh, no spawn
# ---------------------------------------------------------------------------


def _loss_and_grads(model, batch):
    params = list(model.parameters())
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


SHARES = [(label, parts) for label in LABELS for parts in (2, 3, 4)]


@pytest.mark.parametrize("label,parts", SHARES, ids=[f"{l}-{p}" for l, p in SHARES])
def test_shares_sum_to_the_one_process_loss(problems, label, parts):
    """Data rank k of ``parts`` (the mesh stubbed) computes its share of the
    step's loss on the first JAX batch: the shares' losses sum to the
    whole loss within rtol 1e-6 and their gradients within 1e-6 of the
    largest entry; data ranks' shares differ (each sums only its rows)."""
    case = problems[0][label]
    model = _port_model(case)
    batch = T.as_device_batches(tuple(a[0] for a in case["batches"][0]), "cpu")
    model._mesh = None
    whole, whole_grads = _loss_and_grads(model, batch)
    losses, sums = [], [torch.zeros_like(g, dtype=torch.float64) for g in whole_grads]
    for k in range(parts):
        model._mesh = types.SimpleNamespace(data=parts, data_index=k, model=1, model_index=0)
        loss, grads = _loss_and_grads(model, batch)
        losses.append(loss)
        for s, g in zip(sums, grads):
            s += g.double()
    np.testing.assert_allclose(sum(losses), whole, rtol=1e-6)
    assert len(set(losses)) > 1
    for (name, _), s, w in zip(model.named_parameters(), sums, whole_grads):
        np.testing.assert_allclose(s.numpy(), w.double().numpy(), rtol=0,
                                   atol=1e-6 * w.abs().max().item(), err_msg=name)


# ---------------------------------------------------------------------------
# (b) the fits on spawned gloo ranks
# ---------------------------------------------------------------------------

WORLD_FITS = [(world, label) for world in MESH for label in LABELS]
IDS = [f"{label}-{world}ranks" for world, label in WORLD_FITS]


@pytest.mark.parametrize("world,label", WORLD_FITS, ids=IDS)
def test_bold_models_train_on_the_mesh_as_one_process_and_jax(problems, trained, world, label):
    """Three epochs on the JAX sampler's batches: the data ranks' shares of
    the first step's loss sum to one process's, the losses and tables stay
    within the drift bounds of one process and the JAX package."""
    jax_run, one, ranks = problems[1][label], trained[0][label], trained[2][world]
    got = ranks[0]["fits"][label]
    model = 2 if world == 4 else 1
    assert got["mesh"] == {"data": world // model, "model": model} and one["mesh"] is None
    first = sum(r["fits"][label]["first_loss"] for r in ranks[::model])
    np.testing.assert_allclose(first, one["first_loss"], rtol=1e-5)
    shares = {r["fits"][label]["first_loss"] for r in ranks[::model]}
    assert len(shares) == world // model  # each data rank sums only its rows
    assert len(got["losses"]) == len(jax_run["losses"]) == EPOCHS
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-3)
    np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=1e-3)
    assert sorted(got["params"]) == sorted(jax_run["tables"])
    for key, value in got["params"].items():
        np.testing.assert_allclose(value, one["params"][key], atol=1e-4, err_msg=key)
        np.testing.assert_allclose(value, jax_run["tables"][key], atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["U"], one["U"], atol=1e-4)
    np.testing.assert_allclose(got["V"], one["V"], atol=1e-4)


@pytest.mark.parametrize("world,label", WORLD_FITS, ids=IDS)
def test_bold_first_step_gradients_match_one_process(trained, world, label):
    """The gradient invariant: after the step's reduction over ``data``,
    every parameter's gradient on every rank is one process's within rtol
    1e-5 and 1e-6 of its largest entry."""
    one, ranks = trained[0][label], trained[2][world]
    for rank in ranks:
        grads = rank["fits"][label]["grads"]
        assert sorted(grads) == sorted(one["grads"])
        for key, ref in one["grads"].items():
            np.testing.assert_allclose(grads[key], ref, rtol=1e-5,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=key)


# ---------------------------------------------------------------------------
# (c) the ranks agree bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", list(MESH))
def test_bold_ranks_stay_equal_bit_for_bit(trained, world):
    """Every rank's losses, tables, final factors and first-step gradients
    of each fit, and the measures, tables, predictions and rankings of each
    session, equal rank 0's bit for bit."""
    ranks = trained[2][world]
    for r, rank in enumerate(ranks[1:], 1):
        for label in LABELS:
            for key in ("losses", "params", "U", "V", "grads"):
                _equal(rank["fits"][label][key], ranks[0]["fits"][label][key],
                       f"rank {r} {label} {key}")
        for label in trained[3]:
            for key in ("measure", "params", "U", "V", "predictions", "losses", "ranked"):
                _equal(rank[label][key], ranks[0][label][key], f"rank {r} {label} {key}")


# ---------------------------------------------------------------------------
# (d) a converging bold run stops at the same epoch everywhere
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", [f"{name}-converges" for name in CONVERGING])
def test_converging_bold_run_stops_at_the_same_epoch_on_every_rank(trained, label):
    """``|Δloss| < 1e-3`` ends the run before ``num.max.epoch`` at the same
    epoch on four ranks, on three and in one process (every rank reads the
    epoch total summed over ``data``); the losses stay within rtol 1e-3 of
    one process's and the MAE/RMSE within 2e-2; rank 0 alone writes the
    prediction and measure files."""
    one = trained[1][label]
    stop = len(one["losses"]["epoch_losses"])
    assert 2 < stop < MAX_EPOCH
    ref = metrics.parse_measure(one["measure"])["global"]
    for world, ranks in trained[2].items():
        for r, rank in enumerate(ranks):
            got = rank[label]
            assert got["mesh"] == {"data": world // (2 if world == 4 else 1),
                                   "model": 2 if world == 4 else 1}
            assert len(got["losses"]["epoch_losses"]) == stop, (world, r)
            np.testing.assert_allclose(got["losses"]["epoch_losses"],
                                       one["losses"]["epoch_losses"], rtol=1e-3)
            parsed = metrics.parse_measure(got["measure"])["global"]
            for m in ("MAE", "RMSE"):
                assert abs(parsed[m] - ref[m]) < 2e-2, (m, parsed, ref)
        assert [len(rank[label]["files"]) for rank in ranks] == [2] + [0] * (world - 1)


# ---------------------------------------------------------------------------
# (e) SVD ranked through route 7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", list(MESH))
def test_svd_ranked_through_route_7_gives_one_process_lists(trained, world):
    """SVD under ``item.ranking=on``: each rank ranks its ``tensor_split``
    share of the test users through K2's biased form (one call a rank, its
    plain twin here) and the gathered lists equal one process's ranking of
    the same factors and biases bit for bit; the measures within 2e-2 of
    the one-process session; rank 0 alone writes the result files."""
    ranks, one = trained[2][world], trained[1]["SVD-ranked"]
    conf = trained[3]["SVD-ranked"]
    got = ranks[0]["SVD-ranked"]
    rec = QRec(ModelConf(conf), seed=3, device="cpu")  # the session's split
    data = Interactions(ModelConf(conf), rec.training_data, rec.test_data, seed=3)
    n = len(data.test_set_u)
    calls = [len(call) for rank in ranks for call in rank["SVD-ranked"]["k2_calls"]]
    assert calls == [len(c) for c in np.array_split(np.arange(n), world)]
    (ids, scores), = got["ranked"]
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    form = ScoreForm(t(got["U"]), t(got["V"]), item_bias=t(got["params"]["item_bias"]),
                     user_bias=t(got["params"]["user_bias"]),
                     offset=float(np.float32(data.global_mean)))
    ranker = CatalogRanker(data, 10, "cpu", torch.from_numpy(R.rated_bitmask(data)))
    want_ids, want_scores = ranker.topk(form)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(want_ids))
    np.testing.assert_array_equal(np.asarray(scores), np.asarray(want_scores))
    parsed = metrics.parse_measure(got["measure"])["Top 10"]
    ref = metrics.parse_measure(one["measure"])["Top 10"]
    for m in ("Precision", "Recall", "NDCG"):
        assert abs(parsed[m] - ref[m]) < 2e-2, (m, parsed, ref)
    assert [len(rank["SVD-ranked"]["files"]) for rank in ranks] == [2] + [0] * (world - 1)

