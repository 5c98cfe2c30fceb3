"""Slice 7f of the port on the CPU: NeuMF, DMF, CDAE, APR and ESRF trained
data-parallel, each data rank's loss its share of the step's.

* The shares, with no spawn: each model at the JAX package's initial
  parameters on one JAX batch (ESRF's with the JAX package's segment start
  and Gumbel uniforms), its ``mesh`` stubbed as data rank k of 2, 3 and 4:
  NeuMF's three losses, DMF's, CDAE's, APR's base and adversarial losses,
  ESRF's discriminator loss in the forms of its three phases and its
  generator's loss. The shares' losses sum to the one-process loss within
  rtol 1e-6, their gradients within 1e-6 of the largest entry: a term
  counted on every rank, or on none, fails here (CDAE's weights' L2 or
  NeuMF's ``h_mf`` term added on every rank, DMF's L2 on none, CDAE's mean
  taken over the share's count, ESRF's generator loss on the whole batch:
  each fails it). ESRF's run in float64, where f32 cancellation in its
  Gumbel softmax would part the sums by rounding alone. APR's
  perturbation on a share, taken with no collective, equals one
  process's rows bit for bit.
* Spawned gloo ranks (``test_torch_parallel_ranks.fits_and_runs``): four
  (data 2 x model 2) and three (data 3 x model 1, where the batches cut
  unevenly). NeuMF's three phases, APR's two, DMF and CDAE on the batches
  that the JAX sampler drew inside the JAX model's own ``fit``; ESRF one
  epoch a phase on the JAX package's batches, segment starts and Gumbel
  uniforms (``graph.backend=coo`` in both packages); each from the JAX
  package's initial parameters, in one process of the port and in the JAX
  package. The data ranks' first-step shares sum to one process's first
  loss within rtol 1e-5; the first step's gradients after the step's
  reduction within rtol 1e-5 and 1e-6 of the largest entry of one
  process's (a parameter that no rank reaches, the other tower's in
  NeuMF's GMF and MLP phases, keeps no gradient, as in one process); the
  losses within rtol 1e-3 and the tables within 1e-4 of one process's and
  the JAX package's (the drift bounds of ``tests/test_torch_deep.py``);
  ESRF's generator tables after its first step within 1e-4 of one
  process's where |g| >= 1e-6 (ROADMAP Queue 3 item 25: Adam's first step
  turns a gradient of f32 noise into a full step); each fit's collectives:
  one all-reduce a step of each player and one an epoch, nothing else (so
  APR's inner gradient and its step's one backward cross the step's one
  reduction and no other collective); every rank equal to rank 0 bit for
  bit. "ESRF-dense" trains ESRF on the dense joint adjacency
  (``graph.backend`` unset: route 6, K1 on item-column blocks, on the
  ranks; its plain twin on the whole table in one process), the generator's
  step backward through route 6 on every rank in the same order; held
  against one process at the bf16 bound of ``tests/test_torch_parallel.py``
  (first-step gradients rtol and atol 5e-3, tables 1e-4 at lr 0.001).
* A session on the ranks (``QRec(conf).execute()`` on a planted file): APR
  ranked through route 7 (K2 on each rank's share of the test users, the
  lists gathered), whose lists equal one process's ranking of the same
  factors bit for bit; the measures within 2e-2 of one process's session;
  rank 0 alone writes the result files."""

import random
import types

import jax
import numpy as np
import pytest
import torch

import test_torch_deep as TD
import test_torch_parallel_ranks as R
import test_torch_social_mf as TSM
import test_torch_social_ranking as TSR
from test_torch_parallel_models import _equal
from test_torch_social_ranking import esrf_run  # noqa: F401 (the JAX package's ESRF fit)
from qrec_tpu.data.split import data_split
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreForm
from qrec_tpu_torch.runtime import trainer as T

DEEP = ("NeuMF", "APR", "DMF", "CDAE")
LABELS = DEEP + ("ESRF", "ESRF-dense")
MESH = {4: "on -model 2", 3: "on"}
# ESRF on the dense joint adjacency (``graph.backend`` unset: auto), at lr
# 0.001 as the LightGCN family's dense forms in ``tests/test_torch_parallel.py``
DENSE_LR = "-init 0.001 -max 1"
BF16 = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # module-scoped: the module's runs sum on one thread, as the ranks do
    torch.set_num_threads(1)


def _tree(params) -> dict:
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_fit(jmodel):
    """The JAX model's ``fit`` with its phases captured
    (``tests/test_torch_deep.captured_fit``): its epoch batches, the loss
    of every epoch and the parameters that its last phase returned."""
    finals = []
    real = jmodel.run_training

    def run_training(*a, **k):
        finals.append(real(*a, **k))
        return finals[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "run_training", run_training)
        _, batches, losses = TD.captured_fit(jmodel, mp)
    return batches, losses, _tree(finals[-1])


def _deep_case(name):
    """NeuMF, APR, DMF or CDAE: the port's fit case (conf, split, the JAX
    initial parameters and the JAX sampler's batches) and the JAX package's
    run (losses, final tables)."""
    jmodel, _ = TD.both(name)
    if name == "NeuMF":
        init = jmodel._init_params()
    elif name == "APR":
        init = jmodel.init_embeddings("normal")
    else:
        init = jmodel.build().params
    batches, losses, tables = _jax_fit(jmodel)
    train, test = TD._records()
    case = {"conf": TD._conf(name), "train": train, "test": test, "params": _tree(init),
            "batches": batches}
    return case, {"losses": losses, "tables": tables}


def _esrf_draws(jmodel, runs):
    """The segment starts and Gumbel uniforms of the JAX package's ESRF fit,
    in the order the port draws them: one a social step, two an
    adversarial one (``tests/test_torch_social_ranking.py``)."""
    shape = types.SimpleNamespace(num_users=jmodel.num_users, k_sel=jmodel.k_sel)
    draws = []
    for phase, (args, _) in enumerate(runs):
        for r in jax.random.split(args[5], args[4][0].shape[0]):
            if phase > 0:
                draws.append(TSR._esrf_draws(r, shape))
            if phase == 2:
                draws.append(TSR._esrf_draws(jax.random.fold_in(r, 9), shape))
    return R.as_numpy(draws)


def _esrf_cases(esrf_run):
    """ESRF on the whole ``DeviceCOO`` (``coo``) and on the dense joint
    adjacency, from the JAX package's initial tables, batches and draws;
    the JAX package's run (coo) beside the first."""
    jmodel, runs, _ = esrf_run
    ratings, trust = TSR._rows("ESRF")
    train, test = data_split(ratings, 0.2, rng=random.Random(3))
    conf = TSR._conf("ESRF")
    dense = {k: v for k, v in conf.items() if k != "graph.backend"}
    dense["learnRate"] = DENSE_LR
    d0, g0 = runs[0][0][:2]
    case = {"conf": conf, "train": train, "test": test, "relation": trust,
            "params": _tree({"d": d0, "g": g0}),
            "batches": [tuple(np.asarray(a) for a in args[4]) for args, _ in runs],
            "draws": _esrf_draws(jmodel, runs), "attrs": {"segment": TSR.SEGMENT}}
    tables = {f"d.{k}": np.asarray(v) for k, v in runs[-1][1][0].items()}
    jax_run = {"losses": [float(out[4]) for _, out in runs], "tables": tables,
               "U": np.asarray(jmodel.U), "V": np.asarray(jmodel.V)}
    return {"ESRF": (case, jax_run), "ESRF-dense": (dict(case, conf=dense), None)}


@pytest.fixture(scope="module")
def problems(esrf_run):
    """Each label's case and the JAX package's run of it (None for
    ESRF-dense, which is held against one process)."""
    out = {name: _deep_case(name) for name in DEEP}
    out.update(_esrf_cases(esrf_run))
    return {label: case for label, (case, _) in out.items()}, {
        label: run for label, (_, run) in out.items()}


def _session_conf(tmp):
    """APR ranked at top-10 on the planted file of
    ``tests/test_torch_social_mf.py`` (40 users, two blocks of 15 items)."""
    ratings, _ = TSM._files(tmp)
    return TD._conf("APR", {"ratings": ratings, "item.ranking": "on -topN 10",
                            "learnRate": "-init 0.05 -max 1", "num.max.epoch": "4"})


@pytest.fixture(scope="module")
def trained(problems, tmp_path_factory):
    """One process of the port, four ranks and three ranks: the fits, then
    APR's session (one process's in this process)."""
    cases = problems[0]
    one = {label: R.fit_case(case) for label, case in cases.items()}
    tmp = tmp_path_factory.mktemp("deep_sessions")
    conf = _session_conf(tmp)
    one_session = R.replicated_run(dict(conf, **{"output.setup": f"on -dir {tmp}/one/"}))
    ranks = {}
    for world, setup in MESH.items():
        on_mesh = {label: dict(case, conf=dict(case["conf"], **{"parallel.setup": setup}))
                   for label, case in cases.items()}
        runs = {"APR-ranked": (dict(conf, **{"parallel.setup": setup,
                                             "out_dir": str(tmp / f"ranks{world}")}), None)}
        ranks[world] = R.spawn(R.fits_and_runs, world, tmp_path_factory.mktemp(f"deep{world}"),
                               on_mesh, runs)
    return one, one_session, ranks, conf


# ---------------------------------------------------------------------------
# (a) the shares sum to the whole loss: a stubbed mesh, no spawn
# ---------------------------------------------------------------------------


def _deep_model(name):
    """The port's model of ``name`` at the JAX package's initial parameters,
    and the first batch of the JAX sampler's first epoch."""
    jmodel, tmodel = TD.both(name)
    if name == "NeuMF":
        params, sampler = jmodel._init_params(), jmodel.pointwise_sampler()
    elif name == "APR":
        params, sampler = jmodel.init_embeddings("normal"), jmodel.pairwise_sampler()
    else:
        spec = jmodel.build()
        params, sampler = spec.params, spec.sampler
    TD.load(tmodel, params)
    batch = tuple(np.asarray(a)[0] for a in sampler(jax.random.PRNGKey(3)))
    return tmodel, T.as_device_batches(batch, "cpu")


def _deep_loss(name, loss):
    """The port's model of ``name`` and ``loss`` on :func:`_deep_model`'s
    batch."""
    tmodel, tbatch = _deep_model(name)
    fn = getattr(tmodel, loss)
    return tmodel, lambda: fn(tbatch)


def _esrf_loss(esrf_run, mode):
    """The port's ESRF at the JAX package's initial tables, and its loss in
    ``mode`` on the JAX package's first batch and step key, in float64 (its
    tables, operators, batch weights and uniforms cast): the generator's
    gradient goes through a Gumbel softmax at temperature 0.2, whose f32
    cancellation parts the shares' sum from the whole by 2.4e-6 of the
    largest entry, rounding and not a term, which float64 leaves out."""
    jmodel, runs, _ = esrf_run
    tmodel = TSR._esrf_port(jmodel, runs).double()
    for name in ("motif", "_joint_adj"):
        op = getattr(tmodel, name)
        setattr(tmodel, name, op._replace(vals=op.vals.double()))
    batches, re = runs[0][0][4:6]
    r = jax.random.split(re, batches[0].shape[0])[0]
    tbatch = T.as_device_batches(tuple(np.asarray(a)[0] for a in batches), "cpu")
    tbatch = tbatch[:3] + (tbatch[3].double(),)
    if mode == "plain":
        return tmodel, lambda: tmodel.d_loss(tbatch, None, False, False)
    key = jax.random.fold_in(r, 9) if mode == "generator" else r
    start, uniforms = TSR._esrf_draws(key, tmodel)
    draws = start, uniforms.double()
    if mode == "generator":
        return tmodel, lambda: tmodel.g_loss(tbatch, draws)
    return tmodel, lambda: tmodel.d_loss(tbatch, draws, True, mode == "adversarial")


LOSSES = {"NeuMF-mf": ("NeuMF", "loss_mf"), "NeuMF-mlp": ("NeuMF", "loss_mlp"),
          "NeuMF-neu": ("NeuMF", "loss_neu"), "DMF": ("DMF", "loss"), "CDAE": ("CDAE", "loss"),
          "APR-base": ("APR", "base_loss"), "APR-adv": ("APR", "adv_loss"),
          **{f"ESRF-{mode}": ("ESRF", mode)
             for mode in ("plain", "social", "adversarial", "generator")}}
SHARES = [(label, parts) for label in LOSSES for parts in (2, 3, 4)]


def _loss_and_grads(model, loss_fn):
    params = list(model.parameters())
    loss = loss_fn()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


@pytest.mark.parametrize("label,parts", SHARES, ids=[f"{l}-{p}" for l, p in SHARES])
def test_shares_sum_to_the_one_process_loss(esrf_run, label, parts):
    """Data rank k of ``parts`` (the mesh stubbed) computes its share of the
    step's loss: the shares' losses sum to the whole loss within rtol 1e-6
    and their gradients within 1e-6 of the largest entry; the data ranks'
    shares differ (each sums only its rows)."""
    name, loss = LOSSES[label]
    model, loss_fn = _esrf_loss(esrf_run, loss) if name == "ESRF" else _deep_loss(name, loss)
    model._mesh = None
    whole, whole_grads = _loss_and_grads(model, loss_fn)
    losses, sums = [], [torch.zeros_like(g, dtype=torch.float64) for g in whole_grads]
    for k in range(parts):
        model._mesh = types.SimpleNamespace(data=parts, data_index=k, model=1, model_index=0)
        share, grads = _loss_and_grads(model, loss_fn)
        losses.append(share)
        for s, g in zip(sums, grads):
            s += g.double()
    np.testing.assert_allclose(sum(losses), whole, rtol=1e-6)
    assert len(set(losses)) > 1
    for (key, _), s, w in zip(model.named_parameters(), sums, whole_grads):
        np.testing.assert_allclose(s.numpy(), w.double().numpy(), rtol=0,
                                   atol=1e-6 * w.abs().max().item(), err_msg=key)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_apr_share_perturbs_its_rows_as_one_process(parts):
    """APR's perturbation on data rank k of ``parts``, taken from the
    share's loss with no collective, equals one process's for the same
    rows bit for bit: the softplus loss sums over rows, so a row's Δ
    depends on that row alone."""
    model, batch = _deep_model("APR")

    def deltas():
        pu, qi, qj, w = model._rows(batch)
        return model.perturbations(model.softplus_bpr(pu, qi, qj, w), (pu, qi, qj))

    model._mesh = None
    whole = deltas()
    for k in range(parts):
        model._mesh = types.SimpleNamespace(data=parts, data_index=k, model=1, model_index=0)
        for got, want in zip(deltas(), whole):
            assert torch.equal(got, torch.tensor_split(want, parts)[k])
            assert got.abs().max() > 0


# ---------------------------------------------------------------------------
# (b) the fits on spawned gloo ranks
# ---------------------------------------------------------------------------

WORLD_FITS = [(world, label) for world in MESH for label in LABELS]
IDS = [f"{label}-{world}ranks" for world, label in WORLD_FITS]


def _model_axis(world):
    return 2 if world == 4 else 1


@pytest.mark.parametrize("world,label", WORLD_FITS, ids=IDS)
def test_deep_models_train_on_the_mesh_as_one_process_and_jax(problems, trained, world, label):
    """The phases on the JAX sampler's batches (and ESRF's draws): the data
    ranks' shares of the first step's loss sum to one process's, the losses
    and tables stay within the drift bounds of one process and the JAX
    package (ESRF: its discriminator's tables and final factors; the
    generator's part after a few steps in both packages, Queue 3 item 25)."""
    jax_run, one, ranks = problems[1][label], trained[0][label], trained[2][world]
    got = ranks[0]["fits"][label]
    model = _model_axis(world)
    assert got["mesh"] == {"data": world // model, "model": model} and one["mesh"] is None
    if label.startswith("ESRF"):
        assert (got["adj"], one["adj"]) == (("ShardedDenseJoint", "DenseJoint")
                                             if label == "ESRF-dense" else
                                             ("DeviceCOO", "DeviceCOO"))
    first = sum(r["fits"][label]["first_loss"] for r in ranks[::model])
    np.testing.assert_allclose(first, one["first_loss"], rtol=1e-5)
    assert len({r["fits"][label]["first_loss"] for r in ranks[::model]}) == world // model
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-3)
    tables = got["params"] if not label.startswith("ESRF") else {
        k: v for k, v in got["params"].items() if k.startswith("d.")}
    for key, value in tables.items():
        np.testing.assert_allclose(value, one["params"][key], atol=1e-4, err_msg=key)
    for key in ("U", "V"):  # NeuMF and CDAE keep no final factors
        assert (got[key] is None) == (one[key] is None)
        if one[key] is not None:
            np.testing.assert_allclose(got[key], one[key], atol=1e-4)
    if jax_run is None:
        return
    np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=1e-3)
    want = jax_run["tables"] if label == "ESRF" else params_from_jax(jax_run["tables"], "cpu")
    assert set(want) <= set(got["params"])
    for key, value in want.items():
        value = np.asarray(value)
        if label == "DMF":
            # one process already parts from the JAX package by up to 6.4e-3
            # here (ROADMAP Queue 3 item 58): the mesh adds at most 1e-4
            gap = np.abs(got["params"][key] - value) - np.abs(one["params"][key] - value)
            assert gap.max() <= 1e-4, (key, gap.max())
            continue
        np.testing.assert_allclose(got["params"][key], value, atol=1e-4, err_msg=key)
    if label == "ESRF":
        np.testing.assert_allclose(got["U"], jax_run["U"], atol=1e-4)
        np.testing.assert_allclose(got["V"], jax_run["V"], atol=1e-4)


@pytest.mark.parametrize("world,label", WORLD_FITS, ids=IDS)
def test_deep_first_step_gradients_match_one_process(trained, world, label):
    """The gradient invariant: after the step's reduction over ``data``,
    every parameter's gradient on every rank is one process's within rtol
    1e-5 and 1e-6 of its largest entry (ESRF-dense at the bf16 bound), and
    a parameter that one process's step leaves without a gradient has none
    on any rank."""
    one, ranks = trained[0][label], trained[2][world]
    for rank in ranks:
        grads = rank["fits"][label]["grads"]
        assert sorted(grads) == sorted(one["grads"])
        for key, ref in one["grads"].items():
            if ref is None:
                assert grads[key] is None, key
                continue
            bound = BF16 if label == "ESRF-dense" else dict(rtol=1e-5,
                                                            atol=1e-6 * np.abs(ref).max())
            np.testing.assert_allclose(grads[key], ref, **bound, err_msg=key)
    if label == "NeuMF":  # the GMF phase reaches neither the MLP tower nor h_mlp
        assert {k for k, g in one["grads"].items() if g is None} == {
            "PM", "QM", "W1", "b1", "W2", "b2", "W3", "b3", "h_mlp"}


@pytest.mark.parametrize("world", list(MESH))
def test_esrf_generator_first_step_matches_one_process(trained, world):
    """The adversarial phase's first generator step (each player's
    gradients summed over ``data``): the generator's tables after it
    within 1e-4 of one process's where one process's gradient is at least
    1e-6, and within two of Adam's steps (5·lr) elsewhere."""
    one = trained[0]["ESRF"]["first_steps"]
    assert len(one) == 2  # the discriminator's Adam, then the generator's
    step = 5 * 0.02
    for rank in trained[2][world]:
        got = rank["fits"]["ESRF"]["first_steps"][1]
        for key in ("g.relation_emb", "g.selector"):
            steady = np.abs(one[1]["grads"][key]) >= 1e-6
            assert steady.mean() > 0.95, key
            np.testing.assert_allclose(got["after"][key][steady], one[1]["after"][key][steady],
                                       atol=1e-4, err_msg=key)
            assert np.abs(got["after"][key] - one[1]["after"][key]).max() <= 2 * step, key


@pytest.mark.parametrize("world", list(MESH))
def test_each_step_crosses_one_reduction_and_nothing_else(problems, trained, world):
    """The collectives of each fit on the route-free paths: one all-reduce
    of the gradients a step (two in ESRF's adversarial steps, one a
    player) and one of the epoch's total an epoch, no gather, broadcast or
    barrier; none in one process."""
    cases = problems[0]
    for label in ("NeuMF", "APR", "DMF", "CDAE", "ESRF"):
        steps = [b[0].shape[0] for b in cases[label]["batches"]]
        reductions = sum(steps) + len(steps) + (steps[-1] if label == "ESRF" else 0)
        assert trained[0][label]["collectives"] == dict.fromkeys(R.COLLECTIVES, 0)
        for rank in trained[2][world]:
            assert rank["fits"][label]["collectives"] == dict(
                dict.fromkeys(R.COLLECTIVES, 0), all_reduce=reductions), label


# ---------------------------------------------------------------------------
# (c) the ranks agree bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", list(MESH))
def test_deep_ranks_stay_equal_bit_for_bit(trained, world):
    """Every rank's losses, tables, final factors, first-step gradients and
    each optimizer's first step of each fit, and the measures, tables and
    rankings of APR's session, equal rank 0's bit for bit."""
    ranks = trained[2][world]
    for r, rank in enumerate(ranks[1:], 1):
        for label in LABELS:
            for key in ("losses", "params", "U", "V", "grads", "first_steps"):
                _equal(rank["fits"][label][key], ranks[0]["fits"][label][key],
                       f"rank {r} {label} {key}")
        for key in ("measure", "params", "U", "V", "losses", "ranked"):
            _equal(rank["APR-ranked"][key], ranks[0]["APR-ranked"][key], f"rank {r} APR {key}")


# ---------------------------------------------------------------------------
# (d) APR ranked through route 7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", list(MESH))
def test_apr_ranked_through_route_7_gives_one_process_lists(trained, world):
    """APR's session: each rank ranks its ``tensor_split`` share of the test
    users through K2 (one call a rank, its plain twin here) and the
    gathered lists equal one process's ranking of the same factors bit for
    bit; the measures within 2e-2 of the one-process session; rank 0 alone
    writes the result files."""
    ranks, one, conf = trained[2][world], trained[1], trained[3]
    got = ranks[0]["APR-ranked"]
    assert got["mesh"] == {"data": world // _model_axis(world), "model": _model_axis(world)}
    rec = QRec(ModelConf(conf), seed=3, device="cpu")  # the session's split
    data = Interactions(ModelConf(conf), rec.training_data, rec.test_data, seed=3)
    n = len(data.test_set_u)
    calls = [len(call) for rank in ranks for call in rank["APR-ranked"]["k2_calls"]]
    assert calls == [len(c) for c in np.array_split(np.arange(n), world)]
    (ids, scores), = got["ranked"]
    ranker = CatalogRanker(data, 10, "cpu", torch.from_numpy(R.rated_bitmask(data)))
    want_ids, want_scores = ranker.topk(ScoreForm(torch.from_numpy(got["U"]),
                                                  torch.from_numpy(got["V"])))
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(want_ids))
    np.testing.assert_array_equal(np.asarray(scores), np.asarray(want_scores))
    parsed = metrics.parse_measure(got["measure"])["Top 10"]
    ref = metrics.parse_measure(one["measure"])["Top 10"]
    for m in ("Precision", "Recall", "NDCG"):
        assert abs(parsed[m] - ref[m]) < 2e-2, (m, parsed, ref)
    assert [len(rank["APR-ranked"]["files"]) for rank in ranks] == [2] + [0] * (world - 1)
