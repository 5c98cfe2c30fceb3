"""Quality at the lastfm shape: SimGCL, SGL and NGCF trained for two epochs
by the JAX package and by the port, both on the CPU, on the synthetic
lastfm-shaped file that ``chip_smoke.py`` trains on (1,892 users x 17,632
items x 92,834 interactions, ``-ap 0.2 -b 1``, the published confs at full
width). The port is fed the JAX sampler's batches and the JAX loss's draws
(noise, view bits, dropout masks), so the two runs see the same data; each
package then ranks the full catalog with its own ranker and metrics.

The walk family (CUNE_BPR, IF_BPR and RSGAN at the lastfm shape with
``chip_smoke.lastfm_trust``, CUNE_MF's MAE/RMSE at the FilmTrust shape)
trains three epochs in both packages the same way: the port is handed the
JAX model's friends (or seeded profile and initial tables), batches and
Gumbel draws.

Marked ``slow`` (about 30 minutes on the CPU, RSGAN 22 of them): the
tier-1 run leaves it out. Run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_quality.py -m slow -s -q
"""

import os
import random
import time

import jax
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.split import data_split
from qrec_tpu.models.graph import NGCF as JNGCF, SGL as JSGL, SimGCL as JSimGCL
from qrec_tpu.ops.topk import embedding_score_fn
from qrec_tpu.runtime import evaluator as jevaluator
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.convert import embedding_params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.models.graph import NGCF, SGL, SimGCL
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.runtime import evaluator

from test_torch_sparse import _draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_MODELS = {"SimGCL": JSimGCL, "SGL": JSGL, "NGCF": JNGCF}
T_MODELS = {"SimGCL": SimGCL, "SGL": SGL, "NGCF": NGCF}
EPOCHS = 2


def _conf(name):
    """The published conf at full width, two epochs, no result files; the
    JAX package on the factored dense adjacency, as the port runs it."""
    published = ModelConf(os.path.join(REPO, "config", f"{name}.conf"))
    conf = {key: published[key] for key in published}
    conf.update({
        "num.max.epoch": str(EPOCHS), "output.setup": "off -dir ./results/",
        "graph.dense.quant": "factored",
    })
    return conf


def _split():
    """``chip_smoke.lastfm_records`` as ``QRec`` reads and splits it: ids as
    strings, ``-b 1`` (every rating 1 is kept), ``-ap 0.2`` with the
    session's default seed 0."""
    rows, cols, _, _ = chip_smoke.lastfm_records()
    records = [[str(u), str(i), 1.0] for u, i in zip(rows, cols)]
    return data_split(records, 0.2, binarized=True, rng=random.Random(0))


def _jax_run(name, jmodel, spec, tmodel):
    """Two epochs of the JAX package's training loop (its own rng stream,
    best-epoch vote and restore). Returns the per-epoch losses, the best
    epoch (None without a vote), each epoch's batches and the port's draws
    of every step."""
    optimizer = optax.adam(jmodel.lrate)
    run_epoch = jtrainer.make_epoch_runner(spec.loss_fn, optimizer)
    params, opt_state = spec.params, optimizer.init(spec.params)
    consts = () if spec.consts is None else (spec.consts,)
    tracker = jtrainer.BestTracker() if spec.track_best else None
    rng = jax.random.PRNGKey(jmodel.seed + 1)
    losses, batches, draws = [], [], []
    for epoch in range(EPOCHS):
        rng, rs, rt = jax.random.split(rng, 3)
        b = spec.sampler(rs)
        batches.append(tuple(np.asarray(a) for a in b))
        draws += [_draws(tmodel, r) for r in jax.random.split(rt, b[0].shape[0])]
        params, opt_state, loss = run_epoch(params, opt_state, b, rt, *consts)
        losses.append(float(loss))
        if tracker is not None:
            scored = spec.score_params_fn(params, *consts)
            got = jtrainer.quick_eval_metrics(jmodel._quick_ranker(), embedding_score_fn, scored,
                                              jmodel._top_n)
            if tracker.update(epoch, got):
                tracker.best_params = params
    if tracker is not None:
        params = tracker.best_params
    jmodel.finalize(params, spec)
    return losses, None if tracker is None else tracker.best_epoch, batches, draws


# Per-epoch losses within 1e-3 relative: the training drift that ROADMAP.md
# records (f32 summation order can flip a bf16 rounding of the next layer's
# input from the second step on). The measures: the two packages' tables
# part by that drift, which can move a near-tied item across the edge of a
# user's top 10. One hit gained or lost moves Recall@10 and NDCG@10 (means
# over the 1,892 test users of values in [0, 1]) by at most 1/1892; ATOL
# allows that one hit, where a fault in the port (the measures of a model
# that did not learn) would show as a factor, not a hit.
LOSS_RTOL = 1e-3
ATOL = 1 / 1892


@pytest.mark.slow
@pytest.mark.parametrize("name", ["SimGCL", "SGL", "NGCF"])
def test_lastfm_quality_matches_jax(name):
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    conf = _conf(name)
    train, test = _split()
    jconf, tconf = jconfig.ModelConf(conf), ModelConf(conf)
    jd, td = JInteractions(jconf, train, test), Interactions(tconf, train, test)
    jmodel = J_MODELS[name](jconf, jd)
    spec = jmodel.build()
    tmodel = T_MODELS[name](tconf, td, device="cpu")
    tmodel.load_state_dict(embedding_params_from_jax(
        {k: np.asarray(v) for k, v in spec.params.items()}, "cpu"))

    jlosses, jbest, batches, draws = _jax_run(name, jmodel, spec, tmodel)
    want = metrics.parse_measure(jevaluator.eval_ranking(jmodel, jd, jconf))["Top 10"]
    t_jax = time.perf_counter() - t0

    stream = iter(draws)
    tmodel.draw = lambda gen: next(stream)
    losses = tmodel.fit(epoch_batches=batches)
    assert next(stream, None) is None  # one draw per step
    got = metrics.parse_measure(evaluator.eval_ranking(tmodel, td, tconf))["Top 10"]
    t_port = time.perf_counter() - t0 - t_jax

    best = None if tmodel.tracker is None else tmodel.tracker.best_epoch
    print(f"\n[quality {name}] users={tmodel.num_users} items={tmodel.num_items} "
          f"test_users={len(td.test_set_u)} steps/epoch={batches[0][0].shape[0]}")
    print(f"[quality {name}] losses jax={jlosses} port={losses}")
    print(f"[quality {name}] best epoch jax={jbest} port={best}")
    for key in ("Recall", "NDCG", "Precision"):
        print(f"[quality {name}] {key}@10 jax={want[key]} port={got[key]}")
    print(f"[quality {name}] seconds jax={t_jax:.1f} port={t_port:.1f}")

    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert best == jbest
    for key in ("Recall", "NDCG"):
        assert abs(got[key] - want[key]) <= ATOL, (key, got[key], want[key])


# ---------------------------------------------------------------------------
# the walk family (CUNE_BPR, IF_BPR and RSGAN at the lastfm shape, CUNE_MF's
# MAE/RMSE at the FilmTrust shape), three epochs each
# ---------------------------------------------------------------------------

WALK_EPOCHS = 3


def _walk_conf(name):
    published = ModelConf(os.path.join(REPO, "config", f"{name}.conf"))
    conf = {key: published[key] for key in published}
    conf.update({"num.max.epoch": str(WALK_EPOCHS), "output.setup": "off -dir ./results/"})
    return conf


def _filmtrust_split():
    """``chip_smoke.filmtrust_records`` as ``QRec`` reads it (float32
    ratings through the tokenizer) and splits it with ``-ap 0.2``."""
    users, items, ratings = chip_smoke.filmtrust_records()
    records = [[str(u), str(i), float(np.float32(r))] for u, i, r in zip(users, items, ratings)]
    return data_split(records, 0.2, rng=random.Random(0))


def _trust():
    return [[str(a), str(b), 1.0] for a, b in chip_smoke.lastfm_trust()]


def _measures(name, jmodel, jd, jconf, tmodel, td, tconf):
    if jconf.options("item.ranking").isMainOn():
        want = metrics.parse_measure(jevaluator.eval_ranking(jmodel, jd, jconf))["Top 10"]
        got = metrics.parse_measure(evaluator.eval_ranking(tmodel, td, tconf))["Top 10"]
        keys = ("Recall", "NDCG", "Precision")
    else:
        want = metrics.parse_measure(jevaluator.eval_ratings(jmodel, jd, jconf))["global"]
        got = metrics.parse_measure(evaluator.eval_ratings(tmodel, td, tconf))["global"]
        keys = ("MAE", "RMSE")
    for key in keys:
        print(f"[quality {name}] {key} jax={want[key]} port={got[key]}")
    return want, got


@pytest.mark.slow
@pytest.mark.parametrize("name", ["CUNE_BPR", "CUNE_MF"])
def test_cune_quality_matches_jax(name):
    """The JAX model's friends (its C++ walks and SGNS) handed to the port,
    three bold epochs on the JAX sampler's batches; each package then
    ranks (CUNE_BPR, Recall@10/NDCG@10 within one hit) or predicts the
    test ratings (CUNE_MF, MAE/RMSE within 1e-4 relative)."""
    from qrec_tpu.models import walk as jwalk
    from qrec_tpu_torch.convert import params_from_jax
    from qrec_tpu_torch.models import walk as twalk
    from test_torch_walks import _jax_bold_epochs

    torch.set_num_threads(4)
    conf = _walk_conf(name)
    train, test = _split() if name == "CUNE_BPR" else _filmtrust_split()
    jconf, tconf = jconfig.ModelConf(conf), ModelConf(conf)
    jd, td = JInteractions(jconf, train, test), Interactions(tconf, train, test)
    jmodel = getattr(jwalk, name)(jconf, jd)
    friends = []
    real = jmodel.implicit_friends
    jmodel.implicit_friends = lambda: friends.append(real()) or friends[0]
    spec = jmodel.build()
    tmodel = getattr(twalk, name)(tconf, td, device="cpu")
    tmodel.implicit_friends = lambda: friends[0]
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, spec.params), "cpu"))
    batches, jlosses, params = _jax_bold_epochs(jmodel, spec, WALK_EPOCHS)
    jmodel.finalize(params, spec)
    losses = tmodel.fit(epoch_batches=batches)
    print(f"\n[quality {name}] users={tmodel.num_users} items={tmodel.num_items} "
          f"friends={friends[0][0].shape} losses jax={jlosses} port={losses}")
    want, got = _measures(name, jmodel, jd, jconf, tmodel, td, tconf)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    if name == "CUNE_BPR":
        for key in ("Recall", "NDCG"):
            assert abs(got[key] - want[key]) <= ATOL, (key, got[key], want[key])
    else:
        for key in ("MAE", "RMSE"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


def _record_rsgan_fit(jmodel):
    """The JAX RSGAN's fit, keeping only what the port needs: the first
    pretraining step's generator and the first epoch's discriminator
    tables, each epoch's batches, key and loss, and the pretraining step's
    function (its ``profiles`` closure). Recording every call's tables, as
    tests/test_torch_ifbpr.py does at its small size, would hold some 20
    GB of (U, I) item-selection tables and Adam moments here."""
    rec = {"g0": None, "d0": None, "epochs": [], "pre_losses": [], "fns": {}}
    real_jit = jax.jit
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731

    def jit(fn, **kw):
        compiled = real_jit(fn, **kw)
        name = getattr(fn, "__name__", "")
        if name == "g_pre_step":
            rec["fns"][name] = fn

            def pre_step(*args):
                rec["g0"] = host(args[0]) if rec["g0"] is None else rec["g0"]
                out = compiled(*args)
                rec["pre_losses"].append(float(out[2]))
                return out

            return pre_step
        if name == "run_epoch" and fn.__code__.co_argcount == 6:
            def epoch(*args):
                rec["d0"] = host(args[0]) if rec["d0"] is None else rec["d0"]
                out = compiled(*args)
                rec["epochs"].append((tuple(np.asarray(a) for a in args[4]), args[5], float(out[4])))
                return out

            return epoch
        return compiled

    jax.jit = jit
    try:
        jmodel.fit()
    finally:
        jax.jit = real_jit
    return rec


def _recorded_social_fit(name):
    """The JAX model's fit at the lastfm shape with ``chip_smoke``'s trust
    file, recorded (IF_BPR: its friend lists and own loop, as
    tests/test_torch_ifbpr.py records them; RSGAN: ``_record_rsgan_fit``),
    and the port's model on the same split and relation."""
    from qrec_tpu.data.social import SocialGraph as JSocialGraph
    from qrec_tpu.models import adversarial_social as jas
    from qrec_tpu.models import ifbpr as jifbpr
    from qrec_tpu_torch.data.social import SocialGraph
    from qrec_tpu_torch.models import ifbpr
    from qrec_tpu_torch.models.adversarial_social import RSGAN
    from test_torch_ifbpr import _record_fit

    conf = _walk_conf(name)
    conf["social"] = "unused"
    train, test = _split()
    trust = _trust()
    jconf, tconf = jconfig.ModelConf(conf), ModelConf(conf)
    jd, td = JInteractions(jconf, train, test), Interactions(tconf, train, test)
    jcls, tcls = (jifbpr.IF_BPR, ifbpr.IF_BPR) if name == "IF_BPR" else (jas.RSGAN, RSGAN)
    jmodel = jcls(jconf, jd, social=JSocialGraph(trust, jd))
    recorded = _record_fit(jmodel) if name == "IF_BPR" else _record_rsgan_fit(jmodel)
    tmodel = tcls(tconf, td, device="cpu", social=SocialGraph(trust, td))
    return jmodel, jd, jconf, tmodel, td, tconf, recorded


@pytest.mark.slow
def test_if_bpr_quality_matches_jax():
    """The JAX fit's friend lists handed to the port, which trains from
    its own initial tables (the JAX package's draws) on the JAX batches."""
    from qrec_tpu_torch.models import ifbpr

    torch.set_num_threads(4)
    jmodel, jd, jconf, tmodel, td, tconf, (friends, _, calls) = _recorded_social_fit("IF_BPR")
    tmodel.implicit_friends = lambda: ifbpr.FriendLists(*friends, stats={})
    losses = tmodel.fit(epoch_batches=[tuple(np.asarray(a) for a in args[4])
                                       for args, _ in calls["run_epoch"]])
    jlosses = [float(out[4]) for _, out in calls["run_epoch"]]
    print(f"\n[quality IF_BPR] losses jax={jlosses} port={losses}")
    want, got = _measures("IF_BPR", jmodel, jd, jconf, tmodel, td, tconf)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    for key in ("Recall", "NDCG"):
        assert abs(got[key] - want[key]) <= ATOL, (key, got[key], want[key])


@pytest.mark.slow
def test_rsgan_quality_matches_jax():
    """The port from the JAX package's initial tables and seeded profile,
    its pretraining, then three GAN epochs on the JAX batches and Gumbel
    uniforms (made a step at a time: a step's two blocks are 2000 x
    (U + I) floats)."""
    from qrec_tpu_torch.convert import params_from_jax
    from test_torch_ifbpr import _closure, _gumbel_uniforms

    torch.set_num_threads(4)
    jmodel, jd, jconf, tmodel, td, tconf, rec = _recorded_social_fit("RSGAN")
    tmodel.load_state_dict(params_from_jax({"g": rec["g0"], "d": rec["d0"]}, "cpu"))
    profile = np.asarray(_closure(rec["fns"]["g_pre_step"])["profiles"])
    tmodel.seeded_friends = lambda: profile

    def uniforms():
        for batches, re, _ in rec["epochs"]:
            for r in jax.random.split(re, batches[0].shape[0]):
                yield _gumbel_uniforms(r, tmodel)
                yield _gumbel_uniforms(jax.random.fold_in(r, 1), tmodel)

    stream = uniforms()
    tmodel.draw = lambda gen: next(stream)
    losses = tmodel.fit(epoch_batches=[batches for batches, _, _ in rec["epochs"]])
    assert next(stream, None) is None
    jlosses = [loss for _, _, loss in rec["epochs"]]
    print(f"\n[quality RSGAN] pretraining losses jax={rec['pre_losses'][::10]} "
          f"port={[float(x) for x in tmodel.pretrain_losses[::10]]}")
    print(f"[quality RSGAN] losses jax={jlosses} port={losses}")
    want, got = _measures("RSGAN", jmodel, jd, jconf, tmodel, td, tconf)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    for key in ("Recall", "NDCG"):
        assert abs(got[key] - want[key]) <= ATOL, (key, got[key], want[key])
