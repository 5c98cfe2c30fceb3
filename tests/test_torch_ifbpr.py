"""IF_BPR and RSGAN of the PyTorch port against the JAX package, on the CPU:
the relation nets, the meta-path walks (with and without a negative
channel, from one ``RandomState``) and the three tier tables bit for bit;
``friend_lists``' walks, pairs, ids, thresholds and mean similarities on
injected embeddings; IF_BPR's first-step loss, gradients and threshold
sums at the JAX parameters and three epochs on the JAX batches, the
threshold update included; RSGAN's seeded profile, its pretraining and its
first epoch with the JAX package's Gumbel uniforms injected (``draw``
replaced); and the bundled configs on planted blocks.

Both packages' SGNS runs are replaced here by the same injected
embeddings (a seeded normal table per call, in call order), so the friend
lists of the two packages are computed from equal inputs; SGNS itself is
held against the JAX package in tests/test_torch_walks.py.

Data: the planted blocks, trust links and ``ratings_n.txt`` of the JAX
package's tests/test_adversarial_models.py (40 users, 2 blocks of 15 items,
4 links inside a user's block, 20 reciprocated pairs; the negative file
holds 3 items of the other block per user). Tolerances: losses at the JAX
parameters within rtol 1e-5 and atol 1e-6, gradients within 1e-6 of their
largest entry (measured: IF_BPR's loss equal, its gradients 4.5e-8;
RSGAN's losses 5.9e-7 relative, its gradients 2.8e-9 of the largest); the
friend similarities, thresholds and mean similarities within 1e-6
(measured 1.8e-7, 6e-8 and 9e-8); after three IF_BPR epochs the tables
within 1e-4, the losses within rtol 1e-3 and the thresholds and mean
similarities within 1e-5 (measured 2.4e-6, 2.2e-7 relative, 3e-8 and 0);
RSGAN's pretraining losses within rtol 1e-4 (measured 3.1e-5: the
cross-entropy reads log(out) at outputs near its 1e-6 clip) and its
generator's tables after it within 1e-4 (measured 1.5e-6); after one GAN
epoch the discriminator's tables within 1e-4 and the loss within rtol 1e-3
(measured 1.1e-6 and equal). The generator's tables part by up to 2.4e-2
after that epoch, where Gumbel softmaxes at temperature 0.1 saturate and
Adam moves entries whose gradients are f32 rounding (as ESRF's in
tests/test_torch_social_ranking.py), so the generator is held by its first
step's loss and gradients.
"""

import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.social import SocialGraph as JSocialGraph
from qrec_tpu.data.split import data_split
from qrec_tpu.models import adversarial_social as jas
from qrec_tpu.models import ifbpr as jifbpr
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.social import SocialGraph
from qrec_tpu_torch.models import ifbpr
from qrec_tpu_torch.models.adversarial_social import RSGAN
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops.topk import ScoreForm
from qrec_tpu_torch.runtime import trainer as T

CONFIG = Path(__file__).resolve().parents[1] / "config"
F32 = dict(rtol=1e-5, atol=1e-6)
ARGS = "-L 20 -l 16 -w 5 -k 10 -a 0.1 -ep 10 -neg 3 -r 0.2"
VARIANTS = ["no-negative", "negative"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rows(with_negative):
    """(ratings, negative feedback, trust) rows of
    tests/test_adversarial_models.py's ``_write_dataset``."""
    rng = np.random.RandomState(0)
    ratings = [[f"u{u}", f"i{i}", 1.0]
               for u in range(40) for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)]
    negative = []
    if with_negative:
        negative = [(f"u{u}", f"i{i}") for u in range(40)
                    for i in rng.choice(15, size=3, replace=False) + (15 if u < 20 else 0)]
    trust = [[f"u{u}", f"u{f}", 1.0] for u in range(40)
             for f in rng.choice(20, size=4, replace=False) + (0 if u < 20 else 20) if f != u]
    for u in range(0, 40, 2):
        trust += [[f"u{u}", f"u{u + 1}", 1.0], [f"u{u + 1}", f"u{u}", 1.0]]
    return ratings, negative, trust


def _write(tmp, with_negative):
    """The rating file (and ``ratings_n.txt`` beside it); returns its path
    and the rows."""
    ratings, negative, trust = _rows(with_negative)
    path = tmp / "ratings.txt"
    path.write_text("".join(f"{u} {i} 1\n" for u, i, _ in ratings))
    if with_negative:
        (tmp / "ratings_n.txt").write_text("".join(f"{u} {i} 1\n" for u, i in negative))
    return path, ratings, trust


def _conf(name, path, extra=None):
    base = {
        "ratings": str(path), "ratings.setup": "-columns 0 1 2",
        "social": "unused", "social.setup": "-columns 0 1 2",
        "model.name": name, "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10",
        "num.factors": "8", "num.max.epoch": "3", "batch_size": "64",
        "learnRate": "-init 0.02 -max 1", "reg.lambda": "-u 0.01 -i 0.02 -b 0.1 -s 0.1",
        "output.setup": "off -dir ./results/", "seed": "7", "IF_BPR": ARGS,
    }
    base.update(extra or {})
    return base


def _models(name, tmp, with_negative, extra=None):
    """(JAX model, port model) on the same split, relation and rating file
    path (for ``_n.txt``)."""
    path, ratings, trust = _write(tmp, with_negative)
    train, test = data_split(ratings, 0.2, rng=random.Random(3))
    conf = _conf(name, path, extra)
    jd = JInteractions(jconfig.ModelConf(conf), train, test)
    td = Interactions(ModelConf(conf), train, test)
    jcls = jifbpr.IF_BPR if name == "IF_BPR" else jas.RSGAN
    tcls = ifbpr.IF_BPR if name == "IF_BPR" else RSGAN
    return (jcls(jconfig.ModelConf(conf), jd, social=JSocialGraph(trust, jd)),
            tcls(ModelConf(conf), td, device="cpu", social=SocialGraph(trust, td)))


class FakeSkipgram:
    """A stand-in for ``train_skipgram`` in both packages: call n returns
    the same seeded normal (num_nodes, dim) table, and each call's pairs
    and active nodes are kept."""

    def __init__(self, as_torch):
        self.as_torch = as_torch
        self.calls = []

    def __call__(self, centers, contexts, num_nodes, dim, active, **kw):
        self.calls.append((np.array(centers), np.array(contexts), np.array(active), num_nodes, dim))
        emb = np.random.RandomState(100 + len(self.calls)).randn(num_nodes, dim).astype(np.float32)
        return torch.from_numpy(emb) if self.as_torch else jax.numpy.asarray(emb)


def _patch(mp):
    """Both packages' SGNS replaced by the same tables, the JAX package's
    walks in numpy; returns (JAX fake, port fake)."""
    jfake, tfake = FakeSkipgram(False), FakeSkipgram(True)
    mp.setattr("qrec_tpu.native.random_walks_native", lambda *a: None)
    mp.setattr(jifbpr, "train_skipgram", jfake)
    mp.setattr(ifbpr, "train_skipgram", tfake)
    return jfake, tfake


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _record_fit(jmodel):
    """The JAX model's fit with its friend lists, its jitted functions of
    the model's own loop and their calls' inputs and outputs, recorded by
    wrapping ``IF_BPR._friend_lists`` and ``jax.jit``."""
    fns, calls, friends = {}, {}, []
    real_jit, real_friends = jax.jit, jifbpr.IF_BPR._friend_lists

    def jit(fn, **kw):
        compiled = real_jit(fn, **kw)
        name = getattr(fn, "__name__", "")
        # the model's own loop: IF_BPR's and RSGAN's six-argument epochs,
        # not the skip-gram's
        if name not in ("sampler", "g_pre_step") and not (name == "run_epoch"
                                                          and fn.__code__.co_argcount == 6):
            return compiled
        fns[name] = fn

        def recorded(*args):
            out = compiled(*args)
            calls.setdefault(name, []).append((args, out))
            return out

        return recorded

    def friend_lists(self):
        friends.append(real_friends(self))
        return friends[-1]

    jax.jit, jifbpr.IF_BPR._friend_lists = jit, friend_lists
    try:
        jmodel.fit()
    finally:
        jax.jit, jifbpr.IF_BPR._friend_lists = real_jit, real_friends
    return friends[0], fns, calls


@pytest.fixture(scope="module", params=VARIANTS)
def ifbpr_run(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    with_negative = request.param == "negative"
    jmodel, _ = _models("IF_BPR", tmp, with_negative)
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp)
        friends, fns, calls = _record_fit(jmodel)
    assert len(calls["run_epoch"]) == 3 and (friends[2] is not None) == with_negative
    return tmp, with_negative, jmodel, friends, fns, calls


def _port(run):
    """The port's IF_BPR with the JAX package's friend lists."""
    tmp, with_negative, _, friends, _, _ = run
    _, tmodel = _models("IF_BPR", tmp, with_negative)
    tmodel.implicit_friends = lambda: ifbpr.FriendLists(*friends, stats={})
    tmodel.prepare_graph()
    return tmodel


# ---------------------------------------------------------------------------
# the host pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_relation_nets_and_meta_path_walks_equal_jax(tmp_path, variant):
    """UF and UT, then the walks of the positive channel and of the
    negative one, which goes on from the same ``RandomState``."""
    jmodel, tmodel = _models("IF_BPR", tmp_path, variant == "negative")
    uf, ut = ifbpr.relation_nets(tmodel.data, tmodel.social)
    juf, jut = jmodel._relation_nets()
    for got, want in ((uf, juf), (ut, jut)):
        assert got.nnz > 0
        for key in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    neg = ifbpr.read_negative_feedback(tmodel.config["ratings"], tmodel.data)
    jneg = jmodel._read_negative_feedback()
    for a, b in zip(neg, jneg):
        np.testing.assert_array_equal(a, b)
    assert (len(neg[0]) > 0) == (variant == "negative")
    nu, ni = tmodel.num_users, tmodel.num_items
    r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
    channels = [(tmodel.data.train_u, tmodel.data.train_i)] + ([neg] if len(neg[0]) else [])
    for users, items in channels:
        ui, iu = ifbpr.interaction_csrs(users, items, nu, ni)
        jui, jiu = jmodel._interaction_csrs(users, items)
        assert (ui != jui).nnz == 0 and (iu != jiu).nnz == 0
        got, kept = ifbpr.meta_path_walks(ui, iu, uf, ut, r1, nu, tmodel.walk_length)
        want = jmodel._meta_path_walks(jui, jiu, juf, jut, r2)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and sum(n for _, n in kept) == len(got)
        assert [mp for mp, _ in kept] == [mp for mp, _ in ifbpr.META_PATHS]
    assert r1.randint(0, 2**31) == r2.randint(0, 2**31)


@pytest.mark.parametrize("variant", VARIANTS)
def test_friend_lists_match_jax_on_injected_embeddings(monkeypatch, tmp_path, variant):
    """Each channel's walks, pairs and active nodes bit for bit, then the
    friend ids, similarities, thresholds and mean similarities from the
    same embeddings."""
    jfake, tfake = _patch(monkeypatch)
    jmodel, tmodel = _models("IF_BPR", tmp_path, variant == "negative")
    want = jmodel._friend_lists()
    got = tmodel.implicit_friends()
    assert len(tfake.calls) == len(jfake.calls) == (2 if variant == "negative" else 1)
    for a, b in zip(tfake.calls, jfake.calls):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3:] == b[3:] == (tmodel.num_users + tmodel.num_items, tmodel.walk_dim)
    np.testing.assert_array_equal(got.p_ids, want[0])
    np.testing.assert_allclose(got.p_sims, want[1], rtol=0, atol=1e-6)
    if variant == "negative":
        np.testing.assert_array_equal(got.n_ids, want[2])
    else:
        assert got.n_ids is None and want[2] is None
    np.testing.assert_allclose(got.threshold, want[3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.avg_sim, want[4], rtol=0, atol=1e-6)
    assert got.p_ids.shape == (tmodel.num_users, tmodel.top_k)
    stats = got.stats
    assert stats["pairs"] == [len(c[0]) for c in tfake.calls] and len(stats["walkers"]) == len(tfake.calls)


def test_tier_tables_and_pull_edges_equal_jax(ifbpr_run):
    """The joint, positive-only and negative tiers (an empty tier the JAX
    package's dummy entry), the joint tier's strongest similarity and the
    true-friend pull edges."""
    _, with_negative, _, _, fns, _ = ifbpr_run
    tmodel = _port(ifbpr_run)
    joint, ps, neg, simmax, true_mask = tmodel.tier_tables(tmodel.friends)
    sampler = _closure(fns["sampler"])
    tables = _closure(sampler["sample_tier"])["tables"]
    for name, got in (("joint", joint), ("ps", ps), ("neg", neg)):
        indptr, indices, data = (np.asarray(a) for a in tables[name])
        np.testing.assert_array_equal(got.indptr, indptr)
        if got.nnz:
            np.testing.assert_array_equal(got.indices, indices)
            np.testing.assert_array_equal(got.data, data)
        else:
            assert list(indices) == [0] and list(data) == [0.0]
    assert joint.nnz > 0 and (neg.nnz > 0) == with_negative and (ps.nnz > 0) == with_negative
    np.testing.assert_array_equal(simmax, np.asarray(sampler["joint_simmax_d"]))
    loss_fn = _closure(_closure(fns["run_epoch"])["loss_fn"])
    for got, key in ((tmodel.pull_src, "pull_src_d"), (tmodel.pull_dst, "pull_dst_d"),
                     (tmodel.pull_sim, "pull_sim_d"), (tmodel.pull_true, "pull_true_d")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(loss_fn[key]), err_msg=key)


def test_initial_tables_equal_jax(ifbpr_run):
    _, _, _, _, _, calls = ifbpr_run
    params = calls["run_epoch"][0][0][0]
    tmodel = _port(ifbpr_run)
    for key in ("user_emb", "item_emb"):
        np.testing.assert_array_equal(getattr(tmodel, key).detach().numpy(), np.asarray(params[key]))


# ---------------------------------------------------------------------------
# IF_BPR's loss and epochs
# ---------------------------------------------------------------------------


def test_first_step_loss_gradients_and_sums_match_jax(ifbpr_run):
    _, _, _, _, fns, calls = ifbpr_run
    params, _, thr, avg, batches, rng = calls["run_epoch"][0][0]
    batch = tuple(a[0] for a in batches)
    loss_fn = _closure(fns["run_epoch"])["loss_fn"]
    (want, (acc, cnt)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, (thr, avg), batch, rng)
    tmodel = _port(ifbpr_run)
    tbatch = T.as_device_batches(tuple(np.asarray(a) for a in batch), "cpu")
    loss, (t_acc, t_cnt) = tmodel.step_loss(tbatch, torch.from_numpy(np.array(thr)),
                                            torch.from_numpy(np.array(avg)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **F32)
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads[key]), **F32, err_msg=key)
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(cnt))
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(acc), **F32)
    assert t_cnt.sum() > 0


def test_three_epochs_on_injected_batches_match_jax(ifbpr_run, capsys):
    """Three epochs on the JAX package's batches, both packages from the
    JAX tables with the user table perturbed: each epoch's loss and
    threshold update, the final tables, the epoch line and the ranker's
    score form. At the constant 0.1 user table some gradient entries
    cancel to f32 rounding (|g| near 1e-10, 0 a step earlier), and Adam's
    step ``lr·g / (|g| + 1e-8)`` then moves them by an amount that rounding
    decides (2e-4 apart after one epoch); the perturbation (σ = 0.01) keeps
    every gradient clear of that."""
    _, _, _, _, fns, calls = ifbpr_run
    runs = calls["run_epoch"]
    params, _, thr, avg, _, _ = runs[0][0]
    rng = np.random.RandomState(9)
    params = dict(params, user_emb=params["user_emb"] + 0.01 * rng.randn(*params["user_emb"].shape).astype(np.float32))
    epoch = jax.jit(fns["run_epoch"])
    state = _closure(fns["run_epoch"])["optimizer"].init(params)
    outs, p = [], params
    for args, _ in runs:
        p, state, thr, avg, loss = epoch(p, state, thr, avg, args[4], args[5])
        outs.append((p, thr, avg, float(loss)))
    tmodel = _port(ifbpr_run)
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu"))
    capsys.readouterr()
    losses = tmodel.fit(epoch_batches=[tuple(np.asarray(a) for a in args[4]) for args, _ in runs])
    np.testing.assert_allclose(losses, [o[3] for o in outs], rtol=1e-3)
    for (thr, avg), (_, jthr, javg, _) in zip(tmodel.thresholds, outs):
        np.testing.assert_allclose(thr.numpy(), np.asarray(jthr), rtol=0, atol=1e-5)
        np.testing.assert_allclose(avg.numpy(), np.asarray(javg), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(outs[-1][1]) - np.asarray(runs[0][0][2])).max() > 0  # they moved
    for key, value in outs[-1][0].items():
        np.testing.assert_allclose(getattr(tmodel, key).detach().numpy(), np.asarray(value), atol=1e-4,
                                   err_msg=key)
    assert "IF_BPR [1] epoch 3: loss = " in capsys.readouterr().out
    assert isinstance(tmodel.score_form(), ScoreForm) and len(tmodel.timer.times) == 3


def test_user_sums_equal_index_add():
    """The stable sort and segment sums against ``index_add_`` on the CPU
    (the same order there), users absent from the batch 0."""
    rng = np.random.RandomState(4)
    u = torch.from_numpy(rng.randint(0, 9, 50))
    vals = torch.from_numpy(rng.randn(50, 2).astype(np.float32))
    got = ifbpr.user_sums(u, vals, torch.arange(12))
    want = torch.zeros(11, 2).index_add_(0, u, vals)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.shape == (11, 2) and not got[9:].any()


# ---------------------------------------------------------------------------
# RSGAN
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rsgan_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rsgan")
    jmodel, _ = _models("RSGAN", tmp, True, {"num.max.epoch": "1"})
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp)
        friends, fns, calls = _record_fit(jmodel)
    assert len(calls["g_pre_step"]) == 30 and len(calls["run_epoch"]) == 1
    return tmp, jmodel, friends, fns, calls


def _rsgan_port(run, pretrained=False):
    """The port's RSGAN at the JAX package's initial tables (or those after
    its pretraining) with its seeded profile."""
    tmp, _, _, fns, calls = run
    _, tmodel = _models("RSGAN", tmp, True, {"num.max.epoch": "1"})
    g = calls["g_pre_step"][-1][1][0] if pretrained else calls["g_pre_step"][0][0][0]
    d = calls["run_epoch"][0][0][0]
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, {"g": g, "d": d}), "cpu"))
    profile = np.asarray(_closure(fns["g_pre_step"])["profiles"])
    tmodel.seeded_friends = lambda: profile
    tmodel.prepare_graph()
    return tmodel


def _gumbel_uniforms(rng, model):
    """A step's two uniform blocks as the JAX package draws them from a
    key: ``split(rng)`` into the (B, U) and (B, I) draws."""
    r1, r2 = jax.random.split(rng)
    b = model.batch_size
    return (torch.from_numpy(np.array(jax.random.uniform(r1, (b, model.num_users)))),
            torch.from_numpy(np.array(jax.random.uniform(r2, (b, model.num_items)))))


def test_rsgan_seeded_profile_equals_jax(monkeypatch, rsgan_run):
    """The first 30 positive friends and the positive friends that are
    also negative ones, from the same injected embeddings; the candidate
    matrix a ``DeviceCOO`` of the (I, U) ratings."""
    from qrec_tpu_torch.ops.spmm import DeviceCOO

    tmp, _, _, fns, _ = rsgan_run
    _patch(monkeypatch)
    _, tmodel = _models("RSGAN", tmp, True)
    got = tmodel.seeded_friends()
    want = np.asarray(_closure(fns["g_pre_step"])["profiles"])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and (got.sum(1) >= 30).all()
    assert len(tmodel.walk_stats["sgns"]) == 2
    tmodel.prepare_graph()
    assert isinstance(tmodel.iu, DeviceCOO) and tmodel.iu.num_rows == tmodel.num_items


def test_rsgan_pretraining_matches_jax(rsgan_run):
    _, _, _, _, calls = rsgan_run
    tmodel = _rsgan_port(rsgan_run)
    g_opt, _ = tmodel.optimizers()
    losses = tmodel.pretrain(g_opt)
    np.testing.assert_allclose(losses, [float(out[2]) for _, out in calls["g_pre_step"]], rtol=1e-4)
    for key, value in calls["g_pre_step"][-1][1][0].items():
        np.testing.assert_allclose(tmodel.g[key].detach().numpy(), np.asarray(value), atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("player", ["generator", "discriminator"])
def test_rsgan_step_losses_and_gradients_match_jax(rsgan_run, player):
    """The first step's generator loss at the pretrained tables, then the
    discriminator's on the generator the JAX package's step left, each with
    its own JAX uniforms (the discriminator's from ``fold_in(r, 1)``)."""
    _, _, _, fns, calls = rsgan_run
    d, g, d_state, g_state, batches, re = calls["run_epoch"][0][0]
    epoch = _closure(fns["run_epoch"])
    r = jax.random.split(re, batches[0].shape[0])[0]
    batch = tuple(a[0] for a in batches)
    tmodel = _rsgan_port(rsgan_run, pretrained=True)
    tbatch = T.as_device_batches(tuple(np.asarray(a) for a in batch), "cpu")
    if player == "generator":
        want, grads = jax.value_and_grad(epoch["g_loss_fn"])(g, d, batch, r)
        loss = tmodel.g_loss(tbatch, _gumbel_uniforms(r, tmodel))
        params = tmodel.g
    else:
        _, ggrads = jax.value_and_grad(epoch["g_loss_fn"])(g, d, batch, r)
        updates, _ = epoch["g_opt"].update(ggrads, g_state, g)
        g1 = jax.tree_util.tree_map(lambda p, u: p + u, g, updates)
        want, grads = jax.value_and_grad(epoch["d_loss_fn"])(d, g1, batch, jax.random.fold_in(r, 1))
        tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, {"g": g1, "d": d}), "cpu"))
        loss = tmodel.d_loss(tbatch, _gumbel_uniforms(jax.random.fold_in(r, 1), tmodel))
        params = tmodel.d
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **F32)
    for key, p in params.items():
        g_ = np.asarray(grads[key])
        np.testing.assert_allclose(p.grad.numpy(), g_, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(g_).max()),
                                   err_msg=key)
    other = tmodel.d if player == "generator" else tmodel.g
    assert all(p.grad is None for p in other.values())


def test_rsgan_fit_on_injected_draws_matches_jax(rsgan_run, capsys):
    """The port's whole fit from the JAX package's initial tables and
    profile: its 30 pretraining steps, then one GAN epoch on the JAX
    batches and Gumbel uniforms (two draws a step, the generator's first)."""
    _, jmodel, _, _, calls = rsgan_run
    (d, g, _, _, batches, re), out = calls["run_epoch"][0]
    tmodel = _rsgan_port(rsgan_run)
    draws = []
    for r in jax.random.split(re, batches[0].shape[0]):
        draws += [_gumbel_uniforms(r, tmodel), _gumbel_uniforms(jax.random.fold_in(r, 1), tmodel)]
    stream = iter(draws)
    tmodel.draw = lambda gen: next(stream)
    capsys.readouterr()
    losses = tmodel.fit(epoch_batches=[tuple(np.asarray(a) for a in batches)])
    assert next(stream, None) is None
    np.testing.assert_allclose(losses, [float(out[4])], rtol=1e-3)
    np.testing.assert_allclose(tmodel.pretrain_losses,
                               [float(o[2]) for _, o in calls["g_pre_step"]], rtol=1e-4)
    for key, value in out[0].items():
        np.testing.assert_allclose(tmodel.d[key].detach().numpy(), np.asarray(value), atol=1e-4, err_msg=key)
    np.testing.assert_allclose(tmodel.U.numpy(), np.asarray(jmodel.U), atol=1e-4)
    text = capsys.readouterr().out
    assert "pretraining for generator..." in text and "RSGAN [1] epoch 1: D_loss = " in text


# ---------------------------------------------------------------------------
# the bundled configs on planted blocks
# ---------------------------------------------------------------------------

# Recall@10 floors of tests/test_adversarial_models.py:157-201
PLANTED = [("IF_BPR", False, 0.45), ("IF_BPR", True, 0.45), ("RSGAN", True, 0.35)]


@pytest.mark.parametrize("name,with_negative,floor", PLANTED, ids=["if_bpr", "if_bpr-negative", "rsgan"])
def test_bundled_config_learns_planted_blocks_on_cpu(tmp_path, name, with_negative, floor):
    """``config/<name>.conf`` at the JAX tests' small size (d=16, 30
    epochs at rate 0.02, batch 64), the result files written."""
    path, _, trust = _write(tmp_path, with_negative)
    tp = tmp_path / "trust.txt"
    tp.write_text("".join(f"{u} {v} 1\n" for u, v, _ in trust))
    conf = ModelConf(str(CONFIG / f"{name}.conf"))
    for key, value in {"ratings": str(path), "social": str(tp), "social.setup": "-columns 0 1 2",
                       "evaluation.setup": "-ap 0.2", "num.factors": "16", "num.max.epoch": "30",
                       "batch_size": "64", "learnRate": "-init 0.02 -max 1",
                       "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1", "seed": "7",
                       "output.setup": f"on -dir {tmp_path / 'out'}/"}.items():
        conf[key] = value
    if name == "IF_BPR":
        conf["IF_BPR"] = ARGS
    rec = QRec(conf, seed=3, device="cpu")
    parsed = metrics.parse_measure(rec.execute())["Top 10"]
    assert parsed["Recall"] > floor, parsed
    assert len(list((tmp_path / "out").iterdir())) == 2
    assert (rec.model.walk_stats["pairs"][-1] > 0) and len(rec.model.walk_stats["pairs"]) == 1 + with_negative
