"""The social ranking slice of the PyTorch port (SBPR, TBPR and ESRF) and
its samplers against the JAX package, on the CPU: ``csr_member`` and the
row sampler by their properties, SBPR's negatives, the friend-item and
tie-item tables and ESRF's motif adjacency against the JAX package's,
SBPR's (both paths) and TBPR's loss and gradients at the JAX parameters and
three bold epochs on the JAX sampler's batches, ESRF's four losses and its
three phases on the JAX package's batches, segment starts and Gumbel
uniforms (``draw`` replaced), its ranking, and the bundled ``config/``
files on planted blocks.

Data: SBPR and TBPR take the implicit planted blocks of the JAX package's
tests/test_social_models.py (40 users, 2 blocks of 15 items, 3 trust links
inside a user's block), ESRF those of tests/test_adversarial_models.py (4
links, 20 reciprocated pairs) with a segment of 16 users, so that a segment
leaves users out. Tolerances: losses and gradients at the JAX parameters
within rtol 1e-5 and atol 1e-6 (ESRF's gradients, in the hundreds, within
1e-6 of their largest entry), both joint adjacencies ``DeviceCOO``s
(``graph.backend=coo``, f32 in both packages); after three epochs the
tables within 1e-4 and the losses within rtol 1e-3 (measured: SBPR and
TBPR 3e-8 on the tables and 1.4e-7 relative on the losses; ESRF 1.7e-6 on
the discriminator's tables, 1.7e-6 on U and V and 3.6e-7 relative on the
losses; its generator's tables part by up to 3.1e-2 after the adversarial
epoch, where the JAX package's own eager replay of that epoch parts from
its jitted run by 1.4e-2, so they are held after one step)."""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.social import SocialGraph as JSocialGraph
from qrec_tpu.data.split import data_split
from qrec_tpu.models import adversarial_social as jas
from qrec_tpu.models import social_ranking as jsr
from qrec_tpu.ops.topk import CatalogRanker as JRanker, embedding_score_fn
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.social import SocialGraph
from qrec_tpu_torch.models.adversarial_social import ESRF, gumbel_softmax
from qrec_tpu_torch.models.social_ranking import SBPR, TBPR
from qrec_tpu_torch.ops import metrics, sampling
from qrec_tpu_torch.ops.spmm import DeviceCOO
from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreForm
from qrec_tpu_torch.runtime import trainer as T

CONFIG = Path(__file__).resolve().parents[1] / "config"
F32 = dict(rtol=1e-5, atol=1e-6)
ARGS = {"SBPR": "", "TBPR": "-regT 0.01", "ESRF": "-K 5 -beta 0.1 -n_layer 2"}
T_MODELS = {"SBPR": SBPR, "TBPR": TBPR, "ESRF": ESRF}
J_MODELS = {"SBPR": jsr.SBPR, "TBPR": jsr.TBPR, "ESRF": jas.ESRF}
TF = {"evaluation.setup": "-ap 0.2 -tf"}
SEGMENT = 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rows(name):
    """(rating rows, trust rows) of the JAX package's social tests: the
    implicit data of tests/test_social_models.py for SBPR and TBPR, that of
    tests/test_adversarial_models.py for ESRF."""
    rng = np.random.RandomState(0)
    ratings = [[f"u{u}", f"i{i}", 1.0]
               for u in range(40) for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)]
    friends = 4 if name == "ESRF" else 3
    trust = [[f"u{u}", f"u{f}", 1.0] for u in range(40)
             for f in rng.choice(20, size=friends, replace=False) + (0 if u < 20 else 20) if f != u]
    if name == "ESRF":
        for u in range(0, 40, 2):
            trust += [[f"u{u}", f"u{u + 1}", 1.0], [f"u{u + 1}", f"u{u}", 1.0]]
    return ratings, trust


def _conf(name, extra=None):
    base = {
        "ratings": "unused", "ratings.setup": "-columns 0 1 2",
        "social": "unused", "social.setup": "-columns 0 1 2",
        "model.name": name, "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10",
        "num.factors": "8", "num.max.epoch": "3", "batch_size": "64",
        "learnRate": "-init 0.02 -max 1", "reg.lambda": "-u 0.01 -i 0.02 -b 0.1 -s 0.1",
        "graph.backend": "coo", "output.setup": "off -dir ./results/", "seed": "7",
    }
    if ARGS[name]:
        base[name] = ARGS[name]
    base.update(extra or {})
    return base


def _models(name, extra=None, loners=()):
    """(JAX model, port model) on the same split and relation; the users in
    ``loners`` follow nobody."""
    ratings, trust = _rows(name)
    trust = [r for r in trust if r[0] not in loners]
    train, test = data_split(ratings, 0.2, rng=random.Random(3))
    conf = _conf(name, extra)
    jd = JInteractions(jconfig.ModelConf(conf), train, test)
    td = Interactions(ModelConf(conf), train, test)
    jmodel = J_MODELS[name](jconfig.ModelConf(conf), jd, social=JSocialGraph(trust, jd))
    tmodel = T_MODELS[name](ModelConf(conf), td, device="cpu", social=SocialGraph(trust, td))
    return jmodel, tmodel


def _load(tmodel, params):
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu"))


def _csr_sets(m):
    return [set(m.indices[m.indptr[r]:m.indptr[r + 1]]) for r in range(m.shape[0])]


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------


def test_csr_member_and_row_sampler_by_their_properties():
    rng = np.random.RandomState(1)
    dense = rng.rand(30, 50) < 0.15
    dense[[2, 9, 29]] = False  # empty rows, the last one among them
    m = sp.csr_matrix(dense)
    indptr, indices = torch.from_numpy(m.indptr.astype(np.int64)), torch.from_numpy(m.indices.astype(np.int64))
    users = torch.arange(30).repeat_interleave(50)
    items = torch.arange(50).repeat(30)
    got = sampling.csr_member(indices, indptr, users, items, sampling._bisect_iters(50))
    np.testing.assert_array_equal(got.numpy(), dense.reshape(-1))
    # broadcast, as the rejection rounds call it
    got2 = sampling.csr_member(indices, indptr, torch.arange(30)[:, None], torch.arange(50)[None, :].expand(30, 50))
    np.testing.assert_array_equal(got2.numpy(), dense)
    gen = torch.Generator().manual_seed(0)
    users = torch.arange(30).repeat(200)
    item, has, idx = sampling.sample_from_rows(gen, indptr, indices, users)
    deg = np.diff(m.indptr)
    np.testing.assert_array_equal(has.numpy(), deg[users.numpy()] > 0)
    assert has.sum() > 0 and not has[users == 2].any()
    for u, i, h, k in zip(users.tolist(), item.tolist(), has.tolist(), idx.tolist()):
        if h:
            assert dense[u, i] and m.indices[k] == i
    # every item of a row comes up (uniform over the row)
    seen = {(u, i) for u, i, h in zip(users.tolist(), item.tolist(), has.tolist()) if h}
    assert seen == set(zip(*np.nonzero(dense)))
    # an empty table
    empty_ptr, empty = torch.zeros(31, dtype=torch.int64), torch.zeros(0, dtype=torch.int64)
    assert not sampling.csr_member(empty, empty_ptr, users, users).any()
    assert not sampling.sample_from_rows(gen, empty_ptr, empty, users)[1].any()


@pytest.mark.parametrize("extra", [None, TF], ids=["sbpr", "sbpr-tf"])
def test_sbpr_sampler_by_its_properties(extra):
    """A negative is never a positive, and a friend item only where the 8
    tries all failed and the exact draw, which avoids the positives alone
    (as the JAX package's), took its place: at most about sum_b rho_b^8
    times, rho_b the share of the catalog that user b's positives and
    friend items cover (3.2 of the 975 draws here; the JAX package's
    sampler, whose bisection reads scipy's unsorted friend-item rows, gave
    132). A middle item is a friend item with its count where the user has
    one, else (``-tf``) a random item with weight 0; ``-tf`` keeps the
    pairs in file order. Two users follow nobody."""
    _, tmodel = _models("SBPR", extra, loners=("u0", "u25"))
    tmodel.prepare_graph()
    fp = tmodel.friend_items()
    friends = _csr_sets(fp)
    rated = [set(tmodel.data.u_indices[tmodel.data.u_indptr[u]:tmodel.data.u_indptr[u + 1]])
             for u in range(tmodel.num_users)]
    gen = torch.Generator().manual_seed(5)
    n = tmodel.train_size
    friend_negatives, expected = 0, 0.0
    for _ in range(3):
        u, i, k, j, suk, has, w = (t.reshape(-1) for t in tmodel.sampler(gen))
        for b in range(n):
            uu, jj = int(u[b]), int(j[b])
            assert jj not in rated[uu]
            friend_negatives += jj in friends[uu]
            expected += (len(rated[uu] | friends[uu]) / tmodel.num_items) ** 8
            if has[b]:
                assert int(k[b]) in friends[uu] and suk[b] == fp[uu, int(k[b])]
            else:
                assert suk[b] == 0 and not friends[uu]
        assert w[:n].all() and not w[n:].any()
        if extra:
            np.testing.assert_array_equal(u[:n].numpy(), tmodel.data.train_u)
    assert friend_negatives <= 2 * expected
    assert has.any() and (~has[:n]).any()
    # the tries alone, where no query exhausts them: never a friend item
    users = torch.arange(tmodel.num_users).repeat(50)
    ta = tmodel.train_arrays
    neg = sampling.sample_negatives(gen, users, tmodel.num_items, ta["indices"], ta["indptr"],
                                    tmodel.rated_bitmask, 64, 8, tmodel._friend_item_member)
    assert not any(int(jj) in friends[int(uu)] | rated[int(uu)] for uu, jj in zip(users, neg))


def test_friend_items_and_tie_sets_equal_jax():
    jmodel, tmodel = _models("SBPR")
    assert (tmodel.friend_items() != jmodel._friend_items()).nnz == 0
    jmodel, tmodel = _models("TBPR")
    for a, b in zip(tmodel.tie_sets(), jmodel._tie_sets()):
        assert a.nnz > 0 and (a != b).nnz == 0
        np.testing.assert_array_equal(a.indptr, b.indptr)


# ---------------------------------------------------------------------------
# SBPR and TBPR against the JAX package
# ---------------------------------------------------------------------------

RANKERS = [("SBPR", None), ("SBPR", TF), ("TBPR", None)]


def _spec_and_port(name, extra):
    jmodel, tmodel = _models(name, extra)
    spec = jmodel.build()
    _load(tmodel, spec.params)
    tmodel.prepare_graph()
    return jmodel, spec, tmodel


@pytest.mark.parametrize("name,extra", RANKERS, ids=["sbpr", "sbpr-tf", "tbpr"])
def test_first_step_loss_and_gradients_match_jax(name, extra):
    _, spec, tmodel = _spec_and_port(name, extra)
    batch = tuple(np.asarray(a)[0] for a in spec.sampler(jax.random.PRNGKey(3)))
    jloss, jgrads = jax.value_and_grad(spec.loss_fn)(spec.params, batch, jax.random.PRNGKey(0))
    loss = tmodel.loss(T.as_device_batches(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **F32)
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[key]), **F32, err_msg=key)


def _jax_bold_epochs(jmodel, spec, epochs):
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


@pytest.mark.parametrize("name", ["SBPR", "TBPR"])
def test_three_bold_epochs_on_injected_batches_match_jax(name):
    jmodel, spec, tmodel = _spec_and_port(name, None)
    batches, jlosses, params = _jax_bold_epochs(jmodel, spec, 3)
    losses = tmodel.fit(epoch_batches=batches)
    assert len(losses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[key]), atol=1e-4,
                                   err_msg=key)
    assert isinstance(tmodel.score_form(), ScoreForm)


# ---------------------------------------------------------------------------
# ESRF against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def esrf_run():
    """The JAX package's ESRF fit (one epoch a phase, a segment of 16):
    its epoch runners' inputs and outputs, its loss functions and final
    factors, recorded by wrapping ``jax.jit`` and ``jax.value_and_grad``."""
    jmodel, _ = _models("ESRF")
    jmodel.segment = SEGMENT
    runs, fns = [], {}
    real_jit, real_vg = jax.jit, jax.value_and_grad

    def jit(fn, **kw):
        compiled = real_jit(fn, **kw)
        if getattr(fn, "__name__", "") != "run":
            return compiled

        def recorded(*args):
            out = compiled(*args)
            runs.append((args, out))
            return out

        return recorded

    def value_and_grad(fn, *a, **k):
        fns.setdefault(fn.__name__, fn)
        return real_vg(fn, *a, **k)

    jax.jit, jax.value_and_grad = jit, value_and_grad
    try:
        jmodel.fit()
    finally:
        jax.jit, jax.value_and_grad = real_jit, real_vg
    assert len(runs) == 3 and set(fns) == {"d_loss_fn", "g_loss_fn"}
    return jmodel, runs, fns


def _esrf_port(jmodel, runs):
    _, tmodel = _models("ESRF")
    tmodel.segment = SEGMENT
    d0, g0 = runs[0][0][:2]
    _load(tmodel, {"d": d0, "g": g0})
    tmodel.prepare_graph()
    return tmodel


def _esrf_draws(rng, model):
    """The segment start and Gumbel uniforms that the JAX package draws
    from a step key: ``fold_in(rng, 3)`` and ``fold_in(rng, 4)``."""
    nu = model.num_users
    start = jax.random.randint(jax.random.fold_in(rng, 3), (), 0, max(nu - SEGMENT, 1))
    u = jax.random.uniform(jax.random.fold_in(rng, 4), (SEGMENT, model.k_sel, nu))
    return torch.tensor(int(start)), torch.from_numpy(np.array(u))


def test_esrf_motif_adjacency_equals_jax(esrf_run):
    jmodel, runs, _ = esrf_run
    tmodel = _esrf_port(jmodel, runs)
    got, want = tmodel.motif_adjacency(), jmodel._motif_adjacency()
    for key in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.nnz > tmodel.social.trustSize()[1]
    assert isinstance(tmodel.motif, DeviceCOO) and isinstance(tmodel.joint_adj, DeviceCOO)


def test_gumbel_softmax_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 3, 9).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = jas.gumbel_softmax(key, jnp.asarray(logits), 0.2)
    u = np.array(jax.random.uniform(key, logits.shape))
    got = gumbel_softmax(torch.from_numpy(u), torch.from_numpy(logits), 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("mode", ["plain", "social", "adversarial", "generator"])
def test_esrf_losses_and_gradients_match_jax(esrf_run, mode):
    """The discriminator's loss in its three phases' forms and the
    generator's, at the JAX package's initial parameters on its first
    batch and step key."""
    jmodel, runs, fns = esrf_run
    tmodel = _esrf_port(jmodel, runs)
    d0, g0, _, _, batches, re = runs[0][0]
    batch = tuple(a[0] for a in batches)
    r = jax.random.split(re, batches[0].shape[0])[0]
    tbatch = T.as_device_batches(tuple(np.asarray(a) for a in batch), "cpu")
    if mode == "generator":
        want, grads = jax.value_and_grad(fns["g_loss_fn"])(g0, d0, batch, jax.random.fold_in(r, 9))
        loss = tmodel.g_loss(tbatch, _esrf_draws(jax.random.fold_in(r, 9), tmodel))
        params = tmodel.g
    else:
        social, adversarial = mode != "plain", mode == "adversarial"
        want, grads = jax.value_and_grad(fns["d_loss_fn"])(d0, g0, batch, r, social, adversarial)
        loss = tmodel.d_loss(tbatch, _esrf_draws(r, tmodel) if social else None, social, adversarial)
        params = tmodel.d
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **F32)
    for key, p in params.items():
        # the L2-normalized layers of the tiny initial tables give
        # gradients in the hundreds: f32 sums in another order part by
        # 1e-6 of the largest entry
        g = np.asarray(grads[key])
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(g).max()),
                                   err_msg=key)
    other = tmodel.d if mode == "generator" else tmodel.g
    assert all(p.grad is None for p in other.values())


def test_esrf_three_phases_on_injected_draws_match_jax(esrf_run, capsys):
    """One epoch of each phase on the JAX package's batches, segment starts
    and Gumbel uniforms: the losses, both players' tables, the final U and
    V and the ranking of them."""
    jmodel, runs, _ = esrf_run
    tmodel = _esrf_port(jmodel, runs)
    batches, draws = [], []
    for phase, (args, _) in enumerate(runs):
        b, re = args[4], args[5]
        batches.append(tuple(np.asarray(a) for a in b))
        for r in jax.random.split(re, b[0].shape[0]):
            if phase > 0:
                draws.append(_esrf_draws(r, tmodel))
            if phase == 2:
                draws.append(_esrf_draws(jax.random.fold_in(r, 9), tmodel))
    stream = iter(draws)
    tmodel.draw = lambda gen: next(stream)
    capsys.readouterr()
    losses = tmodel.fit(epoch_batches=batches)
    assert next(stream, None) is None  # one draw a social step, two an adversarial one
    np.testing.assert_allclose(losses, [float(out[4]) for _, out in runs], rtol=1e-3)
    assert [len(p) for p in tmodel.phase_losses] == [1, 1, 1]
    # the discriminator's tables; the generator's part after a few steps
    # (ROADMAP Queue 3: they do between the JAX package's own jitted and
    # eager runs of this epoch), so they are held after one step below
    for key, value in runs[-1][1][0].items():
        np.testing.assert_allclose(tmodel.d[key].detach().numpy(), np.asarray(value), atol=1e-4,
                                   err_msg=key)
    assert all(torch.isfinite(p).all() for p in tmodel.g.values())
    np.testing.assert_allclose(tmodel.U.numpy(), np.asarray(jmodel.U), atol=1e-4)
    np.testing.assert_allclose(tmodel.V.numpy(), np.asarray(jmodel.V), atol=1e-4)
    out = capsys.readouterr().out
    assert "adversarial training..." in out and "ESRF [1] phase 3: loss = " in out
    jids, _ = JRanker(jmodel.data, k=10).topk(embedding_score_fn, {"user_emb": jmodel.U,
                                                                    "item_emb": jmodel.V})
    ranker = CatalogRanker(tmodel.data, k=10, device="cpu", bitmask=tmodel.rated_bitmask)
    ids, _ = ranker.topk(ScoreForm(torch.from_numpy(np.array(jmodel.U)),
                                   torch.from_numpy(np.array(jmodel.V))))
    np.testing.assert_array_equal(ids, np.asarray(jids))


def test_esrf_first_generator_step_matches_jax(esrf_run):
    """The adversarial epoch's first generator step, a fresh Adam at 5·lr
    (as in both packages' fits), at the JAX package's tables after that
    step's discriminator update: the generator's tables within 1e-4 where
    the gradient is at least 1e-6. Adam's first step moves an entry by
    ``5·lr·g / (|g| + 1e-8)``, so where the saturated Gumbel softmax leaves
    |g| near 1e-8, the f32 cancellation error of g (about 1e-8) decides the
    step: those entries, a few, are held to Adam's step size alone."""
    jmodel, runs, fns = esrf_run
    d, g, d_state, _, batches, re = runs[2][0]
    r = jax.random.split(re, batches[0].shape[0])[0]
    batch = tuple(a[0] for a in batches)
    _, grads = jax.value_and_grad(fns["d_loss_fn"])(d, g, batch, r, True, True)
    updates, _ = optax.adam(jmodel.lrate).update(grads, d_state, d)
    d1 = optax.apply_updates(d, updates)
    g_opt = optax.adam(jmodel.lrate * 5)
    _, grads = jax.value_and_grad(fns["g_loss_fn"])(g, d1, batch, jax.random.fold_in(r, 9))
    updates, _ = g_opt.update(grads, g_opt.init(g), g)
    g1 = optax.apply_updates(g, updates)
    tmodel = _esrf_port(jmodel, runs)
    _load(tmodel, {"d": d1, "g": g})
    _, t_g_opt = tmodel.optimizers()
    tbatch = T.as_device_batches(tuple(np.asarray(a) for a in batch), "cpu")
    T.step(t_g_opt, tmodel.g_loss(tbatch, _esrf_draws(jax.random.fold_in(r, 9), tmodel)),
           list(tmodel.g.values()))
    step = jmodel.lrate * 5
    for key, value in g1.items():
        got, want = tmodel.g[key].detach().numpy(), np.asarray(value)
        steady = np.abs(np.asarray(grads[key])) >= 1e-6
        assert steady.mean() > 0.95, key
        np.testing.assert_allclose(got[steady], want[steady], atol=1e-4, err_msg=key)
        assert np.abs(got - want).max() <= 2 * step, key


# ---------------------------------------------------------------------------
# the bundled configs on planted blocks
# ---------------------------------------------------------------------------

# Recall@10 floors of tests/test_social_models.py:81-97 and
# tests/test_adversarial_models.py:181-189
FLOORS = {"SBPR": 0.5, "TBPR": 0.5, "ESRF": 0.45}


@pytest.mark.parametrize("name", ["SBPR", "TBPR", "ESRF"])
def test_bundled_config_learns_planted_blocks_on_cpu(tmp_path, name):
    """``config/<name>.conf`` with its model arguments at the JAX tests'
    small size (30 epochs at rate 0.05, batch 64), the result files
    written."""
    ratings, trust = _rows(name)
    rp, tp = tmp_path / "ratings.txt", tmp_path / "trust.txt"
    rp.write_text("".join(f"{u} {i} 1\n" for u, i, _ in ratings))
    tp.write_text("".join(f"{u} {v}\n" for u, v, _ in trust))
    conf = ModelConf(str(CONFIG / f"{name}.conf"))
    size = {"num.factors": "16" if name == "ESRF" else "8", "num.max.epoch": "30",
            "batch_size": "64", "learnRate": "-init 0.05 -max 1",
            "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1" if name == "ESRF"
            else "-u 0.01 -i 0.01 -b 0.1 -s 0.1"}
    for key, value in {"ratings": str(rp), "social": str(tp), **size,
                       "output.setup": f"on -dir {tmp_path / 'out'}/"}.items():
        conf[key] = value
    rec = QRec(conf, seed=3, device="cpu")
    parsed = metrics.parse_measure(rec.execute())["Top 10"]
    assert parsed["Recall"] > FLOORS[name], parsed
    assert len(list((tmp_path / "out").iterdir())) == 2
    assert rec.model.graph_seconds >= 0
