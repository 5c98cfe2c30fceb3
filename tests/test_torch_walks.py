"""The walk slice of the PyTorch port (``ops/walks`` and CUNE_MF, CUNE_BPR)
against the JAX package, on the CPU: the co-rating network and the walk
pairs bit for bit; the port's default walks (its host library's walker)
bit for bit against the JAX package's default (its C++ walker), and the
plain numpy walks (``random_walks_numpy``) bit for bit with the JAX
package's C++ walker patched out (``random_walks_native`` returning None,
as where its library does not build), both by their properties too; SGNS with the JAX
package's draws injected (``SkipgramDraws`` replaced); the friend top-k
against the JAX package's on embeddings that tie at the k-th neighbour;
the CUNE models' friend lists and friend-item table, their first step and
three bold epochs on the JAX sampler's batches, and both bundled configs
on planted blocks.

Data: the planted blocks of the JAX package's tests/test_walk_models.py
(40 users, 2 blocks of 15 items, 10 ratings a user). Tolerances: losses and
gradients at the JAX parameters within rtol 1e-5 and atol 1e-6; after
three epochs the tables within 1e-4 and the losses within rtol 1e-3
(measured: 6e-8 on both models' tables, 1.1e-7 and 9e-8 relative on the
losses); the SGNS tables within 5e-5 after 3 epochs of 26 Adam steps
(measured 8.3e-6: Adam's first steps move by about the rate whatever the
gradient's size, so f32 rounding in the gradients grows into the tables);
the friend top-k's similarities within 1e-6 (measured 1.2e-7), its ids
equal.
"""

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
from qrec_tpu.data.split import data_split
from qrec_tpu.models import walk as jwalk
from qrec_tpu.ops import walks as jw
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.models.walk import CUNE_BPR, CUNE_MF
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops import walks as W
from qrec_tpu_torch.ops.topk import ScoreForm
from qrec_tpu_torch.runtime.profiling import StepTimer
from qrec_tpu_torch.runtime import trainer as T

CONFIG = Path(__file__).resolve().parents[1] / "config"
F32 = dict(rtol=1e-5, atol=1e-6)
ARGS = {"CUNE_MF": ("CUNE-MF", "-T 10 -L 5 -l 10 -w 5 -k 5 -a 0.1 -ep 10"),
        "CUNE_BPR": ("CUNE-BPR", "-T 10 -L 10 -l 16 -w 5 -k 10 -s 2 -ep 10")}
T_MODELS = {"CUNE_MF": CUNE_MF, "CUNE_BPR": CUNE_BPR}
J_MODELS = {"CUNE_MF": jwalk.CUNE_MF, "CUNE_BPR": jwalk.CUNE_BPR}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def numpy_walks(monkeypatch):
    """Both packages walk in numpy: the JAX package as where its C++
    library does not build, the port's models through the plain walker."""
    monkeypatch.setattr("qrec_tpu.native.random_walks_native", lambda *a: None)
    monkeypatch.setattr("qrec_tpu_torch.models.walk.random_walks", W.random_walks_numpy)


class JaxDraws(W.SkipgramDraws):
    """The JAX package's SGNS draws: ``PRNGKey(seed)`` split into the
    initial table's key and, unchanged, the loop key; each epoch splits the
    loop key, permutes with the new key and draws the negatives from its
    ``fold_in(·, 1)``."""

    def __init__(self, seed, device):
        self.rng = jax.random.PRNGKey(seed)
        self.k1 = jax.random.split(self.rng)[0]

    def initial_table(self, num_nodes, dim):
        table = jax.random.uniform(self.k1, (num_nodes, dim), minval=-0.5, maxval=0.5) / dim
        return torch.from_numpy(np.array(table))

    def epoch(self, n, num_batches, batch_size, negatives, num_active):
        self.rng, sub = jax.random.split(self.rng)
        perm = jax.random.permutation(sub, n)
        neg = jax.random.randint(jax.random.fold_in(sub, 1), (num_batches, batch_size, negatives),
                                 0, num_active)
        return torch.from_numpy(np.array(perm)).long(), torch.from_numpy(np.array(neg)).long()


def _records(explicit=False):
    rng = np.random.RandomState(0)
    return [[f"u{u}", f"i{i}", float(rng.randint(3, 6)) if explicit else 1.0]
            for u in range(40) for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)]


def _conf(name):
    key, args = ARGS[name]
    return {
        "ratings": "unused", "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2", "item.ranking": "off -topN 10" if name == "CUNE_MF" else "on -topN 10",
        "num.factors": "8", "num.max.epoch": "3", "batch_size": "64",
        "learnRate": "-init 0.02 -max 1", "reg.lambda": "-u 0.01 -i 0.02 -b 0.1 -s 0.1",
        "output.setup": "off -dir ./results/", "seed": "7", key: args,
    }


def _models(name):
    train, test = data_split(_records(name == "CUNE_MF"), 0.2, rng=random.Random(3))
    conf = _conf(name)
    jd = JInteractions(jconfig.ModelConf(conf), train, test)
    td = Interactions(ModelConf(conf), train, test)
    return (J_MODELS[name](jconfig.ModelConf(conf), jd),
            T_MODELS[name](ModelConf(conf), td, device="cpu"))


def _path_graph():
    return sp.csr_matrix(np.array([[0, 1, 0, 0], [1, 0, 1, 0], [0, 1, 0, 1], [0, 0, 1, 0]],
                                  dtype=np.float32))


# ---------------------------------------------------------------------------
# the host pipeline
# ---------------------------------------------------------------------------


def test_cooccurrence_network_and_walk_pairs_equal_jax():
    jmodel, tmodel = _models("CUNE_BPR")
    got, want = W.cooccurrence_network(tmodel.data), jw.cooccurrence_network(jmodel.data)
    assert got.nnz > 0
    for key in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    walks = np.random.RandomState(2).randint(0, 30, size=(25, 7)).astype(np.int32)
    for window in (1, 3, 6, 9):
        for a, b in zip(W.walk_pairs(walks, window), jw.walk_pairs(walks, window)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("walk_count,walk_length", [(4, 6), (10, 10), (3, 1)])
def test_random_walks_equal_jax_numpy_walks(numpy_walks, walk_count, walk_length):
    """The same ``RandomState`` gives the same walks and leaves the state
    at the same place: the port's numpy walk makes the JAX package's seed
    draw for its C++ walker first."""
    jmodel, tmodel = _models("CUNE_BPR")
    net = W.cooccurrence_network(tmodel.data)
    # an isolated node
    net = sp.block_diag([net, sp.csr_matrix((1, 1), dtype=np.float32)]).tocsr()
    r1, r2 = np.random.RandomState(11), np.random.RandomState(11)
    got, active = W.random_walks_numpy(net, walk_count, walk_length, r1)
    want, jactive = jw.random_walks(net, walk_count, walk_length, r2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(active, jactive)
    assert got.shape == (len(active) * walk_count, walk_length) and net.shape[0] - 1 not in active
    assert r1.randint(0, 2**31) == r2.randint(0, 2**31)


@pytest.mark.parametrize("walk_count,walk_length", [(4, 6), (10, 10), (3, 1)])
def test_random_walks_equal_jax_default_walks(walk_count, walk_length):
    """The port's walker against the JAX package's as it runs by default
    (its C++ library): the same walks from the same ``RandomState``, which
    both leave at the same place."""
    _, tmodel = _models("CUNE_BPR")
    net = W.cooccurrence_network(tmodel.data)
    net = sp.block_diag([net, sp.csr_matrix((1, 1), dtype=np.float32)]).tocsr()
    r1, r2 = np.random.RandomState(11), np.random.RandomState(11)
    got, active = W.random_walks(net, walk_count, walk_length, r1)
    want, jactive = jw.random_walks(net, walk_count, walk_length, r2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(active, jactive)
    assert r1.randint(0, 2**31) == r2.randint(0, 2**31)


def test_random_walks_follow_edges_by_weight():
    for walks_of in (W.random_walks, W.random_walks_numpy):
        adj = _path_graph()
        walks, active = walks_of(adj, 4, 6, np.random.RandomState(0))
        assert list(active) == [0, 1, 2, 3] and walks.shape == (16, 6)
        assert all(adj[a, b] > 0 for row in walks for a, b in zip(row[:-1], row[1:]))
        # node 0 to 1 with weight 9, to 2 with weight 1
        adj = sp.csr_matrix(np.array([[0, 9, 1], [9, 0, 0], [1, 0, 0]], dtype=np.float32))
        walks, _ = walks_of(adj, 2000, 2, np.random.RandomState(1))
        frac = (walks[walks[:, 0] == 0][:, 1] == 1).mean()
        assert 0.82 < frac < 0.97
        empty, act = walks_of(sp.csr_matrix((3, 3), dtype=np.float32), 2, 4, np.random.RandomState(0))
        assert empty.shape == (0, 4) and len(act) == 0


# ---------------------------------------------------------------------------
# SGNS and the friend top-k
# ---------------------------------------------------------------------------


def _cliques():
    n = 12
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(6):
        for j in range(6):
            if i != j:
                a[i, j] = a[i + 6, j + 6] = 1
    return sp.csr_matrix(a)


def test_skipgram_with_jax_draws_matches_jax(numpy_walks):
    """Three epochs of 26 steps (the last batch padded with pair 0) on the
    two-clique graph, the JAX package's draws injected."""
    walks, active = jw.random_walks(_cliques(), 30, 8, np.random.RandomState(0))
    centers, contexts = jw.walk_pairs(walks, 3)
    kw = dict(epochs=3, negatives=5, batch_size=512, lr=0.05, seed=4)
    assert len(centers) % 512
    want = np.asarray(jw.train_skipgram(centers, contexts, 14, 8, active, **kw))
    timer = StepTimer(len(centers))
    got = W.train_skipgram(centers, contexts, 14, 8, active, draws=JaxDraws, timer=timer, **kw)
    assert got.shape == (14, 8) and len(timer.times) == 3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    # the two nodes no walk visits keep their initial rows
    np.testing.assert_array_equal(got[12:].numpy(), JaxDraws(4, "cpu").initial_table(14, 8)[12:].numpy())
    assert not W.train_skipgram(centers[:0], contexts[:0], 14, 8, active).any()


def test_skipgram_loss_and_gradients_match_jax():
    rng = np.random.RandomState(5)
    t_in, t_out = rng.randn(9, 4).astype(np.float32), rng.randn(9, 4).astype(np.float32)
    c, ctx, negs = rng.randint(0, 9, 16), rng.randint(0, 9, 16), rng.randint(0, 9, (16, 3))

    def jloss(p):
        vc = p["in"][c]
        pos = jnp.sum(vc * p["out"][ctx], axis=1)
        neg = jnp.einsum("bd,bkd->bk", vc, p["out"][negs])
        return -(jnp.sum(jnp.log(jax.nn.sigmoid(pos) + 1e-10)) + jnp.sum(jnp.log(jax.nn.sigmoid(-neg) + 1e-10)))

    want, grads = jax.value_and_grad(jloss)({"in": t_in, "out": t_out})
    a, b = torch.tensor(t_in, requires_grad=True), torch.tensor(t_out, requires_grad=True)
    loss = W.skipgram_loss(a, b, torch.tensor(c), torch.tensor(ctx), torch.tensor(negs))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **F32)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(grads["in"]), **F32)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(grads["out"]), **F32)


@pytest.mark.parametrize("chunk", [1024, 4])
def test_friend_topk_matches_jax_with_ties_at_k(chunk):
    """Rows 3, 7 and 10 repeat row 1 (and row 5 is row 1 scaled), so every
    node that has row 1 among its neighbours ties at the k-th place; both
    packages take the lower ids first. Active nodes skip 2 and 11."""
    rng = np.random.RandomState(3)
    emb = rng.randn(14, 6).astype(np.float32)
    emb[[3, 7, 10]] = emb[1]
    emb[5] = 2 * emb[1]
    emb[13] = 0.0  # a zero row
    active = np.array([0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 12, 13])
    for k in (1, 3, 4, 11):
        want_ids, want_sims = jw.topk_cosine_neighbors(jnp.asarray(emb), jnp.asarray(active), k)
        ids, sims = W.topk_cosine_neighbors(torch.from_numpy(emb), active, k, chunk=chunk)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(sims.numpy(), np.asarray(want_sims), rtol=0, atol=1e-6)
    ids, _ = W.topk_cosine_neighbors(torch.from_numpy(emb), active, 4)
    assert list(ids[list(active).index(1)].numpy()[:3]) == [3, 5, 7]
    assert all(a not in row for a, row in zip(active, ids.numpy()))


# ---------------------------------------------------------------------------
# the CUNE models against the JAX package
# ---------------------------------------------------------------------------


def _friends_match(name):
    jmodel, tmodel = _models(name)
    tmodel.skipgram_draws = JaxDraws
    want_ids, want_active = jmodel.implicit_friends()
    ids, active = tmodel.implicit_friends()
    np.testing.assert_array_equal(active, want_active)
    np.testing.assert_array_equal(ids, want_ids)
    stats = tmodel.walk_stats
    assert stats["walkers"] == len(active) * tmodel.walk_count and stats["pairs"] > 0
    got, want = tmodel.friend_item_table(ids, active), jmodel.friend_item_table(want_ids, want_active)
    assert got.nnz > 0
    for key in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))


@pytest.mark.parametrize("name", ["CUNE_MF", "CUNE_BPR"])
def test_implicit_friends_and_friend_items_match_jax(numpy_walks, name):
    """The walks, pairs and SGNS of the JAX package's pipeline (its draws
    injected), its top-k friends and the friend-item table bit for bit on
    the same friends; both packages walk in numpy."""
    _friends_match(name)


@pytest.mark.parametrize("name", ["CUNE_MF", "CUNE_BPR"])
def test_implicit_friends_with_default_walks_match_jax(name):
    """As above, each package walking as it does by default: the port's
    host walker, the JAX package's C++ one."""
    _friends_match(name)


def _spec_and_port(name, monkeypatch):
    """The JAX model's spec (its friends recorded) and the port at its
    parameters with the same friends."""
    monkeypatch.setattr("qrec_tpu.native.random_walks_native", lambda *a: None)
    jmodel, tmodel = _models(name)
    friends = []
    real = jmodel.implicit_friends
    jmodel.implicit_friends = lambda: friends.append(real()) or friends[0]
    spec = jmodel.build()
    tmodel.implicit_friends = lambda: friends[0]
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, spec.params), "cpu"))
    tmodel.prepare_graph()
    return jmodel, spec, tmodel


@pytest.mark.parametrize("name", ["CUNE_MF", "CUNE_BPR"])
def test_first_step_loss_and_gradients_match_jax(monkeypatch, name):
    _, spec, tmodel = _spec_and_port(name, monkeypatch)
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


@pytest.mark.parametrize("name", ["CUNE_MF", "CUNE_BPR"])
def test_three_bold_epochs_on_injected_batches_match_jax(monkeypatch, name):
    jmodel, spec, tmodel = _spec_and_port(name, monkeypatch)
    batches, jlosses, params = _jax_bold_epochs(jmodel, spec, 3)
    losses = tmodel.fit(epoch_batches=batches)
    assert len(losses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[key]), atol=1e-4, err_msg=key)
    assert isinstance(tmodel.score_form(), ScoreForm)


@pytest.mark.parametrize("name", ["CUNE_MF", "CUNE_BPR"])
def test_three_bold_epochs_with_default_walks_match_jax(name):
    """No walker patched: the JAX model builds its friends from its C++
    walks, the port from its own host walker (the JAX SGNS draws
    injected), and the friend lists agree; then three bold epochs on the
    JAX sampler's batches, as above."""
    jmodel, tmodel = _models(name)
    friends = []
    real = jmodel.implicit_friends
    jmodel.implicit_friends = lambda: friends.append(real()) or friends[0]
    spec = jmodel.build()
    tmodel.skipgram_draws = JaxDraws
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, spec.params), "cpu"))
    ids, active = tmodel.implicit_friends()
    np.testing.assert_array_equal(ids, friends[0][0])
    np.testing.assert_array_equal(active, friends[0][1])
    batches, jlosses, params = _jax_bold_epochs(jmodel, spec, 3)
    losses = tmodel.fit(epoch_batches=batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[key]), atol=1e-4, err_msg=key)


def test_cune_bpr_sampler_by_its_properties():
    """A friend item is an item of the user's friend-item row, a negative
    never a positive, and ``has`` says whether the row has items."""
    _, tmodel = _models("CUNE_BPR")
    tmodel.prepare_graph()
    fp_ptr, fp_idx = tmodel.fp_indptr.numpy(), tmodel.fp_indices.numpy()
    rated = [set(tmodel.data.u_indices[tmodel.data.u_indptr[u]:tmodel.data.u_indptr[u + 1]])
             for u in range(tmodel.num_users)]
    batch = tuple(t.reshape(-1) for t in tmodel.sampler(torch.Generator().manual_seed(2)))
    u, ks, js, has, w = batch[0], batch[2:5], batch[5:8], batch[8], batch[9]
    n = tmodel.train_size
    assert w[:n].all() and not w[n:].any() and has.any()
    for b in range(len(u)):
        row = set(fp_idx[fp_ptr[u[b]]:fp_ptr[u[b] + 1]])
        assert bool(has[b]) == bool(row)
        for k, j in zip(ks, js):
            assert int(j[b]) not in rated[int(u[b])]
            if has[b]:
                assert int(k[b]) in row


# ---------------------------------------------------------------------------
# the bundled configs on planted blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["CUNE_BPR", "CUNE_MF"])
def test_bundled_config_learns_planted_blocks_on_cpu(tmp_path, name):
    """``config/<name>.conf`` at the JAX tests' small size
    (tests/test_walk_models.py): CUNE_BPR's Recall@10 above 0.5, CUNE_MF's
    RMSE below 1.7, the result files written."""
    rp = tmp_path / "ratings.txt"
    rp.write_text("".join(f"{u} {i} {int(r)}\n" for u, i, r in _records(name == "CUNE_MF")))
    conf = ModelConf(str(CONFIG / f"{name}.conf"))
    key, args = ARGS[name]
    size = {"num.factors": "8" if name == "CUNE_MF" else "16",
            "num.max.epoch": "25" if name == "CUNE_MF" else "30", "batch_size": "64",
            "learnRate": "-init 0.02 -max 1" if name == "CUNE_MF" else "-init 0.05 -max 1",
            "reg.lambda": "-u 0.01 -i 0.01 -b 0.1 -s 0.1", "evaluation.setup": "-ap 0.2",
            "seed": "7", key: args}
    for k, v in {"ratings": str(rp), **size, "output.setup": f"on -dir {tmp_path / 'out'}/"}.items():
        conf[k] = v
    rec = QRec(conf, seed=3, device="cpu")
    parsed = metrics.parse_measure(rec.execute())
    if name == "CUNE_MF":
        assert parsed["global"]["RMSE"] < 1.7, parsed
    else:
        assert parsed["Top 10"]["Recall"] > 0.5, parsed
    assert len(list((tmp_path / "out").iterdir())) == 2
    assert rec.model.graph_seconds >= 0 and rec.model.walk_stats["pairs"] > 0
