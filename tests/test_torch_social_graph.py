"""The social slice of the PyTorch port against the JAX package, on the CPU:
the relation file and ``SocialGraph``, the session's relation and its
``requires_social`` error, the helpers against the JAX package's formulas,
the five models' host matrices, their losses and gradients at the JAX
parameters with the JAX draws injected, a few epochs on the JAX sampler's
batches (SEPT through both phases, BUIR with its target), the rankings
through the port's ranker, and the port's own runs on planted blocks."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu import io as jio
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.social import SocialGraph as JSocialGraph
from qrec_tpu.data.split import data_split
from qrec_tpu.models import social_graph as jsg
from qrec_tpu.ops.topk import CatalogRanker as JRanker, embedding_score_fn
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch import io as tio
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.social import SocialGraph
from qrec_tpu_torch.errors import ConfigError, DataFormatError
from qrec_tpu_torch.models import social_graph as tsg
from qrec_tpu_torch.models.social_graph import BUIR, DHCF, MHCN, SEPT, DiffNet
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops.spmm import DenseMat, DeviceCOO, DenseJoint
from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreForm


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# only f32 products and sums, in another order
F32 = dict(rtol=1e-5, atol=1e-6)
# bf16-rounded operands on the way: the bound of the dual-vs-XLA JAX test
BF16 = dict(rtol=5e-3, atol=5e-3)


def _close_f32(got, want):
    """rtol 1e-5, and 1e-6 of the largest |want| (at least 1e-6) absolute:
    the gradients of SEPT's exp(s / 0.1) terms are f32 sums of terms up
    to their largest entry."""
    want = np.asarray(want)
    atol = 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=atol)

ARGS = {
    "MHCN": "-n_layer 2 -ss_rate 0.01",
    "SEPT": "-n_layer 2 -ss_rate 0.005 -drop_rate 0.3 -ins_cnt 5",
    "BUIR": "-n_layer 2 -tau 0.99 -drop_rate 0.2",
    "DiffNet": "-n_layer 2",
    "DHCF": "",
}
J_MODELS = {"MHCN": jsg.MHCN, "SEPT": jsg.SEPT, "BUIR": jsg.BUIR, "DiffNet": jsg.DiffNet,
            "DHCF": jsg.DHCF}
T_MODELS = {"MHCN": MHCN, "SEPT": SEPT, "BUIR": BUIR, "DiffNet": DiffNet, "DHCF": DHCF}
# every propagation a DeviceCOO in both packages: only f32 operations
COO = {"graph.aux.dense": "off", "graph.backend": "coo"}


def _lines(tmp_path=None):
    """The planted block data and social blocks of the JAX package's social
    tests (tests/test_social_graph_models.py): 40 users in two blocks of
    15 items, four trust links inside each user's block and 20 reciprocated
    pairs."""
    rng = np.random.RandomState(0)
    ratings = [
        f"u{u} i{i} 1\n"
        for u in range(40)
        for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)
    ]
    trust = []
    for u in range(40):
        lo = 0 if u < 20 else 20
        trust += [f"u{u} u{f} 1\n" for f in rng.choice(20, size=4, replace=False) + lo if f != u]
    for u in range(0, 40, 2):
        trust += [f"u{u} u{u + 1} 1\n", f"u{u + 1} u{u} 1\n"]
    if tmp_path is None:
        return ratings, trust
    rp, tp = tmp_path / "ratings.txt", tmp_path / "trust.txt"
    rp.write_text("".join(ratings))
    tp.write_text("".join(trust))
    return str(rp), str(tp)


def _conf(name, extra=None, ratings="unused", trust="unused"):
    base = {
        "ratings": ratings, "ratings.setup": "-columns 0 1 2",
        "social": trust, "social.setup": "-columns 0 1 2",
        "model.name": name, "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10",
        "num.factors": "8", "num.max.epoch": "3", "batch_size": "64",
        "learnRate": "-init 0.01 -max 1", "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1",
        "output.setup": "off -dir ./results/", "seed": "7",
    }
    if ARGS[name]:
        base[name] = ARGS[name]
    base.update(extra or {})
    return base


def _relation():
    return [line.split()[:2] + [1.0] for line in _lines()[1]]


def _both(name, extra=None):
    """(JAX model, port model) on the same split and relation, the port's
    parameters loaded from the JAX package's initial ones where the model
    builds them up front."""
    ratings, _ = _lines()
    records = [line.split()[:2] + [1.0] for line in ratings]
    train, test = data_split(records, 0.2, rng=random.Random(3))
    conf = _conf(name, extra)
    jd = JInteractions(jconfig.ModelConf(conf), train, test)
    td = Interactions(ModelConf(conf), train, test)
    rel = _relation()
    jmodel = J_MODELS[name](jconfig.ModelConf(conf), jd, social=JSocialGraph(rel, jd))
    tmodel = T_MODELS[name](ModelConf(conf), td, device="cpu", social=SocialGraph(rel, td))
    return jmodel, tmodel


def _load(tmodel, params, target=None):
    tree = {k: np.asarray(v) for k, v in params.items()}
    if target is not None:
        tree["target"] = {k: np.asarray(v) for k, v in target.items()}
    missing, unexpected = tmodel.load_state_dict(params_from_jax(tree, "cpu"), strict=False)
    assert not unexpected and not [k for k in missing if not k.startswith("target.")]


def _torch_batch(batch):
    u, i, j, w = (np.asarray(a) for a in batch)
    idx = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    return idx(u), idx(i), idx(j), torch.from_numpy(w.astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the JAX package's draws, as the port's ``draw`` returns them
# ---------------------------------------------------------------------------


def _mhcn_draws(rng, model):
    u, d = model.num_users, model.emb_size

    def perms(key):
        r1, r2, r3, _ = jax.random.split(key, 4)
        pair = lambda k: tuple(  # noqa: E731
            _t(jax.random.permutation(s, n)) for s, n in zip(jax.random.split(k), (d, u))
        )
        return (_t(jax.random.permutation(r1, u)), pair(r2), pair(r3))

    return [perms(k) for k in jax.random.split(rng, 3)]


def _sept_draws(rng, model):
    return _t(jax.random.bernoulli(jax.random.fold_in(rng, 7), 1.0 - model.drop_rate,
                                   (model.n_groups,)))


def _buir_draws(rng, model):
    return tuple(_t(jax.random.bernoulli(k, 1.0 - model.drop_rate, (model.n_edges,)))
                 for k in jax.random.split(rng))


def _dhcf_draws(rng, model):
    out = []
    for _ in range(model.n_layers):
        r1, r2, rng = jax.random.split(rng, 3)
        out.append((_t(jax.random.bernoulli(r1, 0.9, (model.num_users, model.emb_size))),
                    _t(jax.random.bernoulli(r2, 0.9, (model.num_items, model.emb_size)))))
    return out


DRAWS = {"MHCN": _mhcn_draws, "SEPT": _sept_draws, "BUIR": _buir_draws, "DHCF": _dhcf_draws,
         "DiffNet": lambda rng, model: None}


# ---------------------------------------------------------------------------
# the relation file, SocialGraph and the session
# ---------------------------------------------------------------------------


def test_load_relations_and_social_graph_match_jax(tmp_path):
    path = tmp_path / "trust.txt"
    path.write_text("a,b\nu1 u2 0.5\nu2\tu1 1\nu3 u9 2\nu1 u3 1\n")
    for columns, header in (("-columns 0 1 2", " -header"), ("-columns 0 1", " -header")):
        conf = {"social.setup": columns + header}
        want = jio.load_relations(jconfig.ModelConf(conf), str(path))
        got = tio.load_relations(ModelConf(conf), str(path))
        assert got == want and got[0] == ["u1", "u2", 0.5 if "2" in columns else 1.0]
    bad = tmp_path / "bad.txt"
    bad.write_text("u1 u2 x\n")
    with pytest.raises(DataFormatError, match="line 0"):
        tio.load_relations(ModelConf({"social.setup": "-columns 0 1 2"}), str(bad))
    with pytest.raises(DataFormatError, match="columns"):
        tio.load_relations(ModelConf({"social.setup": "-columns 0"}), str(path))
    # cleaned against the rating users; ids are the ratings'
    jd, td = _both("DiffNet")[0].data, _both("DiffNet")[1].data
    rel = _relation() + [["u1", "nobody", 1.0], ["ghost", "u2", 1.0]]
    jg, tg = JSocialGraph(rel, jd), SocialGraph(rel, td)
    for a, b in zip(tg.coo(), jg.coo()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tg.relation == jg.relation and len(tg.relation) == len(_relation())
    assert tg.user is td.user and tg.trustSize() == jg.trustSize()
    assert tg.getFollowees("u1") == jg.getFollowees("u1") and tg.hasFollower("u1", "u0")
    assert (tg.scipy_adjacency() != jg.scipy_adjacency()).nnz == 0
    np.testing.assert_array_equal(tg.out_degree, jg.out_degree)
    # without the ratings: the store's own first-appearance order
    raw = [["x", "y", 1.0], ["z", "x", 2.0]]
    assert SocialGraph(raw).user == JSocialGraph(raw).user == {"x": 0, "y": 1, "z": 2}


def test_a_social_model_without_a_relation_raises(tmp_path):
    ratings, _ = _lines(tmp_path)
    conf = _conf("MHCN", ratings=ratings)
    del conf["social"]
    with pytest.raises(ConfigError, match="requires a 'social' relation"):
        QRec(ModelConf(conf), device="cpu").execute()


def test_cross_validation_carries_the_relation_to_every_fold(tmp_path, capsys):
    ratings, trust = _lines(tmp_path)
    conf = _conf("DiffNet", {"evaluation.setup": "-cv 2", "num.max.epoch": "1",
                             "output.setup": f"off -dir {tmp_path / 'out'}/"},
                 ratings=ratings, trust=trust)
    rec = QRec(ModelConf(conf), seed=3, device="cpu")
    assert len(rec.relation) == len(_lines()[1])
    measure = rec.execute()
    assert measure[0].startswith("Top 10") and len(measure) == 5
    assert rec.model.social is not None and rec.model.fold == "[2]"
    assert len(list((tmp_path / "out").glob("DiffNet@*-2-fold-cv.txt"))) == 1


# ---------------------------------------------------------------------------
# helpers against the JAX package's formulas
# ---------------------------------------------------------------------------


def test_mhcn_channel_mim_matches_jax():
    rng = np.random.RandomState(1)
    em, edge = rng.randn(12, 5).astype(np.float32), rng.randn(12, 5).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want, (jde, jdg) = jax.value_and_grad(jsg.mhcn_channel_mim, argnums=(1, 2))(
        key, jnp.asarray(em), jnp.asarray(edge))
    r1, r2, r3, _ = jax.random.split(key, 4)
    pair = lambda k, n: tuple(_t(jax.random.permutation(s, m))  # noqa: E731
                              for s, m in zip(jax.random.split(k), (5, n)))
    perms = (_t(jax.random.permutation(r1, 12)), pair(r2, 12), pair(r3, 12))
    te, tg = torch.from_numpy(em).requires_grad_(True), torch.from_numpy(edge).requires_grad_(True)
    got = tsg.mhcn_channel_mim(te, tg, perms)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **F32)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jde), **F32)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jdg), **F32)


def test_sept_neighbor_ssl_and_buir_pair_loss_match_jax():
    rng = np.random.RandomState(2)
    views = [rng.randn(10, 6).astype(np.float32) for _ in range(4)]
    views = [v / np.linalg.norm(v, axis=1, keepdims=True) for v in views]
    um = np.array([1] * 7 + [0] * 3, np.float32)  # three pad slots
    want, jg = jax.jit(jax.value_and_grad(lambda *v: jsg.sept_neighbor_ssl(*v, jnp.asarray(um), 3),
                                          argnums=(0, 1, 2, 3)))(*map(jnp.asarray, views))
    tv = [torch.from_numpy(v).requires_grad_(True) for v in views]
    got = tsg.sept_neighbor_ssl(*tv, torch.from_numpy(um), 3)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **F32)
    for a, b in zip(tv, jg):
        _close_f32(a.grad.numpy(), b)
    # BUIR's loss, with a zero row (a node a view isolated)
    q = [rng.randn(9, 4).astype(np.float32) for _ in range(4)]
    q[2][0] = 0
    w = (rng.rand(9) > 0.2).astype(np.float32)
    want, jg = jax.jit(jax.value_and_grad(lambda *v: jsg.buir_pair_loss(*v, jnp.asarray(w)),
                                          argnums=(0, 1)))(*map(jnp.asarray, q))
    tq = [torch.from_numpy(v).requires_grad_(k < 2) for k, v in enumerate(q)]
    got = tsg.buir_pair_loss(*tq, torch.from_numpy(w))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **F32)
    for a, b in zip(tq, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **F32)


@pytest.mark.parametrize("total", [10**9, 3 * 40 * 40 + 40 * 30, 2 * 40 * 40, 0])
def test_the_dense_budget_falls_to_coo_in_the_jax_order(total, monkeypatch):
    """MHCN's budget order: h_s, h_j, h_p, r, rᵀ; the first that does not
    fit, and every later one, is a DeviceCOO, as in the JAX package."""
    jmodel, tmodel = _both("MHCN")
    mats = list(tmodel.compute_motif_matrices()) + [tmodel.joint_r(), tmodel.joint_r().T]
    jbudget, tbudget = jsg.DenseBudget(total), tsg.DenseBudget(total)
    jforms = [type(jsg._dev(m, jbudget, "on")).__name__ for m in mats]
    tforms = [type(tsg.aux_operator(m, tbudget, "on", "cpu")).__name__ for m in mats]
    assert tforms == jforms and tbudget.remaining == jbudget.remaining
    assert all(type(tsg.aux_operator(m, None, mode, "cpu")) is DeviceCOO
               for m in mats for mode in ("auto", "off"))
    with pytest.raises(ConfigError, match="graph.aux.dense"):
        tsg.aux_operator(mats[0], None, "always", "cpu")


# ---------------------------------------------------------------------------
# the models' host matrices
# ---------------------------------------------------------------------------


def _coo_arrays(op):
    return [op.rows.numpy(), op.cols.numpy(), op.vals.numpy()]


@pytest.mark.parametrize("name", ["MHCN", "SEPT", "DiffNet", "DHCF"])
def test_host_matrices_equal_jax(name):
    jmodel, tmodel = _both(name, {"graph.aux.dense": "off"})
    tmodel.prepare_graph()
    if name == "SEPT":
        for a, b in zip(tmodel.views(), jmodel._views()):
            assert (a != b).nnz == 0
        got, want = tmodel.combined_graph(), jmodel._combined_graph()
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert got[3:] == want[3:]
        assert isinstance(tmodel.aug_structure, DeviceCOO)
        return
    spec = jmodel.build()
    ops = {"MHCN": ("h_s", "h_j", "h_p", "r_op", "rt_op"), "DiffNet": ("s_op", "a_op"),
           "DHCF": ("a_u", "a_i")}[name]
    keys = {"MHCN": ("h_s", "h_j", "h_p", "r", "rt"), "DiffNet": ("s", "a"),
            "DHCF": ("a_u", "a_i")}[name]
    for op, key in zip(ops, keys):
        got, want = getattr(tmodel, op), spec.consts[key]
        assert isinstance(got, DeviceCOO)
        for a, b in zip(_coo_arrays(got), [want["rows"], want["cols"], want["vals"]]):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{name} {key}")
    if name == "MHCN":
        for a, b in zip(tmodel.compute_motif_matrices(), jmodel._compute_motif_matrices()):
            assert (a != b).nnz == 0 and a.nnz > 0


# ---------------------------------------------------------------------------
# losses and gradients at the JAX parameters
# ---------------------------------------------------------------------------


def _capture_phases(jmodel):
    """SEPT's initial parameters and its two phases (loss, sampler, consts,
    epochs) as its ``fit`` hands them to ``run_training``, which trains
    nothing here."""
    seen, phases = {}, []

    def run_training(params, loss_fn, sampler, **kw):
        seen.setdefault("params", params)
        phases.append((loss_fn, sampler, kw["consts"], kw["max_epoch"]))
        return params

    jmodel.run_training = run_training
    jmodel.fit()
    return seen["params"], phases


def _capture_buir(jmodel, monkeypatch):
    """BUIR's loss function, initial parameters and target, from one epoch
    of its own ``fit`` (its loop is not ``run_training``)."""
    seen = {}
    real_vg, real_adam = jax.value_and_grad, optax.adam

    def value_and_grad(fn, *a, **k):
        seen.setdefault("loss_fn", fn)
        return real_vg(fn, *a, **k)

    def adam(lr):
        opt = real_adam(lr)

        def init(params):
            seen.setdefault("params", params)
            return opt.init(params)

        return optax.GradientTransformation(init, opt.update)

    monkeypatch.setattr(jax, "value_and_grad", value_and_grad)
    monkeypatch.setattr(optax, "adam", adam)
    epochs, jmodel.max_epoch = jmodel.max_epoch, 1
    jmodel.fit()
    jmodel.max_epoch = epochs
    monkeypatch.undo()
    params = seen["params"]
    target = {k: params[k] for k in ("user_emb", "item_emb")}
    return seen["loss_fn"], params, target


def _jax_problem(name, jmodel, monkeypatch):
    """(initial params, target or None, [(phase loss, sampler, consts,
    epochs)]) of the JAX model, every loss as ``loss(params, batch, rng)``."""
    if name == "SEPT":
        params, phases = _capture_phases(jmodel)
        return params, None, phases
    if name == "BUIR":
        loss_fn, params, target = _capture_buir(jmodel, monkeypatch)
        return params, target, [(loss_fn, jmodel.pairwise_sampler(), None, None)]
    spec = jmodel.build()
    return spec.params, None, [(spec.loss_fn, spec.sampler, spec.consts, None)]


def _jloss(loss_fn, consts, target):
    if target is not None:
        return lambda p, b, r, t=target: loss_fn(p, t, b, r)
    return lambda p, b, r: loss_fn(p, b, r, consts)


STEP_CASES = [
    ("MHCN", COO, F32), ("MHCN", {"graph.aux.dense": "on"}, BF16),
    ("SEPT", COO, F32), ("SEPT", {"graph.aux.dense": "off", "graph.dense.quant": "factored"}, BF16),
    ("BUIR", COO, F32),
    ("DiffNet", COO, F32), ("DiffNet", {"graph.aux.dense": "on"}, BF16),
    ("DHCF", COO, F32), ("DHCF", {"graph.aux.dense": "on"}, BF16),
]


@pytest.mark.parametrize(
    "name,extra,tol", STEP_CASES,
    ids=["MHCN-coo", "MHCN-dense", "SEPT-coo", "SEPT-factored", "BUIR-coo", "DiffNet-coo",
         "DiffNet-dense", "DHCF-coo", "DHCF-dense"],
)
def test_step_loss_and_gradients_match_jax(name, extra, tol, monkeypatch):
    jmodel, tmodel = _both(name, extra)
    params, target, phases = _jax_problem(name, jmodel, monkeypatch)
    _load(tmodel, params, target)
    tmodel.prepare_graph()
    if "graph.aux.dense" in extra and extra["graph.aux.dense"] == "on" and name != "SEPT":
        assert any(isinstance(v, DenseMat) for v in vars(tmodel).values())
    if name == "SEPT" and "graph.dense.quant" in extra:
        assert isinstance(tmodel.joint_adj, DenseJoint)
    batch = jax.tree_util.tree_map(lambda x: x[0], phases[0][1](jax.random.PRNGKey(2)))
    rng = jax.random.PRNGKey(5)
    losses = [(phases[-1][0], tmodel.step_loss, DRAWS[name](rng, tmodel))]
    if name == "SEPT":
        losses.append((phases[0][0], tmodel.rec_loss, None))
    for loss_fn, port_loss, draws in losses:
        want, grads = jax.jit(jax.value_and_grad(_jloss(loss_fn, phases[0][2], target)))(
            params, batch, rng)
        tmodel.zero_grad(set_to_none=True)
        loss = port_loss(_torch_batch(batch), draws)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want), rtol=tol["rtol"])
        for key, g in params_from_jax({k: np.asarray(v) for k, v in grads.items()}, "cpu").items():
            got = getattr(tmodel, key).grad.numpy()
            if tol is F32:
                _close_f32(got, g.numpy())
            else:
                np.testing.assert_allclose(got, g.numpy(), **tol, err_msg=f"{name} {key}")


# ---------------------------------------------------------------------------
# epochs on the JAX sampler's batches
# ---------------------------------------------------------------------------


def _jax_epochs(name, jmodel, tmodel, params, target, phases):
    """The JAX package's epochs of every phase from ``params`` (BUIR's with
    the target update after each step); returns the epoch batches, losses,
    parameters after each epoch, and the port's draws of every step."""
    batches, jlosses, jparams, draws = [], [], [], []
    rng = jax.random.PRNGKey(0)
    for loss_fn, sampler, consts, epochs in phases:
        optimizer = optax.adam(jmodel.lrate)
        opt_state = optimizer.init(params)
        for _ in range(epochs or jmodel.max_epoch):
            rng, rs, rt = jax.random.split(rng, 3)
            b = sampler(rs)
            batches.append(tuple(np.asarray(a) for a in b))
            keys = jax.random.split(rt, b[0].shape[0])
            if name == "BUIR":
                total = 0.0
                step = jax.jit(jax.value_and_grad(loss_fn))
                for s, key in enumerate(keys):
                    batch = tuple(a[s] for a in b)
                    loss, grads = step(params, target, batch, key)
                    upd, opt_state = optimizer.update(grads, opt_state, params)
                    params = optax.apply_updates(params, upd)
                    target = {k: target[k] * jmodel.tau + params[k] * (1 - jmodel.tau)
                              for k in target}
                    total += float(loss)
                    draws.append(DRAWS[name](key, tmodel))
                jlosses.append(total)
            else:
                run_epoch = jtrainer.make_epoch_runner(loss_fn, optimizer)
                params, opt_state, loss = run_epoch(params, opt_state, b, rt, consts)
                jlosses.append(float(loss))
                if name != "SEPT" or len(jlosses) > phases[0][3]:
                    draws += [DRAWS[name](k, tmodel) for k in keys]
            jparams.append(params)
    return batches, jlosses, jparams, draws, target


@pytest.mark.parametrize("name", ["MHCN", "SEPT", "BUIR", "DiffNet", "DHCF"])
def test_epochs_on_injected_batches_match_jax(name, monkeypatch, capsys):
    jmodel, tmodel = _both(name, COO)
    params, target, phases = _jax_problem(name, jmodel, monkeypatch)
    _load(tmodel, params, target)
    tmodel.prepare_graph()
    batches, jlosses, jparams, draws, jtarget = _jax_epochs(name, jmodel, tmodel, params, target,
                                                            phases)
    stream = iter(draws)
    tmodel.draw = lambda gen: next(stream)
    capsys.readouterr()
    losses = tmodel.fit(epoch_batches=batches)
    assert next(stream, None) is None  # one draw per step
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    if name == "SEPT":  # one warm-up epoch, then two joint ones, one tracker
        assert [len(p) for p in tmodel.phase_losses] == [1, 2]
        assert tmodel.tracker.epoch_offset == 3
    final = jparams[tmodel.tracker.best_epoch - 1] if tmodel.tracker else jparams[-1]
    want = params_from_jax({k: np.asarray(v) for k, v in final.items()}, "cpu")
    for key, value in want.items():
        np.testing.assert_allclose(getattr(tmodel, key).detach().numpy(), value.numpy(),
                                   atol=1e-4, err_msg=key)
    if name == "BUIR":
        for key in ("user_emb", "item_emb"):
            np.testing.assert_allclose(getattr(tmodel.target, key).numpy(),
                                       np.asarray(jtarget[key]), atol=1e-4, err_msg=key)
        out = capsys.readouterr().out
        assert "BUIR [1] epoch 3: loss = " in out and "epoch 1:" not in out
    width = {"BUIR": 16, "DHCF": 24}.get(name, 8)
    assert tmodel.U.shape == (tmodel.num_users, width)
    assert tmodel.V.shape == (tmodel.num_items, width)


# ---------------------------------------------------------------------------
# rankings through the port's ranker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["BUIR", "DHCF"])
def test_rankings_of_the_jax_factors_match(name, monkeypatch):
    """The JAX package's final factors (BUIR's (o_u‖q_u, q_i‖o_i) at width
    2d, DHCF's layer concat at 3d) ranked by the port's fused top-k give the
    JAX ranker's items, and the port's own factors at the JAX parameters
    are the JAX package's."""
    jmodel, tmodel = _both(name, COO)
    params, target, phases = _jax_problem(name, jmodel, monkeypatch)
    _load(tmodel, params, target)
    tmodel.prepare_graph()
    if name == "BUIR":
        jmodel.max_epoch = 0
        jmodel.fit()  # no epoch: the initial parameters' factors
        ju, jv = np.asarray(jmodel.U), np.asarray(jmodel.V)
    else:
        scored = jmodel.build().score_params_fn(params, phases[0][2])
        ju, jv = np.asarray(scored["user_emb"]), np.asarray(scored["item_emb"])
    with torch.no_grad():
        tu, tv = tmodel()
    np.testing.assert_allclose(tu.numpy(), ju, **F32)
    np.testing.assert_allclose(tv.numpy(), jv, **F32)
    jranker = JRanker(jmodel.data, k=10)
    jids, _ = jranker.topk(embedding_score_fn, {"user_emb": jnp.asarray(ju),
                                                "item_emb": jnp.asarray(jv)})
    ranker = CatalogRanker(tmodel.data, k=10, device="cpu", bitmask=tmodel.rated_bitmask)
    ids, _ = ranker.topk(ScoreForm(torch.from_numpy(ju), torch.from_numpy(jv)))
    np.testing.assert_array_equal(ids, np.asarray(jids))


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name,extra,floor",
    [
        ("MHCN", {}, 0.5),
        ("SEPT", {}, 0.5),
        ("BUIR", {"learnRate": "-init 0.01 -max 1", "num.max.epoch": "40"}, 0.35),
        ("DiffNet", {"graph.aux.dense": "on"}, 0.5),
        ("DHCF", {}, 0.5),
    ],
)
def test_qrec_learns_planted_blocks_on_cpu(tmp_path, capsys, name, extra, floor):
    """The floors of the JAX package's tests/test_social_graph_models.py,
    with the result files written."""
    ratings, trust = _lines(tmp_path)
    conf = _conf(name, {"num.factors": "16", "num.max.epoch": "30",
                        "learnRate": "-init 0.05 -max 1",
                        "output.setup": f"on -dir {tmp_path / 'out'}/", **extra},
                 ratings=ratings, trust=trust)
    if name in ("BUIR", "DHCF"):
        del conf["social"]  # they take no relation
    rec = QRec(ModelConf(conf), seed=3, device="cpu")
    parsed = metrics.parse_measure(rec.execute())["Top 10"]
    assert parsed["Recall"] > floor, parsed
    files = sorted(p.name.split("@")[0] + p.name.split(" ")[-1][-12:]
                   for p in (tmp_path / "out").iterdir())
    assert len(files) == 2 and all(f.startswith(name) for f in files), files
    # the joint adjacency only where the model propagates over it
    assert ("Graph backend" in capsys.readouterr().out) == (name in ("SEPT", "BUIR"))
