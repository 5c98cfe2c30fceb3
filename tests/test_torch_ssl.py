"""The graph-SSL slice of the PyTorch port (SimGCL, SGL) against the JAX
package: the batch dedup, the pair hash and SGL's views on injected random
bits, the device-side ranking metrics, the best-epoch vote, one step's loss
and gradients and two epochs of each model on injected batches and noise;
plus the port's own end-to-end runs on planted blocks and its config
guards."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.split import data_split
from qrec_tpu.models.graph import SGL as JSGL, SimGCL as JSimGCL
from qrec_tpu.ops import losses as jlosses
from qrec_tpu.ops import metrics as jmetrics
from qrec_tpu.ops import spmm as jspmm
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import embedding_params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.errors import ConfigError, ModelNotFoundError
from qrec_tpu_torch.models.graph import SGL, SimGCL
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops.losses import unique_padded
from qrec_tpu_torch.ops.spmm import (
    DenseJoint,
    factored_edge_drop_view,
    factored_node_drop_view,
    pair_hash_keep,
)
from qrec_tpu_torch.runtime.trainer import BestTracker

MODEL_ARGS = {
    "SimGCL": "-n_layer 2 -lambda 0.1 -eps 0.1",
    "SGL": "-n_layer 2 -lambda 0.02 -droprate 0.5 -augtype 1 -temp 0.2",
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _conf(name, args=None, extra=None):
    base = {
        "ratings": "unused",
        "ratings.setup": "-columns 0 1 2",
        "model.name": name,
        "evaluation.setup": "-ap 0.2",
        "item.ranking": "on -topN 5",
        "num.factors": "8",
        "num.max.epoch": "2",
        "batch_size": "16",
        "learnRate": "-init 0.001 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.2 -s 0.2",
        name: args or MODEL_ARGS[name],
        "graph.dense.quant": "factored",
        "output.setup": "off -dir ./results/",
        "seed": "11",
    }
    base.update(extra or {})
    return base


def _both(conf):
    rng = np.random.RandomState(5)
    records = [
        [f"u{u}", f"i{i}", 1.0] for u in range(14) for i in rng.choice(24, size=7, replace=False)
    ]
    train, test = data_split(records, 0.25, rng=random.Random(2))
    return JInteractions(jconfig.ModelConf(conf), train, test), Interactions(ModelConf(conf), train, test)


def _bits(key, n):
    """uint32 draws of ``jax.random.bits`` as the port's int64 hash inputs."""
    return torch.from_numpy(np.asarray(jax.random.bits(key, (n,), dtype=jnp.uint32)).astype(np.int64))


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "ids",
    [[5, 3, 5, 0, 9, 3, 3, 1], [4, 4, 4, 4], [7], [2, 9, 0, 13, 6], [0, 0, 3, 0, 0, 0]],
)
def test_unique_padded_matches_jax(ids):
    ids = np.asarray(ids)
    want, want_mask = jlosses.unique_padded(jnp.asarray(ids, jnp.int32))
    got, mask = unique_padded(torch.from_numpy(ids).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert mask.dtype == torch.float32


@pytest.mark.parametrize("drop_rate", [0.0, 0.2, 0.5, 1.0])
def test_pair_hash_keep_matches_jax(drop_rate):
    ru = jax.random.bits(jax.random.PRNGKey(1), (37,), dtype=jnp.uint32)
    ci = jax.random.bits(jax.random.PRNGKey(2), (53,), dtype=jnp.uint32)
    want = np.asarray(jspmm._pair_hash_keep(ru, ci, drop_rate))
    tru = torch.from_numpy(np.asarray(ru).astype(np.int64))
    tci = torch.from_numpy(np.asarray(ci).astype(np.int64))
    np.testing.assert_array_equal(pair_hash_keep(tru[:, None], tci[None, :], drop_rate).numpy(), want)


def _binary_r(u=23, i=41, seed=3):
    rb = (np.random.RandomState(seed).rand(u, i) < 0.2).astype(np.int8)
    rb[0] = 0  # a user without edges
    adj = DenseJoint(torch.from_numpy(rb), torch.ones(u), torch.ones(i))
    return rb, adj


# XLA's CPU rsqrt is within 2 ulp of the correctly rounded value, not on
# it, so the renormalized scales agree to 2 ulp; the tables exactly
SCALE_RTOL = 3e-7


@pytest.mark.parametrize("drop_rate", [0.2, 0.5])
def test_edge_drop_view_matches_jax(drop_rate):
    rb, adj = _binary_r()
    rng = jax.random.PRNGKey(7)
    q8v, q8v_t, su, si = jspmm.factored_edge_drop_view(rng, jnp.asarray(rb), jnp.asarray(rb.T), drop_rate)
    ku, ki = jax.random.split(rng)
    edges = torch.nonzero(adj.r, as_tuple=True)
    view = factored_edge_drop_view(adj, edges, _bits(ku, rb.shape[0]), _bits(ki, rb.shape[1]), drop_rate)
    np.testing.assert_array_equal(view.r.numpy(), np.asarray(q8v))
    np.testing.assert_array_equal(view.r.numpy().T, np.asarray(q8v_t))
    np.testing.assert_allclose(view.row_scale.numpy(), np.asarray(su), rtol=SCALE_RTOL, atol=0)
    np.testing.assert_allclose(view.col_scale.numpy(), np.asarray(si), rtol=SCALE_RTOL, atol=0)
    assert 0 < view.r.sum() < adj.r.sum()


def test_node_drop_view_matches_jax():
    rb, adj = _binary_r(seed=4)
    rng = jax.random.PRNGKey(8)
    q8, q8_t, su, si = jspmm.factored_node_drop_view(rng, jnp.asarray(rb), jnp.asarray(rb.T), 0.3)
    ku = np.array(jax.random.bernoulli(rng, 0.7, (rb.shape[0],)))
    ki = np.array(jax.random.bernoulli(jax.random.fold_in(rng, 1), 0.7, (rb.shape[1],)))
    view = factored_node_drop_view(adj, torch.from_numpy(ku), torch.from_numpy(ki))
    assert view.r is adj.r  # R stays unmasked
    np.testing.assert_allclose(view.row_scale.numpy(), np.asarray(su), rtol=SCALE_RTOL, atol=0)
    np.testing.assert_allclose(view.col_scale.numpy(), np.asarray(si), rtol=SCALE_RTOL, atol=0)
    assert (view.row_scale.numpy()[~ku] == 0).all()


def test_device_ranking_metrics_match_jax():
    rng = np.random.RandomState(0)
    b, n, items = 30, 10, 50
    pred = np.stack([rng.choice(items, size=n, replace=False) for _ in range(b)]).astype(np.int32)
    counts = rng.randint(1, 8, size=b).astype(np.int32)
    test_ids = np.full((b, 7), -1, np.int32)
    for r in range(b):
        test_ids[r, : counts[r]] = rng.choice(items, size=counts[r], replace=False)
    test_ids[3, 0] = -1  # an unseen test item still counts in |test|
    top = [3, 10]
    want = jmetrics.device_ranking_metrics(
        jnp.asarray(pred), jnp.asarray(test_ids), jnp.asarray(counts), top
    )
    got = metrics.device_ranking_metrics(
        torch.from_numpy(pred).long(), torch.from_numpy(test_ids).long(),
        torch.from_numpy(counts).long(), top,
    )
    for k in top:
        assert list(got[k]) == ["Precision", "Recall", "F1", "NDCG"]
        for name, value in got[k].items():
            assert value.dtype == torch.float32 and value.shape == ()
            np.testing.assert_allclose(float(value), float(want[k][name]), rtol=1e-6, err_msg=name)


def test_best_tracker_vote_matches_jax():
    rng = np.random.RandomState(1)
    keys = ("Precision", "Recall", "F1", "NDCG")
    seq = [dict(zip(keys, rng.rand(4).round(2))) for _ in range(12)]
    seq += [dict(seq[4]), {k: 0.0 for k in keys}, {k: 1.0 for k in keys}]  # a tie, a loss, a win
    ours, theirs = BestTracker(), jtrainer.BestTracker()
    for epoch, m in enumerate(seq):
        assert ours.update(epoch, m) == theirs.update(epoch, m)
        assert ours.best_epoch == theirs.best_epoch
        assert ours.best_metrics == theirs.best_metrics
    assert ours.best_epoch == len(seq)


# ---------------------------------------------------------------------------
# models against the JAX package
# ---------------------------------------------------------------------------


def _simgcl_draws(step_rng, n_layers, shape):
    """SimGCL's noise of one step as the JAX loss draws it: view a from ra,
    view b from rb, layer k from ``fold_in(·, k)``."""
    ra, rb = jax.random.split(step_rng)
    return [
        tuple(torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(r, k), shape)))
              for r in (ra, rb))
        for k in range(n_layers)
    ]


def _sgl_view(r, aug, n_layers, drop_rate, u, i):
    if aug == 0:
        ku = jax.random.bernoulli(r, 1.0 - drop_rate, (u,))
        ki = jax.random.bernoulli(jax.random.fold_in(r, 1), 1.0 - drop_rate, (i,))
        return [(torch.from_numpy(np.array(ku)), torch.from_numpy(np.array(ki)))]
    keys = [jax.random.fold_in(r, k) for k in range(n_layers)] if aug == 2 else [r]
    out = []
    for key in keys:
        k1, k2 = jax.random.split(key)
        out.append((_bits(k1, u), _bits(k2, i)))
    return out


def _sgl_draws(step_rng, model):
    r1, r2 = jax.random.split(step_rng)
    return tuple(
        _sgl_view(r, model.aug_type, model.n_layers, model.drop_rate, model.num_users, model.num_items)
        for r in (r1, r2)
    )


def _draws(model, step_rng):
    if isinstance(model, SimGCL):
        shape = (model.num_users + model.num_items, model.emb_size)
        return _simgcl_draws(step_rng, model.n_layers, shape)
    return _sgl_draws(step_rng, model)


def _models(name, args=None):
    conf = _conf(name, args)
    jd, td = _both(conf)
    jmodel = {"SimGCL": JSimGCL, "SGL": JSGL}[name](jconfig.ModelConf(conf), jd)
    spec = jmodel.build()
    tmodel = {"SimGCL": SimGCL, "SGL": SGL}[name](ModelConf(conf), td, device="cpu")
    tmodel.load_state_dict(embedding_params_from_jax(
        {k: np.asarray(v) for k, v in spec.params.items()}, "cpu"
    ))
    return jmodel, spec, tmodel


def _torch_batch(batch):
    u, i, j, w = (np.asarray(a) for a in batch)
    idx = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    return idx(u), idx(i), idx(j), torch.from_numpy(w.astype(np.float32))


# SimGCL propagates through the main adjacency only, whose scales both
# packages compute in numpy: f32 summation order around the InfoNCE
# kernels' plain versions. SGL's views renormalize on the device, where the
# scales differ by up to 2 ulp (SCALE_RTOL); that can flip the bf16
# rounding of a scaled layer input, so its gradients are held to the bound
# of the JAX package's dual-vs-XLA propagation test
TIGHT, BF16_FLIP = (1e-4, 1e-6), (5e-3, 5e-3)


@pytest.mark.parametrize(
    "name,args,grad_tol",
    [
        ("SimGCL", None, TIGHT),
        ("SimGCL", "-n_layer 2 -lambda 0.1 -eps 0", TIGHT),
        ("SGL", None, BF16_FLIP),
        ("SGL", "-n_layer 2 -lambda 0.02 -droprate 0.5 -augtype 0 -temp 0.2", BF16_FLIP),
        ("SGL", "-n_layer 2 -lambda 0.02 -droprate 0.5 -augtype 2 -temp 0.2", BF16_FLIP),
    ],
    ids=["SimGCL", "SimGCL-eps0", "SGL-aug1", "SGL-aug0", "SGL-aug2"],
)
def test_one_step_loss_and_grads_match_jax(name, args, grad_tol):
    jmodel, spec, tmodel = _models(name, args)
    batch = jax.tree_util.tree_map(lambda x: x[0], spec.sampler(jax.random.PRNGKey(0)))
    step_rng = jax.random.PRNGKey(5)
    want, grads = jax.value_and_grad(spec.loss_fn)(spec.params, batch, step_rng, spec.consts)
    draws = _draws(tmodel, step_rng)
    loss = tmodel.step_loss(_torch_batch(batch), draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    rtol, atol = grad_tol
    for pname in ("user_emb", "item_emb"):
        np.testing.assert_allclose(
            getattr(tmodel, pname).grad.numpy(), np.asarray(grads[pname]), rtol=rtol, atol=atol,
            err_msg=pname,
        )
    if name == "SimGCL" and tmodel.eps == 0:
        with torch.no_grad():
            (users, items), *perturbed = tmodel.encode_all(draws)
        for pu, pi in perturbed:
            torch.testing.assert_close(pu, users, rtol=0, atol=1e-7)
            torch.testing.assert_close(pi, items, rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", ["SimGCL", "SGL"])
def test_two_epochs_on_injected_batches_match_jax(name):
    jmodel, spec, tmodel = _models(name)
    optimizer = optax.adam(jmodel.lrate)
    run_epoch = jtrainer.make_epoch_runner(spec.loss_fn, optimizer)
    params, opt_state = spec.params, optimizer.init(spec.params)
    rng = jax.random.PRNGKey(0)
    batches, jlosses_, jparams, draws = [], [], [], []
    for _ in range(2):
        rng, rs, rt = jax.random.split(rng, 3)
        b = spec.sampler(rs)
        batches.append(tuple(np.asarray(a) for a in b))
        draws += [_draws(tmodel, r) for r in jax.random.split(rt, b[0].shape[0])]
        params, opt_state, loss = run_epoch(params, opt_state, b, rt, spec.consts)
        jlosses_.append(float(loss))
        jparams.append(params)
    stream = iter(draws)
    tmodel.draw = lambda gen: next(stream)
    losses = tmodel.fit(epoch_batches=batches)
    assert next(stream, None) is None  # one draw per step
    np.testing.assert_allclose(losses, jlosses_, rtol=1e-3)
    # fit restores the epoch that won the vote
    best = jparams[tmodel.tracker.best_epoch - 1]
    np.testing.assert_allclose(tmodel.user_emb.detach().numpy(), np.asarray(best["user_emb"]), atol=1e-4)
    np.testing.assert_allclose(tmodel.item_emb.detach().numpy(), np.asarray(best["item_emb"]), atol=1e-4)
    assert tmodel.U.shape == (tmodel.num_users, 8) and tmodel.V.shape == (tmodel.num_items, 8)


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------


def _planted(tmp_path, name, args, epochs):
    rng = np.random.RandomState(0)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(
        f"u{u} i{i} 1\n"
        for u in range(40)
        for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)
    ))
    return {
        "ratings": str(path), "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10", "num.factors": "16",
        "num.max.epoch": str(epochs), "batch_size": "64", "learnRate": "-init 0.05 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1", name: args,
        "output.setup": "off -dir ./results/", "seed": "7",
    }


@pytest.mark.parametrize(
    "name,args,epochs,seed,floor",
    [
        ("SimGCL", "-n_layer 2 -lambda 0.05 -eps 0.1", 30, 3, 0.5),
        ("SGL", "-n_layer 2 -lambda 0.05 -droprate 0.2 -augtype 1 -temp 0.2", 30, 3, 0.5),
        ("SGL", "-n_layer 2 -lambda 0.02 -droprate 0.2 -augtype 0 -temp 0.2", 10, 1, 0.3),
        ("SGL", "-n_layer 2 -lambda 0.02 -droprate 0.2 -augtype 2 -temp 0.2", 10, 1, 0.3),
    ],
    ids=["SimGCL", "SGL-aug1", "SGL-aug0", "SGL-aug2"],
)
def test_qrec_learns_planted_blocks_on_cpu(tmp_path, capsys, name, args, epochs, seed, floor):
    rec = QRec(ModelConf(_planted(tmp_path, name, args, epochs)), seed=seed, device="cpu")
    parsed = metrics.parse_measure(rec.execute())["Top 10"]
    # the floors of tests/test_graph_models.py; random recall@10 over 30
    # items is about 0.33
    assert parsed["Recall"] > floor, parsed
    out = capsys.readouterr().out
    assert f"{name} [1] epoch {epochs}: loss = " in out and " Recall:" in out
    best = rec.model.tracker
    assert f"{name} [1] best epoch {best.best_epoch}: Precision:" in out
    # the final ranking is the best epoch's: the same measures
    for key, value in best.best_metrics.items():
        assert abs(parsed[key] - value) < 1e-5, (key, parsed, best.best_metrics)


def test_ssl_backend_is_checked_and_selects_nothing(tmp_path):
    conf = _planted(tmp_path, "SimGCL", "-n_layer 2 -lambda 0.05 -eps 0.1", 2)
    losses = []
    for backend in ("auto", "xla", "pallas"):
        rec = QRec(ModelConf({**conf, "ssl.backend": backend}), seed=3, device="cpu")
        rec.execute()
        losses.append(rec.model.epoch_losses)
    assert losses[0] == losses[1] == losses[2]
    with pytest.raises(ConfigError, match="ssl.backend"):
        QRec(ModelConf({**conf, "ssl.backend": "triton"}), device="cpu").execute()


@pytest.mark.parametrize("backend", ["coo", "pallas"])
def test_sgl_sparse_views_name_the_roadmap(tmp_path, backend):
    """Under ``coo`` (``DeviceCOO``, ported since the social slice) and
    ``pallas`` SGL trains on the sparse adjacency with per-edge views of
    that form."""
    from qrec_tpu_torch.ops.spmm import DeviceCOO, SparseJoint

    conf = _planted(tmp_path, "SGL", MODEL_ARGS["SGL"], 2)
    rec = QRec(ModelConf({**conf, "graph.backend": backend}), seed=3, device="cpu")
    rec.execute()
    assert not rec.model.dense_views and len(rec.model.epoch_losses) == 2
    form = DeviceCOO if backend == "coo" else SparseJoint
    assert isinstance(rec.model.joint_adj, form)
    assert isinstance(rec.model.view_structure[0], form)


def test_registry_holds_every_jax_model_and_refuses_unknown_names(tmp_path):
    """Every name the JAX package registers runs on the port; an unknown
    name raises ``ModelNotFoundError`` with the JAX package's message."""
    from qrec_tpu.models import available_models
    from qrec_tpu_torch.models import MODELS, get_model

    assert set(available_models()) <= set(MODELS)
    assert all(get_model(name) is MODELS[name] for name in available_models())
    conf = _planted(tmp_path, "NoSuchModel", "", 2)
    with pytest.raises(ModelNotFoundError, match=r"unknown model 'NoSuchModel'; available: \['APR'"):
        QRec(ModelConf(conf), device="cpu").execute()
