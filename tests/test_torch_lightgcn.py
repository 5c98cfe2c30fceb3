"""The LightGCN train-and-rank slice of the PyTorch port against the JAX
package: propagation and its gradient, two epochs on injected batches, the
full-catalog ranker and its measures; plus the port's own end-to-end run,
its config guards and its import boundary."""

import ast
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.split import data_split
from qrec_tpu.models.graph import LightGCN as JLightGCN
from qrec_tpu.ops import metrics as jmetrics
from qrec_tpu.ops import spmm as jspmm
from qrec_tpu.ops.topk import CatalogRanker as JRanker, embedding_score_fn
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.__main__ import main as cli_main
from qrec_tpu_torch.convert import lightgcn_params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.errors import ConfigError, DeviceUnavailableError
from qrec_tpu_torch.models.graph import LightGCN
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops.sampling import pack_bitmask
from qrec_tpu_torch.ops.spmm import DenseJoint, lightgcn_propagate
from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreForm

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _conf(extra=None):
    base = {
        "ratings": "unused",
        "ratings.setup": "-columns 0 1 2",
        "model.name": "LightGCN",
        "evaluation.setup": "-ap 0.2",
        "item.ranking": "on -topN 5",
        "num.factors": "8",
        "num.max.epoch": "2",
        "batch_size": "16",
        "learnRate": "-init 0.001 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.2 -s 0.2",
        "LightGCN": "-n_layer 2",
        "graph.dense.quant": "factored",
        "output.setup": "off -dir ./results/",
        "seed": "11",
    }
    base.update(extra or {})
    return base


def _split(users=14, items=24, per_user=7, unseen=()):
    rng = np.random.RandomState(5)
    records = [
        [f"u{u}", f"i{i}", 1.0]
        for u in range(users)
        for i in rng.choice(items, size=per_user, replace=False)
    ]
    train, test = data_split(records, 0.25, rng=random.Random(2))
    return train, test + [list(r) for r in unseen]


def _both(extra=None, **split_kw):
    train, test = _split(**split_kw)
    jd = JInteractions(jconfig.ModelConf(_conf(extra)), train, test)
    td = Interactions(ModelConf(_conf(extra)), train, test)
    return jd, td


def test_propagation_and_gradient_match_jax(tiny_data):
    jadj = jspmm.DenseJoint.from_interactions(tiny_data, quant="factored")
    tadj = DenseJoint.from_interactions(tiny_data, "cpu")
    n = tadj.num_rows
    rng = np.random.RandomState(1)
    e = rng.randn(n, 8).astype(np.float32)
    w = rng.randn(n, 8).astype(np.float32)

    def jloss(x):
        return jnp.sum(jnp.asarray(w) * jspmm.lightgcn_propagate(jadj, x, 2))

    jout = jspmm.lightgcn_propagate(jadj, jnp.asarray(e), 2)
    jgrad = jax.grad(jloss)(jnp.asarray(e))
    x = torch.from_numpy(e).requires_grad_(True)
    out = lightgcn_propagate(tadj, x, 2)
    (out * torch.from_numpy(w)).sum().backward()
    # bf16-rounded layer inputs: the bound of the dual-vs-XLA JAX test
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=5e-3, atol=5e-3)


def test_two_epochs_on_injected_batches_match_jax():
    jd, td = _both()
    jmodel = JLightGCN(jconfig.ModelConf(_conf()), jd)
    spec = jmodel.build()
    run_epoch = jtrainer.make_epoch_runner(spec.loss_fn, optax.adam(jmodel.lrate))
    params = spec.params
    opt_state = optax.adam(jmodel.lrate).init(params)
    tmodel = LightGCN(ModelConf(_conf()), td, device="cpu")
    tmodel.load_state_dict(lightgcn_params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, "cpu"
    ))
    assert tmodel._auto_tries() == jmodel._auto_tries()

    rng = jax.random.PRNGKey(0)
    batches, jlosses = [], []
    for _ in range(2):
        rng, rs, rt = jax.random.split(rng, 3)
        b = spec.sampler(rs)
        batches.append(tuple(np.asarray(a) for a in b))
        params, opt_state, loss = run_epoch(params, opt_state, b, rt, spec.consts)
        jlosses.append(float(loss))
    losses = tmodel.fit(epoch_batches=batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    np.testing.assert_allclose(tmodel.user_emb.detach().numpy(), np.asarray(params["user_emb"]), atol=1e-4)
    np.testing.assert_allclose(tmodel.item_emb.detach().numpy(), np.asarray(params["item_emb"]), atol=1e-4)
    # finalize leaves the propagated factors for the ranker
    assert tmodel.U.shape == (td.num_users, 8) and tmodel.V.shape == (td.num_items, 8)


def _rec_list(data, ids, scores):
    return {
        user: [(data.id2item[int(i)], float(s)) for i, s in zip(ids[b], scores[b])]
        for b, user in enumerate(data.test_eval_arrays()["names"])
    }


def test_ranker_matches_jax_topk_and_measures():
    unseen = [["ghost1", "i3", 1.0], ["ghost2", "i5", 1.0], ["ghost2", "i9", 1.0]]
    jd, td = _both(unseen=unseen)
    k = 5
    rng = np.random.RandomState(3)
    user_emb = rng.randn(jd.num_users, 8).astype(np.float32)
    item_emb = rng.randn(jd.num_items, 8).astype(np.float32)
    jids, jscores = JRanker(jd, k=k).topk(
        embedding_score_fn, {"user_emb": jnp.asarray(user_emb), "item_emb": jnp.asarray(item_emb)}
    )
    bitmask = torch.from_numpy(pack_bitmask(td.u_indptr, td.u_indices, td.num_users, td.num_items))
    ranker = CatalogRanker(td, k=k, device="cpu", bitmask=bitmask, batch_size=4)  # several batches
    tids, tscores = ranker.topk(ScoreForm(torch.from_numpy(user_emb), torch.from_numpy(item_emb)))
    assert tids.shape == jids.shape
    # rows whose top k+1 scores hold a near-tie (within 1e-6) may order it
    # either way; exact ties (masked zeros, unseen users' global mean) may not
    full = user_emb @ item_emb.T
    for b, uid in enumerate(ranker.uids):
        if uid >= 0:
            s = np.sort(np.where(
                np.isin(np.arange(td.num_items), td.user_row_ids(uid)), 0.0, full[uid]
            ))[::-1][: k + 1]
            gaps = -np.diff(s)
            if ((gaps > 0) & (gaps < 1e-6)).any():
                continue
        np.testing.assert_array_equal(tids[b], jids[b])
    unseen_rows = ranker.uids < 0
    assert unseen_rows.sum() == 2
    np.testing.assert_array_equal(tids[unseen_rows], np.tile(np.arange(k), (2, 1)))
    np.testing.assert_allclose(tscores, jscores, rtol=1e-6, atol=1e-6)
    top = [3, 5]
    assert metrics.ranking_measure(td.test_set_u, _rec_list(td, tids, tscores), top) == (
        jmetrics.ranking_measure(jd.test_set_u, _rec_list(jd, jids, jscores), top)
    )


def _planted(tmp_path):
    rng = np.random.RandomState(0)
    lines = []
    for u in range(40):
        block = 0 if u < 20 else 1
        for i in rng.choice(15, size=10, replace=False) + block * 15:
            lines.append(f"u{u} i{i} 1\n")
    path = tmp_path / "ratings.txt"
    path.write_text("".join(lines))
    return {
        "ratings": str(path),
        "ratings.setup": "-columns 0 1 2",
        "model.name": "LightGCN",
        "evaluation.setup": "-ap 0.2",
        "item.ranking": "on -topN 10",
        "num.factors": "16",
        "num.max.epoch": "30",
        "batch_size": "64",
        "learnRate": "-init 0.05 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1",
        "LightGCN": "-n_layer 2",
        "output.setup": f"on -dir {tmp_path / 'results'}/",
        "seed": "7",
    }


def test_qrec_learns_planted_blocks_on_cpu(tmp_path):
    rec = QRec(ModelConf(_planted(tmp_path)), seed=3, device="cpu")
    parsed = metrics.parse_measure(rec.execute())
    # random recall@10 over 30 items is about 0.33
    assert parsed["Top 10"]["Recall"] > 0.5, parsed
    files = sorted(p.name for p in (tmp_path / "results").iterdir())
    assert any("-top-10items[1].txt" in f for f in files)
    assert any("-measure[1].txt" in f for f in files)
    assert len(rec.model.epoch_losses) == 30


def test_cli_runs_on_cpu(tmp_path, capsys):
    conf = _planted(tmp_path)
    conf["num.max.epoch"] = "2"
    path = tmp_path / "run.conf"
    path.write_text("".join(f"{k}={v}\n" for k, v in conf.items()))
    cli_main([str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "LightGCN [1] epoch 2:" in out and "NDCG:" in out


def test_qrec_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(DeviceUnavailableError):
        QRec(ModelConf(_planted(tmp_path)))


@pytest.mark.parametrize(
    "extra",
    [
        {"parallel.setup": "on"},
        {"parallel.setup": "on -model 2"},
        {"checkpoint.setup": "on -dir ckpt"},
        {"model.setup": "-load model.npz"},
        {"model.setup": "-save model.npz"},
        {"model.setup": "off -save model.npz"},  # -save asks, whatever the switch
        # the adjacency forms are ported: what they come with is still refused
        {"graph.backend": "coo", "checkpoint.setup": "on -dir ckpt"},
        {"graph.backend": "pallas", "parallel.setup": "on"},  # the sharded segment kernel
        {"graph.dense.quant": "int8", "model.setup": "-save model.npz"},
        {"graph.dense.quant": "off", "parallel.setup": "on"},
    ],
)
def test_unported_settings_raise(tmp_path, monkeypatch, extra):
    """``parallel.setup`` (ROADMAP item 19) still raises; ``checkpoint.setup``
    and ``model.setup`` are ported and the same configs run: the checkpoint
    of epoch 10 (``-every``'s default) appears, ``-save`` writes its file,
    ``-load`` ranks the saved model as the run that saved it did."""
    monkeypatch.chdir(tmp_path)  # the relative ckpt and model.npz paths
    conf = _planted(tmp_path)
    conf["num.max.epoch"] = "10" if "checkpoint.setup" in extra else "2"
    conf.update(extra)
    if "parallel.setup" in extra:
        with pytest.raises(ConfigError, match="ROADMAP.md Queue 1 item 19"):
            QRec(ModelConf(conf), device="cpu")
        return
    setup = extra.get("model.setup", "")
    if "-load" in setup:
        saved = dict(conf, **{"model.setup": setup.replace("-load", "-save")})
        want = QRec(ModelConf(saved), device="cpu").execute()
        assert (tmp_path / "model.npz").exists()
    rec = QRec(ModelConf(conf), device="cpu")
    measure = rec.execute()
    assert metrics.parse_measure(measure)["Top 10"]["Recall"] >= 0
    if "-load" in setup:
        assert measure == want and rec.model.timer is None
    if "-save" in setup:
        assert (tmp_path / "model.npz").exists()
    if "checkpoint.setup" in extra:
        assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_10.pt"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_never_imports_jax():
    files = (sorted((REPO / "qrec_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted(REPO.glob("k*_p*.py")))
    assert len(files) > 15
    # the social, ALS, classical and walk slices' modules are among them
    scanned = {str(p.relative_to(REPO)) for p in files}
    assert {"qrec_tpu_torch/models/social_graph.py", "qrec_tpu_torch/data/social.py",
            "qrec_tpu_torch/io.py", "qrec_tpu_torch/ops/spmm.py",
            "qrec_tpu_torch/models/social_mf.py", "qrec_tpu_torch/models/social_ranking.py",
            "qrec_tpu_torch/models/adversarial_social.py",
            "qrec_tpu_torch/ops/similarity.py", "qrec_tpu_torch/ops/als.py",
            "qrec_tpu_torch/models/als.py", "qrec_tpu_torch/models/classical.py",
            "qrec_tpu_torch/ops/walks.py", "qrec_tpu_torch/models/walk.py",
            "qrec_tpu_torch/models/ifbpr.py", "qrec_tpu_torch/native.py",
            "qrec_tpu_torch/runtime/checkpoint.py", "qrec_tpu_torch/runtime/profiling.py"} <= scanned
    # networkx and orbax: the card's machine lacks them (LOCABAL's PageRank
    # and the checkpoints are the port's own); qrec_tpu: the host library
    # is the port's own source, not qrec_tpu.native
    banned = {"jax", "jaxlib", "optax", "flax", "qrec_tpu", "networkx", "orbax"}
    for path in files:
        bad = banned & set(_imported_roots(path))
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
