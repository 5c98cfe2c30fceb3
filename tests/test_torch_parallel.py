"""Slice 7a of the port on the CPU: the process mesh and data-parallel
training. gloo groups of spawned ranks (``test_torch_parallel_ranks.py``,
three spawns) run K5's row blocks (route 4) and the row-sharded InfoNCE
(route 5) against the JAX package's ``ShardedPaddedCOO`` and
``sharded_infonce_loss`` in interpret mode on its 8-device virtual mesh,
and train LightGCN, SimGCL and BPR on four ranks against the port in one
process and the JAX package on one device.

Tolerances: the routes within the JAX mesh tests' own bounds (atol 1e-4
for the propagation, ``tests/test_parallel.py:366-461``; the InfoNCE loss
within rtol 1e-5 and its cotangents within rtol 1e-4 plus 1e-5 of the
largest entry: f32 sums in another order). Four ranks against one process:
the same f32 terms summed in another order (the shares over ``data``), so
losses within rtol 1e-5, tables within 1e-5 and first-step gradients within
rtol 1e-5 plus 1e-6 of the largest entry; against the JAX package, the
bounds of the one-device parity tests (tables 1e-4, losses rtol 1e-3)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import test_torch_parallel_ranks as R
from qrec_tpu import config as jconfig
from qrec_tpu.ops import spmm as jspmm_mod
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.graph import COO as JCOO
from qrec_tpu.data.split import data_split
from qrec_tpu.models.graph import NGCF as JNGCF, SGL as JSGL, LightGCN as JLightGCN, SimGCL as JSimGCL
from qrec_tpu.models.mf import BPR as JBPR
from qrec_tpu.ops.losses import infonce_dispatch as jinfonce
from qrec_tpu.ops.spmm import ShardedPaddedCOO, spmm as jspmm
from qrec_tpu.parallel.mesh import make_mesh as jmake_mesh
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops.kernels import weighted_segment_matmul
from qrec_tpu_torch.ops.losses import InfoNCELoss
from qrec_tpu_torch.ops.spmm import (
    DenseJoint,
    factored_edge_drop_view,
    factored_node_drop_view,
    segment_operand,
    spmm,
)
from qrec_tpu_torch.models import get_model
from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreForm
from qrec_tpu_torch.parallel import mesh as M
from test_torch_lightgcn import _conf as _lconf, _split
from test_torch_sparse import _draws as _sparse_slice_draws

WORLD = 4
MESH = "on -model 2"  # four ranks: data 2 x model 2
# bf16-rounded layer inputs: the bound of the dual-vs-XLA JAX test
BF16 = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _same_on_every_rank(values):
    for v in values[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(values[0]), jax.tree_util.tree_leaves(v)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_shapes_match_jax():
    """``mesh_shape`` against the JAX package's ``make_mesh`` on its virtual
    devices, and the error on a model axis that does not divide."""
    for n, model in ((8, None), (1, None), (4, 4), (4, None), (3, None), (6, 3), (2, None)):
        assert M.mesh_shape(n, model) == dict(jmake_mesh(n, model_parallel=model).shape), (n, model)
    with pytest.raises(ValueError, match="not divisible"):
        jmake_mesh(6, model_parallel=4)
    with pytest.raises(ValueError, match="not divisible"):
        M.mesh_shape(6, 4)


def test_maybe_initialize_distributed_env_gated(monkeypatch):
    """The group starts only with the QREC_* triplet or torchrun's, passes it
    through (gloo on the CPU) and starts once (``init_process_group`` is
    stubbed, as ``tests/test_parallel.py`` stubs ``jax.distributed``)."""
    for key in ("QREC_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert M.maybe_initialize_distributed(None, "cpu") is False
    calls = []

    def init(**kw):
        calls.append(kw)
        monkeypatch.setattr(M.dist, "is_initialized", lambda: True)

    monkeypatch.setattr(M.dist, "init_process_group", init)
    monkeypatch.setenv("QREC_COORDINATOR", "host0:8476")
    monkeypatch.setenv("QREC_NUM_PROCESSES", "2")
    monkeypatch.setenv("QREC_PROCESS_ID", "1")
    assert M.maybe_initialize_distributed(None, "cpu") is True
    assert calls == [{"backend": "gloo", "init_method": "tcp://host0:8476", "world_size": 2,
                      "rank": 1}]
    # idempotent: the second call joins nothing
    assert M.maybe_initialize_distributed(None, "cpu") is True and len(calls) == 1
    monkeypatch.setattr(M.dist, "is_initialized", lambda: False)
    monkeypatch.delenv("QREC_COORDINATOR")
    for key, value in (("MASTER_ADDR", "localhost"), ("WORLD_SIZE", "4"), ("RANK", "3")):
        monkeypatch.setenv(key, value)
    assert M.maybe_initialize_distributed(None, "cpu") is True
    assert calls[1] == {"backend": "gloo", "init_method": "env://"}


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl"), ("cuda:1", "nccl")])
def test_backend_follows_the_device(device, backend):
    """NCCL for a CUDA device and gloo for the CPU, nothing else."""
    assert M.backend_for(device) == backend


# ---------------------------------------------------------------------------
# K5's row shard (the ``rows=`` keyword) on its plain twin
# ---------------------------------------------------------------------------


def _random_symmetric_coo(n_nodes=64, n_edges=260, seed=11):
    """``tests/test_parallel.py``'s symmetric, row-sorted test matrix."""
    rng = np.random.RandomState(seed)
    r = rng.randint(0, n_nodes, n_edges)
    c = rng.randint(0, n_nodes, n_edges)
    keep = r != c
    r, c = r[keep], c[keep]
    v = rng.rand(len(r)).astype(np.float32)
    m = sp.csr_matrix((np.concatenate([v, v]), (np.concatenate([r, c]), np.concatenate([c, r]))),
                      shape=(n_nodes, n_nodes)).tocoo()
    order = np.lexsort((m.col, m.row))
    return (m.row[order].astype(np.int32), m.col[order].astype(np.int32),
            m.data[order].astype(np.float32), n_nodes)


@pytest.mark.parametrize("r0,r1", [(0, 1), (0, 32), (32, 64), (17, 40), (63, 64)])
def test_segment_row_shard_equals_the_whole_products_rows(r0, r1):
    """``weighted_segment_matmul(..., rows=)`` on a block of rows of a CSR,
    gathering from the whole x, gives those rows of the whole product bit
    for bit."""
    rows, cols, vals, n = _random_symmetric_coo()
    indptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)
    x = segment_operand(torch.from_numpy(np.random.RandomState(2).randn(n, 15).astype(np.float32)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    whole = weighted_segment_matmul(x, t(indptr), t(cols), t(vals))
    e0, e1 = indptr[r0], indptr[r1]
    block = weighted_segment_matmul(x, t(indptr[r0: r1 + 1] - e0), t(cols[e0:e1]),
                                    t(vals[e0:e1]), rows=r1 - r0)
    assert block.shape == (r1 - r0, 15)
    torch.testing.assert_close(block, whole[r0:r1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        weighted_segment_matmul(x, t(indptr[r0: r1 + 1] - e0), t(cols[e0:e1]), t(vals[e0:e1]),
                                rows=r1 - r0 + 1)


# ---------------------------------------------------------------------------
# routes 4 and 5: one spawn of four ranks (data 2 x model 2)
# ---------------------------------------------------------------------------

# InfoNCE rows: at B=64 the JAX package pads nothing (32 rows a shard); at
# B=63 its infonce_dispatch pads one row with mask 0 (32 + 32), the port
# cuts 32 + 31
INFONCE_B = (64, 63)


def _dense_data():
    """Route 6's graph (24 users, the items they rate in training) and the
    ranking's split, with two test users unseen in training; the JAX
    package's and the port's ``Interactions`` of it."""
    unseen = [["new1", "i3", 1.0], ["new2", "i5", 1.0]]
    train, test = _split(users=24, items=34, per_user=8, unseen=unseen)
    conf = _lconf()
    return (train, test, conf, JInteractions(jconfig.ModelConf(conf), train, test),
            Interactions(ModelConf(conf), train, test))


DENSE_FORMS = ("factored", "off", "int8")


def _dense_inputs():
    """Route 6 in each dense form as the port builds it (R unpadded; the
    bf16 table as its f32 values, numpy having no bf16), the
    views' draws on the factored form, and the ranking's plain and biased
    score forms (K2 in batches of 4 users)."""
    rng = np.random.RandomState(8)
    train, test, conf, _, td = _dense_data()
    n, u, i = td.num_users + td.num_items, td.num_users, td.num_items
    forms = {}
    for form in DENSE_FORMS:
        adj = DenseJoint.from_interactions(td, "cpu", form)
        r = adj.r[:, :i]
        forms[form] = tuple(t.numpy().copy() for t in (
            r.float() if r.dtype == torch.bfloat16 else r, adj.row_scale, adj.col_scale))
    r, su, si = forms["factored"]
    views = {"r": r, "su": su, "si": si, "p": 0.4,
             "ru": rng.randint(0, 2**32, u, dtype=np.uint64).astype(np.int64),
             "ci": rng.randint(0, 2**32, i, dtype=np.uint64).astype(np.int64),
             "keep_u": rng.rand(u) < 0.6, "keep_i": rng.rand(i) < 0.6}
    d = 6
    plain = (rng.randn(u, d).astype(np.float32), rng.randn(i, d).astype(np.float32))
    biased = plain + (rng.randn(i).astype(np.float32), rng.randn(u).astype(np.float32), 0.25)
    ranking = {"conf": conf, "train": train, "test": test, "k": 5, "batch": 4,
               "forms": {"plain": plain, "biased": biased}}
    return {"n": n, "forms": forms, "views": views, "ranking": ranking,
            "x": [rng.randn(n, w).astype(np.float32) for w in (16, 15)],
            "w": [rng.randn(n, w).astype(np.float32) for w in (16, 15)]}


def _route_inputs():
    rng = np.random.RandomState(6)
    rows, cols, vals, n = _random_symmetric_coo()
    graph = {"rows": rows, "cols": cols, "vals": vals, "n": n,
             "x": [rng.randn(n, w).astype(np.float32) for w in (16, 15)],
             "w": [rng.randn(n, w).astype(np.float32) for w in (16, 15)],
             "vals2": rng.rand(len(rows)).astype(np.float32)}
    infonce = {}
    for b in INFONCE_B:
        mask = np.ones(b, np.float32)
        mask[[5, 17, 40, b - 1]] = 0.0
        view1 = rng.randn(b, 16).astype(np.float32)
        view1[2] = 0.0  # a zero row
        infonce[b] = {"view1": view1, "view2": rng.randn(b, 16).astype(np.float32),
                      "mask": mask, "temp": 0.2}
    return {"graph": graph, "infonce": infonce, "dense": _dense_inputs()}


@pytest.fixture(scope="module")
def routes(tmp_path_factory):
    inputs = _route_inputs()
    return inputs, R.spawn(R.routes, WORLD, tmp_path_factory.mktemp("routes"), inputs)


@pytest.fixture(scope="module")
def jax_routes():
    """The JAX package's mesh routes on the same inputs, on its 8 virtual
    devices: ``ShardedPaddedCOO`` (data 2 x model 2, interpret mode) and
    ``infonce_dispatch`` with a mesh, which pads the rows to its tile and
    calls ``sharded_infonce_loss`` (interpret mode)."""
    inputs = _route_inputs()
    jmesh = jmake_mesh(4)
    g = inputs["graph"]
    sharded = ShardedPaddedCOO(jmesh, JCOO(g["rows"], g["cols"], g["vals"], (g["n"], g["n"])),
                               row_block=8, edge_tile=128, interpret=True)
    assert (sharded.n_shards, sharded.feat_shards) == (2, 2)
    vals2 = jnp.asarray(g["vals2"])
    graph = {}
    for x_np, w_np in zip(g["x"], g["w"]):
        x, w = jnp.asarray(x_np), jnp.asarray(w_np)
        gx = jax.grad(lambda a: jnp.sum(jspmm(sharded, a) * w)
                      + jnp.sum(jspmm(sharded, a, vals2) * w))(x)
        gv = jax.grad(lambda v: jnp.sum(jspmm(sharded, x, v) * w))(vals2)
        graph[x_np.shape[1]] = (jspmm(sharded, x), jspmm(sharded, x, vals2), gx, gv)
    infonce = {}
    for b, s in inputs["infonce"].items():
        def loss(a, c, s=s):
            return jinfonce(a, c, jnp.asarray(s["mask"]), s["temp"], backend="pallas",
                            interpret=True, mesh=jmesh)

        infonce[b] = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(s["view1"]),
                                                               jnp.asarray(s["view2"]))
    return jax.tree_util.tree_map(np.asarray, {"graph": graph, "infonce": infonce})


def test_ranks_sit_on_the_grid(routes):
    """Rank r at (r // 2, r % 2); the data ranks' row blocks tile the rows
    as ``torch.tensor_split`` cuts them, each with its own edges."""
    inputs, out = routes
    assert [o["shape"] for o in out] == [{"data": 2, "model": 2}] * WORLD
    assert [o["place"] for o in out] == [divmod(r, 2) for r in range(WORLD)]
    g = inputs["graph"]
    indptr = np.searchsorted(g["rows"], np.arange(g["n"] + 1))
    for o in out:
        r0, r1, e0, e1 = o["block"]
        assert (r0, r1) == ((0, 32) if o["place"][0] == 0 else (32, 64))
        assert (e0, e1) == (indptr[r0], indptr[r1])


@pytest.mark.parametrize("width", [16, 15])
def test_sharded_sparse_joint_matches_jax(routes, jax_routes, width):
    """Route 4 (rows over ``data``; features over ``model`` at width 16, the
    whole width at 15, which 2 does not divide) against ``ShardedPaddedCOO``:
    the forward, the x gradient and the vals gradient within atol 1e-4,
    the same bits on every rank."""
    _, out = routes
    _same_on_every_rank([o["graph"][width] for o in out])
    for got, ref, what in zip(out[0]["graph"][width], jax_routes["graph"][width],
                              ("y", "y with vals", "dx", "dvals")):
        np.testing.assert_allclose(got, ref, atol=1e-4, err_msg=f"{what} at width {width}")


@pytest.mark.parametrize("b", INFONCE_B)
def test_row_sharded_infonce_matches_jax(routes, jax_routes, b):
    """Route 5 (data 2: offsets 0 and B/2 rounded up) against the JAX
    package's ``sharded_infonce_loss`` and the port's one-device
    ``InfoNCELoss``: the shares sum to the loss, and the cotangents summed
    over ``data`` are the one-device ones."""
    inputs, out = routes
    s = inputs["infonce"][b]
    want, (g1, g2) = jax_routes["infonce"][b]
    t1 = torch.from_numpy(s["view1"]).requires_grad_(True)
    t2 = torch.from_numpy(s["view2"]).requires_grad_(True)
    one = InfoNCELoss.apply(t1, t2, torch.from_numpy(s["mask"]), s["temp"])
    one.backward()
    shares = {}
    for o in out:  # model replicas compute the same share, data ranks differ
        shares.setdefault(o["place"][0], set()).add(o["infonce"][b][0])
    assert [len(v) for v in shares.values()] == [1, 1] and shares[0] != shares[1]
    for o in out:
        _, total, d1, d2 = o["infonce"][b]
        np.testing.assert_allclose(total, float(want), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(total, one.item(), rtol=1e-5, atol=1e-6)
        for got, ref in ((d1, g1), (d2, g2), (d1, t1.grad.numpy()), (d2, t2.grad.numpy())):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())
    _same_on_every_rank([o["infonce"][b][2:] for o in out])


# ---------------------------------------------------------------------------
# routes 6 and 7: in the spawn of four ranks (data 2 x model 2) and in one
# of three (data 3 x model 1), where the items and the test users are cut
# unevenly
# ---------------------------------------------------------------------------

WORLDS = (4, 3)


@pytest.fixture(scope="module")
def uneven_routes(tmp_path_factory):
    return R.spawn(R.uneven, 3, tmp_path_factory.mktemp("uneven"), _dense_inputs())


@pytest.fixture(scope="module")
def dense_ranks(routes, uneven_routes):
    return {4: routes[1], 3: uneven_routes}


@pytest.fixture(scope="module")
def dense_refs():
    """Route 6's and the views' one-process references: the port's
    ``joint_matmul`` and views on the whole table, and the JAX package's
    ``DenseJoint`` product (the product it partitions on a mesh), two
    layers forward and the gradient of ``sum(y * w)``; the ranking in one
    process."""
    inputs = _dense_inputs()
    *_, jd, td = _dense_data()
    out = {"port": {}, "jax": {}}
    for form, (r, su, si) in inputs["forms"].items():
        adj = DenseJoint.from_tables(R.dense_table(r, form), torch.from_numpy(su),
                                     torch.from_numpy(si), form)
        jadj = jspmm_mod.DenseJoint.from_interactions(jd, quant=form)
        for x_np, w_np in zip(inputs["x"], inputs["w"]):
            port, ref = [], []
            for layers in (1, 2):
                x = torch.from_numpy(x_np).requires_grad_(True)
                y = x
                for _ in range(layers):
                    y = spmm(adj, y)
                (y * torch.from_numpy(w_np)).sum().backward()
                port += [y.detach().numpy(), x.grad.numpy()]

                def jprop(a, layers=layers):
                    for _ in range(layers):
                        a = jspmm(jadj, a)
                    return a

                w = jnp.asarray(w_np)
                ref += [np.asarray(jprop(jnp.asarray(x_np))),
                        np.asarray(jax.grad(lambda a: jnp.sum(jprop(a) * w))(jnp.asarray(x_np)))]
            out["port"][form, x_np.shape[1]] = tuple(port)
            out["jax"][form, x_np.shape[1]] = tuple(ref)
    v = inputs["views"]
    adj = DenseJoint.from_tables(*map(torch.from_numpy, (v["r"], v["su"], v["si"])))
    t = torch.from_numpy
    out["views"] = {
        "edge": factored_edge_drop_view(adj, torch.nonzero(adj.r, as_tuple=True), t(v["ru"]),
                                        t(v["ci"]), v["p"]),
        "node": factored_node_drop_view(adj, t(v["keep_u"]), t(v["keep_i"])),
    }
    case = inputs["ranking"]
    ranker = CatalogRanker(td, case["k"], "cpu", torch.from_numpy(R.rated_bitmask(td)),
                           batch_size=case["batch"])
    out["ranking"] = {name: ranker.topk(ScoreForm(*(
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in form)))
        for name, form in case["forms"].items()}
    out["test_users"] = len(ranker.uids)
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_dense_column_blocks_tile_the_items(dense_ranks, world):
    """Each data rank holds ``torch.tensor_split``'s block of the item
    columns in a table of its own, padded to 16 columns; model replicas
    hold the same block."""
    ranks = dense_ranks[world]
    data = 2 if world == 4 else 3
    assert [o["shape"] for o in ranks] == [{"data": data, "model": world // data}] * world
    i = _dense_data()[-1].num_items
    sizes = tuple(len(b) for b in np.array_split(np.arange(i), data))
    starts = np.cumsum((0,) + sizes)
    for rank, out in enumerate(ranks):
        c0, c1, ld, col_sizes = out["cols"]
        d = rank // (world // data)
        assert (c0, c1, col_sizes) == (starts[d], starts[d + 1], sizes)
        assert ld == -(-(c1 - c0) // 16) * 16
    assert len(set(sizes)) == (1 if i % data == 0 else 2)


@pytest.mark.parametrize("width", [16, 15])
@pytest.mark.parametrize("form", DENSE_FORMS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_dense_joint_matches_jax_and_one_process(dense_ranks, dense_refs, world, form,
                                                         width):
    """Route 6 (R's item columns over ``data``; features over ``model`` at
    width 16 on four ranks, the whole width at 15) in each dense form, one
    and two layers forward and the gradient summed by the step's reduction.
    Against the JAX package's ``DenseJoint`` product: within the bf16 bound
    (bf16-rounded layer inputs, ``tests/test_torch_graph_forms.py``).
    Against the port's one-process ``joint_matmul``: one application, both
    ways, and two layers forward within 1e-6 of each output's largest
    entry (the partials of the user half are summed over ``data`` before
    the row scale); two layers backward within the bf16 bound, because the
    user rows of a layer's dx are shares scaled before the step sums them,
    an ulp off one process's sum, which the next layer's bf16 cast can
    turn into one bf16 step (``ShardedJointMatmul``). The same bits on
    every rank."""
    ranks = dense_ranks[world]
    _same_on_every_rank([o["dense"][form, width] for o in ranks])
    got = ranks[0]["dense"][form, width]
    names = ("y 1 layer", "dx 1 layer", "y 2 layers", "dx 2 layers")
    for what, g, one, ref in zip(names, got, dense_refs["port"][form, width],
                                 dense_refs["jax"][form, width]):
        np.testing.assert_allclose(g, ref, **BF16, err_msg=what)
        if what == "dx 2 layers":
            np.testing.assert_allclose(g, one, **BF16, err_msg=what)
        else:
            np.testing.assert_allclose(g, one, rtol=0, atol=1e-6 * np.abs(one).max(),
                                       err_msg=what)


@pytest.mark.parametrize("view", ["edge", "node"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_views_equal_one_process_bit_for_bit(dense_ranks, dense_refs, world, view):
    """SGL's factored views of a rank's block (edge drop hashed at the
    global item ids, node drop's degrees from K1 on the block) have one
    process's scales and table, bit for bit: the user degrees summed over
    ``data`` are integer counts."""
    want = dense_refs["views"][view]
    for out in dense_ranks[world]:
        c0, c1, _, _ = out["cols"]
        row_scale, col_scale, table = out["views"][view]
        np.testing.assert_array_equal(row_scale, want.row_scale.numpy())
        np.testing.assert_array_equal(col_scale, want.col_scale[c0:c1].numpy())
        np.testing.assert_array_equal(table, want.r[:, c0:c1].numpy())
    if view == "edge":  # the view drops some edges, not all
        assert 0 < (want.r != 0).sum() < (dense_refs["views"]["node"].r != 0).sum()


@pytest.mark.parametrize("form", ["plain", "biased"])
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_ranking_equals_one_process(dense_ranks, dense_refs, world, form):
    """Route 7: each rank runs K2 on its ``tensor_split`` share of the test
    users only, in batches of 4, and every rank returns the lists of one
    process bit for bit (unseen users at the global mean included)."""
    n = dense_refs["test_users"]
    want_ids, want_scores = dense_refs["ranking"][form]
    assert (want_scores == np.float32(_dense_data()[-1].global_mean)).all(axis=1).sum() >= 2
    for rank, out in enumerate(dense_ranks[world]):
        ids, scores, calls = out["ranking"][form]
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(scores, want_scores)
        share = len(np.array_split(np.arange(n), world)[rank])
        assert sum(calls) == share and len(calls) == -(-share // 4) and max(calls) <= 4


# ---------------------------------------------------------------------------
# training on four ranks: one spawn
# ---------------------------------------------------------------------------


def _block_records(n_users=40, n_items=30, per_user=10):
    """``tests/test_parallel.py``'s two planted blocks (``_block_ratings``)."""
    rng = np.random.RandomState(0)
    half = n_items // 2
    return [[f"u{u}", f"i{i}", 1.0] for u in range(n_users)
            for i in rng.choice(half, size=per_user, replace=False) + (u >= n_users // 2) * half]


def _conf(name, args, extra=None):
    base = {
        "ratings": "unused", "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10", "num.factors": "16",
        "num.max.epoch": "3", "batch_size": "64", "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1", "output.setup": "off -dir ./results/",
        "seed": "7",
    }
    if args:
        base[name] = args
    base.update(extra or {})
    return base


def _jax_adam_epochs(jmodel, spec, draw):
    """Three epochs of the JAX package's Adam loop; ``draw(step_rng)`` gives
    the port's draws of a step as the JAX loss makes them, or is None."""
    optimizer = optax.adam(jmodel.lrate)
    run_epoch = jtrainer.make_epoch_runner(spec.loss_fn, optimizer)
    params, opt_state = spec.params, optimizer.init(spec.params)
    rng = jax.random.PRNGKey(0)
    batches, losses, tables, draws = [], [], [], []
    for _ in range(3):
        rng, rs, rt = jax.random.split(rng, 3)
        b = spec.sampler(rs)
        batches.append(tuple(np.asarray(a) for a in b))
        if draw is not None:
            draws += [draw(r) for r in jax.random.split(rt, b[0].shape[0])]
        params, opt_state, loss = run_epoch(params, opt_state, b, rt, spec.consts)
        losses.append(float(loss))
        tables.append({k: np.asarray(v) for k, v in params.items()})
    return batches, losses, tables, draws or None


def _jax_bold_epochs(jmodel, spec):
    """The JAX package's bold-mode loop (``tests/test_torch_mf.py``)."""
    optimizer = optax.inject_hyperparams(optax.sgd)(learning_rate=jmodel.lrate)
    run_epoch = jtrainer.make_epoch_runner(spec.loss_fn, optimizer)
    params, opt_state = spec.params, optimizer.init(spec.params)
    bold = jtrainer.BoldDriver(jmodel.lrate, jmodel.max_lrate)
    conv = jtrainer.ConvergenceMonitor()
    rng = jax.random.PRNGKey(0)
    batches, losses, tables = [], [], []
    for epoch in range(3):
        rng, rs, rt = jax.random.split(rng, 3)
        b = spec.sampler(rs)
        batches.append(tuple(np.asarray(a) for a in b))
        params, opt_state, loss = run_epoch(params, opt_state, b, rt)
        losses.append(float(loss))
        tables.append({k: np.asarray(v) for k, v in params.items()})
        if conv.check(losses[-1]):
            break
        lr = bold.update(epoch + 1, losses[-1])
        bold.last_loss = losses[-1]
        opt_state = jtrainer._set_lr(opt_state, lr)
    return batches, losses, tables, None


# name -> (model, JAX class, model args, extra keys, the JAX package's
# extra keys where they differ: off a TPU its ``auto`` quant is bf16, the
# port's factored)
FACTORED = {"graph.dense.quant": "factored"}
SGL_ARGS = "-n_layer 2 -lambda 0.02 -droprate 0.5 -augtype {} -temp 0.2"
FITS = {
    "LightGCN-pallas": ("LightGCN", JLightGCN, "-n_layer 2", {"graph.backend": "pallas"}, None),
    "LightGCN-coo": ("LightGCN", JLightGCN, "-n_layer 2", {"graph.backend": "coo"}, None),
    "SimGCL-pallas": ("SimGCL", JSimGCL, "-n_layer 2 -lambda 0.1 -eps 0.1",
                      {"graph.backend": "pallas"}, None),
    "BPR": ("BPR", JBPR, None, {"learnRate": "-init 0.05 -max 1",
                                "reg.lambda": "-u 0.01 -i 0.01 -b 0.1 -s 0.1"}, None),
}
# slice 7b: the dense forms on route 6 (graph.backend unset: auto), SGL's
# factored views on it and its sparse views on route 4, NGCF; at lr 0.001,
# where ``tests/test_torch_lightgcn.py`` set the port's drift bounds
# against the JAX package (tables 1e-4, losses rtol 1e-3): at lr 0.01 the
# one-process port itself parts from the JAX package's tables by up to
# 3e-3 on these forms (a flipped bf16 rounding moves a table further).
# The bf16 form is held against the JAX package's dual kernel
# (``graph.dense.dual=on``, interpret mode), the kernel that K1 ports: on
# this data its two XLA products part from the port by 2.9e-4 in one
# process already (one flipped bf16 rounding)
LR = {"learnRate": "-init 0.001 -max 1"}
BF16_S = {"graph.dense.quant": "off"}
DENSE_FITS = {
    "LightGCN-auto": ("LightGCN", JLightGCN, "-n_layer 2", LR, LR | FACTORED),
    "LightGCN-off": ("LightGCN", JLightGCN, "-n_layer 2", LR | BF16_S,
                     LR | BF16_S | {"graph.dense.dual": "on"}),
    "LightGCN-int8": ("LightGCN", JLightGCN, "-n_layer 2", LR | {"graph.dense.quant": "int8"},
                      None),
    "SimGCL-auto": ("SimGCL", JSimGCL, "-n_layer 2 -lambda 0.1 -eps 0.1", LR, LR | FACTORED),
    "NGCF": ("NGCF", JNGCF, "-n_layer 2", LR, LR | FACTORED),
    "SGL-aug0": ("SGL", JSGL, SGL_ARGS.format(0), LR, LR | FACTORED),
    "SGL-aug1": ("SGL", JSGL, SGL_ARGS.format(1), LR, LR | FACTORED),
    "SGL-pallas": ("SGL", JSGL, SGL_ARGS.format(1), LR | {"graph.backend": "pallas"}, None),
}


def _planted_file(tmp):
    path = tmp / "ratings.txt"
    path.write_text("".join(f"{u} {i} 1\n" for u, i, _ in _block_records()))
    return path


SESSIONS = ("BPR-session", "LightGCN-pallas-session", "LightGCN-session", "BPR-cv")


def _session_confs(tmp):
    """``tests/test_parallel.py``'s end-to-end runs: BPR 30 epochs and
    LightGCN-pallas 15 epochs past the dense budget, on the planted file;
    LightGCN at ``config/LightGCN.conf``'s settings (``graph.backend``
    unset: the factored dense form on route 6) for 15 epochs; and BPR
    under ``-cv 2``, its folds in turn on the mesh."""
    ratings = str(_planted_file(tmp))
    bpr = _conf("BPR", None, {"ratings": ratings, "num.max.epoch": "30",
                              "learnRate": "-init 0.05 -max 1",
                              "reg.lambda": "-u 0.01 -i 0.01 -b 0.1 -s 0.1"})
    lightgcn = _conf("LightGCN", "-n_layer 2", {
        "ratings": ratings, "num.max.epoch": "15", "learnRate": "-init 0.05 -max 1",
        "graph.backend": "pallas", "graph.dense.limit": "1"})
    dense = {k: v for k, v in lightgcn.items() if not k.startswith("graph.")}
    cv = dict(bpr, **{"evaluation.setup": "-cv 2", "num.max.epoch": "3"})
    return dict(zip(SESSIONS, (bpr, lightgcn, dense, cv)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX package's one-device runs, the port's in one process and the
    port's on four ranks, on the same batches (and SimGCL's draws)."""
    train, test = data_split(_block_records(), 0.2, rng=random.Random(2))
    cases, jax_runs = {}, {}
    for label, (name, jcls, args, extra, jextra) in (FITS | DENSE_FITS).items():
        conf = _conf(name, args, extra)
        jconf = jconfig.ModelConf(_conf(name, args, extra if jextra is None else jextra))
        jmodel = jcls(jconf, JInteractions(jconf, train, test))
        spec = jmodel.build()
        init = {k: np.asarray(v) for k, v in spec.params.items()}
        if name == "BPR":
            batches, losses, tables, draws = _jax_bold_epochs(jmodel, spec)
        else:
            draw = None
            if name != "LightGCN":
                # the port's draws of a step, as ``tests/test_torch_sparse.py`` makes them
                tmodel = get_model(name)(ModelConf(conf), Interactions(ModelConf(conf), train, test),
                                         device="cpu")
                draw = lambda r, m=tmodel: _sparse_slice_draws(m, r)  # noqa: E731
            batches, losses, tables, draws = _jax_adam_epochs(jmodel, spec, draw)
        cases[label] = {"conf": conf, "train": train, "test": test, "params": init,
                        "batches": batches, "draws": draws}
        jax_runs[label] = {"losses": losses, "tables": tables}
    tmp = tmp_path_factory.mktemp("trained")
    sessions = _session_confs(tmp)
    one = {label: R.fit_case(case) for label, case in cases.items()}
    for label, conf in sessions.items():
        one[label] = R.session(dict(conf, **{"output.setup": f"on -dir {tmp}/{label}/one"}))
    on_mesh = {label: dict(case, conf=dict(case["conf"], **{"parallel.setup": MESH}))
               for label, case in cases.items()}
    mesh_sessions = {label: dict(conf, **{"parallel.setup": MESH, "out_dir": str(tmp)})
                     for label, conf in sessions.items()}
    ranks = R.spawn(R.training, WORLD, tmp, on_mesh, mesh_sessions)
    return jax_runs, one, ranks


@pytest.mark.parametrize("label", list(FITS))
def test_four_ranks_train_as_one_process_and_jax(trained, label):
    """Three epochs on the JAX sampler's batches: LightGCN on K5's row blocks
    (``pallas``) and on the whole ``DeviceCOO`` (``coo``), SimGCL on K5's
    row blocks with the row-sharded InfoNCE and its per-epoch evaluation,
    BPR in the bold mode (its driver reads the loss summed over ``data``)."""
    jax_run, one, got = trained[0][label], trained[1][label], trained[2][0][label]
    assert got["mesh"] == {"data": 2, "model": 2} and one["mesh"] is None
    if label.endswith("pallas"):
        assert (got["adj"], one["adj"]) == ("ShardedSparseJoint", "SparseJoint")
    if label == "LightGCN-coo":
        assert got["adj"] == one["adj"] == "DeviceCOO"
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=1e-3)
    assert got["best"] == one["best"]
    want = jax_run["tables"][(got["best"] or len(got["losses"])) - 1]
    for key, value in got["params"].items():
        np.testing.assert_allclose(value, one["params"][key], atol=1e-5, err_msg=key)
        np.testing.assert_allclose(value, want[key], atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["U"], one["U"], atol=1e-5)
    np.testing.assert_allclose(got["V"], one["V"], atol=1e-5)


@pytest.mark.parametrize("label", list(FITS))
def test_first_step_gradients_match_one_process(trained, label):
    """The gradient invariant: after the step's reduction over ``data``,
    every parameter's gradient on every rank is the one-process one."""
    one, ranks = trained[1][label], trained[2]
    for rank in ranks:
        assert sorted(rank[label]["grads"]) == sorted(one["grads"])
        for key, ref in one["grads"].items():
            np.testing.assert_allclose(rank[label]["grads"][key], ref, rtol=1e-5,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=key)


@pytest.mark.parametrize("label", list(DENSE_FITS))
def test_four_ranks_train_the_lightgcn_family_in_every_form(trained, label):
    """Three epochs on the JAX sampler's batches and draws on four ranks:
    LightGCN on route 6 in each dense form (``graph.backend`` unset, so
    ``auto`` takes the factored one), SimGCL on it with the row-sharded
    InfoNCE, NGCF on it, SGL on its factored views (aug types 0 and 1) and
    on its sparse views over route 4, SimGCL and SGL ranking after every
    epoch through route 7. The first step's loss (the data ranks' shares
    summed) within rtol 1e-5 of one process's; the losses within rtol 1e-3
    and the tables within 1e-4 of one process's and the JAX package's (the
    drift bounds of ``tests/test_torch_lightgcn.py``: route 6 sums the user
    half's partials in another f32 order, which a layer's bf16 cast can
    turn into one bf16 step); the first step's gradients within the bf16
    bound of one process's."""
    jax_run, one, ranks = trained[0][label], trained[1][label], trained[2]
    got = ranks[0][label]
    assert got["mesh"] == {"data": 2, "model": 2} and one["mesh"] is None
    sparse = label == "SGL-pallas"
    assert (got["adj"], one["adj"]) == (("ShardedSparseJoint", "SparseJoint") if sparse else
                                        ("ShardedDenseJoint", "DenseJoint"))
    first = sum(r[label]["first_loss"] for r in ranks[::2])  # model index 0: one per data rank
    np.testing.assert_allclose(first, one["first_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-3)
    np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=1e-3)
    assert got["best"] == one["best"]
    want = jax_run["tables"][(got["best"] or len(got["losses"])) - 1]
    for key, value in got["params"].items():
        np.testing.assert_allclose(value, one["params"][key], atol=1e-4, err_msg=key)
        np.testing.assert_allclose(value, want[key], atol=1e-4, err_msg=key)
    for key, ref in one["grads"].items():
        np.testing.assert_allclose(got["grads"][key], ref, **BF16, err_msg=key)


def test_ranks_stay_equal_bit_for_bit(trained):
    ranks = trained[2]
    for label in FITS | DENSE_FITS:
        _same_on_every_rank([(r[label]["losses"], r[label]["params"], r[label]["U"],
                              r[label]["V"], r[label]["grads"]) for r in ranks])
    for label in SESSIONS:
        _same_on_every_rank([(r[label]["U"], r[label]["measure"]) for r in ranks])


@pytest.mark.parametrize("label", SESSIONS[:3])
def test_session_on_four_ranks(trained, label):
    """``parallel.setup=on -model 2`` through ``QRec(conf).execute()``: the
    planted blocks learnt (Recall@10 > 0.5) and the measures within 2e-2 of
    one process (``tests/test_parallel.py:298-340``); rank 0 alone writes
    the result files."""
    one, ranks = trained[1][label], trained[2]
    assert one["mesh"] is None and ranks[0][label]["mesh"] == {"data": 2, "model": 2}
    got = metrics.parse_measure(ranks[0][label]["measure"])["Top 10"]
    ref = metrics.parse_measure(one["measure"])["Top 10"]
    assert got["Recall"] > 0.5, got
    for m in ("Precision", "Recall", "NDCG"):
        assert abs(got[m] - ref[m]) < 2e-2, (m, got, ref)
    assert [len(r[label]["files"]) for r in ranks] == [2, 0, 0, 0]


def test_cross_validation_folds_run_in_turn_on_the_mesh(trained):
    """``-cv 2`` without ``-p``: both folds train on the mesh, one after the
    other, and rank 0 alone writes the summary (and each fold's files)."""
    one, ranks = trained[1]["BPR-cv"], trained[2]
    assert ranks[0]["BPR-cv"]["mesh"] == {"data": 2, "model": 2}
    assert [sum(f.endswith("-2-fold-cv.txt") for f in r["BPR-cv"]["files"]) for r in ranks] == [
        1, 0, 0, 0]
    # the same files as one process's, but for their timestamps
    suffix = lambda f: f.split("@")[1][len("2026-01-01 00-00-00"):]  # noqa: E731
    assert sorted(map(suffix, ranks[0]["BPR-cv"]["files"])) == sorted(map(suffix, one["files"]))
    assert len(one["files"]) == 5
    got = metrics.parse_measure(ranks[0]["BPR-cv"]["measure"])["Top 10"]
    ref = metrics.parse_measure(one["measure"])["Top 10"]
    for m in ("Precision", "Recall", "NDCG"):
        assert abs(got[m] - ref[m]) < 2e-2, (m, got, ref)
