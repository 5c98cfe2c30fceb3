"""The sparse joint-adjacency slice of the PyTorch port against the JAX
package: the host graph construction, the segment SpMM's plain version and its
autograd against ``PaddedCOO`` run in interpret mode, SGL's edge values,
one step and two epochs of LightGCN, SimGCL, SGL and NGCF on that path
(and NGCF on the dense one), ``auto`` past the dense budget; plus the
port's own end-to-end runs on planted blocks."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data import graph as jgraph
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.split import data_split
from qrec_tpu.models.graph import NGCF as JNGCF, SGL as JSGL, LightGCN as JLightGCN
from qrec_tpu.models.graph import SimGCL as JSimGCL
from qrec_tpu.ops import spmm as jspmm
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import embedding_params_from_jax
from qrec_tpu_torch.data import graph as tgraph
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.models.graph import NGCF, SGL, LightGCN, SimGCL
from qrec_tpu_torch.ops import kernels as K
from qrec_tpu_torch.ops import metrics
from qrec_tpu_torch.ops.spmm import DenseJoint, SparseJoint, spmm, subgraph_vals

MODEL_ARGS = {
    "LightGCN": "-n_layer 2",
    "NGCF": "-n_layer 2",
    "SimGCL": "-n_layer 2 -lambda 0.1 -eps 0.1",
    "SGL": "-n_layer 2 -lambda 0.02 -droprate 0.5 -augtype 1 -temp 0.2",
}
J_MODELS = {"LightGCN": JLightGCN, "NGCF": JNGCF, "SimGCL": JSimGCL, "SGL": JSGL}
T_MODELS = {"LightGCN": LightGCN, "NGCF": NGCF, "SimGCL": SimGCL, "SGL": SGL}
PALLAS = {"graph.backend": "pallas"}
DENSE = {"graph.dense.quant": "factored"}


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
        "output.setup": "off -dir ./results/",
        "seed": "11",
    }
    base.update(extra or {})
    return base


def _records(duplicate=True):
    """A split of 14 users x 24 items; with ``duplicate``, one training
    (user, item) pair appears twice."""
    rng = np.random.RandomState(5)
    records = [
        [f"u{u}", f"i{i}", 1.0] for u in range(14) for i in rng.choice(24, size=7, replace=False)
    ]
    train, test = data_split(records, 0.25, rng=random.Random(2))
    if duplicate:
        train = train + [list(train[3])]
    return train, test


def _both(conf, duplicate=True):
    train, test = _records(duplicate)
    return (JInteractions(jconfig.ModelConf(conf), train, test),
            Interactions(ModelConf(conf), train, test))


# ---------------------------------------------------------------------------
# host graph construction
# ---------------------------------------------------------------------------


def test_joint_adjacency_construction_matches_jax():
    jd, td = _both(_conf("LightGCN"))
    want, got = jgraph.joint_normalized_adjacency(jd), tgraph.joint_normalized_adjacency(td)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.shape == want.shape
    for a, b in zip(tgraph.joint_bipartite_coo(td), jgraph.joint_bipartite_coo(jd)):
        np.testing.assert_array_equal(a, b)
    # the duplicated pair weighs 2 in the sparse adjacency and counts twice
    # in its degrees; the factored dense form (deduplicated CSR) counts it once
    u, i = int(td.train_u[3]), int(td.train_i[3])
    count_u = np.bincount(td.train_u)[u]
    count_i = np.bincount(td.train_i)[i]
    dense = got.to_scipy().toarray()
    assert dense[u, td.num_users + i] == pytest.approx(2 / np.sqrt(count_u * count_i), rel=1e-6)
    rb, su, si = tgraph.factored_adjacency(td)
    assert rb[u, i] == 1 and rb.sum() == len(td.csr_sel) == len(td.train_u) - 1
    assert su[u] == pytest.approx(1 / np.sqrt(count_u - 1), rel=1e-6)
    # the same structure in the same order as the views' joint_bipartite_coo
    rows, cols, _, _ = tgraph.joint_bipartite_coo(td)
    np.testing.assert_array_equal(got.rows, rows)
    np.testing.assert_array_equal(got.cols, cols)


# ---------------------------------------------------------------------------
# the segment SpMM against PaddedCOO in interpret mode
# ---------------------------------------------------------------------------


def _empty_rows_coo(seed=0):
    """A symmetric 40-node graph whose rows 8..23 have no edges: two whole
    8-row blocks of the PaddedCOO layout below are empty."""
    rng = np.random.RandomState(seed)
    live = np.r_[0:8, 24:40]
    m = np.zeros((40, 40), np.float32)
    for a in live:
        for b in rng.choice(live, size=5, replace=False):
            if a != b:
                m[a, b] = m[b, a] = rng.rand() + 0.1
    import scipy.sparse as sp

    return jgraph.COO.from_scipy(sp.csr_matrix(m))


def _graph(kind):
    if kind == "empty_rows":
        return _empty_rows_coo()
    jd, _ = _both(_conf("LightGCN"))
    return jgraph.joint_normalized_adjacency(jd)


def _pair(coo):
    padded = jspmm.PaddedCOO.from_host(coo, row_block=8, edge_tile=16, interpret=True,
                                       check_symmetric=False)
    tcoo = tgraph.COO(coo.rows, coo.cols, coo.vals, coo.shape)
    return padded, SparseJoint.from_host(tcoo, "cpu")


# unit-scale inputs; the same exact bf16 products summed in f32 in another
# order (the one-hot matmul's against edge order): 1e-6 absolute
SUM_ORDER = 1e-6


@pytest.mark.parametrize("d", [1, 8, 50])
@pytest.mark.parametrize("kind", ["duplicate_pair", "empty_rows"])
def test_segment_plain_matches_padded_coo_interpret(kind, d):
    coo = _graph(kind)
    padded, adj = _pair(coo)
    x = np.random.RandomState(d).randn(coo.shape[0], d).astype(np.float32)
    want = np.asarray(jspmm.spmm(padded, jnp.asarray(x)))
    got = spmm(adj, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SUM_ORDER)
    if kind == "empty_rows":
        assert (got.numpy()[8:24] == 0).all()
    # the kernel's wrapper itself, on the CPU: its plain version, no launch
    before = K.launch_counts()
    direct = K.weighted_segment_matmul(
        torch.from_numpy(x).bfloat16(), adj.indptr, adj.cols, adj.vals
    )
    assert K.launch_counts() == before
    torch.testing.assert_close(direct, got, rtol=0, atol=0)


def test_segment_values_round_to_bf16():
    """The Pallas kernel rounds the edge values to bf16 (its ``_xla`` twin
    does not): the plain version matches the bf16-rounded segment sum to
    f32 order and differs from the f32-valued one."""
    coo = _graph("duplicate_pair")
    padded, adj = _pair(coo)
    x = np.random.RandomState(3).randn(coo.shape[0], 8).astype(np.float32)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    vb = np.asarray(jnp.asarray(coo.vals).astype(jnp.bfloat16).astype(jnp.float32))
    got = spmm(adj, torch.from_numpy(x)).numpy()
    rounded = np.zeros_like(got)
    exact = np.zeros_like(got)
    np.add.at(rounded, coo.rows, vb[:, None] * xb[coo.cols])
    np.add.at(exact, coo.rows, coo.vals[:, None] * xb[coo.cols])
    np.testing.assert_allclose(got, rounded, rtol=0, atol=SUM_ORDER)
    assert np.abs(got - exact).max() > 100 * SUM_ORDER


def test_segment_gradients_match_jax():
    coo = _graph("duplicate_pair")
    padded, adj = _pair(coo)
    rng = np.random.RandomState(6)
    n = coo.shape[0]
    x = rng.randn(n, 8).astype(np.float32)
    w = rng.randn(n, 8).astype(np.float32)
    v = rng.rand(coo.nnz).astype(np.float32)

    def jloss(xx, vv):
        return jnp.sum(jnp.asarray(w) * jspmm.spmm(padded, xx, vv))

    jdx, jdv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(v))
    tx = torch.from_numpy(x).requires_grad_(True)
    tv = torch.from_numpy(v).requires_grad_(True)
    (spmm(adj, tx, tv) * torch.from_numpy(w)).sum().backward()
    # dx: the same kernel on the bf16-cast cotangent; dvals: 8-term f32 dots
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jdv), rtol=1e-6, atol=1e-6)
    # without a gradient for the values none is computed
    tx2 = torch.from_numpy(x).requires_grad_(True)
    (spmm(adj, tx2, torch.from_numpy(v)) * torch.from_numpy(w)).sum().backward()
    torch.testing.assert_close(tx2.grad, tx.grad, rtol=0, atol=0)


def _replay_schedule(s, indptr, cols, vals, x):
    """The segment kernel's schedule played on the host in float64: each
    tile sums its rows' edges, writes the rows it holds whole and the empty
    rows up to the next tile's first row, and leaves the part of a split row
    in that row's slot for the tile; each split row is then the sum of its
    slots in tile order. Returns (out, rows written, slots written)."""
    n, d = x.shape
    e = len(cols)
    out = np.zeros((n, d))
    written = np.zeros(n, np.int64)
    slot_written = np.zeros(s.split_tiles.shape[0], np.int64)
    carry = np.zeros((s.split_tiles.shape[0], d))
    edge_row, tile_row = s.edge_row.numpy(), s.tile_row.numpy()
    tile_split, split_ptr = s.tile_split.numpy(), s.split_ptr.numpy()
    split_tiles = s.split_tiles.numpy()
    prod = vals[:, None].astype(np.float64) * x[cols]
    if e == 0:
        written[:] += 1
    if e:
        written[: edge_row[0]] += 1
    for t in range(s.num_tiles):
        lo, hi = t * s.tile, min((t + 1) * s.tile, e)
        rows = edge_row[lo:hi]
        for r in np.unique(rows):
            part = prod[lo:hi][rows == r].sum(0)
            head, tail = tile_split[t]
            sid = head if (r == rows[0] and head >= 0) else (tail if r == rows[-1] else -1)
            if sid < 0:
                out[r] = part
                written[r] += 1
            else:
                c0 = split_ptr[sid]
                slot = c0 + t - split_tiles[c0]
                assert split_ptr[sid] <= slot < split_ptr[sid + 1] and split_tiles[slot] == t
                carry[slot] = part
                slot_written[slot] += 1
        nxt = np.r_[rows[1:], tile_row[t + 1]] if hi > lo else []
        for r, r2 in zip(rows, nxt):
            written[r + 1 : r2] += 1
    for sid, r in enumerate(s.split_row.numpy()):
        out[r] = carry[split_ptr[sid] : split_ptr[sid + 1]].sum(0)
        written[r] += 1
    return out, written, slot_written


def _indptr_of(degrees):
    return np.r_[0, np.cumsum(degrees)].astype(np.int64)


# (degrees of the rows, tile): empty rows inside and at both ends, one row
# over several tiles, every row split, no edge at all, a zipf-skewed graph
SCHEDULE_CASES = {
    "empty_rows": ([0, 3, 0, 4, 5, 0], 4),
    "long_row": ([2, 13, 1], 4),
    "every_row_split": ([5, 5, 5, 5], 4),
    "no_edges": ([0, 0], 4),
    "one_tile": ([1, 2, 0, 3], 512),
    "zipf": ((np.arange(1, 301) ** -1.1 * 900).astype(np.int64), 64),
}


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_segment_schedule_splits_long_rows(case):
    degrees, tile = SCHEDULE_CASES[case]
    indptr = _indptr_of(degrees)
    n, e = len(degrees), int(indptr[-1])
    s = K.segment_schedule(indptr, tile=tile)
    tensors = (s.edge_row, s.tile_row, s.tile_split, s.split_row, s.split_ptr,
               s.split_tiles, s.counters)
    assert all(t.dtype == torch.int32 for t in tensors)
    assert s.carry.dtype == torch.float32 and s.carry.shape == (s.split_tiles.shape[0], K.SEGMM_MAX_D)
    assert not s.counters.any()  # counters start at zero
    assert (s.tile, s.num_rows) == (tile, n)
    # every edge in exactly one tile: consecutive tiles of `tile` edges
    assert s.num_tiles == max(1, -(-e // tile))
    np.testing.assert_array_equal(s.edge_row.numpy(), np.repeat(np.arange(n), degrees))
    first_edges = np.arange(s.num_tiles) * tile
    want_rows = s.edge_row.numpy()[first_edges] if e else np.full(s.num_tiles, n)
    np.testing.assert_array_equal(s.tile_row.numpy(), np.r_[want_rows, n])
    # split rows are those over a tile edge, each with its tiles in order
    first, last = indptr[:-1] // tile, (indptr[1:] - 1) // tile
    split = [r for r in range(n) if degrees[r] and last[r] > first[r]]
    np.testing.assert_array_equal(s.split_row.numpy(), split)
    ptr, tiles = s.split_ptr.numpy(), s.split_tiles.numpy()
    assert ptr[0] == 0 and len(ptr) == len(split) + 1 and s.counters.shape == (len(split),)
    for k, r in enumerate(split):
        np.testing.assert_array_equal(tiles[ptr[k]:ptr[k + 1]], np.arange(first[r], last[r] + 1))
    # a tile's head: the split row it starts inside of; its tail: the one
    # it ends inside of
    edge_row = s.edge_row.numpy()
    for t, (head, tail) in enumerate(s.tile_split.numpy()):
        lo, hi = t * tile, min((t + 1) * tile, e)
        if lo >= hi:
            assert head == tail == -1
            continue
        r0, r1 = edge_row[lo], edge_row[hi - 1]
        assert head == (split.index(r0) if indptr[r0] < lo else -1)
        assert tail == (split.index(r1) if indptr[r1 + 1] > hi else -1)
    if case == "every_row_split":
        assert len(split) == n
    if case == "long_row":
        np.testing.assert_array_equal(tiles, [0, 1, 2, 3])
        np.testing.assert_array_equal(s.tile_split.numpy(), [[-1, 0], [0, 0], [0, 0], [0, -1]])
    # played on the host, the tiles and their carries give the plain sums,
    # every row written once and every slot filled once
    rng = np.random.RandomState(len(case))
    cols = torch.from_numpy(rng.randint(0, n, size=e).astype(np.int32))
    vals = torch.from_numpy(rng.rand(e).astype(np.float32))
    x = torch.from_numpy(rng.randn(n, 3).astype(np.float32)).bfloat16()
    out, written, slots = _replay_schedule(
        s, indptr, cols.numpy(), vals.bfloat16().float().numpy(), x.float().numpy())
    assert (written == 1).all() and (slots == 1).all()
    want = K.weighted_segment_matmul_plain(x, torch.from_numpy(indptr.astype(np.int32)), cols, vals)
    np.testing.assert_allclose(out, want.numpy(), rtol=1e-5, atol=1e-5)


def test_segment_tile_size():
    # at most 3 tiles an SM of an H100 where 4096 edges allow, 512 at least
    assert K.segment_tile(0) == 512 and K.segment_tile(148_210) == 512
    assert K.segment_tile(721_096) == 2048 and K.segment_tile(10**8) == 4096
    for e in (1, 10**5, 10**6, 2 * 10**6):
        tile = K.segment_tile(e)
        assert tile % 4 == 0 and (-(-e // tile) <= 3 * 132 or tile == 4096)


def test_segment_wrapper_rejects_bad_inputs():
    x = torch.zeros((3, 4), dtype=torch.bfloat16)
    indptr = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    cols = torch.tensor([1, 0], dtype=torch.int32)
    vals = torch.ones(2)
    with pytest.raises(TypeError):
        K.weighted_segment_matmul(x.float(), indptr, cols, vals)
    with pytest.raises(TypeError):
        K.weighted_segment_matmul(x, indptr.long(), cols, vals)
    with pytest.raises(ValueError):
        K.weighted_segment_matmul(x, indptr[:3], cols, vals)
    with pytest.raises(ValueError):
        K.weighted_segment_matmul(x, indptr, cols, vals[:1])
    with pytest.raises(ValueError):
        K.weighted_segment_matmul(torch.zeros((3, 300), dtype=torch.bfloat16), indptr, cols, vals)
    with pytest.raises(ValueError):
        K.weighted_segment_matmul(x.to("meta"), indptr.to("meta"), cols.to("meta"), vals.to("meta"))
    out = K.weighted_segment_matmul(x + 1, indptr, cols, vals)
    np.testing.assert_array_equal(out.numpy(), [[1] * 4, [1] * 4, [0] * 4])


def test_sparse_joint_checks_its_input():
    coo = _empty_rows_coo()
    bad = tgraph.COO(coo.rows[::-1].copy(), coo.cols, coo.vals, coo.shape)
    with pytest.raises(AssertionError, match="row-sorted"):
        SparseJoint.from_host(bad, "cpu")
    vals = coo.vals.copy()
    vals[0] += 1.0
    with pytest.raises(ValueError, match="symmetric"):
        SparseJoint.from_host(tgraph.COO(coo.rows, coo.cols, vals, coo.shape), "cpu")
    SparseJoint.from_host(tgraph.COO(coo.rows, coo.cols, vals, coo.shape), "cpu",
                          check_symmetric=False)


# ---------------------------------------------------------------------------
# SGL's edge values
# ---------------------------------------------------------------------------


def _sparse_view_keeps(key, aug, drop_rate, u, i, e):
    """A sparse-branch view's draws as the JAX package's ``subgraph_vals``
    makes them from ``key`` (one layer)."""
    if aug == 0:
        ku = jax.random.bernoulli(key, 1.0 - drop_rate, (u,))
        ki = jax.random.bernoulli(jax.random.fold_in(key, 1), 1.0 - drop_rate, (i,))
        return (torch.from_numpy(np.array(ku)), torch.from_numpy(np.array(ki)))
    return torch.from_numpy(np.array(jax.random.bernoulli(key, 1.0 - drop_rate, (e,))))


# XLA's CPU rsqrt is within 2 ulp of the correctly rounded value, not on
# it: the edge values are held to 2 ulp of the JAX package's
VALS_ULPS = 2


@pytest.mark.parametrize("aug", [0, 1, 2])
def test_subgraph_vals_match_jax(aug):
    jd, td = _both(_conf("SGL"))
    rows, cols, edge_ids, n = tgraph.joint_bipartite_coo(td)
    num_edges = len(td.csr_sel)
    key = jax.random.fold_in(jax.random.PRNGKey(9), aug)
    want = np.asarray(jspmm.subgraph_vals(
        key, jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(edge_ids), num_edges, n,
        jd.num_users, 0.4, aug,
    ))
    keep = _sparse_view_keeps(key, aug, 0.4, td.num_users, td.num_items, num_edges)
    got = subgraph_vals(
        torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(edge_ids), n, aug, keep
    ).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert 0 < (got == 0).sum() < len(got)
    assert (np.abs(got - want) <= VALS_ULPS * np.spacing(np.abs(want))).all()
    # both directions of an edge together
    dense = np.zeros((n, n), np.float32)
    dense[rows, cols] = got
    assert ((dense != 0) == (dense.T != 0)).all()


# ---------------------------------------------------------------------------
# models against the JAX package
# ---------------------------------------------------------------------------


def _models(name, args=None, extra=None, jextra=None):
    conf = _conf(name, args, extra)
    jconf = _conf(name, args, jextra if jextra is not None else extra)
    jd, td = _both(conf)
    jmodel = J_MODELS[name](jconfig.ModelConf(jconf), jd)
    spec = jmodel.build()
    tmodel = T_MODELS[name](ModelConf(conf), td, device="cpu")
    tmodel.load_state_dict(embedding_params_from_jax(
        {k: np.asarray(v) for k, v in spec.params.items()}, "cpu"
    ))
    return jmodel, spec, tmodel


def _bits(key, n):
    bits = np.asarray(jax.random.bits(key, (n,), dtype=jnp.uint32))
    return torch.from_numpy(bits.astype(np.int64))


def _sgl_draws(step_rng, model):
    """Both views' draws of one SGL step as the JAX loss makes them."""
    u, i = model.num_users, model.num_items
    aug, p = model.aug_type, model.drop_rate
    views = []
    for r in jax.random.split(step_rng):
        if not model.dense_views:
            keys = [jax.random.fold_in(r, k) for k in range(model.n_layers)] if aug == 2 else [r]
            e = model.view_structure[2]
            views.append([_sparse_view_keeps(k, aug, p, u, i, e) for k in keys])
        elif aug == 0:
            ku = jax.random.bernoulli(r, 1.0 - p, (u,))
            ki = jax.random.bernoulli(jax.random.fold_in(r, 1), 1.0 - p, (i,))
            views.append([(torch.from_numpy(np.array(ku)), torch.from_numpy(np.array(ki)))])
        else:
            keys = [jax.random.fold_in(r, k) for k in range(model.n_layers)] if aug == 2 else [r]
            views.append([tuple(_bits(s, n) for s, n in zip(jax.random.split(k), (u, i)))
                          for k in keys])
    return tuple(views)


def _ngcf_draws(step_rng, model):
    """NGCF's message-dropout masks of one step as the JAX loss draws them."""
    shape = (model.num_users + model.num_items, model.emb_size)
    masks, rng = [], step_rng
    for _ in range(model.n_layers):
        rng, sub = jax.random.split(rng)
        masks.append(torch.from_numpy(np.array(jax.random.bernoulli(sub, model.keep_prob, shape))))
    return masks


def _simgcl_draws(step_rng, model):
    shape = (model.num_users + model.num_items, model.emb_size)
    ra, rb = jax.random.split(step_rng)
    return [
        tuple(torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(r, k), shape)))
              for r in (ra, rb))
        for k in range(model.n_layers)
    ]


def _draws(model, step_rng):
    if isinstance(model, SGL):
        return _sgl_draws(step_rng, model)
    if isinstance(model, NGCF):
        return _ngcf_draws(step_rng, model)
    if isinstance(model, SimGCL):
        return _simgcl_draws(step_rng, model)
    return None


def _step_loss(model, batch, draws):
    if draws is None:
        return model.loss(batch)
    return model.step_loss(batch, draws)


def _torch_batch(batch):
    u, i, j, w = (np.asarray(a) for a in batch)
    idx = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    return idx(u), idx(i), idx(j), torch.from_numpy(w.astype(np.float32))


# Layer outputs are re-rounded to bf16 at the next layer's input, so an f32
# summation-order difference (edge order against the one-hot matmul's) can
# flip one rounding: gradients are held to the bound of the JAX package's
# dual-vs-XLA propagation test. SGL's view values differ by up to 2 ulp
# (VALS_ULPS), which can flip an edge value's bf16 rounding: the same bound.
BF16_FLIP = (5e-3, 5e-3)

ONE_STEP = [
    ("LightGCN", None, PALLAS),
    ("SimGCL", None, PALLAS),
    ("SGL", "-n_layer 2 -lambda 0.02 -droprate 0.5 -augtype 0 -temp 0.2", PALLAS),
    ("SGL", None, PALLAS),
    ("SGL", "-n_layer 2 -lambda 0.02 -droprate 0.5 -augtype 2 -temp 0.2", PALLAS),
    ("NGCF", None, PALLAS),
    ("NGCF", None, DENSE),
]


@pytest.mark.parametrize(
    "name,args,extra", ONE_STEP,
    ids=["LightGCN", "SimGCL", "SGL-aug0", "SGL-aug1", "SGL-aug2", "NGCF-pallas", "NGCF-dense"],
)
def test_one_step_loss_and_grads_match_jax(name, args, extra):
    jmodel, spec, tmodel = _models(name, args, extra)
    want_sparse = extra is PALLAS
    assert isinstance(tmodel.joint_adj, SparseJoint if want_sparse else DenseJoint)
    assert isinstance(jmodel.joint_adj, jspmm.PaddedCOO if want_sparse else jspmm.DenseJoint)
    batch = jax.tree_util.tree_map(lambda x: x[0], spec.sampler(jax.random.PRNGKey(0)))
    step_rng = jax.random.PRNGKey(5)
    want, grads = jax.value_and_grad(spec.loss_fn)(spec.params, batch, step_rng, spec.consts)
    loss = _step_loss(tmodel, _torch_batch(batch), _draws(tmodel, step_rng))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    rtol, atol = BF16_FLIP
    for pname, g in grads.items():
        np.testing.assert_allclose(
            getattr(tmodel, pname).grad.numpy(), np.asarray(g), rtol=rtol, atol=atol, err_msg=pname
        )


def test_auto_past_the_dense_limit_picks_the_sparse_adjacency(capsys):
    # the JAX package's auto gives PaddedCOO past the limit on a TPU only;
    # its pallas backend is the same function
    limit = {"graph.dense.limit": "100"}
    jmodel, spec, tmodel = _models("LightGCN", extra=limit, jextra=PALLAS)
    assert tmodel.num_users * tmodel.num_items > 100
    assert isinstance(tmodel.joint_adj, SparseJoint)
    out = capsys.readouterr().out
    assert "Graph backend: SparseJoint CSR, segment kernel (graph.backend=auto)" in out
    batch = jax.tree_util.tree_map(lambda x: x[0], spec.sampler(jax.random.PRNGKey(1)))
    want = spec.loss_fn(spec.params, batch, jax.random.PRNGKey(0), spec.consts)
    np.testing.assert_allclose(tmodel.loss(_torch_batch(batch)).item(), float(want), rtol=1e-5)
    # within the limit, auto stays dense
    _, _, dense = _models("LightGCN", extra={"graph.dense.limit": str(10**6)})
    assert isinstance(dense.joint_adj, DenseJoint)


# Two epochs through ``fit``: losses within 1e-3 and the tables within 1e-4,
# as the dense slices hold them. NGCF on the sparse path is held looser:
# torch's Adam and optax's round the first update differently, and the
# JAX package's own NGCF loss, evaluated that far from its trajectory, can
# flip a layer input's bf16 rounding, which the normalized layer concat
# (norms of 0.005-scale rows) magnifies; the two trajectories part by 1%
# of the loss in two epochs. The function itself is held tight at every
# step of the JAX trajectory (the next test).
TRAJECTORY = {"loss": 1e-3, "params": 1e-4}
NGCF_SPARSE_TRAJECTORY = {"loss": 2e-2, "params": 5e-3}


def _jax_epochs(spec, jmodel, tmodel, epochs=2):
    """Run the JAX package's epochs; return its per-epoch batches, losses,
    parameters and the port's draws of every step."""
    optimizer = optax.adam(jmodel.lrate)
    run_epoch = jtrainer.make_epoch_runner(spec.loss_fn, optimizer)
    params, opt_state = spec.params, optimizer.init(spec.params)
    rng = jax.random.PRNGKey(0)
    batches, jlosses, jparams, steps = [], [], [], []
    for _ in range(epochs):
        rng, rs, rt = jax.random.split(rng, 3)
        b = spec.sampler(rs)
        batches.append(tuple(np.asarray(a) for a in b))
        steps += [(s, r) for s, r in enumerate(jax.random.split(rt, b[0].shape[0]))]
        params, opt_state, loss = run_epoch(params, opt_state, b, rt, spec.consts)
        jlosses.append(float(loss))
        jparams.append(params)
    return batches, jlosses, jparams, steps


@pytest.mark.parametrize(
    "name,extra", [("SGL", PALLAS), ("NGCF", PALLAS), ("NGCF", DENSE)],
    ids=["SGL-pallas", "NGCF-pallas", "NGCF-dense"],
)
def test_two_epochs_on_injected_batches_match_jax(name, extra):
    jmodel, spec, tmodel = _models(name, extra=extra)
    batches, jlosses, jparams, steps = _jax_epochs(spec, jmodel, tmodel)
    stream = iter([_draws(tmodel, r) for _, r in steps])
    tmodel.draw = lambda gen: next(stream)
    losses = tmodel.fit(epoch_batches=batches)
    assert next(stream, None) is None  # one draw per step
    tol = NGCF_SPARSE_TRAJECTORY if (name, extra) == ("NGCF", PALLAS) else TRAJECTORY
    np.testing.assert_allclose(losses, jlosses, rtol=tol["loss"])
    # SGL's fit restores the epoch that won the vote; NGCF keeps the last
    final = jparams[tmodel.tracker.best_epoch - 1] if tmodel.tracker else jparams[-1]
    for pname, value in final.items():
        np.testing.assert_allclose(
            getattr(tmodel, pname).detach().numpy(), np.asarray(value), atol=tol["params"],
            err_msg=pname,
        )
    width = 3 * 8 if name == "NGCF" else 8
    assert tmodel.U.shape == (tmodel.num_users, width)
    assert tmodel.V.shape == (tmodel.num_items, width)


def test_ngcf_sparse_steps_match_jax_along_its_trajectory():
    """Every step of two JAX epochs of NGCF on the sparse path, from the JAX
    package's parameters at that step: the same loss and gradients."""
    jmodel, spec, tmodel = _models("NGCF", extra=PALLAS)
    optimizer = optax.adam(jmodel.lrate)
    params, opt_state = spec.params, optimizer.init(spec.params)
    batches, _, jparams, steps = _jax_epochs(spec, jmodel, tmodel)
    per_epoch = batches[0][0].shape[0]
    rtol, atol = BF16_FLIP
    for n, (s, step_rng) in enumerate(steps):
        batch = tuple(a[s] for a in batches[n // per_epoch])
        want, grads = jax.value_and_grad(spec.loss_fn)(params, batch, step_rng, spec.consts)
        tmodel.load_state_dict(embedding_params_from_jax(
            {k: np.asarray(v) for k, v in params.items()}, "cpu"
        ))
        tmodel.zero_grad(set_to_none=True)
        loss = tmodel.step_loss(_torch_batch(batch), _draws(tmodel, step_rng))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5, err_msg=f"step {n}")
        for pname, g in grads.items():
            np.testing.assert_allclose(getattr(tmodel, pname).grad.numpy(), np.asarray(g),
                                       rtol=rtol, atol=atol, err_msg=f"{pname} step {n}")
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    # the replayed trajectory is the run's
    for pname, value in jparams[-1].items():
        np.testing.assert_allclose(np.asarray(params[pname]), np.asarray(value), rtol=0, atol=1e-6)


def test_ngcf_scores_without_dropout_and_its_weights_carry_across():
    jmodel, spec, tmodel = _models("NGCF", extra=PALLAS)
    assert sorted(n for n, _ in tmodel.named_parameters()) == sorted(spec.params)
    scores = spec.score_params_fn(spec.params, spec.consts)
    users, items = scores["user_emb"], scores["item_emb"]
    with torch.no_grad():
        tu, ti = tmodel()
    # two layers of bf16 propagation between the packages: the bf16 bound
    np.testing.assert_allclose(tu.numpy(), np.asarray(users), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(ti.numpy(), np.asarray(items), rtol=5e-3, atol=5e-3)
    # every layer block of the concat is unit-norm after the ego block
    norms = torch.linalg.vector_norm(tu.reshape(tu.shape[0], 3, -1), dim=2)
    torch.testing.assert_close(norms[:, 1:], torch.ones_like(norms[:, 1:]), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------


def _planted(tmp_path, name, args, epochs, extra):
    rng = np.random.RandomState(0)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(
        f"u{u} i{i} 1\n"
        for u in range(40)
        for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)
    ))
    conf = {
        "ratings": str(path), "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10", "num.factors": "16",
        "num.max.epoch": str(epochs), "batch_size": "64", "learnRate": "-init 0.05 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1",
        "output.setup": "off -dir ./results/", "seed": "7",
    }
    if args:
        conf[name] = args
    conf.update(extra)
    return conf


@pytest.mark.parametrize(
    "name,args,extra",
    [
        ("LightGCN", "-n_layer 2", PALLAS),
        ("SGL", "-n_layer 2 -lambda 0.05 -droprate 0.2 -augtype 1 -temp 0.2", PALLAS),
        ("NGCF", None, {}),
        ("NGCF", None, PALLAS),
    ],
    ids=["LightGCN-pallas", "SGL-pallas", "NGCF", "NGCF-pallas"],
)
def test_qrec_learns_planted_blocks_on_cpu(tmp_path, capsys, name, args, extra):
    rec = QRec(ModelConf(_planted(tmp_path, name, args, 30, extra)), seed=3, device="cpu")
    parsed = metrics.parse_measure(rec.execute())["Top 10"]
    # the floor of tests/test_graph_models.py; random recall@10 over 30
    # items is about 0.33
    assert parsed["Recall"] > 0.5, parsed
    sparse = extra is PALLAS
    assert isinstance(rec.model.joint_adj, SparseJoint if sparse else DenseJoint)
    if name == "SGL":
        assert not rec.model.dense_views
    out = capsys.readouterr().out
    assert ("SparseJoint CSR, segment kernel" if sparse else "DenseJoint factored int8") in out
