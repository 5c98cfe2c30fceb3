"""The adjacency forms of the social slice in the PyTorch port against the
JAX package, on the CPU: ``DeviceCOO`` (f32 gather and segment sum, any
shape, its gradient through the transposed order), ``DenseMat`` (bf16
storage, f32 result, the gradient through the bf16 cast), the bf16 and
legacy int8 ``DenseJoint`` forms on the dual kernel's scaled entry (against
the JAX package's dual kernel in interpret mode, its two bf16 products and
its ``_int8_joint_matmul``), and LightGCN trained under ``graph.backend=coo``,
``graph.dense.quant=off`` (dual on and off) and ``graph.dense.quant=int8``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data import graph as jgraph
from qrec_tpu.models.graph import LightGCN as JLightGCN
from qrec_tpu.ops import spmm as jspmm
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data import graph as tgraph
from qrec_tpu_torch.models.graph import LightGCN
from qrec_tpu_torch.ops import kernels as K
from qrec_tpu_torch.ops.spmm import (
    DenseJoint,
    DenseMat,
    DeviceCOO,
    coo_matmul,
    lightgcn_propagate,
    spmm,
    view_adjacency,
)
from test_torch_lightgcn import _both, _conf


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# only f32 products and sums, in another order: rtol 1e-5, atol 1e-6
F32 = dict(rtol=1e-5, atol=1e-6)
# bf16-rounded operands: the bound of the dual-vs-XLA JAX test
BF16 = dict(rtol=5e-3, atol=5e-3)


def _random_csr(m, n, density, seed, empty_rows=(), empty_cols=()):
    rng = np.random.RandomState(seed)
    a = (rng.rand(m, n) < density) * rng.rand(m, n).astype(np.float32)
    a[list(empty_rows)] = 0
    a[:, list(empty_cols)] = 0
    return sp.csr_matrix(a.astype(np.float32))


# (rows, cols): square but not symmetric, wide, tall
SHAPES = {"square": (30, 30), "wide": (12, 41), "tall": (41, 12)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_device_coo_product_and_gradients_match_jax(shape):
    m, n = SHAPES[shape]
    mat = _random_csr(m, n, 0.2, seed=m + n, empty_rows=(0, 5), empty_cols=(3,))
    jcoo = jspmm.DeviceCOO.from_host(jgraph.COO.from_scipy(mat))
    adj = DeviceCOO.from_scipy(mat, "cpu")
    assert (adj.num_rows, adj.num_cols) == (m, n) and int(adj.indptr[-1]) == mat.nnz
    rng = np.random.RandomState(7)
    x = rng.randn(n, 6).astype(np.float32)
    w = rng.randn(m, 6).astype(np.float32)
    v = rng.rand(mat.nnz).astype(np.float32)

    def jloss(xx, vv):
        return jnp.sum(jnp.asarray(w) * jspmm.spmm(jcoo, xx, vv))

    want = np.asarray(jspmm.spmm(jcoo, jnp.asarray(x)))
    jdx, jdv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(v))
    got = spmm(adj, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (m, 6)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert not got[[0, 5]].any()
    tx = torch.from_numpy(x).requires_grad_(True)
    tv = torch.from_numpy(v).requires_grad_(True)
    (spmm(adj, tx, tv) * torch.from_numpy(w)).sum().backward()
    # dx = Aᵀ @ dy over the transposed order: not the forward on a square A
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **F32)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jdv), **F32)
    assert not tx.grad[3].any()
    # the product is the forward, and a repeat gives the same bits
    torch.testing.assert_close(coo_matmul(adj, torch.from_numpy(x), adj.vals), got,
                               rtol=0, atol=0)
    torch.testing.assert_close(spmm(adj, torch.from_numpy(x)), got, rtol=0, atol=0)


def test_device_coo_checks_row_order():
    mat = _random_csr(8, 8, 0.4, seed=1)
    coo = tgraph.COO.from_scipy(mat)
    bad = tgraph.COO(coo.rows[::-1].copy(), coo.cols, coo.vals, coo.shape)
    with pytest.raises(AssertionError, match="row-sorted"):
        DeviceCOO.from_host(bad, "cpu")


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_dense_mat_product_and_gradient_match_jax(shape):
    m, n = SHAPES[shape]
    mat = _random_csr(m, n, 0.3, seed=m * n)
    jmat = jspmm.DenseMat.from_scipy(mat)
    adj = DenseMat.from_scipy(mat, "cpu")
    assert adj.mat.dtype == torch.bfloat16 and adj.num_rows == m
    np.testing.assert_array_equal(adj.mat.float().numpy(), np.asarray(jmat.mat.astype(jnp.float32)))
    rng = np.random.RandomState(3)
    x = rng.randn(n, 5).astype(np.float32)
    w = rng.randn(m, 5).astype(np.float32)
    want = np.asarray(jspmm.spmm(jmat, jnp.asarray(x)))
    jdx = jax.grad(lambda xx: jnp.sum(jnp.asarray(w) * jspmm.spmm(jmat, xx)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = spmm(adj, tx)
    assert got.dtype == torch.float32
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **BF16)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **BF16)
    # the JAX gradient reaches x through the bf16 cast: bf16-valued, as here
    assert (tx.grad.bfloat16().float() == tx.grad).all()
    assert np.array_equal(np.asarray(jdx), np.asarray(jdx.astype(jnp.bfloat16).astype(jnp.float32)))
    with pytest.raises(ValueError, match="sparse"):
        spmm(adj, tx, torch.ones(3))


def _jax_joint(jd, quant, dual):
    return jspmm.DenseJoint.from_interactions(jd, dual=dual, dual_interpret=True, quant=quant)


@pytest.mark.parametrize(
    "quant,dual", [("off", True), ("off", False), ("int8", False)],
    ids=["bf16-dual-on", "bf16-dual-off", "int8"],
)
@pytest.mark.parametrize("items", [24, 33])
def test_dense_joint_forms_propagate_as_jax(quant, dual, items):
    jd, td = _both(items=items)
    jadj = _jax_joint(jd, quant if quant == "int8" else "off", dual)
    assert (jadj.r_hat_p is not None) == dual
    adj = DenseJoint.from_interactions(td, "cpu", quant)
    assert adj.form == quant and adj.r.shape == (td.num_users, K.aligned_width(td.num_items))
    assert not adj.r[:, td.num_items:].any()
    if quant == "off":
        assert adj.r.dtype == torch.bfloat16
        np.testing.assert_array_equal(adj.r[:, : td.num_items].float().numpy(),
                                      np.asarray(jadj.r_hat.astype(jnp.float32)))
        assert (adj.row_scale == 1).all() and (adj.col_scale == 1).all()
    else:
        assert adj.r.dtype == torch.int8
        np.testing.assert_array_equal(adj.r[:, : td.num_items].numpy(), np.asarray(jadj.q8))
        np.testing.assert_array_equal(adj.row_scale.numpy(), np.asarray(jadj.row_scale))
        assert jadj.col_scale is None and (adj.col_scale == 1).all()
        assert adj.r.max() == 127 and adj.r.min() >= 0  # not binary
    rng = np.random.RandomState(items)
    e = rng.randn(adj.num_rows, 6).astype(np.float32)
    w = rng.randn(adj.num_rows, 6).astype(np.float32)
    jout = jspmm.lightgcn_propagate(jadj, jnp.asarray(e), 2)
    jgrad = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * jspmm.lightgcn_propagate(jadj, v, 2)))(
        jnp.asarray(e)
    )
    x = torch.from_numpy(e).requires_grad_(True)
    before = K.launch_counts()
    out = lightgcn_propagate(adj, x, 2)
    (out * torch.from_numpy(w)).sum().backward()
    assert K.launch_counts() == before  # CPU tensors: the plain version
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **BF16)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **BF16)
    # one application through the wrapper is its plain version, which is
    # the JAX package's step for step: f32 sums in another order
    one = K.factored_dual_matmul(adj.r, torch.from_numpy(e), adj.row_scale, adj.col_scale)
    np.testing.assert_allclose(one.numpy(), np.asarray(jspmm.spmm(jadj, jnp.asarray(e))),
                               rtol=1e-5, atol=1e-6)


def test_view_adjacency_follows_the_backend():
    _, td = _both()
    rows, cols, _, n = tgraph.joint_bipartite_coo(td)
    coo = view_adjacency(rows, cols, n, "cpu", "coo")
    seg = view_adjacency(rows, cols, n, "cpu", "auto")
    assert isinstance(coo, DeviceCOO) and type(seg).__name__ == "SparseJoint"
    v = torch.rand(len(rows))
    x = torch.randn(n, 4)
    dense = np.zeros((n, n), np.float32)
    dense[rows, cols] = v.numpy()
    want = dense @ x.numpy()
    np.testing.assert_allclose(spmm(coo, x, v).numpy(), want, **F32)
    # the segment kernel rounds the values and x to bf16: 2^-8 relative each
    bound = 2.0**-7 * (np.abs(dense) @ np.abs(x.numpy()))
    assert (np.abs(spmm(seg, x, v).numpy() - want) <= bound + 1e-6).all()


# ---------------------------------------------------------------------------
# LightGCN on each form
# ---------------------------------------------------------------------------

FORMS = {
    "coo": {"graph.backend": "coo"},
    "bf16-dual-on": {"graph.dense.quant": "off", "graph.dense.dual": "on"},
    "bf16-dual-off": {"graph.dense.quant": "off", "graph.dense.dual": "off"},
    "int8": {"graph.dense.quant": "int8"},
}
JAX_FORM = {
    "coo": jspmm.DeviceCOO, "bf16-dual-on": jspmm.DenseJoint, "bf16-dual-off": jspmm.DenseJoint,
    "int8": jspmm.DenseJoint,
}


def _lightgcn_pair(form):
    extra = dict(FORMS[form], **{"num.max.epoch": "3"})
    jd, td = _both(extra)
    jmodel = JLightGCN(jconfig.ModelConf(_conf(extra)), jd)
    spec = jmodel.build()
    tmodel = LightGCN(ModelConf(_conf(extra)), td, device="cpu")
    tmodel.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in spec.params.items()},
                                           "cpu"))
    assert isinstance(jmodel.joint_adj, JAX_FORM[form])
    if form == "bf16-dual-on":
        assert jmodel.joint_adj.r_hat_p is not None
    return jmodel, spec, tmodel


def _torch_batch(batch):
    u, i, j, w = (np.asarray(a) for a in batch)
    idx = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    return idx(u), idx(i), idx(j), torch.from_numpy(w.astype(np.float32))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_lightgcn_first_step_on_each_form_matches_jax(form, capsys):
    jmodel, spec, tmodel = _lightgcn_pair(form)
    want_type = DeviceCOO if form == "coo" else DenseJoint
    assert isinstance(tmodel.joint_adj, want_type)
    if want_type is DenseJoint:
        assert tmodel.joint_adj.form == FORMS[form]["graph.dense.quant"]
    built = {"coo": "DeviceCOO f32 gather and segment sum", "int8": "DenseJoint int8 per-row scale"}
    assert built.get(form, "DenseJoint bf16, dual kernel") in capsys.readouterr().out
    batch = jax.tree_util.tree_map(lambda x: x[0], spec.sampler(jax.random.PRNGKey(0)))
    want, grads = jax.value_and_grad(spec.loss_fn)(spec.params, batch, jax.random.PRNGKey(1),
                                                   spec.consts)
    loss = tmodel.loss(_torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    tol = F32 if form == "coo" else BF16
    for name, g in grads.items():
        np.testing.assert_allclose(getattr(tmodel, name).grad.numpy(), np.asarray(g), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_lightgcn_three_epochs_on_each_form_match_jax(form):
    jmodel, spec, tmodel = _lightgcn_pair(form)
    optimizer = optax.adam(jmodel.lrate)
    run_epoch = jtrainer.make_epoch_runner(spec.loss_fn, optimizer)
    params, opt_state = spec.params, optimizer.init(spec.params)
    rng = jax.random.PRNGKey(0)
    batches, jlosses = [], []
    for _ in range(3):
        rng, rs, rt = jax.random.split(rng, 3)
        b = spec.sampler(rs)
        batches.append(tuple(np.asarray(a) for a in b))
        params, opt_state, loss = run_epoch(params, opt_state, b, rt, spec.consts)
        jlosses.append(float(loss))
    losses = tmodel.fit(epoch_batches=batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for name in ("user_emb", "item_emb"):
        np.testing.assert_allclose(getattr(tmodel, name).detach().numpy(),
                                   np.asarray(params[name]), atol=1e-4, err_msg=name)
    assert tmodel.U.shape == (tmodel.num_users, 8)
