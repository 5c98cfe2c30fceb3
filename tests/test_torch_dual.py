"""The dual product's layout and entries in the PyTorch port, on the CPU:
the factored entry's plain version against the JAX package's ``_int8_call``,
the padded R of ``DenseJoint`` (I not a multiple of 16) against the JAX
package's propagation and SGL views, the kernel's region plan, and the
device rule of the model classes. The CUDA kernel itself is held against
these plain versions in ``test_torch_kernels_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrec_tpu.ops import spmm as jspmm
from qrec_tpu_torch.ops import kernels as K
from qrec_tpu_torch.ops.spmm import (
    DenseJoint,
    factored_call,
    factored_edge_drop_view,
    factored_node_drop_view,
    lightgcn_propagate,
    pad_table,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_factored_plain_matches_int8_call(tiny_data):
    jadj = jspmm.DenseJoint.from_interactions(tiny_data, quant="factored")
    adj = DenseJoint.from_interactions(tiny_data, "cpu")
    assert adj.num_items == tiny_data.num_items < 16 and adj.r.shape[1] == 16
    x = np.random.RandomState(4).randn(adj.num_rows, 8).astype(np.float32)
    want = jspmm._int8_call(jadj.q8, jadj.q8_t, jadj.row_scale, jadj.col_scale, jnp.asarray(x))
    got = K.factored_dual_matmul_plain(adj.r, torch.from_numpy(x), adj.row_scale, adj.col_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the wrapper on CPU tensors is the plain version, and so is factored_call
    assert torch.equal(K.factored_dual_matmul(adj.r, torch.from_numpy(x), adj.row_scale,
                                              adj.col_scale), got)
    assert torch.equal(factored_call(adj, torch.from_numpy(x)), got)


@pytest.mark.parametrize("items", [17, 24, 33])
def test_dense_joint_with_unaligned_items_propagates_as_jax(items):
    from test_torch_lightgcn import _both

    jd, td = _both(items=items)
    jadj = jspmm.DenseJoint.from_interactions(jd, quant="factored")
    adj = DenseJoint.from_interactions(td, "cpu")
    assert adj.r.shape == (td.num_users, K.aligned_width(td.num_items))
    assert adj.num_rows == td.num_users + td.num_items
    assert not adj.r[:, td.num_items:].any()
    rng = np.random.RandomState(items)
    e = rng.randn(adj.num_rows, 6).astype(np.float32)
    w = rng.randn(adj.num_rows, 6).astype(np.float32)
    jout = jspmm.lightgcn_propagate(jadj, jnp.asarray(e), 2)
    jgrad = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * jspmm.lightgcn_propagate(jadj, v, 2)))(
        jnp.asarray(e)
    )
    x = torch.from_numpy(e).requires_grad_(True)
    out = lightgcn_propagate(adj, x, 2)
    (out * torch.from_numpy(w)).sum().backward()
    # bf16-rounded layer inputs: the bound of the dual-vs-XLA JAX test
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=5e-3, atol=5e-3)


def _bits(key, n):
    return torch.from_numpy(
        np.asarray(jax.random.bits(key, (n,), dtype=jnp.uint32)).astype(np.int64)
    )


def _padded_r(u=23, i=41, seed=3):
    rb = (np.random.RandomState(seed).rand(u, i) < 0.2).astype(np.int8)
    rb[0] = 0  # a user without edges
    adj = DenseJoint.from_tables(torch.from_numpy(rb), torch.ones(u), torch.ones(i))
    return rb, adj


def test_edge_drop_view_keeps_the_padding_zero():
    rb, adj = _padded_r()
    assert adj.r.shape == (23, 48)
    rng = jax.random.PRNGKey(7)
    q8v, _, su, si = jspmm.factored_edge_drop_view(rng, jnp.asarray(rb), jnp.asarray(rb.T), 0.3)
    ku, ki = jax.random.split(rng)
    edges = torch.nonzero(adj.r, as_tuple=True)
    view = factored_edge_drop_view(adj, edges, _bits(ku, 23), _bits(ki, 41), 0.3)
    assert view.r.shape == adj.r.shape and not view.r[:, 41:].any()
    assert view.num_items == 41 and view.col_scale.shape == (41,)
    np.testing.assert_array_equal(view.r[:, :41].numpy(), np.asarray(q8v))
    np.testing.assert_allclose(view.row_scale.numpy(), np.asarray(su), rtol=3e-7, atol=0)
    np.testing.assert_allclose(view.col_scale.numpy(), np.asarray(si), rtol=3e-7, atol=0)


def test_node_drop_view_on_the_padded_table():
    rb, adj = _padded_r(seed=4)
    rng = jax.random.PRNGKey(8)
    _, _, su, si = jspmm.factored_node_drop_view(rng, jnp.asarray(rb), jnp.asarray(rb.T), 0.3)
    ku = np.array(jax.random.bernoulli(rng, 0.7, (23,)))
    ki = np.array(jax.random.bernoulli(jax.random.fold_in(rng, 1), 0.7, (41,)))
    view = factored_node_drop_view(adj, torch.from_numpy(ku), torch.from_numpy(ki))
    assert view.r is adj.r and view.col_scale.shape == (41,)
    np.testing.assert_allclose(view.row_scale.numpy(), np.asarray(su), rtol=3e-7, atol=0)
    np.testing.assert_allclose(view.col_scale.numpy(), np.asarray(si), rtol=3e-7, atol=0)


def test_pad_table_and_unaligned_dual_call():
    r = torch.from_numpy((np.random.RandomState(0).rand(5, 16) < 0.5).astype(np.int8))
    assert pad_table(r) is r  # already a multiple of 16
    xu = torch.randn(5, 3).bfloat16()
    xi = torch.randn(13, 3).bfloat16()
    ou, oi = K.bipartite_dual_matmul(r[:, :13].contiguous(), xu, xi)
    pu, pi = K.bipartite_dual_matmul(pad_table(r[:, :13].contiguous()), xu,
                                     torch.cat([xi, torch.zeros(3, 3).bfloat16()]))
    assert torch.equal(ou, pu) and torch.equal(oi, pi[:13])


# (U, ld, d): the lastfm main path, SimGCL's fused views, SGL's degrees and
# the yelp2018 shape, with the most columns a region holds in the kernel's
# shared memory and its tile rows at those widths (qrec_dual_max_cols,
# qrec_dual_tile_rows)
@pytest.mark.parametrize("u,ld,d,bn_max,tm", [(1892, 16592, 50, 384, 128), (1892, 16592, 150, 128, 64),
                                              (1892, 16592, 1, 512, 128), (19539, 21280, 64, 384, 64)])
def test_dual_plan_covers_r_and_bounds_the_partials(u, ld, d, bn_max, tm):
    bm, bn = K._dual_plan(u, ld, d, bn_max, 132, tm)
    assert bm % tm == 0 and bn % 64 == 0 and 0 < bn <= bn_max
    n_rs, n_cs = -(-u // bm), -(-ld // bn)
    assert (n_rs - 1) * bm < u <= n_rs * bm and (n_cs - 1) * bn < ld <= n_cs * bn
    n = -(-d // 8) * 8
    partial = (n_cs * u + n_rs * ld) * n * 4
    if d <= 64:  # the main paths: partials within R's own bytes, SMs filled
        assert partial <= u * ld
        assert n_rs * n_cs >= 128
    if (u, d) == (1892, 50):
        assert n_rs >= 2 and n_cs >= 2


@pytest.mark.parametrize("name", ["LightGCN", "NGCF", "SGL", "SimGCL"])
def test_models_default_to_the_card(tiny_data, monkeypatch, name):
    from qrec_tpu_torch.config import ModelConf
    from qrec_tpu_torch.data.dataset import Interactions
    from qrec_tpu_torch.errors import DeviceUnavailableError
    from qrec_tpu_torch.models import get_model

    conf = ModelConf({
        "ratings": "unused", "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 5", "num.factors": "8",
        "num.max.epoch": "1", "batch_size": "16", "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.2 -s 0.2", "output.setup": "off -dir ./results/",
        name: "-n_layer 2 -lambda 0.1 -droprate 0.2 -augtype 1 -temp 0.2 -eps 0.1",
    })
    rng = np.random.RandomState(0)
    train = [[f"u{u}", f"i{i}", 1.0] for u in range(5) for i in rng.choice(9, 4, replace=False)]
    data = Interactions(conf, train, train[:3])
    cls = get_model(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        cls(conf, data)
    assert cls(conf, data, device="cpu").device == torch.device("cpu")
