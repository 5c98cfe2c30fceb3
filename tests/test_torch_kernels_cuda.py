"""The port's CUDA kernels and its main path on a CUDA card, each against
its plain PyTorch version. Every test here is marked ``cuda`` and skips
without a card. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.ops import kernels as K
from qrec_tpu_torch.ops.metrics import parse_measure
from qrec_tpu_torch.ops.spmm import (
    DenseJoint,
    SparseJoint,
    lightgcn_propagate,
    segment_operand,
    spmm,
)
from qrec_tpu_torch.parallel.collectives import split_range

CONFIG = Path(__file__).resolve().parents[1] / "config"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dual_operands(device, u, i, d, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    mask = torch.rand((u, i), generator=g, device=device) < 0.05
    a = mask.to(dtype) if dtype == torch.int8 else (mask * torch.rand((u, i), generator=g, device=device)).to(dtype)
    xu = torch.randn((u, d), generator=g, device=device).bfloat16()
    xi = torch.randn((i, d), generator=g, device=device).bfloat16()
    return a, xu, xi


# ragged U and I (1, 15, 17 and the lastfm item count) at every width the
# paths use (d=1 SGL's degrees, 50, 64, 150 SimGCL's fused views) and the
# bounds of the tensor-core N (8, 256)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 8, 16, 50, 64, 130, 150, 256])
@pytest.mark.parametrize("u,i", [(37, 211), (600, 1100), (1, 15), (15, 17), (17, 1), (64, 16591)])
def test_dual_kernel_matches_plain(cuda_device, u, i, d, dtype):
    a, xu, xi = _dual_operands(cuda_device, u, i, d, dtype)
    before = K.DUAL.launches
    ou, oi = K.bipartite_dual_matmul(a, xu, xi)
    assert K.DUAL.launches == before + 1
    pu, pi = K.bipartite_dual_matmul_plain(a, xu, xi)
    torch.cuda.synchronize()
    torch.testing.assert_close(ou, pu, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(oi, pi, rtol=1e-5, atol=1e-4)
    ou2, oi2 = K.bipartite_dual_matmul(a, xu, xi)
    assert torch.equal(ou, ou2) and torch.equal(oi, oi2)  # no atomics: repeats bit for bit


def _factored_operands(device, u, i, d, seed=1):
    rng = np.random.RandomState(seed)
    rb = (rng.rand(u, i) < 0.05).astype(np.int8)
    su = (1.0 / np.sqrt(np.maximum(rb.sum(1), 1))).astype(np.float32)
    si = (1.0 / np.sqrt(np.maximum(rb.sum(0), 1))).astype(np.float32)
    x = rng.randn(u + i, d).astype(np.float32)
    adj = DenseJoint.from_tables(*(torch.from_numpy(t).to(device) for t in (rb, su, si)))
    return adj, torch.from_numpy(x).to(device)


# the fused entry sums exactly what the unscaled one does (the same regions,
# the same order), and scales as the unfused sequence does: bit for bit
@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 50, 64, 150])
@pytest.mark.parametrize("u,i", [(15, 17), (300, 901), (1892, 16591)])
def test_factored_entry_matches_plain_and_unfused(cuda_device, u, i, d):
    adj, x = _factored_operands(cuda_device, u, i, d)
    assert adj.r.shape[1] % 16 == 0 and not adj.r[:, i:].any()
    before = K.DUAL.launches
    y = K.factored_dual_matmul(adj.r, x, adj.row_scale, adj.col_scale)
    assert K.DUAL.launches == before + 1
    su, si = adj.row_scale[:, None], adj.col_scale[:, None]
    ou, oi = K.bipartite_dual_matmul(
        adj.r, (x[:u] * su).bfloat16(),
        torch.cat([(x[u:] * si).bfloat16(), x.new_zeros((adj.r.shape[1] - i, d)).bfloat16()]),
    )
    assert torch.equal(y, torch.cat([ou * su, oi[:i] * si]))
    plain = K.factored_dual_matmul_plain(adj.r, x, adj.row_scale, adj.col_scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, plain, rtol=1e-5, atol=1e-5 * float(plain.abs().max()))
    assert torch.equal(K.factored_dual_matmul(adj.r, x, adj.row_scale, adj.col_scale), y)


@pytest.mark.cuda
def test_dual_regions_split_both_sides(cuda_device):
    # the lastfm shape puts several regions on each side: ou sums several
    # column partials, oi several row partials
    u, i, d = 1892, 16591, 50
    bn_max, tm, sms = K._dual_limits(cuda_device, d, True)
    bm, bn = K._dual_plan(u, K.aligned_width(i), d, bn_max, sms, tm)
    assert -(-u // bm) >= 2 and -(-K.aligned_width(i) // bn) >= 2
    a, xu, xi = _dual_operands(cuda_device, u, i, d, torch.int8, seed=3)
    ou, oi = K.bipartite_dual_matmul(a, xu, xi)
    pu, pi = K.bipartite_dual_matmul_plain(a, xu, xi)
    torch.testing.assert_close(ou, pu, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(oi, pi, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_dual_kernel_rejects_unpadded_table(cuda_device):
    r = torch.zeros((4, 20), dtype=torch.int8, device=cuda_device)
    x = torch.zeros((24, 3), device=cuda_device)
    with pytest.raises(ValueError):
        K.factored_dual_matmul(r, x, torch.ones(4, device=cuda_device), torch.ones(20, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("b,i,d", [(8, 5000, 16), (100, 33, 3), (1024, 17632, 50)])
def test_scores_kernel_matches_plain(cuda_device, b, i, d):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    u = torch.randn((b, d), generator=g, device=cuda_device)
    v = torch.randn((i, d), generator=g, device=cuda_device)
    words = -(-i // 32)
    bm = torch.randint(-(2**31), 2**31 - 1, (b, words), generator=g, device=cuda_device,
                       dtype=torch.int64).to(torch.int32)
    before = K.SCORES.launches
    s = K.masked_catalog_scores(u, v, bm, 0.0)
    assert K.SCORES.launches == before + 1
    p = K.masked_catalog_scores_plain(u, v, bm, 0.0)
    torch.cuda.synchronize()
    rated = K.expand_bitmask(bm, i)
    assert (s[rated] == 0).all()
    torch.testing.assert_close(s, p, rtol=1e-5, atol=1e-5)


def _topk_inputs(device, b, i, d, seed=0):
    """A user table, items, bitmask and a batch of uids (-1 and repeats)
    with planted ties (duplicated items, a zero user row: its scores tie
    with the masked zeros), a user row of NaN, one of +-inf and an item
    row holding inf."""
    g = torch.Generator(device=device).manual_seed(seed)
    u_n = max(b, 64)
    user = torch.randn((u_n, d), generator=g, device=device)
    items = torch.randn((i, d), generator=g, device=device)
    if i > 8:
        items[i // 2 :: 7] = items[1]  # equal scores: the lower item first
        items[3] = float("inf")
    user[5] = 0.0
    user[6, 0] = float("nan")
    user[7, d // 2] = float("inf")
    words = -(-i // 32)
    bitmask = torch.randint(-(2**31), 2**31 - 1, (u_n, words), generator=g, device=device,
                            dtype=torch.int64).to(torch.int32)
    bitmask[::3] &= 0x01010101  # rows with few rated items
    uids = torch.randint(0, u_n, (b,), generator=g, device=device)
    uids[: min(b, 8)] = torch.arange(min(b, 8), device=device)  # the planted rows
    uids[7::11] = -1
    if b > 20:
        uids[20] = uids[19]
    return user, items, bitmask, uids


def _scores_then_sort(user, items, bitmask, uids, gm, k):
    """K2's scores entry on the gathered rows, the unseen rows filled, a
    stable sort and the first k: what the fused entry must equal."""
    from chip_smoke import scores_then_sort

    return scores_then_sort(torch, K.masked_catalog_scores, user, items, bitmask, uids, gm, k)


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# the fused top-k bit for bit against the scores entry and a stable sort
# (NaN, +-inf, -0.0 and ties included), repeated bit for bit, its counters
# back at 0 and one launch a call
@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16, 50, 64, 150, 300])
@pytest.mark.parametrize("i", [33, 5000, 16591, 21266])
@pytest.mark.parametrize("b", [1, 100, 1024, 4001])
def test_topk_kernel_matches_scores_and_sort(cuda_device, b, i, d):
    user, items, bitmask, uids = _topk_inputs(cuda_device, b, i, d, seed=b + i + d)
    gm = 0.125
    for k in sorted({1, 10, 20, 100, i} & set(range(1, min(100, i) + 1))):
        before = K.TOPK.launches
        ids, vals = K.masked_catalog_topk(user, items, bitmask, uids, gm, k)
        assert K.TOPK.launches == before + 1
        want_ids, want = _scores_then_sort(user, items, bitmask, uids, gm, k)
        torch.cuda.synchronize()
        assert ids.shape == (b, k) and vals.shape == (b, k)
        bad = (ids != want_ids).any(1).nonzero().flatten()[:3].tolist()
        assert not bad, (k, bad, ids[bad], want_ids[bad], vals[bad], want[bad])
        assert _same_bits(vals, want), k
        again = K.masked_catalog_topk(user, items, bitmask, uids, gm, k)
        assert torch.equal(again[0], ids) and _same_bits(again[1], vals)
        assert not K.masked_catalog_topk_counters(cuda_device).any()


# other plans than the default: one split, as many as allowed, 64-row
# tiles, features staged in slices of 64 at a width that fits whole; a plan
# the kernel cannot run (too many splits, a block too large for an SM)
# raises
@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(128, 0, 1000), (128, 0, 8), (64, 0, 17), (64, 0, 33),
                                  (64, 0, 1), (128, 64, 17), (64, 64, 33)])
@pytest.mark.parametrize("k", [1, 20, 100])
def test_topk_kernel_plans(cuda_device, plan, k):
    b, i, d = 300, 16591, 150
    user, items, bitmask, uids = _topk_inputs(cuda_device, b, i, d, seed=k)
    bm, sl, tps = plan
    splits = -(-(-(-i // 64)) // tps)
    fits = K.SCORES.load().qrec_masked_blocks_per_sm(bm, d, sl, k, splits) >= 1
    if not fits or splits > K.CATALOG_MAX_SPLITS:
        with pytest.raises(RuntimeError):  # a CUDA tensor never takes the plain version
            K.masked_catalog_topk(user, items, bitmask, uids, 0.5, k, plan=plan)
        return
    ids, vals = K.masked_catalog_topk(user, items, bitmask, uids, 0.5, k, plan=plan)
    want_ids, want = _scores_then_sort(user, items, bitmask, uids, 0.5, k)
    torch.cuda.synchronize()
    assert torch.equal(ids, want_ids) and _same_bits(vals, want)
    assert not K.masked_catalog_topk_counters(cuda_device).any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,i,d,k", [(1024, 16591, 50, 10), (1024, 21266, 64, 20),
                                     (1024, 16591, 150, 10), (100, 33, 300, 33)])
def test_topk_kernel_is_one_cuda_kernel(cuda_device, b, i, d, k):
    from chip_smoke import kernels_per_call

    user, items, bitmask, uids = _topk_inputs(cuda_device, b, i, d)
    assert kernels_per_call(
        torch, lambda: K.masked_catalog_topk(user, items, bitmask, uids, 0.0, k)) == 1
    assert not K.masked_catalog_topk_counters(cuda_device).any()


def _biases(device, u_n, i, which, seed):
    """The score form's item bias (I,), user bias (U,) and offset, each where
    ``which`` names it."""
    g = torch.Generator(device=device).manual_seed(seed)
    ib = torch.randn(i, generator=g, device=device) * 0.5 if "item" in which else None
    ub = torch.randn(u_n, generator=g, device=device) * 0.5 if "user" in which else None
    return ib, ub, 0.375 if "offset" in which else 0.0


# the bias epilogue (SVD's and MostPopular's score forms): bit for bit
# against the scores entry with an all-zero mask, the adds in torch in the
# kernel's order, the mask, the unseen rows and a stable sort (NaN, +-inf
# and ties included); unseen users keep items 0..k-1 at the global mean;
# counters back at 0
@pytest.mark.cuda
@pytest.mark.parametrize("which", ["item", "user", "offset", "item+offset", "item+user+offset"])
@pytest.mark.parametrize("d", [1, 10, 50, 150])
def test_topk_bias_epilogue_matches_unfused(cuda_device, d, which):
    from chip_smoke import scores_then_sort

    b, i, gm = 1000, 2071, 0.25
    user, items, bitmask, uids = _topk_inputs(cuda_device, b, i, d, seed=d)
    ib, ub, offset = _biases(cuda_device, user.shape[0], i, which, seed=d + 1)
    bias = dict(item_bias=ib, user_bias=ub, offset=offset)
    for k in (1, 10, 20, 100):
        before = K.TOPK.launches
        ids, vals = K.masked_catalog_topk(user, items, bitmask, uids, gm, k, **bias)
        assert K.TOPK.launches == before + 1
        want_ids, want = scores_then_sort(torch, K.masked_catalog_scores, user, items, bitmask,
                                          uids, gm, k, **bias)
        torch.cuda.synchronize()
        bad = (ids != want_ids).any(1).nonzero().flatten()[:3].tolist()
        assert not bad, (k, bad, ids[bad], want_ids[bad], vals[bad], want[bad])
        assert _same_bits(vals, want), k
        unseen = uids < 0
        assert (ids[unseen] == torch.arange(k, device=cuda_device)).all()
        assert (vals[unseen] == gm).all()
        assert not K.masked_catalog_topk_counters(cuda_device).any()
    with pytest.raises(RuntimeError):  # the biased epilogue runs 64-row blocks only
        K.masked_catalog_topk(user, items, bitmask, uids, gm, 10, plan=(128, 0, 3), **bias)


# the bias epilogue against its plain version (cuBLAS's sums in another
# order): ids equal except in rows whose scores differ by at most 1e-5, at
# finite inputs of the scale training leaves
@pytest.mark.cuda
@pytest.mark.parametrize("which", ["none", "item", "user", "item+user+offset"])
@pytest.mark.parametrize("k", [1, 10, 20, 100])
@pytest.mark.parametrize("d", [1, 10, 50, 150])
def test_topk_bias_epilogue_matches_plain(cuda_device, d, k, which):
    b, i, gm = 1000, 2071, 0.25
    user, items, bitmask, uids = _topk_inputs(cuda_device, b, i, d, seed=k + d)
    user[5:8] = torch.randn((3, d), device=cuda_device)
    items[3] = items[4]
    user, items = user * 0.1, items * 0.1
    ib, ub, offset = _biases(cuda_device, user.shape[0], i, which, seed=k)
    bias = dict(item_bias=ib, user_bias=ub, offset=offset)
    ids, vals = K.masked_catalog_topk(user, items, bitmask, uids, gm, k, **bias)
    pids, pvals = K.masked_catalog_topk_plain(user, items, bitmask, uids, gm, k, **bias)
    torch.cuda.synchronize()
    rows_equal = (ids == pids).all(1)
    near = (vals - pvals).abs().max(1).values <= 1e-5
    assert bool((rows_equal | near).all())
    assert rows_equal.float().mean() > 0.9


# without a bias or an offset the kernel takes the epilogue it had before
# them: the same call as before (an offset of -0.0 selects it too), which
# keeps a dot product that underflows to -0.0; zero biases go through the
# adds, which make it +0.0 and change nothing else
@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 64])
def test_topk_no_bias_path_keeps_its_bits(cuda_device, d):
    b, i, k = 64, 100, 100
    user, items, bitmask, uids = _topk_inputs(cuda_device, b, i, d, seed=3)
    user[:8] = 1e-30
    items[10:20] = -1e-30  # products of -1e-60: -0.0 where d is a multiple of 4
    ids, vals = K.masked_catalog_topk(user, items, bitmask, uids, 0.0, k)
    neg_ids, neg_vals = K.masked_catalog_topk(user, items, bitmask, uids, 0.0, k, offset=-0.0)
    zero_ids, zero_vals = K.masked_catalog_topk(
        user, items, bitmask, uids, 0.0, k, item_bias=torch.zeros(i, device=cuda_device),
        user_bias=torch.zeros(user.shape[0], device=cuda_device))
    torch.cuda.synchronize()
    negative_zero = lambda v: torch.signbit(v) & (v == 0)  # noqa: E731
    assert torch.equal(ids, neg_ids) and _same_bits(vals, neg_vals)
    assert negative_zero(vals).any()
    assert torch.equal(zero_ids, ids)
    torch.testing.assert_close(zero_vals, vals, rtol=0, atol=0, equal_nan=True)  # -0.0 == +0.0
    assert not negative_zero(zero_vals).any()


# widths past the old tests' 50, whole and in slices: the same products
# summed in another order than cuBLAS, each score within d 2^-23 of the sum
# of its terms' magnitudes
@pytest.mark.cuda
@pytest.mark.parametrize("b,i,d", [(1024, 16591, 150), (300, 2000, 256), (64, 1000, 300)])
def test_scores_kernel_matches_plain_wide(cuda_device, b, i, d):
    user, items, bitmask, _ = _topk_inputs(cuda_device, b, i, d)
    user, bitmask = user[:b].clone(), bitmask[:b].clone()
    user[5:8] = torch.randn((3, d), device=cuda_device)  # finite rows here
    items[3] = items[4]
    s = K.masked_catalog_scores(user, items, bitmask, 0.0)
    p = K.masked_catalog_scores_plain(user, items, bitmask, 0.0)
    bound = d * 2.0**-23 * (user.abs() @ items.abs().T)
    rated = K.expand_bitmask(bitmask, i)
    torch.cuda.synchronize()
    assert (s[rated] == 0).all()
    assert ((s - p).abs() <= bound).all()


@pytest.mark.cuda
def test_scores_kernel_same_bits_at_any_plan(cuda_device):
    # the slices of 64 features sum in the order of the whole width
    user, items, bitmask, _ = _topk_inputs(cuda_device, 256, 3000, 150)
    whole = K.masked_catalog_scores(user, items, bitmask, 0.0)
    lib = K.SCORES.load()
    for bm, sl, tps in [(64, 64, 3), (128, 64, 47), (64, 0, 1)]:
        out = torch.empty_like(whole)
        err = lib.qrec_masked_scores(user.data_ptr(), items.data_ptr(), bitmask.data_ptr(),
                                     out.data_ptr(), 256, 3000, 150, bitmask.shape[1], 0.0, bm,
                                     sl, tps, torch.cuda.current_stream().cuda_stream)
        assert err == 0
        torch.cuda.synchronize()
        assert _same_bits(out, whole), (bm, sl, tps)


@pytest.mark.cuda
def test_propagation_and_gradient_on_card_match_cpu(cuda_device):
    g = np.random.RandomState(0)
    u, i, d = 300, 900, 50
    rb = (g.rand(u, i) < 0.02).astype(np.int8)
    su = (1.0 / np.sqrt(np.maximum(rb.sum(1), 1))).astype(np.float32)
    si = (1.0 / np.sqrt(np.maximum(rb.sum(0), 1))).astype(np.float32)
    x = g.randn(u + i, d).astype(np.float32)
    w = g.randn(u + i, d).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda_device):
        adj = DenseJoint.from_tables(*(torch.from_numpy(a).to(dev) for a in (rb, su, si)))
        xt = torch.tensor(x, device=dev, requires_grad=True)
        out = lightgcn_propagate(adj, xt, 2)
        (out * torch.from_numpy(w).to(dev)).sum().backward()
        outs.append((out.detach().cpu(), xt.grad.cpu()))
    # layer outputs are re-rounded to bf16 between layers, so a sum order
    # difference can flip one rounding: the bound of the JAX dual-vs-XLA test
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
def test_qrec_learns_planted_blocks_on_card(cuda_device, tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(
        f"u{u} i{i} 1\n"
        for u in range(40)
        for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)
    ))
    conf = ModelConf({
        "ratings": str(path), "ratings.setup": "-columns 0 1 2", "model.name": "LightGCN",
        "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10", "num.factors": "16",
        "num.max.epoch": "30", "batch_size": "64", "learnRate": "-init 0.05 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1", "LightGCN": "-n_layer 2",
        "output.setup": "off -dir ./results/", "seed": "7",
    })
    before = K.launch_counts()
    recall = parse_measure(QRec(conf, seed=3).execute())["Top 10"]["Recall"]
    after = K.launch_counts()
    # LightGCN's path: K1 and K2's fused top-k, never the InfoNCE kernels
    # nor the scores entry (the ranker writes no (B, I) block)
    assert after["bipartite_dual_matmul"] > before["bipartite_dual_matmul"]
    assert after["masked_catalog_topk"] > before["masked_catalog_topk"]
    assert after["masked_catalog_scores"] == before["masked_catalog_scores"]
    assert after["infonce_fwd"] == before["infonce_fwd"]
    assert after["infonce_bwd"] == before["infonce_bwd"]
    assert recall > 0.5


# the MF slice's bundled confs on the card (a small synthetic file, 2
# epochs): every ranking but Rand's runs K2's top-k, a rating run no kernel
@pytest.mark.cuda
@pytest.mark.parametrize(
    "name", ["BasicMF", "PMF", "SVD", "BPR", "UserMean", "ItemMean", "MostPopular", "Rand"])
def test_mf_slice_confs_run_on_card(cuda_device, tmp_path, name):
    rng = np.random.RandomState(1)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(f"{u} {i} {rng.randint(1, 9) / 2}\n" for u in range(300)
                            for i in rng.choice(500, size=12, replace=False)))
    conf = ModelConf(str(CONFIG / f"{name}.conf"))
    conf["ratings"] = str(path)
    conf["num.max.epoch"] = "2"
    conf["output.setup"] = f"off -dir {tmp_path}/"
    K.reset_launch_counts()
    parsed = parse_measure(QRec(conf).execute())
    counts = K.launch_counts()
    ranks = conf.options("item.ranking").isMainOn()
    assert counts.pop("masked_catalog_topk") == (1 if ranks and name != "Rand" else 0)
    assert not any(counts.values())
    assert parsed["Top 10" if ranks else "global"]


def _infonce_inputs(device, b, d, masked=(), zero_row=None, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x1 = torch.randn((b, d), generator=g, device=device)
    x2 = x1 + 0.5 * torch.randn((b, d), generator=g, device=device)
    if zero_row is not None:
        x1[zero_row] = 0.0
    v1, v2 = (x * torch.rsqrt(torch.clamp_min((x * x).sum(1, keepdim=True), 1e-12)) for x in (x1, x2))
    mask = torch.ones(b, device=device)
    mask[list(masked)] = 0.0
    return v1.contiguous(), v2.contiguous(), mask


# logits of unit vectors / 0.2 lie in [-5, 5]; the kernels sum d products
# and B exponentials in another order than the plain versions (cuBLAS f32,
# logsumexp): allow 1e-5 relative on the loss and lse, and on the
# cotangents 1e-4 relative plus 1e-5 of the largest. Widths span K4's three
# feature layouts (<= 64, <= 128, <= 256); batches its ragged row and
# column tiles (128 and 64 rows at d <= 64) and SGL's merged B=4000
@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 16, 50, 64, 150, 256])
@pytest.mark.parametrize("b", [1, 127, 300, 2000, 4000, 4001])
def test_infonce_kernels_match_plain(cuda_device, b, d):
    masked = tuple(range(0, b, 9)) if b > 1 else ()
    v1, v2, m = _infonce_inputs(cuda_device, b, d, masked, zero_row=b // 2 if b > 1 else None)
    before = K.launch_counts()
    loss, lse = K.infonce_fwd(v1, v2, m, m, 0.2)
    d1, d2 = K.infonce_bwd(v1, v2, m, m, lse, 0.2)
    after = K.launch_counts()
    assert after["infonce_fwd"] == before["infonce_fwd"] + 1
    assert after["infonce_bwd"] == before["infonce_bwd"] + 1
    ploss, plse = K.infonce_fwd_plain(v1, v2, m, m, 0.2)
    p1, p2 = K.infonce_bwd_plain(v1, v2, m, m, plse, 0.2)
    torch.cuda.synchronize()
    torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    for got, want in ((d1, p1), (d2, p2)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))
    # no atomics: a second call repeats bit for bit
    loss2, lse2 = K.infonce_fwd(v1, v2, m, m, 0.2)
    e1, e2 = K.infonce_bwd(v1, v2, m, m, lse, 0.2)
    assert torch.equal(loss, loss2) and torch.equal(lse, lse2)
    assert torch.equal(d1, e1) and torch.equal(d2, e2)


@pytest.mark.cuda
def test_infonce_kernels_row_offset_and_full_mask(cuda_device):
    v1, v2, m = _infonce_inputs(cuda_device, 700, 50, masked=(650, 699), zero_row=400, seed=1)
    rows = slice(300, 700)  # the second block of rows of a 700-row batch
    a, rm = v1[rows].contiguous(), m[rows].contiguous()
    loss, lse = K.infonce_fwd(a, v2, m, rm, 0.2, row_offset=300)
    d1, d2 = K.infonce_bwd(a, v2, m, rm, lse, 0.2, row_offset=300)
    ploss, plse = K.infonce_fwd_plain(a, v2, m, rm, 0.2, row_offset=300)
    p1, p2 = K.infonce_bwd_plain(a, v2, m, rm, plse, 0.2, row_offset=300)
    torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d1, p1, rtol=1e-4, atol=1e-5 * float(p1.abs().max()))
    torch.testing.assert_close(d2, p2, rtol=1e-4, atol=1e-5 * float(p2.abs().max()))
    zeros = torch.zeros_like(m)
    loss, lse = K.infonce_fwd(v1, v2, zeros, zeros, 0.2)
    d1, d2 = K.infonce_bwd(v1, v2, zeros, zeros, lse, 0.2)
    assert float(loss) == 0.0 and bool((d1 == 0).all()) and bool((d2 == 0).all())


# a row block of a larger batch whose positives lie off the grid's diagonal
# tiles: local row r meets its positive in column r + row_offset
@pytest.mark.cuda
@pytest.mark.parametrize("d", [50, 150])
@pytest.mark.parametrize("b,start,stop", [(700, 300, 700), (2000, 1100, 1700)])
def test_infonce_bwd_row_block_off_the_grid_diagonal(cuda_device, b, start, stop, d):
    v1, v2, m = _infonce_inputs(cuda_device, b, d, masked=tuple(range(5, b, 11)), seed=d)
    a, rm = v1[start:stop].contiguous(), m[start:stop].contiguous()
    loss, lse = K.infonce_fwd(a, v2, m, rm, 0.2, row_offset=start)
    d1, d2 = K.infonce_bwd(a, v2, m, rm, lse, 0.2, row_offset=start)
    _, plse = K.infonce_fwd_plain(a, v2, m, rm, 0.2, row_offset=start)
    p1, p2 = K.infonce_bwd_plain(a, v2, m, rm, plse, 0.2, row_offset=start)
    torch.cuda.synchronize()
    assert d1.shape == (stop - start, d) and d2.shape == (b, d)
    torch.testing.assert_close(d1, p1, rtol=1e-4, atol=1e-5 * float(p1.abs().max()))
    torch.testing.assert_close(d2, p2, rtol=1e-4, atol=1e-5 * float(p2.abs().max()))
    e1, e2 = K.infonce_bwd(a, v2, m, rm, lse, 0.2, row_offset=start)
    assert torch.equal(d1, e1) and torch.equal(d2, e2)


# K3 alone: the forward at a row block off the grid's diagonal, against the
# plain version at the tolerance above
@pytest.mark.cuda
@pytest.mark.parametrize("d", [50, 150])
@pytest.mark.parametrize("b,start,stop", [(700, 300, 700), (2000, 1100, 1700), (4000, 64, 3000)])
def test_infonce_fwd_row_block_off_the_grid_diagonal(cuda_device, b, start, stop, d):
    v1, v2, m = _infonce_inputs(cuda_device, b, d, masked=tuple(range(5, b, 11)), seed=d + 1)
    a, rm = v1[start:stop].contiguous(), m[start:stop].contiguous()
    loss, lse = K.infonce_fwd(a, v2, m, rm, 0.2, row_offset=start)
    ploss, plse = K.infonce_fwd_plain(a, v2, m, rm, 0.2, row_offset=start)
    torch.cuda.synchronize()
    assert lse.shape == (stop - start,)
    torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)


# K3's column splits: one split for the whole batch (the block merges its
# own rows), and a row tile over up to 63 splits; each plan against the
# plain version, repeated bit for bit, its counters back at 0
@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(128, 63), (128, 5), (128, 1), (64, 1), (64, 2)])
def test_infonce_fwd_column_splits(cuda_device, plan):
    b, d = 4001, 50
    v1, v2, m = _infonce_inputs(cuda_device, b, d, masked=tuple(range(0, b, 13)), zero_row=7)
    loss, lse = K.infonce_fwd(v1, v2, m, m, 0.2, plan=plan)
    ploss, plse = K.infonce_fwd_plain(v1, v2, m, m, 0.2)
    again = K.infonce_fwd(v1, v2, m, m, 0.2, plan=plan)
    torch.cuda.synchronize()
    torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    assert torch.equal(loss, again[0]) and torch.equal(lse, again[1])
    assert not K.infonce_fwd_counters(cuda_device).any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(1, 1), (300, 16), (2000, 50), (4000, 50), (4001, 256)])
def test_infonce_fwd_counters_back_at_zero(cuda_device, b, d):
    v1, v2, m = _infonce_inputs(cuda_device, b, d, masked=tuple(range(0, b, 7)))
    for rows in (slice(0, b), slice(b // 3, b)):
        a, rm = v1[rows].contiguous(), m[rows].contiguous()
        K.infonce_fwd(a, v2, m, rm, 0.2, row_offset=rows.start)
        torch.cuda.synchronize()
        counters = K.infonce_fwd_counters(cuda_device)
        assert counters is not None and not counters.any(), counters


# one CUDA kernel a call: the kernel nodes of a CUDA graph captured from one
# call (the split partials are merged by the block that finishes last)
@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(2000, 50), (4000, 50), (300, 150)])
def test_infonce_fwd_is_one_cuda_kernel(cuda_device, b, d):
    from chip_smoke import kernels_per_call

    v1, v2, m = _infonce_inputs(cuda_device, b, d, masked=(3, b - 1))
    assert kernels_per_call(torch, lambda: K.infonce_fwd(v1, v2, m, m, 0.2)) == 1
    assert not K.infonce_fwd_counters(cuda_device).any()


@pytest.mark.cuda
def test_infonce_loss_gradients_on_card_match_cpu(cuda_device):
    from qrec_tpu_torch.ops.losses import infonce_dispatch

    g = np.random.RandomState(2)
    x1 = g.randn(2000, 50).astype(np.float32)
    x2 = (x1 + 0.3 * g.randn(2000, 50)).astype(np.float32)
    x1[7] = 0.0
    mask = (g.rand(2000) > 0.1).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda_device):
        t1 = torch.tensor(x1, device=dev, requires_grad=True)
        t2 = torch.tensor(x2, device=dev, requires_grad=True)
        loss = infonce_dispatch(t1, t2, torch.tensor(mask, device=dev), 0.2)
        loss.backward()
        outs.append((loss.detach().cpu(), t1.grad.cpu(), t2.grad.cpu()))
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,args",
    [("SimGCL", "-n_layer 2 -lambda 0.05 -eps 0.1"),
     ("SGL", "-n_layer 2 -lambda 0.05 -droprate 0.2 -augtype 1 -temp 0.2")],
)
def test_ssl_models_learn_planted_blocks_on_card(cuda_device, tmp_path, name, args):
    rng = np.random.RandomState(0)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(
        f"u{u} i{i} 1\n"
        for u in range(40)
        for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)
    ))
    conf = ModelConf({
        "ratings": str(path), "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10", "num.factors": "16",
        "num.max.epoch": "30", "batch_size": "64", "learnRate": "-init 0.05 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1", name: args,
        "output.setup": "off -dir ./results/", "seed": "7",
    })
    before = K.launch_counts()
    recall = parse_measure(QRec(conf, seed=3).execute())["Top 10"]["Recall"]
    after = K.launch_counts()
    # the dense path: every kernel but the segment SpMM and K2's scores
    # entry (the ranker takes the fused top-k)
    idle = ("weighted_segment_matmul", "masked_catalog_scores")
    assert all(after[k] > before[k] for k in after if k not in idle)
    assert all(after[k] == before[k] for k in idle)
    assert recall > 0.5


def _skewed_csr(n, mean_deg, heavy=(), empty=(), seed=0):
    """A symmetric CSR graph on n nodes with about ``mean_deg`` edges a row,
    rows ``heavy`` joined to (up to) every other node and rows ``empty``
    without edges; values in (0, 1]. Returns (rows, cols, vals) numpy,
    lexsorted."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, n, size=n * mean_deg // 2)
    b = rng.randint(0, n, size=len(a))
    for h in heavy:
        others = np.arange(n)
        a, b = np.r_[a, np.full(n, h)], np.r_[b, others]
    keep = (a != b) & ~np.isin(a, empty) & ~np.isin(b, empty)
    key = np.unique(np.minimum(a, b)[keep].astype(np.int64) * n + np.maximum(a, b)[keep])
    u, v = key // n, key % n
    rows, cols = np.r_[u, v], np.r_[v, u]
    vals = np.r_[rng.rand(len(u)), rng.rand(len(u))].astype(np.float32) + 1e-3
    vals[len(u):] = vals[: len(u)]
    order = np.lexsort((cols, rows))
    return rows[order].astype(np.int32), cols[order].astype(np.int32), vals[order]


def _csr_tensors(rows, cols, vals, n, device):
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return t(indptr, torch.int32), t(cols, torch.int32), t(vals, torch.float32)


def _order_bound(indptr, x, cols, vals):
    """Twice (deg - 1) 2^-24 of every element's sum of absolute terms: the
    most two f32 sums of the same deg exact products, taken in different
    orders, can differ (each is within (deg - 1) 2^-24 of the exact sum)."""
    indptr, x, cols, vals = (t.cpu() for t in (indptr, x, cols, vals))
    absum = K.weighted_segment_matmul_plain(x.abs(), indptr, cols, vals.abs())
    return 2.0 * indptr.diff().float()[:, None] * 2.0**-24 * absum


def _check_segment(out, x, indptr, c, v, schedule=None):
    """``out`` against the plain version: rows of at most 2 edges bit for
    bit, every row within the order bound, the schedule's counters back at
    0. The kernel's lane groups each sum a share of the tile's edges in edge
    order, and a row that crosses a share's or a tile's edge adds those
    partial sums in order: for 3 or more edges that can be another f32
    order than the plain version's sequential sum (_order_bound); 1 or 2
    products sum the same either way."""
    torch.cuda.synchronize()
    want = K.weighted_segment_matmul_plain(x.cpu(), indptr.cpu(), c.cpu(), v.cpu())
    got = out.cpu()
    short = indptr.diff().cpu() <= 2
    assert torch.equal(got[short], want[short])
    assert ((got - want).abs() <= _order_bound(indptr, x, c, v)).all()
    if schedule is not None:
        assert not schedule.counters.any()


def _segment_graph(device, n, mean_deg, heavy=(), empty=(), seed=0, tile=None):
    rows, cols, vals = _skewed_csr(n, mean_deg, heavy=heavy, empty=empty, seed=seed)
    indptr, c, v = _csr_tensors(rows, cols, vals, n, device)
    return indptr, c, v, K.segment_schedule(indptr, tile=tile)


# every width class of the kernel: 16-byte lanes at 1, 8, 64 and 256 lanes a
# row of 1 to 32 lanes, the padded rows of d=50 and 150 (as _segment_call
# casts them) and their unpadded rows (4-byte lanes); tiles of the default
# size and of 64 edges (rows split over many tiles and warps)
@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None, 64])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("d", [1, 8, 50, 64, 150, 256])
def test_segment_kernel_matches_plain(cuda_device, d, padded, tile):
    n = 3000
    indptr, c, v, s = _segment_graph(cuda_device, n, 12, heavy=(7, 1500), empty=(0, 1, 2999),
                                     seed=d, tile=tile)
    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn((n, d), generator=g, device=cuda_device).bfloat16()
    if padded:
        xp = torch.full((n, K.segment_row_stride(d)), float("nan"), device=cuda_device).bfloat16()
        xp[:, :d] = x
        x = xp[:, :d]  # NaN in the padding never reaches a result
    before = K.SEGMM.launches
    out = K.weighted_segment_matmul(x, indptr, c, v, s)
    assert K.SEGMM.launches == before + 1
    _check_segment(out, x, indptr, c, v, s)
    got = out.cpu()
    assert (got[[0, 1, n - 1]] == 0).all()
    # on the card the plain version sums with atomics: the same bound
    plain = K.weighted_segment_matmul_plain(x, indptr, c, v).cpu()
    assert ((got - plain).abs() <= _order_bound(indptr, x, c, v)).all()
    # no atomics: a second call repeats bit for bit
    assert torch.equal(K.weighted_segment_matmul(x, indptr, c, v, s), out)


@pytest.mark.cuda
def test_segment_kernel_long_row_and_zero_values(cuda_device):
    n = 12000
    indptr, c, v, s = _segment_graph(cuda_device, n, 4, heavy=(5,), empty=(9, 10), seed=3)
    assert int(indptr[6] - indptr[5]) > 10000  # one 10,000-edge row
    assert (s.split_row == 5).any() and s.split_tiles.numel() >= 10000 // s.tile  # over many tiles
    x = torch.randn((n, 64), device=cuda_device).bfloat16()
    out = K.weighted_segment_matmul(x, indptr, c, v, s)
    _check_segment(out, x, indptr, c, v, s)
    assert (out[9:11] == 0).all()
    zeros = K.weighted_segment_matmul(x, indptr, c, torch.zeros_like(v), s)
    assert (zeros == 0).all()
    # values that round to bf16: 1 + 2^-9 rounds to 1 (ties to even)
    ones = torch.full_like(v, 1.0 + 2.0**-9)
    torch.testing.assert_close(
        K.weighted_segment_matmul(x, indptr, c, ones, s),
        K.weighted_segment_matmul(x, indptr, c, torch.ones_like(v), s), rtol=0, atol=0,
    )
    assert not s.counters.any()


@pytest.mark.cuda
@pytest.mark.parametrize("deg,tile", [(5, 4), (3, 4), (9, 8), (700, 512)])
def test_segment_kernel_every_row_split(cuda_device, deg, tile):
    # rows of deg edges over tiles of `tile`: every row (or nearly) crosses
    # a tile edge, and the last block to arrive completes each one
    n = 4000 if deg < 100 else 300
    rng = np.random.RandomState(deg)
    indptr = torch.arange(0, n * deg + 1, deg, dtype=torch.int32, device=cuda_device)
    c = torch.as_tensor(rng.randint(0, n, size=n * deg).astype(np.int32), device=cuda_device)
    v = torch.as_tensor(rng.rand(n * deg).astype(np.float32), device=cuda_device)
    s = K.segment_schedule(indptr, tile=tile)
    if deg % tile and tile % deg:
        assert s.split_row.numel() >= n // 2
    x = torch.randn((n, 64), device=cuda_device).bfloat16()
    out = K.weighted_segment_matmul(x, indptr, c, v, s)
    _check_segment(out, x, indptr, c, v, s)
    assert torch.equal(K.weighted_segment_matmul(x, indptr, c, v, s), out)


# x whose base or row stride 16 bytes do not divide: the kernel takes 8-,
# 4- or 2-byte vectors (a view at an odd element, a row stride of d + 1)
@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 50, 64])
@pytest.mark.parametrize("offset,extra", [(4, 0), (2, 0), (1, 0), (0, 1), (3, 1)])
def test_segment_kernel_unaligned_x(cuda_device, d, offset, extra):
    n = 2000
    indptr, c, v, s = _segment_graph(cuda_device, n, 10, heavy=(3,), seed=d)
    ld = d + extra
    flat = torch.randn(offset + n * ld, device=cuda_device).bfloat16()
    x = flat[offset:].view(n, ld)[:, :d]
    assert x.data_ptr() % 16 or x.stride(0) % 8
    out = K.weighted_segment_matmul(x, indptr, c, v, s)
    _check_segment(out, x, indptr, c, v, s)


@pytest.mark.cuda
def test_segment_kernel_new_values_on_one_schedule(cuda_device):
    # SGL's views: the values change every call, the schedule stays
    n = 5000
    indptr, c, v, s = _segment_graph(cuda_device, n, 8, heavy=(11,), seed=4, tile=256)
    x = torch.randn((n, 50), device=cuda_device).bfloat16()
    for seed in (1, 2):
        vals = torch.rand(v.shape, generator=torch.Generator(device=cuda_device).manual_seed(seed),
                          device=cuda_device)
        out = K.weighted_segment_matmul(x, indptr, c, vals, s)
        _check_segment(out, x, indptr, c, vals, s)


@pytest.mark.cuda
def test_segment_kernel_is_one_cuda_kernel(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 3000
    indptr, c, v, s = _segment_graph(cuda_device, n, 12, heavy=(7,), seed=1, tile=128)
    assert s.split_row.numel() > 0
    x = torch.randn((n, 64), device=cuda_device).bfloat16()
    K.weighted_segment_matmul(x, indptr, c, v, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        K.weighted_segment_matmul(x, indptr, c, v, s)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    # the output is torch.empty: no kernel but the segment kernel
    assert sum(e.count for e in kernels) == 1, [e.key for e in kernels]
    assert not s.counters.any()


@pytest.mark.cuda
def test_segment_autograd_on_card_matches_cpu(cuda_device):
    from qrec_tpu_torch.data.graph import COO

    n, d = 2000, 50
    rows, cols, vals = _skewed_csr(n, 10, heavy=(3,), seed=5)
    coo = COO(rows, cols, vals, (n, n))
    g = np.random.RandomState(1)
    x = g.randn(n, d).astype(np.float32)
    w = g.randn(n, d).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda_device):
        adj = SparseJoint.from_host(coo, dev)
        xt = torch.tensor(x, device=dev, requires_grad=True)
        vt = adj.vals.clone().requires_grad_(True)
        before = K.SEGMM.launches
        out = spmm(adj, spmm(adj, xt, vt), vt)
        (out * torch.from_numpy(w).to(dev)).sum().backward()
        if dev != "cpu":
            assert K.SEGMM.launches == before + 4  # two forward, two backward
        outs.append((out.detach().cpu(), xt.grad.cpu(), vt.grad.cpu()))
    # the second layer re-rounds its input to bf16, so a sum-order
    # difference can flip one rounding: the bf16 bound of the dense test
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)


# a data rank's row block of a larger CSR, as ops/spmm.ShardedSparseJoint
# cuts it: K5 with rows= gathers from every row of x and writes the block
# only; against the plain twin of the block and the whole product's rows.
# Widths: a feature slice of d=50 over two model ranks (25), d=50 and 64
@pytest.mark.cuda
@pytest.mark.parametrize("d", [25, 50, 64])
@pytest.mark.parametrize("parts", [2, 3])
def test_segment_kernel_row_block(cuda_device, d, parts):
    n = 3000
    indptr, c, v, _ = _segment_graph(cuda_device, n, 12, heavy=(7, 1500), empty=(0, 2999), seed=d)
    g = torch.Generator(device=cuda_device).manual_seed(parts)
    x = segment_operand(torch.randn((n, d), generator=g, device=cuda_device))
    whole = K.weighted_segment_matmul_plain(x.cpu(), indptr.cpu(), c.cpu(), v.cpu())
    for p in range(parts):
        r0, r1 = split_range(n, parts, p)
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        local = (indptr[r0: r1 + 1] - e0).contiguous()
        cc, vv = c[e0:e1].contiguous(), v[e0:e1].contiguous()
        s = K.segment_schedule(local)
        before = K.SEGMM.launches
        out = K.weighted_segment_matmul(x, local, cc, vv, s, rows=r1 - r0)
        assert K.SEGMM.launches == before + 1 and out.shape == (r1 - r0, d)
        _check_segment(out, x, local, cc, vv, s)
        assert ((out.cpu() - whole[r0:r1]).abs() <= _order_bound(local, x, cc, vv)).all()
        assert torch.equal(K.weighted_segment_matmul(x, local, cc, vv, s, rows=r1 - r0), out)


# the row-sharded InfoNCE's two data ranks (ops/losses.ShardedInfoNCELoss):
# K3 and K4 on each half of the rows at its row_offset against their plain
# twins, and the halves' losses and dv2 shares summed against the whole
# batch's, at the tolerance of test_infonce_kernels_match_plain
@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 50, 150])
@pytest.mark.parametrize("b", [2000, 2001])
def test_infonce_kernels_on_row_halves(cuda_device, b, d):
    v1, v2, m = _infonce_inputs(cuda_device, b, d, masked=tuple(range(3, b, 13)), zero_row=7,
                                seed=b + d)
    loss, lse = K.infonce_fwd(v1, v2, m, m, 0.2)
    d1, d2 = K.infonce_bwd(v1, v2, m, m, lse, 0.2)
    total, d2_sum = torch.zeros_like(loss), torch.zeros_like(d2)
    for half in range(2):
        o0, o1 = split_range(b, 2, half)
        a, rm = v1[o0:o1].contiguous(), m[o0:o1].contiguous()
        part, plse = K.infonce_fwd(a, v2, m, rm, 0.2, row_offset=o0)
        p1, p2 = K.infonce_bwd(a, v2, m, rm, plse, 0.2, row_offset=o0)
        want, wlse = K.infonce_fwd_plain(a, v2, m, rm, 0.2, row_offset=o0)
        w1, w2 = K.infonce_bwd_plain(a, v2, m, rm, wlse, 0.2, row_offset=o0)
        torch.cuda.synchronize()
        torch.testing.assert_close(part, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(plse, wlse, rtol=1e-5, atol=1e-5)
        for got, ref in ((p1, w1), (p2, w2), (p1, d1[o0:o1])):
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()))
        total += part
        d2_sum += p2
    torch.testing.assert_close(total, loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d2_sum, d2, rtol=1e-4, atol=1e-5 * float(d2.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,args,extra",
    [("LightGCN", "-n_layer 2", {"graph.backend": "pallas"}),
     ("SGL", "-n_layer 2 -lambda 0.05 -droprate 0.2 -augtype 1 -temp 0.2",
      {"graph.backend": "pallas"}),
     ("NGCF", None, {})],
)
def test_sparse_and_ngcf_paths_learn_planted_blocks_on_card(
    cuda_device, tmp_path, name, args, extra
):
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
        "num.max.epoch": "30", "batch_size": "64", "learnRate": "-init 0.05 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1",
        "output.setup": "off -dir ./results/", "seed": "7", **extra,
    }
    if args:
        conf[name] = args
    before = K.launch_counts()
    recall = parse_measure(QRec(ModelConf(conf), seed=3).execute())["Top 10"]["Recall"]
    after = K.launch_counts()
    sparse = bool(extra)
    assert (after["weighted_segment_matmul"] > before["weighted_segment_matmul"]) == sparse
    assert (after["bipartite_dual_matmul"] > before["bipartite_dual_matmul"]) == (not sparse)
    assert recall > 0.5


# ---------------------------------------------------------------------------
# the social slice: the bf16 Ŝ and legacy int8 forms on K1, DeviceCOO,
# DenseMat and the five models
# ---------------------------------------------------------------------------


def _dense_form(device, u, i, form, seed=5):
    """A normalized (U, I) Ŝ of 5% density as the bf16 form (unit scales)
    or the legacy int8 form (rint(127 r / rowmax), row scale rowmax / 127,
    unit column scale), as ``DenseJoint.from_interactions`` builds them."""
    rng = np.random.RandomState(seed)
    r = ((rng.rand(u, i) < 0.05) * rng.rand(u, i)).astype(np.float32)
    r[0] = 0  # a user without an edge
    ones_u, ones_i = torch.ones(u, device=device), torch.ones(i, device=device)
    if form == "off":
        table = torch.from_numpy(r).to(device=device, dtype=torch.bfloat16)
        return DenseJoint.from_tables(table, ones_u, ones_i, "off")
    smax = r.max(axis=1)
    scale = np.where(smax > 0, smax / 127.0, 1.0).astype(np.float32)
    q = np.rint(r / scale[:, None]).astype(np.int8)
    return DenseJoint.from_tables(torch.from_numpy(q).to(device), torch.from_numpy(scale).to(device),
                                  ones_i, "int8")


# the bf16-Ŝ route: the symmetric autograd Function, one K1 call forward
# and one backward, each against the plain version on the same operands
@pytest.mark.cuda
@pytest.mark.parametrize("form", ["off", "int8"])
@pytest.mark.parametrize("d", [1, 50, 150])
@pytest.mark.parametrize("u,i", [(15, 17), (300, 901), (1892, 16591)])
def test_dense_forms_forward_and_backward_match_plain(cuda_device, u, i, d, form):
    from qrec_tpu_torch.ops.spmm import joint_matmul

    adj = _dense_form(cuda_device, u, i, form)
    assert adj.r.shape[1] % 16 == 0 and not adj.r[:, i:].any()
    assert adj.r.dtype == (torch.bfloat16 if form == "off" else torch.int8)
    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn((u + i, d), generator=g, device=cuda_device).requires_grad_(True)
    w = torch.randn((u + i, d), generator=g, device=cuda_device)
    before = K.DUAL.launches
    y = joint_matmul(adj, x)
    (y * w).sum().backward()
    assert K.DUAL.launches == before + 2  # forward, then the same call on the cotangent
    plain = K.factored_dual_matmul_plain(adj.r, x.detach(), adj.row_scale, adj.col_scale)
    plain_dx = K.factored_dual_matmul_plain(adj.r, w, adj.row_scale, adj.col_scale)
    torch.cuda.synchronize()
    for got, want in ((y.detach(), plain), (x.grad, plain_dx)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    again = K.factored_dual_matmul(adj.r, x.detach(), adj.row_scale, adj.col_scale)
    assert torch.equal(again, y.detach())  # repeats bit for bit
    if form == "off":
        # unit scales change no bit: the unscaled entry on bf16(x) gives
        # the same sums in the same order
        xb = x.detach().bfloat16()
        xi = torch.zeros((adj.r.shape[1], d), dtype=torch.bfloat16, device=cuda_device)
        xi[:i] = xb[u:]
        ou, oi = K.bipartite_dual_matmul(adj.r, xb[:u].contiguous(), xi)
        assert torch.equal(y.detach(), torch.cat([ou, oi[:i]]))


def _coo_operands(device, m, n, seed=3):
    import scipy.sparse as sp

    from qrec_tpu_torch.ops.spmm import DeviceCOO

    rng = np.random.RandomState(seed)
    mat = sp.random(m, n, density=0.02, format="csr", random_state=rng, dtype=np.float32)
    return DeviceCOO.from_scipy(mat, device), DeviceCOO.from_scipy(mat, "cpu")


# DeviceCOO repeats bit for bit on the card (segment sums in a fixed order,
# no atomics), forward and through the transposed order backward
@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(1892, 1892), (1892, 16591), (16591, 1892)])
def test_device_coo_repeats_bit_for_bit(cuda_device, m, n):
    adj, cpu = _coo_operands(cuda_device, m, n)
    g = torch.Generator().manual_seed(m + n)
    x0, w0 = torch.randn((n, 50), generator=g), torch.randn((m, 50), generator=g)
    outs = []
    for _ in range(2):
        x = x0.to(cuda_device).requires_grad_(True)
        y = spmm(adj, x)
        (y * w0.to(cuda_device)).sum().backward()
        outs.append((y.detach(), x.grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    xc = x0.clone().requires_grad_(True)
    yc = spmm(cpu, xc)
    (yc * w0).sum().backward()
    torch.testing.assert_close(outs[0][0].cpu(), yc.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[0][1].cpu(), xc.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_dense_mat_on_card_matches_the_cpu(cuda_device):
    import scipy.sparse as sp

    from qrec_tpu_torch.ops.spmm import DenseMat

    rng = np.random.RandomState(4)
    mat = sp.random(300, 700, density=0.1, format="csr", random_state=rng, dtype=np.float32)
    x0 = torch.from_numpy(rng.randn(700, 50).astype(np.float32))
    w0 = torch.from_numpy(rng.randn(300, 50).astype(np.float32))
    outs = []
    for device in ("cpu", cuda_device):
        adj = DenseMat.from_scipy(mat, device)
        x = x0.to(device).clone().requires_grad_(True)
        y = spmm(adj, x)
        assert y.dtype == torch.float32
        (y * w0.to(device)).sum().backward()
        outs.append((y.detach().cpu(), x.grad.cpu()))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
    # the gradient is bf16-rounded: a sum-order difference may flip a rounding
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=8e-3, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,args,extra",
    [("MHCN", "-n_layer 2 -ss_rate 0.01", {}),
     ("SEPT", "-n_layer 2 -ss_rate 0.005 -drop_rate 0.3 -ins_cnt 5", {}),
     ("BUIR", "-n_layer 2 -tau 0.99 -drop_rate 0.2",
      {"learnRate": "-init 0.01 -max 1", "num.max.epoch": "40"}),
     ("DiffNet", "-n_layer 2", {"graph.aux.dense": "on"}),
     ("DHCF", None, {}),
     ("LightGCN", "-n_layer 2", {"graph.dense.quant": "off"}),
     ("LightGCN", "-n_layer 2", {"graph.dense.quant": "int8"}),
     ("LightGCN", "-n_layer 2", {"graph.backend": "coo"})],
)
def test_social_slice_learns_planted_blocks_on_card(cuda_device, tmp_path, name, args, extra):
    rng = np.random.RandomState(0)
    ratings, trust = tmp_path / "ratings.txt", tmp_path / "trust.txt"
    ratings.write_text("".join(
        f"u{u} i{i} 1\n"
        for u in range(40)
        for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)
    ))
    trust.write_text("".join(
        [f"u{u} u{f} 1\n" for u in range(40)
         for f in rng.choice(20, size=4, replace=False) + (0 if u < 20 else 20) if f != u]
        + [f"u{u} u{u ^ 1} 1\n" for u in range(40)]
    ))
    conf = {
        "ratings": str(ratings), "ratings.setup": "-columns 0 1 2", "social": str(trust),
        "social.setup": "-columns 0 1 2", "model.name": name, "evaluation.setup": "-ap 0.2",
        "item.ranking": "on -topN 10", "num.factors": "16", "num.max.epoch": "30",
        "batch_size": "64", "learnRate": "-init 0.05 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1",
        "output.setup": "off -dir ./results/", "seed": "7", **extra,
    }
    if args:
        conf[name] = args
    K.reset_launch_counts()
    recall = parse_measure(QRec(ModelConf(conf), seed=3).execute())["Top 10"]["Recall"]
    counts = K.launch_counts()
    assert counts["masked_catalog_topk"] > 0  # every model ranks through K2
    joint = name in ("SEPT", "BUIR") or (name == "LightGCN" and "graph.backend" not in extra)
    assert (counts["bipartite_dual_matmul"] > 0) == joint
    assert (counts["weighted_segment_matmul"] > 0) == (name == "BUIR")
    assert recall > (0.35 if name == "BUIR" else 0.5)


def _planted_als(name, device, epochs=10):
    """``name`` on tests/test_als_models.py's planted blocks (binary for the
    ALS models, 3-5 stars for SVD++), fitted on ``device``; SVD++'s
    epochs run on batches drawn on the CPU, so that both devices train on
    the same ones. Returns the model."""
    import random

    from qrec_tpu_torch.data.dataset import Interactions
    from qrec_tpu_torch.data.split import data_split
    from qrec_tpu_torch.models import get_model

    rng = np.random.RandomState(0)
    rated = name == "SVDPlusPlus"
    records = [[f"u{u}", f"i{i}", float(rng.randint(3, 6)) if rated else 1.0]
               for u in range(40) for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)]
    conf = ModelConf({
        "ratings": "unused", "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10", "num.factors": "8",
        "num.max.epoch": str(epochs), "batch_size": "64", "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.1 -i 0.1 -b 0.1 -s 0.1", "output.setup": "off -dir ./results/",
        "seed": "7", "CoFactor": "-k 2 -gamma 0.1 -filter 1", "SVDPlusPlus": "-y 0.01",
    })
    train, test = data_split(records, 0.2, rng=random.Random(3))
    model = get_model(name)(conf, Interactions(conf, train, test), device=device)
    if rated:
        cpu = get_model(name)(conf, Interactions(conf, train, test), device="cpu")
        sampler = cpu.rating_sampler()
        gen = torch.Generator().manual_seed(5)
        model.fit(epoch_batches=[sampler(gen) for _ in range(epochs)])
    else:
        model.fit()
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["WRMF", "SVDPlusPlus"])
def test_als_and_svdpp_tables_on_card_match_cpu(cuda_device, name):
    """The batched solves (WRMF) and the implicit-mean segment sums (SVD++)
    on the card against the CPU, on the same initial tables and batches."""
    card = _planted_als(name, cuda_device)
    cpu = _planted_als(name, "cpu")
    for got, want in ((card.U, cpu.U), (card.V, cpu.V)):
        want = want.numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["CoFactor", "SVDPlusPlus"])
def test_seeded_segment_sum_models_repeat_on_card(cuda_device, name):
    """CoFactor's context blocks and SVD++'s implicit mean are segment sums
    with no atomics, so two seeded runs on the card give the same bits."""
    runs = [_planted_als(name, cuda_device) for _ in range(2)]
    assert torch.equal(runs[0].U, runs[1].U) and torch.equal(runs[0].V, runs[1].V)
    if name == "CoFactor":
        for key in ("g", "w", "c"):
            assert torch.equal(runs[0].tables[key], runs[1].tables[key])
    else:
        assert runs[0].epoch_losses == runs[1].epoch_losses


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["WRMF", "ExpoMF", "CoFactor", "SERec", "SVD++"])
def test_als_slice_ranks_through_k2_on_card(cuda_device, tmp_path, name):
    """The four ALS models and SVD++ (its bias epilogue) rank the planted
    blocks through K2's fused top-k, the ALS models above
    tests/test_als_models.py's floors."""
    rng = np.random.RandomState(0)
    ratings, trust = tmp_path / "ratings.txt", tmp_path / "trust.txt"
    ratings.write_text("".join(f"u{u} i{i} {rng.randint(3, 6) if name == 'SVD++' else 1}\n"
                               for u in range(40)
                               for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)))
    trust.write_text("".join(f"u{u} u{f} 1\n" for u in range(40)
                             for f in rng.choice(20, size=3, replace=False) + (0 if u < 20 else 20) if f != u))
    conf = ModelConf(str(CONFIG / f"{name}.conf"))
    for key, value in (("ratings", str(ratings)), ("social", str(trust)), ("social.setup", "-columns 0 1 2"),
                       ("evaluation.setup", "-ap 0.2"), ("item.ranking", "on -topN 10"),
                       ("num.factors", "8"), ("num.max.epoch", "10"), ("batch_size", "64"),
                       ("reg.lambda", "-u 0.1 -i 0.1 -b 0.1 -s 0.1"), ("seed", "7"),
                       ("output.setup", "off -dir ./results/")):
        conf[key] = value
    if name == "CoFactor":
        conf["CoFactor"] = "-k 2 -gamma 0.1 -filter 1"
    K.reset_launch_counts()
    recall = parse_measure(QRec(conf, seed=3).execute())["Top 10"]["Recall"]
    counts = K.launch_counts()
    assert counts["masked_catalog_topk"] == 1 and sum(counts.values()) == 1
    floor = {"WRMF": 0.6, "ExpoMF": 0.5, "CoFactor": 0.55, "SERec": 0.5}.get(name, 0.0)
    assert recall > floor


# ---------------------------------------------------------------------------
# the walk slice: IF_BPR's threshold sums, the friend top-k, the rankers
# ---------------------------------------------------------------------------


def _walk_files(tmp_path):
    """The planted blocks of tests/test_adversarial_models.py: ratings,
    ``ratings_n.txt`` (3 items of the other block per user) and trust."""
    rng = np.random.RandomState(0)
    ratings, negative, trust = tmp_path / "ratings.txt", tmp_path / "ratings_n.txt", tmp_path / "trust.txt"
    ratings.write_text("".join(f"u{u} i{i} 1\n" for u in range(40)
                               for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)))
    negative.write_text("".join(f"u{u} i{i} 1\n" for u in range(40)
                                for i in rng.choice(15, size=3, replace=False) + (15 if u < 20 else 0)))
    trust.write_text("".join(f"u{u} u{f} 1\n" for u in range(40)
                             for f in rng.choice(20, size=4, replace=False) + (0 if u < 20 else 20) if f != u)
                     + "".join(f"u{u} u{u + 1} 1\nu{u + 1} u{u} 1\n" for u in range(0, 40, 2)))
    return ratings, trust


def _walk_conf(name, ratings, trust, epochs=30):
    conf = ModelConf(str(CONFIG / f"{name}.conf"))
    for key, value in (("ratings", str(ratings)), ("social", str(trust)), ("social.setup", "-columns 0 1 2"),
                       ("evaluation.setup", "-ap 0.2"), ("item.ranking", "on -topN 10"),
                       ("num.factors", "16"), ("num.max.epoch", str(epochs)), ("batch_size", "64"),
                       ("learnRate", "-init 0.02 -max 1" if name != "CUNE_BPR" else "-init 0.05 -max 1"),
                       ("reg.lambda", "-u 0.001 -i 0.001 -b 0.1 -s 0.1"), ("seed", "7"),
                       ("output.setup", "off -dir ./results/")):
        conf[key] = value
    if name == "IF_BPR":
        conf["IF_BPR"] = "-L 20 -l 16 -w 5 -k 10 -a 0.1 -ep 10 -neg 3 -r 0.2"
    if name == "CUNE_BPR":
        conf["CUNE-BPR"] = "-T 10 -L 10 -l 16 -w 5 -k 10 -s 2 -ep 10"
        conf["reg.lambda"] = "-u 0.01 -i 0.01 -b 0.1 -s 0.1"
    return conf


@pytest.mark.cuda
def test_ifbpr_threshold_sums_repeat_bit_for_bit_on_card(cuda_device, tmp_path, monkeypatch):
    """IF_BPR's per-user threshold sums are segment sums over each batch
    sorted by user (no atomics), so two seeded runs on the card give the
    same sums, thresholds and tables bit for bit; so does a third that
    runs its epochs step by step from Python (``epoch_graphs=False``)
    against the two that replay one captured CUDA graph an epoch."""
    from qrec_tpu_torch.models.ifbpr import IF_BPR

    ratings, trust = _walk_files(tmp_path)
    runs = []
    for graphs in (None, None, False):
        monkeypatch.setattr(IF_BPR, "epoch_graphs", graphs)
        rec = QRec(_walk_conf("IF_BPR", ratings, trust, epochs=5), seed=3)
        rec.execute()
        runs.append(rec.model)
    a, b, eager = runs
    assert len(a.timer.captures) == 1 and eager.timer.captures == []
    assert a.acc.device.type == "cuda" and a.acc.abs().sum() > 0
    for m in (b, eager):
        assert torch.equal(a.acc, m.acc)
        assert len(m.thresholds) == len(a.thresholds) == 5
        for (t1, v1), (t2, v2) in zip(a.thresholds, m.thresholds):
            assert torch.equal(t1, t2) and torch.equal(v1, v2)
        assert torch.equal(a.U, m.U) and torch.equal(a.V, m.V)
        assert a.epoch_losses == m.epoch_losses
    assert not torch.equal(a.thresholds[0][0], a.thresholds[-1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1024, 64])
def test_friend_topk_on_card_equals_cpu(cuda_device, chunk):
    """The friend top-k on a tie-free block: the same ids as on the CPU,
    the similarities within 1e-5."""
    from qrec_tpu_torch.ops.walks import topk_cosine_neighbors

    g = torch.Generator().manual_seed(0)
    emb = torch.randn((700, 32), generator=g)
    active = np.arange(0, 700, 3)
    ids, sims = topk_cosine_neighbors(emb.to(cuda_device), active, 30, chunk=chunk)
    cids, csims = topk_cosine_neighbors(emb, active, 30, chunk=chunk)
    assert ids.device.type == "cuda"
    assert torch.equal(ids.cpu(), cids)
    torch.testing.assert_close(sims.cpu(), csims, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name,floor", [("CUNE_BPR", 0.5), ("IF_BPR", 0.45), ("RSGAN", 0.35)])
def test_walk_rankers_rank_through_k2_on_card(cuda_device, tmp_path, name, floor):
    """CUNE_BPR, IF_BPR (with its negative channel) and RSGAN rank the
    planted blocks through K2's fused top-k, above the JAX package's
    floors (tests/test_walk_models.py, tests/test_adversarial_models.py)."""
    ratings, trust = _walk_files(tmp_path)
    K.reset_launch_counts()
    recall = parse_measure(QRec(_walk_conf(name, ratings, trust), seed=3).execute())["Top 10"]["Recall"]
    counts = K.launch_counts()
    assert counts["masked_catalog_topk"] == 1 and sum(counts.values()) == 1
    assert recall > floor


# the lifecycle slice: a LightGCN run stopped after epoch 3 (its checkpoint of epoch 2
# the latest) and resumed to 6 on the card ends where the unbroken run
# does, bit for bit: K1 repeats bit for bit, and the resumed run restores
# the parameters, Adam's state and the CUDA generator's seed and offset
@pytest.mark.cuda
def test_lightgcn_resumed_on_card_repeats_the_unbroken_run(cuda_device, tmp_path):
    from qrec_tpu_torch.data.dataset import Interactions
    from qrec_tpu_torch.models import get_model

    rng = np.random.RandomState(0)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(f"u{u} i{i} 1\n" for u in range(60)
                            for i in rng.choice(40, size=12, replace=False)))
    base = {
        "ratings": str(path), "ratings.setup": "-columns 0 1 2", "model.name": "LightGCN",
        "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10", "num.factors": "50",
        "num.max.epoch": "6", "batch_size": "64", "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1", "LightGCN": "-n_layer 2",
        "output.setup": "off -dir ./results/", "seed": "7",
    }
    rec = QRec(ModelConf(base), device="cpu")
    ckpt = f"on -dir {tmp_path / 'ck'} -every 2"

    def fit(**extra):
        conf = ModelConf(dict(base, **extra))
        model = get_model("LightGCN")(conf, Interactions(conf, rec.training_data, rec.test_data))
        before = K.DUAL.launches
        model.fit()
        return model, K.DUAL.launches - before

    unbroken, _ = fit()
    stopped, _ = fit(**{"num.max.epoch": "3", "checkpoint.setup": ckpt})
    resumed, launches = fit(**{"checkpoint.setup": ckpt})
    assert resumed.resumed_step == 2
    steps = -(-resumed.train_size // resumed.batch_size)
    assert launches == 2 * 2 * steps * (6 - 2) + 2  # 2n a step, n for the final factors
    assert stopped.epoch_losses == unbroken.epoch_losses[:3]
    assert resumed.epoch_losses == unbroken.epoch_losses[2:]
    assert torch.equal(resumed.U, unbroken.U) and torch.equal(resumed.V, unbroken.V)


# route 6 (ops/spmm.ShardedDenseJoint): K1 on each data rank's block of
# R's item columns, as the route calls it (x_u scaled before, the unit row
# scale in K1, the user half scaled after the sum). The item half is the
# whole product's rows bit for bit where the block's plan cuts the rows
# into the same regions as the whole table's (its rows are then summed in
# the same order), else within f32 rounding; the blocks' user halves
# summed in rank order are the whole user half within f32 rounding
@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 25, 50, 150])
@pytest.mark.parametrize("parts", [2, 3])
def test_dual_kernel_on_item_column_blocks(cuda_device, d, parts):
    import types

    from qrec_tpu_torch.ops.spmm import ShardedDenseJoint, _block_dual_call

    u, i = 1892, 16591
    adj, x = _factored_operands(cuda_device, u, i, d, seed=d + parts)
    whole = K.factored_dual_matmul(adj.r, x, adj.row_scale, adj.col_scale)
    limits = K._dual_limits(adj.r.device, d, True)
    rows = K._dual_plan(u, adj.r.shape[1], d, limits[0], limits[2], limits[1])[0]
    user = torch.zeros((u, d), device=cuda_device)
    for p in range(parts):
        rank = types.SimpleNamespace(data=parts, data_index=p)
        block = ShardedDenseJoint.from_joint(adj, rank)
        c0, c1 = block.col0, block.col1
        before = K.DUAL.launches
        out = _block_dual_call(block, x)
        assert K.DUAL.launches == before + 1 and out.shape == (u + c1 - c0, d)
        user += out[:u]
        got, want = out[u:], whole[u + c0: u + c1]
        block_rows = K._dual_plan(u, block.r.shape[1], d, limits[0], limits[2], limits[1])[0]
        if block_rows == rows:
            assert torch.equal(got, want), (p, block_rows)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(user * adj.row_scale[:, None], whole[:u], rtol=1e-5, atol=1e-6)


# route 7 (ops/topk.CatalogRanker on a mesh): K2's fused top-k on each
# rank's tensor_split share of the test users gives the whole ranking's
# rows bit for bit, plain and biased: a user's scores do not depend on its
# batch
@pytest.mark.cuda
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("parts", [3, 4])
def test_topk_kernel_on_user_shards(cuda_device, parts, biased):
    b, i, d, k = 1892, 16591, 50, 10
    user, items, bitmask, uids = _topk_inputs(cuda_device, b, i, d, seed=parts)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    bias = dict(item_bias=torch.randn(i, generator=g, device=cuda_device),
                user_bias=torch.randn(user.shape[0], generator=g, device=cuda_device),
                offset=0.25) if biased else {}
    whole_ids, whole = K.masked_catalog_topk(user, items, bitmask, uids, 0.125, k, **bias)
    for p in range(parts):
        s0, s1 = split_range(b, parts, p)
        before = K.TOPK.launches
        ids, vals = K.masked_catalog_topk(user, items, bitmask, uids[s0:s1].contiguous(), 0.125,
                                          k, **bias)
        assert K.TOPK.launches == before + 1
        assert torch.equal(ids, whole_ids[s0:s1]) and _same_bits(vals, whole[s0:s1])


@pytest.mark.cuda
def test_scratch_is_sized_before_capture(cuda_device):
    """A kernel's scratch that a capture would have to allocate raises; a
    warm-up call on the capture's stream sizes it, and the captured call's
    replays are counted."""
    v = torch.nn.functional.normalize(torch.randn(96, 16, device="cuda"), dim=1)
    m = torch.ones(96, device="cuda")
    # the kernel's plan and module first, on the default stream: what a
    # capture may not do for the first time is size the scratch
    K.infonce_fwd(v, v, m, m, 0.2)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="not sized before capture"):
        with K.GraphLaunches().record(), torch.cuda.graph(graph, stream=stream):
            K.infonce_fwd(v, v, m, m, 0.2)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want, _ = K.infonce_fwd(v, v, m, m, 0.2)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    launches = K.GraphLaunches()
    before = K.INFONCE_FWD.launches
    with launches.record(), torch.cuda.graph(graph, stream=stream):
        got, _ = K.infonce_fwd(v, v, m, m, 0.2)
    for _ in range(3):
        graph.replay()
        launches.add()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.INFONCE_FWD.launches - before == 3
    assert int(K.infonce_fwd_counters("cuda").abs().sum()) == 0


# train.chunk on the card: a chunk's epochs replay one CUDA graph, the
# losses, parameters and best epoch those of the per-epoch loop bit for bit
@pytest.mark.cuda
@pytest.mark.parametrize("name,args,backend", [
    ("LightGCN", "-n_layer 2", "auto"),
    ("LightGCN", "-n_layer 2", "pallas"),
    ("NGCF", "", "auto"),
    ("SimGCL", "-n_layer 2 -lambda 0.05 -eps 0.1", "auto"),
    ("SGL", "-n_layer 2 -lambda 0.05 -droprate 0.2 -augtype 1 -temp 0.2", "auto"),
    ("SGL", "-n_layer 2 -lambda 0.05 -droprate 0.2 -augtype 0 -temp 0.2", "pallas"),
])
def test_chunked_graphs_match_per_epoch_on_card(cuda_device, tmp_path, name, args, backend):
    rng = np.random.RandomState(0)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(
        f"u{u} i{i} 1\n" for u in range(40)
        for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)))
    runs = {}
    for chunk in ("1", "3"):
        conf = ModelConf({
            "ratings": str(path), "ratings.setup": "-columns 0 1 2", "model.name": name,
            "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10", "num.factors": "16",
            "num.max.epoch": "5", "batch_size": "64", "learnRate": "-init 0.05 -max 1",
            "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1", name: args,
            "graph.backend": backend, "output.setup": "off -dir ./results/", "seed": "7",
            "train.chunk": chunk,
        })
        rec = QRec(conf, seed=3)
        rec.execute()
        m = rec.model
        runs[chunk] = (m.epoch_losses, [p.detach().clone() for p in m.parameters()],
                       None if m.tracker is None else (m.tracker.best_epoch, m.tracker.best_metrics),
                       m.phase_timers[0])
    (l1, p1, b1, t1), (l3, p3, b3, t3) = runs["1"], runs["3"]
    assert len(t3.captures) == 1 and [e for _, e in t3.chunks] == [3, 2]
    assert t1.captures == [] and [e for _, e in t1.chunks] == [1] * 5
    assert l3 == l1 and b3 == b1
    assert all(torch.equal(a, b) for a, b in zip(p3, p1))


@pytest.mark.cuda
def test_a_host_read_in_a_chunked_epoch_raises(cuda_device):
    """A step that reads the host fails the chunk's warm-up epoch (CUDA's
    sync-debug mode "error") before any capture: the error propagates, the
    loop state stays at its boundary and the process's sync-debug mode is
    put back."""
    from qrec_tpu_torch.runtime import trainer as T
    from qrec_tpu_torch.runtime.profiling import StepTimer

    w = torch.nn.Parameter(torch.ones(8, device="cuda"))
    batches = (torch.zeros((2, 4), device="cuda"),)

    def loss_fn(batch, gen):
        loss = ((w - batch[0].sum()) ** 2).sum()
        float(loss)  # a host read
        return loss

    opt = T.make_optimizer([w], "adam", 0.1)
    T.init_adam_state(opt)
    st = T.LoopState(0, [w], opt, torch.Generator(device="cuda").manual_seed(0))
    prog = T.EpochProgram(st, loss_fn, lambda gen: batches, "cuda")
    loop = T.ChunkedLoop(prog, 2, timer=StepTimer(1, "cuda"), emit=None, lr=0.1)
    mode = torch.cuda.get_sync_debug_mode()
    with pytest.raises(RuntimeError, match="synchroniz"):
        loop.run(st, 4)
    assert torch.cuda.get_sync_debug_mode() == mode
    assert st.epoch == 0 and prog.graph is None and loop.timer.captures == []
    assert torch.equal(w.detach(), torch.ones(8, device="cuda"))


def _planted_social(tmp_path):
    """The planted blocks of the chunk test above and a trust file of four
    links inside each user's block plus 20 reciprocated pairs."""
    rng = np.random.RandomState(0)
    ratings, trust = tmp_path / "ratings.txt", tmp_path / "trust.txt"
    ratings.write_text("".join(
        f"u{u} i{i} 1\n" for u in range(40)
        for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)))
    links = [f"u{u} u{v}\n" for u in range(40)
             for v in rng.choice(20, size=4, replace=False) + (0 if u < 20 else 20) if v != u]
    links += [f"u{u} u{u + 1}\nu{u + 1} u{u}\n" for u in range(0, 40, 2)]
    trust.write_text("".join(links))
    return str(ratings), str(trust)


# train.chunk for the social-graph and deep families on the card: every
# phase of more than one epoch replays one CUDA graph an epoch (captured
# after a warm-up epoch under CUDA's sync-debug mode "error"), the losses
# of every phase, the parameters and the best epoch those of the per-epoch
# loop bit for bit: (model, its arguments, epochs, extra keys, epochs per
# phase)
CHUNK_FAMILIES = [
    ("MHCN", "-n_layer 2 -ss_rate 0.01", 5, {}, [5]),
    ("MHCN", "-n_layer 2 -ss_rate 0.01", 5, {"graph.aux.dense": "on"}, [5]),
    ("SEPT", "-n_layer 2 -ss_rate 0.005 -drop_rate 0.3 -ins_cnt 5", 7, {}, [2, 5]),
    ("DiffNet", "-n_layer 2", 4, {}, [4]),
    ("DHCF", "", 4, {}, [4]),
    ("NeuMF", "", 10, {}, [10, 5, 2]),
    ("APR", "-eps 0.5 -regA 1 -advEpoch 2", 6, {}, [3, 3]),
    ("DMF", "", 4, {"learnRate": "-init 0.001 -max 1"}, [4]),
    ("CDAE", "-co 0.8 -nh 16", 5, {"batch_size": "32"}, [5]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,args,epochs,extra,phases", CHUNK_FAMILIES,
                         ids=["MHCN-coo", "MHCN-dense", "SEPT", "DiffNet", "DHCF", "NeuMF", "APR",
                              "DMF", "CDAE"])
def test_chunked_family_graphs_match_per_epoch_on_card(cuda_device, tmp_path, name, args, epochs,
                                                      extra, phases):
    ratings, trust = _planted_social(tmp_path)
    runs = {}
    for chunk in ("1", "3"):
        conf = ModelConf({
            "ratings": ratings, "ratings.setup": "-columns 0 1 2", "model.name": name,
            "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10", "num.factors": "16",
            "num.max.epoch": str(epochs), "batch_size": "64", "learnRate": "-init 0.01 -max 1",
            "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1", "output.setup": "off -dir ./results/",
            "seed": "7", "train.chunk": chunk, **({name: args} if args else {}), **extra,
        })
        if name in ("MHCN", "SEPT", "DiffNet"):
            conf["social"], conf["social.setup"] = trust, "-columns 0 1"
        rec = QRec(conf, seed=3)
        rec.execute()
        m = rec.model
        runs[chunk] = (m.phase_losses, [p.detach().clone() for p in m.parameters()],
                       None if m.tracker is None else (m.tracker.best_epoch, m.tracker.best_metrics),
                       m.phase_timers)
    (l1, p1, b1, t1), (l3, p3, b3, t3) = runs["1"], runs["3"]
    cut = [[min(3, n - k) for k in range(0, n, 3)] if n > 1 else [1] for n in phases]
    assert [[e for _, e in t.chunks] for t in t3] == cut
    assert [len(t.captures) for t in t3] == [int(n > 1) for n in phases]
    assert all(t.captures == [] and {e for _, e in t.chunks} == {1} for t in t1)
    assert l3 == l1 and b3 == b1
    assert all(torch.equal(a, b) for a, b in zip(p3, p1))


# -tf runs, SGNS and IF_BPR as CUDA graphs: a -tf run with the ranking on
# replays one CUDA graph an epoch (every bold spec is chunkable under Adam),
# SGNS replays graphs of a few steps through each epoch, IF_BPR replays one
# graph an epoch; each the same bits as its eager loop
TF_MODELS = [("BPR", None), ("BasicMF", None), ("PMF", None), ("SVD", None),
             ("SBPR", None), ("TBPR", "-regT 0.01"), ("SoRec", "-z 0.01"),
             ("SoReg", "-alpha 0.1"), ("SocialMF", None), ("RSTE", "-alpha 0.4"),
             ("LOCABAL", "-alpha 0.1"), ("SREE", "-alpha 0.01"),
             ("SocialFD", "-alpha 0.1 -eta 0.1 -beta 0.1"),
             ("CUNE_MF", "-T 10 -L 10 -l 16 -w 5 -k 10 -a 0.1 -ep 10"),
             ("CUNE_BPR", "-T 10 -L 10 -l 16 -w 5 -k 10 -s 2 -ep 10"),
             ("SVD++", "-y 0.01"), ("EE", None)]
TF_KEYS = {"CUNE_MF": "CUNE-MF", "CUNE_BPR": "CUNE-BPR", "SVD++": "SVDPlusPlus"}


def _tf_conf(ratings, trust, name, args, chunk, epochs=5):
    conf = ModelConf({
        "ratings": ratings, "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2 -tf", "item.ranking": "on -topN 10", "num.factors": "16",
        "num.max.epoch": str(epochs), "batch_size": "64", "learnRate": "-init 0.01 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1", "output.setup": "off -dir ./results/",
        "seed": "7", "train.chunk": chunk, "social": trust, "social.setup": "-columns 0 1",
    })
    if args:
        conf[TF_KEYS.get(name, name)] = args
    return conf


@pytest.mark.cuda
@pytest.mark.parametrize("name,args", TF_MODELS, ids=[n for n, _ in TF_MODELS])
@pytest.mark.parametrize("chunk,cut", [("3", [3, 2]), ("auto", [5])])
def test_tf_runs_chunk_as_graphs_on_card(cuda_device, tmp_path, name, args, chunk, cut):
    """Every bold spec under ``-tf`` with the ranking on: one CUDA graph
    (captured after a warm-up epoch under sync-debug "error": no sampler
    or loss reads the host), its chunks as cut, its losses, parameters and
    ranking's factors the same bits as the ``train.chunk=1`` run's."""
    ratings, trust = _planted_social(tmp_path)
    runs = {}
    for c in ("1", chunk):
        rec = QRec(_tf_conf(ratings, trust, name, args, c), seed=3)
        rec.execute()
        m = rec.model
        runs[c] = (m.epoch_losses, [p.detach().clone() for p in m.parameters()], m.U, m.V,
                   m.phase_timers[0])
    (l1, p1, u1, v1, t1), (lc, pc, uc, vc, tc) = runs["1"], runs[chunk]
    assert [e for _, e in tc.chunks] == cut and len(tc.captures) == 1
    assert t1.captures == [] and [e for _, e in t1.chunks] == [1] * 5
    assert lc == l1 and torch.equal(uc, u1) and torch.equal(vc, v1)
    assert all(torch.equal(a, b) for a, b in zip(pc, p1))


@pytest.mark.cuda
@pytest.mark.parametrize("name,args", [m for m in TF_MODELS
                                       if m[0] in ("BPR", "SBPR", "TBPR", "CUNE_BPR")])
def test_tf_chunk_reads_the_host_once(cuda_device, tmp_path, name, args):
    """One more chunk of 4 epochs of a captured ``-tf`` run, under CUDA's
    sync-debug mode "warn": one host read, the chunk's losses."""
    import warnings

    from qrec_tpu_torch.runtime import trainer as T
    from qrec_tpu_torch.runtime.profiling import StepTimer

    ratings, trust = _planted_social(tmp_path)
    rec = QRec(_tf_conf(ratings, trust, name, args, "auto", epochs=1), seed=3)
    rec.execute()
    model = rec.model
    spec = model.build()
    opt = T.make_optimizer(spec.params, "adam", model.lrate)
    T.init_adam_state(opt)
    st = T.LoopState(0, spec.params, opt, torch.Generator(device="cuda").manual_seed(0))
    prog = T.EpochProgram(st, spec.loss_fn, spec.sampler, "cuda")
    loop = T.ChunkedLoop(prog, 4, timer=StepTimer(1), emit=None, lr=model.lrate)
    loop.run(st, 4)
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            losses = loop.run(st, 8)
        finally:
            torch.cuda.set_sync_debug_mode(before)
    assert sum("called a synchronizing" in str(w.message) for w in caught) == 1
    assert len(losses) == 4 and all(np.isfinite(losses))


@pytest.mark.cuda
@pytest.mark.parametrize("graph_steps", [None, 3])
def test_skipgram_graphs_equal_eager_steps_on_card(cuda_device, graph_steps):
    """SGNS at batch 8,192 on 4 batches an epoch (the last padded with
    pair 0): replayed CUDA graphs of ``SGNS_GRAPH_STEPS`` (one program of
    all 4) or of 3 steps (3 + a tail of 1), captured once, give the ``in``
    table of the per-step loop bit for bit, both on the one Adam."""
    from qrec_tpu_torch.ops import walks as W
    from qrec_tpu_torch.runtime.profiling import StepTimer

    rng = np.random.RandomState(0)
    centers = rng.randint(0, 500, 30000).astype(np.int32)
    contexts = rng.randint(0, 500, 30000).astype(np.int32)
    active = np.arange(0, 500, 2)
    kw = dict(epochs=3, seed=4, device="cuda")
    eager_timer, graph_timer = StepTimer(30000, "cuda"), StepTimer(30000, "cuda")
    eager = W.train_skipgram(centers, contexts, 500, 20, active, graph_steps=0,
                             timer=eager_timer, **kw)
    got = W.train_skipgram(centers, contexts, 500, 20, active, graph_steps=graph_steps,
                           timer=graph_timer, **kw)
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    assert torch.equal(got, eager)
    assert eager_timer.captures == [] and len(graph_timer.captures) == 1
    assert len(graph_timer.times) == 3


# the own loops as one dispatch an epoch: ESRF's phases and BUIR chunked,
# IRGAN, RSGAN (pretraining step and epoch) and CFGAN as one CUDA graph
# each, replayed; (model, epochs, captures by timer of the captured run)
OWN_LOOPS = [("ESRF", 6, [1, 1, 1]), ("BUIR", 4, [1]), ("IRGAN", 3, [1]), ("RSGAN", 3, [1, 1]),
             ("CFGAN", 3, [1])]


def _own_timers(m):
    """A fit's timers: ESRF's and BUIR's by phase, RSGAN's pretraining
    timer and its epoch timer, the others' one."""
    if m.model_name == "RSGAN":
        return [m.pretrain_timer, m.timer]
    return m.phase_timers or [m.timer]


def _own_model(name, tmp_path, epochs):
    """The model on the planted blocks, links and negative feedback of
    ``_walk_files``, built as the session builds it, on the card."""
    from qrec_tpu_torch.data.dataset import Interactions
    from qrec_tpu_torch.data.social import SocialGraph
    from qrec_tpu_torch.models import MODELS

    ratings, trust = _walk_files(tmp_path)
    conf = _walk_conf(name, ratings, trust, epochs=epochs)
    rec = QRec(conf, seed=3)
    data = Interactions(conf, rec.training_data, rec.test_data, seed=3)
    cls = MODELS[name]
    social = {"social": SocialGraph(rec.relation, data)} if cls.requires_social else {}
    return cls(conf, data, device="cuda", **social)


@pytest.mark.cuda
@pytest.mark.parametrize("name,epochs,captures", OWN_LOOPS, ids=[n for n, _, _ in OWN_LOOPS])
def test_own_loop_graphs_equal_per_step_loop_on_card(cuda_device, tmp_path, name, epochs,
                                                     captures):
    """Each own loop at more than one epoch (ESRF 2 a phase): its captured
    form (ESRF's three phase graphs, BUIR's epoch graph under
    ``train.chunk`` auto, RSGAN's pretraining step and epoch graphs,
    IRGAN's and CFGAN's epoch graphs) against its per-step loop
    (``epoch_graphs=False``), both on the one Adam: every loss, table,
    buffer and factor the same bits."""
    runs = {}
    for graphs in (None, False):
        model = _own_model(name, tmp_path, epochs)
        model.epoch_graphs = graphs
        model.fit()
        runs[graphs] = (model, {k: list(getattr(model, k)) for k in
                                ("epoch_losses", "g_losses", "pretrain_losses") if hasattr(model, k)},
                        [t.detach().clone() for t in (*model.parameters(), *model.buffers())])
    (g, lg, tg), (e, le, te) = runs[None], runs[False]
    assert [len(t.captures) for t in _own_timers(g)] == captures
    assert all(t.captures == [] for t in _own_timers(e))
    assert lg == le and len(lg["epoch_losses"]) == epochs and np.isfinite(lg["epoch_losses"]).all()
    assert len(tg) == len(te) and all(torch.equal(a, b) for a, b in zip(tg, te))
    for k in ("U", "V"):
        a, b = getattr(g, k, None), getattr(e, k, None)
        assert (a is None and b is None) or torch.equal(a, b)


# the method of each loop's body that a host read is planted in
OWN_BODIES = {"ESRF": "d_loss", "BUIR": "step_loss", "IRGAN": "d_loss", "RSGAN": "recon_loss",
              "CFGAN": "d_loss"}


@pytest.mark.cuda
@pytest.mark.parametrize("name,epochs,captures", OWN_LOOPS, ids=[n for n, _, _ in OWN_LOOPS])
def test_a_host_read_in_an_own_loop_raises(cuda_device, tmp_path, monkeypatch, name, epochs,
                                           captures):
    """A host read planted in a loop's body fails the warm-up of its first
    capture (CUDA's sync-debug mode "error"): the fit raises, nothing runs
    per step instead, and the tables (and BUIR's target) are those the
    loop started from."""
    model = _own_model(name, tmp_path, epochs)
    cls = type(model)
    real = getattr(cls, OWN_BODIES[name])

    def with_read(self, *a, **k):
        loss = real(self, *a, **k)
        float(loss)  # a host read
        return loss

    model.prepare_graph()
    before = [t.detach().clone() for t in (*model.parameters(), *model.buffers())]
    monkeypatch.setattr(cls, OWN_BODIES[name], with_read)
    mode = torch.cuda.get_sync_debug_mode()
    with pytest.raises(RuntimeError, match="synchroniz"):
        model.fit()
    assert torch.cuda.get_sync_debug_mode() == mode
    after = [t.detach() for t in (*model.parameters(), *model.buffers())]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


# ---------------------------------------------------------------------------
# slice 12: the ALS loops as one CUDA graph an epoch, and the one Adam
# ---------------------------------------------------------------------------

ALS_LOOPS = ("WRMF", "ExpoMF", "CoFactor", "SERec")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ALS_LOOPS)
def test_als_graphs_equal_per_step_loop_on_card(cuda_device, tmp_path, name):
    """Seven epochs of each ALS loop: one CUDA graph an epoch (captured
    once, the solves pinned to cuSOLVER) against the per-step loop
    (``epoch_graphs=False``, pinned too): every table, U, V and WRMF's
    losses the same bits."""
    runs = {}
    for graphs in (None, False):
        model = _own_model(name, tmp_path, 7)
        model.epoch_graphs = graphs
        model.fit()
        runs[graphs] = model
    g, e = runs[None], runs[False]
    assert len(g.timer.captures) == 1 and e.timer.captures == []
    assert g.tables.keys() == e.tables.keys()
    assert all(torch.equal(g.tables[k], e.tables[k]) for k in g.tables)
    assert torch.equal(g.U, e.U) and torch.equal(g.V, e.V)
    assert g.epoch_losses == e.epoch_losses
    assert (len(g.epoch_losses) == 7) == (name == "WRMF")
    assert torch.isfinite(g.U).all() and torch.isfinite(g.V).all()


@pytest.mark.cuda
@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("lr", [0.001, 0.01])
def test_one_adam_equals_foreach_adam_on_card(cuda_device, lr, graph):
    """The one Adam (``runtime/adam.Adam``) against
    ``torch.optim.Adam(foreach=True)`` with the same gradients: 100 eager
    steps (the second parameter without a gradient at every third step, so
    its step count lags), or 30 replays of its step captured once through
    ``trainer.GraphProgram`` (that parameter without a gradient
    throughout): parameters, moments and step counts bit for bit."""
    from qrec_tpu_torch.runtime import trainer as T

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(300, 50), (1000, 50), (512,)]
    ps = [torch.randn(s, generator=gen, device="cuda").requires_grad_() for s in shapes]
    qs = [p.detach().clone().requires_grad_() for p in ps]
    ours = T.make_optimizer(ps, "adam", lr)
    plain = torch.optim.Adam(qs, lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=True)
    grads = [torch.zeros_like(p) for p in ps]
    T.init_adam_state(ours)
    prog = None
    if graph:
        for k, (p, g) in enumerate(zip(ps, grads)):
            p.grad = None if k == 1 else g
        prog = T.GraphProgram(T.LoopState(0, ps, ours, None), "cuda", body=ours.step)
        prog.capture()
    for step in range(30 if graph else 100):
        for g in grads:
            g.copy_(torch.randn(g.shape, generator=gen, device="cuda"))
        skip = graph or step % 3 == 2
        for k, (p, q, g) in enumerate(zip(ps, qs, grads)):
            q.grad = None if k == 1 and skip else g.clone()
            if not graph:
                p.grad = None if k == 1 and skip else g.clone()
        if graph:
            prog.run()
        else:
            ours.step()
        plain.step()
    assert all(torch.equal(p, q) for p, q in zip(ps, qs))
    for p, q in zip(ps, qs):
        if q not in plain.state:
            assert float(ours.state[p]["step"]) == 0.0
            continue
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(ours.state[p][key], plain.state[q][key])
        assert float(ours.state[p]["step"]) == float(plain.state[q]["step"])
        assert ours.state[p]["step"].is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1, 0), (37, 0), (1024, 0), (16591 * 50, 0), (1001, 1)])
def test_adam_kernel_matches_plain(cuda_device, n, offset):
    """The Adam update kernel against its plain version (plain Adam's
    foreach update with the table's scalars) at steps 1 and 7 and past the
    table, bit for bit, one launch a call; a table at offset 1 (not 16-byte
    aligned) takes the kernel's scalar path."""
    from qrec_tpu_torch.runtime.adam import adam_scalars

    g = torch.Generator(device="cuda").manual_seed(n)
    table = torch.tensor(adam_scalars(0.01, 0.9, 0.999), device="cuda")
    for t in (1.0, 7.0, float(table.shape[0] + 3)):
        p = torch.randn(n + offset, generator=g, device="cuda")[offset:]
        m = torch.randn(n, generator=g, device="cuda")
        v = torch.rand(n, generator=g, device="cuda")
        q = p.clone()
        step = torch.tensor(t, device="cuda")
        before = K.ADAM.launches
        K.adam_update(p, m, v, step, table, 1e-8)
        assert K.ADAM.launches == before + 1
        K.adam_update_plain(q, m, v, step, table, 1e-8)
        assert torch.equal(p, q), t
