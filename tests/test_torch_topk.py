"""The fused masked top-k of the PyTorch port (K2's top-k entry): its plain
version against the JAX package's ``pallas_catalog_topk`` in interpret
mode, a host replay of the kernel's plan and selection against the stable
sort it must equal, its wrapper's dispatch rules, and the build rule that
a changed shared header builds anew. The kernel itself is held against the
scores entry and a sort on the card in ``test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrec_tpu.ops.topk import pallas_catalog_topk
from qrec_tpu_torch.ops import kernels as K
from qrec_tpu_torch.ops.sampling import pack_bitmask

CAP = 16  # the kernel's candidates a row (masked_scores.cu)
NAN_BITS, ZERO_BITS = 0xFFFFFFFF, 0x80000000


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rated(rng, u, i, most=30):
    indptr, indices = [0], []
    for _ in range(u):
        indices.extend(np.sort(rng.choice(i, size=rng.randint(0, most), replace=False)))
        indptr.append(len(indices))
    return np.array(indptr), np.array(indices, dtype=np.int64)


def _inputs(u, i, d, integer=False, seed=0):
    rng = np.random.RandomState(seed)
    if integer:  # small integers: every f32 dot product is exact, many tie
        ue = rng.randint(-1, 2, size=(u, d)).astype(np.float32)
        ie = rng.randint(-1, 2, size=(i, d)).astype(np.float32)
    else:
        ue, ie = rng.randn(u, d).astype(np.float32), rng.randn(i, d).astype(np.float32)
    indptr, indices = _rated(rng, u, i)
    return ue, ie, pack_bitmask(indptr, indices, u, i)


# plain version against the JAX package's fused path (Pallas scorer in
# interpret mode, then lax.top_k): unseen users, I not a multiple of 32 or
# 64; random scores agree to f32 order (ids exactly: no near-ties at these
# seeds), integer ones exactly, ties included
@pytest.mark.parametrize("k", [1, 5, 32])
@pytest.mark.parametrize("integer", [False, True])
def test_topk_plain_matches_pallas_topk(k, integer):
    u, i, d = 30, 203, 8
    ue, ie, bm = _inputs(u, i, d, integer, seed=k)
    uids = np.array([3, -1, 0, 29, 7, 7, -1, 12, 5, 18, 2, 25], dtype=np.int64)
    gm = 0.375
    jids, jscores = pallas_catalog_topk(
        jnp.asarray(ue), jnp.asarray(ie), uids, jnp.asarray(bm.view(np.uint32)), gm, k,
        batch_size=8, interpret=True,
    )
    tids, tscores = K.masked_catalog_topk(
        torch.from_numpy(ue), torch.from_numpy(ie), torch.from_numpy(bm),
        torch.from_numpy(uids), gm, k,
    )
    assert tids.dtype == torch.int64 and tscores.dtype == torch.float32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    if integer:
        np.testing.assert_array_equal(tscores.numpy(), np.asarray(jscores))
    else:
        np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tids.numpy()[uids < 0], np.tile(np.arange(k), (2, 1)))
    assert (tscores.numpy()[uids < 0] == np.float32(gm)).all()
    if integer and k > 1:  # the ties are real: some rows hold equal scores in their top k
        s = tscores.numpy()[uids >= 0]
        assert (np.diff(s, axis=1) == 0).any()


# ---------------------------------------------------------------------------
# the kernel's plan and selection, replayed on the host
# ---------------------------------------------------------------------------


def _order_bits(s):
    """The kernel's ordered word of each f32 score (uint32)."""
    s = np.asarray(s, np.float32)
    b = s.view(np.uint32).copy()
    b[s == 0] = 0
    out = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    out[np.isnan(s)] = NAN_BITS
    return out


def _keys(scores, items):
    return [(int(h) << 32) | (~int(c) & 0xFFFFFFFF) for h, c in zip(_order_bits(scores), items)]


def _merge(lst, buf, k):
    """The kernel's warp merge: every key goes to its rank in the union."""
    n = min(k, len(lst) + len(buf))
    out = [None] * n
    for i, x in enumerate(lst):
        pos = i + sum(b > x for b in buf)
        if pos < k:
            out[pos] = x
    for b in buf:
        pos = sum(x > b for x in lst) + sum(o > b for o in buf)
        if pos < k:
            out[pos] = b
    assert None not in out
    return out


def _replay(scores, uids, global_mean, k, bm, tps, seed=0):
    """ids and scores of one kernel call, step by step: row tiles of bm
    users x splits of tps item tiles of 64. A row belongs to a half-warp:
    thread row ty (of 16) holds local rows ty + 16 i, and rows 2w and 2w + 1
    (+ 16 i) share warp w. Per tile, i and j, each row's 16 scores of the
    step are offered against its k-th key; if either row of the warp would
    overflow its buffer of CAP, both rows merge first and the scores are
    offered again;
    the buffer takes them in a random order (the merge does not depend on
    it). Then each split's last merge, and each row's splits merged by k
    rounds of a max over their heads, keys decoded (NaN and zero from the
    score itself)."""
    rng = np.random.RandomState(seed)
    b, n_items = scores.shape
    tiles = -(-n_items // 64)
    splits = -(-tiles // tps)
    assert splits <= K.CATALOG_MAX_SPLITS
    ids = np.zeros((b, k), np.int64)
    out = np.zeros((b, k), np.float32)
    for r0 in range(0, b, bm):
        active = {r: r0 + r < b and uids[r0 + r] >= 0 for r in range(bm)}
        part = {}
        for g in range(splits):
            lists = {r: [] for r in range(bm)}
            bufs = {r: [] for r in range(bm)}

            def thr(r):
                return lists[r][k - 1] if len(lists[r]) == k else 0

            def merge(r):
                if bufs[r]:
                    lists[r] = _merge(lists[r], bufs[r], k)
                    bufs[r] = []

            c_end = min(n_items, (g + 1) * tps * 64)
            for t0 in range(g * tps * 64, c_end, 64):
                for i in range(bm // 16):
                    for w in range(8):
                        pair = (2 * w + 16 * i, 2 * w + 1 + 16 * i)
                        for j in range(4):  # 16 items a step, one a lane
                            items = np.arange(t0 + 16 * j, min(t0 + 16 * j + 16, c_end))
                            keys = {r: _keys(scores[r0 + r, items], items) if active[r] else []
                                    for r in pair}
                            wins = {r: [x for x in keys[r] if x > thr(r)] for r in pair}
                            if any(len(bufs[r]) + len(wins[r]) > CAP for r in pair):
                                for r in pair:
                                    merge(r)
                                wins = {r: [x for x in wins[r] if x > thr(r)] for r in pair}
                            for r in pair:
                                assert len(bufs[r]) + len(wins[r]) <= CAP
                                bufs[r] += [wins[r][q] for q in rng.permutation(len(wins[r]))]
            for r in range(bm):
                merge(r)
                if active[r]:
                    part[g, r] = lists[r] + [0] * (k - len(lists[r]))
        for r in range(min(bm, b - r0)):
            if not active[r]:
                ids[r0 + r], out[r0 + r] = np.arange(k), global_mean
                continue
            ptr = [0] * splits
            for e in range(k):
                heads = [part[g, r][ptr[g]] if ptr[g] < k else 0 for g in range(splits)]
                g = int(np.argmax(heads))
                key = heads[g]
                assert key > 0 and heads.count(key) == 1
                ptr[g] += 1
                hi, item = key >> 32, ~key & 0xFFFFFFFF
                if hi in (NAN_BITS, ZERO_BITS):
                    v = scores[r0 + r, item]
                else:
                    bits = hi & 0x7FFFFFFF if hi & 0x80000000 else ~hi & 0xFFFFFFFF
                    v = np.array([bits], np.uint32).view(np.float32)[0]
                ids[r0 + r, e], out[r0 + r, e] = item, v
    return ids, out


def _special_scores(b, n_items, seed):
    """Masked-score rows with NaN, +-inf, -0.0 and +0.0, exact ties and rows
    all equal."""
    rng = np.random.RandomState(seed)
    s = np.round(rng.randn(b, n_items), 1).astype(np.float32)  # many ties
    for value in (np.nan, np.inf, -np.inf, -0.0, 0.0):
        s[rng.rand(b, n_items) < 0.03] = value
    s[1] = 0.0
    s[2] = -0.0
    s[3] = np.nan
    s[4, ::2], s[4, 1::2] = -0.0, 0.0
    s[5] = 1.5
    s[6] = np.arange(n_items, dtype=np.float32)  # increasing: every tile overflows
    return s


def _stable_sort(scores, uids, global_mean, k):
    s = torch.from_numpy(scores.copy())
    s[torch.from_numpy(uids) < 0] = global_mean
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return idx[:, :k].numpy(), vals[:, :k].numpy()


@pytest.mark.parametrize(
    "n_items,k,bm,tps",
    [(700, 10, 64, 1), (700, 10, 128, 3), (700, 100, 64, 2), (333, 1, 64, 11),
     (2100, 20, 64, 3), (70, 70, 64, 1), (130, 100, 128, 1), (1500, 5, 128, 2)],
)
def test_k2_selection_replay_matches_stable_sort(n_items, k, bm, tps):
    b = 70
    scores = _special_scores(b, n_items, seed=n_items + k)
    uids = np.arange(b, dtype=np.int64)
    uids[[9, 40]] = -1
    want_ids, want = _stable_sort(scores, uids, 0.25, k)
    ids, got = _replay(scores, uids, 0.25, k, bm, tps, seed=k)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))  # NaN and -0.0 too
    # the order of the appends does not matter
    again = _replay(scores, uids, 0.25, k, bm, tps, seed=k + 1)
    np.testing.assert_array_equal(again[0], ids)


def _fake_occupancy():
    """A blocks_per_sm callable that models the kernel's shared memory
    (masked_scores.cu smem_bytes: its tiles and lists, or the last merge's
    staging where more) against an SM's 228 KB, at most 2 blocks (its
    registers)."""

    def smem(bm, d, sl, k, splits):
        ld = 4 * (((((sl or d) + 3) // 4)) | 1)
        keys = bm * (k + CAP + 1) if k else 0
        tiles = 4 * (bm + 128) * ld + 8 * keys + 4 * bm * (2 if k else 1)
        return max(tiles, 8 * 4 * splits * (k + k % 2) * 8 if k else 0)

    def per_sm(bm, d, sl, k, splits):
        need = smem(bm, d, sl, k, splits) + 1024
        return min(2, (228 * 1024) // need) if need <= 227 * 1024 else 0

    return per_sm


@pytest.mark.parametrize(
    "b,i,d,k,want",
    [
        (1024, 16591, 50, 10, (64, 0, 17)),    # lastfm: 16 row tiles x 16 splits, 2 an SM
        (1024, 16591, 50, 0, (128, 0, 8)),     # the scores entry: 8 x 33 splits
        (1024, 21266, 64, 20, (64, 0, 21)),    # yelp2018 top-20
        (1024, 16591, 150, 10, (128, 0, 17)),  # NGCF's width: one block an SM, a tie: 128
        (1024, 16591, 50, 100, (64, 0, 33)),   # long lists: the merge's 8 splits fill an SM
        (100, 5000, 256, 10, (64, 0, 5)),      # 128 rows at d=256 do not fit
        (4001, 33, 300, 10, (64, 64, 1)),      # past MAX_D: slices of 64
    ],
)
def test_k2_plan(b, i, d, k, want):
    per_sm = _fake_occupancy()
    plan = K.masked_catalog_plan(b, i, d, k, 132, lambda bm, sl, sp: per_sm(bm, d, sl, k, sp))
    assert plan == want
    bm, sl, tps = plan
    tiles = -(-i // 64)
    splits = -(-tiles // tps)
    assert (splits - 1) * tps < tiles  # no split empty
    assert per_sm(bm, d, sl, k, splits) >= 1
    if k:
        assert splits <= K.CATALOG_MAX_SPLITS


@pytest.mark.parametrize("b,i,d,k", [(1024, 16591, 150, 10), (1024, 2071, 10, 10),
                                     (1024, 16591, 1, 10), (100, 33, 300, 10)])
def test_k2_plan_biased_takes_64_rows(b, i, d, k):
    per_sm = _fake_occupancy()
    plan = K.masked_catalog_plan(b, i, d, k, 132, lambda bm, sl, sp: per_sm(bm, d, sl, k, sp),
                                 K.CATALOG_BIASED_ROWS)
    assert plan[0] == 64
    tiles = -(-i // 64)
    assert -(-tiles // plan[2]) <= K.CATALOG_MAX_SPLITS


def test_k2_plan_replay_at_its_own_plan():
    # the plan of a small batch, replayed: many splits of one tile
    b, n_items, k = 40, 1500, 10
    per_sm = _fake_occupancy()
    bm, sl, tps = K.masked_catalog_plan(b, n_items, 16, k, 132,
                                        lambda m, s, sp: per_sm(m, 16, s, k, sp))
    assert (bm, sl, tps) == (128, 0, 2)  # 12 splits of 2 tiles
    scores = _special_scores(b, n_items, seed=3)
    uids = np.arange(b, dtype=np.int64)
    ids, got = _replay(scores, uids, 0.0, k, bm, tps)
    want_ids, want = _stable_sort(scores, uids, 0.0, k)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# the wrapper and the build rule
# ---------------------------------------------------------------------------


def test_topk_wrapper_dispatch_and_checks():
    ue, ie, bm = _inputs(12, 70, 5, seed=4)
    u, v, m = torch.from_numpy(ue), torch.from_numpy(ie), torch.from_numpy(bm)
    uids = torch.tensor([0, -1, 11, 3])
    before = K.launch_counts()
    ids, scores = K.masked_catalog_topk(u, v, m, uids, 0.5, 70)  # k = I
    assert K.launch_counts() == before  # a CPU call is the plain version, no launch
    pids, pscores = K.masked_catalog_topk_plain(u, v, m, uids, 0.5, 70)
    assert torch.equal(ids, pids) and torch.equal(scores, pscores)
    assert sorted(ids[0].tolist()) == list(range(70))
    with pytest.raises(ValueError):
        K.masked_catalog_topk(u, v, m, uids, 0.5, 0)
    with pytest.raises(ValueError):
        K.masked_catalog_topk(u, v, m, uids, 0.5, 71)
    with pytest.raises(TypeError):
        K.masked_catalog_topk(u, v, m, uids.int(), 0.5, 3)
    with pytest.raises(ValueError):
        K.masked_catalog_topk(u, v, m[:, :2], uids, 0.5, 3)  # fewer words than ceil(I/32)
    with pytest.raises(ValueError):  # neither cpu nor cuda never reaches the plain version
        K.masked_catalog_topk(u.to("meta"), v.to("meta"), m.to("meta"), uids.to("meta"), 0.5, 3)


def test_changed_header_builds_anew(tmp_path):
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    kernel = K.Kernel("probe", "unused.cu", "qrec_probe", [])
    kernel.source = tmp_path / "kernel.cu"
    first = kernel.library_path()
    assert kernel.library_path() == first
    header.write_text("// two\n")
    assert kernel.library_path() != first


# ---------------------------------------------------------------------------
# score forms: SVD's biased scores, MostPopular's popularity, Rand
# ---------------------------------------------------------------------------


def _rated_data(name, ranking="on -topN 10"):
    """Both packages' data and confs for ``name`` on explicit ratings, with
    test users unseen in training."""
    import random

    from qrec_tpu import config as jconfig
    from qrec_tpu.data.dataset import Interactions as JInteractions
    from qrec_tpu.data.split import data_split
    from qrec_tpu_torch import ModelConf
    from qrec_tpu_torch.data.dataset import Interactions

    rng = np.random.RandomState(6)
    records = [[f"u{u}", f"i{i}", float(rng.randint(1, 9)) / 2]
               for u in range(40) for i in rng.choice(150, size=12, replace=False)]
    train, test = data_split(records, 0.2, rng=random.Random(3))
    test += [["ghost1", "i3", 2.0], ["ghost2", "i4", 1.0]]
    conf = {
        "ratings": "unused", "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2", "item.ranking": ranking, "num.factors": "7",
        "num.max.epoch": "1", "batch_size": "32", "learnRate": "-init 0.02 -max 1",
        "reg.lambda": "-u 0.01 -i 0.01 -b 0.01 -s 0.2", "output.setup": "off -dir ./r/",
        "seed": "21",
    }
    jconf, tconf = jconfig.ModelConf(conf), ModelConf(conf)
    return jconf, JInteractions(jconf, train, test), tconf, Interactions(tconf, train, test)


def _rows_agree(tids, tscores, jids, jscores, tol=1e-5):
    """Ids equal row by row, except where the row's scores differ by at
    most ``tol`` (near-equal scores summed in another order may swap)."""
    rows_equal = (tids == jids).all(1)
    gap = np.abs(tscores - jscores).max(1)
    assert (rows_equal | (gap <= tol)).all()
    return rows_equal


def test_biased_topk_plain_matches_jax_svd_ranker():
    from qrec_tpu.models.mf import SVD as JSVD
    from qrec_tpu.ops.topk import CatalogRanker as JRanker
    from qrec_tpu_torch.convert import embedding_params_from_jax
    from qrec_tpu_torch.models.mf import SVD
    from qrec_tpu_torch.ops.topk import CatalogRanker

    jconf, jd, tconf, td = _rated_data("SVD")
    jmodel = JSVD(jconf, jd)
    spec = jmodel.build()
    jmodel.finalize(spec.params, spec)
    jids, jscores = JRanker(jd, k=10, batch_size=16).topk(*jmodel.score_fn_params())
    tmodel = SVD(tconf, td, device="cpu")
    tmodel.load_state_dict(embedding_params_from_jax(
        {k: np.asarray(v) for k, v in spec.params.items()}, "cpu"))
    tmodel.finalize(tmodel.build())
    form = tmodel.score_form()
    assert form.item_bias is not None and form.user_bias is not None and form.offset != 0
    ranker = CatalogRanker(td, k=10, device="cpu", bitmask=tmodel.rated_bitmask, batch_size=16)
    tids, tscores = ranker.topk(form)
    rows_equal = _rows_agree(tids, tscores, np.asarray(jids), np.asarray(jscores))
    assert rows_equal.mean() > 0.9
    unseen = ranker.uids < 0
    assert unseen.sum() == 2 and (tids[unseen] == np.arange(10)).all()
    assert (tscores[unseen] == np.float32(td.global_mean)).all()
    np.testing.assert_allclose(tscores, np.asarray(jscores), rtol=1e-6, atol=1e-5)


def test_popularity_topk_plain_matches_jax_mostpopular():
    """MostPopular's ranking through the score form (width-1 zero tables,
    the popularity as the item bias) equals the JAX ranker's bit for bit."""
    from qrec_tpu.models.baselines import MostPopular as JMostPopular
    from qrec_tpu.ops.topk import CatalogRanker as JRanker
    from qrec_tpu_torch.convert import embedding_params_from_jax
    from qrec_tpu_torch.models.baselines import MostPopular
    from qrec_tpu_torch.ops.topk import CatalogRanker

    jconf, jd, tconf, td = _rated_data("MostPopular")
    jmodel = JMostPopular(jconf, jd)
    jmodel.fit()
    jids, jscores = JRanker(jd, k=10, batch_size=16).topk(*jmodel.score_fn_params())
    tmodel = MostPopular(tconf, td, device="cpu")
    tmodel.fit()
    np.testing.assert_array_equal(tmodel.scores.numpy(), jmodel.scores)
    carried = MostPopular(tconf, td, device="cpu")  # the JAX scores carried across
    carried.load_state_dict(embedding_params_from_jax({"scores": jmodel.scores}, "cpu"))
    assert torch.equal(carried.scores, tmodel.scores)
    ranker = CatalogRanker(td, k=10, device="cpu", bitmask=tmodel.rated_bitmask, batch_size=16)
    tids, tscores = ranker.topk(tmodel.score_form())
    np.testing.assert_array_equal(tids, np.asarray(jids))
    np.testing.assert_array_equal(tscores.view(np.uint32), np.asarray(jscores).view(np.uint32))


def test_rand_ranking_properties():
    """Rand's scores: U(0, 1), rated items at 0 (they rank last), k
    distinct items a row, unseen users at the global mean on items 0..k-1,
    and a fresh draw for every ranking."""
    from qrec_tpu_torch.models.baselines import Rand
    from qrec_tpu_torch.ops.topk import CatalogRanker

    _, _, tconf, td = _rated_data("Rand")
    model = Rand(tconf, td, device="cpu")
    model.fit()
    k = td.num_items
    ranker = CatalogRanker(td, k=k, device="cpu", bitmask=model.rated_bitmask, batch_size=16)
    ids, scores = ranker.topk(model.score_form())
    assert ids.shape == (len(ranker.uids), k)
    for b, uid in enumerate(ranker.uids):
        assert len(set(ids[b].tolist())) == k
        if uid < 0:
            assert (ids[b] == np.arange(k)).all() and (scores[b] == np.float32(td.global_mean)).all()
            continue
        rated = set(td.user_row_ids(uid).tolist())
        assert set(ids[b, k - len(rated):].tolist()) == rated
        assert (scores[b, k - len(rated):] == 0).all()
        free = scores[b, : k - len(rated)]
        assert ((free > 0) & (free < 1)).all() and (np.diff(scores[b]) <= 0).all()
    again, _ = ranker.topk(model.score_form())
    assert not np.array_equal(again, ids)
    draws = np.concatenate([scores[b, : 20] for b in range(len(ranker.uids)) if ranker.uids[b] >= 0])
    assert 0.5 < draws.mean() < 1.0  # the top 20 of ~140 uniform draws
