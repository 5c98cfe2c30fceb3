"""The ALS slice of the PyTorch port (WRMF, ExpoMF, CoFactor, SERec) and its
batched weighted-ridge solves against the JAX package, on the CPU: the
solves and the exposure posterior on seeded inputs, CoFactor's SPPMI
arrays, the numpy-drawn initial tables, three epochs of each model from
the JAX package's initial tables, and the bundled ``config/`` files end to
end on planted blocks.

Data: the planted blocks of the JAX package's tests/test_als_models.py (40
users, two blocks of 15 items, 10 binary ratings a user, 3 trust links
inside each user's block). The JAX fit draws its tables inside ``fit``:
the test reads them from the first call of its jitted epoch (``jax.jit``
wrapped while the JAX model fits), or, for WRMF's and CoFactor's
``jax.random`` tables, draws them as the JAX fit does, and hands them to
the port by replacing ``init_tables``.

Tolerances: one solve within rtol 1e-5 and atol 1e-5 (the same f32 normal
matrices summed in another order, then an LU solve; measured at most
1.1e-7 absolute); the exposure posterior within rtol 1e-6 (measured
1.7e-7); after three epochs the final tables within rtol 1e-3 and atol
1e-4 of the table's largest entry (measured, relative to that entry:
WRMF 4.7e-6, ExpoMF 5.6e-6, CoFactor 6.0e-6 and its g, w, c 1.7e-5,
SERec 5.8e-5: its exposure prior compounds the rounding).
"""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.social import SocialGraph as JSocialGraph
from qrec_tpu.data.split import data_split
from qrec_tpu.models import als as jals
from qrec_tpu.ops import als as jops
from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.social import SocialGraph
from qrec_tpu_torch.models import als as tals
from qrec_tpu_torch.ops import als as tops
from qrec_tpu_torch.ops import metrics

CONFIG = Path(__file__).resolve().parents[1] / "config"
SOLVE = dict(rtol=1e-5, atol=1e-5)
MODELS = ["WRMF", "ExpoMF", "CoFactor", "SERec"]
COFACTOR_ARGS = "-k 2 -gamma 0.1 -filter 1"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the solves
# ---------------------------------------------------------------------------


def _ridge_inputs(m=37, n=23, d=5, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randn(n, d).astype(np.float32)
    w = (rng.rand(m, n) * 3 + 0.5).astype(np.float32)
    t = (rng.rand(m, n) > 0.6).astype(np.float32)
    return y, w, t


def test_weighted_ridge_batch_matches_jax():
    y, w, t = _ridge_inputs()
    rng = np.random.RandomState(1)
    ea = rng.rand(len(w), 5, 5).astype(np.float32)
    ea = ea @ ea.transpose(0, 2, 1)  # symmetric positive semi-definite blocks
    eb = rng.randn(len(w), 5).astype(np.float32)
    for extra in ({}, {"extra_a": ea, "extra_b": eb}):
        want = jops.weighted_ridge_batch(jnp.asarray(y), jnp.asarray(w), jnp.asarray(t), 0.1,
                                         **{k: jnp.asarray(v) for k, v in extra.items()})
        got = tops.weighted_ridge_batch(torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(t),
                                        0.1, **{k: torch.from_numpy(v) for k, v in extra.items()})
        assert got.dtype == torch.float32 and got.shape == (37, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SOLVE)


@pytest.mark.parametrize("chunk", [None, 1, 8, 37, 10, 64])
def test_solve_factors_matches_jax_at_any_chunk(chunk):
    """Chunks that divide the 37 rows (1, 37), that do not (8, 10) and that
    exceed them (64); the JAX package pads to its 256-row chunk."""
    y, w, t = _ridge_inputs()
    want = np.asarray(jops.solve_factors(jnp.asarray(y), jnp.asarray(w), jnp.asarray(t), 0.05))
    got = tops.solve_factors(torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(t), 0.05,
                             chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **SOLVE)
    # rows are independent: a chunk moves a row only by the rounding of its
    # sums (a one-row product takes another BLAS route)
    one = tops.solve_factors(torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(t), 0.05,
                             chunk=37)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-5, atol=1e-6)


def test_solve_factors_carries_extra_blocks_across_chunks():
    y, w, t = _ridge_inputs(m=9)
    rng = np.random.RandomState(2)
    ea = torch.from_numpy(np.eye(5, dtype=np.float32) * rng.rand(9, 1, 1).astype(np.float32))
    eb = torch.from_numpy(rng.randn(9, 5).astype(np.float32))
    args = (torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(t), 0.1)
    whole = tops.weighted_ridge_batch(*args, extra_a=ea, extra_b=eb)
    chunked = tops.solve_factors(*args, chunk=4, extra_a=ea, extra_b=eb)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)
    plain = tops.solve_factors(*args, chunk=4)
    assert (plain - chunked).abs().min(dim=1).values.gt(0).all()  # every row took its blocks
    assert tops.chunk_rows(16591, 20) >= 1892  # the lastfm user solve is one chunk


def test_singular_row_gives_nonfinite_without_raising():
    """``jnp.linalg.solve`` never raises; neither does ``solve_ex``."""
    y, w, t = _ridge_inputs(m=3)
    w[1] = 0.0
    got = tops.solve_factors(torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(t), 0.0)
    assert not torch.isfinite(got[1]).all()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()


@pytest.mark.parametrize("mu_shape", ["items", "rows"])
def test_exposure_posterior_matches_jax(mu_shape):
    rng = np.random.RandomState(3)
    theta = rng.randn(13, 4).astype(np.float32)
    beta = rng.randn(29, 4).astype(np.float32)
    rated = (rng.rand(13, 29) > 0.7).astype(np.float32)
    mu = rng.random_sample(29 if mu_shape == "items" else (13, 29)).astype(np.float32) * 0.1
    mu.flat[0] = 0.0  # the 1e-12 floor
    for lam_y in (1.0, 0.01):
        want = jops.exposure_posterior(*map(jnp.asarray, (theta, beta, rated)), lam_y, jnp.asarray(mu))
        got = tops.exposure_posterior(*map(torch.from_numpy, (theta, beta, rated)), lam_y,
                                      torch.from_numpy(mu))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)
        assert (got.numpy()[rated > 0] == 1).all()


# ---------------------------------------------------------------------------
# the models against the JAX package
# ---------------------------------------------------------------------------


def _rows():
    """(rating rows, trust rows) of tests/test_als_models.py's data."""
    rng = np.random.RandomState(0)
    ratings = [[f"u{u}", f"i{i}", 1.0]
               for u in range(40) for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15)]
    trust = []
    for u in range(40):
        lo = 0 if u < 20 else 20
        trust += [[f"u{u}", f"u{f}", 1.0] for f in rng.choice(20, size=3, replace=False) + lo if f != u]
    return ratings, trust


def _conf(name, epochs=3, cofactor=COFACTOR_ARGS):
    conf = {
        "ratings": "unused", "ratings.setup": "-columns 0 1 2",
        "social": "unused", "social.setup": "-columns 0 1 2",
        "model.name": name, "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10",
        "num.factors": "8", "num.max.epoch": str(epochs), "batch_size": "64",
        "learnRate": "-init 0.01 -max 1", "reg.lambda": "-u 0.1 -i 0.1 -b 0.1 -s 0.1",
        "output.setup": "off -dir ./results/", "seed": "7",
    }
    if name == "CoFactor":
        conf["CoFactor"] = cofactor
    return conf


def _both(name, epochs=3, cofactor=COFACTOR_ARGS):
    ratings, trust = _rows()
    train, test = data_split(ratings, 0.2, rng=random.Random(3))
    conf = _conf(name, epochs, cofactor)
    jd = JInteractions(jconfig.ModelConf(conf), train, test)
    td = Interactions(ModelConf(conf), train, test)
    jkw = {"social": JSocialGraph(trust, jd)} if name == "SERec" else {}
    tkw = {"social": SocialGraph(trust, td)} if name == "SERec" else {}
    jmodel = getattr(jals, name)(jconfig.ModelConf(conf), jd, **jkw)
    tmodel = getattr(tals, name)(ModelConf(conf), td, device="cpu", **tkw)
    return jmodel, tmodel


def _jax_fit(jmodel, monkeypatch):
    """Fit the JAX model with ``jax.jit`` wrapped: returns each call of its
    jitted epoch as (inputs, outputs), numpy."""
    calls = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") not in ("em_epoch", "epoch_fn"):
            return jitted

        def run(*args):
            out = jitted(*args)
            calls.append(([np.asarray(v) for v in args], [np.asarray(v) for v in out]))
            return out

        return run

    monkeypatch.setattr(jax, "jit", recording_jit)
    jmodel.fit()
    monkeypatch.setattr(jax, "jit", real_jit)
    return calls


def _jax_uniform_tables(jmodel, parts):
    """WRMF's (``parts`` 2) and CoFactor's (3) ``x`` and ``y``, drawn as
    the JAX fit draws them."""
    keys = jax.random.split(jax.random.PRNGKey(jmodel.seed), parts)
    d = jmodel.emb_size
    return {"x": np.asarray(jax.random.uniform(keys[0], (jmodel.num_users, d)) * 10 / 3),
            "y": np.asarray(jax.random.uniform(keys[1], (jmodel.num_items, d)) * 10 / 3)}


def _inject(tmodel, tables):
    tmodel.init_tables = lambda: {k: torch.tensor(np.asarray(v)) for k, v in tables.items()}


def test_cofactor_sppmi_equals_jax_bit_for_bit():
    for args in (COFACTOR_ARGS, "-k 1 -gamma 0.1 -filter 2", "-k 1 -gamma 0.1 -filter 0"):
        jmodel, tmodel = _both("CoFactor", cofactor=args)
        want, got = jmodel._build_sppmi(), tmodel.build_sppmi()
        assert len(got[0]) > 0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    tmodel.build_graph()
    assert tmodel.sppmi_edges == len(got[0])
    assert int(tmodel.sp_indptr[-1]) == tmodel.sppmi_edges


@pytest.mark.parametrize("name", ["ExpoMF", "SERec", "CoFactor"])
def test_numpy_drawn_tables_equal_jax(name, monkeypatch):
    """ExpoMF's and SERec's theta, beta and mu and CoFactor's g, w, c:
    numpy's RandomState(seed) in both packages, read from the JAX fit's
    first epoch call."""
    jmodel, tmodel = _both(name, epochs=1)
    (inputs, _), = _jax_fit(jmodel, monkeypatch)
    names = ["x", "y", "g", "w", "c"] if name == "CoFactor" else ["theta", "beta", "mu"]
    want = dict(zip(names, inputs))
    got = tmodel.init_tables()
    drawn = ["g", "w", "c"] if name == "CoFactor" else names
    for key in drawn:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    assert sorted(got) == sorted(names)


def _close(got, want, key):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("name", MODELS)
def test_three_epochs_match_jax(name, monkeypatch, capsys):
    jmodel, tmodel = _both(name)
    calls = _jax_fit(jmodel, monkeypatch)
    if name == "WRMF":
        _inject(tmodel, _jax_uniform_tables(jmodel, 2))
    elif name == "CoFactor":
        _inject(tmodel, dict(zip(["x", "y", "g", "w", "c"], calls[0][0])))
    jout = capsys.readouterr().out
    tmodel.fit()
    tout = capsys.readouterr().out
    _close(tmodel.U.numpy(), jmodel.U, "U")
    _close(tmodel.V.numpy(), jmodel.V, "V")
    if name == "CoFactor":
        for key, want in zip(["g", "w", "c"], calls[-1][1][2:]):
            _close(tmodel.tables[key].numpy(), want, key)
    if name in ("ExpoMF", "SERec"):
        _close(tmodel.tables["mu"].numpy(), calls[-1][1][2], "mu")
    assert len(tmodel.timer.times) == 3
    if name == "WRMF":
        # the loss lines in the JAX format, their values within f32 rounding
        jl = [float(x.split("loss = ")[1]) for x in jout.splitlines() if "loss = " in x]
        np.testing.assert_allclose(tmodel.epoch_losses, jl, rtol=1e-4)
        assert [x.split(":")[0] for x in tout.splitlines()] == [x.split(":")[0] for x in jout.splitlines()]
        assert tmodel.epoch_losses[-1] < tmodel.epoch_losses[0]
    else:
        assert tout.splitlines() == jout.splitlines() == [f"{name} [1] epoch 3"]


def test_serec_mu_is_per_user_and_item():
    _, tmodel = _both("SERec", epochs=1)
    tmodel.fit()
    mu = tmodel.tables["mu"]
    assert mu.shape == (tmodel.num_users, tmodel.num_items)
    # every row of a_sum is the same, so mu varies across users only
    # through the trust product
    assert not torch.equal(mu[0], mu[1]) and torch.isfinite(mu).all()


# ---------------------------------------------------------------------------
# the bundled configs on the CPU
# ---------------------------------------------------------------------------

# the Recall@10 floors of tests/test_als_models.py:71-91
FLOORS = {"WRMF": 0.6, "ExpoMF": 0.5, "CoFactor": 0.55, "SERec": 0.5}


@pytest.mark.parametrize("name", MODELS)
def test_bundled_config_learns_planted_blocks_on_cpu(tmp_path, capsys, name):
    """``config/<name>.conf`` at tests/test_als_models.py's size: 10 epochs
    of d=8, its seeds and regularization, CoFactor with ``-filter 1``;
    ranked through K2's plain version, with the list and measure files."""
    ratings, trust = _rows()
    rp, tp = tmp_path / "ratings.txt", tmp_path / "trust.txt"
    rp.write_text("".join(f"{u} {i} 1\n" for u, i, _ in ratings))
    tp.write_text("".join(f"{u} {v} 1\n" for u, v, _ in trust))
    conf = ModelConf(str(CONFIG / f"{name}.conf"))
    base = _conf(name, epochs=10)
    for key in ("num.factors", "num.max.epoch", "evaluation.setup", "reg.lambda", "seed",
                "social.setup", *(["CoFactor"] if name == "CoFactor" else [])):
        conf[key] = base[key]
    conf["ratings"], conf["output.setup"] = str(rp), f"on -dir {tmp_path / 'out'}/"
    if name == "SERec":
        conf["social"] = str(tp)
    rec = QRec(conf, seed=3, device="cpu")
    parsed = metrics.parse_measure(rec.execute())
    assert parsed["Top 10"]["Recall"] > FLOORS[name], parsed
    assert f"{name} [1] epoch 10" in capsys.readouterr().out
    assert len(rec.model.timer.times) == 10
    assert len(list((tmp_path / "out").iterdir())) == 2
