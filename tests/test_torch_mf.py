"""The MF slice of the PyTorch port (BasicMF, PMF, SVD, BPR) against the JAX
package: the first step's loss and gradients on the same parameters and
batch, three epochs of bold-driver SGD on the JAX sampler's batches, and
the bold driver and the convergence rule on scripted losses, alone and
inside the training loop.

Tolerances: the first step's loss within rtol 1e-6 and each gradient
within rtol 1e-6 plus 1e-6 of its largest entry (the same f32 terms summed
in another order); after three epochs the tables within 1e-4 and the epoch
losses within rtol 1e-3 (SGD steps of another framework's rounding,
compounded); the learning rates and the stopping epoch exactly."""

import random
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from qrec_tpu import config as jconfig
from qrec_tpu.data.dataset import Interactions as JInteractions
from qrec_tpu.data.split import data_split
from qrec_tpu.models import mf as jmf
from qrec_tpu.runtime import trainer as jtrainer
from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.convert import embedding_params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.errors import ConvergenceError
from qrec_tpu_torch.models import mf
from qrec_tpu_torch.runtime import trainer as T

RANKING = {"item.ranking": "on -topN 5"}
CASES = [
    ("BasicMF", {}),
    ("PMF", {}),
    ("SVD", {}),
    ("BPR", RANKING),
    ("BPR", {**RANKING, "evaluation.setup": "-ap 0.25 -tf"}),
]
CONFIG = Path(__file__).resolve().parents[1] / "config"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _conf(name, extra=None):
    base = {
        "ratings": "unused",
        "ratings.setup": "-columns 0 1 2",
        "model.name": name,
        "evaluation.setup": "-ap 0.25",
        "item.ranking": "off -topN 5",
        "num.factors": "6",
        "num.max.epoch": "3",
        "batch_size": "32",
        "learnRate": "-init 0.02 -max 0.05",
        "reg.lambda": "-u 0.01 -i 0.02 -b 0.05 -s 0.2",
        "output.setup": "off -dir ./results/",
        "seed": "11",
    }
    base.update(extra or {})
    return base


def rated_split(users=20, items=30, per_user=8, seed=5):
    """Explicit ratings on 0.5-4.0 in half steps, split 3:1."""
    rng = np.random.RandomState(seed)
    records = [
        [f"u{u}", f"i{i}", float(rng.randint(1, 9)) / 2]
        for u in range(users)
        for i in rng.choice(items, size=per_user, replace=False)
    ]
    return data_split(records, 0.25, rng=random.Random(2))


def both_models(name, extra=None):
    """The JAX model with its built spec, and the port's model holding the
    same initial parameters."""
    train, test = rated_split()
    jconf = jconfig.ModelConf(_conf(name, extra))
    jmodel = getattr(jmf, name)(jconf, JInteractions(jconf, train, test))
    spec = jmodel.build()
    tconf = ModelConf(_conf(name, extra))
    tmodel = getattr(mf, name)(tconf, Interactions(tconf, train, test), device="cpu")
    tmodel.load_state_dict(embedding_params_from_jax(
        {k: np.asarray(v) for k, v in spec.params.items()}, "cpu"))
    return jmodel, spec, tmodel


@pytest.mark.parametrize("name,extra", CASES)
def test_first_step_loss_and_gradients_match_jax(name, extra):
    jmodel, spec, tmodel = both_models(name, extra)
    batch = tuple(np.asarray(a)[0] for a in spec.sampler(jax.random.PRNGKey(3)))
    jloss, jgrads = jax.value_and_grad(spec.loss_fn)(spec.params, batch, jax.random.PRNGKey(0))
    loss = tmodel.loss(T.as_device_batches(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    names = dict(tmodel.named_parameters())
    assert sorted(names) == sorted(jgrads)
    for key, p in names.items():
        want = np.asarray(jgrads[key])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=key)


def jax_bold_epochs(jmodel, spec, epochs, seed=0):
    """The JAX package's bold-mode epoch loop (EpochLoop with a BoldDriver
    and a ConvergenceMonitor): returns the epoch batches it drew, its
    losses, its learning rates and its final parameters."""
    optimizer = optax.inject_hyperparams(optax.sgd)(learning_rate=jmodel.lrate)
    run_epoch = jtrainer.make_epoch_runner(spec.loss_fn, optimizer)
    params, opt_state = spec.params, optimizer.init(spec.params)
    bold = jtrainer.BoldDriver(jmodel.lrate, jmodel.max_lrate)
    conv = jtrainer.ConvergenceMonitor()
    rng = jax.random.PRNGKey(seed)
    batches, losses, rates = [], [], []
    for epoch in range(epochs):
        rng, rs, rt = jax.random.split(rng, 3)
        b = spec.sampler(rs)
        batches.append(tuple(np.asarray(a) for a in b))
        rates.append(bold.lr)
        params, opt_state, loss = run_epoch(params, opt_state, b, rt)
        losses.append(float(loss))
        if conv.check(losses[-1]):
            break
        lr = bold.update(epoch + 1, losses[-1])
        bold.last_loss = losses[-1]
        opt_state = jtrainer._set_lr(opt_state, lr)
    return batches, losses, rates, params


@pytest.mark.parametrize("name,extra", CASES[:4])
def test_three_bold_epochs_on_injected_batches_match_jax(name, extra, capsys):
    jmodel, spec, tmodel = both_models(name, extra)
    batches, jlosses, jrates, params = jax_bold_epochs(jmodel, spec, 3)
    losses = tmodel.fit(epoch_batches=batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for key, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[key]), atol=1e-4,
                                   err_msg=key)
    # the epoch lines print the rate in force during each epoch
    printed = [float(line.split("learning_rate = ")[1].split()[0])
               for line in capsys.readouterr().out.splitlines() if "learning_rate" in line]
    np.testing.assert_allclose(printed, jrates, atol=5e-6)  # printed to 5 decimals
    assert tmodel.U.shape == (tmodel.num_users, 6) and tmodel.V.shape == (tmodel.num_items, 6)


# scripted epoch losses: decreases, an increase, a plateau within 1e-3
# (convergence), sign changes; and a cap the driver reaches
SCRIPTS = [
    ([10.0, 9.0, 9.5, 8.0, 7.0, 6.0, 5.5, 5.0], 0.05, 1.0),
    ([10.0, 9.0, 8.0, 7.0, 6.0, 5.0, 4.0], 0.05, 0.06),
    ([4.0, 3.0, 3.0005, 2.0], 0.01, 1.0),
    ([-1.0, 2.0, -3.0, 0.5, 0.4, 0.3], 0.1, 0.0),
    ([5.0, 5.0], 0.02, 1.0),
]


def _replay(module, losses, lr, max_lr):
    """The JAX package's per-epoch order: the convergence check, then the
    driver's update and its last loss. Returns (rates in force, the epoch
    that converged or None)."""
    bold, conv = module.BoldDriver(lr, max_lr), module.ConvergenceMonitor()
    rates = []
    for epoch, loss in enumerate(losses):
        rates.append(bold.lr)
        if conv.check(loss):
            return rates, epoch
        bold.update(epoch + 1, loss)
        bold.last_loss = loss
    return rates, None


@pytest.mark.parametrize("losses,lr,max_lr", SCRIPTS)
def test_bold_driver_and_convergence_replay_jax(losses, lr, max_lr):
    assert _replay(T, losses, lr, max_lr) == _replay(jtrainer, losses, lr, max_lr)


@pytest.mark.parametrize("losses,lr,max_lr", SCRIPTS)
def test_bold_training_loop_follows_the_script(losses, lr, max_lr, monkeypatch):
    """``train(mode="bold")`` with one batch an epoch whose loss is the
    script's: the rates in the epoch lines and on the optimizer, and the
    epoch training stops at, are the JAX classes'."""
    w = torch.zeros(1, requires_grad=True)
    script = iter(losses)
    lines = []

    def loss_fn(batch, gen):
        return (w * 0).sum() + next(script)

    real_sgd = torch.optim.SGD
    optimizers = []

    def sgd(params, lr):
        optimizers.append(real_sgd(params, lr=lr))
        return optimizers[-1]

    def sampler(gen):
        return (torch.zeros((1, 1), dtype=torch.int64),)

    monkeypatch.setattr(torch.optim, "SGD", sgd)
    got, _ = T.train([w], loss_fn, sampler, max_epoch=len(losses), lr=lr, device="cpu",
                     mode="bold", max_lr=max_lr, generator=torch.Generator(),
                     examples_per_epoch=1,
                     emit=lambda e, loss, rate, wall, metrics: lines.append((e, rate)))
    rates, stop = _replay(jtrainer, losses, lr, max_lr)
    assert [rate for _, rate in lines] == rates
    if stop is None:  # the optimizer holds the driver's rate for the next epoch
        driver = jtrainer.BoldDriver(lr, max_lr)
        driver.lr, driver.last_loss = rates[-1], losses[-2] if len(losses) > 1 else 0.0
        assert optimizers[0].param_groups[0]["lr"] == driver.update(len(losses), losses[-1])
    assert len(got) == (len(losses) if stop is None else stop + 1)


def test_nan_loss_aborts_bold_training():
    w = torch.zeros(1, requires_grad=True)
    with pytest.raises(ConvergenceError):
        T.train([w], lambda b, g: (w * 0).sum() + float("nan"),
                lambda g: (torch.zeros((1, 1), dtype=torch.int64),), max_epoch=2, lr=0.1,
                device="cpu", mode="bold", max_lr=1.0, generator=torch.Generator(),
                examples_per_epoch=1)


def test_tf_switch_trains_bpr_with_adam_on_the_unshuffled_sampler(monkeypatch):
    _, _, tmodel = both_models("BPR", {**RANKING, "evaluation.setup": "-ap 0.25 -tf"})
    assert tmodel.tf_path and tmodel.build().mode == "bold"
    # normal init: |x| <= 2 sigma
    assert 0 < tmodel.user_emb.abs().max() <= 0.01
    users, pos, _, _ = tmodel.build().sampler(torch.Generator().manual_seed(0))
    n = tmodel.train_size
    # file order: the training pairs as loaded, the tail padded
    assert torch.equal(users.flatten()[:n], torch.as_tensor(tmodel.data.train_u, dtype=torch.int64))
    assert torch.equal(pos.flatten()[:n], torch.as_tensor(tmodel.data.train_i, dtype=torch.int64))
    made = []
    real = T.make_optimizer
    monkeypatch.setattr(T, "make_optimizer", lambda p, mode, lr: made.append(mode) or real(p, mode, lr))
    tmodel.fit()
    assert made == ["adam"]


def _synthetic_ratings(tmp_path):
    rng = np.random.RandomState(1)
    path = tmp_path / "ratings.txt"
    path.write_text("".join(
        f"{u} {i} {rng.randint(1, 9) / 2}\n"
        for u in range(30)
        for i in rng.choice(50, size=10, replace=False)
    ))
    return path


@pytest.mark.parametrize(
    "name", ["BasicMF", "PMF", "SVD", "BPR", "UserMean", "ItemMean", "MostPopular", "Rand"])
def test_bundled_conf_runs_on_cpu(name, tmp_path):
    """The bundled conf as published (on a synthetic file, 2 epochs):
    ``QRec(conf).execute()`` on the CPU gives its measures and files."""
    from qrec_tpu_torch import QRec
    from qrec_tpu_torch.ops.metrics import parse_measure

    conf = ModelConf(str(CONFIG / f"{name}.conf"))
    conf["ratings"] = str(_synthetic_ratings(tmp_path))
    conf["num.max.epoch"] = "2"
    conf["output.setup"] = f"on -dir {tmp_path / 'results'}/"
    rec = QRec(conf, device="cpu")
    parsed = parse_measure(rec.execute())
    files = sorted(p.name for p in (tmp_path / "results").iterdir())
    if conf.options("item.ranking").isMainOn():
        assert 0 <= parsed["Top 10"]["Recall"] <= 1
        assert any("-top-10items[1].txt" in f for f in files)
    else:
        assert 0 < parsed["global"]["MAE"] <= parsed["global"]["RMSE"] < 4
        assert any("-rating-predictions[1].txt" in f for f in files)
    assert any("-measure[1].txt" in f for f in files)
    if isinstance(rec.model, mf.PMF | mf.SVD | mf.BPR):
        assert len(rec.model.epoch_losses) == 2
