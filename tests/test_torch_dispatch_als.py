"""Slice 12 of the port on the CPU: the ALS loops as one dispatch an epoch,
one Adam for every loop, and the mesh's gradient flags read once a phase.

* The ALS loops (WRMF, ExpoMF, CoFactor, SERec) through
  ``runtime/trainer.run_own_epochs``: the captured form
  (``epoch_graphs=True``: the epoch program run as written, as the CPU runs
  a program) against the per-step form (``epoch_graphs=False``), bit for
  bit on every table and on WRMF's losses, with the same printed lines;
  both forms from the JAX package's initial tables against its three
  epochs within item 32's bounds (``tests/test_torch_als.py``: rtol 1e-3,
  atol 1e-4 of the table's largest entry); the host reads of a fit, WRMF's
  every epoch and the others' at every 5th epoch and the last; on two gloo
  ranks, every rank in both forms the one-process run bit for bit.
* The summed gradient flags on a mesh (``parallel/collectives.
  reduce_gradients``): NeuMF's three phases, APR's two and DMF's one on
  two gloo ranks read the flags at most once a phase (NeuMF's GMF and MLP
  phases once each, its fused phase never) where they read them at every
  step before, with the same losses and tables bit for bit; a rank whose
  pattern of held gradients changes reads again, once.
* The one Adam (``runtime/adam.Adam``): its device form, forced onto CPU
  tensors (where ``ops/kernels.adam_update`` runs its plain version, the
  foreach sequence with the table's scalars), against
  ``torch.optim.Adam(foreach=True)`` on the CPU over 100 steps, bit for
  bit; its step scalars against plain Adam's f64 expressions; a step past
  the table; its state, saved state and refusals; the update's plain
  version on CPU tensors, with no launch counted.
"""

import copy
import math

import numpy as np
import pytest
import torch

import test_torch_als as TA
import test_torch_deep as TD
import test_torch_parallel_ranks as R
from qrec_tpu_torch import ModelConf
from qrec_tpu_torch.runtime import trainer as T
from qrec_tpu_torch.runtime.adam import MAX_TABLE_ROWS, Adam, adam_scalars

ALS = ["WRMF", "ExpoMF", "CoFactor", "SERec"]
READS = ("tolist", "item", "__float__")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the ALS loops
# ---------------------------------------------------------------------------


def _als_model(name, graphs, epochs, tables=None):
    """The port's model of ``tests/test_torch_als.py`` in the form ``graphs``
    (``epoch_graphs``), from ``tables`` where given."""
    _, model = TA._both(name, epochs=epochs)
    if tables is not None:
        TA._inject(model, tables)
    model.epoch_graphs = graphs
    return model


def _als_fit(name, graphs, epochs, tables=None):
    """:func:`_als_model` fitted; its printed lines are the test's to read."""
    model = _als_model(name, graphs, epochs, tables)
    model.fit()
    return model


def _tables(model) -> dict:
    return {k: v.clone() for k, v in model.tables.items()}


@pytest.mark.parametrize("name", ALS)
def test_captured_form_equals_per_step_form(name, capsys):
    """Seven epochs (a read at 5 and 7 but WRMF's at every epoch) in both
    forms: every table, U and V, WRMF's losses and the printed lines."""
    runs = {}
    for graphs in (True, False):
        model = _als_fit(name, graphs, 7)
        runs[graphs] = (model, _tables(model), capsys.readouterr().out)
    (g, tg, out_g), (e, te, out_e) = runs[True], runs[False]
    assert tg.keys() == te.keys() == g.init_tables().keys()
    for key in tg:
        assert torch.equal(tg[key], te[key]), key
    assert torch.equal(g.U, e.U) and torch.equal(g.V, e.V)
    assert g.epoch_losses == e.epoch_losses
    assert out_g == out_e
    assert len(g.timer.times) == len(e.timer.times) == 7
    assert g.timer.captures == e.timer.captures == []  # no CUDA graph on the CPU
    if name == "WRMF":
        assert len(g.epoch_losses) == 7 and g.epoch_losses[-1] < g.epoch_losses[0]
        assert out_g.splitlines()[0].startswith("WRMF [1] epoch 1: loss = ")
    else:
        assert g.epoch_losses == []
        assert out_g.splitlines() == [f"{name} [1] epoch 5", f"{name} [1] epoch 7"]


@pytest.mark.parametrize("graphs", [True, False])
@pytest.mark.parametrize("name", ALS)
def test_both_forms_match_jax_after_three_epochs(name, graphs, monkeypatch, capsys):
    """Each form from the JAX package's initial tables (read from its fit,
    as ``tests/test_torch_als.py`` does) against its three epochs."""
    jmodel, _ = TA._both(name)
    calls = TA._jax_fit(jmodel, monkeypatch)
    if name == "WRMF":
        tables = TA._jax_uniform_tables(jmodel, 2)
    elif name == "CoFactor":
        tables = dict(zip(["x", "y", "g", "w", "c"], calls[0][0]))
    else:
        tables = dict(zip(["theta", "beta", "mu"], calls[0][0]))
    jout = capsys.readouterr().out
    model = _als_fit(name, graphs, 3, tables)
    tout = capsys.readouterr().out
    TA._close(model.U.numpy(), jmodel.U, "U")
    TA._close(model.V.numpy(), jmodel.V, "V")
    if name == "CoFactor":
        for key, want in zip(["g", "w", "c"], calls[-1][1][2:]):
            TA._close(model.tables[key].numpy(), want, key)
    if name in ("ExpoMF", "SERec"):
        TA._close(model.tables["mu"].numpy(), calls[-1][1][2], "mu")
    if name == "WRMF":
        jl = [float(x.split("loss = ")[1]) for x in jout.splitlines() if "loss = " in x]
        np.testing.assert_allclose(model.epoch_losses, jl, rtol=1e-4)
        assert [x.split(":")[0] for x in tout.splitlines()] == [
            x.split(":")[0] for x in jout.splitlines()]
    else:
        assert tout.splitlines() == jout.splitlines() == [f"{name} [1] epoch 3"]


@pytest.mark.parametrize("graphs", [True, False])
@pytest.mark.parametrize("name", ALS)
def test_host_reads_only_at_printed_epochs(name, graphs, monkeypatch, capsys):
    """Seven epochs: the fit reads a tensor on the host (``tolist``,
    ``item``, ``float``) once an epoch for WRMF, whose loss prints every
    epoch, and at epochs 5 and 7 for the others, in both forms."""
    model = _als_model(name, graphs, 7)
    counts = dict.fromkeys(READS, 0)
    for method in READS:
        real = getattr(torch.Tensor, method)

        def counted(self, *a, _real=real, _method=method, **k):
            counts[_method] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, method, counted)
    model.fit()
    monkeypatch.undo()
    assert counts == {"tolist": 7 if name == "WRMF" else 2, "item": 0, "__float__": 0}
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == (7 if name == "WRMF" else 2)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The four ALS confs (``tests/test_torch_parallel_models.py``'s
    planted files, 7 epochs) on two gloo ranks in both forms, and in one
    process per step."""
    import test_torch_parallel_models as PM

    tmp = tmp_path_factory.mktemp("als_mesh")
    files = PM._write_files(tmp)
    runs = {}
    for name in ALS:
        conf = PM._conf(name, files, "", setup="on")
        conf["num.max.epoch"] = "7"
        runs[name] = dict(conf, out_dir=str(tmp / "out"))
    ranks = R.spawn(R.als_forms, 2, tmp, runs)
    one = {}
    for name, conf in runs.items():
        run = {k: v for k, v in conf.items() if k not in ("out_dir", "parallel.setup")}
        run["output.setup"] = f"on -dir {tmp / 'one' / name}"
        one[name] = R.replicated_run(run)
    return ranks, one


@pytest.mark.parametrize("name", ALS)
def test_mesh_runs_both_forms_as_one_process(mesh_runs, name):
    """Replicated on a mesh, every rank solves the whole tables with no
    collective in its epochs: each rank's run in each form equals the
    one-process run bit for bit (tables, factors, losses, ranked lists and
    measures)."""
    ranks, one = mesh_runs
    want = one[name]
    assert want["mesh"] is None
    for rank, out in enumerate(ranks):
        for graphs in (True, False):
            got = out[(name, graphs)]
            assert got["mesh"] is not None, (rank, graphs)
            assert got["tables"].keys() == want["tables"].keys()
            for key in want["tables"]:
                np.testing.assert_array_equal(got["tables"][key], want["tables"][key])
            np.testing.assert_array_equal(got["U"], want["U"])
            np.testing.assert_array_equal(got["V"], want["V"])
            assert got["losses"] == want["losses"]
            assert got["measure"] == want["measure"]
            ids = np.concatenate([i for i, _ in got["ranked"]])
            assert np.array_equal(ids, np.concatenate([i for i, _ in want["ranked"]]))


# ---------------------------------------------------------------------------
# the gradient flags on a mesh
# ---------------------------------------------------------------------------

FLAG_CASES = {"NeuMF": 4, "APR": 4, "DMF": 2}


@pytest.fixture(scope="module")
def flag_runs(tmp_path_factory):
    train, test = TD._records()
    cases = {}
    for name, epochs in FLAG_CASES.items():
        conf = TD._conf(name, {"num.max.epoch": str(epochs), "parallel.setup": "on"})
        cases[name] = (conf, train, test)
    return R.spawn(R.flag_read_fits, 2, tmp_path_factory.mktemp("flags"), cases)


@pytest.mark.parametrize("name", list(FLAG_CASES))
def test_flags_read_at_most_once_a_phase_with_todays_tables(flag_runs, name):
    """Each phase reads the summed flags at most once where it read them at
    every step that lacked a gradient; the losses and tables are the same
    bits. NeuMF's GMF and MLP phases reach none of the other tower's
    parameters on any rank: one read each, where they read every step; its
    fused phase reaches every parameter and reads none."""
    for rank, out in enumerate(flag_runs):
        kept, every = out[(name, True)], out[(name, False)]
        assert all(n <= 1 for n in kept["reads"]), (rank, kept["reads"])
        assert kept["losses"] == every["losses"]
        assert kept["params"].keys() == every["params"].keys()
        for key in kept["params"]:
            np.testing.assert_array_equal(kept["params"][key], every["params"][key])
        if name == "NeuMF":
            assert kept["reads"] == [1, 1, 0]
            assert every["reads"][0] > 1 and every["reads"][1] > 1 and every["reads"][2] == 0
    assert flag_runs[0][(name, True)]["losses"] == flag_runs[1][(name, True)]["losses"]


def test_a_changed_pattern_of_held_gradients_reads_again(flag_runs):
    """Data rank 0 holds ``a`` and ``b`` at every step: one read, at the
    first. Data rank 1 holds ``b`` only at steps 3 and 4: a read at step 1
    and at step 3, none at step 5, whose pattern it read at step 1. ``b``
    sums the ranks that held it, ``c`` (reached by none) keeps no
    gradient."""
    r0, r1 = (out["patterns"] for out in flag_runs)
    assert [s["reads"] for s in r0] == [1, 0, 0, 0, 0]
    assert [s["reads"] for s in r1] == [1, 0, 1, 0, 0]
    b = torch.linspace(-1.0, 1.0, 4).numpy()
    for steps in (r0, r1):
        for k, s in enumerate(steps):
            np.testing.assert_array_equal(s["a"], np.full((2, 3), 3.0, dtype=np.float32))
            np.testing.assert_array_equal(s["b"], (4 if k in (2, 3) else 2) * b)
            assert s["c"] is None


# ---------------------------------------------------------------------------
# the one Adam
# ---------------------------------------------------------------------------


def _pair(lr, seed=0):
    """Three parameters (the third without a gradient at two steps of
    three) under the device form forced onto the CPU and under
    ``torch.optim.Adam(foreach=True)``, with the same gradients."""
    rng = np.random.RandomState(seed)
    shapes = [(50, 20), (300,), (7, 3)]
    ps = [torch.tensor(rng.randn(*s).astype(np.float32), requires_grad=True) for s in shapes]
    qs = [p.detach().clone().requires_grad_() for p in ps]
    ours = Adam(ps, lr, device_scalars=True)
    plain = torch.optim.Adam(qs, lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=True)
    return rng, ps, qs, ours, plain


@pytest.mark.parametrize("lr", [0.001, 0.01])
def test_device_form_on_cpu_tensors_against_foreach_adam(lr):
    rng, ps, qs, ours, plain = _pair(lr)
    for k in range(100):
        for i, (p, q) in enumerate(zip(ps, qs)):
            if i == 2 and k % 3:
                p.grad = q.grad = None
                continue
            g = torch.tensor(rng.randn(*p.shape).astype(np.float32))
            p.grad, q.grad = g.clone(), g.clone()
        ours.step()
        plain.step()
    for p, q in zip(ps, qs):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(ours.state[p][key], plain.state[q][key]), key
        assert torch.equal(p, q)
    assert [float(ours.state[p]["step"]) for p in ps] == [100.0, 100.0, 34.0]


def test_step_scalars_are_plain_adams_f64_expressions():
    """Row t-1 of the table is f32 of ``(lr / (1 - b1**t)) * -1`` and ``(1 -
    b2**t) ** 0.5`` as ``_multi_tensor_adam`` forms them from the step's
    float; the table ends where both bias corrections are 1 in f64, so
    every later step's scalars equal its last row."""
    for lr in (0.001, 0.01, 0.05):
        table = adam_scalars(lr, 0.9, 0.999)
        assert table.dtype == np.float32 and table.shape[1] == 2
        for t in (1, 2, 3, 10, 100, 1000, 16000, len(table)):
            bc1, bc2 = 1 - 0.9 ** float(t), 1 - 0.999 ** float(t)
            want = np.asarray([(lr / bc1) * -1, bc2 ** 0.5], dtype=np.float32)
            np.testing.assert_array_equal(table[t - 1], want)
        t = len(table)
        assert 1 - 0.9 ** float(t) == 1.0 and 1 - 0.999 ** float(t) == 1.0
        assert 1 - 0.999 ** float(t - 1) != 1.0
        later = [(lr / (1 - 0.9 ** float(s))) * -1 for s in (t + 1, 10 * t)]
        assert np.float32(later[0]) == np.float32(later[1]) == table[-1, 0]
    with pytest.raises(ValueError, match="bias corrections"):
        adam_scalars(0.01, 0.9, 1.0)
    assert MAX_TABLE_ROWS >= len(adam_scalars(0.001, 0.9, 0.999))


def test_a_step_past_the_table_reads_its_last_row():
    """A step count set past the table's rows takes the last row's scalars,
    which are every later step's."""
    p = torch.ones(5, requires_grad=True)
    q = p.detach().clone().requires_grad_()
    ours = Adam([p], 0.01, device_scalars=True)
    plain = torch.optim.Adam([q], lr=0.01, foreach=True)
    ours.prepare()
    rows = len(adam_scalars(0.01, 0.9, 0.999))
    plain.state[q] = {"step": torch.tensor(float(rows + 40)), "exp_avg": torch.full((5,), 0.5),
                      "exp_avg_sq": torch.full((5,), 0.25)}
    ours.state[p]["step"].fill_(rows + 40)
    ours.state[p]["exp_avg"].fill_(0.5)
    ours.state[p]["exp_avg_sq"].fill_(0.25)
    p.grad = q.grad = torch.full((5,), 0.3)
    ours.step()
    plain.step()
    assert torch.equal(p, q)
    assert float(ours.state[p]["step"]) == rows + 41


def test_state_is_made_before_the_first_step_and_saved_as_torch_adams():
    """``prepare`` (``trainer.init_adam_state``) makes the zero step count
    and moments a first step would; the state dict holds ``step``,
    ``exp_avg`` and ``exp_avg_sq`` and loads into a fresh Adam, which then
    steps as the unbroken one does; on CPU parameters without
    ``device_scalars`` the step is ``torch.optim.Adam``'s own."""
    p = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    opt = T.make_optimizer([p], "adam", 0.1)
    assert type(opt) is Adam and not opt._device_form()
    T.init_adam_state(opt)
    state = opt.state[p]
    assert sorted(state) == ["exp_avg", "exp_avg_sq", "step"]
    assert float(state["step"]) == 0.0 and not state["exp_avg"].any()
    for forced in (None, True):
        a = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
        opt = Adam([a], 0.1, device_scalars=forced)
        for _ in range(3):
            a.grad = torch.tensor([0.5, 0.1, -0.2])
            opt.step()
        saved = copy.deepcopy(opt.state_dict())  # as a checkpoint's torch.save copies
        assert sorted(saved["state"][0]) == ["exp_avg", "exp_avg_sq", "step"]
        b = a.detach().clone().requires_grad_()
        again = Adam([b], 0.1, device_scalars=forced)
        again.load_state_dict(saved)
        for x, o in ((a, opt), (b, again)):
            x.grad = torch.tensor([0.3, 0.3, 0.3])
            o.step()
        assert torch.equal(a, b)
        assert float(again.state[b]["step"]) == 4.0
    plain = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    ref = torch.optim.Adam([plain], lr=0.1, betas=(0.9, 0.999), eps=1e-8)
    mine = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    opt = T.make_optimizer([mine], "adam", 0.1)
    for _ in range(5):
        plain.grad = mine.grad = torch.tensor([0.5, 0.1, -0.2])
        ref.step()
        opt.step()
    assert torch.equal(plain, mine)


def test_adam_update_on_cpu_tensors_is_its_plain_version():
    """``adam_update`` on CPU tensors runs the foreach sequence with the
    table's row of the step (the last row past the table), counts no
    launch, and equals ``adam_update_plain`` bit for bit."""
    from qrec_tpu_torch.ops import kernels as K

    rng = np.random.RandomState(3)
    table = torch.tensor(adam_scalars(0.01, 0.9, 0.999))
    for t in (1.0, 7.0, float(len(table) + 5)):
        p, m = (torch.tensor(rng.randn(37).astype(np.float32)) for _ in range(2))
        v = torch.tensor(rng.rand(37).astype(np.float32))
        q = p.clone()
        before = K.ADAM.launches
        K.adam_update(p, m, v, torch.tensor(t), table, 1e-8)
        assert K.ADAM.launches == before
        p0 = q.clone()
        K.adam_update_plain(q, m, v, torch.tensor(t), table, 1e-8)
        assert torch.equal(p, q)
        s, c = (float(x) for x in table[min(int(t), len(table)) - 1])
        want = p0.double() + s * (m.double() / (v.double().sqrt() / c + 1e-8))
        np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)


def test_device_form_refuses_what_it_does_not_compute():
    p = torch.ones(3, requires_grad=True)
    p.grad = torch.ones(3)
    for key, value in (("weight_decay", 0.1), ("amsgrad", True), ("maximize", True)):
        opt = Adam([p], 0.1, device_scalars=True)
        opt.param_groups[0][key] = value
        with pytest.raises(ValueError, match="device form"):
            opt.step()
    assert math.isfinite(float(p.sum()))
