"""Rank workers of ``tests/test_torch_parallel.py``,
``tests/test_torch_parallel_social.py``,
``tests/test_torch_parallel_models.py``,
``tests/test_torch_parallel_bold.py``,
``tests/test_torch_parallel_deep.py`` and ``tests/test_torch_dispatch_als.py``.
Each runs in a spawned
process of a gloo group on the CPU and returns what the test holds against
the JAX package and against one process. This module holds no test: a
spawned rank imports it, and it imports no JAX, as the port imports none.
"""

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from qrec_tpu_torch import ModelConf, QRec
from qrec_tpu_torch.convert import params_from_jax
from qrec_tpu_torch.data.dataset import Interactions
from qrec_tpu_torch.data.social import SocialGraph
from qrec_tpu_torch.data.graph import COO
from qrec_tpu_torch.models import get_model
from qrec_tpu_torch.ops import topk
from qrec_tpu_torch.ops.sampling import pack_bitmask
from qrec_tpu_torch.ops.losses import infonce_dispatch
from qrec_tpu_torch.ops.spmm import (
    DenseJoint,
    ShardedDenseJoint,
    ShardedSparseJoint,
    factored_edge_drop_view,
    factored_node_drop_view,
    spmm,
)
from qrec_tpu_torch.parallel import collectives
from qrec_tpu_torch.parallel.collectives import all_reduce_sum, reduce_gradients, split_range
from qrec_tpu_torch.parallel.mesh import make_mesh
from qrec_tpu_torch.runtime import checkpoint as C
from qrec_tpu_torch.runtime import trainer as T


def spawn(target, world: int, store_dir, *args) -> list:
    """``target(rank, *args)`` in ``world`` spawned processes joined by a gloo
    group through a file store in ``store_dir`` (no TCP port for parallel
    test workers to race for); each rank's return value, in rank order."""
    torch.multiprocessing.spawn(_entry, args=(target, world, str(store_dir), args),
                                nprocs=world, join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, target, world, store_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_dir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        result = target(rank, *args)
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        # no rank tears its connections down while another still uses them
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def routes(rank, inputs):
    """Routes 4 and 5 on a data 2 x model 2 mesh, each with the step's
    gradient reduction over ``data`` as the trainer makes it: K5's row
    blocks (the forward, and a loss whose share is this data rank's rows of
    ``sum(y * w)``) and the row-sharded InfoNCE."""
    mesh = make_mesh(2)
    out = {"shape": mesh.shape, "place": (mesh.data_index, mesh.model_index)}
    g = inputs["graph"]
    coo = COO(g["rows"], g["cols"], g["vals"], (g["n"], g["n"]))
    adj = ShardedSparseJoint.from_host(coo, "cpu", mesh)
    out["block"] = (adj.row0, adj.row1, adj.edge0, adj.edge1)
    out["graph"] = {}
    r0, r1 = split_range(g["n"], mesh.data, mesh.data_index)
    for x_np, w_np in zip(g["x"], g["w"]):
        x = _t(x_np).requires_grad_(True)
        vals = _t(g["vals2"]).requires_grad_(True)
        y, y2 = spmm(adj, x), spmm(adj, x, vals)
        w = _t(w_np)
        ((y * w)[r0:r1].sum() + (y2 * w)[r0:r1].sum()).backward()
        reduce_gradients([x, vals], mesh)
        out["graph"][x_np.shape[1]] = (y.detach().numpy(), y2.detach().numpy(),
                                       x.grad.numpy(), vals.grad.numpy())
    out["infonce"] = {}
    for b, case in inputs["infonce"].items():
        v1 = _t(case["view1"]).requires_grad_(True)
        v2 = _t(case["view2"]).requires_grad_(True)
        loss = infonce_dispatch(v1, v2, _t(case["mask"]), case["temp"], mesh)
        loss.backward()
        reduce_gradients([v1, v2], mesh)
        total = all_reduce_sum(loss.detach().clone(), mesh.data_group)
        out["infonce"][b] = (float(loss), float(total), v1.grad.numpy(), v2.grad.numpy())
    out.update(dense_routes(mesh, inputs["dense"]))
    return out


def dense_routes(mesh, inputs) -> dict:
    """Route 6 (K1 on the rank's item-column block) in each dense form: one
    and two layers forward, and the gradient of a loss whose share is this
    data rank's rows of ``sum(y * w)``, after the step's reduction; SGL's
    factored views of the block (their scales, and the block of the
    edge-drop table); the ranking cut by test user (route 7), with K2's
    calls on this rank."""
    out = {"dense": {}, "views": {}}
    n = inputs["n"]
    r0, r1 = split_range(n, mesh.data, mesh.data_index)
    for form, (r, su, si) in inputs["forms"].items():
        adj = ShardedDenseJoint.from_joint(
            DenseJoint.from_tables(dense_table(r, form), _t(su), _t(si), form), mesh)
        out["cols"] = (adj.col0, adj.col1, adj.r.shape[1], adj.col_sizes)
        for x_np, w_np in zip(inputs["x"], inputs["w"]):
            got = []
            for layers in (1, 2):
                x = _t(x_np).requires_grad_(True)
                y = x
                for _ in range(layers):
                    y = spmm(adj, y)
                ((y * _t(w_np))[r0:r1].sum()).backward()
                reduce_gradients([x], mesh)
                got += [y.detach().numpy(), x.grad.numpy()]
            out["dense"][form, x_np.shape[1]] = tuple(got)
    v = inputs["views"]
    adj = ShardedDenseJoint.from_joint(DenseJoint.from_tables(
        _t(v["r"]), _t(v["su"]), _t(v["si"])), mesh)
    edges = torch.nonzero(adj.r, as_tuple=True)
    edge = factored_edge_drop_view(adj, edges, _t(v["ru"]), _t(v["ci"]), v["p"])
    node = factored_node_drop_view(adj, _t(v["keep_u"]), _t(v["keep_i"]))
    for name, view in (("edge", edge), ("node", node)):
        out["views"][name] = (view.row_scale.numpy(), view.col_scale.numpy(),
                              view.r[:, : adj.col1 - adj.col0].numpy())
    out["ranking"] = ranking(mesh, inputs["ranking"])
    return out


def dense_table(r: np.ndarray, form: str) -> torch.Tensor:
    """A dense form's R from its numpy array: the bf16 table travels as its
    f32 values (exact)."""
    t = _t(r)
    return t.to(torch.bfloat16) if form == "off" else t


def ranking(mesh, case) -> dict:
    """``CatalogRanker(mesh=)`` on a plain and a biased score form: the
    gathered lists and the rows of every K2 call this rank made."""
    data = Interactions(ModelConf(case["conf"]), case["train"], case["test"])
    bitmask = torch.from_numpy(rated_bitmask(data))
    calls = []
    kernel = topk.masked_catalog_topk

    def counted(user_emb, items, bitmask, uids, *a, **k):
        calls.append(int(uids.shape[0]))
        return kernel(user_emb, items, bitmask, uids, *a, **k)

    topk.masked_catalog_topk = counted
    try:
        ranker = topk.CatalogRanker(data, case["k"], "cpu", bitmask, batch_size=case["batch"],
                                    mesh=mesh)
        out = {}
        for name, form in case["forms"].items():
            calls.clear()
            ids, scores = ranker.topk(topk.ScoreForm(*(
                _t(a) if isinstance(a, np.ndarray) else a for a in form)))
            out[name] = (ids, scores, list(calls))
    finally:
        topk.masked_catalog_topk = kernel
    return out


def rated_bitmask(data) -> np.ndarray:
    return pack_bitmask(data.u_indptr, data.u_indices, data.num_users, data.num_items)


def uneven(rank, inputs):
    """Route 6, the views and the ranking on three ranks (data 3 x model
    1): the items and the test users cut unevenly."""
    mesh = make_mesh()
    return dict(dense_routes(mesh, inputs), shape=mesh.shape)


def as_numpy(x):
    """Tensors (in nested tuples and lists) as numpy arrays: a spawn passes
    each tensor through shared memory, which costs seconds for a few
    thousand draws, and an array is pickled with its bytes."""
    if isinstance(x, torch.Tensor):
        return x.numpy().copy()
    if isinstance(x, (tuple, list)):
        return type(x)(as_numpy(v) for v in x)
    return x


def as_tensors(x):
    """The inverse of :func:`as_numpy`."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, (tuple, list)):
        return type(x)(as_tensors(v) for v in x)
    return x


# the loss of a fit's first phase, by the name the model gives it: the
# generic ``loss``, SEPT's warm-up ``rec_loss``, NeuMF's GMF ``loss_mf``,
# APR's ``base_loss``, ESRF's discriminator ``d_loss``
FIRST_LOSSES = ("loss", "rec_loss", "loss_mf", "base_loss", "d_loss")
COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "barrier")


def fit_case(case) -> dict:
    """One model fit on injected batches (and the models' draws) from the
    JAX package's initial parameters (and BUIR's target, under ``target``):
    the losses, the first step's loss (this data rank's share on a mesh),
    the tables and buffers, the final factors (None for a model that keeps
    none: NeuMF, CDAE), every parameter's gradient
    at the first optimizer step (None where the step holds none) and, for
    the first step of each optimizer, its gradients and the parameters
    after it; the calls of each collective that the fit made. A case with
    a ``relation`` gives the model its trust graph, one with ``friends``
    (the walk family's (friend ids, active users)) its implicit friends in
    place of its walks and SGNS, one with ``attrs`` those attributes (ESRF's
    ``segment``)."""
    conf = ModelConf(case["conf"])
    data = Interactions(conf, case["train"], case["test"])
    kwargs = {}
    if case.get("relation") is not None:
        kwargs["social"] = SocialGraph(case["relation"], data)
    model = get_model(case["conf"]["model.name"])(conf, data, device="cpu", **kwargs)
    model.load_state_dict(params_from_jax(case["params"], "cpu"))
    for name, value in case.get("attrs", {}).items():
        setattr(model, name, value)
    if case.get("draws") is not None:
        stream = iter(case["draws"])
        model.draw = lambda gen: as_tensors(next(stream))
    if case.get("friends") is not None:
        model.implicit_friends = lambda: case["friends"]
    step_losses = []

    def first_loss(loss):
        def wrapped(*args, **kwargs):
            value = loss(*args, **kwargs)
            if not step_losses:
                step_losses.append(value.item())
            return value
        return wrapped

    for name in FIRST_LOSSES:
        if hasattr(model, name):
            setattr(model, name, first_loss(getattr(model, name)))
    host = lambda t: None if t is None else t.detach().clone().numpy()  # noqa: E731
    # the optimizers held, not their ids: a later phase's may take a freed id
    firsts, stepped = [], []
    originals = {cls: cls.step for cls in (torch.optim.Adam, torch.optim.SGD)}

    def spy(cls):
        def step(opt, *a, **k):
            if any(opt is seen for seen in stepped):
                return originals[cls](opt, *a, **k)
            stepped.append(opt)
            grads = {n: host(p.grad) for n, p in model.named_parameters()}
            out = originals[cls](opt, *a, **k)
            firsts.append({"grads": grads,
                           "after": {n: host(p) for n, p in model.named_parameters()}})
            return out
        return step

    calls = dict.fromkeys(COLLECTIVES, 0)
    real = {name: getattr(dist, name) for name in COLLECTIVES}

    def counted(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call

    mesh = model.mesh  # the mesh's groups are made before the count starts
    for cls in originals:
        cls.step = spy(cls)
    for name in COLLECTIVES:
        setattr(dist, name, counted(name))
    try:
        losses = model.fit(epoch_batches=case["batches"])
    finally:
        for cls, step in originals.items():
            cls.step = step
        for name, fn in real.items():
            setattr(dist, name, fn)
    return {
        "losses": losses, "grads": firsts[0]["grads"], "first_steps": firsts,
        "first_loss": step_losses[0], "collectives": calls,
        "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
        "buffers": {n: b.numpy().copy() for n, b in model.named_buffers()},
        "U": host(model.U), "V": host(model.V),
        "mesh": None if mesh is None else mesh.shape,
        "adj": type(model.joint_adj).__name__ if hasattr(model, "joint_adj") else None,
        "best": None if model.tracker is None else model.tracker.best_epoch,
    }


def session(conf: dict) -> dict:
    """``QRec(conf).execute()`` on the CPU: the measure lines, the mesh and
    the files the run wrote under its ``-dir``."""
    rec = QRec(ModelConf(conf), seed=3, device="cpu")
    measure = rec.execute()
    out_dir = conf["output.setup"].split("-dir ")[1].strip()
    files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    mesh = rec.model.mesh
    return {"measure": measure, "files": files, "U": rec.model.U.numpy(),
            "mesh": None if mesh is None else mesh.shape}


def training(rank, cases, sessions):
    """The fit cases, then the sessions, each rank with its own ``-dir``."""
    out = {name: fit_case(case) for name, case in cases.items()}
    for name, conf in sessions.items():
        conf = dict(conf, **{"output.setup": f"on -dir {conf['out_dir']}/{name}/rank{rank}"})
        out[name] = session({k: v for k, v in conf.items() if k != "out_dir"})
    return out


def social(rank, cases, lifecycle_confs):
    """The social and hypergraph fit cases on the mesh that their confs ask
    for; on four ranks also the step's reduction with a gradient that only
    data rank 0 holds (:func:`none_gradients`) and the run's lifecycle
    (:func:`lifecycle`)."""
    out = {"fits": {name: fit_case(case) for name, case in cases.items()}}
    if lifecycle_confs:
        out["none_gradients"] = none_gradients(make_mesh(2))
        out["lifecycle"] = lifecycle(lifecycle_confs)
    return out


def none_gradients(mesh) -> dict:
    """``reduce_gradients`` over a step whose loss reaches ``a`` on every
    rank (scaled by the data index + 1), ``b`` on data rank 0 alone (a
    table's regulariser) and ``c`` on none: every rank's gradients
    after the reduction."""
    a = torch.arange(6.0).view(2, 3).requires_grad_(True)
    b = torch.linspace(-1.0, 1.0, 4).requires_grad_(True)
    c = torch.ones(2, requires_grad=True)
    loss = (a * (mesh.data_index + 1)).sum()
    if mesh.data_index == 0:
        loss = loss + (b**2).sum()
    loss.backward()
    held = (a.grad is not None, b.grad is not None, c.grad is not None)
    reduce_gradients([a, b, c], mesh)
    return {"held": held, "a": a.grad.numpy(), "b": None if b.grad is None else b.grad.numpy(),
            "c": None if c.grad is None else c.grad.numpy()}


def lifecycle(confs) -> dict:
    """Each conf through ``QRec(conf).execute()`` in order (their
    checkpoint directories, saved models and result directories shared by
    every rank): the measures, final factors, losses, buffers and the step
    it resumed from, with the checkpoint steps and the ``np.savez`` calls
    that THIS rank made."""
    steps, savez = [], []
    real_save, real_savez = C.Checkpointer.save, np.savez

    def save(self, step, state):
        steps.append((self.directory, step))
        return real_save(self, step, state)

    def spy_savez(path, *a, **k):
        savez.append(str(path))
        return real_savez(path, *a, **k)

    C.Checkpointer.save, np.savez = save, spy_savez
    out = {}
    try:
        for name, conf in confs.items():
            rec = QRec(ModelConf(conf), seed=3, device="cpu")
            measure = rec.execute()
            model = rec.model
            out[name] = {
                "measure": measure, "U": model.U.numpy(), "V": model.V.numpy(),
                "losses": list(getattr(model, "epoch_losses", [])),
                "buffers": {n: b.numpy().copy() for n, b in model.named_buffers()},
                "resumed": getattr(model, "resumed_step", None),
                "mesh": None if model.mesh is None else model.mesh.shape,
            }
    finally:
        C.Checkpointer.save, np.savez = real_save, real_savez
    out["steps"], out["savez"] = steps, savez
    return out


def replicated_run(conf: dict, init=None) -> dict:
    """``QRec(conf).execute()`` on the CPU (a model that trains whole on
    every rank, slice 7d, or a data-parallel one), ``init`` (npz-style arrays by table name)
    replacing those of its ALS ``init_tables``: the measure lines and the
    files under its ``-dir``; everything the model scores or predicts from
    (its parameters and buffers, its ALS tables, ``U``, ``V`` and
    IRGAN's item bias; a rating run's prediction of every test rating),
    its losses; each ranking's gathered (ids, scores) and the users of
    every K2 call that this process made (through its plain twin here)."""
    calls, ranked = [], []
    kernel, real_topk = topk.masked_catalog_topk, topk.CatalogRanker.topk

    def counted(user_emb, items, bitmask, uids, *a, **k):
        calls.append(uids.numpy().copy())
        return kernel(user_emb, items, bitmask, uids, *a, **k)

    def recorded(ranker, form):
        out = real_topk(ranker, form)
        ranked.append(out)
        return out

    cls = get_model(conf["model.name"])
    real_init = getattr(cls, "init_tables", None)

    def injected(model):
        tables = real_init(model)
        tables.update({k: torch.from_numpy(v.copy()) for k, v in init.items()})
        return tables

    topk.masked_catalog_topk, topk.CatalogRanker.topk = counted, recorded
    if init is not None:
        cls.init_tables = injected
    try:
        rec = QRec(ModelConf(conf), seed=3, device="cpu")
        measure = rec.execute()
    finally:
        topk.masked_catalog_topk, topk.CatalogRanker.topk = kernel, real_topk
        if init is not None:
            cls.init_tables = real_init
    model = rec.model
    out_dir = conf["output.setup"].split("-dir ")[1].strip()
    host = lambda t: None if t is None else t.detach().numpy().copy()  # noqa: E731
    users = [e[0] for e in model.data.test_data]
    items = [e[1] for e in model.data.test_data]
    return {
        "measure": measure, "mesh": None if model.mesh is None else model.mesh.shape,
        "files": sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else [],
        "params": {n: host(p) for n, p in model.named_parameters()},
        "buffers": {n: host(b) for n, b in model.named_buffers()},
        # the ALS tables by name; IF_BPR's tier tables, the friends' items
        "tables": as_numpy({n: host(t) for n, t in model.tables.items()}
                           if isinstance(getattr(model, "tables", None), dict)
                           else getattr(model, "tables", None)),
        "U": host(model.U), "V": host(model.V), "item_bias": host(getattr(model, "item_bias", None)),
        "predictions": None if model.ranking.isMainOn() else model.predict_ratings(users, items),
        "losses": {k: list(getattr(model, k)) for k in ("epoch_losses", "g_losses",
                                                        "pretrain_losses") if hasattr(model, k)},
        "thresholds": [tuple(host(t) for t in pair) for pair in getattr(model, "thresholds", [])],
        "ranked": [(ids, scores) for ids, scores in ranked], "k2_calls": calls,
    }


def replicated(rank, runs, lifecycle):
    """Each run of ``runs`` (label -> (conf, init)) through
    :func:`replicated_run`, each rank writing under its own ``-dir``; then
    the ``lifecycle`` confs in order (their saved-model paths shared by
    every rank): the measures and factors of each, or the RuntimeError
    that ended it, with the ``np.savez`` calls that THIS rank made."""
    out = {}
    for label, (conf, init) in runs.items():
        conf = dict(conf, **{"output.setup": f"on -dir {conf['out_dir']}/{label}/rank{rank}"})
        out[label] = replicated_run({k: v for k, v in conf.items() if k != "out_dir"}, init)
    savez, real_savez = [], np.savez

    def spy_savez(path, *a, **k):
        savez.append(str(path))
        return real_savez(path, *a, **k)

    np.savez = spy_savez
    try:
        for label, conf in lifecycle.items():
            try:
                rec = QRec(ModelConf(conf), seed=3, device="cpu")
                measure = rec.execute()
                out[label] = {"measure": measure, "U": rec.model.U.numpy().copy(),
                              "V": rec.model.V.numpy().copy()}
            except RuntimeError as e:
                out[label] = {"raised": str(e)}
    finally:
        np.savez = real_savez
    out["savez"] = savez
    return out


def fits_and_runs(rank, cases, runs):
    """The fit cases (:func:`fit_case`) on the mesh that their confs ask
    for, then the session runs of ``runs`` (label -> (conf, None)) through
    :func:`replicated_run`, each rank writing under its own ``-dir``."""
    out = {"fits": {name: fit_case(case) for name, case in cases.items()}}
    out.update(replicated(rank, runs, {}))
    return out


def als_forms(rank, runs):
    """Each ALS run of ``runs`` (label -> conf) through :func:`replicated_run`
    in its captured form (``epoch_graphs`` True, the program run as written
    on the CPU) and its per-step form (False), each rank and form writing
    under its own ``-dir``; keyed (label, form)."""
    out = {}
    for label, conf in runs.items():
        cls = get_model(conf["model.name"])
        for graphs in (True, False):
            run = {k: v for k, v in conf.items() if k != "out_dir"}
            run["output.setup"] = f"on -dir {conf['out_dir']}/{label}-{graphs}/rank{rank}"
            cls.epoch_graphs = graphs
            try:
                out[(label, graphs)] = replicated_run(run)
            finally:
                del cls.epoch_graphs
    return out


def flag_read_fits(rank, cases):
    """Each fit of ``cases`` (label -> (conf, train, test)) twice on the mesh
    its conf asks for: with the summed gradient flags' answers kept a phase
    (``trainer.reached_flags``) and with none kept, the flags read at
    every step where this rank lacks a gradient, as before they were kept;
    keyed (label, kept): the flag reads of each phase (``T.train`` call),
    the losses and the parameters. Then :func:`flag_patterns`."""
    out = {}
    real_train, real_reached = T.train, T.reached_flags
    for label, (conf, train, test) in cases.items():
        for kept in (True, False):
            reads = []

            def counted(*a, **k):
                before = collectives.flag_reads
                try:
                    return real_train(*a, **k)
                finally:
                    reads.append(collectives.flag_reads - before)

            T.train = counted
            if not kept:
                T.reached_flags = lambda optimizer: None
            try:
                mconf = ModelConf(conf)
                model = get_model(conf["model.name"])(mconf, Interactions(mconf, train, test),
                                                      device="cpu")
                losses = model.fit()
            finally:
                T.train, T.reached_flags = real_train, real_reached
            out[(label, kept)] = {"reads": reads, "losses": losses, "params": {
                n: p.detach().numpy().copy() for n, p in model.named_parameters()}}
    out["patterns"] = flag_patterns(make_mesh(1))
    return out


def flag_patterns(mesh) -> list:
    """:func:`reduce_gradients` over five steps with one kept dict of
    answers: every step's loss reaches ``a`` on every rank and ``c`` on
    none; ``b`` on data rank 0 alone at steps 1, 2 and 5 (a table's
    regulariser) and on every rank at steps 3 and 4, so that data rank 1's
    pattern of held gradients changes at step 3 and back at step 5. Each
    step's flag reads on this rank and its gradients after the reduction."""
    a = torch.arange(6.0).view(2, 3).requires_grad_(True)
    b = torch.linspace(-1.0, 1.0, 4).requires_grad_(True)
    c = torch.ones(2, requires_grad=True)
    reached, out = {}, []
    for everywhere in (False, False, True, True, False):
        for p in (a, b, c):
            p.grad = None
        loss = (a * (mesh.data_index + 1)).sum()
        if mesh.data_index == 0 or everywhere:
            loss = loss + (b**2).sum()
        loss.backward()
        before = collectives.flag_reads
        reduce_gradients([a, b, c], mesh, reached)
        out.append({"reads": collectives.flag_reads - before, "a": a.grad.numpy().copy(),
                    "b": None if b.grad is None else b.grad.numpy().copy(),
                    "c": None if c.grad is None else c.grad.numpy().copy()})
    return out
