"""The process mesh of a multi-GPU run (counterpart of the JAX package's
``parallel/mesh.py``), on ``torch.distributed``.

One process per rank. The W ranks form a ``('data', 'model')`` grid, as
the JAX package's ``make_mesh`` arranges its devices: the model axis is 2
when W is even, or ``-model K``, and rank r sits at ``(r // model, r %
model)``. The mesh holds one process group per data row (the ranks that
share a data index: a gather over ``model``) and one per model column (the
ranks that share a model index: a reduction over ``data``).

Placement. Every rank holds whole tables and draws the same batches, from
a generator with the same seed. Nothing is row-sharded: the JAX package
row-shards its ``emb`` tables over ``model`` where the rows divide, which
moves rows and changes no result. What each axis splits:

* ``data``: the rows of a batch in the loss terms that are sums over them,
  the rows of the sparse joint adjacency (``ops/spmm.ShardedSparseJoint``),
  the item columns of a dense one (``ops/spmm.ShardedDenseJoint``) and
  the rows of the contrastive loss (``ops/losses.ShardedInfoNCELoss``);
* ``model``: the propagation's feature columns, where the width divides.

The ranking cuts its test users over all the ranks of the default group
(``ops/topk.CatalogRanker``) and gathers the lists: no gradient.

The gradient invariant. Each data rank's loss is its *share* of the step's
loss: the shares of the ranks of a ``data`` group sum to the one-process
loss, and their gradients to the one-process gradient. Ranks that share a
data index and differ in model index are replicas: they compute the same
share, bit for bit. So one ``all_reduce(SUM)`` of the flattened gradients
over the rank's ``data`` group, between ``loss.backward()`` and
``optimizer.step()`` (``collectives.reduce_gradients``), gives every rank
the one-process gradient, up to the order of f32 sums. Every collective
that carries a gradient keeps the invariant: a sharded backward that needs
the whole cotangent sums the shares over ``data`` first, and writes only
its own rows of the input's gradient, zero elsewhere, so that the step's
reduction completes the sum. A loss that every rank computed whole and
then summed over ``data`` would count W times; a backward that summed a
cotangent that is already whole would too.

When it forms. ``parallel.setup=on [-model K]`` asks for the mesh and
``off`` refuses it. Without the setting a CUDA run forms the default mesh
when its process is one of more than one rank (a launcher's environment
or a group already made), as the JAX package forms its mesh over more than
one TPU device (:func:`mesh_wanted`); a CPU run forms none unasked.

The ranks stay identical to the bit: they draw the same numbers, and every
rank of a group receives the same bits from a collective.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import OptionConf

DATA_AXIS = "data"
MODEL_AXIS = "model"


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(conf=None, device=None) -> bool:
    """Join the default process group once per process; True when the
    process is in one.

    A default group that the caller already made counts. Otherwise the group
    starts when ``QREC_COORDINATOR`` (``host:port``) is set with
    ``QREC_NUM_PROCESSES`` and ``QREC_PROCESS_ID`` (the JAX package's
    triplet, as ``init_method="tcp://host:port"``), or when torchrun's
    ``MASTER_ADDR``, ``WORLD_SIZE`` and ``RANK`` are (``env://``); its
    backend is NCCL for a CUDA ``device`` (the default) and gloo for the
    CPU. On a CUDA device each rank first takes ``cuda:{LOCAL_RANK %
    device_count()}``. ``conf`` is not read, as in the JAX package.
    Launcher sketch, one process per GPU, ``run.conf`` holding
    ``parallel.setup=on`` or not naming it (the mesh then forms by
    itself, :func:`mesh_wanted`)::

        QREC_COORDINATOR=host0:8476 QREC_NUM_PROCESSES=8 QREC_PROCESS_ID=$i \\
        LOCAL_RANK=$i python -m qrec_tpu_torch run.conf
    """
    if dist.is_initialized():
        return True
    dev = torch.device("cuda" if device is None else device)
    coord = os.environ.get("QREC_COORDINATOR")
    if coord:
        kwargs = dict(init_method=f"tcp://{coord}",
                      world_size=int(os.environ["QREC_NUM_PROCESSES"]),
                      rank=int(os.environ["QREC_PROCESS_ID"]))
    elif all(os.environ.get(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
        kwargs = dict(init_method="env://")
    else:
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
    dist.init_process_group(backend=backend_for(dev), **kwargs)
    return True


def mesh_shape(n_ranks: int, model_parallel: Optional[int] = None) -> Dict[str, int]:
    """``{'data': n // model, 'model': model}``: the model axis is 2 when the
    rank count is even, else 1, unless ``model_parallel`` fixes it."""
    if model_parallel is None:
        model_parallel = 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1
    if n_ranks % model_parallel != 0:
        raise ValueError(f"{n_ranks} ranks not divisible by model={model_parallel}")
    return {DATA_AXIS: n_ranks // model_parallel, MODEL_AXIS: model_parallel}


class Mesh:
    """This rank's place on the ('data', 'model') grid and its two groups:
    ``data_group`` holds the ranks of its model column (a reduction over
    ``data``), ``model_group`` those of its data row (a gather over
    ``model``)."""

    def __init__(self, data: int, model: int, rank: int, data_group, model_group):
        self.data = data
        self.model = model
        self.data_index, self.model_index = divmod(rank, model)
        self.data_group = data_group
        self.model_group = model_group

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


# a mesh's groups are made once per default group and model axis:
# ``new_group`` is collective, and a run of several folds asks again
_meshes: Dict[Tuple[object, int], Mesh] = {}


def make_mesh(model_parallel: Optional[int] = None) -> Mesh:
    """The mesh over the default group's ranks. Every rank calls it, in the
    same order: each makes every row and column group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = mesh_shape(world, model_parallel)
    data, model = shape[DATA_AXIS], shape[MODEL_AXIS]
    key = (dist.group.WORLD, model)
    if key not in _meshes:
        rows = [dist.new_group(list(range(d * model, (d + 1) * model))) for d in range(data)]
        cols = [dist.new_group(list(range(m, world, model))) for m in range(model)]
        _meshes[key] = Mesh(data, model, rank, cols[rank % model], rows[rank // model])
    return _meshes[key]


def launcher_world() -> int:
    """The process count that a launcher's environment names: the
    ``QREC_*`` triplet's ``QREC_NUM_PROCESSES`` under ``QREC_COORDINATOR``,
    or torchrun's ``WORLD_SIZE`` beside ``MASTER_ADDR`` and ``RANK``; 1
    when neither does."""
    if os.environ.get("QREC_COORDINATOR"):
        return int(os.environ.get("QREC_NUM_PROCESSES", "1"))
    if all(os.environ.get(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
        return int(os.environ["WORLD_SIZE"])
    return 1


def mesh_wanted(conf, device) -> Tuple[bool, Optional[int]]:
    """(whether the run asks for a mesh, its ``-model K`` or None).
    ``parallel.setup`` decides where it is set. Where it is absent, a CUDA
    process asks for the default mesh when it is one of more than one
    rank: a default group of more than one rank is already made, or a
    launcher's environment names more than one process
    (:func:`launcher_world`), as the JAX package turns its mesh on by
    itself when more than one TPU device is visible
    (``qrec_tpu/models/base.py:378-390``); on the CPU neither builds one
    unasked."""
    if conf.contains("parallel.setup"):
        opts = OptionConf(conf["parallel.setup"])
        return opts.isMainOn(), opts.get_int("-model", 0) or None
    if torch.device(device).type != "cuda":
        return False, None
    world = dist.get_world_size() if dist.is_initialized() else launcher_world()
    return world > 1, None


def mesh_from_config(conf, device) -> Optional[Mesh]:
    """The mesh that the run asks for (:func:`mesh_wanted`; the JAX
    package's ``Recommender.mesh``): None unless it asks for one and the
    process is one of more than one rank, as the JAX package builds none
    on one device. Asking joins the process group first
    (:func:`maybe_initialize_distributed`)."""
    wanted, model_parallel = mesh_wanted(conf, device)
    if not wanted:
        return None
    if not maybe_initialize_distributed(conf, device) or dist.get_world_size() == 1:
        return None
    return make_mesh(model_parallel)


def is_writer() -> bool:
    """Whether this process writes the run's result files: rank 0 of a
    group, or a process in none."""
    return not dist.is_initialized() or dist.get_rank() == 0
