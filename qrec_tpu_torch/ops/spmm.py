"""Propagation on one device over every form of an adjacency (counterpart
of the JAX package's ``ops/spmm.py``):

* :class:`DenseJoint` — the normalized joint adjacency ``[[0, Ŝ], [Ŝᵀ,
  0]]`` as one (U, ld) table ``r`` with a row and a column scale, ``Ŝ =
  diag(row_scale) · r · diag(col_scale)``, in one of three forms
  (``graph.dense.quant``):

  - ``factored``: r the binary interaction matrix in int8, the scales
    ``deg_u^-1/2`` and ``deg_i^-1/2`` (exact);
  - ``off``: r the bf16 Ŝ itself, unit scales (the JAX package's
    ``_dense_joint_matmul`` and ``_dual_joint_matmul``);
  - ``int8``: the legacy lossy form, r = rint(127 · Ŝ / rowmax), the row
    scale rowmax / 127 and a unit column scale (``_int8_call`` with
    ``si=None``).

  Every application, forward and backward, is one call of the dual
  kernel's scaled entry
  (:func:`~qrec_tpu_torch.ops.kernels.factored_dual_matmul`), which reads
  r once for both products and applies the scales as it loads x and writes
  the result; a unit scale multiplies by 1.0, which changes no bit.
* :class:`SparseJoint` — the whole (U+I) x (U+I) matrix as a row-sorted
  CSR, the counterpart of ``PaddedCOO``; every application runs through the
  segment kernel
  (:func:`~qrec_tpu_torch.ops.kernels.weighted_segment_matmul`), with
  per-edge values that a caller may replace (SGL's views);
  :class:`ShardedSparseJoint` is its row shards on a mesh, the counterpart
  of ``ShardedPaddedCOO``.
* :class:`DeviceCOO` — any row-sorted COO matrix, square or not, symmetric
  or not, in f32: a gather, a multiply by the edge values and a sum per
  row (``graph.backend=coo``, the social models' auxiliary matrices,
  SEPT's augmented graph). The gradient is the transpose's product, in the
  transposed order sorted once at build; the sums run in a fixed order,
  with no atomics, so a product repeats bit for bit.
* :class:`DenseMat` — a small auxiliary matrix stored bf16, times bf16(x)
  with f32 sums and an f32 result.

:func:`spmm` dispatches on the form. SGL's augmented views of the factored
form (``factored_edge_drop_view``, ``factored_node_drop_view``) are
``DenseJoint``s too, with a masked table or renormalized scales, so
:func:`joint_matmul` on a view is the JAX package's
``factored_view_matmul``; views of the other forms are edge values
(:func:`subgraph_vals`) over :func:`view_adjacency`. Their random inputs
come in as tensors that the caller draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.graph import COO, factored_adjacency
from ..parallel.collectives import (
    all_reduce_sum,
    gather_cols,
    gather_rows,
    split_range,
    split_sizes,
)
from .kernels import (
    SegmentSchedule,
    aligned_width,
    bipartite_dual_matmul,
    factored_dual_matmul,
    segment_row_stride,
    segment_schedule,
    weighted_segment_matmul,
)

# entry budget for the dense-bipartite path (same value as the JAX package)
DENSE_JOINT_LIMIT = 600_000_000


def pad_table(r: torch.Tensor) -> torch.Tensor:
    """(U, I) R as the dual kernel reads it: (U, ld) with ld = I rounded up
    to a multiple of 16 and the extra columns zero (``r`` itself when I
    already is one)."""
    u, i = r.shape
    ld = aligned_width(i)
    if ld == i:
        return r
    out = torch.zeros((u, ld), dtype=r.dtype, device=r.device)
    out[:, :i] = r
    return out


class DenseJoint(NamedTuple):
    """Dense joint adjacency on one device in one of the forms of the module
    docstring. ``r`` is stored with its rows padded by zero columns
    (:func:`pad_table`): the item count I is ``col_scale``'s length, and
    zero columns meet zero rows of x, so no result changes."""

    r: torch.Tensor  # (U, ld) int8 (factored, int8) or bf16 (off); columns I..ld zero
    row_scale: torch.Tensor  # (U,) f32
    col_scale: torch.Tensor  # (I,) f32
    form: str = "factored"

    @property
    def num_users(self) -> int:
        return self.r.shape[0]

    @property
    def num_items(self) -> int:
        return self.col_scale.shape[0]

    @property
    def num_rows(self) -> int:
        return self.num_users + self.num_items

    @classmethod
    def from_tables(cls, r, row_scale, col_scale, form: str = "factored") -> "DenseJoint":
        """From an unpadded (U, I) r."""
        return cls(pad_table(r), row_scale, col_scale, form)

    @classmethod
    def from_interactions(cls, data, device, quant: str = "factored") -> "DenseJoint":
        """The form ``quant`` (factored | off | int8) of the binary
        normalized adjacency, as the JAX package's
        ``DenseJoint.from_interactions`` builds it (duplicates count once)."""
        if quant == "factored":
            rb, su, si = factored_adjacency(data)
            as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
            return cls.from_tables(as_t(rb), as_t(su), as_t(si))
        if quant not in ("off", "int8"):
            raise ValueError(f"unknown dense form {quant!r} (expected factored|off|int8)")
        deg_u = np.maximum(np.diff(data.u_indptr), 1).astype(np.float32)
        deg_i = np.maximum(np.diff(data.i_indptr), 1).astype(np.float32)
        u = data.train_u[data.csr_sel]
        i = data.train_i[data.csr_sel]
        r = np.zeros((data.num_users, data.num_items), dtype=np.float32)
        r[u, i] = 1.0 / np.sqrt(deg_u[u]) / np.sqrt(deg_i[i])
        ones_i = torch.ones(data.num_items, dtype=torch.float32, device=device)
        if quant == "off":
            table = torch.from_numpy(r).to(device=device, dtype=torch.bfloat16)
            ones_u = torch.ones(data.num_users, dtype=torch.float32, device=device)
            return cls.from_tables(table, ones_u, ones_i, "off")
        # legacy per-user-row scale: the row max maps to 127
        smax = r.max(axis=1)
        scale = np.where(smax > 0, smax / 127.0, 1.0).astype(np.float32)
        q = np.rint(r / scale[:, None]).astype(np.int8)
        return cls.from_tables(torch.from_numpy(q).to(device), torch.from_numpy(scale).to(device),
                               ones_i, "int8")


def factored_call(adj: DenseJoint, x: torch.Tensor) -> torch.Tensor:
    """``[[0, Ŝ], [Ŝᵀ, 0]] @ x`` for x (U+I, d) f32, as the JAX package's
    ``_int8_call`` (and ``_dual_call`` for the bf16 form): one call of the
    dual kernel's scaled entry."""
    return factored_dual_matmul(adj.r, x.contiguous(), adj.row_scale, adj.col_scale)


class JointMatmul(torch.autograd.Function):
    """``y = M @ x`` with M the symmetric joint adjacency in any dense form.
    The gradient is ``dx = M @ dy``: the backward is the same dual-kernel
    call on the cotangent, never autograd through a transpose of r (the JAX
    package's ``_int8_joint_matmul`` and ``_dual_joint_matmul`` VJPs)."""

    @staticmethod
    def forward(ctx, x, r, row_scale, col_scale):
        adj = DenseJoint(r, row_scale, col_scale)
        ctx.adj = adj
        return factored_call(adj, x)

    @staticmethod
    def backward(ctx, grad):
        return factored_call(ctx.adj, grad), None, None, None


def joint_matmul(adj: DenseJoint, x: torch.Tensor) -> torch.Tensor:
    return JointMatmul.apply(x, adj.r, adj.row_scale, adj.col_scale)


class ShardedDenseJoint(NamedTuple):
    """A dense joint adjacency of :class:`DenseJoint` on a mesh
    (``parallel/mesh.py``), in any of its forms: R cut by **item
    columns** into ``torch.tensor_split``'s blocks over ``data``. Each rank
    keeps only its block ``r[:, col0:col1]``, copied once into a table of
    its own padded to 16 columns (:func:`pad_table`: K1 reads rows whose
    length is a multiple of 16, which a column slice of the whole table is
    not), with the whole row scale and the block's column scale.

    The JAX package has no kernel here: on a mesh its ``DenseJoint`` takes
    XLA's two products, which GSPMD partitions. Cut by columns, the half of
    ``M @ x`` that must be summed over ``data`` is the user half (U x d),
    and dense blocks are the same size whatever the degrees
    (:class:`ShardedJointMatmul`). SGL's factored views of it are
    ``ShardedDenseJoint``s too (``factored_*_view``)."""

    mesh: object
    r: torch.Tensor  # (U, aligned(col1 - col0)) int8 or bf16; padding columns zero
    row_scale: torch.Tensor  # (U,) f32, whole
    col_scale: torch.Tensor  # (col1 - col0,) f32, the block's
    col0: int  # the block's items are [col0, col1)
    col1: int
    num_items: int  # the whole catalog's I
    col_sizes: Tuple[int, ...]  # every data rank's column count, in rank order
    unit: torch.Tensor  # (U,) f32 ones: K1's row scale (row_scale is applied around it)
    form: str = "factored"

    @property
    def num_users(self) -> int:
        return self.r.shape[0]

    @property
    def num_rows(self) -> int:
        return self.num_users + self.num_items

    @classmethod
    def from_joint(cls, adj: DenseJoint, mesh) -> "ShardedDenseJoint":
        """This data rank's block of the whole ``adj``, which the caller
        then drops."""
        sizes = split_sizes(adj.num_items, mesh.data)
        if min(sizes) < 1:
            raise ValueError(f"{adj.num_items} items cannot be cut into {mesh.data} column blocks")
        c0, c1 = split_range(adj.num_items, mesh.data, mesh.data_index)
        block = adj.r[:, c0:c1]
        r = pad_table(block.clone(memory_format=torch.contiguous_format))
        return cls(mesh, r, adj.row_scale, adj.col_scale[c0:c1].clone(), c0, c1,
                   adj.num_items, tuple(sizes), torch.ones_like(adj.row_scale), adj.form)


def _block_dual_call(adj: ShardedDenseJoint, x: torch.Tensor) -> torch.Tensor:
    """K1 on the block with ``x``'s user rows and the block's item rows:
    (U + col1 - col0, d) f32, the block's partial of the user half before
    its row scale, ``r_b @ bf16(si_b · x_i,b)``, and its whole rows of the
    item half ``Ŝᵀ x_u``. The row scale multiplies x_u here (K1 then
    multiplies by 1.0, which changes no bit, before its bf16 cast) and the
    summed user half after the sum (:class:`ShardedJointMatmul`), so that
    the partials are summed as one process's K1 sums its column regions
    and scaled once. K1's partials live in a scratch buffer per device and
    stream (``ops/kernels._scratch``); ranks that share one card are
    separate processes, each with its own."""
    u = adj.num_users
    xb = torch.cat([x[:u] * adj.row_scale[:, None], x[u + adj.col0: u + adj.col1]])
    return factored_dual_matmul(adj.r, xb, adj.unit, adj.col_scale)


class ShardedJointMatmul(torch.autograd.Function):
    """``y = M @ x`` over a :class:`ShardedDenseJoint`, x and y whole on
    every rank; every call of either direction is one K1 launch on the
    rank's block (:func:`_block_dual_call`), on x's feature slice over
    ``model`` where the width divides (:func:`feature_slice`), the columns
    gathered over ``model`` before either collective over ``data``.

    Forward: the user half of K1's output is this block's partial of ``r
    @ bf16(si · x_i)``; it is summed over ``data`` (every rank receives the
    same bits) and then scaled by the row scale. The item half holds the
    block's rows of ``Ŝᵀ x_u``, whole, gathered over ``data`` with the
    blocks' column counts. The all-reduce sums the partials in another
    order than one process's K1 sums its column regions: where an f32 sum
    rounds, the user half parts by an ulp, which the next layer's bf16 cast
    can turn into one bf16 step of an element (a sum of bf16 values times
    0/1 is mostly exact in f32).

    Backward, under the gradient invariant of ``parallel/mesh.py``: the
    rank's feature columns of the cotangent are summed over ``data`` in
    f32 first (K1 rounds its input to bf16, and shares rounded apart would
    part from one process); K1 on the block (``dx = M g``: M is
    symmetric) gives this block's partial of ``dx_u``, which fills
    ``dx[:U]`` scaled by the row scale, and its whole rows of ``dx_i``,
    which fill ``dx[U + col0 : U + col1]``; every other row is zero, and
    the step's one reduction over ``data`` completes the sum. No other
    collective touches dx, so the user rows' shares are scaled before they
    are summed: f32 rounding again."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        mesh, u = adj.mesh, adj.num_users
        cut = feature_slice(mesh, x.shape[1])
        out = _block_dual_call(adj, x if cut is None else x[:, cut[0]: cut[1]])
        if cut is not None:
            out = gather_cols(out, mesh)
        ou = all_reduce_sum(out[:u].contiguous(), mesh.data_group) * adj.row_scale[:, None]
        return torch.cat([ou, gather_rows(out[u:], mesh, adj.col_sizes)])

    @staticmethod
    def backward(ctx, grad):
        adj = ctx.adj
        mesh, u = adj.mesh, adj.num_users
        cut = feature_slice(mesh, grad.shape[1])
        g = grad if cut is None else grad[:, cut[0]: cut[1]]
        g = all_reduce_sum(g.clone(memory_format=torch.contiguous_format), mesh.data_group)
        out = _block_dual_call(adj, g)
        if cut is not None:
            out = gather_cols(out, mesh)
        dx = torch.zeros_like(grad)
        dx[:u] = out[:u] * adj.row_scale[:, None]
        dx[u + adj.col0: u + adj.col1] = out[u:]
        return dx, None


class SparseJoint(NamedTuple):
    """Symmetric joint adjacency as a row-sorted CSR on one device: the
    port's counterpart of the JAX package's ``PaddedCOO``
    (``ops/spmm.py:555-659``).

    ``PaddedCOO`` groups edges by 512-row output block and pads every block
    to whole 2048-edge tiles for the TPU's one-hot matrix product, with a
    ``perm`` that moves per-edge values into that layout. The segment kernel
    reads the CSR as it is (``indptr``, ``cols``, ``vals`` in the COO's
    lexsorted order), so there is no padding and no ``perm``: the values of
    a view arrive in that same order from ``joint_bipartite_coo``. The
    symmetry is what lets the backward be the same kernel on the cotangent
    (:class:`SegmentMatmul`)."""

    indptr: torch.Tensor  # (N+1,) int32
    cols: torch.Tensor  # (E,) int32
    vals: torch.Tensor  # (E,) f32
    schedule: SegmentSchedule  # the kernel's tiles of edges and their scratch

    @property
    def num_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def rows(self) -> torch.Tensor:
        """(E,) int32, the row of every edge (the schedule holds it)."""
        return self.schedule.edge_row

    @classmethod
    def from_host(cls, coo: COO, device, check_symmetric: bool = True) -> "SparseJoint":
        rows = np.asarray(coo.rows)
        cols = np.asarray(coo.cols)
        vals = np.asarray(coo.vals, dtype=np.float32)
        n_rows, n_cols = int(coo.shape[0]), int(coo.shape[1])
        assert n_rows == n_cols, "SparseJoint requires a square (symmetric) matrix"
        # the CSR below assumes row-sorted edges; O(E) host check once per graph
        assert np.all(np.diff(rows) >= 0), "SparseJoint requires row-sorted edges"
        if check_symmetric:
            m = coo.to_scipy()
            if (m != m.T).nnz:
                raise ValueError("SparseJoint requires a symmetric matrix")
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
        as_int32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)  # noqa: E731
        return cls(
            as_int32(indptr),
            as_int32(cols),
            torch.as_tensor(vals, device=device),
            segment_schedule(indptr, device=device),
        )


def segment_operand(x: torch.Tensor) -> torch.Tensor:
    """x cast to bf16 as the segment kernel reads it: rows padded to
    :func:`segment_row_stride` (16 bytes), so it gathers 16 bytes a lane at
    every width (d=50 included); the padding never reaches a result."""
    n, d = x.shape
    ld = segment_row_stride(d)
    if ld == d:
        return x.to(torch.bfloat16).contiguous()
    xb = torch.empty((n, ld), dtype=torch.bfloat16, device=x.device)[:, :d]
    return xb.copy_(x)


def _segment_call(adj: SparseJoint, x: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``A @ x`` on bf16 x, as the JAX package's ``_padded_spmm_fwd_impl``."""
    return weighted_segment_matmul(segment_operand(x), adj.indptr, adj.cols, vals, adj.schedule)


class SegmentMatmul(torch.autograd.Function):
    """``y = A @ x`` for the symmetric sparse joint adjacency with edge
    values ``vals`` (the ``_padded_spmm`` custom VJP,
    ``ops/spmm.py:662-702``): one segment-kernel launch forward, and
    ``dx = Aᵀ @ dy = A @ dy`` as one more launch on the bf16-cast
    cotangent. ``dvals[e] = Σ_d dy[row_e] · x[col_e]`` (f32 x, as the JAX
    package's) is plain PyTorch, computed only when ``vals`` needs a
    gradient."""

    @staticmethod
    def forward(ctx, x, vals, adj):
        ctx.adj = adj
        ctx.save_for_backward(x, vals)
        return _segment_call(adj, x, vals)

    @staticmethod
    def backward(ctx, grad):
        x, vals = ctx.saved_tensors
        adj = ctx.adj
        dx = _segment_call(adj, grad, vals) if ctx.needs_input_grad[0] else None
        dvals = None
        if ctx.needs_input_grad[1]:
            dvals = (grad[adj.rows] * x[adj.cols]).sum(dim=1)
        return dx, dvals, None


class ShardedSparseJoint(NamedTuple):
    """The symmetric joint adjacency of :class:`SparseJoint` on a mesh
    (``parallel/mesh.py``), the port's counterpart of the JAX package's
    ``ShardedPaddedCOO`` (``ops/spmm.py:710-928``). The rows are cut in
    even blocks over ``data`` (``torch.tensor_split``'s cut; the JAX
    package's blocks of ceil(N / shards) rows are rounded up to its 512-row
    tile, a TPU layout). Each rank keeps the CSR of its block: ``indptr``
    rebased to the block's first edge, the block's ``cols``, global, so
    that K5 computes the block's rows of ``A @ x`` from the whole x
    (:class:`ShardedSegmentMatmul`), and the block's own segment schedule.
    ``vals`` holds every edge's value, in the CSR's order, as
    :func:`spmm` takes per-edge values; the block's edges are ``[edge0,
    edge1)``."""

    mesh: object
    num_rows: int
    row0: int  # the block's rows are [row0, row1)
    row1: int
    edge0: int
    edge1: int
    indptr: torch.Tensor  # (row1 - row0 + 1,) int32, from 0
    cols: torch.Tensor  # (edge1 - edge0,) int32, global columns
    vals: torch.Tensor  # (E,) f32, every edge
    schedule: SegmentSchedule  # the block's tiles
    row_sizes: Tuple[int, ...]  # every data rank's row count, in rank order

    @classmethod
    def from_host(cls, coo: COO, device, mesh) -> "ShardedSparseJoint":
        rows = np.asarray(coo.rows)
        n_rows = int(coo.shape[0])
        assert n_rows == int(coo.shape[1]), "ShardedSparseJoint requires a square matrix"
        assert np.all(np.diff(rows) >= 0), "ShardedSparseJoint requires row-sorted edges"
        if n_rows < mesh.data:
            raise ValueError(f"{n_rows} rows cannot be cut into {mesh.data} row blocks")
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
        sizes = split_sizes(n_rows, mesh.data)
        r0 = sum(sizes[: mesh.data_index])
        r1 = r0 + sizes[mesh.data_index]
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        local = indptr[r0: r1 + 1] - e0
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a).astype(dt), device=device)  # noqa: E731
        return cls(
            mesh, n_rows, r0, r1, e0, e1, as_t(local, np.int32),
            as_t(np.asarray(coo.cols)[e0:e1], np.int32), as_t(coo.vals, np.float32),
            segment_schedule(local, device=device), tuple(sizes),
        )


def feature_slice(mesh, d: int) -> Optional[Tuple[int, int]]:
    """[c0, c1) of this rank's feature columns over ``model`` when the model
    axis divides the width d (``qrec_tpu/ops/spmm.py:866-873``), else None:
    every model rank then computes the whole width."""
    if mesh.model == 1 or d % mesh.model:
        return None
    c0 = mesh.model_index * (d // mesh.model)
    return c0, c0 + d // mesh.model


def _block_call(adj: ShardedSparseJoint, x: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """The block's rows of ``A @ x`` on bf16 x: one K5 launch on the block's
    CSR, gathering from every row of x."""
    return weighted_segment_matmul(segment_operand(x), adj.indptr, adj.cols,
                                   vals[adj.edge0: adj.edge1], adj.schedule,
                                   rows=adj.row1 - adj.row0)


class ShardedSegmentMatmul(torch.autograd.Function):
    """``y = A @ x`` over a :class:`ShardedSparseJoint` (the JAX package's
    ``_sharded_spmm`` custom VJP), x and y whole on every rank.

    Forward: K5 computes this data rank's row block from the whole x, or
    from x's feature slice over ``model`` (:func:`feature_slice`); the
    result is gathered over ``model`` (columns), then over ``data``
    (rows).

    Backward, under the gradient invariant of ``parallel/mesh.py``: the
    cotangent is a share on each data rank. The rank's feature columns of
    it are summed over ``data`` first, in f32, since K5 rounds its input to
    bf16 and shares rounded apart would part from one process; K5 applies
    the block's rows to the sum (``dx = Aᵀ g = A g``: A is symmetric), the
    columns are gathered over ``model``, and the result fills the rank's
    rows of a zero dx, whose sum over ``data`` the step's reduction
    completes (adding zeros is exact). ``dvals``, where ``vals`` needs a
    gradient, follows the same rule: the block's edges, zero elsewhere."""

    @staticmethod
    def forward(ctx, x, vals, adj):
        mesh = adj.mesh
        ctx.adj = adj
        ctx.save_for_backward(x, vals)
        cut = feature_slice(mesh, x.shape[1])
        y = _block_call(adj, x if cut is None else x[:, cut[0]: cut[1]], vals)
        if cut is not None:
            y = gather_cols(y, mesh)
        return gather_rows(y, mesh, adj.row_sizes)

    @staticmethod
    def backward(ctx, grad):
        x, vals = ctx.saved_tensors
        adj = ctx.adj
        mesh = adj.mesh
        cut = feature_slice(mesh, grad.shape[1])
        g = grad if cut is None else grad[:, cut[0]: cut[1]]
        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce_sum(g, mesh.data_group)
        dx = dvals = None
        if ctx.needs_input_grad[0]:
            block = _block_call(adj, g, vals)
            dx = torch.zeros_like(x)
            dx[adj.row0: adj.row1] = block if cut is None else gather_cols(block, mesh)
        if ctx.needs_input_grad[1]:
            if cut is not None:
                g = gather_cols(g, mesh)
            e0, e1 = adj.edge0, adj.edge1
            dvals = torch.zeros_like(vals)
            dvals[e0:e1] = (g[adj.schedule.edge_row.long() + adj.row0]
                            * x[adj.cols.long()]).sum(dim=1)
        return dx, dvals, None


class DeviceCOO(NamedTuple):
    """A (num_rows, num_cols) matrix as a row-sorted COO with f32 values
    (the JAX package's ``DeviceCOO``, ``ops/spmm.py:25-41``), kept as a CSR
    (``indptr``) and as the CSR of its transpose: ``t_perm`` sorts the
    edges by (column, row), ``t_indptr`` starts each column's run and
    ``t_cols`` holds the rows in that order. (cuSPARSE's CSR product does
    not repeat bit for bit on an H100, so the sums are torch's segment
    reduction.)"""

    rows: torch.Tensor  # (E,) int32, sorted
    cols: torch.Tensor  # (E,) int32
    vals: torch.Tensor  # (E,) f32
    num_rows: int
    num_cols: int
    indptr: torch.Tensor  # (num_rows + 1,) int64
    t_perm: torch.Tensor  # (E,) int64
    t_indptr: torch.Tensor  # (num_cols + 1,) int64
    t_cols: torch.Tensor  # (E,) int32, rows[t_perm]

    @classmethod
    def from_host(cls, coo: COO, device) -> "DeviceCOO":
        rows = np.asarray(coo.rows, dtype=np.int32)
        cols = np.asarray(coo.cols, dtype=np.int32)
        n_rows, n_cols = int(coo.shape[0]), int(coo.shape[1])
        assert np.all(np.diff(rows) >= 0), "DeviceCOO requires row-sorted edges"
        t_perm = np.lexsort((rows, cols))

        def indptr(ids, n):
            out = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(np.bincount(ids, minlength=n), out=out[1:])
            return out

        as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return cls(
            as_t(rows), as_t(cols), as_t(np.asarray(coo.vals, dtype=np.float32)), n_rows, n_cols,
            as_t(indptr(rows, n_rows)), as_t(t_perm), as_t(indptr(cols, n_cols)),
            as_t(rows[t_perm]),
        )

    @classmethod
    def from_scipy(cls, m, device) -> "DeviceCOO":
        return cls.from_host(COO.from_scipy(m), device)


def segment_sum(data: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Rows of ``data`` summed in the runs that ``indptr`` starts (an empty
    run gives a zero row), each run from its first row to its last: a
    fixed order with no atomics, so a sum repeats bit for bit. ``unsafe``
    skips the check that would copy the run lengths to the host."""
    return torch.segment_reduce(data, "sum", offsets=indptr, axis=0, unsafe=True)


def coo_matmul(adj: DeviceCOO, x: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in f32 as the JAX package computes it: ``segment_sum(x[cols]
    * vals)`` over the sorted rows."""
    return segment_sum(x[adj.cols] * vals[:, None], adj.indptr)


def coo_matmul_t(adj: DeviceCOO, g: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``Aᵀ @ g`` over the transposed order, in f32."""
    p = adj.t_perm
    return segment_sum(g[adj.t_cols] * vals[p][:, None], adj.t_indptr)


class CooMatmul(torch.autograd.Function):
    """``y = A @ x`` for a :class:`DeviceCOO` with edge values ``vals``.
    ``dx = Aᵀ @ dy`` runs over the transposed CSR (A need not be symmetric:
    SEPT's augmented graph is not); ``dvals[e] = dy[row_e] · x[col_e]``,
    computed only when ``vals`` needs a gradient."""

    @staticmethod
    def forward(ctx, x, vals, adj):
        ctx.adj = adj
        ctx.save_for_backward(x, vals)
        return coo_matmul(adj, x.contiguous(), vals)

    @staticmethod
    def backward(ctx, grad):
        x, vals = ctx.saved_tensors
        adj = ctx.adj
        dx = dvals = None
        if ctx.needs_input_grad[0]:
            dx = coo_matmul_t(adj, grad.contiguous(), vals)
        if ctx.needs_input_grad[1]:
            dvals = (grad[adj.rows] * x[adj.cols]).sum(dim=1)
        return dx, dvals, None


class DenseMat(NamedTuple):
    """A small auxiliary matrix stored bf16 (the JAX package's ``DenseMat``,
    ``ops/spmm.py:161-181``): ``mat @ bf16(x)`` with f32 sums and an f32
    result. On a ``mesh`` every rank holds it whole and computes the whole
    product; its backward keeps the gradient invariant (:class:`DenseMatmul`)."""

    mat: torch.Tensor  # (m, n) bf16
    mesh: object = None

    @property
    def num_rows(self) -> int:
        return self.mat.shape[0]

    @classmethod
    def from_scipy(cls, m, device, mesh=None) -> "DenseMat":
        return cls(torch.from_numpy(m.toarray().astype(np.float32)).to(device=device,
                                                                      dtype=torch.bfloat16), mesh)


def _bf16_product(mat: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """``mat @ xb`` for bf16 operands with f32 sums and an f32 result: one
    cuBLAS bf16 product with an f32 output on the card; on the CPU (whose
    bf16 product rounds its result to bf16) an f32 product of the exact
    values."""
    if mat.device.type == "cuda":
        return torch.mm(mat, xb, out_dtype=torch.float32)
    return mat.float() @ xb.float()


class DenseMatmul(torch.autograd.Function):
    """``y = mat @ bf16(x)``. The gradient reaches x through the bf16 cast
    as JAX's autodiff of the dot takes it: ``dx = bf16(matᵀ @ dy)`` in f32,
    returned as f32.

    On a ``mesh`` the cotangent is a share on each data rank (the gradient
    invariant of ``parallel/mesh.py``). Rounded apart, shares whose sum
    is 0 would leave a nonzero gradient, which Adam's first step turns into
    a move of the whole rate; so the shares are summed over ``data`` in f32
    first, data rank 0 returns the one rounding of the whole product and
    the others zeros, which the step's reduction completes."""

    @staticmethod
    def forward(ctx, x, mat, mesh=None):
        ctx.save_for_backward(mat)
        ctx.mesh = mesh
        return _bf16_product(mat, x.to(torch.bfloat16))

    @staticmethod
    def backward(ctx, grad):
        (mat,) = ctx.saved_tensors
        mesh = ctx.mesh
        if mesh is not None:
            grad = all_reduce_sum(grad.clone(memory_format=torch.contiguous_format),
                                  mesh.data_group)
            if mesh.data_index != 0:
                return torch.zeros((mat.shape[1], grad.shape[1]), dtype=grad.dtype,
                                   device=grad.device), None, None
        return (mat.T.float() @ grad).to(torch.bfloat16).float(), None, None


def spmm(adj, x: torch.Tensor, vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``A @ x`` for every form (the JAX package's ``spmm``,
    ``ops/spmm.py:419-457``): a :class:`DenseJoint` through the dual
    kernel (its item-column blocks on a mesh, :class:`ShardedDenseJoint`),
    a :class:`SparseJoint` through the segment kernel (its row blocks on a
    mesh, :class:`ShardedSparseJoint`), a
    :class:`DeviceCOO` or :class:`DenseMat` through torch ops. ``vals``
    replaces the stored edge values (views) and needs a sparse form."""
    if isinstance(adj, (DenseJoint, ShardedDenseJoint, DenseMat)):
        if vals is not None:
            raise ValueError("per-edge values need a sparse adjacency")
        if isinstance(adj, DenseMat):
            return DenseMatmul.apply(x, adj.mat, adj.mesh)
        if isinstance(adj, ShardedDenseJoint):
            return ShardedJointMatmul.apply(x, adj)
        return joint_matmul(adj, x)
    v = adj.vals if vals is None else vals
    if isinstance(adj, DeviceCOO):
        return CooMatmul.apply(x, v, adj)
    if isinstance(adj, ShardedSparseJoint):
        return ShardedSegmentMatmul.apply(x, v, adj)
    return SegmentMatmul.apply(x, v, adj)


def lightgcn_propagate(
    adj, embeddings: torch.Tensor, num_layers: int, vals: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K-layer linear propagation ``E ← ÂE`` with layer-mean readout
    (model/ranking/LightGCN.py:17-33)."""
    acc = embeddings
    e = embeddings
    for _ in range(num_layers):
        e = spmm(adj, e, vals)
        acc = acc + e
    return acc / (num_layers + 1)


def renormalize_vals(
    rows: torch.Tensor, cols: torch.Tensor, keep: torch.Tensor, num_nodes: int
) -> torch.Tensor:
    """Symmetric normalization ``D^-1/2 A D^-1/2`` of a kept subgraph, on
    the device (the JAX package's ``renormalize_vals``): degrees are sums of
    the 0/1 keep flags, exact in any order, so ``index_add_``'s atomics on
    the card cannot change them."""
    deg = torch.zeros(num_nodes, dtype=keep.dtype, device=keep.device).index_add_(0, rows, keep)
    d_inv = _renormalize(deg)
    return keep * d_inv[rows] * d_inv[cols]


def subgraph_vals(
    rows: torch.Tensor,
    cols: torch.Tensor,
    edge_ids: torch.Tensor,
    num_nodes: int,
    aug_type: int,
    keep,
) -> torch.Tensor:
    """Renormalized edge values of an augmented-view subgraph (SGL.py:113-141;
    the JAX package's ``subgraph_vals``). ``keep`` holds the draws: for aug
    type 0 (node dropout) the bool ``(keep_u (U,), keep_i (I,))``, an edge
    kept when both its ends are; for aug types 1 and 2 (edge dropout) one
    bool flag per interaction, read through ``edge_ids`` so that both
    directions of an edge go together. Type 2 calls this once per layer."""
    if aug_type == 0:
        keep_node = torch.cat(keep)
        kept = keep_node[rows] & keep_node[cols]
    else:
        kept = keep[edge_ids]
    return renormalize_vals(rows, cols, kept.float(), num_nodes)


def view_adjacency(rows, cols, n_nodes: int, device, backend: str = "auto", mesh=None):
    """Adjacency of per-edge-value views (SGL's and BUIR's dropout
    subgraphs): the structure is fixed and the values change every step, so
    the stored values are placeholders and callers pass ``vals`` to
    :func:`spmm`. The JAX package's ``view_adjacency``
    (``ops/spmm.py:931-978``): a :class:`DeviceCOO` under
    ``graph.backend=coo``, whole on every rank of a ``mesh`` too; else the
    segment kernel's :class:`SparseJoint` (the JAX package's ``PaddedCOO``;
    its ``VIEW_PALLAS_MIN_EDGES`` rule is a TPU choice that the port does
    not take), or on a ``mesh`` its row blocks, :class:`ShardedSparseJoint`
    (the JAX package's mesh branch, ``ShardedPaddedCOO``), which takes
    every edge's value on every rank. ``rows``/``cols`` describe a
    symmetric structure in lexsorted order, as ``joint_bipartite_coo``
    returns it."""
    ones = np.ones(len(rows), dtype=np.float32)
    coo = COO(np.asarray(rows, np.int32), np.asarray(cols, np.int32), ones, (n_nodes, n_nodes))
    if backend == "coo":
        return DeviceCOO.from_host(coo, device)
    if mesh is not None:
        return ShardedSparseJoint.from_host(coo, device, mesh)
    return SparseJoint.from_host(coo, device, check_symmetric=False)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, in 16-bit halves of ``c`` so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def pair_hash_keep(ru: torch.Tensor, ci: torch.Tensor, drop_rate: float) -> torch.Tensor:
    """Bernoulli(1-p) keep flags from a position-independent pair hash:
    murmur3's finalizer on the wraparound sum of two per-axis uint32 draws
    (the JAX package's ``_pair_hash_keep``, ``ops/spmm.py:345-361``).
    ``ru`` and ``ci`` are int64 tensors holding uint32 values that
    broadcast against each other; the uint32 arithmetic is done in int64
    and masked to 32 bits after each step."""
    x = (ru + ci) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= min(2**32 - 1, int(drop_rate * 2**32))


def _renormalize(deg: torch.Tensor) -> torch.Tensor:
    """deg^-1/2 where deg > 0, else 0."""
    return torch.where(deg > 0, torch.rsqrt(torch.clamp_min(deg, 1e-12)), torch.zeros_like(deg))


def factored_edge_drop_view(adj, edges: Tuple[torch.Tensor, torch.Tensor], ru: torch.Tensor,
                            ci: torch.Tensor, drop_rate: float):
    """Edge-dropout view (SGL.py:128-141, aug types 1/2): ``R · keep(ru, ci)``
    in R's padded layout, one int8 table, renormalized by the kept degrees,
    which are exact f32 row and column sums of it. ``edges`` holds the
    (rows, cols) of R's nonzeros; the hash is evaluated there only, since
    the product is 0 elsewhere whatever the hash says (the padding's
    columns among them).

    On a :class:`ShardedDenseJoint` ``edges`` are the block's nonzeros,
    their columns local: the hash reads ``ci`` at the global item ``col0 +
    col`` (``ci`` is drawn for every item, the same on every rank). A
    block's item degrees are whole; the user degrees are integer counts
    summed over ``data``, exact. So the view's scales equal one process's
    bit for bit."""
    rows, cols = edges
    sharded = isinstance(adj, ShardedDenseJoint)
    keep = pair_hash_keep(ru[rows], ci[cols + adj.col0 if sharded else cols], drop_rate)
    r = torch.zeros_like(adj.r)
    r[rows, cols] = keep.to(torch.int8)
    deg_u = r.sum(dim=1, dtype=torch.float32)
    if sharded:
        deg_u = all_reduce_sum(deg_u, adj.mesh.data_group)
    deg_i = r[:, : adj.col_scale.shape[0]].sum(dim=0, dtype=torch.float32)
    return adj._replace(r=r, row_scale=_renormalize(deg_u), col_scale=_renormalize(deg_i))


def factored_node_drop_view(adj, keep_u: torch.Tensor, keep_i: torch.Tensor):
    """Node-dropout view (SGL.py:113-126, aug type 0): R stays unmasked; a
    dropped node's scale is 0, which removes its edges. The kept degrees
    are the binary matvecs ``R @ keep_i`` and ``Rᵀ @ keep_u`` (one dual
    product at width 1 over the padded R, with zero keeps for the padding's
    columns; exact: 0/1 operands, f32 sums), masked by the node's own keep
    flag. On a :class:`ShardedDenseJoint` the product runs on the block
    with its items' keeps: ``Rᵀ keep_u`` is the block's whole, ``R keep_i``
    a partial that is summed over ``data`` (integer counts, exact)."""
    ni = adj.col_scale.shape[0]
    sharded = isinstance(adj, ShardedDenseJoint)
    ki_block = keep_i[adj.col0: adj.col1] if sharded else keep_i
    ku = keep_u.to(torch.bfloat16)[:, None].contiguous()
    ki = torch.zeros((adj.r.shape[1], 1), dtype=torch.bfloat16, device=keep_i.device)
    ki[:ni, 0] = ki_block.to(torch.bfloat16)
    deg_u, deg_i = bipartite_dual_matmul(adj.r, ku, ki)
    deg_u = deg_u[:, 0]
    if sharded:
        deg_u = all_reduce_sum(deg_u.contiguous(), adj.mesh.data_group)
    return adj._replace(row_scale=_renormalize(deg_u * keep_u),
                        col_scale=_renormalize(deg_i[:ni, 0] * ki_block))
