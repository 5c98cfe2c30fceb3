"""Hand-written CUDA kernels of the port, their plain PyTorch versions, their
launch counters and the build step (counterpart of the JAX package's
``ops/pallas_kernels.py``).

* :func:`bipartite_dual_matmul` — ``(A @ xi, Aᵀ @ xu)`` in one pass over A
  (``csrc/dual_matmul.cu``; replaces ``_dual_kernel``).
* :func:`masked_catalog_scores` — ``U_block @ Vᵀ`` with rated items set to
  ``mask_value`` from a packed bitmask (``csrc/masked_scores.cu``; replaces
  ``_score_kernel``).
* :func:`infonce_fwd` / :func:`infonce_bwd` — the masked InfoNCE loss over
  normalized views and its two cotangents, never writing the B x B logits
  (``csrc/infonce.cu``; replace ``_infonce_kernel`` and
  ``_infonce_bwd_kernel``).
* :func:`weighted_segment_matmul` — a CSR SpMM with bf16-rounded edge
  values and the gather of x fused (``csrc/segment_matmul.cu``; replaces
  ``_segmm_kernel``).

Dispatch rule: a CPU tensor goes to the plain version; a CUDA tensor goes
to the kernel, which raises if it cannot be built or launched. There is no
fallback from one to the other.

Build: each ``csrc/*.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into a shared library with a plain C
interface under ``build/qrec_tpu_torch/`` at the repository root, named by
the hash of its source (a changed source builds anew), and loads with
``ctypes``. Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "qrec_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Kernel:
    """One kernel of a CUDA source: its C entry point's signature, the
    signatures of the source's int-returning queries it needs (``queries``),
    its loaded library and a plain count of launches on CUDA tensors."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence,
                 queries: Optional[Dict[str, Sequence]] = None):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.queries = dict(queries or {})
        self.launches = 0
        self._lib = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            path = self.library_path()
            if not path.exists():
                build([self])
            lib = ctypes.CDLL(str(path))
            for symbol, argtypes in [(self.symbol, self.argtypes), *self.queries.items()]:
                fn = getattr(lib, symbol)
                fn.argtypes = list(argtypes)
                fn.restype = _I
            self._lib = lib
        return self._lib

    def call(self, *args) -> None:
        """Launch on the current stream; raise on a non-zero CUDA error."""
        err = getattr(self.load(), self.symbol)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
        self.launches += 1


DUAL = Kernel(
    "bipartite_dual_matmul", "dual_matmul.cu", "qrec_dual_matmul",
    [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
)
SCORES = Kernel(
    "masked_catalog_scores", "masked_scores.cu", "qrec_masked_scores",
    [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
)
INFONCE_FWD = Kernel(
    "infonce_fwd", "infonce.cu", "qrec_infonce_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    queries={"qrec_infonce_fwd_scratch": [_I, _I, _I]},
)
INFONCE_BWD = Kernel(
    "infonce_bwd", "infonce.cu", "qrec_infonce_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    queries={"qrec_infonce_bwd_scratch": [_I, _I, _I, _I]},
)
SEGMM = Kernel(
    "weighted_segment_matmul", "segment_matmul.cu", "qrec_segment_matmul",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
)
KERNELS: Tuple[Kernel, ...] = (DUAL, SCORES, INFONCE_FWD, INFONCE_BWD, SEGMM)

_build_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(kernels: Sequence[Kernel] = KERNELS) -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` process per
    source, all started together. Each writes a temporary file that is
    renamed into place, so a concurrent build never loads half a library."""
    with _build_lock:
        # kernels of one source share its library
        todo = {k.library_path(): k for k in kernels if not k.library_path().exists()}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = nvcc_path()
            procs = []
            for out, k in todo.items():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
                procs.append((k, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                )))
            failed = []
            for k, out, tmp, proc in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{k.source.name}:\n{log}")
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return {k.name: k.library_path() for k in kernels}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def _check(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _route(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for tensors that all lie on one such device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {kind!r}: expected cpu or cuda")
    return kind


# ---------------------------------------------------------------------------
# bipartite dual product
# ---------------------------------------------------------------------------

DUAL_MAX_D = 256


def bipartite_dual_matmul_plain(a, xu, xi):
    """Plain version: f32 products of the exact operands. ``a.float()`` and
    bf16 ``x.float()`` are exact, so this equals bf16 products with f32
    accumulation up to summation order (a bf16 matmul on the CPU would round
    its result to bf16)."""
    af = a.float()
    return af @ xi.float(), af.T @ xu.float()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _dual_strip_rows(u: int, chunks: int, slices: int, slots: int, tile: int) -> int:
    # as many row strips as fill the card's resident block slots in one wave
    # (more strips only add oi partials), each a whole number of row tiles
    strips = max(1, min(_cdiv(u, tile), slots // (chunks * slices)))
    return _cdiv(_cdiv(u, strips), tile) * tile


@functools.lru_cache(maxsize=None)
def _dual_geometry(device: torch.device) -> Tuple[int, int, int, int, int]:
    """(chunk, tile, slice, resident block slots, SMs) of the dual kernel on
    ``device``."""
    lib = DUAL.load()
    num_sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = lib.qrec_dual_blocks_per_sm()
    if per_sm <= 0:
        raise RuntimeError("bipartite_dual_matmul: the occupancy query failed")
    return (lib.qrec_dual_chunk(), lib.qrec_dual_tile(), lib.qrec_dual_slice(),
            per_sm * num_sms, num_sms)


def bipartite_dual_matmul(a: torch.Tensor, xu: torch.Tensor, xi: torch.Tensor):
    """``(a @ xi, aᵀ @ xu)`` as f32 ``(U, d)`` and ``(I, d)``.

    ``a``: (U, I) int8 or bf16, row-major; ``xu`` (U, d) and ``xi`` (I, d)
    bf16, any U, I and d <= 256."""
    _check(a, "a", (torch.int8, torch.bfloat16), 2)
    _check(xu, "xu", (torch.bfloat16,), 2)
    _check(xi, "xi", (torch.bfloat16,), 2)
    u, i = a.shape
    d = xu.shape[1]
    if xu.shape[0] != u or xi.shape != (i, d):
        raise ValueError(
            f"shape mismatch: a {tuple(a.shape)}, xu {tuple(xu.shape)}, xi {tuple(xi.shape)}"
        )
    if not 0 < d <= DUAL_MAX_D:
        raise ValueError(f"d={d} outside 1..{DUAL_MAX_D}")
    if _route(a, xu, xi) == "cpu":
        return bipartite_dual_matmul_plain(a, xu, xi)
    chunk, tile, dk, slots, num_sms = _dual_geometry(a.device)
    chunks, slices = _cdiv(i, chunk), _cdiv(d, dk)
    strip_rows = _dual_strip_rows(u, chunks, slices, slots, tile)
    strips = _cdiv(u, strip_rows)
    ou_part = torch.empty((chunks, u, d), dtype=torch.float32, device=a.device)
    oi_part = torch.empty((strips, i, d), dtype=torch.float32, device=a.device)
    ou = torch.empty((u, d), dtype=torch.float32, device=a.device)
    oi = torch.empty((i, d), dtype=torch.float32, device=a.device)
    DUAL.call(
        a.data_ptr(), int(a.dtype == torch.int8), xu.data_ptr(), xi.data_ptr(),
        ou_part.data_ptr(), oi_part.data_ptr(), ou.data_ptr(), oi.data_ptr(),
        u, i, d, strip_rows, num_sms, torch.cuda.current_stream(a.device).cuda_stream,
    )
    return ou, oi


# ---------------------------------------------------------------------------
# masked catalog scorer
# ---------------------------------------------------------------------------


def expand_bitmask(bitmask: torch.Tensor, num_items: int) -> torch.Tensor:
    """(B, words) int32 packed bits -> (B, num_items) bool."""
    words = bitmask.repeat_interleave(32, dim=1)[:, :num_items]
    shifts = torch.arange(num_items, device=bitmask.device, dtype=torch.int32) & 31
    # arithmetic shift on int32 still leaves bit s in position 0
    return ((words >> shifts) & 1).bool()


def masked_catalog_scores_plain(u_block, items, bitmask, mask_value: float = 0.0):
    """Plain version: f32 matmul, then the expanded bits select mask_value."""
    scores = u_block @ items.T
    rated = expand_bitmask(bitmask, items.shape[0])
    return torch.where(rated, torch.full_like(scores, mask_value), scores)


def masked_catalog_scores(
    u_block: torch.Tensor,
    items: torch.Tensor,
    bitmask: torch.Tensor,
    mask_value: float = 0.0,
) -> torch.Tensor:
    """(B, I) f32 scores ``u_block @ itemsᵀ`` with rated items set to
    ``mask_value``. ``u_block`` (B, d) and ``items`` (I, d) f32; ``bitmask``
    (B, ceil(I/32)) int32 holding the packed uint32 bit pattern."""
    _check(u_block, "u_block", (torch.float32,), 2)
    _check(items, "items", (torch.float32,), 2)
    _check(bitmask, "bitmask", (torch.int32,), 2)
    b, d = u_block.shape
    i = items.shape[0]
    words = _cdiv(i, 32)
    if items.shape[1] != d or bitmask.shape != (b, words):
        raise ValueError(
            f"shape mismatch: u_block {tuple(u_block.shape)}, items "
            f"{tuple(items.shape)}, bitmask {tuple(bitmask.shape)}"
        )
    if _route(u_block, items, bitmask) == "cpu":
        return masked_catalog_scores_plain(u_block, items, bitmask, mask_value)
    out = torch.empty((b, i), dtype=torch.float32, device=u_block.device)
    SCORES.call(
        u_block.data_ptr(), items.data_ptr(), bitmask.data_ptr(), out.data_ptr(),
        b, i, d, words, float(mask_value),
        torch.cuda.current_stream(u_block.device).cuda_stream,
    )
    return out


# ---------------------------------------------------------------------------
# masked InfoNCE, forward and backward
# ---------------------------------------------------------------------------

INFONCE_MAX_D = 256
# the finite value of a masked logit, as the JAX package fills it
INFONCE_MASKED = -1e30


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _infonce_logits(v1, v2, cmask, temperature: float, row_offset: int):
    """(masked logits (b_loc, B), diagonal (b_loc, B) bool)."""
    logits = (v1 @ v2.T) / temperature
    logits = torch.where(cmask[None, :] > 0, logits, torch.full_like(logits, INFONCE_MASKED))
    rows = torch.arange(v1.shape[0], device=v1.device)[:, None] + row_offset
    diag = rows == torch.arange(v2.shape[0], device=v1.device)[None, :]
    return logits, diag


def infonce_fwd_plain(v1, v2, cmask, rmask, temperature: float, row_offset: int = 0):
    """Plain version of :func:`infonce_fwd`: the (b_loc, B) logits written
    out, ``pos`` read after masking."""
    logits, diag = _infonce_logits(v1, v2, cmask, temperature, row_offset)
    pos = torch.where(diag, logits, torch.zeros_like(logits)).sum(dim=1)
    lse = torch.logsumexp(logits, dim=1)
    return (rmask * (lse - pos)).sum(), lse


def infonce_bwd_plain(v1, v2, cmask, rmask, lse, temperature: float, row_offset: int = 0):
    """Plain version of :func:`infonce_bwd`: the explicit formula, not
    autograd, on the (b_loc, B) matrices written out."""
    logits, diag = _infonce_logits(v1, v2, cmask, temperature, row_offset)
    p = torch.exp(logits - lse[:, None])
    dlog = rmask[:, None] * (p - diag.float()) / temperature
    return dlog @ v2, dlog.T @ v1


def _check_infonce(v1, v2, cmask, rmask, lse=None) -> Tuple[int, int, int]:
    _check(v1, "v1", (torch.float32,), 2)
    _check(v2, "v2", (torch.float32,), 2)
    _check(cmask, "cmask", (torch.float32,), 1)
    _check(rmask, "rmask", (torch.float32,), 1)
    if lse is not None:
        _check(lse, "lse", (torch.float32,), 1)
    b_loc, d = v1.shape
    b = v2.shape[0]
    if (v2.shape[1] != d or cmask.shape != (b,) or rmask.shape != (b_loc,)
            or (lse is not None and lse.shape != (b_loc,))):
        raise ValueError(
            f"shape mismatch: v1 {tuple(v1.shape)}, v2 {tuple(v2.shape)}, cmask "
            f"{tuple(cmask.shape)}, rmask {tuple(rmask.shape)}"
            + ("" if lse is None else f", lse {tuple(lse.shape)}")
        )
    if b_loc < 1 or b < 1 or not 0 < d <= INFONCE_MAX_D:
        raise ValueError(f"need b_loc >= 1, B >= 1 and 1 <= d <= {INFONCE_MAX_D}; "
                         f"got {b_loc}, {b}, {d}")
    return b_loc, b, d


def infonce_fwd(
    v1: torch.Tensor,
    v2: torch.Tensor,
    cmask: torch.Tensor,
    rmask: torch.Tensor,
    temperature: float,
    row_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)``: the scalar ``Σ_r rmask[r] · (lse[r] − pos[r])`` and the
    per-row logsumexp over the masked logits ``v1 @ v2ᵀ / T``.

    ``v1`` (b_loc, d) and ``v2`` (B, d) f32, already L2-normalized; ``cmask``
    (B,) masks logit columns (a masked column enters as -1e30), ``rmask``
    (b_loc,) rows; the positive of row r is column ``r + row_offset``. Any
    b_loc, B >= 1 and d <= 256."""
    b_loc, b, d = _check_infonce(v1, v2, cmask, rmask)
    if _route(v1, v2, cmask, rmask) == "cpu":
        return infonce_fwd_plain(v1, v2, cmask, rmask, temperature, row_offset)
    num_sms = _num_sms(v1.device)
    scratch = INFONCE_FWD.load().qrec_infonce_fwd_scratch(b_loc, b, num_sms)
    part = torch.empty(scratch, dtype=torch.float32, device=v1.device)
    lse = torch.empty(b_loc, dtype=torch.float32, device=v1.device)
    out = torch.empty((), dtype=torch.float32, device=v1.device)
    INFONCE_FWD.call(
        v1.data_ptr(), v2.data_ptr(), cmask.data_ptr(), rmask.data_ptr(), part.data_ptr(),
        lse.data_ptr(), out.data_ptr(), b_loc, b, d, float(temperature), int(row_offset),
        num_sms, torch.cuda.current_stream(v1.device).cuda_stream,
    )
    return out, lse


def infonce_bwd(
    v1: torch.Tensor,
    v2: torch.Tensor,
    cmask: torch.Tensor,
    rmask: torch.Tensor,
    lse: torch.Tensor,
    temperature: float,
    row_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dv1 (b_loc, d), dv2 (B, d))``: the loss of :func:`infonce_fwd`
    differentiated with respect to the normalized views, from its ``lse``:
    ``dlog = rmask · (softmax − diag) / T``, ``dv1 = dlog @ v2``,
    ``dv2 = dlogᵀ @ v1``."""
    b_loc, b, d = _check_infonce(v1, v2, cmask, rmask, lse)
    if _route(v1, v2, cmask, rmask, lse) == "cpu":
        return infonce_bwd_plain(v1, v2, cmask, rmask, lse, temperature, row_offset)
    num_sms = _num_sms(v1.device)
    scratch = INFONCE_BWD.load().qrec_infonce_bwd_scratch(b_loc, b, d, num_sms)
    part = torch.empty(max(scratch, 1), dtype=torch.float32, device=v1.device)
    out = torch.empty((b_loc + b, d), dtype=torch.float32, device=v1.device)
    INFONCE_BWD.call(
        v1.data_ptr(), v2.data_ptr(), cmask.data_ptr(), rmask.data_ptr(), lse.data_ptr(),
        part.data_ptr(), out.data_ptr(), b_loc, b, d, float(temperature), int(row_offset),
        num_sms, torch.cuda.current_stream(v1.device).cuda_stream,
    )
    return out[:b_loc], out[b_loc:]


# ---------------------------------------------------------------------------
# weighted segment SpMM
# ---------------------------------------------------------------------------

SEGMM_MAX_D = 256
# edges per chunk of a row; the kernel gives one warp to each chunk
SEGMM_CHUNK = 64


class SegmentSchedule(NamedTuple):
    """The split of a CSR matrix's rows into chunks of ``SEGMM_CHUNK`` edges
    that the segment kernel runs one warp each: ``chunk_ptr`` (N+1,) the
    first chunk of every row (an empty row has one empty chunk),
    ``chunk_row`` (T,) the row of every chunk, ``long_rows`` (L,) the rows
    of more than one chunk, whose partial rows a second pass sums; all
    int32."""

    chunk_ptr: torch.Tensor
    chunk_row: torch.Tensor
    long_rows: torch.Tensor


def segment_schedule(indptr, device=None) -> SegmentSchedule:
    """The schedule of a CSR matrix from its row pointers (numpy or a
    tensor), computed on the host once per matrix; its tensors go to
    ``device`` (default: ``indptr``'s)."""
    if isinstance(indptr, torch.Tensor):
        device = indptr.device if device is None else device
        indptr = indptr.cpu().numpy()
    deg = np.diff(np.asarray(indptr, dtype=np.int64))
    chunks = np.maximum(-(-deg // SEGMM_CHUNK), 1)
    chunk_ptr = np.zeros(len(deg) + 1, dtype=np.int64)
    np.cumsum(chunks, out=chunk_ptr[1:])
    as_int32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)  # noqa: E731
    return SegmentSchedule(
        as_int32(chunk_ptr),
        as_int32(np.repeat(np.arange(len(deg)), chunks)),
        as_int32(np.flatnonzero(chunks > 1)),
    )


def weighted_segment_matmul_plain(x, indptr, cols, vals):
    """Plain version with the Pallas kernel's semantics: bf16 x and
    bf16-rounded values, whose f32 products are exact, summed per row in
    f32 by ``index_add_`` (in edge order on the CPU)."""
    n = indptr.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), indptr.diff().long())
    prod = vals.to(torch.bfloat16).float()[:, None] * x.float()[cols.long()]
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    return out.index_add_(0, rows, prod)


def weighted_segment_matmul(
    x: torch.Tensor,
    indptr: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    schedule: Optional[SegmentSchedule] = None,
) -> torch.Tensor:
    """(N, d) f32 ``out[r] = Σ_{e in row r} f32(bf16(vals[e])) · f32(x[cols[e]])``
    over a row-sorted CSR matrix, every row written (an empty one as 0).

    ``x`` (N, d) bf16, any 1 <= d <= 256; ``indptr`` (N+1,) and ``cols``
    (E,) int32; ``vals`` (E,) f32. ``schedule`` is
    :func:`segment_schedule` of ``indptr``, which a caller that applies one
    matrix many times keeps; it is computed here when None."""
    _check(x, "x", (torch.bfloat16,), 2)
    _check(indptr, "indptr", (torch.int32,), 1)
    _check(cols, "cols", (torch.int32,), 1)
    _check(vals, "vals", (torch.float32,), 1)
    n, d = x.shape
    if indptr.shape != (n + 1,) or vals.shape != cols.shape:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, indptr {tuple(indptr.shape)}, "
            f"cols {tuple(cols.shape)}, vals {tuple(vals.shape)}"
        )
    if n < 1 or not 0 < d <= SEGMM_MAX_D:
        raise ValueError(f"need N >= 1 and 1 <= d <= {SEGMM_MAX_D}; got {n}, {d}")
    if _route(x, indptr, cols, vals) == "cpu":
        return weighted_segment_matmul_plain(x, indptr, cols, vals)
    if schedule is None:
        schedule = segment_schedule(indptr)
    _route(x, schedule.chunk_ptr, schedule.chunk_row, schedule.long_rows)
    if schedule.chunk_ptr.shape != (n + 1,):
        raise ValueError(f"schedule of {schedule.chunk_ptr.shape[0] - 1} rows for {n} rows")
    if d % 2 == 0 and x.data_ptr() % 4:
        raise ValueError("x must be 4-byte aligned for an even d (bf16 pair loads)")
    num_chunks = schedule.chunk_row.shape[0]
    num_long = schedule.long_rows.shape[0]
    part = torch.empty((num_chunks if num_long else 1, d), dtype=torch.float32, device=x.device)
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    SEGMM.call(
        x.data_ptr(), indptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
        schedule.chunk_ptr.data_ptr(), schedule.chunk_row.data_ptr(),
        schedule.long_rows.data_ptr(), n, d, num_chunks, num_long, SEGMM_CHUNK,
        part.data_ptr(), out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out
