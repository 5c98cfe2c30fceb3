"""Hand-written CUDA kernels of the port, their plain PyTorch versions, their
launch counters and the build step (counterpart of the JAX package's
``ops/pallas_kernels.py``).

* :func:`bipartite_dual_matmul` — ``(A @ xi, Aᵀ @ xu)`` in one pass over A,
  and :func:`factored_dual_matmul`, one application of a dense joint
  adjacency with its scales fused: the factored and legacy int8 forms on
  an int8 table, the bf16 Ŝ with unit scales (``csrc/dual_matmul.cu``;
  replaces ``_dual_kernel``).
* :func:`masked_catalog_scores` — ``U_block @ Vᵀ`` with rated items set to
  ``mask_value`` from a packed bitmask, and :func:`masked_catalog_topk`,
  the best k items of those scores for a batch of users, fused, so the
  (B, I) block is never written, optionally biased first by an item bias,
  a user bias and an offset (a model's score form, :func:`biased_scores`)
  (``csrc/masked_scores.cu``; replace ``_score_kernel`` and the JAX
  ranker's ``lax.top_k``).
* :func:`infonce_fwd` / :func:`infonce_bwd` — the masked InfoNCE loss over
  normalized views and its two cotangents, never writing the B x B logits
  (``csrc/infonce.cu``; replace ``_infonce_kernel`` and
  ``_infonce_bwd_kernel``).
* :func:`weighted_segment_matmul` — a CSR SpMM with bf16-rounded edge
  values and the gather of x fused (``csrc/segment_matmul.cu``; replaces
  ``_segmm_kernel``).

The port's own kernel, with no TPU counterpart (``OWN_KERNELS``):

* :func:`adam_update` — Adam's parameter update with the rounding of
  ``torch.optim.Adam``'s foreach path, its step's scalars read on the
  device, so that a CUDA graph can hold it (``csrc/adam.cu``; the
  optimizer is ``runtime/adam.Adam``).

Dispatch rule: a CPU tensor goes to the plain version; a CUDA tensor goes
to the kernel, which raises if it cannot be built or launched. There is no
fallback from one to the other.

Build: each ``csrc/*.cu`` (with the ``csrc/*.cuh`` headers it includes)
compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared
library with a plain C interface under ``build/qrec_tpu_torch/`` at the
repository root, named by the hash of its source, the headers and the
flags (a changed source or header builds anew), and loads with
``ctypes``. Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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
# the CUDA runtime linked shared (the one PyTorch has loaded), so that the
# launches reach the profiler's runtime tracing: with the static runtime,
# torch.profiler lost some of these kernels
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


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
        # the shared headers count as part of every source
        headers = b"".join(h.read_bytes() for h in sorted(self.source.parent.glob("*.cuh")))
        digest = hashlib.sha256(self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
        digest = digest.hexdigest()[:16]
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
        """Launch on the current stream; raise on a non-zero CUDA error.
        A launch captured into a CUDA graph is no launch: the graph's
        :class:`GraphLaunches` tallies it and counts it at every replay (a
        capture that nothing replays, such as a count of a call's kernel
        nodes, counts nothing)."""
        err = getattr(self.load(), self.symbol)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
        if not torch.cuda.is_current_stream_capturing():
            self.launches += 1
        elif _recording is not None:
            _recording[self.name] = _recording.get(self.name, 0) + 1


DUAL = Kernel(
    "bipartite_dual_matmul", "dual_matmul.cu", "qrec_dual_matmul",
    [_P, _I, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    queries={"qrec_dual_max_cols": [_I, _I], "qrec_dual_tile_rows": [_I, _I]},
)
_CATALOG_QUERIES = {"qrec_masked_blocks_per_sm": [_I, _I, _I, _I, _I]}
SCORES = Kernel(
    "masked_catalog_scores", "masked_scores.cu", "qrec_masked_scores",
    [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P], queries=_CATALOG_QUERIES,
)
TOPK = Kernel(
    "masked_catalog_topk", "masked_scores.cu", "qrec_masked_topk",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P, _P, _F, _I, _I, _I, _P],
    queries=_CATALOG_QUERIES,
)
INFONCE_FWD = Kernel(
    "infonce_fwd", "infonce.cu", "qrec_infonce_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P],
    queries={"qrec_infonce_fwd_blocks_per_sm": [_I, _I]},
)
INFONCE_BWD = Kernel(
    "infonce_bwd", "infonce.cu", "qrec_infonce_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    queries={"qrec_infonce_bwd_scratch": [_I, _I, _I, _I]},
)
SEGMM = Kernel(
    "weighted_segment_matmul", "segment_matmul.cu", "qrec_segment_matmul",
    [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
)
# the counterparts of the JAX package's Pallas kernels
KERNELS: Tuple[Kernel, ...] = (DUAL, SCORES, TOPK, INFONCE_FWD, INFONCE_BWD, SEGMM)
ADAM = Kernel(
    "adam_update", "adam.cu", "qrec_adam_update", [_P, _P, _P, _P, _P, _I, _F, _LL, _I, _P],
)
# the port's own kernels, with no TPU counterpart
OWN_KERNELS: Tuple[Kernel, ...] = (ADAM,)
ALL_KERNELS: Tuple[Kernel, ...] = KERNELS + OWN_KERNELS

_build_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(kernels: Sequence[Kernel] = ALL_KERNELS) -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` process per
    source, all started together. Each writes a temporary file that is
    renamed into place, so a concurrent build never loads half a library;
    the ranks of a multi-GPU run that start at once build under a file
    lock, as the host library does (``native.py``), so each source
    compiles once."""
    if all(k.library_path().exists() for k in kernels):
        return {k.name: k.library_path() for k in kernels}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _build_lock, open(BUILD_DIR / "kernels.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # kernels of one source share its library
        todo = {k.library_path(): k for k in kernels if not k.library_path().exists()}
        if todo:
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
    for k in ALL_KERNELS:
        k.launches = 0


def launch_counts(kernels: Sequence[Kernel] = KERNELS) -> Dict[str, int]:
    """The launches of ``kernels``, by default the TPU kernels'
    counterparts (the Adam kernel's are ``ADAM.launches``)."""
    return {k.name: k.launches for k in kernels}


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Put back counts read by :func:`launch_counts` (a warm-up's launches
    are no launches of the run)."""
    for k in ALL_KERNELS:
        if k.name in counts:
            k.launches = counts[k.name]


# the tally of the capture under way (GraphLaunches.record), else None
_recording: Optional[Dict[str, int]] = None


class GraphLaunches:
    """The kernel launches that a CUDA graph holds: ``record()`` wraps its
    capture and tallies every :meth:`Kernel.call` made inside it; ``add()``
    adds the tally to the kernels' counts, once at every replay, so that a
    replayed launch counts as an eager one does."""

    def __init__(self):
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def record(self):
        global _recording
        if _recording is not None:
            raise RuntimeError("a capture is already being recorded")
        _recording = self.counts
        try:
            yield self
        finally:
            _recording = None

    def add(self) -> None:
        for k in ALL_KERNELS:
            k.launches += self.counts.get(k.name, 0)


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
# R's row stride, in elements, is a multiple of this (16-byte copies)
DUAL_ALIGN = 16


def aligned_width(i: int) -> int:
    """The padded row length of an R with ``i`` columns."""
    return _cdiv(i, DUAL_ALIGN) * DUAL_ALIGN


def bipartite_dual_matmul_plain(a, xu, xi):
    """Plain version: f32 products of the exact operands. ``a.float()`` and
    bf16 ``x.float()`` are exact, so this equals bf16 products with f32
    accumulation up to summation order (a bf16 matmul on the CPU would round
    its result to bf16)."""
    af = a.float()
    return af @ xi.float(), af.T @ xu.float()


def factored_dual_matmul_plain(r, x, row_scale, col_scale):
    """Plain version of :func:`factored_dual_matmul`, the steps of the JAX
    package's ``_int8_call``: scale, cast to bf16, the dual product (of an
    int8 or a bf16 r), scale the f32 sums."""
    nu, ni = r.shape[0], col_scale.shape[0]
    su, si = row_scale[:, None], col_scale[:, None]
    xu = (x[:nu] * su).to(torch.bfloat16)
    xi = (x[nu:] * si).to(torch.bfloat16)
    ou, oi = bipartite_dual_matmul_plain(r[:, :ni], xu, xi)
    return torch.cat([ou * su, oi * si])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# the plan's cost model (H100 figures; they pick a plan, they are no
# measurement): R bytes a block turns into partials per second, device
# memory bytes per second for the partials' round trip
_DUAL_SM_RATE = 12e9
_DUAL_HBM_RATE = 3.0e12


@functools.lru_cache(maxsize=None)
def _dual_plan(u: int, ld: int, d: int, bn_max: int, sms: int, tm: int = 64) -> Tuple[int, int]:
    """Region sides ``(bm, bn)`` of the dual kernel for a (u, ld) R at width
    d: ``bm`` rows, a multiple of the kernel's tile rows ``tm``, and ``bn <=
    bn_max`` columns, a multiple of 64.
    Every block writes ``(rows + cols) · N · 4`` bytes of partials (N = d
    rounded up to 8), which the second launch reads back; more regions fill
    the SMs, larger ones write fewer partials. Among the plans whose
    partials stay within R's bytes (if any do), the one with the least
    estimated time: waves of regions at ``_DUAL_SM_RATE`` plus the
    partials' round trip."""
    n = _cdiv(d, 8) * 8
    best = None
    for n_cs in range(_cdiv(ld, bn_max), _cdiv(ld, 64) + 1):
        bn = _cdiv(_cdiv(ld, n_cs), 64) * 64
        if _cdiv(ld, bn) != n_cs:
            continue
        for n_rs in range(1, _cdiv(u, tm) + 1):
            bm = _cdiv(_cdiv(u, n_rs), tm) * tm
            if _cdiv(u, bm) != n_rs:
                continue
            partial = (n_cs * u + n_rs * ld) * n * 4
            waves = _cdiv(n_rs * n_cs, sms)
            cost = waves * bm * bn / _DUAL_SM_RATE + 2 * partial / _DUAL_HBM_RATE
            key = (partial > u * ld, cost)
            if best is None or key < best[0]:
                best = (key, bm, bn)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _dual_limits(device: torch.device, d: int, a_int8: bool) -> Tuple[int, int, int]:
    """(the most columns a region can have, the tile's rows, SMs) of the
    dual kernel on ``device`` at width d; the same for both entries, so
    that they sum in the same order."""
    lib = DUAL.load()
    bn_max = lib.qrec_dual_max_cols(d, int(a_int8))
    if bn_max <= 0:
        raise RuntimeError(f"bipartite_dual_matmul: no region fits shared memory at d={d}")
    return bn_max, lib.qrec_dual_tile_rows(d, int(a_int8)), _num_sms(device)


_scratch_buffers: Dict[Tuple[str, torch.device, int], torch.Tensor] = {}


def _scratch(device: torch.device, numel: int, name: str = "dual",
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A grow-only buffer of a kernel's scratch, one per ``name``, device and
    stream: kept across calls instead of allocated on every one, and sized
    by the wrapper before the launch. It starts at zero, which counters
    that each call leaves at zero rely on. Inside a CUDA graph's capture it
    must exist already, at its size: a warm-up call on the capture's stream
    sizes it, so that no replay depends on memory allocated, and zeroed,
    inside the capture."""
    key = (name, device, torch.cuda.current_stream(device).cuda_stream)
    buf = _scratch_buffers.get(key)
    if buf is None or buf.numel() < numel:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name} scratch of {numel} elements not sized before capture: "
                               "run the captured work once on the capture's stream first")
        buf = torch.zeros(numel, dtype=dtype, device=device)
        _scratch_buffers[key] = buf
    return buf


def _existing_scratch(device, name: str) -> Optional[torch.Tensor]:
    """The ``name`` scratch buffer of ``device`` and its current stream, or
    None before the first call that needed it."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    return _scratch_buffers.get((name, device, torch.cuda.current_stream(device).cuda_stream))


def _dual_launch(a, xu, xi, x, su, si, u: int, i: int, d: int) -> torch.Tensor:
    """One call of the dual kernel: (u+i, d) f32, ou then oi."""
    a_int8 = a.dtype == torch.int8
    bn_max, tm, sms = _dual_limits(a.device, d, a_int8)
    ld = a.shape[1]
    bm, bn = _dual_plan(u, ld, d, bn_max, sms, tm)
    n = _cdiv(d, 8) * 8
    n_rs, n_cs = _cdiv(u, bm), _cdiv(ld, bn)
    ou_numel = n_cs * u * n
    part = _scratch(a.device, ou_numel + n_rs * i * n)
    out = torch.empty((u + i, d), dtype=torch.float32, device=a.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    DUAL.call(
        a.data_ptr(), int(a_int8), ld, ptr(xu), ptr(xi), ptr(x), ptr(su), ptr(si),
        part.data_ptr(), part.data_ptr() + 4 * ou_numel, out.data_ptr(),
        u, i, d, bm, bn, torch.cuda.current_stream(a.device).cuda_stream,
    )
    return out


def bipartite_dual_matmul(a: torch.Tensor, xu: torch.Tensor, xi: torch.Tensor):
    """``(a @ xi, aᵀ @ xu)`` as f32 ``(U, d)`` and ``(I, d)``.

    ``a``: (U, I) int8 or bf16, row-major; ``xu`` (U, d) and ``xi`` (I, d)
    bf16, any U, I and d <= 256. The kernel reads rows whose length is a
    multiple of 16: an ``a`` of another width is copied once into a
    zero-padded table first (``DenseJoint`` stores R padded)."""
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
    if xu.data_ptr() % 4 or xi.data_ptr() % 4:
        raise ValueError("xu and xi must be 4-byte aligned (4-byte copies)")
    if i % DUAL_ALIGN:
        padded = torch.zeros((u, aligned_width(i)), dtype=a.dtype, device=a.device)
        padded[:, :i] = a
        a = padded
    out = _dual_launch(a, xu, xi, None, None, None, u, i, d)
    return out[:u], out[u:]


def factored_dual_matmul(
    r: torch.Tensor, x: torch.Tensor, row_scale: torch.Tensor, col_scale: torch.Tensor
) -> torch.Tensor:
    """``[[0, Ŝ], [Ŝᵀ, 0]] @ x`` as one (U+I, d) f32 tensor, with
    ``Ŝ = diag(row_scale) · r · diag(col_scale)``: ``ou = su · (r @
    bf16(si · x_i))``, ``oi = si · (rᵀ @ bf16(su · x_u))``, the arithmetic
    of the JAX package's ``_int8_call``. One kernel call: the scaling and
    the casts happen as the kernel loads x, the scales of the result as it
    writes it.

    ``r``: (U, ld) int8 (the binary R of the factored form, the legacy
    form's quantized table) or bf16 (the bf16 Ŝ, with unit scales: then
    this is the JAX package's ``_dual_call``, x cast to bf16 and f32 sums,
    since a unit scale changes no bit), with I = ``col_scale``'s length <=
    ld; on a card ld is a multiple of 16 and the columns past I are zero
    (``DenseJoint``'s layout), so no copy is made. ``x`` (U+I, d) f32, any
    d <= 256; the scales f32."""
    _check(r, "r", (torch.int8, torch.bfloat16), 2)
    _check(x, "x", (torch.float32,), 2)
    _check(row_scale, "row_scale", (torch.float32,), 1)
    _check(col_scale, "col_scale", (torch.float32,), 1)
    u, ld = r.shape
    i = col_scale.shape[0]
    d = x.shape[1]
    if row_scale.shape != (u,) or x.shape[0] != u + i or i > ld:
        raise ValueError(
            f"shape mismatch: r {tuple(r.shape)}, x {tuple(x.shape)}, row_scale "
            f"{tuple(row_scale.shape)}, col_scale {tuple(col_scale.shape)}"
        )
    if not 0 < d <= DUAL_MAX_D:
        raise ValueError(f"d={d} outside 1..{DUAL_MAX_D}")
    if _route(r, x, row_scale, col_scale) == "cpu":
        return factored_dual_matmul_plain(r, x, row_scale, col_scale)
    if ld % DUAL_ALIGN:
        raise ValueError(f"r's rows must be padded to a multiple of {DUAL_ALIGN}, got {ld}")
    return _dual_launch(r, None, None, x, row_scale, col_scale, u, i, d)


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


# K2: users a block (the row tile), item rows a tile, the widest d staged
# whole, features a pass past it, the longest list, the most splits
CATALOG_BLOCK_ROWS = (128, 64)
# the top-k with the score form's biases runs 64-row blocks only: its
# 128-row block spills (masked_scores.cu)
CATALOG_BIASED_ROWS = (64,)
CATALOG_TILE = 64
CATALOG_MAX_D = 256
CATALOG_SLICE = 64
CATALOG_MAX_K = 128
CATALOG_MAX_SPLITS = 16


def masked_catalog_plan(b: int, i: int, d: int, k: int, sms: int, blocks_per_sm,
                        rows: Sequence[int] = CATALOG_BLOCK_ROWS) -> Tuple[int, int, int]:
    """``(bm, slice, tiles_per_split)`` of K2 for B users, I items, width d
    and lists of k (0: the scores entry). ``blocks_per_sm(bm, slice,
    splits)`` is how many such blocks one SM holds. The items are split
    into whole tiles so that the (row tile, split) blocks fill the SMs once,
    no split empty; the top-k entry merges its splits with a lane of a
    half-warp each, so at most 16 (its block's shared memory grows with
    them for that merge). The block: d staged whole where a block fits
    (of ``rows``: 128 or 64), else in slices of 64 features; among those,
    the one with the most blocks resident at once, then the larger."""
    tiles = _cdiv(i, CATALOG_TILE)
    most = min(tiles, CATALOG_MAX_SPLITS) if k else tiles
    best = None
    for sl in ([0] if d <= CATALOG_MAX_D else []) + ([CATALOG_SLICE] if d > CATALOG_SLICE else []):
        for bm in rows:
            tiles_b = _cdiv(b, bm)
            splits = most
            while splits > 1 and blocks_per_sm(bm, sl, splits) < 1:
                splits -= 1
            per_sm = blocks_per_sm(bm, sl, splits)
            if per_sm < 1:
                continue
            splits = min(splits, max(1, per_sm * sms // tiles_b))
            per_sm = blocks_per_sm(bm, sl, splits)
            key = (min(tiles_b * splits, per_sm * sms), bm)
            if best is None or key > best[0]:
                best = (key, bm, sl, splits)
        if best is not None:
            break
    if best is None:
        raise RuntimeError(f"masked catalog kernel: no block fits an SM at d={d}, k={k}")
    _, bm, sl, splits = best
    return bm, sl, _cdiv(tiles, splits)


@functools.lru_cache(maxsize=None)
def _masked_catalog_plan(device: torch.device, b: int, i: int, d: int, k: int,
                         biased: bool = False):
    lib = SCORES.load()
    per_sm = functools.lru_cache(maxsize=None)(
        lambda bm, sl, splits: lib.qrec_masked_blocks_per_sm(bm, d, sl, k, splits))
    rows = CATALOG_BIASED_ROWS if biased else CATALOG_BLOCK_ROWS
    return masked_catalog_plan(b, i, d, k, _num_sms(device), per_sm, rows)


def _check_catalog(user_emb, items, bitmask) -> Tuple[int, int]:
    _check(user_emb, "user_emb", (torch.float32,), 2)
    _check(items, "items", (torch.float32,), 2)
    _check(bitmask, "bitmask", (torch.int32,), 2)
    i, d = items.shape
    if user_emb.shape[1] != d or bitmask.shape[0] != user_emb.shape[0] or bitmask.shape[1] < _cdiv(i, 32):
        raise ValueError(
            f"shape mismatch: user rows {tuple(user_emb.shape)}, items "
            f"{tuple(items.shape)}, bitmask {tuple(bitmask.shape)}"
        )
    if i < 1 or d < 1:
        raise ValueError(f"need I >= 1 and d >= 1; got {i}, {d}")
    return i, d


def masked_catalog_scores(
    u_block: torch.Tensor,
    items: torch.Tensor,
    bitmask: torch.Tensor,
    mask_value: float = 0.0,
) -> torch.Tensor:
    """(B, I) f32 scores ``u_block @ itemsᵀ`` with rated items set to
    ``mask_value``. ``u_block`` (B, d) and ``items`` (I, d) f32, any d;
    ``bitmask`` (B, ceil(I/32)) int32 holding the packed uint32 bit
    pattern. One kernel launch."""
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
    if b == 0:
        return out
    bm, sl, tps = _masked_catalog_plan(u_block.device, b, i, d, 0)
    SCORES.call(
        u_block.data_ptr(), items.data_ptr(), bitmask.data_ptr(), out.data_ptr(),
        b, i, d, words, float(mask_value), bm, sl, tps,
        torch.cuda.current_stream(u_block.device).cuda_stream,
    )
    return out


def biased_scores(scores, uids, item_bias=None, user_bias=None, offset: float = 0.0):
    """The score form's adds on (B, I) dot products of the users ``uids``
    (>= 0), in the kernel's order: ``((s + offset) + item_bias[c]) +
    user_bias[uid]``, each bias where it is given; none of them without a
    bias or an offset (adding 0 would turn -0.0 into +0.0)."""
    if item_bias is None and user_bias is None and offset == 0:
        return scores
    scores = scores + float(np.float32(offset))
    if item_bias is not None:
        scores = scores + item_bias[None, :]
    if user_bias is not None:
        scores = scores + user_bias[uids][:, None]
    return scores


def _row_products(u: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """``u @ items.T`` with every row summed as in a batch of several rows:
    the CPU's product of a single row takes a matrix-vector path that sums
    in another order, so a row's scores would depend on its batch (a mesh's
    shares of the test users can end in a batch of one)."""
    if u.shape[0] == 1:
        return (torch.cat([u, u]) @ items.T)[:1]
    return u @ items.T


def masked_catalog_topk_plain(user_emb, items, bitmask, uids, global_mean: float, k: int,
                              mask_value: float = 0.0, item_bias=None, user_bias=None,
                              offset: float = 0.0):
    """Plain version of :func:`masked_catalog_topk`: the (B, I) dot
    products of the users' rows, biased (:func:`biased_scores`), rated items
    set to ``mask_value``, the global mean for unseen users, a stable
    descending sort, the first k columns."""
    safe = uids.clamp(min=0)
    scores = biased_scores(_row_products(user_emb[safe], items), safe, item_bias, user_bias,
                           offset)
    rated = expand_bitmask(bitmask[safe], items.shape[0])
    scores = torch.where(rated, torch.full_like(scores, mask_value), scores)
    scores = torch.where((uids < 0)[:, None], torch.full_like(scores, global_mean), scores)
    top_scores, top_ids = torch.sort(scores, dim=1, descending=True, stable=True)
    # copies, so the (B, I) sort outputs are freed
    return top_ids[:, :k].clone(), top_scores[:, :k].clone()


def masked_catalog_topk_counters(device) -> Optional[torch.Tensor]:
    """The top-k entry's counters on ``device`` and the current stream (None
    before the first call there); every call leaves them at zero."""
    return _existing_scratch(device, "masked_topk_counters")


def masked_catalog_topk(
    user_emb: torch.Tensor,
    items: torch.Tensor,
    bitmask: torch.Tensor,
    uids: torch.Tensor,
    global_mean: float,
    k: int,
    mask_value: float = 0.0,
    plan: Optional[Tuple[int, int, int]] = None,
    item_bias: Optional[torch.Tensor] = None,
    user_bias: Optional[torch.Tensor] = None,
    offset: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids (B, k) int64, scores (B, k) f32)``: for each user of the batch
    ``uids`` (B,) int64 the k best items of the catalog under the scores of
    :func:`masked_catalog_scores` on its row of ``user_emb`` (U, d) and
    ``bitmask`` (U, >= ceil(I/32)) int32, biased before the mask as
    :func:`biased_scores` says by ``item_bias`` (I,) and ``user_bias`` (U,)
    f32 (each optional) and ``offset`` (rounded to f32), in the order of
    ``torch.sort(descending=True, stable=True)``: score descending, the
    lower item first on equal scores (-0.0 equal to +0.0, NaN above +inf).
    Rated items stay candidates at ``mask_value``. A user id of -1 (unseen
    in training) gets items 0..k-1 at ``global_mean``; its rows are never
    read. 1 <= k <= min(128, I), any d. One kernel launch; no (B, I) tensor
    is allocated. ``plan`` (bm, slice, tiles_per_split) replaces
    :func:`masked_catalog_plan`'s choice (with a bias or an offset, bm 64:
    ``CATALOG_BIASED_ROWS``)."""
    i, d = _check_catalog(user_emb, items, bitmask)
    _check(uids, "uids", (torch.int64,), 1)
    biases = [t for t in (item_bias, user_bias) if t is not None]
    for name, t, rows in (("item_bias", item_bias, i), ("user_bias", user_bias, user_emb.shape[0])):
        if t is not None:
            _check(t, name, (torch.float32,), 1)
            if t.shape[0] != rows:
                raise ValueError(f"{name}: {t.shape[0]} entries, expected {rows}")
    k = int(k)
    if not 1 <= k <= min(CATALOG_MAX_K, i):
        raise ValueError(f"k={k} outside 1..min({CATALOG_MAX_K}, I={i})")
    if _route(user_emb, items, bitmask, uids, *biases) == "cpu":
        return masked_catalog_topk_plain(user_emb, items, bitmask, uids, global_mean, k,
                                         mask_value, item_bias, user_bias, offset)
    dev = user_emb.device
    b = uids.shape[0]
    ids = torch.empty((b, k), dtype=torch.int64, device=dev)
    scores = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0:
        return ids, scores
    biased = item_bias is not None or user_bias is not None or offset != 0
    bm, sl, tps = _masked_catalog_plan(dev, b, i, d, k, biased) if plan is None else plan
    splits = _cdiv(_cdiv(i, CATALOG_TILE), tps)
    part = _scratch(dev, splits * b * (k + k % 2), "masked_topk", torch.int64)
    counters = _scratch(dev, _cdiv(b, bm), "masked_topk_counters", torch.int32)
    TOPK.call(
        user_emb.data_ptr(), items.data_ptr(), bitmask.data_ptr(), uids.data_ptr(),
        part.data_ptr(), counters.data_ptr(), ids.data_ptr(), scores.data_ptr(),
        b, i, d, bitmask.shape[1], k, float(global_mean), float(mask_value),
        None if item_bias is None else item_bias.data_ptr(),
        None if user_bias is None else user_bias.data_ptr(), float(offset), bm, sl, tps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return ids, scores


# ---------------------------------------------------------------------------
# masked InfoNCE, forward and backward
# ---------------------------------------------------------------------------

INFONCE_MAX_D = 256
# the finite value of a masked logit, as the JAX package fills it
INFONCE_MASKED = -1e30
# K3: rows of v2 a column tile, and the rows a block may take
INFONCE_TILE = 64
INFONCE_BLOCK_ROWS = (64, 128)


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def infonce_fwd_plan(b_loc: int, b: int, d: int, sms: int, blocks_per_sm) -> Tuple[int, int]:
    """``(bm, tiles_per_split)`` of K3: blocks of ``bm`` rows of v1, each
    taking ``tiles_per_split`` column tiles of 64 rows of v2.
    ``blocks_per_sm(bm)`` is how many such blocks one SM holds at width d.
    ``bm`` is the largest row tile whose block fits an SM; the columns are
    split so that the (row tile, split) blocks fill the SMs once, no split
    empty."""
    fits = {bm: blocks_per_sm(bm) for bm in INFONCE_BLOCK_ROWS}
    bm = max(m for m in INFONCE_BLOCK_ROWS if fits[m] >= 1)
    tiles = _cdiv(b, INFONCE_TILE)
    splits = min(tiles, max(1, fits[bm] * sms // _cdiv(b_loc, bm)))
    return bm, _cdiv(tiles, splits)


@functools.lru_cache(maxsize=None)
def _infonce_fwd_plan(device: torch.device, b_loc: int, b: int, d: int) -> Tuple[int, int]:
    lib = INFONCE_FWD.load()
    return infonce_fwd_plan(b_loc, b, d, _num_sms(device),
                            lambda bm: lib.qrec_infonce_fwd_blocks_per_sm(bm, d))


def infonce_fwd_scratch(b_loc: int, b: int, bm: int, tiles_per_split: int) -> Tuple[int, int]:
    """(f32, int32) scratch elements of one K3 call: each split's (max, sum,
    pos) of every row and each row tile's loss; a counter per row tile and
    one for the grid."""
    row_tiles = _cdiv(b_loc, bm)
    splits = _cdiv(_cdiv(b, INFONCE_TILE), tiles_per_split)
    return 3 * splits * b_loc + row_tiles, row_tiles + 1


def infonce_fwd_counters(device) -> Optional[torch.Tensor]:
    """K3's counters on ``device`` and the current stream (None before the
    first call there); every call leaves them at zero."""
    return _existing_scratch(device, "infonce_fwd_counters")


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
    plan: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)``: the scalar ``Σ_r rmask[r] · (lse[r] − pos[r])`` and the
    per-row logsumexp over the masked logits ``v1 @ v2ᵀ / T``.

    ``v1`` (b_loc, d) and ``v2`` (B, d) f32, already L2-normalized; ``cmask``
    (B,) masks logit columns (a masked column enters as -1e30), ``rmask``
    (b_loc,) rows; the positive of row r is column ``r + row_offset``. Any
    b_loc, B >= 1 and d <= 256. One kernel launch; ``plan`` (bm,
    tiles_per_split) replaces :func:`infonce_fwd_plan`'s choice."""
    b_loc, b, d = _check_infonce(v1, v2, cmask, rmask)
    if _route(v1, v2, cmask, rmask) == "cpu":
        return infonce_fwd_plain(v1, v2, cmask, rmask, temperature, row_offset)
    dev = v1.device
    bm, tps = _infonce_fwd_plan(dev, b_loc, b, d) if plan is None else plan
    if bm not in INFONCE_BLOCK_ROWS or tps < 1:
        raise ValueError(f"plan {(bm, tps)}: need bm in {INFONCE_BLOCK_ROWS} and tiles >= 1")
    floats, ints = infonce_fwd_scratch(b_loc, b, bm, tps)
    part = _scratch(dev, floats, "infonce_fwd")
    counters = _scratch(dev, ints, "infonce_fwd_counters", torch.int32)
    lse = torch.empty(b_loc, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    INFONCE_FWD.call(
        v1.data_ptr(), v2.data_ptr(), cmask.data_ptr(), rmask.data_ptr(), part.data_ptr(),
        counters.data_ptr(), lse.data_ptr(), out.data_ptr(), b_loc, b, d, float(temperature),
        int(row_offset), bm, tps, torch.cuda.current_stream(dev).cuda_stream,
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
# x's row stride, in elements, that gives 16-byte gathers (8 bf16)
SEGMM_ALIGN = 8


def segment_row_stride(d: int) -> int:
    """The padded row length of a bf16 x of width d that the segment kernel
    gathers 16 bytes a lane from (``_segment_call`` casts into it)."""
    return _cdiv(d, SEGMM_ALIGN) * SEGMM_ALIGN


def segment_tile(num_edges: int) -> int:
    """Edges a tile: a power of two from 512 to 4096, the smallest that
    keeps the tiles at most 3 per SM of an H100 (132 SMs), so that every
    block is resident at once. On the card, 512 was fastest at the lastfm
    CSR (290 tiles) and 2048 at yelp2018 (353 tiles) among 256-4096
    (``k5_paired.py``)."""
    tile = 512
    while tile < 4096 and _cdiv(num_edges, tile) > 3 * 132:
        tile *= 2
    return tile


class SegmentSchedule(NamedTuple):
    """The cut of a row-sorted CSR matrix's E edges into tiles of ``tile``
    edges, ``[t·tile, (t+1)·tile)``, that the segment kernel runs one block
    each; a tile may cross row boundaries. All tensors int32 but ``carry``:

    * ``edge_row`` (E,): the row of every edge;
    * ``tile_row`` (num_tiles + 1,): the row of each tile's first edge, then
      ``num_rows`` (all ``num_rows`` when there is no edge);
    * ``tile_split`` (num_tiles, 2): the split row (index into ``split_row``)
      that the tile starts inside of, and the one it ends inside of, -1
      where none;
    * ``split_row`` (S,): the rows whose edges lie in more than one tile,
      and ``split_ptr`` (S+1,) / ``split_tiles`` (C,): each split row's
      tiles, in order (slot ``split_ptr[s] + k`` is its k-th tile);
    * ``carry`` (C, SEGMM_MAX_D) f32: one slot per (split row, tile), where
      the tile leaves its part of the row;
    * ``counters`` (S,): each split row's arrival count, 0 between calls
      (the block that completes a row resets it).

    Scratch lives here, sized once per matrix: a call allocates only its
    output. Two calls that share a schedule must not run concurrently on
    different streams."""

    tile: int
    num_rows: int
    edge_row: torch.Tensor
    tile_row: torch.Tensor
    tile_split: torch.Tensor
    split_row: torch.Tensor
    split_ptr: torch.Tensor
    split_tiles: torch.Tensor
    carry: torch.Tensor
    counters: torch.Tensor

    @property
    def num_tiles(self) -> int:
        return self.tile_row.shape[0] - 1


def segment_schedule(indptr, device=None, tile: Optional[int] = None) -> SegmentSchedule:
    """The schedule of a CSR matrix from its row pointers (numpy or a
    tensor), computed on the host once per matrix; its tensors go to
    ``device`` (default: ``indptr``'s). ``tile`` (a multiple of 4) defaults
    to :func:`segment_tile` of the edge count."""
    if isinstance(indptr, torch.Tensor):
        device = indptr.device if device is None else device
        indptr = indptr.cpu().numpy()
    indptr = np.asarray(indptr, dtype=np.int64)
    n, e = len(indptr) - 1, int(indptr[-1])
    tile = segment_tile(e) if tile is None else int(tile)
    if tile <= 0 or tile % 4:
        raise ValueError(f"tile={tile}: need a positive multiple of 4")
    num_tiles = max(1, _cdiv(e, tile))
    deg = np.diff(indptr)
    edge_row = np.repeat(np.arange(n), deg)
    tile_row = np.full(num_tiles + 1, n)
    tile_row[:-1] = edge_row[np.arange(num_tiles) * tile] if e else n
    first, last = indptr[:-1] // tile, (indptr[1:] - 1) // tile
    split_row = np.flatnonzero((deg > 0) & (last > first))
    per = (last - first + 1)[split_row]
    split_ptr = np.zeros(len(split_row) + 1, dtype=np.int64)
    np.cumsum(per, out=split_ptr[1:])
    owner = np.repeat(np.arange(len(split_row)), per)
    slot = np.arange(split_ptr[-1])
    split_tiles = first[split_row][owner] + slot - split_ptr[:-1][owner]
    tile_split = np.full((num_tiles, 2), -1)
    # past a split row's first tile the row is where its tile starts;
    # before its last tile, where its tile ends
    head = slot != split_ptr[:-1][owner]
    tail = slot != split_ptr[1:][owner] - 1
    tile_split[split_tiles[head], 0] = owner[head]
    tile_split[split_tiles[tail], 1] = owner[tail]
    as_int32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)  # noqa: E731
    return SegmentSchedule(
        tile, n, as_int32(edge_row), as_int32(tile_row), as_int32(tile_split),
        as_int32(split_row), as_int32(split_ptr), as_int32(split_tiles),
        torch.zeros((len(split_tiles), SEGMM_MAX_D), dtype=torch.float32, device=device),
        torch.zeros(len(split_row), dtype=torch.int32, device=device),
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
    *,
    rows: Optional[int] = None,
) -> torch.Tensor:
    """(N, d) f32 ``out[r] = Σ_{e in row r} f32(bf16(vals[e])) · f32(x[cols[e]])``
    over a row-sorted CSR matrix, every row written (an empty one as 0).

    ``x`` (N, d) bf16, any 1 <= d <= 256, its rows contiguous but their
    stride free (a view of a table padded to :func:`segment_row_stride`
    gathers 16 bytes a lane); ``indptr`` (N+1,) and ``cols`` (E,) int32;
    ``vals`` (E,) f32. ``schedule`` is :func:`segment_schedule` of
    ``indptr``, which a caller that applies one matrix many times keeps;
    it is computed here when None. One kernel launch.

    ``rows``, when given, is N for a shard of a matrix's rows
    (``ops/spmm.ShardedSparseJoint``): ``indptr`` is then (rows + 1,), and
    ``x`` may hold more rows than N, which ``cols`` index (the kernel bounds
    only ``out`` by N)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x: dtype {x.dtype} not in {(torch.bfloat16,)}")
    if x.dim() != 2 or x.stride(-1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(f"x: expected 2 dims with contiguous rows, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    _check(indptr, "indptr", (torch.int32,), 1)
    _check(cols, "cols", (torch.int32,), 1)
    _check(vals, "vals", (torch.float32,), 1)
    if rows is None:
        n, d = x.shape
    else:
        n, d = int(rows), x.shape[1]
        if x.shape[0] < 1:
            raise ValueError(f"x: a row shard reads x's rows; got shape {tuple(x.shape)}")
    if indptr.shape != (n + 1,) or vals.shape != cols.shape:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, indptr {tuple(indptr.shape)}, "
            f"cols {tuple(cols.shape)}, vals {tuple(vals.shape)}"
        )
    if n < 1 or not 0 < d <= SEGMM_MAX_D:
        raise ValueError(f"need N >= 1 and 1 <= d <= {SEGMM_MAX_D}; got {n}, {d}")
    if _route(x, indptr, cols, vals) == "cpu":
        return weighted_segment_matmul_plain(x, indptr, cols, vals)
    s = segment_schedule(indptr) if schedule is None else schedule
    _route(x, s.edge_row, s.tile_row, s.carry, s.counters)
    if s.num_rows != n or s.edge_row.shape != cols.shape:
        raise ValueError(f"schedule of {s.num_rows} rows and {s.edge_row.shape[0]} edges "
                         f"for {n} rows and {cols.shape[0]} edges")
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    SEGMM.call(
        x.data_ptr(), x.stride(0), cols.data_ptr(), vals.data_ptr(), s.edge_row.data_ptr(),
        s.tile_row.data_ptr(), s.tile_split.data_ptr(), s.split_ptr.data_ptr(),
        s.split_tiles.data_ptr(), s.carry.data_ptr(), s.counters.data_ptr(),
        n, d, cols.shape[0], s.tile, s.num_tiles, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out


# ---------------------------------------------------------------------------
# Adam's parameter update
# ---------------------------------------------------------------------------


def adam_update_plain(p, m, v, step, table, eps: float) -> None:
    """Plain version of :func:`adam_update`: the update sequence of
    ``torch.optim.Adam(foreach=True, capturable=False)``
    (``_multi_tensor_adam``: ``_foreach_sqrt``, ``_foreach_div_``,
    ``_foreach_add_``, ``_foreach_addcdiv_``) with the step's scalars
    ``s_t``, ``c_t`` read on the host from ``table``'s row of ``step``. On
    a CUDA tensor it is plain Adam's update bit for bit."""
    rows = table.shape[0]
    t = min(max(int(step), 1), rows)
    s, c = table[t - 1].tolist()
    denom = torch._foreach_sqrt([v])
    torch._foreach_div_(denom, [c])
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_([p], [m], denom, [s])


def adam_update(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, step: torch.Tensor,
                table: torch.Tensor, eps: float) -> None:
    """``p ← p + s_t·(m / (√v / c_t + eps))`` in place, for f32 ``p`` and
    its Adam moments ``m``, ``v`` (updated for step t), ``step`` the 0-d f32
    step count t and ``table`` (rows, 2) f32 the scalars ``(s_t, c_t)`` of
    steps 1..rows (a step past the last row reads the last). The kernel
    reads t on the device, so a CUDA graph holding it reads each replay's
    step, and rounds as :func:`adam_update_plain` does on a CUDA device.
    One launch a tensor."""
    if _route(p, m, v, step, table) == "cpu":
        adam_update_plain(p, m, v, step, table, eps)
        return
    for name, t in (("p", p), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != p.numel():
            raise ValueError(f"adam_update: {name} must be contiguous f32 of p's size")
    if step.dtype != torch.float32 or step.numel() != 1:
        raise ValueError("adam_update: step must be one f32")
    _check(table, "table", (torch.float32,), 2)
    if table.shape[1] != 2 or table.shape[0] < 1:
        raise ValueError(f"adam_update: table must be (rows, 2), got {tuple(table.shape)}")
    ADAM.call(p.data_ptr(), m.data_ptr(), v.data_ptr(), step.data_ptr(), table.data_ptr(),
              table.shape[0], eps, p.numel(), _num_sms(p.device),
              torch.cuda.current_stream(p.device).cuda_stream)
