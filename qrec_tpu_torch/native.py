"""The port's host C++ library (``csrc/qrec_host.cpp``): the rating
tokenizer and the weighted random walker, bound with ``ctypes``.

The library is built at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``build/qrec_tpu_torch/`` at the repository root, named
by the hash of the source and the flags, as the CUDA kernels are
(``ops/kernels.py``): the compiler writes a temporary file that is renamed
into place, under a lock that concurrent processes share. A failed build
raises with the compiler's output; nothing falls back to the plain
versions (``io.parse_ratings_plain``, ``ops/walks.random_walks_numpy``),
whose walks would differ.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from .errors import DataFormatError

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "qrec_host.cpp"
BUILD_DIR = _PKG.parent / "build" / "qrec_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"qrec_host-{digest}.so"


def build() -> Path:
    """Compile the library unless it exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "qrec_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stderr}")
            os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The bound library, built first if it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.qrec_host_parse.restype = ctypes.c_void_p
            lib.qrec_host_parse.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                            ctypes.c_int]
            lib.qrec_host_parse_info.restype = ctypes.c_int
            lib.qrec_host_parse_info.argtypes = [ctypes.c_void_p,
                                                 np.ctypeslib.ndpointer(np.int64)]
            lib.qrec_host_parse_copy.restype = None
            lib.qrec_host_parse_copy.argtypes = [
                ctypes.c_void_p, _I32, _I32, np.ctypeslib.ndpointer(np.float32),
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ]
            lib.qrec_host_parse_free.restype = None
            lib.qrec_host_parse_free.argtypes = [ctypes.c_void_p]
            lib.qrec_host_walks.restype = None
            lib.qrec_host_walks.argtypes = [
                _I32, _I32, np.ctypeslib.ndpointer(np.float64), _I32, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_uint64, _I32,
            ]
            _lib = lib
    return _lib


class ParsedRatings(NamedTuple):
    """The tokenizer's output: per record the user's and the item's dense
    id (first-appearance order) and the float32 rating; the names of the
    ids in order."""

    users: np.ndarray
    items: np.ndarray
    ratings: np.ndarray
    user_names: List[str]
    item_names: List[str]


def parse_ratings(path: str, u_col: int, i_col: int, r_col: int, binarize: bool = False,
                  threshold: float = 3.0, skip_header: bool = False) -> ParsedRatings:
    """Tokenize a rating file on runs of space, comma and tab (``r_col <
    0``: every rating 1; ``binarize``: drop a record below ``threshold``,
    rate the others 1). Columns must be non-negative. Raises
    ``DataFormatError`` at the first line with too few tokens or a rating
    ``strtof`` cannot read, numbered after the header, and ``OSError``
    when the file cannot be read."""
    if min(u_col, i_col) < 0:
        raise ValueError(f"the tokenizer takes non-negative columns, got {u_col}, {i_col}")
    lib = load()
    handle = lib.qrec_host_parse(os.fsencode(path), u_col, i_col, r_col, int(binarize),
                                 threshold, int(skip_header))
    if not handle:
        raise MemoryError(f"the tokenizer could not allocate its result for {path}")
    try:
        sizes = np.zeros(7, dtype=np.int64)
        status = lib.qrec_host_parse_info(handle, sizes)
        if status == 1:
            with open(path, "rb"):
                pass
            raise OSError(f"could not read {path}")
        n = int(sizes[0])
        users, items = np.empty(n, dtype=np.int32), np.empty(n, dtype=np.int32)
        ratings = np.empty(n, dtype=np.float32)
        names = [ctypes.create_string_buffer(max(int(s), 1)) for s in (sizes[3], sizes[4], sizes[6])]
        lib.qrec_host_parse_copy(handle, users, items, ratings, *names)
    finally:
        lib.qrec_host_parse_free(handle)
    if status == 2:
        line = names[2].raw[: int(sizes[6])].decode(errors="replace")
        raise DataFormatError(
            f"Malformed rating line {int(sizes[5])} in {path}: {line.strip()!r} "
            "(did you forget -header in ratings.setup?)"
        )
    split = lambda buf, size: buf.raw[:size].decode().split("\n")[:-1]  # noqa: E731
    return ParsedRatings(users, items, ratings, split(names[0], int(sizes[3])),
                         split(names[1], int(sizes[4])))


def random_walks(indptr: np.ndarray, indices: np.ndarray, cum_weights: np.ndarray,
                 starts: np.ndarray, walk_length: int, seed: int) -> np.ndarray:
    """(len(starts), walk_length) int32 weighted walks, one from each start,
    xorshift128+ seeded ``seed``; ``cum_weights`` is the float64 cumulative
    sum of the CSR values."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    cum_weights = np.ascontiguousarray(cum_weights, dtype=np.float64)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    n = len(indptr) - 1
    if (walk_length < 1 or len(indices) != len(cum_weights) or indptr[-1] != len(indices)
            or (len(starts) and not 0 <= starts.min() <= starts.max() < n)
            or (len(indices) and not 0 <= indices.min() <= indices.max() < n)):
        raise ValueError("random_walks needs a square CSR graph, one cumulative weight an "
                         "edge, starts among its nodes and walk_length >= 1")
    walks = np.empty((len(starts), walk_length), dtype=np.int32)
    load().qrec_host_walks(indptr, indices, cum_weights, starts, len(starts), walk_length, seed,
                           walks)
    return walks
