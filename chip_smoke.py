#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each of which exits non-zero on failure:

1. card check: needs ``torch.cuda.is_available()``; prints ``nvidia-smi``'s
   name and power limit;
2. build: compiles every CUDA kernel from ``qrec_tpu_torch/csrc``;
3. LightGCN main path: ``QRec(conf).execute()`` with
   ``config/LightGCN.conf`` at full width (d=50, 2 layers, batch 2000) on a
   lastfm-shaped synthetic rating file, 5 epochs; launch counts show the
   path ran through K1 and K2's fused top-k (and not K3/K4, nor K2's
   scores entry), and the final ranking is held against the plain versions
   on the CPU and, bit for bit, against K2's scores entry followed by a
   stable sort, with the peak device memory of both rankings;
4. K1 and K2 against their plain PyTorch versions on the card, on the main
   path's own operands (R and the first layer's inputs for K1, at d=50,
   150 and 1, the first batch of test users for K2's scores entry and its
   fused top-k, the latter timed in turns with the unfused ranking and the
   library's ``torch.topk``, with its CUDA kernels per call), K1 also at
   the yelp2018 shape; K1's factored entry against its plain version and the
   unfused sequence, with its kernels per application; the L2 read rate
   (a streaming read of an L2-resident buffer); K5 on the lastfm graph's
   CSR at d=50 (against its plain version, timed in turns with
   ``torch.sparse.mm``, its CUDA kernels per call, bound and gather floor)
   beside K1; CUDA-event timings of each kernel, its plain version and a
   PyTorch yardstick, with the L2 cache flushed before each timed launch,
   and the bound; then one more LightGCN epoch under ``torch.profiler``;
5. SimGCL main path: ``config/SimGCL.conf`` at full width on the same file,
   3 epochs, with the per-epoch quick evaluation and best-epoch selection;
   launch counts of K1-K4 against the code's expectations; K3 and K4
   against their plain versions on the first step's unique-user views
   (B=2000), with masked rows and a zero row, and repeated bit for bit,
   then timed, each kernel in turns with its library call inside one loop
   (``Timer.paired``), with K3's CUDA kernels per call (1) and its split
   counters back at 0, K3's and K4's share of f32 peak and K4's partial
   bytes; one more SimGCL epoch under ``torch.profiler``;
6. SGL path: ``config/SGL.conf`` at full width, 2 epochs, its launch
   counts, and K3/K4 on its first step's merged views (B=4000);
7. the sparse joint adjacency (K5, the segment SpMM): ``config/SGL.conf``
   with ``graph.backend=pallas``, 2 epochs; ``config/NGCF.conf`` as
   published (dense, K1), 3 epochs; LightGCN with ``graph.backend=pallas``
   at the yelp2018 shape and widths of ``bench.build_yelp_scale`` (d=64,
   batch 2048, 2 layers, top-20, reg 1e-4), 2 epochs; each with its launch
   counts (K1 = 0 on the K5 paths); NGCF's (width 150) and the yelp2018
   top-20 rankings held and timed as the main path's; then K5 on the yelp path's own CSR and
   first-layer input against its plain version (and bit for bit against
   itself, its split-row counters back at 0) and against K1 on the same
   graph, timed in turns with ``torch.sparse.mm``, one CUDA kernel a call,
   the gather floor, and one more yelp epoch under ``torch.profiler``;
8. the MF slice and the reference's protocols (``mf_phases``):
   ``config/BPR.conf`` as published, 5 epochs of bold-driver SGD, its
   ranking held as the main path's; ``config/SVD.conf`` on a
   FilmTrust-shaped file (1,508 x 2,071 x 35,497 ratings), rating
   evaluation with its per-epoch MAE/RMSE and result files, then ranked
   (K2's bias epilogue, bit for bit against the unfused sequence, timed);
   ``config/MostPopular.conf`` ranked through K2 with its popularity as the
   item bias; BPR under ``-cv 5`` (five folds, the summary file) and
   ``-predict`` (a list of 100 users, the list file only); each with its
   launch counts against ``expected_launches``;
9. the deep and GAN slice (``deep_phases``): NeuMF, APR, IRGAN, DMF, CDAE
   and CFGAN on the lastfm-shaped file, each ``config/`` file at its
   published widths with the reduced epochs of ``DEEP_EPOCHS``, each with
   its launch counts (K2's top-k for APR and IRGAN, IRGAN's with its item
   bias; nothing for the score blocks of the other four), its steady epoch
   ms per phase and its Recall@10; APR's and IRGAN's rankings held as the
   main path's, the other four's against a copy of the model on the CPU;
   one NeuMF and one CFGAN epoch under ``torch.profiler``;
10. the social slice (``social_phases``): LightGCN on the bf16 joint form
   (``graph.dense.quant=off graph.dense.dual=on``, 2 epochs), then K1's
   bf16-Ŝ route on that run's Ŝ, forward and backward through the model's
   autograd Function against its plain version, bit for bit against
   itself, timed in turns with the JAX package's two bf16 products; LightGCN
   on the legacy int8 form and on ``graph.backend=coo`` (1 epoch each); a
   synthetic lastfm-shaped trust file (``lastfm_trust``: 25,434 directed
   links, clustered, mostly reciprocated) and MHCN, SEPT, BUIR, DiffNet and
   DHCF on it at their published widths with the epochs of
   ``SOCIAL_EPOCHS`` (SEPT's warm-up and joint phase), each with its
   launches, host graph build, steady
   epoch ms per phase, Recall@10/NDCG@10 and K2 ranking checks; MHCN's five
   matrices applied as ``DenseMat`` and as ``DeviceCOO``, timed in turns,
   the latter bit for bit against a repeat; one MHCN and one DHCF epoch
   under ``torch.profiler``;
11. the rest of the social family (``social_rest_phases``): SoRec, SoReg,
   SocialMF, RSTE, LOCABAL, SREE and SocialFD on a FilmTrust-shaped file
   with a FilmTrust-shaped trust file (``filmtrust_trust``: 1,853 links),
   beside UserMean's and ItemMean's MAE/RMSE; SBPR (again under ``-tf``),
   TBPR and ESRF on the lastfm-shaped file with ``lastfm_trust``; each at
   its published widths with the epochs of ``SOCIAL_REST_EPOCHS``, its
   launches (K1 in ESRF's discriminator, K2's top-k for the three rankers,
   no kernel for the rating models), its host build, its steady epoch ms
   per phase and its measures; the rankers' rankings held as the main
   path's; one ESRF adversarial epoch under ``torch.profiler``;
12. the ALS and classical slice (``als_classical_phases``): WRMF, ExpoMF,
   CoFactor and SERec (with ``lastfm_trust``) on the lastfm-shaped file at
   d=20, 3 epochs each (``ALS_EPOCHS``), ranked at top-10 through K2's
   fused top-k and checked as the main path's, CoFactor's SPPMI edges and
   host build, one more WRMF epoch under ``torch.profiler``; UserKNN,
   ItemKNN, SlopeOne, SVD++ and EE (3 epochs each) on the FilmTrust-shaped
   file, their MAE/RMSE beside UserMean's and ItemMean's and the seconds
   of each rating evaluation; SVD++ ranked through K2's bias epilogue;
13. the walk slice (``walk_phases``): CUNE_MF on the FilmTrust-shaped file
   beside UserMean's and ItemMean's MAE/RMSE; CUNE_BPR, IF_BPR (without and
   with a synthetic ``ratings_n.txt``) and RSGAN on the lastfm-shaped file
   with ``lastfm_trust``; each at its published widths with the epochs of
   ``WALK_EPOCHS``, its launches (K2's top-k for the four rankings), its
   host walk build, walkers and pairs, its SGNS steps and seconds per
   channel, its friend top-k ms, its steady epoch and its measures; the
   rankings held as the main path's; RSGAN's pretraining ms and one more
   RSGAN epoch under ``torch.profiler``;
14. the lifecycle slice (``host_and_lifecycle_phases``): the host library
   built; the lastfm- and FilmTrust-shaped files parsed through its
   tokenizer and the plain parser (equal records, both times);
   ``config/LightGCN.conf`` at full width stopped after 3 epochs under
   ``checkpoint.setup=on -every 2`` and resumed to 5, bit for bit against
   the main path's unbroken run, K1's launches those of the resumed epochs;
   ``-save`` then ``-load`` (LightGCN, and SVD ranked through K2's bias
   epilogue on the FilmTrust-shaped file): the same measure lines, K2 once
   a batch of test users and K1 never; CUNE_BPR's walks from the host
   walker against the numpy walker's distribution checks and against
   itself; one LightGCN epoch and ranking under
   ``runtime.profiling.trace``, whose file must name K1's and K2's CUDA
   kernels;
15. planted-block runs that must learn their blocks: LightGCN and SimGCL on
   the dense adjacency, LightGCN and SGL on the sparse one, NGCF, and
   SBPR and ESRF with a trust relation;
16. the ``kernels`` JSON line, the card line, and the final status line.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_BF16 = 989e12  # dense tensor-core bf16 (int8 x bf16 operands of K1)
PEAK_F32 = 67e12  # CUDA-core float32 (K2, K3, K4)
TEMP = 0.2  # SimGCL's fixed temperature and SGL's -temp in config/SGL.conf


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def bound(bytes_moved: float, flops: float, peak: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median CUDA-event times over ``iters`` launches, each after writing a
    256 MB buffer so the 50 MB L2 starts cold (unless ``flush`` is off)."""

    def __init__(self, torch):
        self.torch = torch
        self.scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")

    def ms(self, fn, iters: int = 15, flush: bool = True) -> float:
        return self.paired([fn], iters, flush, hold_cycles=0)[0]

    def paired(self, fns, iters: int = 15, flush: bool = True, hold_cycles: int = 4_000_000):
        """Median CUDA-event times of two or more callables timed in turns
        inside one loop, each launch after the L2 flush, so that drift of
        the card or its host between loops cannot favour one of them. A
        spin kernel of ``hold_cycles`` (about 2 ms) after each flush keeps
        the card busy while the host enqueues the callable, so that the
        time between the events is the card's and not the host's enqueue
        time (an autograd call leaves the card idle behind it)."""
        torch = self.torch
        for fn in fns:
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        pairs = [[] for _ in fns]
        for _ in range(iters):
            for fn, got in zip(fns, pairs):
                if flush:
                    self.scratch.zero_()
                if hold_cycles:
                    torch.cuda._sleep(hold_cycles)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                got.append((start, end))
        torch.cuda.synchronize()
        return [float(np.median([s.elapsed_time(e) for s, e in got])) for got in pairs]


def lastfm_records(seed: int = 0):
    """lastfm-shaped implicit ratings (1,892 users x 17,632 items x 92,834
    interactions, BASELINE.md:12): every user and item at least once, the
    rest with zipf item popularity; unique (user, item) pairs."""
    U_N, I_N, NNZ = 1892, 17632, 92834
    rng = np.random.default_rng(seed)
    u0 = np.concatenate([np.arange(U_N), rng.integers(0, U_N, size=I_N - U_N)])
    i0 = rng.permutation(I_N)
    p = np.arange(1, I_N + 1, dtype=np.float64) ** -0.9
    p /= p.sum()
    u1 = rng.integers(0, U_N, size=NNZ * 2)
    i1 = rng.choice(I_N, size=NNZ * 2, p=p)
    first = u0.astype(np.int64) * I_N + i0
    rest = np.setdiff1d(np.unique(u1.astype(np.int64) * I_N + i1), first)
    rng.shuffle(rest)
    key = np.concatenate([first, rest[: NNZ - len(first)]])
    rng.shuffle(key)
    return (key // I_N).astype(np.int64), (key % I_N).astype(np.int64), U_N, I_N


def yelp_matrix():
    """The 450,884-edge zipf generator of the yelp2018 shape (19,539 users x
    21,266 items), as ``bench.build_yelp_scale`` draws it."""
    U_N, I_N, NNZ = 19539, 21266, 450884
    rng = np.random.default_rng(42)
    u = rng.integers(0, U_N, size=int(NNZ * 1.6))
    p = np.arange(1, I_N + 1, dtype=np.float64) ** -0.9
    p /= p.sum()
    i = rng.choice(I_N, size=len(u), p=p)
    key = np.unique(u.astype(np.int64) * I_N + i)
    rng.shuffle(key)
    key = key[:NNZ]
    return key // I_N, key % I_N, U_N, I_N


def yelp_inputs(torch, K):
    """K1's operands at the yelp2018 shape: binary int8 R from
    :func:`yelp_matrix` in the padded layout of ``DenseJoint``, bf16 layer
    inputs at d=64 (xi with zero rows for the padding's columns), and I."""
    rows, cols, U, I = yelp_matrix()
    g = torch.Generator(device="cuda").manual_seed(2)
    a = torch.zeros((U, K.aligned_width(I)), dtype=torch.int8, device="cuda")
    a[torch.as_tensor(rows, device="cuda"), torch.as_tensor(cols, device="cuda")] = 1
    xu = (torch.randn((U, 64), generator=g, device="cuda") * 0.1).bfloat16()
    xi = torch.zeros((a.shape[1], 64), dtype=torch.bfloat16, device="cuda")
    xi[:I] = (torch.randn((I, 64), generator=g, device="cuda") * 0.1).bfloat16()
    return a, xu, xi, I


def dual_phase(torch, K, timer, label, a, xu, xi, items):
    """K1 on a padded (U, ld) R whose first ``items`` columns are the
    graph's: against its plain version and bit for bit against itself,
    then timed beside its plain version, two bf16 ``torch.matmul`` calls and
    the bound of the function on the logical (U, items) R."""
    U, ld = a.shape
    d = xu.shape[1]
    ou, oi = K.bipartite_dual_matmul(a, xu, xi)
    again = K.bipartite_dual_matmul(a, xu, xi)
    pu, pi = K.bipartite_dual_matmul_plain(a, xu, xi)
    torch.cuda.synchronize()
    err = max((ou - pu).abs().max().item(), (oi - pi).abs().max().item())
    # the same exact bf16 products summed in f32 in another order: allow
    # 1e-5 of the largest output
    scale = max(pu.abs().max().item(), pi.abs().max().item())
    rtol, atol = 1e-5, 1e-5 * scale
    ok = torch.allclose(ou, pu, rtol=rtol, atol=atol) and torch.allclose(oi, pi, rtol=rtol, atol=atol)
    repeat = torch.equal(ou, again[0]) and torch.equal(oi, again[1])
    print(f"[K1 {label}] U={U} I={items} (stored {ld}) d={d} nnz={int((a != 0).sum())} "
          f"max_abs_err={err:.3e} (tolerance rtol {rtol} atol {atol:.3e}) "
          f"{'ok' if ok else 'MISMATCH'}; repeat bit-identical={repeat}", flush=True)
    if not ok:
        fail(f"bipartite_dual_matmul disagrees with its plain version at {label}")
    if not repeat:
        fail(f"bipartite_dual_matmul did not repeat bit for bit at {label}")
    del again, pu, pi, ou, oi
    ms = timer.ms(lambda: K.bipartite_dual_matmul(a, xu, xi))
    warm_ms = timer.ms(lambda: K.bipartite_dual_matmul(a, xu, xi), flush=False)
    plain_ms = timer.ms(lambda: K.bipartite_dual_matmul_plain(a, xu, xi), iters=5)
    rb = a[:, :items].to(torch.bfloat16)
    xb = xi[:items]
    library_ms = timer.ms(lambda: (torch.matmul(rb, xb), torch.matmul(rb.T, xu)))
    del rb
    moved = U * items * 1 + (U + items) * d * 2 + (U + items) * d * 4
    bound_ms, bound_by = bound(moved, 2 * 2 * U * items * d, PEAK_BF16)
    print(f"[K1 {label}] ms={ms:.4f} (L2 flushed) warm_ms={warm_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (2x torch.matmul on a bf16 copy of R) "
          f"bound_ms={bound_ms:.4f} by {bound_by} ({moved / 1e6:.1f} MB, "
          f"{4 * U * items * d / 1e9:.2f} GFLOP)", flush=True)
    return dict(max_abs_err=err, ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def kernels_per_call(torch, fn) -> int:
    """CUDA kernels one call of ``fn`` launches: the kernel nodes of the
    graph that the CUDA runtime's stream capture records from it on a side
    stream (after one call there, uncaptured). torch.profiler is not used
    here: after a profiled epoch it saw none of the ctypes-launched kernels
    of a call."""
    import ctypes

    rt = ctypes.CDLL("libcudart.so.12")
    ptr = ctypes.c_void_p

    def check(err: int, what: str) -> None:
        if err:
            fail(f"kernels_per_call: {what} returned CUDA error {err}")

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()  # scratch that a wrapper keeps per stream exists before the capture
    torch.cuda.synchronize()
    graph = ptr()
    with torch.cuda.stream(stream):
        # cudaStreamCaptureModeRelaxed (2): the caching allocator may still
        # call cudaMalloc while the stream captures
        check(rt.cudaStreamBeginCapture(ptr(stream.cuda_stream), ctypes.c_int(2)),
              "cudaStreamBeginCapture")
        try:
            fn()
        finally:
            check(rt.cudaStreamEndCapture(ptr(stream.cuda_stream), ctypes.byref(graph)),
                  "cudaStreamEndCapture")
    count = ctypes.c_size_t(0)
    check(rt.cudaGraphGetNodes(graph, None, ctypes.byref(count)), "cudaGraphGetNodes")
    nodes = (ptr * count.value)()
    check(rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(count)), "cudaGraphGetNodes")
    kind = ctypes.c_int()
    kernels = 0
    for node in nodes:
        check(rt.cudaGraphNodeGetType(ptr(node), ctypes.byref(kind)), "cudaGraphNodeGetType")
        kernels += kind.value == 0  # cudaGraphNodeTypeKernel
    check(rt.cudaGraphDestroy(graph), "cudaGraphDestroy")
    return kernels


def factored_phase(torch, K, timer, adj, x):
    """The factored entry (one application of the joint adjacency, scales
    fused) on the main path's R and first-layer input: against its plain
    version, bit for bit against the unfused sequence on the card (scale,
    cast, the unscaled kernel, scale: the same sums), its launches per
    application and its time beside the unfused sequence's."""
    U, ld = adj.r.shape
    I, d = adj.num_items, x.shape[1]
    su, si = adj.row_scale[:, None], adj.col_scale[:, None]

    def unfused():
        xi = torch.zeros((ld, d), dtype=torch.bfloat16, device=x.device)
        xi[:I] = (x[U:] * si).bfloat16()
        ou, oi = K.bipartite_dual_matmul(adj.r, (x[:U] * su).bfloat16(), xi)
        return torch.cat([ou * su, oi[:I] * si])

    fused = lambda: K.factored_dual_matmul(adj.r, x, adj.row_scale, adj.col_scale)  # noqa: E731
    y = fused()
    plain = K.factored_dual_matmul_plain(adj.r, x, adj.row_scale, adj.col_scale)
    torch.cuda.synchronize()
    err = (y - plain).abs().max().item()
    atol = 1e-5 * plain.abs().max().item()
    ok = torch.allclose(y, plain, rtol=1e-5, atol=atol)
    same = torch.equal(y, unfused())
    before = K.DUAL.launches
    fused()
    counted = K.DUAL.launches - before
    kernels = kernels_per_call(torch, fused)
    unfused_kernels = kernels_per_call(torch, unfused)
    ms = timer.ms(fused)
    unfused_ms = timer.ms(unfused)
    print(f"[K1 factored] U={U} I={I} d={d} max_abs_err vs plain={err:.3e} (rtol 1e-5 atol "
          f"{atol:.3e}) {'ok' if ok else 'MISMATCH'}; bit-identical to the unfused sequence="
          f"{same}; counted launches per application={counted}; CUDA kernels per application="
          f"{kernels} (unfused sequence {unfused_kernels}); ms={ms:.4f} unfused_ms="
          f"{unfused_ms:.4f} (L2 flushed)", flush=True)
    if not ok:
        fail("factored_dual_matmul disagrees with its plain version")
    if not same:
        fail("factored_dual_matmul differs from the unfused sequence")
    if counted != 1 or kernels > 2:
        fail(f"one factored application took {counted} counted calls and {kernels} kernels")
    return dict(max_abs_err=err, ms=ms, unfused_ms=unfused_ms, kernels=kernels,
                unfused_kernels=unfused_kernels)


def build_inline(K, name: str, source: str):
    """A measurement kernel's CUDA ``source`` built with the port's flags
    into its build directory (named by the source's hash) and loaded with
    ctypes; not part of the port."""
    import ctypes
    import hashlib

    digest = hashlib.sha256((source + " ".join(K.NVCC_FLAGS)).encode()).hexdigest()[:16]
    path = K.BUILD_DIR / f"{name}-{digest}.so"
    if not path.exists():
        K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = K.BUILD_DIR / f"{name}-{digest}.cu"
        src.write_text(source)
        subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS, "-o", str(path), str(src)], check=True,
                       timeout=300)
    return ctypes.CDLL(str(path))


# a streaming read, built beside the port's kernels: every thread reads
# 16-byte words, grid-strided, 4 in flight
L2_READ_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void stream_read(const uint4* __restrict__ p, long n, unsigned* out) {
    const long stride = (long)gridDim.x * blockDim.x;
    unsigned acc = 0;
    for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n; i += 4 * stride) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = i + u * stride < n ? __ldcg(p + i + u * stride) : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
    }
    if (acc == 0x9e3779b9u) *out = acc;  // keeps the loads
}
extern "C" int qrec_stream_read(const void* p, long n, void* out, int blocks, void* stream) {
    stream_read<<<blocks, 256, 0, (cudaStream_t)stream>>>((const uint4*)p, n, (unsigned*)out);
    return (int)cudaGetLastError();
}
"""


def l2_read_rate(torch, K, timer, reads: int = 10) -> float:
    """Bytes per second of a streaming read of an L2-resident buffer: the
    kernel above over 16 and over 32 MB, ``reads`` reads back to back timed
    together after the same reads (so the buffer sits in the 50 MB L2 and a
    launch's own latency is shared), the card held while the host enqueues
    (``Timer.paired``); the faster of the two sizes."""
    import ctypes

    lib = build_inline(K, "stream_read", L2_READ_SOURCE)
    lib.qrec_stream_read.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    blocks = 8 * K._num_sms(torch.device("cuda"))
    rates = {}
    for mbytes in (16, 32):
        buf = torch.ones(mbytes * 2**20 // 4, dtype=torch.float32, device="cuda")

        def read():
            err = lib.qrec_stream_read(buf.data_ptr(), buf.numel() // 4, sink.data_ptr(), blocks,
                                       torch.cuda.current_stream().cuda_stream)
            if err:
                fail(f"stream_read failed with CUDA error {err}")

        ms = timer.paired([lambda: [read() for _ in range(reads)]], flush=False)[0] / reads
        rates[mbytes] = buf.numel() * 4 / (ms / 1e3)
    print("[L2] streaming read of an L2-resident buffer: " + ", ".join(
        f"{mb} MB {r / 1e12:.3f} TB/s" for mb, r in rates.items()), flush=True)
    return max(rates.values())


def segment_check(torch, K, label, x, adj):
    """K5 on ``adj``'s CSR and ``x`` against its plain version (order bound)
    and bit for bit against itself. Returns (out, max_abs_err, Σ|v·x| per
    element)."""
    n, d = x.shape
    e = adj.cols.shape[0]
    deg = adj.indptr.diff()
    csr = (adj.indptr, adj.cols, adj.vals)
    out = K.weighted_segment_matmul(x, *csr, adj.schedule)
    again = K.weighted_segment_matmul(x, *csr, adj.schedule)
    plain = K.weighted_segment_matmul_plain(x, *csr)
    # Σ_e |bf16(v_e) x_e| per element: the scale of every bound below
    absum = K.weighted_segment_matmul_plain(x.abs(), adj.indptr, adj.cols, adj.vals.abs())
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    # the same exact products summed in two f32 orders (lane groups, warps
    # and tiles against index_add_'s atomics): each sum of n terms is within
    # (n-1) 2^-24 sum|terms| of the exact one, so the two within twice that
    order_bound = 2.0 * deg.float()[:, None] * 2.0**-24 * absum
    worst = ((out - plain).abs() / order_bound.clamp_min(1e-30)).max().item()
    ok = bool(((out - plain).abs() <= order_bound).all())
    repeat = torch.equal(out, again)
    counters = int(adj.schedule.counters.abs().sum())
    print(f"[K5 {label}] N={n} E={e} d={d} (x row stride {x.stride(0)}) tile={adj.schedule.tile} "
          f"tiles={adj.schedule.num_tiles} split_rows={int(adj.schedule.split_row.numel())} "
          f"max_degree={int(deg.max())} mean_degree={e / n:.2f} max_abs_err={err:.3e} "
          f"(tolerance 2 deg 2^-24 sum|v*x| per element; worst share of it {worst:.4f}) "
          f"{'ok' if ok else 'MISMATCH'}; repeat bit-identical={repeat}; counters after "
          f"the calls {counters}", flush=True)
    if not ok:
        fail(f"weighted_segment_matmul disagrees with its plain version at {label}")
    if not repeat:
        fail(f"weighted_segment_matmul did not repeat bit for bit at {label}")
    if counters:
        fail(f"weighted_segment_matmul left its split-row counters non-zero at {label}")
    return out, err, absum


def segment_timing(torch, K, timer, label, x, adj, l2_rate):
    """K5 timed in turns with ``torch.sparse.mm`` in one loop
    (``Timer.paired``), warm (the card held too), and its plain version
    alone; the bound, the gather floor (E·d·2 bytes at the L2 read rate)
    and the CUDA kernels of one call (which must be 1)."""
    n, d = x.shape
    e = adj.cols.shape[0]
    csr = (adj.indptr, adj.cols, adj.vals)
    call = lambda: K.weighted_segment_matmul(x, *csr, adj.schedule)  # noqa: E731
    with warnings.catch_warnings():  # sparse CSR tensors are "beta" in PyTorch
        warnings.simplefilter("ignore")
        library = torch.sparse_csr_tensor(adj.indptr, adj.cols, adj.vals.bfloat16().float(),
                                          size=(n, n))
    xf = x.float()
    library_call = lambda: torch.sparse.mm(library, xf)  # noqa: E731
    kernels = kernels_per_call(torch, call)
    ms, library_ms = timer.paired([call, library_call])
    warm_ms = timer.paired([call], flush=False)[0]
    plain_ms = timer.ms(lambda: K.weighted_segment_matmul_plain(x, *csr), iters=5)
    moved = e * 8 + (n + 1) * 4 + n * d * 2 + n * d * 4
    bound_ms, bound_by = bound(moved, 2 * e * d, PEAK_F32)
    floor_ms = e * d * 2 / l2_rate * 1e3
    print(f"[K5 {label}] ms={ms:.4f} library_ms={library_ms:.4f} (L2 flushed, timed in turns in "
          f"one loop; library: torch.sparse.mm, CSR with bf16-rounded values, f32 x) "
          f"warm_ms={warm_ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} by {bound_by} ({moved / 1e6:.1f} MB, {2 * e * d / 1e9:.3f} "
          f"GFLOP) gather_floor_ms={floor_ms:.4f} ({e * d * 2 / 1e6:.1f} MB at the L2 read rate "
          f"{l2_rate / 1e12:.3f} TB/s) CUDA kernels per call={kernels}", flush=True)
    if kernels != 1:
        fail(f"one weighted_segment_matmul call at {label} ran {kernels} CUDA kernels, not 1")
    return dict(ms=ms, warm_ms=warm_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, floor_ms=floor_ms, kernels=kernels)


def lastfm_segment_line(torch, K, timer, model, k1_ms, l2_rate):
    """K5 on the lastfm graph's CSR (the main path's training graph) at the
    main path's width, the operand cast as ``SegmentMatmul`` casts it:
    checked against its plain version, timed beside ``torch.sparse.mm`` and
    K1's time on the same graph (where the dense path should stop). Changes
    no default."""
    from qrec_tpu_torch.data.graph import joint_normalized_adjacency
    from qrec_tpu_torch.ops.spmm import SparseJoint, segment_operand

    adj = SparseJoint.from_host(joint_normalized_adjacency(model.data), "cuda",
                                check_symmetric=False)
    with torch.no_grad():
        x = segment_operand(torch.cat([model.user_emb, model.item_emb]))
    _, err, _ = segment_check(torch, K, "lastfm", x, adj)
    k = segment_timing(torch, K, timer, "lastfm", x, adj, l2_rate)
    print(f"[K5 lastfm] beside K1 lastfm ms={k1_ms:.4f}", flush=True)
    return dict(k, max_abs_err=err)


def scores_phase(torch, K, timer, u, items, bm):
    """K2's scores entry on the main path's first batch of test users
    (their rows gathered): against its plain version, timed beside it and
    the library's product and mask."""
    B, d = u.shape
    I = items.shape[0]
    out = K.masked_catalog_scores(u, items, bm, 0.0)
    plain = K.masked_catalog_scores_plain(u, items, bm, 0.0)
    torch.cuda.synchronize()
    rated = K.expand_bitmask(bm, I)
    err = (out - plain).abs().max().item()
    # f32 dot products of d terms in another order: allow 1e-5 of the
    # largest score
    rtol, atol = 1e-5, 1e-5 * plain.abs().max().item()
    ok = bool((out[rated] == 0).all()) and torch.allclose(out, plain, rtol=rtol, atol=atol)
    print(f"[K2] B={B} I={I} d={d} rated={int(rated.sum())} max_abs_err={err:.3e} "
          f"(masked entries exact, rest rtol {rtol} atol {atol:.3e}) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail("masked_catalog_scores disagrees with its plain version")
    ms = timer.ms(lambda: K.masked_catalog_scores(u, items, bm, 0.0))
    plain_ms = timer.ms(lambda: K.masked_catalog_scores_plain(u, items, bm, 0.0))
    library_ms = timer.ms(lambda: torch.matmul(u, items.T).masked_fill_(rated, 0.0))
    moved = B * d * 4 + I * d * 4 + bm.numel() * 4 + B * I * 4
    bound_ms, bound_by = bound(moved, 2 * B * I * d, PEAK_F32)
    print(f"[K2] ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"(torch.matmul + masked_fill with the bool mask already expanded) "
          f"bound_ms={bound_ms:.4f} by {bound_by} ({moved / 1e6:.1f} MB, "
          f"{2 * B * I * d / 1e9:.2f} GFLOP)", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def scores_then_sort(torch, scores_fn, user_emb, items, bitmask, uids, global_mean, k,
                     item_bias=None, user_bias=None, offset=0.0):
    """One batch ranked without the fused top-k, the reference it must
    equal bit for bit: ``scores_fn`` (K2's scores entry, of this tree or
    another) on the gathered rows, the unseen rows filled, a stable sort of
    every row, the first k columns. (ids, scores). With a bias or an
    offset (a biased score form): the scores entry with an all-zero mask,
    the adds in torch in the kernel's order (``kernels.biased_scores``),
    then the rated mask."""
    from qrec_tpu_torch.ops import kernels as K

    safe = uids.clamp(min=0)
    if item_bias is None and user_bias is None and offset == 0:
        s = scores_fn(user_emb[safe].contiguous(), items, bitmask[safe].contiguous(), 0.0)
    else:
        rows = bitmask[safe]
        s = scores_fn(user_emb[safe].contiguous(), items, torch.zeros_like(rows), 0.0)
        s = K.biased_scores(s, safe, item_bias, user_bias, offset)
        s = s.masked_fill(K.expand_bitmask(rows, items.shape[0]), 0.0)
    s = torch.where((uids < 0)[:, None], torch.full_like(s, global_mean), s)
    vals, ids = torch.sort(s, dim=1, descending=True, stable=True)
    return ids[:, :k].clone(), vals[:, :k].clone()


def unfused_ranking(torch, K, ranker, form, k):
    """A ranker's whole ranking of the score form ``form`` by
    :func:`scores_then_sort`, batch by batch."""
    out = [scores_then_sort(torch, K.masked_catalog_scores, form.user_emb, form.item_emb,
                            ranker.bitmask, ranker._uids[start : start + ranker.batch_size],
                            ranker.global_mean, k, form.item_bias, form.user_bias, form.offset)
           for start in range(0, len(ranker.uids), ranker.batch_size)]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def peak_mib(torch, fn) -> float:
    """Device memory that one call of ``fn`` takes at its peak, above what
    was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def ranking_phase(torch, K, label, model, k):
    """K2's fused top-k on a run's own score form (final factors, and the
    biases of a biased or popularity scorer) and test users, through the
    ranker: bit for bit against the unfused ranking (the scores entry, the
    score form's adds, the mask, then a stable sort), against the plain
    version on the CPU (ids equal but where near-equal scores swap), its
    counters back at 0; the peak device memory of both rankings."""
    from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreForm

    form = model.score_form()
    ranker = CatalogRanker(model.data, k=k, device="cuda", bitmask=model.rated_bitmask,
                           batch_size=model.eval_batch_size)
    V = form.item_emb
    before = K.TOPK.launches
    ids, vals = ranker.topk_device(form)
    calls = K.TOPK.launches - before
    want_ids, want = unfused_ranking(torch, K, ranker, form, k)
    torch.cuda.synchronize()
    same = torch.equal(ids, want_ids) and torch.equal(vals.view(torch.int32), want.view(torch.int32))
    cpu = CatalogRanker(model.data, k=k, device="cpu", bitmask=model.rated_bitmask.cpu(),
                        batch_size=model.eval_batch_size)
    pids, pvals = cpu.topk_device(
        ScoreForm(*(t.cpu() if isinstance(t, torch.Tensor) else t for t in form)))
    rows_equal = (ids.cpu() == pids).all(1)
    gap = (vals.cpu() - pvals).abs().max(1).values
    err = gap.max().item()
    plain_ok = bool((rows_equal | (gap <= 1e-5)).all()) and bool(torch.isfinite(vals).all())
    counters = int(K.masked_catalog_topk_counters(V.device).abs().sum())
    fused_mib = peak_mib(torch, lambda: ranker.topk_device(form))
    unfused_mib = peak_mib(torch, lambda: unfused_ranking(torch, K, ranker, form, k))
    biases = ",".join(n for n, t in (("item_bias", form.item_bias), ("user_bias", form.user_bias),
                                     ("offset", form.offset or None)) if t is not None) or "none"
    print(f"[K2 topk {label}] users={len(ranker.uids)} I={V.shape[0]} d={V.shape[1]} k={k} "
          f"biases={biases} "
          f"launches={calls} bit-identical to the scores entry + stable sort={same}; vs the CPU "
          f"plain version {int(rows_equal.sum())}/{len(rows_equal)} rows identical, max score "
          f"diff {err:.3e} (rows may differ only at near-ties, 1e-5) "
          f"{'ok' if plain_ok else 'MISMATCH'}; counters after the calls {counters}; peak "
          f"device memory of the ranking {fused_mib:.1f} MiB (unfused {unfused_mib:.1f} MiB)",
          flush=True)
    if not same:
        fail(f"masked_catalog_topk differs from the scores entry and a sort at {label}")
    if not plain_ok:
        fail(f"masked_catalog_topk disagrees with its plain version at {label}")
    if counters:
        fail(f"masked_catalog_topk left its counters non-zero at {label}")
    return dict(max_abs_err=err, peak_mib=fused_mib, unfused_peak_mib=unfused_mib)


def topk_timing(torch, K, timer, model, k, label):
    """The fused top-k of the run's score form on one batch of its test
    users (the first ``eval_batch_size``), timed in turns
    (``Timer.paired``) with the unfused path (:func:`scores_then_sort`:
    the scores entry, the form's adds and the mask where it has biases, the
    unseen rows filled, a stable sort, the slice) and the library (the
    gathered rows' ``torch.matmul``, the form's adds, ``masked_fill`` with
    the mask already expanded, ``torch.topk``); its plain version alone;
    the bound; its CUDA kernels per call."""
    from qrec_tpu_torch.ops.topk import CatalogRanker

    form = model.score_form()
    U, V, bm = form.user_emb, form.item_emb, model.rated_bitmask
    extra = dict(item_bias=form.item_bias, user_bias=form.user_bias, offset=form.offset)
    ranker = CatalogRanker(model.data, k=k, device="cuda", bitmask=bm,
                           batch_size=model.eval_batch_size)
    uids = ranker._uids[: ranker.batch_size]
    gm = ranker.global_mean
    B, (I, d) = uids.shape[0], V.shape
    safe = uids.clamp(min=0)
    rated = K.expand_bitmask(bm[safe].contiguous(), I)
    ub = U[safe].contiguous()

    def fused():
        return K.masked_catalog_topk(U, V, bm, uids, gm, k, **extra)

    def unfused():
        return scores_then_sort(torch, K.masked_catalog_scores, U, V, bm, uids, gm, k, **extra)

    def library():
        s = K.biased_scores(torch.matmul(ub, V.T), safe, **extra)
        return torch.topk(s.masked_fill_(rated, 0.0), k)

    kernels = kernels_per_call(torch, fused)
    ms, unfused_ms, library_ms = timer.paired([fused, unfused, library])
    plain_ms = timer.ms(lambda: K.masked_catalog_topk_plain(U, V, bm, uids, gm, k, **extra))
    biased = form.item_bias is not None or form.user_bias is not None or form.offset != 0
    bias_bytes = (I if form.item_bias is not None else 0) * 4 + (B if form.user_bias is not None else 0) * 4
    moved = B * d * 4 + I * d * 4 + B * bm.shape[1] * 4 + B * 8 + B * k * 12 + bias_bytes
    adds = (1 + (form.item_bias is not None) + (form.user_bias is not None)) if biased else 0
    ops = 2 * B * I * d + adds * B * I
    bound_ms, bound_by = bound(moved, ops, PEAK_F32)
    what = " + the score form's adds" if biased else ""
    plan = K._masked_catalog_plan(U.device, B, I, d, k, biased)
    print(f"[K2 topk {label}] B={B} I={I} d={d} k={k} plan={plan} "
          f"ms={ms:.4f} unfused_ms={unfused_ms:.4f} library_ms={library_ms:.4f} (L2 flushed, timed "
          f"in turns in one loop; unfused: the scores entry{what} + where + stable sort + slice; "
          f"library: torch.matmul{what} + masked_fill + torch.topk) plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} by {bound_by} ({moved / 1e6:.2f} MB, "
          f"{ops / 1e9:.3f} GFLOP) share_of_f32_peak="
          f"{ops / PEAK_F32 * 1e3 / ms:.3f} CUDA kernels per call={kernels}", flush=True)
    if kernels != 1:
        fail(f"one masked_catalog_topk call at {label} ran {kernels} CUDA kernels, not 1")
    return dict(ms=ms, unfused_ms=unfused_ms, library_ms=library_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, kernels=kernels)


def infonce_phase(torch, K, timer, label, view1, view2, mask, timed=True):
    """K3 and K4 against their plain versions on normalized ``view1`` /
    ``view2`` and ``mask``; then, if ``timed``, kernel, plain and library
    times with the bounds. Returns (K3 dict, K4 dict)."""
    import torch.nn.functional as F

    from qrec_tpu_torch.ops.losses import _l2n

    with torch.no_grad():
        v1, v2 = _l2n(view1).contiguous(), _l2n(view2).contiguous()
    m = mask.float().contiguous()
    B, d = v1.shape
    loss, lse = K.infonce_fwd(v1, v2, m, m, TEMP)
    dv1, dv2 = K.infonce_bwd(v1, v2, m, m, lse, TEMP)
    ploss, plse = K.infonce_fwd_plain(v1, v2, m, m, TEMP)
    p1, p2 = K.infonce_bwd_plain(v1, v2, m, m, plse, TEMP)
    torch.cuda.synchronize()
    # logits of unit vectors / 0.2 lie in [-5, 5]; K3 sums d products and B
    # exponentials in another order than cuBLAS f32 and logsumexp: 1e-5
    # relative on the loss and lse; the cotangents 1e-4 relative plus 1e-5
    # of the largest
    fwd_err = max(abs(float(loss - ploss)), (lse - plse).abs().max().item())
    bwd_err = max((dv1 - p1).abs().max().item(), (dv2 - p2).abs().max().item())
    fwd_ok = (torch.allclose(loss, ploss, rtol=1e-5, atol=1e-5)
              and torch.allclose(lse, plse, rtol=1e-5, atol=1e-5))
    bwd_ok = all(torch.allclose(g, w, rtol=1e-4, atol=1e-5 * w.abs().max().item())
                 for g, w in ((dv1, p1), (dv2, p2)))
    loss2, lse2 = K.infonce_fwd(v1, v2, m, m, TEMP)
    e1, e2 = K.infonce_bwd(v1, v2, m, m, lse, TEMP)
    repeat = (torch.equal(loss, loss2) and torch.equal(lse, lse2)
              and torch.equal(dv1, e1) and torch.equal(dv2, e2))
    print(f"[K3 {label}] B={B} d={d} masked_rows={int((m == 0).sum())} loss={loss.item():.6f} "
          f"plain={ploss.item():.6f} max_abs_err={fwd_err:.3e} (rtol 1e-5 atol 1e-5) "
          f"{'ok' if fwd_ok else 'MISMATCH'}; repeat bit-identical={repeat}", flush=True)
    print(f"[K4 {label}] max_abs_err={bwd_err:.3e} (rtol 1e-4, atol 1e-5 of the largest "
          f"cotangent) {'ok' if bwd_ok else 'MISMATCH'}", flush=True)
    if not (fwd_ok and bwd_ok):
        fail(f"InfoNCE kernels disagree with their plain versions at {label}")
    if not repeat:
        fail(f"InfoNCE kernels did not repeat bit for bit at {label}")
    k3 = dict(max_abs_err=fwd_err)
    k4 = dict(max_abs_err=bwd_err)
    # one launch a call, its split counters back at 0
    kernels = kernels_per_call(torch, lambda: K.infonce_fwd(v1, v2, m, m, TEMP))
    counters = int(K.infonce_fwd_counters(v1.device).abs().sum())
    print(f"[K3 {label}] plan (bm, tiles per split)={K._infonce_fwd_plan(v1.device, B, B, d)} "
          f"CUDA kernels per call={kernels}; counters after the calls {counters}", flush=True)
    if kernels != 1:
        fail(f"one infonce_fwd call at {label} ran {kernels} CUDA kernels, not 1")
    if counters:
        fail(f"infonce_fwd left its split counters non-zero at {label}")
    if not timed:
        return k3, k4

    cm = (m == 0)[None, :]
    target = torch.arange(B, device=v1.device)

    def library_loss(a, b):
        logits = torch.matmul(a, b.T) / TEMP
        logits = logits.masked_fill(cm, -1e30)
        return (F.cross_entropy(logits, target, reduction="none") * m).sum()

    a1, a2 = v1.clone().requires_grad_(True), v2.clone().requires_grad_(True)
    lib = library_loss(a1, a2)
    # each kernel and its library call in turns inside one loop
    k3["ms"], k3["library_ms"] = timer.paired([
        lambda: K.infonce_fwd(v1, v2, m, m, TEMP), lambda: library_loss(v1, v2)])
    k4["ms"], k4["library_ms"] = timer.paired([
        lambda: K.infonce_bwd(v1, v2, m, m, lse, TEMP),
        lambda: torch.autograd.grad(lib, (a1, a2), retain_graph=True)])
    k3["plain_ms"] = timer.ms(lambda: K.infonce_fwd_plain(v1, v2, m, m, TEMP))
    k4["plain_ms"] = timer.ms(lambda: K.infonce_bwd_plain(v1, v2, m, m, lse, TEMP))
    views, masks = 2 * B * d * 4, 2 * B * 4
    k3["bound_ms"], k3["bound_by"] = bound(views + masks + B * 4 + 4, 2 * B * B * d, PEAK_F32)
    k4["bound_ms"], k4["bound_by"] = bound(views + masks + B * 4 + views, 3 * 2 * B * B * d, PEAK_F32)
    for name, k, gflop, what in (
        ("K3", k3, 2 * B * B * d / 1e9, "torch.matmul + masked_fill + cross_entropy"),
        ("K4", k4, 6 * B * B * d / 1e9, "autograd backward of those calls"),
    ):
        print(f"[{name} {label}] ms={k['ms']:.4f} library_ms={k['library_ms']:.4f} (L2 flushed, "
              f"timed in turns in one loop; library: {what}) plain_ms={k['plain_ms']:.4f} "
              f"bound_ms={k['bound_ms']:.4f} by {k['bound_by']} ({gflop:.2f} GFLOP) "
              f"share_of_f32_peak={gflop * 1e9 / PEAK_F32 * 1e3 / k['ms']:.3f}", flush=True)
    partial_floats = K.INFONCE_BWD.load().qrec_infonce_bwd_scratch(B, B, d, K._num_sms(v1.device))
    print(f"[K4 {label}] partials written and read back: {partial_floats * 4 / 1e6:.2f} MB",
          flush=True)
    return k3, k4


def filmtrust_records(seed: int = 0):
    """FilmTrust-shaped explicit ratings (1,508 users x 2,071 items x
    35,497 ratings on 0.5-4.0 in steps of 0.5, the public dataset's
    counts): every user and item at least once, the rest with zipf item
    popularity; a rating is 3 plus user and item effects and noise,
    rounded to the half-step scale and clipped to it. Unique pairs."""
    U_N, I_N, NNZ = 1508, 2071, 35497
    rng = np.random.default_rng(seed)
    u0 = np.concatenate([np.arange(U_N), rng.integers(0, U_N, size=I_N - U_N)])
    first = u0.astype(np.int64) * I_N + rng.permutation(I_N)
    p = np.arange(1, I_N + 1, dtype=np.float64) ** -0.8
    p /= p.sum()
    more = rng.integers(0, U_N, size=NNZ * 2).astype(np.int64) * I_N + rng.choice(I_N, NNZ * 2, p=p)
    rest = np.setdiff1d(np.unique(more), first)
    rng.shuffle(rest)
    key = np.concatenate([first, rest[: NNZ - len(first)]])
    rng.shuffle(key)
    users, items = key // I_N, key % I_N
    bu, bi = rng.normal(0, 0.5, U_N), rng.normal(0, 0.5, I_N)
    raw = 3.0 + bu[users] + bi[items] + rng.normal(0, 0.5, NNZ)
    ratings = np.clip(np.round(raw * 2) / 2, 0.5, 4.0)
    return users, items, ratings


def mf_phases(torch, K, QRec, timer, tmp, conf_of):
    """The MF slice and the reference's protocols on the card, each driven
    through ``QRec(conf).execute()`` with its launches counted: BPR as
    published (5 epochs of bold-driver SGD on the lastfm-shaped file),
    ranked through K2, one more epoch profiled; SVD on a FilmTrust-shaped
    file as published (rating evaluation, 5 epochs, the per-epoch MAE/RMSE
    and the two result files), then again with ``item.ranking=on -topN
    10`` (K2's bias epilogue: bit for bit against the unfused sequence,
    against the CPU plain version, timed); MostPopular on the lastfm-shaped
    file (K2 with its popularity as the item bias); BPR under ``-cv 5`` (1
    epoch a fold: five folds and the summary file) and under ``-predict``
    with a list of 100 users (the list file only). Returns (K2 launches
    per path, K2 checks, K2 timings)."""
    from qrec_tpu_torch.data.split import cross_validation

    launches, k2r, k2t = {}, {}, {}
    bpr, counts, _ = drive(torch, K, QRec, conf_of("BPR", 5), "bpr")
    launches["bpr"] = counts["masked_catalog_topk"]
    k2r["bpr"] = ranking_phase(torch, K, "bpr", bpr, 10)
    profile_epoch(torch, bpr, "BPR")
    del bpr

    users, items, ratings = filmtrust_records()
    filmtrust = os.path.join(tmp, "filmtrust_like.txt")
    with open(filmtrust, "w") as f:
        f.writelines(f"{a} {b} {r}\n" for a, b, r in zip(users, items, ratings))
    out = os.path.join(tmp, "svd")
    conf = conf_of("SVD", 5)
    conf["ratings"] = filmtrust
    conf["output.setup"] = f"on -dir {out}/"
    svd, counts, rating = drive(torch, K, QRec, conf, "svd rating")
    files = sorted(os.listdir(out))
    print(f"[svd rating] files {files}", flush=True)
    if not (any("-rating-predictions[1].txt" in f for f in files)
            and any("-measure[1].txt" in f for f in files)):
        fail(f"svd rating: the rating-predictions and measure files are missing: {files}")
    if not rating["RMSE"] < 1.5:
        fail(f"svd rating: RMSE {rating['RMSE']} on a 0.5-4.0 scale")
    del svd
    conf["item.ranking"] = "on -topN 10"
    conf["output.setup"] = f"off -dir {out}/"
    svd, counts, _ = drive(torch, K, QRec, conf, "svd ranking")
    launches["svd ranking"] = counts["masked_catalog_topk"]
    k2r["svd biased"] = ranking_phase(torch, K, "svd biased", svd, 10)
    k2t["svd biased"] = topk_timing(torch, K, timer, svd, 10, "svd biased")
    del svd

    pop, counts, _ = drive(torch, K, QRec, conf_of("MostPopular", 1), "mostpopular")
    launches["mostpopular"] = counts["masked_catalog_topk"]
    k2r["mostpopular"] = ranking_phase(torch, K, "mostpopular", pop, 10)
    k2t["mostpopular"] = topk_timing(torch, K, timer, pop, 10, "mostpopular")
    del pop

    out = os.path.join(tmp, "cv")
    conf = conf_of("BPR", 1)
    conf["evaluation.setup"] = "-cv 5 -b 1"
    conf["output.setup"] = f"on -dir {out}/"
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rec = QRec(conf)
    measure = rec.execute()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    folds = list(cross_validation(rec.training_data, 5, binarized=True))
    batches = sum(math.ceil(len({r[0] for r in test}) / rec.model.eval_batch_size)
                  for _, test in folds)
    check_counts("bpr -cv 5", counts, {k.name: 0 for k in K.KERNELS} | {"masked_catalog_topk": batches})
    launches["bpr -cv 5"] = counts["masked_catalog_topk"]
    files = sorted(os.listdir(out))
    print(f"[bpr -cv 5] wall_s={wall:.2f} summary {''.join(measure)!r} files {files}", flush=True)
    lists = [f for f in files if "-top-10items[" in f]
    if len(lists) != 5 or not any(f.endswith("-5-fold-cv.txt") for f in files):
        fail(f"bpr -cv 5: expected five fold lists and the summary file, got {files}")
    recall = float(next(line for line in measure if line.startswith("Recall:")).split(":")[1])
    if not 0 <= recall <= 1:
        fail(f"bpr -cv 5: bad summary {measure}")

    out = os.path.join(tmp, "predict")
    user_list = os.path.join(tmp, "users.txt")
    with open(user_list, "w") as f:
        f.writelines(f"{u}\n" for u in range(100))
    conf = conf_of("BPR", 1)
    conf["evaluation.setup"] = f"-predict {user_list} -b 1"
    conf["output.setup"] = f"on -dir {out}/"
    K.reset_launch_counts()
    measure = QRec(conf).execute()
    counts = K.launch_counts()
    check_counts("bpr -predict", counts, {k.name: 0 for k in K.KERNELS} | {"masked_catalog_topk": 1})
    launches["bpr -predict"] = counts["masked_catalog_topk"]
    files = sorted(os.listdir(out))
    with open(os.path.join(out, files[0])) as f:
        lines = f.readlines()
    print(f"[bpr -predict] measures {measure} files {files} lines {len(lines)}", flush=True)
    if measure != [] or len(files) != 1 or len(lines) != 101 or "*" in "".join(lines[1:]):
        fail("bpr -predict: expected the list file alone, 100 users, no measures")
    return launches, k2r, k2t


# the deep and GAN slice's depth on the card: each config/*.conf at its
# published widths, with these epochs (NeuMF's phases 5, 2, 1; APR's 2, 2)
DEEP_EPOCHS = {"NeuMF": 5, "APR": 4, "IRGAN": 2, "DMF": 2, "CDAE": 100, "CFGAN": 20}
# phases whose loss is one side of a minimax game and need not fall epoch
# by epoch: a GAN's D and G losses; APR's perturbed phase, whose worst-case
# deltas grow with the tables (its loss rises in the JAX package too)
MINIMAX_PHASES = {"APR": (1,), "CFGAN": (0,), "IRGAN": (0,), "RSGAN": (0,)}
# phases checked from their second epoch on: every phase reseeds the
# trainer's generator (seed + 1, as the JAX package's run_training does), so
# SEPT's joint phase starts on the batches its warm-up already trained on,
# and its first epoch's loss can sit below the next one's
RESEEDED_PHASES = {"SEPT": (1,)}


def block_ranking_phase(torch, label, model, k, users: int = 256):
    """A score-block ranking (a model's own scorer, torch ops): the run's
    ranking of its first ``users`` test users against the same form of a
    copy of the model on the CPU (its parameters copied), ids equal but
    where near-equal scores (1e-5) swap; scores finite. No kernel runs."""
    from qrec_tpu_torch.ops.topk import CatalogRanker

    ranker = CatalogRanker(model.data, k=k, device="cuda", bitmask=model.rated_bitmask,
                           batch_size=model.eval_batch_size)
    t0 = time.perf_counter()
    ids, vals = ranker.topk_device(model.score_form())
    torch.cuda.synchronize()
    rank_ms = (time.perf_counter() - t0) * 1e3
    cpu_model = type(model)(model.config, model.data, fold=model.fold, device="cpu")
    cpu_model.load_state_dict({n: t.cpu() for n, t in model.state_dict().items()})
    if model.U is not None:  # final factors (DMF's tower outputs)
        cpu_model.U, cpu_model.V = model.U.cpu(), model.V.cpu()
    cpu = CatalogRanker(model.data, k=k, device="cpu", bitmask=model.rated_bitmask.cpu(),
                        batch_size=model.eval_batch_size)
    form = cpu_model.score_form()
    out = []
    with torch.no_grad():
        for start in range(0, users, cpu.batch_size):
            uids = cpu._uids[start : min(start + cpu.batch_size, users)]
            out.append(cpu._block_topk(form.fn(uids.clamp(min=0)), uids, k))
    pids, pvals = torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])
    rows_equal = (ids[:users].cpu() == pids).all(1)
    gap = (vals[:users].cpu() - pvals).abs().max(1).values
    ok = bool((rows_equal | (gap <= 1e-5)).all()) and bool(torch.isfinite(vals).all())
    print(f"[{label} score block] users={len(ranker.uids)} I={model.num_items} k={k} batch="
          f"{ranker.batch_size} rank_ms={rank_ms:.3f} (torch ops, no kernel); vs the CPU copy "
          f"on the first {users} users: {int(rows_equal.sum())}/{len(rows_equal)} rows identical, "
          f"max score diff {gap.max().item():.3e} (rows may differ only at near-ties, 1e-5) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{label}: the score-block ranking disagrees with the CPU")


def deep_phases(torch, K, QRec, timer, conf_of):
    """The deep and GAN slice on the card: NeuMF, APR, IRGAN, DMF, CDAE and
    CFGAN, each driven through ``QRec(conf).execute()`` with its config at
    its published widths and the depth of ``DEEP_EPOCHS``, its launches
    counted against ``expected_launches`` (K2's top-k for APR and IRGAN,
    no kernel for the four score blocks) and the steady epoch ms of each
    phase printed; APR's and IRGAN's rankings checked as the main path's
    (``ranking_phase``; IRGAN's top-k with its item bias also timed), the
    score-block rankings of NeuMF, DMF, CDAE and CFGAN against the CPU; one
    more NeuMF epoch (the fused phase: host-bound pointwise steps) and one
    more CFGAN epoch (the (I, I) products) under torch.profiler; a summary
    line. Returns (K2 launches per path, K2 checks, K2 timings)."""
    launches, k2r, k2t, summary = {}, {}, {}, {}
    for name, epochs in DEEP_EPOCHS.items():
        label = name.lower()
        t0 = time.perf_counter()
        model, counts, measures = drive(torch, K, QRec, conf_of(name, epochs), label)
        wall = time.perf_counter() - t0
        timers = getattr(model, "phase_timers", None) or [model.timer]
        steady = [round(t.steady_state() * 1e3, 3) for t in timers]
        print(f"[{label}] epochs per phase {[len(t.times) for t in timers]} steady epoch ms per "
              f"phase {steady} (mean after a phase's first epoch)", flush=True)
        summary[name] = dict(wall_s=wall, steady_ms=steady, recall=measures["Recall"],
                             rank_ms=model.rank_seconds * 1e3)
        if name in ("APR", "IRGAN"):
            launches[label] = counts["masked_catalog_topk"]
            k2r[label] = ranking_phase(torch, K, label, model, 10)
            if name == "IRGAN":
                k2t["irgan biased"] = topk_timing(torch, K, timer, model, 10, "irgan biased")
                k2r["irgan biased"] = k2r[label]
        else:
            block_ranking_phase(torch, label, model, 10)
        if name == "NeuMF":
            params = list(model.parameters())
            profile_epoch(torch, model, "NeuMF fused phase", lambda: model.run_training(
                params, model.loss_neu, model.pointwise_sampler(), max_epoch=1))
        elif name == "CFGAN":
            model.max_epoch = 1
            profile_epoch(torch, model, "CFGAN", model.fit_phases)
        del model
    print("[deep] " + " ".join(
        f"{n}: wall_s={v['wall_s']:.2f} steady_ms={v['steady_ms']} Recall@10={v['recall']} "
        f"rank_ms={v['rank_ms']:.3f};" for n, v in summary.items()), flush=True)
    return launches, k2r, k2t


# the social slice's depth on the card (SEPT's 4: one warm-up epoch, then
# three joint ones, the last two on batches no phase has seen)
SOCIAL_EPOCHS = {"MHCN": 2, "SEPT": 4, "BUIR": 2, "DiffNet": 2, "DHCF": 2}


def trust_links(num_users: int, links: int, communities: int, mutual: float, seed: int) -> np.ndarray:
    """A clustered trust relation of ``links`` directed links among
    ``num_users`` users, drawn from ``seed``: ``communities`` communities,
    85% of the pairs inside one, so that triangles (MHCN's and ESRF's
    motifs, SEPT's friend view, TBPR's shared followees) are common; a
    share ``mutual`` of the pairs reciprocated. Returns (links, 2) user
    ids."""
    rng = np.random.default_rng(seed)
    community = rng.permutation(num_users) % communities
    members = [np.flatnonzero(community == c) for c in range(communities)]
    seen, out = set(), []
    while len(out) < links:
        a = int(rng.integers(num_users))
        group = members[community[a]]
        b = int(group[rng.integers(len(group))]) if rng.random() < 0.85 else int(rng.integers(num_users))
        if a == b or (min(a, b), max(a, b)) in seen:
            continue
        seen.add((min(a, b), max(a, b)))
        both = rng.random() < mutual and len(out) + 2 <= links
        out += [(a, b), (b, a)] if both else [(a, b)]
    return np.asarray(out, dtype=np.int64)


def lastfm_trust(seed: int = 0) -> np.ndarray:
    """A lastfm-shaped trust relation: 25,434 directed links among the 1,892
    users (BASELINE.md:12), 59 communities of about 32 users, 90% of the
    pairs reciprocated."""
    return trust_links(1892, 25434, 59, 0.9, seed)


def filmtrust_trust(seed: int = 0) -> np.ndarray:
    """A FilmTrust-shaped trust relation: 1,853 directed links (the public
    file's count of trust statements) among the 1,508 users of
    :func:`filmtrust_records`, 47 communities of about 32 users, half of
    the pairs reciprocated; binary, as FilmTrust's statements are read."""
    return trust_links(1508, 1853, 47, 0.5, seed)


def bf16_phase(torch, K, timer, model, launches):
    """K1's bf16-Ŝ route on the Ŝ that ``DenseJoint(quant=off)`` built for
    ``model`` (LightGCN at d=50): forward and backward through the model's
    autograd Function (``joint_matmul``: one K1 call each way) against the
    plain version, bit for bit against itself; one application timed in
    turns with the JAX package's ``_dense_joint_matmul`` (two bf16 products
    with f32 results, x cast to bf16), its plain version alone, the bound of
    the padded bf16 Ŝ plus x and the result."""
    from qrec_tpu_torch.ops.spmm import joint_matmul

    adj = model.joint_adj
    if adj.form != "off" or adj.r.dtype != torch.bfloat16:
        fail(f"the bf16 run built a {adj.form} {adj.r.dtype} table")
    U, ld = adj.r.shape
    I, d = adj.num_items, model.emb_size
    with torch.no_grad():
        x = torch.cat([model.user_emb, model.item_emb]).contiguous()
    w = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")

    def fwd_bwd():
        xx = x.detach().requires_grad_(True)
        y = joint_matmul(adj, xx)
        y.backward(w)
        return y.detach(), xx.grad

    before = K.DUAL.launches
    y, dx = fwd_bwd()
    calls = K.DUAL.launches - before
    y2, dx2 = fwd_bwd()
    plain = K.factored_dual_matmul_plain(adj.r, x, adj.row_scale, adj.col_scale)
    plain_dx = K.factored_dual_matmul_plain(adj.r, w, adj.row_scale, adj.col_scale)
    torch.cuda.synchronize()
    err = max((y - plain).abs().max().item(), (dx - plain_dx).abs().max().item())
    ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())
             for a, b in ((y, plain), (dx, plain_dx)))
    repeat = torch.equal(y, y2) and torch.equal(dx, dx2)
    rb = adj.r[:, :I]

    def one():
        return K.factored_dual_matmul(adj.r, x, adj.row_scale, adj.col_scale)

    def library():
        xu, xi = x[:U].bfloat16(), x[U:].bfloat16()
        return (torch.mm(rb, xi, out_dtype=torch.float32),
                torch.mm(rb.T, xu, out_dtype=torch.float32))

    ms, library_ms = timer.paired([one, library])
    fwd_bwd_ms = timer.ms(fwd_bwd)
    plain_ms = timer.ms(lambda: K.factored_dual_matmul_plain(adj.r, x, adj.row_scale,
                                                             adj.col_scale), iters=5)
    moved = U * ld * 2 + 2 * (U + I) * d * 4
    bound_ms, bound_by = bound(moved, 2 * 2 * U * I * d, PEAK_BF16)
    print(f"[K1 bf16-S lastfm] U={U} I={I} (stored {ld}) d={d} bf16 table {U * ld * 2 / 1e6:.1f} MB; "
          f"forward and backward through joint_matmul: {calls} counted calls, max_abs_err vs plain="
          f"{err:.3e} (rtol 1e-5, atol 1e-5 of the largest) {'ok' if ok else 'MISMATCH'}; repeat "
          f"bit-identical={repeat}; ms={ms:.4f} library_ms={library_ms:.4f} (one application, L2 "
          f"flushed, median of 15, timed in turns; library: 2x torch.mm bf16 -> f32) fwd_bwd_ms="
          f"{fwd_bwd_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} by {bound_by} "
          f"({moved / 1e6:.1f} MB) launches on the bf16 run={launches}", flush=True)
    if calls != 2:
        fail(f"forward and backward of the bf16 form took {calls} K1 calls, not 2")
    if not ok:
        fail("K1 on the bf16 table disagrees with its plain version")
    if not repeat:
        fail("K1 on the bf16 table did not repeat bit for bit")
    return dict(max_abs_err=err, ms=ms, library_ms=library_ms, plain_ms=plain_ms,
                fwd_bwd_ms=fwd_bwd_ms, bound_ms=bound_ms, bound_by=bound_by)


def aux_forms_phase(torch, timer, model):
    """MHCN's five matrices (h_s, h_j, h_p, r, rᵀ) at the lastfm shape, one
    application forward and backward as ``DenseMat`` (bf16, cuBLAS) and as
    ``DeviceCOO`` (f32 gather and segment sum), timed in turns; the COO
    product and gradient bit for bit against a repeat and within 1e-5 of
    the CPU's. Returns {matrix: (dense_ms, coo_ms)}."""
    from qrec_tpu_torch.ops.spmm import DenseMat, DeviceCOO, spmm

    r = model.joint_r()
    mats = dict(zip(("h_s", "h_j", "h_p"), model.motif_matrices()), r=r, rt=r.T.tocsr())
    g = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for key, m in mats.items():
        dense, coo = DenseMat.from_scipy(m, "cuda"), DeviceCOO.from_scipy(m, "cuda")
        x = torch.randn((m.shape[1], 50), generator=g, device="cuda") * 0.1
        w = torch.randn((m.shape[0], 50), generator=g, device="cuda")

        def apply(op, x=x, w=w):
            xx = x.detach().requires_grad_(True)
            y = spmm(op, xx)
            y.backward(w)
            return y.detach(), xx.grad

        y1, g1 = apply(coo)
        y2, g2 = apply(coo)
        cpu = DeviceCOO.from_scipy(m, "cpu")
        yc, gc = apply(cpu, x.cpu(), w.cpu())
        repeat = torch.equal(y1, y2) and torch.equal(g1, g2)
        cpu_ok = all(torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-5 * max(b.abs().max().item(), 1e-30))
                     for a, b in ((y1, yc), (g1, gc)))
        yd, _ = apply(dense)
        gap = (yd - y1).abs().max().item()
        dense_ms, coo_ms = timer.paired([lambda: apply(dense), lambda: apply(coo)])
        out[key] = (dense_ms, coo_ms)
        print(f"[aux {key}] {m.shape[0]}x{m.shape[1]} nnz={m.nnz} d=50 forward+backward: "
              f"DenseMat ms={dense_ms:.4f} ({m.shape[0] * m.shape[1] * 2 / 1e6:.1f} MB bf16) "
              f"DeviceCOO ms={coo_ms:.4f} (L2 flushed, in turns); DeviceCOO repeat bit-identical="
              f"{repeat}, within 1e-5 of the CPU={cpu_ok}; max |DenseMat - DeviceCOO| {gap:.3e} "
              f"(bf16 storage and x)", flush=True)
        if not repeat:
            fail(f"DeviceCOO did not repeat bit for bit on MHCN's {key}")
        if not cpu_ok:
            fail(f"DeviceCOO on the card disagrees with the CPU on MHCN's {key}")
    return out


def social_phases(torch, K, QRec, timer, conf_of, trust_path):
    """The social slice: LightGCN on the bf16 form (2 epochs, then K1's
    bf16-Ŝ route, :func:`bf16_phase`), on the legacy int8 form and on
    ``graph.backend=coo`` (1 epoch each); then MHCN, SEPT, BUIR, DiffNet and
    DHCF on the lastfm-shaped file with :func:`lastfm_trust`, at their
    published widths with the epochs of ``SOCIAL_EPOCHS`` (SEPT's 4 run its
    warm-up and its joint phase), each with its launches against
    ``expected_launches``, its host graph build apart from its epochs, its
    steady epoch ms per phase, and its ranking checked as the main path's;
    MHCN's matrices as ``DenseMat`` and as ``DeviceCOO``
    (:func:`aux_forms_phase`); one more MHCN and DHCF epoch under
    torch.profiler. Returns (K1 bf16 dict, bf16 run's K1
    launches, K2 launches per path, K2 checks)."""
    from qrec_tpu_torch.ops.spmm import DenseMat, DeviceCOO

    forms = (("lightgcn-bf16", {"graph.dense.quant": "off", "graph.dense.dual": "on"}, 2),
             ("lightgcn-int8", {"graph.dense.quant": "int8"}, 1),
             ("lightgcn-coo", {"graph.backend": "coo"}, 1))
    launches, k2r = {}, {}
    for label, extra, epochs in forms:
        conf = conf_of("LightGCN", epochs)
        for key, value in extra.items():
            conf[key] = value
        model, counts, _ = drive(torch, K, QRec, conf, label)
        launches[label] = counts["masked_catalog_topk"]
        if label == "lightgcn-bf16":
            k1b_launches = counts["bipartite_dual_matmul"]
            k1b = bf16_phase(torch, K, timer, model, k1b_launches)
        del model
    summary = {}
    for name, epochs in SOCIAL_EPOCHS.items():
        conf = conf_of(name, epochs)
        if conf.contains("social"):
            conf["social"] = trust_path
        label = name.lower()
        model, counts, measures = drive(torch, K, QRec, conf, label)
        timers = getattr(model, "phase_timers", None) or [model.timer]
        steady = [round(t.steady_state() * 1e3, 3) for t in timers]
        social = model.social.trustSize() if model.social is not None else None
        ops = [
            f"{k}=DenseMat({v.mat.shape[0]}x{v.mat.shape[1]})" if isinstance(v, DenseMat)
            else f"{k}=DeviceCOO({v.num_rows}x{v.num_cols}, nnz={v.rows.numel()})"
            for k, v in vars(model).items() if isinstance(v, (DenseMat, DeviceCOO))
        ]
        print(f"[{label}] auxiliary operators {' '.join(ops)}", flush=True)
        print(f"[{label}] trust (users, links)={social} host graph build s={model.graph_seconds:.3f} "
              f"(before the epochs) epochs per phase {[len(t.times) for t in timers]} steady epoch "
              f"ms per phase {steady} (mean after a phase's first epoch) U width="
              f"{model.U.shape[1]}", flush=True)
        summary[name] = dict(steady_ms=steady, recall=measures["Recall"], ndcg=measures["NDCG"],
                             rank_ms=model.rank_seconds * 1e3, graph_s=model.graph_seconds)
        launches[label] = counts["masked_catalog_topk"]
        k2r[label] = ranking_phase(torch, K, label, model, 10)
        if name == "MHCN":
            aux_forms_phase(torch, timer, model)
        if name in ("MHCN", "DHCF"):
            profile_epoch(torch, model, name)
        del model
    print("[social] " + " ".join(
        f"{n}: steady_ms={v['steady_ms']} Recall@10={v['recall']} NDCG@10={v['ndcg']} "
        f"rank_ms={v['rank_ms']:.3f} graph_s={v['graph_s']:.3f};" for n, v in summary.items()),
        flush=True)
    return k1b, k1b_launches, launches, k2r


# the rest of the social family's depth on the card, each config/ file at
# its published widths: 3 epochs of the rating models, SBPR (1 more under
# -tf) and TBPR; ESRF's 3 are one epoch a phase. LOCABAL takes 2: on the
# FilmTrust-shaped file its third epoch diverges in both packages (the bold
# driver raises the rate to 0.021 and the JAX package's loss goes from
# 23,533 to 175,296, the port's to NaN, which ends a run)
SOCIAL_REST_EPOCHS = {"SoRec": 3, "SoReg": 3, "SocialMF": 3, "RSTE": 3, "LOCABAL": 2,
                      "SREE": 3, "SocialFD": 3, "SBPR": 3, "SBPR -tf": 1, "TBPR": 3, "ESRF": 3}


def social_rest_phases(torch, K, QRec, conf_of, tmp, trust_path):
    """The rest of the social family: the seven social MF rating models on
    a FilmTrust-shaped file (:func:`filmtrust_records` with
    :func:`filmtrust_trust`), beside UserMean's and ItemMean's MAE/RMSE on
    the same split; SBPR (again under ``-tf``), TBPR and ESRF on the
    lastfm-shaped file with :func:`lastfm_trust`. Each ``config/`` file at
    its published widths with the epochs of ``SOCIAL_REST_EPOCHS``, driven
    through ``QRec(conf).execute()`` with its launches against
    ``expected_launches`` (K1 in ESRF, K2's top-k for the rankers, no
    kernel for the rating models), its host build (edge similarities,
    PageRank, friend items, tie sets, motifs) apart from its epochs, its
    steady epoch ms per phase and its measures; the rankers' rankings
    checked as the main path's (``ranking_phase``); one more ESRF
    adversarial epoch under torch.profiler. Returns (ESRF's K1 launches,
    K2 launches per path, K2 checks)."""
    users, items, ratings = filmtrust_records()
    filmtrust = os.path.join(tmp, "filmtrust_social.txt")
    with open(filmtrust, "w") as f:
        f.writelines(f"{a} {b} {r}\n" for a, b, r in zip(users, items, ratings))
    film_trust = os.path.join(tmp, "filmtrust_trust.txt")
    with open(film_trust, "w") as f:
        f.writelines(f"{a} {b} 1\n" for a, b in filmtrust_trust())
    baseline = {}
    for name in ("UserMean", "ItemMean"):
        conf = conf_of(name, 1)
        conf["ratings"] = filmtrust
        _, _, baseline[name] = drive(torch, K, QRec, conf, name.lower())
    launches, k2r, summary = {}, {}, {}
    k1 = 0
    for key, epochs in SOCIAL_REST_EPOCHS.items():
        name = key.split()[0]
        conf = conf_of(name, epochs)
        ranked = conf.options("item.ranking").isMainOn()
        if not ranked:
            conf["ratings"] = filmtrust
        conf["social"] = trust_path if ranked else film_trust
        if key.endswith("-tf"):
            conf["evaluation.setup"] = conf["evaluation.setup"] + " -tf"
        label = key.lower().replace(" ", "")
        model, counts, measures = drive(torch, K, QRec, conf, label)
        timers = getattr(model, "phase_timers", None) or [model.timer]
        steady = [round(t.steady_state() * 1e3, 3) for t in timers]
        print(f"[{label}] trust (users, links)={model.social.trustSize()} host build s="
              f"{model.graph_seconds:.3f} (before the epochs) epochs per phase "
              f"{[len(t.times) for t in timers]} steady epoch ms per phase {steady} (mean after a "
              f"phase's first epoch)", flush=True)
        summary[key] = dict(steady_ms=steady, graph_s=model.graph_seconds, **measures)
        if ranked:
            launches[label] = counts["masked_catalog_topk"]
            k2r[label] = ranking_phase(torch, K, label, model, 10)
        else:
            print(f"[{label}] MAE={measures['MAE']} RMSE={measures['RMSE']} beside UserMean "
                  f"{baseline['UserMean']['MAE']}/{baseline['UserMean']['RMSE']} and ItemMean "
                  f"{baseline['ItemMean']['MAE']}/{baseline['ItemMean']['RMSE']} on the same split",
                  flush=True)
        if name == "ESRF":
            k1 = counts["bipartite_dual_matmul"]
            gen = torch.Generator(device="cuda").manual_seed(0)
            d_opt, g_opt = model.optimizers()
            profile_epoch(torch, model, "ESRF adversarial", lambda: model.run_phase(
                2, 1, gen, d_opt, g_opt, model.pairwise_sampler()))
        del model
    print("[social rest] " + " ".join(
        f"{k}: steady_ms={v['steady_ms']} graph_s={v['graph_s']:.3f} "
        + (f"Recall@10={v['Recall']} NDCG@10={v['NDCG']};" if "Recall" in v
           else f"MAE={v['MAE']} RMSE={v['RMSE']};") for k, v in summary.items()), flush=True)
    return k1, launches, k2r


# the ALS and classical slice's depth on the card, each config/ file at
# its published widths (d=20 for the ALS models, d=10 for SVD++ and EE)
ALS_EPOCHS = {"WRMF": 3, "ExpoMF": 3, "CoFactor": 3, "SERec": 3}
CLASSICAL_EPOCHS = {"UserKNN": 1, "ItemKNN": 1, "SlopeOne": 1, "SVD++": 3, "EE": 3}


def als_classical_phases(torch, K, QRec, conf_of, tmp, trust_path):
    """The ALS and classical slice: WRMF, ExpoMF, CoFactor and SERec (with
    :func:`lastfm_trust`) on the lastfm-shaped file, top-10 rankings through
    K2 checked as the main path's (``ranking_phase``), CoFactor's SPPMI edge
    count and host build, one more WRMF epoch under torch.profiler;
    UserKNN, ItemKNN, SlopeOne, SVD++ and EE on a FilmTrust-shaped file
    (rating evaluation) beside UserMean's and ItemMean's MAE/RMSE on the
    same split, with the seconds of the whole rating evaluation (the
    memory-based models' only cost); then SVD++ ranked at top-10 through
    K2's bias epilogue. Each ``config/`` file at its published widths with
    the epochs of ``ALS_EPOCHS`` and ``CLASSICAL_EPOCHS``, driven through
    ``QRec(conf).execute()`` with its launches against
    ``expected_launches``. Returns (K2 launches per path, K2 checks)."""
    launches, k2r, summary = {}, {}, {}
    for name, epochs in ALS_EPOCHS.items():
        conf = conf_of(name, epochs)
        if name == "SERec":
            conf["social"] = trust_path
        label = name.lower()
        model, counts, measures = drive(torch, K, QRec, conf, label)
        steady = model.timer.steady_state() * 1e3
        summary[name] = dict(steady_ms=steady, Recall=measures["Recall"], NDCG=measures["NDCG"])
        if name == "CoFactor":
            print(f"[cofactor] SPPMI edges E={model.sppmi_edges} host build s="
                  f"{model.graph_seconds:.3f} (before the epochs) context blocks "
                  f"{model.sppmi_edges * model.emb_size ** 2 * 4 / 1e6:.1f} MB", flush=True)
            summary[name]["edges"] = model.sppmi_edges
        launches[label] = counts["masked_catalog_topk"]
        k2r[label] = ranking_phase(torch, K, label, model, 10)
        if name == "WRMF":
            profile_epoch(torch, model, "WRMF", lambda: model.epoch(model.tables))
        del model

    users, items, ratings = filmtrust_records()
    filmtrust = os.path.join(tmp, "filmtrust_classical.txt")
    with open(filmtrust, "w") as f:
        f.writelines(f"{a} {b} {r}\n" for a, b, r in zip(users, items, ratings))
    baseline = {}
    for name in ("UserMean", "ItemMean"):
        conf = conf_of(name, 1)
        conf["ratings"] = filmtrust
        _, _, baseline[name] = drive(torch, K, QRec, conf, name.lower())
    for name, epochs in CLASSICAL_EPOCHS.items():
        conf = conf_of(name, epochs)
        conf["ratings"] = filmtrust
        label = name.lower()
        model, _, measures = drive(torch, K, QRec, conf, label)
        summary[name] = dict(measures, eval_s=model.rating_seconds)
        if model.timer is not None:
            summary[name]["steady_ms"] = model.timer.steady_state() * 1e3
        print(f"[{label}] MAE={measures['MAE']} RMSE={measures['RMSE']} beside UserMean "
              f"{baseline['UserMean']['MAE']}/{baseline['UserMean']['RMSE']} and ItemMean "
              f"{baseline['ItemMean']['MAE']}/{baseline['ItemMean']['RMSE']} on the same split; "
              f"rating evaluation s={model.rating_seconds:.3f} ({len(model.data.test_data)} test "
              f"ratings)", flush=True)
        del model
    conf = conf_of("SVD++", CLASSICAL_EPOCHS["SVD++"])
    conf["ratings"] = filmtrust
    conf["item.ranking"] = "on -topN 10"
    model, counts, _ = drive(torch, K, QRec, conf, "svd++ ranking")
    launches["svd++ ranking"] = counts["masked_catalog_topk"]
    k2r["svd++ biased"] = ranking_phase(torch, K, "svd++ biased", model, 10)
    del model
    print("[als classical] " + " ".join(
        f"{k}: " + " ".join(f"{m}={v:.4f}" if isinstance(v, float) else f"{m}={v}"
                            for m, v in d.items()) + ";" for k, d in summary.items()), flush=True)
    return launches, k2r


# the walk slice's depth on the card, each config/ file at its published
# widths (CUNE_MF d=10 on the FilmTrust shape; CUNE_BPR and IF_BPR d=10,
# RSGAN d=50 on the lastfm shape)
WALK_EPOCHS = {"CUNE_MF": 3, "CUNE_BPR": 3, "IF_BPR": 3, "RSGAN": 3}


def negative_feedback_file(ratings: str, seed: int = 0) -> str:
    """A copy of the rating file with a synthetic ``<ratings>_n.txt``
    beside it: ten items per user that the user did not rate, drawn with
    numpy from ``seed``. Returns the copy's path."""
    rows = np.loadtxt(ratings, dtype=np.int64, usecols=(0, 1))
    users, items = rows[:, 0], rows[:, 1]
    num_items = int(items.max()) + 1
    rated = set((users * num_items + items).tolist())
    rng = np.random.default_rng(seed)
    lines = []
    for u in np.unique(users):
        picks = [i for i in rng.integers(0, num_items, size=40).tolist() if u * num_items + i not in rated]
        lines += [f"{u} {i} 1\n" for i in dict.fromkeys(picks).keys()][:10]
    copy = os.path.join(os.path.dirname(ratings), "ifbpr_negative.txt")
    shutil.copyfile(ratings, copy)
    with open(copy[:-4] + "_n.txt", "w") as f:
        f.writelines(lines)
    return copy


def walk_stats_line(label: str, stats: dict) -> str:
    """The walk pipeline's numbers: the host seconds of the network and
    walk build, the walkers kept (by meta-path for IF_BPR's channels) and
    the pairs, each SGNS channel's steps and seconds, the friend top-k's
    ms."""
    sgns = " ".join(f"channel {c}: {steps} steps {sec:.3f} s ({sec / steps * 1e3:.3f} ms a step)"
                    for c, (steps, sec) in enumerate(stats["sgns"]))
    return (f"[{label}] walks: host build s={stats['walk_s']:.3f} walkers kept={stats['walkers']} "
            f"pairs={stats['pairs']}; SGNS {sgns}; friend top-k ms={stats['topk_ms']:.3f}")


def walk_phases(torch, K, QRec, conf_of, tmp, trust_path):
    """The walk slice: CUNE_MF on a FilmTrust-shaped file beside UserMean's
    and ItemMean's MAE/RMSE on the same split; CUNE_BPR on the lastfm-shaped
    file; IF_BPR with :func:`lastfm_trust`, once without negative feedback
    and once with the synthetic ``_n.txt`` of :func:`negative_feedback_file`
    (its negative channel, the neg tier and the true friends); RSGAN with
    :func:`lastfm_trust`, its 30 pretraining steps timed. Each ``config/``
    file at its published widths with the epochs of ``WALK_EPOCHS``, driven
    through ``QRec(conf).execute()`` with its launches against
    ``expected_launches`` (K2's top-k for the four rankings, none for
    CUNE_MF), its walk, SGNS and friend top-k numbers, its steady epoch and
    its measures; the rankings checked as the main path's
    (``ranking_phase``); one more RSGAN epoch under torch.profiler. Returns
    (K2 launches per path, K2 checks)."""
    users, items, ratings = filmtrust_records()
    filmtrust = os.path.join(tmp, "filmtrust_walk.txt")
    with open(filmtrust, "w") as f:
        f.writelines(f"{a} {b} {r}\n" for a, b, r in zip(users, items, ratings))
    baseline = {}
    for name in ("UserMean", "ItemMean"):
        conf = conf_of(name, 1)
        conf["ratings"] = filmtrust
        _, _, baseline[name] = drive(torch, K, QRec, conf, name.lower())
    launches, k2r, summary = {}, {}, {}
    negative = None
    for key in ("CUNE_MF", "CUNE_BPR", "IF_BPR", "IF_BPR negative", "RSGAN"):
        name = key.split()[0]
        conf = conf_of(name, WALK_EPOCHS[name])
        if name == "CUNE_MF":
            conf["ratings"] = filmtrust
        if name in ("IF_BPR", "RSGAN"):
            conf["social"] = trust_path
        if key.endswith("negative"):
            negative = negative or negative_feedback_file(conf["ratings"])
            conf["ratings"] = negative
        label = key.lower().replace(" ", "-")
        model, counts, measures = drive(torch, K, QRec, conf, label)
        steady = model.timer.steady_state() * 1e3
        print(walk_stats_line(label, model.walk_stats), flush=True)
        print(f"[{label}] host build s={model.graph_seconds:.3f} (walks, SGNS, friends and tables, "
              f"before the epochs) steady epoch ms={steady:.3f} (mean after the first epoch)",
              flush=True)
        summary[key] = dict(steady_ms=steady, graph_s=model.graph_seconds, **measures)
        if name == "CUNE_MF":
            print(f"[{label}] MAE={measures['MAE']} RMSE={measures['RMSE']} beside UserMean "
                  f"{baseline['UserMean']['MAE']}/{baseline['UserMean']['RMSE']} and ItemMean "
                  f"{baseline['ItemMean']['MAE']}/{baseline['ItemMean']['RMSE']} on the same split",
                  flush=True)
            del model
            continue
        if name == "IF_BPR":
            friends = model.friends
            print(f"[{label}] negative feedback pairs={len(friends.negative[0])} negative channel="
                  f"{friends.n_ids is not None} tier entries joint/ps/neg="
                  f"{[int(t[1].numel()) for t in model.tables]}", flush=True)
            if key.endswith("negative") and (friends.n_ids is None or model.tables[2][1].numel() == 0):
                fail(f"{label}: the negative channel or tier is empty")
        launches[label] = counts["masked_catalog_topk"]
        k2r[label] = ranking_phase(torch, K, label, model, 10)
        if name == "RSGAN":
            summary[key]["pretrain_ms"] = model.pretrain_timer.last * 1e3
            print(f"[{label}] generator pretraining: {model.pretrain_steps} full-profile steps in "
                  f"{model.pretrain_timer.last * 1e3:.3f} ms, losses {model.pretrain_losses[0]:.4f} -> "
                  f"{model.pretrain_losses[-1]:.4f}", flush=True)
            gen = torch.Generator(device="cuda").manual_seed(0)
            g_opt, d_opt = model.optimizers()
            sampler = model.pairwise_sampler()
            profile_epoch(torch, model, "RSGAN", lambda: model.train_epoch(gen, g_opt, d_opt, sampler(gen)))
        del model
    print("[walk] " + " ".join(
        f"{k}: " + " ".join(f"{m}={v:.4f}" if isinstance(v, float) else f"{m}={v}"
                            for m, v in d.items()) + ";" for k, d in summary.items()), flush=True)
    return launches, k2r


def walk_distribution(net, walks, active, walk_count) -> float:
    """Total variation between the nodes a walker visits (steps 1 to L-1,
    pooled) and their expectation under the weighted transition matrix
    from ``walk_count`` walkers at every active node; every step must
    follow an edge (else 1.0)."""
    import scipy.sparse as sp

    if walks.shape[1] > 1 and not np.all(
            np.asarray(net[walks[:, :-1].ravel(), walks[:, 1:].ravel()]).ravel() > 0):
        return 1.0
    deg = np.asarray(net.sum(axis=1)).ravel()
    step = (sp.diags(1.0 / np.maximum(deg, 1e-30)) @ net).T.tocsr()
    x = np.zeros(net.shape[0])
    x[active] = walk_count
    expected = np.zeros(net.shape[0])
    seen = np.zeros(net.shape[0])
    for k in range(1, walks.shape[1]):
        x = step @ x
        expected += x
        seen += np.bincount(walks[:, k], minlength=net.shape[0])
    return float(0.5 * np.abs(seen / seen.sum() - expected / expected.sum()).sum())


def host_and_lifecycle_phases(torch, K, QRec, conf_of, tmp, card, unbroken):
    """The lifecycle slice: the host library, resume, save/load and the trace.

    * the host library built (g++), then the lastfm- and FilmTrust-shaped
      files parsed through its tokenizer (``io.load_ratings``) and through
      the plain regex parser: equal records, both parse times;
    * LightGCN (``config/LightGCN.conf`` at full width) under
      ``checkpoint.setup=on -every 2``: stopped after 3 epochs, resumed to
      5 from the checkpoint of epoch 2, with ``model.setup=-save``; its
      final ``U``/``V`` and epoch losses bit for bit against ``unbroken``
      (the main path's 5-epoch run), K1's launches those of the resumed
      epochs; then a fresh session with ``-load``: the same measure lines,
      K2's top-k launched once a batch of test users, K1 never;
    * SVD on the FilmTrust-shaped file, ranked (K2's bias epilogue), saved
      and loaded the same way;
    * CUNE_BPR's walks on the lastfm-shaped file from the host walker and
      from the plain numpy walker: every step along an edge, the visits'
      distance from their expectation under the edge weights (both below
      0.05 and within 0.01 of each other), the host walker repeating
      itself on the same seed; both walk times;
    * one LightGCN epoch and one ranking under ``runtime.profiling.trace``:
      the trace file names K1's (``dual_regions``) and K2's
      (``catalog_tiles``) CUDA kernels.

    Returns (K1 launches of the stopped and resumed runs, K2 launches per
    path)."""
    from qrec_tpu_torch import io as tio
    from qrec_tpu_torch import native
    from qrec_tpu_torch.config import OptionConf
    from qrec_tpu_torch.data.dataset import Interactions
    from qrec_tpu_torch.ops import walks as W
    from qrec_tpu_torch.ops.topk import CatalogRanker
    from qrec_tpu_torch.runtime import trainer as T
    from qrec_tpu_torch.runtime.profiling import trace

    t0 = time.perf_counter()
    lib = native.build()
    print(f"[host] library {os.path.relpath(lib, REPO)} built or found in "
          f"{time.perf_counter() - t0:.3f} s (g++ -O3; host time; card: {card})", flush=True)
    users, items, ratings = filmtrust_records()
    filmtrust = os.path.join(tmp, "filmtrust_host.txt")
    with open(filmtrust, "w") as f:
        f.writelines(f"{a} {b} {r}\n" for a, b, r in zip(users, items, ratings))
    rated = conf_of("SVD", 1)
    rated["ratings"] = filmtrust
    for label, conf in (("lastfm", conf_of("LightGCN", 1)), ("filmtrust", rated)):
        evaluation = OptionConf(conf["evaluation.setup"])
        binarized = evaluation.contains("-b")
        threshold = float(evaluation["-b"]) if binarized else 0.0
        order = [int(c) for c in OptionConf(conf["ratings.setup"])["-columns"].split()]
        routes = {
            "tokenizer": lambda: native.parse_ratings(conf["ratings"], *order, binarized, threshold),
            "load_ratings": lambda: tio.load_ratings(conf, conf["ratings"], binarized, threshold),
            "plain": lambda: tio.parse_ratings_plain(conf["ratings"], *order, binarized, threshold),
        }
        # in turns, three rounds, each after a full garbage collection: the
        # records are 100 k small lists, and a collection that one route's
        # allocations set off walks every object of this long process
        seconds = {name: [] for name in routes}
        for _ in range(3):
            for name, parse in routes.items():
                gc.collect()
                t0 = time.perf_counter()
                out = parse()
                seconds[name].append(time.perf_counter() - t0)
                if name == "load_ratings":
                    fast = out
                elif name == "plain":
                    plain = out
        med = {name: float(np.median(v)) for name, v in seconds.items()}
        print(f"[host parse {label}] records={len(fast)} median of 3 in turns after gc.collect(): "
              f"the tokenizer alone s={med['tokenizer']:.4f}, load_ratings through it (with the "
              f"Python records) s={med['load_ratings']:.4f}, the plain parser s={med['plain']:.4f}; "
              f"all rounds {json.dumps({k: [round(x, 4) for x in v] for k, v in seconds.items()})} "
              f"equal={fast == plain} (host times; card: {card})", flush=True)
        if fast != plain or not fast:
            fail(f"host parse {label}: the tokenizer's records differ from the plain parser's")

    # resume at full width, then save and load
    def checked_run(label, conf, expect):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rec = QRec(conf)
        measure = rec.execute()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        print(f"[{label}] wall_s={wall:.2f} measures {''.join(measure)!r} (card: {card})", flush=True)
        check_counts(label, counts, expect(rec.model))
        return rec.model, measure, counts

    zero = {k.name: 0 for k in K.KERNELS}
    evals = lambda m: math.ceil(len(m.data.test_set_u) / m.eval_batch_size)  # noqa: E731
    saved = os.path.join(tmp, "lifecycle", "lightgcn")
    ckpt = f"on -dir {os.path.join(tmp, 'lifecycle', 'ck')} -every 2"
    conf = conf_of("LightGCN", 3)
    conf["checkpoint.setup"] = ckpt
    stopped, _, stopped_counts = checked_run("lightgcn stopped", conf, expected_launches)

    def resumed_launches(model):
        counts = expected_launches(model)
        steps = math.ceil(model.train_size / model.batch_size)
        counts["bipartite_dual_matmul"] -= 2 * model.n_layers * steps * model.resumed_step
        return counts

    conf = conf_of("LightGCN", 5)
    conf["checkpoint.setup"] = ckpt
    conf["model.setup"] = f"-save {saved}"
    resumed, measure, counts = checked_run("lightgcn resumed", conf, resumed_launches)
    same = (resumed.resumed_step == 2 and stopped.epoch_losses == unbroken["losses"][:3]
            and resumed.epoch_losses == unbroken["losses"][2:]
            and torch.equal(resumed.U, unbroken["U"]) and torch.equal(resumed.V, unbroken["V"]))
    print(f"[lightgcn resumed] from step {resumed.resumed_step}: stopped losses "
          f"{stopped.epoch_losses}, resumed losses {resumed.epoch_losses}, unbroken "
          f"{unbroken['losses']}; U, V and losses bit-identical to the unbroken run: {same}; "
          f"steady epoch ms={resumed.timer.steady_state() * 1e3:.3f} (card: {card})", flush=True)
    if not same:
        fail("lightgcn resumed: the resumed run differs from the unbroken one")
    k1 = stopped_counts["bipartite_dual_matmul"] + counts["bipartite_dual_matmul"]
    k2 = {"lightgcn stopped": stopped_counts["masked_catalog_topk"],
          "lightgcn resumed": counts["masked_catalog_topk"]}
    del stopped, resumed
    conf = conf_of("LightGCN", 5)
    conf["model.setup"] = f"-load {saved}"
    _, loaded, counts = checked_run("lightgcn loaded", conf,
                                    lambda m: zero | {"masked_catalog_topk": evals(m)})
    if loaded != measure:
        fail("lightgcn loaded: the measure lines differ from the saving run's")
    print(f"[lightgcn loaded] measure lines equal to the saving run's ({counts['masked_catalog_topk']} "
          f"K2 launches, {counts['bipartite_dual_matmul']} K1)", flush=True)
    k2["lightgcn loaded"] = counts["masked_catalog_topk"]

    saved = os.path.join(tmp, "lifecycle", "svd")
    conf = conf_of("SVD", 3)
    conf["ratings"] = filmtrust
    conf["item.ranking"] = "on -topN 10"
    conf["model.setup"] = f"-save {saved}"
    svd, measure, counts = checked_run("svd saved", conf, expected_launches)
    k2["svd saved"] = counts["masked_catalog_topk"]
    conf["model.setup"] = f"-load {saved}"
    loaded_svd, loaded, counts = checked_run("svd loaded", conf,
                                             lambda m: zero | {"masked_catalog_topk": evals(m)})
    biased = loaded_svd.score_form().user_bias is not None
    if loaded != measure or not biased or not torch.equal(loaded_svd.Bu, svd.Bu):
        fail("svd loaded: the measure lines or the biases differ from the saving run's")
    print(f"[svd loaded] measure lines equal to the saving run's through K2's bias epilogue "
          f"({counts['masked_catalog_topk']} launches)", flush=True)
    k2["svd loaded"] = counts["masked_catalog_topk"]
    del svd, loaded_svd

    # CUNE_BPR's walks: host walker against the plain numpy walker
    conf = conf_of("CUNE_BPR", 1)
    rec = QRec(conf)
    data = Interactions(conf, rec.training_data, rec.test_data)
    options = OptionConf(conf["CUNE-BPR"])
    count, length = options.get_int("-T"), options.get_int("-L")
    net = W.cooccurrence_network(data)
    seed = int(conf.get("seed", 2026))
    walked = {}
    for name, walker in (("host", W.random_walks), ("host repeat", W.random_walks),
                         ("numpy", W.random_walks_numpy)):
        t0 = time.perf_counter()
        walks, active = walker(net, count, length, np.random.RandomState(seed))
        walked[name] = (walks, time.perf_counter() - t0, walk_distribution(net, walks, active, count))
    (host, host_s, host_tv), (numpy_walks, numpy_s, numpy_tv) = walked["host"], walked["numpy"]
    repeat = np.array_equal(host, walked["host repeat"][0])
    print(f"[walks cune_bpr] network nnz={net.nnz} walkers={len(host)} length={length}: host "
          f"walker s={host_s:.4f} (repeat {walked['host repeat'][1]:.4f}) numpy walker "
          f"s={numpy_s:.4f}; visits' distance from their expectation host={host_tv:.4f} "
          f"numpy={numpy_tv:.4f}; host repeats itself: {repeat} (host times; card: {card})",
          flush=True)
    if not (repeat and host_tv < 0.05 and numpy_tv < 0.05 and abs(host_tv - numpy_tv) <= 0.01
            and host.shape == numpy_walks.shape):
        fail("walks cune_bpr: the host walker fails the distribution checks or does not repeat")
    del rec, data, net, walked

    # the trace: one LightGCN epoch and one ranking
    conf = conf_of("LightGCN", 1)
    rec = QRec(conf)
    rec.execute()
    model = rec.model
    spec = model.build()
    gen = torch.Generator(device=model.device).manual_seed(0)
    ranker = CatalogRanker(model.data, k=10, device=model.device, bitmask=model.rated_bitmask)
    log_dir = os.path.join(tmp, "trace")
    t0 = time.perf_counter()
    with trace(log_dir) as prof:
        T.train(spec.params, spec.loss_fn, spec.sampler, max_epoch=1, lr=model.lrate,
                device=model.device, mode=spec.mode, max_lr=model.max_lrate, generator=gen,
                examples_per_epoch=model.train_size)
        model.finalize(spec)
        ranker.topk(model.score_form())
    wall = time.perf_counter() - t0
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    found = {sym: sum(sym in n for n in kernels) for sym in ("dual_regions", "catalog_tiles")}
    print(f"[trace] {os.path.basename(prof.trace_path)} {os.path.getsize(prof.trace_path)} bytes, "
          f"{len(events)} events, {len(kernels)} kernel names, K1/K2 kernel names {found}; "
          f"epoch + ranking under the trace {wall * 1e3:.1f} ms (card: {card})", flush=True)
    if not all(found.values()):
        fail(f"trace: the trace names no {[s for s, n in found.items() if not n]} kernel")
    del rec, model, spec
    return k1, k2


def write_yelp_file(path: str) -> None:
    """The :func:`yelp_matrix` interactions as a rating file."""
    rows, cols, _, _ = yelp_matrix()
    with open(path, "w") as f:
        f.writelines(f"{a} {b} 1\n" for a, b in zip(rows, cols))


def segment_phase(torch, K, timer, model, l2_rate):
    """K5 on ``model``'s sparse adjacency (its own CSR) and first-layer input
    (the embedding tables, cast as the propagation casts them): against its
    plain version, bit for bit against itself, and against K1 on the
    factored dense form of the same graph; then timed beside its plain
    version, ``torch.sparse.mm``, the bound and the gather floor."""
    from qrec_tpu_torch.ops.spmm import DenseJoint, factored_call, segment_operand

    adj = model.joint_adj
    with torch.no_grad():
        x = segment_operand(torch.cat([model.user_emb, model.item_emb]))
    out, err, absum = segment_check(torch, K, "yelp2018", x, adj)
    # K1 computes su * (R @ bf16(si * x)), K5 bf16(su * si) * x: each term
    # carries one bf16 rounding on each side, so an element may differ by
    # two; over a row's features the gap stays within 2^-8 of sum|v*x|
    dense = DenseJoint.from_interactions(model.data, x.device)
    k1 = factored_call(dense, x.float())
    gap, allowed = (out - k1).abs().sum(1), 2.0**-8 * absum.sum(1)
    ratio = (gap / allowed.clamp_min(1e-30)).max().item()
    print(f"[K5 vs K1 yelp2018] max |K5-K1| {(out - k1).abs().max().item():.3e}; worst row "
          f"sum|K5-K1| / (2^-8 sum|v*x|) = {ratio:.4f} {'ok' if ratio <= 1 else 'MISMATCH'}",
          flush=True)
    if not ratio <= 1:
        fail("weighted_segment_matmul and bipartite_dual_matmul disagree past the bf16 bound")
    del dense, k1, out, absum
    return dict(segment_timing(torch, K, timer, "yelp2018", x, adj, l2_rate), max_abs_err=err)


def first_step_views(torch, model):
    """The contrastive operands of the first training step of ``model``'s
    run, rebuilt: a fresh model of the same config and data has the run's
    initial parameters (seeded), a generator seeded as ``fit`` seeds it
    gives the first epoch's batches and then the first step's draws.
    Returns (view1, view2, mask): SimGCL's unique-user views, SGL's merged
    user-and-item views."""
    from qrec_tpu_torch.ops.losses import unique_padded

    fresh = type(model)(model.config, model.data, device=model.device)
    spec = fresh.build()
    gen = torch.Generator(device=model.device).manual_seed(fresh.seed + 1)
    batch = tuple(t[0] for t in spec.sampler(gen))
    draws = fresh.draw(gen)
    uu, um = unique_padded(batch[0])
    with torch.no_grad():
        if fresh.model_name == "SimGCL":
            _, (p1u, _), (p2u, _) = fresh.encode_all(draws)
            return p1u[uu], p2u[uu], um
        iu, im = unique_padded(batch[1])
        (s1u, s1i), (s2u, s2i) = fresh.encode_view(draws[0]), fresh.encode_view(draws[1])
        return (torch.cat([s1u[uu], s1i[iu]]), torch.cat([s2u[uu], s2i[iu]]),
                torch.cat([um, im]))


def _joint_kernel(adj):
    """The kernel that propagates over a joint adjacency: K1 on a dense
    form, K5 on the sparse one, none on a ``DeviceCOO`` (torch ops)."""
    from qrec_tpu_torch.ops.spmm import DenseJoint, SparseJoint

    return ("bipartite_dual_matmul" if isinstance(adj, DenseJoint) else
            "weighted_segment_matmul" if isinstance(adj, SparseJoint) else None)


def expected_launches(model):
    """Launches of K1-K5 in one ``QRec(conf).execute()``, from the code.
    S steps per epoch, E epochs, n layers, evals = K2 launches per ranking
    (ceil(test users / 1024), all of the fused top-k entry: no path runs
    K2's scores entry). Every propagation over the joint adjacency is one
    launch forward and one backward, of K1 on a dense form (factored, bf16
    or legacy int8), of K5 on the sparse one, of neither on a ``DeviceCOO``
    (``graph.backend=coo``: torch ops). LightGCN and NGCF: 2n per step, n
    for the final factors. SimGCL: the shared first layer and the fused
    (N, 3d) layers, 2n per step; SGL: the main graph and two views, 6n per
    step (+2 K1 degree matvecs for node drop, aug type 0, on the dense
    adjacency); both evaluate after every epoch (n propagations + evals
    K2) and once more at the end; K3 = K4 = 2 per SimGCL step (users,
    items), 1 per SGL step (merged). The social slice: MHCN, DiffNet and
    DHCF propagate over auxiliary matrices only (torch ops); SEPT's rec
    view is the joint adjacency, 2n per step in both phases, n per quick
    evaluation (every epoch) and n at the end; BUIR's dropout views ride
    K5 (n forward and n backward online, n forward for the target per
    step; a ``DeviceCOO`` under coo) and its final factors one joint
    propagation of n; MHCN and SEPT rank after every epoch and at the end,
    the other three once. ESRF: ``max_epoch // 3`` epochs a phase; a
    discriminator step propagates forward and backward (2n), in every
    phase; the adversarial phase's generator step propagates forward (n)
    and backward through every layer but the first (n - 1): the
    discriminator's tables are constants there, and the first layer reads
    only them; n for the final factors; one ranking. The MF slice, the
    social MF and ranking models, the baselines and the deep and GAN slice
    run no kernel but the top-k: one ranking when ``item.ranking`` is on
    and the model's score form is a ``ScoreForm`` (BPR, SVD, MostPopular,
    APR, IRGAN, SBPR, TBPR, WRMF, ExpoMF, CoFactor, SERec, SVD++, CUNE_BPR,
    IF_BPR, RSGAN: ceil(test users / eval_batch_size) launches, 512 users a
    batch for IRGAN); none for a rating run (the seven social MF models,
    UserKNN, ItemKNN, SlopeOne, SVD++ and EE as published, CUNE_MF; their
    solves, similarity blocks, segment sums, walks' skip-gram and friend
    top-k are torch ops), for Rand (torch ops) nor for
    the score blocks of NeuMF, DMF, CDAE, CFGAN, SREE, SocialFD and EE
    (torch ops, as the JAX package ranks them through XLA)."""
    from qrec_tpu_torch.models.adversarial_social import ESRF
    from qrec_tpu_torch.models.graph import LightGCN
    from qrec_tpu_torch.models.social_graph import BUIR, SEPT, _GraphModel
    from qrec_tpu_torch.ops.kernels import KERNELS
    from qrec_tpu_torch.ops.spmm import SparseJoint
    from qrec_tpu_torch.ops.topk import ScoreForm

    evals = math.ceil(len(model.data.test_set_u) / model.eval_batch_size)
    name = model.model_name
    counts = {k.name: 0 for k in KERNELS}
    if isinstance(model, ESRF):
        joint = _joint_kernel(model.joint_adj)
        if joint:
            steps = math.ceil(model.train_size / model.batch_size)
            n = model.n_layers
            third = max(1, model.max_epoch // 3)
            counts[joint] = third * steps * (2 * n + 2 * n + (2 * n + 2 * n - 1)) + n
        return counts | {"masked_catalog_topk": evals}
    if not isinstance(model, (LightGCN, _GraphModel)):
        ranks = model.ranking.isMainOn() and isinstance(model.score_form(), ScoreForm)
        return counts | {"masked_catalog_topk": evals if ranks else 0}
    steps = math.ceil(model.train_size / model.batch_size)
    n, e = model.n_layers, model.max_epoch
    joint = _joint_kernel(model.joint_adj) if isinstance(model, (LightGCN, SEPT, BUIR)) else None
    if isinstance(model, _GraphModel):
        rankings = e + 1 if model.track_best else 1
        counts["masked_catalog_topk"] = evals * rankings
        if isinstance(model, SEPT) and joint:
            counts[joint] = 2 * n * steps * e + n * rankings
        if isinstance(model, BUIR):
            if isinstance(model.view_adj, SparseJoint):
                counts["weighted_segment_matmul"] += 3 * n * steps * e
            if joint:
                counts[joint] += n
        return counts
    if name in ("LightGCN", "NGCF"):
        per_step, ssl, rankings = 2 * n, 0, 1
    elif name == "SimGCL":
        per_step, ssl, rankings = 2 * n, 2, e + 1
    else:
        degrees = 2 if model.aug_type == 0 and joint == "bipartite_dual_matmul" else 0
        per_step, ssl, rankings = 6 * n + degrees, 1, e + 1
    if joint:
        counts[joint] = per_step * steps * e + n * rankings
    return counts | {
        "masked_catalog_topk": evals * rankings,
        "infonce_fwd": ssl * steps * e,
        "infonce_bwd": ssl * steps * e,
    }


def check_counts(label, counts, expect) -> None:
    """Every kernel's launches in a run against ``expected_launches``."""
    print(f"[{label}] kernels {json.dumps(counts)} expected {json.dumps(expect)}", flush=True)
    for name, n in counts.items():
        if expect[name] > 0 and n <= 0:
            fail(f"{label}: {name} never launched on the path")
        if n != expect[name]:
            fail(f"{label}: {name} launched {n} times, expected {expect[name]}")


def drive(torch, K, QRec, conf, label):
    """One ``QRec(conf).execute()`` with the launch counts set to 0 just
    before and read just after; prints and checks the run: its losses
    (which must fall, for a trained model), its ranking or rating measures
    and its launches. Returns (model, counts, measures)."""
    from qrec_tpu_torch.ops.metrics import parse_measure

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rec = QRec(conf)
    measure = rec.execute()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    model = rec.model
    losses = getattr(model, "epoch_losses", [])
    expect = expected_launches(model)
    # the ALS models time their epochs but report no loss (WRMF's only)
    epochs = len(model.timer.times) if model.timer is not None else len(losses)
    print(f"[{label}] users={model.num_users} items={model.num_items} train={model.train_size} "
          f"test_users={len(model.data.test_set_u)} d={getattr(model, 'emb_size', '-')} "
          f"layers={getattr(model, 'n_layers', '-')} batch={getattr(model, 'batch_size', '-')} "
          f"epochs={epochs} wall_s={wall:.2f}", flush=True)
    if model.timer is not None:
        summary = model.timer.summary()
        print(f"[{label}] epoch losses: {losses}", flush=True)
        print(f"[{label}] epoch ms: {[round(t * 1e3, 3) for t in model.timer.times]} steady_epoch_ms="
              f"{summary['epoch_seconds'] * 1e3:.3f} (mean after epoch 1) examples_per_s="
              f"{summary['examples_per_second']:.0f} median_epoch_ms_3_to_end="
              f"{np.median(model.timer.times[2:] or model.timer.times) * 1e3:.3f}", flush=True)
    measures = parse_measure(measure)
    if model.ranking.isMainOn():
        top, parsed = next((k, v) for k, v in measures.items() if k.startswith("Top "))
        at = top.split()[1]
        print(f"[{label}] rank_ms={model.rank_seconds * 1e3:.3f} Precision@{at}={parsed['Precision']} "
              f"Recall@{at}={parsed['Recall']} NDCG@{at}={parsed['NDCG']}", flush=True)
        if not all(math.isfinite(v) and 0 <= v <= 1 for v in parsed.values()):
            fail(f"{label}: bad measures {parsed}")
    else:
        parsed = measures["global"]
        print(f"[{label}] MAE={parsed['MAE']} RMSE={parsed['RMSE']}", flush=True)
        if not all(math.isfinite(v) and 0 < v for v in parsed.values()):
            fail(f"{label}: bad measures {parsed}")
    tracker = getattr(model, "tracker", None)
    if tracker is not None:
        print(f"[{label}] best epoch {tracker.best_epoch}: {tracker.best_metrics}", flush=True)
    print(f"[{label}] max_memory_allocated_MB={torch.cuda.max_memory_allocated() / 2**20:.1f}",
          flush=True)
    check_counts(label, counts, expect)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss {losses}")
    # each phase of a multi-phase fit minimizes its own loss, but for the
    # phases of a minimax game
    if model.timer is not None:
        skip = MINIMAX_PHASES.get(model.model_name, ())
        reseeded = RESEEDED_PHASES.get(model.model_name, ())
        for k, phase in enumerate(getattr(model, "phase_losses", None) or [losses]):
            first = 1 if k in reseeded else 0
            if k not in skip and len(phase) > first + 1 and not phase[-1] < phase[first]:
                fail(f"{label}: loss did not decrease in phase {k + 1}: {phase}")
    if (tracker is not None) != getattr(model, "track_best", False):
        fail(f"{label}: best-epoch tracking is {'off' if tracker is None else 'on'}")
    return model, counts, parsed


def planted_check(torch, tmp, ModelConf, QRec, parse_measure, name, args, extra=None,
                  social=False, floor=0.5):
    """The repo's planted-block quality floor (tests/test_graph_models.py),
    on the card: Recall@10 > ``floor`` where random ranking gives about
    0.33. ``extra`` adds config keys (``graph.backend``); ``social`` adds
    the trust relation of tests/test_adversarial_models.py (4 links inside
    a user's block and 20 reciprocated pairs)."""
    rng = np.random.RandomState(0)
    path = os.path.join(tmp, "planted.txt")
    with open(path, "w") as f:
        for u in range(40):
            for i in rng.choice(15, size=10, replace=False) + (0 if u < 20 else 15):
                f.write(f"u{u} i{i} 1\n")
    conf = ModelConf({
        "ratings": path, "ratings.setup": "-columns 0 1 2", "model.name": name,
        "evaluation.setup": "-ap 0.2", "item.ranking": "on -topN 10", "num.factors": "16",
        "num.max.epoch": "30", "batch_size": "64", "learnRate": "-init 0.05 -max 1",
        "reg.lambda": "-u 0.001 -i 0.001 -b 0.1 -s 0.1", name: args,
        "output.setup": "off -dir ./results/", "seed": "7", **(extra or {}),
    })
    if social:
        trust = os.path.join(tmp, "planted_trust.txt")
        with open(trust, "w") as f:
            for u in range(40):
                for v in rng.choice(20, size=4, replace=False) + (0 if u < 20 else 20):
                    if v != u:
                        f.write(f"u{u} u{v}\n")
            for u in range(0, 40, 2):
                f.write(f"u{u} u{u + 1}\nu{u + 1} u{u}\n")
        conf["social"], conf["social.setup"] = trust, "-columns 0 1"
    recall = parse_measure(QRec(conf, seed=3).execute())["Top 10"]["Recall"]
    label = " ".join([name, *(f"{k}={v}" for k, v in (extra or {}).items())])
    print(f"[planted {label}] Recall@10={recall} (floor {floor})", flush=True)
    if not recall > floor:
        fail(f"planted-block {name} run reached Recall@10={recall} <= {floor}")


def profile_epoch(torch, model, label, epoch=None):
    """One more training epoch under torch.profiler: device time by kernel
    and the device's busy share of the epoch's wall time, with the InfoNCE
    kernels' and K5's device ms. ``epoch`` runs the epoch (by default one
    epoch of the model's single-phase spec)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qrec_tpu_torch.runtime import trainer as T

    if epoch is None:
        spec = model.build()
        gen = torch.Generator(device="cuda").manual_seed(0)
        epoch = lambda: T.train(  # noqa: E731
            spec.params, spec.loss_fn, spec.sampler, max_epoch=1, lr=model.lrate,
            device=model.device, mode=spec.mode, max_lr=model.max_lrate, generator=gen,
            examples_per_epoch=model.train_size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernels only: a user annotation such as the optimizer's
    # step range spans kernels already counted
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ]
    busy = {e.key: e.self_device_time_total / 1e3 for e in kernels}  # us -> ms
    total = sum(busy.values())
    infonce = sum(ms for name, ms in busy.items() if "infonce" in name)
    k4 = sum(ms for name, ms in busy.items() if "infonce_bwd" in name)
    k5 = sum(ms for name, ms in busy.items() if "segmm" in name)
    print(f"[profile {label}] one epoch under torch.profiler: wall_ms={wall_ms:.3f} "
          f"device_busy_ms={total:.3f} busy_share={total / wall_ms:.3f} "
          f"infonce_ms={infonce:.3f} infonce_share_of_device={infonce / max(total, 1e-9):.3f} "
          f"k4_ms={k4:.3f} k4_share_of_device={k4 / max(total, 1e-9):.3f} "
          f"k5_ms={k5:.3f} k5_share_of_device={k5 / max(total, 1e-9):.3f}", flush=True)
    for name, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile {label}]   {ms:9.3f} ms {ms / wall_ms:6.3f} of wall  {name[:90]}",
              flush=True)


def main() -> None:
    import torch

    # 1. card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from qrec_tpu_torch import ModelConf, QRec
    from qrec_tpu_torch.ops import kernels as K
    from qrec_tpu_torch.ops.metrics import parse_measure
    from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreForm

    # 2. build
    t0 = time.perf_counter()
    K.build()
    print(f"[build] {time.perf_counter() - t0:.2f} s for {len(K.KERNELS)} kernels "
          f"into {K.BUILD_DIR}", flush=True)
    from qrec_tpu_torch import native

    t0 = time.perf_counter()
    native.build()
    print(f"[build] {time.perf_counter() - t0:.2f} s for the host library "
          f"{native.library_path().name} (g++)", flush=True)

    rows, cols, _, _ = lastfm_records()
    tmp = tempfile.mkdtemp(prefix="qrec_smoke_")
    try:
        ratings = os.path.join(tmp, "lastfm_like.txt")
        with open(ratings, "w") as f:
            f.writelines(f"{a} {b} 1\n" for a, b in zip(rows, cols))

        def conf_of(name, epochs):
            conf = ModelConf(os.path.join(REPO, "config", f"{name}.conf"))
            conf["ratings"] = ratings
            conf["num.max.epoch"] = str(epochs)
            conf["output.setup"] = f"on -dir {os.path.join(tmp, 'results')}/"
            return conf

        # 3. LightGCN main path
        model, counts, _ = drive(torch, K, QRec, conf_of("LightGCN", 5), "main")
        # the unbroken run the slice-6 resume is held against
        unbroken = {"U": model.U.clone(), "V": model.V.clone(), "losses": list(model.epoch_losses)}
        # the final ranking against the plain versions on the CPU
        ranker = CatalogRanker(model.data, k=10, device="cuda", bitmask=model.rated_bitmask)
        ids, scores = ranker.topk(ScoreForm(model.U, model.V))
        ref = CatalogRanker(model.data, k=10, device="cpu", bitmask=model.rated_bitmask.cpu())
        rids, rscores = ref.topk(ScoreForm(model.U.cpu(), model.V.cpu()))
        same = (ids == rids).all(axis=1)
        # a row may differ only where near-equal scores (f32 sums in another
        # order) swap places
        close = np.abs(scores - rscores).max(axis=1) <= 1e-5
        if not (same | close).all() or not np.isfinite(scores).all():
            fail("GPU ranking disagrees with the CPU plain-version ranking")
        print(f"[main] ranking vs CPU plain versions: {int(same.sum())}/{len(same)} rows identical, "
              f"max score diff {np.abs(scores - rscores).max():.3e}", flush=True)
        k2r = {"lastfm": ranking_phase(torch, K, "lastfm", model, 10)}

        # 4. K1 and K2 against their plain versions on the main path's own
        # operands: R with the first layer's inputs (K1), the first batch of
        # test users (K2); then K1 at the yelp2018 shape
        adj = model.joint_adj
        n_items = adj.num_items
        with torch.no_grad():
            x = torch.cat([model.user_emb, model.item_emb]).contiguous()
            xu = (model.user_emb * adj.row_scale[:, None]).bfloat16()
            xi = torch.zeros((adj.r.shape[1], x.shape[1]), dtype=torch.bfloat16, device="cuda")
            xi[:n_items] = (model.item_emb * adj.col_scale[:, None]).bfloat16()
        uids = torch.as_tensor(ranker.uids[: model.eval_batch_size], device="cuda").long().clamp(min=0)
        timer = Timer(torch)
        l2_rate = l2_read_rate(torch, K, timer)
        k1 = dual_phase(torch, K, timer, "lastfm", adj.r, xu, xi, n_items)
        # SimGCL's fused three views (d=150) and SGL's node-drop degrees
        # (d=1) on the same R
        k1w = dual_phase(torch, K, timer, "lastfm d=150", adj.r, xu.repeat(1, 3),
                         xi.repeat(1, 3), n_items)
        k1d = dual_phase(torch, K, timer, "lastfm d=1", adj.r, xu[:, :1].contiguous(),
                         xi[:, :1].contiguous(), n_items)
        kf = factored_phase(torch, K, timer, adj, x)
        k5l = lastfm_segment_line(torch, K, timer, model, k1["ms"], l2_rate)
        k2 = scores_phase(torch, K, timer, model.U[uids], model.V, model.rated_bitmask[uids])
        k2t = {"lastfm": topk_timing(torch, K, timer, model, 10, "lastfm")}
        k1y = dual_phase(torch, K, timer, "yelp2018", *yelp_inputs(torch, K))
        epoch_ms = model.timer.summary()["epoch_seconds"] * 1e3
        share = k1["warm_ms"] * counts["bipartite_dual_matmul"] / model.max_epoch / epoch_ms
        print(f"[main] K1 share of a steady epoch, estimated from the warm kernel time: {share:.3f}")
        profile_epoch(torch, model, "LightGCN")
        del model, adj, x, xu, xi

        # 5. SimGCL main path, then K3 and K4 on its first step's views
        simgcl, sim_counts, _ = drive(torch, K, QRec, conf_of("SimGCL", 3), "simgcl")
        view1, view2, mask = first_step_views(torch, simgcl)
        k3, k4 = infonce_phase(torch, K, timer, "simgcl users", view1, view2, mask)
        # masked rows and an all-zero row
        view1 = view1.clone()
        view1[0] = 0.0
        mask = mask.clone()
        mask[::10] = 0.0
        for k, extra in zip((k3, k4), infonce_phase(
                torch, K, timer, "masked+zero row", view1, view2, mask, timed=False)):
            k["max_abs_err"] = max(k["max_abs_err"], extra["max_abs_err"])
        profile_epoch(torch, simgcl, "SimGCL")
        del simgcl, view1, view2, mask

        # 6. SGL path, then K3 and K4 at its merged B=4000
        sgl, sgl_counts, _ = drive(torch, K, QRec, conf_of("SGL", 2), "sgl")
        k3s, k4s = infonce_phase(torch, K, timer, "sgl merged", *first_step_views(torch, sgl))
        for k, extra in ((k3, k3s), (k4, k4s)):
            k["max_abs_err"] = max(k["max_abs_err"], extra["max_abs_err"])
        del sgl

        # 7. the sparse joint adjacency (K5): SGL's per-edge views, NGCF
        # (dense, K1), LightGCN at the yelp2018 shape; K5 on the yelp path
        conf = conf_of("SGL", 2)
        conf["graph.backend"] = "pallas"
        sgl_sparse, sgl_sparse_counts, _ = drive(torch, K, QRec, conf, "sgl-pallas")
        del sgl_sparse
        ngcf, _, _ = drive(torch, K, QRec, conf_of("NGCF", 3), "ngcf")
        if ngcf.U.shape[1] != 3 * ngcf.emb_size:
            fail(f"ngcf: scoring tables of width {ngcf.U.shape[1]}, expected 3d")
        k2r["ngcf d=150"] = ranking_phase(torch, K, "ngcf d=150", ngcf, 10)
        k2t["ngcf d=150"] = topk_timing(torch, K, timer, ngcf, 10, "ngcf d=150")
        del ngcf
        yelp_ratings = os.path.join(tmp, "yelp_like.txt")
        write_yelp_file(yelp_ratings)
        conf = conf_of("LightGCN", 2)
        conf["ratings"] = yelp_ratings
        for key, value in (("num.factors", "64"), ("batch_size", "2048"),
                           ("item.ranking", "on -topN 20"), ("graph.backend", "pallas"),
                           ("reg.lambda", "-u 0.0001 -i 0.0001 -b 0.2 -s 0.2")):
            conf[key] = value
        yelp, yelp_counts, _ = drive(torch, K, QRec, conf, "yelp-pallas")
        k2r["yelp2018"] = ranking_phase(torch, K, "yelp2018", yelp, 20)
        k2t["yelp2018"] = topk_timing(torch, K, timer, yelp, 20, "yelp2018")
        k5 = segment_phase(torch, K, timer, yelp, l2_rate)
        profile_epoch(torch, yelp, "LightGCN yelp2018 pallas")
        del yelp

        # 8. the MF slice (BPR, SVD rating and ranking, MostPopular) and the
        # -cv and -predict protocols
        mf_launches, mf_k2r, mf_k2t = mf_phases(torch, K, QRec, timer, tmp, conf_of)
        k2r.update(mf_k2r)
        k2t.update(mf_k2t)

        # 9. the deep and GAN slice (NeuMF, APR, IRGAN, DMF, CDAE, CFGAN)
        deep_launches, deep_k2r, deep_k2t = deep_phases(torch, K, QRec, timer, conf_of)
        mf_launches.update(deep_launches)
        k2r.update(deep_k2r)
        k2t.update(deep_k2t)

        # 10. the social slice: the bf16 and legacy int8 forms, DeviceCOO,
        # MHCN, SEPT, BUIR, DiffNet and DHCF with a synthetic trust file
        trust = os.path.join(tmp, "trust_like.txt")
        with open(trust, "w") as f:
            f.writelines(f"{a} {b}\n" for a, b in lastfm_trust())
        k1b, k1b_launches, social_launches, social_k2r = social_phases(
            torch, K, QRec, timer, conf_of, trust)
        mf_launches.update(social_launches)
        k2r.update(social_k2r)
        del timer

        # 11. the rest of the social family: the seven social MF rating
        # models, SBPR (and its -tf path), TBPR and ESRF
        k1_esrf, rest_launches, rest_k2r = social_rest_phases(torch, K, QRec, conf_of, tmp, trust)
        mf_launches.update(rest_launches)
        k2r.update(rest_k2r)

        # 12. the ALS and classical slice: WRMF, ExpoMF, CoFactor, SERec,
        # UserKNN, ItemKNN, SlopeOne, SVD++ and EE
        als_launches, als_k2r = als_classical_phases(torch, K, QRec, conf_of, tmp, trust)
        mf_launches.update(als_launches)
        k2r.update(als_k2r)

        # 13. the walk slice: CUNE_MF, CUNE_BPR, IF_BPR (without and with
        # negative feedback) and RSGAN
        walk_launches, walk_k2r = walk_phases(torch, K, QRec, conf_of, tmp, trust)
        mf_launches.update(walk_launches)
        k2r.update(walk_k2r)

        # 14. the lifecycle slice: the host library, resume, save/load and the trace
        k1_life, life_launches = host_and_lifecycle_phases(
            torch, K, QRec, conf_of, tmp, card, unbroken)
        mf_launches.update(life_launches)
        del unbroken

        # 15. planted blocks
        planted_check(torch, tmp, ModelConf, QRec, parse_measure, "LightGCN", "-n_layer 2")
        planted_check(torch, tmp, ModelConf, QRec, parse_measure, "SimGCL",
                      "-n_layer 2 -lambda 0.05 -eps 0.1")
        pallas = {"graph.backend": "pallas"}
        planted_check(torch, tmp, ModelConf, QRec, parse_measure, "LightGCN", "-n_layer 2", pallas)
        planted_check(torch, tmp, ModelConf, QRec, parse_measure, "SGL",
                      "-n_layer 2 -lambda 0.05 -droprate 0.2 -augtype 1 -temp 0.2", pallas)
        planted_check(torch, tmp, ModelConf, QRec, parse_measure, "NGCF", "")
        # the floors of tests/test_social_models.py and tests/test_adversarial_models.py
        planted_check(torch, tmp, ModelConf, QRec, parse_measure, "SBPR", "", social=True)
        planted_check(torch, tmp, ModelConf, QRec, parse_measure, "ESRF", "-K 5 -beta 0.1 -n_layer 2",
                      social=True, floor=0.45)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 16. results
    print(f"[K5 yelp2018] launches {yelp_counts['weighted_segment_matmul']} ms={k5['ms']:.4f} "
          f"plain_ms={k5['plain_ms']:.4f} library_ms={k5['library_ms']:.4f} "
          f"bound_ms={k5['bound_ms']:.4f} gather_floor_ms={k5['floor_ms']:.4f}", flush=True)
    print(f"[K5 lastfm] launches {sgl_sparse_counts['weighted_segment_matmul']} (SGL-pallas) "
          f"ms={k5l['ms']:.4f} plain_ms={k5l['plain_ms']:.4f} library_ms={k5l['library_ms']:.4f} "
          f"bound_ms={k5l['bound_ms']:.4f} "
          f"gather_floor_ms={k5l['floor_ms']:.4f}", flush=True)
    for label, k in (("lastfm", k1), ("lastfm d=150", k1w), ("lastfm d=1", k1d),
                     ("yelp2018", k1y)):
        print(f"[K1 {label}] ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
              f"library_ms={k['library_ms']:.4f} "
              f"bound_ms={k['bound_ms']:.4f}", flush=True)
    print(f"[K1 factored] kernels per application {kf['kernels']} (unfused "
          f"{kf['unfused_kernels']}) ms={kf['ms']:.4f} unfused_ms={kf['unfused_ms']:.4f}; "
          f"K5 lastfm ms={k5l['ms']:.4f}", flush=True)
    print(f"[sgl] launches {json.dumps(sgl_counts)}; K3 at B=4000 ms={k3s['ms']:.4f} "
          f"K4 ms={k4s['ms']:.4f}", flush=True)
    for label, k in k2t.items():
        print(f"[K2 topk {label}] ms={k['ms']:.4f} unfused_ms={k['unfused_ms']:.4f} "
              f"library_ms={k['library_ms']:.4f} plain_ms={k['plain_ms']:.4f} "
              f"bound_ms={k['bound_ms']:.4f} kernels per call {k['kernels']}; ranking peak "
              f"{k2r[label]['peak_mib']:.1f} MiB (unfused {k2r[label]['unfused_peak_mib']:.1f} MiB)",
              flush=True)
    print(f"[K2] scores entry ms={k2['ms']:.4f} (on no path; launches "
          f"{counts['masked_catalog_scores']})", flush=True)
    print(f"[K1] launches: main {counts['bipartite_dual_matmul']} lightgcn-bf16 {k1b_launches} "
          f"esrf {k1_esrf} lightgcn-stopped+resumed {k1_life}", flush=True)
    print(f"[K2 topk] launches: main {counts['masked_catalog_topk']} "
          + " ".join(f"{label} {n}" for label, n in mf_launches.items()), flush=True)

    def row(name, source, replaces, launches, k):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"]}

    print(f"[K1 bf16-S lastfm] launches {k1b_launches} (LightGCN bf16 run) ms={k1b['ms']:.4f} "
          f"plain_ms={k1b['plain_ms']:.4f} library_ms={k1b['library_ms']:.4f} "
          f"bound_ms={k1b['bound_ms']:.4f} max_abs_err={k1b['max_abs_err']:.3e}", flush=True)
    k1["max_abs_err"] = max(k["max_abs_err"] for k in (k1, k1w, k1d, k1y, k1b))
    kernels = [
        row("bipartite_dual_matmul", "qrec_tpu_torch/csrc/dual_matmul.cu",
            "qrec_tpu/ops/pallas_kernels.py:563",
            counts["bipartite_dual_matmul"] + k1b_launches + k1_esrf + k1_life, k1),
        row("masked_catalog_scores", "qrec_tpu_torch/csrc/masked_scores.cu",
            "qrec_tpu/ops/pallas_kernels.py:49", counts["masked_catalog_scores"], k2),
        row("masked_catalog_topk", "qrec_tpu_torch/csrc/masked_scores.cu",
            "qrec_tpu/ops/pallas_kernels.py:49 + qrec_tpu/ops/topk.py:289",
            counts["masked_catalog_topk"] + sum(mf_launches.values()),
            dict(k2t["lastfm"], max_abs_err=max(k["max_abs_err"] for k in k2r.values()))),
        row("infonce_fwd", "qrec_tpu_torch/csrc/infonce.cu",
            "qrec_tpu/ops/pallas_kernels.py:155", sim_counts["infonce_fwd"], k3),
        row("infonce_bwd", "qrec_tpu_torch/csrc/infonce.cu",
            "qrec_tpu/ops/pallas_kernels.py:242", sim_counts["infonce_bwd"], k4),
        row("weighted_segment_matmul", "qrec_tpu_torch/csrc/segment_matmul.cu",
            "qrec_tpu/ops/pallas_kernels.py:478", yelp_counts["weighted_segment_matmul"], k5),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
