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
7b. ``train.chunk`` for the graph family (``chunk_phases``): the LightGCN,
   SimGCL and yelp2018 runs above, chunked under ``auto``, against
   ``train.chunk=1`` bit for bit; each kernel inside a CUDA graph; LightGCN
   timed in turns under both; one profiled chunk of each path;
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
10b. ``train.chunk`` for the social-graph and deep families
   (``family_chunk_phases``): the chunked MHCN (the slice's main path),
   SEPT (both phases), DiffNet, DHCF and CDAE runs above, NeuMF and APR on
   the FilmTrust-shaped file and DMF at the lastfm shape, each against
   ``train.chunk=1`` bit for bit; K2 inside MHCN's evaluation graph, K1 and
   K2 inside SEPT's; MHCN, SEPT's two phases, DHCF and NeuMF's fused phase
   timed in turns under both; one profiled chunk of MHCN, DHCF and NeuMF's
   fused phase;
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
   d=20, 2 epochs each (``ALS_EPOCHS``), ranked at top-10 through K2's
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
13b. slice 10 (``dispatch_walk_phases``): BPR, SBPR, TBPR and CUNE_BPR
   under ``-tf`` (``TF_EPOCHS`` = 4 of the published 30-100), chunked under
   ``auto`` and held bit for bit to ``train.chunk=1``, one host read a
   chunk; BasicMF under ``-tf`` on the FilmTrust-shaped file, per epoch on
   plain Adam; CUNE_BPR's SGNS channel (3 epochs) as replayed CUDA graphs
   against its per-step loop, bit for bit; IF_BPR (``WALK_EPOCHS``) as one
   CUDA graph an epoch against its per-step epochs, bit for bit; every
   SGNS channel of phases 13 and 15 runs as replayed graphs, IF_BPR's
   epochs as one graph each;
13c. slice 11 (``own_loop_phases``): the own loops as one dispatch an
   epoch, each ``config/`` file at its published widths with the epochs of
   ``OWN_LOOP_EPOCHS``: ESRF (2 a phase: three phase graphs, K1 inside)
   and BUIR (4, ``train.chunk=auto``: one epoch graph, K5 inside) through
   ``ChunkedLoop``, RSGAN's pretraining step and epoch, IRGAN's and
   CFGAN's epochs as captured CUDA graphs; each held bit for bit to its
   per-step twin (``epoch_graphs=False``, BUIR at ``train.chunk=1``), with
   its ms an epoch, capture s, host reads in its epochs (``FitReads``
   against ``OWN_LOOP_READS``), peak MiB and launches (replays included);
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
15. multi-GPU (``parallel_phases``): the runs of ``PARALLEL_RUNS`` (the
   LightGCN family in every adjacency form; MHCN, SEPT, BUIR, DiffNet and
   DHCF with ``lastfm_trust``; the 15 models trained whole on every rank,
   CFGAN, IRGAN, RSGAN, IF_BPR, WRMF, ExpoMF, CoFactor, SERec,
   MostPopular and Rand on the lastfm-shaped file, UserMean, ItemMean,
   UserKNN, ItemKNN and SlopeOne on the FilmTrust-shaped one; the
   bold-driver family data-parallel, BasicMF, PMF, SVD, SVD++, EE and the
   seven social MF models with ``filmtrust_trust`` and CUNE_MF on the
   FilmTrust-shaped file, SBPR, TBPR and CUNE_BPR with ``lastfm_trust`` and
   SVD ranked on the lastfm-shaped one; NeuMF, APR, DMF, CDAE and ESRF
   data-parallel on the lastfm-shaped file, ESRF with ``lastfm_trust``),
   each with
   ``parallel.setup=on -model 2``, and WRMF with the setting absent (the
   mesh that forms by itself on a CUDA group), once in one process (no
   mesh; an earlier phase's run of the same config where there is one)
   and once on four ranks on cuda:0 over a
   gloo group that the script makes (data 2 x model 2): K5 on row blocks
   at width 25 (75 for SimGCL's fused views), K1 on item-column blocks,
   K3/K4 on 1,000 rows at offsets 0 and 1,000, K2 on a quarter of the test
   users; every rank's launches against ``expected_launches``, its mesh,
   the result files rank 0 alone writes, the ranks' digests of what each
   model scores from equal bit for bit, the measures within 2e-2 and the
   first epoch's loss within rtol 1e-4 of one process, each route against
   its plain twin, each route's kernel timed on one rank's share (route 7
   also on IRGAN's and SVD's biased forms and on APR's factors); LightGCN's
   lifecycle on the four ranks (``PARALLEL_LIFECYCLE``: stopped after
   epoch 1 of 2 under ``checkpoint.setup``, resumed bit for bit against
   the unbroken mesh run, rank 0 alone writing the step files and the
   ``-save``d model, a ``-load`` of it ranking to the same measures); then
   a one-rank NCCL group from the port's ``maybe_initialize_distributed``,
   whose routes must give the one-device path's bits. Four ranks share one
   card: this shows the routes right, not their scaling;
16. planted-block runs that must learn their blocks: LightGCN and SimGCL on
   the dense adjacency, LightGCN and SGL on the sparse one, NGCF, and
   SBPR and ESRF with a trust relation;
17. the ``kernels`` JSON line, the card line, and the final status line.
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
    per path, K2 checks, K2 timings, the SVD rating run's one-process
    record for the mesh phase)."""
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
    ones = {"svd": one_process_record(conf, svd, rating)}
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
    return launches, k2r, k2t, ones


# the deep and GAN slice's depth on the card: each config/*.conf at its
# published widths, with these epochs, those of the mesh runs that reuse
# these runs in parallel_phases: the least for NeuMF (1 a phase), APR (1 +
# 1) and DMF, whose 4-rank epochs cost 0.3-21 s (their loss falls in the
# runs of family_chunk_phases: NeuMF and APR on the FilmTrust-shaped file,
# DMF 2 epochs); CFGAN's 2, its mesh run's, since its one phase is a
# minimax game, which the check skips
DEEP_EPOCHS = {"NeuMF": 1, "APR": 2, "IRGAN": 2, "DMF": 1, "CDAE": 100, "CFGAN": 2}
# phases whose loss is one side of a minimax game and need not fall epoch
# by epoch: a GAN's D and G losses, ESRF's adversarial phase (its
# discriminator against the generator's neighbourhoods); APR's perturbed
# phase, whose worst-case deltas grow with the tables (its loss rises in
# the JAX package too)
MINIMAX_PHASES = {"APR": (1,), "CFGAN": (0,), "IRGAN": (0,), "RSGAN": (0,), "ESRF": (2,)}
# phases that this script trains too briefly for drive's loss-falls check
# in every run of the model, by design: none since ESRF's first two phases
# are checked at 2 epochs in own_loop_phases (its other runs train one
# epoch a phase). Any phase that no run checks fails the script
SHORT_PHASES = {}
# the phases drive checked and those it found too short, by model
FALLS = {"checked": {}, "short": {}}
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


def deep_phases(torch, K, QRec, timer, conf_of, chunked):
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
    line. CDAE's run (chunked: ``CHUNKED_FAMILY``) goes into ``chunked`` for
    ``family_chunk_phases``. Returns (K2 launches per path, K2 checks, K2
    timings, the one-process records of the six for the mesh phase, APR's,
    IRGAN's and NeuMF's with their models)."""
    launches, k2r, k2t, summary, ones = {}, {}, {}, {}, {}
    for name, epochs in DEEP_EPOCHS.items():
        label = name.lower()
        t0 = time.perf_counter()
        conf = conf_of(name, epochs)
        model, counts, measures = drive(torch, K, QRec, conf, label)
        wall = time.perf_counter() - t0
        timers = getattr(model, "phase_timers", None) or [model.timer]
        steady = phase_text(phase_ms(model))
        print(f"[{label}] epochs per phase {[len(t.times) for t in timers]} epoch ms per "
              f"phase {steady} ({PHASE_KINDS})", flush=True)
        summary[name] = dict(wall_s=wall, epoch_ms=steady, recall=measures["Recall"],
                             rank_ms=model.rank_seconds * 1e3)
        ones[label] = one_process_record(conf, model, measures)
        if label in KEPT:  # route 7 is timed on APR's and IRGAN's factors
            ones[label]["model"] = model
        if name in CHUNKED_FAMILY:
            chunked[label] = (conf, chunk_record(model), epochs, name)
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
        f"{n}: wall_s={v['wall_s']:.2f} epoch_ms={v['epoch_ms']} Recall@10={v['recall']} "
        f"rank_ms={v['rank_ms']:.3f};" for n, v in summary.items()), flush=True)
    return launches, k2r, k2t, ones


# the social slice's depth on the card, the least at which drive checks
# that each phase's loss falls and every chunked phase runs a chunk of two
# epochs or more (SEPT's 6: two warm-up epochs, then four joint ones, the
# last three on batches no phase has seen)
SOCIAL_EPOCHS = {"MHCN": 2, "SEPT": 6, "BUIR": 2, "DiffNet": 2, "DHCF": 2}


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


def social_phases(torch, K, QRec, timer, conf_of, trust_path, chunked):
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
    torch.profiler. The chunked runs (``CHUNKED_FAMILY``) go into
    ``chunked`` for ``family_chunk_phases``. Returns (K1 bf16 dict, bf16
    run's K1 launches, K1 launches per social path, K2 launches per path,
    K2 checks, the one-process records of the five for the mesh phase)."""
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
    summary, ones, k1_social = {}, {}, {}
    for name, epochs in SOCIAL_EPOCHS.items():
        conf = conf_of(name, epochs)
        if conf.contains("social"):
            conf["social"] = trust_path
        label = name.lower()
        model, counts, measures = drive(torch, K, QRec, conf, label)
        timers = getattr(model, "phase_timers", None) or [model.timer]
        steady = phase_text(phase_ms(model))
        social = model.social.trustSize() if model.social is not None else None
        ops = [
            f"{k}=DenseMat({v.mat.shape[0]}x{v.mat.shape[1]})" if isinstance(v, DenseMat)
            else f"{k}=DeviceCOO({v.num_rows}x{v.num_cols}, nnz={v.rows.numel()})"
            for k, v in vars(model).items() if isinstance(v, (DenseMat, DeviceCOO))
        ]
        print(f"[{label}] auxiliary operators {' '.join(ops)}", flush=True)
        print(f"[{label}] trust (users, links)={social} host graph build s={model.graph_seconds:.3f} "
              f"(before the epochs) epochs per phase {[len(t.times) for t in timers]} epoch ms "
              f"per phase {steady} ({PHASE_KINDS}) U width={model.U.shape[1]}", flush=True)
        summary[name] = dict(epoch_ms=steady, recall=measures["Recall"], ndcg=measures["NDCG"],
                             rank_ms=model.rank_seconds * 1e3, graph_s=model.graph_seconds)
        ones[label] = one_process_record(conf, model, measures)
        if name in CHUNKED_FAMILY:
            chunked[label] = (conf, chunk_record(model), epochs, name)
        launches[label] = counts["masked_catalog_topk"]
        if counts["bipartite_dual_matmul"]:  # SEPT's rec view, BUIR's final factors
            k1_social[label] = counts["bipartite_dual_matmul"]
        k2r[label] = ranking_phase(torch, K, label, model, 10)
        if name == "MHCN":
            aux_forms_phase(torch, timer, model)
        if name in ("MHCN", "DHCF"):
            profile_epoch(torch, model, name)
        del model
    print("[social] " + " ".join(
        f"{n}: epoch_ms={v['epoch_ms']} Recall@10={v['recall']} NDCG@10={v['ndcg']} "
        f"rank_ms={v['rank_ms']:.3f} graph_s={v['graph_s']:.3f};" for n, v in summary.items()),
        flush=True)
    return k1b, k1b_launches, k1_social, launches, k2r, ones


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
    K2 launches per path, K2 checks, the one-process records of the seven
    rating models, SBPR, TBPR and ESRF for the mesh phase)."""
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
    launches, k2r, summary, ones = {}, {}, {}, {}
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
        steady = phase_text(phase_ms(model))
        print(f"[{label}] trust (users, links)={model.social.trustSize()} host build s="
              f"{model.graph_seconds:.3f} (before the epochs) epochs per phase "
              f"{[len(t.times) for t in timers]} epoch ms per phase {steady} ({PHASE_KINDS})",
              flush=True)
        summary[key] = dict(epoch_ms=steady, graph_s=model.graph_seconds, **measures)
        ones[label] = one_process_record(conf, model, measures)
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
        f"{k}: epoch_ms={v['epoch_ms']} graph_s={v['graph_s']:.3f} "
        + (f"Recall@10={v['Recall']} NDCG@10={v['NDCG']};" if "Recall" in v
           else f"MAE={v['MAE']} RMSE={v['RMSE']};") for k, v in summary.items()), flush=True)
    return k1, launches, k2r, ones


# the ALS and classical slice's depth on the card, each config/ file at
# its published widths (d=20 for the ALS models, d=10 for SVD++ and EE); the
# ALS models at 2, the mesh runs' depth, whose one-process runs these are
# (WRMF's loss, the one the four report, is still checked to fall)
ALS_EPOCHS = {"WRMF": 2, "ExpoMF": 2, "CoFactor": 2, "SERec": 2}
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
    ``expected_launches``. Returns (K2 launches per path, K2 checks, the
    one-process records of every model here but the ranked SVD++ for the
    mesh phase)."""
    launches, k2r, summary, ones = {}, {}, {}, {}
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
        ones[label] = one_process_record(conf, model, measures)
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
        model, _, baseline[name] = drive(torch, K, QRec, conf, name.lower())
        ones[name.lower()] = one_process_record(conf, model, baseline[name])
        del model
    for name, epochs in CLASSICAL_EPOCHS.items():
        conf = conf_of(name, epochs)
        conf["ratings"] = filmtrust
        label = name.lower()
        model, _, measures = drive(torch, K, QRec, conf, label)
        summary[name] = dict(measures, eval_s=model.rating_seconds)
        ones[label] = one_process_record(conf, model, measures)
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
    return launches, k2r, ones


# the walk slice's depth on the card, each config/ file at its published
# widths (CUNE_MF d=10 on the FilmTrust shape; CUNE_BPR and IF_BPR d=10,
# RSGAN d=50 on the lastfm shape), those of the mesh runs that reuse these
# runs in parallel_phases: the least at which drive checks that the loss
# falls (2), RSGAN's 1 since its one phase is a minimax game, which the
# check skips, and one 4-rank epoch of it costs about 2 s on the H100
WALK_EPOCHS = {"CUNE_MF": 3, "CUNE_BPR": 2, "IF_BPR": 2, "RSGAN": 1}


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
    the pairs, each SGNS channel's steps, seconds without its CUDA graphs'
    capture, the capture's seconds and the steps a replayed graph holds,
    the friend top-k's ms."""
    sgns = " ".join(f"channel {c}: {ch['steps']} steps {ch['s']:.3f} s ({ch['s'] / ch['steps'] * 1e3:.3f} "
                    f"ms a step) capture_s={ch['capture_s']:.3f} graph_steps={ch['graph_steps']}"
                    for c, ch in enumerate(stats["sgns"]))
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
    (K2 launches per path, K2 checks, the one-process records of CUNE_MF,
    CUNE_BPR, IF_BPR and RSGAN, which the mesh phase holds its four ranks
    against)."""
    users, items, ratings = filmtrust_records()
    filmtrust = os.path.join(tmp, "filmtrust_walk.txt")
    with open(filmtrust, "w") as f:
        f.writelines(f"{a} {b} {r}\n" for a, b, r in zip(users, items, ratings))
    baseline = {}
    for name in ("UserMean", "ItemMean"):
        conf = conf_of(name, 1)
        conf["ratings"] = filmtrust
        _, _, baseline[name] = drive(torch, K, QRec, conf, name.lower())
    launches, k2r, summary, ones = {}, {}, {}, {}
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
        steady = phase_text(phase_ms(model))
        print(walk_stats_line(label, model.walk_stats), flush=True)
        print(f"[{label}] host build s={model.graph_seconds:.3f} (walks, SGNS, friends and tables, "
              f"before the epochs) epoch ms {steady} ({PHASE_KINDS})", flush=True)
        summary[key] = dict(epoch_ms=steady, graph_s=model.graph_seconds, **measures)
        if key in ("CUNE_MF", "CUNE_BPR", "IF_BPR", "RSGAN"):
            ones[label] = one_process_record(conf, model, measures)
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
    return launches, k2r, ones


# slice 10: the -tf runs, chunked under auto and held to train.chunk=1, at
# 4 epochs (the published 30-100 cut: each phase of more than one epoch
# chunks, and the loss-falls check needs 3)
TF_RUNS = ("BPR", "SBPR", "TBPR", "CUNE_BPR")
TF_EPOCHS = 4


def tf_runs_phase(torch, K, QRec, conf_of, tmp, trust_path, lap) -> tuple:
    """BPR, SBPR, TBPR (with ``trust_path``) and CUNE_BPR under ``-tf`` on
    the lastfm-shaped file at their published widths, ``TF_EPOCHS`` epochs
    under ``train.chunk=auto``: each checked as chunked and held bit for bit
    to its ``train.chunk=1`` rerun (``per_epoch_reruns``), the host reads
    of one more chunk counted (1), the steady epoch ms of both and the
    seeded losses printed; then BasicMF under ``-tf`` on the FilmTrust-shaped
    file, 3 epochs, its MAE/RMSE read every epoch: per epoch on plain Adam.
    Returns ({label: (auto ms, 1 ms, capture s, losses)}, {label: K2
    launches of its ``auto`` run})."""
    from qrec_tpu_torch.runtime import trainer as T

    runs, reads, launches = {}, {}, {}
    for name in TF_RUNS:
        conf = conf_of(name, TF_EPOCHS)
        conf["evaluation.setup"] = conf["evaluation.setup"] + " -tf"
        if name in ("SBPR", "TBPR"):
            conf["social"] = trust_path
        label = f"{name.lower()} -tf"
        model, counts, _ = drive(torch, K, QRec, conf, f"{label} chunk=auto")
        launches[label] = counts["masked_catalog_topk"]
        runs[label] = (conf, chunk_record(model), TF_EPOCHS, name)
        reads[label] = chunk_host_reads(torch, model, f"{label} chunk=auto")
        del model
        lap(f"{label} chunk=auto")
    _, models = per_epoch_reruns(torch, K, QRec, runs, lap)
    out = {}
    for label, (_, rec, _, _) in runs.items():
        one = models[label].timer.times
        out[label] = (float(np.mean(rec["times"])) * 1e3, float(np.mean(one[1:])) * 1e3,
                      rec["capture_s"], rec["losses"])
        print(f"[tf {label}] steady epoch ms train.chunk=auto {out[label][0]:.3f} (one chunk of "
              f"{TF_EPOCHS}, wall / E, after a capture of {rec['capture_s']:.3f} s) train.chunk=1 "
              f"{out[label][1]:.3f} (mean of epochs 2-{TF_EPOCHS}, lag-1); host reads a chunk "
              f"{reads[label]}; seeded losses {rec['losses']}", flush=True)
    del models
    film = os.path.join(tmp, "filmtrust_tf.txt")
    with open(film, "w") as f:
        f.writelines(f"{a} {b} {r}\n" for a, b, r in zip(*filmtrust_records()))
    conf = conf_of("BasicMF", 3)
    conf["ratings"] = film
    conf["evaluation.setup"] = conf["evaluation.setup"] + " -tf"
    seen = []
    real = T.train

    def spy(*a, **k):
        seen.append((k["chunk"], k["capturable"], k["mode"]))
        return real(*a, **k)

    T.train = spy
    try:
        model, _, measures = drive(torch, K, QRec, conf, "basicmf -tf")
    finally:
        T.train = real
    chunks = [e for t in model.phase_timers for _, e in t.chunks]
    print(f"[tf basicmf] rating run under -tf: (chunk, capturable, mode) {seen}; epochs a dispatch "
          f"{chunks}; seeded losses {model.epoch_losses}; MAE={measures['MAE']} "
          f"RMSE={measures['RMSE']}", flush=True)
    if seen != [(1, False, "adam")] or chunks != [1, 1, 1] or model.phase_timers[0].captures:
        fail("basicmf -tf: a -tf rating run must run per epoch on plain Adam")
    lap("basicmf -tf")
    return out, launches


def sgns_phase(torch, QRec, conf_of) -> dict:
    """One SGNS channel, CUNE_BPR's at its published ``-T 20 -L 10 -l 20 -w
    5`` on the lastfm-shaped file (its network, walks and pairs as the
    model builds them, seeded alike), 3 epochs of 8,192 pairs a step, as
    replayed CUDA graphs of ``SGNS_GRAPH_STEPS`` steps and as the per-step
    loop: the two ``in`` tables equal bit for bit; each one's seconds, the
    graphs' capture seconds and steps."""
    from qrec_tpu_torch.config import OptionConf
    from qrec_tpu_torch.data.dataset import Interactions
    from qrec_tpu_torch.ops import walks as W
    from qrec_tpu_torch.runtime.profiling import StepTimer

    conf = conf_of("CUNE_BPR", 1)
    rec = QRec(conf)
    data = Interactions(conf, rec.training_data, rec.test_data)
    options = OptionConf(conf["CUNE-BPR"])
    seed = int(conf.get("seed", 2026))
    net = W.cooccurrence_network(data)
    walks, active = W.random_walks(net, options.get_int("-T"), options.get_int("-L"),
                                   np.random.RandomState(seed))
    centers, contexts = W.walk_pairs(walks, options.get_int("-w"))
    dim = options.get_int("-l")
    out, tables = {}, {}
    # the default graphs, the per-step loop, then graphs of 32 and 64 steps
    # (the capture's cost against the graph's length)
    for form, steps in (("graphs", None), ("eager", 0), ("graphs k=32", 32), ("graphs k=64", 64)):
        timer = StepTimer(len(centers), "cuda")
        tables[form] = W.train_skipgram(centers, contexts, data.num_users, dim, active, seed=seed,
                                        device="cuda", timer=timer, graph_steps=steps)
        out[form] = W.skipgram_stats(len(centers), timer, "cuda", graph_steps=steps)
        gc.collect()
    same = {form: torch.equal(t, tables["eager"]) for form, t in tables.items()}
    g, e = out["graphs"], out["eager"]
    print(f"[sgns cune_bpr] pairs={len(centers)} steps={g['steps']} (3 epochs of 8,192 pairs) d={dim}: "
          f"graphs of {g['graph_steps']} steps s={g['s']:.3f} (capture_s={g['capture_s']:.3f}, "
          f"warm-up included) eager s={e['s']:.3f} ({e['s'] / e['steps'] * 1e3:.3f} ms a step); "
          f"in tables bit-identical={same['graphs']}; "
          + "; ".join(f"{form} s={out[form]['s']:.3f} capture_s={out[form]['capture_s']:.3f} "
                      f"bit-identical={same[form]}" for form in ("graphs k=32", "graphs k=64")),
          flush=True)
    if not all(same.values()) or not torch.isfinite(tables["graphs"]).all() or e["capture_s"] != 0:
        fail(f"sgns cune_bpr: a replayed form's in table differs from the per-step loop's: {same}")
    return out


def ifbpr_graph_phase(torch, QRec, conf_of, trust_path) -> dict:
    """IF_BPR at the lastfm shape (``lastfm_trust``, its published widths),
    its friends built once, then fitted twice from the same tables for
    ``WALK_EPOCHS`` epochs: one CUDA graph an epoch, then the per-step
    epochs (``epoch_graphs=False``): the tables, thresholds, sums and
    losses equal bit for bit; each one's epoch ms, the capture's seconds."""
    from qrec_tpu_torch.data.dataset import Interactions
    from qrec_tpu_torch.data.social import SocialGraph
    from qrec_tpu_torch.models.ifbpr import IF_BPR

    conf = conf_of("IF_BPR", WALK_EPOCHS["IF_BPR"])
    conf["social"] = trust_path
    rec = QRec(conf)
    data = Interactions(conf, rec.training_data, rec.test_data)
    model = IF_BPR(conf, data, device="cuda", social=SocialGraph(rec.relation, data))
    model.prepare_graph()
    initial = {k: v.detach().clone() for k, v in model.named_parameters()}
    out = {}
    for form, graphs in (("graphs", True), ("eager", False)):
        with torch.no_grad():
            for k, v in model.named_parameters():
                v.copy_(initial[k])
        model.epoch_graphs = graphs
        model.fit()
        out[form] = dict(losses=list(model.epoch_losses), U=model.U, V=model.V, acc=model.acc,
                         thresholds=list(model.thresholds), times=list(model.timer.times),
                         captures=list(model.timer.captures))
    g, e = out["graphs"], out["eager"]
    same = (g["losses"] == e["losses"] and torch.equal(g["U"], e["U"]) and torch.equal(g["V"], e["V"])
            and torch.equal(g["acc"], e["acc"]) and len(g["thresholds"]) == len(e["thresholds"])
            and all(torch.equal(a, b) and torch.equal(c, d)
                    for (a, c), (b, d) in zip(g["thresholds"], e["thresholds"])))
    print(f"[ifbpr graphs] users={model.num_users} items={model.num_items} train={model.train_size} "
          f"steps an epoch={model.num_batches} d={model.emb_size}: epoch ms one CUDA graph an epoch "
          f"{[round(t * 1e3, 3) for t in g['times']]} (capture_s={sum(g['captures']):.3f}, warm-up "
          f"epoch included) per-step {[round(t * 1e3, 3) for t in e['times']]}; tables, thresholds, "
          f"sums and losses bit-identical={same}; seeded losses {g['losses']}", flush=True)
    if not same or len(g["captures"]) != 1 or e["captures"]:
        fail("ifbpr graphs: the captured epochs differ from the per-step epochs")
    return out


def dispatch_walk_phases(torch, K, QRec, conf_of, tmp, trust_path) -> dict:
    """Slice 10: the ``-tf`` runs chunked (``tf_runs_phase``), one SGNS
    channel as replayed graphs against its per-step loop (``sgns_phase``)
    and IF_BPR's epoch graph against its per-step epochs
    (``ifbpr_graph_phase``), with the seconds of each part. Returns their
    results, with the K2 launches of the ``-tf`` runs under "launches"."""
    laps, lap = lap_timer()
    out = dict(zip(("tf", "launches"), tf_runs_phase(torch, K, QRec, conf_of, tmp, trust_path,
                                                     lap)))
    out["sgns"] = sgns_phase(torch, QRec, conf_of)
    lap("sgns")
    out["ifbpr"] = ifbpr_graph_phase(torch, QRec, conf_of, trust_path)
    lap("ifbpr graphs")
    print(f"[slice 10 phases] seconds {json.dumps(laps)}", flush=True)
    return out


# slice 11: the own loops as one dispatch an epoch, each config/ file at
# its published widths with the epochs cut: ESRF 2 a phase (the least at
# which a phase captures), BUIR 4, IRGAN 5 (its first printed epoch), RSGAN
# 2, CFGAN 20 (its first printed epoch)
OWN_LOOP_EPOCHS = {"ESRF": 6, "BUIR": 4, "IRGAN": 5, "RSGAN": 2, "CFGAN": 20}
# the host reads of each captured fit's epochs: one a phase's chunk (ESRF),
# one chunk (BUIR at auto), the printed epochs (IRGAN's 5th, CFGAN's 20th),
# the pretraining's losses and the last epoch's (RSGAN)
OWN_LOOP_READS = {"ESRF": 3, "BUIR": 1, "IRGAN": 1, "RSGAN": 2, "CFGAN": 1}
# the same of each per-step twin: ESRF reads every epoch, BUIR's per-epoch
# loop each epoch (lag-1), the others where their captured form reads
OWN_LOOP_TWIN_READS = {"ESRF": 6, "BUIR": 4, "IRGAN": 1, "RSGAN": 2, "CFGAN": 1}
READ_METHODS = ("tolist", "item", "cpu", "__float__", "__int__", "__bool__")


class FitReads:
    """Counts the host reads of ``cls``'s ``fit_phases`` outside its host
    build (``prepare_graph``): each ``tolist``, ``item``, ``cpu``,
    ``float``, ``int`` or ``bool`` of a CUDA tensor, the ways a Python loop
    reads the card. ``count`` holds them after the block."""

    device = "cuda"  # the device type whose tensors' reads count

    def __init__(self, torch, cls):
        self.torch, self.cls, self.count, self.active = torch, cls, 0, False

    def __enter__(self):
        counter = self
        self.saved = [(owner, name, owner.__dict__.get(name))
                      for owner, names in ((self.torch.Tensor, READ_METHODS),
                                           (self.cls, ("fit_phases", "prepare_graph")))
                      for name in names]

        def reader(real):
            def read(t, *a, **k):
                if counter.active and t.device.type == counter.device:
                    counter.count += 1
                return real(t, *a, **k)
            return read

        def toggled(real, on):
            def run(model, *a, **k):
                was, counter.active = counter.active, on
                try:
                    return real(model, *a, **k)
                finally:
                    counter.active = was
            return run

        for name in READ_METHODS:
            setattr(self.torch.Tensor, name, reader(getattr(self.torch.Tensor, name)))
        self.cls.fit_phases = toggled(self.cls.fit_phases, True)
        self.cls.prepare_graph = toggled(self.cls.prepare_graph, False)
        return self

    def __exit__(self, *exc):
        for owner, name, real in self.saved:
            if real is None:
                delattr(owner, name)
            else:
                setattr(owner, name, real)
        return False


def own_timers(model) -> list:
    """A fit's timers: ESRF's and BUIR's by phase, RSGAN's pretraining
    timer and its epoch timer, the others' one."""
    if model.model_name == "RSGAN":
        return [model.pretrain_timer, model.timer]
    return model.phase_timers or [model.timer]


def own_record(model) -> dict:
    """What a per-step twin is held to: every loss list, table, buffer
    and factor of the fit."""
    clone = lambda x: None if x is None else x.detach().clone()  # noqa: E731
    return dict(
        losses={k: list(getattr(model, k)) for k in ("epoch_losses", "g_losses", "pretrain_losses")
                if hasattr(model, k)},
        tensors={k: clone(v) for k, v in (*model.named_parameters(), *model.named_buffers())},
        U=clone(getattr(model, "U", None)), V=clone(getattr(model, "V", None)))


def same_record(torch, a, b) -> bool:
    return (a["losses"] == b["losses"] and a["tensors"].keys() == b["tensors"].keys()
            and all(torch.equal(a["tensors"][k], b["tensors"][k]) for k in a["tensors"])
            and all((a[k] is None and b[k] is None) or (a[k] is not None and b[k] is not None
                                                        and torch.equal(a[k], b[k]))
                    for k in ("U", "V")))


def own_loop_phases(torch, K, QRec, conf_of, trust_path) -> dict:
    """Slice 11: ESRF, BUIR, IRGAN, RSGAN and CFGAN at their ``config/``
    files' published widths on the lastfm-shaped file (with ``trust_path``
    where the file names a relation), ``OWN_LOOP_EPOCHS`` epochs, each driven twice through
    ``QRec(conf).execute()`` (``drive``: the launches against
    ``expected_launches``, replays included): in its captured form (ESRF's
    three phase graphs and BUIR's epoch graph under ``train.chunk=auto``;
    RSGAN's pretraining-step and epoch graphs; IRGAN's and CFGAN's epoch
    graphs), then as its per-step twin (``epoch_graphs=False``; BUIR at
    ``train.chunk=1``), both on capturable Adam. Each pair is held bit for
    bit (losses, tables, buffers, factors); each run's ms an epoch (by
    phase), capture s, host reads in its epochs (``FitReads``, against
    ``OWN_LOOP_READS``) and peak MiB are printed. Returns the summed
    launches of each kernel over the ten runs and the K2 launches of each
    run."""
    from qrec_tpu_torch.models import MODELS

    laps, lap = lap_timer()
    total, k2 = {}, {}
    out = {"launches": total, "k2": k2}
    for name, epochs in OWN_LOOP_EPOCHS.items():
        cls = MODELS[name]
        runs = {}
        for form in ("graphs", "per-step"):
            conf = conf_of(name, epochs)
            if conf.contains("social"):
                conf["social"] = trust_path
            if form == "per-step" and name == "BUIR":
                conf["train.chunk"] = "1"
            elif form == "per-step":
                cls.epoch_graphs = False
            label = f"own {name.lower()} {form}"
            try:
                with FitReads(torch, cls) as reads:
                    model, counts, _ = drive(torch, K, QRec, conf, label)
            finally:
                if "epoch_graphs" in cls.__dict__:
                    del cls.epoch_graphs
            peak = torch.cuda.max_memory_allocated() / 2**20
            for kernel, n in counts.items():
                total[kernel] = total.get(kernel, 0) + n
            k2[label] = counts["masked_catalog_topk"]
            timers = own_timers(model)
            captures = [len(t.captures) for t in timers]
            runs[form] = dict(record=own_record(model), reads=reads.count, captures=captures,
                              capture_s=sum(sum(t.captures) for t in timers),
                              ms=phase_text(phase_ms(model)), peak=peak, counts=counts,
                              chunks=[[e for _, e in t.chunks] for t in timers])
            del model
            gc.collect()
            lap(label)
        g, e = runs["graphs"], runs["per-step"]
        same = same_record(torch, g["record"], e["record"])
        print(f"[own {name.lower()}] epochs={epochs}: ms an epoch by phase, captured "
              f"{g['ms']} / per-step {e['ms']} ({PHASE_KINDS}); capture_s={g['capture_s']:.3f} "
              f"(captures by timer {g['captures']}, warm-ups included); epochs a dispatch "
              f"{g['chunks']} / {e['chunks']}; host reads in the epochs {g['reads']} / "
              f"{e['reads']}; peak MiB {g['peak']:.1f} / {e['peak']:.1f}; launches "
              f"{ {k: n for k, n in g['counts'].items() if n} } / "
              f"{ {k: n for k, n in e['counts'].items() if n} }; bit-identical={same}; seeded "
              f"losses {g['record']['losses']}", flush=True)
        out[name] = runs
        if not same:
            fail(f"own {name}: the captured form differs from its per-step twin")
        if g["reads"] != OWN_LOOP_READS[name] or e["reads"] != OWN_LOOP_TWIN_READS[name]:
            fail(f"own {name}: host reads {g['reads']} / {e['reads']}, expected "
                 f"{OWN_LOOP_READS[name]} / {OWN_LOOP_TWIN_READS[name]}")
        if not all(g["captures"]) or any(e["captures"]) or g["counts"] != e["counts"]:
            fail(f"own {name}: captures {g['captures']} / {e['captures']}, launches "
                 f"{g['counts']} / {e['counts']}")
    print(f"[slice 11 phases] seconds {json.dumps(laps)}", flush=True)
    return out


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


def lifecycle_launches(model, kind=None):
    """The launches of a lifecycle run of LightGCN or SVD, in one process or
    on a mesh (``host_and_lifecycle_phases``, ``PARALLEL_LIFECYCLE``): a
    stopped run's are a run's; a resumed run's leave out the K1 launches of
    the epochs it did not train; a model loaded (``kind`` ``-load``) runs
    K2 alone, once a batch of its test users (on a mesh, of this rank's
    share)."""
    import torch.distributed as dist

    from qrec_tpu_torch.ops.kernels import KERNELS
    from qrec_tpu_torch.parallel.collectives import split_sizes

    if kind == "-load":
        users = len(model.data.test_set_u)
        if model.mesh is not None:
            users = split_sizes(users, dist.get_world_size())[dist.get_rank()]
        return {k.name: 0 for k in KERNELS} | {
            "masked_catalog_topk": math.ceil(users / model.eval_batch_size)}
    counts = expected_launches(model)
    if model.resumed_step is not None:
        steps = math.ceil(model.train_size / model.batch_size)
        counts["bipartite_dual_matmul"] -= 2 * model.n_layers * steps * model.resumed_step
    return counts


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

    loaded_launches = lambda m: lifecycle_launches(m, "-load")  # noqa: E731
    saved = os.path.join(tmp, "lifecycle", "lightgcn")
    ckpt = f"on -dir {os.path.join(tmp, 'lifecycle', 'ck')} -every 2"
    conf = conf_of("LightGCN", 3)
    conf["checkpoint.setup"] = ckpt
    stopped, _, stopped_counts = checked_run("lightgcn stopped", conf, expected_launches)

    conf = conf_of("LightGCN", 5)
    conf["checkpoint.setup"] = ckpt
    conf["model.setup"] = f"-save {saved}"
    resumed, measure, counts = checked_run("lightgcn resumed", conf, lifecycle_launches)
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
    _, loaded, counts = checked_run("lightgcn loaded", conf, loaded_launches)
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
    loaded_svd, loaded, counts = checked_run("svd loaded", conf, loaded_launches)
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


# ---------------------------------------------------------------------------
# multi-GPU: the mesh on the one card (parallel_phases)
# ---------------------------------------------------------------------------

PARALLEL_RANKS = 4
# (label, config, epochs, keys set on the published config) of the runs
# that every rank makes under parallel.setup=on -model 2 (data 2 x model
# 2): K5's row blocks (pallas), K1's item-column blocks (the configs' own
# auto: the factored dense form), SGL's dense and sparse views; the social
# and hypergraph models with lastfm_trust as published (graph.backend
# unset: SEPT's rec view and BUIR's scoring on K1's column blocks, BUIR's
# views on K5's row blocks, MHCN's, DiffNet's and DHCF's operators whole on
# every rank). The lightgcn run is the unbroken run of the lifecycle
PARALLEL_RUNS = (
    ("lightgcn-pallas", "LightGCN", 1, {"graph.backend": "pallas"}),
    ("simgcl-pallas", "SimGCL", 1, {"graph.backend": "pallas"}),
    ("lightgcn", "LightGCN", 2, {}),
    ("sgl", "SGL", 1, {}),
    ("sgl-pallas", "SGL", 1, {"graph.backend": "pallas"}),
    ("ngcf", "NGCF", 1, {}),
    # MHCN, DiffNet and DHCF at the social slice's depth, whose one-process
    # runs this phase reuses; SEPT (warm-up + joint) and BUIR at the least
    # depth, with one-process runs of their own here, since one 4-rank epoch
    # of theirs (3.6-3.9 s on the H100) costs more than a one-process run
    ("mhcn", "MHCN", SOCIAL_EPOCHS["MHCN"], {}),
    ("sept", "SEPT", 2, {}),
    ("buir", "BUIR", 1, {}),
    ("diffnet", "DiffNet", SOCIAL_EPOCHS["DiffNet"], {}),
    ("dhcf", "DHCF", SOCIAL_EPOCHS["DHCF"], {}),
    # slice 7d: trained whole on every rank, each config/ file at its
    # published widths (epochs cut: CFGAN 500 -> 2, IRGAN 30 -> 2, RSGAN 30
    # -> 1, IF_BPR 30 -> 2, WRMF 30 -> 2, ExpoMF, CoFactor, SERec 20 -> 2; the
    # untrained models have none), each but MostPopular, Rand and "wrmf
    # auto" reusing the one-process run of the same config that deep_phases,
    # als_classical_phases or walk_phases made, the lastfm-shaped file (SERec,
    # IF_BPR, RSGAN with lastfm_trust; IF_BPR without negative feedback, one
    # SGNS channel) or the FilmTrust-shaped one (FILMTRUST)
    ("mostpopular", "MostPopular", 1, {}),
    ("rand", "Rand", 1, {}),
    ("wrmf", "WRMF", 2, {}),
    ("expomf", "ExpoMF", 2, {}),
    ("cofactor", "CoFactor", 2, {}),
    ("serec", "SERec", 2, {}),
    ("cfgan", "CFGAN", 2, {}),
    ("irgan", "IRGAN", 2, {}),
    ("if_bpr", "IF_BPR", WALK_EPOCHS["IF_BPR"], {}),
    ("rsgan", "RSGAN", WALK_EPOCHS["RSGAN"], {}),
    ("usermean", "UserMean", 1, {"ratings": "FILMTRUST"}),
    ("itemmean", "ItemMean", 1, {"ratings": "FILMTRUST"}),
    ("userknn", "UserKNN", 1, {"ratings": "FILMTRUST"}),
    ("itemknn", "ItemKNN", 1, {"ratings": "FILMTRUST"}),
    ("slopeone", "SlopeOne", 1, {"ratings": "FILMTRUST"}),
    # the mesh that forms by itself: parallel.setup absent on the four
    # ranks of a CUDA group (ROADMAP Queue 3 item 55)
    ("wrmf auto", "WRMF", 1, {"parallel.setup": None}),
    # slice 7e: the bold-driver family, data-parallel (each data rank's
    # loss its share), each config/ file at its published widths with the
    # epochs of its one-process run in an earlier phase, which this phase
    # reuses (mf_phases' SVD, SOCIAL_REST_EPOCHS, CLASSICAL_EPOCHS,
    # WALK_EPOCHS; BasicMF and PMF run here, 3 epochs of 100): the rating
    # models on the FilmTrust-shaped file, the social ones with
    # filmtrust_trust; SBPR, TBPR and CUNE_BPR on the lastfm-shaped file
    # with lastfm_trust, and SVD ranked at top-10 there (2 epochs, route 7
    # on its biased form at d=10)
    ("basicmf", "BasicMF", 3, {"ratings": "FILMTRUST"}),
    ("pmf", "PMF", 3, {"ratings": "FILMTRUST"}),
    ("svd", "SVD", 5, {"ratings": "FILMTRUST"}),
    ("svd ranked", "SVD", 2, {"item.ranking": "on -topN 10"}),
    ("svd++", "SVD++", CLASSICAL_EPOCHS["SVD++"], {"ratings": "FILMTRUST"}),
    ("ee", "EE", CLASSICAL_EPOCHS["EE"], {"ratings": "FILMTRUST"}),
    *((name.lower(), name, SOCIAL_REST_EPOCHS[name],
       {"ratings": "FILMTRUST", "social": "FILMTRUST_TRUST"})
      for name in ("SoRec", "SoReg", "SocialMF", "RSTE", "LOCABAL", "SREE", "SocialFD")),
    ("sbpr", "SBPR", SOCIAL_REST_EPOCHS["SBPR"], {}),
    ("tbpr", "TBPR", SOCIAL_REST_EPOCHS["TBPR"], {}),
    ("cune_mf", "CUNE_MF", WALK_EPOCHS["CUNE_MF"], {"ratings": "FILMTRUST"}),
    ("cune_bpr", "CUNE_BPR", WALK_EPOCHS["CUNE_BPR"], {}),
    # slice 7f: NeuMF, APR, DMF, CDAE and ESRF data-parallel, each config/
    # file at its published widths on the lastfm-shaped file (ESRF with
    # lastfm_trust, its discriminator on K1's column blocks) with the epochs
    # of its one-process run in deep_phases or social_rest_phases, which
    # this phase reuses: NeuMF 1 a phase, APR 1 + 1, DMF 1, CDAE 100, ESRF
    # 1 a phase
    *((name.lower(), name, DEEP_EPOCHS[name], {}) for name in ("NeuMF", "APR", "DMF", "CDAE")),
    ("esrf", "ESRF", SOCIAL_REST_EPOCHS["ESRF"], {}),
)
# the models of slice 7d, which train whole on every rank
REPLICATED = {"MostPopular", "Rand", "WRMF", "ExpoMF", "CoFactor", "SERec", "CFGAN", "IRGAN",
              "IF_BPR", "RSGAN", "UserMean", "ItemMean", "UserKNN", "ItemKNN", "SlopeOne"}
# the models trained data-parallel with no joint adjacency (the
# bold-driver family of slice 7e; NeuMF, APR, DMF and CDAE of slice 7f):
# for each, the rows of a step's batch per batch_size (NeuMF's pointwise
# batch holds 4 negatives a positive), the rows of another loss term that
# this data rank sums (row_share; DMF's negatives, cut apart from its
# positives) and the whole tables whose squared norms data rank 0 alone
# adds (adds_table_terms)
DATA_PARALLEL = {
    "BasicMF": (1, None, None), "PMF": (1, None, None), "SVD": (1, None, None),
    "SVD++": (1, None, "Y"), "EE": (1, None, None), "SoRec": (1, "trust edges", "Z"),
    "SoReg": (1, "trust edges", None), "SocialMF": (1, "users", None), "RSTE": (1, None, None),
    "LOCABAL": (1, "trust edges", "H"), "SREE": (1, "trust edges", None),
    "SocialFD": (1, "trust edges", None), "SBPR": (1, None, None), "TBPR": (1, None, None),
    "CUNE_MF": (1, "friend edges", None), "CUNE_BPR": (1, None, None),
    "NeuMF": (5, None, "h_mf and h_mlp"), "APR": (1, None, None),
    "DMF": (1, "negatives", "every parameter"),
    "CDAE": (1, None, "enc_w, dec_w, enc_b and dec_b")}
# the one-process models that later timings and the NCCL phase read
KEPT = ("lightgcn-pallas", "simgcl-pallas", "lightgcn", "irgan", "svd ranked", "apr", "neumf")
# the lifecycle on the four ranks: (label, epochs, checkpoint.setup on,
# model.setup) after the unbroken "lightgcn" run, in this order
PARALLEL_LIFECYCLE = (
    ("lightgcn stopped", 1, True, None),
    ("lightgcn resumed", 2, True, "-save"),
    ("lightgcn loaded", 2, False, "-load"),
)
SHARED = "4 ranks sharing one H100"


def rank_shares(model) -> str:
    """What this rank's kernels take of the run: K1's item-column block or
    K5's row block of the joint adjacency and their feature width, K5's
    row block of BUIR's views, the auxiliary operators every rank holds
    whole, K3/K4's contrastive rows (b_loc) and row offset, K2's test
    users; of a model trained whole on every rank, what it ranks or
    predicts."""
    import torch.distributed as dist

    from qrec_tpu_torch.ops.spmm import DenseMat, DeviceCOO, ShardedDenseJoint, feature_slice
    from qrec_tpu_torch.ops.topk import ScoreForm
    from qrec_tpu_torch.parallel.collectives import split_range

    mesh = model.mesh
    n = len(model.data.test_set_u)
    s0, s1 = split_range(n, dist.get_world_size(), dist.get_rank())
    name = model.model_name
    if name in REPLICATED or name in DATA_PARALLEL:
        if not model.ranking.isMainOn():
            what = f"every one of {len(model.data.test_data)} test ratings predicted"
        elif not isinstance(model.score_form(), ScoreForm):
            what = "every test user ranked whole (torch ops)"
        else:
            what = f"K2 test users [{s0}, {s1}) of {n}"
        if name in REPLICATED:
            return f"trained whole on every rank; {what}"
        per, rows, table = DATA_PARALLEL[name]
        b = model.batch_size * per
        b0, b1 = split_range(b, mesh.data, mesh.data_index)
        parts = [f"batch rows [{b0}, {b1}) of {b}"]
        if rows is not None:
            total = {"trust edges": lambda: model.social_arrays["src"].shape[0],
                     "users": lambda: model.num_users,
                     "friend edges": lambda: model.pull_src.shape[0],
                     "negatives": lambda: b * model.negative_sp}[rows]()
            r0, r1 = split_range(total, mesh.data, mesh.data_index)
            parts.append(f"{rows} [{r0}, {r1}) of {total}")
        if table is not None:
            parts.append(f"the squared norm of {table} "
                         + ("added here" if model.adds_table_terms else "left to data rank 0"))
        return "; ".join(parts + [what])
    # the joint adjacency only where the model built it (MHCN, DiffNet and
    # DHCF propagate over auxiliary operators alone)
    adj, view = vars(model).get("_joint_adj"), getattr(model, "view_adj", None)

    def width(w):
        cut = feature_slice(mesh, w)
        return str(w if cut is None else cut[1] - cut[0])

    widths = [model.emb_size] + ([3 * model.emb_size] if model.model_name == "SimGCL" else [])
    widths = " and ".join(width(w) for w in widths)
    parts = []
    if isinstance(adj, ShardedDenseJoint):
        parts.append(f"K1 item columns [{adj.col0}, {adj.col1}) of {adj.num_items}, "
                     f"{int((adj.r != 0).sum())} nonzeros, width {widths}")
    elif adj is not None:
        parts.append(f"K5 rows [{adj.row0}, {adj.row1}) of {adj.num_rows}, "
                     f"{adj.edge1 - adj.edge0} edges, width {widths}")
    if view is not None and not isinstance(view, DeviceCOO):
        parts.append(f"K5 view rows [{view.row0}, {view.row1}) of {view.num_rows}, "
                     f"{view.edge1 - view.edge0} edges, width {width(model.emb_size)}")
    aux = [k for k, v in vars(model).items() if isinstance(v, (DenseMat, DeviceCOO))
           and k != "view_adj"]
    if aux:
        parts.append(f"whole on every rank (torch ops): {', '.join(aux)}")
    if model.model_name in ("SimGCL", "SGL"):
        b = model.batch_size * (1 if model.model_name == "SimGCL" else 2)
        o0, o1 = split_range(b, mesh.data, mesh.data_index)
        parts.append(f"K3/K4 rows [{o0}, {o1}) of {b}: b_loc {o1 - o0}, row_offset {o0}")
    return "; ".join(parts + [f"K2 test users [{s0}, {s1}) of {n}"])


def parallel_route_checks(torch, K, model):
    """One call of each route of ``model``'s run on its own operands against
    the plain twin of the whole computation on the card: K1's item-column
    blocks (route 6) or K5's row blocks (route 4) on the trained ego table
    (the tolerance of ``factored_phase``, the order bound of
    ``segment_check``); the row-sharded InfoNCE (route 5) on the first
    step's contrastive views (SimGCL's users, SGL's merged set: its shares
    and cotangents summed over ``data`` against the plain function's
    autograd); the ranking cut by test user (route 7) on the final factors,
    bit for bit against K2 on every test user in one process and against
    the plain top-k (a row may differ where near-equal scores swap); BUIR's
    views (route 4 with per-edge values) with every edge kept, against the
    plain segment product of the whole view. A model with no joint
    adjacency (MHCN, DiffNet, DHCF) has route 7 alone; ESRF's ego table is
    its discriminator's. Every rank calls it: the routes gather. Returns
    {route: max_abs_err}."""
    from qrec_tpu_torch.data.graph import joint_normalized_adjacency
    from qrec_tpu_torch.ops.losses import infonce_dispatch, masked_infonce
    from qrec_tpu_torch.ops.spmm import (
        DenseJoint,
        ShardedDenseJoint,
        SparseJoint,
        ShardedSparseJoint,
        renormalize_vals,
        segment_operand,
        spmm,
    )
    from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreForm
    from qrec_tpu_torch.parallel.collectives import all_reduce_sum, reduce_gradients

    def segment_close(y, plain, xb, indptr, cols, vals):
        """K5's order bound: 2 ulp of f32 a term of a row's sum of |v x|."""
        absum = K.weighted_segment_matmul_plain(xb.abs(), indptr, cols, vals.abs())
        return bool(((y - plain).abs() <= 2.0 * indptr.diff().float()[:, None] * 2.0**-24
                     * absum).all())

    mesh, adj = model.mesh, vars(model).get("_joint_adj")
    errs = {}
    with torch.no_grad():
        x = torch.cat([model.user_emb, model.item_emb])
        y = None if adj is None else spmm(adj, x)
    if adj is None:
        pass
    elif isinstance(adj, ShardedDenseJoint):
        whole = DenseJoint.from_interactions(model.data, "cuda", adj.form)
        plain = K.factored_dual_matmul_plain(whole.r, x, whole.row_scale, whole.col_scale)
        del whole
        if not torch.allclose(y, plain, rtol=1e-5, atol=1e-5 * plain.abs().max().item()):
            raise AssertionError("K1's item-column blocks disagree with the plain product")
        errs["dense column blocks"] = (y - plain).abs().max().item()
    else:
        whole = SparseJoint.from_host(joint_normalized_adjacency(model.data), "cuda",
                                      check_symmetric=False)
        xb = segment_operand(x)
        plain = K.weighted_segment_matmul_plain(xb, whole.indptr, whole.cols, whole.vals)
        if not segment_close(y, plain, xb, whole.indptr, whole.cols, whole.vals):
            raise AssertionError("K5's row blocks disagree with the plain product")
        errs["segment row blocks"] = (y - plain).abs().max().item()
    view = getattr(model, "view_adj", None)
    if isinstance(view, ShardedSparseJoint):
        rows, cols = model.view_edges
        n = view.num_rows
        vals = renormalize_vals(rows, cols, torch.ones(rows.shape[0], device="cuda"), n)
        with torch.no_grad():
            y = spmm(view, x, vals)
        indptr = torch.searchsorted(rows.long(), torch.arange(n + 1, device="cuda")).int()
        xb = segment_operand(x)
        plain = K.weighted_segment_matmul_plain(xb, indptr, cols.int(), vals)
        if not segment_close(y, plain, xb, indptr, cols.int(), vals):
            raise AssertionError("K5's row blocks of BUIR's view disagree with the plain product")
        errs["segment row blocks"] = max(errs.get("segment row blocks", 0.0),
                                         (y - plain).abs().max().item())
    if model.model_name in ("SimGCL", "SGL"):
        view1, view2, mask = first_step_views(torch, model)
        a1, a2 = view1.clone().requires_grad_(True), view2.clone().requires_grad_(True)
        loss = infonce_dispatch(a1, a2, mask, TEMP, mesh)
        loss.backward()
        reduce_gradients([a1, a2], mesh)
        total = all_reduce_sum(loss.detach().clone(), mesh.data_group)
        p1, p2 = view1.clone().requires_grad_(True), view2.clone().requires_grad_(True)
        ploss = masked_infonce(p1, p2, mask, TEMP)
        ploss.backward()
        if not (torch.allclose(total, ploss.detach(), rtol=1e-5, atol=1e-5) and all(
                torch.allclose(g, w, rtol=1e-4, atol=1e-5 * w.abs().max().item())
                for g, w in ((a1.grad, p1.grad), (a2.grad, p2.grad)))):
            raise AssertionError("the row-sharded InfoNCE disagrees with its plain twin")
        errs["infonce row shards"] = max(abs(total.item() - ploss.item()),
                                         (a1.grad - p1.grad).abs().max().item(),
                                         (a2.grad - p2.grad).abs().max().item())
    errs["topk user shards"] = user_shard_check(torch, K, model, ScoreForm(model.U, model.V))
    return errs


def user_shard_check(torch, K, model, form) -> float:
    """Route 7 on ``form`` (a ``ScoreForm``, plain or biased): the ranking
    cut by test user over the mesh, bit for bit against K2 on every test
    user in one process and against the plain top-k (a row may differ
    where near-equal scores swap). Every rank calls it: the route gathers.
    Returns the largest score gap to the plain top-k."""
    from qrec_tpu_torch.ops.topk import CatalogRanker

    bm = model.rated_bitmask
    extra = dict(item_bias=form.item_bias, user_bias=form.user_bias, offset=form.offset)
    on_mesh = CatalogRanker(model.data, 10, "cuda", bm, model.eval_batch_size, mesh=model.mesh)
    ids, scores = on_mesh.topk_device(form)
    one_ids, one_scores = CatalogRanker(model.data, 10, "cuda", bm,
                                        model.eval_batch_size).topk_device(form)
    plain_ids, plain_scores = K.masked_catalog_topk_plain(form.user_emb, form.item_emb, bm,
                                                          on_mesh._uids, on_mesh.global_mean, 10,
                                                          **extra)
    same = (ids == plain_ids).all(dim=1)
    close = (scores - plain_scores).abs().max(dim=1).values <= 1e-5
    if not (torch.equal(ids, one_ids) and torch.equal(scores.view(torch.int32),
                                                      one_scores.view(torch.int32))):
        raise AssertionError("the ranking cut by test user differs from one process's")
    if not bool((same | close).all()):
        raise AssertionError("the ranking cut by test user disagrees with the plain top-k")
    return (scores - plain_scores).abs().max().item()


def flag_read_timing(torch, model, steps: int = 40, turns: int = 2) -> dict:
    """NeuMF's GMF-phase step on this rank, timed with and without the
    flag read of ``reduce_gradients``: ``steps`` steps of ``loss_mf`` on the
    pointwise sampler's batches under a fresh Adam, as ``train`` makes them
    (the MLP tower's gradients None on every rank, so the flags reach the
    host every step); in the other form each parameter that the loss does
    not reach gets a zero gradient before the reduction, so that no flag
    is read. In turns, the median ms a step. It trains the model on, after
    every check has read it. Every rank calls it: the steps are
    collective."""
    from qrec_tpu_torch.parallel.collectives import reduce_gradients

    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=1e-3)
    batches = model.pointwise_sampler()(torch.Generator(device=model.device).manual_seed(0))
    n = batches[0].shape[0]
    times, step = {"flag read": [], "no flag read": []}, 0
    for _ in range(turns):
        for key, ms in times.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = model.loss_mf(tuple(t[step % n] for t in batches))
                step += 1
                opt.zero_grad(set_to_none=True)
                loss.backward()
                if key == "no flag read":
                    for p in params:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                reduce_gradients(params, model.mesh)
                opt.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / steps)
    return dict({k: float(np.median(v)) for k, v in times.items()}, steps=steps,
                steps_per_epoch=n)


def replicated_route_check(torch, K, model):
    """A model with no joint adjacency (trained whole on every rank, slice
    7d; the bold-driver family, slice 7e; NeuMF, APR, DMF and CDAE, slice
    7f) reaches one route, route 7, where it ranks a ``ScoreForm``
    (:func:`user_shard_check` on its own form: IRGAN's, MostPopular's and
    SVD's biased, the others' plain). A score block (CFGAN, NeuMF, DMF,
    CDAE), Rand's draws and a rating run reach none. Returns {route:
    max_abs_err}."""
    from qrec_tpu_torch.ops.topk import ScoreForm

    if not model.ranking.isMainOn():
        return {}
    form = model.score_form()
    if not isinstance(form, ScoreForm):
        return {}
    biased = form.item_bias is not None or form.user_bias is not None or form.offset != 0
    return {"topk user shards" + (" biased" if biased else ""):
            user_shard_check(torch, K, model, form)}


def held_digests(model) -> dict:
    """sha256 of everything ``model`` scores or predicts from, by name: its
    parameters and buffers (MostPopular's popularity scores), its ALS
    tables and IF_BPR's tier tables, ``U``, ``V`` and IRGAN's item bias,
    and a rating run's prediction of every test rating. Digests, not the
    arrays: CFGAN's generator is 1.1 GB a rank."""
    import hashlib

    import torch

    arrays = {f"parameter {n}": p for n, p in model.named_parameters()}
    arrays.update({f"buffer {n}": b for n, b in model.named_buffers()})
    tables = getattr(model, "tables", None)
    if isinstance(tables, dict):
        arrays.update({f"table {n}": t for n, t in tables.items()})
    elif tables is not None:
        arrays.update({f"tier {i} {j}": t for i, tier in enumerate(tables)
                       for j, t in enumerate(tier)})
    for name in ("U", "V", "item_bias"):
        if getattr(model, name, None) is not None:
            arrays[name] = getattr(model, name)
    if not model.ranking.isMainOn():
        test = model.data.test_data
        arrays["predictions"] = model.predict_ratings([e[0] for e in test], [e[1] for e in test])
    host = lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t  # noqa: E731
    return {n: hashlib.sha256(np.ascontiguousarray(host(t)).tobytes()).hexdigest()
            for n, t in arrays.items()}


def parallel_rank(rank, store, runs, lifecycle, out_dir):
    """One rank of ``parallel_phases``: joins the gloo group that this script
    makes on cuda:0, drives each run through ``QRec(conf).execute()`` with
    its launch counts set to 0 just before and read just after, checks the
    routes on the run's operands and writes what it read: the digests of
    what the model scores from (:func:`held_digests`) and the result files
    this rank wrote (its printed output goes to ``rank<r>.log``); then the
    lifecycle runs, recording the checkpoint steps and the ``np.savez``
    calls that this rank made."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    sys.stdout = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=PARALLEL_RANKS, timeout=datetime.timedelta(seconds=300))
    try:
        from qrec_tpu_torch import ModelConf, QRec
        from qrec_tpu_torch.ops import kernels as K
        from qrec_tpu_torch.runtime import evaluator

        # the result files this rank writes, run by run
        writes, real_write = [], evaluator.write_file
        evaluator.write_file = lambda d, name, lines: (writes.append(name),
                                                       real_write(d, name, lines))[1]
        out = {}
        for label, conf in runs:
            K.reset_launch_counts()
            writes.clear()
            t0 = time.perf_counter()
            rec = QRec(ModelConf(conf))
            measure = rec.execute()
            counts = K.launch_counts()
            model = rec.model
            checks = (replicated_route_check
                      if model.model_name in REPLICATED or model.model_name in DATA_PARALLEL
                      else parallel_route_checks)
            out[label] = dict(
                mesh=None if model.mesh is None else model.mesh.shape,
                place=None if model.mesh is None else (model.mesh.data_index,
                                                       model.mesh.model_index),
                counts=counts, expect=expected_launches(model),
                losses=list(getattr(model, "epoch_losses", [])),
                epoch_ms=[t * 1e3 for t in model.timer.times] if model.timer else [],
                phase_ms=phase_ms(model),
                graph_s=getattr(model, "graph_seconds", None), measure=measure,
                shares=rank_shares(model), writes=list(writes), held=held_digests(model),
                errs=checks(torch, K, model))
            # the run, its checks and its digests, on this rank
            out[label]["wall_s"] = time.perf_counter() - t0
            if model.model_name == "NeuMF":
                out[label]["flag_ms"] = flag_read_timing(torch, model)
            del rec, model
            gc.collect()
            torch.cuda.empty_cache()
        evaluator.write_file = real_write
        from qrec_tpu_torch.runtime import checkpoint as C

        steps, savez = [], []
        real_save, real_savez = C.Checkpointer.save, np.savez
        C.Checkpointer.save = lambda ck, step, state: (steps.append(step),
                                                       real_save(ck, step, state))[1]
        np.savez = lambda path, *a, **k: (savez.append(str(path)), real_savez(path, *a, **k))[1]
        try:
            for label, conf, kind in lifecycle:
                K.reset_launch_counts()
                rec = QRec(ModelConf(conf))
                measure = rec.execute()
                counts = K.launch_counts()
                model = rec.model
                out[label] = dict(
                    counts=counts, expect=lifecycle_launches(model, kind), measure=measure,
                    losses=list(getattr(model, "epoch_losses", [])),
                    resumed=getattr(model, "resumed_step", None), held=held_digests(model))
                del rec, model
        finally:
            C.Checkpointer.save, np.savez = real_save, real_savez
        out["lifecycle writes"] = dict(steps=steps, savez=savez)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
        sys.stdout.flush()


def shard_timings(torch, K, timer, lightgcn, simgcl, dense):
    """Each route's kernel on one rank's share at the shapes of
    ``parallel_phases`` (data 2 x model 2), on the one-process runs'
    operands, timed in turns with its library call, its plain twin alone,
    with its bound: K5 on data rank 0's row block at model rank 0's feature
    slice (width 25); K3 then K4 on data rank 1's 1,000 rows at offset
    1,000 of SimGCL's first-step user views (B=2,000); K1 on data rank 0's
    item-column block of the factored R at width 25 (``dense``: the
    one-process LightGCN run on it); K2's top-k on rank 0's share of the
    test users of that run's final factors."""
    import types

    import torch.nn.functional as F

    from qrec_tpu_torch.data.graph import joint_normalized_adjacency
    from qrec_tpu_torch.ops.losses import _l2n
    from qrec_tpu_torch.ops.spmm import ShardedSparseJoint, segment_operand

    out = {}
    rank0 = types.SimpleNamespace(data=2, data_index=0, model=2, model_index=0)
    adj = ShardedSparseJoint.from_host(joint_normalized_adjacency(lightgcn.data), "cuda", rank0)
    with torch.no_grad():
        x = torch.cat([lightgcn.user_emb, lightgcn.item_emb])
    d = x.shape[1] // 2
    xb = segment_operand(x[:, :d])
    n, big_n, e = adj.row1 - adj.row0, x.shape[0], adj.edge1 - adj.edge0
    vals = adj.vals[adj.edge0: adj.edge1]
    call = lambda: K.weighted_segment_matmul(xb, adj.indptr, adj.cols, vals,  # noqa: E731
                                             adj.schedule, rows=n)
    with warnings.catch_warnings():  # sparse CSR tensors are "beta" in PyTorch
        warnings.simplefilter("ignore")
        library = torch.sparse_csr_tensor(adj.indptr, adj.cols, vals.bfloat16().float(),
                                          size=(n, big_n))
    xf = xb.float()
    ms, library_ms = timer.paired([call, lambda: torch.sparse.mm(library, xf)])
    plain_ms = timer.ms(lambda: K.weighted_segment_matmul_plain(xb, adj.indptr, adj.cols, vals),
                        iters=5)
    read_rows = int(torch.unique(adj.cols).numel())  # the rows of x the block gathers
    moved = e * 8 + (n + 1) * 4 + read_rows * d * 2 + n * d * 4
    bound_ms, bound_by = bound(moved, 2 * e * d, PEAK_F32)
    out["segment"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
    print(f"[K5 row block] rows={n} of {big_n} edges={e} d={d} rows of x read={read_rows} "
          f"ms={ms:.4f} library_ms={library_ms:.4f} (torch.sparse.mm of the block's CSR, timed in "
          f"turns) plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} by {bound_by}", flush=True)

    view1, view2, mask = first_step_views(torch, simgcl)
    with torch.no_grad():
        v1, v2 = _l2n(view1).contiguous(), _l2n(view2).contiguous()
    m = mask.float().contiguous()
    big_b = v1.shape[0]
    o0 = big_b // 2
    s1, rm = v1[o0:].contiguous(), m[o0:].contiguous()
    b, d = s1.shape
    _, lse = K.infonce_fwd(s1, v2, m, rm, TEMP, o0)
    target = torch.arange(o0, big_b, device="cuda")
    cm = (m == 0)[None, :]

    def library_loss(a, c):
        logits = (torch.matmul(a, c.T) / TEMP).masked_fill(cm, -1e30)
        return (F.cross_entropy(logits, target, reduction="none") * rm).sum()

    a1, a2 = s1.clone().requires_grad_(True), v2.clone().requires_grad_(True)
    lib = library_loss(a1, a2)
    k3_ms, k3_lib = timer.paired([lambda: K.infonce_fwd(s1, v2, m, rm, TEMP, o0),
                                  lambda: library_loss(s1, v2)])
    k4_ms, k4_lib = timer.paired([lambda: K.infonce_bwd(s1, v2, m, rm, lse, TEMP, o0),
                                  lambda: torch.autograd.grad(lib, (a1, a2), retain_graph=True)])
    k3_plain = timer.ms(lambda: K.infonce_fwd_plain(s1, v2, m, rm, TEMP, o0))
    k4_plain = timer.ms(lambda: K.infonce_bwd_plain(s1, v2, m, rm, lse, TEMP, o0))
    views, masks = (b + big_b) * d * 4, (b + big_b) * 4
    k3_bound, _ = bound(views + masks + b * 4 + 4, 2 * b * big_b * d, PEAK_F32)
    k4_bound, by = bound(views + masks + b * 4 + views, 6 * b * big_b * d, PEAK_F32)
    out["infonce"] = dict(ms=k3_ms + k4_ms, plain_ms=k3_plain + k4_plain,
                          library_ms=k3_lib + k4_lib, bound_ms=k3_bound + k4_bound, bound_by=by)
    print(f"[K3 row shard] b_loc={b} of B={big_b} row_offset={o0} d={d} ms={k3_ms:.4f} "
          f"library_ms={k3_lib:.4f} plain_ms={k3_plain:.4f} bound_ms={k3_bound:.4f}; "
          f"[K4 row shard] ms={k4_ms:.4f} library_ms={k4_lib:.4f} plain_ms={k4_plain:.4f} "
          f"bound_ms={k4_bound:.4f} (by operations)", flush=True)
    out["dense"] = column_block_timing(torch, K, timer, dense, rank0)
    out["topk"] = user_shard_timing(torch, K, timer, dense)
    return out


def column_block_timing(torch, K, timer, model, rank):
    """Route 6's call on ``rank``'s item-column block of ``model``'s
    factored R at its feature slice over ``model`` (width 25): K1's scaled
    entry on the block's operands as ``ops/spmm._block_dual_call`` builds
    them (x_u scaled, the unit row scale), against its plain twin, timed in
    turns with the library (two bf16 ``torch.mm`` of the block's Ŝ with f32
    results, the JAX package's partitioned products on a mesh), the plain
    twin alone, and the byte bound of the block's R, x and the result."""
    from qrec_tpu_torch.ops.spmm import ShardedDenseJoint

    block = ShardedDenseJoint.from_joint(model.joint_adj, rank)
    u, c0, c1 = block.num_users, block.col0, block.col1
    n_b = c1 - c0
    with torch.no_grad():
        x = torch.cat([model.user_emb, model.item_emb])
    d = x.shape[1] // 2
    x = x[:, :d]
    xb = torch.cat([x[:u] * block.row_scale[:, None], x[u + c0: u + c1]]).contiguous()
    call = lambda: K.factored_dual_matmul(block.r, xb, block.unit, block.col_scale)  # noqa: E731
    y = call()
    plain = K.factored_dual_matmul_plain(block.r, xb, block.unit, block.col_scale)
    torch.cuda.synchronize()
    err = (y - plain).abs().max().item()
    if not torch.allclose(y, plain, rtol=1e-5, atol=1e-5 * plain.abs().max().item()):
        fail("K1 on an item-column block disagrees with its plain twin")
    s_hat = (block.row_scale[:, None] * block.r[:, :n_b].float()
             * block.col_scale[None, :]).bfloat16()
    xu, xi = x[:u].bfloat16(), x[u + c0: u + c1].bfloat16()
    library = lambda: (torch.mm(s_hat, xi, out_dtype=torch.float32),  # noqa: E731
                       torch.mm(s_hat.T, xu, out_dtype=torch.float32))
    ms, library_ms = timer.paired([call, library])
    plain_ms = timer.ms(lambda: K.factored_dual_matmul_plain(block.r, xb, block.unit,
                                                             block.col_scale), iters=5)
    moved = u * n_b + (u + n_b) * d * 4 * 2 + (u + n_b) * 4
    bound_ms, bound_by = bound(moved, 2 * 2 * u * n_b * d, PEAK_BF16)
    print(f"[K1 column block] data rank {rank.data_index}'s items [{c0}, {c1}) of "
          f"{block.num_items} (stored {block.r.shape[1]}), U={u} d={d} "
          f"nnz={int((block.r != 0).sum())} ms={ms:.4f} library_ms={library_ms:.4f} (2x "
          f"torch.mm of the block's bf16 S-hat to f32, timed in turns) plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} by {bound_by} max_abs_err vs plain={err:.3e}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def user_shard_timing(torch, K, timer, model, k: int = 10, label: str = ""):
    """Route 7's call on rank 0's ``tensor_split`` share of the test users
    over the four ranks: K2's fused top-k of ``model``'s score form (its
    final factors, and its biases where it has them: IRGAN's item bias),
    timed in turns with the library (``matmul`` of the share's rows, the
    form's adds, ``masked_fill`` with the mask already expanded, ``topk``),
    its plain twin alone, and the operation bound; the call held against
    the plain twin (ids equal but where near-equal scores swap)."""
    from qrec_tpu_torch.ops.topk import CatalogRanker
    from qrec_tpu_torch.parallel.collectives import split_range

    form, bm = model.score_form(), model.rated_bitmask
    U, V = form.user_emb, form.item_emb
    extra = dict(item_bias=form.item_bias, user_bias=form.user_bias, offset=form.offset)
    ranker = CatalogRanker(model.data, k=k, device="cuda", bitmask=bm)
    n = len(ranker.uids)
    s0, s1 = split_range(n, PARALLEL_RANKS, 0)
    uids, gm = ranker._uids[s0:s1], ranker.global_mean
    B, (I, d) = uids.shape[0], V.shape
    safe = uids.clamp(min=0)
    rated = K.expand_bitmask(bm[safe].contiguous(), I)
    ub = U[safe].contiguous()
    fused = lambda: K.masked_catalog_topk(U, V, bm, uids, gm, k, **extra)  # noqa: E731

    def library():
        s = K.biased_scores(torch.matmul(ub, V.T), safe, **extra)
        return torch.topk(s.masked_fill_(rated, 0.0), k)

    ms, library_ms = timer.paired([fused, library])
    plain = lambda: K.masked_catalog_topk_plain(U, V, bm, uids, gm, k, **extra)  # noqa: E731
    plain_ms = timer.ms(plain)
    (ids, scores), (pids, pscores) = fused(), plain()
    gap = (scores - pscores).abs().max(dim=1).values
    err = gap.max().item()
    if not bool(((ids == pids).all(dim=1) | (gap <= 1e-5)).all()):
        fail(f"route 7{label}: K2 on rank 0's share disagrees with its plain twin")
    adds = (form.item_bias is not None) + (form.user_bias is not None) + (form.offset != 0)
    moved = (B * d * 4 + I * d * 4 + B * bm.shape[1] * 4 + B * 8 + B * k * 12
             + (I * 4 if form.item_bias is not None else 0)
             + (B * 4 if form.user_bias is not None else 0))
    bound_ms, bound_by = bound(moved, 2 * B * I * d + adds * B * I, PEAK_F32)
    terms = [term for term, on in (("the item bias", form.item_bias is not None),
                                   ("the user bias", form.user_bias is not None),
                                   ("the global mean", form.offset != 0)) if on]
    biases = " with " + ", ".join(terms) if terms else ""
    print(f"[K2 topk user shard{label}] {model.model_name}{biases}: rank 0's test users "
          f"[{s0}, {s1}) of {n}: B={B} I={I} d={d} k={k} ms={ms:.4f} library_ms={library_ms:.4f} "
          f"(torch.matmul{' + the bias' if adds else ''} + masked_fill + torch.topk, timed in "
          f"turns) plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} by {bound_by} max_abs_err vs "
          f"plain={err:.3e}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


def nccl_phase(torch, lightgcn, simgcl, dense):
    """Run B: a one-rank NCCL group made through the port's own
    ``maybe_initialize_distributed`` from the ``QREC_*`` triplet (the code
    path of a user's multi-GPU run), and each route on its one-rank mesh,
    against the one-device path: two layers forward and backward of routes
    4 and 6, the InfoNCE of route 5, the ranking of route 7. The bits must
    be equal (a block of every row, of every item column, a shard of every
    contrastive row and of every test user, and collectives over one rank,
    which copy; route 6 scales the user half after its sum, as K1 scales
    it in-kernel)."""
    import socket

    import torch.distributed as dist

    from qrec_tpu_torch.data.graph import joint_normalized_adjacency
    from qrec_tpu_torch.ops.losses import infonce_dispatch
    from qrec_tpu_torch.ops.spmm import (
        ShardedDenseJoint,
        ShardedSparseJoint,
        SparseJoint,
        spmm,
    )
    from qrec_tpu_torch.ops.topk import CatalogRanker, ScoreForm
    from qrec_tpu_torch.parallel import mesh as M

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    triplet = {"QREC_COORDINATOR": f"localhost:{port}", "QREC_NUM_PROCESSES": "1",
               "QREC_PROCESS_ID": "0"}
    os.environ.update(triplet)
    try:
        if not M.maybe_initialize_distributed(None, "cuda"):
            fail("nccl: maybe_initialize_distributed made no group from the QREC_* triplet")
        backend = dist.get_backend()
        if backend != "nccl":
            fail(f"nccl: the port chose {backend} for a CUDA device")
        mesh = M.make_mesh()
        coo = joint_normalized_adjacency(lightgcn.data)
        g = torch.Generator(device="cuda").manual_seed(0)
        with torch.no_grad():
            ego = torch.cat([lightgcn.user_emb, lightgcn.item_emb])
        w = torch.randn(ego.shape, generator=g, device="cuda")
        def two_layers(adjs, ego, w):
            got = []
            for adj in adjs:
                x = ego.clone().requires_grad_(True)
                y = spmm(adj, spmm(adj, x))
                (y * w).sum().backward()
                got.append((y.detach(), x.grad))
            return all(torch.equal(a, b) for a, b in zip(*got))

        same4 = two_layers((SparseJoint.from_host(coo, "cuda", check_symmetric=False),
                            ShardedSparseJoint.from_host(coo, "cuda", mesh)), ego, w)
        whole = dense.joint_adj
        with torch.no_grad():
            ego = torch.cat([dense.user_emb, dense.item_emb])
        same6 = two_layers((whole, ShardedDenseJoint.from_joint(whole, mesh)), ego, w)
        form = ScoreForm(dense.U, dense.V)
        ranked = [CatalogRanker(dense.data, 10, "cuda", dense.rated_bitmask,
                                mesh=on).topk_device(form) for on in (None, mesh)]
        same7 = torch.equal(ranked[0][0], ranked[1][0]) and torch.equal(
            ranked[0][1].view(torch.int32), ranked[1][1].view(torch.int32))
        view1, view2, mask = first_step_views(torch, simgcl)
        got = []
        for on in (None, mesh):
            a1, a2 = view1.clone().requires_grad_(True), view2.clone().requires_grad_(True)
            loss = infonce_dispatch(a1, a2, mask, TEMP, on)
            loss.backward()
            got.append((loss.detach(), a1.grad, a2.grad))
        same5 = all(torch.equal(a, b) for a, b in zip(*got))
        print(f"[parallel nccl] a {dist.get_world_size()}-rank {backend} group from the QREC_* "
              f"triplet, mesh {mesh.shape}: route 4 (two layers, forward and backward) bit-equal "
              f"to the one-device path={same4}; route 5 (B={view1.shape[0]}) bit-equal={same5}; "
              f"route 6 (two layers, forward and backward) bit-equal={same6}; route 7 "
              f"({len(dense.data.test_set_u)} test users) bit-equal={same7}", flush=True)
        if not (same4 and same5 and same6 and same7):
            fail("nccl: a route on the one-rank mesh is not bit-equal to the one-device path")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key in triplet:
            os.environ.pop(key, None)


def same_config(a: dict, b: dict) -> bool:
    """Whether two runs' configs make one run: the same keys and values,
    but ``parallel.setup`` and ``output.setup``, a data file's path equal
    or naming a file of the same bytes."""
    import filecmp

    skip = ("parallel.setup", "output.setup")
    a = {k: v for k, v in a.items() if k not in skip}
    b = {k: v for k, v in b.items() if k not in skip}
    same_file = lambda x, y: (os.path.isfile(x) and os.path.isfile(y)  # noqa: E731
                              and filecmp.cmp(x, y, shallow=False))
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (k in ("ratings", "social") and same_file(a[k], b[k])) for k in a)


def parallel_phases(torch, K, QRec, conf_of, tmp, trust_path, one_process=None):
    """Slices 7a-7f on the card. Run A: each run of ``PARALLEL_RUNS`` in
    one process (where ``parallel.setup`` builds no mesh), then on four
    ranks on cuda:0 over a gloo group that this script makes
    (``parallel_rank``): data 2 x model 2, so K5 runs on row blocks and K1
    on item-column blocks at width 25 (75 for SimGCL's fused views), K3/K4
    on half the contrastive rows and K2 on a quarter of the test users; the
    social models read ``trust_path``, the rating models a FilmTrust-shaped
    file (with :func:`filmtrust_trust` for the social ones); the models of
    ``REPLICATED`` train whole on every rank, those of ``DATA_PARALLEL``
    data-parallel with no joint adjacency (ESRF data-parallel on
    K1's column blocks), and "wrmf auto" leaves
    ``parallel.setup`` out; a run that an earlier phase made in one
    process with the same config (``one_process``) is not made again.
    Holds every rank's launches against ``expected_launches``, its mesh
    (data 2 x model 2, "wrmf auto" too), rank 0 alone writing the result
    files, the ranks' digests of what each model scores from equal bit for
    bit, the measures within 2e-2 and
    the first epoch's loss within rtol 1e-4 of the one-process run, and
    each route against its plain twin; then the lifecycle runs
    (``PARALLEL_LIFECYCLE``) against the unbroken ``lightgcn`` run, bit for
    bit, with rank 0 alone writing; times each route's kernel on one rank's
    share (``shard_timings``, and route 7 on IRGAN's and SVD's biased
    forms and on APR's factors). The four ranks share one card and gloo carries their
    collectives through host memory: this checks the routes, not their
    scaling. Run B: ``nccl_phase``. Returns (kernels-line entries, launches
    summed over the ranks, the K2 launches on a biased form by run)."""
    import pickle

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    from qrec_tpu_torch.ops.metrics import parse_measure

    t_phase = time.perf_counter()
    users, items, ratings = filmtrust_records()
    filmtrust = os.path.join(tmp, "filmtrust_parallel.txt")
    with open(filmtrust, "w") as f:
        f.writelines(f"{a} {b} {r}\n" for a, b, r in zip(users, items, ratings))
    film_trust = os.path.join(tmp, "filmtrust_trust_parallel.txt")
    with open(film_trust, "w") as f:
        f.writelines(f"{a} {b} 1\n" for a, b in filmtrust_trust())
    files = {"FILMTRUST": filmtrust, "FILMTRUST_TRUST": film_trust}
    runs, one = [], {}
    for label, name, epochs, extra in PARALLEL_RUNS:
        conf = conf_of(name, epochs)
        conf["parallel.setup"] = "on -model 2"
        if conf.contains("social"):
            conf["social"] = trust_path
        for key, value in extra.items():
            if value is None:
                conf.config.pop(key)
            else:
                conf[key] = files.get(value, value)
        runs.append((label, dict(conf.config)))
        earlier = (one_process or {}).get(label)
        if earlier is not None and same_config(earlier["conf"], conf.config):
            # an earlier phase ran the same config in one process: reuse it
            # (the walk models' SGNS host build is most of their run)
            one[label] = {k: v for k, v in earlier.items() if k != "conf"}
            print(f"[parallel {label} one process] an earlier phase's run of the same config: "
                  f"losses {one[label]['losses']}", flush=True)
            continue
        model, _, parsed = drive(torch, K, QRec, conf, f"parallel {label} one process")
        if model.mesh is not None:
            fail(f"parallel {label}: one process built a mesh")
        one[label] = one_process_record(conf, model, parsed)
        if label in KEPT:
            one[label]["model"] = model
        del model
        gc.collect()
        torch.cuda.empty_cache()
    life_dir = os.path.join(tmp, "parallel_lifecycle")
    saved = os.path.join(life_dir, "lightgcn")
    lifecycle = []
    for label, epochs, ckpt, setup in PARALLEL_LIFECYCLE:
        conf = dict(dict(runs)["lightgcn"], **{"num.max.epoch": str(epochs)})
        if ckpt:
            conf["checkpoint.setup"] = f"on -dir {os.path.join(life_dir, 'ck')} -every 1"
        if setup:
            conf["model.setup"] = f"{setup} {saved}"
        lifecycle.append((label, conf, setup))
    out_dir = os.path.join(tmp, "ranks")
    os.makedirs(out_dir)
    print(f"[parallel] this script makes a gloo group of {PARALLEL_RANKS} ranks on cuda:0 "
          f"(NCCL refuses two ranks on one device; the port itself picks NCCL for a CUDA "
          f"device): {SHARED}, gloo carrying the collectives through host memory", flush=True)
    t0 = time.perf_counter()
    try:
        mp.spawn(parallel_rank, args=(os.path.join(out_dir, "store"), runs, lifecycle, out_dir),
                 nprocs=PARALLEL_RANKS, join=True)
    except ProcessException as e:
        for r in range(PARALLEL_RANKS):
            log = os.path.join(out_dir, f"rank{r}.log")
            if os.path.exists(log):
                with open(log) as f:
                    print(f"[parallel rank {r} log tail]\n" + f.read()[-3000:], flush=True)
        fail(f"parallel_phases: a rank failed: {e}")
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(PARALLEL_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    launches = {k.name: 0 for k in K.KERNELS}
    errs, biased = {}, {}
    for label, _ in runs:
        first = ranks[0][label]
        for r, got in enumerate(ranks):
            g = got[label]
            print(f"[parallel {label} rank {r}] mesh {g['mesh']} place (data, model)="
                  f"{g['place']}; {g['shares']}; epoch ms ({SHARED}): "
                  f"{[round(t, 1) for t in g['epoch_ms']]}; losses {g['losses']}; host build s="
                  f"{g['graph_s']}; result files written {len(g['writes'])}; run, checks and "
                  f"digests s={g['wall_s']:.2f}", flush=True)
            check_counts(f"parallel {label} rank {r}", g["counts"], g["expect"])
            for k, n in g["counts"].items():
                launches[k] += n
            for route, err in g["errs"].items():
                errs[route] = max(errs.get(route, 0.0), err)
            if "topk user shards biased" in g["errs"]:
                biased[label] = biased.get(label, 0) + g["counts"]["masked_catalog_topk"]
            if g["mesh"] != {"data": 2, "model": 2}:
                fail(f"parallel {label}: rank {r} built the mesh {g['mesh']}")
            if len(g["writes"]) != (2 if r == 0 else 0):
                fail(f"parallel {label}: rank {r} wrote {g['writes']}")
            if g["held"] != first["held"] or g["losses"] != first["losses"] or (
                    g["measure"] != first["measure"]):
                fail(f"parallel {label}: rank {r}'s tables, losses or measures differ from "
                     f"rank 0's")
        got, want = parse_measure(first["measure"]), one[label]["parsed"]
        top = next((k for k in got if k.startswith("Top ")), "global")
        names = ("Precision", "Recall", "NDCG") if top != "global" else ("MAE", "RMSE")
        gap = max(abs(got[top][m] - want[m]) for m in names)
        loss1 = one[label]["losses"][0] if one[label]["losses"] else None
        steady = lambda ms: [round(t, 1) for t in ms]  # noqa: E731
        print(f"[parallel {label}] the ranks' held tables ({len(first['held'])} digests), "
              f"losses and measures equal bit for bit; {top} on 4 ranks {got[top]} one process "
              f"{want}: largest gap {gap:.3e} (bound 2e-2); first epoch loss 4 ranks "
              f"{first['losses'][0] if first['losses'] else None} one process {loss1} (rtol "
              f"1e-4); epoch ms 4 ranks {steady(first['epoch_ms'])} one process "
              f"{steady(one[label]['epoch_ms'])}; epoch ms per phase 4 ranks "
              f"{phase_text(first['phase_ms'])} one process {phase_text(one[label]['phase_ms'])} "
              f"({PHASE_KINDS}); host build s 4 ranks {first['graph_s']} one process "
              f"{one[label]['graph_s']}", flush=True)
        if "flag_ms" in first:
            f = first["flag_ms"]
            print(f"[parallel {label}] GMF-phase steps on rank 0 ({SHARED}), {f['steps']} a turn "
                  f"in turns: ms a step with the flag read {f['flag read']:.3f}, with zero "
                  f"gradients in its place {f['no flag read']:.3f}; {f['steps_per_epoch']} steps "
                  f"an epoch, so the flag read's share of a GMF epoch is about "
                  f"{(f['flag read'] - f['no flag read']) * f['steps_per_epoch']:.1f} ms",
                  flush=True)
        if not gap < 2e-2:
            fail(f"parallel {label}: the measures on 4 ranks are {gap} from one process's")
        if loss1 is not None and not math.isclose(first["losses"][0], loss1, rel_tol=1e-4):
            fail(f"parallel {label}: the first epoch's loss is not the one process's")
    for r, got in enumerate(ranks):
        unbroken, (stopped, resumed, loaded) = got["lightgcn"], (
            got[label] for label, _, _, _ in PARALLEL_LIFECYCLE)
        for label, _, _, _ in PARALLEL_LIFECYCLE:
            check_counts(f"parallel {label} rank {r}", got[label]["counts"], got[label]["expect"])
            for k, n in got[label]["counts"].items():
                launches[k] += n
        same = (stopped["resumed"] is None and resumed["resumed"] == 1
                and stopped["losses"] == unbroken["losses"][:1]
                and resumed["losses"] == unbroken["losses"][1:]
                and resumed["measure"] == unbroken["measure"]
                and resumed["held"] == unbroken["held"])
        # a loaded model holds the saved U and V, its parameters untrained
        same_load = loaded["measure"] == resumed["measure"] and all(
            loaded["held"][k] == resumed["held"][k] for k in ("U", "V"))
        writes = got["lifecycle writes"]
        writer = writes == (dict(steps=[1, 2], savez=[saved]) if r == 0 else
                            dict(steps=[], savez=[]))
        print(f"[parallel lifecycle rank {r}] stopped losses {stopped['losses']}, resumed from "
              f"step {resumed['resumed']} losses {resumed['losses']}, unbroken "
              f"{unbroken['losses']}: tables, U, V, losses and measures bit-equal={same}; "
              f"-load measures and factors equal the saving run's={same_load}; this rank wrote "
              f"steps {writes['steps']} and {len(writes['savez'])} npz", flush=True)
        if not (same and same_load and writer):
            fail(f"parallel lifecycle: rank {r} resumed, loaded or wrote otherwise than "
                 f"expected")
    steps = sorted(os.listdir(os.path.join(life_dir, "ck")))
    if steps != ["step_1.pt", "step_2.pt"] or not os.path.exists(saved + ".npz"):
        fail(f"parallel lifecycle: the shared directory holds {steps}")
    print(f"[parallel] routes against their plain twins on the card, max_abs_err "
          f"{json.dumps(errs)}; launches summed over the ranks {json.dumps(launches)}; spawn to "
          f"join {spawn_s:.1f} s ({SHARED})", flush=True)
    timer = Timer(torch)
    timings = shard_timings(torch, K, timer, one["lightgcn-pallas"]["model"],
                            one["simgcl-pallas"]["model"], one["lightgcn"]["model"])
    # route 7 on a biased form: IRGAN's item bias at d=20, SVD's user and
    # item biases and global mean at d=10
    timings["topk biased"] = user_shard_timing(torch, K, timer, one["irgan"]["model"],
                                               label=" biased")
    timings["topk biased svd"] = user_shard_timing(torch, K, timer, one["svd ranked"]["model"],
                                                   label=" biased svd")
    # and on APR's factors (d=50, plain): the one data-parallel path of
    # slice 7f that ranks through route 7 with no joint adjacency
    user_shard_timing(torch, K, timer, one["apr"]["model"], label=" apr")
    for key, route in (("segment", "segment row blocks"), ("infonce", "infonce row shards"),
                       ("dense", "dense column blocks"), ("topk", "topk user shards"),
                       ("topk biased", "topk user shards biased"),
                       ("topk biased svd", "topk user shards biased")):
        timings[key]["max_abs_err"] = max(errs[route], timings[key].get("max_abs_err", 0.0))
    del timer
    nccl_phase(torch, one["lightgcn-pallas"]["model"], one["simgcl-pallas"]["model"],
               one["lightgcn"]["model"])
    print(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return timings, launches, biased


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
    form (or on a rank's item-column block of it), K5 on the sparse one (or
    on a rank's row block of it), none on a ``DeviceCOO`` (torch ops)."""
    from qrec_tpu_torch.ops.spmm import (
        DenseJoint,
        ShardedDenseJoint,
        ShardedSparseJoint,
        SparseJoint,
    )

    return ("bipartite_dual_matmul" if isinstance(adj, (DenseJoint, ShardedDenseJoint)) else
            "weighted_segment_matmul" if isinstance(adj, (SparseJoint, ShardedSparseJoint))
            else None)


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
    (torch ops, as the JAX package ranks them through XLA). On a mesh
    (``parallel_phases``) every rank launches where one device does: K1
    once a propagation on its item-column block (and once a node-drop
    view's degrees), K5 once a propagation on its row block (BUIR's views:
    3n a step, as on one device), K3 and K4 once a loss on its rows; K2
    once a batch of its own share of the test users (ceil(n_loc /
    eval_batch_size) a ranking); MHCN, DiffNet and DHCF hold their
    operators whole on every rank, so K2 alone; the models trained whole
    on every rank (slice 7d) and the bold-driver family (slice 7e) launch
    K2 alone, on their share, where one device ranks through it. A
    captured CUDA graph's kernels count at every replay
    (``ops/kernels.GraphLaunches``) and its warm-up's not at all, so a
    captured run launches what its per-step twin does: the chunked runs,
    and since slice 11 ESRF's phase graphs (2 epochs a phase in
    ``own_loop_phases``: 2·38·(4 + 4 + 7) + 2 = 1,142 K1) and BUIR's epoch
    graph (4 epochs: 6·38·4 = 912 K5)."""
    import torch.distributed as dist

    from qrec_tpu_torch.models.adversarial_social import ESRF
    from qrec_tpu_torch.models.graph import LightGCN
    from qrec_tpu_torch.models.social_graph import BUIR, SEPT, _GraphModel
    from qrec_tpu_torch.ops.kernels import KERNELS
    from qrec_tpu_torch.ops.spmm import ShardedSparseJoint, SparseJoint
    from qrec_tpu_torch.ops.topk import ScoreForm
    from qrec_tpu_torch.parallel.collectives import split_sizes

    test_users = len(model.data.test_set_u)
    if model.mesh is not None:
        test_users = split_sizes(test_users, dist.get_world_size())[dist.get_rank()]
    evals = math.ceil(test_users / model.eval_batch_size)
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
            if isinstance(model.view_adj, (SparseJoint, ShardedSparseJoint)):
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
        kind = "mean after epoch 1" if len(model.timer.times) > 1 else "one epoch: its first"
        print(f"[{label}] epoch ms: {[round(t * 1e3, 3) for t in model.timer.times]} steady_epoch_ms="
              f"{summary['epoch_seconds'] * 1e3:.3f} ({kind}) examples_per_s="
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
    # (a phase too short for the check is named here, and falls_coverage
    # fails the script if no run of the model checks it)
    if model.timer is not None:
        name = model.model_name
        skip = MINIMAX_PHASES.get(name, ())
        reseeded = RESEEDED_PHASES.get(name, ())
        short = []
        for k, phase in enumerate(getattr(model, "phase_losses", None) or [losses]):
            first = 1 if k in reseeded else 0
            if k in skip or not phase:
                continue
            if len(phase) <= first + 1:
                short.append(k)
                FALLS["short"].setdefault(name, set()).add(k)
                continue
            FALLS["checked"].setdefault(name, set()).add(k)
            if not phase[-1] < phase[first]:
                fail(f"{label}: loss did not decrease in phase {k + 1}: {phase}")
        if short:
            print(f"[{label}] loss falls: unchecked in phase(s) {[k + 1 for k in short]}, too few "
                  f"epochs", flush=True)
    if (tracker is not None) != getattr(model, "track_best", False):
        fail(f"{label}: best-epoch tracking is {'off' if tracker is None else 'on'}")
    return model, counts, parsed


def falls_coverage() -> None:
    """Fails the script where a phase that drive found too short for its
    loss-falls check was checked in no other run of the model and is not
    one of ``SHORT_PHASES``: a cut of depth cannot turn the check off
    unnoticed."""
    missing = {name: sorted(k + 1 for k in ks - FALLS["checked"].get(name, set())
                            - set(SHORT_PHASES.get(name, ())))
               for name, ks in FALLS["short"].items()}
    missing = {name: ks for name, ks in missing.items() if ks}
    print(f"[loss falls] checked in {len(FALLS['checked'])} models; unchecked by design "
          f"(SHORT_PHASES, phases from 1) "
          f"{ {n: [k + 1 for k in ks] for n, ks in SHORT_PHASES.items()} }; unchecked "
          f"otherwise {missing}", flush=True)
    if missing:
        fail(f"no run checks that the loss falls in these phases: {missing}")


def phase_ms(model) -> list:
    """Each training phase's epoch ms of ``model`` (its one timer's where
    it trains no phases) as [ms, kind]: "steady", the mean after the
    phase's first epoch, or "first" where the phase trained one epoch (its
    warm-up included, and the first phase's first-step costs)."""
    timers = getattr(model, "phase_timers", None) or ([model.timer] if model.timer else [])
    return [[round(t.steady_state() * 1e3, 3), "steady" if len(t.times) > 1 else "first"]
            for t in timers]


def phase_text(phases) -> str:
    """``phase_ms``'s list as "[1063.4 first, 84.2 steady]"."""
    return "[" + ", ".join(f"{ms:.1f} {kind}" for ms, kind in phases) + "]"


# how phase_text's kinds read, beside every print of it
PHASE_KINDS = ("steady: the mean after a phase's first epoch; first: a phase's one epoch, its "
               "warm-up included")


def one_process_record(conf, model, measures) -> dict:
    """What ``parallel_phases`` holds its four ranks against, from a
    one-process run of the same config in an earlier phase: the config,
    the measures, the epoch losses and ms (and the steady ms of each
    phase) and the host build s."""
    return dict(conf=dict(conf.config), parsed=measures,
                losses=list(getattr(model, "epoch_losses", [])),
                epoch_ms=[t * 1e3 for t in model.timer.times] if model.timer else [],
                phase_ms=phase_ms(model),
                graph_s=getattr(model, "graph_seconds", None))


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


def device_ms_by_name(prof) -> dict:
    """Device time by kernel name (ms) of a finished torch.profiler run,
    summed over its device activities but user annotations (the
    optimizer's step range spans kernels already counted): what
    ``key_averages()``'s device rows hold, read from the profiler's raw
    events, whose conversion to ``key_averages()`` took tens of seconds on
    a chunk of graph replays."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return out


def profile_epoch(torch, model, label, epoch=None):
    """One more training epoch under torch.profiler: device time by kernel
    and the device's busy share of the epoch's wall time, with the InfoNCE
    kernels' and K5's device ms. ``epoch`` runs the epoch (by default one
    epoch of the model's single-phase spec)."""
    from torch.profiler import ProfilerActivity, profile

    from qrec_tpu_torch.runtime import trainer as T

    if epoch is None:
        spec = model.build()
        gen = torch.Generator(device="cuda").manual_seed(0)
        epoch = lambda: T.train(  # noqa: E731
            spec.params, spec.loss_fn, spec.sampler, max_epoch=1, lr=model.lrate,
            device=model.device, mode=spec.mode, max_lr=model.max_lrate, generator=gen,
            examples_per_epoch=model.train_size,
            capturable=spec.chunkable and spec.mode == "adam")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_ms_by_name(prof)
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


def chunk_record(model) -> dict:
    """What ``chunk_phases`` holds a ``train.chunk=1`` run against, from a
    run of the same config: its losses, trained parameters, final factors,
    best epoch, measures and parameters, and its chunk statistics (CUDA
    graphs and their capture s, the (wall s, epochs) of every chunk)."""
    t = getattr(model, "tracker", None)
    timer = model.timer
    clone = lambda x: None if x is None else x.detach().clone()  # noqa: E731
    return dict(
        losses=list(model.epoch_losses),
        params={k: v.detach().clone() for k, v in model.named_parameters()},
        U=clone(model.U), V=clone(model.V),
        best=None if t is None else (t.best_epoch, dict(t.best_metrics),
                                     [b.clone() for b in t.best_params]),
        graphs=sum(len(pt.captures) for pt in model.phase_timers),
        capture_s=sum(sum(pt.captures) for pt in model.phase_timers),
        phase_captures=[list(pt.captures) for pt in model.phase_timers],
        chunks=[c for pt in model.phase_timers for c in pt.chunks],
        phase_chunks=[[e for _, e in pt.chunks] for pt in model.phase_timers],
        times=list(timer.times))


# the epochs of each run_training phase of a model trained for E epochs
# (the JAX package's phase lengths): one phase of E where not listed
PHASE_EPOCHS = {
    "NeuMF": lambda e: [e, max(1, e // 2), max(1, e // 5)],
    "APR": lambda e: [max(1, e // 2)] * 2,
    "SEPT": lambda e: [max(1, int(e / 3)), max(1, e - max(1, int(e / 3)))],
}


def check_chunked(label, rec, epochs: int, chunk: int = 8, name: str = "") -> None:
    """A run that ``train.chunk=auto`` chunked: one CUDA graph for each
    phase of more than one epoch (``PHASE_EPOCHS`` of ``name``'s ``epochs``),
    each chunk's epochs as ``train`` cut them, a phase of one epoch per
    epoch (``profile_chunk`` counts a chunk's host reads)."""
    phases = PHASE_EPOCHS.get(name, lambda e: [e])(epochs)
    want = [[min(chunk, n - k) for k in range(0, n, chunk)] if n > 1 else [1] for n in phases]
    graphs = sum(n > 1 for n in phases)
    got = rec["phase_chunks"]
    print(f"[chunk {label}] graphs={rec['graphs']} capture_s={rec['capture_s']:.3f} (warm-up "
          f"epoch included; by phase {[[round(c, 3) for c in p] for p in rec['phase_captures']]}) "
          f"chunks(epochs) by phase={got} "
          f"chunk_wall_ms={[round(w * 1e3, 3) for w, _ in rec['chunks']]}", flush=True)
    if got != want or rec["graphs"] != graphs:
        fail(f"{label}: chunks {got} (expected {want}), graphs {rec['graphs']} (expected "
             f"{graphs})")


def compare_chunk_runs(torch, label, auto, one) -> dict:
    """``train.chunk=auto`` against ``1`` on the card: losses, trained
    parameters, final factors, best epoch, measures and parameters, bit for
    bit. Both loops run every epoch through ``trainer.run_epoch`` with
    capturable Adam and one generator stream; a CUDA graph replays the
    eager epoch's kernels on the same operands, and every kernel on the
    path repeats bit for bit (the K1-K5 phases check it), so the bound is
    0."""
    gaps = {"losses": max((abs(a - b) for a, b in zip(auto["losses"], one["losses"])),
                          default=0.0)}
    for name in auto["params"]:
        gaps[name] = (auto["params"][name] - one["params"][name]).abs().max().item()
    same = (auto["losses"] == one["losses"]
            and all(torch.equal(auto["params"][k], one["params"][k]) for k in auto["params"]))
    for k in ("U", "V"):  # final factors, where the model keeps them
        if auto[k] is None or one[k] is None:
            same = same and auto[k] is None and one[k] is None
            continue
        gaps[k] = (auto[k] - one[k]).abs().max().item()
        same = same and torch.equal(auto[k], one[k])
    if auto["best"] is not None:
        (ea, ma, pa), (eo, mo, po) = auto["best"], one["best"]
        gaps["best params"] = max((a - b).abs().max().item() for a, b in zip(pa, po))
        same = same and ea == eo and ma == mo and all(torch.equal(a, b) for a, b in zip(pa, po))
        print(f"[chunk {label}] best epoch auto {ea} / 1 {eo}; measures auto {ma} / 1 {mo}",
              flush=True)
    print(f"[chunk {label}] train.chunk=auto vs 1: bit-identical={same}; largest gaps "
          f"{ {k: f'{v:.3e}' for k, v in gaps.items()} } (bound 0)", flush=True)
    if not same:
        fail(f"{label}: train.chunk=auto and 1 disagree: {gaps}")
    return gaps


def spec_loop(torch, model, chunk: int, phase=None):
    """(loop state, ``ChunkedLoop`` of ``chunk`` epochs) over ``model``'s
    spec (or ``phase`` = (params, loss, sampler, evaluate or None)) on
    capturable Adam from a generator seeded 0, the vote with a tracked
    spec, as ``train`` builds them."""
    from qrec_tpu_torch.runtime import trainer as T
    from qrec_tpu_torch.runtime.profiling import StepTimer

    if phase is None:
        spec = model.build()
        phase = (spec.params, spec.loss_fn, spec.sampler,
                 (lambda: model.quick_eval_vector(spec)) if spec.track_best else None)
    params, loss_fn, sampler, evaluate = phase
    gen = torch.Generator(device="cuda").manual_seed(0)
    opt = T.make_optimizer(params, "adam", model.lrate)
    T.make_capturable(opt)
    T.init_adam_state(opt)
    vote = T.DeviceVote(params, T.BestTracker(), 0) if evaluate is not None else None
    st = T.LoopState(0, params, opt, gen, vote)
    prog = T.EpochProgram(st, loss_fn, sampler, "cuda", evaluate=evaluate)
    loop = T.ChunkedLoop(prog, chunk, timer=StepTimer(model.train_size, "cuda"), emit=None,
                         lr=model.lrate)
    return st, loop


def host_reads(torch, loop, st, until: int) -> int:
    """The host reads of ``loop.run(st, until)`` as CUDA's sync-debug mode
    "warn" reports them, with the timer's own synchronisations off."""
    from qrec_tpu_torch.runtime.profiling import StepTimer

    loop.timer = StepTimer(loop.timer.examples_per_epoch)
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loop.run(st, until)
        finally:
            torch.cuda.set_sync_debug_mode(before)
    return sum("called a synchronizing" in str(w.message) for w in caught)


def chunk_host_reads(torch, model, label, chunk: int = 4) -> int:
    """One chunk of ``chunk`` epochs of ``model``'s spec, its graph captured
    by a first chunk: its host reads (1, or the script fails)."""
    st, loop = spec_loop(torch, model, chunk)
    loop.run(st, chunk)
    reads = host_reads(torch, loop, st, 2 * chunk)
    if reads != 1:
        fail(f"{label}: {reads} host reads in one chunk, expected 1")
    return reads


def profile_chunk(torch, model, label, chunk: int = 8, phase=None) -> dict:
    """One chunk of ``chunk`` epochs (the model's spec, or ``phase`` =
    (params, loss, sampler, evaluate or None) for a phase of a multi-phase
    model; its CUDA graph captured and replayed for one epoch first) under
    torch.profiler: the device's busy share of the chunk's wall, as
    ``profile_epoch`` reads an epoch's; then the host reads of one more
    chunk (1, or the script fails). With a tracked spec the chunk holds the
    quick evaluation and the vote."""
    from torch.profiler import ProfilerActivity, profile

    st, loop = spec_loop(torch, model, chunk, phase)
    loop.run(st, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run(st, 1 + chunk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    busy = sum(device_ms_by_name(prof).values())
    processing_s = time.perf_counter() - t0
    # the host reads of one more chunk
    capture_s = loop.timer.captures[0]
    reads = host_reads(torch, loop, st, 1 + 2 * chunk)
    print(f"[profile chunk {label}] one chunk of {chunk} epochs (CUDA graph replays) under "
          f"torch.profiler: wall_ms={wall_ms:.3f} ({wall_ms / chunk:.3f} an epoch) "
          f"device_busy_ms={busy:.3f} busy_share={busy / wall_ms:.3f} host_reads={reads} "
          f"(capture_s={capture_s:.3f}, a one-epoch chunk first; the profiler's processing "
          f"{processing_s:.1f} s)", flush=True)
    if reads != 1:
        fail(f"{label}: {reads} host reads in one chunk, expected 1")
    return dict(wall_ms=wall_ms, busy_ms=busy, share=busy / wall_ms, host_reads=reads)


def graph_kernel_checks(torch, K, lightgcn, simgcl, yelp) -> None:
    """Each kernel of the chunked path called inside a CUDA graph on the
    main path's operands (K1: LightGCN's first layer; K2: its first batch of
    test users on its final factors; K3/K4: SimGCL's first step's views;
    K5: the yelp2018 run's first layer): the replayed result equals the
    eager call's bit for bit, and stands against the plain version with
    the tolerance of that kernel's own phase. Launches made here are put
    back: they are no launches of a run."""
    from qrec_tpu_torch.ops.losses import _l2n
    from qrec_tpu_torch.ops.spmm import segment_operand

    adj = lightgcn.joint_adj
    with torch.no_grad():
        x = torch.cat([lightgcn.user_emb, lightgcn.item_emb]).contiguous()
    ranker = lightgcn._quick_ranker()
    uids = ranker._uids[: lightgcn.eval_batch_size]
    v1, v2, mask = first_step_views(torch, simgcl)
    with torch.no_grad():
        v1, v2 = _l2n(v1).contiguous(), _l2n(v2).contiguous()
    m = mask.float().contiguous()
    yadj = yelp.joint_adj
    with torch.no_grad():
        xs = segment_operand(torch.cat([yelp.user_emb, yelp.item_emb]))
    calls = {
        "bipartite_dual_matmul": (
            lambda: K.factored_dual_matmul(adj.r, x, adj.row_scale, adj.col_scale),
            lambda: K.factored_dual_matmul_plain(adj.r, x, adj.row_scale, adj.col_scale),
            (1e-5, 1e-5)),
        "masked_catalog_topk": (
            lambda: K.masked_catalog_topk(lightgcn.U, lightgcn.V, lightgcn.rated_bitmask, uids,
                                          ranker.global_mean, 10)[1],
            lambda: K.masked_catalog_topk_plain(lightgcn.U, lightgcn.V, lightgcn.rated_bitmask,
                                                uids, ranker.global_mean, 10)[1],
            (0.0, 1e-5)),
        "infonce_fwd": (lambda: K.infonce_fwd(v1, v2, m, m, TEMP)[1],
                        lambda: K.infonce_fwd_plain(v1, v2, m, m, TEMP)[1], (1e-5, 1e-5)),
        "infonce_bwd": (
            lambda: torch.cat(K.infonce_bwd(v1, v2, m, m, K.infonce_fwd_plain(
                v1, v2, m, m, TEMP)[1], TEMP)),
            lambda: torch.cat(K.infonce_bwd_plain(v1, v2, m, m, K.infonce_fwd_plain(
                v1, v2, m, m, TEMP)[1], TEMP)), (1e-4, 1e-5)),
        "weighted_segment_matmul": (
            lambda: K.weighted_segment_matmul(xs, yadj.indptr, yadj.cols, yadj.vals,
                                              yadj.schedule),
            lambda: K.weighted_segment_matmul_plain(xs, yadj.indptr, yadj.cols, yadj.vals),
            (1e-5, 1e-5)),
    }
    graph_call_checks(torch, K, calls)


def graph_call_checks(torch, K, calls, label: str = "") -> None:
    """``calls`` maps a kernel's name to (its call, its plain version,
    (rtol, atol relative to the plain result's largest entry)): each call is
    captured in a CUDA graph (after a warm-up call on the capture's stream)
    and replayed twice; its result must equal the eager call's bit for bit
    and the plain version's within the tolerance, with one launch captured.
    Launches made here are put back."""
    counts = K.launch_counts()
    for name, (fn, plain, (rtol, atol_rel)) in calls.items():
        eager = fn()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        launches = K.GraphLaunches()
        with launches.record(), torch.cuda.graph(graph, stream=stream):
            out = fn()
        graph.replay()
        graph.replay()
        want = plain()
        torch.cuda.synchronize()
        same = torch.equal(out, eager)
        err = (out - want).abs().max().item()
        atol = atol_rel * max(want.abs().max().item(), 1.0)
        ok = torch.allclose(out, want, rtol=rtol, atol=atol)
        print(f"[graph {name}{label}] in a CUDA graph ({launches.counts.get(name, 0)} launch captured, "
              f"2 replays): equal to the eager call bit for bit={same}; max_abs_err vs plain "
              f"{err:.3e} (rtol {rtol} atol {atol:.3e}) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not same or not ok or launches.counts.get(name, 0) != 1:
            fail(f"{name}{label} inside a CUDA graph: bit-equal {same}, within tolerance {ok}")
        del graph
    K.set_launch_counts(counts)


def lap_timer(start=None):
    """(laps, lap): ``lap(name)`` records the seconds since the last lap
    (the first since ``start``, by default now)."""
    laps, last = {}, [time.perf_counter() if start is None else start]

    def lap(name):
        laps[name] = round(time.perf_counter() - last[0], 1)
        last[0] = time.perf_counter()

    return laps, lap


def per_epoch_reruns(torch, K, QRec, runs, lap, keep=None) -> tuple:
    """``runs`` maps a label to (conf, its ``train.chunk=auto`` run's
    ``chunk_record``, epochs, model name): each such run is checked as
    chunked (a graph a phase of more than one epoch, ``check_chunked``),
    then run again under ``train.chunk=1`` (through ``drive``: launches
    against ``expected_launches``, losses that fall) and held to it bit for
    bit. Returns (the gaps by label, the ``train.chunk=1`` models of the
    labels in ``keep``, every label's where it is None)."""
    out, models = {}, {}
    for label, (conf, rec, epochs, name) in runs.items():
        check_chunked(label, rec, epochs, name=name)
        one = conf.__class__(dict(conf.config))
        one["train.chunk"] = "1"
        model, _, _ = drive(torch, K, QRec, one, f"{label} chunk=1")
        out[label] = compare_chunk_runs(torch, label, rec, chunk_record(model))
        if keep is None or label in keep:
            models[label] = model
        del model
        lap(f"{label} chunk=1")
    return out, models


def chunk_phases(torch, K, QRec, runs) -> dict:
    """Slice 8: ``train.chunk``. The runs of ``runs`` (``per_epoch_reruns``)
    against ``train.chunk=1``; then LightGCN's steady epoch ms under both
    (12 epochs), in turns, one profiled chunk of each path, and each kernel
    inside a CUDA graph against its plain version."""
    laps, lap = lap_timer()
    out, models = per_epoch_reruns(torch, K, QRec, runs, lap)
    graph_kernel_checks(torch, K, models["main"], models["simgcl"], models["yelp-pallas"])
    lap("kernels in graphs")
    # steady epoch ms, in turns: mean of epochs 9-12 (the second chunk)
    conf = runs["main"][0].__class__(dict(runs["main"][0].config))
    conf["num.max.epoch"] = "12"
    steady = {"auto": [], "1": []}
    for _ in range(2):
        for chunk in ("auto", "1"):
            conf["train.chunk"] = chunk
            rec = QRec(conf)
            rec.execute()
            times = rec.model.timer.times
            steady[chunk].append(float(np.mean(times[8:12])) * 1e3)
            del rec
    print(f"[chunk timing] LightGCN main path, 12 epochs, in turns (auto, 1, auto, 1): steady "
          f"epoch ms (mean of epochs 9-12) train.chunk=auto {[round(t, 3) for t in steady['auto']]} "
          f"train.chunk=1 {[round(t, 3) for t in steady['1']]}", flush=True)
    out["steady"] = steady
    lap("timing in turns")
    out["profile"] = {
        "LightGCN": profile_chunk(torch, models["main"], "LightGCN"),
        "SimGCL": profile_chunk(torch, models["simgcl"], "SimGCL"),
        "yelp-pallas": profile_chunk(torch, models["yelp-pallas"], "LightGCN yelp2018 pallas",
                                     chunk=2),
    }
    profile_epoch(torch, models["simgcl"], "SimGCL with its quick evaluation",
                  epoch=lambda: eval_epoch(torch, models["simgcl"]))
    lap("profiles")
    print(f"[chunk phases] seconds {json.dumps(laps)}", flush=True)
    return out


def eval_epoch(torch, model) -> None:
    """One per-epoch-loop epoch of ``model``'s spec with its quick
    evaluation and vote, as ``train.chunk=1`` runs a tracked epoch."""
    from qrec_tpu_torch.runtime import trainer as T

    spec = model.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    T.train(spec.params, spec.loss_fn, spec.sampler, max_epoch=1, lr=model.lrate,
            device=model.device, generator=gen, examples_per_epoch=model.train_size,
            quick_eval=lambda: model.quick_eval(spec), tracker=T.BestTracker(), capturable=True)


# the models whose run_training phases chunk since slice 9, with their
# one-process runs in deep_phases (CDAE) and social_phases (the four)
CHUNKED_FAMILY = ("MHCN", "SEPT", "DiffNet", "DHCF", "CDAE")


def turns_timing(torch, model, label, phase, epochs: int = 4, per_epoch: int = 3) -> dict:
    """Steady epoch ms of one phase of ``model`` (``phase`` = (params, loss,
    sampler, evaluate or None, quick_eval or None)) through
    ``trainer.train`` as ``run_training`` calls it, in turns:
    ``train.chunk=auto`` (``epochs`` epochs, one chunk, after its capture),
    ``1`` (``per_epoch`` epochs: the mean after the first), auto, 1. A tracked
    phase evaluates every epoch (inside the chunk, or on the host). Returns
    {"auto": [ms, ms], "1": [ms, ms], "capture_s": [s, s]}."""
    from qrec_tpu_torch.runtime import trainer as T

    params, loss_fn, sampler, evaluate, quick = phase
    out = {"auto": [], "1": [], "capture_s": []}
    for _ in range(2):
        for chunk in (8, 1):
            gen = torch.Generator(device="cuda").manual_seed(model.seed + 1)
            _, timer = T.train(
                params, loss_fn, sampler, max_epoch=epochs if chunk > 1 else per_epoch,
                lr=model.lrate, device=model.device, generator=gen,
                examples_per_epoch=model.train_size, quick_eval=quick,
                tracker=T.BestTracker() if evaluate is not None else None, chunk=chunk,
                eval_vector=evaluate, capturable=True)
            if chunk > 1:
                out["auto"].append(float(np.mean(timer.times)) * 1e3)
                out["capture_s"].append(timer.captures[0])
            else:
                out["1"].append(float(np.mean(timer.times[1:])) * 1e3)
            del timer
            gc.collect()
    print(f"[chunk timing {label}] in turns (auto, 1, auto, 1): steady epoch ms train.chunk=auto "
          f"{[round(t, 3) for t in out['auto']]} (one chunk of {epochs}, "
          f"{'evaluation inside' if evaluate is not None else 'no evaluation'}; captures "
          f"{[round(c, 3) for c in out['capture_s']]} s) train.chunk=1 "
          f"{[round(t, 3) for t in out['1']]} (mean of epochs 2-{per_epoch}"
          f"{', evaluation on the host' if evaluate is not None else ', lag-1'})", flush=True)
    return out


def family_graph_kernel_checks(torch, K, mhcn, sept) -> None:
    """K2 on MHCN's final factors and its ranker's first batch of test
    users, K1 on SEPT's joint adjacency with its tables and K2 on SEPT's
    factors, each called inside a CUDA graph (``graph_call_checks``): the
    kernels that MHCN's and SEPT's epoch graphs hold."""
    def topk(model):
        ranker = model._quick_ranker()
        uids = ranker._uids[: model.eval_batch_size]
        args = (model.U, model.V, model.rated_bitmask, uids, ranker.global_mean, 10)
        return (lambda: K.masked_catalog_topk(*args)[1],
                lambda: K.masked_catalog_topk_plain(*args)[1], (0.0, 1e-5))

    graph_call_checks(torch, K, {"masked_catalog_topk": topk(mhcn)}, " mhcn")
    adj = sept.joint_adj
    with torch.no_grad():
        x = torch.cat([sept.user_emb, sept.item_emb]).contiguous()
    graph_call_checks(torch, K, {
        "bipartite_dual_matmul": (
            lambda: K.factored_dual_matmul(adj.r, x, adj.row_scale, adj.col_scale),
            lambda: K.factored_dual_matmul_plain(adj.r, x, adj.row_scale, adj.col_scale),
            (1e-5, 1e-5)),
        "masked_catalog_topk": topk(sept),
    }, " sept")


def family_chunk_phases(torch, K, QRec, conf_of, tmp, runs, neumf) -> dict:
    """Slice 9: ``train.chunk`` for the social-graph and deep families.
    ``runs`` holds the chunked runs of ``CHUNKED_FAMILY`` that phases 9 and
    10 made (label -> (conf, ``chunk_record``, epochs, model name)); to
    them come NeuMF (10 epochs: phases of 10, 5 and 2) and APR (4: 2 + 2) on
    the FilmTrust-shaped file and DMF at the lastfm shape (2 epochs: its
    578-step graph), each at its published widths under ``auto``. Each run
    is checked as chunked and held bit for bit to its ``train.chunk=1``
    rerun (``per_epoch_reruns``); then K2 inside MHCN's evaluation graph and
    K1 and K2 inside SEPT's (``family_graph_kernel_checks``); steady epoch
    ms in turns (``turns_timing``) of MHCN (the slice's main path), SEPT's
    warm-up and joint phases, DHCF and ``neumf``'s fused phase (the lastfm
    run of phase 9); one profiled chunk of MHCN (8 epochs), DHCF and
    NeuMF's fused phase (2 each) beside one profiled MHCN epoch with its
    evaluation (phases 9 and 10 profile DHCF's and NeuMF's per-epoch
    epochs)."""
    from qrec_tpu_torch.models.base import TrainSpec

    laps, lap = lap_timer()
    film = os.path.join(tmp, "filmtrust_chunk.txt")
    with open(film, "w") as f:
        f.writelines(f"{a} {b} {r}\n" for a, b, r in zip(*filmtrust_records()))
    runs = dict(runs)
    for label, name, epochs, ratings in (("neumf filmtrust", "NeuMF", 10, film),
                                         ("apr filmtrust", "APR", 4, film),
                                         ("dmf", "DMF", 2, None)):
        conf = conf_of(name, epochs)
        if ratings is not None:
            conf["ratings"] = ratings
        model, _, _ = drive(torch, K, QRec, conf, f"{label} chunk=auto")
        runs[label] = (conf, chunk_record(model), epochs, name)
        del model
        lap(f"{label} chunk=auto")
    out, models = per_epoch_reruns(torch, K, QRec, runs, lap, keep=("mhcn", "sept", "dhcf"))
    print(f"[chunk family] graphs and capture s (warm-up epoch included) by run: " + "; ".join(
        f"{label} {rec['graphs']} graphs {[[round(c, 3) for c in p] for p in rec['phase_captures']]}"
        for label, (_, rec, _, _) in runs.items()), flush=True)
    mhcn, sept, dhcf = models["mhcn"], models["sept"], models["dhcf"]
    family_graph_kernel_checks(torch, K, mhcn, sept)
    lap("kernels in graphs")
    spec = mhcn.build()
    mhcn_phase = (spec.params, spec.loss_fn, spec.sampler,
                  lambda: mhcn.quick_eval_vector(spec), lambda: mhcn.quick_eval(spec))
    sspec = TrainSpec(list(sept.parameters()), sept.loss, sept.pairwise_sampler(),
                      score_params_fn=sept.forward, track_best=True, chunkable=True)
    sept_eval = (lambda: sept.quick_eval_vector(sspec), lambda: sept.quick_eval(sspec))
    dspec = dhcf.build()
    neu = (list(neumf.parameters()), neumf.loss_neu, neumf.pointwise_sampler(), None, None)
    # the main path's chunk at auto's 8 epochs, the others' at 4
    out["steady"] = {
        "MHCN": turns_timing(torch, mhcn, "MHCN", mhcn_phase, epochs=8),
        "SEPT warm-up": turns_timing(torch, sept, "SEPT warm-up",
                                     (sspec.params, sept.rec_loss, sspec.sampler, *sept_eval)),
        "SEPT joint": turns_timing(torch, sept, "SEPT joint",
                                   (sspec.params, sept.loss, sspec.sampler, *sept_eval)),
        "DHCF": turns_timing(torch, dhcf, "DHCF",
                             (dspec.params, dspec.loss_fn, dspec.sampler, None, None)),
        "NeuMF fused": turns_timing(torch, neumf, "NeuMF fused phase", neu),
    }
    lap("timing in turns")
    # the main path's chunk at auto's 8 epochs; DHCF's and NeuMF's at 2
    # (torch.profiler's own processing of a chunk's kernels is most of a
    # profile's seconds)
    out["profile"] = {
        "MHCN": profile_chunk(torch, mhcn, "MHCN"),
        "DHCF": profile_chunk(torch, dhcf, "DHCF", chunk=2),
        "NeuMF fused": profile_chunk(torch, neumf, "NeuMF fused phase", chunk=2, phase=neu[:4]),
    }
    profile_epoch(torch, mhcn, "MHCN with its quick evaluation",
                  epoch=lambda: eval_epoch(torch, mhcn))
    lap("profiles")
    print(f"[chunk family phases] seconds {json.dumps(laps)}", flush=True)
    return out


def main() -> None:
    import torch

    # 1. card
    t_start = time.perf_counter()
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
    from qrec_tpu_torch.runtime import trainer as T

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

    # each phase's seconds, for the script's time budget
    laps, lap = lap_timer(t_start)
    lap("1-2 card and build")
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
        chunked = {"main": (conf_of("LightGCN", 5), chunk_record(model), 5, "LightGCN")}
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

        lap("3 LightGCN main path")

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

        lap("4 K1, K2, K5 against their plain versions")

        # 5. SimGCL main path, then K3 and K4 on its first step's views
        simgcl, sim_counts, _ = drive(torch, K, QRec, conf_of("SimGCL", 3), "simgcl")
        chunked["simgcl"] = (conf_of("SimGCL", 3), chunk_record(simgcl), 3, "SimGCL")
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

        lap("5 SimGCL, K3, K4")

        # 6. SGL path, then K3 and K4 at its merged B=4000
        sgl, sgl_counts, _ = drive(torch, K, QRec, conf_of("SGL", 2), "sgl")
        k3s, k4s = infonce_phase(torch, K, timer, "sgl merged", *first_step_views(torch, sgl))
        for k, extra in ((k3, k3s), (k4, k4s)):
            k["max_abs_err"] = max(k["max_abs_err"], extra["max_abs_err"])
        del sgl

        lap("6 SGL")

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
        chunked["yelp-pallas"] = (conf, chunk_record(yelp), 2, "LightGCN")
        k2r["yelp2018"] = ranking_phase(torch, K, "yelp2018", yelp, 20)
        k2t["yelp2018"] = topk_timing(torch, K, timer, yelp, 20, "yelp2018")
        k5 = segment_phase(torch, K, timer, yelp, l2_rate)
        profile_epoch(torch, yelp, "LightGCN yelp2018 pallas")
        del yelp

        lap("7 SGL-pallas, NGCF, yelp2018, K5")

        # 7b. train.chunk: the chunked runs above against train.chunk=1
        chunk_phases(torch, K, QRec, chunked)
        del chunked

        lap("7b train.chunk")

        # 8. the MF slice (BPR, SVD rating and ranking, MostPopular) and the
        # -cv and -predict protocols
        mf_launches, mf_k2r, mf_k2t, ones = mf_phases(torch, K, QRec, timer, tmp, conf_of)
        k2r.update(mf_k2r)
        k2t.update(mf_k2t)

        lap("8 MF slice")

        # 9. the deep and GAN slice (NeuMF, APR, IRGAN, DMF, CDAE, CFGAN)
        family = {}
        deep_launches, deep_k2r, deep_k2t, deep_ones = deep_phases(torch, K, QRec, timer, conf_of,
                                                                   family)
        ones.update(deep_ones)
        mf_launches.update(deep_launches)
        k2r.update(deep_k2r)
        k2t.update(deep_k2t)

        lap("9 deep and GAN slice")

        # 10. the social slice: the bf16 and legacy int8 forms, DeviceCOO,
        # MHCN, SEPT, BUIR, DiffNet and DHCF with a synthetic trust file
        trust = os.path.join(tmp, "trust_like.txt")
        with open(trust, "w") as f:
            f.writelines(f"{a} {b}\n" for a, b in lastfm_trust())
        k1b, k1b_launches, k1_social, social_launches, social_k2r, social_ones = social_phases(
            torch, K, QRec, timer, conf_of, trust, family)
        ones.update(social_ones)
        mf_launches.update(social_launches)
        k2r.update(social_k2r)
        del timer

        lap("10 social slice")

        # 10b. train.chunk for the social-graph and deep families: the
        # chunked runs of phases 9 and 10 against train.chunk=1, NeuMF and
        # APR on the FilmTrust-shaped file, DMF's 578-step graph
        family_chunk_phases(torch, K, QRec, conf_of, tmp, family, ones["neumf"].pop("model"))
        del family

        lap("10b train.chunk, slice 9")

        # 11. the rest of the social family: the seven social MF rating
        # models, SBPR (and its -tf path), TBPR and ESRF
        k1_esrf, rest_launches, rest_k2r, rest_ones = social_rest_phases(torch, K, QRec, conf_of,
                                                                         tmp, trust)
        ones.update(rest_ones)
        mf_launches.update(rest_launches)
        k2r.update(rest_k2r)

        lap("11 social rest")

        # 12. the ALS and classical slice: WRMF, ExpoMF, CoFactor, SERec,
        # UserKNN, ItemKNN, SlopeOne, SVD++ and EE
        als_launches, als_k2r, als_ones = als_classical_phases(torch, K, QRec, conf_of, tmp, trust)
        ones.update(als_ones)
        mf_launches.update(als_launches)
        k2r.update(als_k2r)

        lap("12 ALS and classical")

        # 13. the walk slice: CUNE_MF, CUNE_BPR, IF_BPR (without and with
        # negative feedback) and RSGAN
        walk_launches, walk_k2r, walk_ones = walk_phases(torch, K, QRec, conf_of, tmp, trust)
        ones.update(walk_ones)
        mf_launches.update(walk_launches)
        k2r.update(walk_k2r)

        lap("13 walk slice")

        # 13b. slice 10: -tf runs chunked, SGNS as replayed graphs, IF_BPR's
        # epoch as one captured graph
        mf_launches.update(dispatch_walk_phases(torch, K, QRec, conf_of, tmp, trust)["launches"])

        lap("13b -tf, SGNS and IF_BPR graphs")

        # 13c. slice 11: ESRF's phases and BUIR chunked, IRGAN, RSGAN and
        # CFGAN as captured graphs, each against its per-step twin
        own = own_loop_phases(torch, K, QRec, conf_of, trust)
        mf_launches.update(own["k2"])

        lap("13c own loops")

        # 14. the lifecycle slice: the host library, resume, save/load and the trace
        k1_life, life_launches = host_and_lifecycle_phases(
            torch, K, QRec, conf_of, tmp, card, unbroken)
        mf_launches.update(life_launches)
        del unbroken

        lap("14 lifecycle")

        # 15. multi-GPU: the LightGCN family on four ranks on the card, in
        # the sparse and the dense forms, and the one-rank NCCL group
        par, par_launches, par_biased = parallel_phases(torch, K, QRec, conf_of, tmp, trust,
                                                        ones)

        lap("15 multi-GPU")

        # 16. planted blocks
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
        lap("16 planted blocks")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 17. results
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
          + " ".join(f"{label} {n}" for label, n in k1_social.items())
          + f" esrf {k1_esrf} lightgcn-stopped+resumed {k1_life} own loops (both forms) "
          f"{own['launches']['bipartite_dual_matmul']}", flush=True)
    print(f"[K5] launches: yelp-pallas {yelp_counts['weighted_segment_matmul']} own loops (BUIR, "
          f"both forms) {own['launches']['weighted_segment_matmul']}", flush=True)
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
            counts["bipartite_dual_matmul"] + k1b_launches + sum(k1_social.values()) + k1_esrf
            + k1_life + own["launches"]["bipartite_dual_matmul"], k1),
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
            "qrec_tpu/ops/pallas_kernels.py:478",
            yelp_counts["weighted_segment_matmul"] + own["launches"]["weighted_segment_matmul"], k5),
        # the mesh routes: launches summed over the four ranks, ms on one
        # rank's share (K3 + K4 for the InfoNCE)
        row("sharded_infonce_loss", "qrec_tpu_torch/csrc/infonce.cu",
            "qrec_tpu/ops/pallas_kernels.py:366",
            par_launches["infonce_fwd"] + par_launches["infonce_bwd"], par["infonce"]),
        row("ShardedPaddedCOO._apply", "qrec_tpu_torch/csrc/segment_matmul.cu",
            "qrec_tpu/ops/spmm.py:855", par_launches["weighted_segment_matmul"], par["segment"]),
        # route 6: K1 on a data rank's item-column block (on a mesh the JAX
        # package takes XLA's products over its DenseJoint, no kernel)
        row("ShardedDenseJoint (dense joint on a mesh)", "qrec_tpu_torch/csrc/dual_matmul.cu",
            "qrec_tpu/ops/pallas_kernels.py:635", par_launches["bipartite_dual_matmul"],
            par["dense"]),
        # route 7: K2's top-k on a rank's share of the test users, each
        # form's launches on its row: plain (LightGCN's factors timed),
        # biased (MostPopular's and IRGAN's runs; IRGAN's item bias timed)
        # and SVD's biased form at d=10 (the "svd ranked" run, timed)
        row("pallas_catalog_topk(mesh=)", "qrec_tpu_torch/csrc/masked_scores.cu",
            "qrec_tpu/ops/topk.py:263",
            par_launches["masked_catalog_topk"] - sum(par_biased.values()), par["topk"]),
        row("pallas_catalog_topk(mesh=), biased", "qrec_tpu_torch/csrc/masked_scores.cu",
            "qrec_tpu/ops/topk.py:263",
            sum(n for label, n in par_biased.items() if label != "svd ranked"),
            par["topk biased"]),
        row("pallas_catalog_topk(mesh=), biased SVD d=10", "qrec_tpu_torch/csrc/masked_scores.cu",
            "qrec_tpu/ops/topk.py:263", par_biased.get("svd ranked", 0), par["topk biased svd"]),
    ]
    falls_coverage()
    print(f"[phases] seconds {json.dumps(laps)}; script {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
