#!/usr/bin/env python3
"""Times K5, the port's weighted segment SpMM, on one CUDA card and prints
one JSON line per shape: this tree's kernel at several tile sizes, the K5
of another tree (``--parent``) and ``torch.sparse.mm``, in turns inside one
loop (``chip_smoke.Timer.paired``: the L2 flushed and the card held while
the host enqueues), each checked against the plain version first, and a
plain gather of the same rows of x without sums (what the gathers alone
take); with the byte bound, the gather floor and the CUDA kernels of one
call.

Compare with a parent commit unpacked under ``build/parent`` (``git
archive``):

    python3 k5_paired.py --parent build/parent

Shapes: the CSRs of ``chip_smoke.py``'s sparse paths, built the same way
(the synthetic rating file, the ``-ap 0.2`` split of ``QRec`` with seed 0,
the joint normalized adjacency): the lastfm graph at d=50 (SGL-pallas) and
the yelp2018 graph at d=64 (LightGCN-pallas), with seeded random x cast as
``SegmentMatmul`` casts it (the parent's K5 gets the contiguous cast its own
path used).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import sys
import tempfile
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


# a plain gather of the same rows of x, no sums written: every lane group of
# 8 lanes fetches 16 bytes of a row for 16 edges in flight (rows of at most
# 8 16-byte words, d <= 64); what the gathers alone take on this card
GATHER_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void gather_rows(const uint4* __restrict__ x, int words, int ld16,
                            const int* __restrict__ cols, int e, unsigned* out) {
    const int lane = threadIdx.x & 31, grp = lane / 8, sub = lane % 8;
    const int base = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 64;
    uint4 v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
        const int k = base + u * 4 + grp;
        v[u] = (k < e && sub < words) ? __ldg(x + (size_t)__ldg(cols + k) * ld16 + sub)
                                      : make_uint4(0, 0, 0, 0);
    }
    unsigned acc = 0;
#pragma unroll
    for (int u = 0; u < 16; ++u) acc ^= v[u].x ^ v[u].w;
    if (acc == 0x9e3779b9u) *out = acc;  // keeps the loads
}
extern "C" int qrec_gather_rows(const void* x, int words, int ld16, const void* cols, int e,
                                void* out, void* stream) {
    const int warps = (e + 63) / 64;
    gather_rows<<<(warps + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
        (const uint4*)x, words, ld16, (const int*)cols, e, (unsigned*)out);
    return (int)cudaGetLastError();
}
"""


def load_parent_kernels(root: str):
    """``qrec_tpu_torch/ops/kernels.py`` of the tree at ``root`` as its own
    module: it builds from that tree's sources into that tree's build/."""
    path = os.path.join(root, "qrec_tpu_torch", "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def csr_of(ratings_lines, conf_name: str):
    """The joint normalized adjacency of ``chip_smoke``'s run on a rating
    file written from ``ratings_lines``, as a ``SparseJoint`` on the card."""
    from qrec_tpu_torch import ModelConf, QRec
    from qrec_tpu_torch.data.dataset import Interactions
    from qrec_tpu_torch.data.graph import joint_normalized_adjacency
    from qrec_tpu_torch.ops.spmm import SparseJoint

    with tempfile.TemporaryDirectory(prefix="qrec_k5_") as tmp:
        path = os.path.join(tmp, "ratings.txt")
        with open(path, "w") as f:
            f.writelines(ratings_lines)
        conf = ModelConf(os.path.join(HERE, "config", f"{conf_name}.conf"))
        conf["ratings"] = path
        rec = QRec(conf)
        data = Interactions(conf, rec.training_data, rec.test_data)
    return SparseJoint.from_host(joint_normalized_adjacency(data), "cuda", check_symmetric=False)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default=None, help="a tree whose K5 is timed beside this one")
    parser.add_argument("--tiles", default="256,512,1024,2048,4096",
                        help="tile sizes of this tree's K5, comma-separated")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("k5_paired: no CUDA device")
    import chip_smoke as CS
    from qrec_tpu_torch.ops import kernels as K
    from qrec_tpu_torch.ops.spmm import segment_operand

    K.build([K.SEGMM])
    parent = None
    if args.parent:
        parent = load_parent_kernels(os.path.abspath(args.parent))
        parent.build([parent.SEGMM])
    card = CS.card_line()
    timer = CS.Timer(torch)
    l2_rate = CS.l2_read_rate(torch, K, timer)
    gather = CS.build_inline(K, "gather_rows", GATHER_SOURCE)
    gather.qrec_gather_rows.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p]
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    tiles = [int(t) for t in args.tiles.split(",")]
    rows_l, cols_l, _, _ = CS.lastfm_records()
    rows_y, cols_y, _, _ = CS.yelp_matrix()
    shapes = {
        "lastfm d=50": ([f"{a} {b} 1\n" for a, b in zip(rows_l, cols_l)], "SGL", 50),
        "yelp2018 d=64": ([f"{a} {b} 1\n" for a, b in zip(rows_y, cols_y)], "LightGCN", 64),
    }
    g = torch.Generator(device="cuda").manual_seed(5)
    for label, (lines, conf_name, d) in shapes.items():
        adj = csr_of(lines, conf_name)
        n, e = adj.num_rows, adj.cols.shape[0]
        x32 = torch.randn((n, d), generator=g, device="cuda") * 0.1
        x = segment_operand(x32)
        csr = (adj.indptr, adj.cols, adj.vals)
        calls, names = [], []
        for tile in tiles:
            s = K.segment_schedule(adj.indptr, tile=tile)
            calls.append(lambda s=s: K.weighted_segment_matmul(x, *csr, s))
            names.append(f"tile {tile}" + (" (default)" if tile == adj.schedule.tile else ""))
        if parent is not None:
            xc = x.contiguous()
            ps = parent.segment_schedule(adj.indptr)
            calls.append(lambda: parent.weighted_segment_matmul(xc, *csr, ps))
            names.append("parent")
        with warnings.catch_warnings():  # sparse CSR tensors are "beta" in PyTorch
            warnings.simplefilter("ignore")
            lib = torch.sparse_csr_tensor(adj.indptr, adj.cols, adj.vals.bfloat16().float(),
                                          size=(n, n))
        xf = x.float()
        calls.append(lambda: torch.sparse.mm(lib, xf))
        names.append("torch.sparse.mm")
        # x's rows are padded to 16 bytes (segment_operand)
        words, ld16 = -(-d // 8), x.stride(0) // 8
        calls.append(lambda: gather.qrec_gather_rows(
            x.data_ptr(), words, ld16, adj.cols.data_ptr(), e, sink.data_ptr(),
            torch.cuda.current_stream().cuda_stream))
        names.append("plain gather")
        # every version against the plain one, within the f32 order bound
        plain = K.weighted_segment_matmul_plain(x, *csr)
        absum = K.weighted_segment_matmul_plain(x.abs(), adj.indptr, adj.cols, adj.vals.abs())
        bound = 2.0 * adj.indptr.diff().float()[:, None] * 2.0**-24 * absum
        agree = {}
        for name, call in zip(names[:-2], calls[:-2]):
            agree[name] = bool(((call() - plain).abs() <= bound).all())
        # the K5 versions' kernels per call (torch.sparse.mm is not captured)
        kernels = {name: CS.kernels_per_call(torch, call) for name, call in zip(names[:-2], calls)}
        times = timer.paired(calls)
        moved = e * 8 + (n + 1) * 4 + n * d * 2 + n * d * 4
        print(json.dumps({
            "shape": label, "N": n, "E": e, "d": d, "card": card,
            "ms": dict(zip(names, times)), "cuda_kernels_per_call": kernels,
            "within_order_bound": agree,
            "bound_ms": moved / CS.HBM_BYTES_PER_S * 1e3,
            "gather_floor_ms": e * d * 2 / l2_rate * 1e3, "l2_read_tb_s": l2_rate / 1e12,
        }), flush=True)
        if not all(agree.values()):
            sys.exit(f"k5_paired: a K5 disagrees with its plain version at {label}")
        del adj, lib, plain, absum, bound, calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
