// Masked full-catalog scores (K2) and the top-k over them, fused.
//
//   score[b, i] = mask_value if item i is rated by user b (bit i of the
//                 packed row bitmask), else dot(u[b], items[i])
//
// Replaces the Pallas TPU kernel `masked_catalog_scores` / `_score_kernel`
// (qrec_tpu/ops/pallas_kernels.py:49-137) and, in `qrec_masked_topk`, the
// `lax.top_k` the JAX ranker takes of its (B, I) block
// (qrec_tpu/ops/topk.py:54, :289). The TPU kernel expands mask bits with
// one-hot f32 matmuls because Mosaic cannot relayout words into columns;
// here each thread reads the two 32-bit words of its rows in a 64-item tile
// and shifts, so no (B, I) mask exists in device memory.
//
// What bounds it on an H100: 2 x B x I x d f32 FMA work over the 67 TFLOP/s
// of the CUDA cores (25 us at B = 1024, I = 16,591, d = 50); the (B, I) f32
// block that `qrec_masked_scores` writes adds 68 MB, 20 us at 3.35 TB/s,
// which `qrec_masked_topk` never writes: it keeps each row's best k in
// shared memory and writes (B, k) ids and scores.
//
// Design. One tile product for both entries, K3's and K4's (tiles.cuh): a
// block holds 128 or 64 users, staged once by cp.async (through `uids` for
// the top-k entry, so the ranker gathers nothing), and walks the 64-item
// tiles of its split of the catalog, double-buffered; each thread owns an
// 8 x 4 or 4 x 4 register patch, summed by fmaf over the features in order
// from 0, so both entries give every score the same bits as the 4 x 4
// kernel they replace (except the sign of a dot product that underflows to
// zero where d is a multiple of 4 and not of 32: that kernel summed 0 x 0
// over its padding). A width past MAX_D is staged in slices of 64 features
// a tile, which keeps the order of the sum. The rated mask is applied in
// registers.
//   Selection (qrec_masked_topk). Every score becomes a 64-bit key whose
//   unsigned order is that of torch.sort(descending=True, stable=True):
//   the score's bits mapped to an ordered word (-0.0 as +0.0, NaN above
//   +inf), then ~item, so the lower item wins a tie. A row belongs to the
//   half-warp whose 16 lanes hold its scores; in shared memory it keeps a
//   sorted list of its best k keys and a buffer of 16 candidates. Each
//   step offers the row's 16 scores of one patch column against its k-th
//   key; the lanes that win take buffer slots by a ballot, and a buffer
//   they would overflow is first merged into the list by the half-warp
//   (each key's new place is its rank in the union), the winners tested
//   again against the new k-th key. Rows never cross warps, so selection
//   needs no block barrier and no atomic, and under a total order its
//   result does not depend on when merges happen: it repeats bit for bit.
//   Merging the splits. Each split writes its rows' lists to scratch; the
//   last split of a row tile to count in (an acquire-release add on the
//   tile's counter, back at 0 when the call ends: K3's pattern) copies each
//   row's lists into shared memory (cp.async, the next row's in flight) and
//   takes k rounds of a max over the split heads, one lane of the row's
//   half-warp a split, by xor shuffles. A key decodes to the item and the
//   score's bits; a NaN or zero score, whose bits the key does not keep, is
//   taken again from the bitmask and the dot product in the same order.
//   Users with uid < 0 (unseen in training) get items 0..k-1 at
//   global_mean, what a stable sort of a constant row gives.
//   Biased scores (qrec_masked_topk with item_bias, user_bias or offset):
//   the score form of SVD, ((dot + offset) + item_bias[c]) + user_bias[uid]
//   (qrec_tpu/models/mf.py:130-150), and of MostPopular, whose width-1
//   zero tables give +0 + item_bias[c], exactly its popularity. The adds
//   run in registers in that order, before the rated mask and the order
//   key, as round-to-nearest adds that are never fused; the biases are read
//   through L1 where a score is formed. Only 64-row blocks take them: at
//   128 rows the epilogue spilled some 450 bytes a thread (ptxas) and ran
//   1.55x the unbiased kernel at d=150 on an H100 (PERF.md). The epilogue
//   is a template flag: without biases the kernel is the one above, bit for
//   bit (adding 0 would turn -0.0 into +0.0). Bias reads are (I + B)
//   floats, small beside the tables.
// The host's plan (ops/kernels.py masked_catalog_plan) picks the block and
// the splits so that the blocks fill the SMs once. One launch per call for
// either entry.

#include <cuda/atomic>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

typedef unsigned long long u64;

constexpr int CAP = 16;           // candidates a row's buffer holds: one a lane of its half-warp
constexpr int MAX_K = 128;        // the longest list
constexpr int MAX_SPLITS = 16;    // the final merge gives each split a lane of a half-warp
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t NAN_BITS = 0xffffffffu;   // order_bits of every NaN
constexpr uint32_t ZERO_BITS = 0x80000000u;  // order_bits of -0.0 and +0.0

struct Params {
    const float* u;          // user rows: the block (scores) or the table (top-k), (.., d)
    const int64_t* uids;     // null (row r is u[r], bitmask[r]) or (B,) rows, -1 = unseen
    const float* items;      // (I, d)
    const int32_t* bitmask;  // (.., words) packed uint32 bits
    int B, I, d, words, vec;
    int slice;               // 0: d staged whole; else features staged a pass
    int tiles_per_split;
    float mask_value;
    float* out;              // scores: (B, I)
    int k;                   // top-k: k, lists, outputs
    float global_mean;
    const float* item_bias;  // null or (I,)
    const float* user_bias;  // null or (U,), read through uids
    float offset;
    int bias;                // whether the score form adds offset and the biases
    u64* part;               // (splits, B, k rounded up to even) each split's lists
    int* counters;           // (row tiles) 0 on entry and on exit
    int64_t* ids;            // (B, k)
    float* scores;           // (B, k)
};

// an ordered word: unsigned order is float order, -0.0 = +0.0, every NaN
// above +inf
__device__ __forceinline__ uint32_t order_bits(float s) {
    if (s != s) return NAN_BITS;
    const uint32_t b = s == 0.f ? 0u : __float_as_uint(s);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// larger key = earlier in the ranking; 0 = no entry (every key is above it)
__device__ __forceinline__ u64 order_key(float s, int item) {
    return ((u64)order_bits(s) << 32) | (uint32_t)~(uint32_t)item;
}

// the biased score of a dot product: ((acc + offset) + ib) + ub, each
// bias where its table is given
__device__ __forceinline__ float biased(const Params& p, float acc, float ib, float ub) {
    float v = __fadd_rn(acc, p.offset);
    if (p.item_bias) v = __fadd_rn(v, ib);
    if (p.user_bias) v = __fadd_rn(v, ub);
    return v;
}

// the score that user row `src` gives `item`, as the tile product sums it
// and the epilogue biases it
__device__ float score_of(const Params& p, int src, int item) {
    const uint32_t word = static_cast<uint32_t>(p.bitmask[(size_t)src * p.words + (item >> 5)]);
    if ((word >> (item & 31)) & 1u) return p.mask_value;
    const float* a = p.u + (size_t)src * p.d;
    const float* b = p.items + (size_t)item * p.d;
    float acc = 0.f;
    for (int f = 0; f < 4 * ((p.d + 3) / 4); ++f)
        acc = fmaf(f < p.d ? a[f] : 0.f, f < p.d ? b[f] : 0.f, acc);
    if (!p.bias) return acc;
    return biased(p, acc, p.item_bias ? p.item_bias[item] : 0.f, p.user_bias ? p.user_bias[src] : 0.f);
}

__device__ __forceinline__ float decode(const Params& p, u64 key, int src, int* item) {
    const uint32_t hi = (uint32_t)(key >> 32);
    *item = (int)~(uint32_t)key;
    if (hi == NAN_BITS || hi == ZERO_BITS) return score_of(p, src, *item);
    return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}

// Shared memory of a block: the users (bm rows) and two item tiles at row
// stride ld, then for the top-k entry each row's list (k keys), buffer (CAP
// keys), k-th key and list length, then each row's source row.
struct Smem {
    float* a_s;
    float* b_s;
    u64* list;
    u64* buf;
    u64* thr;
    int* len;
    int* src;
};

__host__ __device__ inline int row_ld(int d, int slice) { return fwd_ld(slice ? slice : d); }

// A block's shared memory: the tiles and lists above, or, where more, what
// the last split's merge stages (a row a half-warp, two buffers a
// half-warp of a row's split lists, each list k keys padded to an even
// count), which reuses the same bytes.
__host__ __device__ inline size_t smem_bytes(int bm, int d, int slice, int k, int splits) {
    const size_t floats = (size_t)(bm + 2 * CT) * row_ld(d, slice);
    const size_t keys = k ? (size_t)bm * (k + CAP + 1) : 0;
    const size_t tiles = 4 * floats + 8 * keys + 4 * (size_t)bm * (k ? 2 : 1);
    const size_t merge = k ? (size_t)WARPS * 4 * splits * (k + (k & 1)) * 8 : 0;
    return tiles > merge ? tiles : merge;
}

__device__ inline Smem carve(void* raw, int bm, int ld, int k) {
    Smem s;
    s.a_s = static_cast<float*>(raw);
    s.b_s = s.a_s + bm * ld;
    u64* keys = reinterpret_cast<u64*>(s.b_s + 2 * CT * ld);  // 16-byte aligned: ld % 4 == 0
    s.list = keys;
    s.buf = s.list + (size_t)bm * k;
    s.thr = s.buf + (k ? (size_t)bm * CAP : 0);
    s.len = reinterpret_cast<int*>(s.thr + (k ? bm : 0));
    s.src = s.len + (k ? bm : 0);
    return s;
}

// a_s[r * ld + f] = u[src[r]][f] for f < d (cp.async, no commit), zero for
// f in [d, width) and for a row without a source (src < 0)
template <int V>
__device__ __forceinline__ void stage_users_v(float* a_s, const float* __restrict__ u,
                                              const int* src, int rows, int d, int ld, int width) {
    const int lane = threadIdx.x % 32;
    for (int r = threadIdx.x / 32; r < rows; r += WARPS) {
        float* dst = a_s + r * ld;
        const int g = src[r];
        if (g >= 0) {
            const float* row = u + (size_t)g * d;
            for (int f = lane * V; f < d; f += 32 * V)
                __pipeline_memcpy_async(dst + f, row + f, V * sizeof(float));
        }
        for (int f = (g >= 0 ? d : 0) + lane; f < width; f += 32) dst[f] = 0.f;
    }
}

__device__ __forceinline__ void stage_users(int vec, float* a_s, const float* __restrict__ u,
                                            const int* src, int rows, int d, int ld, int width) {
    if (vec == 4) {
        stage_users_v<4>(a_s, u, src, rows, d, ld, width);
    } else if (vec == 2) {
        stage_users_v<2>(a_s, u, src, rows, d, ld, width);
    } else {
        stage_users_v<1>(a_s, u, src, rows, d, ld, width);
    }
}

// A row belongs to the half-warp whose 16 lanes hold its scores (the
// threads of one ty): it alone appends to the row's buffer and merges it,
// so no block barrier and no atomic is needed. Both halves of a warp merge
// together, each its own row (a half with nothing to merge passes through).

// The half-warp merges n <= CAP buffered keys into the row's sorted list:
// every key's new place is the number of keys of the union above it (keys
// are distinct: one item a key); keys placed at k or later drop out. A
// lane holds L list keys (k <= 16 L) and one buffer key.
template <int L>
__device__ void merge_half(u64* list, const u64* buf, int* len_p, u64* thr_p, int n, int k) {
    const int hl = threadIdx.x % 16;
    const int len = *len_p;
    u64 lv[L];
    int lp[L];
#pragma unroll
    for (int m = 0; m < L; ++m) {
        const int i = hl + 16 * m;
        lv[m] = i < len ? list[i] : 0;
        lp[m] = i;
    }
    const u64 bv = hl < n ? buf[hl] : 0;
    int bp = 0;
    for (int q = 0; q < n; ++q) {
        const u64 o = buf[q];
#pragma unroll
        for (int m = 0; m < L; ++m) lp[m] += o > lv[m];
        bp += o > bv;
    }
    for (int q = 0; q < len; ++q) bp += list[q] > bv;
    __syncwarp();
#pragma unroll
    for (int m = 0; m < L; ++m)
        if (hl + 16 * m < len && lp[m] < k) list[lp[m]] = lv[m];
    if (hl < n && bp < k) list[bp] = bv;
    __syncwarp();
    const int new_len = min(k, len + n);
    const u64 thr = new_len == k ? list[k - 1] : 0;
    __syncwarp();
    if (hl == 0) {
        *len_p = new_len;
        *thr_p = thr;
    }
    __syncwarp();
}

// out of line: the rare path, called from every row of the unrolled epilogue
__device__ __noinline__ void merge_half_k(u64* list, const u64* buf, int* len_p, u64* thr_p, int n,
                                          int k) {
    if (k <= 16) {
        merge_half<1>(list, buf, len_p, thr_p, n, k);
    } else if (k <= 32) {
        merge_half<2>(list, buf, len_p, thr_p, n, k);
    } else if (k <= 64) {
        merge_half<4>(list, buf, len_p, thr_p, n, k);
    } else {
        merge_half<8>(list, buf, len_p, thr_p, n, k);
    }
}

__device__ __forceinline__ void merge_row(const Smem& s, int row, int n, int k) {
    merge_half_k(s.list + (size_t)row * k, s.buf + (size_t)row * CAP, s.len + row, s.thr + row, n, k);
}

// The epilogue of one tile: acc holds the patch's dot products of items
// t0 + tx + 16 j, valid below c_end. Scores: write them masked. Top-k:
// offer each row's scores of the tile, 16 at a time (one j), to its
// buffer, keeping those whose key beats the row's k-th; a buffer they
// would overflow is merged into the list first and they are offered again
// against the new k-th. cnt[i]: keys in row ty + 16 i's buffer, the same
// in the half's lanes. BIAS: each score is biased first.
template <int RM, bool TOPK, bool BIAS>
__device__ __forceinline__ void tile_epilogue(const Params& p, const Smem& s, float (&acc)[RM][4],
                                              const uint32_t (&mw)[RM][2], const int (&src)[RM],
                                              int (&cnt)[RM], int r0, int t0, int c_end, int tx,
                                              int ty) {
    if (!TOPK) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            if (src[i] < 0) continue;
            float* o = p.out + (size_t)(r0 + ty + 16 * i) * p.I;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = t0 + tx + 16 * j;
                if (c < c_end) o[c] = (mw[i][j >> 1] >> (tx + 16 * (j & 1))) & 1u ? p.mask_value : acc[i][j];
            }
        }
        return;
    }
    const int half = threadIdx.x & 16;
    const uint32_t below = (1u << tx) - 1u;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = ty + 16 * i;
        u64 thr = s.thr[row];
        const float ub = BIAS && p.user_bias && src[i] >= 0 ? __ldg(p.user_bias + src[i]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = t0 + tx + 16 * j;
            const bool rated = (mw[i][j >> 1] >> (tx + 16 * (j & 1))) & 1u;
            const float ib = BIAS && p.item_bias && c < c_end ? __ldg(p.item_bias + c) : 0.f;
            const float v = BIAS ? biased(p, acc[i][j], ib, ub) : acc[i][j];
            const u64 key = order_key(rated ? p.mask_value : v, c);
            bool win = src[i] >= 0 && c < c_end && key > thr;
            uint32_t mine = __ballot_sync(FULL, win);
            if (!mine) continue;
            mine = (mine >> half) & 0xffffu;
            if (__any_sync(FULL, cnt[i] + __popc(mine) > CAP)) {
                merge_row(s, row, cnt[i], p.k);
                cnt[i] = 0;
                thr = s.thr[row];
                win = win && key > thr;
                mine = (__ballot_sync(FULL, win) >> half) & 0xffffu;
            }
            if (win) s.buf[(size_t)row * CAP + cnt[i] + __popc(mine & below)] = key;
            cnt[i] += __popc(mine);
        }
    }
}

// Block (tile, split): rows [tile BM, tile BM + BM) of the batch against
// the items [split tps CT, (split + 1) tps CT).
template <int RM, bool TOPK, bool BIAS>
__global__ void __launch_bounds__(THREADS, 2) catalog_tiles(Params p) {
    constexpr int BM = 16 * RM;
    extern __shared__ float4 smem_raw[];
    __shared__ int last;
    const int d = p.d, k = TOPK ? p.k : 0;
    const int ld = row_ld(d, p.slice);
    const Smem s = carve(smem_raw, BM, ld, k);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int tile = blockIdx.x, r0 = tile * BM;
    const int split = blockIdx.y, splits = gridDim.y;
    const int c_begin = split * p.tiles_per_split * CT;
    const int c_end = min(p.I, c_begin + p.tiles_per_split * CT);

    for (int r = threadIdx.x; r < BM; r += THREADS) {
        const int b = r0 + r;
        s.src[r] = b >= p.B ? -1 : p.uids ? (int)p.uids[b] : b;
        if (TOPK) {
            s.len[r] = 0;
            s.thr[r] = 0;
        }
    }
    __syncthreads();
    int src[RM], cnt[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        src[i] = s.src[ty + 16 * i];
        cnt[i] = 0;
    }

    // the tile's two bitmask words of each of the thread's rows
    auto mask_words = [&](int t0, uint32_t (&mw)[RM][2]) {
        const int w0 = t0 >> 5;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int32_t* row = p.bitmask + (size_t)max(src[i], 0) * p.words;
            mw[i][0] = src[i] >= 0 ? (uint32_t)__ldg(row + w0) : 0u;
            mw[i][1] = src[i] >= 0 && w0 + 1 < p.words ? (uint32_t)__ldg(row + w0 + 1) : 0u;
        }
    };

    if (p.slice == 0) {
        const int k4_end = (d + 3) / 4;
        stage_users(p.vec, s.a_s, p.u, s.src, BM, d, ld, 4 * k4_end);
        for_each_tile(s.b_s, p.items, c_begin, c_end, d, ld, 4 * k4_end, p.vec,
                      [&](const float* t, int t0) {
                          uint32_t mw[RM][2];
                          mask_words(t0, mw);
                          float acc[RM][4];
                          patch_dots<RM>(s.a_s, t, ld, k4_end, tx, ty, acc);
                          tile_epilogue<RM, TOPK, BIAS>(p, s, acc, mw, src, cnt, r0, t0, c_end, tx, ty);
                      });
    } else {
        // d too wide to stage whole: each tile sums slices of p.slice
        // features in order, staged by plain loads
        const int lane = threadIdx.x % 32;
        for (int t0 = c_begin; t0 < c_end; t0 += CT) {
            uint32_t mw[RM][2];
            mask_words(t0, mw);
            float acc[RM][4];
#pragma unroll
            for (int i = 0; i < RM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
            for (int f0 = 0; f0 < d; f0 += p.slice) {
                const int n = min(p.slice, d - f0), k4 = (n + 3) / 4;
                __syncthreads();
                for (int r = threadIdx.x / 32; r < BM; r += WARPS) {
                    const int g = s.src[r];
                    for (int f = lane; f < 4 * k4; f += 32)
                        s.a_s[r * ld + f] = g >= 0 && f < n ? p.u[(size_t)g * d + f0 + f] : 0.f;
                }
                for (int r = threadIdx.x / 32; r < CT; r += WARPS) {
                    const int it = t0 + r;
                    for (int f = lane; f < 4 * k4; f += 32)
                        s.b_s[r * ld + f] = it < c_end && f < n ? p.items[(size_t)it * d + f0 + f] : 0.f;
                }
                __syncthreads();
                patch_dots_acc<RM>(s.a_s, s.b_s, ld, 0, k4, tx, ty, acc);
            }
            tile_epilogue<RM, TOPK, BIAS>(p, s, acc, mw, src, cnt, r0, t0, c_end, tx, ty);
        }
    }
    if (!TOPK) return;

    // each half-warp: its rows' last candidates, then their lists to
    // scratch (rows of kp keys: 16-byte aligned)
    const int hl = tx, half = threadIdx.x & 16, warp = threadIdx.x / 32;
    const int kp = k + (k & 1);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = ty + 16 * i, b = r0 + row;
        if (__any_sync(FULL, cnt[i] > 0)) merge_row(s, row, cnt[i], k);
        if (b < p.B) {
            const int len = s.len[row];
            for (int e = hl; e < kp; e += 16)
                __stcg(p.part + ((size_t)split * p.B + b) * kp + e,
                       e < len ? s.list[(size_t)row * k + e] : 0ull);
        }
    }
    // count in on the tile; the release publishes the block's lists (the
    // barrier orders every thread's stores before it), the acquire of the
    // last count sees every split's
    __syncthreads();
    if (threadIdx.x == 0) {
        cuda::atomic_ref<int, cuda::thread_scope_device> count(p.counters[tile]);
        last = count.fetch_add(1, cuda::memory_order_acq_rel) == splits - 1;
    }
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) p.counters[tile] = 0;

    // The last split of the tile. Each half-warp takes its rows ty + 16 i
    // again: a row's split lists are copied into shared memory (the block's
    // tiles and lists are done with; two buffers a half-warp, the next
    // row's copy in flight while this one merges), then k rounds of a max
    // over the split heads, one lane a split, by xor shuffles within the
    // half.
    u64* w_s = reinterpret_cast<u64*>(smem_raw) + (size_t)(2 * warp + (half >> 4)) * 2 * splits * kp;
    auto stage = [&](int i, int which) {
        const int b = r0 + ty + 16 * i;
        if (i < RM && b < p.B && p.uids[b] >= 0) {
            u64* dst = w_s + (size_t)which * splits * kp;
            for (int c = hl; c < splits * kp / 2; c += 16) {
                const int g = 2 * c / kp, e = 2 * c - g * kp;
                const u64* src = p.part + ((size_t)g * p.B + b) * kp + e;
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                                 (unsigned)__cvta_generic_to_shared(dst + 2 * c)),
                             "l"(__cvta_generic_to_global(src)));
            }
        }
        __pipeline_commit();
    };
    stage(0, 0);
    for (int i = 0, which = 0; i < RM; ++i, which ^= 1) {
        stage(i + 1, which ^ 1);
        __pipeline_wait_prior(1);  // this row's copies landed (the next one's may not)
        __syncwarp();
        const int b = r0 + ty + 16 * i;
        const int64_t uid = b < p.B ? p.uids[b] : -1;
        const u64* lists = w_s + (size_t)which * splits * kp;
        int ptr = 0;
        u64 head = uid >= 0 && hl < splits ? lists[hl * kp] : 0;
        for (int e0 = 0; e0 < k; e0 += 16) {
            u64 mine = 0;
            for (int q = 0; q < 16 && e0 + q < k; ++q) {
                u64 top = head;
#pragma unroll
                for (int off = 8; off > 0; off >>= 1) {
                    const u64 o = __shfl_xor_sync(FULL, top, off);
                    top = o > top ? o : top;
                }
                if (hl == q) mine = top;
                if (top != 0 && head == top) {
                    ++ptr;
                    head = ptr < k ? lists[hl * kp + ptr] : 0;
                }
            }
            const int e = e0 + hl;
            if (b < p.B && e < k) {
                int64_t item = e;
                float v = p.global_mean;
                if (uid >= 0) {
                    int it;
                    v = decode(p, mine, (int)uid, &it);
                    item = it;
                }
                p.ids[(size_t)b * k + e] = item;
                p.scores[(size_t)b * k + e] = v;
            }
        }
        __syncwarp();  // every lane is done with this buffer before it is refilled
    }
    __pipeline_wait_prior(0);
}

template <int RM, bool TOPK>
int blocks_per_sm(int d, int slice, int k, int splits) {
    const size_t smem = smem_bytes(16 * RM, d, slice, k, splits);
    cudaError_t err = cudaFuncSetAttribute(catalog_tiles<RM, TOPK, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, catalog_tiles<RM, TOPK, false>,
                                                            THREADS, smem);
    cudaGetLastError();  // a block too large for the SM is an answer here, not an error
    return err == cudaSuccess ? blocks : 0;
}

template <int RM, bool TOPK, bool BIAS>
int launch(const Params& p, int splits, cudaStream_t st) {
    const size_t smem = smem_bytes(16 * RM, p.d, p.slice, p.k, splits);
    cudaError_t err = cudaFuncSetAttribute(catalog_tiles<RM, TOPK, BIAS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
        cudaGetLastError();  // refused before the launch: leave no error behind for the caller
        return (int)err;
    }
    const int row_tiles = (p.B + 16 * RM - 1) / (16 * RM);
    catalog_tiles<RM, TOPK, BIAS><<<dim3(row_tiles, splits), THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
}

// the grid's splits of the plan, or 0 if the plan is not one this kernel runs
int plan_splits(int I, int d, int bm, int slice, int tiles_per_split) {
    if (bm != 64 && bm != 128) return 0;
    if (slice == 0 ? d > MAX_D : (slice % 4 || slice <= 0 || slice > MAX_D)) return 0;
    if (tiles_per_split <= 0) return 0;
    const int tiles = (I + CT - 1) / CT;
    return (tiles + tiles_per_split - 1) / tiles_per_split;
}

}  // namespace

extern "C" {

// Blocks of a `bm`-row (64 or 128) block at width d, features staged
// `slice` at a time (0: whole), lists of k (0: the scores entry) and
// `splits` splits that one SM holds at once (0 if the block does not
// fit), for the host's plan.
int qrec_masked_blocks_per_sm(int bm, int d, int slice, int k, int splits) {
    if (d <= 0 || k < 0 || k > MAX_K || (slice == 0 && d > MAX_D)) return 0;
    const bool topk = k > 0;
    if (bm == 128)
        return topk ? blocks_per_sm<8, true>(d, slice, k, splits) : blocks_per_sm<8, false>(d, slice, 0, 0);
    if (bm == 64)
        return topk ? blocks_per_sm<4, true>(d, slice, k, splits) : blocks_per_sm<4, false>(d, slice, 0, 0);
    return 0;
}

// u (B, d), items (I, d), out (B, I) f32; bitmask (B, words) int32 holding
// the packed uint32 bit pattern, words >= ceil(I / 32); the plan: bm rows a
// block (64 or 128), slice (0 or the features staged a pass) and
// tiles_per_split item tiles of 64 a block. One launch; returns
// cudaGetLastError() after it.
int qrec_masked_scores(const void* u, const void* items, const void* bitmask, void* out, int B,
                       int I, int d, int words, float mask_value, int bm, int slice,
                       int tiles_per_split, void* stream) {
    const int splits = plan_splits(I, d, bm, slice, tiles_per_split);
    if (B <= 0 || I <= 0 || d <= 0 || words < (I + 31) / 32 || splits == 0)
        return (int)cudaErrorInvalidValue;
    Params p = {};
    p.u = static_cast<const float*>(u);
    p.items = static_cast<const float*>(items);
    p.bitmask = static_cast<const int32_t*>(bitmask);
    p.B = B;
    p.I = I;
    p.d = d;
    p.words = words;
    p.vec = copy_width(u, items, d);
    p.slice = slice;
    p.tiles_per_split = tiles_per_split;
    p.mask_value = mask_value;
    p.out = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return bm == 128 ? launch<8, false, false>(p, splits, st) : launch<4, false, false>(p, splits, st);
}

// user_emb (U, d), items (I, d) f32; bitmask (U, words) int32 as above;
// uids (B) int64, each in [0, U) or -1 (unseen: items 0..k-1 at
// global_mean; row -1 is never read); 1 <= k <= min(128, I); the score
// form: item_bias (I) and user_bias (U) f32 or null, and offset (with
// neither bias and offset 0, the plain dot products; otherwise bm = 64).
// The plan as
// for qrec_masked_scores, with at most 16 splits (the block's shared
// memory grows to hold 32 splits kp keys a warp for the last merge, kp = k
// rounded up to even, where its tiles take less);
// part (splits B kp) int64 and
// counters (ceil(B / bm)) int32, zero on entry and left zero, the scratch;
// ids (B, k) int64 and scores (B, k) f32 are written. One launch; returns
// cudaGetLastError() after it.
int qrec_masked_topk(const void* user_emb, const void* items, const void* bitmask,
                     const void* uids, void* part, void* counters, void* ids, void* scores, int B,
                     int I, int d, int words, int k, float global_mean, float mask_value,
                     const void* item_bias, const void* user_bias, float offset, int bm,
                     int slice, int tiles_per_split, void* stream) {
    const int splits = plan_splits(I, d, bm, slice, tiles_per_split);
    if (B <= 0 || I <= 0 || d <= 0 || words < (I + 31) / 32 || splits == 0 ||
        splits > MAX_SPLITS || k < 1 || k > MAX_K || k > I)
        return (int)cudaErrorInvalidValue;
    Params p = {};
    p.u = static_cast<const float*>(user_emb);
    p.uids = static_cast<const int64_t*>(uids);
    p.items = static_cast<const float*>(items);
    p.bitmask = static_cast<const int32_t*>(bitmask);
    p.B = B;
    p.I = I;
    p.d = d;
    p.words = words;
    p.vec = copy_width(user_emb, items, d);
    p.slice = slice;
    p.tiles_per_split = tiles_per_split;
    p.mask_value = mask_value;
    p.k = k;
    p.global_mean = global_mean;
    p.item_bias = static_cast<const float*>(item_bias);
    p.user_bias = static_cast<const float*>(user_bias);
    p.offset = offset;
    p.bias = item_bias != nullptr || user_bias != nullptr || offset != 0.f;
    p.part = static_cast<u64*>(part);
    p.counters = static_cast<int*>(counters);
    p.ids = static_cast<int64_t*>(ids);
    p.scores = static_cast<float*>(scores);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (p.bias) return bm == 64 ? launch<4, true, true>(p, splits, st) : (int)cudaErrorInvalidValue;
    return bm == 128 ? launch<8, true, false>(p, splits, st) : launch<4, true, false>(p, splits, st);
}

}  // extern "C"
