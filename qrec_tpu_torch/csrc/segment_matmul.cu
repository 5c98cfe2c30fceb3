// Weighted segment SpMM over a row-sorted CSR matrix:
//   out[r] = sum over edges e of row r of f32(bf16(vals[e])) * f32(x[cols[e]])
// with x (N, d) bf16 (rows of any stride), out (N, d) f32 and every row
// written (an empty row as zeros).
//
// Replaces the Pallas TPU kernel `weighted_segment_matmul` / `_segmm_kernel`
// (qrec_tpu/ops/pallas_kernels.py:478-533), which the JAX package's
// `PaddedCOO` drives (qrec_tpu/ops/spmm.py:555-702). It computes the same
// function, not the TPU's one-hot matrix product: the TPU kernel rounds the
// edge values to bf16 (`.astype(bfloat16)` of its selection matrix) and
// multiplies them by the bf16 gathered rows with f32 sums. A product of two
// bf16 values is exact in f32, so the results differ from the TPU's only by
// the order of the f32 sums. The TPU version gathers x[cols] into an
// (E, d) copy in device memory first; here the gather is fused and no
// gathered copy exists.
//
// What bounds it on an H100: counted as the function, the CSR (8 bytes an
// edge plus the row pointers), x once and out once over 3.35 TB/s; 2 x E x
// d FLOP is far below the f32 rate. The kernel reads a row of x once per
// edge that names it (E x d x 2 bytes), mostly from L2 (x is 5.2 MB at the
// yelp2018 shape): its practical floor is that volume at the L2 read rate.
//
// Design: one launch, edge-balanced. The host cuts the row-sorted edges
// into tiles of `tile` edges (ops/kernels.py `segment_schedule`); a tile may
// cross row boundaries, so a heavy row (thousands of edges, zipf item
// popularity) spreads over several blocks and no block waits on one row.
//   - Block t stages its tile's cols, vals and edge rows into shared memory
//     with cp.async (16-byte copies where aligned) and rounds the values to
//     bf16 there: one round trip a block, not a chain of index loads a warp.
//   - A row of x is gathered by LPR lanes of V bf16 each (16 bytes a lane
//     where the row stride allows: at d=64 eight lanes fetch a row and a
//     warp instruction fetches four edges' rows). The block's lane groups
//     each take an equal share of the tile's edges and scan it in edge
//     order, U gathers in flight whatever the rows, sums in f32 registers:
//     the loads wait on the edges and not on row boundaries (most rows are
//     short, and a warp that took its rows one at a time waited on a round
//     trip for each).
//   - A row that begins and ends inside a group's share goes to out from
//     registers. A share's first and last rows go to shared memory, and
//     after a barrier each row met there is summed over its parts in edge
//     order.
//   - A row that crosses a tile edge (a "split" row) leaves that sum in its
//     carry slot for this tile; the block then counts itself in on the row's
//     counter (an acquire-release add), and the block that arrives last adds
//     the row's carries in tile order, writes out and resets the counter.
// No float atomics: a call repeats bit for bit, and it leaves the schedule's
// scratch as it found it (ready for graph capture). Every row's sum is an
// in-order sum of in-order partial sums: a row inside one share is the plain
// edge-order sum. Any 1 <= d <= 256.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda/atomic>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_D = 256;
constexpr int U = 4;  // gathers in flight per lane group (8 and 16 ran slower at d=50 and 64)
constexpr unsigned FULL = 0xffffffffu;

// bf16 to f32 is a 16-bit shift: exact
__device__ __forceinline__ float lo_bf16(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void fma2(float* acc, float v, unsigned u) {
    acc[0] = fmaf(v, lo_bf16(u), acc[0]);
    acc[1] = fmaf(v, hi_bf16(u), acc[1]);
}

// V bf16 of a row of x as one load: 16, 8, 4 or 2 bytes
template <int V>
struct Vec;

template <>
struct Vec<8> {
    using raw = uint4;
    static __device__ __forceinline__ raw load(const uint16_t* p) {
        return __ldg(reinterpret_cast<const uint4*>(p));
    }
    static __device__ __forceinline__ raw zero() { return make_uint4(0, 0, 0, 0); }
    static __device__ __forceinline__ void fma(float* acc, float v, raw r) {
        fma2(acc, v, r.x);
        fma2(acc + 2, v, r.y);
        fma2(acc + 4, v, r.z);
        fma2(acc + 6, v, r.w);
    }
};

template <>
struct Vec<4> {
    using raw = uint2;
    static __device__ __forceinline__ raw load(const uint16_t* p) {
        return __ldg(reinterpret_cast<const uint2*>(p));
    }
    static __device__ __forceinline__ raw zero() { return make_uint2(0, 0); }
    static __device__ __forceinline__ void fma(float* acc, float v, raw r) {
        fma2(acc, v, r.x);
        fma2(acc + 2, v, r.y);
    }
};

template <>
struct Vec<2> {
    using raw = unsigned;
    static __device__ __forceinline__ raw load(const uint16_t* p) {
        return __ldg(reinterpret_cast<const unsigned*>(p));
    }
    static __device__ __forceinline__ raw zero() { return 0u; }
    static __device__ __forceinline__ void fma(float* acc, float v, raw r) { fma2(acc, v, r); }
};

template <>
struct Vec<1> {
    using raw = unsigned short;
    static __device__ __forceinline__ raw load(const uint16_t* p) {
        return __ldg(reinterpret_cast<const unsigned short*>(p));
    }
    static __device__ __forceinline__ raw zero() { return 0; }
    static __device__ __forceinline__ void fma(float* acc, float v, raw r) {
        acc[0] = fmaf(v, lo_bf16(r), acc[0]);
    }
};

// features f .. f+V-1 of a row of stride d (as wide as d's alignment allows;
// the part past d is dropped)
template <int V>
__device__ __forceinline__ void store_vec(float* row, int f, int d, const float* a) {
    if (f + V <= d) {
        if (V % 4 == 0 && d % 4 == 0) {
#pragma unroll
            for (int t = 0; t < V; t += 4)
                *reinterpret_cast<float4*>(row + f + t) = make_float4(a[t], a[t + 1], a[t + 2], a[t + 3]);
        } else if (V % 2 == 0 && d % 2 == 0) {
#pragma unroll
            for (int t = 0; t < V; t += 2)
                *reinterpret_cast<float2*>(row + f + t) = make_float2(a[t], a[t + 1]);
        } else {
#pragma unroll
            for (int t = 0; t < V; ++t) row[f + t] = a[t];
        }
    } else {
#pragma unroll
        for (int t = 0; t < V; ++t)
            if (f + t < d) row[f + t] = a[t];
    }
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(g));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(g));
}

// len 4-byte words from g to s (s 16-byte aligned): 16-byte copies when g
// is 16-byte aligned too, then the remainder word by word
__device__ __forceinline__ void stage(void* s, const void* g, int len) {
    uint32_t* sw = static_cast<uint32_t*>(s);
    const uint32_t* gw = static_cast<const uint32_t*>(g);
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        const int quads = len >> 2;
        for (int i = threadIdx.x; i < quads; i += THREADS) cp_async16(sw + 4 * i, gw + 4 * i);
        done = quads << 2;
    }
    for (int i = done + threadIdx.x; i < len; i += THREADS) cp_async4(sw + i, gw + i);
}

__device__ __forceinline__ void zero_rows(float* out, int lo, int hi, int d, int lane) {
    for (int r = lo; r < hi; ++r)
        for (int f = lane; f < d; f += 32) out[(size_t)r * d + f] = 0.f;
}

// V bf16 a lane vector, LPR lanes a row of x, NV vectors a lane: lane
// `sub` of a lane group owns features (j * LPR + sub) * V .. + V - 1 for
// j < NV. A block's GROUPS = WARPS * 32 / LPR lane groups each take an equal
// share of the tile's edges.
template <int V, int LPR, int NV>
__global__ void __launch_bounds__(THREADS)
segmm_tiles(const uint16_t* __restrict__ x, int ldx, const int32_t* __restrict__ cols,
            const float* __restrict__ vals, const int32_t* __restrict__ edge_row,
            const int32_t* __restrict__ tile_row, const int32_t* __restrict__ tile_split,
            const int32_t* __restrict__ split_ptr, const int32_t* __restrict__ split_tiles,
            float* __restrict__ carry, int32_t* __restrict__ counters, int n, int d,
            int num_edges, int tile, float* __restrict__ out) {
    constexpr int GROUPS = THREADS / LPR;
    constexpr int ENTRIES = 2 * GROUPS;  // a group's first and last rows
    constexpr int A = NV * V;            // f32 sums a lane
    constexpr int Q = MAX_D / 32;
    extern __shared__ __align__(16) unsigned char smem[];
    float* spart = reinterpret_cast<float*>(smem);  // (ENTRIES, d)
    int32_t* scol = reinterpret_cast<int32_t*>(spart + ENTRIES * d);
    float* sval = reinterpret_cast<float*>(scol + tile);
    int32_t* srow = reinterpret_cast<int32_t*>(sval + tile);
    int32_t* prow = srow + tile;  // (ENTRIES): the rows in spart, -1 for none

    const int t = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int e0 = t * tile;
    const int len = min(tile, num_edges - e0);
    if (len <= 0) {  // no edge at all (one tile): every row is empty
        for (size_t i = threadIdx.x; i < (size_t)n * d; i += THREADS) out[i] = 0.f;
        return;
    }
    stage(scol, cols + e0, len);
    stage(sval, vals + e0, len);
    stage(srow, edge_row + e0, len);
    for (int i = threadIdx.x; i < ENTRIES; i += THREADS) prow[i] = -1;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += THREADS)
        sval[i] = __bfloat162float(__float2bfloat16_rn(sval[i]));
    __syncthreads();

    const int next_tile_row = tile_row[t + 1];
    if (t == 0 && warp == 0) zero_rows(out, 0, srow[0], d, lane);

    // lane group g sums edges [lo, hi) in edge order, a row at a time, U
    // gathers in flight: a row that ends inside the range and began inside
    // it goes to out; the range's first and last rows (which may go on in
    // the neighbouring ranges) to the group's two entries of spart
    const int g = threadIdx.x / LPR, sub = threadIdx.x % LPR;
    const int per = (len + GROUPS - 1) / GROUPS;
    const int lo = min(len, g * per), hi = min(len, lo + per);
    float acc[A];
#pragma unroll
    for (int q = 0; q < A; ++q) acc[q] = 0.f;
    int r = lo < hi ? srow[lo] : 0, seg = lo;
    for (int k0 = lo; k0 < hi; k0 += U) {
        typename Vec<V>::raw xs[U][NV];
        float vs[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int k = k0 + u;
            const bool live = k < hi;
            const uint16_t* xr = x + (size_t)(live ? scol[k] : 0) * ldx;
            vs[u] = live ? sval[k] : 0.f;
#pragma unroll
            for (int j = 0; j < NV; ++j) {
                const int f = (j * LPR + sub) * V;
                xs[u][j] = (live && f < d) ? Vec<V>::load(xr + f) : Vec<V>::zero();
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int k = k0 + u;
            if (k >= hi) break;
#pragma unroll
            for (int j = 0; j < NV; ++j) Vec<V>::fma(acc + j * V, vs[u], xs[u][j]);
            const int next = k + 1 < len ? srow[k + 1] : next_tile_row;
            if (k + 1 < hi && next == r) continue;
            // row r ends at k + 1 within the range, or the range ends
            float* dst = out + (size_t)r * d;
            if (seg == lo || k + 1 == hi) {
                const int entry = 2 * g + (seg == lo ? 0 : 1);
                dst = spart + entry * d;
                if (sub == 0) prow[entry] = r;
            }
#pragma unroll
            for (int j = 0; j < NV; ++j) store_vec<V>(dst, (j * LPR + sub) * V, d, acc + j * V);
            // the empty rows before the next edge's row (past the tile, the
            // next tile's first row)
            for (int z = r + 1; z < next; ++z)
                for (int f = sub; f < d; f += LPR) out[(size_t)z * d + f] = 0.f;
#pragma unroll
            for (int q = 0; q < A; ++q) acc[q] = 0.f;
            r = next;
            seg = k + 1;
        }
    }
    __syncthreads();

    // each row met in spart, summed over its entries in edge order by the
    // warp that holds its first entry
    const int head = tile_split[2 * t], tail = tile_split[2 * t + 1];
    const int first_row = srow[0], last_row = srow[len - 1];
    constexpr int PER_WARP = ENTRIES / WARPS;
    for (int i = warp * PER_WARP; i < (warp + 1) * PER_WARP; ++i) {
        const int row = prow[i];
        if (row < 0) continue;
        int j = i - 1;
        while (j >= 0 && prow[j] < 0) --j;
        if (j >= 0 && prow[j] == row) continue;
        float sum[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) sum[q] = 0.f;
        for (int k = i; k < ENTRIES; ++k) {
            const int rk = prow[k];
            if (rk < 0) continue;
            if (rk != row) break;
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const int f = lane + 32 * q;
                if (f < d) sum[q] += spart[k * d + f];
            }
        }
        const int s = (row == first_row && head >= 0) ? head : (row == last_row ? tail : -1);
        if (s < 0) {
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const int f = lane + 32 * q;
                if (f < d) out[(size_t)row * d + f] = sum[q];
            }
            continue;
        }
        // a split row: this tile's part into its slot, then count in; the
        // release of the count publishes the slot (the warp's stores come
        // before it through __syncwarp), the acquire of the last count sees
        // every slot
        const int c0 = split_ptr[s], c1 = split_ptr[s + 1];
        float* mine = carry + (size_t)(c0 + t - split_tiles[c0]) * d;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int f = lane + 32 * q;
            if (f < d) __stcg(mine + f, sum[q]);
        }
        __syncwarp();
        int arrived = 0;
        if (lane == 0) {
            cuda::atomic_ref<int32_t, cuda::thread_scope_device> count(counters[s]);
            arrived = count.fetch_add(1, cuda::memory_order_acq_rel);
        }
        arrived = __shfl_sync(FULL, arrived, 0);
        if (arrived != c1 - c0 - 1) continue;
        // the last to arrive adds the row's slots in tile order
#pragma unroll
        for (int q = 0; q < Q; ++q) sum[q] = 0.f;
        for (int c = c0; c < c1; ++c) {
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const int f = lane + 32 * q;
                if (f < d) sum[q] += __ldcg(carry + (size_t)c * d + f);
            }
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int f = lane + 32 * q;
            if (f < d) out[(size_t)row * d + f] = sum[q];
        }
        if (lane == 0) counters[s] = 0;
    }
}

template <int V, int LPR, int NV>
int launch(const void* x, int ldx, const void* cols, const void* vals, const void* edge_row,
           const void* tile_row, const void* tile_split, const void* split_ptr,
           const void* split_tiles, void* carry, void* counters, int n, int d, int num_edges,
           int tile, int num_tiles, void* out, cudaStream_t st) {
    auto kernel = segmm_tiles<V, LPR, NV>;
    const size_t entries = 2 * THREADS / LPR;
    const size_t smem = entries * d * 4 + (size_t)tile * 12 + entries * 4;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<num_tiles, THREADS, smem, st>>>(
        static_cast<const uint16_t*>(x), ldx, static_cast<const int32_t*>(cols),
        static_cast<const float*>(vals), static_cast<const int32_t*>(edge_row),
        static_cast<const int32_t*>(tile_row), static_cast<const int32_t*>(tile_split),
        static_cast<const int32_t*>(split_ptr), static_cast<const int32_t*>(split_tiles),
        static_cast<float*>(carry), static_cast<int32_t*>(counters), n, d, num_edges, tile,
        static_cast<float*>(out));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, d) bf16 with row stride ldx elements; cols (E) int32 and vals (E)
// f32 of a row-sorted CSR matrix with n rows; edge_row (E), tile_row
// (num_tiles + 1), tile_split (num_tiles, 2), split_ptr (S + 1) and
// split_tiles (C) int32, the host's schedule of `tile`-edge tiles; carry
// (C, >= d) f32 and counters (S) int32 its scratch (counters 0 on entry,
// left 0); out (n, d) f32. Returns cudaGetLastError() after the launch.
int qrec_segment_matmul(const void* x, int ldx, const void* cols, const void* vals,
                        const void* edge_row, const void* tile_row, const void* tile_split,
                        const void* split_ptr, const void* split_tiles, void* carry,
                        void* counters, int n, int d, int num_edges, int tile, int num_tiles,
                        void* out, void* stream) {
    if (n <= 0 || d <= 0 || d > MAX_D || ldx < d || num_edges < 0 || tile <= 0 || tile % 4 ||
        num_tiles != (num_edges > 0 ? (num_edges + tile - 1) / tile : 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
    const int v = (ldx % 8 == 0 && xa % 16 == 0)  ? 8
                  : (ldx % 4 == 0 && xa % 8 == 0) ? 4
                  : (ldx % 2 == 0 && xa % 4 == 0) ? 2
                                                   : 1;
    const int nvec = (d + v - 1) / v;
#define QREC_SEGMM(V, LPR, NV)                                                                 \
    launch<V, LPR, NV>(x, ldx, cols, vals, edge_row, tile_row, tile_split, split_ptr,          \
                       split_tiles, carry, counters, n, d, num_edges, tile, num_tiles, out, st)
    if (v == 8) {  // LPR lanes a row, the fewest that hold it (nvec <= 32)
        if (nvec <= 1) return QREC_SEGMM(8, 1, 1);
        if (nvec <= 2) return QREC_SEGMM(8, 2, 1);
        if (nvec <= 4) return QREC_SEGMM(8, 4, 1);
        if (nvec <= 8) return QREC_SEGMM(8, 8, 1);
        if (nvec <= 16) return QREC_SEGMM(8, 16, 1);
        return QREC_SEGMM(8, 32, 1);
    }
    // narrower vectors (a row stride or base that 16 bytes do not divide):
    // a whole warp a row
    const int nv = (nvec + 31) / 32;
    if (v == 4) return nv == 1 ? QREC_SEGMM(4, 32, 1) : QREC_SEGMM(4, 32, 2);
    if (v == 2) {
        switch (nv) {
            case 1: return QREC_SEGMM(2, 32, 1);
            case 2: return QREC_SEGMM(2, 32, 2);
            case 3: return QREC_SEGMM(2, 32, 3);
            default: return QREC_SEGMM(2, 32, 4);
        }
    }
    switch (nv) {
        case 1: return QREC_SEGMM(1, 32, 1);
        case 2: return QREC_SEGMM(1, 32, 2);
        case 3: return QREC_SEGMM(1, 32, 3);
        case 4: return QREC_SEGMM(1, 32, 4);
        case 5: return QREC_SEGMM(1, 32, 5);
        case 6: return QREC_SEGMM(1, 32, 6);
        case 7: return QREC_SEGMM(1, 32, 7);
        default: return QREC_SEGMM(1, 32, 8);
    }
#undef QREC_SEGMM
}

}  // extern "C"
