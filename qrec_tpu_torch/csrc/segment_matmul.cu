// Weighted segment SpMM over a row-sorted CSR matrix:
//   out[r] = sum over edges e of row r of f32(bf16(vals[e])) * f32(x[cols[e]])
// with x (N, d) bf16, out (N, d) f32 and every row written (an empty row as
// zeros).
//
// Replaces the Pallas TPU kernel `weighted_segment_matmul` / `_segmm_kernel`
// (qrec_tpu/ops/pallas_kernels.py:478-533), which the JAX package's
// `PaddedCOO` drives (qrec_tpu/ops/spmm.py:555-702). It computes the same
// function, not the TPU's one-hot matrix product: the TPU kernel rounds the
// edge values to bf16 (`.astype(bfloat16)` of its selection matrix) and
// multiplies them by the bf16 gathered rows with f32 sums. A product of two
// bf16 values is exact in f32, so the results differ from the TPU's only by
// the order of the f32 sums. The TPU version gathers x[cols] into an
// (E, d) copy in device memory first; here the gather is fused: each warp
// reads the rows of x its edges name, and no gathered copy exists.
//
// What bounds it on an H100: counted as the function, the CSR (8 bytes an
// edge plus the row pointers), x once and out once over 3.35 TB/s; 2 x E x
// d FLOP is far below the f32 rate. The kernel reads a row of x once per
// edge that names it (E x d x 2 bytes), mostly from L2 (x is 5.2 MB at the
// yelp2018 shape): it is bound by the latency of those gathers.
//
// Design. Rows have skewed degrees (zipf item popularity: the heaviest
// item row has thousands of edges against a mean near 20), so a warp per
// row would let one row set the kernel's time. The host splits every row
// into chunks of `chunk` edges (an empty row is one empty chunk) and lists
// each chunk's row (`chunk_row`) and each row's first chunk (`chunk_ptr`):
//   pass 1 (segmm_chunks): one warp per chunk. The warp loads 32 (col,
//     value) pairs at a time, rounds the values to bf16, and broadcasts
//     each pair by shuffles; each lane loads its features of G rows of x
//     at once (G loads in flight), then accumulates them weighted in f32
//     registers, in edge order. A row of one chunk is written to out
//     directly; the chunks of a longer row write partial rows, indexed by
//     chunk, to `part`.
//   pass 2 (segmm_long_rows): one warp per long row (`long_rows`) sums the
//     row's partials in four interleaved sums (four loads in flight) and
//     adds those in a fixed order into out.
// No atomics: a call repeats bit for bit. Lanes own pairs of features
// (bf16x2 loads, float2 stores) when d is even, single features when it is
// odd; any 1 <= d <= 256.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one chunk or one long row each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;
constexpr unsigned FULL = 0xffffffffu;

// V features per lane vector (2 for even d, 1 for odd d), NV vectors per
// lane: lane l owns features (j * 32 + l) * V .. + V - 1 for j < NV. `raw`
// holds a vector of x as loaded, so that all loads are in flight before any use.
template <int V>
struct Vec;

template <>
struct Vec<1> {
    using raw = __nv_bfloat16;
    static __device__ __forceinline__ raw load(const __nv_bfloat16* p) { return *p; }
    static __device__ __forceinline__ raw zero() { return __float2bfloat16_rn(0.f); }
    static __device__ __forceinline__ void fma(float* acc, float v, raw x) {
        acc[0] = fmaf(v, __bfloat162float(x), acc[0]);
    }
    static __device__ __forceinline__ void add(float* acc, const float* p) { acc[0] += *p; }
    static __device__ __forceinline__ void store(float* p, const float* acc) { *p = acc[0]; }
};

template <>
struct Vec<2> {
    using raw = __nv_bfloat162;
    static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
        return *reinterpret_cast<const __nv_bfloat162*>(p);
    }
    static __device__ __forceinline__ raw zero() { return __float2bfloat162_rn(0.f); }
    static __device__ __forceinline__ void fma(float* acc, float v, raw x) {
        const float2 xf = __bfloat1622float2(x);
        acc[0] = fmaf(v, xf.x, acc[0]);
        acc[1] = fmaf(v, xf.y, acc[1]);
    }
    static __device__ __forceinline__ void add(float* acc, const float* p) {
        const float2 f = *reinterpret_cast<const float2*>(p);
        acc[0] += f.x;
        acc[1] += f.y;
    }
    static __device__ __forceinline__ void store(float* p, const float* acc) {
        *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
    }
};

template <int V, int NV>
__global__ void __launch_bounds__(THREADS)
segmm_chunks(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ indptr,
             const int32_t* __restrict__ cols, const float* __restrict__ vals,
             const int32_t* __restrict__ chunk_ptr, const int32_t* __restrict__ chunk_row,
             int num_chunks, int chunk, int d, float* __restrict__ out,
             float* __restrict__ part) {
    // edges whose rows of x are loaded before their products are added: the
    // gathers are latency-bound, so a warp keeps G loads in flight
    constexpr int G = NV * V <= 2 ? 8 : 4;
    const int lane = threadIdx.x & 31;
    const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (c >= num_chunks) return;  // whole warps only: c is warp-uniform
    const int r = chunk_row[c];
    const int first = chunk_ptr[r];
    const bool whole_row = chunk_ptr[r + 1] - first == 1;
    const int e0 = indptr[r] + (c - first) * chunk;
    const int e1 = min(indptr[r + 1], e0 + chunk);

    float acc[NV][V];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int t = 0; t < V; ++t) acc[j][t] = 0.f;

    for (int base = e0; base < e1; base += 32) {
        const int e = base + lane;
        int col = 0;
        float v = 0.f;
        if (e < e1) {
            col = cols[e];
            v = __bfloat162float(__float2bfloat16_rn(vals[e]));
        }
        const int n = min(32, e1 - base);  // warp-uniform
        for (int k0 = 0; k0 < n; k0 += G) {
            typename Vec<V>::raw xs[G][NV];
            float vs[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int ck = __shfl_sync(FULL, col, (k0 + g) & 31);
                vs[g] = __shfl_sync(FULL, v, (k0 + g) & 31);
                const __nv_bfloat16* xr = x + (size_t)ck * d;
#pragma unroll
                for (int j = 0; j < NV; ++j) {
                    const int f = (j * 32 + lane) * V;
                    xs[g][j] = (k0 + g < n && f < d) ? Vec<V>::load(xr + f) : Vec<V>::zero();
                }
            }
            // the products in edge order: a row of one chunk sums exactly as
            // a sequential f32 sum of its exact products
#pragma unroll
            for (int g = 0; g < G; ++g) {
                if (k0 + g < n) {
#pragma unroll
                    for (int j = 0; j < NV; ++j) Vec<V>::fma(acc[j], vs[g], xs[g][j]);
                }
            }
        }
    }

    float* dst = whole_row ? out + (size_t)r * d : part + (size_t)c * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        const int f = (j * 32 + lane) * V;
        if (f < d) Vec<V>::store(dst + f, acc[j]);
    }
}

template <int V, int NV>
__global__ void __launch_bounds__(THREADS)
segmm_long_rows(const int32_t* __restrict__ chunk_ptr, const int32_t* __restrict__ long_rows,
                int num_long, int d, const float* __restrict__ part, float* __restrict__ out) {
    // S interleaved sums over the row's chunks, so S loads are in flight,
    // added in a fixed order at the end
    constexpr int S = 4;
    const int lane = threadIdx.x & 31;
    const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (w >= num_long) return;
    const int r = long_rows[w];
    const int c0 = chunk_ptr[r], c1 = chunk_ptr[r + 1];
    float acc[S][NV][V];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
            for (int t = 0; t < V; ++t) acc[s][j][t] = 0.f;
    for (int c = c0; c < c1; c += S) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            if (c + s < c1) {
                const float* p = part + (size_t)(c + s) * d;
#pragma unroll
                for (int j = 0; j < NV; ++j) {
                    const int f = (j * 32 + lane) * V;
                    if (f < d) Vec<V>::add(acc[s][j], p + f);
                }
            }
        }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        const int f = (j * 32 + lane) * V;
        if (f >= d) continue;
        float sum[V];
#pragma unroll
        for (int t = 0; t < V; ++t)
            sum[t] = (acc[0][j][t] + acc[1][j][t]) + (acc[2][j][t] + acc[3][j][t]);
        Vec<V>::store(out + (size_t)r * d + f, sum);
    }
}

template <int V, int NV>
int launch(const void* x, const void* indptr, const void* cols, const void* vals,
           const void* chunk_ptr, const void* chunk_row, const void* long_rows, int d,
           int num_chunks, int num_long, int chunk, void* part, void* out, cudaStream_t st) {
    const int32_t* cp = static_cast<const int32_t*>(chunk_ptr);
    float* o = static_cast<float*>(out);
    float* p = static_cast<float*>(part);
    segmm_chunks<V, NV><<<(num_chunks + WARPS - 1) / WARPS, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(indptr),
        static_cast<const int32_t*>(cols), static_cast<const float*>(vals), cp,
        static_cast<const int32_t*>(chunk_row), num_chunks, chunk, d, o, p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || num_long == 0) return (int)err;
    segmm_long_rows<V, NV><<<(num_long + WARPS - 1) / WARPS, THREADS, 0, st>>>(
        cp, static_cast<const int32_t*>(long_rows), num_long, d, p, o);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, d) bf16; indptr (n + 1), cols (E) int32 and vals (E) f32 of a
// row-sorted CSR matrix with n rows; chunk_ptr (n + 1), chunk_row
// (num_chunks) and long_rows (num_long) int32, the host's split of the rows
// into chunks of `chunk` edges (every row at least one chunk, long rows
// those of more than one); part (num_chunks, d) f32 scratch, out (n, d) f32.
// Returns cudaGetLastError() after the launches.
int qrec_segment_matmul(const void* x, const void* indptr, const void* cols, const void* vals,
                        const void* chunk_ptr, const void* chunk_row, const void* long_rows,
                        int n, int d, int num_chunks, int num_long, int chunk, void* part,
                        void* out, void* stream) {
    if (n <= 0 || d <= 0 || d > MAX_D || chunk <= 0 || num_chunks < n || num_long < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QREC_SEGMM(V, NV) \
    launch<V, NV>(x, indptr, cols, vals, chunk_ptr, chunk_row, long_rows, d, num_chunks, \
                  num_long, chunk, part, out, st)
    if (d % 2 == 0) {
        switch ((d + 63) / 64) {
            case 1: return QREC_SEGMM(2, 1);
            case 2: return QREC_SEGMM(2, 2);
            case 3: return QREC_SEGMM(2, 3);
            default: return QREC_SEGMM(2, 4);
        }
    }
    switch ((d + 31) / 32) {
        case 1: return QREC_SEGMM(1, 1);
        case 2: return QREC_SEGMM(1, 2);
        case 3: return QREC_SEGMM(1, 3);
        case 4: return QREC_SEGMM(1, 4);
        case 5: return QREC_SEGMM(1, 5);
        case 6: return QREC_SEGMM(1, 6);
        case 7: return QREC_SEGMM(1, 7);
        default: return QREC_SEGMM(1, 8);
    }
#undef QREC_SEGMM
}

}  // extern "C"
