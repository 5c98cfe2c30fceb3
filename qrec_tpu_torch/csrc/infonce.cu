// Masked InfoNCE over L2-normalized views, forward (K3) and backward (K4).
//
//   logits[r, c] = v1[r] . v2[c] / T, set to -1e30 where cmask[c] == 0
//   pos[r]       = logits[r, r + row_offset] (read after masking)
//   loss         = sum_r rmask[r] * (logsumexp_c logits[r, c] - pos[r])
//   dlog[r, c]   = rmask[r] * (softmax_c(logits)[r, c] - [c == r + row_offset]) / T
//   dv1 = dlog @ v2,  dv2 = dlogᵀ @ v1
//
// Replaces the Pallas TPU kernels `_infonce_kernel` (forward,
// qrec_tpu/ops/pallas_kernels.py:155-191, called at :218) and
// `_infonce_bwd_kernel` (backward, :242-285, called at :292). v1 holds the
// b_loc rows of this device (all of them on one device, row_offset 0), v2
// and cmask the whole batch of B rows. Neither kernel writes the (b_loc, B)
// logits or probabilities to device memory.
//
// What bounds them on an H100: the work, not the bytes. At B = 4000, d = 50
// the inputs are 1.6 MB, but the forward is one B x B x d product (1.6
// GFLOP, 24 us at the 67 TFLOP/s of f32 FMA on the CUDA cores) and the
// backward three (72 us). They stay in f32 (no TF32, which keeps about
// three digits), so the tensor cores' f32 path is not used.
//
// Design. The TPU kernels walk a sequential grid of row blocks, summing the
// loss into one SMEM scalar and dv2 into one resident block; on Hopper the
// blocks run in no order, so each output is owned by one block and every
// cross-block sum is a second pass in a fixed order. No float atomics: a
// call repeats bit for bit. Both kernels walk tiles of CT rows of the other
// operand through shared memory, double-buffered: the next tile's copy
// (cp.async) is in flight while the current one is used, since a block that
// waits for each tile is bound by the load latency, not by its FMAs.
//   K3 pass 1 (infonce_fwd_partial): block (strip, split) holds RS rows of
//     v1 in shared memory (transposed, one 16-byte load gives a thread its 4
//     rows' values of one feature) and walks its split's columns of v2. A
//     thread owns 4 rows x 1 column of a tile and keeps an online (max, sum
//     of exp) per row, flash style; the thread that meets the diagonal keeps
//     pos. Warp shuffles and one shared-memory step merge the 64 threads of
//     a row into the split's (max, sum, pos). Columns are split so that
//     strips x splits gives each SM several blocks (B = 2000 has only 125
//     strips of 16 rows for 132 SMs).
//   K3 pass 2 (infonce_fwd_finish, one block): merges the splits of each row
//     in split order, writes lse (kept for K4) and sums rmask * (lse - pos)
//     by a fixed tree.
//   K4 pass 1 (infonce_bwd_partial): blockIdx.y = 0 takes a strip of v1 rows
//     against a part of v2's rows and sums its rows of dv1; blockIdx.y = 1
//     takes a strip of v2 rows (columns of the logits) against a part of
//     v1's rows and sums its rows of dv2. Both recompute their logits tile
//     with the same fused multiply-adds in the same order as K3, so the
//     logits match K3's bit for bit, and take p = exp(logit - lse) from K3's
//     saved lse instead of recomputing the row statistics. The tile's dlog
//     goes to shared memory and is multiplied into register accumulators (4
//     strip rows x NK features a thread). The B x B product is recomputed
//     once per orientation, so K4 does four B x B x d products where the
//     function needs three.
//   K4 pass 2 (infonce_bwd_reduce): when the other operand is split into
//     parts, sums the parts' partial rows in part order.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RS = 16;               // strip rows per block
constexpr int CT = 64;               // rows of the other operand per tile
constexpr int THREADS = 256;         // (RS / 4) row groups x CT lanes
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;
constexpr int FIN_THREADS = 1024;
constexpr int BLOCKS_PER_SM = 4;     // pass-1 blocks a launch aims for on each SM
constexpr float MASKED = -1e30f;     // finite, as the TPU kernel's mask value
static_assert(THREADS == (RS / 4) * CT, "a thread owns 4 strip rows x 1 tile row");
static_assert(CT == 2 * 32, "a row group spans two warps");

// Odd row stride of a staged tile: lanes reading one feature of 32
// consecutive rows hit 32 banks.
__host__ __device__ inline int row_stride(int d) { return d | 1; }

// the strip, two tiles, and for K4 the dlog tile
size_t fwd_smem_bytes(int d) { return sizeof(float) * ((size_t)d * RS + 2 * (size_t)CT * row_stride(d)); }
size_t bwd_smem_bytes(int d) { return fwd_smem_bytes(d) + sizeof(float) * CT * RS; }

// Staging: warp w copies rows w, w + WARPS, ...; its lanes stride one row's
// features, so global reads coalesce and no index is divided by d.

// a_t[k * RS + r] = x[r0 + r][k] for r0 + r < n, else 0
__device__ void load_strip(float* a_t, const float* __restrict__ x, int r0, int n, int d) {
    for (int r = threadIdx.x / 32; r < RS; r += WARPS) {
        const float* src = x + (size_t)(r0 + r) * d;
        for (int k = threadIdx.x % 32; k < d; k += 32) a_t[k * RS + r] = r0 + r < n ? src[k] : 0.f;
    }
}

// b_s[t * ld + k] = y[t0 + t][k] for t0 + t < end, else 0: rows in range
// are copied asynchronously as one commit group, the others zeroed
__device__ void load_tile_async(float* b_s, const float* __restrict__ y, int t0, int end, int d,
                                int ld) {
    for (int t = threadIdx.x / 32; t < CT; t += WARPS) {
        float* dst = b_s + t * ld;
        const float* src = y + (size_t)(t0 + t) * d;
        const bool in = t0 + t < end;
        for (int k = threadIdx.x % 32; k < d; k += 32) {
            if (in) {
                __pipeline_memcpy_async(dst + k, src + k, sizeof(float));
            } else {
                dst[k] = 0.f;
            }
        }
    }
    __pipeline_commit();
}

// Walks the tiles of rows [begin, end) of y, double-buffered in b_s (two
// tiles of CT * ld floats): use(tile, t0) sees every row of the tile at t0
// in place, for every thread of the block.
template <typename Use>
__device__ __forceinline__ void for_each_tile(float* b_s, const float* __restrict__ y, int begin,
                                              int end, int d, int ld, Use use) {
    const int tile_floats = CT * ld;
    int cur = 0;
    if (begin < end) load_tile_async(b_s, y, begin, end, d, ld);
    for (int t0 = begin; t0 < end; t0 += CT, cur ^= 1) {
        if (t0 + CT < end) {
            load_tile_async(b_s + (cur ^ 1) * tile_floats, y, t0 + CT, end, d, ld);
        } else {
            __pipeline_commit();  // an empty group keeps the count below
        }
        __pipeline_wait_prior(1);  // this thread's copies of the current tile landed
        __syncthreads();           // ... and every thread's
        use(b_s + cur * tile_floats, t0);
        __syncthreads();  // the tile is consumed before it is refilled
    }
}

// acc[i] = sum over k, in order, of strip row (4 grp + i) times tile row lane
__device__ __forceinline__ void tile_dots(const float* a_t, const float* b_s, int d, int ld,
                                          int grp, int lane, float acc[4]) {
    acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
    const float* a = a_t + grp * 4;
    const float* b = b_s + lane * ld;
    for (int k = 0; k < d; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(a + k * RS);
        const float bv = b[k];
        acc[0] = fmaf(av.x, bv, acc[0]);
        acc[1] = fmaf(av.y, bv, acc[1]);
        acc[2] = fmaf(av.z, bv, acc[2]);
        acc[3] = fmaf(av.w, bv, acc[3]);
    }
}

__device__ __forceinline__ float masked_logit(float dot, float cmask, float temperature) {
    return cmask > 0.f ? dot / temperature : MASKED;
}

// (m, s) <- online logsumexp state after one more value x
__device__ __forceinline__ void lse_push(float& m, float& s, float x) {
    if (x > m) {
        s = s * expf(m - x) + 1.f;
        m = x;
    } else {
        s += expf(x - m);
    }
}

// (m, s) <- merge of two states; a state with s == 0 has seen no value.
// Symmetric in its two arguments, so both lanes of a shuffle pair agree.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
    if (s2 == 0.f) return;
    if (s == 0.f) {
        m = m2;
        s = s2;
        return;
    }
    const float mm = fmaxf(m, m2);
    s = s * expf(m - mm) + s2 * expf(m2 - mm);
    m = mm;
}

// part: (3, splits, b_loc) = per split (max, sum of exp, pos) of each row
__global__ void __launch_bounds__(THREADS)
infonce_fwd_partial(const float* __restrict__ v1, const float* __restrict__ v2,
                    const float* __restrict__ cmask, int b_loc, int B, int d, float temperature,
                    int row_offset, int cols_per_split, float* __restrict__ part) {
    extern __shared__ float4 smem_raw[];
    float* a_t = reinterpret_cast<float*>(smem_raw);
    float* b_s = a_t + d * RS;
    __shared__ float red[WARPS][4][3];
    const int ld = row_stride(d);
    const int grp = threadIdx.x / CT, lane = threadIdx.x % CT;
    const int r0 = blockIdx.x * RS;
    const int split = blockIdx.y, splits = gridDim.y;
    const int c_begin = split * cols_per_split;
    const int c_end = min(B, c_begin + cols_per_split);

    load_strip(a_t, v1, r0, b_loc, d);
    float m[4], s[4], pos[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        s[i] = 0.f;
        pos[i] = 0.f;
    }
    for_each_tile(b_s, v2, c_begin, c_end, d, ld, [&](const float* tile, int t0) {
        const int c = t0 + lane;
        if (c < c_end) {
            float acc[4];
            tile_dots(a_t, tile, d, ld, grp, lane, acc);
            const float cm = cmask[c];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float x = masked_logit(acc[i], cm, temperature);
                if (r0 + grp * 4 + i + row_offset == c) pos[i] = x;
                lse_push(m[i], s[i], x);
            }
        }
    });
    // at most one thread of the grid holds a row's pos; the others add 0
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
            const float s2 = __shfl_xor_sync(0xffffffffu, s[i], off);
            const float p2 = __shfl_xor_sync(0xffffffffu, pos[i], off);
            lse_merge(m[i], s[i], m2, s2);
            pos[i] += p2;
        }
    }
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            red[warp][i][0] = m[i];
            red[warp][i][1] = s[i];
            red[warp][i][2] = pos[i];
        }
    }
    __syncthreads();
    if (threadIdx.x < RS && r0 + threadIdx.x < b_loc) {
        const int g = threadIdx.x / 4, i = threadIdx.x % 4;
        float mm = red[2 * g][i][0], ss = red[2 * g][i][1];
        lse_merge(mm, ss, red[2 * g + 1][i][0], red[2 * g + 1][i][1]);
        const float pp = red[2 * g][i][2] + red[2 * g + 1][i][2];
        const size_t row = r0 + threadIdx.x;
        part[((size_t)0 * splits + split) * b_loc + row] = mm;
        part[((size_t)1 * splits + split) * b_loc + row] = ss;
        part[((size_t)2 * splits + split) * b_loc + row] = pp;
    }
}

__global__ void __launch_bounds__(FIN_THREADS)
infonce_fwd_finish(const float* __restrict__ part, const float* __restrict__ rmask, int b_loc,
                   int splits, float* __restrict__ lse, float* __restrict__ out) {
    __shared__ float red[FIN_THREADS];
    const size_t n = b_loc;
    float acc = 0.f;
    for (int r = threadIdx.x; r < b_loc; r += FIN_THREADS) {
        float m = part[r], s = part[splits * n + r], pos = part[2 * splits * n + r];
        for (int p = 1; p < splits; ++p) {
            lse_merge(m, s, part[p * n + r], part[(splits + p) * n + r]);
            pos += part[(2 * splits + p) * n + r];
        }
        const float l = m + logf(s);
        lse[r] = l;
        acc += rmask[r] * (l - pos);
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int stride = FIN_THREADS / 2; stride > 0; stride >>= 1) {
        if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[0] = red[0];
}

// out (or, with several parts, part z of the partials): rows [0, b_loc)
// hold dv1, rows [b_loc, b_loc + B) dv2. NK = ceil(d / CT) features a lane.
template <int NK>
__global__ void __launch_bounds__(THREADS)
infonce_bwd_partial(const float* __restrict__ v1, const float* __restrict__ v2,
                    const float* __restrict__ cmask, const float* __restrict__ rmask,
                    const float* __restrict__ lse, int b_loc, int B, int d, float temperature,
                    int row_offset, int parts, float* __restrict__ out) {
    const bool cols = blockIdx.y == 1;  // strip rows are logit columns
    const float* a = cols ? v2 : v1;
    const float* b = cols ? v1 : v2;
    const int na = cols ? B : b_loc, nb = cols ? b_loc : B;
    const int s0 = blockIdx.x * RS;
    if (s0 >= na) return;
    const int per = ((nb + CT - 1) / CT + parts - 1) / parts * CT;  // rows of b per part
    const int t_begin = blockIdx.z * per;
    const int t_end = min(nb, t_begin + per);
    float* o = out + ((size_t)blockIdx.z * (b_loc + B) + (cols ? b_loc : 0)) * d;

    extern __shared__ float4 smem_raw[];
    float* a_t = reinterpret_cast<float*>(smem_raw);
    float* b_s = a_t + d * RS;
    float* w_s = b_s + 2 * CT * row_stride(d);  // w_s[t * RS + r]: dlog of (strip row r, tile row t)
    const int ld = row_stride(d);
    const int grp = threadIdx.x / CT, lane = threadIdx.x % CT;

    load_strip(a_t, a, s0, na, d);
    float acc[4][NK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NK; ++j) acc[i][j] = 0.f;

    for_each_tile(b_s, b, t_begin, t_end, d, ld, [&](const float* tile, int t0) {
        float dot[4], w[4];
        tile_dots(a_t, tile, d, ld, grp, lane, dot);
        const int t = t0 + lane;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int s = s0 + grp * 4 + i;
            w[i] = 0.f;
            if (s < na && t < t_end) {
                const int r = cols ? t : s, c = cols ? s : t;
                const float p = expf(masked_logit(dot[i], cmask[c], temperature) - lse[r]);
                const float diag = c == r + row_offset ? 1.f : 0.f;
                w[i] = rmask[r] * (p - diag) / temperature;
            }
        }
        *reinterpret_cast<float4*>(w_s + lane * RS + grp * 4) = make_float4(w[0], w[1], w[2], w[3]);
        __syncthreads();
        for (int tt = 0; tt < CT; ++tt) {
            const float4 wv = *reinterpret_cast<const float4*>(w_s + tt * RS + grp * 4);
            const float* brow = tile + tt * ld;
#pragma unroll
            for (int j = 0; j < NK; ++j) {
                const int k = lane + CT * j;
                if (k < d) {
                    const float bv = brow[k];
                    acc[0][j] = fmaf(wv.x, bv, acc[0][j]);
                    acc[1][j] = fmaf(wv.y, bv, acc[1][j]);
                    acc[2][j] = fmaf(wv.z, bv, acc[2][j]);
                    acc[3][j] = fmaf(wv.w, bv, acc[3][j]);
                }
            }
        }
    });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = s0 + grp * 4 + i;
        if (s >= na) continue;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
            const int k = lane + CT * j;
            if (k < d) o[(size_t)s * d + k] = acc[i][j];
        }
    }
}

// out[e] = sum over p in order of part[p][e], for e < n
__global__ void infonce_bwd_reduce(const float* __restrict__ part, float* __restrict__ out,
                                   long long n, int parts) {
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
         e += (long long)gridDim.x * blockDim.x) {
        float acc = part[e];
        for (int p = 1; p < parts; ++p) acc += part[(long long)p * n + e];
        out[e] = acc;
    }
}

// Column splits of K3's pass 1: about BLOCKS_PER_SM (strip, split) blocks
// on each SM, each split a whole number of tiles, no split empty.
int fwd_splits(int b_loc, int B, int num_sms, int* cols_per_split) {
    const int strips = (b_loc + RS - 1) / RS;
    const int tiles = (B + CT - 1) / CT;
    const int want = (BLOCKS_PER_SM * num_sms + strips - 1) / strips;
    const int splits = want < 1 ? 1 : (want > tiles ? tiles : want);
    *cols_per_split = (tiles + splits - 1) / splits * CT;
    return (B + *cols_per_split - 1) / *cols_per_split;
}

// Parts of K4's pass 1: the other operand's rows are split so that strips x
// 2 orientations x parts gives each SM about BLOCKS_PER_SM blocks; each
// part is a whole number of tiles of the shorter operand.
int bwd_parts(int b_loc, int B, int num_sms) {
    const int strips = ((b_loc > B ? b_loc : B) + RS - 1) / RS;
    const int tiles = ((b_loc < B ? b_loc : B) + CT - 1) / CT;
    const int want = (BLOCKS_PER_SM * num_sms + 2 * strips - 1) / (2 * strips);
    return want < 1 ? 1 : (want > tiles ? tiles : want);
}

template <int NK>
int launch_bwd(const float* v1, const float* v2, const float* cmask, const float* rmask,
               const float* lse, float* part, float* out, int b_loc, int B, int d,
               float temperature, int row_offset, int parts, int num_sms, cudaStream_t st) {
    const size_t smem = bwd_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(infonce_bwd_partial<NK>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int rows = b_loc > B ? b_loc : B;
    dim3 grid((rows + RS - 1) / RS, 2, parts);
    infonce_bwd_partial<NK><<<grid, THREADS, smem, st>>>(v1, v2, cmask, rmask, lse, b_loc, B, d,
                                                         temperature, row_offset, parts,
                                                         parts > 1 ? part : out);
    err = cudaGetLastError();
    if (err != cudaSuccess || parts == 1) return (int)err;
    infonce_bwd_reduce<<<BLOCKS_PER_SM * num_sms, 256, 0, st>>>(part, out, (long long)(b_loc + B) * d,
                                                               parts);
    return (int)cudaGetLastError();
}

bool bad_shape(int b_loc, int B, int d, float temperature) {
    return b_loc <= 0 || B <= 0 || d <= 0 || d > MAX_D || !(temperature > 0.f);
}

}  // namespace

extern "C" {

// Floats of scratch that qrec_infonce_fwd needs for these sizes.
int qrec_infonce_fwd_scratch(int b_loc, int B, int num_sms) {
    int per = 0;
    return 3 * fwd_splits(b_loc, B, num_sms, &per) * b_loc;
}

// v1 (b_loc, d), v2 (B, d), cmask (B), rmask (b_loc) f32; part: the scratch
// above; lse (b_loc) and out (1) f32 are written. d <= 256. Returns
// cudaGetLastError() after the launches.
int qrec_infonce_fwd(const void* v1, const void* v2, const void* cmask, const void* rmask,
                     void* part, void* lse, void* out, int b_loc, int B, int d,
                     float temperature, int row_offset, int num_sms, void* stream) {
    if (bad_shape(b_loc, B, d, temperature) || num_sms <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = fwd_smem_bytes(d);
    cudaError_t err = cudaFuncSetAttribute(
        infonce_fwd_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per = 0;
    const int splits = fwd_splits(b_loc, B, num_sms, &per);
    dim3 grid((b_loc + RS - 1) / RS, splits);
    infonce_fwd_partial<<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(v1), static_cast<const float*>(v2),
        static_cast<const float*>(cmask), b_loc, B, d, temperature, row_offset, per,
        static_cast<float*>(part));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    infonce_fwd_finish<<<1, FIN_THREADS, 0, st>>>(
        static_cast<const float*>(part), static_cast<const float*>(rmask), b_loc, splits,
        static_cast<float*>(lse), static_cast<float*>(out));
    return (int)cudaGetLastError();
}

// Floats of scratch that qrec_infonce_bwd needs for these sizes (0 when the
// other operand is not split).
int qrec_infonce_bwd_scratch(int b_loc, int B, int d, int num_sms) {
    const int parts = bwd_parts(b_loc, B, num_sms);
    return parts > 1 ? parts * (b_loc + B) * d : 0;
}

// As qrec_infonce_fwd, with lse (b_loc) from it; part: the scratch above;
// out (b_loc + B, d) f32 is written, dv1 in its first b_loc rows and dv2 in
// the rest. Returns cudaGetLastError() after the launches.
int qrec_infonce_bwd(const void* v1, const void* v2, const void* cmask, const void* rmask,
                     const void* lse, void* part, void* out, int b_loc, int B, int d,
                     float temperature, int row_offset, int num_sms, void* stream) {
    if (bad_shape(b_loc, B, d, temperature) || num_sms <= 0) return (int)cudaErrorInvalidValue;
    const int parts = bwd_parts(b_loc, B, num_sms);
    const float* a = static_cast<const float*>(v1);
    const float* b = static_cast<const float*>(v2);
    const float* cm = static_cast<const float*>(cmask);
    const float* rm = static_cast<const float*>(rmask);
    const float* l = static_cast<const float*>(lse);
    float* pt = static_cast<float*>(part);
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d <= CT) return launch_bwd<1>(a, b, cm, rm, l, pt, o, b_loc, B, d, temperature, row_offset, parts,
                                  num_sms, st);
    if (d <= 2 * CT) return launch_bwd<2>(a, b, cm, rm, l, pt, o, b_loc, B, d, temperature, row_offset, parts,
                                  num_sms, st);
    return launch_bwd<MAX_D / CT>(a, b, cm, rm, l, pt, o, b_loc, B, d, temperature, row_offset, parts,
                                  num_sms, st);
}

}  // extern "C"
