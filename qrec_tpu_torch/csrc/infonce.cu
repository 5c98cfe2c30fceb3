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
// three digits), so the tensor cores' f32 path is not used. Inside a
// block the limit is shared memory: an SM delivers 32 floats a clock to
// 128 FMA lanes, so a loop needs 4 FMAs per float it reads to keep the
// lanes busy.
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
//   K4 pass 1 (infonce_bwd_tiles): block (i, g) holds row tile i of v1 (BM
//     rows, row-major in shared memory) and walks column group g of v2 in
//     tiles of CT rows. Each (BM x CT) logits tile is computed once, in
//     register patches (RM rows x 4 columns a thread, both operands read
//     as float4 along the features), and both cotangents are fed from it:
//     p = exp(logit - lse) from K3's saved lse (the logits are within a few
//     f32 roundings of K3's, not bit for bit), dlog formed in registers and
//     staged once in shared memory (row-major, a stride that keeps both
//     reads and the writes free of bank conflicts), dv1 += dlog @ tile kept
//     in registers across the group, and dlogᵀ @ v1 tile written as row
//     tile i's dv2 partial. Three B x B x d products, as the function
//     needs. The patches give 2.7 FMAs per float read at d <= 64 (2 in the
//     dv2 product); 8 x 8 patches need more registers than two blocks an
//     SM leave, and one block an SM ran slower. Widths are templated on
//     feature groups NQ (F = 64 NQ staged features): BM = 128 / NQ keeps
//     the dv1 sums at 32 registers a thread.
//   K4 pass 2 (infonce_bwd_sum): sums dv1's partials over the groups and
//     dv2's over the row tiles, each in order, into out.

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

// K3: the strip and two tiles
size_t fwd_smem_bytes(int d) { return sizeof(float) * ((size_t)d * RS + 2 * (size_t)CT * row_stride(d)); }

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

// K4 geometry at feature groups NQ (F = 64 NQ staged features, d <= F): a
// block holds BM rows of v1 and walks tiles of CT rows of v2. A thread
// (ty, tx) of the 16 x 16 grid owns logits (rows ty + 16 i, i < RM; columns
// tx + 16 j, j < 4), dv1 rows ty + 16 i at features 4 (tx + 16 q) + e, and
// dv2 columns 4 ty + j at the same features.
template <int NQ>
struct Bwd {
    static constexpr int F = 64 * NQ;
    static constexpr int LD = F + 4;  // row stride: 16-byte rows, odd in float4s
    static constexpr int BM = 128 / NQ;
    static constexpr int RM = BM / 16;
    static constexpr int MIN_BLOCKS = NQ == 1 ? 2 : 1;  // blocks an SM holds
    static_assert(RM * 16 == BM && CT == 64, "16 x 16 threads over BM x CT logits");
};
constexpr int WLD = CT + 16;  // dlog row stride: the two rows a warp writes fall in other banks

template <int NQ>
size_t bwd_smem_bytes() {
    using G = Bwd<NQ>;
    return sizeof(float) * ((size_t)G::BM * G::LD + 2 * CT * G::LD + G::BM * WLD + 2 * G::BM);
}

// Column groups of K4's pass 1: about MIN_BLOCKS blocks on each SM, each
// group a whole number of tiles, no group empty.
template <int NQ>
int bwd_groups(int b_loc, int B, int num_sms, int* tiles_per_group) {
    const int row_tiles = (b_loc + Bwd<NQ>::BM - 1) / Bwd<NQ>::BM;
    const int tiles = (B + CT - 1) / CT;
    int want = Bwd<NQ>::MIN_BLOCKS * num_sms / row_tiles;
    want = want < 1 ? 1 : (want > tiles ? tiles : want);
    *tiles_per_group = (tiles + want - 1) / want;
    return (tiles + *tiles_per_group - 1) / *tiles_per_group;
}

// Pass 1 of K4. Block (i, g) computes each (BM x CT) logits tile of its row
// tile i and column group g once, forms dlog in registers and stages it in
// shared memory, then feeds both cotangents from it: dv1 of its rows stays
// in registers across the group (written once as group g's partial, part1
// (groups, b_loc, d)); dv2 of the tile's columns is row tile i's partial
// (part2 (row tiles, B, d)), written per tile.
template <int NQ>
__global__ void __launch_bounds__(THREADS, Bwd<NQ>::MIN_BLOCKS)
infonce_bwd_tiles(const float* __restrict__ v1, const float* __restrict__ v2,
                  const float* __restrict__ cmask, const float* __restrict__ rmask,
                  const float* __restrict__ lse, int b_loc, int B, int d, float temperature,
                  int row_offset, int tiles_per_group, float* __restrict__ part1,
                  float* __restrict__ part2) {
    using G = Bwd<NQ>;
    constexpr int BM = G::BM, RM = G::RM, LD = G::LD, F = G::F;
    extern __shared__ float4 smem_raw[];
    float* a_s = reinterpret_cast<float*>(smem_raw);  // a_s[r * LD + k] = v1[r0 + r][k]
    float* b_s = a_s + BM * LD;                        // two tiles of v2, as a_s
    float* w_s = b_s + 2 * CT * LD;                    // w_s[r * WLD + c]: dlog
    float* s_lse = w_s + BM * WLD;
    float* s_rmt = s_lse + BM;  // rmask / T
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int r0 = blockIdx.x * BM;
    const int c_begin = blockIdx.y * tiles_per_group * CT;
    const int c_end = min(B, c_begin + tiles_per_group * CT);

    // v1's rows (zero past b_loc) and the features [d, F) of every staged
    // row, which the products read as zeros; the cp.async copies of v2 only
    // write [0, d)
    for (int r = threadIdx.x / 32; r < BM; r += WARPS) {
        const bool in = r0 + r < b_loc;
        const float* src = v1 + (size_t)(r0 + r) * d;
        for (int k = threadIdx.x % 32; k < F; k += 32) a_s[r * LD + k] = in && k < d ? src[k] : 0.f;
    }
    for (int t = threadIdx.x / 32; t < 2 * CT; t += WARPS)
        for (int k = d + threadIdx.x % 32; k < F; k += 32) b_s[t * LD + k] = 0.f;
    for (int r = threadIdx.x; r < BM; r += THREADS) {
        const bool in = r0 + r < b_loc;
        s_lse[r] = in ? lse[r0 + r] : 0.f;
        s_rmt[r] = in ? rmask[r0 + r] / temperature : 0.f;
    }
    const int k4_end = (d + 3) / 4;
    const float inv_t = 1.f / temperature;

    float dv1[RM][NQ][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int q = 0; q < NQ; ++q) dv1[i][q][0] = dv1[i][q][1] = dv1[i][q][2] = dv1[i][q][3] = 0.f;

    for_each_tile(b_s, v2, c_begin, c_end, d, LD, [&](const float* tile, int t0) {
        // 1. logits: an RM x 4 register patch, both operands read as float4
        // along the features
        float acc[RM][4];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        for (int k4 = 0; k4 < k4_end; ++k4) {
            float4 b[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                b[j] = *reinterpret_cast<const float4*>(tile + (tx + 16 * j) * LD + 4 * k4);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                const float4 a = *reinterpret_cast<const float4*>(a_s + (ty + 16 * i) * LD + 4 * k4);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
                    acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
                    acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
                    acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
                }
            }
        }
        // 2. dlog = rmask (exp(logit - lse) - diag) / T, 0 outside the batch;
        // the logit as dot * (1 / T) and exp as __expf: each within a few
        // f32 roundings of K3's, about 1e-6 of p
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = t0 + tx + 16 * j;
            const bool c_in = c < c_end;
            const float cm = c_in ? cmask[c] : 0.f;
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                const int rl = ty + 16 * i, r = r0 + rl;
                float w = 0.f;
                if (c_in && r < b_loc) {
                    const float logit = cm > 0.f ? acc[i][j] * inv_t : MASKED;
                    const float p = __expf(logit - s_lse[rl]);
                    const float diag = c == r + row_offset ? 1.f : 0.f;
                    w = s_rmt[rl] * (p - diag);
                }
                w_s[rl * WLD + tx + 16 * j] = w;
            }
        }
        __syncthreads();
        // 3. dv1 += dlog @ tile, summed over the tile's columns in order
        for (int c4 = 0; c4 < CT / 4; ++c4) {
            float4 w[RM];
#pragma unroll
            for (int i = 0; i < RM; ++i)
                w[i] = *reinterpret_cast<const float4*>(w_s + (ty + 16 * i) * WLD + 4 * c4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
#pragma unroll
                for (int q = 0; q < NQ; ++q) {
                    const float4 bv =
                        *reinterpret_cast<const float4*>(tile + (4 * c4 + e) * LD + 4 * (tx + 16 * q));
#pragma unroll
                    for (int i = 0; i < RM; ++i) {
                        const float we = e == 0 ? w[i].x : e == 1 ? w[i].y : e == 2 ? w[i].z : w[i].w;
                        dv1[i][q][0] = fmaf(we, bv.x, dv1[i][q][0]);
                        dv1[i][q][1] = fmaf(we, bv.y, dv1[i][q][1]);
                        dv1[i][q][2] = fmaf(we, bv.z, dv1[i][q][2]);
                        dv1[i][q][3] = fmaf(we, bv.w, dv1[i][q][3]);
                    }
                }
            }
        }
        // 4. the tile's dv2 partial = dlogᵀ @ v1 rows, summed over the rows in order
        float dv2[4][NQ][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < NQ; ++q) dv2[j][q][0] = dv2[j][q][1] = dv2[j][q][2] = dv2[j][q][3] = 0.f;
#pragma unroll 4
        for (int r = 0; r < BM; ++r) {
            const float4 w = *reinterpret_cast<const float4*>(w_s + r * WLD + 4 * ty);
            const float wj[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const float4 av = *reinterpret_cast<const float4*>(a_s + r * LD + 4 * (tx + 16 * q));
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    dv2[j][q][0] = fmaf(wj[j], av.x, dv2[j][q][0]);
                    dv2[j][q][1] = fmaf(wj[j], av.y, dv2[j][q][1]);
                    dv2[j][q][2] = fmaf(wj[j], av.z, dv2[j][q][2]);
                    dv2[j][q][3] = fmaf(wj[j], av.w, dv2[j][q][3]);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = t0 + 4 * ty + j;
            if (c >= c_end) continue;
            float* o = part2 + ((size_t)blockIdx.x * B + c) * d;
#pragma unroll
            for (int q = 0; q < NQ; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int f = 4 * (tx + 16 * q) + e;
                    if (f < d) o[f] = dv2[j][q][e];
                }
        }
    });
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int r = r0 + ty + 16 * i;
        if (r >= b_loc) continue;
        float* o = part1 + ((size_t)blockIdx.y * b_loc + r) * d;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int f = 4 * (tx + 16 * q) + e;
                if (f < d) o[f] = dv1[i][q][e];
            }
    }
}

// Pass 2 of K4: out[e] = sum over p in order of part1[p][e] (groups1 parts
// of n1 elements: dv1), then of part2 (groups2 parts of n2 elements: dv2)
__global__ void infonce_bwd_sum(const float* __restrict__ part1, long long n1, int groups1,
                                const float* __restrict__ part2, long long n2, int groups2,
                                float* __restrict__ out) {
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n1 + n2;
         e += (long long)gridDim.x * blockDim.x) {
        const bool first = e < n1;
        const float* p = first ? part1 + e : part2 + (e - n1);
        const long long n = first ? n1 : n2;
        const int parts = first ? groups1 : groups2;
        float acc = p[0];
        for (int k = 1; k < parts; ++k) acc += p[k * n];
        out[e] = acc;
    }
}

// Floats of K4's partials: groups x b_loc rows of dv1, row tiles x B of dv2
template <int NQ>
size_t bwd_scratch(int b_loc, int B, int d, int num_sms) {
    int tpg = 0;
    const size_t groups = bwd_groups<NQ>(b_loc, B, num_sms, &tpg);
    const size_t row_tiles = (b_loc + Bwd<NQ>::BM - 1) / Bwd<NQ>::BM;
    return (groups * b_loc + row_tiles * B) * d;
}

template <int NQ>
int launch_bwd(const float* v1, const float* v2, const float* cmask, const float* rmask,
               const float* lse, float* part, float* out, int b_loc, int B, int d,
               float temperature, int row_offset, int num_sms, cudaStream_t st) {
    const size_t smem = bwd_smem_bytes<NQ>();
    cudaError_t err = cudaFuncSetAttribute(infonce_bwd_tiles<NQ>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int tpg = 0;
    const int groups = bwd_groups<NQ>(b_loc, B, num_sms, &tpg);
    const int row_tiles = (b_loc + Bwd<NQ>::BM - 1) / Bwd<NQ>::BM;
    float* part2 = part + (size_t)groups * b_loc * d;
    infonce_bwd_tiles<NQ><<<dim3(row_tiles, groups), THREADS, smem, st>>>(
        v1, v2, cmask, rmask, lse, b_loc, B, d, temperature, row_offset, tpg, part, part2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    infonce_bwd_sum<<<BLOCKS_PER_SM * num_sms, 256, 0, st>>>(
        part, (long long)b_loc * d, groups, part2, (long long)B * d, row_tiles, out);
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

// Floats of scratch that qrec_infonce_bwd needs for these sizes: the
// partials of its first launch.
int qrec_infonce_bwd_scratch(int b_loc, int B, int d, int num_sms) {
    if (d <= 64) return (int)bwd_scratch<1>(b_loc, B, d, num_sms);
    if (d <= 128) return (int)bwd_scratch<2>(b_loc, B, d, num_sms);
    return (int)bwd_scratch<4>(b_loc, B, d, num_sms);
}

// As qrec_infonce_fwd, with lse (b_loc) from it; part: the scratch above;
// out (b_loc + B, d) f32 is written, dv1 in its first b_loc rows and dv2 in
// the rest. Returns cudaGetLastError() after the launches.
int qrec_infonce_bwd(const void* v1, const void* v2, const void* cmask, const void* rmask,
                     const void* lse, void* part, void* out, int b_loc, int B, int d,
                     float temperature, int row_offset, int num_sms, void* stream) {
    if (bad_shape(b_loc, B, d, temperature) || num_sms <= 0) return (int)cudaErrorInvalidValue;
    const float* a = static_cast<const float*>(v1);
    const float* b = static_cast<const float*>(v2);
    const float* cm = static_cast<const float*>(cmask);
    const float* rm = static_cast<const float*>(rmask);
    const float* l = static_cast<const float*>(lse);
    float* pt = static_cast<float*>(part);
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d <= 64) return launch_bwd<1>(a, b, cm, rm, l, pt, o, b_loc, B, d, temperature, row_offset,
                                      num_sms, st);
    if (d <= 128) return launch_bwd<2>(a, b, cm, rm, l, pt, o, b_loc, B, d, temperature, row_offset,
                                       num_sms, st);
    return launch_bwd<4>(a, b, cm, rm, l, pt, o, b_loc, B, d, temperature, row_offset, num_sms, st);
}

}  // extern "C"
