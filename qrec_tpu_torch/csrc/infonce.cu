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
// cross-block sum is taken in a fixed order. No float atomics: a call
// repeats bit for bit. Both kernels hold a tile of BM rows of v1 (row-major
// in shared memory) and walk tiles of CT rows of v2, double-buffered: the
// next tile's copy (cp.async, 16 bytes where the rows allow) is in flight
// while the current one is used. Each (BM x CT) logits tile is computed in
// register patches: thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i
// (i < RM) and columns tx + 16 j (j < 4), both operands read as float4
// along the features, 2.7 FMAs per float read at RM = 8 (`for_each_tile`
// and `patch_dots` of tiles.cuh, shared by both kernels and by K2).
//   K3 (infonce_fwd_tiles, one launch): block (i, g) takes row tile i and
//     column split g. A patch row's 4 logits update the thread's online
//     logsumexp once per tile, flash style: one max, one rescale of the
//     running sum, exponentials on the SFU (ex2.approx) with no branch per
//     logit; the thread that meets the diagonal keeps pos. The 16 threads
//     of a row (one half-warp) merge by xor shuffles at the end, and the
//     block writes its rows' (max, sum, pos) for split g. The last split
//     of a row tile to count in (an acquire-release add on the tile's
//     counter) merges the splits in split order, writes lse (kept for K4)
//     and the tile's loss partial; the last row tile to count in sums the
//     partials in row-tile order into out. Both counters are back at 0
//     when the call ends. The host picks the row tile (64 or 128 rows)
//     and the column split (ops/kernels.py `infonce_fwd_plan`) so that row
//     tiles x splits fills the SMs once (B = 2000 has 16 row tiles of 128
//     for 132 SMs, so 16 splits of 2 tiles). Each block stages its own v1
//     rows and v2 tiles, so the tiles cross from L2 once per row tile: at
//     B = 2000 that staging takes a third of the kernel.
//   K4 pass 1 (infonce_bwd_tiles): block (i, g) holds row tile i and walks
//     column group g. Both cotangents are fed from one logits tile:
//     p = exp(logit - lse) from K3's saved lse (the logits are within a few
//     f32 roundings of K3's, not bit for bit), dlog formed in registers and
//     staged once in shared memory (row-major, a stride that keeps both
//     reads and the writes free of bank conflicts), dv1 += dlog @ tile kept
//     in registers across the group, and dlogᵀ @ v1 tile written as row
//     tile i's dv2 partial. Three B x B x d products, as the function
//     needs. 8 x 8 patches need more registers than two blocks an SM
//     leave, and one block an SM ran slower. Widths are templated on
//     feature groups NQ (F = 64 NQ staged features): BM = 128 / NQ keeps
//     the dv1 sums at 32 registers a thread.
//   K4 pass 2 (infonce_bwd_sum): sums dv1's partials over the groups and
//     dv2's over the row tiles, each in order, into out.

#include <cuda/atomic>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

constexpr int SUM_BLOCKS_PER_SM = 4; // K4 pass-2 blocks on each SM
constexpr float MASKED = -1e30f;     // finite, as the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// 2^x on the SFU: relative error about 2^-22, 0 for x below -126
__device__ __forceinline__ float exp2_fast(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// (m, s) <- the merge of two online logsumexp states (max, sum of exp(x -
// max)), both of at least one value. Symmetric in its two arguments (two
// rounded products, never contracted into an FMA), so both lanes of a
// shuffle pair agree bit for bit.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
    const float mm = fmaxf(m, m2);
    s = __fmul_rn(s, exp2_fast((m - mm) * LOG2E)) + __fmul_rn(s2, exp2_fast((m2 - mm) * LOG2E));
    m = mm;
}

// a sum over the 32 lanes, the same on every lane and in every call
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    return v;
}


size_t fwd_smem_bytes(int bm, int d) { return sizeof(float) * (size_t)(bm + 2 * CT) * fwd_ld(d); }

// K3. Block (tile, split) computes the logits of row tile `tile` (BM rows)
// against the columns [split tps CT, (split + 1) tps CT) of v2 and leaves
// each row's (max, sum, pos) of that split in part; the last split of the
// tile to arrive finishes its rows (lse, the tile's loss) and the last tile
// to arrive sums the loss. part: (3, splits, b_loc) then (row tiles) f32;
// counters: (row tiles + 1) int32, 0 on entry and on exit.
template <int RM>
__global__ void __launch_bounds__(THREADS, 2)
infonce_fwd_tiles(const float* __restrict__ v1, const float* __restrict__ v2,
                  const float* __restrict__ cmask, const float* __restrict__ rmask, int b_loc,
                  int B, int d, int vec, float temperature, int row_offset, int tiles_per_split,
                  float* __restrict__ part, int* __restrict__ counters, float* __restrict__ lse,
                  float* __restrict__ out) {
    constexpr int BM = 16 * RM;
    extern __shared__ float4 smem_raw[];
    __shared__ float red[WARPS];
    __shared__ int last;
    const int ld = fwd_ld(d), k4_end = (d + 3) / 4;
    float* a_s = reinterpret_cast<float*>(smem_raw);  // a_s[r * ld + k] = v1[r0 + r][k]
    float* b_s = a_s + BM * ld;                        // two tiles of v2, as a_s
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int tile = blockIdx.x, r0 = tile * BM;
    const int split = blockIdx.y, splits = gridDim.y;
    const int c_begin = split * tiles_per_split * CT;
    const int c_end = min(B, c_begin + tiles_per_split * CT);
    const int diag0 = r0 + row_offset;  // row r0 + r meets its positive in column diag0 + r
    const float inv_t = 1.f / temperature;

    stage_rows(vec, a_s, v1, r0, BM, b_loc, d, ld, 4 * k4_end);
    float m[RM], s[RM], pos[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        m[i] = -INFINITY;
        s[i] = 0.f;
        pos[i] = 0.f;
    }
    for_each_tile(b_s, v2, c_begin, c_end, d, ld, 4 * k4_end, vec, [&](const float* t, int t0) {
        // a masked column, or one past the batch, enters as -1e30: dot / T
        // is within 5 of 0, so fma(dot, 1 / T, -1e30) is -1e30 exactly
        float bias[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = t0 + tx + 16 * j;
            bias[j] = c < c_end && cmask[c] > 0.f ? 0.f : MASKED;
        }
        float acc[RM][4];
        patch_dots<RM>(a_s, t, ld, k4_end, tx, ty, acc);
        const bool diag = t0 < diag0 + BM && diag0 < t0 + CT;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            float x[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) x[j] = fmaf(acc[i][j], inv_t, bias[j]);
            if (diag) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = t0 + tx + 16 * j;
                    if (c == diag0 + ty + 16 * i && c < c_end) pos[i] = x[j];
                }
            }
            // one rescale of the running sum a tile; every term's exponent
            // is (x - max) log2(e) <= 0, exactly 0 at the max
            const float mn = fmaxf(m[i], fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
            const float e = (exp2_fast((x[0] - mn) * LOG2E) + exp2_fast((x[1] - mn) * LOG2E)) +
                            (exp2_fast((x[2] - mn) * LOG2E) + exp2_fast((x[3] - mn) * LOG2E));
            s[i] = fmaf(s[i], exp2_fast((m[i] - mn) * LOG2E), e);
            m[i] = mn;
        }
    });
    // the 16 threads of a row (one half-warp) merge; at most one thread of
    // the grid holds a row's pos, the others add 0
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const float m2 = __shfl_xor_sync(FULL, m[i], off);
            const float s2 = __shfl_xor_sync(FULL, s[i], off);
            pos[i] += __shfl_xor_sync(FULL, pos[i], off);
            lse_merge(m[i], s[i], m2, s2);
        }
    }
    const size_t n = b_loc;
    float* part_m = part;
    float* part_s = part + splits * n;
    float* part_p = part + 2 * splits * n;
    float* tile_loss = part + 3 * splits * n;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int r = r0 + ty + 16 * i;
        if (tx == i && r < b_loc) {
            __stcg(part_m + split * n + r, m[i]);
            __stcg(part_s + split * n + r, s[i]);
            __stcg(part_p + split * n + r, pos[i]);
        }
    }
    // count in on the tile; the release publishes the block's partials (the
    // barrier orders every thread's stores before it), the acquire of the
    // last count sees every split's
    __syncthreads();
    if (threadIdx.x == 0) {
        cuda::atomic_ref<int, cuda::thread_scope_device> count(counters[tile]);
        last = count.fetch_add(1, cuda::memory_order_acq_rel) == splits - 1;
    }
    __syncthreads();
    if (!last) return;

    // the last split of the tile: each row's splits merged in split order
    float term = 0.f;
    const int r = r0 + threadIdx.x;
    if (threadIdx.x < BM && r < b_loc) {
        float mm = __ldcg(part_m + r), ss = __ldcg(part_s + r), pp = __ldcg(part_p + r);
        // eight splits' loads in flight at a time, merged in order
        for (int g0 = 1; g0 < splits; g0 += 8) {
            float mg[8], sg[8], pg[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const size_t o = (size_t)min(g0 + u, splits - 1) * n + r;
                mg[u] = __ldcg(part_m + o);
                sg[u] = __ldcg(part_s + o);
                pg[u] = __ldcg(part_p + o);
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                if (g0 + u < splits) {
                    lse_merge(mm, ss, mg[u], sg[u]);
                    pp += pg[u];
                }
            }
        }
        const float l = mm + logf(ss);
        lse[r] = l;
        term = rmask[r] * (l - pp);
    }
    // the tile's loss by a fixed tree, then count in on the grid
    term = warp_sum(term);
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = term;
    __syncthreads();
    if (threadIdx.x == 0) {
        float t = red[0];
        for (int w = 1; w < WARPS; ++w) t += red[w];
        __stcg(tile_loss + tile, t);
        counters[tile] = 0;
        cuda::atomic_ref<int, cuda::thread_scope_device> count(counters[gridDim.x]);
        last = count.fetch_add(1, cuda::memory_order_acq_rel) == (int)gridDim.x - 1;
    }
    __syncthreads();
    if (!last || threadIdx.x >= 32) return;
    // the last tile: the tiles' losses in order, lane k taking k, k + 32, ...
    float t = 0.f;
    for (int k = threadIdx.x; k < (int)gridDim.x; k += 32) t += __ldcg(tile_loss + k);
    t = warp_sum(t);
    if (threadIdx.x == 0) {
        out[0] = t;
        counters[gridDim.x] = 0;
    }
}

template <int RM>
int launch_fwd(const float* v1, const float* v2, const float* cmask, const float* rmask,
               float* part, int* counters, float* lse, float* out, int b_loc, int B, int d, int vec,
               float temperature, int row_offset, int tiles_per_split, cudaStream_t st) {
    const size_t smem = fwd_smem_bytes(16 * RM, d);
    cudaError_t err = cudaFuncSetAttribute(infonce_fwd_tiles<RM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int row_tiles = (b_loc + 16 * RM - 1) / (16 * RM);
    const int tiles = (B + CT - 1) / CT;
    const int splits = (tiles + tiles_per_split - 1) / tiles_per_split;
    infonce_fwd_tiles<RM><<<dim3(row_tiles, splits), THREADS, smem, st>>>(
        v1, v2, cmask, rmask, b_loc, B, d, vec, temperature, row_offset, tiles_per_split, part,
        counters, lse, out);
    return (int)cudaGetLastError();
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
                  const float* __restrict__ lse, int b_loc, int B, int d, int vec,
                  float temperature, int row_offset, int tiles_per_group,
                  float* __restrict__ part1, float* __restrict__ part2) {
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

    // v1's rows (zero past b_loc and in the features [d, F), which the
    // products read as zeros) by plain loads: timed against cp.async
    // staging, these were 1.5-3% faster here (not in K3)
    for (int r = threadIdx.x / 32; r < BM; r += WARPS) {
        const bool in = r0 + r < b_loc;
        const float* src = v1 + (size_t)(r0 + r) * d;
        for (int k = threadIdx.x % 32; k < F; k += 32) a_s[r * LD + k] = in && k < d ? src[k] : 0.f;
    }
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

    for_each_tile(b_s, v2, c_begin, c_end, d, LD, F, vec, [&](const float* tile, int t0) {
        // 1. logits: an RM x 4 register patch
        float acc[RM][4];
        patch_dots<RM>(a_s, tile, LD, k4_end, tx, ty, acc);
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
               const float* lse, float* part, float* out, int b_loc, int B, int d, int vec,
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
        v1, v2, cmask, rmask, lse, b_loc, B, d, vec, temperature, row_offset, tpg, part, part2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    infonce_bwd_sum<<<SUM_BLOCKS_PER_SM * num_sms, 256, 0, st>>>(
        part, (long long)b_loc * d, groups, part2, (long long)B * d, row_tiles, out);
    return (int)cudaGetLastError();
}

bool bad_shape(int b_loc, int B, int d, float temperature) {
    return b_loc <= 0 || B <= 0 || d <= 0 || d > MAX_D || !(temperature > 0.f);
}

}  // namespace

extern "C" {

// Blocks of K3 at `bm` rows (64 or 128) and width d that one SM holds
// at once (0 if the block does not fit), for the host's column split.
int qrec_infonce_fwd_blocks_per_sm(int bm, int d) {
    if (d <= 0 || d > MAX_D) return 0;
    const size_t smem = fwd_smem_bytes(bm, d);
    int blocks = 0;
    cudaError_t err = cudaSuccess;
#define QREC_FWD_OCC(RM)                                                                        \
    err = cudaFuncSetAttribute(infonce_fwd_tiles<RM>,                                           \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);         \
    if (err == cudaSuccess)                                                                     \
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, infonce_fwd_tiles<RM>,     \
                                                            THREADS, smem);
    switch (bm) {
        case 64: QREC_FWD_OCC(4) break;
        case 128: QREC_FWD_OCC(8) break;
        default: return 0;
    }
#undef QREC_FWD_OCC
    cudaGetLastError();  // a block too large for the SM is an answer here, not an error
    return err == cudaSuccess ? blocks : 0;
}

// v1 (b_loc, d), v2 (B, d), cmask (B), rmask (b_loc) f32; bm rows a block
// (64 or 128) and tiles_per_split column tiles of 64 a split; part
// (3 splits b_loc + ceil(b_loc / bm)) f32 and counters (ceil(b_loc / bm) +
// 1) int32, zero on entry and left zero, the scratch; lse (b_loc) and out
// (1) f32 are written. d <= 256. One launch; returns cudaGetLastError()
// after it.
int qrec_infonce_fwd(const void* v1, const void* v2, const void* cmask, const void* rmask,
                     void* part, void* counters, void* lse, void* out, int b_loc, int B, int d,
                     float temperature, int row_offset, int bm, int tiles_per_split,
                     void* stream) {
    if (bad_shape(b_loc, B, d, temperature) || tiles_per_split <= 0)
        return (int)cudaErrorInvalidValue;
    const int vec = copy_width(v1, v2, d);
#define QREC_FWD(RM)                                                                             \
    launch_fwd<RM>(static_cast<const float*>(v1), static_cast<const float*>(v2),                 \
                   static_cast<const float*>(cmask), static_cast<const float*>(rmask),           \
                   static_cast<float*>(part), static_cast<int*>(counters),                       \
                   static_cast<float*>(lse), static_cast<float*>(out), b_loc, B, d, vec,         \
                   temperature, row_offset, tiles_per_split, static_cast<cudaStream_t>(stream))
    switch (bm) {
        case 64: return QREC_FWD(4);
        case 128: return QREC_FWD(8);
        default: return (int)cudaErrorInvalidValue;
    }
#undef QREC_FWD
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
    const int vec = copy_width(v1, v2, d);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d <= 64) return launch_bwd<1>(a, b, cm, rm, l, pt, o, b_loc, B, d, vec, temperature,
                                      row_offset, num_sms, st);
    if (d <= 128) return launch_bwd<2>(a, b, cm, rm, l, pt, o, b_loc, B, d, vec, temperature,
                                       row_offset, num_sms, st);
    return launch_bwd<4>(a, b, cm, rm, l, pt, o, b_loc, B, d, vec, temperature, row_offset,
                         num_sms, st);
}

}  // extern "C"
