// The tile walk and the register-patch product shared by the masked catalog
// scorer (K2, masked_scores.cu) and the InfoNCE kernels (K3, K4,
// infonce.cu).
//
// A block of THREADS = 16 x 16 threads holds a tile of rows of one operand
// (a_s, row-major in shared memory, row stride ld) and walks tiles of CT
// rows of the other (b_s), double-buffered: the next tile's copy (cp.async,
// 16 bytes where the rows allow) is in flight while the current one is
// used. Thread (ty, tx) owns the products of rows ty + 16 i (i < RM) and
// tile rows tx + 16 j (j < 4), both operands read as float4 along the
// features: 2.7 FMAs per float read from shared memory at RM = 8.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 64;        // rows of the other operand per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;    // features a row of shared memory holds

// Staging: warp w copies rows w, w + WARPS, ...; its lanes stride one row's
// features, V floats a copy, so global reads coalesce and no index is
// divided by d.

// s[r * ld + k] = x[r0 + r][k] for r < rows, k < width: rows below n are
// copied asynchronously (no commit), the features [d, width) and the rows
// from n on are zeroed
template <int V>
__device__ __forceinline__ void stage_rows_v(float* s, const float* __restrict__ x, int r0,
                                             int rows, int n, int d, int ld, int width) {
    const int lane = threadIdx.x % 32;
    for (int r = threadIdx.x / 32; r < rows; r += WARPS) {
        float* dst = s + r * ld;
        const bool in = r0 + r < n;
        if (in) {
            const float* src = x + (size_t)(r0 + r) * d;
            for (int k = lane * V; k < d; k += 32 * V)
                __pipeline_memcpy_async(dst + k, src + k, V * sizeof(float));
        }
        for (int k = (in ? d : 0) + lane; k < width; k += 32) dst[k] = 0.f;
    }
}

// vec: the floats a copy moves (4, 2 or 1), which d and the operands'
// alignment allow; one branch a call, the same in every thread
__device__ __forceinline__ void stage_rows(int vec, float* s, const float* __restrict__ x, int r0,
                                           int rows, int n, int d, int ld, int width) {
    if (vec == 4) {
        stage_rows_v<4>(s, x, r0, rows, n, d, ld, width);
    } else if (vec == 2) {
        stage_rows_v<2>(s, x, r0, rows, n, d, ld, width);
    } else {
        stage_rows_v<1>(s, x, r0, rows, n, d, ld, width);
    }
}

// Walks the tiles of rows [begin, end) of y, double-buffered in b_s (two
// tiles of CT * ld floats, zero past end and in the features [d, width),
// which are zeroed once): use(tile, t0) sees every row of the tile at t0 in
// place, for every thread of the block (no barrier follows the last use).
// Copies staged by the caller before the call land with the first tile.
// The next tile's copies are issued once the current one has landed and
// land while it is used: one barrier a tile.
template <typename Use>
__device__ __forceinline__ void for_each_tile(float* b_s, const float* __restrict__ y, int begin,
                                              int end, int d, int ld, int width, int vec, Use use) {
    const int tile_floats = CT * ld;
    int cur = 0;
    for (int t = threadIdx.x / 32; t < 2 * CT; t += WARPS)
        for (int k = d + threadIdx.x % 32; k < width; k += 32) b_s[t * ld + k] = 0.f;
    if (begin < end) stage_rows(vec, b_s, y, begin, CT, end, d, ld, d);
    __pipeline_commit();
    for (int t0 = begin; t0 < end; t0 += CT, cur ^= 1) {
        __pipeline_wait_prior(0);  // this thread's copies of the current tile landed
        __syncthreads();           // ... and every thread's; the other buffer is consumed
        if (t0 + CT < end) {
            stage_rows(vec, b_s + (cur ^ 1) * tile_floats, y, t0 + CT, CT, end, d, ld, d);
            __pipeline_commit();
        }
        use(b_s + cur * tile_floats, t0);
    }
}

// acc[i][j] += sum over the features 4 k4_begin .. 4 k4_end - 1, in float4
// steps in order, of a_s row ty + 16 i times tile row tx + 16 j (both
// row-major, stride ld, zero from d to the next multiple of 4)
template <int RM>
__device__ __forceinline__ void patch_dots_acc(const float* a_s, const float* tile, int ld,
                                               int k4_begin, int k4_end, int tx, int ty,
                                               float (&acc)[RM][4]) {
    for (int k4 = k4_begin; k4 < k4_end; ++k4) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            b[j] = *reinterpret_cast<const float4*>(tile + (tx + 16 * j) * ld + 4 * k4);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(a_s + (ty + 16 * i) * ld + 4 * k4);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
                acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
                acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
                acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
            }
        }
    }
}

// acc[i][j] = the same sum over the features 0 .. 4 k4_end - 1, from 0
template <int RM>
__device__ __forceinline__ void patch_dots(const float* a_s, const float* tile, int ld, int k4_end,
                                           int tx, int ty, float (&acc)[RM][4]) {
#pragma unroll
    for (int i = 0; i < RM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    patch_dots_acc<RM>(a_s, tile, ld, 0, k4_end, tx, ty, acc);
}

// The row stride of a_s and the tiles: d rounded up to float4s, an odd
// number of them, so the 8 lanes of a quarter warp reading one float4 of 8
// rows hit 32 banks
__host__ __device__ inline int fwd_ld(int d) { return 4 * (((d + 3) / 4) | 1); }

// The floats a copy of x's and y's rows moves: 4 (16 bytes) where d and
// both operands' alignment allow, else 2, else 1
inline int copy_width(const void* x, const void* y, int d) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
    if (d % 4 == 0 && a % 16 == 0) return 4;
    if (d % 2 == 0 && a % 8 == 0) return 2;
    return 1;
}

}  // namespace
