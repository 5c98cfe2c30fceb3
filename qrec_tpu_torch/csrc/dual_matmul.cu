// Bipartite dual product: (ou, oi) = (A @ xi, Aᵀ @ xu) in one pass over A,
// and its factored form, one application of the joint LightGCN adjacency
// [[0, Ŝ], [Ŝᵀ, 0]] with Ŝ = diag(su) · R · diag(si).
//
// Replaces the Pallas TPU kernel `bipartite_dual_matmul` / `_dual_kernel`
// (qrec_tpu/ops/pallas_kernels.py:563-656). On the main path A is the binary
// interaction matrix R in int8; the factored entry forms bf16(x · s) as it
// loads x and multiplies the f32 sums by the scales as it writes the joint
// (U+I, d) output, the arithmetic of the JAX package's `_int8_call` step for
// step (qrec_tpu/ops/spmm.py:267-288).
//
// What bounds it on an H100: counted as the function, the bytes of A (31.4
// MB int8 at the lastfm shape, 415.5 MB at yelp2018) over 3.35 TB/s; the
// dense work (2 products x 2·U·I·d FLOP, 0.27% of it on nonzeros) on the
// bf16 tensor cores comes close to that at d = 50 and 64 and passes it at
// d = 150. The design keeps what it moves besides R below R's bytes:
//   * R streams once per call for every d <= 256: a block computes all
//     features of both products from each tile, the tensor-core N being d
//     rounded up to 8 (56 for d = 50, 152 for d = 150).
//   * R's rows have a stride that is a multiple of 16 bytes (DenseJoint
//     pads I to ld with zero columns), so every tile (TM = 128 rows of int8
//     R at N <= 128 where shared memory allows, else 64, by 64 columns)
//     arrives by 16-byte cp.async copies through a ring of 3-6 shared-memory
//     stages; the next tiles are in flight while the tensor cores work, and
//     so are the next row tile's rows of x.
//   * mma.sync m16n8k16 (bf16 in, f32 sums) with fragments read by
//     ldmatrix; the Aᵀ product reads the same converted tile through
//     ldmatrix.trans, so A is never transposed in memory.
//   * A block owns a region of BM rows x BN columns and writes one ou
//     partial per region row and one oi partial per region column:
//     Σ (rows + cols) · N · 4 bytes, below R's own bytes at the lastfm and
//     yelp2018 shapes (the host picks the regions, ops/kernels.py
//     `_dual_plan`). A second launch sums the partials in a fixed order (no
//     atomics: a call repeats bit for bit) and, for the factored entry,
//     applies the scales.
// What still holds it above the bound: one 227 KB block per SM with two
// barriers per tile, the fragment reads and oi's f32 adds in shared memory,
// and the partials' round trip through device memory.
//
// Walk of a region: row tiles outer, column tiles inner, so the tiles in
// flight lie side by side along R's rows. The region's xi rows stay in
// shared memory as bf16 (loaded once), the row tile's xu rows too; ou of
// the row tile accumulates in registers over the region's columns and is
// written when its columns are done; oi of every region column accumulates
// in shared memory in f32.
// Tensor cores may round their f32 sums toward zero, so no tensor-core sum
// spans an unbounded number of terms: oi's chain is one tile's rows (at
// most 128), added to the f32 running sum with rounded f32 adds; ou's chain
// is the region's columns, at most MAX_BN = 512. Ragged U, I and d are
// masked with zeros.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;           // columns of A per tile
constexpr int THREADS = 512;     // 16 warps
constexpr int MAX_BN = 512;      // columns of a region: bounds ou's tensor-core chain
constexpr int LDA_S = TK + 8;    // bf16 row of a converted tile (144 B: ldmatrix without conflicts)
constexpr int SMEM_LIMIT = 232448;

struct Args {
    const void* a;               // (U, lda) int8 or bf16, lda a multiple of 16
    long long lda;
    const __nv_bfloat16* xu;     // unscaled entry: (U, d) and (I, d) bf16
    const __nv_bfloat16* xi;
    const float* x;              // factored entry: (U+I, d) f32 and the scales
    const float* su;
    const float* si;
    float* ou_part;              // (n_cs, U, N)
    float* oi_part;              // (n_rs, I, N)
    float* out;                  // (U+I, d)
    int U, I, d, N, bm, bn, n_rs, n_cs;
};

// bf16 row of x in shared memory: an odd number of 16-byte words, so that
// ldmatrix's 8 rows fall in distinct banks
__host__ __device__ inline int x_stride(int N) { return (N / 8) % 2 ? N : N + 8; }
// f32 row of the oi accumulator: ≡ 8 or 24 mod 32 words, so that the float2
// adds of a fragment's rows g = 0..3 (a half warp) hit distinct banks
__host__ __device__ inline int o_stride(int N) { return N % 16 == 8 ? N : N + 8; }
// ring depth: tiles of TM rows x 64 columns, int8 or bf16 (2.25x larger)
__host__ __device__ constexpr int stages(bool a_int8, int N, int tm) {
    return tm == 128 ? 4 : N > 128 ? (a_int8 ? 4 : 3) : (a_int8 ? 6 : 4);
}
__host__ __device__ constexpr int stage_bytes(bool a_int8, int tm) {
    return a_int8 ? tm * TK : tm * LDA_S * 2;
}

// ring, converted tile, xu_s [tm] and xi_s [bn] rows, oi_s [bn], and the
// staging of the next row tile's raw xu rows (f32 and their scales for the
// factored entry, bf16 for the unscaled one, sized for the former in both:
// the two entries then take the same regions and sum in the same order)
__host__ __device__ inline size_t smem_bytes(int N, int bn, bool a_int8, int tm) {
    size_t ring = size_t(stages(a_int8, N, tm)) * stage_bytes(a_int8, tm);
    size_t conv = a_int8 ? size_t(tm) * LDA_S * 2 : 0;
    size_t xs = size_t(bn + tm) * x_stride(N) * 2;
    size_t os = size_t(bn) * o_stride(N) * 4;
    return ring + conv + xs + os + size_t(tm) * N * 4 + tm * 4;
}

inline int max_cols(int N, bool a_int8, int tm) {
    int bn = 0;
    for (int c = TK; c <= MAX_BN; c += TK)
        if (smem_bytes(N, c, a_int8, tm) <= size_t(SMEM_LIMIT)) bn = c;
    return bn;
}

// rows of a tile: 128 for int8 R at N <= 128 when a region still holds 384
// columns (half the partial adds and barriers per byte of R), else 64
inline int tile_rows(int N, bool a_int8) {
    return a_int8 && N <= 128 && max_cols(N, a_int8, 128) >= 384 ? 128 : 64;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int S>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The x rows of one side of the product: the factored entry's f32 rows
// with their scales, or the unscaled entry's bf16 rows; n rows exist.
struct Side {
    const unsigned char* raw;
    const float* scale;
    int es;  // bytes per element
    int n;
};

__device__ __forceinline__ Side user_side(const Args& p) {
    return p.x ? Side{reinterpret_cast<const unsigned char*>(p.x), p.su, 4, p.U}
               : Side{reinterpret_cast<const unsigned char*>(p.xu), nullptr, 2, p.U};
}
__device__ __forceinline__ Side item_side(const Args& p) {
    return p.x ? Side{reinterpret_cast<const unsigned char*>(p.x + size_t(p.U) * p.d), p.si, 4, p.I}
               : Side{reinterpret_cast<const unsigned char*>(p.xi), nullptr, 2, p.I};
}

// cp.async copies of rows [r0, r0 + rows) of a side (those that exist) as
// they lie in memory, one contiguous range: 16-byte pieces where the range
// starts 16-byte aligned, 4-byte ones for the rest (the last cut short);
// their scales to dst_scale
__device__ void stage_rows(void* dst, void* dst_scale, const Side& sd, int d, int r0, int rows) {
    const int nrows = max(0, min(rows, sd.n - r0));
    const int bytes = nrows * d * sd.es;
    const unsigned char* src = sd.raw + size_t(r0) * d * sd.es;
    const uint32_t to = smem_addr(dst);
    const int wide = reinterpret_cast<uintptr_t>(src) % 16 ? 0 : bytes / 16 * 16;
    for (int i = 16 * threadIdx.x; i < wide; i += 16 * THREADS) cp_async16(to + i, src + i, true);
    for (int i = wide + 4 * threadIdx.x; i < bytes; i += 4 * THREADS)
        cp_async4(to + i, src + i, min(4, bytes - i));
    if (sd.scale) {
        const uint32_t ts = smem_addr(dst_scale);
        for (int r = threadIdx.x; r < nrows; r += THREADS) cp_async4(ts + 4 * r, sd.scale + r0 + r, 4);
    }
}

// dst[r][f] (row stride x_stride(N)) from staged rows, a warp per row:
// bf16(x · s) for the factored entry (the product rounded once, as
// `(x * s).to(bfloat16)`), the bf16 value for the unscaled one; 0 past the
// rows that exist and past d
__device__ void convert_rows(__nv_bfloat16* dst, const void* raw, const float* scale,
                             const Side& sd, int d, int N, int r0, int rows) {
    const int nrows = max(0, min(rows, sd.n - r0));
    const int sx = x_stride(N), lane = threadIdx.x & 31;
    const float* rf = static_cast<const float*>(raw);
    const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(raw);
    for (int r = threadIdx.x >> 5; r < rows; r += THREADS / 32) {
        const bool ok = r < nrows;
        const float sc = ok && sd.scale ? scale[r] : 0.f;
        for (int f = lane; f < sx; f += 32) {
            __nv_bfloat16 v = __float2bfloat16(0.f);
            if (ok && f < d) v = sd.scale ? __float2bfloat16_rn(rf[r * d + f] * sc) : rb[r * d + f];
            dst[r * sx + f] = v;
        }
    }
}

// One block per region of R: rows [row0, row0 + bm), columns [col0, col0 +
// bn), in tiles of TM rows x 64 columns. Row tiles outer, column tiles
// inner, so the tiles in flight lie side by side along R's rows. In a
// tile, warp w takes the ou rows [16 · (w % RU), +16) and a part w / RU of
// the features (RU = TM / 16 row groups, 16 / RU parts), and the oi columns
// [16 · (w % 4), +16) and a part w / 4 of the features (4 parts). NFW: n8
// fragments a warp owns in ou (NFWI in oi). KEEP_XU: the row tile's xu
// fragments stay in registers over its columns.
template <bool A_INT8, int TM, int NFW>
__global__ void __launch_bounds__(THREADS, 1) dual_regions(Args p) {
    constexpr int STAGES = stages(A_INT8, NFW * 8 * (16 / (TM / 16)), TM);
    constexpr int RU = TM / 16;             // ou row groups
    constexpr int KS = TM / 16;             // k16 steps of oi's chain
    constexpr int NFWI = TM == 128 ? (NFW + 1) / 2 : NFW;
    constexpr bool KEEP_XU = TM == 128 && NFW <= 4;
    extern __shared__ __align__(128) unsigned char smem[];
    const int N = p.N, sx = x_stride(N), so = o_stride(N);
    unsigned char* ring = smem;
    __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(ring + STAGES * stage_bytes(A_INT8, TM));
    __nv_bfloat16* xu_s = A_INT8 ? conv + TM * LDA_S : conv;                       // [TM][sx]
    __nv_bfloat16* xi_s = xu_s + size_t(TM) * sx;                                  // [bn][sx]
    float* oi_s = reinterpret_cast<float*>(xi_s + size_t(p.bn) * sx);              // [bn][so]
    unsigned char* staging = reinterpret_cast<unsigned char*>(oi_s + size_t(p.bn) * so);
    float* staging_scale = reinterpret_cast<float*>(staging + TM * N * 4);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int s = blockIdx.x % p.n_rs, c = blockIdx.x / p.n_rs;
    const int row0 = s * p.bm, col0 = c * p.bn;
    const int rows = min(p.bm, p.U - row0);
    const int cols = (int)min((long long)p.bn, p.lda - col0);
    const int nrt = (rows + TM - 1) / TM, nct = (cols + TK - 1) / TK;
    const int steps = nrt * nct;
    const Side su = user_side(p), si = item_side(p);

    // fragments [ju, ju + nu) of ou's part and [ji, ji + ni) of oi's
    const int NF = N / 8, rg = warp % RU, cg = warp & 3;
    const int per_u = (NF + 16 / RU - 1) / (16 / RU), per_i = (NF + 3) / 4;
    const int ju = min(NF, (warp / RU) * per_u), nu = min(NF, ju + per_u) - ju;
    const int ji = min(NF, (warp >> 2) * per_i), ni = min(NF, ji + per_i) - ji;

    // ring: step k = (row tile k / nct, column tile k % nct)
    auto issue = [&](int k) {
        if (k < steps) {
            const int r0 = row0 + (k / nct) * TM, c0 = col0 + (k % nct) * TK;
            const uint32_t base = smem_addr(ring + (k % STAGES) * stage_bytes(A_INT8, TM));
            if (A_INT8) {
                for (int e = tid; e < TM * TK / 16; e += THREADS) {
                    const int r = e >> 2, cc = (e & 3) * 16;
                    const bool ok = r0 + r < p.U && c0 + cc < p.lda;
                    const int8_t* src = static_cast<const int8_t*>(p.a) +
                                        (ok ? (r0 + r) * p.lda + c0 + cc : 0);
                    cp_async16(base + r * TK + cc, src, ok);
                }
            } else {
                for (int e = tid; e < TM * TK / 8; e += THREADS) {
                    const int r = e >> 3, cc = (e & 7) * 8;
                    const bool ok = r0 + r < p.U && c0 + cc < p.lda;
                    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p.a) +
                                               (ok ? (r0 + r) * p.lda + c0 + cc : 0);
                    cp_async16(base + (r * LDA_S + cc) * 2, src, ok);
                }
            }
        }
        cp_commit();
    };
    // the first group also carries the region's xi rows (raw, into oi_s
    // before it accumulates; their scales into the ring's last stage, which
    // the first tile to use it is issued into only after they are
    // converted) and row tile 0's xu rows. xu_s cannot take bn scales
    // with bf16 tiles at N = 8: TM x sx bf16 is 256 floats
    float* xi_scale = reinterpret_cast<float*>(ring + (STAGES - 1) * stage_bytes(A_INT8, TM));
    static_assert(stage_bytes(A_INT8, TM) >= MAX_BN * 4, "a ring stage holds a region's xi scales");
    stage_rows(oi_s, xi_scale, si, p.d, col0, p.bn);
    stage_rows(staging, staging_scale, su, p.d, row0, TM);
    for (int k = 0; k < STAGES - 1; ++k) issue(k);

    float acc_u[NFW][4];
    uint32_t xuf[KEEP_XU ? KS : 1][KEEP_XU ? NFWI : 1][2];
    for (int k = 0; k < steps; ++k) {
        const int rt = k / nct, ct = k % nct;
        // the staged xu rows of this row tile were committed with step
        // k - nct + STAGES - 1: complete by wait_group when nct >= STAGES - 1
        if (ct == 0 && nct < STAGES - 1)
            asm volatile("cp.async.wait_all;\n");
        else
            cp_wait<STAGES>();
        __syncthreads();  // tile k landed; every warp is done with step k-1
        if (k == 0) {
            convert_rows(xi_s, oi_s, xi_scale, si, p.d, N, col0, p.bn);
            __syncthreads();
            float4* o4 = reinterpret_cast<float4*>(oi_s);
            for (int e = tid; e < p.bn * so / 4; e += THREADS) o4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        if (ct == 0) {
            convert_rows(xu_s, staging, staging_scale, su, p.d, N, row0 + rt * TM, TM);
#pragma unroll
            for (int j = 0; j < NFW; ++j)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc_u[j][v] = 0.f;
        }
        const unsigned char* stage = ring + (k % STAGES) * stage_bytes(A_INT8, TM);
        const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(stage);
        if (A_INT8) {  // int8 -> bf16, exact
            for (int e = tid; e < TM * TK / 16; e += THREADS) {
                const int r = e >> 2, cc = (e & 3) * 16;
                const int4 raw = *reinterpret_cast<const int4*>(stage + r * TK + cc);
                const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
                __align__(16) __nv_bfloat16 v[16];
#pragma unroll
                for (int t = 0; t < 16; ++t) v[t] = __float2bfloat16_rn(float(b[t]));
                int4* dst = reinterpret_cast<int4*>(conv + r * LDA_S + cc);
                dst[0] = reinterpret_cast<const int4*>(v)[0];
                dst[1] = reinterpret_cast<const int4*>(v)[1];
            }
            a_s = conv;
        }
        if (A_INT8 || ct == 0) __syncthreads();  // conv, xu_s (and oi_s zeroed) written
        if (KEEP_XU && ct == 0) {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
#pragma unroll
                for (int j = 0; j < NFWI; ++j)
                    if (j < ni)
                        ldsm_x2_t(xuf[KEEP_XU ? ks : 0][KEEP_XU ? j : 0],
                                  smem_addr(xu_s + (16 * ks + (lane & 15)) * sx + 8 * (ji + j)));
        }
        if (ct == 0 && rt + 1 < nrt) stage_rows(staging, staging_scale, su, p.d, row0 + (rt + 1) * TM, TM);
        issue(k + STAGES - 1);

        // ou rows [16 rg, +16) of the tile: acc_u += A_tile @ xi_tile
#pragma unroll
        for (int ks = 0; ks < TK / 16; ++ks) {
            uint32_t fa[4];
            ldsm_x4(fa, smem_addr(a_s + (16 * rg + (lane & 15)) * LDA_S + 16 * ks + (lane >> 4) * 8));
            const __nv_bfloat16* xb = xi_s + (ct * TK + 16 * ks + (lane & 15)) * sx;
#pragma unroll
            for (int j = 0; j < NFW; ++j) {
                if (j < nu) {
                    uint32_t fb[2];
                    ldsm_x2_t(fb, smem_addr(xb + 8 * (ju + j)));
                    mma(acc_u[j], fa, fb);
                }
            }
        }
        // oi columns [16 cg, +16) of the tile: a TM-row chain, then f32 adds
        {
            float tmp[NFWI][4];
#pragma unroll
            for (int j = 0; j < NFWI; ++j)
#pragma unroll
                for (int v = 0; v < 4; ++v) tmp[j][v] = 0.f;
            const int i8 = lane & 7, m4 = lane >> 3;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                uint32_t fa[4];
                ldsm_x4_t(fa, smem_addr(a_s + (16 * ks + i8 + (m4 >> 1) * 8) * LDA_S + 16 * cg +
                                        (m4 & 1) * 8));
#pragma unroll
                for (int j = 0; j < NFWI; ++j) {
                    if (j < ni) {
                        if (KEEP_XU) {
                            mma(tmp[j], fa, xuf[KEEP_XU ? ks : 0][KEEP_XU ? j : 0]);
                        } else {
                            uint32_t fb[2];
                            ldsm_x2_t(fb, smem_addr(xu_s + (16 * ks + (lane & 15)) * sx + 8 * (ji + j)));
                            mma(tmp[j], fa, fb);
                        }
                    }
                }
            }
            float* o = oi_s + (ct * TK + 16 * cg + g) * so + 2 * t4;
#pragma unroll
            for (int j = 0; j < NFWI; ++j) {
                if (j < ni) {
                    float2* lo = reinterpret_cast<float2*>(o + 8 * (ji + j));
                    float2* hi = reinterpret_cast<float2*>(o + 8 * so + 8 * (ji + j));
                    float2 a = *lo, b = *hi;
                    a.x += tmp[j][0]; a.y += tmp[j][1];
                    b.x += tmp[j][2]; b.y += tmp[j][3];
                    *lo = a;
                    *hi = b;
                }
            }
        }
        if (ct == nct - 1) {
            // this row tile's ou partial: lane pairs swap halves so each
            // lane stores 4 consecutive features (16 bytes) of one row
            const bool odd = t4 & 1;
            const int row = row0 + rt * TM + 16 * rg + g + (odd ? 8 : 0);
#pragma unroll
            for (int j = 0; j < NFW; ++j) {
                if (j < nu) {
                    const float* a = acc_u[j];
                    const float got0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
                    const float got1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
                    const float4 v = odd ? make_float4(got0, got1, a[2], a[3])
                                         : make_float4(a[0], a[1], got0, got1);
                    if (row < p.U)
                        *reinterpret_cast<float4*>(p.ou_part + (size_t(c) * p.U + row) * N +
                                                   8 * (ju + j) + 2 * (t4 & ~1)) = v;
                }
            }
        }
    }
    cp_wait<STAGES>();
    __syncthreads();  // every warp's oi adds are in
    const int q4 = N / 4, ncols = min(p.bn, p.I - col0);
    for (int e = tid; e < ncols * q4; e += THREADS) {
        const int r = e / q4, f = (e - r * q4) * 4;
        *reinterpret_cast<float4*>(p.oi_part + (size_t(s) * p.I + col0 + r) * N + f) =
            *reinterpret_cast<const float4*>(oi_s + r * so + f);
    }
}

// out[e][f] for e < U: Σ_c ou_part[c][e][f] (· su[e]); for e = U + i:
// Σ_s oi_part[s][i][f] (· si[i]); parts summed in order 0, 1, ...; the scale
// multiplies the finished sum, as `ou * su` does
__global__ void reduce_partials(Args p) {
    const int q4 = p.N / 4;
    const long long total = (long long)(p.U + p.I) * q4;
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
        const int row = int(e / q4), f = int(e % q4) * 4;
        if (f >= p.d) continue;
        const bool user = row < p.U;
        const int r = user ? row : row - p.U;
        const int parts = user ? p.n_cs : p.n_rs;
        const long long step = (long long)(user ? p.U : p.I) * p.N;
        const float* src = (user ? p.ou_part : p.oi_part) + (long long)r * p.N + f;
        // loads in batches of 16 in flight, adds in part order
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int k = 0; k < parts; k += 16) {
            float4 v[16];
#pragma unroll
            for (int j = 0; j < 16; ++j)
                if (k + j < parts) v[j] = __ldg(reinterpret_cast<const float4*>(src + (k + j) * step));
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                if (k + j < parts) {
                    acc.x += v[j].x; acc.y += v[j].y; acc.z += v[j].z; acc.w += v[j].w;
                }
            }
        }
        const float* scale = user ? p.su : p.si;
        if (scale) {
            const float sc = scale[r];
            acc.x *= sc; acc.y *= sc; acc.z *= sc; acc.w *= sc;
        }
        float* o = p.out + (long long)row * p.d + f;
        const float vals[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int v = 0; v < 4; ++v)
            if (f + v < p.d) o[v] = vals[v];
    }
}

template <bool A_INT8, int TM, int NFW>
int launch_regions(const Args& p, int smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(dual_regions<A_INT8, TM, NFW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dual_regions<A_INT8, TM, NFW><<<p.n_rs * p.n_cs, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

template <bool A_INT8>
int launch_width(const Args& p, int tm, int smem, cudaStream_t stream) {
    // n8 fragments a warp owns in ou: the features split in 2 parts with
    // 128-row tiles (8 row groups), in 4 with 64-row ones
    const int NF = p.N / 8;
    if (tm == 128) {  // int8 at N <= 128 only
        const int nfw = (NF + 1) / 2;
        if (nfw <= 1) return launch_regions<A_INT8, 128, 1>(p, smem, stream);
        if (nfw <= 2) return launch_regions<A_INT8, 128, 2>(p, smem, stream);
        if (nfw <= 4) return launch_regions<A_INT8, 128, 4>(p, smem, stream);
        return launch_regions<A_INT8, 128, 8>(p, smem, stream);
    }
    const int nfw = (NF + 3) / 4;
    if (nfw <= 1) return launch_regions<A_INT8, 64, 1>(p, smem, stream);
    if (nfw <= 2) return launch_regions<A_INT8, 64, 2>(p, smem, stream);
    if (nfw <= 4) return launch_regions<A_INT8, 64, 4>(p, smem, stream);
    return launch_regions<A_INT8, 64, 8>(p, smem, stream);
}

}  // namespace

extern "C" {

// Rows of a tile at width d: a region's rows must be a multiple of it.
int qrec_dual_tile_rows(int d, int a_is_int8) {
    return tile_rows((d + 7) / 8 * 8, a_is_int8 != 0);
}

// The most columns a region of width-d features can have in shared memory,
// a multiple of the 64-column tile, at most MAX_BN (0 if not even one tile
// fits).
int qrec_dual_max_cols(int d, int a_is_int8) {
    const int N = (d + 7) / 8 * 8;
    return max_cols(N, a_is_int8 != 0, tile_rows(N, a_is_int8 != 0));
}

// a: (U, lda) row-major, int8 when a_is_int8 else bf16, lda >= I a multiple
// of 16 whose columns past I are zero or meet zero rows of xi. Unscaled
// entry: xu (U, d), xi (I, d) bf16, 4-byte aligned, x = su = si = null.
// Factored entry: x (U+I, d) f32, su (U,), si (I,) f32, xu = xi = null.
// ou_part (n_cs, U, N), oi_part (n_rs, I, N) f32 with N = d rounded up to
// 8; out (U+I, d) f32. Regions of bm x bn, bm a multiple of the tile rows,
// bn of 64 and at most the max cols, cover U x lda. Two launches; returns
// cudaGetLastError() after them.
int qrec_dual_matmul(const void* a, int a_is_int8, long long lda, const void* xu, const void* xi,
                     const void* x, const void* su, const void* si, void* ou_part, void* oi_part,
                     void* out, int U, int I, int d, int bm, int bn, void* stream) {
    const int tm = qrec_dual_tile_rows(d, a_is_int8);
    if (U <= 0 || I <= 0 || d <= 0 || d > 256 || lda < I || lda % 16 != 0 || bm <= 0 ||
        bn <= 0 || bm % tm != 0 || bn % TK != 0 || bn > qrec_dual_max_cols(d, a_is_int8) ||
        (x == nullptr) == (xu == nullptr))
        return (int)cudaErrorInvalidValue;
    Args p;
    p.a = a;
    p.lda = lda;
    p.xu = static_cast<const __nv_bfloat16*>(xu);
    p.xi = static_cast<const __nv_bfloat16*>(xi);
    p.x = static_cast<const float*>(x);
    p.su = static_cast<const float*>(su);
    p.si = static_cast<const float*>(si);
    p.ou_part = static_cast<float*>(ou_part);
    p.oi_part = static_cast<float*>(oi_part);
    p.out = static_cast<float*>(out);
    p.U = U;
    p.I = I;
    p.d = d;
    p.N = (d + 7) / 8 * 8;
    p.bm = bm;
    p.bn = bn;
    p.n_rs = (U + bm - 1) / bm;
    p.n_cs = int((lda + bn - 1) / bn);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int smem = (int)smem_bytes(p.N, bn, a_is_int8 != 0, tm);
    int err = a_is_int8 ? launch_width<true>(p, tm, smem, st) : launch_width<false>(p, tm, smem, st);
    if (err != 0) return err;
    // one thread per (row, 4 features): every row's loads in flight at once
    const long long items = (long long)(U + I) * (p.N / 4);
    reduce_partials<<<(unsigned)((items + 255) / 256), 256, 0, st>>>(p);
    return (int)cudaGetLastError();
}

}  // extern "C"
