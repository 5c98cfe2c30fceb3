// Adam's parameter update, step t, with the rounding of torch.optim.Adam's
// non-capturable foreach path (torch/optim/adam.py _multi_tensor_adam), and
// capturable: the step's scalars come from a device table indexed by the
// device step count, so a CUDA graph that holds the launch reads the step
// of each replay.
//
// The foreach path computes, per element of f32 p, m = exp_avg and
// v = exp_avg_sq (the moments already updated for step t):
//   denom = sqrt(v) / c_t + eps                 (_foreach_sqrt, _foreach_div_,
//                                                _foreach_add_)
//   p     = p + s_t * (m / denom)               (_foreach_addcdiv_)
// with c_t = f32((1 - b2^t)^0.5) and s_t = f32(-lr / (1 - b1^t)), both formed
// on the host in f64 and cast to f32 in the kernel. Each operation rounds
// once (IEEE division and square root); the addcdiv's multiply-add is one
// fused rounding (nvcc contracts `a + s * q`). Here every step is written
// out with its explicit rounding intrinsic, so that no contraction or fast
// path of this compiler can change a bit.
//
// table: (rows, 2) f32, row t-1 = (s_t, c_t); a step past the last row
// reads the last row, which the host ends where both bias corrections are
// exactly 1 in f64, so every later step's scalars equal it.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float adam_element(float p, float m, float v, float s, float c,
                                              float eps) {
  const float denom = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), c), eps);
  return __fmaf_rn(s, __fdiv_rn(m, denom), p);
}

__global__ void adam_update_kernel(float* __restrict__ p, const float* __restrict__ m,
                                   const float* __restrict__ v, const float* __restrict__ step,
                                   const float* __restrict__ table, int rows, float eps,
                                   long long n, int vec4) {
  int t = static_cast<int>(step[0]);
  t = t < 1 ? 1 : (t > rows ? rows : t);
  const float s = table[2 * (t - 1)];
  const float c = table[2 * (t - 1) + 1];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec4) {
    const long long n4 = n >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (long long k = i; k < n4; k += stride) {
      float4 pv = p4[k];
      const float4 mv = m4[k];
      const float4 vv = v4[k];
      pv.x = adam_element(pv.x, mv.x, vv.x, s, c, eps);
      pv.y = adam_element(pv.y, mv.y, vv.y, s, c, eps);
      pv.z = adam_element(pv.z, mv.z, vv.z, s, c, eps);
      pv.w = adam_element(pv.w, mv.w, vv.w, s, c, eps);
      p4[k] = pv;
    }
    done = n4 << 2;
  }
  for (long long k = done + i; k < n; k += stride) {
    p[k] = adam_element(p[k], m[k], v[k], s, c, eps);
  }
}

}  // namespace

extern "C" int qrec_adam_update(float* p, const float* m, const float* v, const float* step,
                                const float* table, int rows, float eps, long long n,
                                int num_sms, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned long long a = reinterpret_cast<unsigned long long>(p) |
                               reinterpret_cast<unsigned long long>(m) |
                               reinterpret_cast<unsigned long long>(v);
  const int vec4 = (a & 15ull) == 0 ? 1 : 0;
  const long long work = vec4 ? (n >> 2) + (n & 3) : n;
  long long blocks = (work + threads - 1) / threads;
  const long long cap = static_cast<long long>(num_sms) * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  adam_update_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p, m, v, step, table, rows, eps, n,
                                                            vec4);
  return static_cast<int>(cudaGetLastError());
}
