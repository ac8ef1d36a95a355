// Shared device code of the PQ kernels: the int2 argmin rule and the
// per-(row, subspace) nearest-centroid scan that K3 and K4 both run.
//
// Rounding: every product and sum is an explicit round-to-nearest
// intrinsic, and the library is built with -fmad=false as well, so no
// multiply-add is contracted into an FMA. The score of centroid j is
//     cc[j] - 2 * dot,   dot = ((0 + x0*c0) + x1*c1) + ... (e ascending)
// which is exactly what the plain PyTorch versions compute elementwise,
// so kernel and plain agree bit for bit.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vqk {

constexpr int kThreads = 256;  // rows per tile: one thread per row
constexpr int kXRegs = 16;     // subspace widths up to this sit in registers
constexpr int kInfKey = 0x7F800000;  // orderable_key(+inf)

// Monotone f32 -> i32 map (integer order == float order), the TPU
// kernels' _orderable_key: negative floats flip their low 31 bits, NaN
// keys above +inf so it never wins a min, and -0.0 shares +0.0's key.
__device__ __forceinline__ int orderable_key(float f) {
  const int b = __float_as_int(f);
  const int key = b < 0 ? (b ^ 0x7FFFFFFF) : b;
  return key == -1 ? 0 : key;
}

__device__ __forceinline__ float key_to_f32(int key) {
  return __int_as_float(key < 0 ? (key ^ 0x7FFFFFFF) : key);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Copies centroids [j0, j0 + cnt) of one subspace (and their squared
// norms) into shared memory.
__device__ __forceinline__ void load_chunk(const float* __restrict__ cbi,
                                           const float* __restrict__ cci,
                                           float* cbs, float* ccs, int j0,
                                           int cnt, int s) {
  const float* src = cbi + (size_t)j0 * s;
  for (int t = threadIdx.x; t < cnt * s; t += blockDim.x) cbs[t] = src[t];
  for (int t = threadIdx.x; t < cnt; t += blockDim.x) ccs[t] = cci[j0 + t];
}

// Nearest centroid of one subspace for this thread's row under the int2
// rule: minimum orderable key, lowest index among equal keys (a strict <
// over ascending j, starting from key INT_MAX at index 0, gives exactly
// that, NaN rows included). Every thread of the block must call it: when
// the codebook does not fit shared memory (resident == false) it streams
// through in chunks of kc centroids with a running minimum, and the
// loads synchronise the block. Scores are compared unclamped.
template <typename T>
__device__ __forceinline__ void nearest_centroid(
    const T* __restrict__ xs, bool valid, int s,
    const float* __restrict__ cbi, const float* __restrict__ cci, int k,
    int kc, bool resident, float* cbs, float* ccs, int& best_key,
    int& best_idx) {
  const bool in_regs = s <= kXRegs;
  float xr[kXRegs];
#pragma unroll
  for (int e = 0; e < kXRegs; ++e)
    xr[e] = (valid && in_regs && e < s) ? to_f32(xs[e]) : 0.f;
  best_key = INT_MAX;
  best_idx = 0;
  for (int j0 = 0; j0 < k; j0 += kc) {
    const int cnt = min(kc, k - j0);
    if (!resident) {
      __syncthreads();
      load_chunk(cbi, cci, cbs, ccs, j0, cnt, s);
      __syncthreads();
    }
    if (!valid) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* c = cbs + (size_t)j * s;
      float dot = 0.f;
      if (in_regs) {
#pragma unroll
        for (int e = 0; e < kXRegs; ++e)
          if (e < s) dot = __fadd_rn(dot, __fmul_rn(xr[e], c[e]));
      } else {
        for (int e = 0; e < s; ++e)
          dot = __fadd_rn(dot, __fmul_rn(to_f32(xs[e]), c[e]));
      }
      const int key = orderable_key(__fsub_rn(ccs[j], __fmul_rn(2.0f, dot)));
      if (key < best_key) {
        best_key = key;
        best_idx = j0 + j;
      }
    }
  }
}

}  // namespace vqk
