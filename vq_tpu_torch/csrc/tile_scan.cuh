// Device helpers of the register-tiled scans, K1 (assign.cu) and the PQ
// scan of K3 and K4 (pq_encode.cu): cp.async copies into shared memory
// and the rounded multiply-add of the 8 x 8 outer products.
#pragma once

#include <cuda_runtime.h>

namespace vqk {

// 16 (4) bytes from src to dst, or zeros when !ok (src is then only a
// valid address, never read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mac(float& acc, float a, float b) {
  acc = __fadd_rn(acc, __fmul_rn(a, b));
}

// Component e of v (e is a constant once the caller's loop is unrolled).
__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

}  // namespace vqk
