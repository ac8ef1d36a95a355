// Shared code of the PQ kernels: the int2 argmin rule and the PQ scan
// that K3 and K4 both run.
//
// Rounding: every product and sum is an explicit round-to-nearest
// intrinsic, and the library is built with -fmad=false as well, so no
// multiply-add is contracted into an FMA. The score of centroid j is
//     cc[j] - 2 * dot,   dot = ((0 + x0*c0) + x1*c1) + ... (e ascending)
// which is exactly what the plain PyTorch versions compute elementwise,
// so kernel and plain agree bit for bit (but K4-bf16 and K4-bf16x3, whose
// dots the tensor cores sum in their own order: pq_encode.cu).
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vqk {

constexpr int kThreads = 256;  // rows per tile: one thread per row
constexpr int kInfKey = 0x7F800000;  // orderable_key(+inf)

// Monotone f32 -> i32 map (integer order == float order), the TPU
// kernels' _orderable_key: negative floats flip their low 31 bits, NaN
// keys above +inf so it never wins a min, and -0.0 shares +0.0's key.
// A NaN with its sign bit set would key below -inf (the plain versions'
// orderable_key clears that bit first). None reaches this key: the card's
// arithmetic returns the positive canonical NaN (0x7FFFFFFF), which
// tests/test_torch_cuda.py checks, and the encodes fold their scores by
// float compares that let no NaN in.
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

// The PQ scan (defined in pq_encode.cu): codes [n, m] i32, the int2 argmin
// of cc - 2 x_s.c for every row and subspace, and, where minval is not
// null, the minimum score itself [n, m] f32 (key_to_f32 of the winning
// key). x is [n, m*s] f32 or bf16 (x_is_bf16); cb [m, k, s] and cc [m, k]
// f32. resident: the subspace's codebook stays in shared memory while x
// tiles stream through a ring of `stages` stages (blocks of
// rows_per_block rows); otherwise one block a 128-row tile, the codebook
// streaming past it in slices. smem: dynamic shared-memory bytes a block,
// as cuda_kernels.pq_scan_plan reckons them. Returns cudaGetLastError().
int pq_scan(const void* x, bool x_is_bf16, const float* cb, const float* cc, int* codes,
            float* minval, long long n, int m, int k, int s, bool resident, int stages,
            int smem, long long rows_per_block, cudaStream_t st);

}  // namespace vqk
