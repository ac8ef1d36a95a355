// K4: exact PQ encode. x [n, m*s] (f32 or bf16) against codebooks
// [m, k, s] f32 -> codes [n, m] i32, the int2 argmin of
// ||c||^2 - 2 x_s.c per subspace.
//
// Replaces vq_tpu/ops/pallas_kernels.py::_pq_encode_kernel (reached
// through pq_encode_fused / _pq_encode_fused_jit).
//
// What bounds it on the card: 2*n*m*k*s flops in exact fp32 on the CUDA
// cores (no tensor cores: TF32 or bf16 would move argmins near ties).
// At 1M x 128 against 8x256x16 that is 67 GFLOP against 512 MB of x, so
// it is compute-bound, and the 67 TFLOP/s fp32 peak assumes FMAs, which
// the exact rounding rule forbids.
//
// Design: block (c, i) owns subspace i of a contiguous range of rows,
// one thread per row in tiles of 256. The subspace's codebook sits in
// shared memory (reads are warp broadcasts) and the row's slice in
// registers. Where the codebook does not fit the 48 KB window
// (e.g. 16x256x96 is 1.5 MB in all, 96 KB a subspace) it streams through
// in chunks of kc centroids with a running minimum, so every shape runs.
// bf16 input stays bf16 in device memory and is upcast in registers.
// The TPU kernel's k padding to 128 lanes (cc = +inf) is not needed: the
// scan runs over exactly k centroids, so no index >= k can come out.
#include "common.cuh"

using namespace vqk;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pq_encode_kernel(const T* __restrict__ x, const float* __restrict__ cb,
                     const float* __restrict__ cc, int* __restrict__ codes,
                     long long n, int m, int k, int s, int kc,
                     long long rows_per_block) {
  extern __shared__ float smem[];
  float* cbs = smem;
  float* ccs = smem + (size_t)kc * s;
  const int i = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  const float* cbi = cb + (size_t)i * k * s;
  const float* cci = cc + (size_t)i * k;
  const bool resident = kc >= k;
  if (resident) {
    load_chunk(cbi, cci, cbs, ccs, 0, k, s);
    __syncthreads();
  }
  const long long d = (long long)m * s;
  for (long long base = r0; base < r1; base += blockDim.x) {
    const long long row = base + threadIdx.x;
    const bool valid = row < r1;
    const T* xs = x + (valid ? row : 0) * d + (long long)i * s;
    int best_key, best_idx;
    nearest_centroid(xs, valid, s, cbi, cci, k, kc, resident, cbs, ccs,
                     best_key, best_idx);
    if (valid) codes[row * m + i] = best_idx;
  }
}

extern "C" int vq_pq_encode(const void* x, int x_is_bf16, const float* cb,
                            const float* cc, int* codes, long long n, int m,
                            int k, int s, int kc, long long rows_per_block,
                            void* stream) {
  const unsigned nblk = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  const dim3 grid(nblk, (unsigned)m);
  const size_t smem = ((size_t)kc * s + kc) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    pq_encode_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), cb, cc, codes, n, m, k, s, kc,
        rows_per_block);
  } else {
    pq_encode_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), cb, cc, codes, n, m, k, s, kc,
        rows_per_block);
  }
  return (int)cudaGetLastError();
}
