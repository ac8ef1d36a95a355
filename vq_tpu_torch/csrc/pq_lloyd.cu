// K3: one Lloyd pass of PQ training for all m subspaces. x [n, m*s] f32
// against codebooks [m, k, s] -> sums [m, k, s], counts [m, k] (f32,
// exact integers) and the total inertia sum(max(min_score + ||x_s||^2, 0)).
//
// Replaces vq_tpu/ops/pallas_kernels.py::_pq_lloyd_acc_kernel (reached
// through pq_lloyd_accumulate_fused / _pq_lloyd_accumulate_jit).
//
// What bounds it on the card: the assignment, as in K4 (2*n*m*k*s FP32
// instructions, no FMA); the accumulation adds n*m*s more adds and
// read-modify-writes that hit L2.
//
// Design: the TPU grid ran in order and carried the sums in VMEM from
// one step to the next. Hopper blocks run in parallel, so the pass is
// three launches, with no atomics anywhere:
//  1. K4's register-tiled scan (pq_scan, pq_encode.cu) writes each row's
//     code [n, m] i32 and its minimum score [n, m] f32, the exact float
//     of the winning key.
//  2. Block (c, i) walks subspace i of its row range in 256-row tiles
//     and accumulates into its own partial slice: thread j owns centroid
//     j (and j + 256, ...) and walks the tile's rows in ascending order,
//     so every partial sum has one fixed order. Counts are integers.
//     Inertia is summed per thread over its rows, then tree-reduced in a
//     fixed order into one partial per block.
//  3. A reduce kernel sums the partials over c in ascending order.
// The result is deterministic from run to run for a given n (the row
// partition depends only on n, m, k and s), and equal bit for bit to the
// one-launch design it replaced, whose scan computed the same keys.
// Against the plain version, which sums in another order, sums and
// inertia differ by fp32 rounding only; counts are exact, because both
// assign with the same arithmetic. Rows past n are never read, so they
// add nothing to sums, counts or inertia.
#include "common.cuh"

using namespace vqk;

__global__ void __launch_bounds__(kThreads)
    pq_lloyd_partial_kernel(const float* __restrict__ x,
                            const int* __restrict__ codes,
                            const float* __restrict__ minval,
                            float* __restrict__ psums,
                            int* __restrict__ pcounts,
                            float* __restrict__ pinertia, long long n, int m,
                            int k, int s, long long rows_per_block) {
  __shared__ int tile_codes[kThreads];
  __shared__ float red[kThreads];

  const int i = blockIdx.y;
  const size_t slot = (size_t)blockIdx.x * m + i;
  float* ps = psums + slot * k * s;
  int* pc = pcounts + slot * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {  // owner-zeroed
    for (int e = 0; e < s; ++e) ps[(size_t)j * s + e] = 0.f;
    pc[j] = 0;
  }

  const long long d = (long long)m * s;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  float inertia = 0.f;
  for (long long base = r0; base < r1; base += blockDim.x) {
    const long long row = base + threadIdx.x;
    const bool valid = row < r1;
    const float* xs = x + (valid ? row : 0) * d + (long long)i * s;
    const int best_idx = valid ? codes[row * m + i] : -1;
    if (valid) {
      float xx = 0.f;
      for (int e = 0; e < s; ++e) xx = __fadd_rn(xx, __fmul_rn(xs[e], xs[e]));
      const float t = __fadd_rn(minval[row * m + i], xx);
      inertia = __fadd_rn(inertia, isnan(t) ? t : fmaxf(t, 0.f));
    }
    tile_codes[threadIdx.x] = best_idx;
    __syncthreads();
    const int rows = (int)min((long long)blockDim.x, r1 - base);
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      float* psj = ps + (size_t)j * s;
      for (int r = 0; r < rows; ++r) {
        if (tile_codes[r] != j) continue;
        pc[j] += 1;
        const float* xr = x + (base + r) * d + (long long)i * s;
        for (int e = 0; e < s; ++e) psj[e] = __fadd_rn(psj[e], xr[e]);
      }
    }
    __syncthreads();
  }
  red[threadIdx.x] = inertia;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) pinertia[slot] = red[0];
}

__global__ void pq_lloyd_reduce_kernel(const float* __restrict__ psums,
                                       const int* __restrict__ pcounts,
                                       const float* __restrict__ pinertia,
                                       float* __restrict__ sums,
                                       float* __restrict__ counts,
                                       float* __restrict__ inertia, int chunks,
                                       long long mks, long long mk, int m) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < mks) {
    float a = 0.f;
    for (int c = 0; c < chunks; ++c) a = __fadd_rn(a, psums[c * mks + t]);
    sums[t] = a;
  }
  if (t < mk) {
    long long a = 0;
    for (int c = 0; c < chunks; ++c) a += pcounts[c * mk + t];
    counts[t] = (float)a;
  }
  if (t == 0) {
    float a = 0.f;
    for (long long q = 0; q < (long long)chunks * m; ++q)
      a = __fadd_rn(a, pinertia[q]);
    *inertia = a;
  }
}

extern "C" int vq_pq_lloyd(const float* x, const float* cb, const float* cc,
                           int* codes, float* minval, float* psums,
                           int* pcounts, float* pinertia, float* sums,
                           float* counts, float* inertia, long long n, int m,
                           int k, int s, int resident, int stages, int smem,
                           long long scan_rows, long long rows_per_block,
                           int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = pq_scan(x, false, cb, cc, codes, minval, n, m, k, s, resident != 0,
                    stages, smem, scan_rows, st);
  if (err != 0) return err;
  const dim3 grid((unsigned)chunks, (unsigned)m);
  pq_lloyd_partial_kernel<<<grid, kThreads, 0, st>>>(
      x, codes, minval, psums, pcounts, pinertia, n, m, k, s, rows_per_block);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long mks = (long long)m * k * s;
  const unsigned nblk = (unsigned)((mks + kThreads - 1) / kThreads);
  pq_lloyd_reduce_kernel<<<nblk, kThreads, 0, st>>>(
      psums, pcounts, pinertia, sums, counts, inertia, chunks, mks,
      (long long)m * k, m);
  return (int)cudaGetLastError();
}
