// K2: one Lloyd pass. x [n, d] f32 against centroids [k, d] -> sums
// [k, d], counts [k] (f32, exact integers) and the inertia
// sum(max(min_score + ||x||^2, 0)). With sample weights w [n] f32 (a
// null pointer means none) the sums are sum w*x, the counts sum w and the
// inertia sum w*d, each product rounded before it is added.
//
// Replaces vq_tpu/ops/pallas_kernels.py::_lloyd_acc_kernel (reached
// through lloyd_accumulate_fused / _lloyd_accumulate_jit).
//
// What bounds it on the card: the assignment, exactly K1's work
// (2*n*k*d exact fp32 operations); the accumulation is n*d adds and a
// few passes over n ints.
//
// Design: the TPU grid ran in order and carried the sums in VMEM. Hopper
// blocks run in parallel, and per-block partial sums (K3's way) cost
// k*d*4 bytes a block: 32 MB at k = 65536, d = 128. So the pass groups
// rows by cluster instead, with no float atomics anywhere:
//  1. K1's assignment (vq_assign) -> codes [n], distances [n];
//  2. a stable counting sort of the row ids by code: per-chunk
//     histograms (integer atomics: exact counts), per-cluster totals, an
//     exclusive scan into cluster offsets, per-(chunk, cluster) cursors,
//     then one warp per chunk places its rows in ascending order
//     (__match_any_sync ranks equal codes inside a 32-row step);
//  3. one block per cluster sums its rows in ascending row order (with
//     weights, w*x and, in one more column, w: the weighted count);
//  4. one block sums the distances (or w*d) in a fixed order for the
//     inertia.
// Every sum has one fixed order, so the result is bit-identical from
// run to run, weighted or not; against the unweighted plain version
// (index_add_) sums and inertia differ by fp32 summation order only, and
// counts are exact; the weighted plain version sums in the kernel's
// order and matches it bit for bit where the assignments agree. The
// temporaries are O(n + chunks*k) ints at any k, with chunks*k kept at
// or below 2^24 by the wrapper.
#include "common.cuh"

extern "C" int vq_assign(const void* x, int x_is_bf16, const float* c,
                         const float* cc, int* codes, float* dists,
                         long long n, int k, int d, void* stream);

namespace {

constexpr int kScanThreads = 1024;

__global__ void chunk_hist_kernel(const int* __restrict__ codes,
                                  int* __restrict__ chunk_counts, long long n,
                                  int k, long long rows_per_chunk) {
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  int* cnt = chunk_counts + (size_t)blockIdx.x * k;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x)
    atomicAdd(&cnt[codes[r]], 1);
}

__global__ void cluster_totals_kernel(const int* __restrict__ chunk_counts,
                                      int* __restrict__ totals, int k,
                                      int chunks) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  int a = 0;
  for (int c = 0; c < chunks; ++c) a += chunk_counts[(size_t)c * k + j];
  totals[j] = a;
}

// Exclusive scan of totals into offsets (one block), and counts as f32.
__global__ void __launch_bounds__(kScanThreads)
    cluster_scan_kernel(const int* __restrict__ totals,
                        int* __restrict__ offsets, float* __restrict__ counts,
                        int k) {
  __shared__ int part[kScanThreads];
  const int per = (k + kScanThreads - 1) / kScanThreads;
  const int j0 = min(k, (int)threadIdx.x * per), j1 = min(k, j0 + per);
  int a = 0;
  for (int j = j0; j < j1; ++j) a += totals[j];
  part[threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int t = 0; t < kScanThreads; ++t) {
      const int v = part[t];
      part[t] = run;
      run += v;
    }
  }
  __syncthreads();
  int run = part[threadIdx.x];
  for (int j = j0; j < j1; ++j) {
    offsets[j] = run;
    run += totals[j];
    counts[j] = (float)totals[j];
  }
}

// Turns the per-chunk counts into the first output slot of each
// (chunk, cluster): cluster offset plus the rows of earlier chunks.
__global__ void chunk_cursor_kernel(int* __restrict__ chunk_counts,
                                    const int* __restrict__ offsets, int k,
                                    int chunks) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  int run = offsets[j];
  for (int c = 0; c < chunks; ++c) {
    const int v = chunk_counts[(size_t)c * k + j];
    chunk_counts[(size_t)c * k + j] = run;
    run += v;
  }
}

// One warp per chunk walks its rows 32 at a time in ascending order:
// lanes with equal codes rank by lane, so each cluster's rows land in
// ascending row order.
__global__ void chunk_scatter_kernel(const int* __restrict__ codes,
                                     int* __restrict__ cursors,
                                     int* __restrict__ perm, long long n,
                                     int k, long long rows_per_chunk) {
  const int lane = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  int* cur = cursors + (size_t)blockIdx.x * k;
  for (long long base = r0; base < r1; base += 32) {
    const long long r = base + lane;
    const bool valid = r < r1;
    const int code = valid ? codes[r] : -1;
    const unsigned same = __match_any_sync(0xffffffffu, code);
    const int pos0 = valid ? cur[code] : 0;
    __syncwarp();
    if (valid) {
      perm[pos0 + __popc(same & ((1u << lane) - 1u))] = (int)r;
      if (lane == 31 - __clz(same)) cur[code] = pos0 + __popc(same);
    }
    __syncwarp();
  }
}

// Column e < d of cluster j sums x[r, e] (w[r]*x[r, e] when weighted)
// over the cluster's rows r in ascending order; weighted, column d sums
// w[r] into the count, which the scan wrote as a row count before.
template <bool kWeighted>
__global__ void cluster_sum_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   const int* __restrict__ perm,
                                   const int* __restrict__ offsets,
                                   const int* __restrict__ totals,
                                   float* __restrict__ sums,
                                   float* __restrict__ counts, int d) {
  const int j = blockIdx.x;
  const int off = offsets[j], cnt = totals[j];
  for (int e = threadIdx.x; e < d + (kWeighted ? 1 : 0); e += blockDim.x) {
    float a = 0.f;
    if (kWeighted && e == d) {
      for (int t = 0; t < cnt; ++t) a = __fadd_rn(a, w[perm[off + t]]);
      counts[j] = a;
      continue;
    }
#pragma unroll 8
    for (int t = 0; t < cnt; ++t) {
      const long long r = perm[off + t];
      const float v = x[r * d + e];
      a = __fadd_rn(a, kWeighted ? __fmul_rn(w[r], v) : v);
    }
    sums[(long long)j * d + e] = a;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    inertia_kernel(const float* __restrict__ dists,
                   const float* __restrict__ w,
                   float* __restrict__ inertia, long long n) {
  __shared__ float red[kScanThreads];
  float a = 0.f;
  for (long long r = threadIdx.x; r < n; r += kScanThreads)
    a = __fadd_rn(a, w ? __fmul_rn(w[r], dists[r]) : dists[r]);
  red[threadIdx.x] = a;
  __syncthreads();
  for (int half = kScanThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) *inertia = red[0];
}

}  // namespace

extern "C" int vq_lloyd(const float* x, const float* w, const float* c,
                        const float* cc, int* codes, float* dists, int* chunk_counts,
                        int* totals, int* offsets, int* perm, float* sums,
                        float* counts, float* inertia, long long n, int k,
                        int d, long long rows_per_chunk, int chunks,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = vq_assign(x, 0, c, cc, codes, dists, n, k, d, stream);
  if (err != 0) return err;
  err = (int)cudaMemsetAsync(chunk_counts, 0,
                             (size_t)chunks * k * sizeof(int), st);
  if (err != 0) return err;
  const unsigned kblk = (unsigned)((k + 255) / 256);
  chunk_hist_kernel<<<chunks, 256, 0, st>>>(codes, chunk_counts, n, k,
                                            rows_per_chunk);
  cluster_totals_kernel<<<kblk, 256, 0, st>>>(chunk_counts, totals, k,
                                              chunks);
  cluster_scan_kernel<<<1, kScanThreads, 0, st>>>(totals, offsets, counts, k);
  chunk_cursor_kernel<<<kblk, 256, 0, st>>>(chunk_counts, offsets, k, chunks);
  chunk_scatter_kernel<<<chunks, 32, 0, st>>>(codes, chunk_counts, perm, n, k,
                                              rows_per_chunk);
  if (w)
    cluster_sum_kernel<true><<<k, 128, 0, st>>>(x, w, perm, offsets, totals,
                                                sums, counts, d);
  else
    cluster_sum_kernel<false><<<k, 128, 0, st>>>(x, w, perm, offsets, totals,
                                                 sums, counts, d);
  inertia_kernel<<<1, kScanThreads, 0, st>>>(dists, w, inertia, n);
  return (int)cudaGetLastError();
}
