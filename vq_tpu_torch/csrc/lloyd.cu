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
// (2*n*k*d exact fp32 operations). The per-cluster sums are bound by
// bytes: x read once (n*d*4, 0.031 ms at 200k x 128 and 3.35 TB/s).
//
// Design: the TPU grid ran in order and carried the sums in VMEM. Hopper
// blocks run in parallel, and per-block partial sums (K3's way) cost
// k*d*4 bytes a block: 32 MB at k = 65536, d = 128. So the pass groups
// rows by cluster instead, with no float atomics anywhere:
//  1. K1's assignment (vq_assign) -> codes [n], distances [n];
//  2. a stable counting sort of the row ids by code: per-chunk
//     histograms (integer atomics: exact counts), per-cluster totals, an
//     exclusive scan into cluster offsets (and, in the same pass, the
//     segment offsets below), per-(chunk, cluster) cursors, then one warp
//     per chunk places its rows in ascending order (__match_any_sync
//     ranks equal codes inside a 32-row step);
//  3. the segmented sums. Each cluster's sorted rows are cut into
//     segments of S = kSegRows = 32 consecutive rows, ceil(total / S) of
//     them (segment table: seg_off, the exclusive scan of those counts,
//     and seg_cluster, each segment's cluster). One warp a segment,
//     whatever the skew (about n/S + k warps, 8 a block): lane t loads
//     the segment's t-th row id (and weight) once and the warp passes
//     them round by __shfl_sync; the lanes lie across the columns, one
//     float4 each (a row of d = 128 is one coalesced 512-byte read; wider
//     rows loop over 128-column groups; d % 4 != 0 or an unaligned x takes
//     4-byte loads, 32 columns a group, in the same order); each lane
//     issues 8 rows' loads (4 KB a warp at d = 128) before it adds them
//     in order. A segment's partial starts from +0.0 and adds its rows in
//     ascending order, one __fadd_rn a row (weighted: __fmul_rn(w, x), and
//     sum w beside it);
//  4. a cluster of one segment writes its partial straight to sums (and
//     counts); a cluster of several writes them to the scratch psums
//     [P, d] (pcounts [P] weighted), P <= 2n/S rows (only clusters of more
//     than S rows use it: 6.4 MB at n = 200k, d = 128), and one thread a
//     (cluster, column) adds that cluster's partials to +0.0 in ascending
//     segment order, 64 loads ahead of its adds, and writes 0 for an
//     empty cluster. A cluster of at most S rows therefore gets the plain
//     ascending-row sum (0 + p = p: a sum from +0.0 is never -0.0). The
//     combine's time follows the largest cluster's chain of partials;
//     without a minimum-blocks launch bound ptxas held it (and the sums
//     kernel) to 32 registers, few loads in flight;
//  5. one block sums the distances (or w*d) in a fixed order for the
//     inertia.
// Every sum has one fixed order, which lloyd_accumulate_plain repeats,
// so the result is bit-identical from run to run and to the plain
// version, weighted or not; counts are exact. The temporaries are
// O(n + chunks*k) ints at any k, with chunks*k kept at or below 2^24 by
// the wrapper, plus the n/S + k segment table and the 2n/S-row scratch.
#include <type_traits>

#include "common.cuh"

extern "C" int vq_assign(const void* x, int x_is_bf16, const float* c,
                         const float* cc, int* codes, float* dists,
                         long long n, int k, int d, void* stream);

namespace {

constexpr int kScanThreads = 1024;
constexpr int kSegRows = 32;   // S: rows a segment (cuda_kernels._SEGMENT_ROWS)
constexpr int kSumWarps = 8;   // segments a block of the sums kernel
constexpr int kInFlight = 8;   // rows a lane loads before it adds them
constexpr int kCombineInFlight = 64;  // partials a combine thread loads at once
constexpr int kCombineThreads = 256;  // (cluster, column) threads a combine block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int segments(int total) {
  return (total + kSegRows - 1) / kSegRows;
}

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

// Exclusive scans (one block) of the totals into row offsets, of the
// segment counts into seg_off (seg_off[k]: all segments), and of the
// segment counts of the clusters with more than one into pseg_off (their
// first scratch row); counts as f32.
__global__ void __launch_bounds__(kScanThreads)
    cluster_scan_kernel(const int* __restrict__ totals,
                        int* __restrict__ offsets, int* __restrict__ seg_off,
                        int* __restrict__ pseg_off, float* __restrict__ counts,
                        int k) {
  __shared__ int part[3][kScanThreads];
  const int per = (k + kScanThreads - 1) / kScanThreads;
  const int j0 = min(k, (int)threadIdx.x * per), j1 = min(k, j0 + per);
  int a = 0, b = 0, c = 0;
  for (int j = j0; j < j1; ++j) {
    const int s = segments(totals[j]);
    a += totals[j];
    b += s;
    c += s > 1 ? s : 0;
  }
  part[0][threadIdx.x] = a;
  part[1][threadIdx.x] = b;
  part[2][threadIdx.x] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run[3] = {0, 0, 0};
    for (int t = 0; t < kScanThreads; ++t) {
      for (int q = 0; q < 3; ++q) {
        const int v = part[q][t];
        part[q][t] = run[q];
        run[q] += v;
      }
    }
    seg_off[k] = run[1];
  }
  __syncthreads();
  a = part[0][threadIdx.x];
  b = part[1][threadIdx.x];
  c = part[2][threadIdx.x];
  for (int j = j0; j < j1; ++j) {
    const int s = segments(totals[j]);
    offsets[j] = a;
    seg_off[j] = b;
    pseg_off[j] = c;
    a += totals[j];
    b += s;
    c += s > 1 ? s : 0;
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
    const unsigned same = __match_any_sync(kFull, code);
    const int pos0 = valid ? cur[code] : 0;
    __syncwarp();
    if (valid) {
      perm[pos0 + __popc(same & ((1u << lane) - 1u))] = (int)r;
      if (lane == 31 - __clz(same)) cur[code] = pos0 + __popc(same);
    }
    __syncwarp();
  }
}

// One warp a cluster writes its segments' entries of seg_cluster.
__global__ void segment_table_kernel(const int* __restrict__ totals,
                                     const int* __restrict__ seg_off,
                                     int* __restrict__ seg_cluster, int k) {
  const int j = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32);
  if (j >= k) return;
  const int base = seg_off[j], cnt = segments(totals[j]);
  for (int i = threadIdx.x % 32; i < cnt; i += 32) seg_cluster[base + i] = j;
}

// A lane's columns of one row: a float4 (16-byte loads) or one float.
__device__ __forceinline__ void load_cols(float4& v, const float* p) {
  v = __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void load_cols(float& v, const float* p) {
  v = __ldg(p);
}
__device__ __forceinline__ void store_cols(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_cols(float* p, float v) { *p = v; }

template <bool kWeighted>
__device__ __forceinline__ void add_row(float& acc, float v, float wt) {
  acc = __fadd_rn(acc, kWeighted ? __fmul_rn(wt, v) : v);
}
template <bool kWeighted>
__device__ __forceinline__ void add_row(float4& acc, const float4& v,
                                        float wt) {
  add_row<kWeighted>(acc.x, v.x, wt);
  add_row<kWeighted>(acc.y, v.y, wt);
  add_row<kWeighted>(acc.z, v.z, wt);
  add_row<kWeighted>(acc.w, v.w, wt);
}

// One warp a segment: its partial sums over the segment's rows in
// ascending order (weighted: w*x, and sum w), written to sums / counts
// when the cluster has one segment, else to its scratch row.
template <bool kWeighted, bool kVec>
__global__ void __launch_bounds__(kSumWarps * 32, 1)
    segment_sum_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ perm,
                       const int* __restrict__ offsets,
                       const int* __restrict__ totals,
                       const int* __restrict__ seg_off,
                       const int* __restrict__ pseg_off,
                       const int* __restrict__ seg_cluster,
                       float* __restrict__ sums, float* __restrict__ counts,
                       float* __restrict__ psums,
                       float* __restrict__ pcounts, int k, int d) {
  using Cols = std::conditional_t<kVec, float4, float>;
  constexpr int kWidth = kVec ? 4 : 1;  // columns a lane
  const int s = blockIdx.x * kSumWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (s >= seg_off[k]) return;
  const int j = seg_cluster[s];
  const int i = s - seg_off[j], total = totals[j];
  const int m = min(kSegRows, total - i * kSegRows);  // rows, warp-uniform
  const int row = lane < m ? perm[offsets[j] + i * kSegRows + lane] : 0;
  const float wr = (kWeighted && lane < m) ? w[row] : 0.f;
  const bool direct = total <= kSegRows;
  const long long p = direct ? 0 : (long long)pseg_off[j] + i;
  float* out = direct ? sums + (size_t)j * d : psums + p * d;
  if constexpr (kWeighted) {
    float a = 0.f;
    for (int t = 0; t < m; ++t) a = __fadd_rn(a, __shfl_sync(kFull, wr, t));
    if (lane == 0) *(direct ? counts + j : pcounts + p) = a;
  }
  for (int c0 = 0; c0 < d; c0 += 32 * kWidth) {
    const int c = c0 + kWidth * lane;
    const bool on = c < d;
    Cols acc{};
    for (int t0 = 0; t0 < m; t0 += kInFlight) {
      Cols v[kInFlight];
      float wv[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int r = __shfl_sync(kFull, row, (t0 + u) % 32);
        wv[u] = kWeighted ? __shfl_sync(kFull, wr, (t0 + u) % 32) : 1.f;
        v[u] = Cols{};
        if (on && t0 + u < m) load_cols(v[u], x + (long long)r * d + c);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (t0 + u < m) add_row<kWeighted>(acc, v[u], wv[u]);
    }
    if (on) store_cols(out + c, acc);
  }
}

// One thread a (cluster, column; weighted, column d is the count): the
// partials of a cluster of several segments added to +0.0 in ascending
// segment order; 0 for an empty cluster (its count is already 0).
template <bool kWeighted>
__global__ void __launch_bounds__(kCombineThreads, 1)
    segment_combine_kernel(const int* __restrict__ totals,
                           const int* __restrict__ pseg_off,
                           const float* __restrict__ psums,
                           const float* __restrict__ pcounts,
                           float* __restrict__ sums,
                           float* __restrict__ counts, int k, int d) {
  const int width = d + (kWeighted ? 1 : 0);
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (long long)k * width) return;
  const int j = (int)(id / width), e = (int)(id % width);
  const int total = totals[j];
  if (total == 0) {
    if (e < d) sums[(size_t)j * d + e] = 0.f;
    return;
  }
  if (total <= kSegRows) return;  // written by segment_sum_kernel
  const int cnt = segments(total);
  const bool col = e < d;
  const float* src = col ? psums + (size_t)pseg_off[j] * d + e
                         : pcounts + pseg_off[j];
  const size_t stride = col ? (size_t)d : 1;
  float a = 0.f;
  int i = 0;
  for (; i + kCombineInFlight <= cnt; i += kCombineInFlight) {
    float v[kCombineInFlight];
#pragma unroll
    for (int u = 0; u < kCombineInFlight; ++u) v[u] = src[(i + u) * stride];
#pragma unroll
    for (int u = 0; u < kCombineInFlight; ++u) a = __fadd_rn(a, v[u]);
  }
  for (; i < cnt; ++i) a = __fadd_rn(a, src[i * stride]);
  if (col)
    sums[(size_t)j * d + e] = a;
  else
    counts[j] = a;
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

// max_segs bounds the segments (n / S + min(k, n)); psums holds 2n/S
// rows of d (pcounts 2n/S values, weighted only); vec: d % 4 == 0 and x
// 16-byte aligned.
extern "C" int vq_lloyd(const float* x, const float* w, const float* c,
                        const float* cc, int* codes, float* dists,
                        int* chunk_counts, int* totals, int* offsets,
                        int* perm, int* seg_off, int* pseg_off,
                        int* seg_cluster, float* psums, float* pcounts,
                        float* sums, float* counts, float* inertia,
                        long long n, int k, int d, long long rows_per_chunk,
                        int chunks, long long max_segs, int vec,
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
  cluster_scan_kernel<<<1, kScanThreads, 0, st>>>(totals, offsets, seg_off,
                                                  pseg_off, counts, k);
  chunk_cursor_kernel<<<kblk, 256, 0, st>>>(chunk_counts, offsets, k, chunks);
  chunk_scatter_kernel<<<chunks, 32, 0, st>>>(codes, chunk_counts, perm, n, k,
                                              rows_per_chunk);
  segment_table_kernel<<<(unsigned)(((long long)k * 32 + 255) / 256), 256, 0,
                         st>>>(totals, seg_off, seg_cluster, k);
  const unsigned sblk = (unsigned)((max_segs + kSumWarps - 1) / kSumWarps);
  auto sums_kernel = segment_sum_kernel<false, false>;
  if (w)
    sums_kernel = vec ? segment_sum_kernel<true, true>
                      : segment_sum_kernel<true, false>;
  else if (vec)
    sums_kernel = segment_sum_kernel<false, true>;
  sums_kernel<<<sblk, kSumWarps * 32, 0, st>>>(
      x, w, perm, offsets, totals, seg_off, pseg_off, seg_cluster, sums,
      counts, psums, pcounts, k, d);
  const long long width = (long long)d + (w ? 1 : 0);
  const unsigned cblk =
      (unsigned)(((long long)k * width + kCombineThreads - 1) / kCombineThreads);
  if (w)
    segment_combine_kernel<true><<<cblk, kCombineThreads, 0, st>>>(
        totals, pseg_off, psums, pcounts, sums, counts, k, d);
  else
    segment_combine_kernel<false><<<cblk, kCombineThreads, 0, st>>>(
        totals, pseg_off, psums, pcounts, sums, counts, k, d);
  inertia_kernel<<<1, kScanThreads, 0, st>>>(dists, w, inertia, n);
  return (int)cudaGetLastError();
}
