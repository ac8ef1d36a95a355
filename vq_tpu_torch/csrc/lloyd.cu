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
// blocks run in parallel, and per-block partial sums cost k*d*4 bytes a
// block: 32 MB at k = 65536, d = 128. So the pass groups rows by cluster
// instead, with no float atomics anywhere:
//  1. K1's assignment (vq_assign) -> codes [n], distances [n];
//  2. a stable counting sort of the row ids by code: per-chunk
//     histograms (integer atomics, in shared memory where the k counters
//     fit: exact counts), per-cluster totals, an exclusive scan into
//     cluster offsets (and, in the same pass, the segment offsets below),
//     per-(chunk, cluster) cursors, then one warp per chunk places its
//     rows in ascending order (__match_any_sync ranks equal codes inside
//     a 32-row step; the chunk's cursors in shared memory where they fit).
//     The totals and cursors walk the [chunks, k] counts column by
//     column: a block of 32 warps serves 32 clusters, each warp one of 32
//     ranges of chunks, so a walk is chunks / 32 loads long, not chunks
//     (K3 sorts 800k entries in 782 chunks at 100k rows);
//  3. the segmented sums. Each cluster's sorted rows are cut into
//     segments of S = kSegRows = 32 consecutive rows, ceil(total / S) of
//     them (segment table: seg_off, the exclusive scan of those counts,
//     and seg_cluster, each segment's cluster). A group of L lanes a
//     segment, whatever the skew: L = ceil(d / width) rounded up to a
//     power of two, at most 32, so a warp serves 32 / L segments (L = 32
//     at d = 128; L = 4 for K3's 16-wide rows). A group's lanes load the
//     segment's row ids (and weights) once, S / L each, and pass them
//     round by __shfl_sync; the lanes lie across the columns, one float4
//     each (a row of d = 128 is one coalesced 512-byte read; wider rows
//     loop over 32-lane groups of columns; d % 4 != 0 or an unaligned x
//     takes 4-byte loads, one column a lane, in the same order); each lane
//     issues 8 rows' loads before it adds them in order. A segment's
//     partial starts from +0.0 and adds its rows in ascending order, one
//     __fadd_rn a row (weighted: __fmul_rn(w, x), and sum w beside it);
//     the layout of lanes does not change a bit of it;
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
//     inertia: thread t of 1024 adds terms t, t + 1024, ... in ascending
//     order, then the halves fold pairwise.
// Steps 2-4 are one entry point, vq_segment_sums, over any rows, labels
// and cluster count: K3 (pq_lloyd.cu) runs it over the [n*m, s] view of
// its x with m*k clusters. Step 5 is vq_inertia_sum, which K3 also calls
// on its block partials. Every sum has one fixed order, which
// lloyd_accumulate_plain repeats (cuda_kernels._segment_sums_plain and
// _k2_inertia), so the result is bit-identical from run to run and to the
// plain version, weighted or not; counts are exact. The temporaries are
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
constexpr int kColWarps = 32;  // chunk ranges a block of the column walks
constexpr int kColBatch = 8;   // loads a column walk issues before it adds
constexpr int kSharedCells = 12 * 1024;  // k at most, for per-chunk counts in shared memory

__device__ __forceinline__ int segments(int total) {
  return (total + kSegRows - 1) / kSegRows;
}

// Per-chunk histograms: in shared memory, every entry of the chunk's row
// written, where the k counters fit (kShared); else integer atomics on
// the chunk's row of chunk_counts, zeroed beforehand.
template <bool kShared>
__global__ void chunk_hist_kernel(const int* __restrict__ codes,
                                  int* __restrict__ chunk_counts, long long n,
                                  int k, long long rows_per_chunk) {
  extern __shared__ int hist[];
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  int* row = chunk_counts + (size_t)blockIdx.x * k;
  int* cnt = kShared ? hist : row;
  if constexpr (kShared) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) hist[j] = 0;
    __syncthreads();
  }
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x)
    atomicAdd(&cnt[codes[r]], 1);
  if constexpr (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < k; j += blockDim.x) row[j] = hist[j];
  }
}

// The column walks below (totals, cursors): a block of kColWarps warps
// serves 32 clusters, lane = cluster, and warp w walks chunks
// [c0, c1), the w-th of kColWarps equal ranges, kColBatch loads ahead.
__device__ __forceinline__ void chunk_range(int chunks, int& c0, int& c1) {
  const int per = (chunks + kColWarps - 1) / kColWarps;
  c0 = min(chunks, (int)(threadIdx.x / 32) * per);
  c1 = min(chunks, c0 + per);
}

__device__ __forceinline__ int column_sum(const int* __restrict__ counts,
                                          int j, int k, int c0, int c1) {
  int a = 0, c = c0;
  for (; c + kColBatch <= c1; c += kColBatch) {
    int v[kColBatch];
#pragma unroll
    for (int u = 0; u < kColBatch; ++u) v[u] = counts[(size_t)(c + u) * k + j];
#pragma unroll
    for (int u = 0; u < kColBatch; ++u) a += v[u];
  }
  for (; c < c1; ++c) a += counts[(size_t)c * k + j];
  return a;
}

__global__ void __launch_bounds__(kColWarps * 32)
    cluster_totals_kernel(const int* __restrict__ chunk_counts,
                          int* __restrict__ totals, int k, int chunks) {
  __shared__ int part[kColWarps][32];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + lane;
  int c0, c1;
  chunk_range(chunks, c0, c1);
  part[wid][lane] = j < k ? column_sum(chunk_counts, j, k, c0, c1) : 0;
  __syncthreads();
  if (wid == 0 && j < k) {
    int a = 0;
    for (int w = 0; w < kColWarps; ++w) a += part[w][lane];
    totals[j] = a;
  }
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Exclusive scans (one block) of the totals into row offsets, of the
// segment counts into seg_off (seg_off[k]: all segments), and of the
// segment counts of the clusters with more than one into pseg_off (their
// first scratch row); counts as f32. Thread t sums a range of clusters;
// the ranges' sums are scanned by warp shuffles, then across warps.
__global__ void __launch_bounds__(kScanThreads)
    cluster_scan_kernel(const int* __restrict__ totals,
                        int* __restrict__ offsets, int* __restrict__ seg_off,
                        int* __restrict__ pseg_off, float* __restrict__ counts,
                        int k) {
  __shared__ int wsum[3][kScanThreads / 32];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int per = (k + kScanThreads - 1) / kScanThreads;
  const int j0 = min(k, (int)threadIdx.x * per), j1 = min(k, j0 + per);
  int v[3] = {0, 0, 0}, incl[3];
  for (int j = j0; j < j1; ++j) {
    const int s = segments(totals[j]);
    v[0] += totals[j];
    v[1] += s;
    v[2] += s > 1 ? s : 0;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    incl[q] = warp_inclusive_scan(v[q], lane);
    if (lane == 31) wsum[q][wid] = incl[q];
  }
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int w = wsum[q][lane], iw = warp_inclusive_scan(w, lane);
      wsum[q][lane] = iw - w;
      if (q == 1 && lane == 31) seg_off[k] = iw;
    }
  }
  __syncthreads();
  int a = wsum[0][wid] + incl[0] - v[0];
  int b = wsum[1][wid] + incl[1] - v[1];
  int c = wsum[2][wid] + incl[2] - v[2];
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
__global__ void __launch_bounds__(kColWarps * 32)
    chunk_cursor_kernel(int* __restrict__ chunk_counts,
                        const int* __restrict__ offsets, int k, int chunks) {
  __shared__ int part[kColWarps][32];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + lane;
  int c0, c1;
  chunk_range(chunks, c0, c1);
  part[wid][lane] = j < k ? column_sum(chunk_counts, j, k, c0, c1) : 0;
  __syncthreads();
  if (wid == 0 && j < k) {
    int run = offsets[j];
    for (int w = 0; w < kColWarps; ++w) {
      const int v = part[w][lane];
      part[w][lane] = run;
      run += v;
    }
  }
  __syncthreads();
  if (j >= k) return;
  int run = part[wid][lane], c = c0;
  for (; c + kColBatch <= c1; c += kColBatch) {
    int v[kColBatch];
#pragma unroll
    for (int u = 0; u < kColBatch; ++u) v[u] = chunk_counts[(size_t)(c + u) * k + j];
#pragma unroll
    for (int u = 0; u < kColBatch; ++u) {
      chunk_counts[(size_t)(c + u) * k + j] = run;
      run += v[u];
    }
  }
  for (; c < c1; ++c) {
    const int v = chunk_counts[(size_t)c * k + j];
    chunk_counts[(size_t)c * k + j] = run;
    run += v;
  }
}

// One warp per chunk walks its rows 32 at a time in ascending order:
// lanes with equal codes rank by lane, so each cluster's rows land in
// ascending row order. The chunk's cursors are copied to shared memory
// first where they fit (kShared), and the codes are loaded kAhead steps
// ahead, so a step waits on no global load.
template <bool kShared>
__global__ void chunk_scatter_kernel(const int* __restrict__ codes,
                                     int* __restrict__ cursors,
                                     int* __restrict__ perm, long long n,
                                     int k, long long rows_per_chunk) {
  extern __shared__ int scur[];
  const int lane = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  int* cur = cursors + (size_t)blockIdx.x * k;
  if constexpr (kShared) {
    int j = lane;
    for (; j + 32 * (kColBatch - 1) < k; j += 32 * kColBatch) {
      int v[kColBatch];
#pragma unroll
      for (int u = 0; u < kColBatch; ++u) v[u] = cur[j + 32 * u];
#pragma unroll
      for (int u = 0; u < kColBatch; ++u) scur[j + 32 * u] = v[u];
    }
    for (; j < k; j += 32) scur[j] = cur[j];
    __syncwarp();
    cur = scur;
  }
  constexpr int kAhead = kColBatch;  // 32-row steps whose codes are loaded ahead
  int code[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const long long r = r0 + 32 * u + lane;
    code[u] = r < r1 ? codes[r] : -1;
  }
  for (long long base = r0; base < r1; base += 32 * kAhead) {
    int next[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long r = base + 32 * (kAhead + u) + lane;
      next[u] = r < r1 ? codes[r] : -1;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long r = base + 32 * u + lane;
      const bool valid = r < r1;
      const unsigned same = __match_any_sync(kFull, code[u]);
      const int pos0 = valid ? cur[code[u]] : 0;
      __syncwarp();
      if (valid) {
        perm[pos0 + __popc(same & ((1u << lane) - 1u))] = (int)r;
        if (lane == 31 - __clz(same)) cur[code[u]] = pos0 + __popc(same);
      }
      __syncwarp();
      code[u] = next[u];
    }
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

// A group of kLanes lanes a segment (32 / kLanes segments a warp): its
// partial sums over the segment's rows in ascending order (weighted: w*x,
// and sum w), written to sums / counts when the cluster has one segment,
// else to its scratch row. Position t's row id is held by lane t % kLanes
// of the group, in ids[t / kLanes]; every loop over t is unrolled, so the
// index is a constant, and every lane takes part in every shuffle.
template <bool kWeighted, bool kVec, int kLanes>
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
  constexpr int kGroups = 32 / kLanes;  // segments a warp
  constexpr int kIds = kSegRows / kLanes;  // row ids a lane holds
  const int lane = threadIdx.x % 32, gl = lane % kLanes;
  const int src0 = lane - gl;  // the group's first lane
  const long long s0 =
      ((long long)blockIdx.x * kSumWarps + threadIdx.x / 32) * kGroups;
  const long long s = s0 + lane / kLanes;
  const int nseg = seg_off[k];
  if (s0 >= nseg) return;  // the whole warp
  const bool live = s < nseg;
  int j = 0, m = 0, pos0 = 0;
  if (live) {
    j = seg_cluster[s];
    const int i = (int)(s - seg_off[j]);
    m = min(kSegRows, totals[j] - i * kSegRows);  // rows, group-uniform
    pos0 = offsets[j] + i * kSegRows;
  }
  int ids[kIds];
  float wts[kIds];
#pragma unroll
  for (int u = 0; u < kIds; ++u) {
    const int t = gl + u * kLanes;
    ids[u] = t < m ? perm[pos0 + t] : 0;
    wts[u] = (kWeighted && t < m) ? w[ids[u]] : 0.f;
  }
  const int mmax = __reduce_max_sync(kFull, m);
  const bool direct = live && totals[j] <= kSegRows;
  const long long p = (live && !direct) ? (long long)pseg_off[j] + (s - seg_off[j]) : 0;
  float* out = direct ? sums + (size_t)j * d : psums + p * d;
  if constexpr (kWeighted) {
    float a = 0.f;
#pragma unroll
    for (int t = 0; t < kSegRows; ++t) {
      const float wt = __shfl_sync(kFull, wts[t / kLanes], src0 + t % kLanes);
      if (t < m) a = __fadd_rn(a, wt);
    }
    if (live && gl == 0) *(direct ? counts + j : pcounts + p) = a;
  }
  for (int c0 = 0; c0 < d; c0 += kLanes * kWidth) {
    const int c = c0 + kWidth * gl;
    const bool on = live && c < d;
    Cols acc{};
#pragma unroll
    for (int t0 = 0; t0 < kSegRows; t0 += kInFlight) {
      if (t0 >= mmax) break;
      Cols v[kInFlight];
      float wv[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int t = t0 + u, src = src0 + t % kLanes;
        const int r = __shfl_sync(kFull, ids[t / kLanes], src);
        wv[u] = kWeighted ? __shfl_sync(kFull, wts[t / kLanes], src) : 1.f;
        v[u] = Cols{};
        if (on && t < m) load_cols(v[u], x + (long long)r * d + c);
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

template <bool kWeighted, bool kVec>
void launch_segment_sums(int lanes, unsigned segs, cudaStream_t st,
                         const float* x, const float* w, const int* perm,
                         const int* offsets, const int* totals,
                         const int* seg_off, const int* pseg_off,
                         const int* seg_cluster, float* sums, float* counts,
                         float* psums, float* pcounts, int k, int d) {
  auto kernel = segment_sum_kernel<kWeighted, kVec, 32>;
  switch (lanes) {
    case 1: kernel = segment_sum_kernel<kWeighted, kVec, 1>; break;
    case 2: kernel = segment_sum_kernel<kWeighted, kVec, 2>; break;
    case 4: kernel = segment_sum_kernel<kWeighted, kVec, 4>; break;
    case 8: kernel = segment_sum_kernel<kWeighted, kVec, 8>; break;
    case 16: kernel = segment_sum_kernel<kWeighted, kVec, 16>; break;
  }
  const unsigned groups = 32 / lanes;
  const unsigned blocks = (segs + groups * kSumWarps - 1) / (groups * kSumWarps);
  kernel<<<blocks, kSumWarps * 32, 0, st>>>(x, w, perm, offsets, totals, seg_off,
                                            pseg_off, seg_cluster, sums, counts,
                                            psums, pcounts, k, d);
}

}  // namespace

// Steps 2-4 over rows x [rows, d] f32 (weights w [rows], null for none)
// labelled labels [rows] in [0, k): sums [k, d] and counts [k].
// max_segs bounds the segments (rows / S + min(k, rows)); psums holds
// 2 rows / S rows of d (pcounts 2 rows / S values, weighted only); vec:
// d % 4 == 0 and x 16-byte aligned.
extern "C" int vq_segment_sums(const float* x, const float* w,
                               const int* labels, int* chunk_counts,
                               int* totals, int* offsets, int* perm,
                               int* seg_off, int* pseg_off, int* seg_cluster,
                               float* psums, float* pcounts, float* sums,
                               float* counts, long long rows, int k, int d,
                               long long rows_per_chunk, int chunks,
                               long long max_segs, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = k <= kSharedCells;
  const size_t smem = shared ? (size_t)k * sizeof(int) : 0;
  if (shared) {
    chunk_hist_kernel<true><<<chunks, 256, smem, st>>>(labels, chunk_counts,
                                                       rows, k, rows_per_chunk);
  } else {
    int err = (int)cudaMemsetAsync(chunk_counts, 0,
                                   (size_t)chunks * k * sizeof(int), st);
    if (err != 0) return err;
    chunk_hist_kernel<false><<<chunks, 256, 0, st>>>(labels, chunk_counts, rows,
                                                     k, rows_per_chunk);
  }
  const unsigned cblk32 = (unsigned)((k + 31) / 32);
  cluster_totals_kernel<<<cblk32, kColWarps * 32, 0, st>>>(chunk_counts, totals,
                                                           k, chunks);
  cluster_scan_kernel<<<1, kScanThreads, 0, st>>>(totals, offsets, seg_off,
                                                  pseg_off, counts, k);
  chunk_cursor_kernel<<<cblk32, kColWarps * 32, 0, st>>>(chunk_counts, offsets,
                                                         k, chunks);
  if (shared)
    chunk_scatter_kernel<true><<<chunks, 32, smem, st>>>(
        labels, chunk_counts, perm, rows, k, rows_per_chunk);
  else
    chunk_scatter_kernel<false><<<chunks, 32, 0, st>>>(
        labels, chunk_counts, perm, rows, k, rows_per_chunk);
  segment_table_kernel<<<(unsigned)(((long long)k * 32 + 255) / 256), 256, 0,
                         st>>>(totals, seg_off, seg_cluster, k);
  const int width = vec ? 4 : 1;
  int lanes = 1;
  while (lanes < 32 && lanes * width < d) lanes *= 2;
  if (w)
    (vec ? launch_segment_sums<true, true> : launch_segment_sums<true, false>)(
        lanes, (unsigned)max_segs, st, x, w, perm, offsets, totals, seg_off, pseg_off,
        seg_cluster, sums, counts, psums, pcounts, k, d);
  else
    (vec ? launch_segment_sums<false, true> : launch_segment_sums<false, false>)(
        lanes, (unsigned)max_segs, st, x, w, perm, offsets, totals, seg_off, pseg_off,
        seg_cluster, sums, counts, psums, pcounts, k, d);
  const long long cwidth = (long long)d + (w ? 1 : 0);
  const unsigned cblk =
      (unsigned)(((long long)k * cwidth + kCombineThreads - 1) / kCombineThreads);
  if (w)
    segment_combine_kernel<true><<<cblk, kCombineThreads, 0, st>>>(
        totals, pseg_off, psums, pcounts, sums, counts, k, d);
  else
    segment_combine_kernel<false><<<cblk, kCombineThreads, 0, st>>>(
        totals, pseg_off, psums, pcounts, sums, counts, k, d);
  return (int)cudaGetLastError();
}

// Step 5: *out = the sum of terms [n] (w*terms where w is not null) in
// its fixed order.
extern "C" int vq_inertia_sum(const float* terms, const float* w, float* out,
                              long long n, void* stream) {
  inertia_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      terms, w, out, n);
  return (int)cudaGetLastError();
}

extern "C" int vq_lloyd(const float* x, const float* w, const float* c,
                        const float* cc, int* codes, float* dists,
                        int* chunk_counts, int* totals, int* offsets,
                        int* perm, int* seg_off, int* pseg_off,
                        int* seg_cluster, float* psums, float* pcounts,
                        float* sums, float* counts, float* inertia,
                        long long n, int k, int d, long long rows_per_chunk,
                        int chunks, long long max_segs, int vec,
                        void* stream) {
  int err = vq_assign(x, 0, c, cc, codes, dists, n, k, d, stream);
  if (err != 0) return err;
  err = vq_segment_sums(x, w, codes, chunk_counts, totals, offsets, perm,
                        seg_off, pseg_off, seg_cluster, psums, pcounts, sums,
                        counts, n, k, d, rows_per_chunk, chunks, max_segs, vec,
                        stream);
  if (err != 0) return err;
  return vq_inertia_sum(dists, w, inertia, n, stream);
}
