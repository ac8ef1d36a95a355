// K3: one Lloyd pass of PQ training for all m subspaces. x [n, m*s] f32
// against codebooks [m, k, s] -> sums [m, k, s], counts [m, k] (f32,
// exact integers) and the total inertia sum(max(min_score + ||x_s||^2, 0)).
//
// Replaces vq_tpu/ops/pallas_kernels.py::_pq_lloyd_acc_kernel (reached
// through pq_lloyd_accumulate_fused / _pq_lloyd_accumulate_jit).
//
// What bounds it on the card: the assignment, as in K4 (2*n*m*k*s FP32
// instructions, no FMA). The sums stage after it is bound by bytes: x,
// the codes and the minimum scores read once, the sums written once
// (n*m*(s + 2)*4 + m*k*s*4 bytes: 0.017 ms at 100k x 8x256x16 and
// 3.35 TB/s).
//
// Design: the TPU grid ran in order and carried the sums in VMEM from
// one step to the next. Hopper blocks run in parallel. K3's sums are K2's
// sums problem: read x [n, m*s] as [n*m, s], entry q = r*m + i being row
// r's subspace i, and give it the label i*k + code[r, i]; the sums and
// counts are then K2's over m*k clusters of s-wide rows, and within a
// cluster ascending entry order is ascending row order. So the pass is
// four steps, with no float atomics anywhere:
//  1. K4's register-tiled scan (pq_scan, pq_encode.cu) writes each row's
//     code [n, m] i32 and its minimum score [n, m] f32, the exact float
//     of the winning key;
//  2. pq_terms_kernel turns each code into its label, in place, and sums
//     the inertia terms t = minval + xx (xx = ||x_s||^2 from +0.0 in
//     ascending e, one __fmul_rn and __fadd_rn an entry; a NaN t is kept,
//     any other clamped at 0): block b owns terms [1024 b, 1024 (b + 1)),
//     thread t of 256 adds terms 1024 b + t + 256 u in ascending u from
//     +0.0, and the 256 partials fold pairwise in halves;
//  3. K2's sums stage (vq_segment_sums, lloyd.cu) over the [n*m, s] view
//     with those labels: counting sort, segment table, one group of 4
//     lanes a 32-entry segment (a float4 each at s = 16), partials
//     combined in ascending segment order;
//  4. K2's inertia sum (vq_inertia_sum, lloyd.cu) over the block partials.
// Every sum has one fixed order, which pq_lloyd_accumulate_plain repeats
// (cuda_kernels._segment_sums_plain and _k3_inertia), so sums, counts and
// inertia are bit-identical to the plain version and from run to run.
// The scratch is O(n*m) ints, the (chunk, cluster) cursors (at most 2^24)
// and at most 2*n*m/32 partial rows of s floats: no per-block copies of
// the [m, k, s] sums.
#include "common.cuh"

using namespace vqk;

extern "C" int vq_segment_sums(const float* x, const float* w,
                               const int* labels, int* chunk_counts,
                               int* totals, int* offsets, int* perm,
                               int* seg_off, int* pseg_off, int* seg_cluster,
                               float* psums, float* pcounts, float* sums,
                               float* counts, long long rows, int k, int d,
                               long long rows_per_chunk, int chunks,
                               long long max_segs, int vec, void* stream);
extern "C" int vq_inertia_sum(const float* terms, const float* w, float* out,
                              long long n, void* stream);

namespace {

constexpr int kTermThreads = 256;  // cuda_kernels._K3_TERM_THREADS
constexpr int kTermsPerThread = 4;
constexpr int kBlockTerms = kTermThreads * kTermsPerThread;  // _K3_BLOCK_TERMS

// ||x_s||^2 of one entry: from +0.0 in ascending e, each square rounded.
template <bool kVec>
__device__ __forceinline__ float sq_norm(const float* __restrict__ xs, int s) {
  float xx = 0.f;
  if constexpr (kVec) {
    for (int e = 0; e < s; e += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xs + e));
      xx = __fadd_rn(xx, __fmul_rn(v.x, v.x));
      xx = __fadd_rn(xx, __fmul_rn(v.y, v.y));
      xx = __fadd_rn(xx, __fmul_rn(v.z, v.z));
      xx = __fadd_rn(xx, __fmul_rn(v.w, v.w));
    }
  } else {
    for (int e = 0; e < s; ++e) xx = __fadd_rn(xx, __fmul_rn(xs[e], xs[e]));
  }
  return xx;
}

// Labels in place (code + i*k for entry q = r*m + i) and one inertia
// partial a block of kBlockTerms entries.
template <bool kVec>
__global__ void __launch_bounds__(kTermThreads, 1)
    pq_terms_kernel(const float* __restrict__ x,
                    const float* __restrict__ minval, int* __restrict__ labels,
                    float* __restrict__ partials, long long terms, int m,
                    int k, int s) {
  __shared__ float red[kTermThreads];
  const long long q0 = (long long)blockIdx.x * kBlockTerms + threadIdx.x;
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < kTermsPerThread; ++u) {
    const long long q = q0 + (long long)u * kTermThreads;
    if (q < terms) {
      labels[q] += (int)(q % m) * k;
      const float t = __fadd_rn(minval[q], sq_norm<kVec>(x + q * s, s));
      acc = __fadd_rn(acc, isnan(t) ? t : fmaxf(t, 0.f));
    }
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kTermThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
}

}  // namespace

// codes / minval [n*m] and partials [ceil(n*m / 1024)] are scratch (codes
// end as labels); the segment-sum scratch and sizes are vq_segment_sums'
// at n*m rows of s and m*k clusters; vec: s % 4 == 0 and x 16-byte
// aligned.
extern "C" int vq_pq_lloyd(const float* x, const float* cb, const float* cc,
                           int* codes, float* minval, float* partials,
                           int* chunk_counts, int* totals, int* offsets,
                           int* perm, int* seg_off, int* pseg_off,
                           int* seg_cluster, float* psums, float* sums,
                           float* counts, float* inertia, long long n, int m,
                           int k, int s, int resident, int stages, int smem,
                           long long scan_rows, long long rows_per_chunk,
                           int chunks, long long max_segs, int vec,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = pq_scan(x, false, cb, cc, codes, minval, n, m, k, s, resident != 0,
                    stages, smem, scan_rows, st);
  if (err != 0) return err;
  const long long terms = n * m;
  const unsigned blocks = (unsigned)((terms + kBlockTerms - 1) / kBlockTerms);
  if (vec)
    pq_terms_kernel<true><<<blocks, kTermThreads, 0, st>>>(
        x, minval, codes, partials, terms, m, k, s);
  else
    pq_terms_kernel<false><<<blocks, kTermThreads, 0, st>>>(
        x, minval, codes, partials, terms, m, k, s);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = vq_segment_sums(x, nullptr, codes, chunk_counts, totals, offsets, perm,
                        seg_off, pseg_off, seg_cluster, psums, nullptr, sums,
                        counts, terms, m * k, s, rows_per_chunk, chunks,
                        max_segs, vec, stream);
  if (err != 0) return err;
  return vq_inertia_sum(partials, nullptr, inertia, blocks, stream);
}
