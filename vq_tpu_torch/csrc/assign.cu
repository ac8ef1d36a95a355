// K1: nearest-centroid assignment. x [n, d] (f32 or bf16) against
// centroids [k, d] f32 -> codes [n] i32 and sq_dists [n] f32, where the
// code is the int2 argmin of ||c||^2 - 2 x.c and the distance is
// max(min_score + ||x||^2, 0) (NaN passes through).
//
// Replaces vq_tpu/ops/pallas_kernels.py::_assign_kernel (reached through
// assign_fused / _assign_fused_jit, and _assign_fused_chunked_jit for
// codebooks past the TPU's VMEM budget).
//
// What bounds it on the card: n*k*d multiply/add pairs in exact fp32 on
// the CUDA cores, each a separately rounded multiply and add (no FMA, no
// tensor cores: TF32 or bf16 would move argmins near ties). At
// 1M x 1024 x 128 that is 1.3e11 pairs, about 2.7e11 instructions, so
// instruction throughput bounds the kernel; x (512 MB) and the codebook
// are read from L2 once per centroid tile.
//
// Design: a block owns 64 rows and walks ALL k centroids in tiles of 64
// inside one launch (the TPU ran one launch per VMEM-sized centroid
// chunk and merged them). Each thread holds a 4 x 4 register tile of
// dots (rows ty + 16i, centroids tx + 16j), built from 32-wide slices of
// x and of the centroid tile staged in shared memory, and keeps a
// running (key, index) minimum for its 4 rows. The dot of each pair is
// summed in ascending e, one rounded multiply and add at a time, which
// is what the plain version computes. Each thread visits its centroids
// in ascending order with a strict < from key INT_MAX at index 0; the
// 16 threads of a row then merge by the lexicographic (key, index)
// minimum. That is the int2 rule over the whole row, whatever the
// merge order, so there is no cross-chunk tie question at any k.
// Minima are compared unclamped; ||x||^2 is added and clamped once, at
// the end. Every k and d run: the tiles mask the ragged edges.
#include "common.cuh"

using namespace vqk;

namespace {

constexpr int kBM = 64;  // rows per block
constexpr int kBN = 64;  // centroids per tile
constexpr int kBK = 32;  // dimensions per staged slice
constexpr int kT = 4;    // register tile: kT rows x kT centroids a thread
constexpr int kAssignThreads = (kBM / kT) * (kBN / kT);  // 256

template <typename T>
__global__ void __launch_bounds__(kAssignThreads)
    assign_kernel(const T* __restrict__ x, const float* __restrict__ c,
                  const float* __restrict__ cc, int* __restrict__ codes,
                  float* __restrict__ dists, long long n, int k, int d) {
  // +1 column of padding: the transposing stores hit 32 distinct banks.
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float cs[kBK][kBN + 1];
  __shared__ int red_key[kBM][kBN / kT];
  __shared__ int red_idx[kBM][kBN / kT];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kT);  // centroid lane: tx + 16j
  const int ty = tid / (kBN / kT);  // row lane: ty + 16i
  const long long row0 = (long long)blockIdx.x * kBM;

  int best_key[kT], best_idx[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    best_key[i] = INT_MAX;
    best_idx[i] = 0;
  }
  float xx = 0.f;  // ||x||^2 of row tid (threads tid < kBM)

  for (int j0 = 0; j0 < k; j0 += kBN) {
    float acc[kT][kT];
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < kT; ++j) acc[i][j] = 0.f;
    for (int e0 = 0; e0 < d; e0 += kBK) {
      const int ecnt = min(kBK, d - e0);
      __syncthreads();
      for (int t = tid; t < kBM * kBK; t += kAssignThreads) {
        const int r = t / kBK, e = t % kBK;
        const long long row = row0 + r;
        xs[e][r] = (row < n && e < ecnt) ? to_f32(x[row * d + e0 + e]) : 0.f;
      }
      for (int t = tid; t < kBN * kBK; t += kAssignThreads) {
        const int jj = t / kBK, e = t % kBK;
        cs[e][jj] = (j0 + jj < k && e < ecnt)
                        ? c[(long long)(j0 + jj) * d + e0 + e]
                        : 0.f;
      }
      __syncthreads();
      if (j0 == 0 && tid < kBM)
        for (int e = 0; e < ecnt; ++e)
          xx = __fadd_rn(xx, __fmul_rn(xs[e][tid], xs[e][tid]));
      for (int e = 0; e < ecnt; ++e) {
        float xv[kT], cv[kT];
#pragma unroll
        for (int i = 0; i < kT; ++i) xv[i] = xs[e][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kT; ++j) cv[j] = cs[e][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kT; ++i)
#pragma unroll
          for (int j = 0; j < kT; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xv[i], cv[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int col = j0 + tx + 16 * j;
      if (col >= k) continue;
      const float ccj = cc[col];
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        const int key =
            orderable_key(__fsub_rn(ccj, __fmul_rn(2.0f, acc[i][j])));
        if (key < best_key[i]) {
          best_key[i] = key;
          best_idx[i] = col;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kT; ++i) {
    red_key[ty + 16 * i][tx] = best_key[i];
    red_idx[ty + 16 * i][tx] = best_idx[i];
  }
  __syncthreads();
  const long long row = row0 + tid;
  if (tid < kBM && row < n) {
    int bk = red_key[tid][0], bi = red_idx[tid][0];
    for (int t = 1; t < kBN / kT; ++t) {
      const int key = red_key[tid][t], idx = red_idx[tid][t];
      if (key < bk || (key == bk && idx < bi)) {
        bk = key;
        bi = idx;
      }
    }
    const float t = __fadd_rn(key_to_f32(bk), xx);
    codes[row] = bi;
    dists[row] = isnan(t) ? t : fmaxf(t, 0.f);
  }
}

}  // namespace

extern "C" int vq_assign(const void* x, int x_is_bf16, const float* c,
                         const float* cc, int* codes, float* dists,
                         long long n, int k, int d, void* stream) {
  const unsigned nblk = (unsigned)((n + kBM - 1) / kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    assign_kernel<__nv_bfloat16><<<nblk, kAssignThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), c, cc, codes, dists, n, k, d);
  } else {
    assign_kernel<float><<<nblk, kAssignThreads, 0, st>>>(
        static_cast<const float*>(x), c, cc, codes, dists, n, k, d);
  }
  return (int)cudaGetLastError();
}
