// B2, B3, B4: three designs of K8's function, the dense ADC table sum
// out[q, j] = sum over i of tables[q, i, codes_t[i, j]] (tables [Q, m, k]
// f32, codes_t [m, n] u8, out [Q, n] f32, added from +0.0 in ascending
// subspace order), and the bytes floor of its output.
//
// Replace benchmarks/adc_vmem_bench.py::_adc_kt_kernel (B2, the call at
// :79), ::_adc_gather_kernel (B3, :136) and ::_adc_floor_kernel (B4,
// :173).
//
// What bounds them on the card: the [Q, n] f32 output. At Q = 128 over
// 1M rows that is 512 MB written against 8 MB of codes and 1 MB of
// tables read, 0.156 ms at 3.35 TB/s; the Q*n*m = 1.0 G additions are
// 16 us at 67 TFLOP/s. B2's one-hot products are 3 * 2*Q*k*n*m = 1.57
// TFLOP of bf16, so its own design floor is 1.6 ms at 989 TFLOP/s.
//
// B2 (adc_kt_kernel), the experiment's matmul design on the tensor cores.
// The wrapper splits the tables once into three bf16 parts, hi = bf(t),
// mid = bf(t - hi), lo = bf(t - hi - mid) (exact for finite normal f32),
// zero-padded to 16 queries and 16 entries. A block owns 64 corpus rows
// and 128 queries (grid.y covers more); warp w owns the 16-query tile w.
// For each subspace the block writes the one-hot [64, kp] bf16 operand
// of its rows into shared memory, and each warp runs three products per
// 16 x 16 output tile, one a part, into fresh zeroed fragments: a one-hot
// row picks exactly one entry, so each product is exact. Elementwise,
// (hi + mid) + lo gives the f32 entry back and acc + entry runs in
// subspace order, so B2 matches its plain version, B3 and K8 bit for bit
// on finite tables. A code >= k matches no one-hot column and adds 0, as
// on the TPU. The tile goes through shared memory to the output, so a
// ragged Q or n stores only what exists.
//
// B3 (adc_gather_kernel), the gather design. The tables of a group of at
// most 8 queries sit in shared memory, as in K8 (read from device memory
// when one query's table does not fit). Each thread owns 4 consecutive
// rows: it reads one u32 of codes_t a subspace (coalesced, thanks to the
// [m, n] layout), keeps 4 x group sums in registers, added from +0.0 in
// subspace order, and writes float4s. `subspaces` < m stops early (the
// script's `only`). A code >= k adds 0.0, K8's rule.
//
// B4 (adc_floor_kernel): the same I/O with no lookup,
// out[q, j] = f32(codes_t[0, j]) + tables[0, 0, 0] for every q, one u32
// of codes read and float4s written: the card's practical floor for K8's
// output.
#include "common.cuh"

#include <mma.h>

namespace {

constexpr int kKtRows = 64;     // corpus rows a B2 block
constexpr int kKtWarps = 8;     // 16-query tiles a B2 block
constexpr int kKtStage = 16 * kKtRows;  // f32 staging a warp
constexpr int kGatherMax = 8;   // queries a B3 group, at most
constexpr int kRowsPerThread = 4;

__device__ __forceinline__ void load4(const unsigned char* __restrict__ row, long long j,
                                      long long n, bool vec, int c[4]) {
  if (vec) {
    const unsigned v = *reinterpret_cast<const unsigned*>(row + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = (v >> (8 * e)) & 0xFF;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = j + e < n ? row[j + e] : 0;
  }
}

__device__ __forceinline__ void store4(float* __restrict__ out, long long j, long long n,
                                       bool vec, const float v[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(out + j) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j + e < n) out[j + e] = v[e];
  }
}

__global__ void __launch_bounds__(256, 2)
    adc_kt_kernel(const __nv_bfloat16* __restrict__ hi, const __nv_bfloat16* __restrict__ mid,
                  const __nv_bfloat16* __restrict__ lo, const unsigned char* __restrict__ codes_t,
                  float* __restrict__ out, int nq, int m, int k, int kp, long long n) {
  using namespace nvcuda;
  using AFrag = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using BFrag = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
  using CFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldo = kp + 8;  // one-hot row pitch (bf16)
  __nv_bfloat16* onehot = reinterpret_cast<__nv_bfloat16*>(smem);
  float* stage = reinterpret_cast<float*>(smem + (size_t)kKtRows * ldo * 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long j0 = (long long)blockIdx.x * kKtRows;
  const int qt = blockIdx.y * kKtWarps + warp;
  const bool active = qt * 16 < nq;
  const long long ldt = (long long)m * kp;  // query pitch of a table part
  const __nv_bfloat16* parts[3] = {hi, mid, lo};
  CFrag acc[kKtRows / 16];
#pragma unroll
  for (int t = 0; t < kKtRows / 16; ++t) wmma::fill_fragment(acc[t], 0.f);
  const int chunks = kp / 8;  // 16-byte chunks a one-hot row
  for (int i = 0; i < m; ++i) {
    __syncthreads();
    for (int t = threadIdx.x; t < kKtRows * chunks; t += blockDim.x) {
      const int r = t / chunks, c0 = (t % chunks) * 8;
      const long long j = j0 + r;
      const int code = j < n ? (int)codes_t[(long long)i * n + j] : -1;
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = __float2bfloat16_rn(code == c0 + e && code < k ? 1.f : 0.f);
      *reinterpret_cast<uint4*>(onehot + r * ldo + c0) = *reinterpret_cast<const uint4*>(v);
    }
    __syncthreads();
    if (!active) continue;
    CFrag sum[kKtRows / 16], part[kKtRows / 16];
    for (int p = 0; p < 3; ++p) {
      const __nv_bfloat16* tab = parts[p] + (long long)qt * 16 * ldt + (long long)i * kp;
#pragma unroll
      for (int t = 0; t < kKtRows / 16; ++t) wmma::fill_fragment(part[t], 0.f);
      for (int kk = 0; kk < kp; kk += 16) {
        AFrag af;
        wmma::load_matrix_sync(af, tab + kk, (unsigned)ldt);
#pragma unroll
        for (int t = 0; t < kKtRows / 16; ++t) {
          BFrag bf;
          wmma::load_matrix_sync(bf, onehot + t * 16 * ldo + kk, ldo);
          wmma::mma_sync(part[t], af, bf, part[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kKtRows / 16; ++t) {
        if (p == 0) {
          sum[t] = part[t];
        } else {
#pragma unroll
          for (int e = 0; e < sum[t].num_elements; ++e)
            sum[t].x[e] = __fadd_rn(sum[t].x[e], part[t].x[e]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kKtRows / 16; ++t)
#pragma unroll
      for (int e = 0; e < acc[t].num_elements; ++e)
        acc[t].x[e] = __fadd_rn(acc[t].x[e], sum[t].x[e]);
  }
  if (!active) return;
  float* st = stage + warp * kKtStage;
#pragma unroll
  for (int t = 0; t < kKtRows / 16; ++t)
    wmma::store_matrix_sync(st + t * 16, acc[t], kKtRows, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < kKtStage; e += 32) {
    const int q = qt * 16 + e / kKtRows;
    const long long j = j0 + e % kKtRows;
    if (q < nq && j < n) out[(long long)q * n + j] = st[e];
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(256)
    adc_gather_kernel(const float* __restrict__ tables, const unsigned char* __restrict__ codes_t,
                      float* __restrict__ out, int nq, int m, int k, long long n, int group,
                      int subspaces, long long rows_per_block, int vec) {
  extern __shared__ float tab_s[];
  const int q0 = blockIdx.y * group;
  const int gq = min(group, nq - q0);
  const float* tab = tables + (size_t)q0 * m * k;
  if (kSmem) {
    const int cells = gq * m * k;
    for (int t = threadIdx.x; t < cells; t += blockDim.x) tab_s[t] = tab[t];
    __syncthreads();
    tab = tab_s;
  }
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long j = r0 + (long long)kRowsPerThread * threadIdx.x; j < r1;
       j += (long long)kRowsPerThread * blockDim.x) {
    float acc[kGatherMax][kRowsPerThread];
#pragma unroll
    for (int g = 0; g < kGatherMax; ++g)
#pragma unroll
      for (int e = 0; e < kRowsPerThread; ++e) acc[g][e] = 0.f;
    for (int i = 0; i < subspaces; ++i) {
      int c[kRowsPerThread];
      load4(codes_t + (long long)i * n, j, n, vec, c);
#pragma unroll
      for (int g = 0; g < kGatherMax; ++g) {
        if (g < gq) {
          const float* tq = tab + ((size_t)g * m + i) * k;
#pragma unroll
          for (int e = 0; e < kRowsPerThread; ++e)
            acc[g][e] = __fadd_rn(acc[g][e], c[e] < k ? tq[c[e]] : 0.f);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGatherMax; ++g)
      if (g < gq) store4(out + (long long)(q0 + g) * n, j, n, vec, acc[g]);
  }
}

__global__ void __launch_bounds__(256)
    adc_floor_kernel(const float* __restrict__ tables, const unsigned char* __restrict__ codes_t,
                     float* __restrict__ out, int nq, long long n, int q_per_block, int vec) {
  const long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kRowsPerThread;
  if (j >= n) return;
  const float t0 = tables[0];
  int c[kRowsPerThread];
  load4(codes_t, j, n, vec, c);
  float v[kRowsPerThread];
#pragma unroll
  for (int e = 0; e < kRowsPerThread; ++e) v[e] = __fadd_rn((float)c[e], t0);
  const int q1 = min(nq, (int)(blockIdx.y + 1) * q_per_block);
  for (int q = blockIdx.y * q_per_block; q < q1; ++q)
    store4(out + (long long)q * n, j, n, vec, v);
}

}  // namespace

// hi, mid, lo: [qp, m, kp] bf16, qp and kp multiples of 16.
extern "C" int vq_adc_kt(const void* hi, const void* mid, const void* lo,
                         const unsigned char* codes_t, float* out, int nq, int qp, int m,
                         int k, int kp, long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)kKtRows * (kp + 8) * 2 + (size_t)kKtWarps * kKtStage * 4;
  int err = (int)cudaFuncSetAttribute(adc_kt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err != 0) return err;
  const dim3 grid((unsigned)((n + kKtRows - 1) / kKtRows),
                  (unsigned)((qp + 16 * kKtWarps - 1) / (16 * kKtWarps)));
  using bf = __nv_bfloat16;
  adc_kt_kernel<<<grid, 256, smem, st>>>(static_cast<const bf*>(hi), static_cast<const bf*>(mid),
                                         static_cast<const bf*>(lo), codes_t, out, nq, m, k, kp, n);
  return (int)cudaGetLastError();
}

// group <= 8 queries a block; tab_in_smem: the group's tables fit
// `smem` bytes; vec: n % 4 == 0 (u32 code loads, float4 stores).
extern "C" int vq_adc_gather(const float* tables, const unsigned char* codes_t, float* out,
                             int nq, int m, int k, long long n, int group, int tab_in_smem,
                             int subspaces, long long rows_per_block, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((n + rows_per_block - 1) / rows_per_block),
                  (unsigned)((nq + group - 1) / group));
  if (tab_in_smem) {
    const size_t smem = (size_t)group * m * k * sizeof(float);
    const int err = (int)cudaFuncSetAttribute(
        adc_gather_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
    adc_gather_kernel<true><<<grid, 256, smem, st>>>(tables, codes_t, out, nq, m, k, n, group,
                                                     subspaces, rows_per_block, vec);
  } else {
    adc_gather_kernel<false><<<grid, 256, 0, st>>>(tables, codes_t, out, nq, m, k, n, group,
                                                   subspaces, rows_per_block, vec);
  }
  return (int)cudaGetLastError();
}

extern "C" int vq_adc_floor(const float* tables, const unsigned char* codes_t, float* out,
                            int nq, long long n, int q_per_block, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long threads = (n + kRowsPerThread - 1) / kRowsPerThread;
  const dim3 grid((unsigned)((threads + 255) / 256),
                  (unsigned)((nq + q_per_block - 1) / q_per_block));
  adc_floor_kernel<<<grid, 256, 0, st>>>(tables, codes_t, out, nq, n, q_per_block, vec);
  return (int)cudaGetLastError();
}
