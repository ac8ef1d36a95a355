// K8: dense ADC lookup. tables [Q, m, k] f32 x codes [n, m] (u8 or i32)
// -> out [Q, n] f32, out[q, r] = sum over i of tables[q, i, codes[r, i]],
// added from +0.0 in ascending subspace order; a code outside [0, k)
// adds 0.0.
//
// Replaces vq_tpu/ops/pallas_kernels.py::_adc_lookup_kernel (reached
// through adc_lookup_fused / _adc_lookup_fused_jit), whose m one-hot
// matmuls a tile give the same sum: a one-hot row picks one table entry
// exactly, and a code outside [0, k) matches no column.
//
// What bounds it on the card: the [Q, n] f32 output. At Q = 128 over 1M
// rows that is 512 MB written against 8 MB of u8 codes and 1 MB of
// tables read, and Q*n*m = 1.07 G additions (16 us at 67 TFLOP/s), so
// it is bound by the bytes it writes (~0.155 ms at 3.35 TB/s).
//
// Design: block (r, g) owns a contiguous range of rows and a group of
// queries whose tables sit in shared memory (8 KB a query at 8 x 256,
// six queries in the 48 KB window). One thread a row: it loads the row's
// m codes once into registers (m <= 32; wider rows read them through L1
// each query) and writes out[q, row] for each query of the group, so a
// warp's stores are 128 contiguous bytes of one output row. Tables too
// large for shared memory (RQ at k = 4096, say) are read from device
// memory through L2, as K7 does with gsub = 0.
#include "common.cuh"

using namespace vqk;

constexpr int kLookupThreads = 256;
constexpr int kCodeRegs = 32;  // codes a row kept in registers

__device__ __forceinline__ float pick(const float* __restrict__ tq, int i, int k,
                                      int c) {
  return (c >= 0 && c < k) ? tq[(size_t)i * k + c] : 0.f;
}

template <typename C, bool kSmem>
__global__ void __launch_bounds__(kLookupThreads)
    adc_lookup_kernel(const float* __restrict__ tables,
                      const C* __restrict__ codes, float* __restrict__ out,
                      int nq, int m, int k, long long n, int group,
                      long long rows_per_block) {
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
  const bool in_regs = m <= kCodeRegs;
  for (long long row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    const C* rc = codes + row * m;
    int cr[kCodeRegs];
#pragma unroll
    for (int i = 0; i < kCodeRegs; ++i)
      cr[i] = (in_regs && i < m) ? (int)rc[i] : 0;
    for (int q = 0; q < gq; ++q) {
      const float* tq = tab + (size_t)q * m * k;
      float acc = 0.f;
      if (in_regs) {
#pragma unroll
        for (int i = 0; i < kCodeRegs; ++i)
          if (i < m) acc = __fadd_rn(acc, pick(tq, i, k, cr[i]));
      } else {
        for (int i = 0; i < m; ++i)
          acc = __fadd_rn(acc, pick(tq, i, k, (int)rc[i]));
      }
      out[(size_t)(q0 + q) * n + row] = acc;
    }
  }
}

template <typename C>
static void launch(const float* tables, const void* codes, float* out, int nq,
                   int m, int k, long long n, int group, int tab_in_smem,
                   long long rows_per_block, cudaStream_t st) {
  const unsigned nblk = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  const dim3 grid(nblk, (unsigned)((nq + group - 1) / group));
  const C* c = static_cast<const C*>(codes);
  if (tab_in_smem) {
    const size_t smem = (size_t)group * m * k * sizeof(float);
    adc_lookup_kernel<C, true><<<grid, kLookupThreads, smem, st>>>(
        tables, c, out, nq, m, k, n, group, rows_per_block);
  } else {
    adc_lookup_kernel<C, false><<<grid, kLookupThreads, 0, st>>>(
        tables, c, out, nq, m, k, n, group, rows_per_block);
  }
}

extern "C" int vq_adc_lookup(const float* tables, const void* codes,
                             int codes_are_u8, float* out, int nq, int m,
                             int k, long long n, int group, int tab_in_smem,
                             long long rows_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (codes_are_u8)
    launch<unsigned char>(tables, codes, out, nq, m, k, n, group, tab_in_smem,
                          rows_per_block, st);
  else
    launch<int>(tables, codes, out, nq, m, k, n, group, tab_in_smem,
                rows_per_block, st);
  return (int)cudaGetLastError();
}
