// K7: ADC sums over probed IVF chunks. For each (query, probe) pair p:
// tables [P, m, kk] f32, that pair's chunk chain chunks [P, nc] i32
// (-1 = no chunk), the code pool codes [n_chunks, ch, m] (u8 or i32)
// -> out [P, nc*ch] with out[p, t] = sum_i tables[p, i, code_i] over
// the codes of row t % ch of chunk chunks[p, t / ch], summed from 0 in
// subspace order 0..m-1 in fp32. Positions t >= cap, and positions of a
// -1 chunk, give 0; a code outside [0, kk) adds 0.
//
// Replaces vq_tpu/ops/pallas_kernels.py::_ivf_probe_gather_kernel
// (kk <= 256, u8 codes) and ::_ivf_probe_kernel (kk > 256, i32 codes),
// both reached through ivf_probe_adc_fused / _ivf_probe_adc_jit: one
// kernel templated on the code width serves both.
//
// What bounds it on the card: the code bytes of the probed chains
// (m bytes a row for u8 codes) and m shared-memory table gathers a row;
// at 128 queries x nprobe 64 over 1M rows that is ~100 MB of codes.
//
// Design: the TPU caller repeated each (query, probe) table once per
// chunk of the chain so that every chunk was a BlockSpec "list"; here a
// block takes one pair's table once into shared memory and walks that
// pair's chain itself, one thread per row position, reading the row's
// m codes (contiguous) and gathering from the table. A table larger
// than the 48 KB window (m = 16, kk = 4096 is 256 KB) streams through it
// in groups of subspaces, the running sums kept in `out` between
// groups, so the summation order is unchanged; a single subspace that
// does not fit is read from device memory. No shape is refused.
#include "common.cuh"

namespace {

constexpr int kProbeThreads = 256;

template <typename C>
__global__ void __launch_bounds__(kProbeThreads)
    ivf_probe_kernel(const float* __restrict__ tables,
                     const int* __restrict__ chunks,
                     const C* __restrict__ codes, float* __restrict__ out,
                     int m, int kk, int nc, int ch, long long cap, int gsub) {
  extern __shared__ float tab[];
  const long long p = blockIdx.x;
  const long long width = (long long)nc * ch;
  const float* tp = tables + p * m * (long long)kk;
  float* op = out + p * width;
  const bool in_smem = gsub > 0;
  const int group = in_smem ? gsub : m;
  for (int g0 = 0; g0 < m; g0 += group) {
    const int gc = min(group, m - g0);
    const float* src = tp + (long long)g0 * kk;
    if (in_smem) {
      __syncthreads();
      for (int t = threadIdx.x; t < gc * kk; t += blockDim.x) tab[t] = src[t];
      __syncthreads();
      src = tab;
    }
    for (long long t = (long long)blockIdx.y * blockDim.x + threadIdx.x;
         t < width; t += (long long)gridDim.y * blockDim.x) {
      const int cid = chunks[p * nc + t / ch];
      float acc = 0.f;
      if (cid >= 0 && t < cap) {
        if (g0 > 0) acc = op[t];
        const C* row = codes + ((long long)cid * ch + t % ch) * m + g0;
        for (int i = 0; i < gc; ++i) {
          const int code = (int)row[i];
          acc = __fadd_rn(acc, (unsigned)code < (unsigned)kk
                                   ? src[(long long)i * kk + code]
                                   : 0.f);
        }
      }
      op[t] = acc;
    }
  }
}

}  // namespace

extern "C" int vq_ivf_probe(const float* tables, const int* chunks,
                            const void* codes, int codes_are_u8, float* out,
                            int pairs, int m, int kk, int nc, int ch,
                            long long cap, int gsub, int slices,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)pairs, (unsigned)slices);
  const size_t smem = (size_t)gsub * kk * sizeof(float);
  if (codes_are_u8) {
    ivf_probe_kernel<unsigned char><<<grid, kProbeThreads, smem, st>>>(
        tables, chunks, static_cast<const unsigned char*>(codes), out, m, kk,
        nc, ch, cap, gsub);
  } else {
    ivf_probe_kernel<int><<<grid, kProbeThreads, smem, st>>>(
        tables, chunks, static_cast<const int*>(codes), out, m, kk, nc, ch,
        cap, gsub);
  }
  return (int)cudaGetLastError();
}
