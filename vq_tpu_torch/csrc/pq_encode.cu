// K4: exact PQ encode. x [n, m*s] (f32 or bf16) against codebooks
// [m, k, s] f32 -> codes [n, m] i32, the int2 argmin of
// ||c||^2 - 2 x_s.c per subspace.
//
// Replaces vq_tpu/ops/pallas_kernels.py::_pq_encode_kernel (reached
// through pq_encode_fused / _pq_encode_fused_jit), and, in the second
// kernel below, its two lower-precision bodies K4-bf16
// (_pq_encode_bf16_kernel) and K4-bf16x3 (_pq_encode_bf16x3_kernel).
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

// K4-bf16 and K4-bf16x3: the same encode with the dot taken at a lower
// precision, as the TPU runs it on its matrix unit.
//
// * bf16 (kX3 = false): x and the codebook rounded to bf16, products
//   summed in f32: dot = sum_e bf(x_e) * bf(c_e).
// * bf16x3 (kX3 = true): each f32 operand split into a bf16 high half
//   and the bf16 of its remainder, dot = (xh.ch + xh.cl) + xl.ch, each of
//   the three dots summed from 0 (~2^-16 relative accuracy).
//
// cc = ||c||^2 stays f32 from the f32 codebook, as on the TPU. A product
// of two bf16 values is exact in f32, so summing them on the CUDA cores
// with __fmul_rn / __fadd_rn in ascending e gives, bit for bit, what the
// plain PyTorch version computes; the argmin is the int2 rule, where the
// TPU bodies take jnp.argmin.
//
// What bounds them on the card: the same 2*n*m*k*s products as K4 (3x
// for bf16x3), here on the CUDA cores in f32. On tensor cores the bf16
// work is 67 GFLOP (201 for bf16x3) at 989 TFLOP/s, 0.07 (0.2) ms, so
// the 512 MB of f32 x read (0.155 ms) would bound bf16 and the products
// bf16x3. This first design keeps K4's structure (one thread a row and
// subspace, the codebook chunk in shared memory, pre-rounded by the
// wrapper: cbh = bf(c), cbl = bf(c - cbh)) and does the rounding of x in
// registers; a wgmma design is the next step.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, bool kX3>
__global__ void __launch_bounds__(kThreads)
    pq_encode_lowp_kernel(const T* __restrict__ x, const float* __restrict__ cbh,
                          const float* __restrict__ cbl,
                          const float* __restrict__ cc, int* __restrict__ codes,
                          long long n, int m, int k, int s, int kc,
                          long long rows_per_block) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* ls = hs + (size_t)kc * s;
  float* ccs = ls + (kX3 ? (size_t)kc * s : 0);
  const int i = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  const float* hi_i = cbh + (size_t)i * k * s;
  const float* lo_i = cbl + (size_t)i * k * s;
  const float* cci = cc + (size_t)i * k;
  const bool resident = kc >= k;
  const bool in_regs = s <= kXRegs;
  if (resident) {
    load_chunk(hi_i, cci, hs, ccs, 0, k, s);
    if (kX3) load_chunk(lo_i, cci, ls, ccs, 0, k, s);
    __syncthreads();
  }
  const long long d = (long long)m * s;
  for (long long base = r0; base < r1; base += blockDim.x) {
    const long long row = base + threadIdx.x;
    const bool valid = row < r1;
    const T* xs = x + (valid ? row : 0) * d + (long long)i * s;
    float xh[kXRegs], xl[kXRegs];
#pragma unroll
    for (int e = 0; e < kXRegs; ++e) {
      const float v = (valid && in_regs && e < s) ? to_f32(xs[e]) : 0.f;
      xh[e] = bf16_round(v);
      xl[e] = kX3 ? bf16_round(__fsub_rn(v, xh[e])) : 0.f;
    }
    int best_key = INT_MAX, best_idx = 0;
    for (int j0 = 0; j0 < k; j0 += kc) {
      const int cnt = min(kc, k - j0);
      if (!resident) {
        __syncthreads();
        load_chunk(hi_i, cci, hs, ccs, j0, cnt, s);
        if (kX3) load_chunk(lo_i, cci, ls, ccs, j0, cnt, s);
        __syncthreads();
      }
      if (!valid) continue;
      for (int j = 0; j < cnt; ++j) {
        const float* ch = hs + (size_t)j * s;
        const float* cl = ls + (size_t)j * s;
        float hh = 0.f, hl = 0.f, lh = 0.f;
        if (in_regs) {
#pragma unroll
          for (int e = 0; e < kXRegs; ++e) {
            if (e < s) {
              hh = __fadd_rn(hh, __fmul_rn(xh[e], ch[e]));
              if (kX3) {
                hl = __fadd_rn(hl, __fmul_rn(xh[e], cl[e]));
                lh = __fadd_rn(lh, __fmul_rn(xl[e], ch[e]));
              }
            }
          }
        } else {
          for (int e = 0; e < s; ++e) {
            const float v = to_f32(xs[e]);
            const float vh = bf16_round(v);
            hh = __fadd_rn(hh, __fmul_rn(vh, ch[e]));
            if (kX3) {
              hl = __fadd_rn(hl, __fmul_rn(vh, cl[e]));
              lh = __fadd_rn(lh, __fmul_rn(bf16_round(__fsub_rn(v, vh)), ch[e]));
            }
          }
        }
        const float dot = kX3 ? __fadd_rn(__fadd_rn(hh, hl), lh) : hh;
        const int key = orderable_key(__fsub_rn(ccs[j], __fmul_rn(2.0f, dot)));
        if (key < best_key) {
          best_key = key;
          best_idx = j0 + j;
        }
      }
    }
    if (valid) codes[row * m + i] = best_idx;
  }
}

extern "C" int vq_pq_encode_lowp(const void* x, int x_is_bf16, const float* cbh,
                                 const float* cbl, const float* cc, int* codes,
                                 long long n, int m, int k, int s, int kc,
                                 long long rows_per_block, int bf16x3,
                                 void* stream) {
  const unsigned nblk = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  const dim3 grid(nblk, (unsigned)m);
  const size_t smem = ((size_t)(bf16x3 ? 2 : 1) * kc * s + kc) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16x3) {  // the wrapper upcasts a bf16 x for bf16x3, as the TPU caller does
    pq_encode_lowp_kernel<float, true><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), cbh, cbl, cc, codes, n, m, k, s, kc,
        rows_per_block);
  } else if (x_is_bf16) {
    pq_encode_lowp_kernel<__nv_bfloat16, false><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), cbh, cbl, cc, codes, n, m, k, s,
        kc, rows_per_block);
  } else {
    pq_encode_lowp_kernel<float, false><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), cbh, cbl, cc, codes, n, m, k, s, kc,
        rows_per_block);
  }
  return (int)cudaGetLastError();
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
