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
// What bounds it on the card: the [Q, n] f32 output, 512 MB written at
// Q = 128 over 1M rows against 8 MB of u8 codes and 1 MB of tables read
// (~0.156 ms at 3.35 TB/s). The work is Q*n*m = 1.02 G random table
// lookups, and those set its time: one 4-byte shared load a lookup costs
// ~3.5 wavefronts a warp (32 random codes over 32 banks), so 0.43 ms of
// shared-memory cycles before any other instruction.
//
// Design: the tables of 4 queries are interleaved into one float4 an
// entry, [quad][m][kp] in shared memory, so one 16-byte shared load gives
// a (subspace, code) entry for 4 queries; a quarter-warp's 8 loads then
// fall in 8 slots of 16 bytes (~2.5 wavefronts a phase): a quarter of the
// load instructions at ~0.7 of the shared-memory cycles a lookup. The
// layout is built by the block's own fill, a ragged last quad padded with
// zeros (computed, never stored). Where a code can fall outside [0, k)
// (i32 codes, or u8 codes with k < 256) each subspace gets one zero entry
// at index k and a code is clamped to it once a (row, subspace), not once
// a query; u8 codes with k >= 256 need no check at all (kClamp = false).
// A block of 512 threads holds up to 4 quads (128 KB at 8 x 256, one
// block an SM, in the opted-in window of up to 227 KB; fewer where they do
// not fit or the queries run out, spread evenly over the blocks) and walks
// a range of rows, 4 consecutive rows a thread:
// a row's codes load as 4-byte (u8) or 16-byte (i32) words where m % 4 ==
// 0, the 16 sums of 4 rows x 4 queries stay in registers, and each query
// gets a float4 of 4 rows (a warp writes 512 contiguous bytes), streamed
// past L2 (st.global.cs) so the codes stay there for the other blocks
// that read them. Codes of up to 8 subspaces sit in registers as byte
// offsets, made once for all quads where m <= 8 and again a quad
// otherwise. A launch is one wave, as many blocks as the card holds at
// once with the rows spread evenly over them, so each block fills its
// tables once. Tables too large for shared memory (RQ at k = 4096, say) are read
// from device memory through L1 / L2, one query at a time within the
// quad, out-of-range codes picking 0.0 by a check.
#include <cstdint>

#include "common.cuh"

using namespace vqk;

namespace {

constexpr int kRows = 4;           // consecutive rows a thread
constexpr int kChunk = 8;          // subspaces whose codes a thread holds at once
constexpr int kQuads = 4;          // quads of queries a block, at most
constexpr int kBlock = 512;        // threads a block
constexpr int kFill = 4;           // table entries a thread loads at a fill step

// A (subspace i, code c) entry: the byte offset of its float4 in a quad's
// shared table (kSmem; an out-of-range code takes the zero entry k), or
// its index in one query's [m, k] table, -1 outside [0, k) (read through
// L2).
template <bool kSmem, bool kClamp>
__device__ __forceinline__ int entry(int i, int c, int k, int kp) {
  if (kSmem) {
    if (kClamp && (unsigned)c >= (unsigned)k) c = k;
    return (i * kp + c) << 4;
  }
  return (unsigned)c < (unsigned)k ? i * k + c : -1;
}

// off[e][ii]: the entries of rows r + e, subspaces i0 + ii (ii < cnt).
// Rows past n read code 0 (summed, never stored).
template <typename C, bool kSmem, bool kClamp>
__device__ __forceinline__ void load_entries(const C* __restrict__ codes, long long r,
                                             long long n, int m, int i0, int cnt, int k,
                                             int kp, bool vec, int off[kRows][kChunk]) {
  int c[kRows][kChunk];
  if (vec && r + kRows <= n) {  // m % 4 == 0, codes 16-byte aligned
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      const C* p = codes + (r + e) * m + i0;
      if constexpr (sizeof(C) == 1) {
        if ((m & 7) == 0) {  // the row's 8 codes in one 8-byte load
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            c[e][b] = (v.x >> (8 * b)) & 0xFF;
            c[e][4 + b] = (v.y >> (8 * b)) & 0xFF;
          }
          continue;
        }
      }
#pragma unroll
      for (int w = 0; w < kChunk / 4; ++w) {
        if (4 * w < cnt) {
          if constexpr (sizeof(C) == 1) {
            const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p) + w);
#pragma unroll
            for (int b = 0; b < 4; ++b) c[e][4 * w + b] = (v >> (8 * b)) & 0xFF;
          } else {
            const int4 v = __ldg(reinterpret_cast<const int4*>(p) + w);
            c[e][4 * w] = v.x;
            c[e][4 * w + 1] = v.y;
            c[e][4 * w + 2] = v.z;
            c[e][4 * w + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b) c[e][4 * w + b] = 0;
        }
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kRows; ++e)
#pragma unroll
      for (int ii = 0; ii < kChunk; ++ii)
        c[e][ii] = (r + e < n && ii < cnt) ? (int)codes[(r + e) * m + i0 + ii] : 0;
  }
#pragma unroll
  for (int e = 0; e < kRows; ++e)
#pragma unroll
    for (int ii = 0; ii < kChunk; ++ii)
      off[e][ii] = entry<kSmem, kClamp>(i0 + ii, c[e][ii], k, kp);
}

// The entry `off` for the 4 queries of a quad: one 16-byte shared load
// from the quad's table `qs`, or 4 reads of the queries' tables t[l].
template <bool kSmem>
__device__ __forceinline__ float4 lookup(const char* qs, const float* const t[4], int off) {
  if (kSmem) return *reinterpret_cast<const float4*>(qs + off);
  if (off < 0) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(__ldg(t[0] + off), __ldg(t[1] + off), __ldg(t[2] + off), __ldg(t[3] + off));
}

__device__ __forceinline__ void add4(float4& a, const float4 v) {
  a.x = __fadd_rn(a.x, v.x);
  a.y = __fadd_rn(a.y, v.y);
  a.z = __fadd_rn(a.z, v.z);
  a.w = __fadd_rn(a.w, v.w);
}

__device__ __forceinline__ float lane(const float4 a, int l) {
  return l == 0 ? a.x : l == 1 ? a.y : l == 2 ? a.z : a.w;
}

// Block (g, b): queries [4 g quads, 4 (g + 1) quads) against rows
// [b rows_per_block, (b + 1) rows_per_block), rows_per_block a multiple of
// kRows * blockDim.x. kSmem: the quads' tables sit in shared memory
// (dynamic, quads * m * kp * 16 bytes); otherwise quads is 1.
template <typename C, bool kSmem, bool kClamp>
__global__ void __launch_bounds__(kBlock)
    adc_lookup_kernel(const float* __restrict__ tables, const C* __restrict__ codes,
                      float* __restrict__ out, int nq, int m, int k, long long n, int quads,
                      long long rows_per_block, bool vec_codes) {
  extern __shared__ float4 tab_s[];
  const int kp = kSmem && kClamp ? k + 1 : k;
  const int q0 = blockIdx.x * quads * 4;
  const int gquads = min(quads, (nq - q0 + 3) / 4);
  if (kSmem) {
    // The fill: kFill entries a thread at a step, their 4 x kFill loads
    // issued before the stores.
    const int cells = gquads * m * kp;
    for (int t0 = threadIdx.x; t0 < cells; t0 += kFill * blockDim.x) {
      float4 v[kFill];
#pragma unroll
      for (int b = 0; b < kFill; ++b) {
        const int t = t0 + b * blockDim.x, row = t / kp, c = t - row * kp;
        const int j = row / m, i = row - j * m;
        float x[4];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int q = q0 + 4 * j + l;
          x[l] = (t < cells && q < nq && c < k) ? __ldg(tables + ((size_t)q * m + i) * k + c)
                                                : 0.f;
        }
        v[b] = make_float4(x[0], x[1], x[2], x[3]);
      }
#pragma unroll
      for (int b = 0; b < kFill; ++b)
        if (t0 + b * blockDim.x < cells) tab_s[t0 + b * blockDim.x] = v[b];
    }
    __syncthreads();
  }
  const size_t quad_bytes = (size_t)m * kp * 16;
  const bool vec_out = (n & 3) == 0;
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long r = r0 + (long long)kRows * threadIdx.x; r < r1;
       r += (long long)kRows * blockDim.x) {
    int off[kRows][kChunk];
    if (m <= kChunk) load_entries<C, kSmem, kClamp>(codes, r, n, m, 0, m, k, kp, vec_codes, off);
    for (int j = 0; j < gquads; ++j) {
      const int qj = q0 + 4 * j;
      const char* qs = reinterpret_cast<const char*>(tab_s) + j * quad_bytes;
      const float* t[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) t[l] = tables + (size_t)min(qj + l, nq - 1) * m * k;
      float4 acc[kRows];
#pragma unroll
      for (int e = 0; e < kRows; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i0 = 0; i0 < m; i0 += kChunk) {
        const int cnt = min(kChunk, m - i0);
        if (m > kChunk)
          load_entries<C, kSmem, kClamp>(codes, r, n, m, i0, cnt, k, kp, vec_codes, off);
#pragma unroll
        for (int ii = 0; ii < kChunk; ++ii) {
          if (ii < cnt) {
#pragma unroll
            for (int e = 0; e < kRows; ++e) add4(acc[e], lookup<kSmem>(qs, t, off[e][ii]));
          }
        }
      }
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        if (qj + l >= nq) break;
        float* o = out + (size_t)(qj + l) * n + r;
        if (vec_out && r + kRows <= n) {
          __stcs(reinterpret_cast<float4*>(o), make_float4(lane(acc[0], l), lane(acc[1], l),
                                                           lane(acc[2], l), lane(acc[3], l)));
        } else {
#pragma unroll
          for (int e = 0; e < kRows; ++e)
            if (r + e < n) __stcs(o + e, lane(acc[e], l));
        }
      }
    }
  }
}

// One wave of blocks: as many as the card holds at once (by the occupancy
// calculator), `quads` quads of queries a block, the rows spread evenly
// over the blocks of a query group in whole tiles of kRows * kBlock.
template <typename C, bool kSmem, bool kClamp>
int launch(const float* tables, const void* codes, float* out, int nq, int m, int k,
           long long n, int quads, int sms, cudaStream_t st) {
  auto kernel = adc_lookup_kernel<C, kSmem, kClamp>;
  const size_t smem = kSmem ? (size_t)quads * m * (kClamp ? k + 1 : k) * 16 : 0;
  int err = 0, per_sm = 0;
  if (smem > 48 * 1024)
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, smem);
  if (err != 0) return err;
  const unsigned groups = (unsigned)((nq + 4 * quads - 1) / (4 * quads));
  const long long tile = (long long)kRows * kBlock, tiles = (n + tile - 1) / tile;
  const long long row_blocks = max(1LL, min(tiles, (long long)per_sm * sms / groups));
  const long long rows_per_block = (tiles + row_blocks - 1) / row_blocks * tile;
  const bool vec_codes = m % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const dim3 grid(groups, (unsigned)((n + rows_per_block - 1) / rows_per_block));
  kernel<<<grid, kBlock, smem, st>>>(tables, static_cast<const C*>(codes), out, nq, m, k, n,
                                     quads, rows_per_block, vec_codes);
  return (int)cudaGetLastError();
}

}  // namespace

// The tables of a quad take m * kp * 16 bytes of shared memory (kp = k,
// or k + 1 unless the codes are u8 and k >= 256); a block holds as many
// quads as fit in the opt-in window, kQuads at most, and none where one
// does not fit: then the tables are read from device memory, a quad a
// block.
extern "C" int vq_adc_lookup(const float* tables, const void* codes, int codes_are_u8,
                             float* out, int nq, int m, int k, long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, optin = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != 0) return err;
  const bool clamp = !codes_are_u8 || k < 256;
  const long long fit = optin / ((long long)m * (clamp ? k + 1 : k) * 16);
  const int nquads = (nq + 3) / 4;
  if (fit == 0) {
    return codes_are_u8 ? launch<unsigned char, false, false>(tables, codes, out, nq, m, k, n, 1,
                                                              sms, st)
                        : launch<int, false, false>(tables, codes, out, nq, m, k, n, 1, sms, st);
  }
  const int most = (int)min(fit, (long long)min(kQuads, nquads));
  const int groups = (nquads + most - 1) / most;
  const int quads = (nquads + groups - 1) / groups;  // spread evenly over the groups
  if (!codes_are_u8)
    return launch<int, true, true>(tables, codes, out, nq, m, k, n, quads, sms, st);
  if (clamp)
    return launch<unsigned char, true, true>(tables, codes, out, nq, m, k, n, quads, sms, st);
  return launch<unsigned char, true, false>(tables, codes, out, nq, m, k, n, quads, sms, st);
}
