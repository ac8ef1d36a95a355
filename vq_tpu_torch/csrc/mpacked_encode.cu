// B1: m-packed PQ encode. x [n, d] (f32 or bf16) times any W [d, m*256]
// (f32 or bf16) plus cc [m*256] f32 -> scores, then for each subspace i
// the int2 argmin over its 256 columns -> codes [n, m] i32.
//
// Replaces benchmarks/mpacked_encode.py::_mpacked_kernel (reached through
// mpacked_encode, its pl.pallas_call at :76). benchmarks/mpacked_encode.py
// ::build_w makes W the block-diagonal -2 c^T of a codebook, but the
// function, and so this kernel, takes any W: a kernel that skipped the
// zero blocks would compute K4's function instead.
//
// Two bodies, as the TPU function's two precisions:
//
// * "highest" (mpacked_highest_kernel): exact fp32 on the CUDA cores.
//   Each score is sum_d x_d * W[d, j] from +0.0 in ascending d, one
//   __fmul_rn and __fadd_rn a term (-fmad=false), then + cc[j]: the plain
//   version's arithmetic, bit for bit. A block owns row tiles of 64 rows;
//   warp w owns 8 rows of a tile and lane l the columns l + 32*t of the
//   subspace, so each thread keeps an 8x8 tile of scores in registers
//   while x and W stream through shared memory 16 depths at a time. The
//   argmin is the thread's strict < over its columns in ascending order,
//   then a warp shuffle on (key, column): the lowest key, then the lowest
//   column. With W = build_w(cb) it gives K4's codes exactly: x*(-2c) is
//   -2*(x*c) exactly, the zero blocks add +-0.0 to a +0.0 or nonzero
//   sum, and (-2 dot) + cc is cc - 2 dot.
// * "default" (mpacked_bf16_kernel): bf16 tensor cores (nvcuda::wmma
//   16x16x16, f32 accumulation). The wrapper rounds W to bf16 once; the
//   kernel rounds an f32 x to bf16 (to nearest even) as it stages it (a
//   bf16 x goes through f32 and back unchanged). A block owns 64-row
//   tiles; for each subspace, 8 warps each hold 8 accumulator fragments of the
//   [64, 256] score tile while x and W chunks of 32 depths pass through
//   shared memory, then the scores go to shared memory, get + cc and the
//   same int2 argmin. The tensor core sums in its own order, so this body
//   is held to its plain version (bf16-rounded operands summed in
//   ascending d) by the near-tie rule, not bit for bit.
//
// What bounds it on the card, at 1M x 128 against 8 x 256: 2*n*d*m*256 =
// 524 GFLOP. "highest" is bound by operations (7.8 ms at the 67 TFLOP/s
// fp32 peak, which assumes FMAs that the exact rounding rule forbids);
// "default" by operations too (0.53 ms at 989 TFLOP/s bf16), the 512 MB
// of f32 x being 0.15 ms. This first design is simple: no wgmma, no TMA,
// no multi-stage pipeline. Each thread issues all its loads of a chunk
// before the barrier that ends the previous chunk's reads, so a chunk
// waits on memory once, not once a value.
#include "common.cuh"

#include <mma.h>

using namespace vqk;

namespace {

constexpr int kCols = 256;   // columns of a subspace (the TPU function's k)
constexpr int kTile = 64;    // rows of a tile
constexpr int kHiDepth = 16;  // depths of x and W staged at a time ("highest")
constexpr int kLoDepth = 32;  // the same for "default" (two wmma steps)
constexpr int kLdX = kLoDepth + 8;  // bf16 row pitches in shared memory
constexpr int kLdW = kCols + 8;
constexpr int kLdS = kCols + 4;     // f32 row pitch of the score tile
constexpr size_t kXBytes = (size_t)kTile * kLdX * 2;
constexpr size_t kWBytes = (size_t)kLoDepth * kLdW * 2;
constexpr size_t kLoSmem = kXBytes + kWBytes + (size_t)kTile * kLdS * 4;
constexpr int kPieces = kCols / 8;  // 16-byte pieces of a bf16 W row of a subspace
// Values of a staged chunk a thread loads (blocks of kThreads threads).
constexpr int kHiXPer = kTile * kHiDepth / kThreads;
constexpr int kHiWPer = kHiDepth * kCols / kThreads;
constexpr int kLoXPer = kTile * kLoDepth / kThreads;
constexpr int kLoWPer = kLoDepth * kPieces / kThreads;

// The int2 winner of a warp: (key, column) pairs, lowest key first, then
// lowest column. Every lane ends with the winner.
__device__ __forceinline__ int warp_argmin(int key, int col) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(0xffffffffu, key, off);
    const int oc = __shfl_xor_sync(0xffffffffu, col, off);
    if (ok < key || (ok == key && oc < col)) {
      key = ok;
      col = oc;
    }
  }
  return col;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
    mpacked_highest_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                           const float* __restrict__ cc, int* __restrict__ codes,
                           long long n, int d, int m, long long rows_per_block) {
  __shared__ float xs[kTile][kHiDepth];
  __shared__ float ws[kHiDepth][kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long mk = (long long)m * kCols;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(n, r_begin + rows_per_block);
  for (long long r0 = r_begin; r0 < r_end; r0 += kTile) {
    for (int i = 0; i < m; ++i) {
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      for (int d0 = 0; d0 < d; d0 += kHiDepth) {
        // All of a thread's loads of the chunk are issued before its
        // first store, so they wait on device memory once, not one by one.
        float xv[kHiXPer], wv[kHiWPer];
#pragma unroll
        for (int u = 0; u < kHiXPer; ++u) {
          const int t = threadIdx.x + u * kThreads, rr = t / kHiDepth, dd = t % kHiDepth;
          const long long row = r0 + rr;
          xv[u] = (row < r_end && d0 + dd < d) ? to_f32(x[row * d + d0 + dd]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kHiWPer; ++u) {
          const int t = threadIdx.x + u * kThreads, dd = t / kCols, c = t % kCols;
          wv[u] = d0 + dd < d ? to_f32(w[(long long)(d0 + dd) * mk + (long long)i * kCols + c])
                              : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kHiXPer; ++u) {
          const int t = threadIdx.x + u * kThreads;
          xs[t / kHiDepth][t % kHiDepth] = xv[u];
        }
#pragma unroll
        for (int u = 0; u < kHiWPer; ++u) {
          const int t = threadIdx.x + u * kThreads;
          ws[t / kCols][t % kCols] = wv[u];
        }
        __syncthreads();
        const int depth = min(kHiDepth, d - d0);
        for (int dd = 0; dd < depth; ++dd) {
          float a[8], b[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) a[r] = xs[warp * 8 + r][dd];
#pragma unroll
          for (int c = 0; c < 8; ++c) b[c] = ws[dd][lane + 32 * c];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(a[r], b[c]));
        }
      }
      const float* cci = cc + (size_t)i * kCols;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        int best_key = INT_MAX, best_col = lane;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int key = orderable_key(__fadd_rn(acc[r][c], cci[lane + 32 * c]));
          if (key < best_key) {
            best_key = key;
            best_col = lane + 32 * c;
          }
        }
        const int col = warp_argmin(best_key, best_col);
        const long long row = r0 + warp * 8 + r;
        if (lane == 0 && row < r_end) codes[row * m + i] = col;
      }
    }
  }
}

template <typename TX>
__global__ void __launch_bounds__(kThreads, 2)
    mpacked_bf16_kernel(const TX* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ cc, int* __restrict__ codes,
                        long long n, int d, int m, long long rows_per_block) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + kXBytes);
  float* ss = reinterpret_cast<float*>(smem + kXBytes + kWBytes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rt = warp >> 1, ct0 = (warp & 1) * 8;  // row tile, first column tile
  const long long mk = (long long)m * kCols;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(n, r_begin + rows_per_block);
  for (long long r0 = r_begin; r0 < r_end; r0 += kTile) {
    for (int i = 0; i < m; ++i) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) wmma::fill_fragment(acc[c], 0.f);
      for (int d0 = 0; d0 < d; d0 += kLoDepth) {
        // Loads first (W in 16-byte pieces: a row of a subspace's block
        // is 512 aligned bytes), then the stores, as in the fp32 body.
        float xv[kLoXPer];
        uint4 wv[kLoWPer];
#pragma unroll
        for (int u = 0; u < kLoXPer; ++u) {
          const int t = threadIdx.x + u * kThreads, rr = t / kLoDepth, dd = t % kLoDepth;
          const long long row = r0 + rr;
          xv[u] = (row < r_end && d0 + dd < d) ? to_f32(x[row * d + d0 + dd]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kLoWPer; ++u) {
          const int t = threadIdx.x + u * kThreads, dd = t / kPieces, c = (t % kPieces) * 8;
          wv[u] = d0 + dd < d ? *reinterpret_cast<const uint4*>(
                                    w + (long long)(d0 + dd) * mk + (long long)i * kCols + c)
                              : make_uint4(0u, 0u, 0u, 0u);
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kLoXPer; ++u) {
          const int t = threadIdx.x + u * kThreads;
          xs[(t / kLoDepth) * kLdX + t % kLoDepth] = __float2bfloat16_rn(xv[u]);
        }
#pragma unroll
        for (int u = 0; u < kLoWPer; ++u) {
          const int t = threadIdx.x + u * kThreads;
          *reinterpret_cast<uint4*>(ws + (t / kPieces) * kLdW + (t % kPieces) * 8) = wv[u];
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kLoDepth; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::load_matrix_sync(af, xs + rt * 16 * kLdX + kk, kLdX);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
            wmma::load_matrix_sync(bf, ws + kk * kLdW + (ct0 + c) * 16, kLdW);
            wmma::mma_sync(acc[c], af, bf, acc[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c)
        wmma::store_matrix_sync(ss + rt * 16 * kLdS + (ct0 + c) * 16, acc[c], kLdS,
                                wmma::mem_row_major);
      __syncthreads();
      const float* cci = cc + (size_t)i * kCols;
      for (int r = 0; r < 8; ++r) {
        const int rr = warp * 8 + r;
        int best_key = INT_MAX, best_col = lane;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = lane + 32 * c;
          const int key = orderable_key(__fadd_rn(ss[rr * kLdS + col], cci[col]));
          if (key < best_key) {
            best_key = key;
            best_col = col;
          }
        }
        const int col = warp_argmin(best_key, best_col);
        if (lane == 0 && r0 + rr < r_end) codes[(r0 + rr) * m + i] = col;
      }
    }
  }
}

template <typename TX, typename TW>
void launch_highest(const void* x, const void* w, const float* cc, int* codes,
                    long long n, int d, int m, long long rows_per_block, unsigned nblk,
                    cudaStream_t st) {
  mpacked_highest_kernel<TX, TW><<<nblk, kThreads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), cc, codes, n, d, m,
      rows_per_block);
}

template <typename TX>
int launch_bf16(const void* x, const void* w, const float* cc, int* codes, long long n,
                int d, int m, long long rows_per_block, unsigned nblk, cudaStream_t st) {
  const int err = (int)cudaFuncSetAttribute(
      mpacked_bf16_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kLoSmem);
  if (err != 0) return err;
  mpacked_bf16_kernel<TX><<<nblk, kThreads, kLoSmem, st>>>(
      static_cast<const TX*>(x), static_cast<const __nv_bfloat16*>(w), cc, codes, n, d, m,
      rows_per_block);
  return 0;
}

}  // namespace

// rows_per_block is a multiple of 64; tensor_cores selects "default"
// (W must then be bf16).
extern "C" int vq_mpacked_encode(const void* x, int x_is_bf16, const void* w,
                                 int w_is_bf16, const float* cc, int* codes,
                                 long long n, int d, int m, int tensor_cores,
                                 long long rows_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nblk = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  using bf = __nv_bfloat16;
  if (tensor_cores) {
    if (!w_is_bf16) return (int)cudaErrorInvalidValue;
    const int err = x_is_bf16 ? launch_bf16<bf>(x, w, cc, codes, n, d, m, rows_per_block, nblk, st)
                              : launch_bf16<float>(x, w, cc, codes, n, d, m, rows_per_block, nblk, st);
    if (err != 0) return err;
  } else if (x_is_bf16) {
    if (w_is_bf16)
      launch_highest<bf, bf>(x, w, cc, codes, n, d, m, rows_per_block, nblk, st);
    else
      launch_highest<bf, float>(x, w, cc, codes, n, d, m, rows_per_block, nblk, st);
  } else {
    if (w_is_bf16)
      launch_highest<float, bf>(x, w, cc, codes, n, d, m, rows_per_block, nblk, st);
    else
      launch_highest<float, float>(x, w, cc, codes, n, d, m, rows_per_block, nblk, st);
  }
  return (int)cudaGetLastError();
}
