// K5: flat ADC scan with a per-tile top-`fetch`. tables [Q, m, k<=256]
// f32 and codes transposed [m, n] u8 (or sub-byte packed
// [ceil(m*b/8), n], b in {1, 2, 4}) -> vals [Q, T*128] f32 and ids
// [Q, T*128] i32, where tile t's best `fetch` candidates sit in lanes
// [t*128, t*128 + fetch) in ascending (value, id) order, padded with
// inf / -1.
//
// Replaces vq_tpu/ops/pallas_kernels.py::_adc_scan_topk_kernel (reached
// through adc_scan_topk_fused / _adc_scan_topk_jit).
//
// What bounds it on the card: not device memory (the codes are m bytes a
// vector, 8 MB at 1M x 8, which L2 holds; the output is 1 KB a tile) but
// the Q*n*m table lookups in shared memory (32 a clock an SM at best) and
// the selection's warp shuffles.
//
// Scoring: a block of 8 warps holds one query's table, zero-padded to
// kpad = 128 or 256 entries a subspace as on the TPU (code &= kpad - 1),
// in shared memory when it fits in 48 KB, and read through L1 otherwise;
// warp w scores and selects tile blockIdx.x * 8 + w alone. It walks the
// tile in rounds of 256 columns: lane l owns two runs of 4 consecutive
// columns, 4l and 128 + 4l, and reads one u32 of codes_t a run and a row
// of it (coalesced, thanks to the [m, n] layout). Each column sums acc =
// +0.0, acc = acc + table[i][code_i] for i = 0..m-1 in fp32 (the plain
// version's order, so distances are bit-identical), then applies the mode:
// "sum" as is, "l2" max(qn2 - 2*acc + off, 0) (NaN kept), "dot" -acc.
//
// Selection: each column becomes the 64-bit word (orderable key with its
// sign bit flipped) << 32 | column in the tile, so a tile's words are
// distinct and their ascending order is the plain version's stable sort of
// keys. Columns past n or past the tile become ~0, which is above every
// word. The warp keeps the F smallest words seen, F = the power of two >=
// max(fetch, 32), sorted ascending in R = F/32 registers a lane (word
// r*32 + lane in register r). A round's 8 words a lane are first sorted in
// the lane's registers, and then, R registers at a time (the lanes' r-th
// smallest words), bitonic-sorted descending across the warp by shuffles
// and merged into the kept words: the elementwise min of an ascending and
// a descending list holds the F smallest of both, and log2(F) shuffle
// passes sort it again. A group whose smallest word in every lane is at
// or above the largest kept word (a ballot) ends the round, since every
// later word of each lane is larger. So the kept words are exactly the
// tile's F smallest, and lanes [0, fetch) of them, those whose key is below
// +inf's, are written; +inf and NaN scores and missing columns never are.
// No barrier runs after the table load, and no word touches shared memory.
#include <cstdint>

#include "common.cuh"

using namespace vqk;

namespace {

typedef unsigned long long u64;

constexpr int kTopLanes = 128;
constexpr int kWarps = 8;                   // tiles a block, one a warp
constexpr int kBlockThreads = 32 * kWarps;
constexpr int kCols = 8;                    // columns a lane a round: two runs of 4
constexpr int kRunGap = 128;                // second run's offset in the round
constexpr int kRoundCols = 32 * kCols;      // 256 columns a warp a round
constexpr u64 kNone = ~0ull;                // no column: above every word
constexpr unsigned kFull = 0xFFFFFFFFu;

enum AdcMode { kSum = 0, kL2 = 1, kDot = 2 };

__device__ __forceinline__ void order(u64& a, u64& b, bool up) {
  const bool swap = (b < a) == up;
  const u64 t = a;
  a = swap ? b : a;
  b = swap ? t : b;
}

// One bitonic pass over the warp's 32*R words, word e = r*32 + lane held in
// register r: the pairs at distance `stride` go ascending where
// (e & size) == 0, descending elsewhere, all reversed when `desc`.
template <int R>
__device__ __forceinline__ void pass(u64 (&v)[R], int size, int stride, bool desc, int lane) {
  if (stride >= 32) {
    const int rs = stride >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((r & rs) == 0) order(v[r], v[r | rs], (((r << 5) & size) == 0) != desc);
  } else {
    const bool lower = (lane & stride) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const u64 o = __shfl_xor_sync(kFull, v[r], stride);
      const bool up = ((((r << 5) | lane) & size) == 0) != desc;
      // keep the pair's min where lower == up, its max elsewhere
      v[r] = ((lower == up) == (o < v[r])) ? o : v[r];
    }
  }
}

template <int R>
__device__ __forceinline__ void warp_sort(u64 (&v)[R], bool desc, int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) pass<R>(v, size, stride, desc, lane);
}

// keep (ascending) <- the 32*R smallest of keep and d (descending),
// ascending.
template <int R>
__device__ __forceinline__ void merge_into(u64 (&keep)[R], const u64 (&d)[R], int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) keep[r] = d[r] < keep[r] ? d[r] : keep[r];
#pragma unroll
  for (int stride = 16 * R; stride > 0; stride >>= 1) pass<R>(keep, 32 * R, stride, false, lane);
}

__device__ __forceinline__ void lane_sort(u64 (&w)[kCols]) {
#pragma unroll
  for (int size = 2; size <= kCols; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        if ((i & stride) == 0) order(w[i], w[i | stride], (i & size) == 0);
}

// Codes of columns u..u+3 of one row (byte e in bits 8e..8e+7); columns at
// or past `lim` read 0. vec: one aligned u32 (u, lim multiples of 4).
__device__ __forceinline__ unsigned load_codes(const unsigned char* __restrict__ row, int u,
                                               int lim, bool vec) {
  if (vec) return u < lim ? __ldg(reinterpret_cast<const unsigned*>(row + u)) : 0u;
  unsigned v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (u + e < lim) v |= (unsigned)row[u + e] << (8 * e);
  return v;
}

// R: registers a lane of kept words (F = 32R); kSmem: the table sits in
// shared memory.
template <int R, bool kSmem>
__global__ void __launch_bounds__(kBlockThreads)
    adc_topk_kernel(const float* __restrict__ tables, const unsigned char* __restrict__ codes_t,
                    const float* __restrict__ qn2, const float* __restrict__ offsets,
                    float* __restrict__ vals, int* __restrict__ ids, int q0, int m, int k,
                    int kpad, long long n, int tile, int fetch, int mode, int pack_bits,
                    int ntiles, int vec) {
  extern __shared__ float tab_s[];  // [m][kpad] when kSmem
  const int q = q0 + blockIdx.y;
  const float* tq = tables + (size_t)q * m * k;
  if (kSmem) {
    for (int u = threadIdx.x; u < m * kpad; u += blockDim.x) {
      const int c = u % kpad;
      tab_s[u] = c < k ? tq[(u / kpad) * k + c] : 0.f;
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= ntiles) return;
  const long long col0 = (long long)t * tile;
  const int lim = (int)min((long long)tile, n - col0);  // columns of the tile that exist
  const int per = 8 / pack_bits;
  const int rows = (m + per - 1) / per;
  const int cmask = (1 << pack_bits) - 1;
  const float qn = mode == kL2 ? qn2[q] : 0.f;
  u64 keep[R];
#pragma unroll
  for (int r = 0; r < R; ++r) keep[r] = kNone;
  u64 bar = kNone;  // the largest kept word: a word at or above it stays out

  for (int r0 = 0; r0 < lim; r0 += kRoundCols) {
    const int u0 = r0 + 4 * lane;
    float acc[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] = 0.f;
    for (int ri = 0; ri < rows; ++ri) {
      const unsigned char* row = codes_t + (size_t)ri * n + col0;
      const unsigned b0 = load_codes(row, u0, lim, vec);
      const unsigned b1 = load_codes(row, u0 + kRunGap, lim, vec);
      const int i0 = ri * per;
      for (int j = 0; j < per && i0 + j < m; ++j) {
        const int i = i0 + j;
        const int sh = j * pack_bits;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const unsigned b = e < 4 ? b0 : b1;
          const int code = (int)((b >> (8 * (e & 3) + sh)) & cmask) & (kpad - 1);
          const float v = kSmem ? tab_s[i * kpad + code]
                                : (code < k ? __ldg(tq + i * k + code) : 0.f);
          acc[e] = __fadd_rn(acc[e], v);
        }
      }
    }
    u64 w[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int u = u0 + (e < 4 ? 0 : kRunGap) + (e & 3);
      w[e] = kNone;
      if (u < lim) {
        float a = acc[e];
        if (mode == kL2) {
          const float v =
              __fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, a)), __ldg(offsets + col0 + u));
          a = isnan(v) ? v : fmaxf(v, 0.f);
        } else if (mode == kDot) {
          a = -a;
        }
        // Signed key -> unsigned order by flipping the sign bit; the column
        // in the low word breaks ties toward the lower id.
        w[e] = ((u64)((unsigned)orderable_key(a) ^ 0x80000000u) << 32) | (unsigned)u;
      }
    }
    lane_sort(w);
#pragma unroll
    for (int g = 0; g < kCols / R; ++g) {
      if (!__any_sync(kFull, w[g * R] < bar)) break;
      u64 d[R];
#pragma unroll
      for (int r = 0; r < R; ++r) d[r] = w[g * R + r];
      warp_sort<R>(d, true, lane);
      merge_into<R>(keep, d, lane);
      bar = __shfl_sync(kFull, keep[R - 1], 31);
    }
  }

  const size_t out0 = ((size_t)q * ntiles + t) * kTopLanes;
#pragma unroll
  for (int r = 0; r < kTopLanes / 32; ++r) {
    const int e = r * 32 + lane;
    const u64 wd = r < R ? keep[r % R] : kNone;
    const int key = (int)((unsigned)(wd >> 32) ^ 0x80000000u);
    const bool hit = e < fetch && key < kInfKey;
    vals[out0 + e] = hit ? key_to_f32(key) : __int_as_float(kInfKey);
    ids[out0 + e] = hit ? (int)(col0 + (long long)(unsigned)wd) : -1;
  }
}

template <bool kSmem>
auto kernel_for(int fetch) {
  return fetch <= 32 ? &adc_topk_kernel<1, kSmem>
         : fetch <= 64 ? &adc_topk_kernel<2, kSmem> : &adc_topk_kernel<4, kSmem>;
}

}  // namespace

extern "C" int vq_adc_topk(const float* tables, const unsigned char* codes_t,
                           const float* qn2, const float* offsets, float* vals,
                           int* ids, int nq, int m, int k, int kpad,
                           long long n, int tile, int fetch, int mode,
                           int pack_bits, int tab_in_smem, int ntiles,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = tab_in_smem ? (size_t)m * kpad * sizeof(float) : 0;
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(codes_t) % 4 == 0;
  const auto kernel = tab_in_smem ? kernel_for<true>(fetch) : kernel_for<false>(fetch);
  const int kMaxGridY = 65535;
  for (int q0 = 0; q0 < nq; q0 += kMaxGridY) {
    const dim3 grid((unsigned)((ntiles + kWarps - 1) / kWarps),
                    (unsigned)min(kMaxGridY, nq - q0));
    kernel<<<grid, kBlockThreads, smem, st>>>(tables, codes_t, qn2, offsets, vals, ids, q0, m, k,
                                              kpad, n, tile, fetch, mode, pack_bits, ntiles, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
