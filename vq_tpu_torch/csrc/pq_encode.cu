// K4: exact PQ encode. x [n, m*s] (f32 or bf16) against codebooks
// [m, k, s] f32 -> codes [n, m] i32, the int2 argmin of
// ||c||^2 - 2 x_s.c per subspace. Its scan (pq_scan) is also K3's first
// launch (pq_lloyd.cu), which keeps the minimum score too.
//
// Replaces vq_tpu/ops/pallas_kernels.py::_pq_encode_kernel (reached
// through pq_encode_fused / _pq_encode_fused_jit), and, in the
// tensor-core kernel at the end of this file, its two lower-precision
// bodies K4-bf16 (_pq_encode_bf16_kernel) and K4-bf16x3
// (_pq_encode_bf16x3_kernel).
//
// What bounds it on the card: 2*n*m*k*s FP32 instructions, each term a
// separately rounded multiply and add (no FMA, no tensor cores: TF32 or
// bf16 would move argmins near ties). At 1M x 128 against 8x256x16 that
// is 6.55e10 instructions against 512 MB of x: at 132 SMs x 128 lanes x
// 1.98 GHz no design under this contract beats ~1.96 ms, and x's read
// takes 0.15 ms. The epilogue (cc - 2 dot, the compare, the selects)
// adds ~6 instructions a score to the 2s of its dot, a fifth more at
// s = 16.
//
// Design (256 threads, the register tiles of K1 in assign.cu with the
// roles of the operands turned round for PQ's narrow subspaces):
//  - each thread holds an 8 x 8 register tile of dots: rows ty + 16r and
//    centroids tx + 16j (r, j < 8; tx = lane % 16, ty = 2 warp +
//    lane / 16), a block 128 rows x 128 centroids a pass, and reads its
//    operands as float4s along e from shared memory laid out [e / 4]
//    [row][4]: a thread's 8 rows (centroids) sit 64 floats apart, the 8
//    lanes of a load phase read 128 consecutive bytes (no bank conflict,
//    no padding) and one x row (a broadcast). An e step is an 8 x 8 outer
//    product; 16 LDS.128 feed 512 FP instructions;
//  - resident mode (the codebook of a subspace and its norms fit beside
//    the ring, 17 KB at 8x256x16): block (c, i) keeps subspace i's
//    codebook, padded with zeros to a multiple of 128 centroids, in
//    opted-in dynamic shared memory and walks its range of row tiles,
//    which stream through a 3-stage (2 where 3 do not fit) cp.async ring;
//    each 128-row tile takes ceil(k / 128) passes over the codebook with
//    no barrier between them;
//  - streamed mode (e.g. 1x4096x64, a 1 MB subspace): block (t, i) owns
//    row tile t of subspace i and the codebook streams past it as
//    [128 centroids x 64 e] slices, each with the tile's x slice, through
//    a 3-stage ring, K1's arrangement with its arithmetic. Every n, k and
//    s >= 1 runs in one launch in one of the two modes;
//  - copies are 16 bytes where s % 4 == 0 and the operand is aligned, 4
//    otherwise, zero-filled past n, k and s; bf16 x is loaded by the
//    threads, widened exactly and stored as floats;
//  - every dot adds its e terms in ascending order, one __fmul_rn and
//    one __fadd_rn at a time, as the plain version does (which starts
//    from +0.0; the scan starts from the first product, which changes at
//    most the sign of a zero dot and never a score: mac_tile); the zeros
//    past s add +0 (0 * 0 = +0), which changes a sum at most in the
//    sign of a zero;
//  - after each pass a thread folds its 8 x 8 scores cc - 2 dot into a
//    running (score, index) minimum a row, by a strict less-than over its
//    ascending centroids from (NaN, 0) that lets no NaN in (fold); at the
//    end of the tile the 16 threads of a row (one half-warp) merge by the
//    lexicographic (orderable key, index) minimum through shuffles. That
//    is the int2 rule over the whole row (NaN never wins unless every
//    score is NaN, -0.0 equals +0.0, ties go to the lowest index),
//    whatever the merge order.
// The TPU kernel's k padding to 128 lanes (cc = +inf) is not needed: a
// centroid at or past k is never folded, so no index >= k can come out.
#include <cstdint>

#include "common.cuh"
#include "tile_scan.cuh"

using namespace vqk;

namespace {

constexpr int kBM = 128;  // rows of an x tile
constexpr int kBN = 128;  // centroids a pass
constexpr int kBK = 64;   // streamed mode: dimensions a ring slice
constexpr int kTM = 8, kTN = 8;  // register tile: rows x centroids a thread
constexpr int kScanThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kSlice = kBN * kBK;  // floats of a streamed slice, [16][128][4]
constexpr int kStreamStages = 3;

// Starts copying rows [r0, r0 + nr) and columns [e0, e0 + 4 q4) of src
// (row stride ld; rows past `rows` and columns past `width` read as 0)
// into dst, laid out [q][nr][4]: column e0 + 4q + u of row r0 + r at
// dst[(q nr + r) 4 + u]. f32 goes by cp.async, 16-byte copies where vec
// (width % 4 == 0, src 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, long long ld,
                                      long long r0, int nr, long long rows, int width, int e0,
                                      int q4, bool vec) {
  if (vec) {
    for (int t = threadIdx.x; t < nr * q4; t += kScanThreads) {
      const int r = t / q4, q = t - r * q4;
      const long long row = r0 + r;
      const int e = e0 + 4 * q;
      const bool ok = row < rows && e < width;
      cp_async16(dst + (q * nr + r) * 4, ok ? src + row * ld + e : src, ok);
    }
  } else {
    const int w = 4 * q4;
    for (int t = threadIdx.x; t < nr * w; t += kScanThreads) {
      const int r = t / w, c = t - r * w;
      const long long row = r0 + r;
      const bool ok = row < rows && e0 + c < width;
      cp_async4(dst + ((c >> 2) * nr + r) * 4 + (c & 3), ok ? src + row * ld + e0 + c : src, ok);
    }
  }
}

// bf16 by the threads, four 4-wide chunks a thread at a time (8-byte
// loads where vec: width % 4 == 0, src 8-byte aligned), widened exactly
// and stored as float4s in the same layout.
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* __restrict__ src,
                                      long long ld, long long r0, int nr, long long rows,
                                      int width, int e0, int q4, bool vec) {
  constexpr int kU = 4;
  const int total = nr * q4;
  for (int base = threadIdx.x; base < total; base += kU * kScanThreads) {
    float4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = base + u * kScanThreads;
      const int r = t / q4, e = e0 + 4 * (t - r * q4);
      const long long row = r0 + r;
      const bool ok = t < total && row < rows;
      const __nv_bfloat16* p = src + (ok ? row * ld + e : 0);
      if (ok && vec && e < width) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        v[u] = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        const int lim = ok ? width - e : 0;  // valid columns of the chunk
        v[u] = make_float4(lim > 0 ? to_f32(p[0]) : 0.f, lim > 1 ? to_f32(p[1]) : 0.f,
                           lim > 2 ? to_f32(p[2]) : 0.f, lim > 3 ? to_f32(p[3]) : 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = base + u * kScanThreads;
      if (t < total) {
        const int r = t / q4, q = t - r * q4;
        *reinterpret_cast<float4*>(dst + (q * nr + r) * 4) = v[u];
      }
    }
  }
}

// acc[r][j] += x[row r] . c[centroid j] over the 4 e of group q. xp:
// this thread's first row (ty) in a [q][128][4] tile; cp: its first
// centroid (tx) in a [q][cn][4] block, cq = 4 cn floats a group. kFresh:
// the sums start at this group's first product (acc's value is dropped).
template <bool kFresh>
__device__ __forceinline__ void mac_group(const float* xp, const float* cp, int q, int cq,
                                          float (&acc)[kTM][kTN]) {
  float4 xv[kTM], cv[kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r) xv[r] = *reinterpret_cast<const float4*>(xp + q * 4 * kBM + 64 * r);
#pragma unroll
  for (int j = 0; j < kTN; ++j) cv[j] = *reinterpret_cast<const float4*>(cp + q * cq + 64 * j);
#pragma unroll
  for (int e = 0; e < 4; ++e)  // one e step: an 8 x 8 outer product
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (kFresh && e == 0)
          acc[r][j] = __fmul_rn(at(xv[r], e), at(cv[j], e));
        else
          mac(acc[r][j], at(xv[r], e), at(cv[j], e));
      }
}

// acc over q4 float4 groups of e, ascending; fresh: a new sum, else acc's
// is continued. A new sum starts at its first product p0, where the plain
// version adds p0 to +0.0: the two differ only where p0 = -0.0, and then
// every partial sum differs at most in the sign of a zero. A dot of +-0
// gives the same score cc - 2 dot (cc is +0.0 or more, or NaN), so codes
// and minimum scores stay bit-identical, and the zeroing of acc and 64
// adds a pass are saved.
__device__ __forceinline__ void mac_tile(const float* xp, const float* cp, int cq, int q4,
                                         bool fresh, float (&acc)[kTM][kTN]) {
  int q = 0;
  if (fresh) mac_group<true>(xp, cp, q++, cq, acc);
#pragma unroll 1
  for (; q < q4; ++q) mac_group<false>(xp, cp, q, cq, acc);
}

// Folds the scores cc - 2 dot of centroids j0 + tx + 16j (those below k)
// into this thread's running (score, index) minima by a strict less-than
// over its centroids in ascending order, from (NaN, 0). That is the int2
// rule on the float scores: sc replaces the best where !(sc >= best) and
// sc is a number, i.e. where sc < best or best is the starting NaN, so
// NaN never wins, -0.0 equals +0.0 and the lowest index keeps a tie. (A
// score is the result of a subtraction, which the card returns as the
// canonical NaN, 0x7FFFFFFF, the largest orderable key, so no NaN key
// could win under int2 either.) ccp[col] is ||c_col||^2.
__device__ __forceinline__ void fold(const float (&acc)[kTM][kTN], const float* ccp, int j0,
                                     int k, float (&best)[kTM], int (&bi)[kTM]) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int col = j0 + tx + 16 * j;
    if (col < k) {
      const float ccj = ccp[col];
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        const float sc = __fsub_rn(ccj, __fmul_rn(2.0f, acc[r][j]));
        if (!(sc >= best[r]) && sc == sc) {
          best[r] = sc;
          bi[r] = col;
        }
      }
    }
  }
}

// Merges the minima of each row's 16 threads (one half-warp) by the
// lexicographic (orderable key, index) minimum and writes the rows of the
// tile at row0 below `rows`: the code, and the minimum score where minval
// (key_to_f32 of its key: -0.0 comes out as +0.0).
__device__ __forceinline__ void write_rows(const float (&best)[kTM], const int (&bi)[kTM],
                                           long long row0, long long rows, int m, int i,
                                           int* __restrict__ codes, float* __restrict__ minval) {
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15, ty = 2 * (threadIdx.x >> 5) + (lane >> 4);
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    int key = orderable_key(best[r]), idx = bi[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const int ok = __shfl_xor_sync(0xffffffffu, key, off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      if (ok < key || (ok == key && oi < idx)) {
        key = ok;
        idx = oi;
      }
    }
    const long long row = row0 + ty + 16 * r;
    if (tx == 0 && row < rows) {
      codes[row * m + i] = idx;
      if (minval != nullptr) minval[row * m + i] = key_to_f32(key);
    }
  }
}

__device__ __forceinline__ void reset(float (&best)[kTM], int (&bi)[kTM]) {
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    best[r] = __int_as_float(INT_MAX);  // the canonical NaN: no score yet
    bi[r] = 0;
  }
}

// Resident mode: block (c, i) scans rows [c rpb, (c + 1) rpb) of
// subspace i. Shared memory: the codebook [q4][kp][4], its norms [kp],
// then `stages` x tiles [q4][128][4].
template <typename T>
__global__ void __launch_bounds__(kScanThreads, 1)
    pq_scan_resident(const T* __restrict__ x, const float* __restrict__ cb,
                     const float* __restrict__ cc, int* __restrict__ codes,
                     float* __restrict__ minval, long long n, int m, int k, int s, int stages,
                     long long rows_per_block, bool x_vec, bool c_vec) {
  extern __shared__ float4 smem4[];
  const int q4 = (s + 3) / 4, kp = (k + kBN - 1) / kBN * kBN;
  float* const cbs = reinterpret_cast<float*>(smem4);
  float* const ccs = cbs + 4 * kp * q4;
  float* const ring = ccs + kp;
  const int tile_floats = 4 * kBM * q4;
  const int i = blockIdx.y;
  const long long ld = (long long)m * s;
  const T* const xi = x + (long long)i * s;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  const int tiles = (int)((r1 - r0 + kBM - 1) / kBM);
  auto load_tile = [&](int t) {
    stage(ring + (t % stages) * tile_floats, xi, ld, r0 + (long long)t * kBM, kBM, r1, s, 0, q4,
          x_vec);
  };

  stage(cbs, cb + (size_t)i * k * s, s, 0, kp, k, s, 0, q4, c_vec);  // lands with tile 0
  for (int t = threadIdx.x; t < kp; t += kScanThreads) ccs[t] = t < k ? cc[(size_t)i * k + t] : 0.f;
  for (int t = 0; t < stages - 1; ++t) {
    if (t < tiles) load_tile(t);
    cp_async_commit();
  }
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15, ty = 2 * (threadIdx.x >> 5) + (lane >> 4);
  float acc[kTM][kTN], best[kTM];
  int bi[kTM];
  for (int t = 0; t < tiles; ++t) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (t + stages - 1 < tiles) load_tile(t + stages - 1);
    cp_async_commit();
    const float* xp = ring + (t % stages) * tile_floats + 4 * ty;
    reset(best, bi);
    for (int j0 = 0; j0 < k; j0 += kBN) {
      mac_tile(xp, cbs + 4 * (j0 + tx), 4 * kp, q4, true, acc);
      fold(acc, ccs, j0, k, best, bi);
    }
    write_rows(best, bi, r0 + (long long)t * kBM, r1, m, i, codes, minval);
  }
  cp_async_wait<0>();
}

// Streamed mode: block (t, i) scans row tile t of subspace i; step u of
// the ring holds centroid tile u / slices and e slice u % slices of both
// operands, [16][128][4] each.
template <typename T>
__global__ void __launch_bounds__(kScanThreads, 1)
    pq_scan_streamed(const T* __restrict__ x, const float* __restrict__ cb,
                     const float* __restrict__ cc, int* __restrict__ codes,
                     float* __restrict__ minval, long long n, int m, int k, int s, bool x_vec,
                     bool c_vec) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  const int i = blockIdx.y;
  const long long ld = (long long)m * s, row0 = (long long)blockIdx.x * kBM;
  const T* const xi = x + (long long)i * s;
  const float* const cbi = cb + (size_t)i * k * s;
  const int q4s = (s + 3) / 4;
  const int slices = (s + kBK - 1) / kBK;
  const int steps = ((k + kBN - 1) / kBN) * slices;
  auto load_step = [&](int u) {
    float* st = ring + (u % kStreamStages) * 2 * kSlice;
    const int e0 = (u % slices) * kBK, q4 = min(kBK / 4, q4s - e0 / 4);
    stage(st, cbi, s, (long long)(u / slices) * kBN, kBN, k, s, e0, q4, c_vec);
    stage(st + kSlice, xi, ld, row0, kBM, n, s, e0, q4, x_vec);
  };

  for (int u = 0; u < kStreamStages - 1; ++u) {
    if (u < steps) load_step(u);
    cp_async_commit();
  }
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15, ty = 2 * (threadIdx.x >> 5) + (lane >> 4);
  float acc[kTM][kTN], best[kTM];
  int bi[kTM];
  reset(best, bi);
  for (int u = 0; u < steps; ++u) {
    cp_async_wait<kStreamStages - 2>();
    __syncthreads();  // step u landed; every thread is done with step u - 1
    if (u + kStreamStages - 1 < steps) load_step(u + kStreamStages - 1);
    cp_async_commit();
    const float* st = ring + (u % kStreamStages) * 2 * kSlice;
    const int tile = u / slices, e0 = (u - tile * slices) * kBK;
    mac_tile(st + kSlice + 4 * ty, st + 4 * tx, 4 * kBN, min(kBK / 4, q4s - e0 / 4), e0 == 0,
             acc);
    if (e0 + kBK >= s) fold(acc, cc + (size_t)i * k, tile * kBN, k, best, bi);
  }
  cp_async_wait<0>();
  write_rows(best, bi, row0, n, m, i, codes, minval);
}

template <typename T>
int launch_scan(const T* x, const float* cb, const float* cc, int* codes, float* minval,
                long long n, int m, int k, int s, bool resident, int stages, int smem,
                long long rows_per_block, cudaStream_t st) {
  const bool x_vec = s % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0;
  const bool c_vec = s % 4 == 0 && (uintptr_t)cb % 16 == 0;
  if (resident) {
    int err = (int)cudaFuncSetAttribute(pq_scan_resident<T>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
    const dim3 grid((unsigned)((n + rows_per_block - 1) / rows_per_block), (unsigned)m);
    pq_scan_resident<T><<<grid, kScanThreads, smem, st>>>(x, cb, cc, codes, minval, n, m, k, s,
                                                          stages, rows_per_block, x_vec, c_vec);
  } else {
    int err = (int)cudaFuncSetAttribute(pq_scan_streamed<T>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
    const dim3 grid((unsigned)((n + kBM - 1) / kBM), (unsigned)m);
    pq_scan_streamed<T><<<grid, kScanThreads, smem, st>>>(x, cb, cc, codes, minval, n, m, k, s,
                                                          x_vec, c_vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

int vqk::pq_scan(const void* x, bool x_is_bf16, const float* cb, const float* cc, int* codes,
                 float* minval, long long n, int m, int k, int s, bool resident, int stages,
                 int smem, long long rows_per_block, cudaStream_t st) {
  if (x_is_bf16)
    return launch_scan(static_cast<const __nv_bfloat16*>(x), cb, cc, codes, minval, n, m, k, s,
                       resident, stages, smem, rows_per_block, st);
  return launch_scan(static_cast<const float*>(x), cb, cc, codes, minval, n, m, k, s, resident,
                     stages, smem, rows_per_block, st);
}

extern "C" int vq_pq_encode(const void* x, int x_is_bf16, const float* cb,
                            const float* cc, int* codes, long long n, int m,
                            int k, int s, int resident, int stages, int smem,
                            long long rows_per_block, void* stream) {
  return pq_scan(x, x_is_bf16 != 0, cb, cc, codes, nullptr, n, m, k, s,
                 resident != 0, stages, smem, rows_per_block,
                 static_cast<cudaStream_t>(stream));
}

// K4-bf16 and K4-bf16x3 on the tensor cores: the PQ encode with the dot
// taken at a lower precision. They replace vq_tpu/ops/pallas_kernels.py::
// _pq_encode_bf16_kernel (:404, called at :475) and
// _pq_encode_bf16x3_kernel (:420, called at :496), which run the same
// products on the TPU's matrix unit.
//
// * bf16 (kX3 = false): dot = sum_e bf(x_e) bf(c_e), summed in f32.
// * bf16x3 (kX3 = true): xh = bf(x), xl = bf(x - xh), (ch, cl) the
//   wrapper's split of the codebook; three dots hh = xh.ch, hl = xh.cl,
//   lh = xl.ch, each from zero, then dot = (hh + hl) + lh.
// The score is cc - 2 dot with cc = ||c||^2 in f32 from the f32 codebook,
// and the code its int2 argmin, as in K4.
//
// What bounds them on the card: at 1M x 128 against 8x256x16 the
// products are 67 GFLOP (201 for bf16x3), 0.07 (0.2) ms at 989 TFLOP/s;
// reading x is 512 MB, 0.153 ms at 3.35 TB/s. The epilogue is n m k =
// 2.1e9 scores on the CUDA cores, ~6 instructions each (cc - 2 dot, a
// share of a pair's fminf and index, the fold's compares and selects; 2
// more adds for bf16x3), ~0.4 ms at 132 SMs x 4 warp instructions a
// clock: it, not the products or x, bounds this design.
//
// Design (mma.sync m16n8k16, bf16 in, f32 accumulators; no shared memory):
//  - a warp owns RT tiles of 16 rows of one subspace (RT = 4 for s <= 16,
//    2 for s <= 32, 1 above; half that for bf16x3, whose three
//    accumulators a tile need the registers) and walks row groups strided
//    over the grid; its A fragments (x rounded to bf16 once a group with
//    __float2bfloat16_rn, as the plain version rounds; bf16 x is used as
//    it is) stay in registers for all of the subspace's centroids, and
//    the next group's x is loaded into registers while this one is
//    scanned (8-byte loads where s is even, zeros past s and n);
//  - the wrapper lays the bf16 codebook out in fragment order, [m][k / 8]
//    [s / 16][lane][4] (hi and lo side by side for bf16x3), zero-padded
//    to whole 8-centroid and 16-e tiles: one 8-byte (16-byte) load a lane
//    brings an n8 tile's B operand, from L1, for RT (3 RT) mmas, and the
//    next tile's is loaded while this one is folded; a zero e adds +0;
//  - s past 64 e runs in chunks of 4 k-steps, x reloaded a chunk;
//  - the epilogue works on the accumulator fragments, never through
//    shared memory: a thread holds rows g and g + 8 of each tile and
//    centroids 2 tq, 2 tq + 1 of each n8 tile; it takes the smaller score
//    of the pair, then folds it into a running (score, index) a row by
//    K4's strict less-than from (NaN, 0) (fold), with no branch; a centroid
//    at or past k has a NaN norm and is never folded; the 4 threads of a
//    quad then merge by the lexicographic (orderable key, index) minimum
//    through shuffles: the int2 rule.
// A tensor core adds a tile's 16 products in its own order, so a code may
// differ from the plain version's only at a float64 near tie, as on the
// TPU; where every partial sum is exact (small integers) the codes are
// bit-identical.
namespace {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

// d += a (16 x 16 bf16, row-major) * b (16 x 8 bf16, column-major), f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T>
struct XPair;  // two neighbouring e of a row, as loaded
template <>
struct XPair<float> {
  using type = float2;
};
template <>
struct XPair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

// Elements e and e + 1 of the subspace at p (zeros past s, or where !ok).
// vec: s is even and p 2-element aligned, so e < s implies e + 1 < s.
__device__ __forceinline__ float2 load_pair(const float* p, int e, int s, bool ok, bool vec) {
  if (!ok || e >= s) return make_float2(0.f, 0.f);
  if (vec) return __ldg(reinterpret_cast<const float2*>(p + e));
  return make_float2(__ldg(p + e), e + 1 < s ? __ldg(p + e + 1) : 0.f);
}

__device__ __forceinline__ __nv_bfloat162 load_pair(const __nv_bfloat16* p, int e, int s,
                                                    bool ok, bool vec) {
  __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
  if (!ok || e >= s) return v;
  if (vec) return *reinterpret_cast<const __nv_bfloat162*>(p + e);
  v.x = p[e];
  if (e + 1 < s) v.y = p[e + 1];
  return v;
}

// This thread's share of the A operands of RT 16-row tiles at row0 and KS
// k-steps from e0: v[r][q][j] holds row 16 r + g + 8 (j & 1), e = e0 +
// 16 q + 8 (j >> 1) + 2 tq and the e after it (the fragment's register j).
template <typename T, int RT, int KS>
__device__ __forceinline__ void load_x(typename XPair<T>::type (&v)[RT][KS][4], const T* xi,
                                       long long ld, long long row0, long long n, int e0, int s,
                                       bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + 16 * r + 8 * h + g;
      const bool ok = row < n;
      const T* p = xi + (ok ? row : 0) * ld;
#pragma unroll
      for (int q = 0; q < KS; ++q)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          v[r][q][2 * c + h] = load_pair(p, e0 + 16 * q + 8 * c + 2 * tq, s, ok, vec);
    }
}

// A fragments from the loaded pairs: ah = bf(x), and for bf16x3 al =
// bf(x - ah), each rounded to nearest even as the plain version rounds.
template <bool kX3, int RT, int KS>
__device__ __forceinline__ void to_frags(const float2 (&v)[RT][KS][4], uint32_t (&ah)[RT][KS][4],
                                         uint32_t (&al)[RT][KS][4]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int q = 0; q < KS; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = v[r][q][j];
        const __nv_bfloat162 h = __floats2bfloat162_rn(f.x, f.y);
        ah[r][q][j] = bits(h);
        if (kX3) {
          const float2 hf = __bfloat1622float2(h);
          al[r][q][j] = bits(__floats2bfloat162_rn(__fsub_rn(f.x, hf.x), __fsub_rn(f.y, hf.y)));
        }
      }
}

template <bool kX3, int RT, int KS>
__device__ __forceinline__ void to_frags(const __nv_bfloat162 (&v)[RT][KS][4],
                                         uint32_t (&ah)[RT][KS][4], uint32_t (&)[RT][KS][4]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int q = 0; q < KS; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) ah[r][q][j] = bits(v[r][q][j]);
}

// The B operand of one n8 tile and k-step, a lane's share: bf16 (uint2),
// or the high and low halves side by side (uint4).
template <bool kX3>
struct BFrag {
  using type = uint2;
};
template <>
struct BFrag<true> {
  using type = uint4;
};

// Loads n8 tile t's B operands (KS k-steps from q0; zeros past ksteps)
// and its two norms. fb: this lane's first operand of the subspace. A tile
// past the last (t >= kt) loads the last one's operands again, with NaN
// norms, so that none of its scores is folded.
template <bool kX3, int KS>
__device__ __forceinline__ void load_b(typename BFrag<kX3>::type (&b)[KS], float2& cc2,
                                       const typename BFrag<kX3>::type* fb, const float* cci,
                                       int t, int kt, int ksteps, int q0) {
  const int tc = t < kt ? t : kt - 1;
  const typename BFrag<kX3>::type* p = fb + (tc * ksteps + q0) * 32;
#pragma unroll
  for (int q = 0; q < KS; ++q)
    b[q] = KS == 1 || q0 + q < ksteps ? __ldg(p + 32 * q) : typename BFrag<kX3>::type{};
  cc2 = __ldg(reinterpret_cast<const float2*>(cci + 8 * tc + 2 * (threadIdx.x & 3)));
  if (t != tc) cc2 = make_float2(__int_as_float(INT_MAX), __int_as_float(INT_MAX));
}

// acc (+)= the dots of the RT row tiles with one n8 tile over KS k-steps:
// acc[0] = xh.ch, and for bf16x3 acc[1] = xh.cl, acc[2] = xl.ch.
template <bool kX3, int RT, int KS>
__device__ __forceinline__ void mma_tile(const uint32_t (&ah)[RT][KS][4],
                                         const uint32_t (&al)[RT][KS][4],
                                         const typename BFrag<kX3>::type (&b)[KS],
                                         float (&acc)[kX3 ? 3 : 1][RT][4]) {
#pragma unroll
  for (int q = 0; q < KS; ++q)
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if constexpr (kX3) {
        mma_bf16(acc[0][r], ah[r][q], b[q].x, b[q].y);
        mma_bf16(acc[1][r], ah[r][q], b[q].z, b[q].w);
        mma_bf16(acc[2][r], al[r][q], b[q].x, b[q].y);
      } else {
        mma_bf16(acc[0][r], ah[r][q], b[q].x, b[q].y);
      }
    }
}

// Folds the scores cc - 2 dot of one n8 tile (this thread's centroids col
// and col + 1) into the running (score, index) minima of its rows: the
// pair's smaller score (fminf passes over a NaN; the lower index on a tie,
// and where col + 1's score is NaN), then K4's strict less-than from
// (NaN, 0), which lets no NaN in. A centroid at or past k has a NaN norm,
// so its score is NaN and never folded. No branch: the tests are and-ed
// as bits, then selects.
template <bool kX3, int RT>
__device__ __forceinline__ void fold_tile(const float (&acc)[kX3 ? 3 : 1][RT][4], float2 cc2,
                                          int col, float (&best)[RT][2], int (&bi)[RT][2]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sc[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * h + u;
        const float dot =
            kX3 ? __fadd_rn(__fadd_rn(acc[0][r][j], acc[1][r][j]), acc[2][r][j]) : acc[0][r][j];
        sc[u] = __fsub_rn(u ? cc2.y : cc2.x, __fmul_rn(2.0f, dot));
      }
      const float lo = fminf(sc[0], sc[1]);
      const int at = lo == sc[0] ? col : col + 1;
      const bool take = !(lo >= best[r][h]) & (lo == lo);
      best[r][h] = take ? lo : best[r][h];
      bi[r][h] = take ? at : bi[r][h];
    }
}

template <bool kX3, int RT>
__device__ __forceinline__ void zero(float (&acc)[kX3 ? 3 : 1][RT][4]) {
#pragma unroll
  for (int p = 0; p < (kX3 ? 3 : 1); ++p)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][r][j] = 0.f;
}

// x [n, m*s] (T), frag: the bf16 codebook in fragment order (uint2 a lane
// and k-step, uint4 with the lo half for bf16x3), ccp [m, 8 ceil(k / 8)]
// the norms, NaN-padded; block (b, i) scans row groups b*4 + warp, then
// every gridDim.x * 4 groups on, of subspace i. kOne: s fits KS k-steps,
// so the A fragments stay in registers; else the KS-step chunks of x are
// reloaded a tile.
template <typename T, bool kX3, int RT, int KS, bool kOne>
__global__ void __launch_bounds__(kMmaThreads, kX3 ? 3 : 4)
    pq_encode_mma(const T* __restrict__ x, const void* __restrict__ frag,
                  const float* __restrict__ ccp, int* __restrict__ codes, long long n, int m,
                  int k, int s, bool vec) {
  using B = typename BFrag<kX3>::type;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int i = blockIdx.y;
  const int kt = (k + 7) / 8, ksteps = (s + 15) / 16, chunks = (ksteps + KS - 1) / KS;
  const long long ld = (long long)m * s;
  const T* const xi = x + (long long)i * s;
  const float* const cci = ccp + (size_t)i * 8 * kt;
  const B* const fb = static_cast<const B*>(frag) + (size_t)i * kt * ksteps * 32 + lane;
  const long long groups = (n + 16 * RT - 1) / (16 * RT);
  const long long stride = (long long)gridDim.x * kMmaWarps;
  long long grp = (long long)blockIdx.x * kMmaWarps + (threadIdx.x >> 5);
  typename XPair<T>::type raw[RT][KS][4];
  if (kOne && grp < groups) load_x<T, RT, KS>(raw, xi, ld, grp * 16 * RT, n, 0, s, vec);
  for (; grp < groups; grp += stride) {  // uniform across the warp
    const long long row0 = grp * 16 * RT;
    uint32_t ah[RT][KS][4], al[RT][KS][4];
    float best[RT][2];
    int bi[RT][2];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        best[r][h] = __int_as_float(INT_MAX);  // the canonical NaN: no score yet
        bi[r][h] = 0;
      }
    if constexpr (kOne) {
      to_frags<kX3, RT, KS>(raw, ah, al);
      if (grp + stride < groups)  // the next group's x lands while this one is scanned
        load_x<T, RT, KS>(raw, xi, ld, (grp + stride) * 16 * RT, n, 0, s, vec);
      B b[KS];
      float2 c;
      load_b<kX3, KS>(b, c, fb, cci, 0, kt, ksteps, 0);
      for (int t8 = 0; t8 < kt; ++t8) {
        float acc[kX3 ? 3 : 1][RT][4];
        zero<kX3, RT>(acc);
        mma_tile<kX3, RT, KS>(ah, al, b, acc);
        const float2 cc = c;
        load_b<kX3, KS>(b, c, fb, cci, t8 + 1, kt, ksteps, 0);  // lands while this tile is folded
        fold_tile<kX3, RT>(acc, cc, 8 * t8 + 2 * tq, best, bi);
      }
    } else {
      for (int t8 = 0; t8 < kt; ++t8) {
        float acc[kX3 ? 3 : 1][RT][4];
        zero<kX3, RT>(acc);
        float2 cc2;
        for (int c = 0; c < chunks; ++c) {
          load_x<T, RT, KS>(raw, xi, ld, row0, n, 16 * KS * c, s, vec);
          to_frags<kX3, RT, KS>(raw, ah, al);
          B b[KS];
          load_b<kX3, KS>(b, cc2, fb, cci, t8, kt, ksteps, KS * c);
          mma_tile<kX3, RT, KS>(ah, al, b, acc);
        }
        fold_tile<kX3, RT>(acc, cc2, 8 * t8 + 2 * tq, best, bi);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int key = orderable_key(best[r][h]), idx = bi[r][h];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const int ok = __shfl_xor_sync(0xffffffffu, key, off);
          const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
          if (ok < key || (ok == key && oi < idx)) {
            key = ok;
            idx = oi;
          }
        }
        const long long row = row0 + 16 * r + 8 * h + g;
        if (tq == 0 && row < n) codes[row * m + i] = idx;
      }
  }
}

template <typename T, bool kX3, int RT, int KS, bool kOne>
int launch_mma(const T* x, const void* frag, const float* ccp, int* codes, long long n, int m,
               int k, int s, int max_blocks, cudaStream_t st) {
  const long long groups = (n + 16 * RT - 1) / (16 * RT);
  const long long want = (groups + kMmaWarps - 1) / kMmaWarps;
  const long long blocks = want < max_blocks ? want : max_blocks;
  const bool vec = s % 2 == 0 && (uintptr_t)x % (2 * sizeof(T)) == 0;
  pq_encode_mma<T, kX3, RT, KS, kOne>
      <<<dim3((unsigned)blocks, (unsigned)m), kMmaThreads, 0, st>>>(x, frag, ccp, codes, n, m, k,
                                                                    s, vec);
  return (int)cudaGetLastError();
}

// Row tiles a warp by s: bf16 holds RT = 4 tiles of one k-step, bf16x3
// (three accumulators a tile) 2; wider subspaces hold fewer tiles of
// more k-steps, and past 64 e the x chunks are reloaded a tile.
template <typename T, bool kX3>
int launch_lowp(const T* x, const void* frag, const float* ccp, int* codes, long long n, int m,
                int k, int s, int max_blocks, cudaStream_t st) {
  constexpr int kRT = kX3 ? 2 : 4;
  if (s <= 16)
    return launch_mma<T, kX3, kRT, 1, true>(x, frag, ccp, codes, n, m, k, s, max_blocks, st);
  if (s <= 32)
    return launch_mma<T, kX3, kRT / 2, 2, true>(x, frag, ccp, codes, n, m, k, s, max_blocks, st);
  if (s <= 64)
    return launch_mma<T, kX3, 1, 4, true>(x, frag, ccp, codes, n, m, k, s, max_blocks, st);
  return launch_mma<T, kX3, 1, 4, false>(x, frag, ccp, codes, n, m, k, s, max_blocks, st);
}

}  // namespace

// x [n, m*s] (f32, or bf16 for bf16 alone: the wrapper upcasts a bf16 x
// for bf16x3, as the TPU caller does); frag and ccp as pq_encode_mma
// takes them; max_blocks: blocks a subspace, at most.
extern "C" int vq_pq_encode_lowp(const void* x, int x_is_bf16, const void* frag, const float* ccp,
                                 int* codes, long long n, int m, int k, int s, int max_blocks,
                                 int bf16x3, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16x3)
    return launch_lowp<float, true>(static_cast<const float*>(x), frag, ccp, codes, n, m, k, s,
                                    max_blocks, st);
  if (x_is_bf16)
    return launch_lowp<__nv_bfloat16, false>(static_cast<const __nv_bfloat16*>(x), frag, ccp,
                                             codes, n, m, k, s, max_blocks, st);
  return launch_lowp<float, false>(static_cast<const float*>(x), frag, ccp, codes, n, m, k, s,
                                   max_blocks, st);
}
