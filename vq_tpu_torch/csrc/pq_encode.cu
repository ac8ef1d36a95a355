// K4: exact PQ encode. x [n, m*s] (f32 or bf16) against codebooks
// [m, k, s] f32 -> codes [n, m] i32, the int2 argmin of
// ||c||^2 - 2 x_s.c per subspace. Its scan (pq_scan) is also K3's first
// launch (pq_lloyd.cu), which keeps the minimum score too.
//
// Replaces vq_tpu/ops/pallas_kernels.py::_pq_encode_kernel (reached
// through pq_encode_fused / _pq_encode_fused_jit), and, in the second
// kernel below, its two lower-precision bodies K4-bf16
// (_pq_encode_bf16_kernel) and K4-bf16x3 (_pq_encode_bf16x3_kernel).
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
                            int k, int s, int resident, int stages, int smem,
                            long long rows_per_block, void* stream) {
  return pq_scan(x, x_is_bf16 != 0, cb, cc, codes, nullptr, n, m, k, s,
                 resident != 0, stages, smem, rows_per_block,
                 static_cast<cudaStream_t>(stream));
}
