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
// tensor cores: TF32 or bf16 would move argmins near ties). That is
// 2*n*k*d FP32 instructions; at 10^6 x 1024 x 128, 2.62e11, and the card
// dispatches 132 SMs x 128 lanes x 1.98 GHz = 3.35e13 a second, so no design
// under this contract beats ~7.8 ms there. Everything else (x read once
// from HBM, the codebook from L2 once a block) is small beside it, so the
// design spends its instruction slots on the multiplies and adds.
//
// Design (block of 256 threads, 128 rows x 128 centroids a tile; the
// numbers are kBM, kBN, kBK, kStages and kTM x kTN below):
//  - each thread holds an 8 x 8 register tile of dots: rows ty + 16i and
//    centroids tx + 16j (i, j < 8; tx = lane % 16, ty = 2 warp + lane / 16),
//    and reads its operands from shared memory as float4s along e: 16
//    16-byte loads for 4 e steps, i.e. 512 FP instructions, one load per
//    32. An e step is an 8 x 8 outer product. Rows and centroids are
//    stored row-major with a stride of 68 floats in a slice (4 mod 32
//    banks): the eight lanes of a load phase read eight different
//    centroid rows in 32 different banks, and one x row (a broadcast);
//  - the block's x rows stay resident in opted-in dynamic shared memory
//    (stride d4 + 4 floats, d4 = d rounded up to 4) while all k centroids
//    stream past, when they fit beside the ring (d up to 244 in 227 KB);
//    otherwise (d = 960, GIST's width) each ring stage holds an x slice
//    too, with the same arithmetic;
//  - the centroids stream as [128 x 64] slices through a 3-stage cp.async
//    ring (16-byte copies where d % 4 == 0 and the pointer is aligned,
//    4-byte copies otherwise; zero-fill past k and d), one barrier a
//    slice: the next two slices load while the current one is multiplied.
//    f32 x comes in by cp.async too; bf16 x is loaded, widened (exactly)
//    and stored by the threads;
//  - every accumulator adds its e terms in ascending order, one __fmul_rn
//    and one __fadd_rn at a time, from +0.0, which is what the plain
//    version computes. Slices are padded with zeros in both operands past
//    d: 0 * 0 = +0 and acc + 0 = acc, since acc is never -0.0 (it starts
//    at +0.0, and a round-to-nearest sum is -0.0 only from two -0.0s);
//  - ||x||^2 is summed by every thread for its rows while the first
//    centroid tile passes, in the same order;
//  - after each tile a thread folds its 8 x 8 scores cc - 2 dot into a
//    running (key, index) minimum per row, by a strict < over its
//    ascending centroids from key INT_MAX at index 0; at the end the 16
//    threads of a row (one half-warp) merge by the lexicographic
//    (key, index) minimum through warp shuffles. That is the int2 rule
//    over the whole row, whatever the merge order. Minima are compared
//    unclamped; ||x||^2 is added and clamped once, at the end.
// The inner loop is those multiplies and adds, its 16 LDS.128 and a few
// address and loop instructions; at ~230 registers a thread one block
// (8 warps) fits an SM. On an H100 at 1980 MHz it runs at ~0.7 of the
// floor above: with two warps a scheduler, latency neither covers (the
// loads at the top of each 4-step group, barriers) costs the rest.
// Every n, k >= 1 and d >= 1 run in one launch.
#include <cstdint>

#include "common.cuh"
#include "tile_scan.cuh"

using namespace vqk;

namespace {

constexpr int kBM = 128;  // rows a block
constexpr int kBN = 128;  // centroids a tile
constexpr int kBK = 64;   // dimensions a ring slice
constexpr int kStr = kBK + 4;  // floats a row of a slice (4 mod 32 banks)
constexpr int kStages = 3;     // depth of the cp.async ring
constexpr int kTM = 8, kTN = 8;  // register tile: rows x centroids a thread
constexpr int kAssignThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kSliceFloats = kBN * kStr;  // one [128 x 68] slice
static_assert(kBM == kBN, "stage_async copies kBM rows of either operand");

// Starts copying columns [e0, e0 + w) of rows [r0, r0 + 128) of src
// [rows, d] f32 into dst (row stride dstr), zero past `rows` and past d.
// w is a multiple of 4; vec (d % 4 == 0, src 16-byte aligned) takes
// 16-byte copies, else 4-byte ones.
__device__ __forceinline__ void stage_async(float* dst, int dstr, const float* src,
                                            long long r0, long long rows, int d, int e0,
                                            int w, bool vec) {
  if (vec) {
    const int cpr = w / 4;
    for (int t = threadIdx.x; t < kBM * cpr; t += kAssignThreads) {
      const int r = t / cpr, e = 4 * (t - r * cpr);
      const long long row = r0 + r;
      const bool ok = row < rows && e0 + e < d;
      cp_async16(dst + r * dstr + e, ok ? src + row * d + e0 + e : src, ok);
    }
  } else {
    for (int t = threadIdx.x; t < kBM * w; t += kAssignThreads) {
      const int r = t / w, e = t - r * w;
      const long long row = r0 + r;
      const bool ok = row < rows && e0 + e < d;
      cp_async4(dst + r * dstr + e, ok ? src + row * d + e0 + e : src, ok);
    }
  }
}

// x's copy into dst: f32 x by cp.async (stage_async).
__device__ __forceinline__ void stage_x(float* dst, int dstr, const float* src, long long r0,
                                        long long n, int d, int e0, int w, bool vec) {
  stage_async(dst, dstr, src, r0, n, d, e0, w, vec);
}

// bf16 x by the threads: eight 4-wide chunks a thread at a time (8-byte
// loads where vec), widened exactly and stored as float4s.
__device__ __forceinline__ void stage_x(float* dst, int dstr,
                                        const __nv_bfloat16* __restrict__ src, long long r0,
                                        long long n, int d, int e0, int w, bool vec) {
  const int cpr = w / 4, total = kBM * cpr;
  for (int base = threadIdx.x; base < total; base += 8 * kAssignThreads) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = base + u * kAssignThreads;
      const int r = t / cpr, e = 4 * (t - r * cpr);
      const long long row = r0 + r;
      const bool ok = t < total && row < n;
      const __nv_bfloat16* p = src + row * d + e0 + e;
      if (ok && vec && e0 + e < d) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        v[u] = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        const int lim = ok ? d - (e0 + e) : 0;  // valid columns of the chunk
        v[u] = make_float4(lim > 0 ? to_f32(p[0]) : 0.f, lim > 1 ? to_f32(p[1]) : 0.f,
                           lim > 2 ? to_f32(p[2]) : 0.f, lim > 3 ? to_f32(p[3]) : 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = base + u * kAssignThreads;
      if (t < total) {
        const int r = t / cpr, e = 4 * (t - r * cpr);
        *reinterpret_cast<float4*>(dst + r * dstr + e) = v[u];
      }
    }
  }
}

// acc[i][j] += x[row i] . c[centroid j] over the slice's q4 float4
// groups of e, ascending (and ||x||^2 with kNorm). xp points at this
// thread's first row (ty) with row stride xstr, cp at its first centroid
// (tx) with row stride kStr.
template <bool kNorm>
__device__ __forceinline__ void mac_slice(const float* xp, int xstr, const float* cp, int q4,
                                          float (&acc)[kTM][kTN], float (&xx)[kTM]) {
#pragma unroll 1
  for (int q = 0; q < q4; ++q) {
    float4 xv[kTM], cv[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xp + 16 * i * xstr + 4 * q);
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      cv[j] = *reinterpret_cast<const float4*>(cp + 16 * j * kStr + 4 * q);
#pragma unroll
    for (int e = 0; e < 4; ++e)  // one e step: an 8 x 8 outer product
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        if (kNorm) mac(xx[i], at(xv[i], e), at(xv[i], e));
#pragma unroll
        for (int j = 0; j < kTN; ++j) mac(acc[i][j], at(xv[i], e), at(cv[j], e));
      }
  }
}

// xstr > 0: x resident (row stride xstr floats, ahead of the ring);
// xstr == 0: x sliced through the ring beside the centroids.
template <typename T>
__global__ void __launch_bounds__(kAssignThreads, 1)
    assign_kernel(const T* __restrict__ x, const float* __restrict__ c,
                  const float* __restrict__ cc, int* __restrict__ codes,
                  float* __restrict__ dists, long long n, int k, int d, int xstr,
                  bool x_vec, bool c_vec) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const bool resident = xstr > 0;
  const int d4 = (d + 3) & ~3;
  float* const ring = resident ? smem + kBM * xstr : smem;
  const int stage_floats = resident ? kSliceFloats : 2 * kSliceFloats;

  const int lane = threadIdx.x & 31;
  const int tx = lane & 15;                            // centroids tx + 16j
  const int ty = 2 * (threadIdx.x >> 5) + (lane >> 4);  // rows ty + 16i
  const long long row0 = (long long)blockIdx.x * kBM;
  const int slices = (d + kBK - 1) / kBK;
  const int steps = ((k + kBN - 1) / kBN) * slices;

  // Step t: centroid tile t / slices, e slice t % slices, into stage t % kStages.
  auto load_step = [&](int t) {
    float* st = ring + (t % kStages) * stage_floats;
    const int j0 = (t / slices) * kBN, e0 = (t % slices) * kBK;
    if (!resident) stage_x(st + kSliceFloats, kStr, x, row0, n, d, e0, kBK, x_vec);
    stage_async(st, kStr, c, j0, k, d, e0, kBK, c_vec);
  };

  constexpr bool kAsyncX = sizeof(T) == 4;
  if (resident && kAsyncX) {
    stage_x(smem, xstr, x, row0, n, d, 0, d4, x_vec);
    cp_async_commit();
  }
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) load_step(t);
    cp_async_commit();
  }
  if (resident && !kAsyncX) stage_x(smem, xstr, x, row0, n, d, 0, d4, x_vec);

  float acc[kTM][kTN], xx[kTM];
  int best_key[kTM], best_idx[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    xx[i] = 0.f;
    best_key[i] = INT_MAX;
    best_idx[i] = 0;
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step t landed; every thread is done with step t - 1
    if (t + kStages - 1 < steps) load_step(t + kStages - 1);
    cp_async_commit();

    const float* st = ring + (t % kStages) * stage_floats;
    const int tile = t / slices, e0 = (t - tile * slices) * kBK;
    const int q4 = min(kBK, d4 - e0) / 4;
    const float* xp = resident ? smem + ty * xstr + e0 : st + kSliceFloats + ty * kStr;
    const int xs = resident ? xstr : kStr;
    if (tile == 0)
      mac_slice<true>(xp, xs, st + tx * kStr, q4, acc, xx);
    else
      mac_slice<false>(xp, xs, st + tx * kStr, q4, acc, xx);

    if (e0 + kBK >= d) {  // last slice of the tile: fold it into the minima
      const int j0 = tile * kBN;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = j0 + tx + 16 * j;
        if (col < k) {
          const float ccj = __ldg(cc + col);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const int key = orderable_key(__fsub_rn(ccj, __fmul_rn(2.0f, acc[i][j])));
            if (key < best_key[i]) {
              best_key[i] = key;
              best_idx[i] = col;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i) acc[i][j] = 0.f;
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    int bk = best_key[i], bi = best_idx[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {  // within the row's half-warp
      const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ok < bk || (ok == bk && oi < bi)) {
        bk = ok;
        bi = oi;
      }
    }
    const long long row = row0 + ty + 16 * i;
    if (tx == 0 && row < n) {
      const float v = __fadd_rn(key_to_f32(bk), xx[i]);
      codes[row] = bi;
      dists[row] = isnan(v) ? v : fmaxf(v, 0.f);
    }
  }
}

template <typename T>
int launch_assign(const T* x, const float* c, const float* cc, int* codes, float* dists,
                  long long n, int k, int d, cudaStream_t st) {
  int dev = 0, optin = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != 0) return err;
  const int d4 = (d + 3) & ~3;
  const size_t ring = (size_t)kStages * kSliceFloats * sizeof(float);
  const size_t with_x = (size_t)kBM * (d4 + 4) * sizeof(float) + ring;
  const bool resident = with_x <= (size_t)optin;
  const size_t smem = resident ? with_x : 2 * ring;
  const bool x_vec = d % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0;
  const bool c_vec = d % 4 == 0 && (uintptr_t)c % 16 == 0;
  err = (int)cudaFuncSetAttribute(assign_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err != 0) return err;
  const unsigned nblk = (unsigned)((n + kBM - 1) / kBM);
  assign_kernel<T><<<nblk, kAssignThreads, smem, st>>>(x, c, cc, codes, dists, n, k, d,
                                                       resident ? d4 + 4 : 0, x_vec, c_vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vq_assign(const void* x, int x_is_bf16, const float* c,
                         const float* cc, int* codes, float* dists,
                         long long n, int k, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_assign(static_cast<const __nv_bfloat16*>(x), c, cc, codes, dists, n, k, d,
                         st);
  return launch_assign(static_cast<const float*>(x), c, cc, codes, dists, n, k, d, st);
}
