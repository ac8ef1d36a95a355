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
// Two bodies, as the TPU function's two precisions. At the twin's shape,
// 1M x 128 against 8 x 256, both do 2*n*d*m*256 = 524 GFLOP.
//
// * "highest" (mpacked_highest_kernel): exact fp32 on the CUDA cores. Each
//   score is sum_d x_d * W[d, j] from +0.0 in ascending d, one __fmul_rn
//   and __fadd_rn a term (-fmad=false), then + cc[j]: the plain version's
//   arithmetic, bit for bit. With W = build_w(cb) it gives K4's codes
//   exactly: x*(-2c) is -2*(x*c) exactly, the zero blocks add +-0.0 to a
//   +0.0 or nonzero sum, and (-2 dot) + cc is cc - 2 dot.
//   What bounds it: the rounding rule forbids FMAs, so the card issues
//   2*n*d*m*256 FP32 instructions at 132 SMs x 128 lanes x 1.98 GHz:
//   15.67 ms, twice the 7.8 ms of the fp32 peak. The first design reached
//   0.55 of that floor: it reloaded all of W for every 64-row tile, waited
//   on its global loads every 16 depths and read its operands as scalars.
//   This one is K1's design (csrc/assign.cu), which runs at ~0.7 of the
//   same kind of floor: blocks of 256 threads over 128-row x 128-column
//   tiles, 8 x 8 register tiles a thread fed by float4 loads from shared
//   memory (row stride 68 floats, 4 mod 32 banks), the block's x rows
//   resident in opted-in dynamic shared memory (sliced through the ring
//   with W when d > 244), and W's columns streamed as [128 x 64] slices
//   through a 3-stage cp.async ring, one barrier a slice. The wrapper
//   hands it W transposed once a call ([m*256, d] f32, 1 MiB at the
//   twin's shape), so a column is a row of depths, as K1's centroids. A
//   thread folds each finished 128-column tile into a running (key,
//   column) minimum a row by a strict < in ascending order; after the
//   subspace's second tile the 16 threads of a row merge by the
//   lexicographic (key, column) minimum and write codes[:, i]. A block
//   owns rows_per_block rows (a multiple of 128), one tile after another.
//
// * "default" (mpacked_wgmma_kernel): bf16 operands on Hopper's warpgroup
//   tensor cores (wgmma), f32 sums. The wrapper lays W out once a call as
//   the shared-memory image of wgmma's 128-byte-swizzled K-major B
//   operand (mpacked_encode.mpacked_image: bf16, one 32 KiB box a
//   subspace and 64 depths, zero past d); the kernel rounds an f32 x to
//   bf16 (to nearest even) as it stores it in the same image (a bf16 x is
//   stored as it is). The tensor cores sum in their own order, starting
//   from cc, so this body is held to its plain version (bf16-rounded
//   operands summed in ascending d, then + cc) by the near-tie rule, not
//   bit for bit.
//   What bounds it: the tensor cores, 0.53 ms at 989 TFLOP/s; reading x
//   (512 MB f32) takes 0.15 ms. The first design (wmma 16x16x16, 64-row
//   tiles) took 6.9 ms: it reloaded W for every tile, sent each [64, 256]
//   score tile through shared memory to a scalar argmin and overlapped
//   nothing. In this one a subspace is one wgmma m64n256k16 accumulator
//   (N = 256, 128 f32 registers a thread) that starts from cc, so the
//   argmin runs in registers on the finished scores: a thread holds
//   columns 8j + 2(lane % 4) (+1) of rows lane / 4 and lane / 4 + 8 of
//   its warp's 16, folds them in ascending order from (NaN, 0) as K4-bf16
//   does (a NaN never wins, -0.0 equals +0.0, the lower column keeps a
//   tie), and two __shfl_xor_sync steps (1, 2) in the quad keep the
//   lexicographic (key, column) minimum.
//   A persistent block (one an SM) has two consumer warpgroups and a
//   producer warpgroup; at 384 threads every thread has 168 registers,
//   which the consumers' 128-register accumulator and fold fit, so no
//   setmaxnreg. A unit is R = 256 rows: each consumer takes two 64-row
//   m-tiles and runs them one after the other for every subspace, A (x)
//   and B (W) both from shared memory; the two consumers run unsynchronised,
//   so one's fold overlaps the other's products. The producer's first
//   thread bulk-copies (cp.async.bulk) W's boxes, in subspace order, into
//   a ring behind full / empty mbarriers, so each box is read from L2
//   once a unit: (n / 256) x 512 KiB = 2.05 GB a call at the twin's
//   shape. Its other three warps convert x's m-tiles into a ring of x
//   slots, eight at d = 128 (the unit's four and the next unit's), with
//   eight 16-byte loads in flight a thread, through L2 only (L1 keeps cc).
//   At d = 128 that leaves room for three W boxes, a subspace and one
//   ahead; a deeper W ring would need fewer x slots, and measured slower.
//   Where R rows of x and a whole subspace's boxes do not fit in shared
//   memory (d > 192), R is 128, one m-tile a consumer, and x's k-slices
//   stream through the ring beside W's, converted again for every
//   subspace. Every n, d >= 1 and m >= 1 run in one launch; d is padded to
//   a multiple of 64 with zeros in both operands.
#include "common.cuh"
#include "hopper.cuh"
#include "tile_scan.cuh"

#include <cstdint>

using namespace vqk;

namespace {

constexpr int kCols = 256;  // columns of a subspace (the TPU function's k)

// "highest": K1's tile (csrc/assign.cu).
constexpr int kBM = 128;            // rows a tile
constexpr int kBN = 128;            // columns a tile: half a subspace
constexpr int kBK = 64;             // depths a ring slice
constexpr int kStr = kBK + 4;       // floats a row of a slice (4 mod 32 banks)
constexpr int kStages = 3;          // depth of the cp.async ring
constexpr int kTM = 8, kTN = 8;     // register tile: rows x columns a thread
constexpr int kHiThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kSliceFloats = kBN * kStr;

// "default": wgmma m64n256k16.
constexpr int kWBox = kCols * 128;  // bytes of a W box: 256 columns x 64 depths bf16
constexpr int kXBox = 64 * 128;     // bytes of an x box: 64 rows x 64 depths bf16
constexpr int kConsumers = 2;       // consumer warpgroups
constexpr int kLoThreads = 128 * (kConsumers + 1);
constexpr int kXFillers = 96;       // producer threads that fill x (its warps 1-3)
constexpr int kFillBatch = 8;       // x chunks a filler loads at a time

// ---------------------------------------------------------------------------
// "highest"
// ---------------------------------------------------------------------------

// Starts copying depths [e0, e0 + w) of rows [r0, r0 + 128) of src
// [rows, d] f32 into dst (row stride dstr), zero past `rows` and past d.
// w is a multiple of 4; vec (d % 4 == 0, src 16-byte aligned) takes
// 16-byte copies, else 4-byte ones.
__device__ __forceinline__ void stage_async(float* dst, int dstr, const float* src,
                                            long long r0, long long rows, int d, int e0,
                                            int w, bool vec) {
  if (vec) {
    const int cpr = w / 4;
    for (int t = threadIdx.x; t < kBM * cpr; t += kHiThreads) {
      const int r = t / cpr, e = 4 * (t - r * cpr);
      const long long row = r0 + r;
      const bool ok = row < rows && e0 + e < d;
      cp_async16(dst + r * dstr + e, ok ? src + row * d + e0 + e : src, ok);
    }
  } else {
    for (int t = threadIdx.x; t < kBM * w; t += kHiThreads) {
      const int r = t / w, e = t - r * w;
      const long long row = r0 + r;
      const bool ok = row < rows && e0 + e < d;
      cp_async4(dst + r * dstr + e, ok ? src + row * d + e0 + e : src, ok);
    }
  }
}

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
  for (int base = threadIdx.x; base < total; base += 8 * kHiThreads) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = base + u * kHiThreads;
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
        const int lim = ok ? d - (e0 + e) : 0;  // valid depths of the chunk
        v[u] = make_float4(lim > 0 ? to_f32(p[0]) : 0.f, lim > 1 ? to_f32(p[1]) : 0.f,
                           lim > 2 ? to_f32(p[2]) : 0.f, lim > 3 ? to_f32(p[3]) : 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = base + u * kHiThreads;
      if (t < total) {
        const int r = t / cpr, e = 4 * (t - r * cpr);
        *reinterpret_cast<float4*>(dst + r * dstr + e) = v[u];
      }
    }
  }
}

// acc[i][j] += x[row i] . w[column j] over the slice's q4 float4 groups
// of depths, ascending. xp points at this thread's first row (ty) with
// row stride xstr, wp at its first column (tx) with row stride kStr.
__device__ __forceinline__ void mac_slice(const float* xp, int xstr, const float* wp, int q4,
                                          float (&acc)[kTM][kTN]) {
#pragma unroll 1
  for (int q = 0; q < q4; ++q) {
    float4 xv[kTM], wv[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xp + 16 * i * xstr + 4 * q);
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      wv[j] = *reinterpret_cast<const float4*>(wp + 16 * j * kStr + 4 * q);
#pragma unroll
    for (int e = 0; e < 4; ++e)  // one depth: an 8 x 8 outer product
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) mac(acc[i][j], at(xv[i], e), at(wv[j], e));
  }
}

// x [n, d] (T, d >= 1), wt [m*256, d] f32 (W transposed). xstr > 0: x resident
// (row stride xstr floats, ahead of the ring); xstr == 0: x sliced through
// the ring beside W.
template <typename T>
__global__ void __launch_bounds__(kHiThreads, 1)
    mpacked_highest_kernel(const T* __restrict__ x, const float* __restrict__ wt,
                           const float* __restrict__ cc, int* __restrict__ codes, long long n,
                           int d, int m, long long rows_per_block, int xstr, bool x_vec,
                           bool w_vec) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const bool resident = xstr > 0;
  const int d4 = (d + 3) & ~3;
  float* const ring = resident ? smem + kBM * xstr : smem;
  const int stage_floats = resident ? kSliceFloats : 2 * kSliceFloats;

  const int lane = threadIdx.x & 31;
  const int tx = lane & 15;                              // columns tx + 16j
  const int ty = 2 * (threadIdx.x >> 5) + (lane >> 4);  // rows ty + 16i
  const int cols = m * kCols;
  const int slices = (d + kBK - 1) / kBK;
  const int steps = (cols / kBN) * slices;
  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(n, r_begin + rows_per_block);
  constexpr bool kAsyncX = sizeof(T) == 4;

  for (long long row0 = r_begin; row0 < r_end; row0 += kBM) {
    // Step t: column tile t / slices, depth slice t % slices, into stage
    // t % kStages.
    auto load_step = [&](int t) {
      float* st = ring + (t % kStages) * stage_floats;
      const int j0 = (t / slices) * kBN, e0 = (t % slices) * kBK;
      if (!resident) stage_x(st + kSliceFloats, kStr, x, row0, r_end, d, e0, kBK, x_vec);
      stage_async(st, kStr, wt, j0, cols, d, e0, kBK, w_vec);
    };
    if (resident && kAsyncX) {
      stage_x(smem, xstr, x, row0, r_end, d, 0, d4, x_vec);
      cp_async_commit();
    }
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < steps) load_step(t);
      cp_async_commit();
    }
    if (resident && !kAsyncX) stage_x(smem, xstr, x, row0, r_end, d, 0, d4, x_vec);

    float acc[kTM][kTN];
    int best_key[kTM], best_col[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      best_key[i] = INT_MAX;
      best_col[i] = 0;
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
      mac_slice(xp, resident ? xstr : kStr, st + tx * kStr, q4, acc);

      if (e0 + kBK >= d) {  // the tile's last slice: fold it into the minima
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int col = (tile & 1) * kBN + tx + 16 * j;  // column in the subspace
          const float ccj = __ldg(cc + tile * kBN + tx + 16 * j);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const int key = orderable_key(__fadd_rn(acc[i][j], ccj));
            if (key < best_key[i]) {
              best_key[i] = key;
              best_col[i] = col;
            }
            acc[i][j] = 0.f;
          }
        }
        if (tile & 1) {  // the subspace's second tile: its codes
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            int bk = best_key[i], bc = best_col[i];
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) {  // within the row's half-warp
              const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
              const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
              if (ok < bk || (ok == bk && oc < bc)) {
                bk = ok;
                bc = oc;
              }
            }
            const long long row = row0 + ty + 16 * i;
            if (tx == 0 && row < r_end) codes[row * m + (tile >> 1)] = bc;
            best_key[i] = INT_MAX;
            best_col[i] = 0;
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with this tile's x and ring
  }
}

template <typename T>
int launch_highest(const T* x, const float* wt, const float* cc, int* codes, long long n,
                   int d, int m, long long rows_per_block, cudaStream_t st) {
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
  const bool w_vec = d % 4 == 0 && (uintptr_t)wt % 16 == 0;
  err = (int)cudaFuncSetAttribute(mpacked_highest_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  const unsigned nblk = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  mpacked_highest_kernel<T><<<nblk, kHiThreads, smem, st>>>(
      x, wt, cc, codes, n, d, m, rows_per_block, resident ? d4 + 4 : 0, x_vec, w_vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "default"
// ---------------------------------------------------------------------------

// d += A x B, both operands by descriptor (K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], unsigned long long da,
                                                 unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// The accumulator's registers stay put across a wait (the compiler may
// not move their reads above it).
__device__ __forceinline__ void hold(float (&d)[128]) {
#pragma unroll
  for (int r = 0; r < 128; ++r) asm volatile("" : "+f"(d[r])::"memory");
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const unsigned*>(&h);
}

// Eight depths of an x row (a 16-byte chunk of bf16) as bf16, lim of
// them existing (the rest zero):
// f32 rounded to nearest even, bf16 as it is. vec: 16-byte loads (d % 4
// == 0 for f32, d % 8 == 0 for bf16, x 16-byte aligned), cached in L2
// only, so that L1 keeps cc.
__device__ __forceinline__ uint4 load8(const float* p, int lim, bool vec) {
  float v[8];
  if (vec && lim >= 4) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
    const float4 b = lim >= 8 ? __ldcg(reinterpret_cast<const float4*>(p + 4)) : make_float4(0, 0, 0, 0);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
    v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < lim ? p[e] : 0.f;
  }
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int lim, bool vec) {
  if (vec && lim >= 8) return __ldcg(reinterpret_cast<const uint4*>(p));
  unsigned h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = e < lim ? __bfloat16_as_ushort(p[e]) : 0u;
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
}

// Rows [row0, row0 + rows) of x (64 or 128), depths [k0, k0 + 64 kboxes),
// as bf16 in wgmma's image at dst: row r, depths k0 + 8p .. + 7 in box
// (r / 64) kboxes + p / 8, at byte (r % 64) 128 + ((p % 8) ^ (r % 8)) 16.
// Zero past n and past d. tid: this thread among the kXFillers, which
// take chunks tid, tid + kXFillers, ... (row r, chunk p stepped without
// a division), kFillBatch chunks' loads in flight.
template <typename T>
__device__ __forceinline__ void fill_x(unsigned char* dst, const T* __restrict__ x,
                                       long long row0, int rows, long long n, int d, int k0,
                                       int kboxes, bool vec, int tid) {
  const int cpr = 8 * kboxes, total = rows * cpr;
  const int dr = kXFillers / cpr, dp = kXFillers % cpr;
  int r = tid / cpr, p = tid % cpr;
  for (int e0 = tid; e0 < total; e0 += kFillBatch * kXFillers) {
    uint4 v[kFillBatch];
    int rq[kFillBatch], pq[kFillBatch];
#pragma unroll
    for (int q = 0; q < kFillBatch; ++q) {  // all the loads before the first store
      rq[q] = r, pq[q] = p;
      const int k = k0 + 8 * p;
      v[q] = e0 + q * kXFillers < total && row0 + r < n
                 ? load8(x + (row0 + r) * d + k, d - k, vec)
                 : make_uint4(0u, 0u, 0u, 0u);
      r += dr, p += dp;
      if (p >= cpr) p -= cpr, ++r;
    }
#pragma unroll
    for (int q = 0; q < kFillBatch; ++q)
      if (e0 + q * kXFillers < total)
        *reinterpret_cast<uint4*>(dst + ((rq[q] >> 6) * kboxes + (pq[q] >> 3)) * kXBox +
                                  (rq[q] & 63) * 128 + (((pq[q] & 7) ^ (rq[q] & 7)) << 4)) = v[q];
  }
}

// The block's units in order: groups of `group` consecutive units, group
// g to block g % gridDim.x. -1 after the last.
__device__ __forceinline__ long long next_unit(long long u, int group, long long units) {
  const long long v = u % group == group - 1 ? u + 1 + (long long)(gridDim.x - 1) * group : u + 1;
  return v < units ? v : -1;
}

__device__ __forceinline__ float min_num(float a, float b) {
  float r;
  asm("min.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));  // the number where one is NaN
  return r;
}

// One m-tile's codes for subspace i from its accumulator, which holds the
// scores cc + dot (rows row0 + 16w + lane / 4 (+ 8), w this thread's warp
// in its warpgroup; columns 8j + 2(lane % 4) (+1)): K4-bf16's fold from
// (NaN, 0) over the thread's columns in ascending order (a pair's min,
// its lower column unless only the upper is a number; taken where not >=
// the best and a number), then the lexicographic (key, column) minimum of
// the quad.
__device__ __forceinline__ void mtile_codes(const float (&acc)[128], long long row0, long long n,
                                            int m, int i, int* __restrict__ codes) {
  const int lane = threadIdx.x & 31, fc = 2 * (lane & 3);
  const long long r = row0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float best[2];
  int bi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best[h] = __int_as_float(INT_MAX);  // the canonical NaN: no score yet
    bi[h] = 0;
  }
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s0 = acc[4 * j + 2 * h], s1 = acc[4 * j + 2 * h + 1];
      const float lo = min_num(s0, s1);
      const int at = lo == s0 ? 8 * j : 8 * j + 1;
      const bool take = !(lo >= best[h]) & (lo == lo);
      best[h] = take ? lo : best[h];
      bi[h] = take ? at : bi[h];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int key = orderable_key(best[h]), col = bi[h] + fc;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const int ok = __shfl_xor_sync(0xffffffffu, key, off);
      const int oc = __shfl_xor_sync(0xffffffffu, col, off);
      if (ok < key || (ok == key && oc < col)) {
        key = ok;
        col = oc;
      }
    }
    if ((lane & 3) == 0 && r + 8 * h < n) codes[(r + 8 * h) * m + i] = col;
  }
}

// img: W's image, [m][kb][256 columns][64 depths] bf16, 128-byte rows
// swizzled. streamed == 0: units of 256 rows, x resident in `xslots`
// slots of one m-tile each, a ring of `stages` W boxes; streamed == 1:
// units of 128 rows, each of the `stages` ring stages a W box and the
// unit's two x boxes of the same depths. `group` units in a row to a
// block at a time.
template <typename T>
__global__ void __launch_bounds__(kLoThreads, 1)
    mpacked_wgmma_kernel(const T* __restrict__ x, const unsigned char* __restrict__ img,
                         const float* __restrict__ cc, int* __restrict__ codes, long long n,
                         int d, int m, int kb, int streamed, int stages, int xslots, int group,
                         long long units, int x_vec) {
  extern __shared__ unsigned char smem_raw[];
  // The swizzle wants 1024-byte boxes.
  unsigned char* const ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tiles = streamed ? 1 : 2;  // m-tiles a consumer takes a unit
  const int R = 128 * tiles;           // rows a unit
  const int stage_bytes = kWBox + (streamed ? 2 * kXBox : 0);
  const int slot_bytes = kb * kXBox;
  unsigned char* const xring = ring + stages * stage_bytes;
  const unsigned ring_a = smem_u32(ring), xring_a = smem_u32(xring);
  const unsigned full = xring_a + (streamed ? 0 : xslots * slot_bytes);
  const unsigned empty = full + 8 * stages, xfull = empty + 8 * stages;
  const unsigned xempty = xfull + 8 * xslots;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, streamed ? 1 + kXFillers : 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one arrival a consumer warp
    }
    for (int s = 0; s < (streamed ? 0 : xslots); ++s) {
      mbar_init(xfull + 8 * s, kXFillers);
      mbar_init(xempty + 8 * s, 4);  // the warps of the consumer that owns the m-tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup
    const long long first = (long long)blockIdx.x * group;
    if (warp == 4 * kConsumers) {  // W's boxes, in the consumers' order
      if (lane == 0) {
        int stage = 0;
        unsigned phase = 0;
        for (long long u = first; u >= 0; u = next_unit(u, group, units))
          for (int i = 0; i < m; ++i)
            for (int b = 0; b < kb; ++b) {
              mbar_wait(empty + 8 * stage, phase ^ 1);
              bulk_load(ring_a + stage * stage_bytes, img + ((long long)i * kb + b) * kWBox,
                        kWBox, full + 8 * stage);
              if (++stage == stages) stage = 0, phase ^= 1;
            }
      }
    } else {  // x, converted to bf16
      const int tid = threadIdx.x - 128 * kConsumers - 32;
      int slot = 0;
      unsigned phase = 0;
      for (long long u = first; u >= 0; u = next_unit(u, group, units)) {
        if (!streamed) {
          for (int f = 0; f < 2 * tiles; ++f) {  // m-tile f: consumer f % 2's (f / 2)-th
            mbar_wait(xempty + 8 * slot, phase ^ 1);
            fill_x(xring + slot * slot_bytes, x, u * R + 64 * f, 64, n, d, 0, kb, x_vec, tid);
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for wgmma
            mbar_arrive(xfull + 8 * slot);
            if (++slot == xslots) slot = 0, phase ^= 1;
          }
        } else {
          for (int i = 0; i < m; ++i)
            for (int b = 0; b < kb; ++b) {
              mbar_wait(empty + 8 * slot, phase ^ 1);
              fill_x(ring + slot * stage_bytes + kWBox, x, u * R, 128, n, d, 64 * b, 1, x_vec,
                     tid);
              asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
              mbar_arrive(full + 8 * slot);
              if (++slot == stages) slot = 0, phase ^= 1;
            }
        }
      }
    }
    return;
  }

  // A consumer warpgroup: m-tile t of a unit is rows u R + 64 (2t + c).
  const long long first = (long long)blockIdx.x * group;
  const int c = warp >> 2;
  float acc[128];
  int stage0 = 0, xs0 = 0;  // ring stage of the subspace's first box, x slot of the unit's first m-tile
  unsigned phase0 = 0, xp0 = 0;
  for (long long u = first; u >= 0; u = next_unit(u, group, units)) {
    for (int i = 0; i < m; ++i) {
      for (int t = 0; t < tiles; ++t) {
        const long long row0 = u * R + 64 * (2 * t + c);
        int xs = xs0 + 2 * t + c;
        unsigned xp = xp0;
        if (xs >= xslots && !streamed) xs -= xslots, xp ^= 1;
        if (!streamed && i == 0) mbar_wait(xfull + 8 * xs, xp);
        const bool release = t == tiles - 1;  // the subspace's last pass over its boxes
        int st = stage0, prev = stage0;
        unsigned ph = phase0;
        {  // the accumulator starts from cc: column 8j + 2(lane % 4) (+1) of both rows
          const float* ccb = cc + (size_t)i * kCols + 2 * (lane & 3);
          asm volatile("" : "+l"(ccb));  // one base register, immediate offsets
#pragma unroll
          for (int j = 0; j < kCols / 8; ++j) {
            const float2 c2 = __ldg(reinterpret_cast<const float2*>(ccb + 8 * j));
            acc[4 * j] = acc[4 * j + 2] = c2.x;
            acc[4 * j + 1] = acc[4 * j + 3] = c2.y;
          }
        }
        hold(acc);
        for (int b = 0; b < kb; ++b) {
          mbar_wait(full + 8 * st, ph);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
          const unsigned wa = ring_a + st * stage_bytes;
          const unsigned xa = streamed ? wa + kWBox + c * kXBox : xring_a + xs * slot_bytes + b * kXBox;
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_m64n256k16(acc, sw128_desc(xa + 32 * s), sw128_desc(wa + 32 * s));
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          if (release && b > 0) {  // box b - 1 is read: hand it back
            asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * prev);
          }
          prev = st;
          if (++st == stages) st = 0, ph ^= 1;
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        hold(acc);
        __syncwarp();
        if (release && lane == 0) mbar_arrive(empty + 8 * prev);
        if (!streamed && i == m - 1 && lane == 0) mbar_arrive(xempty + 8 * xs);
        if (release) stage0 = st, phase0 = ph;
        mtile_codes(acc, row0, n, m, i, codes);
      }
    }
    if (!streamed) {
      xs0 += 2 * tiles;
      if (xs0 >= xslots) xs0 -= xslots, xp0 ^= 1;
    }
  }
}

template <typename T>
int launch_wgmma(const T* x, const void* img, const float* cc, int* codes, long long n, int d,
                 int m, int kb, int streamed, int stages, int xslots, int group,
                 long long units, cudaStream_t st) {
  const int stage_bytes = kWBox + (streamed ? 2 * kXBox : 0);
  const int slots = streamed ? 0 : xslots;
  const int smem = 1024 + stages * stage_bytes + slots * kb * kXBox + 16 * (stages + slots);
  int err = (int)cudaFuncSetAttribute(mpacked_wgmma_kernel<T>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
    return err;
  const long long groups = (units + group - 1) / group;
  const unsigned grid = (unsigned)(groups < sms ? groups : sms);
  const int x_vec = d % (16 / (int)sizeof(T)) == 0 && (uintptr_t)x % 16 == 0;
  mpacked_wgmma_kernel<T><<<grid, kLoThreads, smem, st>>>(
      x, static_cast<const unsigned char*>(img), cc, codes, n, d, m, kb, streamed, stages,
      xslots, group, units, x_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// wt: W transposed, [m*256, d] f32; rows_per_block a multiple of 128.
extern "C" int vq_mpacked_highest(const void* x, int x_is_bf16, const float* wt,
                                  const float* cc, int* codes, long long n, int d, int m,
                                  long long rows_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_highest(static_cast<const __nv_bfloat16*>(x), wt, cc, codes, n, d, m,
                          rows_per_block, st);
  return launch_highest(static_cast<const float*>(x), wt, cc, codes, n, d, m, rows_per_block,
                        st);
}

// img: mpacked_encode.mpacked_image(W); kb: its 64-depth boxes a subspace;
// the rest as mpacked_encode.mpacked_plan reckons it (cc 8-byte aligned).
extern "C" int vq_mpacked_default(const void* x, int x_is_bf16, const void* img,
                                  const float* cc, int* codes, long long n, int d, int m,
                                  int kb, int streamed, int stages, int xslots, int group,
                                  long long units, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_wgmma(static_cast<const __nv_bfloat16*>(x), img, cc, codes, n, d, m, kb,
                        streamed, stages, xslots, group, units, st);
  return launch_wgmma(static_cast<const float*>(x), img, cc, codes, n, d, m, kb, streamed,
                      stages, xslots, group, units, st);
}
