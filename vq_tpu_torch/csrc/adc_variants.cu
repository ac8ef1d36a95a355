// B2, B3, B4: three designs of K8's function, the dense ADC table sum
// out[q, j] = sum over i of tables[q, i, codes_t[i, j]] (tables [Q, m, k]
// f32, codes_t [m, n] u8, out [Q, n] f32, added from +0.0 in ascending
// subspace order), and the bytes floor of its output.
//
// Replace benchmarks/adc_vmem_bench.py::_adc_kt_kernel (B2, the call at
// :79), ::_adc_gather_kernel (B3, :136) and ::_adc_floor_kernel (B4,
// :173).
//
// What bounds them on the card: the [Q, n] f32 output. At Q = 128 over
// 1M rows that is 512 MB written against 8 MB of codes and 1 MB of
// tables read, 0.156 ms at 3.35 TB/s; the Q*n*m = 1.0 G additions are
// 16 us at 67 TFLOP/s. B2's one-hot products are 3 * 2*Q*k*n*m = 1.57
// TFLOP of bf16, so its own design floor is 1.6 ms at 989 TFLOP/s.
//
// B2 (adc_kt_kernel), the experiment's matmul design on Hopper's
// warpgroup tensor cores (wgmma). The wrapper splits the tables once into
// three bf16 parts, hi = bf(t), mid = bf(t - hi), lo = bf(t - hi - mid)
// (exact for finite normal f32), and lays them out as slabs: one slab a
// (group of 32 queries, subspace), [boxes][96 columns][64 entries] bf16,
// the columns hi q0..q31, mid q0..q31, lo q0..q31, each 128-byte row
// swizzled (16-byte chunk c at c ^ (row % 8)), zero past k and past Q:
// exactly the shared-memory image of wgmma's 128-byte-swizzled K-major B
// operand. A persistent block (one an SM) walks units of 576 corpus rows
// x one query group. Its producer warpgroup copies the unit's slabs, one
// a subspace, into a ring of three stages with bulk copies (cp.async.bulk,
// the TMA engine) behind full / empty mbarriers; each slab is read from
// device memory once a unit and serves all three consumer warpgroups:
// 1.5 MiB of table parts a 576-row pass, 2.73 GB a call at [128, 1M].
// Each consumer warpgroup owns 192 rows, three 64-row m-tiles. For a
// subspace and an m-tile it runs one m64n96k16 wgmma a 16-entry k-step:
// A, the one-hot of the tile's codes, is built in registers (a thread
// compares the codes of its two fragment rows with the step's entries:
// no one-hot in shared memory, no barrier), B is the slab; the first step
// starts a fresh accumulator (scale-d 0), so the three parts' products
// land in separate columns, each one bf16 entry plus zeros, exact in f32.
// Then, elementwise and in subspace order, acc = acc + ((hi + mid) + lo)
// with __fadd_rn: B2 matches its plain version, B3 and K8 bit for bit on
// finite tables. A code >= k picks a zero column or none and adds 0, as
// on the TPU. A finished 192-row x 32-query tile goes through shared
// memory into whole rows of out[q, :] (16 bytes a thread where n % 4 ==
// 0), so a ragged Q or n stores only what exists. Registers: 48 of acc
// (3 tiles x 16) and 48 of the accumulator a thread, 152 a consumer
// thread after setmaxnreg (the producer keeps 40). Three consumer
// warpgroups keep the tensor cores fed while one adds its parts; two
// warpgroups of four tiles ran slower, and more wgmmas in flight slower
// still (ptxas serializes them).
//
// B3 (adc_gather_kernel), the gather design. The tables of a group of at
// most 8 queries sit in shared memory, as in K8 (read from device memory
// when one query's table does not fit). Each thread owns 4 consecutive
// rows: it reads one u32 of codes_t a subspace (coalesced, thanks to the
// [m, n] layout), keeps 4 x group sums in registers, added from +0.0 in
// subspace order, and writes float4s. `subspaces` < m stops early (the
// script's `only`). A code >= k adds 0.0, K8's rule.
//
// B4 (adc_floor_kernel): the same I/O with no lookup,
// out[q, j] = f32(codes_t[0, j]) + tables[0, 0, 0] for every q, one u32
// of codes read and float4s written: the card's practical floor for K8's
// output.
#include "common.cuh"
#include "hopper.cuh"

#include <cstdint>

using namespace vqk;

namespace {

constexpr int kKtQueries = 32;                 // queries a B2 group
constexpr int kKtN = 3 * kKtQueries;           // wgmma N: hi, mid, lo columns
constexpr int kKtTiles = 3;                    // 64-row m-tiles a consumer warpgroup
constexpr int kKtConsumers = 3;                // consumer warpgroups a block
constexpr int kKtWgRows = 64 * kKtTiles;       // rows a consumer warpgroup
constexpr int kKtRows = kKtConsumers * kKtWgRows;  // rows a unit
constexpr int kKtBox = kKtN * 128;             // bytes of a [96, 64] bf16 box
constexpr int kKtStages = 3;                   // slabs in the ring
constexpr int kKtPitch = kKtWgRows + 4;        // staging row pitch (floats)
constexpr int kKtThreads = 128 * (kKtConsumers + 1);  // + the producer warpgroup
// Registers a thread after setmaxnreg: 3 x 128 x 152 + 128 x 40 <= 65,536.
constexpr int kKtConsumerRegs = 152, kKtProducerRegs = 40;
constexpr int kGatherMax = 8;   // queries a B3 group, at most
constexpr int kRowsPerThread = 4;

__device__ __forceinline__ void load4(const unsigned char* __restrict__ row, long long j,
                                      long long n, bool vec, int c[4]) {
  if (vec) {
    const unsigned v = *reinterpret_cast<const unsigned*>(row + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = (v >> (8 * e)) & 0xFF;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = j + e < n ? row[j + e] : 0;
  }
}

__device__ __forceinline__ void store4(float* __restrict__ out, long long j, long long n,
                                       bool vec, const float v[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(out + j) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j + e < n) out[j + e] = v[e];
  }
}

// d (+)= A (4 registers of the m64k16 bf16 fragment) x B (desc); a fresh
// accumulator where `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n96k16(float d[48], const unsigned a[4],
                                                unsigned long long desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %52, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %53, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc));
}

// The accumulator's registers stay put across a wait (the compiler may
// not move their reads above it).
__device__ __forceinline__ void hold(float d[48]) {
#pragma unroll
  for (int x = 0; x < 48; ++x) asm volatile("" : "+f"(d[x])::"memory");
}

// acc += (hi + mid) + lo, elementwise: columns 8j + fc (+1) of n8-chunk j
// hold hi in chunks 0-3, mid in 4-7, lo in 8-11.
__device__ __forceinline__ void add_parts(float acc[16], const float d[48]) {
#pragma unroll
  for (int x = 0; x < 16; ++x)
    acc[x] = __fadd_rn(acc[x], __fadd_rn(__fadd_rn(d[x], d[x + 16]), d[x + 32]));
}

__global__ void __launch_bounds__(kKtThreads, 1)
    adc_kt_kernel(const unsigned char* __restrict__ slabs,
                  const unsigned char* __restrict__ codes_t, float* __restrict__ out, int nq,
                  int m, int ksteps, int slab_bytes, long long n, int groups,
                  long long units) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;  // the swizzle wants 1024-byte boxes
  float* staging = reinterpret_cast<float*>(smem_raw + (base - raw) + kKtStages * slab_bytes);
  const unsigned full = smem_u32(staging + kKtConsumers * kKtQueries * kKtPitch);
  const unsigned empty = full + 8 * kKtStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kKtStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kKtConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kKtConsumers) {  // the producer warpgroup: one slab a (unit, subspace)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kKtProducerRegs) : "memory");
    if (warp == 4 * kKtConsumers && lane == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const long long g = u % groups;
        for (int i = 0; i < m; ++i) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          bulk_load(base + stage * slab_bytes, slabs + (g * m + i) * slab_bytes, slab_bytes,
                    full + 8 * stage);
          if (++stage == kKtStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kKtConsumerRegs) : "memory");

  // A consumer warpgroup: rows j0 + [0, 192) of a unit, m-tile t's rows
  // 64t + 16 * (warp % 4) + lane / 4 (+ 8) in this thread's fragments.
  const int wg = warp >> 2, fr = 16 * (warp & 3) + (lane >> 2), fc = 2 * (lane & 3);
  float* stg = staging + wg * kKtQueries * kKtPitch;
  int stage = 0;
  unsigned phase = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int q0 = (int)(u % groups) * kKtQueries;
    const long long j0 = (u / groups) * kKtRows + wg * kKtWgRows;
    float acc[kKtTiles][16];
#pragma unroll
    for (int t = 0; t < kKtTiles; ++t)
#pragma unroll
      for (int x = 0; x < 16; ++x) acc[t][x] = 0.f;
    int next[kKtTiles][2];
    auto load_codes = [&](int i) {
#pragma unroll
      for (int t = 0; t < kKtTiles; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long j = j0 + 64 * t + fr + 8 * h;
          next[t][h] = j < n ? (int)__ldg(codes_t + (long long)i * n + j) : 0x7FFF;
        }
    };
    load_codes(0);
    for (int i = 0; i < m; ++i) {
      int code[kKtTiles][2];
#pragma unroll
      for (int t = 0; t < kKtTiles; ++t) code[t][0] = next[t][0], code[t][1] = next[t][1];
      if (i + 1 < m) load_codes(i + 1);
      mbar_wait(full + 8 * stage, phase);
      const unsigned slab = base + stage * slab_bytes;
#pragma unroll
      for (int t = 0; t < kKtTiles; ++t) {
        // Row h's one-hot entry code sits in the fragment's columns
        // fc, fc + 1 (register h) or fc + 8, fc + 9 (register 2 + h) of
        // k-step code / 16 only when (code - fc) % 16 is 0, 1, 8 or 9.
        int hit[2];
        unsigned lo[2], hi[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = code[t][h] - fc;
          hit[h] = r >= 0 && (r & 6) == 0 ? r >> 4 : -1;
          const unsigned one = 0x3F80u << ((r & 1) << 4);  // bf16 1.0, low or high half
          lo[h] = (r & 8) ? 0u : one;
          hi[h] = (r & 8) ? one : 0u;
        }
        // One k-step in flight while the next one's A is built: ptxas
        // serializes the wgmmas when an A register is written with more
        // in flight, or an accumulator read with any (C7513, C7514).
        float d[48];
        for (int s = 0; s < ksteps; ++s) {
          const unsigned a[4] = {hit[0] == s ? lo[0] : 0u, hit[1] == s ? lo[1] : 0u,
                                 hit[0] == s ? hi[0] : 0u, hit[1] == s ? hi[1] : 0u};
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
          wgmma_m64n96k16(d, a, sw128_desc(slab + (s >> 2) * kKtBox + (s & 3) * 32), s);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        hold(d);
        add_parts(acc[t], d);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == kKtStages) stage = 0, phase ^= 1;
    }

    // The tile through shared memory, [32 queries][192 rows], then whole
    // rows of out[q, :].
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
#pragma unroll
    for (int t = 0; t < kKtTiles; ++t)
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int q = 8 * (x >> 2) + fc + (x & 1), row = 64 * t + fr + 8 * ((x >> 1) & 1);
        stg[q * kKtPitch + row] = acc[t][x];
      }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    constexpr int kVecs = kKtWgRows / 4;  // float4s a query row
    for (int e = threadIdx.x & 127; e < kKtQueries * kVecs; e += 128) {
      const int q = e / kVecs, r = 4 * (e % kVecs);
      const long long j = j0 + r;
      if (q0 + q >= nq || j >= n) continue;
      const float4 v = *reinterpret_cast<const float4*>(stg + q * kKtPitch + r);
      float* o = out + (long long)(q0 + q) * n + j;
      if ((n & 3) == 0) {  // out is the wrapper's: rows start 16-byte aligned
        *reinterpret_cast<float4*>(o) = v;
      } else {
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j + c < n) o[c] = w[c];
      }
    }
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(256)
    adc_gather_kernel(const float* __restrict__ tables, const unsigned char* __restrict__ codes_t,
                      float* __restrict__ out, int nq, int m, int k, long long n, int group,
                      int subspaces, long long rows_per_block, int vec) {
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
  for (long long j = r0 + (long long)kRowsPerThread * threadIdx.x; j < r1;
       j += (long long)kRowsPerThread * blockDim.x) {
    float acc[kGatherMax][kRowsPerThread];
#pragma unroll
    for (int g = 0; g < kGatherMax; ++g)
#pragma unroll
      for (int e = 0; e < kRowsPerThread; ++e) acc[g][e] = 0.f;
    for (int i = 0; i < subspaces; ++i) {
      int c[kRowsPerThread];
      load4(codes_t + (long long)i * n, j, n, vec, c);
#pragma unroll
      for (int g = 0; g < kGatherMax; ++g) {
        if (g < gq) {
          const float* tq = tab + ((size_t)g * m + i) * k;
#pragma unroll
          for (int e = 0; e < kRowsPerThread; ++e)
            acc[g][e] = __fadd_rn(acc[g][e], c[e] < k ? tq[c[e]] : 0.f);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGatherMax; ++g)
      if (g < gq) store4(out + (long long)(q0 + g) * n, j, n, vec, acc[g]);
  }
}

__global__ void __launch_bounds__(256)
    adc_floor_kernel(const float* __restrict__ tables, const unsigned char* __restrict__ codes_t,
                     float* __restrict__ out, int nq, long long n, int q_per_block, int vec) {
  const long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kRowsPerThread;
  if (j >= n) return;
  const float t0 = tables[0];
  int c[kRowsPerThread];
  load4(codes_t, j, n, vec, c);
  float v[kRowsPerThread];
#pragma unroll
  for (int e = 0; e < kRowsPerThread; ++e) v[e] = __fadd_rn((float)c[e], t0);
  const int q1 = min(nq, (int)(blockIdx.y + 1) * q_per_block);
  for (int q = blockIdx.y * q_per_block; q < q1; ++q)
    store4(out + (long long)q * n, j, n, vec, v);
}

}  // namespace

// slabs: [groups, m, slab_bytes / 12288, 96, 64] bf16, the wrapper's
// swizzled layout (adc_vmem_bench.kt_slabs); ksteps: 16-entry k-steps a
// subspace (ceil(min(k, 256) / 16)); units: ceil(n / 576) * groups.
extern "C" int vq_adc_kt(const void* slabs, const unsigned char* codes_t, float* out, int nq,
                         int m, int ksteps, int slab_bytes, long long n, int groups,
                         long long units, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = 1024 + kKtStages * slab_bytes +
                   kKtConsumers * kKtQueries * kKtPitch * 4 + 16 * kKtStages;
  int err = (int)cudaFuncSetAttribute(adc_kt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
    return err;
  const unsigned grid = (unsigned)(units < sms ? units : sms);
  adc_kt_kernel<<<grid, kKtThreads, smem, st>>>(static_cast<const unsigned char*>(slabs), codes_t,
                                               out, nq, m, ksteps, slab_bytes, n, groups, units);
  return (int)cudaGetLastError();
}

// group <= 8 queries a block; tab_in_smem: the group's tables fit
// `smem` bytes; vec: n % 4 == 0 (u32 code loads, float4 stores).
extern "C" int vq_adc_gather(const float* tables, const unsigned char* codes_t, float* out,
                             int nq, int m, int k, long long n, int group, int tab_in_smem,
                             int subspaces, long long rows_per_block, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((n + rows_per_block - 1) / rows_per_block),
                  (unsigned)((nq + group - 1) / group));
  if (tab_in_smem) {
    const size_t smem = (size_t)group * m * k * sizeof(float);
    const int err = (int)cudaFuncSetAttribute(
        adc_gather_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
    adc_gather_kernel<true><<<grid, 256, smem, st>>>(tables, codes_t, out, nq, m, k, n, group,
                                                     subspaces, rows_per_block, vec);
  } else {
    adc_gather_kernel<false><<<grid, 256, 0, st>>>(tables, codes_t, out, nq, m, k, n, group,
                                                   subspaces, rows_per_block, vec);
  }
  return (int)cudaGetLastError();
}

extern "C" int vq_adc_floor(const float* tables, const unsigned char* codes_t, float* out,
                            int nq, long long n, int q_per_block, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long threads = (n + kRowsPerThread - 1) / kRowsPerThread;
  const dim3 grid((unsigned)((threads + 255) / 256),
                  (unsigned)((nq + q_per_block - 1) / q_per_block));
  adc_floor_kernel<<<grid, 256, 0, st>>>(tables, codes_t, out, nq, n, q_per_block, vec);
  return (int)cudaGetLastError();
}
