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
// B3 (adc_gather_kernel), the gather design, laid out for the card's
// shared memory. Besides the output, Q*n*m random table lookups set its
// time: one 4-byte shared load a lookup costs ~3.5 wavefronts a warp on
// random codes, and K8's 16-byte load of 4 queries still lets the 8
// lanes of a quarter-warp (one phase of the load) hit 8 random 16-byte
// slots of the 32 banks, ~2.5 wavefronts a phase. Here every phase costs
// one wavefront on any codes:
//  * Tables. A block holds the tables of up to 16 queries (4 quads) in
//    shared memory as 128-byte lines, line (p, c) = [entry(2p, c) |
//    entry(2p + 1, c)], an entry (subspace i, code c) 64 bytes: one
//    float4 of 4 queries a quad. Subspace parity picks the half of the
//    banks, the quad the 16-byte slot within it. 128 KB at 8 x 256. The
//    block's own fill builds them; an absent query or an odd subspace
//    count leaves zeros. Where a u8 code can reach k (k < 256) each
//    subspace gets a zero entry at index k and a code is clamped to it
//    once a (row, subspace), not once a query (K8's rule); at k >= 256
//    there is no check.
//  * Lanes. A quarter-warp is two groups of 4 lanes; a group covers a row
//    set of 4 consecutive rows, lane l of it quad l, and keeps 4 rows x 4
//    queries = 16 sums in registers, each (query, row) sum formed by one
//    lane from +0.0 in ascending subspace order with __fadd_rn: B3
//    matches its plain version and K8 bit for bit.
//  * Skew. The second group runs one subspace behind the first, so at
//    every load the two groups read opposite halves: 8 distinct slots,
//    one wavefront a phase. The lag is carried across a thread's whole
//    row loop (one step a thread); an odd subspace count gets one idle
//    step a row set (a bubble), so the parities alternate across row sets
//    too.
//  * Codes: the 4 rows' codes of a subspace are one u32 of codes_t [m, n]
//    (the 4 lanes of a group load the same word), loaded a pass of 4
//    steps ahead. Output: a float4 of 4 rows a query, streamed past L2
//    (st.global.cs) so the codes stay there. Where the subspace count is
//    even, group 0 holds its finished sums one step, so that both groups
//    store at once: a warp's store writes whole 128-byte lines.
//  * One wave: as many blocks as the card holds (occupancy calculator),
//    the rows spread evenly over the blocks of a query group, so each
//    block fills its tables once. Where 16 queries' tables do not fit the
//    opt-in window (m = 40 at k = 256), the entries are read from device
//    memory through L1 / L2, 4 loads an entry: right, not fast. The plan
//    (tier, queries a block, shared bytes) is the wrapper's
//    (adc_vmem_bench.gather_plan); the launcher checks it and never falls
//    back. `subspaces` < m sums the first ones only (the script's `only`)
//    and fills only those.
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
constexpr int kRowsPerThread = 4;
constexpr int kGQueries = 16;     // queries a B3 block, at most: 4 quads
constexpr int kGThreads = 512;    // threads a B3 block: 16 warps of 32 rows
constexpr int kGTile = kGThreads; // rows a B3 block step (8 row sets a warp)
constexpr int kGChunk = 4;        // steps whose code words a B3 thread loads ahead
constexpr int kGLine = 128;       // bytes a B3 table line: 2 subspaces x 4 quads
constexpr int kGFill = 4;         // table slots a thread loads at a B3 fill step

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

__device__ __forceinline__ void add4(float4& a, const float4 v) {
  a.x = __fadd_rn(a.x, v.x);
  a.y = __fadd_rn(a.y, v.y);
  a.z = __fadd_rn(a.z, v.z);
  a.w = __fadd_rn(a.w, v.w);
}

__device__ __forceinline__ float comp(const float4 a, int l) {
  return l == 0 ? a.x : l == 1 ? a.y : l == 2 ? a.z : a.w;
}

// Block (g, b): queries [g queries, (g + 1) queries) against rows
// [b rows_per_block, (b + 1) rows_per_block), rows_per_block a multiple
// of kGTile. kSmem: the paired tier, the first `subspaces` tables as
// 128-byte lines in shared memory ((subspaces + 1) / 2 * kp * 128 bytes,
// kp = k + 1 where kClamp, else 256); otherwise the entries are read
// from device memory. kFast: a row set's steps fill whole passes and the
// codes load as u32 words (vec), so a pass runs its steps unchecked.
//
// A lane's steps: a row set takes `steps` (the subspaces, and a bubble
// where their count is odd), run in passes of kGChunk unrolled steps
// whose code words are loaded a pass ahead. Group 1 is one step behind
// group 0 throughout: at a row set's first step it is still on its
// previous row set's last step, with that step's word (`last`). No step
// is skipped: a bubble reads the zero half of the last line, a row set
// past the block's rows reads code 0, and the sums a lane makes before
// its first row set are dropped when it starts afresh.
template <bool kSmem, bool kClamp, bool kFast>
__global__ void __launch_bounds__(kGThreads)
    adc_gather_kernel(const float* __restrict__ tables, const unsigned char* __restrict__ codes_t,
                      float* __restrict__ out, int nq, int m, int k, long long n, int subspaces,
                      int queries, long long rows_per_block, int vec) {
  extern __shared__ float4 lines_s[];
  const int kp = kClamp ? k + 1 : 256;
  const int q0 = blockIdx.x * queries;
  const int qn = min(queries, nq - q0);  // queries of this block
  const int steps = subspaces + (subspaces & 1);
  if (kSmem) {
    // The fill: slot s of line (p, c) holds quad s % 4 of subspace
    // 2p + s / 4; kGFill slots a thread at a step, their loads issued
    // before the stores.
    const int cells = steps / 2 * kp * 8;
    for (int t0 = threadIdx.x; t0 < cells; t0 += kGFill * kGThreads) {
      float4 v[kGFill];
#pragma unroll
      for (int b = 0; b < kGFill; ++b) {
        const int t = t0 + b * kGThreads, line = t >> 3, p = line / kp, c = line - p * kp;
        const int i = 2 * p + ((t >> 2) & 1), quad = t & 3;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 4 * quad + e;
          x[e] = (t < cells && i < subspaces && c < k && q < qn)
                     ? __ldg(tables + ((size_t)(q0 + q) * m + i) * k + c)
                     : 0.f;
        }
        v[b] = make_float4(x[0], x[1], x[2], x[3]);
      }
#pragma unroll
      for (int b = 0; b < kGFill; ++b)
        if (t0 + b * kGThreads < cells) lines_s[t0 + b * kGThreads] = v[b];
    }
    __syncthreads();
  }

  // Lane 8h + 4g + l of a warp: quarter h, group g, quad l; the group's
  // row set is rows 4 (4g + h) .. + 3 of the warp's 32 in a block step.
  const int lane = threadIdx.x & 31, g = (lane >> 2) & 1, l = lane & 3;
  const int row_off = 32 * (threadIdx.x >> 5) + 4 * (4 * g + (lane >> 3));
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  const int tiles = (int)((r1 - r0 + kGTile - 1) / kGTile);
  const int passes = (steps + kGChunk - 1) / kGChunk;
  const int line_stride = kp * kGLine;  // bytes from line (p, c) to (p + 1, c)
  const bool even = (subspaces & 1) == 0;
  // off[s]: this lane's float4 at step s of a pass, past the pass's
  // first line: subspace s - g of the pass, its line (subspace / 2), half
  // (subspace % 2) and slot l; at a row set's first step group 1 reads
  // the last line's second half (`first`).
  int off[kGChunk];
#pragma unroll
  for (int s = 0; s < kGChunk; ++s)
    off[s] = ((s - g) >> 1) * line_stride + (((s - g) & 1) << 6) + (l << 4);
  const int first = g ? (steps / 2 - 1) * line_stride + 64 + (l << 4) : off[0];
  const char* tab = reinterpret_cast<const char*>(lines_s);
  const float* tq[4];  // device-memory tier: the tables of the quad's queries
#pragma unroll
  for (int e = 0; e < 4; ++e) tq[e] = tables + (size_t)(q0 + min(4 * l + e, qn - 1)) * m * k;

  float4 acc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  // The codes of pass p of block step t: one u32 a subspace (0 past the
  // subspaces and the block's rows).
  auto load_pass = [&](int t, int p, unsigned w[kGChunk]) {
    const long long j = r0 + (long long)t * kGTile + row_off;
    const bool ok = t < tiles && j < r1;
#pragma unroll
    for (int u = 0; u < kGChunk; ++u) {
      w[u] = 0;
      if (ok && kGChunk * p + u < subspaces) {
        const unsigned char* c = codes_t + (long long)(kGChunk * p + u) * n + j;
        if (kFast || vec) {
          w[u] = __ldg(reinterpret_cast<const unsigned*>(c));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j + e < n) w[u] |= (unsigned)__ldg(c + e) << (8 * e);
        }
      }
    }
  };
  // One step: the 4 rows' entries of subspace i (codes w) at `sub`.
  auto lookup = [&](unsigned w, int sub, int i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      unsigned c = (w >> (8 * e)) & 0xFF;
      if (kSmem) {
        if (kClamp) c = min(c, (unsigned)k);
        add4(acc[e], *reinterpret_cast<const float4*>(tab + sub + (c << 7)));
      } else if (i < subspaces && c < (unsigned)k) {
        const int at = i * k + (int)c;
        add4(acc[e], make_float4(__ldg(tq[0] + at), __ldg(tq[1] + at), __ldg(tq[2] + at),
                                 __ldg(tq[3] + at)));
      } else {
        add4(acc[e], make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  };
  // The sums of the row set at block step t (where it holds rows of the
  // block) to out, both groups at once: group 0's from `done` where the
  // count is even (it finished a step before group 1 and started its next
  // row set), else from acc; a lane that stored from acc starts afresh.
  float4 done[4];
  auto store = [&](int t) {
    const bool held = even && !g;
    float4 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = held ? done[e] : acc[e];
    const long long j = r0 + (long long)t * kGTile + row_off;
    if (t >= 0 && j < r1) {
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        if (4 * l + qq >= qn) break;
        float* o = out + (size_t)(q0 + 4 * l + qq) * n + j;
        if (kFast || (vec && j + 4 <= n)) {
          __stcs(reinterpret_cast<float4*>(o), make_float4(comp(v[0], qq), comp(v[1], qq),
                                                           comp(v[2], qq), comp(v[3], qq)));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j + e < n) __stcs(o + e, comp(v[e], qq));
        }
      }
    }
    if (!held) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  unsigned cur[kGChunk], last = 0;
  load_pass(0, 0, cur);
  for (int t = 0; t < tiles; ++t) {
    for (int p = 0; p < passes; ++p) {
      unsigned nxt[kGChunk];
      if (p + 1 < passes) load_pass(t, p + 1, nxt);
      else load_pass(t + 1, 0, nxt);
      const int base = kGChunk / 2 * p * line_stride;
#pragma unroll
      for (int s = 0; s < kGChunk; ++s) {
        const int sigma = kGChunk * p + s;
        if (!kFast && sigma >= steps) break;
        const bool wrap = s == 0 && p == 0;
        const unsigned w = g ? (s == 0 ? last : cur[s > 0 ? s - 1 : 0]) : cur[s];
        lookup(w, wrap ? first : base + off[s], wrap && g ? steps - 1 : sigma - g);
        if (wrap && even) store(t - 1);  // group 1 ends its previous row set
        last = cur[s];
      }
#pragma unroll
      for (int u = 0; u < kGChunk; ++u) cur[u] = nxt[u];
    }
    if (!even) {
      store(t);  // an odd count ends both groups' row sets on the bubble
    } else if (!g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) done[e] = acc[e], acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (even) {  // group 1's last step: the block's last row set, last subspace
    lookup(g ? last : 0u, first, steps - 1);
    store(tiles - 1);
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

// One wave of B3 blocks: as many as the card holds at once (by the
// occupancy calculator), the rows spread evenly over the blocks of a
// query group in whole block steps of kGTile rows.
using GatherKernel = void (*)(const float*, const unsigned char*, float*, int, int, int, long long,
                              int, int, long long, int);

int launch_gather(GatherKernel kernel, const float* tables, const unsigned char* codes_t,
                  float* out, int nq, int m, int k, long long n, int subspaces, int queries,
                  int smem, int vec, int sms, cudaStream_t st) {
  int err = 0, per_sm = 0;
  if (smem > 48 * 1024)
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGThreads, smem);
  if (err != 0) return err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (nq + queries - 1) / queries;
  const long long tiles = (n + kGTile - 1) / kGTile;
  const long long row_blocks = max(1LL, min(tiles, (long long)per_sm * sms / groups));
  const long long rows_per_block = (tiles + row_blocks - 1) / row_blocks * kGTile;
  const dim3 grid((unsigned)groups, (unsigned)((n + rows_per_block - 1) / rows_per_block));
  kernel<<<grid, kGThreads, smem, st>>>(tables, codes_t, out, nq, m, k, n, subspaces, queries,
                                        rows_per_block, vec);
  return (int)cudaGetLastError();
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

// B3's plan (adc_vmem_bench.gather_plan): `queries` a block (a multiple
// of 4, at most kGQueries), the paired tier's shared bytes, (subspaces +
// 1) / 2 lines of kp * 128 bytes (kp = k + 1 where k < 256, else 256), or
// 0 for the device-memory tier; vec: n % 4 == 0 (u32 code loads, float4
// stores). A plan that does not fit the card returns an error.
extern "C" int vq_adc_gather(const float* tables, const unsigned char* codes_t, float* out,
                             int nq, int m, int k, long long n, int subspaces, int queries,
                             int smem, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, optin = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != 0) return err;
  const bool clamp = k < 256;
  const long long paired = (long long)((subspaces + 1) / 2) * (clamp ? k + 1 : 256) * kGLine;
  if (queries < 4 || queries > kGQueries || queries % 4 != 0 || subspaces < 1 || subspaces > m ||
      (smem != 0 && (smem != paired || smem > optin)))
    return (int)cudaErrorInvalidValue;
  const bool fast = vec && (subspaces + (subspaces & 1)) % kGChunk == 0;
  GatherKernel kernel = adc_gather_kernel<false, false, false>;  // the device-memory tier
  if (smem != 0 && clamp)
    kernel = fast ? adc_gather_kernel<true, true, true> : adc_gather_kernel<true, true, false>;
  else if (smem != 0)
    kernel = fast ? adc_gather_kernel<true, false, true> : adc_gather_kernel<true, false, false>;
  return launch_gather(kernel, tables, codes_t, out, nq, m, k, n, subspaces, queries, smem, vec,
                       sms, st);
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
