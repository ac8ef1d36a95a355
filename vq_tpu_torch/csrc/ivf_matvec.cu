// K6: dots of per-(query, probe) vectors with the rows of their probed
// IVF chunks, at the rows' stored width. For each pair p: the left
// vector lhs [P, d] f32, that pair's chunk chain chunks [P, nc] i32
// (-1 = no chunk) and the row pool payload [n_chunks, ch, d] (f32, bf16,
// f16 or u8) -> out [P, nc*ch] with out[p, t] = sum_e lhs[p, e] * row[e]
// over row t % ch of chunk chunks[p, t / ch], summed from 0 in ascending
// e, one rounded multiply and one rounded add at a time. Positions
// t >= cap, and positions of a chunk id outside [0, n_chunks) (-1 marks
// no chunk), give 0, so no chunk id reads outside the pool.
//
// Replaces vq_tpu/ops/pallas_kernels.py::_ivf_matvec_kernel, reached
// through ivf_probe_matvec_fused / _ivf_probe_matvec_jit: IVF-Flat over
// raw f32 / bf16 / f16 rows, IVF-SQ over u8 codes (the caller folds the
// SQ step into the left vector and adds the affine offsets outside).
//
// What bounds it on the card: bytes, then the no-FMA arithmetic. Each
// probed chunk's rows once (ch x d x itemsize: 128 KB at f32, ch = 256,
// d = 128) and the output once (P x nc x ch x 4 bytes: 193 MB at 8192
// pairs x 23 chunks x 256 rows). Many pairs probe one chunk (at 128
// queries x nprobe 64 over IVF1024 of 1M rows, 82k live (pair, chunk)
// entries over 2,982 chunks, up to one a query), so a design that reads a
// chain a pair reads the rows ~27 times over. The arithmetic, a rounded
// multiply and a rounded add a live (pair, row, dimension), is 5.4e9
// FP32 instructions there, ~0.16 ms at the issue rate of an H100 SXM at
// 700 W and its 1980 MHz clock (132 SMs x 128 lanes): above the bytes
// at u8 and bf16, beside them at f32.
//
// Design: chunk-major, in two steps.
//  1. The work list (vq_ivf_matvec_plan): entry i = p * nc + s (pair p,
//     chain slot s) is live when its chunk id c is in [0, n_chunks) and
//     s * ch < cap. A stable counting sort by c puts chunk c's live
//     entries, in ascending i (so ascending pair), at work[offsets[c] ..
//     offsets[c + 1]). The entries are cut into segments of seg_len, one
//     warp (and block) a segment (entry_pass_kernel): 32 entries a step,
//     equal chunk ids ranked by __match_any_sync and one integer
//     atomicAdd a (chunk, segment) cell, whose returned count the warp
//     waits for, so steps land in order; counts into table [n_chunks,
//     segs] and totals [n_chunks]. Then one block
//     scans the totals into offsets, and each chunk's task count (a task:
//     up to kTaskEntries of its entries) into task offsets
//     (bin_scan_kernel); a warp a chunk turns its row of counts into each
//     segment's first slot and writes its tasks (bin_cursor_kernel); a
//     thread an entry places it (entry_scatter_kernel). Integer counts
//     only: the list is the same on every run. No host sync: the matvec
//     reads the task count from the device. K7 (ivf_probe.cu) runs the
//     same list over its pairs' bins, 4 a task (work_list.cuh).
//  2. The matvec (chunk_matvec_kernel), persistent: three blocks an SM,
//     block b taking tasks b, b + G, ... (G blocks), each task one chunk
//     read once for up to 32 entries, in tiles of 16 entries x 256 rows.
//     Each thread holds a 4 x 4 register tile (entries 4 pg + j of the
//     tile, rows 128 h + lane + 32 i), 16 independent sums. The chunk's
//     rows and the tile's 16 left vectors stream through a 3-stage
//     cp.async ring in slices of 64 bytes of a row (16 f32, 32 bf16 / f16
//     or 64 u8 dimensions), one ring for the block's whole walk over its
//     tasks, so loads stay in flight across task boundaries. Rows sit at
//     their stored width with an 80-byte stride (a warp's 16-byte reads
//     of eight rows hit all 32 banks once), left vectors as f32 rows
//     (read as broadcasts). Each thread reads 16 bytes of each of its
//     rows, widens them as it uses them (u8 by the 2^23 trick: one byte
//     permute and one add, exact) and adds the products in ascending e.
//     A chunk with more than 32 entries is several tasks, which run at
//     once on neighbouring blocks and share its rows through L2; warps
//     of a tile with no live entry skip the arithmetic. Zero padding past
//     d in both operands adds +0 to a sum that is never -0.0, so any d
//     runs in the same ring and the sums are the plain version's.
//     The same blocks write the zeros: positions [lo, ch) of each entry,
//     where lo is 0 for a dead entry and min(ch, cap - s*ch) for a live
//     one, each block for its share of the entries, one entry a warp a
//     ring step (float4s where ch % 4 == 0) and the rest after its walk.
//     So the output's dead positions (~57% of it at nprobe 64) are written
//     once, while the arithmetic runs, and no block is spent on them.
// Rows read are all ch rows of each probed chunk, whatever the entries'
// live lengths; outputs written are [0, lo) of each live entry.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "tile_scan.cuh"
#include "work_list.cuh"

using namespace vqk;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;       // a block of chunk_matvec_kernel
constexpr int kBlocksPerSM = 3;     // its resident blocks an SM
constexpr int kTileRows = 256;      // chunk rows a tile
constexpr int kTilePairs = 16;      // work entries a tile
constexpr int kTaskEntries = 2 * kTilePairs;  // work entries a task, at most
constexpr int kSliceBytes = 64;     // bytes of a row a ring stage holds
constexpr int kRowStride = kSliceBytes + 16;  // 20 words
constexpr int kStages = 3;          // depth of the cp.async ring
constexpr int kScanThreads = 1024;  // bin_scan_kernel's one block
constexpr int kScatterThreads = 256;

template <typename T>
struct Tile {
  static constexpr int kPer = 16 / (int)sizeof(T);             // elements a 16-byte read
  static constexpr int kDims = kSliceBytes / (int)sizeof(T);   // dimensions a slice
  static constexpr int kQStride = kDims + 4;                   // floats a left-vector slice
  static constexpr int kStageBytes = kTileRows * kRowStride + kTilePairs * kQStride * 4;
  static constexpr int kSmem = kStages * kStageBytes;
  // 16-byte groups unrolled a step: u8's unrolled step body (~2.7k
  // instructions) runs slower than its loop.
  static constexpr int kGroupUnroll = sizeof(T) == 1 ? 1 : 4;
};

template <int N>
struct RawOf;
template <>
struct RawOf<1> { using type = unsigned char; };
template <>
struct RawOf<2> { using type = unsigned short; };
template <>
struct RawOf<4> { using type = unsigned; };

__device__ __forceinline__ unsigned word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Element k of a 16-byte read, as f32 (k is a constant once unrolled).
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int k);
template <>
__device__ __forceinline__ float elem<float>(const uint4& v, int k) {
  return __uint_as_float(word(v, k));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v, int k) {
  const unsigned w = word(v, k >> 1);  // bf16 is the top half of an f32
  return __uint_as_float((k & 1) ? (w & 0xFFFF0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float elem<__half>(const uint4& v, int k) {
  const unsigned w = word(v, k >> 1);
  return __half2float(__ushort_as_half((unsigned short)((k & 1) ? (w >> 16) : (w & 0xFFFFu))));
}
template <>
__device__ __forceinline__ float elem<unsigned char>(const uint4& v, int k) {
  // The byte b under the exponent of 2^23 is the float 2^23 + b; less
  // 2^23 it is b, exactly.
  const unsigned w = __byte_perm(word(v, k >> 2), 0x4B000000u, 0x7540u | (unsigned)(k & 3));
  return __fsub_rn(__uint_as_float(w), 8388608.f);
}

// Whether entry i (chunk id cid) is live, and lo: its first position
// that is 0 (0 for a dead entry, min(ch, cap - s * ch) for a live one).
__device__ __forceinline__ bool entry_live(long long i, int cid, int nc, int ch, int n_chunks,
                                           long long cap, int* lo) {
  const long long s0 = (long long)(int)(i % nc) * ch;
  const bool live = cid >= 0 && cid < n_chunks && s0 < cap;
  *lo = live ? (int)min((long long)ch, cap - s0) : 0;
  return live;
}

// Step 1a: one warp a segment of seg_len entries, 32 a step in ascending
// order. Live entries get their rank among the segment's entries of the
// same chunk (rank [E]) and are counted into table [n_chunks, segs] and
// totals [n_chunks].
__global__ void __launch_bounds__(32)
    entry_pass_kernel(const int* __restrict__ chunks, int* __restrict__ table,
                      int* __restrict__ totals, int* __restrict__ rank, long long entries,
                      int nc, int ch, int n_chunks, long long cap, int seg_len, int segs) {
  const int lane = threadIdx.x;
  const int g = blockIdx.x;
  const long long i0 = (long long)g * seg_len;
  const long long i1 = min(entries, i0 + seg_len);
  for (long long b = i0; b < i1; b += 32) {
    const long long i = b + lane;
    int code = -1, lo;
    if (i < i1) {
      const int cid = chunks[i];
      if (entry_live(i, cid, nc, ch, n_chunks, cap, &lo)) code = cid;
    }
    const unsigned same = __match_any_sync(kFull, code);
    const int leader = 31 - __clz(same);
    int base = 0;
    if (code >= 0 && lane == leader) {
      base = atomicAdd(&table[(long long)code * segs + g], __popc(same));
      atomicAdd(&totals[code], __popc(same));
    }
    // Waiting for the count orders this step's atomics before the next's.
    base = __shfl_sync(kFull, base, leader);
    if (code >= 0) rank[i] = base + __popc(same & ((1u << lane) - 1u));
  }
}

// Exclusive scan over a block of kScanThreads of one value a thread;
// returns the thread's offset, and the block's total in *total.
__device__ __forceinline__ int block_exclusive_scan(int a, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = a;  // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // warp_sums is free
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int v = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  *total = warp_sums[kScanThreads / 32 - 1];
  return x - a + (w > 0 ? warp_sums[w - 1] : 0);
}

__device__ __forceinline__ int task_count(int live, int task_entries) {
  return (live + task_entries - 1) / task_entries;
}

// Step 1b: exclusive scans of the totals into offsets [n_chunks + 1] and
// of the chunks' task counts into task_off [n_chunks + 1] (the last:
// all tasks).
__global__ void __launch_bounds__(kScanThreads)
    bin_scan_kernel(const int* __restrict__ totals, int* __restrict__ offsets,
                    int* __restrict__ task_off, int nb, int task_entries) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int j0 = min(nb, (int)threadIdx.x * per), j1 = min(nb, j0 + per);
  int a = 0, t = 0;
  for (int j = j0; j < j1; ++j) {
    a += totals[j];
    t += task_count(totals[j], task_entries);
  }
  int all_entries, all_tasks;
  int run = block_exclusive_scan(a, warp_sums, &all_entries);
  int trun = block_exclusive_scan(t, warp_sums, &all_tasks);
  for (int j = j0; j < j1; ++j) {
    offsets[j] = run;
    task_off[j] = trun;
    run += totals[j];
    trun += task_count(totals[j], task_entries);
  }
  if (threadIdx.x == 0) {
    offsets[nb] = all_entries;
    task_off[nb] = all_tasks;
  }
}

// Step 1c: one warp a chunk turns its row of segment counts into the
// first work-list slot of each segment's entries of that chunk, and
// writes the chunk's tasks (chunk, first slot, entries).
__global__ void bin_cursor_kernel(int* __restrict__ table, const int* __restrict__ offsets,
                                  const int* __restrict__ task_off, int4* __restrict__ tasks,
                                  int nb, int segs, int task_entries) {
  const long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= nb) return;
  int base = offsets[c];
  const int live = offsets[c + 1] - base;
  if (live == 0) return;  // no entry reads this chunk
  for (int k = lane; k < task_count(live, task_entries); k += 32)
    tasks[task_off[c] + k] = make_int4((int)c, base + k * task_entries,
                                       min(task_entries, live - k * task_entries), 0);
  int* row = table + c * segs;
  for (int g0 = 0; g0 < segs; g0 += 32) {
    const int g = g0 + lane;
    const int v = g < segs ? row[g] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (g < segs) row[g] = base + x - v;
    base += __shfl_sync(kFull, x, 31);
  }
}

// Step 1d: a thread an entry places each live entry in the work list.
__global__ void __launch_bounds__(kScatterThreads)
    entry_scatter_kernel(const int* __restrict__ chunks, const int* __restrict__ table,
                         const int* __restrict__ rank, int* __restrict__ work,
                         long long entries, int nc, int ch, int n_chunks, long long cap,
                         int seg_len, int segs) {
  const long long i = (long long)blockIdx.x * kScatterThreads + threadIdx.x;
  if (i >= entries) return;
  const int cid = chunks[i];
  int lo;
  if (entry_live(i, cid, nc, ch, n_chunks, cap, &lo))
    work[table[(long long)cid * segs + i / seg_len] + rank[i]] = (int)i;
}

// A block's walk over its tasks, one ring step at a time: task k (its
// chunk c, first work slot and entry count), pair tile, row tile and
// slice. Every thread keeps the same walk.
struct Walk {
  int k, c, first, count, tile, rt, sl;

  __device__ __forceinline__ void start(int task, const int4* tasks, int n_tasks) {
    k = task;
    tile = rt = sl = 0;
    if (k < n_tasks) {
      const int4 m = __ldg(tasks + k);
      c = m.x;
      first = m.y;
      count = m.z;
    }
  }
  __device__ __forceinline__ void next(int slices, int rtiles, const int4* tasks, int n_tasks) {
    if (++sl < slices) return;
    sl = 0;
    if (++rt < rtiles) return;
    rt = 0;
    if (++tile * kTilePairs < count) return;
    start(k + gridDim.x, tasks, n_tasks);
  }
};

// Step 2: the persistent matvec over the tasks.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    chunk_matvec_kernel(const float* __restrict__ lhs, const T* __restrict__ payload,
                        const int4* __restrict__ tasks, const int* __restrict__ n_tasks_at,
                        const int* __restrict__ work, const int* __restrict__ chunks,
                        float* __restrict__ out, long long entries, int d, int nc, int ch,
                        int n_chunks, long long cap, bool vec, bool qvec, bool vec_out) {
  using K = Tile<T>;
  using Raw = typename RawOf<(int)sizeof(T)>::type;
  extern __shared__ uint4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  const int n_tasks = *n_tasks_at;
  const int slices = max(1, (d + K::kDims - 1) / K::kDims);
  const int rtiles = (ch + kTileRows - 1) / kTileRows;
  const long long row_bytes = (long long)d * (long long)sizeof(T);

  // Issue the copies of the walk's current step into stage st.
  auto load = [&](const Walk& w, char* st) {
    float* qs = reinterpret_cast<float*>(st + kTileRows * kRowStride);
    const int row0 = w.rt * kTileRows;
    const char* chunk = reinterpret_cast<const char*>(payload) + (long long)w.c * ch * row_bytes;
    if (vec) {
      for (int k = threadIdx.x; k < kTileRows * 4; k += kThreads) {
        const int r = k >> 2;
        const long long eb = (long long)w.sl * kSliceBytes + (k & 3) * 16;
        const bool ok = row0 + r < ch && eb < row_bytes;
        const char* src = ok ? chunk + (row0 + r) * row_bytes + eb : chunk;
        cp_async16(reinterpret_cast<float*>(st + r * kRowStride + (k & 3) * 16),
                   reinterpret_cast<const float*>(src), ok);
      }
    } else {  // element loads, stored at the same place as raw bits
      const Raw* rows = reinterpret_cast<const Raw*>(chunk);
      for (int k = threadIdx.x; k < kTileRows * K::kDims; k += kThreads) {
        const int r = k / K::kDims, e = k - r * K::kDims;
        const int ee = w.sl * K::kDims + e;
        Raw v = 0;
        if (row0 + r < ch && ee < d) v = rows[(long long)(row0 + r) * d + ee];
        reinterpret_cast<Raw*>(st + r * kRowStride)[e] = v;
      }
    }
    constexpr int kQPieces = K::kDims / 4;  // 4-float pieces of a left-vector slice
    for (int k = threadIdx.x; k < kTilePairs * kQPieces; k += kThreads) {
      const int j = k / kQPieces, piece = k - j * kQPieces;
      const int jj = w.tile * kTilePairs + j;
      const int e = w.sl * K::kDims + piece * 4;
      const float* q = jj < w.count ? lhs + (long long)(work[w.first + jj] / nc) * d : nullptr;
      float* dst = qs + j * K::kQStride + piece * 4;
      if (qvec) {
        cp_async16(dst, q != nullptr && e < d ? q + e : lhs, q != nullptr && e < d);
      } else {
        for (int u = 0; u < 4; ++u)
          cp_async4(dst + u, q != nullptr && e + u < d ? q + e + u : lhs, q != nullptr && e + u < d);
      }
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pg = warp >> 1;                   // entries 4 pg + j of a tile
  const int rbase = (warp & 1) * 128 + lane;  // rows rbase + 32 i of a tile

  // The zeros: positions [lo, ch) of each entry of the block's share
  // [z, z_end), one entry a warp a step beside the arithmetic, the rest
  // after the walk. A warp's next chunk id is read a step ahead.
  constexpr int kWarps = kThreads / 32;
  const long long share = (entries + gridDim.x - 1) / gridDim.x;
  const long long z_end = min(entries, (long long)blockIdx.x * share + share);
  long long z = (long long)blockIdx.x * share + warp;
  int zcid = z < z_end ? chunks[z] : -1;
  auto zero_next = [&]() {
    int lo;
    entry_live(z, zcid, nc, ch, n_chunks, cap, &lo);
    float* o = out + z * ch;
    if (vec_out && lo == 0) {
      for (int q = lane; q < ch / 4; q += 32)
        reinterpret_cast<float4*>(o)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int r = lo + lane; r < ch; r += 32) o[r] = 0.f;
    }
    z += kWarps;
    zcid = z < z_end ? chunks[z] : -1;
  };
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  Walk ld, cp;  // the loads run kStages - 1 steps ahead of the arithmetic
  ld.start(blockIdx.x, tasks, n_tasks);
  cp.start(blockIdx.x, tasks, n_tasks);
  for (int s = 0; s < kStages - 1; ++s) {
    if (ld.k < n_tasks) {
      load(ld, smem + s * K::kStageBytes);
      ld.next(slices, rtiles, tasks, n_tasks);
    }
    cp_async_commit();
  }
  for (int step = 0; cp.k < n_tasks; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step landed; every thread is done with the last
    if (ld.k < n_tasks) {
      load(ld, smem + ((step + kStages - 1) % kStages) * K::kStageBytes);
      ld.next(slices, rtiles, tasks, n_tasks);
    }
    cp_async_commit();

    const int jt = cp.tile * kTilePairs + 4 * pg;  // the warp's first entry of the task
    const bool active = jt < cp.count;             // warp-uniform
    if (active) {
      const char* st = smem + (step % kStages) * K::kStageBytes;
      const char* rp = st + rbase * kRowStride;
      const float* qp =
          reinterpret_cast<const float*>(st + kTileRows * kRowStride) + 4 * pg * K::kQStride;
      constexpr int kUnroll = K::kGroupUnroll;
#pragma unroll kUnroll
      for (int g = 0; g < 4; ++g) {  // the slice's 16-byte groups, ascending e
        uint4 raw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          raw[i] = *reinterpret_cast<const uint4*>(rp + i * 32 * kRowStride + g * 16);
#pragma unroll
        for (int sub = 0; sub < K::kPer / 4; ++sub) {
          float4 qv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            qv[j] = *reinterpret_cast<const float4*>(qp + j * K::kQStride + g * K::kPer + sub * 4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float rv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) rv[i] = elem<T>(raw[i], sub * 4 + u);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) mac(acc[j][i], at(qv[j], u), rv[i]);
          }
        }
      }
    }
    if (cp.sl == slices - 1) {  // the tile's last slice: write its sums
      if (active) {
        const int row0 = cp.rt * kTileRows;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (jt + j < cp.count) {
            const int entry = work[cp.first + jt + j];
            const long long live = min((long long)ch, cap - (long long)(entry % nc) * ch);
            float* o = out + (long long)entry * ch;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = row0 + rbase + 32 * i;
              if (r < live) o[r] = acc[j][i];
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    }
    if (z < z_end) zero_next();
    cp.next(slices, rtiles, tasks, n_tasks);
  }
  cp_async_wait<0>();
  while (z < z_end) zero_next();
}

}  // namespace

int vqk::work_list(const int* chunks, const WorkList& s, long long entries, int nc, int ch,
                   int n_chunks, long long cap, int seg_len, int segs, int task_entries,
                   cudaStream_t st) {
  const size_t counted = ((size_t)n_chunks * segs + n_chunks) * sizeof(int);
  int err = counted ? (int)cudaMemsetAsync(s.table, 0, counted, st) : 0;
  if (err != 0) return err;
  if (entries > 0)
    entry_pass_kernel<<<(unsigned)segs, 32, 0, st>>>(chunks, s.table, s.totals, s.rank, entries,
                                                     nc, ch, n_chunks, cap, seg_len, segs);
  bin_scan_kernel<<<1, kScanThreads, 0, st>>>(s.totals, s.offsets, s.task_off, n_chunks,
                                               task_entries);
  if (n_chunks > 0)
    bin_cursor_kernel<<<(unsigned)(((long long)n_chunks * 32 + 255) / 256), 256, 0, st>>>(
        s.table, s.offsets, s.task_off, s.tasks, n_chunks, segs, task_entries);
  if (entries > 0)
    entry_scatter_kernel<<<(unsigned)((entries + kScatterThreads - 1) / kScatterThreads),
                           kScatterThreads, 0, st>>>(chunks, s.table, s.rank, s.work, entries,
                                                     nc, ch, n_chunks, cap, seg_len, segs);
  return (int)cudaGetLastError();
}

namespace {

template <typename T>
int launch_matvec(const float* lhs, const int* chunks, const void* payload, float* out,
                  const WorkList& s, long long entries, int d, int nc, int ch, int n_chunks,
                  long long cap, bool vec, bool qvec, cudaStream_t st) {
  constexpr int smem = Tile<T>::kSmem;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(chunk_matvec_kernel<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const long long blocks = min(s.max_tasks, (long long)kBlocksPerSM * sms);
  const bool vec_out = ch % 4 == 0;  // out comes from the caching allocator: 16-byte aligned
  chunk_matvec_kernel<T><<<(unsigned)blocks, kThreads, smem, st>>>(
      lhs, static_cast<const T*>(payload), s.tasks, s.task_off + n_chunks, s.work, chunks, out,
      entries, d, nc, ch, n_chunks, cap, vec, qvec, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Step 1 alone, the work list: after it, chunk c's live entries i = p *
// nc + s are work[offsets[c] .. offsets[c + 1]), ascending. scratch
// holds 4 * (n_chunks + ceil(E / 32)) + n_chunks * (segs + 3) + 2 + 2 * E
// i32 (E = pairs * nc), 16-byte aligned; segs = ceil(E / seg_len),
// seg_len a multiple of 32.
extern "C" int vq_ivf_matvec_plan(const int* chunks, int* scratch, int pairs, int nc, int ch,
                                  int n_chunks, long long cap, int seg_len, int segs,
                                  void* stream) {
  const long long entries = (long long)pairs * nc;
  return work_list(chunks, WorkList(scratch, entries, n_chunks, segs, kTaskEntries), entries, nc,
                   ch, n_chunks, cap, seg_len, segs, kTaskEntries,
                   static_cast<cudaStream_t>(stream));
}

// Both steps: the work list, then the matvec, which writes every output
// position. payload_type: 0 f32, 1 bf16, 2 f16, 3 u8. vec: rows may be
// read 16 bytes at a time (d * itemsize % 16 == 0 and a 16-byte aligned
// pool); qvec: so may lhs (d % 4 == 0 and 16-byte aligned).
extern "C" int vq_ivf_matvec(const float* lhs, const int* chunks, const void* payload,
                             int payload_type, float* out, int* scratch, int pairs, int d,
                             int nc, int ch, int n_chunks, long long cap, int seg_len, int segs,
                             int vec, int qvec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long entries = (long long)pairs * nc;
  const WorkList s(scratch, entries, n_chunks, segs, kTaskEntries);
  const int err = work_list(chunks, s, entries, nc, ch, n_chunks, cap, seg_len, segs,
                            kTaskEntries, st);
  if (err != 0) return err;
  switch (payload_type) {
    case 0:
      return launch_matvec<float>(lhs, chunks, payload, out, s, entries, d, nc, ch, n_chunks, cap,
                                  vec, qvec, st);
    case 1:
      return launch_matvec<__nv_bfloat16>(lhs, chunks, payload, out, s, entries, d, nc, ch,
                                          n_chunks, cap, vec, qvec, st);
    case 2:
      return launch_matvec<__half>(lhs, chunks, payload, out, s, entries, d, nc, ch, n_chunks,
                                   cap, vec, qvec, st);
    case 3:
      return launch_matvec<unsigned char>(lhs, chunks, payload, out, s, entries, d, nc, ch,
                                          n_chunks, cap, vec, qvec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
