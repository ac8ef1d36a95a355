// K7: ADC sums over probed IVF chunks. For each (query, probe) pair p:
// tables [P, m, kk] f32, that pair's chunk chain chunks [P, nc] i32
// (-1 = no chunk), the code pool codes [n_chunks, ch, m] (u8 or i32)
// -> out [P, nc*ch] with out[p, t] = sum_i tables[p, i, code_i] over
// the codes of row t % ch of chunk chunks[p, t / ch], summed from +0.0
// in subspace order 0..m-1 in fp32. Positions t >= cap, and positions of
// a chunk id outside [0, n_chunks) (-1 marks no chunk), give 0, so no id
// reads outside the pool; a code outside [0, kk) adds 0.
//
// Replaces vq_tpu/ops/pallas_kernels.py::_ivf_probe_gather_kernel
// (kk <= 256, u8 codes) and ::_ivf_probe_kernel (kk > 256, i32 codes),
// both reached through ivf_probe_adc_fused / _ivf_probe_adc_jit: one
// kernel templated on the code width serves both.
//
// What bounds it on the card: bytes. The [P, nc*ch] output is written
// once (padded to the longest list: 193 MB at 128 queries x nprobe 64
// over IVF1024 of 1M rows, 8192 pairs x 23 chunks x 256 rows), each
// pair's table is read once (P x m x kk x 4 bytes: 67 MB there) and the
// probed chunks' codes once (m bytes a row, at most the 8 MB pool):
// ~0.080 ms at 3.35 TB/s (~0.011 ms at nprobe 8). The lookups, m a live
// (pair, row), are 0.17 G there: ~0.07 ms of shared-memory wavefronts
// as one 4-byte load a lookup, under the bytes once four pairs share
// each load.
//
// Design: list-major, in two steps, with K8's shared lookups
// (adc_lookup.cu).
//  1. The grouping (vq_ivf_probe_plan), on the card with no host sync:
//     pair_key_kernel gives each pair the bin of its chain's first chunk
//     id (n_chunks, the dead bin, where that id is outside the pool);
//     K6's work list (work_list.cuh) stably counting-sorts the pairs by
//     bin and cuts each bin's run into quads of up to kQuad pairs; then
//     quad_info_kernel, a warp a quad, writes each quad's record: its
//     pairs, where the last chunk of the pool sits in any of their chains
//     (`live`), and whether all their chains agree with the first pair's
//     (`same`). A chunk belongs to one list, so on the library's paths a
//     bin's pairs probe one list and walk one chain: `same` holds.
//  2. The sums (ivf_probe_kernel), persistent: as many blocks of kBlock
//     threads as the card holds at once take (quad, part) items from a
//     counter; a part is a range of whole tiles of kTile positions of the
//     chain. The quad's tables sit in shared memory as [m][kp] entries of
//     4 floats, one a pair, so one 16-byte load gives a (subspace, code)
//     entry for all four pairs (also for a quad of fewer pairs: 4- and
//     8-byte entries for those took no less time), filled by cp.async
//     into one of two buffers while the block walks the item before (the
//     records and the counter run further ahead), so no fill stalls the
//     walk. A zero entry sits at kk where a code can fall outside [0, kk)
//     (i32 codes, u8 codes at kk < 256); u8 codes at kk >= 256 need no
//     range check. Each thread owns 4
//     consecutive positions: it reads the leader's (the quad's first
//     pair's) chunk id there, the rows' codes once (one 8-byte load a row
//     at m = 8 u8, 4- or 16-byte words where m % 4 == 0), makes 4 x 4
//     sums from +0.0 in subspace order with __fadd_rn, and writes each
//     pair's 4 sums as one float4 streamed past L2 (st.global.cs).
//     Positions past the quad's `live` end (or cap) are zeros for every
//     pair, written with no lookup; every dead position gets its zero
//     once. Where `same` fails (never on the library's paths; any chains
//     are taken), a pair whose chunk id at those positions differs from
//     the leader's sums its own rows from the same shared entries: the
//     same bits, more slowly. Tables past one buffer (m = 16, kk = 4096
//     is 1 MB a quad) go through it in groups of subspaces, the running
//     sums kept in `out` between groups, so the order is unchanged; where
//     one subspace does not fit they are read from device memory. No
//     shape is refused.
//  A quad's chain is cut into parts so that there are at least
//  kItemsPerBlock items a resident block: at nprobe 8 the 1024 pairs make
//  ~400 quads, too few items to keep 132 SMs busy to the end. Each part
//  repeats the quad's fill, 8 KB a pair at 8 x 256. The trade, measured
//  on an H100 SXM at 700 W on the IVF-PQ search's operands (IVF1024 of
//  1M rows, 128 queries): at nprobe 8 the sums took 0.067 ms with 1 item
//  a block, 0.042 with 2, 0.041 with 4 and 0.046 with 8; at nprobe 64
//  (2,386 quads, one part each) all four within 0.002 ms. Skipping the
//  fill of parts with no live position saved nothing measurable.
#include <cstdint>

#include "common.cuh"
#include "tile_scan.cuh"
#include "work_list.cuh"

using namespace vqk;

namespace {

constexpr int kRows = 4;               // consecutive positions a thread
constexpr int kChunk = 8;              // subspaces whose entries a thread holds at once
constexpr int kBlock = 256;            // threads a block
constexpr int kTile = kRows * kBlock;  // positions a block step
constexpr int kQuad = 4;               // pairs a quad: the work list's task size
constexpr int kItemsPerBlock = 4;      // (quad, part) items a resident block, at least
constexpr int kKeyThreads = 256;      // pair_key_kernel and quad_info_kernel

// The launch's operands. records [n] (two int4 a quad: (first slot of
// the pairs by bin, pairs, live << 1 | same, 0) and its pair ids, the
// last repeated past the quad's pairs) and the quad count n at *n_quads
// come from step 1.
struct Probe {
  const float* tables;
  const int* chunks;
  const void* codes;
  float* out;
  const int4* records;
  const int* n_quads;
  int* next_item;
  int m, kk, kp, nc, ch, n_chunks, width, gsub;
  long long cap;
  bool vec_codes, vec_out;
};

// Step 1a: each pair's bin, the first chunk id of its chain, or n_chunks
// (the dead bin) where that id lies outside [0, n_chunks); and step 2's
// item counter set to 0.
__global__ void __launch_bounds__(kKeyThreads)
    pair_key_kernel(const int* __restrict__ chunks, int* __restrict__ keys,
                    int* __restrict__ next_item, int pairs, int nc, int n_chunks) {
  const int p = blockIdx.x * kKeyThreads + threadIdx.x;
  if (p == 0) *next_item = 0;
  if (p < pairs) {
    const int c = nc > 0 ? chunks[(long long)p * nc] : -1;
    keys[p] = c >= 0 && c < n_chunks ? c : n_chunks;
  }
}

// Step 1c: a warp a quad writes its record: its pairs, and over the
// whole chain whether every pair's canonical chunk ids (an id outside
// the pool as -1) equal the first pair's (`same`), and `live`, one past
// the last slot where any of its pairs has a chunk of the pool.
__global__ void __launch_bounds__(kKeyThreads)
    quad_info_kernel(const int4* __restrict__ tasks, const int* __restrict__ n_quads_at,
                     const int* __restrict__ order, const int* __restrict__ chunks,
                     int4* __restrict__ records, int nc, int n_chunks) {
  const int q = (blockIdx.x * kKeyThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (q >= *n_quads_at) return;
  const int4 t = tasks[q];
  int pr[kQuad];
#pragma unroll
  for (int l = 0; l < kQuad; ++l) pr[l] = order[t.y + min(l, t.z - 1)];
  int last = -1;
  bool same = true;
  for (int s = lane; s < nc; s += 32) {
    int c0 = -1;
#pragma unroll
    for (int l = 0; l < kQuad; ++l) {
      if (l < t.z) {
        int c = chunks[(long long)pr[l] * nc + s];
        c = c >= 0 && c < n_chunks ? c : -1;
        if (l == 0) c0 = c;
        same &= c == c0;
        if (c >= 0) last = s;
      }
    }
  }
  last = __reduce_max_sync(0xffffffffu, last);
  same = __all_sync(0xffffffffu, same);
  if (lane == 0) {
    records[2 * q] = make_int4(t.y, t.z, (last + 1) << 1 | (int)same, 0);
    records[2 * q + 1] = make_int4(pr[0], pr[1], pr[2], pr[3]);
  }
}

// The 4 lanes of the shared entry at byte offset p.
__device__ __forceinline__ void lanes_at(const char* p, float (&x)[kQuad]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// A (subspace i, code c) entry: the byte offset of its 4 floats in the
// shared table (i counted from the group's first subspace; an
// out-of-range code takes the zero entry kk), or its index in one pair's
// [m, kk] table, -1 outside [0, kk) (read from device memory).
template <bool kSmem, bool kClamp>
__device__ __forceinline__ int entry(int i, int c, int kk, int kp) {
  if (kSmem) {
    if (kClamp && (unsigned)c >= (unsigned)kk) c = kk;
    return (i * kp + c) << 4;
  }
  return (unsigned)c < (unsigned)kk ? i * kk + c : -1;
}

// The chain slot and row of the 4 positions from t0.
__device__ __forceinline__ void slots_of(int t0, int ch, int (&slot)[kRows], int (&row)[kRows]) {
  slot[0] = t0 / ch;
  row[0] = t0 - slot[0] * ch;
#pragma unroll
  for (int e = 1; e < kRows; ++e) {
    slot[e] = slot[e - 1];
    row[e] = row[e - 1] + 1;
    if (row[e] == ch) {
      row[e] = 0;
      ++slot[e];
    }
  }
}

// id[e]: the chunk of `pair` at position t0 + e, or -1 where the position
// is dead (t >= cap, an id outside the pool) or past the chain.
__device__ __forceinline__ void live_ids(const Probe& a, int pair, int t0,
                                         const int (&slot)[kRows], int (&id)[kRows]) {
  const int* chain = a.chunks + (long long)pair * a.nc;
  int c = -1;
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    const int t = t0 + e;
    if (t >= a.width) {
      id[e] = -1;
      continue;
    }
    if (e == 0 || slot[e] != slot[e - 1]) c = __ldg(chain + slot[e]);
    id[e] = t < a.cap && c >= 0 && c < a.n_chunks ? c : -1;
  }
}

// off[e][ii]: the entries of the rows rowp[e] (null: a dead position,
// code 0, summed but never stored) at subspaces i0 + ii (ii < cnt); g0 is
// the first subspace of the shared group.
template <typename C, bool kSmem, bool kClamp>
__device__ __forceinline__ void load_entries(const Probe& a, const C* const (&rowp)[kRows], int i0,
                                             int cnt, int g0, int (&off)[kRows][kChunk]) {
  int c[kRows][kChunk];
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    const C* p = rowp[e];
    if (p == nullptr) {
#pragma unroll
      for (int ii = 0; ii < kChunk; ++ii) c[e][ii] = 0;
      continue;
    }
    p += i0;
    if (a.vec_codes && (i0 & 3) == 0) {  // m % 4 == 0, codes 16-byte aligned
      if constexpr (sizeof(C) == 1) {
        if ((a.m & 7) == 0 && (i0 & 7) == 0) {  // the row's 8 codes in one 8-byte load
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
    } else {
#pragma unroll
      for (int ii = 0; ii < kChunk; ++ii) c[e][ii] = ii < cnt ? (int)__ldg(p + ii) : 0;
    }
  }
#pragma unroll
  for (int e = 0; e < kRows; ++e)
#pragma unroll
    for (int ii = 0; ii < kChunk; ++ii)
      off[e][ii] = entry<kSmem, kClamp>(kSmem ? i0 + ii - g0 : i0 + ii, c[e][ii], a.kk, a.kp);
}

// Issues the copies (cp.async) of the quad's tables of subspaces [g0,
// g0 + gc) into `tab` as [gc][kp] entries of 4 floats: lane l < count of
// entry (i, c) from pair l's tables[g0 + i, c], zero-filled at c = kk
// (the zero entry). Lanes past the quad's pairs are not written: they
// are summed and never stored.
__device__ __forceinline__ void fill(const Probe& a, char* tab, const int (&pr)[kQuad], int count,
                                     int g0, int gc) {
  const int cells = gc * a.kp;
  for (int e = threadIdx.x; e < cells; e += kBlock) {
    const int i = e / a.kp, c = e - i * a.kp;
    const bool ok = c < a.kk;
#pragma unroll
    for (int l = 0; l < kQuad; ++l) {
      if (l < count) {
        const float* src = a.tables + ((long long)pr[l] * a.m + g0 + i) * a.kk + (ok ? c : 0);
        cp_async4(reinterpret_cast<float*>(tab) + (size_t)e * kQuad + l, src, ok);
      }
    }
  }
}

// Lane `lane` of a quad whose chunk ids differ from the leader's at the 4
// positions from t0: the pair's own rows, looked up in the same entries
// (lane `lane` of the shared table, or its own table in device memory).
template <typename C, bool kSmem, bool kClamp>
__device__ __forceinline__ void own_sums(const Probe& a, const char* tab, const float* tl, int pair,
                                         int lane, int t0, int g0, int gc) {
  int slot[kRows], row[kRows], id[kRows];
  slots_of(t0, a.ch, slot, row);
  live_ids(a, pair, t0, slot, id);
  float* o = a.out + (long long)pair * a.width + t0;
  for (int e = 0; e < kRows && t0 + e < a.width; ++e) {
    float acc = 0.f;
    if (id[e] >= 0) {
      if (g0 > 0) acc = o[e];
      const C* rp = static_cast<const C*>(a.codes) + ((long long)id[e] * a.ch + row[e]) * a.m;
      for (int i = g0; i < g0 + gc; ++i) {
        const int off = entry<kSmem, kClamp>(kSmem ? i - g0 : i, (int)rp[i], a.kk, a.kp);
        float x;
        if (kSmem) {
          x = *reinterpret_cast<const float*>(tab + off + 4 * lane);
        } else {
          x = off < 0 ? 0.f : __ldg(tl + off);
        }
        acc = __fadd_rn(acc, x);
      }
    }
    __stcs(o + e, acc);
  }
}

// One item: the quad's pairs pr[0 .. count) over positions [t_lo, t_hi),
// a multiple of kTile from t_lo; the first group of subspaces is in `tab`
// already. Positions from t_live on are zeros for every pair; `same`: no
// pair's chain differs from the leader's.
template <typename C, bool kSmem, bool kClamp>
__device__ __forceinline__ void walk(const Probe& a, char* tab, const int (&pr)[kQuad], int count,
                                     int t_lo, int t_hi, int t_live, bool same) {
  const int group = kSmem ? a.gsub : a.m;
  const float* tp[kQuad];
#pragma unroll
  for (int l = 0; l < kQuad; ++l)  // lanes past the quad's pairs: summed, never stored
    tp[l] = a.tables + (long long)(l < count ? pr[l] : pr[0]) * a.m * a.kk;
  for (int g0 = 0; g0 < a.m; g0 += group) {
    const int gc = min(group, a.m - g0);
    if (kSmem && g0 > 0) {  // a table past one buffer: its next group, in place
      __syncthreads();      // every lookup of the last group is done
      fill(a, tab, pr, count, g0, gc);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int t0 = t_lo + kRows * threadIdx.x; t0 < t_hi; t0 += kTile) {
      if (t0 >= t_live) {  // dead for every pair of the quad: zeros, written once
        if (g0 > 0) continue;
#pragma unroll
        for (int l = 0; l < kQuad; ++l) {
          if (l >= count) break;
          float* o = a.out + (long long)pr[l] * a.width + t0;
          if (a.vec_out && t0 + kRows <= a.width) {
            __stcs(reinterpret_cast<float4*>(o), make_float4(0.f, 0.f, 0.f, 0.f));
          } else {
#pragma unroll
            for (int e = 0; e < kRows; ++e)
              if (t0 + e < a.width) __stcs(o + e, 0.f);
          }
        }
        continue;
      }
      int slot[kRows], row[kRows], lead[kRows];
      slots_of(t0, a.ch, slot, row);
      live_ids(a, pr[0], t0, slot, lead);
      unsigned own = 0;  // lanes whose chunk ids here differ from the leader's
#pragma unroll
      for (int l = 1; l < kQuad; ++l) {
        if (!same && l < count) {
          int id[kRows];
          live_ids(a, pr[l], t0, slot, id);
#pragma unroll
          for (int e = 0; e < kRows; ++e)
            if (id[e] != lead[e]) own |= 1u << l;
        }
      }
      float acc[kRows][kQuad];
      const C* rowp[kRows];
      bool any = false;
#pragma unroll
      for (int e = 0; e < kRows; ++e) {
        any |= lead[e] >= 0;
        rowp[e] = lead[e] >= 0 ? static_cast<const C*>(a.codes) +
                                     ((long long)lead[e] * a.ch + row[e]) * a.m
                               : nullptr;
#pragma unroll
        for (int l = 0; l < kQuad; ++l)
          acc[e][l] = g0 > 0 && lead[e] >= 0 && l < count && !((own >> l) & 1)
                          ? a.out[(long long)pr[l] * a.width + t0 + e]
                          : 0.f;
      }
      if (any) {
        for (int i0 = g0; i0 < g0 + gc; i0 += kChunk) {
          const int cnt = min(kChunk, g0 + gc - i0);
          int off[kRows][kChunk];
          load_entries<C, kSmem, kClamp>(a, rowp, i0, cnt, g0, off);
#pragma unroll
          for (int ii = 0; ii < kChunk; ++ii) {
            if (ii < cnt) {
#pragma unroll
              for (int e = 0; e < kRows; ++e) {
                float x[kQuad];
                if (kSmem) {
                  lanes_at(tab + off[e][ii], x);
                } else {
#pragma unroll
                  for (int l = 0; l < kQuad; ++l) x[l] = off[e][ii] < 0 ? 0.f : __ldg(tp[l] + off[e][ii]);
                }
#pragma unroll
                for (int l = 0; l < kQuad; ++l) acc[e][l] = __fadd_rn(acc[e][l], x[l]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int l = 0; l < kQuad; ++l) {
        if (l >= count) break;
        if ((own >> l) & 1) {
          own_sums<C, kSmem, kClamp>(a, tab, tp[l], pr[l], l, t0, g0, gc);
          continue;
        }
        float v[kRows];
#pragma unroll
        for (int e = 0; e < kRows; ++e) v[e] = lead[e] >= 0 ? acc[e][l] : 0.f;
        float* o = a.out + (long long)pr[l] * a.width + t0;
        if (a.vec_out && t0 + kRows <= a.width) {
          __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int e = 0; e < kRows; ++e)
            if (t0 + e < a.width) __stcs(o + e, v[e]);
        }
      }
    }
  }
}

// Step 2: persistent blocks take (quad, part) items from the counter,
// pipelined: while a block walks its item j, the copies of item j + 1's
// tables (into the other of two buffers) and of item j + 2's record are
// in flight, and the counter's answer for item j + 4. index_s and meta_s
// are rings of 4: item x's index is written at the end of item x - 3 (or
// before the loop), its record lands by the top of item x - 1.
template <typename C, bool kSmem, bool kClamp>
__global__ void __launch_bounds__(kBlock, 2) ivf_probe_kernel(const Probe a) {
  extern __shared__ float4 tab_s[];
  __shared__ int4 meta_s[4][2];
  __shared__ int index_s[4];
  const int n_quads = *a.n_quads;
  if (n_quads == 0) return;
  const int tiles = (a.width + kTile - 1) / kTile;
  const int parts = min(min(tiles, (1 << 30) / n_quads),
                        max(1, (kItemsPerBlock * (int)gridDim.x + n_quads - 1) / n_quads));
  const int items = n_quads * max(1, parts);
  const size_t buf = kSmem ? (size_t)a.gsub * a.kp * 16 : 0;
  char* const tab0 = reinterpret_cast<char*>(tab_s);
  auto fetch_record = [&](int w, int slot) {  // thread 0
    if (w >= items) return;
    const int4* r = a.records + 2 * (w / parts);
    cp_async16(reinterpret_cast<float*>(&meta_s[slot][0]), reinterpret_cast<const float*>(r), true);
    cp_async16(reinterpret_cast<float*>(&meta_s[slot][1]), reinterpret_cast<const float*>(r + 1),
               true);
  };
  auto fill_first = [&](int slot, char* tab) {  // item in meta_s[slot]: its first group
    const int4 m1 = meta_s[slot][1];
    const int pr[kQuad] = {m1.x, m1.y, m1.z, m1.w};
    fill(a, tab, pr, meta_s[slot][0].y, 0, min(a.gsub, a.m));
  };
  int next = 0;
  if (threadIdx.x == 0) {
    for (int x = 0; x < 3; ++x) index_s[x] = atomicAdd(a.next_item, 1);
    fetch_record(index_s[0], 0);
    fetch_record(index_s[1], 1);
    next = atomicAdd(a.next_item, 1);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (kSmem && index_s[0] < items) fill_first(0, tab0);
  cp_async_commit();
  for (int j = 0;; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // item j's tables and item j + 1's record landed; item j - 1 is done
    const int w = index_s[j & 3];
    if (w >= items) break;
    if (kSmem && index_s[(j + 1) & 3] < items) fill_first((j + 1) & 3, tab0 + ((j + 1) & 1) * buf);
    if (threadIdx.x == 0) fetch_record(index_s[(j + 2) & 3], (j + 2) & 3);
    cp_async_commit();
    const int4 m0 = meta_s[j & 3][0], m1 = meta_s[j & 3][1];
    const int pr[kQuad] = {m1.x, m1.y, m1.z, m1.w};
    const int part = w % parts;
    const int t_lo = (int)((long long)tiles * part / parts) * kTile;
    const int t_hi = min(a.width, (int)((long long)tiles * (part + 1) / parts) * kTile);
    const int t_live = min(t_hi, max(t_lo, (int)min(a.cap, (long long)(m0.z >> 1) * a.ch)));
    const bool same = m0.z & 1;
    walk<C, kSmem, kClamp>(a, tab0 + (j & 1) * buf, pr, m0.y, t_lo, t_hi, t_live, same);
    if (threadIdx.x == 0) {
      index_s[(j + 3) & 3] = next;
      next = atomicAdd(a.next_item, 1);
    }
  }
}

// Step 1's scratch: keys [P rounded up to 4], the item counter (4 i32),
// the quads' records (8 i32 a quad, as many as the work list has room
// for tasks), then the work list (WorkList over P entries and
// n_chunks + 1 bins, kQuad entries a task).
struct Plan {
  int *keys, *next_item;
  int4* records;
  WorkList wl;
  Plan(int* s, int pairs, int n_chunks, int segs)
      : keys(s),
        next_item(s + (pairs + 3) / 4 * 4),
        records(reinterpret_cast<int4*>(next_item + 4)),
        wl(next_item + 4 + 8 * (n_chunks + 1 + (pairs + kQuad - 1) / kQuad), pairs, n_chunks + 1,
           segs, kQuad) {}
};

// Step 1: the keys, K6's work list over them (nc = 1, ch = 1, cap = 1:
// every key is a live entry of its bin), then the quads' records.
int plan(const int* chunks, const Plan& pl, int pairs, int nc, int n_chunks, int seg_len,
         int segs, cudaStream_t st) {
  pair_key_kernel<<<(unsigned)max(1, (pairs + kKeyThreads - 1) / kKeyThreads), kKeyThreads, 0,
                    st>>>(chunks, pl.keys, pl.next_item, pairs, nc, n_chunks);
  int err = (int)cudaGetLastError();
  if (err == 0)
    err = work_list(pl.keys, pl.wl, pairs, 1, 1, n_chunks + 1, 1, seg_len, segs, kQuad, st);
  if (err != 0) return err;
  const long long warps = pl.wl.max_tasks;
  quad_info_kernel<<<(unsigned)((warps * 32 + kKeyThreads - 1) / kKeyThreads), kKeyThreads, 0,
                     st>>>(pl.wl.tasks, pl.wl.task_off + n_chunks + 1, pl.wl.work, chunks,
                           pl.records, nc, n_chunks);
  return (int)cudaGetLastError();
}

// As many blocks as the card holds at once (by the occupancy calculator).
template <typename C, bool kSmem, bool kClamp>
int launch(const Probe& a, int sms, cudaStream_t st) {
  auto kernel = ivf_probe_kernel<C, kSmem, kClamp>;
  const size_t smem = kSmem ? 2 * (size_t)a.gsub * a.kp * 16 : 0;  // two buffers
  int err = 0, per_sm = 0;
  if (smem > 48 * 1024)
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, smem);
  if (err != 0) return err;
  kernel<<<(unsigned)(max(1, per_sm) * sms), kBlock, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Step 1 alone, the grouping: after it, the scratch's work list holds
// the quads (tasks) and the pairs by bin (work); scratch as Plan lays it
// out, 16-byte aligned; segs = ceil(P / seg_len), seg_len a multiple of
// 32.
extern "C" int vq_ivf_probe_plan(const int* chunks, int* scratch, int pairs, int nc, int n_chunks,
                                 int seg_len, int segs, void* stream) {
  return plan(chunks, Plan(scratch, pairs, n_chunks, segs), pairs, nc, n_chunks, seg_len, segs,
              static_cast<cudaStream_t>(stream));
}

// Both steps; every output position is written. width = nc * ch < 2^31.
// A quad's entries take kp * 16 bytes a subspace of shared memory (kp =
// kk, or kk + 1 unless the codes are u8 and kk >= 256): each of the
// block's two buffers holds as many subspaces as fit in half the opt-in
// window (whole groups of 8 where not all m fit), none where one does
// not (tables read from device memory).
extern "C" int vq_ivf_probe(const float* tables, const int* chunks, const void* codes,
                            int codes_are_u8, float* out, int* scratch, int pairs, int m, int kk,
                            int nc, int ch, int n_chunks, long long cap, int seg_len, int segs,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl(scratch, pairs, n_chunks, segs);
  int err = plan(chunks, pl, pairs, nc, n_chunks, seg_len, segs, st);
  int dev = 0, sms = 0, optin = 0;
  if (err == 0) err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != 0) return err;
  const bool clamp = !codes_are_u8 || kk < 256;
  const int kp = clamp ? kk + 1 : kk;
  const long long fit = optin / 2 / ((long long)kp * 16);
  const int gsub = fit >= m ? m : fit >= kChunk ? (int)(fit / kChunk * kChunk) : (int)fit;
  Probe a;
  a.tables = tables;
  a.chunks = chunks;
  a.codes = codes;
  a.out = out;
  a.records = pl.records;
  a.n_quads = pl.wl.task_off + n_chunks + 1;
  a.next_item = pl.next_item;
  a.m = m;
  a.kk = kk;
  a.kp = fit == 0 ? kk : kp;
  a.nc = nc;
  a.ch = ch;
  a.n_chunks = n_chunks;
  a.width = nc * ch;
  a.gsub = gsub;
  a.cap = cap;
  a.vec_codes = m % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  a.vec_out = a.width % 4 == 0;  // out comes from the caching allocator: 16-byte aligned
  if (fit == 0) {
    return codes_are_u8 ? launch<unsigned char, false, false>(a, sms, st)
                        : launch<int, false, false>(a, sms, st);
  }
  if (!codes_are_u8) return launch<int, true, true>(a, sms, st);
  if (clamp) return launch<unsigned char, true, true>(a, sms, st);
  return launch<unsigned char, true, false>(a, sms, st);
}
