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
// What bounds it on the card: the bytes of the probed rows, d x itemsize
// a row. 128 queries x nprobe 64 x ~1000 live rows x 512 B is ~4 GB of
// logical reads at f32 and d = 128; queries that probe the same list
// share it through the 50 MB L2. The arithmetic (one multiply and one
// add a byte or four) is far below the card's rate.
//
// Design: the TPU caller repeated each left vector once per chunk of the
// probed chain so that every chunk was a BlockSpec "list"; here a block
// takes one pair and a slice of its chain's row positions, one thread a
// position, 256 positions a tile. A tile's rows stream through shared
// memory in groups of 32 dimensions, loaded 16 bytes a thread (coalesced
// along each row, up to four loads in flight a thread) when the row width
// allows it and one element a thread otherwise, and converted to f32 as
// they land. Each thread then adds its
// row's 32 products to a running sum kept in a register, so any d runs
// in the same 34 KB of shared memory and the summation order is the
// plain version's. Tiles with no live position skip the loads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;  // row positions a tile, one a thread
constexpr int kGroup = 32;  // dimensions staged at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(unsigned char v) { return (float)v; }

// A 16-byte load's elements as f32 into dst, taken out of its 32-bit
// words with shifts (no array and no address of the load, which would
// put it on the stack).
__device__ __forceinline__ void put_bf16x2(float* dst, unsigned w) {
  dst[0] = __uint_as_float(w << 16);  // bf16 is the top half of an f32
  dst[1] = __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ void put_halfx2(float* dst, unsigned w) {
  dst[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xFFFFu)));
  dst[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}
__device__ __forceinline__ void put_u8x4(float* dst, unsigned w) {
  dst[0] = (float)(w & 0xFFu);
  dst[1] = (float)((w >> 8) & 0xFFu);
  dst[2] = (float)((w >> 16) & 0xFFu);
  dst[3] = (float)(w >> 24);
}

template <typename T>
__device__ __forceinline__ void put16(float* dst, const uint4& v);
template <>
__device__ __forceinline__ void put16<float>(float* dst, const uint4& v) {
  dst[0] = __uint_as_float(v.x);
  dst[1] = __uint_as_float(v.y);
  dst[2] = __uint_as_float(v.z);
  dst[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void put16<__nv_bfloat16>(float* dst, const uint4& v) {
  put_bf16x2(dst, v.x);
  put_bf16x2(dst + 2, v.y);
  put_bf16x2(dst + 4, v.z);
  put_bf16x2(dst + 6, v.w);
}
template <>
__device__ __forceinline__ void put16<__half>(float* dst, const uint4& v) {
  put_halfx2(dst, v.x);
  put_halfx2(dst + 2, v.y);
  put_halfx2(dst + 4, v.z);
  put_halfx2(dst + 6, v.w);
}
template <>
__device__ __forceinline__ void put16<unsigned char>(float* dst, const uint4& v) {
  put_u8x4(dst, v.x);
  put_u8x4(dst + 4, v.y);
  put_u8x4(dst + 8, v.z);
  put_u8x4(dst + 12, v.w);
}

template <typename T>
__global__ void __launch_bounds__(kRows)
    ivf_matvec_kernel(const float* __restrict__ lhs,
                      const int* __restrict__ chunks,
                      const T* __restrict__ payload, float* __restrict__ out,
                      int d, int nc, int ch, int n_chunks, long long cap,
                      int vec) {
  __shared__ float tile[kRows][kGroup + 1];  // +1: conflict-free row reads
  __shared__ long long base[kRows];          // element offset of each row, -1 dead
  __shared__ float lq[kGroup];
  constexpr int kPer = 16 / (int)sizeof(T);  // elements a 16-byte load
  constexpr int kPieces = kGroup / kPer;     // 16-byte loads a row and group
  const long long p = blockIdx.x;
  const long long width = (long long)nc * ch;
  const long long live_end = cap < width ? cap : width;
  const float* lp = lhs + p * d;
  float* op = out + p * width;
  for (long long t0 = (long long)blockIdx.y * kRows; t0 < width;
       t0 += (long long)gridDim.y * kRows) {
    const long long t = t0 + threadIdx.x;
    long long b = -1;
    if (t < live_end) {
      const int cid = chunks[p * nc + t / ch];
      if (cid >= 0 && cid < n_chunks) b = ((long long)cid * ch + t % ch) * d;
    }
    base[threadIdx.x] = b;
    // Also the barrier between the last tile's readers and this tile.
    if (!__syncthreads_or(b >= 0)) {
      if (t < width) op[t] = 0.f;
      continue;
    }
    float acc = 0.f;
    for (int e0 = 0; e0 < d; e0 += kGroup) {
      const int gc = min(kGroup, d - e0);
      if (e0 > 0) __syncthreads();
      if ((int)threadIdx.x < gc) lq[threadIdx.x] = lp[e0 + threadIdx.x];
      if (vec) {
        // Up to four 16-byte loads a thread in flight, then their
        // conversions (all eight of f32's at once cost occupancy).
        constexpr int kBatch = kPieces < 4 ? kPieces : 4;
#pragma unroll 1
        for (int b0 = 0; b0 < kPieces; b0 += kBatch) {
          uint4 v[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int i = (b0 + j) * kRows + threadIdx.x;
            const int r = i / kPieces, e = (i % kPieces) * kPer;
            const long long rb = base[r];
            v[j] = make_uint4(0u, 0u, 0u, 0u);
            if (rb >= 0 && e < gc)
              v[j] = *reinterpret_cast<const uint4*>(payload + rb + e0 + e);
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int i = (b0 + j) * kRows + threadIdx.x;
            const int r = i / kPieces, e = (i % kPieces) * kPer;
            if (base[r] >= 0 && e < gc) put16<T>(&tile[r][e], v[j]);
          }
        }
      } else {
        for (int i = threadIdx.x; i < kRows * kGroup; i += kRows) {
          const int r = i / kGroup, e = i % kGroup;
          const long long rb = base[r];
          if (rb >= 0 && e < gc) tile[r][e] = to_f32(payload[rb + e0 + e]);
        }
      }
      __syncthreads();
      if (b >= 0) {
        for (int e = 0; e < gc; ++e)
          acc = __fadd_rn(acc, __fmul_rn(lq[e], tile[threadIdx.x][e]));
      }
    }
    if (t < width) op[t] = b >= 0 ? acc : 0.f;
  }
}

template <typename T>
void launch(const float* lhs, const int* chunks, const void* payload,
            float* out, int pairs, int d, int nc, int ch, int n_chunks,
            long long cap, int vec, int slices, cudaStream_t st) {
  const dim3 grid((unsigned)pairs, (unsigned)slices);
  ivf_matvec_kernel<T><<<grid, kRows, 0, st>>>(
      lhs, chunks, static_cast<const T*>(payload), out, d, nc, ch, n_chunks,
      cap, vec);
}

}  // namespace

// payload_type: 0 f32, 1 bf16, 2 f16, 3 u8. vec: rows may be read 16
// bytes at a time (d * itemsize % 16 == 0 and a 16-byte aligned pool).
extern "C" int vq_ivf_matvec(const float* lhs, const int* chunks,
                             const void* payload, int payload_type,
                             float* out, int pairs, int d, int nc, int ch,
                             int n_chunks, long long cap, int vec, int slices,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (payload_type) {
    case 0:
      launch<float>(lhs, chunks, payload, out, pairs, d, nc, ch, n_chunks, cap, vec, slices, st);
      break;
    case 1:
      launch<__nv_bfloat16>(lhs, chunks, payload, out, pairs, d, nc, ch, n_chunks, cap, vec, slices, st);
      break;
    case 2:
      launch<__half>(lhs, chunks, payload, out, pairs, d, nc, ch, n_chunks, cap, vec, slices, st);
      break;
    case 3:
      launch<unsigned char>(lhs, chunks, payload, out, pairs, d, nc, ch, n_chunks, cap, vec, slices, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
