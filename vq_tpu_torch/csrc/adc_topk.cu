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
// What bounds it on the card: the codes are m bytes a vector (8 MB at
// 1M x 8, which L2 holds), so it is bound by the Q*n*m table gathers and
// by the selection, not by device memory.
//
// Design: block (t, q) scores one corpus tile of `tile` columns (a power
// of two >= 128) for one query. The query's table, zero-padded to 128 or
// 256 entries a subspace as on the TPU, sits in shared memory when it
// fits beside the sort buffer, and is read through L1 otherwise. Each
// element sums acc = 0, acc += table[i][code_i] for i = 0..m-1 in fp32
// (the reference's order, so distances are bit-identical to the plain
// version), then applies the mode: "sum" as is, "l2"
// max(qn2 - 2*acc + off, 0), "dot" -acc. The tile's (orderable key,
// column) pairs, packed into 64-bit words, are bitonic-sorted in shared
// memory, which gives ascending value with the lowest id first on exact
// ties; columns past n get the +inf key and, like +inf and NaN scores,
// are never emitted. The per-tile candidates are merged outside with one
// stable sort.
#include "common.cuh"

using namespace vqk;

constexpr int kTopLanes = 128;
constexpr int kSortThreads = 512;

enum AdcMode { kSum = 0, kL2 = 1, kDot = 2 };

__global__ void __launch_bounds__(kSortThreads)
    adc_topk_kernel(const float* __restrict__ tables,
                    const unsigned char* __restrict__ codes_t,
                    const float* __restrict__ qn2,
                    const float* __restrict__ offsets, float* __restrict__ vals,
                    int* __restrict__ ids, int q0, int m, int k, int kpad,
                    long long n, int tile, int fetch, int mode, int pack_bits,
                    int tab_in_smem, int ntiles) {
  extern __shared__ unsigned long long keys[];  // [tile], then the table
  float* tab_s = reinterpret_cast<float*>(keys + tile);
  const int t = blockIdx.x;
  const int q = q0 + blockIdx.y;
  const float* tq = tables + (size_t)q * m * k;
  if (tab_in_smem) {
    for (int u = threadIdx.x; u < m * kpad; u += blockDim.x) {
      const int c = u % kpad;
      tab_s[u] = c < k ? tq[(u / kpad) * k + c] : 0.f;
    }
    __syncthreads();
  }
  const long long col0 = (long long)t * tile;
  const int per = 8 / pack_bits;
  const int cmask = (1 << pack_bits) - 1;
  for (int u = threadIdx.x; u < tile; u += blockDim.x) {
    const long long col = col0 + u;
    int key = kInfKey;
    if (col < n) {
      float acc = 0.f;
      for (int i = 0; i < m; ++i) {
        int code;
        if (pack_bits == 8) {
          code = codes_t[(size_t)i * n + col];
        } else {
          const int byte = codes_t[(size_t)(i / per) * n + col];
          code = (byte >> ((i % per) * pack_bits)) & cmask;
        }
        code &= kpad - 1;
        const float v = tab_in_smem ? tab_s[i * kpad + code]
                                    : (code < k ? __ldg(tq + i * k + code) : 0.f);
        acc = __fadd_rn(acc, v);
      }
      if (mode == kL2) {
        const float v =
            __fadd_rn(__fsub_rn(qn2[q], __fmul_rn(2.0f, acc)), offsets[col]);
        acc = isnan(v) ? v : fmaxf(v, 0.f);
      } else if (mode == kDot) {
        acc = -acc;
      }
      key = orderable_key(acc);
    }
    // Signed key -> unsigned order by flipping the sign bit; the column
    // in the low word breaks ties toward the lower id.
    keys[u] = ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) |
              (unsigned)u;
  }
  __syncthreads();
  for (int size = 2; size <= tile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const int lo = 2 * p - (p & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == up) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  const size_t out0 = (size_t)q * ntiles * kTopLanes + (size_t)t * kTopLanes;
  for (int j = threadIdx.x; j < kTopLanes; j += blockDim.x) {
    float v = __int_as_float(kInfKey);
    int id = -1;
    if (j < fetch) {
      const unsigned long long w = keys[j];
      const int key = (int)((unsigned)(w >> 32) ^ 0x80000000u);
      if (key < kInfKey) {
        v = key_to_f32(key);
        id = (int)(col0 + (long long)(w & 0xFFFFFFFFull));
      }
    }
    vals[out0 + j] = v;
    ids[out0 + j] = id;
  }
}

extern "C" int vq_adc_topk(const float* tables, const unsigned char* codes_t,
                           const float* qn2, const float* offsets, float* vals,
                           int* ids, int nq, int m, int k, int kpad,
                           long long n, int tile, int fetch, int mode,
                           int pack_bits, int tab_in_smem, int ntiles,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t smem = (size_t)tile * sizeof(unsigned long long);
  if (tab_in_smem) smem += (size_t)m * kpad * sizeof(float);
  const int kMaxGridY = 65535;
  for (int q0 = 0; q0 < nq; q0 += kMaxGridY) {
    const dim3 grid((unsigned)ntiles, (unsigned)min(kMaxGridY, nq - q0));
    adc_topk_kernel<<<grid, kSortThreads, smem, st>>>(
        tables, codes_t, qn2, offsets, vals, ids, q0, m, k, kpad, n, tile,
        fetch, mode, pack_bits, tab_in_smem, ntiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
