// Native reference kernel library — the hsdlib analog for vq_tpu.
//
// The reference accelerates distance computation with a vendored C SIMD
// library (hsdlib; surface known from src/core/hsdlib_ffi.rs:37-62 and
// build.rs:9-14: sqeuclidean / manhattan / cosine / dot + a queryable backend
// name). This C++ library serves the same three roles for vq_tpu:
//
//   1. CPU parity oracle: golden values the Pallas/XLA kernels are tested
//      against (the analog of the reference's SIMD-vs-scalar consistency
//      test, src/core/distance.rs:177-223).
//   2. The measured CPU baseline for bench.py — multithreaded, -O3,
//      -march=native auto-vectorized PQ encode, standing in for the Rust
//      reference's Rayon + hsdlib path (the Rust toolchain is not available
//      in this image).
//   3. Backend introspection (hsd_get_backend), like
//      src/core/hsdlib_ffi.rs:144-155.
//
// Compiled on demand by vq_tpu/native/__init__.py with g++; exposed to
// Python via ctypes.

#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Pair kernels (one vector vs one vector) — the hsdlib C ABI shape.
// ---------------------------------------------------------------------------

float hsd_sqeuclidean_f32(const float* a, const float* b, size_t n) {
  float acc = 0.0f;
  for (size_t i = 0; i < n; ++i) {
    float d = a[i] - b[i];
    acc += d * d;
  }
  return acc;
}

float hsd_manhattan_f32(const float* a, const float* b, size_t n) {
  float acc = 0.0f;
  for (size_t i = 0; i < n; ++i) acc += std::fabs(a[i] - b[i]);
  return acc;
}

float hsd_dot_f32(const float* a, const float* b, size_t n) {
  float acc = 0.0f;
  for (size_t i = 0; i < n; ++i) acc += a[i] * b[i];
  return acc;
}

// Cosine *similarity*, like hsdlib (the reference converts to distance as
// 1 - similarity, src/core/distance.rs:98-105).
float hsd_cosine_sim_f32(const float* a, const float* b, size_t n) {
  float dot = 0.0f, na = 0.0f, nb = 0.0f;
  for (size_t i = 0; i < n; ++i) {
    dot += a[i] * b[i];
    na += a[i] * a[i];
    nb += b[i] * b[i];
  }
  float denom = std::sqrt(na) * std::sqrt(nb);
  if (denom == 0.0f) return 0.0f;
  return dot / denom;
}

const char* hsd_get_backend() {
#if defined(__AVX512F__)
  return "AVX512F (native)";
#elif defined(__AVX2__)
  return "AVX2 (native)";
#elif defined(__AVX__)
  return "AVX (native)";
#elif defined(__ARM_NEON)
  return "NEON (native)";
#else
  return "Scalar (native)";
#endif
}

// ---------------------------------------------------------------------------
// Batch kernels (the shapes TPU code actually uses; parity-test surface).
// ---------------------------------------------------------------------------

// x: [n, d], c: [k, d] -> out: [n, k] squared-L2.
void hsd_sqeuclidean_batch_f32(const float* x, const float* c, float* out,
                               size_t n, size_t k, size_t d) {
  for (size_t i = 0; i < n; ++i)
    for (size_t j = 0; j < k; ++j)
      out[i * k + j] = hsd_sqeuclidean_f32(x + i * d, c + j * d, d);
}

// ---------------------------------------------------------------------------
// Multithreaded PQ encode — the CPU baseline benchmark path.
// x: [n, m*s]; codebooks: [m, k, s]; codes out: [n, m] (uint8, k <= 256).
// Mirrors the reference's encode loop (src/pq.rs:177-196): per subspace,
// linear argmin over squared-L2 with lowest-index tie-breaking.
// ---------------------------------------------------------------------------

static void pq_encode_range(const float* x, const float* cb, uint8_t* codes,
                            size_t lo, size_t hi, size_t m, size_t k,
                            size_t s) {
  const size_t d = m * s;
  for (size_t i = lo; i < hi; ++i) {
    const float* xi = x + i * d;
    for (size_t mi = 0; mi < m; ++mi) {
      const float* sub = xi + mi * s;
      const float* book = cb + mi * k * s;
      float best = INFINITY;
      size_t best_j = 0;
      for (size_t j = 0; j < k; ++j) {
        const float* cj = book + j * s;
        float acc = 0.0f;
        for (size_t t = 0; t < s; ++t) {
          float dv = sub[t] - cj[t];
          acc += dv * dv;
        }
        if (acc < best) {
          best = acc;
          best_j = j;
        }
      }
      codes[i * m + mi] = static_cast<uint8_t>(best_j);
    }
  }
}

void hsd_pq_encode_f32(const float* x, const float* cb, uint8_t* codes,
                       size_t n, size_t m, size_t k, size_t s,
                       int num_threads) {
  if (num_threads <= 0)
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (num_threads <= 1 || n < 1024) {
    pq_encode_range(x, cb, codes, 0, n, m, k, s);
    return;
  }
  std::vector<std::thread> workers;
  size_t chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    size_t lo = t * chunk;
    size_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    workers.emplace_back(pq_encode_range, x, cb, codes, lo, hi, m, k, s);
  }
  for (auto& w : workers) w.join();
}

// Lloyd assignment step (k-means hot loop analog of the reference's
// Rayon par_iter, src/core/vector.rs:417-429): squared-L2 argmin.
void hsd_assign_f32(const float* x, const float* c, int32_t* codes, size_t n,
                    size_t k, size_t d, int num_threads) {
  if (num_threads <= 0)
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
  auto work = [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      const float* xi = x + i * d;
      float best = INFINITY;
      size_t best_j = 0;
      for (size_t j = 0; j < k; ++j) {
        float acc = 0.0f;
        const float* cj = c + j * d;
        for (size_t t = 0; t < d; ++t) {
          float dv = xi[t] - cj[t];
          acc += dv * dv;
        }
        if (acc < best) {
          best = acc;
          best_j = j;
        }
      }
      codes[i] = static_cast<int32_t>(best_j);
    }
  };
  if (num_threads <= 1 || n < 1024) {
    work(0, n);
    return;
  }
  std::vector<std::thread> workers;
  size_t chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    size_t lo = t * chunk;
    size_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    workers.emplace_back(work, lo, hi);
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
