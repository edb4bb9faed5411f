// The statistical outlier filter's kNN for sm_90a (K6).
//
// Replaces nerfjax/native/knn.cpp:22-48 knn_mean_distances, the OpenMP C++
// host kernel that nerfjax/colmap/outliers.py:41-62
// remove_statistical_outliers calls for every point of the SfM cloud. It is
// no TPU kernel: nerfjax runs it on the host, by brute force. Semantics are
// the native path's:
//   k = min(k, n - 1); n <= 1 or k <= 0 gives zeros (the wrapper, no launch);
//   the point's own index is excluded, duplicates of it count at distance 0;
//   d2 = dx*dx + dy*dy + dz*dz in f32 with dx = x_j - x_i, each product and
//   sum rounded on its own (explicit __fmul_rn/__fadd_rn, and the source is
//   built with -fmad=false), as the plain version's separate torch ops round;
//   the k smallest d2, their sqrt summed in float64 in ascending order,
//   divided by k and rounded to f32. The plain version
//   (ops/knn.py knn_mean_distances_plain) does the same arithmetic in the
//   same order, so the two agree bit for bit.
//
// What bounds it on an H100: 8 FP32 operations a pair over n(n - 1) ordered
// pairs (3 subtractions, 3 products, 2 sums), at 67 TFLOP/s about 11 ms at
// n = 303,000; the bytes (16 n) are nothing beside them. Without FMA each
// operation is an instruction of its own, so the FP32 pipes' instruction
// rate allows half of that peak, and the compare with the running k-th
// distance and the loop add more.
//
// First design, simple and right: one thread per query point; the candidate
// points staged through shared memory in tiles of TILE (x, y, z, 0) float4s
// that all threads of a warp read at once (a broadcast); a sorted list of
// the KMAX smallest d2 per thread, in registers (every index is a constant
// after unrolling). Its first KMAX - k slots hold -inf, so the k-th smallest
// is always the last slot: a candidate is tested against best[KMAX - 1] and
// inserted only when smaller, by a branch-free pass b[s] = min(max(a[s - 1],
// d), a[s]). KMAX is a template parameter (8, 16, 32, 64, 128, 256); above
// 256 the wrapper raises. Only the tile that holds a block's own queries
// tests j != i. Warp-cooperative selection and register tiling of several
// queries a thread are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 512;  // candidates staged per round, a multiple of THREADS
constexpr int K_LIMIT = 256;

template <int KMAX>
__device__ __forceinline__ void consider(float (&best)[KMAX], float d2) {
  // NaN (the padding past the last point) compares false and is skipped
  if (d2 < best[KMAX - 1]) {
#pragma unroll
    for (int s = KMAX - 1; s > 0; --s) best[s] = fminf(fmaxf(best[s - 1], d2), best[s]);
    best[0] = fminf(best[0], d2);
  }
}

__device__ __forceinline__ float dist2(float4 p, float qx, float qy, float qz) {
  const float dx = __fsub_rn(p.x, qx), dy = __fsub_rn(p.y, qy), dz = __fsub_rn(p.z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

template <int KMAX>
__global__ void __launch_bounds__(THREADS) knn_mean_dist_kernel(const float* __restrict__ pts, int n, int k,
                                                                float* __restrict__ out) {
  __shared__ float4 tile[TILE];
  const int first = blockIdx.x * THREADS;  // the block's first query
  const int i = first + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < n) {
    qx = pts[3 * (int64_t)i];
    qy = pts[3 * (int64_t)i + 1];
    qz = pts[3 * (int64_t)i + 2];
  }
  float best[KMAX];  // ascending; slots [0, KMAX - k) stay -inf
#pragma unroll
  for (int s = 0; s < KMAX; ++s) best[s] = s < KMAX - k ? -INFINITY : INFINITY;

  for (int base = 0; base < n; base += TILE) {
    __syncthreads();
    for (int t = threadIdx.x; t < TILE; t += THREADS) {
      const int64_t j = (int64_t)base + t;
      tile[t] = j < n ? make_float4(pts[3 * j], pts[3 * j + 1], pts[3 * j + 2], 0.f)
                      : make_float4(NAN, NAN, NAN, 0.f);
    }
    __syncthreads();
    if (first >= base && first < base + TILE) {  // block-uniform: this tile holds the block's queries
      const int self = i - base;
#pragma unroll 4
      for (int t = 0; t < TILE; ++t)
        if (t != self) consider<KMAX>(best, dist2(tile[t], qx, qy, qz));
    } else {
#pragma unroll 8
      for (int t = 0; t < TILE; ++t) consider<KMAX>(best, dist2(tile[t], qx, qy, qz));
    }
  }
  if (i >= n) return;
  double acc = 0.0;  // the k smallest, in ascending order
#pragma unroll
  for (int s = 0; s < KMAX; ++s)
    if (s >= KMAX - k) acc = __dadd_rn(acc, sqrt((double)best[s]));
  out[i] = (float)(acc / k);
}

template <int KMAX>
cudaError_t launch(const float* pts, int n, int k, float* out, cudaStream_t s) {
  knn_mean_dist_kernel<KMAX><<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(pts, n, k, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nerf_knn_max_k() { return K_LIMIT; }

// pts: [n, 3] contiguous f32, out: [n] f32; 2 <= n < 2^31 and 1 <= k <= min(n - 1, 256) (the wrapper checks).
extern "C" int nerf_knn_mean_dist(const void* pts, int n, int k, void* out, void* stream) {
  if (n < 2 || k < 1 || k > n - 1 || k > K_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(pts);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (k <= 8) e = launch<8>(p, n, k, o, s);
  else if (k <= 16) e = launch<16>(p, n, k, o, s);
  else if (k <= 32) e = launch<32>(p, n, k, o, s);
  else if (k <= 64) e = launch<64>(p, n, k, o, s);
  else if (k <= 128) e = launch<128>(p, n, k, o, s);
  else e = launch<256>(p, n, k, o, s);
  return static_cast<int>(e);
}
