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
//   same order, and the result depends only on the multiset of the k
//   smallest d2, so every route here agrees with it bit for bit.
//
// Every thread keeps a sorted list of the KMAX smallest d2 it has seen, in
// registers (every index is a constant after unrolling). Its first KMAX - k
// slots hold -inf, so the k-th smallest is always the last slot: a candidate
// is tested against best[KMAX - 1] and inserted only when smaller, by a
// branch-free pass b[s] = min(max(a[s - 1], d), a[s]). KMAX is a template
// parameter (8, 16, 32, 64, 128, 256); above 256 the wrapper raises.
//
// Two routes (ops/knn.py knn_plan chooses):
//
// The grid, an exact search over hashed cubic cells:
//   knn_bin_kernel      a point's cell, floor((x - origin) * inv_h) per axis
//                       in float64, packed into a 63-bit key, hashed into a
//                       power-of-two table of buckets; counts per bucket.
//   (torch.cumsum)      bucket offsets.
//   knn_scatter_kernel  the points placed by bucket: float4 (x, y, z, index
//                       bits) and the key.
//   knn_mark_kernel     flags the buckets that hold more than one cell; only
//                       those test each point's key.
//   knn_grid_kernel     one thread per query, queries in bucket order (a
//                       warp's queries share cells, so a candidate's load is
//                       one broadcast): the cube of cells around the query's
//                       grows ring by ring up to r_max; a cell is skipped
//                       when its least possible d2 is at least the list's
//                       k-th, the search stops when the least possible d2 to
//                       anything outside the cube is. Both bounds in float64
//                       from the query's offset to the faces, less
//                       h * 2^-20 (the binning's rounding), times 1 - 2^-16:
//                       what they cut off has a rounded d2 of at least the
//                       k-th, so it changes nothing. A query still open
//                       after r_max rings is listed with its k-th. The same
//                       kernel runs the coarser levels (cells 2x wider a
//                       level, all points binned anew; ops/knn.py chooses
//                       how many) over the list a finer level left, each
//                       query from scratch.
//   knn_tail_kernel     one warp per query the last level left open (an
//                       isolated point), eight
//                       a block: the block stages all points through shared
//                       memory in tiles that its eight queries share; each
//                       lane keeps the points of its stride that are at most
//                       the listed k-th in a list of its own; k rounds of a
//                       warp minimum merge the 32 lists in ascending order.
//   Both search kernels count the d2 they evaluate (the pairs).
//
// The brute force (the first design), for clouds the grid cannot split (all points in
// one cell), small clouds and non-finite coordinates:
//   knn_mean_dist_kernel  one thread per query; the candidate points staged
//                       through shared memory in tiles of TILE (x, y, z, 0)
//                       float4s that all threads of a warp read at once.
//
// What bounds them on an H100: without FMA each of d2's 8 operations is an
// instruction of its own, at 132 SMs x 128 lanes x 1.98 GHz = 33.5 T
// instructions/s: n(n - 1) pairs by brute force, the counted pairs on the
// grid.

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

// -- the grid -------------------------------------------------------------------------

constexpr int CELL_BITS = 21;
constexpr double BOUND_SHRINK = 1.0 - 1.0 / 65536.0;
constexpr double SLACK = 1.0 / 1048576.0;  // of h
constexpr int TAIL_WARPS = 8;  // tail queries a block takes at once, one warp each
constexpr int TAIL_THREADS = 32 * TAIL_WARPS;
constexpr int TAIL_TILE = 1024;  // points staged per round (16 KB), a multiple of TAIL_THREADS
constexpr int TAIL_BLOCKS_PER_SM = 4;

__device__ __forceinline__ uint32_t cell_hash(uint32_t cx, uint32_t cy, uint32_t cz) {
  uint32_t h = cx * 0x9E3779B1u ^ cy * 0x85EBCA77u ^ cz * 0xC2B2AE3Du;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  return h ^ (h >> 15);
}

__device__ __forceinline__ int64_t cell_key(int64_t cx, int64_t cy, int64_t cz) {
  return (cx << (2 * CELL_BITS)) | (cy << CELL_BITS) | cz;
}

__device__ __forceinline__ int cell_of(float x, double o, double inv_h, int g) {
  const long long c = (long long)floor(((double)x - o) * inv_h);
  return (int)min((long long)g - 1, max(0ll, c));
}

__global__ void knn_bin_kernel(const float* __restrict__ pts, int n, double ox, double oy, double oz, double inv_h,
                               int gx, int gy, int gz, int mask, int* __restrict__ bucket,
                               int64_t* __restrict__ key, int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int cx = cell_of(pts[3 * (int64_t)i], ox, inv_h, gx);
  const int cy = cell_of(pts[3 * (int64_t)i + 1], oy, inv_h, gy);
  const int cz = cell_of(pts[3 * (int64_t)i + 2], oz, inv_h, gz);
  const int b = (int)(cell_hash(cx, cy, cz) & (uint32_t)mask);
  bucket[i] = b;
  key[i] = cell_key(cx, cy, cz);
  atomicAdd(count + b, 1);
}

__global__ void knn_scatter_kernel(const float* __restrict__ pts, int n, const int* __restrict__ bucket,
                                   const int64_t* __restrict__ key, const int* __restrict__ start,
                                   int* __restrict__ cursor, float4* __restrict__ sorted,
                                   int64_t* __restrict__ sorted_key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = bucket[i];
  const int at = start[b] + atomicAdd(cursor + b, 1);
  sorted[at] = make_float4(pts[3 * (int64_t)i], pts[3 * (int64_t)i + 1], pts[3 * (int64_t)i + 2], __int_as_float(i));
  sorted_key[at] = key[i];
}

__device__ __forceinline__ int bucket_of_key(int64_t key, int mask) {
  const uint32_t m = (1u << CELL_BITS) - 1u;
  return (int)(cell_hash((uint32_t)(key >> (2 * CELL_BITS)) & m, (uint32_t)(key >> CELL_BITS) & m,
                         (uint32_t)key & m) & (uint32_t)mask);
}

__global__ void knn_mark_kernel(const int64_t* __restrict__ sorted_key, int n, int mask, int* __restrict__ impure) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < 1 || j >= n) return;
  const int64_t a = sorted_key[j - 1], b = sorted_key[j];
  if (a != b) {
    const int bb = bucket_of_key(b, mask);
    if (bucket_of_key(a, mask) == bb) impure[bb] = 1;
  }
}

__device__ __forceinline__ double face_gap(double lo, double hi, double q, double slack) {
  const double g = fmax(fmax(lo - q, q - hi), 0.0);
  return fmax(g - slack, 0.0);
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int KMAX>
__device__ __forceinline__ double sum_roots(const float (&best)[KMAX], int k) {
  double acc = 0.0;  // the k smallest, in ascending order
#pragma unroll
  for (int s = 0; s < KMAX; ++s)
    if (s >= KMAX - k) acc = __dadd_rn(acc, sqrt((double)best[s]));
  return acc;
}

template <int KMAX>
__global__ void __launch_bounds__(THREADS)
    knn_grid_kernel(const float* __restrict__ pts, const int* __restrict__ queries, int n_queries,
                    const float4* __restrict__ sorted, const int64_t* __restrict__ sorted_key,
                    const int* __restrict__ start, const int* __restrict__ impure, int n, int k, double ox,
                    double oy, double oz, double h, int gx, int gy, int gz, int mask, int r_max,
                    float* __restrict__ out, int* __restrict__ tail_idx, float* __restrict__ tail_t0,
                    int* __restrict__ tail_count, unsigned long long* __restrict__ pairs) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  unsigned long long tested = 0;
  if (t < n_queries) {
    // the queries: every point in bucket order (queries == nullptr), or the
    // listed points a finer level left open
    float4 q;
    int cx, cy, cz;
    if (queries == nullptr) {
      q = sorted[t];
      const int64_t qkey = sorted_key[t];
      cx = (int)(qkey >> (2 * CELL_BITS));
      cy = (int)(qkey >> CELL_BITS) & ((1 << CELL_BITS) - 1);
      cz = (int)qkey & ((1 << CELL_BITS) - 1);
    } else {
      const int i = queries[t];
      q = make_float4(pts[3 * (int64_t)i], pts[3 * (int64_t)i + 1], pts[3 * (int64_t)i + 2], __int_as_float(i));
      const double inv_h = 1.0 / h;
      cx = cell_of(q.x, ox, inv_h, gx);
      cy = cell_of(q.y, oy, inv_h, gy);
      cz = cell_of(q.z, oz, inv_h, gz);
    }
    const int self = __float_as_int(q.w);
    const double qx = (double)q.x - ox, qy = (double)q.y - oy, qz = (double)q.z - oz;
    const double slack = h * SLACK;
    float best[KMAX];
#pragma unroll
    for (int s = 0; s < KMAX; ++s) best[s] = s < KMAX - k ? -INFINITY : INFINITY;
    bool done = false;
    for (int r = 0; r <= r_max && !done; ++r) {
      for (int dz = -r; dz <= r; ++dz) {
        const int z = cz + dz;
        if (z < 0 || z >= gz) continue;
        const double zlo = (double)z * h;
        const double gzz = face_gap(zlo, zlo + h, qz, slack);
        for (int dy = -r; dy <= r; ++dy) {
          const int y = cy + dy;
          if (y < 0 || y >= gy) continue;
          const double ylo = (double)y * h;
          const double gyy = face_gap(ylo, ylo + h, qy, slack);
          const bool edge_zy = dz == -r || dz == r || dy == -r || dy == r;
          for (int dx = -r; dx <= r; dx += (edge_zy || dx == r) ? 1 : 2 * r) {
            const int x = cx + dx;
            if (x < 0 || x >= gx) continue;
            const double xlo = (double)x * h;
            const double gxx = face_gap(xlo, xlo + h, qx, slack);
            const double lb = (gxx * gxx + gyy * gyy + gzz * gzz) * BOUND_SHRINK;
            if ((double)best[KMAX - 1] <= lb) continue;
            const int64_t ck = cell_key(x, y, z);
            const int b = (int)(cell_hash(x, y, z) & (uint32_t)mask);
            const int s0 = start[b], s1 = start[b + 1];
            if (s0 == s1) continue;
            if (!impure[b]) {
              if (sorted_key[s0] != ck) continue;
              for (int j = s0; j < s1; ++j) {
                const float4 p = sorted[j];
                if (__float_as_int(p.w) != self) {
                  consider<KMAX>(best, dist2(p, q.x, q.y, q.z));
                  ++tested;
                }
              }
            } else {
              for (int j = s0; j < s1; ++j) {
                if (sorted_key[j] != ck) continue;
                const float4 p = sorted[j];
                if (__float_as_int(p.w) != self) {
                  consider<KMAX>(best, dist2(p, q.x, q.y, q.z));
                  ++tested;
                }
              }
            }
          }
        }
      }
      // the least d2 to any cell outside the cube within r of the query's cell
      double m = INFINITY;
      if (cx - r > 0) m = fmin(m, qx - (double)(cx - r) * h);
      if (cx + r + 1 < gx) m = fmin(m, (double)(cx + r + 1) * h - qx);
      if (cy - r > 0) m = fmin(m, qy - (double)(cy - r) * h);
      if (cy + r + 1 < gy) m = fmin(m, (double)(cy + r + 1) * h - qy);
      if (cz - r > 0) m = fmin(m, qz - (double)(cz - r) * h);
      if (cz + r + 1 < gz) m = fmin(m, (double)(cz + r + 1) * h - qz);
      if (isinf(m)) {
        done = true;  // the cube covers the grid
      } else {
        const double g = fmax(fmax(m, 0.0) - slack, 0.0);
        done = (double)best[KMAX - 1] <= g * g * BOUND_SHRINK;
      }
    }
    if (done) {
      out[self] = (float)(sum_roots<KMAX>(best, k) / k);
    } else {
      const int slot = atomicAdd(tail_count, 1);
      tail_idx[slot] = self;
      tail_t0[slot] = best[KMAX - 1];
    }
  }
  tested = warp_sum(tested);
  if ((threadIdx.x & 31) == 0 && tested) atomicAdd(pairs, tested);
}

template <int KMAX>
__global__ void __launch_bounds__(TAIL_THREADS)
    knn_tail_kernel(const float* __restrict__ pts, const float4* __restrict__ sorted, int n, int k,
                    const int* __restrict__ tail_idx,
                    const float* __restrict__ tail_t0, const int* __restrict__ tail_count,
                    float* __restrict__ out, unsigned long long* __restrict__ pairs) {
  __shared__ float4 tile[TAIL_TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int count = *tail_count;
  for (int base = blockIdx.x * TAIL_WARPS; base < count; base += gridDim.x * TAIL_WARPS) {
    const int w = base + warp;  // this warp's query; the block's warps share each staged tile
    const bool mine = w < count;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    float t0 = -INFINITY;
    if (mine) {
      const int i = tail_idx[w];
      q = make_float4(pts[3 * (int64_t)i], pts[3 * (int64_t)i + 1], pts[3 * (int64_t)i + 2], __int_as_float(i));
      t0 = tail_t0[w];
    }
    const int self = __float_as_int(q.w);
    float best[KMAX];
#pragma unroll
    for (int s = 0; s < KMAX; ++s) best[s] = s < KMAX - k ? -INFINITY : INFINITY;
    for (int t = 0; t < n; t += TAIL_TILE) {
      __syncthreads();
      for (int i = threadIdx.x; i < TAIL_TILE; i += TAIL_THREADS)
        tile[i] = t + i < n ? sorted[t + i] : make_float4(NAN, NAN, NAN, __int_as_float(-1));
      __syncthreads();
      if (mine) {
#pragma unroll 4
        for (int i = lane; i < TAIL_TILE; i += 32) {
          const float4 p = tile[i];
          const float d2 = dist2(p, q.x, q.y, q.z);  // NaN past the last point: never kept
          if (d2 <= t0 && __float_as_int(p.w) != self) consider<KMAX>(best, d2);
        }
      }
    }
    if (!mine) continue;
    // merge: k rounds of the warp's least head; a lane's head is its least
    // slot above -inf, and the winning lane sets that slot to -inf
    double acc = 0.0;
    for (int s = 0; s < k; ++s) {
      float head = INFINITY;
#pragma unroll
      for (int i = KMAX - 1; i >= 0; --i)
        if (best[i] > -INFINITY) head = best[i];
      // d2 >= 0, so the bits of head order as its values
      const unsigned bits = __reduce_min_sync(0xffffffffu, __float_as_uint(head));
      const unsigned winners = __ballot_sync(0xffffffffu, __float_as_uint(head) == bits);
      if (lane == __ffs(winners) - 1) {
        bool popped = false;
#pragma unroll
        for (int i = 0; i < KMAX; ++i)
          if (!popped && best[i] > -INFINITY) {
            best[i] = -INFINITY;
            popped = true;
          }
      }
      acc = __dadd_rn(acc, sqrt((double)__uint_as_float(bits)));
    }
    if (lane == 0) {
      out[self] = (float)(acc / k);
      atomicAdd(pairs, (unsigned long long)(n - 1));
    }
  }
}

#define KNN_DISPATCH(k, LAUNCH) \
  do {                              \
    if ((k) <= 8) LAUNCH(8);        \
    else if ((k) <= 16) LAUNCH(16); \
    else if ((k) <= 32) LAUNCH(32); \
    else if ((k) <= 64) LAUNCH(64); \
    else if ((k) <= 128) LAUNCH(128); \
    else LAUNCH(256);               \
  } while (0)

int blocks_of(int n) { return (n + THREADS - 1) / THREADS; }

int tail_blocks() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * TAIL_BLOCKS_PER_SM;
}

}  // namespace

extern "C" int nerf_knn_max_k() { return K_LIMIT; }

// pts: [n, 3] contiguous f32, out: [n] f32; 2 <= n < 2^31 and 1 <= k <= min(n - 1, 256) (the wrapper checks).
extern "C" int nerf_knn_mean_dist(const void* pts, int n, int k, void* out, void* stream) {
  if (n < 2 || k < 1 || k > n - 1 || k > K_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(pts);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BRUTE(KM) knn_mean_dist_kernel<KM><<<blocks_of(n), THREADS, 0, s>>>(p, n, k, o)
  KNN_DISPATCH(k, BRUTE);
#undef BRUTE
  return static_cast<int>(cudaGetLastError());
}

// The grid route's five launches, in order; count/cursor/impure: [mask + 1]
// int32 zeros, start: [mask + 2] offsets (start[0] = 0), tail_count: one
// int32 zero, pairs: one uint64 zero.
extern "C" int nerf_knn_bin(const void* pts, int n, double ox, double oy, double oz, double inv_h, int gx, int gy,
                            int gz, int mask, void* bucket, void* key, void* count, void* stream) {
  if (n < 1 || gx < 1 || gy < 1 || gz < 1 || gx > (1 << CELL_BITS) || gy > (1 << CELL_BITS) ||
      gz > (1 << CELL_BITS))
    return static_cast<int>(cudaErrorInvalidValue);
  knn_bin_kernel<<<blocks_of(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n, ox, oy, oz, inv_h, gx, gy, gz, mask, static_cast<int*>(bucket),
      static_cast<int64_t*>(key), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nerf_knn_scatter(const void* pts, int n, const void* bucket, const void* key, const void* start,
                                void* cursor, void* sorted, void* sorted_key, void* stream) {
  knn_scatter_kernel<<<blocks_of(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n, static_cast<const int*>(bucket), static_cast<const int64_t*>(key),
      static_cast<const int*>(start), static_cast<int*>(cursor), static_cast<float4*>(sorted),
      static_cast<int64_t*>(sorted_key));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nerf_knn_mark(const void* sorted_key, int n, int mask, void* impure, void* stream) {
  knn_mark_kernel<<<blocks_of(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(sorted_key), n, mask, static_cast<int*>(impure));
  return static_cast<int>(cudaGetLastError());
}

// queries: nullptr (every point, in bucket order) or n_queries point indices.
extern "C" int nerf_knn_grid(const void* pts, const void* queries, int n_queries, const void* sorted,
                             const void* sorted_key, const void* start, const void* impure, int n, int k, double ox,
                             double oy, double oz, double h, int gx, int gy, int gz, int mask, int r_max, void* out,
                             void* tail_idx, void* tail_t0, void* tail_count, void* pairs, void* stream) {
  if (n < 2 || k < 1 || k > n - 1 || k > K_LIMIT || r_max < 0 || n_queries < 1 || n_queries > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRID(KM)                                                                                              \
  knn_grid_kernel<KM><<<blocks_of(n_queries), THREADS, 0, s>>>(                                               \
       static_cast<const float*>(pts), static_cast<const int*>(queries), n_queries,                         \
       static_cast<const float4*>(sorted), static_cast<const int64_t*>(sorted_key),                          \
       static_cast<const int*>(start), static_cast<const int*>(impure), n, k, ox, oy, oz, h, gx, gy, gz, mask, \
       r_max, static_cast<float*>(out), static_cast<int*>(tail_idx), static_cast<float*>(tail_t0),           \
       static_cast<int*>(tail_count), static_cast<unsigned long long*>(pairs))
  KNN_DISPATCH(k, GRID);
#undef GRID
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nerf_knn_tail(const void* pts, const void* sorted, int n, int k, const void* tail_idx,
                             const void* tail_t0, const void* tail_count, void* out, void* pairs, void* stream) {
  if (n < 2 || k < 1 || k > n - 1 || k > K_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TAIL(KM)                                                                                         \
  knn_tail_kernel<KM><<<tail_blocks(), TAIL_THREADS, 0, s>>>(                                            \
       static_cast<const float*>(pts), static_cast<const float4*>(sorted), n, k,                        \
       static_cast<const int*>(tail_idx),                                                               \
       static_cast<const float*>(tail_t0), static_cast<const int*>(tail_count), static_cast<float*>(out), \
       static_cast<unsigned long long*>(pairs))
  KNN_DISPATCH(k, TAIL);
#undef TAIL
  return static_cast<int>(cudaGetLastError());
}
