// Hashed levels of the multiresolution hash grid, forward and table
// gradient, and the table-gradient scatter, for sm_90a.
//
// Replaces, from nerfjax:
//   hash_levels_fwd    <- the XLA forward _hash_levels_fwd
//                         (nerfjax/ops/hash_encode.py:304-332): exact
//                         8-corner trilinear sum, or the k = 1 dithered
//                         estimate (one corner drawn with P = its weight)
//   hash_levels_bwd    <- the XLA backward _hash_levels_bwd (:335-406): the
//                         scatter-add of g*w to all 8 corners (exact), of g
//                         to the planned corner (k = 1), or of g*Lh/gl to
//                         the planned corner of gl drawn levels
//   table_grad_scatter <- the Pallas kernels grad_onehot (_onehot_kernel)
//                         and grad_rowscatter (_rowscatter_kernel) of
//                         benchmarks/micro_onehot.py:44-129: out[p][idx_k]
//                         += g_p[k] into two f32 planes, out-of-range
//                         indices dropped (mode="drop"), in f32 as
//                         grad_rowscatter computes
//
// Plan. The k = 1 draws are keyed on the f32 bits of the position
// (_draw_corners :152-172, _draw_levels :197-217), so the backward replays
// the corners the forward gathered without saving them. Both kernels call
// one set of __device__ functions below (lattice, corner_weight, the CDF,
// draw_corner, draw_level), and every float operation in them is an
// explicit __fmul_rn/__fadd_rn/__fsub_rn: nothing is contracted into an
// FMA, so the weights, the CDF and u round exactly as the plain PyTorch
// version's separate multiplies and adds do, and the drawn corner is the
// same bit for bit. The file is also built with -fmad=false.
//
// What bounds them on an H100: the table gathers and the atomics. Each
// (level, point) reads one (k = 1) or eight (exact) 4-byte values from each
// of the two planes at hashed, i.e. random, addresses: every read pulls a
// 32-byte sector for 4 useful bytes, so the sector traffic is 8x the bytes
// the function needs. The backward's atomicAdds land at the same random
// addresses (the L2 performs them). The hashed levels of the tuned model
// hold 2 x 7 x 2^19 f32 = 29 MB, which fits the 50 MB L2, so most sectors
// come from L2 rather than HBM. This first version is simple: one thread
// per (level, point) in the forward, per (drawn level, point) in the
// backward, positions and outputs coalesced along points, no shared-memory
// staging, no sorting of indices. PERF.md has its times beside its bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int THREADS = 256;
constexpr uint32_t LEVEL_SALT = 0x85EBCA6Bu;  // nerfjax _LEVEL_SALT

// Per hashed level: the lattice scale and the offset of its table relative
// to the first hashed level. Passed by value (kernel parameter space).
struct Levels {
  float scale[MAX_LEVELS];
  int64_t offset[MAX_LEVELS];
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));  // _pack_pairs_bf16 rounds so
}

// floor(x*scale + 0.5) and its fraction, as nerfjax's _corner_weights and
// _hash_level_indices compute them (no contraction)
__device__ __forceinline__ void lattice(float x, float s, int& i, float& t) {
  float p = __fadd_rn(__fmul_rn(x, s), 0.5f);
  float f = floorf(p);
  i = static_cast<int>(f);
  t = __fsub_rn(p, f);
}

// trilinear weight of corner c = dx*4 + dy*2 + dz (nerfjax _CORNERS order),
// evaluated as (wx*wy)*wz
__device__ __forceinline__ float corner_weight(int c, float tx, float ty, float tz) {
  float wx = (c & 4) ? tx : __fsub_rn(1.0f, tx);
  float wy = (c & 2) ? ty : __fsub_rn(1.0f, ty);
  float wz = (c & 1) ? tz : __fsub_rn(1.0f, tz);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

__device__ __forceinline__ int64_t hash_index(int ix, int iy, int iz, int c, uint32_t mask) {
  uint32_t h = static_cast<uint32_t>(ix + ((c >> 2) & 1)) * 1u ^
               static_cast<uint32_t>(iy + ((c >> 1) & 1)) * 2654435761u ^
               static_cast<uint32_t>(iz + (c & 1)) * 805459861u;
  return static_cast<int64_t>(h & mask);
}

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  return h ^ (h >> 12);
}

__device__ __forceinline__ uint32_t position_seed(float x, float y, float z, uint32_t salt) {
  return (__float_as_uint(x) * 0x9E3779B1u ^ __float_as_uint(y) * 0x85EBCA77u ^
          __float_as_uint(z) * 0xC2B2AE3Du) ^ salt;
}

// the top 24 bits of h as a uniform in [0, 1) (exact: (h >> 8) < 2^24)
__device__ __forceinline__ float unit24(uint32_t h) {
  return __fmul_rn(static_cast<float>(h >> 8), 5.9604644775390625e-8f);
}

// The k = 1 plan of level l at (x, y, z): the hashed index (relative to the
// first hashed level) of the one corner drawn with P(corner) = its weight.
// cdf is the sequential f32 cumsum of the 8 weights; u is scaled by cdf[7]
// and the corner is #{j < 7 : u >= cdf[j]} (_draw_corners with k = 1, j = 0).
__device__ __forceinline__ int64_t plan_k1(const Levels& L, int l, uint32_t mask, float x,
                                           float y, float z, uint32_t seed) {
  int ix, iy, iz;
  float tx, ty, tz;
  lattice(x, L.scale[l], ix, tx);
  lattice(y, L.scale[l], iy, ty);
  lattice(z, L.scale[l], iz, tz);
  float cdf[8];
  float acc = corner_weight(0, tx, ty, tz);
  cdf[0] = acc;
#pragma unroll
  for (int c = 1; c < 8; ++c) {
    acc = __fadd_rn(acc, corner_weight(c, tx, ty, tz));
    cdf[c] = acc;
  }
  uint32_t h = mix(seed ^ (static_cast<uint32_t>(l) * 2654435761u));
  float u = __fmul_rn(unit24(h), cdf[7]);
  int corner = 0;
#pragma unroll
  for (int j = 0; j < 7; ++j) corner += (u >= cdf[j]) ? 1 : 0;
  return hash_index(ix, iy, iz, corner, mask) + L.offset[l];
}

// draw j of the level subset (_draw_levels): a level id in [0, Lh)
__device__ __forceinline__ int draw_level(uint32_t seed, int j, int Lh) {
  uint32_t h = mix(seed + static_cast<uint32_t>(j) * 0x7F4A7C15u);
  int id = static_cast<int>(__fmul_rn(unit24(h), static_cast<float>(Lh)));
  return id < Lh - 1 ? id : Lh - 1;
}

// out0[i] += v0, out1[i] += v1 for 0 <= i < T; an index outside is dropped.
// The one add of K2 and K3.
__device__ __forceinline__ void scatter_add2(float* out0, float* out1, int64_t T, int64_t i,
                                             float v0, float v1) {
  if (i < 0 || i >= T) return;
  atomicAdd(out0 + i, v0);
  atomicAdd(out1 + i, v1);
}

// K1. planes: [2, total] f32; the hashed levels start at column base.
// out: [2, Lh, N] f32. sel (optional): [Lh, N] int32 planned index (k = 1).
template <bool K1>
__global__ void __launch_bounds__(THREADS)
hash_levels_fwd_kernel(const float* __restrict__ planes, int64_t total, int64_t base,
                       const float* __restrict__ xs, const float* __restrict__ ys,
                       const float* __restrict__ zs, int64_t N, int Lh, Levels L,
                       uint32_t mask, float* __restrict__ out, int32_t* __restrict__ sel) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= Lh * N) return;
  int l = static_cast<int>(t / N);
  int64_t n = t - l * N;
  float x = xs[n], y = ys[n], z = zs[n];
  const float* p0 = planes + base;
  const float* p1 = planes + total + base;
  float e0, e1;
  if (K1) {
    int64_t i = plan_k1(L, l, mask, x, y, z, position_seed(x, y, z, 0u));
    e0 = bf16_round(p0[i]);
    e1 = bf16_round(p1[i]);
    if (sel != nullptr) sel[t] = static_cast<int32_t>(i);
  } else {
    int ix, iy, iz;
    float tx, ty, tz;
    lattice(x, L.scale[l], ix, tx);
    lattice(y, L.scale[l], iy, ty);
    lattice(z, L.scale[l], iz, tz);
    e0 = 0.0f;
    e1 = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int64_t i = hash_index(ix, iy, iz, c, mask) + L.offset[l];
      float w = corner_weight(c, tx, ty, tz);
      e0 = __fadd_rn(e0, __fmul_rn(bf16_round(p0[i]), w));
      e1 = __fadd_rn(e1, __fmul_rn(bf16_round(p1[i]), w));
    }
  }
  out[t] = e0;
  out[Lh * N + t] = e1;
}

// K2. g: [2, Lh, N] f32 upstream gradient; grad: [2, total] f32 that the
// hashed levels' gradient is added into, at columns base.. (the encode's
// backward hands K3 and K2 one zeroed gradient).
//   MODE 0: exact, one thread per (level, point), g*w to all 8 corners
//   MODE 1: k = 1, one thread per (level, point), g to the planned corner
//   MODE 2: k = 1 with the level subset, one thread per (draw, point): the
//           draw's level l, g[l]*scale (scale = Lh/gl) to its planned corner;
//           the draws are iid, so a level drawn twice scatters twice
template <int MODE>
__global__ void __launch_bounds__(THREADS)
hash_levels_bwd_kernel(const float* __restrict__ g, int64_t total, int64_t base,
                       const float* __restrict__ xs, const float* __restrict__ ys,
                       const float* __restrict__ zs, int64_t N, int Lh, int gl, float scale,
                       Levels L, uint32_t mask, float* __restrict__ grad) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  int64_t rows = MODE == 2 ? gl : Lh;
  if (t >= rows * N) return;
  int r = static_cast<int>(t / N);
  int64_t n = t - r * N;
  float x = xs[n], y = ys[n], z = zs[n];
  float* o0 = grad + base;
  float* o1 = grad + total + base;
  int64_t T = total - base;
  if (MODE == 0) {
    int ix, iy, iz;
    float tx, ty, tz;
    lattice(x, L.scale[r], ix, tx);
    lattice(y, L.scale[r], iy, ty);
    lattice(z, L.scale[r], iz, tz);
    float g0 = g[r * N + n], g1 = g[(Lh + r) * N + n];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float w = corner_weight(c, tx, ty, tz);
      scatter_add2(o0, o1, T, hash_index(ix, iy, iz, c, mask) + L.offset[r], __fmul_rn(g0, w),
                   __fmul_rn(g1, w));
    }
    return;
  }
  int l = MODE == 2 ? draw_level(position_seed(x, y, z, LEVEL_SALT), r, Lh) : r;
  int64_t i = plan_k1(L, l, mask, x, y, z, position_seed(x, y, z, 0u));
  float g0 = g[l * N + n], g1 = g[(Lh + l) * N + n];
  if (MODE == 2) {
    g0 = __fmul_rn(g0, scale);
    g1 = __fmul_rn(g1, scale);
  }
  scatter_add2(o0, o1, T, i, g0, g1);
}

// K3. out: [2, T] f32 that the entries are added into; one thread per
// entry k.
__global__ void __launch_bounds__(THREADS)
table_grad_scatter_kernel(const int32_t* __restrict__ idx, const float* __restrict__ g0,
                          const float* __restrict__ g1, int64_t K, int64_t T,
                          float* __restrict__ out) {
  int64_t k = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (k >= K) return;
  scatter_add2(out, out + T, T, idx[k], g0[k], g1[k]);
}

unsigned blocks(int64_t work) { return static_cast<unsigned>((work + THREADS - 1) / THREADS); }

bool fill_levels(Levels& L, int Lh, const float* scales, const int64_t* offsets) {
  if (Lh < 1 || Lh > MAX_LEVELS) return false;
  for (int l = 0; l < Lh; ++l) {
    L.scale[l] = scales[l];
    L.offset[l] = offsets[l];
  }
  return true;
}

}  // namespace

extern "C" int nerf_hash_max_levels() { return MAX_LEVELS; }

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// level count outside 1..MAX_LEVELS).
extern "C" int nerf_hash_levels_fwd(const float* planes, int64_t total, int64_t base,
                                    const float* x, const float* y, const float* z, int64_t N,
                                    int Lh, const float* scales, const int64_t* offsets,
                                    uint32_t mask, int k1, float* out, int32_t* sel,
                                    void* stream) {
  Levels L;
  if (!fill_levels(L, Lh, scales, offsets)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k1) {
    hash_levels_fwd_kernel<true><<<blocks(Lh * N), THREADS, 0, s>>>(planes, total, base, x, y, z,
                                                                    N, Lh, L, mask, out, sel);
  } else {
    hash_levels_fwd_kernel<false><<<blocks(Lh * N), THREADS, 0, s>>>(planes, total, base, x, y, z,
                                                                     N, Lh, L, mask, out, sel);
  }
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 exact, 1 k = 1, 2 k = 1 with gl drawn levels scaled by `scale`
extern "C" int nerf_hash_levels_bwd(const float* g, int64_t total, int64_t base, const float* x,
                                    const float* y, const float* z, int64_t N, int Lh,
                                    const float* scales, const int64_t* offsets, uint32_t mask,
                                    int mode, int gl, float scale, float* grad, void* stream) {
  Levels L;
  if (!fill_levels(L, Lh, scales, offsets) || mode < 0 || mode > 2 || (mode == 2 && gl < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    hash_levels_bwd_kernel<0><<<blocks(Lh * N), THREADS, 0, s>>>(g, total, base, x, y, z, N, Lh,
                                                                 gl, scale, L, mask, grad);
  } else if (mode == 1) {
    hash_levels_bwd_kernel<1><<<blocks(Lh * N), THREADS, 0, s>>>(g, total, base, x, y, z, N, Lh,
                                                                 gl, scale, L, mask, grad);
  } else {
    hash_levels_bwd_kernel<2><<<blocks(gl * N), THREADS, 0, s>>>(g, total, base, x, y, z, N, Lh,
                                                                 gl, scale, L, mask, grad);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nerf_table_grad_scatter(const int32_t* idx, const float* g0, const float* g1,
                                       int64_t K, int64_t T, float* out, void* stream) {
  table_grad_scatter_kernel<<<blocks(K), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, g0, g1, K, T, out);
  return static_cast<int>(cudaGetLastError());
}
