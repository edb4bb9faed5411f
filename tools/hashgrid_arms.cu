// The design arms of the feature-last encode's kernels that the shipped
// source does not keep, for tools/hashgrid_arms.py, which times them against
// the shipped ones on one card. It includes the shipped source (build with
// -I nerfjax_torch/csrc and that source's flags), so the arms share its
// device functions.
//
//   arms_fwd       the forward: arm 0, the first design (one thread per
//                  (point, level), level innermost, both planes read in
//                  place: 16 4-byte loads a (point, level)); 1, the same
//                  threads on the float2-pair table; 2, the shipped block
//                  tile (hashgrid_fwd_kernel); 3, the tile with each pair of
//                  x-neighbour corners served by one 16-byte load where both
//                  entries lie in it
//   arms_stage     the first design's backward: g*w staged per (level,
//                  corner, point) for K3
//   arms_bwd_inplace  the shipped backward's kernel reading g [N, 2L] in
//                  place (two 4-byte loads 8L bytes apart a (level, point),
//                  a sector each) instead of its transpose

#include "hash_encode.cu"

namespace {

template <bool PLANES>
__global__ void __launch_bounds__(THREADS)
first_fwd_kernel(const float* __restrict__ planes, const float2* __restrict__ pairs, int64_t total,
                 const float* __restrict__ x01, int64_t N, int L, GridLevels G, uint32_t mask,
                 float* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= N * L) return;
  const int64_t n = t / L;
  const int l = static_cast<int>(t - n * L);
  int ix, iy, iz;
  float tx, ty, tz;
  grid_cell(G, l, x01, n, ix, iy, iz, tx, ty, tz);
  float2 f[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int64_t i = grid_index(G, l, ix, iy, iz, c, mask);
    f[c] = PLANES ? make_float2(__ldg(planes + i), __ldg(planes + total + i)) : __ldg(pairs + i);
  }
  const float2 v = grid_blend(f, tx, ty, tz);
  out[n * 2 * L + l] = v.x;
  out[n * 2 * L + L + l] = v.y;
}

// hashgrid_fwd_kernel with the 16-byte pairs: each x-neighbour pair
// (corners c, c + 4) first loads the aligned 16 bytes that hold entry e_c;
// where e_{c+4} lies in them too (a hashed level at even ix: the x prime is
// 1, so the two hashes differ in bit 0 only; a dense level where the two
// entries are adjacent and e_c is even) that load serves both, else e_{c+4}
// is loaded on its own. The 16 bytes are loaded only inside the table.
__global__ void __launch_bounds__(THREADS)
pairs_fwd_kernel(const float2* __restrict__ pairs, int64_t total, const float* __restrict__ x01, int64_t N, int L,
                 GridLevels G, uint32_t mask, float* __restrict__ out) {
  __shared__ float xs[3 * FWD_POINTS];
  __shared__ float tile[FWD_POINTS * (2 * MAX_LEVELS + 1)];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * FWD_POINTS;
  const int np = static_cast<int>(N - p0 < FWD_POINTS ? N - p0 : FWD_POINTS);
  for (int i = threadIdx.x; i < 3 * np; i += THREADS) xs[i] = x01[3 * p0 + i];
  __syncthreads();
  const int row = 2 * L, stride = row + 1;
  const int warp = static_cast<int>(threadIdx.x >> 5), lane = static_cast<int>(threadIdx.x & 31);
  for (int task = warp; task < (FWD_POINTS / 32) * L; task += THREADS / 32) {
    const int l = task % L, p = (task / L) * 32 + lane;
    if (p >= np) continue;
    const float s = G.scale[l];
    int ix, iy, iz;
    float tx, ty, tz;
    lattice(xs[3 * p], s, ix, tx);
    lattice(xs[3 * p + 1], s, iy, ty);
    lattice(xs[3 * p + 2], s, iz, tz);
    float2 f[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t a = grid_index(G, l, ix, iy, iz, c, mask), b = grid_index(G, l, ix, iy, iz, c + 4, mask);
      if ((a | 1) < total) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(pairs) + (a >> 1));
        f[c] = (a & 1) ? make_float2(q.z, q.w) : make_float2(q.x, q.y);
        f[c + 4] = ((a ^ b) >> 1) != 0 ? __ldg(pairs + b) : (b & 1) ? make_float2(q.z, q.w) : make_float2(q.x, q.y);
      } else {
        f[c] = __ldg(pairs + a);
        f[c + 4] = __ldg(pairs + b);
      }
    }
    const float2 v = grid_blend(f, tx, ty, tz);
    tile[p * stride + l] = v.x;
    tile[p * stride + L + l] = v.y;
  }
  __syncthreads();
  for (int p = warp; p < np; p += THREADS / 32) {
    for (int c = lane; c < row; c += 32) out[(p0 + p) * row + c] = tile[p * stride + c];
  }
}

__global__ void __launch_bounds__(THREADS)
stage_kernel(const float* __restrict__ g, const float* __restrict__ x01, int64_t N, int L, GridLevels G,
             uint32_t mask, int32_t* __restrict__ idx, float* __restrict__ v0, float* __restrict__ v1) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= N * L) return;
  const int l = static_cast<int>(t / N);
  const int64_t n = t - static_cast<int64_t>(l) * N;
  int ix, iy, iz;
  float tx, ty, tz;
  grid_cell(G, l, x01, n, ix, iy, iz, tx, ty, tz);
  const float g0 = g[n * 2 * L + l], g1 = g[n * 2 * L + L + l];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int64_t k = (static_cast<int64_t>(l) * 8 + c) * N + n;
    const float w = corner_weight(c, tx, ty, tz);
    idx[k] = static_cast<int32_t>(grid_index(G, l, ix, iy, iz, c, mask));
    v0[k] = __fmul_rn(g0, w);
    v1[k] = __fmul_rn(g1, w);
  }
}

// hashgrid_bwd_kernel with g0, g1 read from g [N, 2L] in place
__global__ void __launch_bounds__(THREADS)
bwd_inplace_kernel(const float* __restrict__ g, const float* __restrict__ x01, int N, GridLevels G, uint32_t mask,
                   float2* __restrict__ scratch) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int l = blockIdx.y, L = gridDim.y;
  const bool live = n < N;
  float g0 = 0.0f, g1 = 0.0f;
  if (live) {
    g0 = g[static_cast<int64_t>(n) * 2 * L + l];
    g1 = g[static_cast<int64_t>(n) * 2 * L + L + l];
  }
  if (__ballot_sync(FULL_WARP, g0 != 0.0f || g1 != 0.0f) == 0) return;
  int ix = 0, iy = 0, iz = 0;
  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  if (live) grid_cell(G, l, x01, n, ix, iy, iz, tx, ty, tz);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int64_t i = -1;
    float v0 = 0.0f, v1 = 0.0f;
    if (live) {
      const float w = corner_weight(c, tx, ty, tz);
      i = grid_index(G, l, ix, iy, iz, c, mask);
      v0 = __fmul_rn(g0, w);
      v1 = __fmul_rn(g1, w);
    }
    if (merge_run(i, v0, v1) && i >= 0 && (v0 != 0.0f || v1 != 0.0f)) atomicAdd(scratch + i, make_float2(v0, v1));
  }
}

}  // namespace

extern "C" int arms_fwd(int arm, const float* planes, const void* pairs, int64_t total, const float* x01,
                        int64_t N, int L, const float* scales, const int64_t* offsets, const int32_t* res,
                        const int32_t* hashed, uint32_t mask, float* out, void* stream) {
  GridLevels G;
  if (!fill_grid_levels(G, L, scales, offsets, res, hashed) || arm < 0 || arm > 3 ||
      (reinterpret_cast<uintptr_t>(pairs) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* p = static_cast<const float2*>(pairs);
  const unsigned tiles = static_cast<unsigned>((N + FWD_POINTS - 1) / FWD_POINTS);
  if (arm == 0) first_fwd_kernel<true><<<blocks(N * L), THREADS, 0, s>>>(planes, p, total, x01, N, L, G, mask, out);
  if (arm == 1) first_fwd_kernel<false><<<blocks(N * L), THREADS, 0, s>>>(planes, p, total, x01, N, L, G, mask, out);
  if (arm == 2) hashgrid_fwd_kernel<<<tiles, THREADS, 0, s>>>(p, x01, N, L, G, mask, out);
  if (arm == 3) pairs_fwd_kernel<<<tiles, THREADS, 0, s>>>(p, total, x01, N, L, G, mask, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int arms_stage(const float* g, const float* x01, int64_t N, int L, const float* scales,
                          const int64_t* offsets, const int32_t* res, const int32_t* hashed, uint32_t mask,
                          int32_t* idx, float* v0, float* v1, void* stream) {
  GridLevels G;
  if (!fill_grid_levels(G, L, scales, offsets, res, hashed)) return static_cast<int>(cudaErrorInvalidValue);
  stage_kernel<<<blocks(N * L), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(g, x01, N, L, G, mask, idx, v0, v1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int arms_bwd_inplace(const float* g, const float* x01, int64_t N, int L, const float* scales,
                                const int64_t* offsets, const int32_t* res, const int32_t* hashed, uint32_t mask,
                                int64_t total, float* grad, float* scratch, void* stream) {
  GridLevels G;
  if (!fill_grid_levels(G, L, scales, offsets, res, hashed) || N >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* sc = reinterpret_cast<float2*>(scratch);
  bwd_inplace_kernel<<<dim3(blocks(N), L), THREADS, 0, s>>>(g, x01, static_cast<int>(N), G, mask, sc);
  scratch_fold_kernel<<<stride_blocks(total), THREADS, 0, s>>>(sc, total, total, 0, grad);
  return static_cast<int>(cudaGetLastError());
}
