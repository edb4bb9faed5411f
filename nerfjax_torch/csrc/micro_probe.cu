// The lowering probes of benchmarks/micro_probe.py, for sm_90a.
//
// Replaces the six Pallas TPU kernels that micro_probe.py's probe() runs
// (benchmarks/micro_probe.py:19, pallas_call :21):
//   reshape_mask_kernel   <- k_reshape       :36  out[0, i] = f32(x.flat[i] & 127)
//   transpose_kernel      <- k_transpose     :49  out = f32(x^T)
//   dot_dim0_kernel<f32>  <- k_dot_dim0      :61  out = a^T . b (contracting dim 0)
//   dot_dim0_kernel<bf16> <- k_dot_dim0_bf16 :76  the same on bf16(a), bf16(b), f32 sums
//     (dot_dim0_kernel is one template over <BF16>)
//   onehot_row_kernel     <- k_onehot_row    :93  out[r, c] = (r == x[0, c] >> 7)
//   col_slice_kernel      <- k_col_slice     :108 out[r, l] = (l == x[0, r] >> 7)
//
// On the TPU these probed which Mosaic lowerings work for the one-hot
// gradient kernel (reshape across tiles, transpose, a dot contracting the
// sublane dimension). On the card each elementwise probe is a plain kernel
// that writes every output element once and computes it exactly, so it
// equals its PyTorch version: one thread per output element.
//
// What bounds them on an H100: the inputs are 4 KB to 256 KB and the outputs
// at most 256 KB, so each call is its launch plus global-memory round trips
// (a few microseconds); the bytes over HBM take well under a microsecond,
// and so do the dot's 16.8 MFLOP on the FP32 pipes or the tensor cores.
//
// The dot (a [K, M], b [K, N] -> a^T . b) is therefore built to wait on
// global memory once. Each block owns a BM x BN output tile and stages the
// whole K strip of a (K x BM) and of b (K x BN) into shared memory with
// 16-byte cp.async copies issued all at once, then waits once (K beyond
// one stage of KC rows: a loop over K chunks with two stage buffers, the
// next chunk in flight while one is summed). The first design walked
// K in slices of 16 with a global load and two barriers per slice: K/16
// load latencies in series, ~5.3 us per call. Tile: BM = 32, BN = 16, 128
// blocks of 128 threads at the probe's M = 512, N = 128, so nearly every
// SM has a block and each thread sums only 2 x 2 outputs. Chosen by
// measurement against a wider tile (BM = 64, BN = 32: 32 blocks, 4 x 4 per
// thread): on an H100 80GB HBM3 (700 W) the 32 x 16 tile took 2.9 us (f32)
// and 2.5 us (bf16) of device time per call, the 64 x 32 one 5.4 and 3.5.
//   f32: each thread sums its 2 x 2 register tile on the FP32 pipes
//     with one __fmaf_rn per term in ascending k (no TF32: an f32 product).
//   bf16: the staged f32 chunk is rounded to bf16 tiles in shared memory
//     (as the plain version rounds its inputs), and each warp computes
//     16 x 8 output tiles with mma.sync.m16n8k16 bf16 -> f32, fragments
//     loaded with ldmatrix.trans (both operands lie k-major in shared
//     memory). The products are exact; the tensor cores' f32 sums round
//     otherwise than sequential IEEE adds, within K * 2^-24 * sum|a||b| of
//     the plain version (chip_smoke.py prints the fraction of that bound).
//     mma.sync, not wgmma: the whole product is a few nanoseconds of
//     tensor-core time, and wgmma's 64-row warpgroup tiles and descriptors
//     would buy nothing for a call that costs its launch and one round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void reshape_mask_kernel(const int32_t* __restrict__ x, float* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n; i += (int64_t)gridDim.x * blockDim.x)
    out[i] = static_cast<float>(x[i] & 127);
}

// x [R, C] -> out [C, R]; consecutive threads write consecutive outputs.
__global__ void transpose_kernel(const int32_t* __restrict__ x, float* __restrict__ out, int R, int C) {
  const int64_t n = (int64_t)R * C;
  for (int64_t o = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; o < n; o += (int64_t)gridDim.x * blockDim.x) {
    const int64_t c = o / R, r = o % R;
    out[o] = static_cast<float>(x[r * C + c]);
  }
}

// -- the dot --------------------------------------------------------------------

constexpr int KC = 128;           // K rows of a and b per stage
constexpr int DOT_THREADS = 128;  // 4 warps
constexpr int BM = 32, BN = 16;   // the output tile of a block
constexpr int TM = 2, TN = 2;     // the f32 register tile of a thread

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes from global to shared memory, asynchronously; with
// src_bytes = 0 the destination is filled with zeros (the ragged edge).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING)); }

// Rows [k0, k0 + rows) of src's columns [c0, c0 + W) (row length ld) into
// dst [rows][W] f32, zeros outside [0, K) x [0, ld). vec: ld % 4 == 0 and
// src 16-byte aligned, so every 16-byte piece is wholly in or out.
template <int W>
__device__ __forceinline__ void stage(float* dst, const float* src, int ld, int K, int k0, int rows, int c0,
                                      bool vec) {
  if (vec) {
    constexpr int P = W / 4;
    for (int p = threadIdx.x; p < rows * P; p += DOT_THREADS) {
      const int k = k0 + p / P, c = c0 + (p % P) * 4;
      const bool in = k < K && c < ld;
      cp_async16(dst + 4 * p, in ? src + (int64_t)k * ld + c : src, in ? 16 : 0);
    }
  } else {
    for (int p = threadIdx.x; p < rows * W; p += DOT_THREADS) {
      const int k = k0 + p / W, c = c0 + p % W;
      const bool in = k < K && c < ld;
      cp_async4(dst + p, in ? src + (int64_t)k * ld + c : src, in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v = p[0 : 2] from shared memory in one 8-byte load (p is 8-byte aligned)
__device__ __forceinline__ void lds2(float (&v)[2], const float* p) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x, v[1] = q.y;
}

// dst [rows][W + 8] bf16 = src [rows][W] f32 rounded to nearest even, four
// values a thread at a time (W % 4 == 0: each group of four stays in a row,
// 8-byte aligned in dst)
template <int W>
__device__ __forceinline__ void round_tile(__nv_bfloat16* dst, const float* src, int rows) {
  for (int p = threadIdx.x; p < rows * W / 4; p += DOT_THREADS) {
    const float4 v = reinterpret_cast<const float4*>(src)[p];
    const int row = 4 * p / W, col = 4 * p % W;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 w;
    memcpy(&w.x, &lo, 4);
    memcpy(&w.y, &hi, 4);
    *reinterpret_cast<uint2*>(dst + row * (W + 8) + col) = w;
  }
}

template <bool BF16>
constexpr size_t dot_smem_bytes(int stages) {
  return stages * KC * (BM + BN) * sizeof(float) + (BF16 ? KC * (BM + BN + 16) * sizeof(__nv_bfloat16) : 0);
}

// a [K, M], b [K, N] row-major -> out [M, N] = a^T . b; block (bx, by) owns
// out[by*BM : +BM, bx*BN : +BN]. Shared memory: the f32 stages sa
// [stages][KC][BM] and sb [stages][KC][BN]; under BF16 also the rounded
// tiles ta [KC][BM + 8] and tb [KC][BN + 8] (8 columns of padding put the 8
// rows an ldmatrix reads in 8 distinct 16-byte bank groups).
//   f32: thread (tx, ty) sums out rows ty*TM.., columns tx*TN.. of the
//     tile, one __fmaf_rn per term in ascending k.
//   bf16: warp w computes the tile's 16 x 8 pieces w, w + 4, ...; A (16 x 16,
//     A[m][k] = a[k][m]) and B (16 x 8, B[k][n] = b[k][n]) both lie k-major
//     in shared memory, so both are loaded with ldmatrix.trans.
template <bool BF16>
__global__ void __launch_bounds__(DOT_THREADS)
dot_dim0_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out, int K, int M,
                int N) {
  static_assert(TM == 2 && TN == 2 && (BM / TM) * (BN / TN) == DOT_THREADS, "one thread per 2 x 2 register tile");
  static_assert(BM % 16 == 0 && BN % 8 == 0 && (BM / 16) * (BN / 8) % 4 == 0, "whole mma tiles for 4 warps");
  constexpr int TILES = (BM / 16) * (BN / 8) / 4;  // mma tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int stages = K > KC ? 2 : 1;
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = sa + stages * KC * BM;
  __nv_bfloat16* ta = reinterpret_cast<__nv_bfloat16*>(sb + stages * KC * BN);
  __nv_bfloat16* tb = ta + KC * (BM + 8);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool va = M % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vb = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int chunks = (K + KC - 1) / KC;
  // the rows chunk c stages: its K rows rounded up to whole mma k-steps
  auto rows = [&](int c) { return min(KC, (K - c * KC + 15) / 16 * 16); };
  auto issue = [&](int c) {
    stage<BM>(sa + (c & 1) * KC * BM, a, M, K, c * KC, rows(c), m0, va);
    stage<BN>(sb + (c & 1) * KC * BN, b, N, K, c * KC, rows(c), n0, vb);
    cp_async_commit();
  };

  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[TM][TN] = {};
  float cf[TILES][4] = {};
  if (chunks > 0) issue(0);
  if (chunks > 1) issue(1);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const float* A = sa + (c & 1) * KC * BM;
    const float* B = sb + (c & 1) * KC * BN;
    if (!BF16) {
      const int kn = min(KC, K - c * KC);
#pragma unroll 8
      for (int k = 0; k < kn; ++k) {  // unrolled: the shared-memory loads of later k run ahead
        float av[TM], bv[TN];
        lds2(av, A + k * BM + ty * TM);
        lds2(bv, B + k * BN + tx * TN);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    } else {
      const int kr = rows(c);
      round_tile<BM>(ta, A, kr);
      round_tile<BN>(tb, B, kr);
      __syncthreads();
      const int q = lane / 8, r = lane % 8;  // ldmatrix: this lane addresses row r of matrix q
#pragma unroll 4
      for (int k = 0; k < kr; k += 16) {
#pragma unroll
        for (int s = 0; s < TILES; ++s) {
          const int tile = warp + 4 * s, mi = tile / (BN / 8), ni = tile % (BN / 8);
          uint32_t af[4], bf[2];
          // A's matrices: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
          ldmatrix_x4_trans(af, ta + (k + (q / 2) * 8 + r) * (BM + 8) + mi * 16 + (q % 2) * 8);
          // B's: (k 0-7), (k 8-15); lanes 16-31 repeat lanes 0-15's addresses
          ldmatrix_x2_trans(bf, tb + (k + (q % 2) * 8 + r) * (BN + 8) + ni * 8);
          mma_bf16(cf[s], af, bf);
        }
      }
    }
    __syncthreads();
    if (c + 2 < chunks) issue(c + 2);
  }

  if (!BF16) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx * TN + j;
        if (row < M && col < N) out[(int64_t)row * N + col] = acc[i][j];
      }
    }
  } else {
    const int g = lane / 4, t = lane % 4;  // the accumulator fragment's row and column pair
#pragma unroll
    for (int s = 0; s < TILES; ++s) {
      const int tile = warp + 4 * s, mi = tile / (BN / 8), ni = tile % (BN / 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mi * 16 + g + (e / 2) * 8, col = n0 + ni * 8 + 2 * t + e % 2;
        if (row < M && col < N) out[(int64_t)row * N + col] = cf[s][e];
      }
    }
  }
}

// One launch. Each raises the kernel's dynamic shared-memory limit (48 KB by
// default) to its two-stage size on the current device: the attribute is
// per device and per context, and setting it costs nothing beside a launch.
template <bool BF16>
cudaError_t launch_dot(const float* a, const float* b, float* out, int K, int M, int N, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(dot_dim0_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(dot_smem_bytes<BF16>(2)));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dot_dim0_kernel<BF16><<<grid, DOT_THREADS, dot_smem_bytes<BF16>(K > KC ? 2 : 1), s>>>(a, b, out, K, M, N);
  return cudaGetLastError();
}

// x [R, C] (row 0 read) -> out [rows, C].
__global__ void onehot_row_kernel(const int32_t* __restrict__ x, float* __restrict__ out, int rows, int C) {
  const int64_t n = (int64_t)rows * C;
  for (int64_t o = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; o < n; o += (int64_t)gridDim.x * blockDim.x) {
    const int r = static_cast<int>(o / C), c = static_cast<int>(o % C);
    out[o] = (r == (x[c] >> 7)) ? 1.0f : 0.0f;
  }
}

// x [R, C] (row 0 read) -> out [C, lanes]: the transpose of the row one-hot.
__global__ void col_slice_kernel(const int32_t* __restrict__ x, float* __restrict__ out, int C, int lanes) {
  const int64_t n = (int64_t)C * lanes;
  for (int64_t o = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; o < n; o += (int64_t)gridDim.x * blockDim.x) {
    const int r = static_cast<int>(o / lanes), l = static_cast<int>(o % lanes);
    out[o] = (l == (x[r] >> 7)) ? 1.0f : 0.0f;
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + THREADS - 1) / THREADS;
  return static_cast<int>(b < 65535 ? (b > 0 ? b : 1) : 65535);
}

}  // namespace

// C interface for ctypes: device pointers, sizes, the stream. Each entry
// returns cudaGetLastError() after its launch (0 = launched).

extern "C" int nerf_probe_reshape(const void* x, void* out, int64_t n, void* stream) {
  reshape_mask_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nerf_probe_transpose(const void* x, void* out, int R, int C, void* stream) {
  transpose_kernel<<<blocks_for((int64_t)R * C), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<float*>(out), R, C);
  return static_cast<int>(cudaGetLastError());
}

// M, N >= 1.
extern "C" int nerf_probe_dot_dim0(const void* a, const void* b, void* out, int K, int M, int N, int is_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  const cudaError_t e = is_bf16 ? launch_dot<true>(pa, pb, po, K, M, N, s) : launch_dot<false>(pa, pb, po, K, M, N, s);
  return static_cast<int>(e);
}

extern "C" int nerf_probe_onehot_row(const void* x, void* out, int rows, int C, void* stream) {
  onehot_row_kernel<<<blocks_for((int64_t)rows * C), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<float*>(out), rows, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nerf_probe_col_slice(const void* x, void* out, int C, int lanes, void* stream) {
  col_slice_kernel<<<blocks_for((int64_t)C * lanes), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<float*>(out), C, lanes);
  return static_cast<int>(cudaGetLastError());
}
