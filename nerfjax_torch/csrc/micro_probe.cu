// The lowering probes of benchmarks/micro_probe.py, for sm_90a.
//
// Replaces the six Pallas TPU kernels that micro_probe.py's probe() runs
// (benchmarks/micro_probe.py:19, pallas_call :21):
//   reshape_mask_kernel   <- k_reshape       :36  out[0, i] = f32(x.flat[i] & 127)
//   transpose_kernel      <- k_transpose     :49  out = f32(x^T)
//   dot_dim0_kernel<f32>  <- k_dot_dim0      :61  out = a^T . b (contracting dim 0)
//   dot_dim0_kernel<bf16> <- k_dot_dim0_bf16 :76  the same on bf16(a), bf16(b), f32 sums
//   onehot_row_kernel     <- k_onehot_row    :93  out[r, c] = (r == x[0, c] >> 7)
//   col_slice_kernel      <- k_col_slice     :108 out[r, l] = (l == x[0, r] >> 7)
//
// On the TPU these probed which Mosaic lowerings work for the one-hot
// gradient kernel (reshape across tiles, transpose, a dot contracting the
// sublane dimension). On the card each is a plain kernel that writes every
// output element once and computes it exactly, so it equals its PyTorch
// version; the dot sums in its own order, with one __fmaf_rn per term in
// ascending k.
//
// What bounds them on an H100: the inputs are 4 KB to 256 KB and the outputs
// at most 256 KB, so each call is launch latency (a few microseconds); the
// bytes over HBM take well under a microsecond and the dot's 16.8 MFLOP
// under a microsecond on the FP32 pipes. The design is the simplest one that
// is right: one thread per output element, and for the dot a 16 x 16 output
// tile per block whose k-slices of a and b are staged in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 16;

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

template <bool BF16>
__device__ __forceinline__ float load_in(const float* p) {
  const float v = *p;
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// a [K, M], b [K, N] row-major -> out [M, N] = a^T . b. Thread (tx, ty) of
// block (bx, by) sums out[by*16 + ty, bx*16 + tx] over k in ascending order;
// each k-slice of 16 rows of a's and b's columns is staged in shared memory
// (coalesced loads along M and N). A product of two bf16 values is exact in
// f32, so the bf16 variant differs from a plain f32 product of the rounded
// inputs only in the order of the sum.
template <bool BF16>
__global__ void dot_dim0_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
                                int K, int M, int N) {
  __shared__ float As[TILE][TILE + 1];  // As[k][i]
  __shared__ float Bs[TILE][TILE + 1];  // Bs[k][j]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.y * TILE + ty, j = blockIdx.x * TILE + tx;
  const int ia = blockIdx.y * TILE + tx;  // the column of a this thread stages
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += TILE) {
    const int k = k0 + ty;
    As[ty][tx] = (k < K && ia < M) ? load_in<BF16>(a + (int64_t)k * M + ia) : 0.0f;
    Bs[ty][tx] = (k < K && j < N) ? load_in<BF16>(b + (int64_t)k * N + j) : 0.0f;
    __syncthreads();
    const int kn = min(TILE, K - k0);
    for (int kk = 0; kk < kn; ++kk) acc = __fmaf_rn(As[kk][ty], Bs[kk][tx], acc);
    __syncthreads();
  }
  if (i < M && j < N) out[(int64_t)i * N + j] = acc;
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

extern "C" int nerf_probe_dot_dim0(const void* a, const void* b, void* out, int K, int M, int N, int is_bf16,
                                   void* stream) {
  const dim3 block(TILE, TILE), grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  if (is_bf16)
    dot_dim0_kernel<true><<<grid, block, 0, s>>>(pa, pb, po, K, M, N);
  else
    dot_dim0_kernel<false><<<grid, block, 0, s>>>(pa, pb, po, K, M, N);
  return static_cast<int>(cudaGetLastError());
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
