// Fused Instant-NGP MLP head and its density-only twin, for sm_90a.
//
// Replaces the two Pallas TPU kernels of nerfjax/ops/pallas_mlp.py:
//   ngp_head_kernel    <- _head_kernel    (via fused_ngp_head)
//   ngp_density_kernel <- _density_kernel (via fused_ngp_density)
//
// What it computes, per point n (feature-major: enc [E, N], sh [16, N]):
//   h    = relu(W1 . enc)        [64]   enc in its dtype, W1 rounded to it
//   feat = relu(W2 . h)          [16]   f32 activations x weights rounded
//   h2   = relu(W3 . [feat; sh]) [64]   to enc's dtype (jnp promotion: an
//   h3   = relu(W4 . h2)         [64]   f32 product), f32 accumulation
//   rgb  = sigmoid(W5 . h3)      [3]
//   sigma = feat[0]
// and writes rgb and sigma rounded once to enc's dtype (round to nearest
// even). The density kernel computes only sigma. E is any width from 1 to
// EMAX = 128, the widest encoding the port's hash grid produces (32 dense
// and 32 hashed levels of 2 features), as nerfjax's full-height block takes
// any E.
//
// What bounds it on an H100: 8,896 multiply-adds per point (E = 24) against
// 80 bytes of input and 8 of output in bf16 - about 200 FLOP per byte. That
// is ten times the ~20 FLOP/byte at which the FP32 pipes (67 TFLOP/s) would
// wait on HBM (3.35 TB/s), so this version's roof is FP32 FMA issue, not
// memory; on the tensor cores (~295 FLOP/byte for bf16) it would be close
// to balanced. Below that roof it is held by latency: the head kernel needs
// ~228 registers per thread, so only two 128-thread blocks fit on an SM,
// too few warps to hide the dependent FMA chains (PERF.md has the numbers).
// Its design: one thread per point, every weight staged per block in
// dynamic shared memory (37.6 KB as f32 at E <= 32, 62.2 KB at E = 128)
// and read as a broadcast, 16 bytes at a time (all threads of a warp read
// the same address: no bank conflicts), and activations in registers. The
// first layer walks the encoding in chunks of 32 rows: each chunk's 32
// values are loaded into registers and added into the 64 sums h, which
// stay in registers across chunks, so the register count does not grow
// with E. The five products go to tensor-core tiles in a later version.
//
// Bit-identical sigma: nerfjax's extraction marks cells with the density
// kernel and refines them with the head kernel under one threshold, so the
// two sigmas must agree bit for bit. Both kernels call density_features(),
// whose accumulation order is fixed: ascending fan-in (chunk by chunk, the
// chunks in ascending order), one __fmaf_rn per term (no contraction left
// to the compiler). At E <= 32 there is one chunk, and the sums are the
// ones the single-chunk layout computed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EMAX = 128;  // widest encoding (64 levels x 2 features)
constexpr int CHUNK = 32;  // rows of the encoding per step of the first layer
constexpr int HID = 64;
constexpr int GEO = 16;
constexpr int SHD = 16;
constexpr int CIN = GEO + SHD;
constexpr int NOUT = 3;

// Packed f32 weight buffer, written by the wrapper, for an encoding of E
// rows in C = ceil(E / 32) chunks:
//   W1 as C chunks of [HID][CHUNK] (chunk c holds fan-in columns 32c..32c+31
//      of every row, row-major; the columns past E are zero), then
//   W2 [GEO][HID], W3 [HID][CIN], W4 [HID][HID], W5 [NOUT][HID], row-major
//      [out][in].
// At E <= 32 this is W1 [HID][32] followed by the rest.
constexpr int W1_CHUNK = HID * CHUNK;
constexpr int OFF_W3 = GEO * HID;                 // offsets after W1
constexpr int OFF_W4 = OFF_W3 + HID * CIN;
constexpr int OFF_W5 = OFF_W4 + HID * HID;
constexpr int W_REST = OFF_W5 + NOUT * HID;       // 7,360 floats
static_assert(W1_CHUNK % 4 == 0 && OFF_W3 % 4 == 0 && W_REST % 4 == 0, "16-byte staging");

__host__ __device__ constexpr int chunks(int E) { return (E + CHUNK - 1) / CHUNK; }
__host__ __device__ constexpr int weights_size(int E) { return chunks(E) * W1_CHUNK + W_REST; }  // 9,408 floats at E <= 32

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// relu that lets NaN through, as jnp.maximum(x, 0) and torch.relu do
__device__ __forceinline__ float relu(float v) { return v != v ? v : fmaxf(v, 0.0f); }

// acc + sum_k w[k] * x[k] in ascending k, one __fmaf_rn per term. The
// weights are read four at a time (one 16-byte shared load feeds four
// FMAs); every row starts at a multiple of 4 floats in the packed buffer.
template <int IN>
__device__ __forceinline__ float dot_row(const float* w, const float (&x)[IN], float acc) {
  static_assert(IN % 4 == 0, "fan-in must be a multiple of 4");
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int k = 0; k < IN / 4; ++k) {
    const float4 v = w4[k];
    acc = __fmaf_rn(v.x, x[4 * k + 0], acc);
    acc = __fmaf_rn(v.y, x[4 * k + 1], acc);
    acc = __fmaf_rn(v.z, x[4 * k + 2], acc);
    acc = __fmaf_rn(v.w, x[4 * k + 3], acc);
  }
  return acc;
}

// rows k0..k0+31 of enc at point n (zero past E)
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ enc, int E, int64_t N, int64_t n, int k0,
                                           float (&x)[CHUNK]) {
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) x[k] = k0 + k < E ? to_f32(enc[(k0 + k) * N + n]) : 0.0f;
}

// The shared W1 -> W2 stage: the first ROWS rows of feat. Row r is computed
// the same way whatever ROWS is, so feat[0] is bit-identical in both
// kernels. The chunk loop is not unrolled: its weight addresses move with
// the chunk, so nothing is hoisted out of it.
template <typename T, int ROWS>
__device__ __forceinline__ void density_features(const T* __restrict__ enc, int E, int64_t N, int64_t n,
                                                 const float* sw, float (&feat)[ROWS]) {
  float h[HID];
#pragma unroll
  for (int o = 0; o < HID; ++o) h[o] = 0.0f;
  const int C = chunks(E);
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    float x[CHUNK];
    load_chunk(enc, E, N, n, c * CHUNK, x);
    const float* w1 = sw + c * W1_CHUNK;
#pragma unroll
    for (int o = 0; o < HID; ++o) h[o] = dot_row<CHUNK>(w1 + o * CHUNK, x, h[o]);
  }
#pragma unroll
  for (int o = 0; o < HID; ++o) h[o] = relu(h[o]);
  const float* w2 = sw + C * W1_CHUNK;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) feat[r] = relu(dot_row<HID>(w2 + r * HID, h, 0.0f));
}

// Copy the first `count` floats of the packed weights into shared memory.
// One point per thread and no loop over points: a loop would let the
// compiler hoist the (loop-invariant) weight loads into registers, which
// spills thousands of values.
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, float* sw, int count) {
  const float4* src = reinterpret_cast<const float4*>(w);
  float4* dst = reinterpret_cast<float4*>(sw);
  for (int i = threadIdx.x; i < count / 4; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ngp_head_kernel(const T* __restrict__ enc, const T* __restrict__ sh, const float* __restrict__ w,
                T* __restrict__ out, int E, int64_t N) {
  extern __shared__ float4 smem[];  // weights_size(E) floats
  float* sw = reinterpret_cast<float*>(smem);
  stage_weights(w, sw, weights_size(E));
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;  // the ragged edge: no padding
  float feat[GEO];
  density_features(enc, E, N, n, sw, feat);
  const float* rest = sw + chunks(E) * W1_CHUNK;

  float x2[CIN];
#pragma unroll
  for (int k = 0; k < GEO; ++k) x2[k] = feat[k];
#pragma unroll
  for (int k = 0; k < SHD; ++k) x2[GEO + k] = to_f32(sh[k * N + n]);
  float h2[HID];
#pragma unroll
  for (int o = 0; o < HID; ++o) h2[o] = relu(dot_row<CIN>(rest + OFF_W3 + o * CIN, x2, 0.0f));
  float h3[HID];
#pragma unroll
  for (int o = 0; o < HID; ++o) h3[o] = relu(dot_row<HID>(rest + OFF_W4 + o * HID, h2, 0.0f));
#pragma unroll
  for (int c = 0; c < NOUT; ++c) {
    const float z = dot_row<HID>(rest + OFF_W5 + c * HID, h3, 0.0f);
    put(out, c * N + n, 1.0f / (1.0f + expf(-z)));
  }
  put(out, NOUT * N + n, feat[0]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ngp_density_kernel(const T* __restrict__ enc, const float* __restrict__ w, T* __restrict__ out,
                   int E, int64_t N) {
  extern __shared__ float4 smem[];  // W1 and W2 only
  float* sw = reinterpret_cast<float*>(smem);
  stage_weights(w, sw, chunks(E) * W1_CHUNK + OFF_W3);
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float feat[1];
  density_features(enc, E, N, n, sw, feat);
  put(out, n, feat[0]);
}

// Launch with `bytes` of dynamic shared memory. Above 48 KB (E > 64 for
// the head) a kernel may take them only after its limit is raised; the
// limit is set before every launch, as it holds per device and context and
// costs nothing beside the launch.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int grid, size_t bytes, cudaStream_t s, Args... args) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, bytes, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Every pointer is a device pointer
// from tensor.data_ptr(); stream is PyTorch's current cudaStream_t. Each
// entry returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for E outside 1..EMAX.

extern "C" int nerf_fused_max_width() { return EMAX; }

// floats of the packed weight buffer for an encoding of E rows (-1 outside 1..EMAX)
extern "C" int nerf_fused_weights_size(int E) { return E < 1 || E > EMAX ? -1 : weights_size(E); }

extern "C" int nerf_fused_threads() { return THREADS; }

extern "C" int nerf_fused_head(const void* enc, const void* sh, const void* w, void* out, int E,
                               int64_t N, int is_bf16, int grid, void* stream) {
  if (E < 1 || E > EMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(float) * weights_size(E);
  if (is_bf16) {
    return static_cast<int>(launch(ngp_head_kernel<__nv_bfloat16>, grid, bytes, s,
                                   static_cast<const __nv_bfloat16*>(enc), static_cast<const __nv_bfloat16*>(sh),
                                   static_cast<const float*>(w), static_cast<__nv_bfloat16*>(out), E, N));
  }
  return static_cast<int>(launch(ngp_head_kernel<float>, grid, bytes, s, static_cast<const float*>(enc),
                                 static_cast<const float*>(sh), static_cast<const float*>(w),
                                 static_cast<float*>(out), E, N));
}

extern "C" int nerf_fused_density(const void* enc, const void* w, void* out, int E, int64_t N,
                                  int is_bf16, int grid, void* stream) {
  if (E < 1 || E > EMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(float) * (chunks(E) * W1_CHUNK + OFF_W3);
  if (is_bf16) {
    return static_cast<int>(launch(ngp_density_kernel<__nv_bfloat16>, grid, bytes, s,
                                   static_cast<const __nv_bfloat16*>(enc), static_cast<const float*>(w),
                                   static_cast<__nv_bfloat16*>(out), E, N));
  }
  return static_cast<int>(launch(ngp_density_kernel<float>, grid, bytes, s, static_cast<const float*>(enc),
                                 static_cast<const float*>(w), static_cast<float*>(out), E, N));
}
