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
// even). The density kernel computes only sigma.
//
// What bounds it on an H100: 8,896 multiply-adds per point (E = 24) against
// 80 bytes of input and 8 of output in bf16 - about 200 FLOP per byte. That
// is ten times the ~20 FLOP/byte at which the FP32 pipes (67 TFLOP/s) would
// wait on HBM (3.35 TB/s), so this version's roof is FP32 FMA issue, not
// memory; on the tensor cores (~295 FLOP/byte for bf16) it would be close
// to balanced. Below that roof it is held by latency: the head kernel needs
// ~228 registers per thread, so only two 128-thread blocks fit on an SM,
// too few warps to hide the dependent FMA chains (PERF.md has the numbers).
// Its design: one thread per point, every weight (37.6 KB as f32) staged
// per block in shared memory and read as a broadcast, 16 bytes at a time
// (all threads of a warp read the same address: no bank conflicts), and
// activations in registers. The five products go to wgmma tiles in a later
// version.
//
// Bit-identical sigma: nerfjax's extraction marks cells with the density
// kernel and refines them with the head kernel under one threshold, so the
// two sigmas must agree bit for bit. Both kernels call density_features(),
// whose accumulation order is fixed: ascending fan-in, one __fmaf_rn per
// term (no contraction left to the compiler).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EMAX = 32;  // widest encoding (16 levels x 2 features)
constexpr int HID = 64;
constexpr int GEO = 16;
constexpr int SHD = 16;
constexpr int CIN = GEO + SHD;
constexpr int NOUT = 3;

// Packed f32 weight buffer, row-major [out][in], written by the wrapper:
constexpr int OFF_W1 = 0;                    // [HID][EMAX], fan-in zero-padded
constexpr int OFF_W2 = OFF_W1 + HID * EMAX;  // [GEO][HID]
constexpr int OFF_W3 = OFF_W2 + GEO * HID;   // [HID][CIN]
constexpr int OFF_W4 = OFF_W3 + HID * CIN;   // [HID][HID]
constexpr int OFF_W5 = OFF_W4 + HID * HID;   // [NOUT][HID]
constexpr int W_TOTAL = OFF_W5 + NOUT * HID; // 9,408 floats = 37,632 bytes
static_assert(OFF_W3 % 4 == 0 && W_TOTAL % 4 == 0, "16-byte staging");

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// relu that lets NaN through, as jnp.maximum(x, 0) and torch.relu do
__device__ __forceinline__ float relu(float v) { return v != v ? v : fmaxf(v, 0.0f); }

// sum_k w[k] * x[k] in ascending k, one __fmaf_rn per term. The weights are
// read four at a time (one 16-byte shared load feeds four FMAs); every row
// starts at a multiple of 4 floats in the packed buffer.
template <int IN>
__device__ __forceinline__ float dot_row(const float* w, const float (&x)[IN]) {
  static_assert(IN % 4 == 0, "fan-in must be a multiple of 4");
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float acc = 0.0f;
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

// The shared W1 -> W2 stage: the first ROWS rows of feat. Row r is computed
// the same way whatever ROWS is, so feat[0] is bit-identical in both kernels.
template <int ROWS>
__device__ __forceinline__ void density_features(const float (&x)[EMAX], const float* sw,
                                                 float (&feat)[ROWS]) {
  float h[HID];
#pragma unroll
  for (int o = 0; o < HID; ++o) h[o] = relu(dot_row<EMAX>(sw + OFF_W1 + o * EMAX, x));
#pragma unroll
  for (int r = 0; r < ROWS; ++r) feat[r] = relu(dot_row<HID>(sw + OFF_W2 + r * HID, h));
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
__device__ __forceinline__ void load_enc(const T* __restrict__ enc, int E, int64_t N, int64_t n,
                                         float (&x)[EMAX]) {
#pragma unroll
  for (int k = 0; k < EMAX; ++k) x[k] = k < E ? to_f32(enc[k * N + n]) : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ngp_head_kernel(const T* __restrict__ enc, const T* __restrict__ sh, const float* __restrict__ w,
                T* __restrict__ out, int E, int64_t N) {
  __shared__ __align__(16) float sw[W_TOTAL];
  stage_weights(w, sw, W_TOTAL);
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;  // the ragged edge: no padding
  float x[EMAX];
  load_enc(enc, E, N, n, x);
  float feat[GEO];
  density_features<GEO>(x, sw, feat);

  float x2[CIN];
#pragma unroll
  for (int k = 0; k < GEO; ++k) x2[k] = feat[k];
#pragma unroll
  for (int k = 0; k < SHD; ++k) x2[GEO + k] = to_f32(sh[k * N + n]);
  float h2[HID];
#pragma unroll
  for (int o = 0; o < HID; ++o) h2[o] = relu(dot_row<CIN>(sw + OFF_W3 + o * CIN, x2));
  float h3[HID];
#pragma unroll
  for (int o = 0; o < HID; ++o) h3[o] = relu(dot_row<HID>(sw + OFF_W4 + o * HID, h2));
#pragma unroll
  for (int c = 0; c < NOUT; ++c) {
    const float z = dot_row<HID>(sw + OFF_W5 + c * HID, h3);
    put(out, c * N + n, 1.0f / (1.0f + expf(-z)));
  }
  put(out, NOUT * N + n, feat[0]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ngp_density_kernel(const T* __restrict__ enc, const float* __restrict__ w, T* __restrict__ out,
                   int E, int64_t N) {
  __shared__ __align__(16) float sw[OFF_W3];  // W1 and W2 only
  stage_weights(w, sw, OFF_W3);
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float x[EMAX];
  load_enc(enc, E, N, n, x);
  float feat[1];
  density_features<1>(x, sw, feat);
  put(out, n, feat[0]);
}

}  // namespace

// Plain C interface, loaded with ctypes. Every pointer is a device pointer
// from tensor.data_ptr(); stream is PyTorch's current cudaStream_t. Each
// entry returns cudaGetLastError() after its launch (0 = launched).

extern "C" int nerf_fused_weights_size() { return W_TOTAL; }

extern "C" int nerf_fused_threads() { return THREADS; }

extern "C" int nerf_fused_head(const void* enc, const void* sh, const void* w, void* out, int E,
                               int64_t N, int is_bf16, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    ngp_head_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(enc), static_cast<const __nv_bfloat16*>(sh),
        static_cast<const float*>(w), static_cast<__nv_bfloat16*>(out), E, N);
  } else {
    ngp_head_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(enc), static_cast<const float*>(sh),
        static_cast<const float*>(w), static_cast<float*>(out), E, N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nerf_fused_density(const void* enc, const void* w, void* out, int E, int64_t N,
                                  int is_bf16, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    ngp_density_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(enc), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(out), E, N);
  } else {
    ngp_density_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(enc), static_cast<const float*>(w),
        static_cast<float*>(out), E, N);
  }
  return static_cast<int>(cudaGetLastError());
}
