// Fused Instant-NGP MLP head and its density-only twin, for sm_90a.
//
// Replaces the two Pallas TPU kernels of nerfjax/ops/pallas_mlp.py:
//   ngp_head_mma_kernel    (bf16) and ngp_head_kernel    (f32) <- _head_kernel    (via fused_ngp_head)
//   ngp_density_mma_kernel (bf16) and ngp_density_kernel (f32) <- _density_kernel (via fused_ngp_density)
// The dtype of the encoding picks the kernel.
//
// What they compute, per point n (feature-major: enc [E, N], sh [16, N]):
//   h    = relu(W1 . enc)        [64]   enc in its dtype, W1 rounded to it
//   feat = relu(W2 . h)          [16]   f32 activations x weights rounded
//   h2   = relu(W3 . [feat; sh]) [64]   to enc's dtype (jnp promotion: an
//   h3   = relu(W4 . h2)         [64]   f32 product), f32 accumulation
//   rgb  = sigmoid(W5 . h3)      [3]
//   sigma = feat[0]
// and write rgb and sigma rounded once to enc's dtype (round to nearest
// even). The density kernels compute only sigma. E is any width from 1 to
// EMAX = 128, the widest encoding the port's hash grid produces (32 dense
// and 32 hashed levels of 2 features), as nerfjax's full-height block takes
// any E.
//
// What bounds them on an H100: at E = 24 the function is 8,896
// multiply-adds a point against 80 bytes of input and 8 of output in bf16,
// about 200 FLOP per byte: below the ~295 FLOP/byte at which the bf16
// tensor cores (989 TFLOP/s) would wait on HBM (3.35 TB/s), so the bound is
// bytes. On the FP32 pipes (67 TFLOP/s, ~20 FLOP/byte) it would be ten
// times above that line, which is why the bf16 kernels run on the tensor
// cores.
//
// The bf16 kernels: mma.sync.m16n8k16 (bf16 in, f32 accumulate), points as
// M. A block of 4 warps steps over the points 128 at a time (a grid of as
// many blocks as fit on the card, each walking its share); each warp owns
// MMA_TILES = 2 tiles of 16 points, so every weight fragment it loads
// serves both. Per step the block stages enc [E_pad, 128] and sh [16, 128]
// into shared memory with 16-byte cp.async copies (rows are contiguous
// along points: coalesced), and each warp reads them as A fragments with
// ldmatrix.trans. The weights are staged once per block, in B-fragment
// order (pack_weights): each lane reads its fragment with one 8-byte
// shared load, 256 contiguous bytes per warp. Activations never leave
// registers: after ReLU the f32 C fragments of two neighbouring n8 tiles
// hold exactly the A fragment of the next layer's k16 step.
//
// Numerics: layer 1 is bf16 x bf16, one mma per k16 step. Layers 2-5 take
// f32 activations, so each ReLU'd activation a is split by truncation into
// three bf16 terms, hi (a's upper 16 bits), mid (the same of a - hi) and
// lo = a - hi - mid, exact for finite |a| >= 2^-110 (split3; below that lo
// is subnormal and loses bits). w.hi, w.mid and w.lo are exact products,
// summed by the tensor core in f32 in a fixed order (lo, mid, hi) per k16
// step, so the kernels compute the plain version's function with another
// order of additions. sh enters layer 3 as one term: it is bf16. NaN splits
// as (NaN, 0, 0) (clearing a NaN's low half could leave inf), inf as (inf,
// 0, 0).
//
// Bit-identical sigma: nerfjax's extraction marks cells with the density
// kernel and refines them with the head kernel under one threshold, so the
// two sigmas must agree bit for bit. The bf16 kernels both call
// density_mma() (the same fragments, k-step order and term order; mma is
// deterministic), the f32 kernels density_features(), whose accumulation
// order is fixed: ascending fan-in (chunk by chunk), one __fmaf_rn per term.
//
// The f32 kernels keep one point per thread on FP32 FMAs: every weight
// staged per block in dynamic shared memory (37.6 KB at E <= 32, 62.2 KB at
// E = 128) and read as a broadcast, 16 bytes at a time, activations in
// registers. The first layer walks the encoding in chunks of 32 rows, the
// 64 sums staying in registers across chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EMAX = 128;  // widest encoding (64 levels x 2 features)
constexpr int HID = 64;
constexpr int GEO = 16;
constexpr int SHD = 16;
constexpr int CIN = GEO + SHD;
constexpr int NOUT = 3;
constexpr int THREADS = 128;

// ---------------------------------------------------------------------------
// f32: one point per thread on FP32 FMAs
// ---------------------------------------------------------------------------

constexpr int CHUNK = 32;  // rows of the encoding per step of the first layer

// Packed f32 weight buffer, written by the wrapper, for an encoding of E
// rows in C = ceil(E / 32) chunks:
//   W1 as C chunks of [HID][CHUNK] (chunk c holds fan-in columns 32c..32c+31
//      of every row, row-major; the columns past E are zero), then
//   W2 [GEO][HID], W3 [HID][CIN], W4 [HID][HID], W5 [NOUT][HID], row-major
//      [out][in].
constexpr int W1_CHUNK = HID * CHUNK;
constexpr int OFF_W3 = GEO * HID;                 // offsets after W1
constexpr int OFF_W4 = OFF_W3 + HID * CIN;
constexpr int OFF_W5 = OFF_W4 + HID * HID;
constexpr int W_REST = OFF_W5 + NOUT * HID;       // 7,360 floats
static_assert(W1_CHUNK % 4 == 0 && OFF_W3 % 4 == 0 && W_REST % 4 == 0, "16-byte staging");

__host__ __device__ constexpr int chunks(int E) { return (E + CHUNK - 1) / CHUNK; }
__host__ __device__ constexpr int weights_size(int E) { return chunks(E) * W1_CHUNK + W_REST; }  // 9,408 floats at E <= 32

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
__device__ __forceinline__ void load_chunk(const float* __restrict__ enc, int E, int64_t N, int64_t n, int k0,
                                           float (&x)[CHUNK]) {
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) x[k] = k0 + k < E ? enc[(k0 + k) * N + n] : 0.0f;
}

// The shared W1 -> W2 stage: the first ROWS rows of feat. Row r is computed
// the same way whatever ROWS is, so feat[0] is bit-identical in both
// kernels. The chunk loop is not unrolled: its weight addresses move with
// the chunk, so nothing is hoisted out of it.
template <int ROWS>
__device__ __forceinline__ void density_features(const float* __restrict__ enc, int E, int64_t N, int64_t n,
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

__global__ void __launch_bounds__(THREADS)
ngp_head_kernel(const float* __restrict__ enc, const float* __restrict__ sh, const float* __restrict__ w,
                float* __restrict__ out, int E, int64_t N) {
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
  for (int k = 0; k < SHD; ++k) x2[GEO + k] = sh[k * N + n];
  float h2[HID];
#pragma unroll
  for (int o = 0; o < HID; ++o) h2[o] = relu(dot_row<CIN>(rest + OFF_W3 + o * CIN, x2, 0.0f));
  float h3[HID];
#pragma unroll
  for (int o = 0; o < HID; ++o) h3[o] = relu(dot_row<HID>(rest + OFF_W4 + o * HID, h2, 0.0f));
#pragma unroll
  for (int c = 0; c < NOUT; ++c) {
    const float z = dot_row<HID>(rest + OFF_W5 + c * HID, h3, 0.0f);
    out[c * N + n] = 1.0f / (1.0f + expf(-z));
  }
  out[NOUT * N + n] = feat[0];
}

__global__ void __launch_bounds__(THREADS)
ngp_density_kernel(const float* __restrict__ enc, const float* __restrict__ w, float* __restrict__ out, int E,
                   int64_t N) {
  extern __shared__ float4 smem[];  // W1 and W2 only
  float* sw = reinterpret_cast<float*>(smem);
  stage_weights(w, sw, chunks(E) * W1_CHUNK + OFF_W3);
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float feat[1];
  density_features(enc, E, N, n, sw, feat);
  out[n] = feat[0];
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_TILES = 2;                           // m16 tiles of points per warp
constexpr int MMA_WARPS = THREADS / 32;
constexpr int MMA_POINTS = MMA_WARPS * MMA_TILES * 16;  // points per block step
constexpr int PITCH = MMA_POINTS + 8;                  // bf16 per staged row: 16 bytes of padding put
                                                       // the 8 rows an ldmatrix reads in 8 bank groups
constexpr int MMA_MIN_BLOCKS = 3;                      // per SM: at most 170 registers a thread

// Packed bf16 weight buffer, written by the wrapper: each layer's W [out]
// [in], zero-padded to in a multiple of 16 and out a multiple of 8, cut into
// the B fragments of m16n8k16 (k16 step s, n8 tile j), in the order
// s * (out / 8) + j; a fragment is 32 lanes x 4 bf16, lane 4g + t holding
// W[8j + g][16s + 2t + {0, 1, 8, 9}] (b0 = the first two, b1 = the last two).
//   W1 (in padded from E to E_pad = 16 ceil(E / 16), out 64), then
//   W2 (64 -> 16), W3 (32 -> 64: k-step 0 feat, 1 sh), W4 (64 -> 64),
//   W5 (64 -> 3, out padded to 8).
constexpr int FRAG = 32 * 4;                 // bf16 per fragment
constexpr int OFF_B3 = 4 * 2 * FRAG;         // offsets after W1, in bf16
constexpr int OFF_B4 = OFF_B3 + 2 * 8 * FRAG;
constexpr int OFF_B5 = OFF_B4 + 4 * 8 * FRAG;
constexpr int B_REST = OFF_B5 + 4 * 1 * FRAG;  // 7,680 bf16

__host__ __device__ constexpr int pad16(int E) { return (E + 15) / 16 * 16; }
__host__ __device__ constexpr int bf16_weights_size(int E) { return pad16(E) * HID + B_REST; }  // 9,728 at E <= 32

// dynamic shared memory of the bf16 kernels: weights, enc tile, sh tile
// (head only), output tile (4 rows, or sigma's 1)
__host__ __device__ constexpr size_t mma_smem_bytes(int E, bool head) {
  return 2 * (size_t)((head ? bf16_weights_size(E) : pad16(E) * HID + OFF_B3) + pad16(E) * PITCH +
                      (head ? SHD * PITCH + 4 * MMA_POINTS : MMA_POINTS));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with src_bytes =
// 0 the destination is filled with zeros (rows past E, points past N).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// a = hi + mid + lo, each a bf16 value held as the upper half of an f32's
// bits (the lower half zero); see the header. fused_mlp.split3_bf16 is the
// same arithmetic in plain torch.
__device__ __forceinline__ void split3(float a, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = a != a ? 0x7FC00000u : __float_as_uint(a) & 0xFFFF0000u;
  const float r = fabsf(a) <= 3.402823466e38f ? __fsub_rn(a, __uint_as_float(hi)) : 0.0f;
  mid = __float_as_uint(r) & 0xFFFF0000u;
  lo = __float_as_uint(__fsub_rn(r, __uint_as_float(mid))) & 0xFFFF0000u;
}

// The three A fragments (lo, mid, hi) of one k16 step from the ReLU'd C
// fragments of the n8 tiles 2s (x0) and 2s + 1 (x1): a0 = row g, k 2t..2t+1
// (x0[0..1]); a1 = row g + 8 (x0[2..3]); a2, a3 the same from x1.
__device__ __forceinline__ void split_pair(float u, float v, uint32_t (&a)[3][4], int i) {
  uint32_t hu, mu, lu, hv, mv, lv;
  split3(u, hu, mu, lu);
  split3(v, hv, mv, lv);
  a[0][i] = __byte_perm(lu, lv, 0x7632);  // the lower k in the lower half
  a[1][i] = __byte_perm(mu, mv, 0x7632);
  a[2][i] = __byte_perm(hu, hv, 0x7632);
}
__device__ __forceinline__ void split_fragment(const float (&x0)[4], const float (&x1)[4], uint32_t (&a)[3][4]) {
  split_pair(x0[0], x0[1], a, 0);
  split_pair(x0[2], x0[3], a, 1);
  split_pair(x1[0], x1[1], a, 2);
  split_pair(x1[2], x1[3], a, 3);
}

template <int NT>
__device__ __forceinline__ void relu_all(float (&x)[MMA_TILES][NT][4]) {
#pragma unroll
  for (int tt = 0; tt < MMA_TILES; ++tt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[tt][j][e] = relu(x[tt][j][e]);
}

// acc += a . W over one k16 step with bf16 A fragments (one term); wf: the
// step's NT fragments
template <int NT>
__device__ __forceinline__ void step_bf16(float (&acc)[MMA_TILES][NT][4], const uint32_t (&a)[MMA_TILES][4],
                                          const uint2* wf, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const uint2 b = wf[j * 32 + lane];
#pragma unroll
    for (int tt = 0; tt < MMA_TILES; ++tt) mma_bf16(acc[tt][j], a[tt], b);
  }
}

// acc += x . W over k16 step s of f32 activations x (C fragments of NT_IN
// n8 tiles), split into three terms and added lo, mid, hi. The term loop is
// outermost, so NT * MMA_TILES independent mma lie between two into one
// accumulator; the order of the sums is the same whatever the loop order.
template <int NT, int NT_IN>
__device__ __forceinline__ void step_split(float (&acc)[MMA_TILES][NT][4], const float (&x)[MMA_TILES][NT_IN][4],
                                           int s, const uint2* wf, int lane) {
  uint32_t a[MMA_TILES][3][4];
#pragma unroll
  for (int tt = 0; tt < MMA_TILES; ++tt) split_fragment(x[tt][2 * s], x[tt][2 * s + 1], a[tt]);
  uint2 b[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) b[j] = wf[j * 32 + lane];
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int tt = 0; tt < MMA_TILES; ++tt) mma_bf16(acc[tt][j], a[tt][term], b[j]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[MMA_TILES][NT][4]) {
#pragma unroll
  for (int tt = 0; tt < MMA_TILES; ++tt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[tt][j][e] = 0.0f;
}

// A fragments of rows k0..k0+15 of a staged tile [rows][PITCH] at this
// warp's points m0.. (tile tt at m0 + 16 tt). ldmatrix matrix q (lanes 8q..)
// is (k 0-7 | 8-15 by q / 2) x (m 0-7 | 8-15 by q % 2): a0..a3.
__device__ __forceinline__ void load_a(uint32_t (&a)[MMA_TILES][4], const __nv_bfloat16* tile, int k0, int m0,
                                       int lane) {
  const int q = lane / 8, r = lane % 8;
#pragma unroll
  for (int tt = 0; tt < MMA_TILES; ++tt)
    ldmatrix_x4_trans(a[tt], tile + (k0 + (q / 2) * 8 + r) * PITCH + m0 + 16 * tt + (q % 2) * 8);
}

// The shared W1 -> W2 stage of both bf16 kernels: feat = relu(W2 .
// relu(W1 . enc)) for this warp's points, as C fragments (two n8 tiles).
__device__ __forceinline__ void density_mma(const __nv_bfloat16* senc, int E, const uint2* sw, int m0, int lane,
                                            float (&feat)[MMA_TILES][2][4]) {
  float h[MMA_TILES][8][4];
  zero(h);
#pragma unroll 1
  for (int s = 0; s < pad16(E) / 16; ++s) {
    uint32_t a[MMA_TILES][4];
    load_a(a, senc, 16 * s, m0, lane);
    step_bf16(h, a, sw + s * 8 * 32, lane);
  }
  relu_all(h);
  const uint2* w2 = sw + pad16(E) * HID / 4;
  zero(feat);
#pragma unroll
  for (int s = 0; s < 4; ++s) step_split(feat, h, s, w2 + s * 2 * 32, lane);
  relu_all(feat);
}

// sigma = feat column 0 (held by the lanes t = 0: rows g and g + 8 of each
// tile), rounded to bf16, into the output tile's row at this warp's points
__device__ __forceinline__ void put_sigma(__nv_bfloat16* row, const float (&feat)[MMA_TILES][2][4], int m0, int g) {
#pragma unroll
  for (int tt = 0; tt < MMA_TILES; ++tt) {
    row[m0 + 16 * tt + g] = __float2bfloat16_rn(feat[tt][0][0]);
    row[m0 + 16 * tt + g + 8] = __float2bfloat16_rn(feat[tt][0][2]);
  }
}

// Rows [0, rows) of src [*, N] at points n0.. into dst [rows][PITCH],
// zeros at rows >= valid and points >= N: 16-byte cp.async copies where
// every piece is wholly in or out (vec), else element by element.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int rows,
                                           int valid, int64_t N, int64_t n0, bool vec) {
  if (vec) {
    constexpr int PIECES = MMA_POINTS / 8;
    for (int i = threadIdx.x; i < rows * PIECES; i += THREADS) {
      const int k = i / PIECES, p = (i % PIECES) * 8;
      const bool in = k < valid && n0 + p < N;
      cp_async16(dst + k * PITCH + p, in ? src + k * N + n0 + p : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * MMA_POINTS; i += THREADS) {
      const int k = i / MMA_POINTS, p = i % MMA_POINTS;
      dst[k * PITCH + p] = k < valid && n0 + p < N ? src[k * N + n0 + p] : __float2bfloat16_rn(0.0f);
    }
  }
}

// The weights, once per block, 16 bytes a copy (count: bf16, a multiple of 8)
__device__ __forceinline__ void stage_weights_bf16(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                                   int count) {
  for (int i = threadIdx.x; i < count / 8; i += THREADS) cp_async16(dst + 8 * i, src + 8 * i, 16);
}

// out [rows, N] at points n0.. from the staged output tile [rows][MMA_POINTS]
__device__ __forceinline__ void store_tile(__nv_bfloat16* __restrict__ out, const __nv_bfloat16* sout, int rows,
                                           int64_t N, int64_t n0) {
  for (int i = threadIdx.x; i < rows * MMA_POINTS; i += THREADS) {
    const int r = i / MMA_POINTS, p = i % MMA_POINTS;
    if (n0 + p < N) out[r * N + n0 + p] = sout[i];
  }
}

__global__ void __launch_bounds__(THREADS, MMA_MIN_BLOCKS)
ngp_head_mma_kernel(const __nv_bfloat16* __restrict__ enc, const __nv_bfloat16* __restrict__ sh,
                    const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out, int E, int64_t N) {
  extern __shared__ __align__(16) unsigned char smem_bf16[];  // mma_smem_bytes(E, ...)
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* senc = sw + bf16_weights_size(E);
  __nv_bfloat16* ssh = senc + pad16(E) * PITCH;
  __nv_bfloat16* sout = ssh + SHD * PITCH;
  const uint2* wf = reinterpret_cast<const uint2*>(sw);
  const uint2* w3 = wf + (pad16(E) * HID + OFF_B3) / 4;
  const uint2* w4 = wf + (pad16(E) * HID + OFF_B4) / 4;
  const uint2* w5 = wf + (pad16(E) * HID + OFF_B5) / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m0 = warp * MMA_TILES * 16;
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(enc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sh) % 16 == 0;
  stage_weights_bf16(sw, w, bf16_weights_size(E));

  const int64_t steps = (N + MMA_POINTS - 1) / MMA_POINTS;
  for (int64_t c = blockIdx.x; c < steps; c += gridDim.x) {
    const int64_t n0 = c * MMA_POINTS;
    stage_tile(senc, enc, pad16(E), E, N, n0, vec);
    stage_tile(ssh, sh, SHD, SHD, N, n0, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float feat[MMA_TILES][2][4];
    density_mma(senc, E, wf, m0, lane, feat);
    if (t == 0) put_sigma(sout + NOUT * MMA_POINTS, feat, m0, g);
    float h2[MMA_TILES][8][4];
    zero(h2);
    step_split(h2, feat, 0, w3, lane);  // k-step 0: feat, three terms
    uint32_t a[MMA_TILES][4];
    load_a(a, ssh, 0, m0, lane);
    step_bf16(h2, a, w3 + 8 * 32, lane);  // k-step 1: sh, one term
    relu_all(h2);
    float h3[MMA_TILES][8][4];
    zero(h3);
#pragma unroll
    for (int s = 0; s < 4; ++s) step_split(h3, h2, s, w4 + s * 8 * 32, lane);
    relu_all(h3);
    float z[MMA_TILES][1][4];
    zero(z);
#pragma unroll
    for (int s = 0; s < 4; ++s) step_split(z, h3, s, w5 + s * 32, lane);

    // C fragment element e: row g + 8 (e / 2), column 2t + e % 2
#pragma unroll
    for (int tt = 0; tt < MMA_TILES; ++tt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * t + e % 2;
        if (col < NOUT)
          sout[col * MMA_POINTS + m0 + 16 * tt + g + 8 * (e / 2)] =
              __float2bfloat16_rn(1.0f / (1.0f + expf(-z[tt][0][e])));
      }
    }
    __syncthreads();
    store_tile(out, sout, NOUT + 1, N, n0);
  }
}

__global__ void __launch_bounds__(THREADS, MMA_MIN_BLOCKS)
ngp_density_mma_kernel(const __nv_bfloat16* __restrict__ enc, const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ out, int E, int64_t N) {
  extern __shared__ __align__(16) unsigned char smem_bf16[];  // mma_smem_bytes(E, ...)
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* senc = sw + pad16(E) * HID + OFF_B3;  // W1 and W2 only
  __nv_bfloat16* sout = senc + pad16(E) * PITCH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m0 = warp * MMA_TILES * 16;
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(enc) % 16 == 0;
  stage_weights_bf16(sw, w, pad16(E) * HID + OFF_B3);

  const int64_t steps = (N + MMA_POINTS - 1) / MMA_POINTS;
  for (int64_t c = blockIdx.x; c < steps; c += gridDim.x) {
    const int64_t n0 = c * MMA_POINTS;
    stage_tile(senc, enc, pad16(E), E, N, n0, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float feat[MMA_TILES][2][4];
    density_mma(senc, E, reinterpret_cast<const uint2*>(sw), m0, lane, feat);
    if (t == 0) put_sigma(sout, feat, m0, g);
    __syncthreads();
    store_tile(out, sout, 1, N, n0);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Launch with `bytes` of dynamic shared memory. Above 48 KB a kernel may
// take them only after its limit is raised; the limit is set before every
// launch, as it holds per device and context and costs nothing beside the
// launch.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int grid, size_t bytes, cudaStream_t s, Args... args) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, bytes, s>>>(args...);
  return cudaGetLastError();
}

// The bf16 kernels' grid: as many blocks as fit on the card at once (each
// walks every gridDim-th step of MMA_POINTS points), fewer for a short N.
template <typename Kernel, typename... Args>
cudaError_t launch_mma(Kernel kernel, int64_t N, size_t bytes, cudaStream_t s, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
  if (e != cudaSuccess) return e;
  const int64_t steps = (N + MMA_POINTS - 1) / MMA_POINTS;
  const int grid = static_cast<int>(steps < (int64_t)sms * per_sm ? steps : (int64_t)sms * per_sm);
  kernel<<<grid > 0 ? grid : 1, THREADS, bytes, s>>>(args...);
  return cudaGetLastError();
}

int f32_grid(int64_t N) { return static_cast<int>((N + THREADS - 1) / THREADS); }  // one point per thread

}  // namespace

// Plain C interface, loaded with ctypes. Every pointer is a device pointer
// from tensor.data_ptr(); stream is PyTorch's current cudaStream_t. Each
// entry returns cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for E outside 1..EMAX.

extern "C" int nerf_fused_max_width() { return EMAX; }

// elements of the packed weight buffer for an encoding of E rows: floats
// (f32) or bf16 (is_bf16); -1 outside 1..EMAX
extern "C" int nerf_fused_weights_size(int E, int is_bf16) {
  return E < 1 || E > EMAX ? -1 : is_bf16 ? bf16_weights_size(E) : weights_size(E);
}

// dynamic shared memory of a block of the head (density = 0) or density
// kernel, in bytes; -1 outside 1..EMAX
extern "C" int nerf_fused_smem_bytes(int E, int is_bf16, int density) {
  if (E < 1 || E > EMAX) return -1;
  if (is_bf16) return static_cast<int>(mma_smem_bytes(E, !density));
  return static_cast<int>(sizeof(float) * (density ? chunks(E) * W1_CHUNK + OFF_W3 : weights_size(E)));
}

extern "C" int nerf_fused_head(const void* enc, const void* sh, const void* w, void* out, int E, int64_t N,
                               int is_bf16, void* stream) {
  if (E < 1 || E > EMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return static_cast<int>(launch_mma(ngp_head_mma_kernel, N, mma_smem_bytes(E, true), s,
                                       static_cast<const __nv_bfloat16*>(enc), static_cast<const __nv_bfloat16*>(sh),
                                       static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out), E, N));
  }
  return static_cast<int>(launch(ngp_head_kernel, f32_grid(N), sizeof(float) * weights_size(E), s,
                                 static_cast<const float*>(enc), static_cast<const float*>(sh),
                                 static_cast<const float*>(w), static_cast<float*>(out), E, N));
}

extern "C" int nerf_fused_density(const void* enc, const void* w, void* out, int E, int64_t N, int is_bf16,
                                  void* stream) {
  if (E < 1 || E > EMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return static_cast<int>(launch_mma(ngp_density_mma_kernel, N, mma_smem_bytes(E, false), s,
                                       static_cast<const __nv_bfloat16*>(enc), static_cast<const __nv_bfloat16*>(w),
                                       static_cast<__nv_bfloat16*>(out), E, N));
  }
  return static_cast<int>(launch(ngp_density_kernel, f32_grid(N), sizeof(float) * (chunks(E) * W1_CHUNK + OFF_W3),
                                 s, static_cast<const float*>(enc), static_cast<const float*>(w),
                                 static_cast<float*>(out), E, N));
}
