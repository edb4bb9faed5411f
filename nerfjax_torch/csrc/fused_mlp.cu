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
// cores. The f32 kernels keep their sums on the FP32 pipes (their results
// are fixed bit for bit, below), so their bound is operations: 139 us for
// the head at N = 524,288, E = 24, and their design is about issuing FMAs:
// in layers 1, 3 and 4 every 16-byte shared-memory load feeds 16 of them.
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
// deterministic), the f32 kernels layer1() and the same order of additions
// in layer 2.
//
// The f32 kernels: a grid of as many 128-thread blocks as fit on the card,
// each staging the weights once (transposed, pack_weights) and walking
// every gridDim-th step of TILE = 128 points. A step's enc and sh rows are copied into shared memory with
// cp.async: the density kernel double-buffers enc (the next step's copy is
// in flight while this one computes); the head, short of shared memory for
// two, issues the next enc copy once layer 1 has read its tile and the next
// sh copy once layer 3 has, so each lands during the layers after. Each
// layer is a register-blocked product: a thread owns 8 outputs x 8 points
// (layers 1, 3 and 4; 4 x 4 in layer 2), reads a fan-in step's 8 weights
// and 8 activations with four 16-byte shared loads and issues 64 FMAs; the
// ReLU'd activations go to a shared buffer [64][128] for the next layer.
// Layer 5 (3 outputs) and the output take one point a thread; so does the
// density kernel's layer 2, one row: a serial chain of 64 FMAs a point
// over W2's row 0, kept contiguous.
//
// Measured on an H100 (80GB HBM3, 700 W) at N = 524,288, E = 24: the head
// at ~59 % of its operations bound, the density kernel at ~47 %, where a
// loop of FMAs alone reaches 94 % (63 TFLOP/s) from 8 warps an SM. What is
// left is outside the FMA loops: a warp of the density kernel spends ~52 %
// of its time in layer 1, ~18 % in the layer-2 chain (its order is fixed)
// and ~23 % issuing the next tile's cp.async copies, the price of keeping
// enough copies in flight: one bulk copy (TMA) a row issued by one thread,
// a warp that only copies, and the copies spread over the chain were all
// slower; another lane map and loading each step's operands one step ahead
// moved the times by 0-3 %.
//
// Their numerics are those of the plain order of additions, fixed: every
// sum starts at +0.0f, each term is one __fmaf_rn, and the terms run in
// ascending fan-in (layer 1 over the encoding's rows 0..E-1, layer 3 over
// feat then sh). The tiling changes which thread makes a sum, not the order
// within it, so the outputs are bit for bit those of the first design
// (HEAD_DIGESTS in chip_smoke.py). No TF32 or bf16 splitting: the f32
// kernels compute what a caller who asks for f32 expects.

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
// shared by both halves: asynchronous copies into shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared memory, asynchronously; with src_bytes
// = 0 the destination is filled with zeros (rows past E, points past N).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// ---------------------------------------------------------------------------
// f32: register-blocked products on the FP32 pipes
// ---------------------------------------------------------------------------

constexpr int TILE = 128;  // points per step of the f32 kernels: one per thread in layer 5
static_assert(TILE == THREADS, "layer 5 and the output take one point a thread");

// Packed f32 weight buffer, written by the wrapper: every layer transposed
// to [in][out], row-major, so that a row holds one fan-in step's weights of
// consecutive outputs:
//   W1t [E][HID], then W2t [HID][GEO], W3t [CIN][HID], W4t [HID][HID] and
//   W5t [HID][4] (its 3 outputs and a zero column, one 16-byte load a step).
constexpr int OFF_T3 = HID * GEO;  // offsets after W1t
constexpr int OFF_T4 = OFF_T3 + CIN * HID;
constexpr int OFF_T5 = OFF_T4 + HID * HID;
constexpr int T_REST = OFF_T5 + HID * 4;  // 7,424 floats
static_assert(OFF_T3 % 4 == 0 && OFF_T4 % 4 == 0 && OFF_T5 % 4 == 0 && T_REST % 4 == 0, "16-byte rows");

__host__ __device__ constexpr int weights_size(int E) { return E * HID + T_REST; }  // 8,960 floats at E = 24

// dynamic shared memory of the f32 kernels, in floats. Head: the weights,
// one enc tile [E][TILE], one sh tile [SHD][TILE], the activations [HID]
// [TILE] (h, then h2, then h3) and feat [GEO][TILE]. Density: W1t and W2t,
// two enc tiles, the activations and W2's row 0 (contiguous).
__host__ __device__ constexpr int f32_smem_floats(int E, bool head) {
  return head ? weights_size(E) + (E + SHD + HID + GEO) * TILE : E * HID + OFF_T3 + (2 * E + HID) * TILE + HID;
}

// relu that lets NaN through, as jnp.maximum(x, 0) and torch.relu do
__device__ __forceinline__ float relu(float v) { return v != v ? v : fmaxf(v, 0.0f); }

// the same relu in one instruction, for values that come out of FMAs: max.NaN
// returns the canonical NaN where its input is NaN, and an FMA's NaN result
// is the canonical one already
__device__ __forceinline__ float relu_sum(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(v));
  return r;
}

// A thread's tile of a layer: TO consecutive outputs o0.. by TP points,
// TP / 4 runs of 4 at p0 + r * TILE / 2 (TP = 8: p0.. and p0 + 64..; TP =
// 4: p0..). The callers give each half-warp 2 groups of outputs by 8 runs
// of points, so its 16-byte loads of a row touch at most 128 contiguous
// bytes (an H100 serves a half-warp's 16-byte loads in one 128-byte
// wavefront when they read at most 8 distinct chunks, in two at 16).
template <int TO, int TP>
struct Tile {
  static_assert(TO % 4 == 0 && (TP == 4 || TP == 8), "16-byte loads");
  float acc[TO][TP];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TO; ++i)
#pragma unroll
      for (int j = 0; j < TP; ++j) acc[i][j] = 0.0f;
  }

  // one fan-in step: acc[i][j] += w[i] * a[j], one __fmaf_rn per term; w:
  // the step's row of a transposed weight matrix at o0 (16-byte loads), a:
  // the step's activation row at p0
  __device__ __forceinline__ void step(const float* w, const float* a) {
    float wv[TO], av[TP];
#pragma unroll
    for (int i = 0; i < TO / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(w)[i];
      wv[4 * i] = v.x, wv[4 * i + 1] = v.y, wv[4 * i + 2] = v.z, wv[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < TP / 4; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(a + r * (TILE / 2));
      av[4 * r] = v.x, av[4 * r + 1] = v.y, av[4 * r + 2] = v.z, av[4 * r + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TO; ++i)
#pragma unroll
      for (int j = 0; j < TP; ++j) acc[i][j] = __fmaf_rn(wv[i], av[j], acc[i][j]);
  }

  // K fan-in steps in ascending order over rows [K][OUT] of a transposed
  // weight matrix (from wt + o0) and rows [K][TILE] of activations (from
  // act + p0). Unrolled by 4, not fully: the kernels' code stays small.
  template <int OUT>
  __device__ __forceinline__ void product(int K, const float* wt, const float* act) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) step(wt + k * OUT, act + k * TILE);
  }

  // relu(acc) into rows o0.. of dst [*][TILE] at the thread's points
  __device__ __forceinline__ void store_relu(float* dst, int o0, int p0) const {
#pragma unroll
    for (int i = 0; i < TO; ++i)
#pragma unroll
      for (int r = 0; r < TP / 4; ++r)
        *reinterpret_cast<float4*>(dst + (o0 + i) * TILE + p0 + r * (TILE / 2)) =
            make_float4(relu_sum(acc[i][4 * r]), relu_sum(acc[i][4 * r + 1]), relu_sum(acc[i][4 * r + 2]),
                        relu_sum(acc[i][4 * r + 3]));
  }
};

// The 8 x 8 tiles of a 64-output layer: 8 groups of outputs by 16 of
// points; a warp holds 4 groups of outputs by 8 of points (lane / 8, lane
// % 8), the two warps of one half of the outputs the two halves of the
// points.
struct Wide {
  int o0, p0;
  __device__ __forceinline__ Wide()
      : o0((threadIdx.x / 64 * 4 + threadIdx.x % 32 / 8) * 8), p0((threadIdx.x / 32 % 2 * 8 + threadIdx.x % 8) * 4) {}
};

// Layer 1 into act [HID][TILE]: h = relu(W1 . enc) over the encoding's E
// rows in ascending order. Shared by both kernels with the same tiles, so
// the two compute every h bit for bit alike.
__device__ __forceinline__ void layer1(const float* w1t, const float* senc, int E, float* act) {
  const Wide t;
  Tile<8, 8> h;
  h.zero();
  h.product<HID>(E, w1t + t.o0, senc + t.p0);
  h.store_relu(act, t.o0, t.p0);
}

// Rows [0, rows) of src [rows, N] at points n0.. into dst [rows][TILE],
// zeros at points >= N, with cp.async: 16 bytes a copy where every row
// starts on a 16-byte boundary (vec: N % 4 == 0 and src aligned), else 4.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int rows, int64_t N,
                                           int64_t n0, bool vec) {
  if (vec) {
    constexpr int PIECES = TILE / 4;
    for (int i = threadIdx.x; i < rows * PIECES; i += THREADS) {
      const int k = i / PIECES, p = i % PIECES * 4;
      const bool in = n0 + p < N;
      cp_async16(dst + k * TILE + p, in ? src + k * N + n0 + p : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * TILE; i += THREADS) {
      const int k = i / TILE, p = i % TILE;
      const bool in = n0 + p < N;
      cp_async4(dst + k * TILE + p, in ? src + k * N + n0 + p : src, in ? 4 : 0);
    }
  }
}

// The first `count` floats of the packed weights (a multiple of 4), once per block
__device__ __forceinline__ void stage_weights(float* dst, const float* __restrict__ src, int count) {
  for (int i = threadIdx.x; i < count / 4; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i, 16);
}

__device__ __forceinline__ bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

__global__ void __launch_bounds__(THREADS)
ngp_head_kernel(const float* __restrict__ enc, const float* __restrict__ sh, const float* __restrict__ w,
                float* __restrict__ out, int E, int64_t N) {
  extern __shared__ float4 smem_f32[];  // f32_smem_floats(E, true)
  float* sw = reinterpret_cast<float*>(smem_f32);
  float* senc = sw + weights_size(E);
  float* ssh = senc + E * TILE;
  float* act = ssh + SHD * TILE;
  float* feat = act + HID * TILE;
  const float* w2t = sw + E * HID;
  const float* w3t = w2t + OFF_T3;
  const float* w4t = w2t + OFF_T4;
  const float* w5t = w2t + OFF_T5;
  const Wide t;
  const int o4 = threadIdx.x % 32 / 8 * 4, p4 = (threadIdx.x / 32 * 8 + threadIdx.x % 8) * 4;  // layer 2: 4 x 4 tiles, 4 by 32
  const bool vec = N % 4 == 0 && aligned16(enc) && aligned16(sh);
  const int64_t steps = (N + TILE - 1) / TILE;

  stage_weights(sw, w, weights_size(E));
  if (blockIdx.x < steps) {
    stage_rows(senc, enc, E, N, (int64_t)blockIdx.x * TILE, vec);
    stage_rows(ssh, sh, SHD, N, (int64_t)blockIdx.x * TILE, vec);
  }
  cp_async_commit();
  for (int64_t c = blockIdx.x; c < steps; c += gridDim.x) {
    const int64_t n0 = c * TILE, next = (c + gridDim.x) * TILE;
    cp_async_wait_all();  // this step's enc and sh (and, first, the weights)
    __syncthreads();
    layer1(sw, senc, E, act);
    __syncthreads();
    if (next < N) stage_rows(senc, enc, E, N, next, vec);  // lands during layers 2-5
    cp_async_commit();

    Tile<4, 4> f;  // feat = relu(W2 . h)
    f.zero();
    f.product<GEO>(HID, w2t + o4, act + p4);
    f.store_relu(feat, o4, p4);
    __syncthreads();

    Tile<8, 8> h2;  // h2 = relu(W3 . [feat; sh])
    h2.zero();
    h2.product<HID>(GEO, w3t + t.o0, feat + t.p0);
    h2.product<HID>(SHD, w3t + GEO * HID + t.o0, ssh + t.p0);
    h2.store_relu(act, t.o0, t.p0);
    __syncthreads();
    if (next < N) stage_rows(ssh, sh, SHD, N, next, vec);  // lands during layers 4-5 and the next layer 1
    cp_async_commit();

    Tile<8, 8> h3;  // h3 = relu(W4 . h2), into act once every thread has read h2
    h3.zero();
    h3.product<HID>(HID, w4t + t.o0, act + t.p0);
    __syncthreads();
    h3.store_relu(act, t.o0, t.p0);
    __syncthreads();

    const int p = threadIdx.x;  // rgb = sigmoid(W5 . h3), one point a thread
    float z0 = 0.0f, z1 = 0.0f, z2 = 0.0f;
#pragma unroll 8
    for (int k = 0; k < HID; ++k) {
      const float4 wk = reinterpret_cast<const float4*>(w5t)[k];
      const float a = act[k * TILE + p];
      z0 = __fmaf_rn(wk.x, a, z0);
      z1 = __fmaf_rn(wk.y, a, z1);
      z2 = __fmaf_rn(wk.z, a, z2);
    }
    if (n0 + p < N) {  // the ragged edge: no padding
      out[n0 + p] = 1.0f / (1.0f + expf(-z0));
      out[N + n0 + p] = 1.0f / (1.0f + expf(-z1));
      out[2 * N + n0 + p] = 1.0f / (1.0f + expf(-z2));
      out[NOUT * N + n0 + p] = feat[p];  // sigma = feat row 0
    }
  }
}

__global__ void __launch_bounds__(THREADS)
ngp_density_kernel(const float* __restrict__ enc, const float* __restrict__ w, float* __restrict__ out, int E,
                   int64_t N) {
  extern __shared__ float4 smem_f32[];  // f32_smem_floats(E, false)
  float* sw = reinterpret_cast<float*>(smem_f32);
  float* senc = sw + E * HID + OFF_T3;  // two tiles: step i in senc + (i % 2) * E * TILE
  float* act = senc + 2 * E * TILE;
  float* w2r = act + HID * TILE;  // W2 row 0, contiguous
  if (threadIdx.x < HID) w2r[threadIdx.x] = w[E * HID + threadIdx.x * GEO];
  const bool vec = N % 4 == 0 && aligned16(enc);
  const int64_t steps = (N + TILE - 1) / TILE;

  stage_weights(sw, w, E * HID + OFF_T3);
  if (blockIdx.x < steps) stage_rows(senc, enc, E, N, (int64_t)blockIdx.x * TILE, vec);
  cp_async_commit();
  int buf = 0;
  for (int64_t c = blockIdx.x; c < steps; c += gridDim.x, buf ^= 1) {
    const int64_t n0 = c * TILE, next = (c + gridDim.x) * TILE;
    // the next step's tile into the other buffer, whose last reader (layer
    // 1 of the step before) is behind the barrier that followed it
    if (next < N) stage_rows(senc + (buf ^ 1) * E * TILE, enc, E, N, next, vec);
    cp_async_commit();
    cp_async_wait_prior();  // this step's tile
    __syncthreads();
    layer1(sw, senc + buf * E * TILE, E, act);
    __syncthreads();
    const int p = threadIdx.x;  // sigma = relu(W2 row 0 . h), one point a thread
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < HID; k += 4) {
      const float4 wk = *reinterpret_cast<const float4*>(w2r + k);
      s = __fmaf_rn(wk.x, act[k * TILE + p], s);
      s = __fmaf_rn(wk.y, act[(k + 1) * TILE + p], s);
      s = __fmaf_rn(wk.z, act[(k + 2) * TILE + p], s);
      s = __fmaf_rn(wk.w, act[(k + 3) * TILE + p], s);
    }
    if (n0 + p < N) out[n0 + p] = relu_sum(s);
  }
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

// Every kernel's grid: as many blocks as fit on the card at once (each
// walks every gridDim-th step of its points), fewer for a short N, with
// `bytes` of dynamic shared memory. Above 48 KB a kernel may take them only
// after its limit is raised; the limit is set before every launch, as it
// holds per device and context and costs nothing beside the launch.
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kernel, int64_t steps, size_t bytes, cudaStream_t s, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
  if (e != cudaSuccess) return e;
  const int grid = static_cast<int>(steps < (int64_t)sms * per_sm ? steps : (int64_t)sms * per_sm);
  kernel<<<grid > 0 ? grid : 1, THREADS, bytes, s>>>(args...);
  return cudaGetLastError();
}

int64_t steps_of(int64_t N, int points) { return (N + points - 1) / points; }

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
  return static_cast<int>(sizeof(float) * f32_smem_floats(E, !density));
}

// blocks of the head (density = 0) or density kernel that fit on one SM at
// once (the persistent grid is this many times the SMs); -1 outside
// 1..EMAX, -2 - the CUDA error where the query fails
extern "C" int nerf_fused_blocks_per_sm(int E, int is_bf16, int density) {
  if (E < 1 || E > EMAX) return -1;
  const int bytes = nerf_fused_smem_bytes(E, is_bf16, density);
  const void* kernel = is_bf16 ? (density ? reinterpret_cast<const void*>(ngp_density_mma_kernel)
                                          : reinterpret_cast<const void*>(ngp_head_mma_kernel))
                               : (density ? reinterpret_cast<const void*>(ngp_density_kernel)
                                          : reinterpret_cast<const void*>(ngp_head_kernel));
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
  return e == cudaSuccess ? per_sm : -2 - static_cast<int>(e);
}

extern "C" int nerf_fused_head(const void* enc, const void* sh, const void* w, void* out, int E, int64_t N,
                               int is_bf16, void* stream) {
  if (E < 1 || E > EMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return static_cast<int>(launch_persistent(ngp_head_mma_kernel, steps_of(N, MMA_POINTS), mma_smem_bytes(E, true),
                                              s, static_cast<const __nv_bfloat16*>(enc),
                                              static_cast<const __nv_bfloat16*>(sh),
                                              static_cast<const __nv_bfloat16*>(w),
                                              static_cast<__nv_bfloat16*>(out), E, N));
  }
  return static_cast<int>(launch_persistent(ngp_head_kernel, steps_of(N, TILE), sizeof(float) * f32_smem_floats(E, true),
                                            s, static_cast<const float*>(enc), static_cast<const float*>(sh),
                                            static_cast<const float*>(w), static_cast<float*>(out), E, N));
}

extern "C" int nerf_fused_density(const void* enc, const void* w, void* out, int E, int64_t N, int is_bf16,
                                  void* stream) {
  if (E < 1 || E > EMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return static_cast<int>(launch_persistent(ngp_density_mma_kernel, steps_of(N, MMA_POINTS),
                                              mma_smem_bytes(E, false), s, static_cast<const __nv_bfloat16*>(enc),
                                              static_cast<const __nv_bfloat16*>(w),
                                              static_cast<__nv_bfloat16*>(out), E, N));
  }
  return static_cast<int>(launch_persistent(ngp_density_kernel, steps_of(N, TILE),
                                            sizeof(float) * f32_smem_floats(E, false), s,
                                            static_cast<const float*>(enc), static_cast<const float*>(w),
                                            static_cast<float*>(out), E, N));
}
