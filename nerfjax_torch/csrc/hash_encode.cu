// The multiresolution hash grid's hashed and dense levels, forward and
// table gradient, and the table-gradient scatter, for sm_90a.
//
// Replaces, from nerfjax:
//   dense_levels_fwd   <- the Pallas kernel _dma_gather_fn
//                         (benchmarks/micro_pallas_gather.py:97), the row
//                         gather out[i] = tbl[idx[i]] that fetches a dense
//                         cell's 8 corners x 2 planes (_packed_row_gather,
//                         nerfjax/ops/hash_encode.py:457-468), with the
//                         blend around it: the exact dense forward
//                         _dense_levels_encode (:487-530) and the k = 1
//                         stochastic one _dense_stoch_fwd (:727-741)
//   dense_levels_bwd   <- the Pallas kernel _take_along_axis_probe
//                         (benchmarks/micro_pallas_gather.py:71), the take
//                         of the drawn level's cotangent in the dense
//                         level-subset backward _dense_glv_bwd (:623-669),
//                         with the staging of the dense table gradient
//                         around it (exact, k = 1 _dense_stoch_bwd :744-763,
//                         level subset) as K3's inputs
//   hash_levels_fwd    <- the XLA forward _hash_levels_fwd
//                         (nerfjax/ops/hash_encode.py:304-332): exact
//                         8-corner trilinear sum, or the k = 1 dithered
//                         estimate (one corner drawn with P = its weight)
//   hash_levels_bwd    <- the XLA backward _hash_levels_bwd (:335-406): the
//   (+ _exact, fold)      scatter-add of g*w to all 8 corners (exact), of g
//                         to the planned corner (k = 1), or of g*Lh/gl to
//                         the planned corner of gl drawn levels
//   hashgrid_fwd       <- the XLA forward of the feature-last encode
//                         hashgrid_encode (nerfjax/fields/ngp.py:212-237):
//                         every level's 8 corners (hashed, or dense with
//                         each corner coordinate clipped to [0, r-1],
//                         :149-206), both planes gathered and blended in
//                         f32, no bf16 rounding, into a row-major [N, 2L]
//   hashgrid_bwd       <- its autodiff transpose: the scatter-add of g*w
//   (+ fold)              to every level's 8 corners, into the table
//                         gradient
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
// (level, point) reads one (k = 1) or eight (exact) table entries at hashed,
// i.e. random, addresses: every read pulls a 32-byte sector for a few
// useful bytes, so the sector traffic is many times the bytes the function
// needs. The backward's atomicAdds land at the same random addresses (the
// L2 performs them). The hashed levels of the tuned model hold 2 x 7 x 2^19
// f32 = 29 MB, which fits the 50 MB L2; the drop-in model's 12 levels hold
// 50 MB, the size of the L2. PERF.md has the kernels' times beside their
// bounds.
//
// K1 k = 1 reads one drawn entry per (level, point): two 4-byte loads, one
// from each plane, at hashed addresses. Its time follows the count of those
// random requests (~100-130G a second on an H100 80GB HBM3 at 700 W, the
// rate of K2 k = 1's atomics), not their latency or the plan's arithmetic:
// one thread per point walking its levels with 1, 2, 4 or all 7 levels'
// loads in flight, plain, __ldg or __ldcg loads, all take 27-31 us at the
// tuned step (first design 28.5). So it stays one thread per (level, point),
// over a 2-D grid (the level in blockIdx.y: no int64 division) with 32-bit
// entries, the fastest arm at the grid update's call (56.7 us against
// 58.6). One request per entry (bf16 pairs packed in front, as K1 exact
// reads them) halves the kernel, but the pack of the 3.7M hashed columns
// (16.6 us then, one entry a thread) cost more than that saved at the
// tuned step.
//
// K1 and K4 store into the encode's [2, L, N] output in its dtype, each into
// its rows through a plane stride: no float32 part, no cast, no concat.
//
// K1 exact first read both planes of each of the 8 corners with two 4-byte
// loads from planes 4*total bytes apart (two sectors per corner, ~9 per
// (level, point) where the x-neighbours share one). It rounds every table
// value to bf16 anyway, so a coalesced pass (pack_pairs_bf16_kernel) packs
// the hashed columns into one 32-bit word per entry, plane 0 in the low
// half and plane 1 in the high half (nerfjax's _pack_pairs_bf16 layout),
// and K1 exact loads one word per corner and widens each half by a shift.
// That halves the table K1 reads (25 MB at the drop-in spec, half the L2)
// and the sectors per (level, point); the pack moves 12 bytes per entry
// (~75 MB at the drop-in spec) and its time counts in K1's. The arithmetic
// and its order do not change, so K1 exact equals its plain version bit
// for bit. K1 k = 1 reads one corner per (level, point) and keeps the
// planes: at the tuned step the pack costs more than the second load.
//
// K2 exact is bound by the L2's atomic rate, not by bytes. The first design
// issued 16 float atomics per (level, point), one per corner and
// plane: 302M at the drop-in step's fine pass (12 hashed levels, N =
// 1,572,864), ~3.1 ms, ~95G atomics/s, against a 66 us bound on bytes. Two
// facts of that data make the count larger than it needs to be: the two
// planes of an entry lie 4*total bytes apart, in two sectors; and a fine
// pass is ray-major with each ray's depths sorted, so neighbouring lanes of
// a warp are neighbouring samples of one ray, which share all 8 corners at
// the coarse hashed levels. The design: per corner, each warp merges runs
// of equal indices (a shuffle scan, merge_run) and only a run's last lane
// adds; that add is one float2 atomic into an interleaved [T, 2] scratch,
// which a coalesced pass (scratch_fold_kernel) adds into the two planes.
// The level-major thread order stays: the hashed gradient (12 x 2^19
// entries x 8 B = 50 MB) is the size of the L2, and one level's 4 MB is
// live at a time. On an H100 80GB HBM3 (700 W), at that fine pass: the
// first design 3.1 ms, merge only 2.4 ms (230M float adds), float2 only
// 1.75 ms (151M float2 adds), both 1.36 ms (115M float2 adds, the scratch
// zeroing and fold ~75 us of it); the time follows the count of atomics,
// ~90-97G a second whatever their width, not their contention (PERF.md
// keeps each variant's times and counts).
//
// K2's k = 1 modes add g to one planned corner per (drawn level, point),
// two float atomics each: 0.79M at the tuned step (2 of 7 levels, N =
// 196,608), ~8 us at the L2's ~90-97G atomics a second, which is most of
// their time. A scratch and fold (K2 exact's) would cost more than the
// adds: zeroing and folding ~2 x 29 MB. So they add straight into the
// planes (scatter_add2), and the design cuts what is around the adds: one
// thread per point walks its rows four at a time (their plans, then their
// g, then their adds), so the position and its two seeds are formed once
// per point and four rows' loads are in flight; and every mode of K2 reads
// the upstream gradient in the encode's own dtype in place, through a
// plane stride (bf16 halves its bytes, and the backward's f32 copy of the
// hashed rows, 151 MB at the drop-in fine pass, is gone). On an H100 80GB
// HBM3 (700 W) at the tuned step's captured inputs: 9.7 us net of the
// caller's zero fill (the first design, one thread per (row, point) on an
// f32 copy: 13.8); PERF.md keeps the other designs' times.
//
// The dense levels (K4, K5) are collision free and small: the tuned model's
// five hold 753,488 entries (6.0 MB in the two f32 planes), the drop-in
// model's four 222,040. K4's first design read the planes in place, one
// thread per (level, point): 16 scattered 4-byte loads, two sectors per
// corner. It now reads a table that a coalesced pass (pack_pairs) packs in
// front of it at each call, one entry per dense column holding both
// planes: a bf16 pair where the values are rounded to bf16 anyway (exact
// bf16 and k = 1; rounding once at the pack is what rounding at each
// corner did), a float2 in exact f32; 3 MB (6 MB) at the tuned spec,
// 2.5 us. One thread per point walks the levels (the position read once, a
// level's 8 loads issued together), with 32-bit entries and two bf16
// roundings per cvt.rn.bf16x2.f32 (rnd2). Once the loads are paired, the
// kernel is not bound by sectors but by its instructions (~200 per (level,
// point) in exact bf16) and, at the tuned step's one wave of points, by
// their latency: nerfjax's cell rows (one aligned 32-byte row per (level,
// point), 23 MB built per call at the tuned spec) cost more to build than
// they save, and level-major threads, two threads per point or an unrolled
// level loop gain nothing. On an H100 80GB HBM3 (700 W), exact bf16: 23.1
// us at the tuned step (first design 48.8), 56.8 at the drop-in fine pass
// (115.0); PERF.md keeps every other design's time. K5 writes
// 12 bytes per (level, corner, point): 94 MB per exact tuned step, its
// bound; fusing it into K3 would save writing and reading them back. One
// thread per (level, point), or per (drawn level, point).
//
// K3 adds K5's staged entries into the dense columns. Its first design
// issued two float atomics per entry (100.7M at the drop-in fine pass,
// 1.83 ms on an H100 80GB HBM3 at 700 W, ~54G a second), and K5's order
// (level, corner, point) puts neighbouring samples of one ray side by side,
// so neighbouring lanes add to the same dense entry again and again. K3 now
// takes K2 exact's design: each warp merges its runs of equal indices
// (merge_run) and adds each run with one float2 atomic into an interleaved
// [T, 2] scratch, which scratch_fold_kernel adds into the planes. Its bound
// is then the 12 bytes per entry it reads.

// The leader + residual modes (k = 2..7 corners; nerfjax's
// _stochastic_corner_plan :244-290) stand beside the k = 1 and exact
// kernels, which they leave as they are: K1, K4 and K5 one thread per
// (level, point), K2 one thread per point over its rows (the gl mode) or
// per (level, point) (over all levels). Each forms the 8 f32 weights, the leader (the first largest: a
// strict > over corners 0..7, as jnp.argmax), the residual CDF (w with w_m
// zeroed, summed in order), and k - 1 draws from it (draw_u with draw index
// j - 1; at j = 0 the k = 1 draw bit for bit), then reads or adds at the k
// planned entries: coef w_m for the leader, total * rinv for each draw,
// rinv = f32(1/(k-1)) from the host (a product, as nerfjax forms it; at
// total = 0 every draw is corner 7 with coef 0). Like k = 1, they are bound
// by random requests: K1 and K4 read k entries per (level, point), K2 adds
// two floats per planned entry, K5 writes 12 bytes per planned entry for
// K3, in (level, draw, point) order so that neighbouring lanes share
// entries as K3's run merge expects. PERF.md has their times.
//
// K1 k >= 2 first read both planes of each planned entry, 2k random 4-byte
// loads per (level, point) (5.5M at the k2 knob step: 7 hashed levels, N =
// 196,608, k = 2), ~48 us on an H100 80GB HBM3 (700 W). Its plan alone
// takes ~11 us, the loads of a fixed plan from the planes ~49: it is bound
// by those random requests, as K1 k = 1 is. It now reads one bf16-pair word
// per planned entry from the pack in front of it (half the requests, and a
// 15 MB table that the L2 holds where the planes' 29 MB miss it), with the
// k loads issued together (k a template parameter: a runtime k unrolled to
// 7 with predication was 23 % slower at k = 7); the pack moves four entries
// a thread with 16-byte loads and stores (13.5 us, one entry a thread
// 16.5). Together ~37 us at k = 2, ~51 at k = 7 (first design ~144).
//
// K4 k >= 2 first ran one thread per point over its levels, a runtime k
// and one dependent load per planned corner. It now takes K1 k >= 2's
// design: one thread per (level, point) on a 2-D grid, k a template
// parameter, the k planned words loaded together. On an H100 80GB HBM3
// (700 W), at the k2 knob spec (5 dense levels, N = 196,608, ray samples;
// the pack included) that gains nothing at k = 2 (12.77 us against 12.74)
// and 13 % at k = 7 (20.22 against 23.12), because the kernel is bound by
// its scattered table requests, not by the plan: with a fixed plan (no
// leader, no draws) it takes as long (13.92 against 13.56 us on uniform
// positions), without its loads 8.53, with neither 4.41. Reading the two
// f32 planes in place and rounding them here (no pack) doubles those
// requests and lost (16.36 us). Each level alone takes 2.9-3.9 us, so no
// level is cheap enough to gain from shared memory. K is kept a template
// parameter for k = 3..7, where the loads in flight do gain; PERF.md keeps
// the arms' times.
//
// K2 b >= 2 at the fast step (12 hashed levels, N = 393,216, b = 2) first
// ran one thread per point over its 12 levels, two float atomics per
// planned entry straight into the planes: 18.9M adds in ~400 us on an H100
// 80GB HBM3 (700 W), half of K2 k = 1's rate. Two causes were measured
// (PERF.md keeps every arm's time). Not contention: the fast step's warps
// hold 1.04 terms per run of equal indices (its 48 samples a ray spread
// over the ray's occupied segments), and shuffling the points changed
// nothing. The working set: a thread walking all 12 levels keeps all 12
// levels' columns of the gradient (50 MB, the L2's size) live, and one
// thread per (level, point) on a 2-D grid, level-major as K1 k = 1, took
// it to ~241 us; merging runs (merge_run) ~235; a float2 scratch with its
// fill and fold ~245. Then the data: ~80 % of the step's cotangent values
// are exactly 0 (samples behind the surface and in empty space), and
// adding 0 changes no entry, so a run whose sums are both 0 adds nothing
// and a warp whose g are all 0 skips its row: ~75 us. The gl mode keeps
// its one thread per point over its drawn rows: at the k2 knob step (2 of
// 7 levels, b = 2) the 1.57M float atomics of its own plan, issued alone
// from a precomputed plan, take ~19.5-20.8 us, as long as the kernel
// (~20.5), so every arm that added work around the same adds (a (point,
// draw) grid, level-major threads with or without lists of each level's
// points, merged runs) was slower. It leaves out its terms of 0: ~5 % of
// them at the knob's step 34 (21.0 us against 22.0), 89 % at its step 384,
// once the occupancy grid has emptied, as at the tuned run's end (5.1 us
// against 20.5).

// The feature-last encode (hashgrid_fwd, hashgrid_bwd) is the path of
// nerfjax's render_rays and its quality evals: exact f32, no rounding.
// Times below: an H100 80GB HBM3 at 700 W, tools/hashgrid_arms.py (each arm
// against the first design in p, k, k, p sets, the pack counted).
//
// The forward is bound by its scattered table requests, not by bytes: at
// nerfjax's eval shape (16 levels, N = 786,432) the table's 14 MB sit in the
// L2 and the function's bytes take 37 us. The first design, one thread per
// (point, level) with the level innermost, loaded both planes of each
// corner in place: 16 random 4-byte loads a (point, level), the planes
// 4*total bytes apart, two sectors a corner; 1,493 us there (uniform
// positions), 2,073 at the drop-in render's fine pass (N = 1,572,864,
// ray-ordered), 786 at a quality eval's fine pass. Now (1) a pass in front
// packs the planes into one float2 per entry (pack_pairs_f32_kernel; the
// values copied, so the sums do not change), one 8-byte load a corner:
// 555, 954 and 346 us; (2) a block takes 64 points and every level, its
// warps' lanes 32 points at one level (neighbouring samples of a ray share
// sectors at the coarse levels), the sums staged in shared memory and
// written as the block's whole rows (the first design's level-major
// variant, the level in blockIdx.y, lost by storing two values 8L bytes
// apart a (point, level)): 535, 947 and 275 us. One 16-byte load for two x-neighbour
// corners where both entries lie in it (a hashed level at even ix, the x
// prime being 1) gained on uniform positions (491 us) and lost on both
// ray-ordered passes (968, 282), so it is not kept.
//
// The backward adds the table gradient itself: nothing is staged. The
// first design wrote g*w per (level, corner, point) (2.3 GiB at the drop-in
// fine pass) for K3 to read back and merge: 3,930 us. Now K2 exact's design
// carried to every level, the dense ones with their clipped corners: one
// thread per (level, point), level-major on a 2-D grid (one level's part of
// the scratch live in the L2 at a time), the cell and weights recomputed
// from the positions, each warp's runs of equal entries merged per corner,
// one float2 atomic per run whose sums are not both 0 (69 % of that pass's
// cotangent is 0: 32.5M adds where K3 issued 130.0M) into an interleaved
// scratch that a last pass folds into the gradient. Read in place, the
// cotangent [N, 2L] costs two sectors a (level, point) and every level's
// pass streams all of it again: 1,287 us; a pass in front transposes it to
// [L, N] float2 (one coalesced 8-byte load a (level, point)): 682 us, with
// 0.24 GiB allocated against the first design's 2.30.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int THREADS = 256;
constexpr uint32_t LEVEL_SALT = 0x85EBCA6Bu;     // nerfjax _LEVEL_SALT
constexpr uint32_t DENSE_SALT = 0x5BD1E995u;     // nerfjax _DENSE_SALT: the dense corner draws
constexpr uint32_t DENSE_GL_SALT = 0x27D4EB2Fu;  // nerfjax _DENSE_GL_SALT: the dense level draws

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

// v rounded to the working type: bf16 (BF16) or f32 (unchanged). PyTorch's
// bf16 ops compute in f32 and round each result once; so do the kernels.
template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  return BF16 ? bf16_round(v) : v;
}

// trilinear weight of corner c = dx*4 + dy*2 + dz (nerfjax _CORNERS order),
// evaluated as (wx*wy)*wz, every op rounded to the working type (tx, ty, tz
// already are)
template <bool BF16 = false>
__device__ __forceinline__ float corner_weight(int c, float tx, float ty, float tz) {
  float wx = (c & 4) ? tx : rnd<BF16>(__fsub_rn(1.0f, tx));
  float wy = (c & 2) ? ty : rnd<BF16>(__fsub_rn(1.0f, ty));
  float wz = (c & 1) ? tz : rnd<BF16>(__fsub_rn(1.0f, tz));
  return rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(wx, wy)), wz));
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

// The uniform of draw j of level l (_draw_corners: h = (seed ^ l*2654435761)
// + j*0x7F4A7C15, mixed; the salt is in seed), in [0, 1). At j = 0 the added
// term is 0: the k = 1 draw.
__device__ __forceinline__ float draw_u(uint32_t seed, int l, int j) {
  return unit24(mix((seed ^ (static_cast<uint32_t>(l) * 2654435761u)) + static_cast<uint32_t>(j) * 0x7F4A7C15u));
}

// The corner a uniform u in [0, 1) picks from the sequential f32 CDF cdf of
// 8 weights: u scaled by cdf[7], then #{i < 7 : u >= cdf[i]}.
__device__ __forceinline__ int cdf_corner(float u, const float (&cdf)[8]) {
  u = __fmul_rn(u, cdf[7]);
  int corner = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) corner += (u >= cdf[i]) ? 1 : 0;
  return corner;
}

// The corner of level l drawn with P(corner) = its f32 weight from the
// fractions tx, ty, tz: cdf is the sequential f32 cumsum of the 8 weights
// (_draw_corners with k = 1, draw j = 0; the salt is in seed).
__device__ __forceinline__ int draw_corner(float tx, float ty, float tz, uint32_t seed, int l) {
  float cdf[8];
  float acc = corner_weight(0, tx, ty, tz);
  cdf[0] = acc;
#pragma unroll
  for (int c = 1; c < 8; ++c) {
    acc = __fadd_rn(acc, corner_weight(c, tx, ty, tz));
    cdf[c] = acc;
  }
  return cdf_corner(draw_u(seed, l, 0), cdf);
}

// The leader + residual plan (k >= 2) of one (level, point), from its
// fractions (_stochastic_corner_plan): the leader m, the first of the
// largest f32 weights (a strict > over corners 0..7, as jnp.argmax breaks
// ties), its weight wm, and cdfr, the sequential f32 CDF of the residual
// weights (w with w_m set to 0; cdfr[7] = total = 1 - w_m as summed).
struct LeaderPlan {
  int m;
  float wm;
  float cdfr[8];
};

__device__ __forceinline__ void leader_plan(float tx, float ty, float tz, LeaderPlan& p) {
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) w[c] = corner_weight(c, tx, ty, tz);
  p.m = 0;
  p.wm = w[0];
#pragma unroll
  for (int c = 1; c < 8; ++c) {
    if (w[c] > p.wm) {
      p.m = c;
      p.wm = w[c];
    }
  }
  float acc = p.m == 0 ? 0.0f : w[0];
  p.cdfr[0] = acc;
#pragma unroll
  for (int c = 1; c < 8; ++c) {
    acc = __fadd_rn(acc, p.m == c ? 0.0f : w[c]);
    p.cdfr[c] = acc;
  }
}

// Corner j (0 <= j < k) of a leader + residual plan: the leader at j = 0,
// else residual draw j - 1 (draw index j - 1 of _draw_corners over cdfr; at
// total = 0, u = 0 and every draw is corner 7).
__device__ __forceinline__ int plan_corner(const LeaderPlan& p, uint32_t seed, int l, int j) {
  return j == 0 ? p.m : cdf_corner(draw_u(seed, l, j - 1), p.cdfr);
}

// The k = 1 plan of hashed level l at (x, y, z): the hashed index (relative
// to the first hashed level) of the drawn corner.
__device__ __forceinline__ int64_t plan_k1(const Levels& L, int l, uint32_t mask, float x,
                                           float y, float z, uint32_t seed) {
  int ix, iy, iz;
  float tx, ty, tz;
  lattice(x, L.scale[l], ix, tx);
  lattice(y, L.scale[l], iy, ty);
  lattice(z, L.scale[l], iz, tz);
  return hash_index(ix, iy, iz, draw_corner(tx, ty, tz, seed, l), mask) + L.offset[l];
}

// draw j of the level subset (_draw_levels): a level id in [0, Lh)
__device__ __forceinline__ int draw_level(uint32_t seed, int j, int Lh) {
  uint32_t h = mix(seed + static_cast<uint32_t>(j) * 0x7F4A7C15u);
  int id = static_cast<int>(__fmul_rn(unit24(h), static_cast<float>(Lh)));
  return id < Lh - 1 ? id : Lh - 1;
}

// element i of an upstream gradient in bf16 (BF16) or f32, widened to f32
// (exact)
template <bool BF16>
__device__ __forceinline__ float load_g(const void* g, int64_t i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(g)[i]);
  return static_cast<const float*>(g)[i];
}

// out0[i] += v0, out1[i] += v1 for 0 <= i < T; an index outside is dropped.
// The add of K2's k = 1 modes.
__device__ __forceinline__ void scatter_add2(float* out0, float* out1, int64_t T, int64_t i,
                                             float v0, float v1) {
  if (i < 0 || i >= T) return;
  atomicAdd(out0 + i, v0);
  atomicAdd(out1 + i, v1);
}

constexpr unsigned FULL_WARP = 0xFFFFFFFFu;

// K2 exact's and K3's merge. The lanes of the warp whose indices i are equal in a
// row form a run (a lane starts one where its index differs from the
// previous lane's). Returns true on each run's last lane, which then holds
// the run's sums of v0 and of v1, and false on the others. A segmented
// inclusive scan: lane L adds the partial sum of lane L - d while L - d
// lies in its run (d = 1, 2, ..., 16), both planes together; a warp whose
// 32 lanes are 32 runs skips it. Called by all 32 lanes; a lane with no
// add holds i = -1.
__device__ __forceinline__ bool merge_run(int64_t i, float& v0, float& v1) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int64_t prev = __shfl_up_sync(FULL_WARP, i, 1);
  const unsigned heads = __ballot_sync(FULL_WARP, lane == 0 || prev != i);
  if (heads == FULL_WARP) return true;
  const int start = 31 - __clz(heads & (FULL_WARP >> (31 - lane)));  // the first lane of this lane's run
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float u0 = __shfl_up_sync(FULL_WARP, v0, d);
    const float u1 = __shfl_up_sync(FULL_WARP, v1, d);
    if (lane - d >= start) {
      v0 = __fadd_rn(v0, u0);
      v1 = __fadd_rn(v1, u1);
    }
  }
  return lane == 31 || ((heads >> (lane + 1)) & 1u);
}

// v stored into an output of the encode's dtype: as is in f32, rounded to
// nearest even in bf16 (what .to(bfloat16) does)
__device__ __forceinline__ void store_rn(float* o, int64_t i, float v) { o[i] = v; }
__device__ __forceinline__ void store_rn(__nv_bfloat16* o, int64_t i, float v) { o[i] = __float2bfloat16_rn(v); }

// K1, k = 1. planes: [2, total] f32, total < 2^31 (32-bit entries); the
// hashed levels start at column base. out: [2, Lh, N] in f32 or bf16, plane
// stride os, level stride N (the hashed rows of the encode's output). sel
// (optional): [Lh, N] int32 planned index. One thread per (level, point)
// over a 2-D grid (blockIdx.y the level: no division), each value rounded to
// bf16 (exact in a bf16 output) and stored coalesced along points.
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
hash_levels_fwd_k1_kernel(const float* __restrict__ planes, int total, int base,
                          const float* __restrict__ xs, const float* __restrict__ ys,
                          const float* __restrict__ zs, int N, Levels L, uint32_t mask,
                          OutT* __restrict__ out, int64_t os, int32_t* __restrict__ sel) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int l = blockIdx.y;
  const float x = xs[n], y = ys[n], z = zs[n];
  const int i = static_cast<int>(plan_k1(L, l, mask, x, y, z, position_seed(x, y, z, 0u)));
  const int64_t t = static_cast<int64_t>(l) * N + n;
  store_rn(out, t, bf16_round(__ldg(planes + base + i)));
  store_rn(out, os + t, bf16_round(__ldg(planes + total + base + i)));
  if (sel != nullptr) sel[t] = i;
}

// K1, k >= 2 (leader + residual), K = k corners. words: the packed hashed
// table ([T] bf16 pairs, pack_pairs_bf16_kernel, run in front as for K1
// exact); out as K1 k = 1; sel (optional): [K, Lh, N] int32, the plan
// (leader first). One thread per (level, point) over a 2-D grid, as K1
// k = 1: the 8 weights, the leader, the residual CDF and the K - 1 draws,
// then all K planned words loaded together (one 4-byte load per entry, both
// planes widened from it by a shift), summed e = f_0*w_m, e += f_j*coef_r
// in j order in f32 (coef_r = total*rinv, rinv = f32(1/(K-1)) from the
// host) and stored in out's type.
template <int K, typename OutT>
__global__ void __launch_bounds__(THREADS)
hash_levels_fwd_lr_kernel(const uint32_t* __restrict__ words, const float* __restrict__ xs,
                          const float* __restrict__ ys, const float* __restrict__ zs, int N, Levels L, uint32_t mask,
                          float rinv, OutT* __restrict__ out, int64_t os, int32_t* __restrict__ sel) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int l = blockIdx.y;
  const float x = xs[n], y = ys[n], z = zs[n];
  int ix, iy, iz;
  float tx, ty, tz;
  lattice(x, L.scale[l], ix, tx);
  lattice(y, L.scale[l], iy, ty);
  lattice(z, L.scale[l], iz, tz);
  LeaderPlan p;
  leader_plan(tx, ty, tz, p);
  const uint32_t seed = position_seed(x, y, z, 0u);
  int i[K];
  uint32_t w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    i[j] = static_cast<int>(hash_index(ix, iy, iz, plan_corner(p, seed, l, j), mask) + L.offset[l]);
    w[j] = __ldg(words + i[j]);
  }
  const float cr = __fmul_rn(p.cdfr[7], rinv);
  float e0 = __fmul_rn(__uint_as_float(w[0] << 16), p.wm), e1 = __fmul_rn(__uint_as_float(w[0] & 0xFFFF0000u), p.wm);
#pragma unroll
  for (int j = 1; j < K; ++j) {
    e0 = __fadd_rn(e0, __fmul_rn(__uint_as_float(w[j] << 16), cr));
    e1 = __fadd_rn(e1, __fmul_rn(__uint_as_float(w[j] & 0xFFFF0000u), cr));
  }
  const int64_t t = static_cast<int64_t>(l) * N + n;
  store_rn(out, t, e0);
  store_rn(out, os + t, e1);
  if (sel != nullptr) {
    const int64_t LN = static_cast<int64_t>(gridDim.y) * N;
#pragma unroll
    for (int j = 0; j < K; ++j) sel[j * LN + t] = i[j];
  }
}

// The pack in front of K1 exact and K1 k >= 2 (and K4's table in its bf16
// modes): word[i] = bf16(p0[i]) | bf16(p1[i]) << 16 for the T entries
// (nerfjax's _pack_pairs_bf16 layout: plane 0 in the low half, plane 1 in
// the high half, a __nv_bfloat162), rounded as bf16_round rounds. A stream
// bound by its 12 bytes per entry: where p0, p1 and words are 16-byte
// aligned, each thread packs four entries a step from two 16-byte loads
// into one 16-byte store (the T % 4 left over one at a time), else one
// entry a step.
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

__global__ void __launch_bounds__(THREADS)
pack_pairs_bf16_kernel(const float* __restrict__ p0, const float* __restrict__ p1, int64_t T,
                       uint32_t* __restrict__ words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(p0) | reinterpret_cast<uintptr_t>(p1) |
                     reinterpret_cast<uintptr_t>(words)) & 15) == 0;
  const int64_t T4 = vec ? T / 4 : 0;
  for (int64_t i = first; i < T4; i += stride) {
    const float4 a = reinterpret_cast<const float4*>(p0)[i], b = reinterpret_cast<const float4*>(p1)[i];
    reinterpret_cast<uint4*>(words)[i] = make_uint4(bf16_pair(a.x, b.x), bf16_pair(a.y, b.y), bf16_pair(a.z, b.z),
                                                    bf16_pair(a.w, b.w));
  }
  for (int64_t i = 4 * T4 + first; i < T; i += stride) words[i] = bf16_pair(p0[i], p1[i]);
}

// K1 exact. words: the packed hashed table ([T] bf16 pairs, pack above);
// out: [2, Lh, N] in f32 or bf16 (each f32 sum rounded once, as .to(dtype)
// rounds), plane stride os. One thread per (level, point), t = l*N + n
// (level-major: one level's 2 MB of words is live at a time). Each corner
// is one 4-byte load, both planes widened from it by a shift, where it was
// two loads from planes 4*total bytes apart; the arithmetic and its order
// are the plain version's: e += table * w over the corners in _CORNERS
// order, f32, no contraction.
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
hash_levels_fwd_exact_kernel(const uint32_t* __restrict__ words, const float* __restrict__ xs,
                             const float* __restrict__ ys, const float* __restrict__ zs, int64_t N,
                             int Lh, Levels L, uint32_t mask, OutT* __restrict__ out, int64_t os) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= Lh * N) return;
  int l = static_cast<int>(t / N);
  int64_t n = t - l * N;
  int ix, iy, iz;
  float tx, ty, tz;
  lattice(xs[n], L.scale[l], ix, tx);
  lattice(ys[n], L.scale[l], iy, ty);
  lattice(zs[n], L.scale[l], iz, tz);
  float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t word = words[hash_index(ix, iy, iz, c, mask) + L.offset[l]];
    const float w = corner_weight(c, tx, ty, tz);
    e0 = __fadd_rn(e0, __fmul_rn(__uint_as_float(word << 16), w));
    e1 = __fadd_rn(e1, __fmul_rn(__uint_as_float(word & 0xFFFF0000u), w));
  }
  store_rn(out, t, e0);
  store_rn(out, os + t, e1);
}

// K2 exact. g: [2, Lh, N] upstream gradient in bf16 (G16) or f32, plane
// stride gs, level stride N (the hashed levels' rows of the encode's own
// cotangent, read in place); grad: [2, total] f32 that
// the hashed levels' gradient is added into, at columns base.. (the encode's
// backward hands K3 and K2 one zeroed gradient). One thread per (level,
// point), t = l*N + n (level-major: the live part of the gradient is about
// one level's table at a time), g*w to all 8 corners. Per corner, the lanes
// of a warp whose indices are equal in a row (neighbouring samples of one
// ray in one cell) sum their terms with a shuffle scan (merge_run), and
// each run's last lane adds the sums with one float2 atomic into scratch,
// the zeroed interleaved [T, 2] (both planes of an entry in one 8-byte
// word); scratch_fold_kernel then adds it into grad's two planes. Lanes
// past the end stay in the warp's shuffles with no index.
template <bool G16>
__global__ void __launch_bounds__(THREADS)
hash_levels_bwd_exact_kernel(const void* __restrict__ g, int64_t gs, const float* __restrict__ xs,
                             const float* __restrict__ ys, const float* __restrict__ zs, int64_t N,
                             int Lh, Levels L, uint32_t mask, int64_t T,
                             float2* __restrict__ scratch) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const bool live = t < Lh * N;
  int r = 0, ix = 0, iy = 0, iz = 0;
  float tx = 0.0f, ty = 0.0f, tz = 0.0f, g0 = 0.0f, g1 = 0.0f;
  if (live) {
    r = static_cast<int>(t / N);
    int64_t n = t - r * N;
    lattice(xs[n], L.scale[r], ix, tx);
    lattice(ys[n], L.scale[r], iy, ty);
    lattice(zs[n], L.scale[r], iz, tz);
    g0 = load_g<G16>(g, r * N + n);
    g1 = load_g<G16>(g, gs + r * N + n);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int64_t i = -1;  // -1: no add (a lane past the end, or an index outside the table)
    float v0 = 0.0f, v1 = 0.0f;
    if (live) {
      const float w = corner_weight(c, tx, ty, tz);
      i = hash_index(ix, iy, iz, c, mask) + L.offset[r];
      if (i >= T) i = -1;
      v0 = __fmul_rn(g0, w);
      v1 = __fmul_rn(g1, w);
    }
    if (merge_run(i, v0, v1) && i >= 0) atomicAdd(scratch + i, make_float2(v0, v1));
  }
}

// grad[p][base + i] += scratch[i] (x: plane 0, y: plane 1) for i < T;
// entries no add reached (both zero) are left as they are.
__global__ void __launch_bounds__(THREADS)
scratch_fold_kernel(const float2* __restrict__ scratch, int64_t T, int64_t total, int64_t base,
                    float* __restrict__ grad) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < T;
       i += static_cast<int64_t>(gridDim.x) * THREADS) {
    const float2 v = scratch[i];
    if (v.x != 0.0f || v.y != 0.0f) {
      grad[base + i] = __fadd_rn(grad[base + i], v.x);
      grad[total + base + i] = __fadd_rn(grad[total + base + i], v.y);
    }
  }
}

// K2, k = 1. g, grad as for K2 exact. One thread per point over its rows,
// four at a time: the four rows' plans, then their g, then their adds (the
// position and its two seeds once per point).
//   MODE 1: k = 1, rows = the Lh levels, g to the planned corner
//   MODE 2: k = 1 with the level subset, rows = gl draws: draw r's level l,
//           g[l]*scale (scale = Lh/gl) to its planned corner; the draws are
//           iid, so a level drawn twice scatters twice
template <int MODE, bool G16>
__global__ void __launch_bounds__(THREADS)
hash_levels_bwd_kernel(const void* __restrict__ g, int64_t gs, int64_t total, int64_t base,
                       const float* __restrict__ xs, const float* __restrict__ ys,
                       const float* __restrict__ zs, int64_t N, int Lh, int rows, float scale,
                       Levels L, uint32_t mask, float* __restrict__ grad) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (n >= N) return;
  const float x = xs[n], y = ys[n], z = zs[n];
  const uint32_t seed = position_seed(x, y, z, 0u), lseed = position_seed(x, y, z, LEVEL_SALT);
  float* o0 = grad + base;
  float* o1 = grad + total + base;
  const int64_t T = total - base;
  for (int r0 = 0; r0 < rows; r0 += 4) {
    int64_t i[4];
    float g0[4], g1[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      i[k] = -1;  // no add
      g0[k] = g1[k] = 0.0f;
      if (r0 + k < rows) {
        const int l = MODE == 2 ? draw_level(lseed, r0 + k, Lh) : r0 + k;
        i[k] = plan_k1(L, l, mask, x, y, z, seed);
        g0[k] = load_g<G16>(g, l * N + n);
        g1[k] = load_g<G16>(g, gs + l * N + n);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (MODE == 2) {
        g0[k] = __fmul_rn(g0[k], scale);
        g1[k] = __fmul_rn(g1[k], scale);
      }
      scatter_add2(o0, o1, T, i[k], g0[k], g1[k]);
    }
  }
}

// K2, b >= 2 (leader + residual) over the Lh levels. g, grad as for K2
// k = 1; N < 2^31. One thread per (level, point) over a 2-D grid
// (blockIdx.y the level, as K1 k = 1): level-major, so that about one
// level's columns of the gradient are live in the L2 at a time. g*coef to
// each of the b planned corners (a corner drawn twice adds twice): per
// draw j the lanes of the warp whose indices are equal sum their terms
// (merge_run) and each run's last lane adds both sums, one float atomic
// into each plane, unless both sums are 0 (adding 0 changes no entry; most
// of a step's cotangent is 0: samples behind the surface and in empty
// space). A warp whose g are all 0 adds nothing. Lanes past N take part
// in the shuffles with no add.
template <bool G16>
__global__ void __launch_bounds__(THREADS)
hash_levels_bwd_lr_kernel(const void* __restrict__ g, int64_t gs, int64_t total, int64_t base,
                          const float* __restrict__ xs, const float* __restrict__ ys,
                          const float* __restrict__ zs, int N, int b, float rinv, Levels L, uint32_t mask,
                          float* __restrict__ grad) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int l = blockIdx.y;
  const bool live = n < N;
  float x = 0.0f, y = 0.0f, z = 0.0f, g0 = 0.0f, g1 = 0.0f;
  if (live) {
    const int64_t t = static_cast<int64_t>(l) * N + n;
    x = xs[n];
    y = ys[n];
    z = zs[n];
    g0 = load_g<G16>(g, t);
    g1 = load_g<G16>(g, gs + t);
  }
  if (__ballot_sync(FULL_WARP, g0 != 0.0f || g1 != 0.0f) == 0) return;
  int ix, iy, iz;
  float tx, ty, tz;
  lattice(x, L.scale[l], ix, tx);
  lattice(y, L.scale[l], iy, ty);
  lattice(z, L.scale[l], iz, tz);
  LeaderPlan p;
  leader_plan(tx, ty, tz, p);
  const uint32_t seed = position_seed(x, y, z, 0u);
  const float cr = __fmul_rn(p.cdfr[7], rinv);
  const int64_t T = total - base;
  for (int j = 0; j < b; ++j) {
    int64_t i = -1;  // -1: no add
    float v0 = 0.0f, v1 = 0.0f;
    if (live) {
      const float coef = j == 0 ? p.wm : cr;
      v0 = __fmul_rn(g0, coef);
      v1 = __fmul_rn(g1, coef);
      i = hash_index(ix, iy, iz, plan_corner(p, seed, l, j), mask) + L.offset[l];
      if (i >= T) i = -1;
    }
    if (merge_run(i, v0, v1) && i >= 0 && (v0 != 0.0f || v1 != 0.0f)) {
      atomicAdd(grad + base + i, v0);
      atomicAdd(grad + total + base + i, v1);
    }
  }
}

// K2, b >= 2 over gl drawn levels (scale = Lh/gl). g, grad as for K2
// k = 1. One thread per point over its gl draws: draw r's level l, its g,
// its leader + residual plan of b corners, and (g*coef)*scale (in that
// order) added to each planned corner with scatter_add2 (a corner drawn
// twice adds twice), but for a term whose two values are 0 (adding 0
// changes no entry; a draw whose g are both 0 plans nothing). Its time is
// its float atomics': the adds of its own plan alone take as long, so a
// (point, draw) grid, level-major work and merged runs, which add work
// around the same adds, were slower (PERF.md).
template <bool G16>
__global__ void __launch_bounds__(THREADS)
hash_levels_bwd_lr_gl_kernel(const void* __restrict__ g, int64_t gs, int64_t total, int64_t base,
                             const float* __restrict__ xs, const float* __restrict__ ys,
                             const float* __restrict__ zs, int64_t N, int Lh, int gl, float scale, int b,
                             float rinv, Levels L, uint32_t mask, float* __restrict__ grad) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (n >= N) return;
  const float x = xs[n], y = ys[n], z = zs[n];
  const uint32_t seed = position_seed(x, y, z, 0u), lseed = position_seed(x, y, z, LEVEL_SALT);
  float* o0 = grad + base;
  float* o1 = grad + total + base;
  const int64_t T = total - base;
  for (int r = 0; r < gl; ++r) {
    const int l = draw_level(lseed, r, Lh);
    const float g0 = load_g<G16>(g, l * N + n), g1 = load_g<G16>(g, gs + l * N + n);
    if (g0 == 0.0f && g1 == 0.0f) continue;
    int ix, iy, iz;
    float tx, ty, tz;
    lattice(x, L.scale[l], ix, tx);
    lattice(y, L.scale[l], iy, ty);
    lattice(z, L.scale[l], iz, tz);
    LeaderPlan p;
    leader_plan(tx, ty, tz, p);
    const float cr = __fmul_rn(p.cdfr[7], rinv);
    for (int j = 0; j < b; ++j) {
      const float coef = j == 0 ? p.wm : cr;
      const float v0 = __fmul_rn(__fmul_rn(g0, coef), scale), v1 = __fmul_rn(__fmul_rn(g1, coef), scale);
      if (v0 != 0.0f || v1 != 0.0f) {
        scatter_add2(o0, o1, T, hash_index(ix, iy, iz, plan_corner(p, seed, l, j), mask) + L.offset[l], v0, v1);
      }
    }
  }
}

// K3. out: plane 0 at out[0..T), plane 1 at out[stride..stride + T), f32,
// added into through scratch. One thread per entry k, in the order the
// entries come (K5 stages them (level, corner, point): neighbouring lanes
// are neighbouring samples of one ray at one corner, which often share a
// dense entry). As in K2 exact, the lanes of a warp whose indices are equal
// in a row sum their values (merge_run) and each run's last lane adds both
// sums with one float2 atomic into scratch, the zeroed interleaved [T, 2];
// scratch_fold_kernel then adds it into out. An index outside [0, T) and a
// lane past K take part as "no add".
__global__ void __launch_bounds__(THREADS)
table_grad_scatter_kernel(const int32_t* __restrict__ idx, const float* __restrict__ g0,
                          const float* __restrict__ g1, int64_t K, int64_t T,
                          float2* __restrict__ scratch) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  int64_t i = -1;
  float v0 = 0.0f, v1 = 0.0f;
  if (k < K) {
    const int64_t j = idx[k];
    if (j >= 0 && j < T) {
      i = j;
      v0 = g0[k];
      v1 = g1[k];
    }
  }
  if (merge_run(i, v0, v1) && i >= 0) atomicAdd(scratch + i, make_float2(v0, v1));
}

// -- the dense levels ---------------------------------------------------------
//
// Per dense level: lattice scale, resolution r and the offset of its r^3
// table in the [2, total] planes. Dense levels are collision free: corner
// (dx, dy, dz) of base cell (bx, by, bz) is entry (bx+dx) + (by+dy)*r +
// (bz+dz)*r^2 of the level's table.
struct DenseLevels {
  float scale[MAX_LEVELS];
  int res[MAX_LEVELS];
  int64_t offset[MAX_LEVELS];
};

// floor(x*scale + 0.5) clamped to [0, r-2] and the fraction clipped to
// [0, 1] (_dense_levels_encode's clamp semantics; f32, no contraction)
__device__ __forceinline__ void dense_axis(float x, float s, int r, int& b, float& t) {
  float p = __fadd_rn(__fmul_rn(x, s), 0.5f);
  float f = fminf(fmaxf(floorf(p), 0.0f), static_cast<float>(r - 2));
  b = static_cast<int>(f);
  t = fminf(fmaxf(__fsub_rn(p, f), 0.0f), 1.0f);
}

__device__ __forceinline__ int64_t dense_index(const DenseLevels& L, int l, int bx, int by, int bz,
                                               int c) {
  int64_t r = L.res[l];
  return L.offset[l] + (bx + ((c >> 2) & 1)) + (by + ((c >> 1) & 1)) * r + (bz + (c & 1)) * r * r;
}

// (a, b) each rounded to bf16 as bf16_round rounds it, with one
// cvt.rn.bf16x2.f32 for the two, and widened back (exact)
__device__ __forceinline__ void rnd2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
}

// K4's table: the dense columns packed into one word per entry holding both
// planes, a bf16 pair (pack_pairs_bf16_kernel) in the bf16 modes, a float2
// in exact f32 (this kernel); coalesced, one thread per entry.
__global__ void __launch_bounds__(THREADS)
pack_pairs_f32_kernel(const float* __restrict__ p0, const float* __restrict__ p1, int64_t T,
                      float2* __restrict__ pairs) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < T;
       i += static_cast<int64_t>(gridDim.x) * THREADS) {
    pairs[i] = make_float2(p0[i], p1[i]);
  }
}

// K4. pairs: the dense levels' entries packed (above): bf16 pairs (MODE 1,
// 2) or float2 (MODE 0). out: [2, Ld, N], plane stride os, level stride N
// (the dense rows of the encode's output). One thread per point, walking the
// levels (point-major: the position is read once, and a level's 8 corner
// loads are issued together); k4_level computes one (level, point).
//   MODE 0, 1 exact: out in f32 (0) or bf16 (1); the table value (bf16 at
//     the pack), the fractions, 1 - t, (wx*wy)*wz, G*w and e + G*w each
//     rounded to that type, the corners summed in _CORNERS order, as the
//     plain version's ops round (bf16: two values per cvt, rnd2)
//   MODE 2 k = 1: f32 or bf16 out (the value is a bf16 one: exact in
//     either); the one corner drawn with P = its clamped f32 weight
//     (_stochastic_corner_plan(clamp=True, salt=_DENSE_SALT)), its bf16
//     pair; sel (optional) [Ld, N] int32 receives the drawn entry
// Entries are 32-bit: the wrapper holds the dense columns below 2^31.
template <int MODE, typename OutT>
__device__ __forceinline__ void k4_level(const void* pairs, const DenseLevels& L, int l, float x, float y,
                                         float z, int64_t n, int64_t N, OutT* out, int64_t os, int32_t* sel) {
  const uint32_t* words = static_cast<const uint32_t*>(pairs);
  const int64_t t = l * N + n;  // plane 0 at out[t], plane 1 at out[os + t]
  const int r = L.res[l];
  int bx, by, bz;
  float tx, ty, tz;
  dense_axis(x, L.scale[l], r, bx, tx);
  dense_axis(y, L.scale[l], r, by, ty);
  dense_axis(z, L.scale[l], r, bz, tz);
  const int i0 = static_cast<int>(L.offset[l]) + bx + by * r + bz * r * r;
  if (MODE == 2) {
    const int c = draw_corner(tx, ty, tz, position_seed(x, y, z, DENSE_SALT), l);
    const int i = i0 + ((c >> 2) & 1) + ((c >> 1) & 1) * r + (c & 1) * r * r;
    const uint32_t w = words[i];
    store_rn(out, t, __uint_as_float(w << 16));
    store_rn(out, os + t, __uint_as_float(w & 0xFFFF0000u));
    if (sel != nullptr) sel[t] = i;
    return;
  }
  float v0[8], v1[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int i = i0 + ((c >> 2) & 1) + ((c >> 1) & 1) * r + (c & 1) * r * r;
    if (MODE == 0) {
      const float2 f = static_cast<const float2*>(pairs)[i];
      v0[c] = f.x;
      v1[c] = f.y;
    } else {
      const uint32_t w = words[i];
      v0[c] = __uint_as_float(w << 16);
      v1[c] = __uint_as_float(w & 0xFFFF0000u);
    }
  }
  float e0 = 0.0f, e1 = 0.0f;
  if (MODE == 0) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = corner_weight(c, tx, ty, tz);
      e0 = __fadd_rn(e0, __fmul_rn(v0[c], w));
      e1 = __fadd_rn(e1, __fmul_rn(v1[c], w));
    }
    store_rn(out, t, e0);
    store_rn(out, os + t, e1);
    return;
  }
  // bf16: the weights as corner_weight<true> forms them, two roundings per cvt
  rnd2(tx, ty);
  tz = bf16_round(tz);
  float ox = __fsub_rn(1.0f, tx), oy = __fsub_rn(1.0f, ty);
  rnd2(ox, oy);
  const float oz = bf16_round(__fsub_rn(1.0f, tz));
  float wxy[4] = {__fmul_rn(ox, oy), __fmul_rn(ox, ty), __fmul_rn(tx, oy), __fmul_rn(tx, ty)};  // (dx, dy)
  rnd2(wxy[0], wxy[1]);
  rnd2(wxy[2], wxy[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float w0 = __fmul_rn(wxy[k], oz), w1 = __fmul_rn(wxy[k], tz);  // corners 2k (dz = 0), 2k + 1
    rnd2(w0, w1);
    const float w[2] = {w0, w1};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float a = __fmul_rn(v0[2 * k + j], w[j]), b = __fmul_rn(v1[2 * k + j], w[j]);
      rnd2(a, b);
      e0 = __fadd_rn(e0, a);
      e1 = __fadd_rn(e1, b);
      rnd2(e0, e1);
    }
  }
  store_rn(out, t, e0);  // exact: e0 is a bf16 value
  store_rn(out, os + t, e1);
}

template <int MODE, typename OutT>
__global__ void __launch_bounds__(THREADS)
dense_levels_fwd_kernel(const void* __restrict__ pairs, const float* __restrict__ xs,
                        const float* __restrict__ ys, const float* __restrict__ zs, int64_t N, int Ld,
                        DenseLevels L, OutT* __restrict__ out, int64_t os, int32_t* __restrict__ sel) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (n >= N) return;
  const float x = xs[n], y = ys[n], z = zs[n];
  for (int l = 0; l < Ld; ++l) k4_level<MODE>(pairs, L, l, x, y, z, n, N, out, os, sel);
}

// K5. The dense levels' table gradient as K3's inputs (idx int32, v0, v1
// f32), each entry written at a fixed position (no atomics: deterministic).
// g: the upstream gradient [2, Ld, N] in bf16 (BF16) or f32, plane stride
// gs, level stride N.
//   MODE 0 exact: one thread per (level, point), entry (l*8 + c)*N + n =
//     corner c's g*w, formed in the working type as the forward's weights
//   MODE 1 k = 1: one thread per (level, point), entry l*N + n = g at the
//     corner the forward drew (the plan replayed from the position bits)
//   MODE 2 level subset: one thread per (draw, point); draw r's level
//     (_draw_levels with _DENSE_GL_SALT), its cotangent taken along the
//     level axis (take_along_axis), entry (r*8 + c)*N + n = (w*g)*scale
//     with f32 weights and scale = Ld/gd
template <bool BF16, int MODE>
__global__ void __launch_bounds__(THREADS)
dense_levels_bwd_kernel(const void* __restrict__ g, int64_t gs, const float* __restrict__ xs,
                        const float* __restrict__ ys, const float* __restrict__ zs, int64_t N,
                        int Ld, int gd, float scale, DenseLevels L, int32_t* __restrict__ idx,
                        float* __restrict__ v0, float* __restrict__ v1) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  int64_t rows = MODE == 2 ? gd : Ld;
  if (t >= rows * N) return;
  int r = static_cast<int>(t / N);
  int64_t n = t - r * N;
  float x = xs[n], y = ys[n], z = zs[n];
  int l = MODE == 2 ? draw_level(position_seed(x, y, z, DENSE_GL_SALT), r, Ld) : r;
  float g0 = load_g<BF16>(g, l * N + n), g1 = load_g<BF16>(g, gs + l * N + n);
  int bx, by, bz;
  float tx, ty, tz;
  dense_axis(x, L.scale[l], L.res[l], bx, tx);
  dense_axis(y, L.scale[l], L.res[l], by, ty);
  dense_axis(z, L.scale[l], L.res[l], bz, tz);
  if (MODE == 1) {
    int c = draw_corner(tx, ty, tz, position_seed(x, y, z, DENSE_SALT), l);
    idx[t] = static_cast<int32_t>(dense_index(L, l, bx, by, bz, c));
    v0[t] = g0;
    v1[t] = g1;
    return;
  }
  constexpr bool WBF16 = BF16 && MODE == 0;  // the level subset weights in f32
  tx = rnd<WBF16>(tx);
  ty = rnd<WBF16>(ty);
  tz = rnd<WBF16>(tz);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int64_t k = (static_cast<int64_t>(r) * 8 + c) * N + n;
    float w = corner_weight<WBF16>(c, tx, ty, tz);
    idx[k] = static_cast<int32_t>(dense_index(L, l, bx, by, bz, c));
    if (MODE == 0) {
      v0[k] = rnd<BF16>(__fmul_rn(g0, w));
      v1[k] = rnd<BF16>(__fmul_rn(g1, w));
    } else {
      v0[k] = __fmul_rn(__fmul_rn(w, g0), scale);
      v1[k] = __fmul_rn(__fmul_rn(w, g1), scale);
    }
  }
}

// K4, k >= 2 (leader + residual), K = k corners. words: the dense columns
// packed into bf16 pairs (pack_pairs_bf16_kernel, run in front); out:
// [2, Ld, N] in f32 or bf16, plane stride os; sel (optional): [K, Ld, N]
// int32, the plan's entries (leader first), written only when asked for.
// One thread per (level, point) on a 2-D grid (blockIdx.y the level), as
// K1 k >= 2: the clamped f32 weights (_corner_weights(clamp=True)), the
// leader + residual plan with DENSE_SALT, then all K planned words loaded
// together, summed e = f_0*w_m, e += f_j*coef_r in j order in f32 and
// stored in out's type.
template <int K, typename OutT>
__global__ void __launch_bounds__(THREADS)
dense_levels_fwd_lr_kernel(const uint32_t* __restrict__ words, const float* __restrict__ xs,
                           const float* __restrict__ ys, const float* __restrict__ zs, int N, DenseLevels L,
                           float rinv, OutT* __restrict__ out, int64_t os, int32_t* __restrict__ sel) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int l = blockIdx.y;
  const float x = xs[n], y = ys[n], z = zs[n];
  const int r = L.res[l];
  int bx, by, bz;
  float tx, ty, tz;
  dense_axis(x, L.scale[l], r, bx, tx);
  dense_axis(y, L.scale[l], r, by, ty);
  dense_axis(z, L.scale[l], r, bz, tz);
  const int i0 = static_cast<int>(L.offset[l]) + bx + by * r + bz * r * r;
  LeaderPlan p;
  leader_plan(tx, ty, tz, p);
  const uint32_t seed = position_seed(x, y, z, DENSE_SALT);
  int i[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = plan_corner(p, seed, l, j);
    i[j] = i0 + ((c >> 2) & 1) + ((c >> 1) & 1) * r + (c & 1) * r * r;
  }
  uint32_t w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = __ldg(words + i[j]);
  const float cr = __fmul_rn(p.cdfr[7], rinv);
  float e0 = __fmul_rn(__uint_as_float(w[0] << 16), p.wm), e1 = __fmul_rn(__uint_as_float(w[0] & 0xFFFF0000u), p.wm);
#pragma unroll
  for (int j = 1; j < K; ++j) {
    e0 = __fadd_rn(e0, __fmul_rn(__uint_as_float(w[j] << 16), cr));
    e1 = __fadd_rn(e1, __fmul_rn(__uint_as_float(w[j] & 0xFFFF0000u), cr));
  }
  const int64_t t = static_cast<int64_t>(l) * N + n;
  store_rn(out, t, e0);
  store_rn(out, os + t, e1);
  if (sel != nullptr) {
    const int64_t LN = static_cast<int64_t>(gridDim.y) * N;
#pragma unroll
    for (int j = 0; j < K; ++j) sel[j * LN + t] = i[j];
  }
}

// K5, b >= 2 (leader + residual): the dense levels' table gradient staged
// for K3. g as for K5. One thread per (level, point); entry (l*b + j)*N + n
// (level, draw, point order: neighbouring lanes are neighbouring points at
// the same level and draw, which K3's run merge sums) holds corner j of the
// plan (DENSE_SALT, clamped f32 weights) and g*coef_j in f32.
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
dense_levels_bwd_lr_kernel(const void* __restrict__ g, int64_t gs, const float* __restrict__ xs,
                           const float* __restrict__ ys, const float* __restrict__ zs, int64_t N, int Ld, int b,
                           float rinv, DenseLevels L, int32_t* __restrict__ idx, float* __restrict__ v0,
                           float* __restrict__ v1) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= Ld * N) return;
  const int l = static_cast<int>(t / N);
  const int64_t n = t - l * N;
  const float x = xs[n], y = ys[n], z = zs[n];
  const float g0 = load_g<BF16>(g, t), g1 = load_g<BF16>(g, gs + t);
  int bx, by, bz;
  float tx, ty, tz;
  dense_axis(x, L.scale[l], L.res[l], bx, tx);
  dense_axis(y, L.scale[l], L.res[l], by, ty);
  dense_axis(z, L.scale[l], L.res[l], bz, tz);
  LeaderPlan p;
  leader_plan(tx, ty, tz, p);
  const uint32_t seed = position_seed(x, y, z, DENSE_SALT);
  const float cr = __fmul_rn(p.cdfr[7], rinv);
  for (int j = 0; j < b; ++j) {
    const int64_t k = (static_cast<int64_t>(l) * b + j) * N + n;
    const float coef = j == 0 ? p.wm : cr;
    idx[k] = static_cast<int32_t>(dense_index(L, l, bx, by, bz, plan_corner(p, seed, l, j)));
    v0[k] = __fmul_rn(g0, coef);
    v1[k] = __fmul_rn(g1, coef);
  }
}

// -- the feature-last encode ---------------------------------------------------
//
// Per level, in the order of the planes: lattice scale, resolution, the
// offset of its table, and whether it is hashed (else dense).
struct GridLevels {
  float scale[MAX_LEVELS];
  int64_t offset[MAX_LEVELS];
  int res[MAX_LEVELS];
  int hashed[MAX_LEVELS];
};

// The entry of the planes that corner c of level l's cell (ix, iy, iz)
// reads: the masked uint32 hash plus the level's offset, or (dense) each
// corner coordinate clipped to [0, r-1] (hashgrid_indices_and_weights)
__device__ __forceinline__ int64_t grid_index(const GridLevels& G, int l, int ix, int iy, int iz, int c,
                                              uint32_t mask) {
  if (G.hashed[l]) return hash_index(ix, iy, iz, c, mask) + G.offset[l];
  const int r = G.res[l];
  const int64_t cx = min(max(ix + ((c >> 2) & 1), 0), r - 1);
  const int64_t cy = min(max(iy + ((c >> 1) & 1), 0), r - 1);
  const int64_t cz = min(max(iz + (c & 1), 0), r - 1);
  return cx + cy * r + cz * (static_cast<int64_t>(r) * r) + G.offset[l];
}

// The cell of level l at point n of x01 [N, 3]: lattice coordinates and
// fractions (unclamped, as nerfjax's weights)
__device__ __forceinline__ void grid_cell(const GridLevels& G, int l, const float* __restrict__ x01, int64_t n,
                                          int& ix, int& iy, int& iz, float& tx, float& ty, float& tz) {
  const float s = G.scale[l];
  lattice(x01[3 * n], s, ix, tx);
  lattice(x01[3 * n + 1], s, iy, ty);
  lattice(x01[3 * n + 2], s, iz, tz);
}

// The forward's sum at one (point, level): sum over the corners, in order,
// of f_c * w_c from +0 in f32, each product and sum rounded on its own.
__device__ __forceinline__ float2 grid_blend(const float2 (&f)[8], float tx, float ty, float tz) {
  float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = corner_weight(c, tx, ty, tz);
    e0 = __fadd_rn(e0, __fmul_rn(f[c].x, w));
    e1 = __fadd_rn(e1, __fmul_rn(f[c].y, w));
  }
  return make_float2(e0, e1);
}

constexpr int FWD_POINTS = 64;  // the points of one block of the feature-last forward

// out[n, l] and out[n, L + l] = sum over the corners, in order, of
// plane_p[i_c] * w_c, from +0 in f32 (grid_blend). pairs: [total] float2,
// the two planes packed (pack_pairs_f32_kernel): one 8-byte load a corner;
// x01 [N, 3]; out [N, 2L] f32. A block takes FWD_POINTS consecutive points
// and all L levels: it stages their positions in shared memory, then each
// warp takes (32 points, one level) tasks, its lanes 32 consecutive points
// at one level (neighbouring samples of a ray, which share cells at the
// coarse levels, so one load instruction's lanes share sectors), and puts
// the two sums in a [FWD_POINTS, 2L] shared tile (an odd row stride: the
// 32 lanes' stores hit 32 banks). The tile is then written as the block's
// contiguous rows of out.
__global__ void __launch_bounds__(THREADS)
hashgrid_fwd_kernel(const float2* __restrict__ pairs, const float* __restrict__ x01, int64_t N, int L, GridLevels G,
                    uint32_t mask, float* __restrict__ out) {
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
    for (int c = 0; c < 8; ++c) f[c] = __ldg(pairs + grid_index(G, l, ix, iy, iz, c, mask));
    const float2 v = grid_blend(f, tx, ty, tz);
    tile[p * stride + l] = v.x;
    tile[p * stride + L + l] = v.y;
  }
  __syncthreads();
  for (int p = warp; p < np; p += THREADS / 32) {
    for (int c = lane; c < row; c += 32) out[(p0 + p) * row + c] = tile[p * stride + c];
  }
}

// gT[l*N + n] = (g[n, l], g[n, L + l]): the cotangent [N, 2L] f32 as
// [L, N] float2, so that the backward's lanes (neighbouring points at one
// level) read it coalesced. A block takes 32 points' rows (contiguous)
// through shared memory (an odd row stride) and writes L rows of 32.
__global__ void __launch_bounds__(THREADS)
hashgrid_cotangent_kernel(const float* __restrict__ g, int N, int L, float2* __restrict__ gT) {
  __shared__ float s[32 * (2 * MAX_LEVELS + 1)];
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * 32;
  const int rows = static_cast<int>(N - n0 < 32 ? N - n0 : 32), row = 2 * L, stride = row + 1;
  for (int i = threadIdx.x; i < rows * row; i += THREADS) s[(i / row) * stride + i % row] = g[n0 * row + i];
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * L; i += THREADS) {
    const int l = i >> 5, p = i & 31;
    if (p < rows) gT[static_cast<int64_t>(l) * N + n0 + p] = make_float2(s[p * stride + l], s[p * stride + L + l]);
  }
}

// The table gradient from the cotangent gT [L, N] float2 (above):
// g[n, l] * w_c and g[n, L + l] * w_c added to corner c's entry, for every
// (level, point) and corner. One thread per (level, point) on a 2-D grid
// (blockIdx.y the level: level-major, so that about one level's entries of
// the scratch are live in the L2 at a time), the cell and weights
// recomputed from x01. Per corner, the lanes of a warp whose entries are
// equal in a row (neighbouring samples of one ray in one cell) sum their
// terms (merge_run) and each run's last lane adds both sums with one float2
// atomic into scratch, the zeroed interleaved [total, 2], unless both sums
// are 0 (adding 0 changes no entry); a warp whose g are all 0 adds nothing.
// scratch_fold_kernel then adds scratch into the [2, total] gradient. Lanes
// past N take part in the shuffles with no add.
__global__ void __launch_bounds__(THREADS)
hashgrid_bwd_kernel(const float2* __restrict__ gT, const float* __restrict__ x01, int N, GridLevels G,
                    uint32_t mask, float2* __restrict__ scratch) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int l = blockIdx.y;
  const bool live = n < N;
  const float2 gv = live ? gT[static_cast<int64_t>(l) * N + n] : make_float2(0.0f, 0.0f);
  if (__ballot_sync(FULL_WARP, gv.x != 0.0f || gv.y != 0.0f) == 0) return;
  int ix = 0, iy = 0, iz = 0;
  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  if (live) grid_cell(G, l, x01, n, ix, iy, iz, tx, ty, tz);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int64_t i = -1;  // -1: no add
    float v0 = 0.0f, v1 = 0.0f;
    if (live) {
      const float w = corner_weight(c, tx, ty, tz);
      i = grid_index(G, l, ix, iy, iz, c, mask);
      v0 = __fmul_rn(gv.x, w);
      v1 = __fmul_rn(gv.y, w);
    }
    if (merge_run(i, v0, v1) && i >= 0 && (v0 != 0.0f || v1 != 0.0f)) atomicAdd(scratch + i, make_float2(v0, v1));
  }
}

unsigned blocks(int64_t work) { return static_cast<unsigned>((work + THREADS - 1) / THREADS); }

// blocks of a grid-stride pass over T entries (the pack, the fold): at
// least one, at most 4096
unsigned stride_blocks(int64_t T) { return blocks(T) < 1 ? 1 : blocks(T) < 4096 ? blocks(T) : 4096; }

bool fill_levels(Levels& L, int Lh, const float* scales, const int64_t* offsets) {
  if (Lh < 1 || Lh > MAX_LEVELS) return false;
  for (int l = 0; l < Lh; ++l) {
    L.scale[l] = scales[l];
    L.offset[l] = offsets[l];
  }
  return true;
}

bool fill_dense_levels(DenseLevels& L, int Ld, const float* scales, const int32_t* res,
                       const int64_t* offsets) {
  if (Ld < 1 || Ld > MAX_LEVELS) return false;
  for (int l = 0; l < Ld; ++l) {
    if (res[l] < 2) return false;
    L.scale[l] = scales[l];
    L.res[l] = res[l];
    L.offset[l] = offsets[l];
  }
  return true;
}

bool fill_grid_levels(GridLevels& G, int L, const float* scales, const int64_t* offsets, const int32_t* res,
                      const int32_t* hashed) {
  if (L < 1 || L > MAX_LEVELS) return false;
  for (int l = 0; l < L; ++l) {
    if (res[l] < 1) return false;
    G.scale[l] = scales[l];
    G.offset[l] = offsets[l];
    G.res[l] = res[l];
    G.hashed[l] = hashed[l];
  }
  return true;
}

}  // namespace

extern "C" int nerf_hash_max_levels() { return MAX_LEVELS; }

// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for a
// level count outside 1..MAX_LEVELS, k outside 1..8, or total or N >= 2^31
// under k < 8). k: the corners, 8 exact, 1 k = 1, 2..7 leader + residual
// with rinv = f32(1/(k-1)). out: [2, Lh, N] in bf16 (out_bf16) or f32,
// plane stride os, level stride N. sel (optional, k < 8): [Lh, N] (k = 1)
// or [k, Lh, N] int32. k >= 2 (exact and leader + residual): words, a
// [total - base] uint32 buffer that the pack fills and K1 reads.
extern "C" int nerf_hash_levels_fwd(const float* planes, int64_t total, int64_t base,
                                    const float* x, const float* y, const float* z, int64_t N,
                                    int Lh, const float* scales, const int64_t* offsets,
                                    uint32_t mask, int k, float rinv, void* out, int64_t os, int out_bf16,
                                    int32_t* sel, uint32_t* words, void* stream) {
  Levels L;
  if (!fill_levels(L, Lh, scales, offsets) || k < 1 || k > 8 || (k >= 2 && words == nullptr) ||
      (k < 8 && (total >= (int64_t{1} << 31) || N >= (int64_t{1} << 31)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* o16 = static_cast<__nv_bfloat16*>(out);
  float* o32 = static_cast<float*>(out);
  const int64_t T = total - base;
  if (k >= 2) {
    pack_pairs_bf16_kernel<<<stride_blocks((T + 3) / 4), THREADS, 0, s>>>(planes + base, planes + total + base, T,
                                                                       words);
  }
  if (k == 8) {
    if (out_bf16) {
      hash_levels_fwd_exact_kernel<<<blocks(Lh * N), THREADS, 0, s>>>(words, x, y, z, N, Lh, L, mask, o16, os);
    } else {
      hash_levels_fwd_exact_kernel<<<blocks(Lh * N), THREADS, 0, s>>>(words, x, y, z, N, Lh, L, mask, o32, os);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int n = static_cast<int>(N);
  const dim3 grid(blocks(N), Lh);
  if (k == 1) {
    const int t = static_cast<int>(total), b = static_cast<int>(base);
    if (out_bf16) {
      hash_levels_fwd_k1_kernel<<<grid, THREADS, 0, s>>>(planes, t, b, x, y, z, n, L, mask, o16, os, sel);
    } else {
      hash_levels_fwd_k1_kernel<<<grid, THREADS, 0, s>>>(planes, t, b, x, y, z, n, L, mask, o32, os, sel);
    }
    return static_cast<int>(cudaGetLastError());
  }
#define NERF_K1_LR(K)                                                                                           \
  case K:                                                                                                       \
    if (out_bf16) {                                                                                             \
      hash_levels_fwd_lr_kernel<K><<<grid, THREADS, 0, s>>>(words, x, y, z, n, L, mask, rinv, o16, os, sel);    \
    } else {                                                                                                    \
      hash_levels_fwd_lr_kernel<K><<<grid, THREADS, 0, s>>>(words, x, y, z, n, L, mask, rinv, o32, os, sel);    \
    }                                                                                                           \
    break
  switch (k) {
    NERF_K1_LR(2);
    NERF_K1_LR(3);
    NERF_K1_LR(4);
    NERF_K1_LR(5);
    NERF_K1_LR(6);
    NERF_K1_LR(7);
  }
#undef NERF_K1_LR
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 exact, 1 b planned corners per level, 2 the same over gl drawn
// levels scaled by `scale`; b: 1 (k = 1) or 2..7 (leader + residual, rinv =
// f32(1/(b-1)); in mode 1, N < 2^31). g: bf16 (g_bf16) or f32, plane
// stride gs. Exact only:
// scratch, a zeroed [total - base, 2] f32 buffer, which K2 exact adds into
// and the fold kernel launched after it adds into grad.
extern "C" int nerf_hash_levels_bwd(const void* g, int64_t gs, int g_bf16, int64_t total, int64_t base,
                                    const float* x, const float* y, const float* z, int64_t N, int Lh,
                                    const float* scales, const int64_t* offsets, uint32_t mask,
                                    int mode, int gl, float scale, int b, float rinv, float* grad,
                                    float* scratch, void* stream) {
  Levels L;
  if (!fill_levels(L, Lh, scales, offsets) || mode < 0 || mode > 2 || (mode == 2 && gl < 1) ||
      (mode == 0 && scratch == nullptr) || (mode != 0 && (b < 1 || b > 7))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    float2* sc = reinterpret_cast<float2*>(scratch);
    const int64_t T = total - base;
    if (g_bf16) {
      hash_levels_bwd_exact_kernel<true><<<blocks(Lh * N), THREADS, 0, s>>>(g, gs, x, y, z, N, Lh, L, mask, T, sc);
    } else {
      hash_levels_bwd_exact_kernel<false><<<blocks(Lh * N), THREADS, 0, s>>>(g, gs, x, y, z, N, Lh, L, mask, T, sc);
    }
    scratch_fold_kernel<<<stride_blocks(T), THREADS, 0, s>>>(sc, T, total, base, grad);
    return static_cast<int>(cudaGetLastError());
  }
  const int rows = mode == 2 ? gl : Lh;
  if (b >= 2 && mode == 1) {
    if (N >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(blocks(N), Lh);
    const int n = static_cast<int>(N);
    if (g_bf16) {
      hash_levels_bwd_lr_kernel<true><<<grid, THREADS, 0, s>>>(g, gs, total, base, x, y, z, n, b, rinv, L, mask, grad);
    } else {
      hash_levels_bwd_lr_kernel<false><<<grid, THREADS, 0, s>>>(g, gs, total, base, x, y, z, n, b, rinv, L, mask, grad);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (b >= 2) {
    if (g_bf16) {
      hash_levels_bwd_lr_gl_kernel<true><<<blocks(N), THREADS, 0, s>>>(g, gs, total, base, x, y, z, N, Lh, gl, scale,
                                                                      b, rinv, L, mask, grad);
    } else {
      hash_levels_bwd_lr_gl_kernel<false><<<blocks(N), THREADS, 0, s>>>(g, gs, total, base, x, y, z, N, Lh, gl, scale,
                                                                       b, rinv, L, mask, grad);
    }
    return static_cast<int>(cudaGetLastError());
  }
#define NERF_K2_K1(M, G) \
  hash_levels_bwd_kernel<M, G><<<blocks(N), THREADS, 0, s>>>(g, gs, total, base, x, y, z, N, Lh, rows, scale, L, \
                                                              mask, grad)
  if (mode == 1) {
    if (g_bf16) NERF_K2_K1(1, true); else NERF_K2_K1(1, false);
  } else {
    if (g_bf16) NERF_K2_K1(2, true); else NERF_K2_K1(2, false);
  }
#undef NERF_K2_K1
  return static_cast<int>(cudaGetLastError());
}

// out: plane 0 at out[0..T), plane 1 at out[stride..stride + T); scratch: a
// zeroed [T, 2] f32 buffer that K3 adds into and the fold kernel launched
// after it adds into out.
extern "C" int nerf_table_grad_scatter(const int32_t* idx, const float* g0, const float* g1,
                                       int64_t K, int64_t T, int64_t stride, float* out, float* scratch,
                                       void* stream) {
  if (scratch == nullptr || stride < T) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* sc = reinterpret_cast<float2*>(scratch);
  table_grad_scatter_kernel<<<blocks(K), THREADS, 0, s>>>(idx, g0, g1, K, T, sc);
  scratch_fold_kernel<<<stride_blocks(T), THREADS, 0, s>>>(sc, T, stride, 0, out);
  return static_cast<int>(cudaGetLastError());
}

// words[i] = the pair of p0[i], p1[i] for i < T: a bf16 pair (f32 = 0;
// plane 0 in the low half) or a float2 (f32 = 1). K4's table.
extern "C" int nerf_pack_pairs(const float* p0, const float* p1, int64_t T, int f32, void* words,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    pack_pairs_f32_kernel<<<stride_blocks(T), THREADS, 0, s>>>(p0, p1, T, static_cast<float2*>(words));
  } else {
    pack_pairs_bf16_kernel<<<stride_blocks((T + 3) / 4), THREADS, 0, s>>>(p0, p1, T, static_cast<uint32_t*>(words));
  }
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 exact in f32, 1 exact in bf16, 2 k = 1, 3 k corners (2..7,
// leader + residual, rinv = f32(1/(k-1))); sel optional in modes 2 and 3
// ([Ld, N], [k, Ld, N]); pairs: the dense columns packed by nerf_pack_pairs
// (float2 in mode 0, bf16 pairs otherwise); out: [2, Ld, N] in bf16
// (out_bf16: modes 1-3) or f32 (modes 0, 2 and 3), plane stride os, level
// stride N; mode 3 needs N < 2^31
extern "C" int nerf_dense_levels_fwd(const void* pairs, const float* x, const float* y, const float* z,
                                     int64_t N, int Ld, const float* scales, const int32_t* res,
                                     const int64_t* offsets, int mode, int k, float rinv, void* out, int64_t os,
                                     int out_bf16, int32_t* sel, void* stream) {
  DenseLevels L;
  if (!fill_dense_levels(L, Ld, scales, res, offsets) || mode < 0 || mode > 3 || (mode == 0 && out_bf16) ||
      (mode == 1 && !out_bf16) || (mode == 3 && (k < 2 || k > 7 || N >= (int64_t{1} << 31)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = blocks(N);
  __nv_bfloat16* o16 = static_cast<__nv_bfloat16*>(out);
  float* o32 = static_cast<float*>(out);
  if (mode == 0) {
    dense_levels_fwd_kernel<0><<<nb, THREADS, 0, s>>>(pairs, x, y, z, N, Ld, L, o32, os, sel);
  } else if (mode == 1) {
    dense_levels_fwd_kernel<1><<<nb, THREADS, 0, s>>>(pairs, x, y, z, N, Ld, L, o16, os, sel);
  } else if (mode == 2 && out_bf16) {
    dense_levels_fwd_kernel<2><<<nb, THREADS, 0, s>>>(pairs, x, y, z, N, Ld, L, o16, os, sel);
  } else if (mode == 2) {
    dense_levels_fwd_kernel<2><<<nb, THREADS, 0, s>>>(pairs, x, y, z, N, Ld, L, o32, os, sel);
  } else {
    const dim3 grid(nb, Ld);
    const int n = static_cast<int>(N);
    const uint32_t* words = static_cast<const uint32_t*>(pairs);
#define NERF_K4_LR(K)                                                                                           \
  case K:                                                                                                       \
    if (out_bf16) {                                                                                             \
      dense_levels_fwd_lr_kernel<K><<<grid, THREADS, 0, s>>>(words, x, y, z, n, L, rinv, o16, os, sel);         \
    } else {                                                                                                    \
      dense_levels_fwd_lr_kernel<K><<<grid, THREADS, 0, s>>>(words, x, y, z, n, L, rinv, o32, os, sel);         \
    }                                                                                                           \
    break
    switch (k) {
      NERF_K4_LR(2);
      NERF_K4_LR(3);
      NERF_K4_LR(4);
      NERF_K4_LR(5);
      NERF_K4_LR(6);
      NERF_K4_LR(7);
    }
#undef NERF_K4_LR
  }
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 exact, 1 b planned corners (b = 1: k = 1; 2..7: leader +
// residual, rinv = f32(1/(b-1))), 2 gd drawn levels scaled by `scale`;
// g_bf16: g holds bf16 (else f32)
extern "C" int nerf_dense_levels_bwd(const void* g, int64_t gs, int g_bf16, const float* x,
                                     const float* y, const float* z, int64_t N, int Ld,
                                     const float* scales, const int32_t* res,
                                     const int64_t* offsets, int mode, int gd, float scale, int b, float rinv,
                                     int32_t* idx, float* v0, float* v1, void* stream) {
  DenseLevels L;
  if (!fill_dense_levels(L, Ld, scales, res, offsets) || mode < 0 || mode > 2 ||
      (mode == 2 && gd < 1) || (mode == 1 && (b < 1 || b > 7))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1 && b >= 2) {
    if (g_bf16) {
      dense_levels_bwd_lr_kernel<true><<<blocks(Ld * N), THREADS, 0, s>>>(g, gs, x, y, z, N, Ld, b, rinv, L, idx,
                                                                          v0, v1);
    } else {
      dense_levels_bwd_lr_kernel<false><<<blocks(Ld * N), THREADS, 0, s>>>(g, gs, x, y, z, N, Ld, b, rinv, L, idx,
                                                                           v0, v1);
    }
    return static_cast<int>(cudaGetLastError());
  }
  unsigned nb = blocks((mode == 2 ? gd : Ld) * N);
#define NERF_DENSE_BWD(B, M)                                                                \
  dense_levels_bwd_kernel<B, M><<<nb, THREADS, 0, s>>>(g, gs, x, y, z, N, Ld, gd, scale, L, \
                                                       idx, v0, v1)
  if (g_bf16) {
    if (mode == 0) NERF_DENSE_BWD(true, 0);
    else if (mode == 1) NERF_DENSE_BWD(true, 1);
    else NERF_DENSE_BWD(true, 2);
  } else {
    if (mode == 0) NERF_DENSE_BWD(false, 0);
    else if (mode == 1) NERF_DENSE_BWD(false, 1);
    else NERF_DENSE_BWD(false, 2);
  }
#undef NERF_DENSE_BWD
  return static_cast<int>(cudaGetLastError());
}

// The feature-last encode's forward: out [N, 2L] f32 (row-major) from the
// [total] float2 pairs (nerf_pack_pairs with f32 = 1 over the [2, total]
// planes) and x01 [N, 3]. Levels as fill_grid_levels takes them (every
// level, in the planes' order); mask = hashmap size - 1.
extern "C" int nerf_hashgrid_fwd(const void* pairs, const float* x01, int64_t N, int L, const float* scales,
                                 const int64_t* offsets, const int32_t* res, const int32_t* hashed, uint32_t mask,
                                 float* out, void* stream) {
  GridLevels G;
  if (!fill_grid_levels(G, L, scales, offsets, res, hashed)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nb = static_cast<unsigned>((N + FWD_POINTS - 1) / FWD_POINTS);
  hashgrid_fwd_kernel<<<nb, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float2*>(pairs), x01,
                                                                             N, L, G, mask, out);
  return static_cast<int>(cudaGetLastError());
}

// Its table gradient from the cotangent g [N, 2L] f32 (row-major), added
// into grad [2, total] f32: g transposed into gT, an [L, N, 2] f32 buffer,
// then added through scratch, a zeroed [total, 2] f32 buffer; N < 2^31.
extern "C" int nerf_hashgrid_bwd(const float* g, const float* x01, int64_t N, int L, const float* scales,
                                 const int64_t* offsets, const int32_t* res, const int32_t* hashed, uint32_t mask,
                                 int64_t total, float* grad, float* gT, float* scratch, void* stream) {
  GridLevels G;
  if (!fill_grid_levels(G, L, scales, offsets, res, hashed) || N >= (int64_t{1} << 31) || gT == nullptr ||
      scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* gt = reinterpret_cast<float2*>(gT);
  float2* sc = reinterpret_cast<float2*>(scratch);
  const int n = static_cast<int>(N);
  hashgrid_cotangent_kernel<<<static_cast<unsigned>((N + 31) / 32), THREADS, 0, s>>>(g, n, L, gt);
  hashgrid_bwd_kernel<<<dim3(blocks(N), L), THREADS, 0, s>>>(gt, x01, n, G, mask, sc);
  scratch_fold_kernel<<<stride_blocks(total), THREADS, 0, s>>>(sc, total, total, 0, grad);
  return static_cast<int>(cudaGetLastError());
}
