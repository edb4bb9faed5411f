#!/usr/bin/env python3
"""Smoke run of nerfjax_torch on one CUDA card, at the full width of the
models of cfg/blender_scene_tuned.yml, cfg/blender_scene_fast.yml and
cfg/blender_scene.yml: the extraction path (checkpoint -> 512^3
volume.pth), the training paths (ray NPZ -> tuned and fast single-pass
train steps, and the drop-in coarse->pdf->fine steps -> nerf_final.pth),
the tail (volume.pth -> volume_sliced.pth -> tif/vti), held-out eval
rendering, and micro_probe.py's probes.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero before the
final line:

  1. the card (nvidia-smi name and power limit); no CUDA -> exit 1;
  2. build the CUDA kernels from nerfjax_torch/csrc, one nvcc per source,
     all at once (ptxas report);
  3. the MLP kernels against their plain PyTorch versions at the
     extraction's shapes (N = 524,288 and 1,000,003; E = 24, 32, 40 and
     64; bf16 and f32; f32 also at E = 128), with per-call times;
  4. a synthetic NGP-large checkpoint (seeded sphere field, written with
     nerfjax_torch.checkpoint.save_field_params) ->
     nerfjax_torch.extract.extract_volume at 512^3 on the card ->
     save_volume -> load_volume; checks the volume and that the MLP kernels
     and the hashed- and dense-level forwards launched;
  5. the same extraction at 128^3 in float32 on the card (kernels) and on
     the CPU (plain versions), held to the CPU parity tests' rule;
  6. the hash-encode kernels against their plain versions at the tuned
     spec on seeded inputs: the hashed-level forward (exact at N = 524,288
     and 1,000,003, k = 1 at 196,608 with its plan; timed), its table
     gradient (exact, k = 1, k = 1 over 2 levels), the table-gradient
     scatter (also timed beside index_add_ at the micro-benchmark's
     T = 2^19, K = 4,194,304, an extra line), the dense-level forward
     (exact in f32 and bf16 at N = 196,608 and 524,288, k = 1 with its
     plan; bit for bit; timed) and its gradient staging (exact in bf16 and
     f32, over 1 and 2 drawn levels, k = 1; torch.equal; K3 on each output
     within the atomic-order bound; timed);
  7. training at full width: a seeded synthetic ray NPZ (2^20 rays from
     cameras around an analytic sphere) -> nerfjax_torch.train.train (the
     function the CLI calls) for 3 epochs of 128 steps at batch 8192;
     checks PSNR, NaNs, the five hash kernels' launches and nerf_final.pth;
     then times warm steps (median ms/step, the split by stage, a
     torch.profiler idle share) and captures the inputs of the dense-level
     and table-gradient kernels in one more step; those kernels are held
     against their plain versions on the step's own inputs and timed there,
     beside index_add_ for the scatter;
  7b. the same training, 128 steps, with hash_dense_grad_levels: 1 and
     then with hash_dense_corners: 1, on the same NPZ: PSNR, NaNs, the
     dense kernels' launches and mode, a warm-step median;
  8. the trained checkpoint extracted at 256^3: occupied voxels against the
     analytic sphere (IoU >= 0.5);
  9. one train step at the CPU tests' small size in float32, card against
     CPU, with the same draws: the tuned estimators, then with each dense
     knob.

Added for the hierarchical path, each printed as it ends:

  P. micro_probe.py's entry point through nerfjax_torch.probes.main on the
     card (after phase 6); then its six kernels against their plain
     versions (equal; the dots within K*2^-24*sum|a||b|), timed beside
     their bounds and torch.matmul / x.t().to(float32) where one call
     computes the same function;
  7c. drop-in training at full width: cfg/blender_scene.yml's model and
     training keys (NGP-large, 16 levels: 4 dense + 12 hashed, E = 32;
     64 + 128 samples, no grid, exact, bf16, batch 8192) through train()
     for 128 steps on phase 7's NPZ: PSNR, NaNs, the coarse loss, K1-K5
     launched twice per step; a warm median, the split by stage, the idle
     share, peak memory; every hash kernel on one warm step's inputs (each
     pass) against its plain version, timed at the fine pass;
  8b. eval rendering: render_image of phase 7's trained ball and of the
     drop-in trained ball (E = 32) on the card at 256 x 256 from 3 held-out
     orbit poses, at 64 + 128 (PSNR against the analytic ball >= 25 dB;
     head kernel launched; rays/s) and at the tuned 8 + 16 (printed); the
     head, K1 and K4 against their plain versions on the 64 + 128
     render's own calls (each pass), the head timed at the fine pass;
  9b. one drop-in step at the CPU tests' small size and one 32 x 32 render
     in float32, card against CPU, with the same draws.

Added for the kernel redesigns (the dot, K2 exact):

  P. also each dot's max error as a fraction of K*2^-24*sum|a||b|;
  7c. K2 exact timed at both drop-in passes beside the atomics it issues
     (the first design's 16*Lh*N float adds, k2_atomic_count's float2
     runs).

Added for the wide heads and the redesigns of K3 and K1 exact:

  3. also at E = 40 and 64 (two 32-row chunks of W1; timed at N =
     524,288, extra lines), and at E = 24 and 32 the outputs' digests
     against HEAD_DIGESTS, those of the kernels before the chunked layout;
  4. K1 exact equal to its plain version on the 512^3 extraction's calls;
  7, 7b, 7c. K3's merged float2 adds (k3_atomic_count) beside the first
     design's 2*K float adds at every captured pass; K1 exact and K3 timed
     at both drop-in passes;
  P. the bf16 dot also beside casts + bf16 torch.matmul (the function it
     computes from its f32 inputs), the matmul on bf16 inputs an extra
     line.

Added for the MLP heads on the tensor cores (the bf16 head and density
kernels on mma.sync, f32 activations split into three bf16 terms):

  3. the bf16 kernels within one bf16 ulp of plain at every shape, with
     the share of bf16 outputs bit-equal to plain and the largest error in
     bf16 ulps; HEAD_DIGESTS' bf16 entries are the redesigned kernels'
     (the f32 ones unchanged); the head also timed at E = 32; each
     kernel's dynamic shared memory;
  8b. the 64 + 128 eval frame of each pose split by stage with CUDA
     events around the render's own calls: rays and the stratified
     sample, coarse encode, coarse head, composite + sample_pdf + sort,
     fine encode, fine head, composite, the host's remainder.

Added for the redesigns of K4 (pair-packed table, one thread per point)
and K2 k = 1 (one thread per point, the cotangent read in place):

  4, 6, 7, 7b, 7c, 8b. K4 held bit for bit and timed at every main-path
     call: the 512^3 extraction's (new: its own calls held to plain), the
     tuned, dgl1 and dc1 steps', both drop-in passes', the eval renders'
     coarse and fine passes', and exact f32 at the step's N on seeded
     positions; its table pass (pack_pairs) held word for word and timed
     at the tuned step and the drop-in fine pass on copies of the columns
     that the L2 cannot hold all of (so its bytes bound holds), beside one
     PyTorch call of the same function, a kernel of its own in the
     kernels line;
  7, 7c. K2 and K3 timed net of the caller's zero fill of the columns they
     add into, the fill alone and fill + kernel (the figure these lines
     printed before) beside it; K2's net bound counts positions, the g rows it reads and 8
     B per distinct entry it adds to; one traced warm tuned and drop-in
     step each must show no copy of the hashed levels' cotangent inside
     the encode's backward.
  Every device time comes from a profiler trace that holds every call's
  device events, the calls between spin kernels that take the loss of a
  trace's first or last few events (a trace that drops any of the calls'
  is taken again).

Added for the redesign of K1 k = 1 (one thread per point over its levels)
and the encode's forward in one buffer (K4 and K1 write their rows of the
[2, L, N] output in its dtype):

  7, 7b. K1 k = 1 held to plain (output and plan, through sel) and timed at
     the tuned, dgl1 and dc1 steps' captured calls and at the occupancy
     grid update's call (N = 128^3 / 4, recorded in one update of the warm
     state), each beside its bound with the output it writes and with a
     float32 output; where the encode handed K1 a slice of its output the
     kernel writes into a fresh one of the same dtype and strides;
  7, 7c. one traced warm tuned and drop-in step each must show no
     aten::cat and no cast of a [2, Lh, N] part inside the encode's
     forward;
  P. the launch floor (a one-element kernel's device time) beside every
     probe's bound, which falls below it.

Added for the leader + residual estimators (k >= 2 in K1, K2, K4 and K5)
and the chain's tail:

  L. (after P) K1, K2, K4 and K5 (+ K3) at k = 2, 3 and 7 at the fast
     cfg's spec on seeded positions with the plan's edge cases (8-way
     ties, total = 0): K1 and K4 with torch.equal, output and plan (sel);
     K2 (all levels, 2 drawn levels, under the exact forward) and K3 on
     K5's staging within the atomic-order bound, K5 with torch.equal;
  7d. cfg/blender_scene_fast.yml's model and estimators at full width (16
     levels of 2^19, 16 + 32 samples, batch 8192, bf16, exact forward,
     k = 2 table gradient) through train() for 128 steps on phase 7's NPZ:
     PSNR of the first and last 20 steps (the last >= 30 dB), NaNs,
     launches, K2 planning b = 2; a warm median, the device busy time of 8
     warm steps, and every hash kernel on one warm step's captured calls
     against its plain version, K2 k = 2 timed there beside its bound;
  7e. the k2 knob: the tuned cfg with fwd, grad and dense corners 2 and
     gl 2, 32 train steps (launches counted from 0 around them), then K1
     k = 2, K4 k = 2, K5 b = 2 and K2 b = 2 over 2 levels on one step's
     captured calls against their plain versions, each timed there;
  8c. the tail: the trained tuned ball extracted at 512^3 on the card,
     then nerfjax_torch.cli.post_process_vol's and write_format's main()
     on it (host code); volume_sliced.pth and the six tif/tiff/vti files
     read back and held to the sliced points and their voxels; each
     stage's seconds;
  9. also one small step with the fast estimators, card against CPU, in
     float32 (phase 9's rule) and in bf16 (the CPU tests' bf16 step
     bound).

Added for the fast op point's quality and the redesign of K2 b >= 2:

  Q. (after 7e) the quality phase: benchmarks/psnr_parity.py's protocol on
     the port (parity_cfg: arms spass2, the fast cfg's estimators, and
     spass8, the exact gradient; NGP-medium, batch 2048, 600 steps on
     tests/synthetic.make_ray_npz's sphere, seeds 0-2; eval at 64 + 128 on
     4,096 held-out rays of seed 9999): each run's eval PSNR beside
     nerfjax's recorded one, each arm's mean and its verdict against
     nerfjax's three-seed range (reported; a run below
     PARITY_RUN_FLOOR_DB or not finite, or an arm mean below
     PARITY_FLOOR_DB, fails). Alone: python3 chip_smoke.py --only quality
     [--seeds 0-7];
  7d. every hash kernel timed at the fast step's captured call, K2 b = 2
     beside its adds (k2_lr_atomic_count) and the first design's 2*b*Lh*N;
  every timing: a (p, k, k, p) set whose two kernel or two plain runs
     differ by more than TIMING_AGREE is taken again, up to TIMING_SETS
     sets, every run printed, the medians reported.

Added for the redesigns of K1 k >= 2 (on the packed bf16-pair words) and
K2 b >= 2 over gl drawn levels (terms of 0 left out):

  7, 7b, 7c, 7d, 7e. the share of the hashed levels' cotangent that is 0
     (values; (level, point) pairs 0 in both planes) at every captured
     step, a summary line, and the kernels line's cotangent_zero_share;
  7e. K2 over gl levels beside its adds (k2_lr_atomic_count: its terms
     that are not 0) and the first design's 2*b*gl*N.

Added for the redesign of K4 k >= 2 ((level, point) threads, k a template
parameter, the k loads in flight) and the chain's head (ray precompute and
the prefetch):

  3. the f32 head and density kernels timed at N = 524,288, E = 24 beside
     their plain versions and bounds (on no main path: launches 0);
  every K4 timing: its bound is that of the function (positions in, the
     touched entries once, the output at the size of the encode's dtype
     where the call wrote into its rows; k corners: with a float32 output
     beside it), not of the pack in front of the kernel, a choice of
     design; the call (pack included) and the kernel's own time net of the
     pack, from the same trace, both stand beside it; a time below its
     bound says so, and names the L2 as the cause only where the same call
     timed with the L2 flushed reads at or above it;
  L. K4 timed at k = 2, 3 and 7 into a bf16 output;
  7b. K5 at the dgl1 step also timed with the L2 flushed in front of every
     call (a device-to-device copy of twice the L2, left out of the time);
  7. train()'s wall per step of the tuned run (its batches fed by
     prefetch_to_device);
  S. alone (python3 chip_smoke.py --only steps): the warm step medians of
     the tuned, fast and drop-in cfgs (_warm_steps, a fresh state each)
     before and after a train() of the same cfg, and train()'s wall per
     step, so that a host-side change to train() (the prefetch) is read
     on the steps after it and beside the parent's in one call;
  H. (after 8c) the chain's head: 60 PNG frames of 800 x 800 in
     nerf_synthetic's train split's shape (precompute_scene) through
     python -m nerfjax_torch.cli.precompute_rays on the card: the rays
     kept, each stage's seconds, the wall and rays/s, the NPZ read back;
     4 frames on the card and on the CPU, masks equal, arrays within 1e-6.

Added for K6's exact cell-grid search and vanilla NeRF:

  C3/C4 K6 now takes its grid route at C3's cloud: every grid kernel
     launched by colmap2nerf (knn_bin, knn_scatter, knn_mark, knn_grid a
     level, knn_tail once), == plain, timed with its split (plan, sort,
     search, tail), the pairs its kernels tested and the bound of the
     function (n k pairs at 8 FP32 instructions a pair, 33.5 T/s with no
     FMA, or 16 n bytes; the bound of the tested pairs beside it); the
     brute kernel (knn_mean_dist, the first design) == plain and timed at
     the same cloud.
  K. (after C, knn_phase) K6 at 1,200,000 points of clustered_cloud
     (Gaussian blobs on a surface, 1 % planted outliers), == plain on 4,096
     seeded queries, timed with its split; the statistical filter on the
     all-coincident cloud of 303,000 points (the brute route: its
     launches counted from 0 around the call, every point kept), timed.
  V. (after the drop-in run, train_vanilla) vanilla NeRF at full width
     (pos_L 10, dir_L 4, hidden 256, 64 + 128 samples, batch 4096, bf16)
     through python -m nerfjax_torch.cli.train: 256 steps, PSNR first and
     last 20 steps (must rise), a warm median, the split by stage, the idle
     share, peak memory; the trained field extracted at 256^3 (IoU), then by
     the extract_vol CLI at 512^3 when that is predicted under 30 s; the
     render and eval_psnr CLIs on it; the checkpoint reloaded and written
     again.

Added for the front end (images -> COLMAP text model -> transforms JSON)
and its kernel, K6 (the statistical outlier filter's kNN, csrc/knn.cu):

  C. (after H, front_end_phase) C1 python -m nerfjax_torch.cli.resize_images
     on H's 60 frames (800^2 -> 400^2, LANCZOS; two files byte-equal to
     PIL); C2 a COLMAP text model of the scene (PINHOLE 400^2 at f/2, H's
     poses as OpenCV world-to-camera quaternions, 300,000 points on the
     ball's surface and 3,000 planted 5-50 radii out); C3
     python -m nerfjax_torch.cli.colmap2nerf (mode auto) on the card, its
     Stages line, K6 launched once, every planted outlier removed, the
     orientation check reported; C4 K6 against its plain version at that
     cloud (the k and ratio of C3's cfg, torch.equal), timed beside its
     bound (8 FP32 operations a pair) and the plain version's one call; C5
     the CLI on a 20,000-point subsample with --device cuda and cpu, the
     JSONs byte-equal, with the default cfg and again with radius_filter:
     true (the radius filter's float64 products on the card); C6 C3's JSON through precompute_rays, one epoch of tuned
     train(), 256^3 extraction: IoU with the ball fitted to the normalized
     inliers >= 0.5, the PSNR of the last 20 steps. The CLIs run in this
     process (runpy), so K6's launches are counted around C3's run.

Added for the GUI's launcher and several processes (both after every
timed phase: once other processes have used the card, this process's
profiler traces dropped or gained device events for a while):

  L (the launcher, launcher_phase): a scene config from
     nerfjax_torch.gui.logic.generate_config_dict (20 of H's frames, C's
     COLMAP text model with those images, 256^3) plus TUNED_TRAIN and one
     epoch, as JSON; build_pipeline_commands with every step but "Run
     COLMAP" (no binary here) through the launcher's own loop
     (logic.run_commands): eight CLIs as subprocesses on the card, their
     output streamed, each must exit 0; both volumes through
     load_volume_any, the AABB band, the IoU with the ball fitted to the
     recentered model's inliers (>= 0.5); each step's seconds. Alone:
     python3 chip_smoke.py --only launcher;
  D (after L, multi_phase; children are this script with --child, started
     after the build) D1: one child, TUNED_TRAIN at full width for 16
     steps twice without a process group (the card's run-to-run
     difference: float atomics), then under NCCL at a world of one
     (NERFJAX_DISTRIBUTED=1, WORLD_SIZE=1) with shard_hash_table off and
     on, each step's PSNR within the bf16 step bound of the first run's
     (its parameters torch.equal where two runs alone are); the 256^3
     extraction with and without the group, torch.equal; the table modes
     on equal gradients (_lockstep), torch.equal. D2: two ranks over gloo
     on the card (global batch 8192, 16 steps): the lockstep check,
     train() with shard_hash_table off and on, K1-K5 launched on each rank,
     peak memory and the table's AdamW bytes per rank (the sharded half
     the replicated). D3: D2's checkpoint extracted at 256^3 over the two
     ranks, torch.equal to one rank. Alone: python3 chip_smoke.py --only
     multi.

Added for the redesign of the f32 head and density kernels (a persistent
grid, cp.async tiles, register-blocked FP32 products):

  3. every f32 output held to HEAD_DIGESTS (E = 24 to 128 at both N: the
     sums of the first design, bit for bit); each kernel's blocks an SM;
  5b. (after 5, extract_f32) the f32 kernels' main path: extract_volume(...,
     dtype=torch.float32) of the synthetic checkpoint at 512^3, twice (the
     two volumes bit-equal, their digest the pinned one), the launches of
     the timed run counted from 0 around it (the kernels line's
     f32_launches), its wall; the f32 head and density kernels on its own
     calls against their plain versions (atol 2e-5), the density sigma ==
     the head's.

Added for the point-major path (nerfjax's render_rays and field.apply; its
encode's forward, pack_pairs then hashgrid_fwd_kernel, and its backward,
hashgrid_bwd_kernel then the scratch fold):

  R. (after the drop-in run, feature_last_phase) hashgrid_fwd torch.equal
     to its plain version at nerfjax's eval shape (N = 786,432 seeded
     positions with the domain's faces) at the quality protocol's spec
     (medium, 16 levels) and the tuned cfg's, the pack torch.equal to its
     plain version, timed beside its bounds (the touched entries once;
     every gather counted); one render_rays(train=True) pass and its
     backward at the drop-in shape (the drop-in checkpoint, 8192 rays,
     64 + 128), launches counted from 0 around it (hashgrid_fwd 4,
     pack_pairs 4, hashgrid_bwd 2, nothing else), each wrapper against its
     plain version on the pass's own arguments (the forward torch.equal,
     the table gradient within the atomic-order bound, its float2 adds
     beside the first design's), both timed at the fine pass, the peak
     memory beside the first design's 3.58 GiB; the forward also at the
     quality phase's first eval's fine pass (captured there); render_rays
     card vs CPU at the CPU tests' small spec. Alone: python3 chip_smoke.py
     --only feature_last (a seeded drop-in field, no eval call);
  Q. each run now evaluated as psnr_parity._eval_psnr evaluates it:
     render_rays with the checkpoint's field in f32, all 4,096 rays in one
     call, 64 + 128, train=False, generator seed 0 (the number held against
     nerfjax's range and the floors), the planar bf16 eval of the same
     checkpoint beside it; the tuned arm spass12Led1k1f1scns24gl2sg32
     (NGP-large, batch 8192, 600 steps, cfg/blender_scene_tuned.yml's
     estimators) added. The first run's render_rays calls of hashgrid_fwd
     are recorded, and phase R times its fine pass's.

tools/hashgrid_arms.py times the design arms of both kernels on these
inputs.

The last two lines are a JSON object with each kernel's launches (summed
over the main paths: the 512^3 extraction, the tuned, drop-in and fast
train() runs, the k2 knob steps, the eval renders, the probe entry point,
phase R's render and the quality evals' render_rays calls),
error, times and bound (extra keys: the k >= 2 modes at the fast and k2
knob steps' calls; K1, K2 and K3 also their times, bounds and atomics at
the drop-in passes; the head at E = 40 and 64 and at the eval renders'
fine passes; the f32 kernels' launches on the f32 extraction and their
times; K6 launched by C3's colmap2nerf, timed at C4), then
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SEED = 0
# the model keys of cfg/blender_scene_tuned.yml (NGP-large, 12 levels, one
# promoted dense level); the script states them so it needs no PyYAML
TUNED_CFG = {"ngp": True, "nerf_type": "large", "hash_n_levels": 12, "hash_extra_dense_levels": 1}
SPHERE_CENTER = np.array([0.10, -0.05, 0.0])
SPHERE_RADIUS = 0.5
KERNEL_SHAPES = ([(n, e, dt) for n in (524_288, 1_000_003) for e in (24, 32, 40, 64) for dt in ("bf16", "f32")]
                 + [(524_288, 128, "f32")])
MAIN_SHAPE = (524_288, 24, "bf16")  # the fine pass's call: 8192 cells x 64 voxels
F32_SHAPE = (524_288, 24, "f32")  # the f32 kernels: an extraction or a render with dtype=torch.float32
# timed beside MAIN_SHAPE: 16, 20 and 32 levels
WIDE_SHAPES = [(524_288, 32, "bf16"), (524_288, 40, "bf16"), (524_288, 64, "bf16")]
# sha-256 prefixes of (rgb, sigma, density sigma) of the MLP kernels on
# _head_inputs, on an H100. f32 (every shape of KERNEL_SHAPES): as the
# first design of the FP32 kernels (one point per thread) computed them; E =
# 24 and 32 from before its first layer was split into 32-row chunks, E =
# 40, 64 and 128 pinned from the chunked one. The f32 kernels' order of
# additions is fixed, so every later design must reproduce them bit for bit.
# bf16 (E = 24 and 32): as the tensor-core kernels compute them (their
# order of additions is fixed, so any change to it shows here). ("f32
# extraction", 512): the occupancy and RGB volumes of extract_f32.
HEAD_DIGESTS = {
    (524_288, 24, "bf16"): "50034c4833e3cc25", (524_288, 24, "f32"): "2a21ea1846941ddd",
    (524_288, 32, "bf16"): "460680b3c25de4f7", (524_288, 32, "f32"): "c4fb4edeb8dce1ae",
    (1_000_003, 24, "bf16"): "7edeb9394c4de77c", (1_000_003, 24, "f32"): "276ab8e05a8b9298",
    (1_000_003, 32, "bf16"): "35b7e0b69abc0b0a", (1_000_003, 32, "f32"): "1066bfe6a9dc1cff",
    (524_288, 40, "f32"): "db042fdeb2256384", (1_000_003, 40, "f32"): "c11e047ddec388aa",
    (524_288, 64, "f32"): "a793322bf685f000", (1_000_003, 64, "f32"): "cb747000851c69e0",
    (524_288, 128, "f32"): "0cdb68f44dff70ea", ("f32 extraction", 512): "fcdd78660afad0f2",
}


START = time.perf_counter()


def phase(msg: str) -> None:
    """Print one line of the run's log, stamped with the wall seconds since the script started and the CPU
    seconds that this process and its finished children have used (host work shows where CPU grows with wall)."""
    t = os.times()
    cpu = t.user + t.system + t.children_user + t.children_system
    print(f"[chip_smoke {time.perf_counter() - START:6.1f}s cpu {cpu:6.1f}s] {msg}", flush=True)


def card() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are full f32
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build() -> None:
    from nerfjax_torch import _build
    from nerfjax_torch.ops import fused_mlp, hash_encode, knn

    t0 = time.perf_counter()
    for name, info in _build.build_all().items():
        phase(f"built {info['path'].name} in {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  " + line.strip())
    phase(f"all kernels built in {time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    fused_mlp._lib()
    hash_encode._lib()
    knn._lib()


def _weights(E: int, rng) -> dict:
    import torch

    dims = {"dmlp": [(E, 64), (64, 16)], "cmlp": [(32, 64), (64, 64), (64, 3)]}
    out = {}
    for name, layers in dims.items():
        out[name] = []
        for fi, fo in layers:
            b = np.sqrt(6.0 / (fi + fo))
            out[name].append({"w": torch.from_numpy(rng.uniform(-b, b, (fi, fo)).astype(np.float32)).cuda()})
    return out


def _ulps(got, ref):
    """|got - ref| in bf16 ulps of ref, elementwise. The ulp is taken at no
    less than 2^-14: near zero (where relu cuts) the two summation orders
    differ by float32 noise of O(1) sums, which lies below 2^-21."""
    import torch

    got, ref = got.float(), ref.float()
    return (got - ref).abs() / torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-14))) - 7)


def _ulp_ok(got, ref) -> bool:
    """|got - ref| within one bf16 ulp of ref, elementwise (_ulps)."""
    return bool((_ulps(got, ref) <= 1).all())


def _head_work(E: int, N: int, density: bool = False, size: int = 2) -> tuple[float, float]:
    """(bytes, operations) of the function that the head (density: the
    density head) computes on N points of width E in bf16 (``size`` 2) or
    f32 (4): enc (and sh) read once, rgb and sigma (sigma) written once,
    nerfjax's W1..W5 (W1, W2) read once; two operations per multiply-add
    of its five matmuls (W1, and W2's row 0). Neither the kernels' split
    into three terms nor their padded weight layout is counted: the bound
    is the function's."""
    if density:
        return size * ((E + 1) * N + E * 64 + 64 * 16), 2 * N * (E * 64 + 64)
    macs = E * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 3  # per point, and the weights' count
    return size * ((E + 16 + 4) * N + macs), 2 * N * macs


def _wall_ms(fn, iters: int = 20) -> float:
    """ms per call of fn from CUDA events around iters calls: the device's
    time, or the host's where the host enqueues slower than the device
    runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


TRACE_PAD = 32  # spin kernels before and after a trace's calls: a trace may lose its first or last few events
TRACE_CROSS_CHECKS = [8]  # traces left whose raw device events _device_trace holds to the profiler's event tree


def _device_trace(fn, n: int, pad: int = TRACE_PAD, only: str | None = None, skip: str | None = None
                  ) -> tuple[int, float]:
    """(device events, summed device us) of fn's n calls, from a
    torch.profiler trace of the card alone. The calls sit between two runs
    of ``pad`` short spin kernels, left out of both counts: without them a
    trace was seen to lose one or two events of the calls it measures, at
    its start or its end (K1 exact's two kernels a call: 38 or 39 events
    in 20 calls, 1 in one). ``only``: count only the events whose name
    holds it (a wrapper's one kernel); ``skip``: leave out those whose
    name holds it (an L2 flush in front of each call)."""
    import torch
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(n):
            fn()
        for _ in range(pad):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def counted(name: str) -> bool:
        return "spin_kernel" not in name and (only is None or only in name) and (skip is None or skip not in name)

    # the trace's raw device events: the profiler's event tree (key_averages) takes up to 0.7 s to build for a
    # trace of a plain version's thousands of small kernels, and the run takes hundreds of traces
    events, ns = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and counted(e.name()):
            events, ns = events + 1, ns + e.duration_ns()
    if TRACE_CROSS_CHECKS[0] > 0:  # the run's first traces: the same sums from the event tree
        TRACE_CROSS_CHECKS[0] -= 1
        tree = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and counted(e.key)]
        count, us = sum(e.count for e in tree), sum(e.self_device_time_total for e in tree)
        if count != events or abs(us - ns / 1e3) > 1e-3 + 1e-6 * us:
            raise AssertionError(f"a trace's raw device events ({events}, {ns / 1e3:.3f} us) differ from its event "
                                 f"tree's ({count}, {us:.3f} us)")
    return events, ns / 1e3


def _time_ms(fn, iters: int = 20, only: str | None = None, skip: str | None = None, rest=None,
             known: dict | None = None) -> float:
    """Device ms per call of fn: the summed durations of the kernels (and
    copies) it runs over iters calls, from a torch.profiler trace of the
    card alone (_device_trace); the host's time between them is left out.
    The trace counts only if it holds every call's device events: iters
    times those of one call, traced alone just before. A trace that drops
    events (seen about once in 100, some with none, some with half the
    calls) is taken again, up to 5 times. Where all 5 drop events (seen
    once, in a burst), the time is taken with CUDA events around the
    calls instead (_wall_ms: the host's gaps between calls included) and
    a line says so. ``only`` and ``skip`` filter the events by name
    (_device_trace); there the fallback takes CUDA events around fn's
    calls less those around ``rest``'s, the part of fn the filter leaves
    out (the pack in front of K4, an L2 flush), timed alone. ``known``:
    one call's event count by id(fn), kept for the caller's later runs of
    the same fn (a timing set's second kernel and plain runs); a trace
    that does not hold that count times iters is taken again with a fresh
    count."""
    import torch

    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(5):
        per_call = known.get(id(fn)) if known is not None and attempt == 0 else None
        if per_call is None:
            per_call, _ = _device_trace(fn, 1, only=only, skip=skip)
        events, us = _device_trace(fn, iters, only=only, skip=skip)
        if per_call > 0 and events == iters * per_call:
            if known is not None:
                known[id(fn)] = per_call
            return us / 1e3 / iters
        seen.append(f"{events} events in {iters} calls, {per_call} in one")
    ms = _wall_ms(fn, iters)
    if only is not None or skip is not None:
        ms -= _wall_ms(rest, iters)
    phase(f"5 profiler traces in a row dropped device events ({'; '.join(seen)}): timed with CUDA events "
          f"instead, {ms * 1e3:.1f} us per call, the host's gaps between calls included"
          + ("" if rest is None else ", less the part the trace would leave out, timed alone"))
    return ms


def _head_inputs(N: int, E: int, dt: str):
    """(params, enc [E, N], sh [16, N]) on the card, seeded by the shape."""
    import torch

    rng = np.random.default_rng([SEED, N, E, dt == "bf16"])
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    params = _weights(E, rng)
    enc = torch.from_numpy(rng.uniform(-1, 1, (E, N)).astype(np.float32)).cuda().to(tdt)
    sh = torch.from_numpy(rng.uniform(-1, 1, (16, N)).astype(np.float32)).cuda().to(tdt)
    return params, enc, sh


def _digest(*tensors) -> str:
    """The first 16 hex digits of the sha-256 of the tensors' bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def kernels_vs_plain() -> dict:
    import torch

    from nerfjax_torch.ops import fused_mlp as fm

    stats = {"fused_ngp_head": {"max_abs_err": 0.0, "f32_max_abs_err": 0.0, "wide": {}},
             "fused_ngp_density": {"max_abs_err": 0.0, "f32_max_abs_err": 0.0}}
    lib = fm._lib()
    for dt, flag in (("bf16", 1), ("f32", 0)):
        phase(f"{dt} MLP kernels' dynamic shared memory per block (blocks an SM): head " + ", ".join(
            f"E={E} {lib.nerf_fused_smem_bytes(E, flag, 0):,} B ({lib.nerf_fused_blocks_per_sm(E, flag, 0)})"
            for E in (24, 32, 64, 128)) + "; density " + ", ".join(
            f"E={E} {lib.nerf_fused_smem_bytes(E, flag, 1):,} B ({lib.nerf_fused_blocks_per_sm(E, flag, 1)})"
            for E in (24, 32, 128)))
    equal, total, worst = 0, 0, 0.0  # bf16 outputs bit-equal to plain, of all; the largest error in ulps
    for N, E, dt in KERNEL_SHAPES:
        params, enc, sh = _head_inputs(N, E, dt)
        packed = fm.pack_weights(params, enc.dtype, enc.device)  # once per field, as InstantNGP does
        rgb_k, sig_k = fm.fused_ngp_head(params, enc, sh, packed=packed)
        dsig_k = fm.fused_ngp_density(params, enc, packed=packed)
        rgb_p, sig_p = fm.fused_ngp_head_plain(params, enc, sh)
        dsig_p = fm.fused_ngp_density_plain(params, enc)
        torch.cuda.synchronize()
        if not torch.equal(dsig_k, sig_k):
            raise AssertionError(f"density sigma != head sigma at N={N} E={E} {dt}")
        shape_eq, shape_worst = 0, 0.0
        for name, pairs in (("fused_ngp_head", [(rgb_k, rgb_p), (sig_k, sig_p)]),
                            ("fused_ngp_density", [(dsig_k, dsig_p)])):
            for got, ref in pairs:
                err = float((got.float() - ref.float()).abs().max())
                ok = _ulp_ok(got, ref) if dt == "bf16" else err <= 2e-5
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain version at N={N} E={E} {dt}: {err}")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
                if dt == "f32":
                    stats[name]["f32_max_abs_err"] = max(stats[name]["f32_max_abs_err"], err)
                if dt == "bf16" and name == "fused_ngp_head":
                    shape_eq += int(torch.eq(got, ref).sum())
                    shape_worst = max(shape_worst, float(_ulps(got, ref).max()))
        line = f"N={N} E={E} {dt}: kernel == plain (bf16: <= 1 ulp; f32: <= 2e-5); density sigma == head sigma"
        if dt == "bf16":
            equal, total, worst = equal + shape_eq, total + 4 * N, max(worst, shape_worst)
            line += (f"; head outputs bit-equal to plain {shape_eq / (4 * N):.4%}, largest error "
                     f"{shape_worst:.3f} bf16 ulp")
        if E <= 32 or dt == "f32":
            digest = _digest(rgb_k, sig_k, dsig_k)
            if HEAD_DIGESTS.get((N, E, dt)) != digest:
                raise AssertionError(f"the MLP kernels' outputs at N={N} E={E} {dt} changed: digest {digest}, "
                                     f"pinned {HEAD_DIGESTS.get((N, E, dt))}")
            line += f"; outputs equal to the pinned ones (digest {digest})"
        if (N, E, dt) in WIDE_SHAPES:
            t = _time_kernel(lambda: fm.fused_ngp_head(params, enc, sh, packed=packed),
                             lambda: fm.fused_ngp_head_plain(params, enc, sh), None, _bound(*_head_work(E, N), "bf16"))
            stats["fused_ngp_head"]["wide"][E] = t
            line += f"\n  fused_ngp_head E={E} (extra line): " + _timing_line(t)
        if (N, E, dt) in (MAIN_SHAPE, F32_SHAPE):
            runs = {
                "fused_ngp_head": (lambda: fm.fused_ngp_head(params, enc, sh, packed=packed),
                                   lambda: fm.fused_ngp_head_plain(params, enc, sh)),
                "fused_ngp_density": (lambda: fm.fused_ngp_density(params, enc, packed=packed),
                                      lambda: fm.fused_ngp_density_plain(params, enc)),
            }
            for name, (kern, plain) in runs.items():
                bound = _bound(*_head_work(E, N, name == "fused_ngp_density", enc.element_size()), dt)
                t = _time_kernel(kern, plain, None, bound)
                if dt == "f32":  # an extra line and extra keys
                    stats[name]["f32"] = t
                    line += f"\n  {name} f32 (ngp_{'density' if 'density' in name else 'head'}_kernel): "
                else:
                    stats[name].update(t)
                    line += f"\n  {name}: "
                line += _timing_line(t)
        phase(line)
    stats["fused_ngp_head"].update(bit_equal_share=equal / total, max_err_ulp=worst)
    phase(f"bf16 head outputs over all shapes: {equal / total:.4%} bit-equal to plain, largest error {worst:.3f} "
          "bf16 ulp (bound: 1)")
    return stats


def synthetic_checkpoint(path: Path) -> None:
    """nerf_final.pth at the tuned NGP-large shape: plane 0 of every dense
    level holds the signed distance to a sphere, W1/W2 route its level mean
    to sigma, the hashed levels keep tcnn's +-1e-4 init, the rest is seeded."""
    from nerfjax_torch import checkpoint as ckpt
    from nerfjax_torch.train import build_fields

    rng = np.random.default_rng(SEED)
    field = build_fields(TUNED_CFG)[1]
    spec = field.spec
    table = rng.uniform(-1e-4, 1e-4, (2, spec.total_table_size)).astype(np.float32)
    dense = [lp for lp in spec.level_params() if not lp["use_hash"]]
    for lp in dense:
        r = lp["res"]
        p = 2.0 * (np.arange(r) - 0.5) / lp["scale"] - 1.0  # lattice point -> [-1, 1]
        z, y, x = np.meshgrid(p, p, p, indexing="ij")  # flat index x + y*r + z*r^2
        d = SPHERE_RADIUS - np.sqrt((x - SPHERE_CENTER[0]) ** 2 + (y - SPHERE_CENTER[1]) ** 2
                                    + (z - SPHERE_CENTER[2]) ** 2)
        table[0, lp["offset"] : lp["offset"] + r**3] = d.reshape(-1)
    params = {"table": table, "dmlp": [], "cmlp": []}
    for name, dims in field.mlp_dims().items():
        for fi, fo in dims:
            b = np.sqrt(6.0 / (fi + fo))
            params[name].append({"w": rng.uniform(-b, b, (fi, fo)).astype(np.float32)})
    w1, w2 = params["dmlp"][0]["w"], params["dmlp"][1]["w"]
    w1[:, 0] = 0.0
    w1[: len(dense), 0] = 1.0 / len(dense)  # hidden 0 = mean sphere distance
    w2[:, 0] = 0.0
    w2[0, 0] = 40.0  # sigma = 40 * relu(distance inside the sphere)
    ckpt.save_field_params(path, TUNED_CFG, params, iteration=1)


def extract_full(ckpt_path: Path, out_dir: Path, k4_shapes: dict) -> dict:
    """The main path: checkpoint -> extract_volume at 512^3 on the card ->
    save_volume -> load_volume, checked; K4 on the extraction's own calls
    equal to its plain version, timed at the largest (filed in k4_shapes)."""
    import torch

    from nerfjax_torch.extract import extract_volume, load_volume, save_volume
    from nerfjax_torch.ops import fused_mlp as fm
    from nerfjax_torch.ops import hash_encode as he

    res = 512
    cfg = {**TUNED_CFG, "checkpoint": str(ckpt_path), "volume_resolution": res}
    warm = extract_volume(cfg, device="cuda", verbose=False)  # first use: allocator, cuBLAS
    phase(f"{res}^3 warm-up run: " + _phases(warm["metadata"]))
    del warm
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    he.reset_launch_counts()
    with _recorded((he, "hash_levels_fwd"), (he, "dense_levels_fwd"), (fm, "fused_ngp_density"),
                   (fm, "fused_ngp_head")) as calls:
        t0 = time.perf_counter()
        vol = extract_volume(cfg, device="cuda")
        wall = time.perf_counter() - t0
    launches = {**fm.launch_counts,
                **{k: he.launch_counts[k] for k in ("hash_levels_fwd", "pack_pairs", "dense_levels_fwd")}}
    peak = torch.cuda.max_memory_allocated() / 2**30
    md = vol["metadata"]
    phase(f"{res}^3 extraction: {wall:.2f} s wall; " + _phases(md)
          + f"; peak device memory {peak:.2f} GiB; launches {launches}")

    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    k1_sizes, mlp_sizes = [], []
    for N, seen in sorted(calls.items()):  # each kernel on its last call of each size
        if "hash_levels_fwd" in seen:  # K1 exact
            (spec, planes, x, y, z), _ = seen["hash_levels_fwd"]
            if not torch.equal(he.hash_levels_fwd(spec, planes, x, y, z),
                               he.hash_levels_fwd_plain(spec, planes, x, y, z)[0]):
                raise AssertionError(f"hash_levels_fwd at the {res}^3 extraction (N={N:,}): kernel != plain")
            k1_sizes.append(N)
        if "dense_levels_fwd" in seen:
            (spec, planes, x, y, z, dtype), _ = seen["dense_levels_fwd"]
            got = he.dense_levels_fwd(spec, planes, x, y, z, dtype)
            if got.dtype != dtype or not torch.equal(got, he.dense_levels_fwd_plain(spec, planes, x, y, z, dtype)[0]):
                raise AssertionError(f"dense_levels_fwd at the {res}^3 extraction (N={N:,}): kernel != plain")
    phase(f"dense_levels_fwd at the {res}^3 extraction's calls (N = "
          + ", ".join(f"{n:,}" for n, seen in sorted(calls.items()) if "dense_levels_fwd" in seen)
          + "): kernel == plain bit for bit")
    N = max(n for n, seen in calls.items() if "dense_levels_fwd" in seen)
    (spec, planes, x, y, z, dtype), _ = calls[N]["dense_levels_fwd"]
    _k4_timed(k4_shapes, "extraction", spec, planes, x, y, z, dtype)
    for N, seen in sorted(calls.items()):
        if "fused_ngp_density" in seen:  # the marking pass: also the head's sigma on the same enc
            (params, enc), kw = seen["fused_ngp_density"]
            sigma = fm.fused_ngp_density(params, enc, **kw)
            _, head_sigma = fm.fused_ngp_head(params, enc, torch.zeros(16, N, dtype=enc.dtype, device=enc.device), **kw)
            if not (_ulp_ok(sigma, fm.fused_ngp_density_plain(params, enc)) and torch.equal(sigma, head_sigma)):
                raise AssertionError(f"fused_ngp_density at the {res}^3 extraction (N={N:,}): beyond one ulp of "
                                     "plain, or not the head's sigma")
            mlp_sizes.append(f"density {N:,}")
        if "fused_ngp_head" in seen:
            (params, enc, sh), kw = seen["fused_ngp_head"]
            for got, ref in zip(fm.fused_ngp_head(params, enc, sh, **kw), fm.fused_ngp_head_plain(params, enc, sh)):
                if not _ulp_ok(got, ref):
                    raise AssertionError(f"fused_ngp_head at the {res}^3 extraction (N={N:,}): beyond one ulp of plain")
            mlp_sizes.append(f"head {N:,}")
    phase(f"hash_levels_fwd exact at the {res}^3 extraction's calls (N = " + ", ".join(f"{n:,}" for n in k1_sizes)
          + "): kernel == plain (torch.equal); the MLP kernels on their calls (" + ", ".join(mlp_sizes)
          + "): within one bf16 ulp of plain, the density sigma == the head's on the same enc")
    out = out_dir / "volume.pth"
    save_volume(vol, out)
    back = load_volume(out)
    occ, rgb = back["occupancy_volume"], back["rgb_volume"]
    if occ.shape != (res,) * 3 or occ.dtype != np.uint8 or rgb.shape != (res,) * 3 + (3,) or rgb.dtype != np.uint8:
        raise AssertionError(f"volume.pth shapes/dtypes {occ.shape} {occ.dtype} {rgb.shape} {rgb.dtype}")
    marked = md["marked_cells"] / (res // 4) ** 3
    occupied = md["occupied_ratio"]
    if not (0 < marked < 1 and 0 < occupied < 1):
        raise AssertionError(f"marked {marked}, occupied {occupied}: expected strictly between 0 and 1")
    step = 2.0 / (res - 1)
    idx = np.argwhere(occ)
    dist = np.linalg.norm(-1.0 + idx * step - SPHERE_CENTER, axis=1)
    if dist.max() > SPHERE_RADIUS + 3 * step:
        raise AssertionError(f"occupied voxel {dist.max():.4f} from the center, sphere radius {SPHERE_RADIUS}")
    if rgb[occ == 0].any():
        raise AssertionError("sparse fetch returned RGB at unoccupied voxels")
    phase(f"volume.pth ok: marked {marked:.2%} of cells, occupied {occupied:.2%} of voxels, "
          f"farthest occupied voxel {dist.max():.4f} from the center (radius {SPHERE_RADIUS}), "
          f"threshold {md['threshold']:.4f}")
    return launches


def _phases(md: dict) -> str:
    s = md["phase_seconds"]
    return ", ".join(f"{k} {s[k]:.3f} s" for k in ("coarse", "fine", "otsu", "fetch"))


def card_vs_cpu_128(ckpt_path: Path) -> None:
    """128^3 in f32 on the card and on the CPU: thresholds within 1e-5
    relative, occupancy differing at <= 0.5% of voxels and only where sigma
    is within 2e-5 relative of the threshold, RGB within +-1 where both are
    occupied (the rule of tests/test_torch_extract.py)."""
    import torch

    from nerfjax_torch.checkpoint import load_field_params
    from nerfjax_torch.extract import extract_volume
    from nerfjax_torch.train import build_fields

    cfg = {**TUNED_CFG, "checkpoint": str(ckpt_path)}
    params = load_field_params(ckpt_path, cfg)
    kw = dict(params=params, resolution=128, dtype=torch.float32, verbose=False)
    a = extract_volume(cfg, device="cuda", **kw)
    b = extract_volume(cfg, device="cpu", **kw)
    ta, tb = a["metadata"]["threshold"], b["metadata"]["threshold"]
    if abs(ta - tb) > 1e-5 * abs(tb):
        raise AssertionError(f"128^3 threshold card {ta} vs cpu {tb}")
    oa, ob = a["occupancy_volume"], b["occupancy_volume"]
    diff = np.flatnonzero(oa != ob)
    if diff.size > 0.005 * oa.size:
        raise AssertionError(f"128^3 occupancy differs at {diff.size} voxels")
    if diff.size:
        field = build_fields(cfg)[1].load_params(params["model"])
        c = torch.from_numpy(np.float32(-1.0) + np.arange(128, dtype=np.float32) * np.float32(2.0 / 127))
        i = np.unravel_index(diff, oa.shape)
        pos3 = tuple(c[torch.from_numpy(i[k])] for k in range(3))
        _, sig = field.apply_planar_fused(pos3, tuple(torch.full_like(pos3[0], v) for v in (0.0, 0.0, -1.0)),
                                          dtype=torch.float32)
        if not bool(((sig - tb).abs() <= 2e-5 * abs(tb)).all()):
            raise AssertionError("128^3 occupancy differs away from the threshold")
    both = (oa == 1) & (ob == 1)
    rgb_err = int(np.abs(a["rgb_volume"].astype(int) - b["rgb_volume"].astype(int))[both].max())
    if rgb_err > 1:
        raise AssertionError(f"128^3 RGB differs by {rgb_err}")
    phase(f"128^3 f32 card vs cpu: thresholds {ta:.6f} / {tb:.6f}, occupancy differs at "
          f"{diff.size} of {oa.size} voxels, RGB max diff {rgb_err}")


def extract_f32(ckpt_path: Path) -> dict:
    """The f32 MLP kernels' main path: nerfjax_torch.extract.extract_volume(cfg,
    dtype=torch.float32) at 512^3 on the synthetic checkpoint, the library
    call a caller makes for an f32 extraction (the hash kernels write f32
    encodings, the f32 head and density kernels take them). Run twice: a
    warm-up, then the timed run with the launch counts set to 0 just before
    it; the two volumes must be bit-equal, and their digest the pinned one.
    Then the MLP kernels on the timed run's own calls against their plain
    versions (atol 2e-5), the density sigma == the head's on the same enc.
    Returns the timed run's wall and launches."""
    import torch

    from nerfjax_torch.extract import extract_volume
    from nerfjax_torch.ops import fused_mlp as fm

    res = 512
    cfg = {**TUNED_CFG, "checkpoint": str(ckpt_path), "volume_resolution": res}

    def digest(vol):
        return _digest(*(torch.from_numpy(np.ascontiguousarray(vol[k])) for k in ("occupancy_volume", "rgb_volume")))

    warm = digest(extract_volume(cfg, device="cuda", dtype=torch.float32, verbose=False))
    fm.reset_launch_counts()
    with _recorded((fm, "fused_ngp_density"), (fm, "fused_ngp_head")) as calls:
        t0 = time.perf_counter()
        vol = extract_volume(cfg, device="cuda", dtype=torch.float32, verbose=False)
        wall = time.perf_counter() - t0
    launches = dict(fm.launch_counts)
    md, got = vol["metadata"], digest(vol)
    phase(f"{res}^3 f32 extraction: {wall:.2f} s wall; " + _phases(md) + f"; launches {launches}; occupied "
          f"{md['occupied_voxels']:,} voxels, threshold {md['threshold']:.6f}; volumes' digest {got} (warm-up run: "
          f"{warm})")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the f32 extraction")
    if warm != got:
        raise AssertionError(f"two f32 extractions of one checkpoint differ: digests {warm} and {got}")
    if HEAD_DIGESTS.get(("f32 extraction", res)) != got:
        raise AssertionError(f"the f32 extraction's volumes changed: digest {got}, pinned "
                             f"{HEAD_DIGESTS.get(('f32 extraction', res))}")
    sizes = []
    for N, seen in sorted(calls.items()):
        if "fused_ngp_density" in seen:  # the marking pass: also the head's sigma on the same enc
            (params, enc), kw = seen["fused_ngp_density"]
            sigma = fm.fused_ngp_density(params, enc, **kw)
            _, head_sigma = fm.fused_ngp_head(params, enc, torch.zeros(16, N, dtype=enc.dtype, device=enc.device), **kw)
            err = float((sigma - fm.fused_ngp_density_plain(params, enc)).abs().max())
            if enc.dtype != torch.float32 or err > 2e-5 or not torch.equal(sigma, head_sigma):
                raise AssertionError(f"fused_ngp_density at the f32 extraction (N={N:,}): {enc.dtype}, {err} from "
                                     "plain, or not the head's sigma")
            sizes.append(f"density {N:,}")
        if "fused_ngp_head" in seen:
            (params, enc, sh), kw = seen["fused_ngp_head"]
            for a, b in zip(fm.fused_ngp_head(params, enc, sh, **kw), fm.fused_ngp_head_plain(params, enc, sh)):
                if enc.dtype != torch.float32 or float((a - b).abs().max()) > 2e-5:
                    raise AssertionError(f"fused_ngp_head at the f32 extraction (N={N:,}): beyond 2e-5 of plain")
            sizes.append(f"head {N:,}")
    phase(f"the f32 MLP kernels on the f32 extraction's calls ({', '.join(sizes)}): within atol 2e-5 of plain, the "
          "density sigma == the head's on the same enc; the volumes equal to the pinned ones and to the warm-up run's")
    return {"wall_s": wall, "launches": launches}


# -- the training path -----------------------------------------------------

# the training keys of cfg/blender_scene_tuned.yml, stated so the script
# needs no PyYAML
TUNED_TRAIN = {
    **TUNED_CFG, "batch_size": 8192, "lr": 0.0005, "N_samples": 8, "N_importance": 16, "white_bg": False,
    "precision": "bf16", "occupancy_grid": True, "single_pass": True, "hash_grad_corners": 1,
    "hash_fwd_corners": 1, "hash_grad_levels": 2, "occ_resolution": 128, "occ_update_every": 16,
    "occ_fast_cdf": True, "occ_update_partitions": 4, "occ_segments": 32,
}
TRAIN_EPOCHS = 3
N_RAYS = 1 << 20  # 128 steps of 8192 rays per epoch
# the dense-level knobs trained beside the tuned cfg (phase 7b), 128 steps each
DENSE_KNOBS = {"dgl1": {"hash_dense_grad_levels": 1}, "dc1": {"hash_dense_corners": 1}}
PSNR_RISE_DB = 3.0  # the least rise of PSNR from the first 20 steps to the last 20 of a training run
BALL_CENTER = np.array([0.10, -0.05, 0.0])
BALL_RADIUS = 0.5
BALL_SIGMA = 4.0
BALL_RGB = np.array([0.9, 0.6, 0.3], np.float32)
# the CPU tests' small size (tests/test_torch_train_step.py)
SMALL_TRAIN = {
    **TUNED_TRAIN, "nerf_type": "small", "hash_n_levels": 8, "batch_size": 256, "lr": 5e-3,
    "precision": "fp32", "occ_resolution": 16, "occ_segments": 8,
}
H100_BYTES_PER_S = 3.35e12
H100_L2_BYTES = 50 * 2**20
H100_FLOPS = {"f32": 67e12, "bf16": 989e12}  # non-tensor FP32; dense bf16 tensor cores


def _bound(nbytes: float, ops: float, dtype: str = "f32") -> tuple[float, str]:
    """(least ms, "bytes" or "operations") on an H100 at its published peaks."""
    tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _rand(shape, rng, lo=-1.0, hi=1.0):
    import torch

    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).cuda()


def hash_kernels_vs_plain() -> dict:
    """K1, K2 and K3 against their plain versions on the card at the tuned
    spec, on seeded inputs: K1 timed (runs p, k, k, p) at the extraction's
    and the train step's shapes; K3 also timed at the micro-benchmark's
    shape (an extra line). K2 and K3 are timed at the step's own inputs in
    step_kernels_vs_plain."""
    import torch

    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import build_fields

    rng = np.random.default_rng(SEED + 6)
    exact = build_fields(TUNED_CFG)[1].spec
    k1 = build_fields(TUNED_TRAIN, train=True)[1].spec
    _, hashed = he._split_levels(exact)
    Lh, base, total = len(hashed), hashed[0]["offset"], exact.total_table_size
    planes = _rand((2, total), rng)
    stats = {n: {"max_abs_err": 0.0} for n in ("hash_levels_fwd", "hash_levels_bwd", "table_grad_scatter", "pack_pairs")}

    def timed(name, label, kern, plain, bound):
        stats[name].update(_time_kernel(kern, plain, None, bound))
        phase(f"  {name} {label}: " + _timing_line(stats[name]))

    # K1 exact (the extraction's fine pass and beyond), f32 output and bf16 at the concat
    for N in (524_288, 1_000_003):
        x, y, z = _rand((3, N), rng, 0.0, 1.0)
        got = he.hash_levels_fwd(exact, planes, x, y, z)
        ref, _ = he.hash_levels_fwd_plain(exact, planes, x, y, z)
        for dt in (torch.float32, torch.bfloat16):
            if not torch.equal(got.to(dt), ref.to(dt)):
                err = float((got.to(dt).float() - ref.to(dt).float()).abs().max())
                if dt == torch.bfloat16 and not _ulp_ok(got.to(dt), ref.to(dt)) or dt == torch.float32 and err > 0:
                    raise AssertionError(f"hash_levels_fwd exact N={N} {dt}: {err}")
                stats["hash_levels_fwd"]["max_abs_err"] = max(stats["hash_levels_fwd"]["max_abs_err"], err)
        phase(f"hash_levels_fwd exact N={N}: kernel == plain (f32 and bf16, <= 1 ulp)")
        if N == 524_288:
            timed("hash_levels_fwd", f"exact N={N}", lambda: he.hash_levels_fwd(exact, planes, x, y, z),
                  lambda: he.hash_levels_fwd_plain(exact, planes, x, y, z), _k1_bounds(exact, x, y, z, None, 4)[0])

    # K1 k = 1 (the train step's forward) with its plan; K2 in its three modes
    N = 196_608
    x, y, z = _rand((3, N), rng, 0.0, 1.0)
    sel = torch.empty(Lh, N, dtype=torch.int32, device="cuda")
    got = he.hash_levels_fwd(k1, planes, x, y, z, sel=sel)
    ref, plan = he.hash_levels_fwd_plain(k1, planes, x, y, z)
    if not torch.equal(sel.long(), plan) or not torch.equal(got, ref):
        raise AssertionError("hash_levels_fwd k=1: plan or output differs from the plain version")
    phase(f"hash_levels_fwd k=1 N={N}: sel == plain plan, output == plain (torch.equal)")
    timed("hash_levels_fwd", f"k=1 N={N}", lambda: he.hash_levels_fwd(k1, planes, x, y, z),
          lambda: he.hash_levels_fwd_plain(k1, planes, x, y, z), _k1_bounds(k1, x, y, z, plan, 4)[0])
    stats["hash_levels_fwd"]["shapes"] = {"seeded_k1": {**stats["hash_levels_fwd"], "N": N}}

    g = _rand((2, Lh, N), rng)
    for label, spec in (("exact", exact), ("k=1", dataclasses.replace(k1, grad_levels=0)), ("k=1 gl=2", k1)):
        got = he.hash_levels_bwd(spec, g, x, y, z, _zeros2(total))
        ref = he.hash_levels_bwd_plain(spec, g, x, y, z, _zeros2(total))
        mass = he.hash_levels_bwd_plain(spec, g.abs(), x, y, z, _zeros2(total))
        err = _check_scatter(f"hash_levels_bwd {label}", got, ref, mass, _k2_count(spec, g, x, y, z, total))
        if got[:, :base].abs().max() != 0:
            raise AssertionError(f"hash_levels_bwd {label} wrote outside the hashed columns")
        stats["hash_levels_bwd"]["max_abs_err"] = max(stats["hash_levels_bwd"]["max_abs_err"], err)
        phase(f"hash_levels_bwd {label} N={N}: kernel == plain within the atomic-order bound; max |err| {err:.3g}")

    # K3 at the micro-benchmark's shape (benchmarks/micro_onehot.py:165), an
    # extra line: the kernels line times K3 at the train step's shapes
    T, K = 1 << 19, 4_194_304
    idx = torch.from_numpy(rng.integers(0, T, K).astype(np.int32)).cuda()
    idx[::1000] = T + 5  # dropped
    g0, g1 = _rand((2, K), rng)
    got = he.table_grad_scatter(idx, g0, g1, _zeros2(T))
    ref = he.table_grad_scatter_plain(idx, g0, g1, _zeros2(T))
    one = torch.ones_like(g0)
    mass = he.table_grad_scatter_plain(idx, g0.abs(), g1.abs(), _zeros2(T))
    count = he.table_grad_scatter_plain(idx, one, one, _zeros2(T))
    err = _check_scatter("table_grad_scatter (micro shape)", got, ref, mass, count)
    stats["table_grad_scatter"]["max_abs_err"] = err
    phase(f"table_grad_scatter T={T} K={K}: kernel == plain within the atomic-order bound; max |err| {err:.3g}")
    buf = torch.empty(2, T, device="cuda")
    keep = idx < T
    ik, gk = idx[keep], torch.stack([g0[keep], g1[keep]])  # index_add_ raises on the dropped indices
    micro = _time_kernel(
        lambda: he.table_grad_scatter(idx, g0, g1, buf.zero_()),
        lambda: he.table_grad_scatter_plain(idx, g0, g1, buf.zero_()),
        lambda: buf.zero_().index_add_(1, ik, gk),
        _bound(12 * K + 8 * T, 2 * K),
    )
    phase(f"  table_grad_scatter T={T} K={K} (extra line, micro shape): " + _timing_line(micro))
    return stats


def _positions(N: int, rng):
    """x, y, z [N] on the card, uniform in [0, 1] but for the domain's
    corners 0 and 1 at the first two points."""
    x, y, z = _rand((3, N), rng, 0.0, 1.0)
    for c in (x, y, z):
        c[0], c[1] = 0.0, 1.0
    return x, y, z


def _dense_fwd_bound(Ld: int, touched: int, N: int, out_bytes: int, ops_per_row: int):
    """K4's bound, that of the function it computes: positions in, the
    touched table entries (both f32 planes) in once, the [2, Ld, N] output
    out once; ops per (level, point). The pack in front of the kernel is a
    choice of design (the kernel could read the planes in place) and is
    left out: the wrapper's call and its kernel alone are both set
    against this bound."""
    return _bound(12 * N + 8 * touched + out_bytes * 2 * Ld * N, ops_per_row * Ld * N)


def _plan_ops(k: int) -> int:
    """Operations per (level, point) of a k-corner plan and its blend: 80 at
    k = 1 (8 weights, the CDF, one draw); k >= 2 also the leader and 30 per
    further draw and corner."""
    return 80 if k == 1 else 90 + 30 * (k - 1)


def _k4_bound(spec, x, y, z, dtype, out_bytes: int | None = None):
    """K4's bound at one call (_dense_fwd_bound): exact,
    the cells' 8 corners (120 operations per (level, point)) and an output
    in ``dtype``; k corners, the planned entries (_plan_ops) and an output
    of ``out_bytes`` per value (the encode's dtype where the call wrote
    into its rows; float32 by default, as the wrapper allocates it)."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    dense, _ = he._split_levels(spec)
    Ld, N = len(dense), x.shape[0]
    if he._dense_mode(spec, Ld)[0] == 1:
        k = spec.dense_corners
        touched = torch.unique(he._dense_plan(dense, x, y, z, k)[0]).numel()
        return _dense_fwd_bound(Ld, touched, N, out_bytes or 4, _plan_ops(k))
    touched = torch.unique(he._dense_corner_arrays(dense, x, y, z, torch.float32)[0]).numel()
    size = torch.empty(0, dtype=dtype).element_size()
    return _dense_fwd_bound(Ld, touched, N, size, 120)


def _k4_timed(shapes: dict, label: str, spec, planes, x, y, z, dtype) -> dict:
    """K4 held to plain and timed at one main-path call (_k4_at_call, into
    the wrapper's own output), filed in ``shapes`` under ``label`` and
    printed (an extra line)."""
    from nerfjax_torch.ops import hash_encode as he

    t = shapes[label] = _k4_at_call(spec, planes, x, y, z, dtype, None, label, True)
    mode = "exact" if he._dense_mode(spec, len(he._split_levels(spec)[0]))[0] != 1 else f"k={spec.dense_corners}"
    phase(f"  dense_levels_fwd at {label} ({mode} {dtype}, N={x.shape[0]:,}): " + _timing_line(t))
    return t


def _k4_at_call(spec, planes, x, y, z, dtype, out, label: str, timed: bool):
    """K4 on the arguments of one main-path call against its plain version
    with torch.equal (k corners: its plan too, through sel). Where the call
    wrote into the encode's output (``out``: a [2, Ld, N] slice of it, in
    the encode's dtype) the kernel writes into a fresh buffer of the same
    dtype and strides and is held to the plain output cast to that dtype.
    Timed (runs p, k, k, p) beside its bound with the output it writes and
    with a float32 one, and its kernel net of the pack (the trace's
    dense_levels_fwd events alone, kernel_ms), if ``timed``:
    returns the timing, else None."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    dense, _ = he._split_levels(spec)
    Ld, N = len(dense), x.shape[0]
    k = spec.dense_corners if he._dense_mode(spec, Ld)[0] == 1 else 8
    ref, plan = he.dense_levels_fwd_plain(spec, planes, x, y, z, dtype)
    sel = torch.empty(plan.shape, dtype=torch.int32, device=x.device) if k < 8 else None
    if out is None:
        got = he.dense_levels_fwd(spec, planes, x, y, z, dtype, sel=sel)
        call = lambda: he.dense_levels_fwd(spec, planes, x, y, z, dtype)  # noqa: E731
    else:
        buf = torch.empty_strided(out.shape, out.stride(), dtype=out.dtype, device=out.device)
        got = he.dense_levels_fwd(spec, planes, x, y, z, dtype, sel=sel, out=buf)
        ref = ref.to(out.dtype)
        call = lambda: he.dense_levels_fwd(spec, planes, x, y, z, dtype, out=buf)  # noqa: E731
    if got.dtype != ref.dtype or not torch.equal(got, ref) or (k < 8 and not torch.equal(sel.long(), plan)):
        raise AssertionError(f"dense_levels_fwd ({label}, N={N:,}): kernel != plain (output or plan)")
    if not timed:
        return None
    t = _time_kernel(call, lambda: he.dense_levels_fwd_plain(spec, planes, x, y, z, dtype), None,
                     _k4_bound(spec, x, y, z, dtype, got.element_size()))
    if k < 8:
        t["bound_f32_out"] = _k4_bound(spec, x, y, z, dtype, 4)
    t["N"] = N
    T, f32 = he._dense_width(dense), k == 8 and dtype == torch.float32
    pack = lambda: he.pack_pairs(planes[:, :T], f32)  # noqa: E731
    known = {}
    t["kernel_ms"] = float(np.median([_time_ms(call, only="dense_levels_fwd", rest=pack, known=known)
                                      for _ in range(2)]))
    return t


def _dense_bwd_bound(spec, g, x, y, z, K: int):
    """K5's bound: positions in, the upstream gradient g [2, Ld, N] it reads
    (under a level subset only the drawn (level, point) pairs), 12 B (idx,
    v0, v1) per staged entry out; 8 operations per entry."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    Ld, N = g.shape[1], x.shape[0]
    mode, gd = he._dense_mode(spec, Ld)
    pairs = Ld * N
    if mode == 2:
        ids = he._draw_levels(x, y, z, Ld, gd, he.DENSE_GL_SALT)
        pairs = torch.unique(ids * N + torch.arange(N, device=x.device)).numel()
    return _bound(12 * N + 2 * g.element_size() * pairs + 12 * K, 8 * K)


def dense_kernels_vs_plain(stats: dict) -> None:
    """K4 and K5 against their plain versions on the card at the tuned spec
    on seeded inputs (faces included), each timed (runs p, k, k, p) beside
    its bound as an extra line: K4 exact in f32 and bf16 at the step's
    N = 196,608 and the extraction's fine call's 524,288, bit for bit, and
    k = 1 with its plan; K5 exact in bf16 and f32, over 1 and 2 drawn
    levels and k = 1, with torch.equal, and K3 on each K5 output within the
    atomic-order bound. The kernels line takes K4's and K5's times at the
    train step's own inputs (step_kernels_vs_plain)."""
    import torch

    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import build_fields

    rng = np.random.default_rng(SEED + 8)
    exact = build_fields(TUNED_CFG)[1].spec
    dc1 = dataclasses.replace(exact, dense_corners=1)
    dense, _ = he._split_levels(exact)
    Ld, total = len(dense), exact.total_table_size
    planes = _rand((2, total), rng)
    stats.update({n: {"max_abs_err": 0.0} for n in ("dense_levels_fwd", "dense_levels_bwd")})
    stats["dense_levels_fwd"]["shapes"] = {}
    for N in (196_608, 524_288):
        x, y, z = _positions(N, rng)
        for dt in (torch.float32, torch.bfloat16):
            got = he.dense_levels_fwd(exact, planes, x, y, z, dt)
            ref, _ = he.dense_levels_fwd_plain(exact, planes, x, y, z, dt)
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                raise AssertionError(f"dense_levels_fwd exact N={N} {dt}: kernel != plain "
                                     f"(max |err| {float((got.float() - ref.float()).abs().max())})")
        touched = torch.unique(he._dense_corner_arrays(dense, x, y, z, torch.float32)[0]).numel()
        t = _time_kernel(lambda: he.dense_levels_fwd(exact, planes, x, y, z, torch.bfloat16),
                         lambda: he.dense_levels_fwd_plain(exact, planes, x, y, z, torch.bfloat16), None,
                         _k4_bound(exact, x, y, z, torch.bfloat16))
        phase(f"dense_levels_fwd exact N={N}: kernel == plain bit for bit (f32 and bf16); "
              f"{touched:,} of {he._dense_width(dense):,} dense entries touched")
        phase(f"  dense_levels_fwd exact bf16 N={N}: " + _timing_line(t))
        if N == 196_608:  # the --fp32 tuned step's call (exact f32), on seeded positions
            _k4_timed(stats["dense_levels_fwd"]["shapes"], "fp32_seeded", exact, planes, x, y, z, torch.float32)

    N = 196_608
    x, y, z = _positions(N, rng)
    sel = torch.empty(Ld, N, dtype=torch.int32, device="cuda")
    got = he.dense_levels_fwd(dc1, planes, x, y, z, torch.bfloat16, sel=sel)
    ref, plan = he.dense_levels_fwd_plain(dc1, planes, x, y, z, torch.bfloat16)
    if not torch.equal(sel.long(), plan) or got.dtype != torch.float32 or not torch.equal(got, ref):
        raise AssertionError("dense_levels_fwd k=1: plan or output differs from the plain version")
    t = _time_kernel(lambda: he.dense_levels_fwd(dc1, planes, x, y, z, torch.bfloat16),
                     lambda: he.dense_levels_fwd_plain(dc1, planes, x, y, z, torch.bfloat16), None,
                     _k4_bound(dc1, x, y, z, torch.bfloat16))
    phase(f"dense_levels_fwd k=1 N={N}: sel == plain plan, output == plain (torch.equal)")
    phase(f"  dense_levels_fwd k=1 N={N}: " + _timing_line(t))

    g = _rand((2, Ld, N), rng).to(torch.bfloat16)
    for label, spec, dt in (("exact bf16", exact, torch.bfloat16), ("exact f32", exact, torch.float32),
                            ("gd=1", dataclasses.replace(exact, dense_grad_levels=1), torch.bfloat16),
                            ("gd=2", dataclasses.replace(exact, dense_grad_levels=2), torch.bfloat16),
                            ("k=1", dc1, torch.bfloat16)):
        gt = g.to(dt)
        got = he.dense_levels_bwd(spec, gt, x, y, z, dt)
        ref = he.dense_levels_bwd_plain(spec, gt, x, y, z, dt)
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"dense_levels_bwd {label}: kernel != plain")
        idx, v0, v1 = got
        one = torch.ones_like(v0)
        err = _check_scatter(f"table_grad_scatter on dense_levels_bwd {label}",
                             he.table_grad_scatter(idx, v0, v1, _zeros2(total)),
                             he.table_grad_scatter_plain(idx, v0, v1, _zeros2(total)),
                             he.table_grad_scatter_plain(idx, v0.abs(), v1.abs(), _zeros2(total)),
                             he.table_grad_scatter_plain(idx, one, one, _zeros2(total)))
        stats["table_grad_scatter"]["max_abs_err"] = max(stats["table_grad_scatter"]["max_abs_err"], err)
        t = _time_kernel(lambda: he.dense_levels_bwd(spec, gt, x, y, z, dt),
                         lambda: he.dense_levels_bwd_plain(spec, gt, x, y, z, dt), None,
                         _dense_bwd_bound(spec, gt, x, y, z, idx.numel()))
        phase(f"dense_levels_bwd {label} N={N}: K={idx.numel():,} staged entries == plain (torch.equal); "
              f"K3 on them within the atomic-order bound, max |err| {err:.3g}")
        phase(f"  dense_levels_bwd {label}: " + _timing_line(t))


def _zeros2(T: int):
    import torch

    return torch.zeros(2, T, device="cuda")


def _k2_count(spec, g, x, y, z, total: int):
    """Terms per entry ([2, total] float32) of K2's scatter: the plain
    version's entries (hash_bwd_entries), each counted once."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    idx, _, _ = he.hash_bwd_entries(spec, g, x, y, z)
    one = torch.ones(idx.shape[0], device=idx.device)
    return he.table_grad_scatter_plain(idx, one, one, _zeros2(total))


def _check_scatter(label: str, got, ref, mass, count) -> float:
    """max |got - ref| of two table gradients summed by atomics in a free
    order, held per entry to 2 * max(n, 8) * 2^-24 * sum|terms|, n the
    entry's terms (``count``; ``_k2_count`` for K2): an f32 sum of n terms
    in any order lies within (n - 1) * 2^-24 * sum|terms| of the exact sum,
    so two such sums within twice that."""
    bound = 2.0 * count.clamp_min(8.0) * 2.0**-24 * mass + 1e-30
    err = (got - ref).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"{label}: kernel vs plain max |err| {float(err.max())} beyond the atomic-order bound")
    return float(err.max())


TIMING_SETS = 3  # (p, k, k, p) sets a timing takes at most, until one set's two runs of each agree
TIMING_AGREE = 1.25  # the largest ratio between two runs of one set that counts as agreement


def _agree(a: float, b: float) -> bool:
    return max(a, b) <= TIMING_AGREE * min(a, b)


FLUSH_EVENT = "Memcpy DtoD"  # the L2 flush's device event, left out of the times it precedes


def _l2_flush():
    """A call that streams twice the L2's size through it (one
    device-to-device copy, FLUSH_EVENT in a trace), so that the call after
    it finds nothing of its own in the L2."""
    import torch

    src = torch.empty(H100_L2_BYTES // 2, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)


def _time_kernel(kern, plain, library, bound, library_name: str = "index_add_", fill=None, flush=None) -> dict:
    """Device ms per call (_time_ms) of a kernel's wrapper and its plain
    version, in sets of runs p, k, k, p, of its one-call library yardstick
    where there is one (runs l, l), beside its bound (or None); and the
    wrapper's wall ms per call (_wall_ms, the host's Python included).
    A set whose two kernel runs or two plain runs differ by more than
    TIMING_AGREE times is taken again, up to TIMING_SETS sets; every run is
    kept and ms and plain_ms are the medians over all sets' runs. Raises
    if no set agrees. ``fill``: the caller's zero fill of the columns a
    scatter adds into, which kern, plain and library leave out (their adds
    pile up over the runs); it is timed alone and in front of the wrapper
    (the combined figure). ``flush`` (_l2_flush): run in front of every
    call of kern and plain and left out of their times, so that each call
    starts with an L2 that holds none of its bytes."""
    skip = None
    if flush is not None:
        kern_alone, plain_alone = kern, plain
        kern, plain, skip = (lambda: (flush(), kern_alone())), (lambda: (flush(), plain_alone())), FLUSH_EVENT
    sets, known = [], {}  # known: each fn's events in one call, traced once (_time_ms)
    for _ in range(TIMING_SETS):
        sets.append(tuple(_time_ms(fn, skip=skip, rest=flush, known=known) for fn in (plain, kern, kern, plain)))
        if _agree(sets[-1][1], sets[-1][2]) and _agree(sets[-1][0], sets[-1][3]):
            break
    else:
        raise AssertionError(f"{TIMING_SETS} timing sets (p, k, k, p) in a row disagree by more than "
                             f"{TIMING_AGREE}x: " + "; ".join(", ".join(f"{v * 1e3:.1f}" for v in r) for r in sets))
    lib = (_time_ms(library, known=known), _time_ms(library, known=known)) if library is not None else ()
    t = {"ms": float(np.median([r[i] for r in sets for i in (1, 2)])),
         "plain_ms": float(np.median([r[i] for r in sets for i in (0, 3)])),
         "library_ms": sum(lib) / 2 if lib else None, "library_name": library_name, "bound": bound,
         "sets": sets, "library_runs": lib, "wall_ms": _wall_ms(kern if flush is None else kern_alone),
         "flushed": flush is not None}
    if fill is not None:
        t["fill_ms"] = _time_ms(fill)
        t["with_fill_ms"] = _time_ms(lambda: (fill(), kern()))
    return t


def _timing_line(t: dict) -> str:
    r = " | ".join(", ".join(f"{v * 1e3:.1f}" for v in runs) for runs in t["sets"])
    if t["library_ms"] is not None:
        r += " | " + ", ".join(f"{v * 1e3:.1f}" for v in t["library_runs"])
    lib = "" if t["library_ms"] is None else f", {t['library_name']} {t['library_ms'] * 1e3:.1f} us"
    order = ("p,k,k,p" + " | p,k,k,p" * (len(t["sets"]) - 1) + (" | l,l" if t["library_ms"] is not None else ""))
    bound = "" if t["bound"] is None else f", bound {t['bound'][0] * 1e3:.1f} us ({t['bound'][1]})"
    if "sectors" in t:  # K1: the bound had it written a float32 output; its random reads
        bound += (f" (with a float32 output {t['bound_f32_out'][0] * 1e3:.1f} us; {t['sectors']:,} random 4-byte "
                  f"reads, one 32-byte sector each: {t['sectors'] * 32 / t['ms'] / 1e9:.2f} TB/s of sectors)")
    if "bound_f32_out" in t and "sectors" not in t:  # K4's k-corner modes
        bound += f" (with a float32 output {t['bound_f32_out'][0] * 1e3:.1f} us)"
    if "kernel_ms" in t:  # K4: its own kernel, net of the pack in front of it, against the same bound
        bound += (f"; the kernel alone {t['kernel_ms'] * 1e3:.1f} us, the pack {(t['ms'] - t['kernel_ms']) * 1e3:.1f} us "
                  f"of the call; the call at {t['bound'][0] / t['ms']:.0%} of the bound, the kernel alone at "
                  f"{t['bound'][0] / t['kernel_ms']:.0%}")
    if t["bound"] is not None and t["ms"] < t["bound"][0]:
        flushed = t.get("flushed_timing")
        if flushed is not None and flushed["ms"] >= t["bound"][0]:
            bound += (f"; time below bound; with the L2 flushed in front of every call {flushed['ms'] * 1e3:.1f} us, "
                      "at or above it, so the bytes it counts stayed in the L2 between calls")
        else:
            bound += "; time below bound"
    fill = "" if "fill_ms" not in t else (f"; net of the caller's zero fill, which takes {t['fill_ms'] * 1e3:.1f} us "
                                          f"alone; fill + kernel {t['with_fill_ms'] * 1e3:.1f} us")
    flushed = "; the L2 flushed in front of every call (the flush left out)" if t.get("flushed") else ""
    return (f"device: kernel {t['ms'] * 1e3:.1f} us, plain {t['plain_ms'] * 1e3:.1f} us{lib} per call, medians "
            f"(runs {order}: {r}){bound}; wall per kernel call {t['wall_ms'] * 1e3:.1f} us{fill}{flushed}")


STEP_KERNELS = ("hash_levels_fwd", "dense_levels_fwd", "dense_levels_bwd", "hash_levels_bwd", "table_grad_scatter")
FEATURE_LAST_KERNELS = ("hashgrid_fwd", "hashgrid_bwd")  # the point-major encode's: render_rays' path only


def _planar_launches() -> dict:
    """The hash-encode launch counts of the feature-major paths (train,
    extract, eval render): every key but FEATURE_LAST_KERNELS."""
    from nerfjax_torch.ops import hash_encode as he

    return {k: v for k, v in he.launch_counts.items() if k not in FEATURE_LAST_KERNELS}


@contextlib.contextmanager
def _recorded(*targets):
    """Within the block each (module, name) of ``targets`` records its
    calls. Yields {N: {name: (args, kwargs) of its last call at N}}: N is
    the call's point count, the last dimension of its third argument (x of
    the hash-encode wrappers, sh of the head; enc, the second, of the
    density head); table_grad_scatter, which
    takes no positions, is filed under the N of the call before it, the
    dense-level staging whose entries it adds."""
    seen, wrapped, n = {}, [], [None]
    for module, name in targets:
        fn = getattr(module, name)

        def record(*args, _name=name, _fn=fn, **kw):
            if _name != "table_grad_scatter":
                n[0] = args[1 if _name == "fused_ngp_density" else 2].shape[-1]
            seen.setdefault(n[0], {})[_name] = (args, kw)
            return _fn(*args, **kw)

        wrapped.append((module, name, fn))
        setattr(module, name, record)
    try:
        yield seen
    finally:
        for module, name, fn in wrapped:
            setattr(module, name, fn)


def capture_step_inputs(state, batch, names=STEP_KERNELS) -> dict:
    """The arguments that the named hash-encode wrappers (K1, K4, K5, K2 and
    K3 by default) get in one warm train step, {N: {name: (args, kwargs)}}: one entry
    for each field pass of N points (the single-pass step has one, the
    two-pass step a coarse and a fine one), with the step's own positions,
    table, plan and upstream gradients. The encode of an occupancy update,
    which has no backward, is left out."""
    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import train_step

    with _recorded(*((he, name) for name in names)) as seen:
        train_step(state, batch)
    passes = {N: calls for N, calls in seen.items() if calls.keys() == set(names)}
    if not passes:
        raise AssertionError(f"no field pass of the step called all of {names}: {[sorted(c) for c in seen.values()]}")
    return passes


def _pack_library(f32: bool):
    """(one PyTorch call computing pack_pairs, its name): the yardstick,
    timed only; the port never calls it."""
    import torch

    if f32:
        return (lambda c: c.t().contiguous()), "t().contiguous()"
    return ((lambda c: c.t().to(torch.bfloat16, memory_format=torch.contiguous_format).view(torch.int32)),
            "t().to(bfloat16).view(int32)")


def _cycled(fn, inputs: list):
    """A call of fn on each of ``inputs`` in turn."""
    it = itertools.cycle(inputs)
    return lambda: fn(next(it))


def _k1_bounds(spec, x, y, z, plan, out_bytes: int):
    """K1's bound at one call, twice: with out_bytes per output value (the
    output it writes), and with the float32 output it wrote before it
    stored in the encode's dtype. Bytes: positions in, both planes of each
    distinct entry read (k corners: the planned ones, ``plan``; exact:
    every corner's), the [2, Lh, N] output out; operations per (level,
    point): _plan_ops(k), 110 exact."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    _, hashed = he._split_levels(spec)
    Lh, N = len(hashed), x.shape[0]
    idx = torch.stack(he._hash_level_indices(spec, hashed, x, y, z)) if plan is None else plan
    touched, ops = torch.unique(idx).numel(), (110 if plan is None else _plan_ops(spec.fwd_corners)) * Lh * N
    return tuple(_bound(8 * touched + 12 * N + 2 * b * Lh * N, ops) for b in (out_bytes, 4))


def _k1_at_call(spec, planes, x, y, z, out, label: str, timed: bool):
    """K1 on the arguments of one main-path call, against its plain version
    with torch.equal (k corners: its plan too, through sel). Where the call
    wrote into the encode's output (``out``: a [2, Lh, N] slice of it, in
    the encode's dtype) the kernel writes into a fresh buffer of the same
    dtype and strides and is held to the plain output cast to that dtype.
    Timed (runs p, k, k, p) beside both bounds (_k1_bounds) if ``timed``:
    returns the timing, else None."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    k = spec.fwd_corners
    Lh, N = len(he._split_levels(spec)[1]), x.shape[0]
    ref, plan = he.hash_levels_fwd_plain(spec, planes, x, y, z)
    sel = torch.empty(plan.shape, dtype=torch.int32, device=x.device) if k < 8 else None
    if out is None:
        got = he.hash_levels_fwd(spec, planes, x, y, z, sel=sel)
        call = lambda: he.hash_levels_fwd(spec, planes, x, y, z)  # noqa: E731
    else:
        buf = torch.empty_strided(out.shape, out.stride(), dtype=out.dtype, device=out.device)
        got = he.hash_levels_fwd(spec, planes, x, y, z, sel=sel, out=buf)
        ref = ref.to(out.dtype)
        call = lambda: he.hash_levels_fwd(spec, planes, x, y, z, out=buf)  # noqa: E731
    if got.dtype != ref.dtype or not torch.equal(got, ref) or (k < 8 and not torch.equal(sel.long(), plan)):
        raise AssertionError(f"hash_levels_fwd ({label}, N={N:,}): kernel != plain (output or plan)")
    if not timed:
        return None
    bound, bound_f32 = _k1_bounds(spec, x, y, z, plan, got.element_size())
    t = _time_kernel(call, lambda: he.hash_levels_fwd_plain(spec, planes, x, y, z), None, bound)
    # sectors: k = 1 both planes of its planned corner; k >= 2 one packed word a planned entry, exact a corner
    t.update(N=N, bound_f32_out=bound_f32, sectors=(2 if k == 1 else k) * Lh * N)
    return t


def grid_update_k1(state) -> dict:
    """K1 at the occupancy-grid update's call (train.update_occupancy, every
    occ_update_every steps; N = resolution^3 / partitions jittered cell
    centres, no backward): its arguments recorded in one update of a warm
    state, K1 held to plain and timed there (_k1_at_call)."""
    from nerfjax_torch import train
    from nerfjax_torch.ops import hash_encode as he

    every = state.settings.occ_spec().update_every
    state.step = -(-state.step // every) * every
    with _recorded((he, "hash_levels_fwd")) as seen:
        train.update_occupancy(state)
    ((_, calls),) = seen.items()
    (spec, planes, x, y, z), kw = calls["hash_levels_fwd"]
    t = _k1_at_call(spec, planes.detach(), x, y, z, kw.get("out"), "the grid update", True)
    phase(f"hash_levels_fwd at the grid update's call (N={x.shape[0]:,}): kernel == plain (output and sel)")
    phase("  hash_levels_fwd at the grid update: " + _timing_line(t))
    return t


def launch_floor() -> float:
    """Device ms of a one-element kernel (an add into a one-element
    tensor), by _time_ms, twice: the least time a launch takes on the card,
    below which no kernel's time can fall whatever its bytes and
    operations."""
    import torch

    one = torch.zeros(1, device="cuda")
    add, known = (lambda: one.add_(1.0)), {}
    runs = [_time_ms(add, known=known) for _ in range(2)]
    phase(f"launch floor: a one-element kernel takes {sum(runs) / 2 * 1e3:.2f} us of device time "
          f"(runs {runs[0] * 1e3:.2f}, {runs[1] * 1e3:.2f})")
    return sum(runs) / 2


def step_kernels_vs_plain(cap: dict, label: str, stats: dict, timed=(), flushed=()) -> dict:
    """The hash kernels on the arguments they got in one field pass of a
    warm train step (one entry of capture_step_inputs), each that was
    captured: K1 and K4 equal to their plain versions, K5 equal with every
    staged entry handed to K3, K3 and K2 within the atomic-order bound;
    the worst errors folded into ``stats``. The kernels named in ``timed``
    are timed beside their bounds (K3 also beside index_add_); a timed
    scatter zeroes the columns its levels own in a [2, total] buffer and
    adds into it, as the encode's backward does with its one gradient.
    Those named in ``flushed`` are timed again with the L2 flushed in front
    of every call (_l2_flush), filed under their timing's "flushed_timing".
    Returns {name: timing}."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    kws = {name: kw for name, (_, kw) in cap.items()}
    cap = {name: args for name, (args, _) in cap.items()}
    spec = next(args[0] for name, args in cap.items() if name != "table_grad_scatter")
    dense, hashed = he._split_levels(spec)
    Ld, Lh, base, total = len(dense), len(hashed), hashed[0]["offset"], spec.total_table_size
    buf = torch.empty(2, total, device="cuda")
    out, checked = {}, []

    def fold(name, err):
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)

    def timing(name, kern, plain, library, bound, fill=None, library_name="index_add_"):  # bound: called only when timed
        if name in timed:
            out[name] = _time_kernel(kern, plain, library, bound(), library_name, fill=fill)
        if name in flushed:
            out[name]["flushed_timing"] = _time_kernel(kern, plain, None, out[name]["bound"], flush=_l2_flush())

    if "hash_levels_fwd" in cap:
        _, planes, x, y, z = cap["hash_levels_fwd"][:5]
        t = _k1_at_call(spec, planes.detach(), x, y, z, kws["hash_levels_fwd"].get("out"), label,
                        "hash_levels_fwd" in timed)
        if t is not None:
            out["hash_levels_fwd"] = t
        fold("hash_levels_fwd", 0.0)
        checked.append(f"K1 {'exact' if spec.fwd_corners == 8 else f'k={spec.fwd_corners} (output and sel)'} == plain")

    if "dense_levels_fwd" in cap:
        _, planes, x, y, z, dtype = cap["dense_levels_fwd"]
        planes, N = planes.detach(), x.shape[0]
        mode, _ = he._dense_mode(spec, Ld)
        t = _k4_at_call(spec, planes, x, y, z, dtype, kws["dense_levels_fwd"].get("out"), label,
                        "dense_levels_fwd" in timed)
        if t is not None:
            out["dense_levels_fwd"] = t
        fold("dense_levels_fwd", 0.0)
        checked.append(f"K4 {f'k={spec.dense_corners} (output and sel)' if mode == 1 else 'exact'} {dtype} == plain")
        T = he._dense_width(dense)
        cols, f32 = planes[:, :T], mode != 1 and dtype == torch.float32  # K4's table pass
        words = he.pack_pairs_plain(cols, f32).view(torch.int32).reshape(-1)
        if not torch.equal(he.pack_pairs(cols, f32).view(torch.int32).reshape(-1), words):
            raise AssertionError(f"pack_pairs ({label}): kernel != plain")
        fold("pack_pairs", 0.0)
        library, library_name = _pack_library(f32)
        if not torch.equal(library(cols).view(torch.int32).reshape(-1), words):
            raise AssertionError(f"pack_pairs ({label}): {library_name} != plain")
        if "pack_pairs" in timed:  # on copies that the L2 cannot hold all of: every call reads from HBM
            copies = [cols.clone() for _ in range(-(-H100_L2_BYTES * 2 // (8 * T)))]
            timing("pack_pairs", _cycled(lambda c: he.pack_pairs(c, f32), copies),
                   _cycled(lambda c: he.pack_pairs_plain(c, f32), copies), _cycled(library, copies),
                   lambda: _bound((16 if f32 else 12) * T, 2 * T), library_name=library_name)
            del copies
        checked.append(f"K4's pack of {T:,} dense columns == plain word for word")

    if "dense_levels_bwd" in cap:
        _, g, x, y, z, dtype = cap["dense_levels_bwd"]
        N = x.shape[0]
        mode, gd = he._dense_mode(spec, Ld)
        got = he.dense_levels_bwd(spec, g, x, y, z, dtype)
        ref = he.dense_levels_bwd_plain(spec, g, x, y, z, dtype)
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"dense_levels_bwd ({label}): kernel != plain")
        K = got[0].numel()
        b = he._dense_grad_corners(spec)
        if K != {0: 8 * Ld, 1: b * Ld, 2: 8 * gd}[mode] * N or not torch.equal(got[0], cap["table_grad_scatter"][0]):
            raise AssertionError(f"dense_levels_bwd ({label}): K3 did not get K5's {K:,} staged entries")
        fold("dense_levels_bwd", 0.0)
        timing("dense_levels_bwd", lambda: he.dense_levels_bwd(spec, g, x, y, z, dtype),
               lambda: he.dense_levels_bwd_plain(spec, g, x, y, z, dtype), None,
               lambda: _dense_bwd_bound(spec, g, x, y, z, K))
        checked.append(f"K5 {['exact', f'b={b}', f'{gd} of {Ld} levels'][mode]} {dtype}: {K:,} staged entries == plain, "
                       "all handed to K3")

    if "table_grad_scatter" in cap:
        idx, v0, v1, _ = cap["table_grad_scatter"]
        K, one = idx.shape[0], torch.ones_like(v0)
        got = he.table_grad_scatter(idx, v0, v1, _zeros2(total))
        err = _check_scatter(f"table_grad_scatter ({label})", got, he.table_grad_scatter_plain(idx, v0, v1, _zeros2(total)),
                             he.table_grad_scatter_plain(idx, v0.abs(), v1.abs(), _zeros2(total)),
                             he.table_grad_scatter_plain(idx, one, one, _zeros2(total)))
        hits = torch.bincount(idx.long(), minlength=total)[:base]
        if got[:, base:].abs().max() != 0 or int(hits.sum()) != K:
            raise AssertionError(f"table_grad_scatter ({label}): the dense-level gradient reached outside the dense columns")
        fold("table_grad_scatter", err)
        vv, cols = torch.stack([v0, v1]), buf[:, :base]  # the encode's backward hands K3 the dense columns
        # net bound: the staged entries in, 8 B out per distinct entry added to
        timing("table_grad_scatter", lambda: he.table_grad_scatter(idx, v0, v1, cols),
               lambda: he.table_grad_scatter_plain(idx, v0, v1, cols), lambda: buf.index_add_(1, idx, vv),
               lambda: _bound(12 * K + 8 * int((hits > 0).sum()), 2 * K), cols.zero_)
        checked.append(f"K3: {K:,} entries into {base:,} dense entries (at most {int(hits.max()):,} adds to one, median "
                       f"{int(hits[hits > 0].median())}) within the atomic-order bound, max |err| {err:.3g}")
        atomics = {"first": 2 * K, "runs": he.k3_atomic_count(idx, base)}
        checked.append(f"K3's atomics: {atomics['runs']:,} float2 adds of merged runs (the first design's 2*K: "
                       f"{atomics['first']:,} float adds)")
        if "table_grad_scatter" in out:
            out["table_grad_scatter"]["atomics"] = atomics

    if "hash_levels_bwd" in cap:
        _, g, x, y, z, _ = cap["hash_levels_bwd"]
        N = x.shape[0]
        mode, gl = he._bwd_mode(spec, Lh)
        b = he._grad_corners(spec)
        err = _check_scatter(f"hash_levels_bwd ({label})", he.hash_levels_bwd(spec, g, x, y, z, _zeros2(total)),
                             he.hash_levels_bwd_plain(spec, g, x, y, z, _zeros2(total)),
                             he.hash_levels_bwd_plain(spec, g.abs(), x, y, z, _zeros2(total)),
                             _k2_count(spec, g, x, y, z, total))
        fold("hash_levels_bwd", err)
        zero = g == 0  # the hashed rows of the encode's cotangent
        share = {"values": float(zero.float().mean()), "pairs": float((zero[0] & zero[1]).float().mean())}
        stats["hash_levels_bwd"].setdefault("zero_share", {})[label] = share
        checked.append(f"the hashed levels' cotangent: {share['values']:.2%} of its values 0, {share['pairs']:.2%} of "
                       "its (level, point) pairs 0 in both planes")

        def k2_bound():
            # net of the fill: positions in, the g rows read (under a level
            # subset only the drawn (level, point) pairs), 8 B out per distinct
            # entry added to. No one PyTorch call computes it: the indices are
            # computed inside
            row_ops = 110 if mode == 0 else _plan_ops(b) if b > 1 else 90
            pairs, ops = Lh * N, row_ops * Lh * N
            if mode == 2:
                ids = he._draw_levels(x, y, z, Lh, gl, he.LEVEL_SALT)
                pairs, ops = torch.unique(ids * N + torch.arange(N, device=x.device)).numel(), row_ops * gl * N
            hit = _zeros2(total)
            he.hash_levels_bwd_plain(spec, torch.ones_like(g), x, y, z, hit)
            return _bound(12 * N + 2 * g.element_size() * pairs + 8 * int((hit[0] != 0).sum()), ops)

        timing("hash_levels_bwd", lambda: he.hash_levels_bwd(spec, g, x, y, z, buf),
               lambda: he.hash_levels_bwd_plain(spec, g, x, y, z, buf), None, k2_bound, buf[:, base:].zero_)
        checked.append(f"K2 {['exact', f'b={b}', f'b={b} over {gl} of {Lh} levels'][mode]} within the atomic-order "
                       f"bound, max |err| {err:.3g}")
        atomics = None
        if mode == 0:
            atomics = {"first": 16 * Lh * N, "runs": he.k2_atomic_count(spec, x, y, z)}
            checked.append(f"K2 exact's atomics: {atomics['runs']:,} float2 adds of merged runs (the first design's "
                           f"16*Lh*N: {atomics['first']:,} float adds)")
        elif b >= 2 and mode == 1:
            atomics = {"first": 2 * b * Lh * N, "runs": 2 * he.k2_lr_atomic_count(spec, g, x, y, z)}
            checked.append(f"K2 b={b}'s atomics: {atomics['runs']:,} float adds of merged runs that hold a nonzero "
                           f"term ({int(he.k2_lr_runs(spec, x, y, z).sum()):,} runs of {b * Lh * N:,} terms; "
                           f"the first design's 2*b*Lh*N: {atomics['first']:,} float adds)")
        elif b >= 2:
            atomics = {"first": 2 * b * gl * N, "runs": 2 * he.k2_lr_atomic_count(spec, g, x, y, z)}
            checked.append(f"K2 b={b} over {gl} levels' atomics: {atomics['runs']:,} float adds of its terms that are "
                           f"not 0 (the first design's 2*b*gl*N: {atomics['first']:,} float adds)")
        if atomics is not None and "hash_levels_bwd" in out:
            out["hash_levels_bwd"]["atomics"] = atomics

    phase(f"hash kernels at the {label} (N={N:,}, {Ld} dense + {Lh} hashed levels): " + "; ".join(checked))
    for name, t in out.items():
        phase(f"  {name}: " + _timing_line(t))
        if "flushed_timing" in t:
            phase(f"  {name}, the L2 flushed in front of every call: " + _timing_line(t["flushed_timing"]))
    return out


def ray_npz(path: Path) -> None:
    """2^20 rays from 256 cameras on a sphere of radius 2.5 around a ball of
    constant density BALL_SIGMA and color BALL_RGB on a black background,
    each ray aimed at a random point of [-0.8, 0.8]^3. The color is exact
    volume rendering: BALL_RGB * (1 - exp(-sigma * chord)). t_near/t_far
    clip the ray to the [-1, 1]^3 cube."""
    rng = np.random.default_rng(SEED + 7)
    cams = rng.normal(size=(256, 3))
    cams = cams / np.linalg.norm(cams, axis=1, keepdims=True) * 2.5
    o = cams[rng.integers(0, 256, N_RAYS)]
    d = rng.uniform(-0.8, 0.8, (N_RAYS, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    oc = o - BALL_CENTER
    b = np.sum(oc * d, axis=1)
    disc = b * b - (np.sum(oc * oc, axis=1) - BALL_RADIUS**2)
    chord = 2.0 * np.sqrt(np.maximum(disc, 0.0))
    rgb = BALL_RGB[None, :] * (1.0 - np.exp(-BALL_SIGMA * chord))[:, None]
    dd = np.where(np.abs(d) < 1e-8, 1e-8, d)
    t0, t1 = (-1 - o) / dd, (1 - o) / dd
    near = np.maximum(np.minimum(t0, t1).max(1), 0.0)
    far = np.maximum(t0, t1).min(1)
    np.savez(path, rays_o=o.astype(np.float32), rays_d=d.astype(np.float32), rgbs=rgb.astype(np.float32),
             t_near=near.astype(np.float32), t_far=far.astype(np.float32))


def _idle_share(state, batches) -> tuple[float, float, float]:
    """(device busy ms, traced wall ms, idle share) of a torch.profiler
    trace over warm train steps ("Self CUDA time total" over the wall)."""
    import re

    import torch

    from nerfjax_torch.train import train_step

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches:
            train_step(state, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=20)
    print(table)
    m = re.search(r"Self CUDA time total:\s*([\d.]+)(us|ms|s)", table)
    if m is None:
        raise AssertionError("the profiler trace shows no device time")
    busy = float(m.group(1)) * {"us": 1e-3, "ms": 1.0, "s": 1e3}[m.group(2)]
    return busy, wall, 1.0 - busy / wall


def _encode_copies(state, batch) -> dict:
    """{"forward": [...], "backward": [...]}: (name, input shapes) of each
    copy or concat op (aten::_to_copy, aten::copy_, aten::cat) that runs
    inside the encode's forward (the autograd Function _HashEncode) and
    inside its backward (the node _HashEncodeBackward) in one warm train
    step traced by torch.profiler with its input shapes. A cast of a
    float32 encode part or of the hashed levels' cotangent shows as a copy
    of [2, Lh, N]; the concat of the two parts as an aten::cat."""
    import torch

    from nerfjax_torch.train import train_step

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        train_step(state, batch)
        torch.cuda.synchronize()
    found, seen = {"forward": [], "backward": []}, set()
    nodes = dict.fromkeys(found, 0)

    def walk(e, into):
        for c in e.cpu_children:
            if id(c) in seen:
                continue
            seen.add(id(c))
            if c.name in ("aten::_to_copy", "aten::copy_", "aten::cat"):
                into.append((c.name, [list(sh) for sh in c.input_shapes if sh]))
            walk(c, into)

    for e in prof.events():
        which = {"_HashEncode": "forward", "_HashEncodeBackward": "backward"}.get(e.name)
        if which is not None:
            nodes[which] += 1
            walk(e, found[which])
    if not all(nodes.values()):
        raise AssertionError(f"the traced step shows no _HashEncode forward or backward node: {nodes}")
    return found


def _report_encode_copies(state, batch, label: str) -> None:
    """Print the copies and concats inside the encode's forward and
    backward in one traced warm step (_encode_copies); fail if the forward
    concatenates (an aten::cat: K4 and K1 write their rows of one output)
    or casts a [2, Lh, N] part, or if the backward copies the hashed
    levels' cotangent ([2, Lh, N]: K2 reads it in place)."""
    from nerfjax_torch.ops import hash_encode as he

    Lh = len(he._split_levels(state.field.spec)[1])
    found = _encode_copies(state, batch)

    def hashed(ops):
        return [c for c in ops if c[1] and len(c[1][0]) == 3 and c[1][0][:2] == [2, Lh]]

    for which, ops in found.items():
        phase(f"the encode's {which} in one traced warm {label} step: {len(ops)} copy or concat ops ("
              + ", ".join(f"{n} {sh}" for n, sh in ops) + f"); of them on a [2, {Lh}, N] hashed part: "
              f"{len(hashed(ops))}")
    concats = [c for c in found["forward"] if c[0] == "aten::cat"]
    if concats or hashed(found["forward"]):
        raise AssertionError(f"the encode's forward concatenates or casts its parts again ({label} step): "
                             f"{found['forward']}")
    if hashed(found["backward"]):
        raise AssertionError(f"the encode's backward copies the hashed cotangent again ({label} step): "
                             f"{found['backward']}")


def _stage_split(state, batches) -> dict:
    """ms per step by stage of the real train_step over ``batches``, from
    CUDA events that wrappers record around its calls: the occupancy update
    (with a grid; amortised over the steps), the sampling before the first
    field pass, each field pass's forward (apply_planar), between two
    passes the coarse composite, sample_pdf and the sort, then the
    composites and losses with their backward up to the first gradient
    that reaches a field pass's outputs, the fields' backward (MLP and
    encode, all passes), AdamW with its schedule. Vanilla's two MLPs are
    wrapped alike."""
    import torch

    from nerfjax_torch import train

    fields, opt, s = state.fields(), state.optimizer, state.settings
    applies, update, adamw = [f.apply_planar for f in fields], train.update_occupancy, opt.step
    marks, total = [], {}

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    def backward_reached(_grad):
        if marks[-1][0].startswith("field forward"):  # the step's first gradient at a field pass's outputs
            mark("composite + loss, forward and backward")

    def timed(apply):
        def timed_apply(*args, **kw):
            i = sum(label.startswith("field forward") for label, _ in marks)
            mark(("occupancy sample" if s.use_occupancy else "stratified sample") if i == 0
                 else "coarse composite + pdf sample + sort")
            rgb, sigma = apply(*args, **kw)
            mark("field forward" + ("" if s.single_pass else " (coarse)" if i == 0 else " (fine)"))
            rgb.register_hook(backward_reached)
            sigma.register_hook(backward_reached)
            return rgb, sigma

        return timed_apply

    def timed_update(*args, **kw):
        update(*args, **kw)
        mark("occupancy update")

    def timed_adamw(*args, **kw):
        mark("field backward")
        return adamw(*args, **kw)

    for f, apply in zip(fields, applies):
        f.apply_planar = timed(apply)
    opt.step = timed_adamw
    if s.use_occupancy:
        train.update_occupancy = timed_update
    try:
        for b in batches:
            marks.clear()
            mark("")
            train.train_step(state, b)
            mark("AdamW + schedule")
            torch.cuda.synchronize()
            for (_, start), (label, end) in zip(marks, marks[1:]):
                total[label] = total.get(label, 0.0) + start.elapsed_time(end)
    finally:
        for f in fields:
            del f.apply_planar
        opt.step, train.update_occupancy = adamw, update
    return {k: v / len(batches) for k, v in total.items()}


def train_full(tmp: Path) -> dict:
    """The training path at full width, through nerfjax_torch.train.train."""
    import torch

    from nerfjax_torch.data import RayDataset, batch_to_device
    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import TrainSettings, make_train_state, train, train_step

    t0 = time.perf_counter()
    ray_npz(tmp / "rays.npz")
    phase(f"synthetic ray NPZ: {N_RAYS:,} rays in {time.perf_counter() - t0:.1f} s")
    cfg = {**TUNED_TRAIN, "num_epochs": TRAIN_EPOCHS, "rays_file": str(tmp / "rays.npz"),
           "output_dir": str(tmp / "out"), "checkpoint_dir": str(tmp / "out" / "checkpoints")}
    he.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(cfg, seed=SEED, log_every=64, device="cuda")
    wall = time.perf_counter() - t0
    launches = _planar_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    psnr = np.asarray(out["psnr"])
    first, last = float(psnr[:20].mean()), float(psnr[-20:].mean())
    phase(f"train(): {out['steps']} steps in {wall:.2f} s wall (checkpoint writes included) = "
          f"{wall / out['steps'] * 1e3:.2f} ms per step, PSNR first 20 steps {first:.2f} dB, last 20 {last:.2f} dB; "
          f"peak device memory {peak:.2f} GiB; launches {launches}")
    if not np.isfinite(psnr).all() or not all(np.isfinite(v["w"]).all() for v in out["params"]["dmlp"]):
        raise AssertionError("NaN in training")
    if last < first + PSNR_RISE_DB:
        raise AssertionError(f"PSNR rose {last - first:.2f} dB, expected >= {PSNR_RISE_DB}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the training path")
    final = Path(cfg["checkpoint_dir"]) / "nerf_final.pth"
    if not final.exists():
        raise AssertionError("nerf_final.pth was not written")

    # warm steps, timed: the real train_step with a sync per step, then the
    # split by stage, then a profiler trace
    settings = TrainSettings.from_cfg(cfg, out["steps"])
    state = make_train_state(cfg, settings, seed=SEED, device="cuda")
    data = RayDataset(cfg["rays_file"], verbose=False)
    batches = [batch_to_device(b, "cuda") for _, b in zip(range(64), data.epoch_batches(8192, seed=SEED))]
    for b in batches[:16]:
        train_step(state, b)
    torch.cuda.synchronize()
    times = []
    for b in batches[16:64]:
        t1 = time.perf_counter()
        train_step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    med = float(np.median(times))
    phase(f"warm train_step: median {med:.2f} ms/step over {len(times)} steps (min {min(times):.2f}, "
          f"max {max(times):.2f}; 3 of them update the grid) = {8192 / med * 1e3:,.0f} rays/s")
    split = _stage_split(state, batches[:32])
    phase("split, ms per step (CUDA events around train_step's calls, 32 steps, the grid update amortised over "
          "them): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f"; sum {sum(split.values()):.3f}")
    state.step = 1  # no grid update inside the traced window
    busy, traced, idle = _idle_share(state, batches[32:40])
    phase(f"profiler, 8 warm steps: device busy {busy:.2f} ms of {traced:.2f} ms traced wall: idle share {idle:.1%}")
    _report_encode_copies(state, batches[41], "tuned")
    torch.cuda.reset_peak_memory_stats()
    step_inputs = capture_step_inputs(state, batches[40])
    phase(f"one warm step (inputs captured): peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    grid_k1 = grid_update_k1(state)
    return {"cfg": cfg, "final": final, "launches": launches, "ms_per_step": med, "step_inputs": step_inputs,
            "grid_update_k1": grid_k1, "train_wall_ms_per_step": wall / out["steps"] * 1e3}


def train_dense_knob(tmp: Path, label: str, stats: dict) -> dict:
    """128 steps of the tuned cfg with one dense knob through
    nerfjax_torch.train.train on phase 7's NPZ: PSNR, NaNs, the five hash
    kernels' launches, K5's mode (the size of its staging in one captured
    warm step), a warm-step median; K4, K5, K3 and K2 on that step's
    inputs against their plain versions (errors folded into ``stats``), K4
    and K5 timed there."""
    import torch

    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import train

    cfg = {**TUNED_TRAIN, **DENSE_KNOBS[label], "num_epochs": 1, "rays_file": str(tmp / "rays.npz"),
           "output_dir": str(tmp / f"out_{label}"), "checkpoint_dir": str(tmp / f"out_{label}" / "checkpoints")}
    he.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(cfg, seed=SEED, log_every=64, device="cuda")
    wall = time.perf_counter() - t0
    launches = _planar_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    psnr = np.asarray(out["psnr"])
    first, last = float(psnr[:20].mean()), float(psnr[-20:].mean())
    phase(f"train() {label} {DENSE_KNOBS[label]}: {out['steps']} steps in {wall:.2f} s wall, PSNR first 20 steps "
          f"{first:.2f} dB, last 20 {last:.2f} dB; peak device memory {peak:.2f} GiB; launches {launches}")
    if not np.isfinite(psnr).all() or not all(np.isfinite(v["w"]).all() for v in out["params"]["dmlp"]):
        raise AssertionError(f"NaN in training ({label})")
    if last < first + PSNR_RISE_DB:
        raise AssertionError(f"PSNR rose {last - first:.2f} dB ({label}), expected >= {PSNR_RISE_DB}")
    for name, n in launches.items():
        if n < (out["steps"] if name.startswith("dense") else 1):
            raise AssertionError(f"{name} launched {n} times in {out['steps']} steps ({label})")

    state, left, med = _warm_steps(cfg, tmp / "rays.npz", 16, 32, label)
    mode = he._dense_mode(state.field.spec, len(he._split_levels(state.field.spec)[0]))
    if mode != {"dgl1": (2, 1), "dc1": (1, 0)}[label]:
        raise AssertionError(f"{label}: the field's dense mode is {mode}")
    (cap,) = capture_step_inputs(state, left[0]).values()
    # K5 at dgl1 stages 18.9 MB that stay in the L2 between the timer's calls: timed again with it flushed
    timings = step_kernels_vs_plain(cap, f"{label} step", stats,
                                    ("hash_levels_fwd", "dense_levels_fwd", "dense_levels_bwd"),
                                    ("dense_levels_bwd",) if label == "dgl1" else ())
    return {"ms_per_step": med, "launches": launches, "timings": timings}


def extract_trained(cfg: dict, final: Path, center=BALL_CENTER, radius: float = BALL_RADIUS,
                    label: str = "trained field") -> float:
    """The trained checkpoint extracted at 256^3 with the port; the occupied
    voxels against the ball (by default the analytic one); its IoU, which
    must be >= 0.5."""
    from nerfjax_torch.extract import extract_volume

    res = 256
    vol = extract_volume({**cfg, "checkpoint": str(final)}, resolution=res, device="cuda", verbose=False)
    occ = vol["occupancy_volume"].astype(bool)
    c = -1.0 + np.arange(res) * (2.0 / (res - 1))
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    ball = (X - center[0]) ** 2 + (Y - center[1]) ** 2 + (Z - center[2]) ** 2 <= radius**2
    iou = float((occ & ball).sum() / max((occ | ball).sum(), 1))
    phase(f"{label} at {res}^3: occupied {occ.mean():.2%} of voxels, ball {ball.mean():.2%}, IoU {iou:.3f}; "
          f"threshold {vol['metadata']['threshold']:.4f}; " + _phases(vol["metadata"]))
    if iou < 0.5:
        raise AssertionError(f"{label}: IoU with the ball {iou:.3f} < 0.5")
    return iou


def step_card_vs_cpu(tmp: Path, label: str) -> None:
    """One train step at the CPU tests' small size in float32 on the card
    (kernels) and on the CPU (plain versions), with the tuned estimators
    and, unless ``label`` is "tuned", one of DENSE_KNOBS; or ("fast",
    "fast bf16") with the fast cfg's estimators (the exact forward, the
    k = 2 table gradient) in float32 or bf16: the same parameters, batch,
    update jitter and sampler uniforms. The grid update runs first on both
    (the MLP products sum in another order on each device: grids within
    1e-5 relative); the step then runs on the CPU's grid on both, so the
    samples and the draws are the same bits. bf16 is held to the CPU tests'
    bf16 step bound (_steps_agree)."""
    import torch

    from nerfjax_torch.data import RayDataset, batch_to_device
    from nerfjax_torch.ops.occupancy import draw_update_jitter
    from nerfjax_torch.train import TrainSettings, make_train_state, train_step, update_occupancy

    if label.startswith("fast"):
        cfg = {**FAST_SMALL, "num_epochs": 1, "precision": "bf16" if label.endswith("bf16") else "fp32"}
    else:
        cfg = {**SMALL_TRAIN, **DENSE_KNOBS.get(label, {}), "num_epochs": 1}
    settings = TrainSettings.from_cfg(cfg, 100)
    cpu = make_train_state(cfg, settings, seed=SEED, device="cpu")
    card = make_train_state(cfg, settings, seed=SEED, device="cuda")
    batch = next(RayDataset(tmp / "rays.npz", verbose=False).epoch_batches(256, seed=SEED))
    jitter = draw_update_jitter(settings.occ_spec(), torch.Generator().manual_seed(1), "cpu")
    xi = torch.rand(256, cfg["N_samples"] + cfg["N_importance"], generator=torch.Generator().manual_seed(2))
    update_occupancy(cpu, jitter=jitter)
    update_occupancy(card, jitter=jitter.cuda())
    gerr = float(((card.occ_grid.cpu() - cpu.occ_grid).abs() / cpu.occ_grid.abs().clamp_min(1e-30)).max())
    if gerr > 1e-5:
        raise AssertionError(f"grid update card vs cpu: {gerr}")
    card.occ_grid = cpu.occ_grid.cuda()
    cpu.step = card.step = 1
    m_cpu = train_step(cpu, batch_to_device(batch, "cpu"), u_strat=xi)
    m_card = train_step(card, batch_to_device(batch, "cuda"), u_strat=xi.cuda())
    bf16 = cfg["precision"] == "bf16"
    lerr, worst = _steps_agree(cpu, card, m_cpu, m_card, cfg["lr"], ("loss_fine",), bf16)
    phase(f"train step card vs cpu ({cfg['precision']}, small, {label}): grid rel err {gerr:.2g}, loss rel err "
          f"{lerr:.2g}, gradients within rtol {2e-2 if bf16 else 1e-4:g}, parameters after AdamW within {worst:.2g} "
          f"(bound {(5e-2 if bf16 else 1e-3) * cfg['lr']:.1g})")


def _steps_agree(cpu, card, m_cpu, m_card, lr: float, losses, bf16: bool = False) -> tuple[float, float]:
    """Phase 9's rule for one fp32 step on the CPU and on the card: each of
    ``losses`` within 1e-5 relative, every gradient within rtol 1e-4 (atol
    1e-4 x its largest entry), every parameter after AdamW within 1e-3 x lr
    at entries whose CPU gradient exceeds 1e-6; ``bf16``: the CPU tests'
    bf16 step bound (tests/test_torch_train_step.py), losses and gradients
    within 2e-2, parameters within 5e-2 x lr. Returns (worst loss error,
    worst parameter error)."""
    import torch

    rtol, ptol = (2e-2, 5e-2) if bf16 else (1e-4, 1e-3)
    lerr = max(abs(float(m_card[k]) - float(m_cpu[k])) / float(m_cpu[k]) for k in losses)
    if lerr > (2e-2 if bf16 else 1e-5):
        raise AssertionError(f"loss card vs cpu: relative {lerr}")
    worst = 0.0
    for (name, pc), pk in zip(cpu.field.named_parameters(), card.field.parameters()):
        gc, gk = pc.grad, pk.grad.cpu()
        if not torch.allclose(gk, gc, rtol=rtol, atol=rtol * float(gc.abs().max())):
            raise AssertionError(f"gradient of {name} card vs cpu")
        sure = gc.abs() > 1e-6
        d = float((pk.detach().cpu() - pc.detach()).abs()[sure].max()) if bool(sure.any()) else 0.0
        if d > ptol * lr:
            raise AssertionError(f"{name} after AdamW card vs cpu: {d}")
        worst = max(worst, d)
    return lerr, worst


# -- the fast operating point and the k >= 2 estimators -----------------------

# the model and training keys of cfg/blender_scene_fast.yml (NGP-large, 16
# levels: 4 dense + 12 hashed, E = 32; single pass, 16 + 32 samples from the
# grid's exact CDF sampler over 128 segments; bf16; the exact forward with
# the k = 2 leader + residual table gradient), stated so the script needs no
# PyYAML
FAST_TRAIN = {"ngp": True, "nerf_type": "large", "batch_size": 8192, "lr": 0.0005, "N_samples": 16,
              "N_importance": 32, "white_bg": False, "precision": "bf16", "occupancy_grid": True,
              "single_pass": True, "hash_grad_corners": 2, "occ_resolution": 128, "occ_update_every": 16}
FAST_PSNR_DB = 30.0  # the least mean PSNR of the fast run's last 20 steps on the ball
# the k >= 2 knob run: the tuned cfg with every corner estimator at 2 and gl 2
K2_KNOB = {"hash_fwd_corners": 2, "hash_grad_corners": 2, "hash_dense_corners": 2, "hash_grad_levels": 2}
K2_STEPS = 32
# the CPU tests' small size with the fast estimators (tests/test_torch_train_step.py's FAST)
FAST_SMALL = {**FAST_TRAIN, "nerf_type": "small", "hash_n_levels": 8, "batch_size": 256, "lr": 5e-3,
              "precision": "fp32", "occ_resolution": 16, "occ_segments": 8}
LR_KS = (2, 3, 7)


def _warm_steps(cfg: dict, data_path: Path, n_warm: int, n_timed: int, label: str, batch_size: int = 8192):
    """A fresh state for ``cfg`` trained n_warm steps, then n_timed steps
    each timed with a sync (the median printed): (state, batches left
    over, median ms/step). The batches are the NPZ's first, in order."""
    import torch

    from nerfjax_torch.data import RayDataset, batch_to_device
    from nerfjax_torch.train import TrainSettings, make_train_state, train_step

    data = RayDataset(data_path, verbose=False)
    total = n_warm + n_timed + 12
    batches = [batch_to_device(b, "cuda") for _, b in zip(range(total), data.epoch_batches(batch_size, seed=SEED))]
    state = make_train_state(cfg, TrainSettings.from_cfg(cfg, 128), seed=SEED, device="cuda")
    for b in batches[:n_warm]:
        train_step(state, b)
    torch.cuda.synchronize()
    times = []
    for b in batches[n_warm:n_warm + n_timed]:
        t1 = time.perf_counter()
        train_step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    med = float(np.median(times))
    phase(f"warm train_step {label}: median {med:.2f} ms/step over {len(times)} steps (min {min(times):.2f}, "
          f"max {max(times):.2f}) = {batch_size / med * 1e3:,.0f} rays/s")
    return state, batches[n_warm + n_timed:], med


def train_fast(tmp: Path, stats: dict) -> dict:
    """cfg/blender_scene_fast.yml's model and estimators at full width
    through nerfjax_torch.train.train for 128 steps on phase 7's NPZ:
    PSNR (first and last 20 steps; the last >= FAST_PSNR_DB), NaNs, every
    hash kernel launched each step, K2 planning b = 2 corners; then a warm
    median, the device busy time of 8 warm steps (profiler), and every hash
    kernel on one warm step's captured calls against its plain version, K2
    k = 2 timed there beside its bound."""
    import torch

    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import train

    cfg = {**FAST_TRAIN, "num_epochs": 1, "rays_file": str(tmp / "rays.npz"), "output_dir": str(tmp / "out_fast"),
           "checkpoint_dir": str(tmp / "out_fast" / "checkpoints")}
    he.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(cfg, seed=SEED, log_every=64, device="cuda")
    wall = time.perf_counter() - t0
    launches = _planar_launches()
    psnr = np.asarray(out["psnr"])
    first, last = float(psnr[:20].mean()), float(psnr[-20:].mean())
    phase(f"train() fast (cfg/blender_scene_fast.yml's model and estimators): {out['steps']} steps in {wall:.2f} s "
          f"wall, PSNR first 20 steps {first:.2f} dB, last 20 {last:.2f} dB; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
    if not np.isfinite(psnr).all() or not all(np.isfinite(v["w"]).all() for v in out["params"]["dmlp"]):
        raise AssertionError("NaN in training (fast)")
    if last < FAST_PSNR_DB:
        raise AssertionError(f"fast run: PSNR of the last 20 steps {last:.2f} dB < {FAST_PSNR_DB}")
    for name, n in launches.items():
        if n < out["steps"]:
            raise AssertionError(f"{name} launched {n} times in {out['steps']} fast steps")

    state, left, med = _warm_steps(cfg, tmp / "rays.npz", 16, 32, "fast")
    spec = state.field.spec
    dense, hashed = he._split_levels(spec)
    if (len(dense), len(hashed), spec.hashmap_size, spec.fwd_corners, he._grad_corners(spec),
            he._bwd_mode(spec, len(hashed))) != (4, 12, 2**19, 8, 2, (1, 0)):
        raise AssertionError(f"fast: the field's spec is not the fast cfg's: {spec}")
    state.step = 1  # no grid update inside the traced window
    busy, traced, idle = _idle_share(state, left[:8])
    phase(f"profiler, 8 warm fast steps: device busy {busy:.2f} ms of {traced:.2f} ms traced wall: idle share "
          f"{idle:.1%}")
    (cap,) = capture_step_inputs(state, left[8]).values()
    _, g, x, y, z, _ = cap["hash_levels_bwd"][0]
    K = he.hash_bwd_entries(spec, g, x, y, z)[0].numel()
    if K != 2 * len(hashed) * x.shape[0]:
        raise AssertionError(f"fast: K2's plan holds {K:,} terms, not b = 2 per hashed level and point")
    phase(f"fast step: K2 plans b = 2 corners (leader + 1 residual draw): {K:,} terms over {len(hashed)} levels x "
          f"{x.shape[0]:,} points")
    timings = step_kernels_vs_plain(cap, "fast step", stats, STEP_KERNELS)
    return {"launches": launches, "ms_per_step": med, "timings": timings, "psnr": (first, last), "busy_ms": busy,
            "traced_ms": traced, "idle": idle}


# benchmarks/psnr_parity.py's protocol (run_one :267-319, _cfg :75-215,
# _eval_psnr :238-264), repeated on the port: NGP-medium, batch 2048, 600
# steps (12 epochs of 50) on tests/synthetic.py's sphere (the tuned arm:
# NGP-large, batch 8192), eval at uniform 64 + 128 on 4,096 held-out rays of
# seed 9999 through render_rays in f32
PARITY_BATCH = 2048
PARITY_TUNED_ARM = "spass12Led1k1f1scns24gl2sg32"  # cfg/blender_scene_tuned.yml's estimators
PARITY_ARMS = {"spass2": ("medium", PARITY_BATCH), "spass8": ("medium", PARITY_BATCH),
               PARITY_TUNED_ARM: ("large", 8192)}  # arm -> (nerf_type, batch) of its psnr_parity.json rows
PARITY_STEPS = 600
PARITY_STEPS_PER_EPOCH = 50  # psnr_parity.STEPS_PER_EPOCH: the training NPZ holds batch * 50 rays
PARITY_EVAL_RAYS = 4096
PARITY_EVAL_SEED = 9999
PARITY_EVAL_SAMPLES = (64, 128)
PARITY_SEEDS = (0, 1, 2)
# nerfjax's eval PSNR in dB for seeds 0, 1, 2 (benchmarks/psnr_parity.json:
# sphere, 600 steps, each arm's nerf_type and batch): a quality number of the
# method, not a time
PARITY_NERFJAX_DB = {"spass2": (32.091, 32.010, 31.625), "spass8": (33.117, 31.066, 31.854),
                     PARITY_TUNED_ARM: (32.818, 32.748, 32.335)}
PARITY_FLOOR_DB = 30.0  # the least mean eval PSNR of an arm's seeds
# the least eval PSNR of every run: a step that does not learn stays near the
# sphere's first PSNR (~7 dB), while a healthy run of this protocol spreads
# over a few dB by seed (on an H100 spass2 seed 1 lands at 29.6-29.7 dB;
# nerfjax's spass8 seeds span 31.07-33.12)
PARITY_RUN_FLOOR_DB = 25.0
PARITY_SEED_SLACK_DB = 0.5  # a run in range lies at most this far below nerfjax's lowest seed


def parity_cfg(arm: str, rays_file: Path, out_dir: Path):
    """The port's copy of psnr_parity._cfg(tag, arm, batch, 600, rays_file,
    nerf_type) at the arm's PARITY_ARMS shape, for arms "spass2" (single
    pass, 16 + 32 samples from the 128-segment occupancy CDF, the exact
    forward, hash_grad_corners 2: the fast cfg's estimators), "spass8" (the
    same, exact gradient) and PARITY_TUNED_ARM (12 levels, one promoted
    dense, 8 + 16 samples from the 32-segment fast CDF, k = 1 forward and
    gradient over 2 drawn levels: cfg/blender_scene_tuned.yml's estimators),
    overlaid on the port's base defaults as _cfg overlays nerfjax's;
    tests/test_torch_quality_protocol.py holds it equal to _cfg on every
    key the port reads."""
    from nerfjax_torch.config import ConfigNode, with_defaults

    nerf_type, batch = PARITY_ARMS[arm]
    tuned = arm == PARITY_TUNED_ARM
    return with_defaults(ConfigNode({
        "scene_name": out_dir.name, "ngp": True, "nerf_type": nerf_type, "batch_size": batch,
        "num_epochs": PARITY_STEPS // PARITY_STEPS_PER_EPOCH, "lr": 5e-4, "N_samples": 8 if tuned else 16,
        "N_importance": 16 if tuned else 32, "precision": "bf16", "occupancy_grid": True,
        "hash_grad_corners": {"spass2": 2, "spass8": 8, PARITY_TUNED_ARM: 1}[arm], "single_pass": True,
        "hash_n_levels": 12 if tuned else 16, "hash_extra_dense_levels": 1 if tuned else 0,
        "hash_fwd_corners": 1 if tuned else 8, "hash_dense_corners": 8, "hash_grad_levels": 2 if tuned else 0,
        "hash_dense_grad_levels": 0, "occ_fast_cdf": tuned, "occ_update_partitions": 1,
        "occ_segments": 32 if tuned else 128, "rays_file": str(rays_file), "output_dir": str(out_dir),
        "checkpoint_dir": str(out_dir / "checkpoints"),
    }))


def _synthetic_module():
    """tests/synthetic.py, loaded by its path: the numpy data generator that
    nerfjax's parity rows were trained on (it imports only numpy)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("synthetic", HERE / "tests" / "synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _recording(module, names):
    """Within the block, each named wrapper of ``module`` files the
    arguments of every call in seen[name] (the dict yielded) before it runs."""
    seen = {name: [] for name in names}
    real = {name: getattr(module, name) for name in names}

    def recorder(name):
        def call(*args, **kw):
            seen[name].append(args)
            return real[name](*args, **kw)
        return call

    for name in names:
        setattr(module, name, recorder(name))
    try:
        yield seen
    finally:
        for name in names:
            setattr(module, name, real[name])


def _parity_eval_psnr(final: Path, cfg, data: dict, device: str = "cuda", record: bool = False) -> dict:
    """psnr_parity._eval_psnr on the port: render_rays (nerfjax's point-major
    render) with the checkpoint's field in f32 for both passes, all the
    held-out rays in one call, 64 + 128 samples, train=False, the draws from
    a generator of seed 0; PSNR = -10 log10(MSE) against their rgbs:
    "psnr". Beside it "planar_psnr", the same field through
    render_rays_planar in the cfg's precision (the fused bf16 head and the
    bf16-rounded hashed levels for every arm here), and "launches", the hash
    kernels' launches of the render_rays call. ``record``: also
    "fwd_calls", the arguments (spec, planes, x01) of render_rays' calls of
    hashgrid_fwd."""
    import torch

    from nerfjax_torch.checkpoint import load_field
    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.render import render_rays, render_rays_planar

    field = load_field(final, cfg, device=device)
    ro, rd, tn, tf = (torch.from_numpy(data[k]).to(device) for k in ("rays_o", "rays_d", "t_near", "t_far"))

    def psnr(rgb) -> float:
        mse = float(np.mean((rgb.float().cpu().numpy() - data["rgbs"]) ** 2))
        return -10.0 * float(np.log10(mse))

    he.reset_launch_counts()
    with torch.no_grad(), _recording(he, ("hashgrid_fwd",) if record else ()) as seen:
        rgb = render_rays(field, field, ro, rd, tn, tf, *PARITY_EVAL_SAMPLES, train=False,
                          generator=torch.Generator(device=device).manual_seed(0))["rgb_fine"]
    out = {"psnr": psnr(rgb), "launches": {k: v for k, v in he.launch_counts.items() if v}}
    if record:
        out["fwd_calls"] = [(spec, planes.detach(), x01) for spec, planes, x01 in seen["hashgrid_fwd"]]
    with torch.no_grad():
        rgb = render_rays_planar(field, field, ro, rd, tn, tf, *PARITY_EVAL_SAMPLES, train=False,
                                 dtype=torch.bfloat16 if cfg["precision"] == "bf16" else torch.float32,
                                 generator=torch.Generator(device=device).manual_seed(0))["rgb_fine"]
    out["planar_psnr"] = psnr(rgb)
    return out


def quality_parity(tmp: Path, seeds=PARITY_SEEDS) -> dict:
    """The op points' quality under nerfjax's own protocol: arms spass2,
    spass8 and PARITY_TUNED_ARM (parity_cfg), each seed trained by
    nerfjax_torch.train.train on the card from tests/synthetic.make_ray_npz
    rays (batch * 50 rays of its seed: one NPZ per seed and batch, shared by
    the arms of that batch) and evaluated on the 4,096 held-out rays of seed
    9999 as nerfjax evaluates it (_parity_eval_psnr: render_rays in f32).
    One line per run (that eval PSNR beside nerfjax's for the same arm and
    seed where benchmarks/psnr_parity.json has one, the planar bf16 eval of
    the same checkpoint, wall seconds, steps) and one per arm (the mean, the
    verdict against nerfjax's three-seed range: in range if the mean lies
    within [min, max] and no seed is more than PARITY_SEED_SLACK_DB below
    the min). After every run has printed its line, raises on a run that is
    not finite, misses its steps or lies below PARITY_RUN_FLOOR_DB, or an
    arm whose mean lies below PARITY_FLOOR_DB; the verdict itself is only
    reported. Returns the arms, the evals' launches and "eval_call", the
    first run's eval's fine-pass call of hashgrid_fwd (spec, planes, x01)
    for phase R."""
    import torch

    from nerfjax_torch.train import train

    syn = _synthetic_module()
    t0 = time.perf_counter()
    eval_data = syn.make_ray_npz(tmp / "parity_eval.npz", n_rays=PARITY_EVAL_RAYS, seed=PARITY_EVAL_SEED,
                                 scene="sphere")
    rays = {(seed, batch): tmp / f"parity_rays_s{seed}_b{batch}.npz"
            for batch in sorted({b for _, b in PARITY_ARMS.values()}) for seed in seeds}
    # the NPZs in threads: the oracle's ray march is numpy ufuncs on whole arrays, which release the GIL
    with concurrent.futures.ThreadPoolExecutor(max_workers=min(8, len(rays))) as pool:
        for done in [pool.submit(syn.make_ray_npz, path, n_rays=batch * PARITY_STEPS_PER_EPOCH, seed=seed,
                                 scene="sphere") for (seed, batch), path in rays.items()]:
            done.result()
    phase(f"quality: tests/synthetic.make_ray_npz sphere NPZs ({len(seeds)} seeds x "
          + " and ".join(f"{b * PARITY_STEPS_PER_EPOCH:,}" for b in sorted({b for _, b in PARITY_ARMS.values()}))
          + f" training rays, {PARITY_EVAL_RAYS:,} eval rays of seed {PARITY_EVAL_SEED}) in "
          f"{time.perf_counter() - t0:.1f} s")
    result, failed, launches, eval_s, eval_call = {}, [], {}, 0.0, None
    for arm, ref in PARITY_NERFJAX_DB.items():
        runs, t_arm = [], time.perf_counter()
        for seed in seeds:
            cfg = parity_cfg(arm, rays[seed, PARITY_ARMS[arm][1]], tmp / f"parity_{arm}_s{seed}")
            t1 = time.perf_counter()
            out = train(cfg, seed=seed, log_every=PARITY_STEPS, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            t1 = time.perf_counter()
            ev = _parity_eval_psnr(Path(cfg["checkpoint_dir"]) / "nerf_final.pth", cfg, eval_data,
                                   record=eval_call is None)
            eval_s += time.perf_counter() - t1
            if eval_call is None:  # the first run's fine pass, for phase R
                eval_call = max(ev.pop("fwd_calls"), key=lambda args: args[2].shape[0])
            for k, v in ev["launches"].items():
                launches[k] = launches.get(k, 0) + v
            psnr = ev["psnr"]
            nerfjax = f"{ref[seed]:.3f}" if seed < len(ref) else "not recorded"
            phase(f"quality {arm} seed {seed}: eval PSNR {psnr:.3f} dB (render_rays, f32; nerfjax {nerfjax}); the "
                  f"planar render in {cfg['precision']} {ev['planar_psnr']:.3f} dB ({ev['planar_psnr'] - psnr:+.3f}); "
                  f"{out['steps']} steps in {wall:.1f} s wall, train PSNR of the last 50 steps "
                  f"{np.mean(out['psnr'][-50:]):.2f} dB")
            if not np.isfinite(psnr) or not np.isfinite(out["psnr"]).all() or psnr < PARITY_RUN_FLOOR_DB:
                failed.append(f"{arm} seed {seed}: eval PSNR {psnr:.3f} dB (floor {PARITY_RUN_FLOOR_DB}), training "
                              f"PSNR {'finite' if np.isfinite(out['psnr']).all() else 'not finite'}")
            if out["steps"] != PARITY_STEPS:
                failed.append(f"{arm} seed {seed}: {out['steps']} steps, not {PARITY_STEPS}")
            runs.append({"seed": seed, "psnr": psnr, "planar_psnr": ev["planar_psnr"], "wall_s": wall,
                         "steps": out["steps"]})
        psnrs = [r["psnr"] for r in runs]
        mean, lo, hi = float(np.mean(psnrs)), min(ref), max(ref)
        planar = float(np.mean([r["planar_psnr"] for r in runs]))
        in_range = lo <= mean <= hi and min(psnrs) >= lo - PARITY_SEED_SLACK_DB
        spread = f", sd {np.std(psnrs, ddof=1):.3f}" if len(psnrs) > 1 else ""
        phase(f"quality {arm}: mean eval PSNR {mean:.3f} dB over seeds {tuple(seeds)}{spread}, lowest "
              f"{min(psnrs):.3f} (nerfjax mean {np.mean(ref):.3f} over seeds 0-2, range [{lo:.3f}, {hi:.3f}]): "
              f"{'in' if in_range else 'OUT OF'} nerfjax's range (mean within it, no seed below "
              f"{lo - PARITY_SEED_SLACK_DB:.3f}); the planar bf16 eval's mean {planar:.3f} dB "
              f"({planar - mean:+.3f}); the arm {time.perf_counter() - t_arm:.1f} s")
        if mean < PARITY_FLOOR_DB:
            failed.append(f"{arm}: mean eval PSNR {mean:.3f} dB < {PARITY_FLOOR_DB}")
        result[arm] = {"runs": runs, "mean": mean, "planar_mean": planar, "in_range": in_range}
    gap = result["spass2"]["mean"] - result["spass8"]["mean"]
    ref_gap = np.mean(PARITY_NERFJAX_DB["spass2"]) - np.mean(PARITY_NERFJAX_DB["spass8"])
    phase(f"quality: the b = 2 gradient's cost, mean spass2 - mean spass8, {gap:+.3f} dB on the port over seeds "
          f"{tuple(seeds)} (nerfjax {ref_gap:+.3f} dB over seeds 0-2)")
    phase(f"quality phase: {time.perf_counter() - t0:.1f} s, of it the evals (render_rays f32 and the planar bf16 "
          f"render) {eval_s:.1f} s; render_rays' launches over the evals: {launches}")
    if failed:
        raise AssertionError("quality: " + "; ".join(failed))
    return {"arms": result, "launches": launches, "eval_call": eval_call}


def train_k2_knob(tmp: Path, stats: dict) -> dict:
    """The tuned cfg with K2_KNOB (fwd, grad and dense corners 2, gl 2),
    K2_STEPS steps of train_step on phase 7's NPZ, the launches counted
    from 0 around them: NaNs, every hash kernel launched each step; then K1,
    K4, K5, K3 and K2 on one more step's captured calls (K1 k = 2, K2 b = 2
    over 2 levels, K4 k = 2, K5 b = 2) against their plain versions, each
    new mode timed there beside its bound."""
    import torch

    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import train_step

    cfg = {**TUNED_TRAIN, **K2_KNOB}
    he.reset_launch_counts()
    t0 = time.perf_counter()
    state, left, med = _warm_steps(cfg, tmp / "rays.npz", K2_STEPS - 8, 8, "k2 knob")
    torch.cuda.synchronize()
    launches = _planar_launches()
    phase(f"k2 knob {K2_KNOB}: {K2_STEPS} steps in {time.perf_counter() - t0:.2f} s; launches {launches}")
    for name, n in launches.items():
        if n < K2_STEPS:
            raise AssertionError(f"{name} launched {n} times in {K2_STEPS} k2 knob steps")
    m = train_step(state, left[0])
    if not np.isfinite(float(m["psnr"])):
        raise AssertionError("NaN in the k2 knob run")
    spec = state.field.spec
    if (spec.fwd_corners, he._grad_corners(spec), spec.dense_corners, he._dense_grad_corners(spec),
            he._bwd_mode(spec, len(he._split_levels(spec)[1]))) != (2, 2, 2, 2, (2, 2)):
        raise AssertionError(f"k2 knob: the field's estimators are not the knob's: {spec}")
    phase(f"k2 knob: PSNR at step {K2_STEPS + 1} {float(m['psnr']):.2f} dB")
    (cap,) = capture_step_inputs(state, left[1]).values()
    timings = step_kernels_vs_plain(cap, "k2 knob step", stats,
                                    ("hash_levels_fwd", "dense_levels_fwd", "dense_levels_bwd", "hash_levels_bwd"))
    return {"launches": launches, "ms_per_step": med, "timings": timings}


def lr_kernels_vs_plain(stats: dict) -> None:
    """K1, K2, K4 and K5 (+ K3) at k = 2, 3 and 7 on seeded positions at the
    fast cfg's spec (16 levels: 4 dense + 12 hashed) and the fast step's
    N = 393,216, with the plan's edge cases up front (the origin: 8 weights
    tie; (1, 1, 1): a dense corner of weight 1; hashed lattice points): K1
    and K4 with torch.equal, output (float32 and bf16) and plan (sel); K2
    (b = k over all levels, and over 2 drawn levels from a k-corner
    forward) and K3 on K5's staging within the atomic-order bound; K5 with
    torch.equal; K4 timed at each k into a bf16 output beside its bound."""
    import torch

    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import build_fields

    rng = np.random.default_rng(SEED + 9)
    base_spec = build_fields(FAST_TRAIN)[1].spec
    dense, hashed = he._split_levels(base_spec)
    Ld, Lh, total, N = len(dense), len(hashed), base_spec.total_table_size, 393_216
    planes = _rand((2, total), rng)
    x, y, z = _positions(N, rng)
    lattice = torch.tensor(np.concatenate([(np.arange(1, 5) - 0.5) / lp["scale"] for lp in hashed]),
                           dtype=torch.float32, device="cuda")
    for c in (x, y, z):
        c[2:2 + lattice.numel()] = lattice
    g_h = _rand((2, Lh, N), rng).to(torch.bfloat16)
    g_d = _rand((2, Ld, N), rng).to(torch.bfloat16)
    for k in LR_KS:
        spec = dataclasses.replace(base_spec, fwd_corners=k, dense_corners=k, grad_corners=k)
        for name, fwd, plain, rows in (("hash_levels_fwd", he.hash_levels_fwd, he.hash_levels_fwd_plain, Lh),
                                       ("dense_levels_fwd", he.dense_levels_fwd, he.dense_levels_fwd_plain, Ld)):
            args = () if name == "hash_levels_fwd" else (torch.bfloat16,)
            ref, plan = plain(spec, planes, x, y, z, *args)
            for dt in (torch.float32, torch.bfloat16):
                sel = torch.empty(k, rows, N, dtype=torch.int32, device="cuda")
                got = fwd(spec, planes, x, y, z, *args, sel=sel, out=torch.empty(2, rows, N, dtype=dt, device="cuda"))
                if not torch.equal(got, ref.to(dt)) or not torch.equal(sel.long(), plan):
                    raise AssertionError(f"{name} k={k} ({dt} out): kernel != plain (output or plan)")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], 0.0)
        t = _k4_at_call(spec, planes, x, y, z, torch.bfloat16, torch.empty(2, Ld, N, dtype=torch.bfloat16, device="cuda"),
                        f"seeded k={k}", True)
        stats["dense_levels_fwd"]["shapes"][f"seeded_k{k}"] = t
        phase(f"  dense_levels_fwd k={k} at the fast spec (seeded, bf16 out, N={N:,}): " + _timing_line(t))
        for label, s in (("all levels", spec), ("gl=2", dataclasses.replace(spec, grad_levels=2)),
                         ("exact forward", dataclasses.replace(spec, fwd_corners=8))):
            err = _check_scatter(f"hash_levels_bwd k={k} {label}", he.hash_levels_bwd(s, g_h, x, y, z, _zeros2(total)),
                                 he.hash_levels_bwd_plain(s, g_h, x, y, z, _zeros2(total)),
                                 he.hash_levels_bwd_plain(s, g_h.abs(), x, y, z, _zeros2(total)),
                                 _k2_count(s, g_h, x, y, z, total))
            stats["hash_levels_bwd"]["max_abs_err"] = max(stats["hash_levels_bwd"]["max_abs_err"], err)
        got = he.dense_levels_bwd(spec, g_d, x, y, z, torch.bfloat16)
        ref = he.dense_levels_bwd_plain(spec, g_d, x, y, z, torch.bfloat16)
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, ref)) or got[0].numel() != k * Ld * N:
            raise AssertionError(f"dense_levels_bwd k={k}: kernel != plain")
        idx, v0, v1 = got
        one = torch.ones_like(v0)
        err = _check_scatter(f"table_grad_scatter on dense_levels_bwd k={k}",
                             he.table_grad_scatter(idx, v0, v1, _zeros2(total)),
                             he.table_grad_scatter_plain(idx, v0, v1, _zeros2(total)),
                             he.table_grad_scatter_plain(idx, v0.abs(), v1.abs(), _zeros2(total)),
                             he.table_grad_scatter_plain(idx, one, one, _zeros2(total)))
        stats["table_grad_scatter"]["max_abs_err"] = max(stats["table_grad_scatter"]["max_abs_err"], err)
        phase(f"k={k} at the fast spec, N={N:,}: K1 and K4 == plain (f32 and bf16 out, sel [k, L, N]); K2 (b={k}, "
              f"all levels, gl=2, exact forward) within the atomic-order bound; K5 == plain ({idx.numel():,} "
              f"entries), K3 on them within the bound, max |err| {err:.3g}")


# the precompute phase's scene: nerf_synthetic's train split in shape (800 x 800, camera_angle_x
# 0.6911112, cameras 4.03 from the origin), 60 of its 100 frames, for the script's time limit (at 100
# frames the NPZ's zlib write took ~70 s of the script)
PRECOMPUTE_FRAMES = 60
PRECOMPUTE_SIZE = 800
PRECOMPUTE_ANGLE_X = 0.6911112
PRECOMPUTE_RADIUS = 4.03
PRECOMPUTE_CHECK_FRAMES = 4  # frames made on the card and on the CPU, held equal


def _lookat(cam: np.ndarray) -> np.ndarray:
    """[4, 4] float32 OpenGL camera-to-world pose at ``cam`` looking at the
    origin, +Z up (the transforms JSON's convention)."""
    fwd = -cam / np.linalg.norm(cam)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, cam
    return c2w.astype(np.float32)


def precompute_scene(root: Path, n: int = PRECOMPUTE_FRAMES) -> Path:
    """nerf_synthetic's train split in shape: n frames of PRECOMPUTE_SIZE^2
    at camera_angle_x PRECOMPUTE_ANGLE_X, on look-at poses PRECOMPUTE_RADIUS
    from the origin over the upper hemisphere (elevation 0.2 to 1.2 rad,
    azimuth by the golden angle), each _ball_image written as an 8-bit PNG
    (8 threads); the transforms JSON (h, w, K, frames) -> its path."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    H = W = PRECOMPUTE_SIZE
    f = 0.5 * W / np.tan(0.5 * PRECOMPUTE_ANGLE_X)
    K = np.array([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]])
    poses = []
    for i in range(n):
        el, az = 0.2 + i / max(n - 1, 1), i * 2.399963229728653
        poses.append(_lookat(PRECOMPUTE_RADIUS * np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                                                           np.sin(el)])))
    root.mkdir(parents=True, exist_ok=True)

    def write(i: int) -> dict:
        path = root / f"r_{i}.png"
        Image.fromarray(np.round(_ball_image(K, poses[i], H, W) * 255).astype(np.uint8)).save(path)
        return {"file_path": str(path), "transform_matrix": poses[i].tolist()}

    with ThreadPoolExecutor(8) as pool:
        frames = list(pool.map(write, range(n)))
    path = root / "transforms_train.json"
    path.write_text(json.dumps({"camera_angle_x": PRECOMPUTE_ANGLE_X, "h": H, "w": W, "K": K.tolist(),
                                "frames": frames}))
    return path


def precompute_cli(tmp: Path, scene: Path) -> tuple:
    """``python -m nerfjax_torch.cli.precompute_rays`` on precompute_scene's
    frames (``scene``, its transforms JSON under tmp/scene), on the card,
    with a JSON cfg naming the transforms JSON and the NPZ: (the completed
    process, its output captured; its wall seconds). Prints nothing, so
    that it can run in a thread beside other phases."""
    cfg = tmp / "scene" / "precompute.json"
    cfg.write_text(json.dumps({"scene_name": "train", "transforms_json": str(scene),
                               "rays_file": str(tmp / "scene" / "train_ray_data.npz")}))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "nerfjax_torch.cli.precompute_rays", "--cfg_path", str(cfg)],
                         capture_output=True, text=True, cwd=HERE, timeout=600)
    return res, time.perf_counter() - t0


def precompute_phase(tmp: Path, scene: Path, ran: tuple | None = None) -> dict:
    """The chain's head on the card: precompute_cli (``ran``, its result
    where it ran already; else it runs here): the rays kept of those
    generated, each stage's seconds as the CLI reports them (decode; rays
    + intersection, CUDA events; compaction + fetch; the NPZ write), its
    wall and rays/s; the NPZ read back (its rays count, finite, unit
    directions, t_far >= t_near). Then the first PRECOMPUTE_CHECK_FRAMES
    frames made on the card and on the CPU: the hit masks equal (else the
    count that differ and the largest |t_far - t_near| among them, and a
    failure), the arrays within 1e-6."""
    import torch

    from nerfjax_torch import rays as R

    npz = tmp / "scene" / "train_ray_data.npz"
    res, wall = precompute_cli(tmp, scene) if ran is None else ran
    if res.returncode != 0:
        raise AssertionError(f"precompute_rays failed (exit {res.returncode}):\n{res.stdout}\n{res.stderr}")
    last = res.stdout.strip().splitlines()[-1]
    if not last.startswith("Stages: "):
        raise AssertionError(f"precompute_rays printed no stages line:\n{res.stdout}")
    st = json.loads(last[len("Stages: "):])
    phase(f"precompute_rays (the CLI, on the card): {st['kept']:,} rays kept of {st['generated']:,} generated "
          f"({st['kept'] / st['generated']:.2%}); seconds: decode {st['decode']:.3f}, rays + intersection "
          f"{st['rays']:.4f} (CUDA events), compaction + fetch {st['compact_fetch']:.3f}, NPZ write {st['write']:.2f}, "
          f"the CLI's own wall {st['wall']:.2f}, the process {wall:.2f} (python and CUDA start included); "
          f"{st['generated'] / wall:,.0f} rays/s generated over the process's wall, "
          f"{st['generated'] / (st['decode'] + st['rays'] + st['compact_fetch']):,.0f} rays/s over decode + rays + "
          "fetch")
    data = R.load_ray_data(npz)
    n = len(data["rays_o"])
    ok = n == st["kept"] and all(v.shape[0] == n and np.isfinite(v).all() for v in data.values())
    if not ok or not np.allclose(np.linalg.norm(data["rays_d"], axis=1), 1.0, atol=1e-5) or \
            (data["t_far"] < data["t_near"]).any():
        raise AssertionError("the ray NPZ is not what the CLI reported: count, finiteness, unit directions or t order")
    phase(f"ray NPZ: {npz.stat().st_size / 1e6:,.1f} MB, {n:,} rays read back (finite, unit directions, "
          "t_far >= t_near)")
    del data

    meta = json.loads(scene.read_text())
    few = tmp / "scene" / "transforms_check.json"
    few.write_text(json.dumps({**meta, "frames": meta["frames"][:PRECOMPUTE_CHECK_FRAMES]}))
    poses = np.array([f["transform_matrix"] for f in meta["frames"][:PRECOMPUTE_CHECK_FRAMES]], np.float32)
    hits = []
    for dev in ("cuda", "cpu"):
        o, d = R.get_rays(meta["h"], meta["w"], meta["K"], torch.from_numpy(poses).to(dev))
        hit, tn, tf = R.ray_cube_intersection(o.reshape(-1, 3), d.reshape(-1, 3))
        hits.append((hit.cpu(), (tf - tn).abs().cpu()))
    differ = hits[0][0] != hits[1][0]
    if bool(differ.any()):
        raise AssertionError(f"the hit masks of {PRECOMPUTE_CHECK_FRAMES} frames differ between the card and the CPU "
                             f"at {int(differ.sum())} rays, |t_far - t_near| there up to "
                             f"{float(torch.maximum(hits[0][1], hits[1][1])[differ].max()):.3g}")
    card = R.precompute_rays_for_scene(few, device="cuda")
    host = R.precompute_rays_for_scene(few, device="cpu")
    err = max(float(np.abs(card[k] - host[k]).max()) for k in R.RAY_KEYS)
    if err > 1e-6 or not np.array_equal(card["rgbs"], host["rgbs"]):
        raise AssertionError(f"precompute on the card vs the CPU: max |err| {err:.3g} (bound 1e-6)")
    equal = all(np.array_equal(card[k], host[k]) for k in R.RAY_KEYS)
    phase(f"precompute, {PRECOMPUTE_CHECK_FRAMES} frames card vs CPU: hit masks equal ({int(hits[0][0].sum()):,} of "
          f"{hits[0][0].numel():,} rays), arrays within 1e-6 (max |err| {err:.3g}; bit for bit: {equal})")
    return {**st, "process_wall": wall}


# -- the front end (phase C) ---------------------------------------------------

FRONT_SIZE = 400  # phase H's frames resized to FRONT_SIZE^2 (C1)
FRONT_POINTS = 300_000  # SfM points on the ball's surface (C2)
FRONT_OUTLIERS = 3_000  # planted points 5 to 50 ball radii from its center
FRONT_SUBSAMPLE = 20_000  # C5's cloud, converted on the card and on the CPU
FRONT_RADIUS_FILTER = {"radius_filter": True, "radius_radius": 0.03, "radius_nb_points": 16}  # ~18 neighbours a point
FRONT_CHECK_FILES = ("r_0.png", "r_57.png")  # C1's files held to an in-process PIL resize


def _run_cli(module: str, args: list[str], cwd: Path) -> str:
    """``python -m module args`` in this process (so that the kernels'
    launch counts are read here), in cwd; its standard output. Fails if it
    exits non-zero."""
    import runpy

    argv, out = sys.argv, io.StringIO()
    try:
        sys.argv = [module, *args]
        with contextlib.chdir(cwd), contextlib.redirect_stdout(out):
            runpy.run_module(module, run_name="__main__", alter_sys=False)
    except SystemExit as e:
        if e.code not in (None, 0):
            raise AssertionError(f"{module} exited with {e.code}:\n{out.getvalue()}") from e
    finally:
        sys.argv = argv
    return out.getvalue()


def _stages(stdout: str, module: str) -> dict:
    last = stdout.strip().splitlines()[-1]
    if not last.startswith("Stages: "):
        raise AssertionError(f"{module} printed no stages line:\n{stdout}")
    return json.loads(last[len("Stages: "):])


def colmap_model(root: Path, frames: list, focal: float, seed: int = SEED) -> np.ndarray:
    """A COLMAP text model of the ball scene under root/colmap_text:
    cameras.txt (PINHOLE FRONT_SIZE^2, focal, centred), images.txt (each
    frame's OpenGL camera-to-world pose turned into COLMAP's OpenCV
    world-to-camera, c2w @ diag(1, -1, -1, 1) inverted, quaternion wxyz;
    empty points2D lines) and points3D.txt (FRONT_POINTS seeded points on
    the ball's surface in the ball's colour, and FRONT_OUTLIERS planted
    5 to 50 radii from its center, uniform in radius, shuffled in). Returns
    the mask of planted outliers in the file's order."""
    from nerfjax_torch.colmap.quaternion import matrix_to_quat

    work = root / "colmap_text"
    work.mkdir(parents=True, exist_ok=True)
    c = FRONT_SIZE / 2
    (work / "cameras.txt").write_text(f"# cameras\n1 PINHOLE {FRONT_SIZE} {FRONT_SIZE} {focal} {focal} {c} {c}\n")
    lines = ["# images"]
    for i, f in enumerate(frames):
        w2c = np.linalg.inv(np.asarray(f["transform_matrix"], np.float64) @ np.diag([1.0, -1.0, -1.0, 1.0]))
        q, t = matrix_to_quat(w2c[:3, :3]).tolist(), w2c[:3, 3].tolist()  # Python floats: repr round-trips
        lines += [f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} 1 {Path(f['file_path']).name}", ""]
    (work / "images.txt").write_text("\n".join(lines) + "\n")
    rng = np.random.default_rng(seed + 11)
    d = rng.normal(size=(FRONT_POINTS + FRONT_OUTLIERS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.concatenate([np.full(FRONT_POINTS, BALL_RADIUS),
                        BALL_RADIUS * rng.uniform(5.0, 50.0, FRONT_OUTLIERS)])
    pts = BALL_CENTER + d * r[:, None]
    planted = np.arange(len(pts)) >= FRONT_POINTS
    order = rng.permutation(len(pts))
    pts, planted = pts[order], planted[order]
    rgb = np.round(BALL_RGB * 255).astype(int).tolist()
    body = "\n".join(f"{i} {p[0]} {p[1]} {p[2]} {rgb[0]} {rgb[1]} {rgb[2]} 0.5 1 {i}"
                     for i, p in enumerate(pts.tolist()))
    (work / "points3D.txt").write_text("# 3D point list\n" + body + "\n")
    return planted


KNN_GRID_KERNELS = ("knn_bin", "knn_scatter", "knn_mark", "knn_grid", "knn_tail")
KNN_FIRST_DESIGN_MS = 46.22  # K6's first design (brute force) at C3's cloud, n 303,000, k 20; H100 80GB HBM3, 700 W
KNN_CLUSTERED = 1_200_000  # the K6 phase's clustered cloud: a real forest plot's sparse cloud is 1-3M points
KNN_SUBSET = 4_096  # queries the plain version checks at KNN_CLUSTERED points
H100_INSTR_PER_S = 132 * 128 * 1.98e9  # FP32 lanes x boost clock: one instruction a lane a cycle, no FMA


def _knn_bound(n: int, pairs: int) -> tuple[float, str]:
    """The least time for n points and ``pairs`` distances: 8 FP32
    instructions a pair (3 FADD, 3 FMUL, 2 FADD; -fmad=false, so no FMA) at
    H100_INSTR_PER_S, or the bytes (each point read once, each distance
    written once: 16 n) at the memory rate. The function's bound is at
    pairs = n k (each point's k neighbours' distances); at the pairs a
    design tests it is that design's work, not the function's bound."""
    tb, to = 16.0 * n / H100_BYTES_PER_S * 1e3, 8.0 * pairs / H100_INSTR_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _knn_timed(pts, k: int, plain_ms: float | None, err: float, label: str, plan=None) -> dict:
    """K6 (the wrapper: the plan, the sorts and every kernel of its route;
    ``plan`` forces one, as knn_plan gives it) at one cloud: device ms from
    a profiler trace (sets p, k, k, p as _time_ms takes them), the
    function's bound, the pairs its kernels tested and their bound, its
    split by stage (CUDA events); printed."""
    from nerfjax_torch.ops import knn

    n = pts.shape[0]
    kern = lambda: knn.knn_mean_distances(pts, k, plan=plan)  # noqa: E731
    runs, known = [], {}
    for _ in range(TIMING_SETS):
        runs += [_time_ms(kern, known=known), _time_ms(kern, known=known)]
        if _agree(runs[-2], runs[-1]):
            break
    else:
        raise AssertionError(f"{label}: K6's timing runs disagree: " + ", ".join(f"{v:.3f}" for v in runs))
    split: dict = {}
    knn.knn_mean_distances(pts, k, plan=plan, split=split)
    run = dict(knn.last_run)
    pairs = int(run["pairs"])
    k = min(k, n - 1)
    bound = _knn_bound(n, n * k)
    out = {"ms": float(np.median(runs)), "plain_ms": plain_ms, "bound": bound, "max_abs_err": err, "runs": runs,
           "n": n, "k": k, "wall_ms": _wall_ms(kern, iters=5), "pairs": pairs, "route": run["route"],
           "levels": run["levels"], "tail": run["tail"], "split": split, "plan": dataclasses.asdict(run["plan"]),
           "tested_bound": _knn_bound(n, pairs), "brute_pairs_bound": _knn_bound(n, n * (n - 1))}
    plan = run["plan"]
    phase(f"{label}: K6 at n = {n:,}, k = {k}, {run['route']} route: == plain (torch.equal); device: "
          f"{out['ms']:.3f} ms (runs {', '.join(f'{v:.3f}' for v in runs)}; profiler traces of 20 calls; the first "
          f"design's recorded time at C3's cloud: {KNN_FIRST_DESIGN_MS} ms); plain "
          f"{'not run' if plain_ms is None else f'{plain_ms:.1f} ms'}; wall per call {out['wall_ms']:.3f} ms; "
          f"split (CUDA events, one call): " + ", ".join(f"{a} {b:.3f}" for a, b in split.items())
          + f"; the function's bound {bound[0] * 1e3:.2f} us ({bound[1]}: n k = {n * k:,} pairs at 8 FP32 "
          f"instructions a pair, {H100_INSTR_PER_S / 1e12:.1f} T/s, or 16 n bytes), the call at "
          f"{bound[0] / out['ms']:.2%} of it; pairs tested {pairs:,} ({pairs / max(n * (n - 1), 1):.2e} of "
          f"n(n - 1)), their bound {out['tested_bound'][0]:.3f} ms; {run['levels']} grid level(s), {run['tail']:,} "
          f"queries to the brute tail; brute force's bound at this n {out['brute_pairs_bound'][0]:.2f} ms"
          + ("" if run["route"] != "grid" else f"; cell side {plan.h:.6g}, {plan.dims} cells, load "
             f"{plan.cell_load:.1f}, {plan.iterations} counts"))
    return out


def knn_phase() -> dict:
    """K6 beyond C3's cloud: KNN_CLUSTERED points of clustered_cloud (blobs
    on a surface with 1 % planted outliers), k 20, against the plain version
    on KNN_SUBSET seeded queries (torch.equal), timed with its split; the
    statistical filter on the all-coincident cloud at C3's size (the brute
    route, its launches counted from 0 around the call), and the brute
    kernel timed there."""
    import torch

    from nerfjax_torch.colmap.outliers import remove_statistical_outliers
    from nerfjax_torch.ops import knn

    out = {}
    pts = torch.from_numpy(clustered_cloud(KNN_CLUSTERED, SEED + 13)[0]).cuda()
    got = knn.knn_mean_distances(pts, 20)
    q = torch.from_numpy(np.random.default_rng(SEED + 14).choice(KNN_CLUSTERED, KNN_SUBSET, replace=False)).cuda()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = knn.knn_mean_distances_plain(pts, 20, queries=q)
    end.record()
    torch.cuda.synchronize()
    if not torch.equal(got[q], want) or not torch.isfinite(got).all():
        raise AssertionError(f"K6 at the clustered cloud: kernel != plain at {int((got[q] != want).sum())} of "
                             f"{KNN_SUBSET} queries")
    plain_ms = start.elapsed_time(end) * KNN_CLUSTERED / KNN_SUBSET
    out["clustered"] = _knn_timed(pts, 20, plain_ms, float((got[q] - want).abs().max()),
                                  f"K6 phase, clustered cloud (plain on {KNN_SUBSET:,} queries, its ms scaled to n)")
    del pts, got
    n = FRONT_POINTS + FRONT_OUTLIERS
    knn.reset_launch_counts()
    _, keep = remove_statistical_outliers(np.full((n, 3), 0.25, np.float32), 20, 2.0, device="cuda")
    out["coincident_launches"] = dict(knn.launch_counts)
    route = knn.last_run["route"]
    if route != "brute" or out["coincident_launches"]["knn_mean_dist"] != 1 or len(keep) != n:
        raise AssertionError(f"the statistical filter on {n:,} coincident points: route {route}, launches "
                             f"{out['coincident_launches']}, {len(keep):,} kept; expected the brute kernel once, "
                             "every point kept")
    phase(f"K6 phase: the statistical filter on {n:,} coincident points took the brute route (launches "
          f"{out['coincident_launches']}) and kept every point")
    same = torch.full((n, 3), 0.25, device="cuda")
    if knn.knn_mean_distances(same, 20).any():
        raise AssertionError("K6 at the all-coincident cloud: expected zeros")
    out["coincident"] = _knn_timed(same, 20, None, 0.0, "K6 phase, all points coincident (plain not run)")
    return out


def clustered_cloud(n: int, seed: int, outlier_share: float = FRONT_OUTLIERS / (FRONT_POINTS + FRONT_OUTLIERS)):
    """(float32 [n, 3] points, planted-outlier mask): a clustered SfM-like
    cloud, not a sphere. 64 Gaussian blobs (sd 0.02 to 0.25, log-uniform;
    Dirichlet weights) in the plane over [-2, 2]^2, lifted onto the surface
    z = 0.3 sin(2x) cos(3y) with 0.002 of normal noise, and the share of
    planted outliers of phase C's cloud, 5 to 50 half-widths (2) from the
    origin in random directions; shuffled."""
    rng = np.random.default_rng(seed)
    n_out = round(n * outlier_share)
    m = n - n_out
    centers = rng.uniform(-2.0, 2.0, (64, 2))
    sd = np.exp(rng.uniform(np.log(0.02), np.log(0.25), 64))
    comp = rng.choice(64, m, p=rng.dirichlet(np.ones(64)))
    xy = centers[comp] + rng.normal(size=(m, 2)) * sd[comp, None]
    z = 0.3 * np.sin(2.0 * xy[:, 0]) * np.cos(3.0 * xy[:, 1]) + rng.normal(0.0, 0.002, m)
    d = rng.normal(size=(n_out, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    far = d * (2.0 * rng.uniform(5.0, 50.0, n_out))[:, None]
    pts = np.concatenate([np.column_stack([xy, z]), far]).astype(np.float32)
    planted = np.arange(n) >= m
    order = rng.permutation(n)
    return pts[order], planted[order]


def front_end_phase(tmp: Path) -> dict:
    """The front end on the card, from phase H's frames to a trained field:
    C1 nerfjax_torch.cli.resize_images on them (800^2 -> FRONT_SIZE^2,
    LANCZOS; two files held byte-equal to PIL in this process); C2 a COLMAP
    text model of the scene (colmap_model); C3 nerfjax_torch.cli.colmap2nerf
    (mode auto) on the card: its Stages line, the kept share, every planted
    outlier removed (else a failure), the orientation check's verdict
    (reported, not failed: a hemisphere of cameras fails nerfjax's check
    too); C4 K6 against its plain version at that cloud (torch.equal),
    timed beside its bound; C5 the CLI on a FRONT_SUBSAMPLE-point cloud
    with --device cuda and --device cpu, the JSONs byte-equal, with the
    default cfg and with FRONT_RADIUS_FILTER; C6 C3's JSON
    and the resized frames through nerfjax_torch.cli.precompute_rays, one
    epoch of train() with the tuned cfg, extraction at 256^3 and the IoU
    with the ball fitted to colmap_to_nerf's normalized inlier points
    (>= 0.5). The CLIs run in this process (runpy), K6's launches are
    counted from 0 around C3's."""
    import torch
    from PIL import Image

    from nerfjax_torch.colmap import colmap_to_nerf, read_points3d_txt
    from nerfjax_torch.config import ConfigNode, with_defaults
    from nerfjax_torch.ops import knn
    from nerfjax_torch.train import train

    scene = tmp / "scene"
    root = tmp / "front"
    colmap_dir = root / "colmap"
    root.mkdir()
    out: dict = {}

    # C1: resize
    (root / "resize.json").write_text(json.dumps({
        "scene_name": "ball", "image_dir": str(scene), "tmp_image_dir": str(colmap_dir / "images"),
        "resize_images": True, "newSize": [FRONT_SIZE, FRONT_SIZE]}))
    t0 = time.perf_counter()
    _run_cli("nerfjax_torch.cli.resize_images", ["--cfg_path", str(root / "resize.json")], root)
    out["resize_s"] = time.perf_counter() - t0
    resized = sorted((colmap_dir / "images").iterdir())
    for name in FRONT_CHECK_FILES:
        Image.open(scene / name).resize((FRONT_SIZE, FRONT_SIZE), Image.LANCZOS).save(root / name)
        if (root / name).read_bytes() != (colmap_dir / "images" / name).read_bytes():
            raise AssertionError(f"resize_images wrote {name} other than PIL's LANCZOS resize")
    if len(resized) != PRECOMPUTE_FRAMES or Image.open(resized[0]).size != (FRONT_SIZE, FRONT_SIZE):
        raise AssertionError(f"resize_images wrote {len(resized)} files of {Image.open(resized[0]).size}")
    phase(f"front end C1: resize_images (the CLI, host code) resized {len(resized)} frames from {PRECOMPUTE_SIZE}^2 "
          f"to {FRONT_SIZE}^2 in {out['resize_s']:.2f} s; {', '.join(FRONT_CHECK_FILES)} byte-equal to PIL's LANCZOS")

    # C2: the COLMAP text model
    meta = json.loads((scene / "transforms_train.json").read_text())
    focal = float(0.5 * PRECOMPUTE_SIZE / np.tan(0.5 * PRECOMPUTE_ANGLE_X) * FRONT_SIZE / PRECOMPUTE_SIZE)
    t0 = time.perf_counter()
    planted = colmap_model(colmap_dir, meta["frames"], focal)
    phase(f"front end C2: COLMAP text model of {len(meta['frames'])} images (PINHOLE {FRONT_SIZE}^2, f {focal:.3f}) "
          f"and {len(planted):,} points ({FRONT_POINTS:,} on the ball, {int(planted.sum()):,} planted 5-50 radii out), "
          f"{(colmap_dir / 'colmap_text' / 'points3D.txt').stat().st_size / 1e6:.1f} MB, in "
          f"{time.perf_counter() - t0:.2f} s (set-up)")

    # C3: colmap2nerf on the card
    cfg_keys = {"scene_name": "ball", "colmap_dir": str(colmap_dir)}
    (root / "colmap2nerf.json").write_text(json.dumps(cfg_keys))
    knn.reset_launch_counts()
    t0 = time.perf_counter()
    stdout = _run_cli("nerfjax_torch.cli.colmap2nerf", ["--cfg_path", str(root / "colmap2nerf.json")], root)
    wall = time.perf_counter() - t0
    out["launches"] = dict(knn.launch_counts)
    out["route"] = knn.last_run["route"]
    st = _stages(stdout, "colmap2nerf")
    verdict = [line.strip() for line in stdout.splitlines()
               if line.startswith(("Cameras oriented", "Dot product", "Validation", "All validations", "Some validations"))]
    phase(f"front end C3: colmap2nerf (the CLI, mode auto, on the card) in {wall:.2f} s; {st['points_kept']:,} of "
          f"{st['points_read']:,} points kept ({st['points_kept'] / st['points_read']:.2%}); seconds: read "
          f"{st['read']:.3f}, outlier filter {st['outlier_filter']:.4f} (its kNN {st['knn'] * 1e3:.2f} ms, CUDA events), "
          f"normalize + convert {st['normalize_convert']:.4f}, AABB {st['aabb']:.4f}, write {st['write']:.4f}, "
          f"the CLI's wall {st['wall']:.3f}; K6 ({out['route']} route) launches {out['launches']}; orientation check "
          f"(reported, not failed): {'; '.join(verdict)}")
    unlaunched = [name for name in KNN_GRID_KERNELS if not out["launches"][name]]
    if out["route"] != "grid" or unlaunched or out["launches"]["knn_tail"] != 1:
        raise AssertionError(f"colmap2nerf's K6 took the {out['route']} route with launches {out['launches']}: "
                             f"expected the grid, every grid kernel launched, knn_tail once")
    out["stages"] = st

    # C4: K6 against its plain version at that cloud; the keep set with the filter's k and ratio as C3 took them
    used = with_defaults(ConfigNode(cfg_keys))
    k, std_ratio = int(used.outlier_nb_neighbors), float(used.outlier_std_ratio)
    points, _ = read_points3d_txt(colmap_dir / "colmap_text" / "points3D.txt")
    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).cuda()
    n = pts.shape[0]
    got = knn.knn_mean_distances(pts, k)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = knn.knn_mean_distances_plain(pts, k)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"K6 at n = {n:,}, k = {k}: kernel != plain, max |err| {err:.3g} at "
                             f"{int((got != want).sum()):,} points")
    brute_plan = knn.knn_plan(pts, k, route="brute")
    brute = knn.knn_mean_distances(pts, k, plan=brute_plan)
    if not torch.equal(brute, want):
        raise AssertionError(f"K6's brute kernel at n = {n:,}, k = {k}: != plain")
    d = got.cpu().numpy()
    keep = np.where(d <= d.mean() + std_ratio * d.std())[0]  # the filter's threshold, as colmap2nerf formed it
    survivors = int(planted[keep].sum())
    if len(keep) != st["points_kept"] or survivors:
        raise AssertionError(f"{survivors} planted outliers survived the filter; {len(keep):,} kept here, "
                             f"{st['points_kept']:,} by colmap2nerf")
    out["knn"] = _knn_timed(pts, k, plain_ms, err, "front end C4")
    out["knn_brute"] = _knn_timed(pts, k, plain_ms, float((brute - want).abs().max()), "front end C4, brute kernel",
                                  plan=brute_plan)
    phase(f"front end C3: every one of the {int(planted.sum()):,} planted outliers removed (the keep set from K6's "
          f"distances and the filter's threshold: {len(keep):,} points, as colmap2nerf kept)")

    # C5: a subsample, card against CPU
    sub = np.sort(np.random.default_rng(SEED + 12).choice(n, FRONT_SUBSAMPLE, replace=False))
    sub_dir = root / "sub"
    (sub_dir / "colmap_text").mkdir(parents=True)
    for name in ("cameras.txt", "images.txt"):
        (sub_dir / "colmap_text" / name).write_bytes((colmap_dir / "colmap_text" / name).read_bytes())
    rows = (colmap_dir / "colmap_text" / "points3D.txt").read_text().splitlines()[1:]
    (sub_dir / "colmap_text" / "points3D.txt").write_text("# 3D point list\n" + "\n".join(rows[i] for i in sub) + "\n")
    for label, extra in (("default cfg", {}), ("radius_filter", FRONT_RADIUS_FILTER)):
        sub_cfg = root / f"sub_{len(extra)}.json"
        sub_cfg.write_text(json.dumps({"scene_name": "sub", "colmap_dir": str(sub_dir), **extra}))
        seconds, jsons, said = {}, {}, {}
        for dev in ("cuda", "cpu"):
            cwd = root / f"{dev}_{len(extra)}"
            cwd.mkdir()
            t0 = time.perf_counter()
            stdout = _run_cli("nerfjax_torch.cli.colmap2nerf", ["--cfg_path", str(sub_cfg), "--device", dev], cwd)
            seconds[dev] = time.perf_counter() - t0
            jsons[dev] = (cwd / "transforms_sub.json").read_bytes()
            said[dev] = [line for line in stdout.splitlines() if line.startswith("Radius filter kept")]
        if jsons["cuda"] != jsons["cpu"] or said["cuda"] != said["cpu"]:
            raise AssertionError(f"colmap2nerf ({label}) on {FRONT_SUBSAMPLE:,} points: the card's JSON differs from "
                                 f"the CPU's; {said}")
        if extra and not said["cpu"]:
            raise AssertionError("colmap2nerf with radius_filter: true printed no radius filter line")
        phase(f"front end C5: colmap2nerf ({label}{': ' + said['cpu'][0] if extra else ''}) on {FRONT_SUBSAMPLE:,} "
              f"of the points with --device cuda ({seconds['cuda']:.2f} s) and --device cpu ({seconds['cpu']:.2f} s): "
              f"the two transforms JSONs byte-equal ({len(jsons['cpu']):,} B)")

    # C6: the chain from C3's JSON to a trained field
    npz = root / "ball_ray_data.npz"
    (root / "precompute.json").write_text(json.dumps({"scene_name": "ball", "transforms_json": str(
        root / "transforms_ball.json"), "rays_file": str(npz)}))
    t0 = time.perf_counter()
    ps = _stages(_run_cli("nerfjax_torch.cli.precompute_rays", ["--cfg_path", str(root / "precompute.json")], root),
                 "precompute_rays")
    out["precompute_s"] = time.perf_counter() - t0
    cfg = {**TUNED_TRAIN, "num_epochs": 1, "rays_file": str(npz), "output_dir": str(root / "out"),
           "checkpoint_dir": str(root / "out" / "checkpoints")}
    t0 = time.perf_counter()
    res = train(cfg, seed=SEED, log_every=128, device="cuda")
    out["train_s"] = time.perf_counter() - t0
    psnr = np.asarray(res["psnr"])
    out["psnr_last20"] = float(psnr[-20:].mean())
    phase(f"front end C6: precompute_rays on C3's JSON: {ps['kept']:,} of {ps['generated']:,} rays kept in "
          f"{out['precompute_s']:.2f} s (NPZ write {ps['write']:.2f}); train() one epoch, {res['steps']} tuned steps in "
          f"{out['train_s']:.2f} s, PSNR first 20 steps {float(psnr[:20].mean()):.2f} dB, last 20 "
          f"{out['psnr_last20']:.2f} dB")
    if not np.isfinite(psnr).all() or out["psnr_last20"] < float(psnr[:20].mean()) + PSNR_RISE_DB:
        raise AssertionError(f"training on the front end's rays: PSNR {float(psnr[:20].mean()):.2f} -> "
                             f"{out['psnr_last20']:.2f} dB")
    with contextlib.redirect_stdout(io.StringIO()):  # the normalizer prints whatever verbose says
        norm = colmap_to_nerf(with_defaults(ConfigNode(cfg_keys)), device="cuda", verbose=False)["points"][keep]
    inl = norm[~planted[keep]]
    center = inl.mean(axis=0)
    radius = float(np.linalg.norm(inl - center, axis=1).mean())
    out["iou"] = extract_trained(cfg, Path(cfg["checkpoint_dir"]) / "nerf_final.pth", center, radius,
                                 label=f"front end C6: the field trained on C3's scene (ball fitted to the normalized "
                                       f"inliers: center {np.round(center, 4).tolist()}, radius {radius:.4f})")
    out["colmap_text"], out["planted"] = colmap_dir / "colmap_text", planted  # phase L starts from them
    return out


def tail_on_trained(cfg: dict, final: Path, tmp: Path) -> dict:
    """The chain's tail on the card's output: the trained tuned ball
    extracted at 512^3 on the card (save_volume), then
    nerfjax_torch.cli.post_process_vol's and write_format's main() (host
    code) on a JSON cfg whose transforms hold an AABB around the ball. Reads
    every file back: volume_sliced.pth equals the sliced points of the
    volume; the napari, ParaView and VTI files hold the voxels of those
    points (write_format's voxelizer). Returns each stage's seconds."""
    import json

    from nerfjax_torch import checkpoint as ckpt
    from nerfjax_torch import postprocess as pp
    from nerfjax_torch.cli import post_process_vol, write_format
    from nerfjax_torch.extract import extract_volume, save_volume
    from nerfjax_torch.formats.tiff import read_tiff_volume
    from nerfjax_torch.formats.vti import read_vti_volume

    out_dir = tmp / "tail"
    out_dir.mkdir()
    aabb = {"aabb_min": [-0.45, -0.6, -0.55], "aabb_max": [0.4, 0.5, 0.3]}  # cuts the ball
    (out_dir / "transforms.json").write_text(json.dumps({"frames": [], "scene_aabb": aabb}))
    tail_cfg = {"output_dir": str(out_dir), "volume_output_path": str(out_dir / "volume.pth"),
                "sliced_vol_path": str(out_dir / "volume_sliced.pth"),
                "transforms_json": str(out_dir / "transforms.json"), "aabb_slice": True}
    (out_dir / "cfg.json").write_text(json.dumps(tail_cfg))
    seconds = {}
    t0 = time.perf_counter()
    vol = extract_volume({**cfg, "checkpoint": str(final)}, resolution=512, device="cuda", verbose=False)
    save_volume(vol, tail_cfg["volume_output_path"])
    seconds["extract 512^3 + save_volume"] = time.perf_counter() - t0
    argv = sys.argv
    try:
        for label, tool, extra in (("post_process_vol", post_process_vol, []),
                                   ("write_format", write_format, ["--grid_size", "512"])):
            sys.argv = [label, "--cfg_path", str(out_dir / "cfg.json"), *extra]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                tool.main()
            seconds[label] = time.perf_counter() - t0
    finally:
        sys.argv = argv
    t0 = time.perf_counter()
    points, rgbs = pp.slice_aabb(*pp.volume_to_points(vol["occupancy_volume"], vol["rgb_volume"],
                                                       vol["metadata"].get("rgb_global_max")), aabb)
    sliced = ckpt.load_pth(tail_cfg["sliced_vol_path"])
    if not (np.array_equal(sliced["points_normalized"], points) and np.array_equal(sliced["rgbs"], rgbs)
            and sliced["aabb_meta"] == aabb):
        raise AssertionError("volume_sliced.pth differs from the sliced points of the extracted volume")
    binary, rgb = pp.voxelize_points(points, rgbs, 512)
    files = {"napari/volume_sliced_binary.tif": (read_tiff_volume, binary),
             "napari/volume_sliced_rgb.tif": (read_tiff_volume, rgb),
             "paraview/volume_sliced_binary.tiff": (read_tiff_volume, np.transpose(binary, (2, 1, 0))),
             "paraview/volume_sliced_rgb.tiff": (read_tiff_volume, np.transpose(rgb, (2, 1, 0, 3))),
             "vti/volume_sliced_binary.vti": (read_vti_volume, np.transpose(binary, (2, 1, 0))),
             # the writer's grey value, mean(rgb) truncated: (r + g + b) // 3 exactly, without a float64 copy
             "vti/volume_sliced_rgb.vti": (read_vti_volume,
                                           np.transpose((rgb.sum(-1, dtype=np.uint16) // 3).astype(np.uint8), (2, 1, 0)))}
    for rel, (read, want) in files.items():
        if not np.array_equal(read(out_dir / rel), want):
            raise AssertionError(f"{rel}: the voxels read back differ from the sliced points'")
    seconds["read back + check"] = time.perf_counter() - t0
    occupied = int((binary > 0).sum())
    if occupied == 0 or occupied > points.shape[0]:
        raise AssertionError(f"{occupied} occupied voxels from {points.shape[0]:,} sliced points")
    phase(f"tail on the tuned ball's 512^3 volume: {int(vol['occupancy_volume'].sum()):,} occupied voxels -> "
          f"{points.shape[0]:,} sliced points -> {occupied:,} voxels in the tif/tiff/vti files (read back, equal); "
          "seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    return seconds


# -- the probes --------------------------------------------------------------

# line of each probe kernel in benchmarks/micro_probe.py
PROBE_LINES = {"k_reshape": 36, "k_transpose": 49, "k_dot_dim0": 61, "k_dot_dim0_bf16": 76, "k_onehot_row": 93,
               "k_col_slice": 108}


def probes_vs_plain(floor: float) -> dict:
    """micro_probe.py's entry point through the port (nerfjax_torch.probes.main)
    on the card, its launches counted; then each of the six kernels against
    its plain version on the probe's inputs (equal; the dots within
    K*2^-24*sum|a||b| per element), timed beside its bound and one PyTorch
    call where one computes the same function; each bound beside the launch
    floor (``floor``, ms), which every probe's bytes and operations fall
    below."""
    import torch

    from nerfjax_torch import probes

    probes.reset_launch_counts()
    if probes.main(device="cuda") != 0:
        raise AssertionError("a probe failed on the card")
    launches = dict(probes.launch_counts)
    x, a, b = probes.probe_inputs("cuda")
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    K, M, N = a.shape[0], a.shape[1], b.shape[1]
    dot_bytes, rows = 4 * (K * M + K * N + M * N), probes.ROWS
    bounds = {
        "k_reshape": _bound(8 * x.numel(), x.numel()),
        "k_transpose": _bound(8 * x.numel(), x.numel()),
        "k_dot_dim0": _bound(dot_bytes, 2 * K * M * N),
        "k_dot_dim0_bf16": _bound(dot_bytes, 2 * K * M * N, "bf16"),
        "k_onehot_row": _bound(4 * x.shape[1] + 4 * rows * x.shape[1], rows * x.shape[1]),
        "k_col_slice": _bound(4 * x.shape[1] + 4 * rows * x.shape[1], rows * x.shape[1]),
    }
    # the bf16 dot's yardstick computes its function from its f32 inputs: both
    # casts and the matmul; the matmul alone on inputs already in bf16 is an
    # extra line
    libraries = {"k_transpose": (lambda: x.t().to(torch.float32), "x.t().to(float32)"),
                 "k_dot_dim0": (lambda: torch.matmul(a.t(), b), "torch.matmul f32"),
                 "k_dot_dim0_bf16": (lambda: torch.matmul(a.t().to(torch.bfloat16), b.to(torch.bfloat16)),
                                     "casts + torch.matmul bf16")}
    stats = {}
    for name, kernel, wrapper, plain, args, dot_bound in probes.probes(x, a, b):
        err = probes.check(name, wrapper(*args), plain(*args), dot_bound)
        library, library_name = libraries.get(kernel, (None, ""))
        t = _time_kernel(lambda: wrapper(*args), lambda: plain(*args), library, bounds[kernel], library_name)
        stats[kernel] = {"max_abs_err": err, "launches": launches[kernel], **t, "floor": floor}
        rule = "within K*2^-24*sum|a||b|" if dot_bound is not None else "(torch.equal)"
        phase(f"{kernel} ({name.strip()}): kernel == plain {rule}, max |err| {err:.3g}; main-path launches "
              f"{launches[kernel]}")
        phase("  " + _timing_line(t) + f"; launch floor {floor * 1e3:.2f} us, so the least time is "
              f"{max(t['bound'][0], floor) * 1e3:.2f} us")
        if kernel == "k_dot_dim0_bf16":
            mm, known = (lambda: torch.matmul(a16.t(), b16)), {}
            bf16_in = [_time_ms(mm, known=known) for _ in range(2)]
            stats[kernel]["library_bf16_inputs_ms"] = sum(bf16_in) / 2
            phase(f"  {kernel}: torch.matmul on inputs already in bf16 (no casts; extra line) "
                  f"{sum(bf16_in) / 2 * 1e3:.2f} us per call (runs l,l: {bf16_in[0] * 1e3:.2f}, {bf16_in[1] * 1e3:.2f})")
        if dot_bound is not None:
            frac = float(((wrapper(*args) - plain(*args)).abs() / dot_bound.clamp_min(1e-30)).max())
            mma = kernel == "k_dot_dim0_bf16"
            note = ": mma.sync, whose f32 sums round otherwise than sequential adds" if mma else ""
            phase(f"  {kernel}: max |err| / (K*2^-24*sum|a||b|) = {frac:.3g} at K={K}{note}")
    return stats


# -- the drop-in operating point and eval rendering -----------------------------

# the model and training keys of cfg/blender_scene.yml (the drop-in point:
# NGP-large, 16 levels, 64 + 128 samples, no occupancy grid, two passes of
# one shared field, the exact estimators), stated so the script needs no
# PyYAML
DROP_IN_TRAIN = {"ngp": True, "nerf_type": "large", "batch_size": 8192, "lr": 0.0005, "N_samples": 64,
                 "N_importance": 128, "white_bg": False, "precision": "bf16", "occupancy_grid": False}
# the CPU tests' small drop-in size (tests/test_torch_train_step.py), in fp32
DROP_IN_SMALL = {**DROP_IN_TRAIN, "nerf_type": "small", "hash_n_levels": 8, "batch_size": 256, "lr": 5e-3,
                 "precision": "fp32", "N_samples": 8, "N_importance": 16}
DROP_IN_KERNELS = ("hash_levels_fwd", "dense_levels_fwd", "dense_levels_bwd", "table_grad_scatter", "hash_levels_bwd")
EVAL_SIZE = 256  # pixels per side of the held-out renders
EVAL_POSES = 3
EVAL_PSNR_DB = 25.0  # the least mean PSNR of the 64 + 128 renders against the analytic ball


def train_dropin(tmp: Path) -> dict:
    """cfg/blender_scene.yml's model and training keys at full width through
    nerfjax_torch.train.train, 1 epoch of 128 steps on phase 7's NPZ: PSNR,
    NaNs, the coarse loss, each hash kernel launched twice per step (K1 and
    K4 in both forwards, K5, K3 and K2 in both backwards); then a warm
    median, the split by stage, the idle share, and every hash kernel's
    arguments in one more warm step."""
    import torch

    from nerfjax_torch.data import RayDataset, batch_to_device
    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import TrainSettings, make_train_state, train, train_step

    cfg = {**DROP_IN_TRAIN, "num_epochs": 1, "rays_file": str(tmp / "rays.npz"), "output_dir": str(tmp / "out_dropin"),
           "checkpoint_dir": str(tmp / "out_dropin" / "checkpoints")}
    he.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(cfg, seed=SEED, log_every=64, device="cuda")
    wall = time.perf_counter() - t0
    launches = _planar_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    psnr = np.asarray(out["psnr"])
    first, last = float(psnr[:20].mean()), float(psnr[-20:].mean())
    steps = out["steps"]
    phase(f"train() drop-in (cfg/blender_scene.yml keys): {steps} steps in {wall:.2f} s wall, PSNR first 20 steps "
          f"{first:.2f} dB, last 20 {last:.2f} dB; last logged coarse loss {out['metrics']['loss_coarse']:.5f}; "
          f"peak device memory {peak:.2f} GiB; launches {launches}")
    if not np.isfinite(psnr).all() or not all(np.isfinite(v["w"]).all() for v in out["params"]["dmlp"]):
        raise AssertionError("NaN in drop-in training")
    if last < first + PSNR_RISE_DB:
        raise AssertionError(f"drop-in PSNR rose {last - first:.2f} dB, expected >= {PSNR_RISE_DB}")
    if not out["metrics"]["loss_coarse"] > 0:
        raise AssertionError("the drop-in step reported no coarse loss")
    if launches != {k: 2 * steps for k in launches}:
        raise AssertionError(f"drop-in launches {launches}, expected {2 * steps} of each (two encodes per step)")

    settings = TrainSettings.from_cfg(cfg, steps)
    state = make_train_state(cfg, settings, seed=SEED, device="cuda")
    data = RayDataset(cfg["rays_file"], verbose=False)
    batches = [batch_to_device(b, "cuda") for _, b in zip(range(47), data.epoch_batches(8192, seed=SEED))]
    for b in batches[:8]:
        train_step(state, b)
    torch.cuda.synchronize()
    times = []
    for b in batches[8:32]:
        t1 = time.perf_counter()
        train_step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    med = float(np.median(times))
    phase(f"warm drop-in train_step: median {med:.2f} ms/step over {len(times)} steps (min {min(times):.2f}, "
          f"max {max(times):.2f}) = {8192 / med * 1e3:,.0f} rays/s, {8192 * 192 / med * 1e3:,.0f} fine points/s")
    split = _stage_split(state, batches[32:40])
    phase("drop-in split, ms per step (CUDA events around train_step's calls, 8 steps): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; sum {sum(split.values()):.3f}")
    busy, traced, idle = _idle_share(state, batches[40:46])
    phase(f"profiler, 6 warm drop-in steps: device busy {busy:.2f} ms of {traced:.2f} ms traced wall: "
          f"idle share {idle:.1%}")
    _report_encode_copies(state, batches[45], "drop-in")
    torch.cuda.reset_peak_memory_stats()
    cap = capture_step_inputs(state, batches[46], names=DROP_IN_KERNELS)
    if len(cap) != 2:
        raise AssertionError(f"the drop-in step ran {len(cap)} field passes ({sorted(cap)} points), expected 2")
    phase(f"one warm drop-in step (inputs captured): peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    final = Path(cfg["checkpoint_dir"]) / "nerf_final.pth"
    if not final.exists():
        raise AssertionError("the drop-in run wrote no nerf_final.pth")
    return {"launches": launches, "ms_per_step": med, "step_inputs": cap, "final": final}


# cfg/base_cfg.yml's model and training keys with ngp: false (its defaults: pos_L 10, dir_L 4, hidden 256,
# batch 4096, 64 + 128 samples, bf16, no occupancy grid): vanilla NeRF at full width
VANILLA_TRAIN = {"ngp": False, "pos_L": 10, "dir_L": 4, "hidden_dim": 256, "batch_size": 4096, "lr": 0.0005,
                 "N_samples": 64, "N_importance": 128, "precision": "bf16", "occupancy_grid": False,
                 "single_pass": False}
VANILLA_EXTRACT_LIMIT_S = 30.0  # the 512^3 extraction runs when the 256^3 one predicts it within this


def train_vanilla(tmp: Path) -> dict:
    """Vanilla NeRF (VANILLA_TRAIN) through the CLI, ``python -m
    nerfjax_torch.cli.train`` in this process on a JSON cfg (train()'s
    result read by wrapping it), one epoch of 256 steps on phase 7's NPZ:
    PSNR of the first and last 20 steps (must rise by PSNR_RISE_DB, every
    value finite), peak memory; a warm median ms/step, the split by stage
    (coarse and fine field, the composites, AdamW), the idle share; the
    trained checkpoint extracted at 256^3 (IoU with the ball), then through
    the extract_vol CLI at 512^3 when 8x the 256^3 wall stays under
    VANILLA_EXTRACT_LIMIT_S (else 256^3), the render and eval_psnr CLIs on
    it (two 64^2 frames of tests/synthetic.make_image_scene, the frames of
    another scene: they show the CLIs run, not quality); the checkpoint
    reloaded (both MLPs equal to train()'s) and a resumed state written and
    read back."""
    import torch

    from nerfjax_torch import checkpoint as ckpt
    from nerfjax_torch import train as train_module
    from nerfjax_torch.extract import load_volume
    from nerfjax_torch.train import TrainSettings, make_train_state

    root = tmp / "out_vanilla"
    scene = _synthetic_module().make_image_scene(root / "scene", "vanilla", n_frames=2, H=64, W=64)
    cfg = {**VANILLA_TRAIN, "num_epochs": 1, "rays_file": str(tmp / "rays.npz"), "output_dir": str(root),
           "checkpoint_dir": str(root / "checkpoints"), "checkpoint": str(root / "checkpoints" / "nerf_final.pth"),
           "volume_output_path": str(root / "volume.pth"), "transforms_json": str(scene)}
    (root / "vanilla.json").write_text(json.dumps(cfg))
    cli_cfg = ["--cfg_path", str(root / "vanilla.json")]
    real_train, result = train_module.train, {}

    def recorded_train(*args, **kw):
        result["out"] = real_train(*args, **kw)
        return result["out"]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_module.train = recorded_train
    try:
        _run_cli("nerfjax_torch.cli.train", cli_cfg, root)
    finally:
        train_module.train = real_train
    wall = time.perf_counter() - t0
    out = result["out"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    psnr = np.asarray(out["psnr"])
    first, last = float(psnr[:20].mean()), float(psnr[-20:].mean())
    finite = all(np.isfinite(v).all() for mlp in out["params"].values() for v in _param_leaves(mlp))
    phase(f"python -m nerfjax_torch.cli.train, vanilla NeRF (ngp: false, pos_L 10, dir_L 4, hidden 256, 64 + 128 "
          f"samples, batch 4096, bf16): {out['steps']} steps in {wall:.2f} s wall ({wall / out['steps'] * 1e3:.2f} "
          f"ms/step with the feed and the checkpoint), PSNR first 20 steps {first:.2f} dB, last 20 {last:.2f} dB; "
          f"last logged coarse loss {out['metrics']['loss_coarse']:.5f}; peak device memory {peak:.2f} GiB")
    if not np.isfinite(psnr).all() or not finite:
        raise AssertionError("vanilla training: a PSNR or a parameter is not finite")
    if last < first + PSNR_RISE_DB:
        raise AssertionError(f"vanilla PSNR rose {last - first:.2f} dB, expected >= {PSNR_RISE_DB}")
    state, rest, med = _warm_steps(cfg, tmp / "rays.npz", 8, 24, "vanilla", batch_size=4096)
    split = _stage_split(state, rest[:8])
    phase("vanilla split, ms per step (CUDA events around train_step's calls, 8 steps): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f"; sum {sum(split.values()):.3f}")
    busy, traced, idle = _idle_share(state, rest[8:12])
    phase(f"profiler, 4 warm vanilla steps: device busy {busy:.2f} ms of {traced:.2f} ms traced wall: "
          f"idle share {idle:.1%}")
    del state, rest

    final = Path(cfg["checkpoint"])
    t0 = time.perf_counter()
    iou = extract_trained(cfg, final, label="vanilla field")
    t256 = time.perf_counter() - t0
    res = 512 if 8 * t256 <= VANILLA_EXTRACT_LIMIT_S else 256
    t0 = time.perf_counter()
    _run_cli("nerfjax_torch.cli.extract_vol", [*cli_cfg, "--resolution", str(res)], root)
    t_cli = time.perf_counter() - t0
    occ = load_volume(cfg["volume_output_path"])["occupancy_volume"]
    if occ.shape != (res,) * 3 or not 0 < occ.mean() < 1:
        raise AssertionError(f"vanilla {res}^3 extraction: occupancy {occ.shape}, share {occ.mean():.3f}")
    phase(f"python -m nerfjax_torch.cli.extract_vol on the vanilla checkpoint at {res}^3 "
          f"({'512^3: 8x' if res == 512 else '256^3: 512^3 not run, 8x'} the 256^3 wall of {t256:.2f} s against "
          f"{VANILLA_EXTRACT_LIMIT_S:.0f} s): {t_cli:.2f} s wall, volume.pth read back, occupied {occ.mean():.2%}")
    said = _run_cli("nerfjax_torch.cli.render", [*cli_cfg, "--frame", "0", "--orbit", "1"], root)
    pngs = sorted((root / "renders").glob("*.png"))
    evals = _run_cli("nerfjax_torch.cli.eval_psnr", cli_cfg, root)
    m = [line for line in evals.splitlines() if line.startswith("mean PSNR")]
    if len(pngs) != 2 or said.count("wrote") != 2 or not m:
        raise AssertionError(f"the vanilla render / eval_psnr CLIs: {len(pngs)} PNGs, {m}")
    phase(f"python -m nerfjax_torch.cli.render and eval_psnr on the vanilla checkpoint: {len(pngs)} PNGs of 64^2; "
          f"{m[0]} (another scene's frames: the CLIs run, no quality is claimed)")

    # the checkpoint: both MLPs reload equal to train()'s, and a state written again reads back
    for which in ("coarse", "fine"):
        got = ckpt.params_to_numpy(ckpt.load_field(final, cfg, "cuda", which).params())
        for a, b in zip(_param_leaves(got), _param_leaves(out["params"][which])):
            if not np.array_equal(a, b):
                raise AssertionError(f"vanilla nerf_final.pth: the {which} MLP reloads other than train() left it")
    fresh = make_train_state(cfg, TrainSettings.from_cfg(cfg, out["steps"]), seed=SEED + 1, device="cuda")
    epoch = ckpt.restore_train_state(final, fresh.field, fresh.optimizer, field_coarse=fresh.field_coarse)
    again = root / "again.pth"
    ckpt.save_train_state(again, cfg, fresh.field, fresh.optimizer, epoch, field_coarse=fresh.field_coarse)
    a, b = ckpt.load_pth(final), ckpt.load_pth(again)
    same = all(np.array_equal(a[k][n], b[k][n]) for k in ("nerf_coarse_state_dict", "nerf_fine_state_dict")
               for n in a[k])
    same &= all(np.array_equal(a["optimizer_state_dict"]["state"][i]["exp_avg"],
                               b["optimizer_state_dict"]["state"][i]["exp_avg"])
                for i in a["optimizer_state_dict"]["state"])
    if not same or epoch != 1:
        raise AssertionError("the vanilla checkpoint, restored into a fresh state and written again, differs")
    phase(f"vanilla checkpoint: {final.stat().st_size / 2**20:.2f} MiB; both MLPs reload equal to train()'s; "
          f"restored into a fresh state (epoch {epoch}, {len(a['optimizer_state_dict']['state'])} AdamW leaves) and "
          f"written again: every state dict and moment equal")
    return {"ms_per_step": med, "psnr": (first, last), "steps": out["steps"], "wall_s": wall, "peak_gib": peak,
            "split": split, "idle": idle, "iou": iou, "extract_256_s": t256, "extract_res": res,
            "extract_cli_s": t_cli}


def _param_leaves(tree) -> list:
    """The arrays of a nested dict/list of params, in order."""
    if isinstance(tree, dict):
        return [a for k in tree for a in _param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _param_leaves(v)]
    return [np.asarray(tree)]


def _feed_ms(state, data, feed, seed: int) -> float:
    """Host ms per step of one epoch of train_step on the batches ``feed``
    makes of data's epoch (no sync inside; one at each end)."""
    import torch

    from nerfjax_torch.train import train_step

    torch.cuda.synchronize()
    t0, n = time.perf_counter(), 0
    for batch in feed(data.epoch_batches(8192, seed=seed)):
        train_step(state, batch)
        n += 1
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def steps_around_train(tmp: Path) -> None:
    """The batch feed, then train(): (1) epochs of the tuned cfg's
    train_step on a warm state, fed by batch_to_device (a copy from
    pageable memory), prefetch_to_device (depth 2, as train() feeds them)
    and prefetch_to_device at depth 1, in the order a, b, c, c, b, a, each
    one line; (2) the warm train_step medians (_warm_steps: 16 warm, 32
    timed, a fresh state) of the tuned, fast and drop-in cfgs, each taken
    before and after a train() of that cfg (tuned 3 epochs, the others 1),
    with train()'s wall per step: one line per cfg."""
    import torch

    from nerfjax_torch.data import RayDataset, batch_to_device, prefetch_to_device
    from nerfjax_torch.train import TrainSettings, make_train_state, train

    ray_npz(tmp / "rays.npz")
    cfg = {**TUNED_TRAIN, "rays_file": str(tmp / "rays.npz")}
    state = make_train_state(cfg, TrainSettings.from_cfg(cfg, 1024), seed=SEED, device="cuda")
    data = RayDataset(tmp / "rays.npz", verbose=False)
    feeds = {"batch_to_device": lambda it: (batch_to_device(b, "cuda") for b in it),
             "prefetch_to_device": lambda it: prefetch_to_device(it, "cuda"),
             "prefetch_to_device depth 1": lambda it: prefetch_to_device(it, "cuda", depth=1)}
    _feed_ms(state, data, feeds["batch_to_device"], SEED)  # warm
    runs = {name: [] for name in feeds}
    for i, name in enumerate((*feeds, *reversed(feeds))):
        runs[name].append(_feed_ms(state, data, feeds[name], SEED + 1 + i))
    phase("feed, tuned train_step on a warm state, host ms per step over an epoch of 128 (runs a, b, c, c, b, a): "
          + "; ".join(f"{name} {', '.join(f'{v:.2f}' for v in r)}" for name, r in runs.items()))
    del state
    for label, base, epochs in (("tuned", TUNED_TRAIN, TRAIN_EPOCHS), ("fast", FAST_TRAIN, 1),
                                ("drop-in", DROP_IN_TRAIN, 1)):
        out_dir = tmp / f"steps_{label}"
        cfg = {**base, "num_epochs": epochs, "rays_file": str(tmp / "rays.npz"), "output_dir": str(out_dir),
               "checkpoint_dir": str(out_dir / "checkpoints")}
        before = _warm_steps(cfg, tmp / "rays.npz", 16, 32, f"{label}, before train()")[2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train(cfg, seed=SEED, log_every=64, device="cuda")
        wall = (time.perf_counter() - t0) / out["steps"] * 1e3
        after = _warm_steps(cfg, tmp / "rays.npz", 16, 32, f"{label}, after train()")[2]
        phase(f"steps {label}: warm median {before:.2f} ms/step before train(), {after:.2f} after; train() "
              f"{wall:.2f} ms per step over {out['steps']} steps (checkpoint writes included)")


def _ball_image(K: np.ndarray, c2w: np.ndarray, H: int, W: int) -> np.ndarray:
    """[H, W, 3] float32: the analytic ball seen from c2w, with the exact
    volume rendering that colors ray_npz's rays (BALL_RGB * (1 - exp(-sigma
    * chord))), black where a ray misses the ball."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    pix = np.stack([u.ravel(), v.ravel(), np.ones(H * W)])
    d = np.diag([1.0, -1.0, -1.0]) @ (np.linalg.inv(K.astype(np.float64)) @ pix)
    d = (c2w[:3, :3].astype(np.float64) @ (d / np.linalg.norm(d, axis=0, keepdims=True))).T
    oc = c2w[:3, 3].astype(np.float64) - BALL_CENTER
    b = d @ oc
    disc = b * b - (oc @ oc - BALL_RADIUS**2)
    chord = 2.0 * np.sqrt(np.maximum(disc, 0.0))
    return (BALL_RGB[None, :] * (1.0 - np.exp(-BALL_SIGMA * chord))[:, None]).reshape(H, W, 3).astype(np.float32)


def _psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(-10.0 * np.log10(max(float(np.mean((pred - gt) ** 2)), 1e-12)))


FRAME_STAGES = ("rays + stratified sample", "coarse encode", "coarse head", "composite + sample_pdf + sort",
                "fine encode", "fine head", "composite", "host remainder")


def _frame_split(field, K, c2w, H: int, W: int, seed: int) -> dict:
    """One 64 + 128 render_image frame split by stage, ms on the card's
    clock: CUDA events recorded around the render's own calls
    (render_rays_planar per chunk, the field's encode and the head per
    pass) and at the frame's start and end (it ends in a copy to the host,
    which synchronises). Each interval between two marks goes to a stage:
    up to a chunk's coarse encode to "rays + stratified sample" (the frame's
    rays and ray-cube hits, then the chunk's draws, depths and positions),
    from the coarse encode's end to the coarse head's end to "coarse head"
    (the directions' SH encode included), from there to the fine encode to
    "composite + sample_pdf + sort" (the fine positions included), after
    the fine head to "composite", between chunks and after the last to
    "host remainder". Where the card waits on the host an interval holds
    the host's time: the stages add up to the frame's wall."""
    import torch

    from nerfjax_torch import render_image as ri
    from nerfjax_torch.ops import fused_mlp as fm

    marks = []

    def mark(label):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((label, e))

    def around(label, fn):
        def run(*args, **kw):
            mark(label)
            out = fn(*args, **kw)
            mark(label + " end")
            return out
        return run

    real_rays, real_head = ri.render_rays_planar, fm.fused_ngp_head
    ri.render_rays_planar, fm.fused_ngp_head = around("chunk", real_rays), around("head", real_head)
    field.encode = around("encode", field.encode)  # an instance attribute over the method
    try:
        mark("start")
        ri.render_image(field, K, c2w, H, W, n_samples=64, n_importance=128, seed=seed)
        mark("end")
        torch.cuda.synchronize()
    finally:
        ri.render_rays_planar, fm.fused_ngp_head = real_rays, real_head
        del field.encode
    stage = {("encode", 0): 1, ("encode end", 0): 2, ("head", 0): 2, ("head end", 0): 3,
             ("encode", 1): 4, ("encode end", 1): 5, ("head", 1): 5, ("head end", 1): 6}
    split, fine = dict.fromkeys(FRAME_STAGES, 0.0), 0
    for (label, e0), (_, e1) in zip(marks, marks[1:]):
        if label == "chunk":
            fine = 0
        i = 0 if label in ("start", "chunk") else 7 if label in ("chunk end",) else stage[(label, fine)]
        if label == "head end":
            fine = 1
        split[FRAME_STAGES[i]] += e0.elapsed_time(e1)
    return split


def eval_render(final: Path, cfg: dict, label: str, stats: dict, hstats: dict) -> dict:
    """render_image on the card from a trained ball (``cfg``'s model) at
    EVAL_SIZE^2 and EVAL_POSES held-out orbit poses (radius 2.5, height
    1.2: outside the training cameras' sphere): at 64 + 128 samples (the
    main path, launches counted; mean PSNR against the analytic ball >=
    EVAL_PSNR_DB) and at the tuned cfg's 8 + 16 (PSNR printed only: the
    tuned field was trained on occupancy samples); the render's rays/s.
    The head, K1 and K4 are held against their plain versions on the
    arguments of their last call in each pass of the 64 + 128 render (the
    head as in kernels_vs_plain, K1 and K4 equal; errors folded into
    ``stats`` and ``hstats``), and the head is timed at the fine pass's
    call (extra line)."""
    import torch

    from nerfjax_torch.checkpoint import load_field
    from nerfjax_torch.ops import fused_mlp as fm
    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.render_image import orbit_poses, render_image

    field = load_field(final, cfg, device="cuda")
    H = W = EVAL_SIZE
    K = np.array([[W, 0.0, W / 2], [0.0, W, H / 2], [0.0, 0.0, 1.0]], np.float32)
    poses = orbit_poses(EVAL_POSES)
    gts = [_ball_image(K, c2w, H, W) for c2w in poses]
    render_image(field, K, poses[0], H, W)  # warm-up: the allocator, first launches
    result, seen = {}, {}
    for ns, ni in ((64, 128), (8, 16)):
        main_path = (ns, ni) == (64, 128)
        fm.reset_launch_counts()
        he.reset_launch_counts()
        rec = (_recorded((fm, "fused_ngp_head"), (he, "hash_levels_fwd"), (he, "dense_levels_fwd")) if main_path
               else contextlib.nullcontext(seen))
        with rec as calls:
            t0 = time.perf_counter()
            imgs = [render_image(field, K, c2w, H, W, n_samples=ns, n_importance=ni, seed=i)
                    for i, c2w in enumerate(poses)]
            wall = time.perf_counter() - t0
        seen = calls
        launches = {**fm.launch_counts,
                    **{k: he.launch_counts[k] for k in ("hash_levels_fwd", "pack_pairs", "dense_levels_fwd")}}
        psnrs = [_psnr(img, gt) for img, gt in zip(imgs, gts)]
        if not all(np.isfinite(img).all() for img in imgs):
            raise AssertionError(f"NaN in the {ns}+{ni} eval render")
        phase(f"eval render of the {label} field, {ns}+{ni}, {EVAL_POSES} orbit poses at {H}x{W} (bf16): PSNR "
              "against the analytic ball "
              + ", ".join(f"{p:.2f}" for p in psnrs) + f" dB (mean {np.mean(psnrs):.2f}); {wall:.2f} s wall = "
              f"{EVAL_POSES * H * W / wall:,.0f} rays/s; launches {launches}")
        if main_path:
            if launches["fused_ngp_head"] <= 0 or launches["fused_ngp_density"] != 0:
                raise AssertionError(f"the eval render's field passes did not all run the head kernel: {launches}")
            if np.mean(psnrs) < EVAL_PSNR_DB:
                raise AssertionError(f"eval render mean PSNR {np.mean(psnrs):.2f} dB < {EVAL_PSNR_DB}")
            result = {"launches": launches, "psnr": psnrs, "rays_per_s": EVAL_POSES * H * W / wall}
            splits = [_frame_split(field, K, c2w, H, W, i) for i, c2w in enumerate(poses)]
            for i, sp in enumerate(splits):
                phase(f"  the {label} 64+128 frame {i} by stage (CUDA events), ms: "
                      + ", ".join(f"{k} {v:.3f}" for k, v in sp.items()) + f"; frame {sum(sp.values()):.3f}")
            result["frame_split"] = {k: float(np.mean([sp[k] for sp in splits])) for k in FRAME_STAGES}

    head_err = 0.0
    for N, calls in sorted(seen.items()):
        (params, enc, sh), kw = calls["fused_ngp_head"]
        for got, ref in zip(fm.fused_ngp_head(params, enc, sh, **kw), fm.fused_ngp_head_plain(params, enc, sh)):
            err = float((got.float() - ref.float()).abs().max())
            if not (_ulp_ok(got, ref) if enc.dtype == torch.bfloat16 else err <= 2e-5):
                raise AssertionError(f"fused_ngp_head at the {label} eval render (N={N:,}, E={enc.shape[0]}, "
                                     f"{enc.dtype}) disagrees with its plain version: {err}")
            head_err = max(head_err, err)
        (spec, planes, x, y, z), _ = calls["hash_levels_fwd"]
        if not torch.equal(he.hash_levels_fwd(spec, planes.detach(), x, y, z),
                           he.hash_levels_fwd_plain(spec, planes.detach(), x, y, z)[0]):
            raise AssertionError(f"hash_levels_fwd at the {label} eval render (N={N:,}): kernel != plain")
        (spec, planes, x, y, z, dtype), _ = calls["dense_levels_fwd"]
        got = he.dense_levels_fwd(spec, planes.detach(), x, y, z, dtype)
        ref, _ = he.dense_levels_fwd_plain(spec, planes.detach(), x, y, z, dtype)
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            raise AssertionError(f"dense_levels_fwd at the {label} eval render (N={N:,}): kernel != plain")
        which = "fine" if N == max(seen) else "coarse"
        _k4_timed(hstats["dense_levels_fwd"]["shapes"], f"eval_{label.replace('-', '')}_{which}", spec,
                  planes.detach(), x, y, z, dtype)
    stats["fused_ngp_head"]["max_abs_err"] = max(stats["fused_ngp_head"]["max_abs_err"], head_err)
    phase(f"the {label} eval render's kernels on their last call in each pass (N = "
          + ", ".join(f"{n:,}" for n in sorted(seen)) + f"): fused_ngp_head within one bf16 ulp of its plain "
          f"version (max |err| {head_err:.3g}), hash_levels_fwd and dense_levels_fwd == plain")
    (params, enc, sh), kw = seen[max(seen)]["fused_ngp_head"]
    E, N = enc.shape
    result["head_timing"] = _time_kernel(lambda: fm.fused_ngp_head(params, enc, sh, **kw),
                                         lambda: fm.fused_ngp_head_plain(params, enc, sh), None,
                                         _bound(*_head_work(E, N), "bf16"))
    phase(f"  fused_ngp_head at the {label} eval render's fine pass (E={E}, N={N:,}, bf16; extra line): "
          + _timing_line(result["head_timing"]))
    return result


def dropin_step_card_vs_cpu(tmp: Path) -> None:
    """One drop-in step at the CPU tests' small size in float32 on the card
    (kernels) and on the CPU (plain versions), with the same parameters,
    batch and uniforms, under phase 9's rule (coarse loss too). The
    importance depths of both are the CPU's: an importance depth in a bin
    of low pdf moves by the coarse weights' rounding over that pdf (at init
    ~6e-8 of rounding in 1 - exp(-sigma*delta) on weights of ~1e-6), which
    would move points across grid cells; the sampler itself is held card
    against CPU on the CPU's weights (within 5e-5, the CPU tests' bound)."""
    import torch

    from nerfjax_torch import render
    from nerfjax_torch.data import RayDataset, batch_to_device
    from nerfjax_torch.train import TrainSettings, make_train_state, train_step

    cfg = {**DROP_IN_SMALL, "num_epochs": 1}
    settings = TrainSettings.from_cfg(cfg, 100)
    cpu = make_train_state(cfg, settings, seed=SEED, device="cpu")
    card = make_train_state(cfg, settings, seed=SEED, device="cuda")
    batch = next(RayDataset(tmp / "rays.npz", verbose=False).epoch_batches(256, seed=SEED))
    u_strat = torch.rand(256, settings.n_samples, generator=torch.Generator().manual_seed(3))
    u_pdf = torch.rand(256, settings.n_importance, generator=torch.Generator().manual_seed(4))
    real, seen = render.sample_pdf, []

    def record(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    bc = batch_to_device(batch, "cpu")
    render.sample_pdf = record
    try:
        with torch.no_grad():
            render.render_rays_planar(cpu.field, cpu.field, bc["rays_o"], bc["rays_d"], bc["t_near"], bc["t_far"],
                                      settings.n_samples, settings.n_importance, train=True, dtype=torch.float32,
                                      u_strat=u_strat, u_pdf=u_pdf)
    finally:
        render.sample_pdf = real
    (bins, w, n), kw = seen[0]
    z_imp = real(bins, w, n, **kw)
    zerr = float((real(bins.cuda(), w.cuda(), n, u=u_pdf.cuda()).cpu() - z_imp).abs().max())
    if zerr > 5e-5:
        raise AssertionError(f"sample_pdf card vs cpu on the same weights: {zerr}")
    render.sample_pdf = lambda bins, w, n, *, u=None, generator=None: z_imp.to(bins.device)
    try:
        m_cpu = train_step(cpu, bc, u_strat=u_strat, u_pdf=u_pdf)
        m_card = train_step(card, batch_to_device(batch, "cuda"), u_strat=u_strat.cuda(), u_pdf=u_pdf.cuda())
    finally:
        render.sample_pdf = real
    lerr, worst = _steps_agree(cpu, card, m_cpu, m_card, cfg["lr"], ("loss_fine", "loss_coarse"))
    phase(f"drop-in train step card vs cpu (fp32, small): sample_pdf max |err| {zerr:.2g} on the same weights; "
          f"losses rel err {lerr:.2g}, gradients within rtol 1e-4, parameters after AdamW within {worst:.2g} "
          f"(bound {1e-3 * cfg['lr']:.1g})")


def render_card_vs_cpu(final: Path) -> None:
    """One 32 x 32 render_image of phase 7's trained ball in float32 on the
    card (head kernel) and on the CPU (its plain version) with the same
    uniforms (the draws hook): max |diff| <= 1e-2 and mean <= 1e-4. The
    coarse weights differ by float32 rounding, which moves importance
    depths within bins of low pdf, empty space where the weights and so the
    colors are small."""
    import torch

    from nerfjax_torch.checkpoint import load_field
    from nerfjax_torch.render_image import orbit_poses, render_image

    H = W = 32
    K = np.array([[W, 0.0, W / 2], [0.0, W, H / 2], [0.0, 0.0, 1.0]], np.float32)
    c2w = orbit_poses(EVAL_POSES)[1]

    def draws(s, B):
        rng = np.random.default_rng(SEED + s)
        return rng.uniform(size=(B, 64)).astype(np.float32), rng.uniform(size=(B, 128)).astype(np.float32)

    imgs = [render_image(load_field(final, TUNED_CFG, device=dev), K, c2w, H, W, chunk_rays=256,
                         dtype=torch.float32, draws=draws) for dev in ("cuda", "cpu")]
    err = np.abs(imgs[0] - imgs[1])
    if err.max() > 1e-2 or err.mean() > 1e-4:
        raise AssertionError(f"32x32 render card vs cpu: max |diff| {err.max():.3g}, mean {err.mean():.3g}")
    phase(f"32x32 f32 render card vs cpu: max |diff| {err.max():.3g}, mean {err.mean():.3g}; PSNR card "
          f"{_psnr(imgs[0], _ball_image(K, c2w, H, W)):.2f} dB")


# -- phase R: the feature-last path (nerfjax's render_rays) ---------------------------------------

R_EVAL_N = PARITY_EVAL_RAYS * sum(PARITY_EVAL_SAMPLES)  # 786,432: nerfjax's eval fine pass, 4,096 rays at 64 + 128
R_FACE = 4096  # points per face of the domain in the seeded positions
R_SMALL = {"ngp": True, "nerf_type": "small", "hash_n_levels": 6}  # tests/test_torch_feature_last.py's spec
R_RAYS = 64  # rays of the card-vs-CPU render, 16 + 32 samples
R_FIRST_PEAK_GIB = 3.58  # R2's peak with the first design's backward (staged terms, then K3), PERF.md


def _hashgrid_x01(N: int, rng):
    """x01 [N, 3] on the card, uniform in [0, 1] but for the domain's faces:
    for each axis R_FACE points at 0 and R_FACE at 1 on it, and the first
    two points the corners 0 and 1."""
    x01 = _rand((N, 3), rng, 0.0, 1.0)
    for a in range(3):
        x01[2 * a * R_FACE:(2 * a + 1) * R_FACE, a] = 0.0
        x01[(2 * a + 1) * R_FACE:(2 * a + 2) * R_FACE, a] = 1.0
    x01[0], x01[1] = 0.0, 1.0
    return x01


def _hashgrid_check(spec, planes, x01, label: str) -> None:
    """hashgrid_fwd torch.equal to hashgrid_encode_plain (the kernel sums
    each level's 8 corners in the plain version's order, each product and
    sum rounded on its own), and the float2 pack in front of it torch.equal
    to pack_pairs_plain."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    if not torch.equal(he.hashgrid_fwd(spec, planes, x01), he.hashgrid_encode_plain(spec, planes, x01)):
        raise AssertionError(f"hashgrid_fwd ({label}): kernel != plain")
    if not torch.equal(he.pack_pairs(planes, f32=True), he.pack_pairs_plain(planes, True)):
        raise AssertionError(f"pack_pairs ({label}): kernel != plain")


def _hashgrid_bounds(spec, x01) -> tuple[tuple, tuple]:
    """The feature-last forward's bound at x01, twice. Bytes: positions in
    (12 B a point), the [N, 2L] f32 output out (8 L B a point), and the
    table: (1) each distinct entry the call touches, both planes, once
    (8 B: the guide's rule, every repeat served by the L2); (2) every gather
    counted, 8 B for each of a (point, level)'s 8 corners, the design's
    bytes if no cache served a repeat. Operations: 110 a (point, level) (K1
    exact's count), at the FP32 peak. The pack in front is left out: the
    bound is the function's."""
    import torch

    from nerfjax_torch.fields.ngp import hashgrid_indices_and_weights

    N, L = x01.shape[0], spec.n_levels
    touched = torch.unique(hashgrid_indices_and_weights(spec, x01)[0]).numel()
    base, ops = 12 * N + 8 * L * N, 110 * L * N
    return _bound(base + 8 * touched, ops), _bound(base + 64 * L * N, ops)


def _hashgrid_timed(spec, planes, x01, label: str) -> dict:
    from nerfjax_torch.ops import hash_encode as he

    bound, gathers = _hashgrid_bounds(spec, x01)
    t = _time_kernel(lambda: he.hashgrid_fwd(spec, planes, x01), lambda: he.hashgrid_encode_plain(spec, planes, x01),
                     None, bound)
    t.update(N=x01.shape[0], gathers_bound=gathers)
    phase(f"  hashgrid_fwd {label} (the pack included): " + _timing_line(t) + f"; with every gather counted the "
          f"bound is {gathers[0] * 1e3:.1f} us ({gathers[1]}), the call at {gathers[0] / t['ms']:.0%} of it")
    return t


def _hashgrid_bwd_checked(spec, g, x01, label: str) -> dict:
    """hashgrid_bwd against hashgrid_bwd_plain within the atomic-order bound
    (_check_scatter); its float2 adds (hashgrid_bwd_add_count, the plain
    emulation run on these tensors) beside the first design's: one staged
    term per (level, corner, point), then K3's merged runs of them."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    total = spec.total_table_size
    idx, v0, v1 = he.hashgrid_bwd_entries_plain(spec, g, x01)
    one = torch.ones_like(v0)
    err = _check_scatter(f"hashgrid_bwd ({label})", he.hashgrid_bwd(spec, g, x01, _zeros2(total)),
                         he.table_grad_scatter_plain(idx, v0, v1, _zeros2(total)),
                         he.table_grad_scatter_plain(idx, v0.abs(), v1.abs(), _zeros2(total)),
                         he.table_grad_scatter_plain(idx, one, one, _zeros2(total)))
    return {"max_abs_err": err, "adds": he.hashgrid_bwd_add_count(spec, g, x01), "staged": idx.numel(),
            "k3_adds": he.k3_atomic_count(idx, total), "touched": int(torch.unique(idx).numel()),
            "zero_share": float((g == 0).sum()) / g.numel()}


def feature_last_phase(tmp: Path, final: Path | None, smi: str, eval_call=None) -> dict:
    """Phase R, nerfjax's point-major path on the port.

    R1: hashgrid_fwd torch.equal to its plain version at nerfjax's eval
    shape (N = R_EVAL_N seeded positions with the domain's faces) at the
    quality protocol's spec (medium, 16 levels) and the tuned cfg's (large,
    12 levels, 1 promoted dense), the pack torch.equal to its plain
    version, timed beside its bounds (_hashgrid_bounds). R2: one
    render_rays(train=True) pass and the backward of its two losses at the
    drop-in shape (DROP_IN_TRAIN's model, the checkpoint ``final`` or a
    seeded init, 8192 rays of phase 7's NPZ, 64 + 128), the launch counts
    set to 0 just before and read just after: hashgrid_fwd 4 (two passes,
    each recomputed under remat), pack_pairs 4 (one in front of each),
    hashgrid_bwd 2, no other kernel; its peak memory beside the first
    design's; then, on the arguments each wrapper got there, hashgrid_fwd
    torch.equal to plain and hashgrid_bwd within the atomic-order bound of
    hashgrid_bwd_plain, its float2 adds beside the first design's
    (_hashgrid_bwd_checked); both timed at the fine pass (the backward net
    of the caller's zero fill, and with it). ``eval_call``: the quality
    phase's first eval's fine pass (spec, planes, x01), checked and timed
    as R1. R3: render_rays on the card against the CPU at the CPU tests'
    small spec in f32, the same field and uniforms, train off and on: the
    coarse pass (same depths) within 2e-5, rgb_fine within 1e-3 (an
    importance depth in a bin of low pdf moves by the coarse weights'
    float32 noise over that pdf, as tests/test_torch_render_hier.py
    explains)."""
    import torch

    from nerfjax_torch import render
    from nerfjax_torch.checkpoint import load_field
    from nerfjax_torch.data import RayDataset, batch_to_device
    from nerfjax_torch.ops import fused_mlp as fm
    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import build_fields

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 18)
    out = {"fwd": {}, "max_abs_err": {"hashgrid_fwd": 0.0, "hashgrid_bwd": 0.0}}
    specs = {"medium16": build_fields(parity_cfg("spass2", tmp / "r.npz", tmp / "r"))[1].spec,
             "tuned12ed1": build_fields(TUNED_CFG)[1].spec}
    for label, spec in specs.items():
        planes = _rand((2, spec.total_table_size), rng)
        x01 = _hashgrid_x01(R_EVAL_N, rng)
        _hashgrid_check(spec, planes, x01, label)
        phase(f"R1 hashgrid_fwd {label} ({spec.n_levels} levels, N={R_EVAL_N:,}, {6 * R_FACE:,} points on the "
              "domain's faces): torch.equal to plain; the pack torch.equal to plain")
        out["fwd"][label] = _hashgrid_timed(spec, planes, x01, f"{label} N={R_EVAL_N:,}")
        del planes, x01

    # R2: the drop-in training pass through render_rays
    cfg = DROP_IN_TRAIN
    if final is not None:
        field = load_field(final, cfg, device="cuda")
    else:
        field = build_fields(cfg, device="cuda")[1].init(torch.Generator().manual_seed(SEED))
    field.requires_grad_(True)
    batch = batch_to_device(next(RayDataset(tmp / "rays.npz", verbose=False).epoch_batches(
        cfg["batch_size"], seed=SEED)), "cuda")
    with _recording(he, ("hashgrid_fwd", "hashgrid_bwd")) as seen:
        he.reset_launch_counts()
        fm.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        res = render.render_rays(field, field, batch["rays_o"], batch["rays_d"], batch["t_near"], batch["t_far"],
                                 cfg["N_samples"], cfg["N_importance"], train=True,
                                 generator=torch.Generator(device="cuda").manual_seed(SEED))
        loss_f = torch.mean((res["rgb_fine"] - batch["rgb"]) ** 2)
        (loss_f + torch.mean((res["rgb_coarse"] - batch["rgb"]) ** 2)).backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {k: v for k, v in {**he.launch_counts, **fm.launch_counts}.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"hashgrid_fwd": 4, "pack_pairs": 4, "hashgrid_bwd": 2}
    if launches != want:
        raise AssertionError(f"R2: render_rays(train=True) + backward launched {launches}, expected {want}")
    grad = field.table.grad
    if grad is None or not bool(torch.isfinite(grad).all()) or float(grad.abs().sum()) == 0:
        raise AssertionError("R2: the table's gradient is missing, zero or not finite")
    psnr = -10.0 * float(torch.log10(loss_f.detach()))
    phase(f"R2 render_rays(train=True) + backward at the drop-in shape ({cfg['batch_size']} rays, "
          f"{cfg['N_samples']} + {cfg['N_importance']}, {field.spec.n_levels} levels, "
          f"{'the drop-in checkpoint' if final is not None else 'a seeded init'}): {wall * 1e3:.1f} ms wall, peak "
          f"{peak:.2f} GiB (the first design's backward, staged terms then K3: {R_FIRST_PEAK_GIB} GiB), fine PSNR "
          f"{psnr:.2f} dB; launches {launches}")
    out.update(launches=launches, wall_ms=wall * 1e3, peak_gib=peak)

    spec = field.spec
    fwd_calls = {args[2].shape[0]: args for args in seen["hashgrid_fwd"]}
    bwd_calls = {args[2].shape[0]: args for args in seen["hashgrid_bwd"]}
    if sorted(bwd_calls) != sorted(fwd_calls):
        raise AssertionError(f"R2: hashgrid_bwd ran at N {sorted(bwd_calls)}, the forward at {sorted(fwd_calls)}")
    for i, (_, pl, x01) in enumerate(seen["hashgrid_fwd"]):  # each pass's forward and its recomputation
        _hashgrid_check(spec, pl.detach(), x01, f"R2 call {i} N={x01.shape[0]:,}")
    checked, counts = [f"all {len(seen['hashgrid_fwd'])} hashgrid_fwd calls torch.equal to plain"], {}
    for N in sorted(fwd_calls):
        _, g, x01, _ = bwd_calls[N]
        b = counts[N] = _hashgrid_bwd_checked(spec, g, x01, f"R2 N={N:,}")
        out["max_abs_err"]["hashgrid_bwd"] = max(out["max_abs_err"]["hashgrid_bwd"], b["max_abs_err"])
        checked.append(f"N={N:,}: hashgrid_bwd within the atomic-order bound, "
                       f"max |err| {b['max_abs_err']:.3g}, {b['adds']:,} float2 adds (the first design: "
                       f"{b['staged']:,} staged terms, then {b['k3_adds']:,} adds of K3's merged runs), the "
                       f"cotangent {b['zero_share']:.1%} zero")
    phase("R2 on the pass's own arguments: " + "; ".join(checked))

    # the fine pass's calls, timed
    fine_n = max(fwd_calls)
    _, pl, x01 = fwd_calls[fine_n]
    out["fwd"]["render_fine"] = _hashgrid_timed(spec, pl.detach(), x01, f"the render's fine pass N={fine_n:,}")
    _, g, x01, _ = bwd_calls[fine_n]
    b = counts[fine_n]
    buf = _zeros2(spec.total_table_size)
    # bytes: positions and the cotangent in, each touched entry of the gradient out once (both planes);
    # operations: 8 a term (its weight, two products, two adds)
    out["bwd"] = _time_kernel(lambda: he.hashgrid_bwd(spec, g, x01, buf),
                              lambda: he.hashgrid_bwd_plain(spec, g, x01, buf), None,
                              _bound(12 * fine_n + 8 * spec.n_levels * fine_n + 8 * b["touched"], 8 * b["staged"]),
                              fill=buf.zero_)
    out["bwd"].update(adds=b["adds"], adds_first_design=b["k3_adds"], staged_first_design=b["staged"])
    phase(f"  hashgrid_bwd at the render's fine pass (N={fine_n:,}, {b['staged']:,} terms into {b['touched']:,} "
          f"entries; {b['adds']:,} float2 adds, the first design {b['k3_adds']:,} after staging every term): "
          + _timing_line(out["bwd"]))
    del seen, fwd_calls, bwd_calls, buf

    if eval_call is not None:  # the quality phase's first eval, its fine pass
        spec_q, pl, x01 = eval_call
        _hashgrid_check(spec_q, pl, x01, "the quality eval's fine pass")
        phase(f"R hashgrid_fwd at the quality phase's first eval's fine pass (N={x01.shape[0]:,}, "
              f"{spec_q.n_levels} levels): torch.equal to plain")
        out["fwd"]["quality_eval_fine"] = _hashgrid_timed(spec_q, pl, x01,
                                                          f"the quality eval's fine pass N={x01.shape[0]:,}")

    # R3: the card against the CPU at the CPU tests' small size
    cpu = build_fields(R_SMALL)[1].init(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        cpu.table.uniform_(-0.2, 0.2, generator=torch.Generator().manual_seed(SEED + 1))
    card_field = build_fields(R_SMALL, device="cuda")[1].load_params(cpu.params())
    r3 = np.random.default_rng(SEED + 19)
    o = r3.normal(size=(R_RAYS, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 2.5
    d = r3.uniform(-0.4, 0.4, (R_RAYS, 3)) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    near = r3.uniform(1.0, 1.6, R_RAYS)
    far = near + r3.uniform(1.5, 2.5, R_RAYS)
    u_strat, u_pdf = r3.uniform(size=(R_RAYS, 16)), r3.uniform(size=(R_RAYS, 32))
    arrays = [torch.from_numpy(a.astype(np.float32)) for a in (o, d, near, far, u_strat, u_pdf)]
    errs = {}
    for train in (False, True):
        outs = []
        for dev, f in (("cuda", card_field), ("cpu", cpu)):
            o_, d_, n_, f_, us, up = (a.to(dev) for a in arrays)
            with torch.no_grad():
                outs.append({k: v.float().cpu() for k, v in render.render_rays(
                    f, f, o_, d_, n_, f_, 16, 32, train=train, u_strat=us, u_pdf=up).items()})
        a, b = outs
        e = {k: float((a[k] - b[k]).abs().max()) for k in a}
        if max(e["rgb_coarse"], e["weights_coarse"]) > 2e-5 or e["rgb_fine"] > 1e-3 or \
                not all(bool(torch.isfinite(v).all()) for v in a.values()):
            raise AssertionError(f"R3 render_rays card vs cpu (train={train}): max |err| {e}")
        errs[train] = e
    phase("R3 render_rays card vs cpu (small spec, f32, the same uniforms): " + "; ".join(
        f"train={t}: coarse rgb {e['rgb_coarse']:.2g}, weights {e['weights_coarse']:.2g} (bound 2e-5), fine rgb "
        f"{e['rgb_fine']:.2g} (bound 1e-3), depths {e['z_vals']:.2g}" for t, e in errs.items()))
    out["seconds"] = time.perf_counter() - t0
    fwd = out["fwd"]["medium16"]
    ev = out["fwd"].get("quality_eval_fine")
    phase(f"phase R: {out['seconds']:.1f} s; {smi}: hashgrid_fwd at N={R_EVAL_N:,} (medium, 16 levels) "
          f"{fwd['ms'] * 1e3:.1f} us (plain {fwd['plain_ms'] * 1e3:.1f}, bound {fwd['bound'][0] * 1e3:.1f}); "
          f"tuned spec {out['fwd']['tuned12ed1']['ms'] * 1e3:.1f} us; the render's fine pass "
          f"{out['fwd']['render_fine']['ms'] * 1e3:.1f} us; the quality eval's fine pass "
          + ("not run" if ev is None else f"{ev['ms'] * 1e3:.1f} us") + f"; hashgrid_bwd "
          f"{out['bwd']['ms'] * 1e3:.1f} us (with the caller's zero fill {out['bwd']['with_fill_ms'] * 1e3:.1f}); "
          f"R2's peak {out['peak_gib']:.2f} GiB (first design {R_FIRST_PEAK_GIB})")
    return out


# -- phase L: the launcher -------------------------------------------------------------------------


def _ball_iou(occ: np.ndarray, center, radius: float) -> float:
    res = occ.shape[0]
    c = -1.0 + np.arange(res) * (2.0 / (res - 1))
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    ball = (X - center[0]) ** 2 + (Y - center[1]) ** 2 + (Z - center[2]) ** 2 <= radius**2
    occ = occ.astype(bool)
    return float((occ & ball).sum() / max((occ | ball).sum(), 1))


def _launcher_outputs(out_dir: Path, transforms: Path):
    """Both volumes of the launcher's run through load_volume_any, checked:
    volume.pth's points finite with colours in [0, 1]; volume_sliced.pth
    exactly its points inside the scene AABB of the transforms JSON
    (aabb_band_from_transforms), with that AABB as its aabb_meta; the
    viewer's band (clip_aabb_band, slice_z) leaves some. Returns (points,
    colours, band, sliced points, sliced colours, sliced points in the
    band)."""
    from nerfjax_torch.gui.logic import aabb_band_from_transforms, clip_aabb_band, load_volume_any, slice_z

    pts, rgbs, meta = load_volume_any(out_dir / "volume.pth")
    spts, srgbs, aabb = load_volume_any(out_dir / "volume_sliced.pth")
    band = aabb_band_from_transforms(transforms)
    lo, hi = np.asarray(band["aabb_min"], np.float32), np.asarray(band["aabb_max"], np.float32)
    inside = np.all((pts >= lo) & (pts <= hi), axis=1)
    clipped, _ = clip_aabb_band(pts, rgbs, band)
    zs, _ = slice_z(spts, srgbs, band["aabb_remove_below"], band["aabb_remove_above"])
    if meta is not None or not len(pts) or not np.isfinite(pts).all() or not np.isfinite(rgbs).all() \
            or rgbs.min() < 0.0 or rgbs.max() > 1.0 or srgbs.max() > 1.0:
        raise AssertionError(f"volume.pth: {len(pts):,} points, meta {meta}")
    if aabb is None or not (np.allclose(aabb["aabb_min"], lo) and np.allclose(aabb["aabb_max"], hi)):
        raise AssertionError(f"volume_sliced.pth's aabb_meta {aabb} is not the transforms JSON's {band}")
    if not np.array_equal(spts, pts[inside]) or not len(spts) or not len(clipped) or not len(zs):
        raise AssertionError(f"volume_sliced.pth holds {len(spts):,} points; volume.pth {int(inside.sum()):,} in "
                             f"the scene AABB {band}, {len(clipped):,} in its band")
    return pts, rgbs, band, spts, srgbs, zs


LAUNCHER_FRAMES = range(0, PRECOMPUTE_FRAMES, 3)  # phase L's cut: 20 of H's 60 frames (all 60: 146 s on a slow host)


@contextlib.contextmanager
def _here_on_pythonpath():
    """The checkout first on PYTHONPATH while the block runs, for the
    launcher's CLIs (run from another directory)."""
    env_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = str(HERE) + (os.pathsep + env_path if env_path else "")
    try:
        yield
    finally:
        if env_path is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = env_path


def launcher_run(tmp: Path, colmap_text: Path) -> dict:
    """Phase L's pipeline: a scene config from
    nerfjax_torch.gui.logic.generate_config_dict (LAUNCHER_FRAMES of phase
    H's 800^2 frames resized to FRONT_SIZE^2, a copy of phase C's COLMAP
    text model with those images, 256^3 volume) plus TUNED_TRAIN and one
    epoch, written as JSON; every pipeline step but "Run COLMAP" (no COLMAP
    binary here) through build_pipeline_commands and the launcher's own
    loop (logic.run_commands: each CLI a subprocess, on the card by
    default), under _here_on_pythonpath, which the caller sets: it changes
    the environment, which no thread should do while another may start a
    process. Prints nothing, so that it can run in a thread beside other
    phases: the CLIs' output lines are kept in the result ("log"), with
    the config, each step's start and whether every step exited 0."""
    from nerfjax_torch.gui.logic import PIPELINE_STEPS, build_pipeline_commands, generate_config_dict, run_commands

    work = tmp / "launcher"
    (work / "colmap" / "colmap_text").mkdir(parents=True)
    (work / "photos").mkdir()
    names = {f"r_{i}.png" for i in LAUNCHER_FRAMES}
    for name in names:
        (work / "photos" / name).symlink_to(tmp / "scene" / name)
    for name in ("cameras.txt", "points3D.txt"):
        (work / "colmap" / "colmap_text" / name).write_bytes((colmap_text / name).read_bytes())
    lines = (colmap_text / "images.txt").read_text().splitlines()  # a comment, then two lines an image
    kept = [line for pair in zip(lines[1::2], lines[2::2]) if pair[0].split()[-1] in names for line in pair]
    (work / "colmap" / "colmap_text" / "images.txt").write_text("\n".join(lines[:1] + kept) + "\n")
    values = {"scene_name": "ball", "image_dir": str(work / "photos"), "tmp_image_dir": str(work / "colmap" / "images"),
              "resize_images": True, "newSize": [FRONT_SIZE, FRONT_SIZE], "colmap_dir": str(work / "colmap"),
              "volume_resolution": 256}
    cfg = {**generate_config_dict(values), **TUNED_TRAIN, "num_epochs": 1}
    cfg_path = work / "ball.json"
    cfg_path.write_text(json.dumps(cfg, indent=1))
    selected = [label != "Run COLMAP" for label, _ in PIPELINE_STEPS]
    cmds = build_pipeline_commands(str(cfg_path), selected)
    starts: list[float] = []
    log_lines: list[str] = []

    def log(line: str) -> None:
        if line.startswith("$ "):
            starts.append(time.perf_counter())
        log_lines.append(line)

    with contextlib.chdir(work):  # the CLIs' relative paths (transforms JSON, NPZ, outputs) land here
        ok = run_commands(cmds, log)
    return {"work": work, "cfg": cfg, "cmds": cmds, "ok": ok, "starts": starts, "end": time.perf_counter(),
            "log": log_lines, "labels": [label for label, _ in PIPELINE_STEPS if label != "Run COLMAP"]}


def launcher_phase(tmp: Path, colmap_text: Path, planted: np.ndarray, run: dict | None = None) -> dict:
    """Phase L: the GUI's launcher on the card. launcher_run's pipeline
    (``run``, where it ran already; else it runs here), its CLIs' output
    printed; every step must exit 0. Then both volume files through
    load_volume_any, the AABB band from the transforms JSON
    (aabb_band_from_transforms, clip_aabb_band, slice_z), and the volume's
    IoU with the ball fitted to the normalized inliers of the recentered
    model (>= 0.5). Returns each step's seconds and the IoU."""
    from nerfjax_torch.colmap import colmap_to_nerf
    from nerfjax_torch.config import ConfigNode, with_defaults

    if run is None:
        with _here_on_pythonpath():
            run = launcher_run(tmp, colmap_text)
    for line in run["log"]:
        print(f"  [launcher] {line}")
    work, cfg, cmds, labels, starts, end = (run[k] for k in ("work", "cfg", "cmds", "labels", "starts", "end"))
    if not run["ok"]:
        raise AssertionError(f"the launcher stopped at step {len(starts)} ({labels[len(starts) - 1]}): see its log")
    seconds = {label: b - a for label, a, b in zip(labels, starts, starts[1:] + [end])}
    out_dir = work / "outputs" / "ball"
    pts, rgbs, band, spts, srgbs, zs = _launcher_outputs(out_dir, work / "transforms_ball.json")
    from nerfjax_torch.extract import load_volume

    occ = load_volume(out_dir / "volume.pth")["occupancy_volume"]
    with contextlib.redirect_stdout(io.StringIO()):
        norm = colmap_to_nerf(with_defaults(ConfigNode(cfg)), device="cuda", verbose=False)["points"]
    inl = norm[~planted]
    center = inl.mean(axis=0)
    radius = float(np.linalg.norm(inl - center, axis=1).mean())
    iou = _ball_iou(occ, center, radius)
    phase(f"launcher L: {len(cmds)} steps through logic.run_commands, each exit 0; seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()) + f"; volume.pth {len(pts):,} points, "
          f"volume_sliced.pth {len(spts):,} (the scene AABB's), {len(zs):,} of them in the AABB band "
          f"[{band['aabb_remove_below']:.3f}, {band['aabb_remove_above']:.3f}]; IoU with the ball fitted to the recentered model's inliers (center "
          f"{np.round(center, 4).tolist()}, radius {radius:.4f}) {iou:.3f}")
    if iou < 0.5:
        raise AssertionError(f"launcher L: IoU with the ball {iou:.3f} < 0.5")
    return {"seconds": seconds, "iou": iou, "total_s": end - starts[0]}


# -- phase D: several processes on the one card -----------------------------------------------------

D_STEPS = 16  # train() steps of D1 and D2 (one epoch of 8192-ray batches)
D_RES = 256
D_CHILD_TIMEOUT_S = 300
D_RTOL = 2e-2  # the bf16 step bound (tests/test_torch_train_step.py)
D_TIMING = ("query_seconds", "transfer_seconds", "phase_seconds", "timestamp", "device")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _children(job: str, world: int, work: Path, env_for) -> list[str]:
    """``world`` processes of ``python3 chip_smoke.py --child job --work
    work`` (after the build: they load its libraries), each with the
    environment env_for(rank, port) adds; their output in work/job_<r>.log.
    On a failure or after D_CHILD_TIMEOUT_S the rest are killed and the
    phase fails with every child's output."""
    import os

    port, procs, logs = _free_port(), [], [work / f"{job}_{r}.log" for r in range(world)]
    joined = ("NERFJAX_COORDINATOR", "NERFJAX_NUM_PROCESSES", "NERFJAX_PROCESS_ID", "NERFJAX_DISTRIBUTED", "RANK",
              "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    for r in range(world):
        env = {k: v for k, v in os.environ.items() if k not in joined}
        env.update(env_for(r, port))
        procs.append(subprocess.Popen([sys.executable, str(HERE / "chip_smoke.py"), "--child", job, "--work", str(work)],
                                      env=env, stdout=logs[r].open("w"), stderr=subprocess.STDOUT, cwd=HERE))
    deadline = time.monotonic() + D_CHILD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = [log.read_text() for log in logs]
    for r, text in enumerate(outs):
        for line in text.splitlines():
            if line.startswith("[chip_smoke"):
                print(f"  [{job} rank {r}] {line.partition('] ')[2]}")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{job}: rank(s) {bad} exited {[procs[r].returncode for r in bad]}\n" + "\n".join(
            f"--- rank {r} ---\n{text[-4000:]}" for r, text in enumerate(outs)))
    return outs


def _flat_params(p: dict) -> dict:
    return {"table": np.asarray(p["table"]),
            **{f"{n}{i}": np.asarray(layer["w"]) for n in ("dmlp", "cmlp") for i, layer in enumerate(p[n])}}


def _d_train(cfg: dict, out: Path, rank: int) -> dict:
    """train() on cfg into out (the K1-K5 launches counted from 0 around
    it, the peak memory from a reset); its parameters, PSNR, launches, peak
    GiB and the table's AdamW bytes on this rank."""
    import torch

    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import train

    he.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train({**cfg, "output_dir": str(out), "checkpoint_dir": str(out / "checkpoints")}, seed=SEED,
                log_every=1000, device="cuda")
    torch.cuda.synchronize()
    return {"params": _flat_params(res["params"]), "psnr": res["psnr"], "launches": dict(he.launch_counts),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "table_bytes": res["table_optimizer_bytes"],
            "seconds": time.perf_counter() - t0, "steps": res["steps"], "rank": rank}


def _lockstep(cfg: dict, steps: int, mesh) -> int:
    """The two table modes on the same gradients: a replicated state and a
    shard_hash_table state from one seed, each step's gradient computed
    once (on the replicated state: step_gradients) and copied to the
    other, then apply_gradients on both (the all_reduce, the cut to the
    rank's slice, AdamW). Before every step the gathered table must equal
    the replicated one and after the last every parameter and the table's
    AdamW moments, torch.equal. Returns the steps taken."""
    import torch

    from nerfjax_torch.data import RayDataset, batch_to_device
    from nerfjax_torch.train import TrainSettings, apply_gradients, make_train_state, shard_table, step_gradients

    ds = RayDataset(cfg["rays_file"], verbose=False)
    B = int(cfg["batch_size"])
    settings = TrainSettings.from_cfg(cfg, ds.steps_per_epoch(B))
    a, b = (make_train_state(cfg, settings, seed=SEED, device="cuda") for _ in range(2))
    a.mesh = b.mesh = mesh
    shard_table(b)
    pa = [p for f in a.fields() for p in f.parameters()]
    pb = [p for f in b.fields() for p in f.parameters()]
    n = 0
    for batch in ds.epoch_batches(B, seed=SEED * 100003 + 1, process_index=mesh.rank, process_count=mesh.world):
        if n == steps:
            break
        n += 1
        b.shard.gather()
        if not torch.equal(b.field.table, a.field.table):
            raise AssertionError(f"lockstep step {n - 1}: the gathered table != the replicated table")
        step_gradients(a, batch_to_device(batch, "cuda"))
        for x, y in zip(pa, pb):
            y.grad = x.grad.clone()
        b.occ_grid = None if a.occ_grid is None else a.occ_grid.clone()
        apply_gradients(a)
        apply_gradients(b)
    b.shard.gather()
    for i, (x, y) in enumerate(zip(pa, pb)):
        if not torch.equal(x, y):
            raise AssertionError(f"lockstep: parameter {i} differs between the table modes after {n} steps")
    mine, whole = b.shard.moments(b.optimizer), a.optimizer.state[a.field.table]
    for key in ("exp_avg", "exp_avg_sq"):
        if not torch.equal(mine[key], whole[key]):
            raise AssertionError(f"lockstep: the table's {key} differs between the table modes")
    return n


def multi_child(job: str, work: Path) -> int:
    """A child of phase D. d1: one process, the reference runs without a
    process group, then NCCL at a world of one (NERFJAX_DISTRIBUTED=1,
    WORLD_SIZE=1); d2: a rank of two over gloo on the one card. Writes its
    results under work; the parent compares."""
    import torch
    import torch.distributed as dist

    from nerfjax_torch.extract import extract_volume
    from nerfjax_torch.parallel import init_distributed, make_mesh

    cfg = json.loads((work / "cfg.json").read_text())

    def save(tag: str, r: dict) -> None:
        np.savez(work / f"{tag}.npz", **r.pop("params"))
        (work / f"{tag}.json").write_text(json.dumps(r))

    def volume(ckpt: Path) -> dict:
        return extract_volume({**cfg, "checkpoint": str(ckpt)}, resolution=D_RES, device="cuda", verbose=False)

    def save_volume(tag: str, vol: dict) -> None:
        np.savez(work / f"{tag}.npz", occ=vol["occupancy_volume"], rgb=vol["rgb_volume"])
        md = {k: v for k, v in vol["metadata"].items() if k not in D_TIMING}
        (work / f"{tag}.json").write_text(json.dumps(md))

    if job == "d1":
        for tag in ("ref", "again"):  # no process group: the run-to-run reference
            r = _d_train(cfg, work / "d1" / tag, 0)
            phase(f"{tag}: train() without a process group, {r['steps']} steps in {r['seconds']:.2f} s")
            save(f"d1_{tag}", r)
        ckpt = work / "d1" / "ref" / "checkpoints" / "nerf_final.pth"
        save_volume("d1_vol_alone", volume(ckpt))
        rank, world = init_distributed()
        if (rank, world) != (0, 1) or dist.get_backend() != "nccl":
            raise AssertionError(f"d1: joined as {(rank, world)} over {dist.get_backend()}")
        for tag, over in (("off", {}), ("on", {"shard_hash_table": True})):
            r = _d_train({**cfg, **over}, work / "d1" / tag, 0)
            phase(f"{tag}: train() under NCCL at a world of one, shard_hash_table {bool(over)}, {r['steps']} steps "
                  f"in {r['seconds']:.2f} s, peak {r['peak_gib']:.2f} GiB, table AdamW {r['table_bytes']:,} B")
            save(f"d1_{tag}", r)
        save_volume("d1_vol_group", volume(ckpt))
        n = _lockstep(cfg, D_STEPS, make_mesh())
        phase(f"lockstep under NCCL at a world of one: {n} steps, the two table modes torch.equal")
    else:
        rank, world = init_distributed(backend="gloo")
        if world != 2 or dist.get_backend() != "gloo":
            raise AssertionError(f"d2: joined as {(rank, world)} over {dist.get_backend()}")
        t0 = time.perf_counter()
        n = _lockstep(cfg, D_STEPS, make_mesh())
        phase(f"lockstep over gloo, 2 ranks: {n} steps, the two table modes torch.equal "
              f"({time.perf_counter() - t0:.2f} s)")
        for tag, over in (("off", {}), ("on", {"shard_hash_table": True})):
            dist.barrier()
            r = _d_train({**cfg, **over}, work / "d2" / tag, rank)
            phase(f"{tag}: train() over gloo, rank {rank} of 2, shard_hash_table {bool(over)}, {r['steps']} steps "
                  f"in {r['seconds']:.2f} s, peak {r['peak_gib']:.2f} GiB, table AdamW {r['table_bytes']:,} B, "
                  f"launches {r['launches']}")
            save(f"d2_{tag}_{rank}", r)
        dist.barrier()  # rank 0's checkpoint is written
        t0 = time.perf_counter()
        vol = volume(work / "d2" / "off" / "checkpoints" / "nerf_final.pth")
        phase(f"D3: the 256^3 extraction over 2 ranks in {time.perf_counter() - t0:.2f} s")
        save_volume(f"d2_vol_{rank}", vol)
    torch.cuda.synchronize()
    return 0


def _beyond(got: dict, want: dict) -> dict:
    """Per array: entries beyond the bf16 step bound (rtol D_RTOL, floor D_RTOL x the largest entry),
    unequal entries and the largest difference."""
    out = {}
    for k, w in want.items():
        d = np.abs(got[k] - w)
        out[k] = (int((d > D_RTOL * np.abs(w) + D_RTOL * np.abs(w).max()).sum()), int((got[k] != w).sum()),
                  float(d.max()))
    return out


def multi_phase(tmp: Path) -> dict:
    """Phase D: the multi-process paths on the one card. D1: a child with
    NERFJAX_DISTRIBUTED=1, WORLD_SIZE=1: train() of TUNED_TRAIN at full width
    for one epoch of D_STEPS steps twice without a process group (the card's
    run-to-run difference: K2 and K3 add with float atomics, whose order
    varies), then under NCCL with shard_hash_table off and on; the 256^3
    extraction of the first run's checkpoint without and with the group
    (torch.equal); the two table modes on the same gradients (_lockstep,
    torch.equal). D2: two ranks over gloo on the card, global batch 8192:
    the lockstep check, then train() with shard_hash_table off and on, K1-K5
    launched on each rank, peak memory and the table's AdamW bytes per
    rank. D3: D2's checkpoint extracted at 256^3 over the two ranks, equal
    to one rank (torch.equal). Every train() run: each step's PSNR within
    the bf16 step bound of the first run's, and where the two runs without
    a group are equal, its parameters torch.equal to them; the parameters'
    differences are printed."""
    work = tmp / "multi"
    work.mkdir()
    data = dict(np.load(tmp / "rays.npz"))
    n = D_STEPS * int(TUNED_TRAIN["batch_size"])
    np.savez(work / "rays.npz", **{k: v[:n] for k, v in data.items()})
    cfg = {**TUNED_TRAIN, "num_epochs": 1, "rays_file": str(work / "rays.npz")}
    (work / "cfg.json").write_text(json.dumps(cfg))

    def load(tag: str):
        return dict(np.load(work / f"{tag}.npz")), json.loads((work / f"{tag}.json").read_text())

    t0 = time.perf_counter()
    _children("d1", 1, work, lambda r, port: {"NERFJAX_DISTRIBUTED": "1", "WORLD_SIZE": "1", "RANK": "0",
                                               "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                                               "MASTER_PORT": str(port)})
    d1_s = time.perf_counter() - t0
    ref, ref_info = load("d1_ref")
    again, _ = load("d1_again")
    repeatable = all(np.array_equal(again[k], ref[k]) for k in ref)
    noise = _beyond(again, ref)
    phase(f"D1: two train() runs without a process group {'are' if repeatable else 'are not'} bit-equal; per array "
          f"(beyond the bf16 bound, unequal, max |diff|): {noise}")
    out: dict = {"d1_s": d1_s, "repeatable": repeatable, "noise": noise}

    def held(label: str, arrays: dict, info: dict, world_of_one: bool) -> None:
        psnr, want = np.asarray(info["psnr"]), np.asarray(ref_info["psnr"])
        diff = _beyond(arrays, ref)
        phase(f"{label}: PSNR first/last step {psnr[0]:.3f}/{psnr[-1]:.3f} dB (reference {want[0]:.3f}/"
              f"{want[-1]:.3f}); parameters against the reference (beyond the bf16 bound, unequal, max |diff|): {diff}")
        if len(psnr) != len(want) or not np.isfinite(psnr).all() or not np.allclose(psnr, want, rtol=D_RTOL, atol=0):
            raise AssertionError(f"{label}: PSNR per step outside the bf16 step bound of the reference's")
        if world_of_one and repeatable and any(v[1] for v in diff.values()):
            raise AssertionError(f"{label}: parameters != the reference's, which two runs reproduce bit for bit")
        for name, n_launch in info["launches"].items():
            if name in STEP_KERNELS and n_launch <= 0:
                raise AssertionError(f"{label}: {name} was not launched")

    for tag in ("off", "on"):
        held(f"D1 NCCL world of one, shard_hash_table {tag}", *load(f"d1_{tag}"), world_of_one=True)
    on_info = load("d1_on")[1]
    va, vg = load("d1_vol_alone"), load("d1_vol_group")
    if not (np.array_equal(va[0]["occ"], vg[0]["occ"]) and np.array_equal(va[0]["rgb"], vg[0]["rgb"])
            and va[1] == vg[1]):
        raise AssertionError("D1: the 256^3 extraction under NCCL at a world of one != without a process group")
    phase(f"D1: the {D_RES}^3 extraction under NCCL at a world of one == without a process group (volumes, "
          f"threshold {va[1]['threshold']:.6f}, metadata); child {d1_s:.1f} s")

    t0 = time.perf_counter()
    _children("d2", 2, work, lambda r, port: {"NERFJAX_COORDINATOR": f"localhost:{port}",
                                               "NERFJAX_NUM_PROCESSES": "2", "NERFJAX_PROCESS_ID": str(r)})
    out["d2_s"] = time.perf_counter() - t0
    per_rank = {}
    for tag in ("off", "on"):
        runs = [load(f"d2_{tag}_{r}") for r in range(2)]
        if not all(np.array_equal(runs[1][0][k], runs[0][0][k]) for k in runs[0][0]):
            raise AssertionError(f"D2 shard_hash_table {tag}: rank 1's parameters != rank 0's")
        held(f"D2 gloo, 2 ranks, shard_hash_table {tag}", *runs[0], world_of_one=False)
        for r, (_, info) in enumerate(runs):
            missing = [k for k in STEP_KERNELS if info["launches"].get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"D2 rank {r}: {missing} not launched")
            per_rank[f"{tag}_rank{r}"] = {"peak_gib": info["peak_gib"], "table_bytes": info["table_bytes"],
                                          "seconds": info["seconds"], "launches": info["launches"]}
    phase("D2: the two table modes' train() runs against each other (beyond the bf16 bound, unequal, max |diff|; "
          "their steps' gradients differ as two runs alone do): "
          + str(_beyond(load("d2_on_0")[0], load("d2_off_0")[0])))
    for r in range(2):
        if per_rank[f"on_rank{r}"]["table_bytes"] * 2 != per_rank[f"off_rank{r}"]["table_bytes"]:
            raise AssertionError(f"D2 rank {r}: the sharded table's AdamW bytes are not half the replicated ones")
    # D3: one rank's extraction of the same checkpoint, here without a process group
    from nerfjax_torch.extract import extract_volume

    t0 = time.perf_counter()
    alone = extract_volume({**cfg, "checkpoint": str(work / "d2" / "off" / "checkpoints" / "nerf_final.pth")},
                           resolution=D_RES, device="cuda", verbose=False)
    alone_s = time.perf_counter() - t0
    md = json.loads(json.dumps({k: v for k, v in alone["metadata"].items() if k not in D_TIMING}))
    for r in range(2):
        arrays, got = load(f"d2_vol_{r}")
        if not (np.array_equal(arrays["occ"], alone["occupancy_volume"])
                and np.array_equal(arrays["rgb"], alone["rgb_volume"]) and got == md):
            raise AssertionError(f"D3: rank {r}'s {D_RES}^3 extraction over 2 ranks != one rank's")
    phase(f"D3: the {D_RES}^3 extraction over 2 ranks (gloo) == one rank's on every rank (volumes, threshold "
          f"{md['threshold']:.6f}, metadata); one rank {alone_s:.2f} s")
    phase("D2 per rank: " + "; ".join(f"{k}: peak {v['peak_gib']:.2f} GiB, table AdamW {v['table_bytes']:,} B, "
                                        f"train() {v['seconds']:.2f} s" for k, v in per_rank.items())
          + f"; D1 sharded at a world of one: table AdamW {on_info['table_bytes']:,} B; children: D1 {d1_s:.1f} s, "
          f"D2 {out['d2_s']:.1f} s")
    out["per_rank"] = per_rank
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of nerfjax_torch on one CUDA card (every phase by default)")
    ap.add_argument("--only", choices=["quality", "steps", "launcher", "multi", "feature_last"], default=None,
                    help="run only the card, the build and this phase (no kernels line, no final line)")
    ap.add_argument("--child", choices=["d1", "d2"], default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--seeds", default=None,
                    help="with --only quality: the seeds to train, e.g. 0-7 or 0,3,5 (default 0,1,2: nerfjax's)")
    args = ap.parse_args()
    seeds = PARITY_SEEDS
    if args.seeds is not None:
        if args.only != "quality":
            ap.error("--seeds needs --only quality: the full run trains nerfjax's seeds 0, 1, 2")
        lo, _, hi = args.seeds.partition("-")
        seeds = tuple(range(int(lo), int(hi) + 1)) if hi else tuple(int(v) for v in args.seeds.split(","))
    if not (HERE / "nerfjax_torch").is_dir():
        raise SystemExit(f"chip_smoke: no nerfjax_torch/ beside {Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(HERE))
    import torch

    if args.child:  # a process of phase D, started by multi_phase after the build
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return multi_child(args.child, Path(args.work))
    smi = card()
    phase(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build()
    if args.only == "quality":
        with tempfile.TemporaryDirectory() as tmp:
            quality_parity(Path(tmp), seeds)
        phase("--only quality: done")
        return 0
    if args.only == "steps":
        with tempfile.TemporaryDirectory() as tmp:
            steps_around_train(Path(tmp))
        phase("--only steps: done")
        return 0
    if args.only == "launcher":
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            frames = json.loads(precompute_scene(tmp / "scene").read_text())["frames"]
            focal = float(0.5 * PRECOMPUTE_SIZE / np.tan(0.5 * PRECOMPUTE_ANGLE_X) * FRONT_SIZE / PRECOMPUTE_SIZE)
            planted = colmap_model(tmp / "front" / "colmap", frames, focal)
            launcher_phase(tmp, tmp / "front" / "colmap" / "colmap_text", planted)
        phase("--only launcher: done")
        return 0
    if args.only == "feature_last":  # phase R on a seeded drop-in field
        with tempfile.TemporaryDirectory() as tmp:
            ray_npz(Path(tmp) / "rays.npz")
            feature_last_phase(Path(tmp), None, smi)
        phase("--only feature_last: done")
        return 0
    if args.only == "multi":
        with tempfile.TemporaryDirectory() as tmp:
            ray_npz(Path(tmp) / "rays.npz")
            multi_phase(Path(tmp))
        phase("--only multi: done")
        return 0
    stats = kernels_vs_plain()
    k4_shapes = {}  # K4 at each main-path call: the kernels line's extra keys
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_path = Path(tmp) / "nerf_final.pth"
        synthetic_checkpoint(ckpt_path)
        extract_launches = extract_full(ckpt_path, Path(tmp), k4_shapes)
        card_vs_cpu_128(ckpt_path)
        f32x = extract_f32(ckpt_path)
    hstats = hash_kernels_vs_plain()
    dense_kernels_vs_plain(hstats)
    hstats["dense_levels_fwd"]["shapes"].update(k4_shapes)
    pstats = probes_vs_plain(launch_floor())
    lr_kernels_vs_plain(hstats)
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_full(Path(tmp))
        (cap,) = trained.pop("step_inputs").values()
        for name, t in step_kernels_vs_plain(cap, "tuned step", hstats, STEP_KERNELS + ("pack_pairs",)).items():
            hstats[name].update(t)
        del cap
        k1_shapes = hstats["hash_levels_fwd"]["shapes"]  # K1 k = 1 at its other main-path calls
        k1_shapes["grid_update"] = trained.pop("grid_update_k1")
        knobs = {label: train_dense_knob(Path(tmp), label, hstats) for label in DENSE_KNOBS}
        fast = train_fast(Path(tmp), hstats)
        k2 = train_k2_knob(Path(tmp), hstats)
        quality = quality_parity(Path(tmp))
        k1_shapes["k2_knob_step"] = k2["timings"]["hash_levels_fwd"]
        k1_shapes["fast_step"] = fast["timings"]["hash_levels_fwd"]
        dropin = train_dropin(Path(tmp))
        vanilla = train_vanilla(Path(tmp))
        passes = dropin.pop("step_inputs")
        # K1, K3 and K2 exact at the drop-in passes; the kernels line carries them beside the tuned step's times
        dropin_timed = {}
        for N in sorted(passes):  # the timings at the drop-in passes are extra lines
            which = "fine" if N == max(passes) else "coarse"
            label = f"drop-in step's {which} pass"
            dropin_timed[which] = step_kernels_vs_plain(
                passes[N], label, hstats,
                DROP_IN_KERNELS + ("pack_pairs",) if which == "fine"
                else ("hash_levels_fwd", "dense_levels_fwd", "table_grad_scatter", "hash_levels_bwd"))
        del passes
        flast = feature_last_phase(Path(tmp), dropin["final"], smi, eval_call=quality.pop("eval_call"))
        shapes = hstats["dense_levels_fwd"]["shapes"]  # K4 at the train steps' calls
        shapes["tuned_step"] = {k: v for k, v in hstats["dense_levels_fwd"].items() if k != "shapes"}
        for label, knob in knobs.items():
            shapes[f"{label}_step"] = knob["timings"]["dense_levels_fwd"]
            k1_shapes[f"{label}_step"] = knob["timings"]["hash_levels_fwd"]
        for which in ("coarse", "fine"):
            shapes[f"dropin_{which}"] = dropin_timed[which]["dense_levels_fwd"]
        shapes["k2_knob_step"] = k2["timings"]["dense_levels_fwd"]
        shapes["fast_step"] = fast["timings"]["dense_levels_fwd"]
        extract_trained(trained["cfg"], trained["final"])
        t0 = time.perf_counter()
        scene = precompute_scene(Path(tmp) / "scene")
        phase(f"precompute scene: {PRECOMPUTE_FRAMES} PNG frames of {PRECOMPUTE_SIZE}^2 written in "
              f"{time.perf_counter() - t0:.1f} s (set-up)")
        front = front_end_phase(Path(tmp))
        knn_more = knn_phase()
        evals = {"tuned": eval_render(trained["final"], TUNED_CFG, "tuned", stats, hstats),
                 "drop-in": eval_render(dropin["final"], DROP_IN_TRAIN, "drop-in", stats, hstats)}
        # last, the phases that time no kernel: after other processes have used the card, this process's
        # profiler traces dropped or gained device events for a while (PERF.md), which the timings above rely
        # on. Two threads that print nothing run subprocesses beside the rest: the launcher's CLIs (L, one at a
        # time) and the chain's head (precompute_rays); here meanwhile the checks against the CPU, the chain's
        # tail and the processes of D; then L's and the head's outputs are checked.
        with _here_on_pythonpath(), concurrent.futures.ThreadPoolExecutor(2) as pool:
            colmap_text = front.pop("colmap_text")
            launched = pool.submit(launcher_run, Path(tmp), colmap_text)
            head_ran = pool.submit(precompute_cli, Path(tmp), scene)
            for label in ("tuned", *DENSE_KNOBS, "fast", "fast bf16"):
                step_card_vs_cpu(Path(tmp), label)
            dropin_step_card_vs_cpu(Path(tmp))
            render_card_vs_cpu(trained["final"])
            tail = tail_on_trained(trained["cfg"], trained["final"], Path(tmp))
            multi = multi_phase(Path(tmp))
            head = precompute_phase(Path(tmp), scene, head_ran.result())
            launcher = launcher_phase(Path(tmp), colmap_text, front.pop("planted"), launched.result())
    phase(f"train() wall per step, tuned run: {trained['train_wall_ms_per_step']:.2f} ms; precompute_rays: "
          f"{head['kept']:,} of {head['generated']:,} rays, {head['process_wall']:.2f} s (NPZ write "
          f"{head['write']:.2f} s)")
    fs = front["stages"]
    phase(f"front end: resize_images {front['resize_s']:.2f} s; colmap2nerf on {fs['points_read']:,} points "
          f"{fs['wall']:.2f} s (read {fs['read']:.2f}, kNN {fs['knn'] * 1e3:.2f} ms), {fs['points_kept']:,} kept; K6 "
          f"{front['knn']['ms']:.3f} ms, the brute kernel {front['knn_brute']['ms']:.3f} ms (its recorded time: "
          f"{KNN_FIRST_DESIGN_MS}), the function's bound {front['knn']['bound'][0] * 1e3:.2f} us, the grid's "
          f"{front['knn']['pairs']:,} tested pairs' {front['knn']['tested_bound'][0]:.3f} ms (plain "
          f"{front['knn']['plain_ms']:.1f}); at {KNN_CLUSTERED:,} "
          f"clustered points {knn_more['clustered']['ms']:.3f} ms, all {FRONT_POINTS + FRONT_OUTLIERS:,} points "
          f"coincident {knn_more['coincident']['ms']:.3f} ms; precompute {front['precompute_s']:.2f} s, train "
          f"{front['train_s']:.2f} s, PSNR last 20 steps {front['psnr_last20']:.2f} dB, IoU {front['iou']:.3f}")
    phase("launcher L: " + ", ".join(f"{k} {v:.2f} s" for k, v in launcher["seconds"].items())
          + f" (total {launcher['total_s']:.1f} s), IoU {launcher['iou']:.3f}; multi-process D: children D1 "
          f"{multi['d1_s']:.1f} s, D2 {multi['d2_s']:.1f} s; per rank " + "; ".join(
              f"{k} peak {v['peak_gib']:.2f} GiB, table AdamW {v['table_bytes']:,} B" for k, v in multi["per_rank"].items()))
    phase(f"vanilla NeRF: {vanilla['steps']} train() steps, median warm {vanilla['ms_per_step']:.2f} ms/step, PSNR "
          f"{vanilla['psnr'][0]:.2f} -> {vanilla['psnr'][1]:.2f} dB, peak {vanilla['peak_gib']:.2f} GiB, idle "
          f"{vanilla['idle']:.1%}; extraction 256^3 {vanilla['extract_256_s']:.2f} s (IoU {vanilla['iou']:.3f}), "
          f"the extract_vol CLI at {vanilla['extract_res']}^3 {vanilla['extract_cli_s']:.2f} s")
    phase("warm ms/step: tuned " + f"{trained['ms_per_step']:.2f}, "
          + ", ".join(f"{k} {v['ms_per_step']:.2f}" for k, v in knobs.items())
          + f", drop-in {dropin['ms_per_step']:.2f}, fast {fast['ms_per_step']:.2f}, k2 knob {k2['ms_per_step']:.2f}"
          + f"; fast run PSNR first/last 20 steps {fast['psnr'][0]:.2f}/{fast['psnr'][1]:.2f} dB, device busy "
          + f"{fast['busy_ms']:.2f} of {fast['traced_ms']:.2f} ms per 8 warm steps; tail seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in tail.items()) + "; eval render, 64+128: "
          + ", ".join(f"{k} {v['rays_per_s']:,.0f} rays/s" for k, v in evals.items())
          + "; quality (psnr_parity protocol), mean eval PSNR (render_rays, f32; the planar bf16 eval): "
          + ", ".join(f"{arm} {q['mean']:.3f} dB ({q['planar_mean']:.3f}; {'in' if q['in_range'] else 'out of'} "
                      f"nerfjax's range)" for arm, q in quality["arms"].items()))
    # launches on the main paths, each counted from 0 around its run: the
    # 512^3 extraction, the tuned and the drop-in train(), the eval renders
    paths = {"extraction": extract_launches, "tuned train": trained["launches"], "drop-in train": dropin["launches"],
             "fast train": fast["launches"], "k2 knob": k2["launches"],
             **{f"eval render ({k})": v["launches"] for k, v in evals.items()},
             "feature-last render (R)": flast["launches"], "quality evals (render_rays)": quality["launches"]}
    launches = {}
    for counts in paths.values():
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    phase("main-path launches: " + "; ".join(f"{k} {v}" for k, v in paths.items()))
    zero_share = hstats["hash_levels_bwd"]["zero_share"]  # the hashed cotangent at every captured step
    phase("the hashed levels' cotangent, share of its values 0: "
          + "; ".join(f"{label} {v['values']:.2%}" for label, v in zero_share.items()))
    kernels = []
    for name, line in (("fused_ngp_head", 28), ("fused_ngp_density", 98)):
        bound, by = stats[name]["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": "nerfjax_torch/csrc/fused_mlp.cu",
            "replaces": f"nerfjax/ops/pallas_mlp.py:{line}", "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
            "plain_ms": stats[name]["plain_ms"], "bound_ms": bound, "bound_by": by, "library_ms": None,
        })
        t = stats[name]["f32"]  # the f32 kernel (ngp_head_kernel, ngp_density_kernel): the f32 extraction's
        kernels[-1].update(f32_launches=f32x["launches"][name], f32_ms=t["ms"], f32_plain_ms=t["plain_ms"],
                           f32_bound_ms=t["bound"][0], f32_bound_by=t["bound"][1],
                           f32_max_abs_err=stats[name]["f32_max_abs_err"], f32_extraction_s=f32x["wall_s"])
        if name == "fused_ngp_head":  # the extra lines: E = 32, 40 and 64, and the eval renders' fine passes
            kernels[-1].update(bit_equal_share=stats[name]["bit_equal_share"], max_err_ulp=stats[name]["max_err_ulp"])
            for E, t in stats[name]["wide"].items():
                kernels[-1].update({f"E{E}_ms": t["ms"], f"E{E}_plain_ms": t["plain_ms"], f"E{E}_bound_ms": t["bound"][0]})
            for label, ev in evals.items():
                t = ev["head_timing"]
                kernels[-1].update({f"eval_{label}_fine_ms": t["ms"], f"eval_{label}_fine_bound_ms": t["bound"][0]})
    for name, replaces in (("hash_levels_fwd", "nerfjax/ops/hash_encode.py:304"),
                           ("hash_levels_bwd", "nerfjax/ops/hash_encode.py:335"),
                           ("table_grad_scatter", "benchmarks/micro_onehot.py:44, benchmarks/micro_onehot.py:99"),
                           ("pack_pairs", "benchmarks/micro_pallas_gather.py:97"),
                           ("dense_levels_fwd", "benchmarks/micro_pallas_gather.py:97"),
                           ("dense_levels_bwd", "benchmarks/micro_pallas_gather.py:71")):
        h = hstats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "nerfjax_torch/csrc/hash_encode.cu", "replaces": replaces,
            "launches": launches[name], "max_abs_err": h["max_abs_err"], "ms": h["ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound"][0], "bound_by": h["bound"][1],
            "library_ms": h.get("library_ms"),
        })
        # ms above: K1 k = 1, K2 and K3 at the tuned step; K1 exact, K2 exact and K3 at the drop-in passes
        if name in ("hash_levels_fwd", "hash_levels_bwd", "table_grad_scatter"):
            for which in ("fine", "coarse"):
                t = dropin_timed[which][name]
                kernels[-1].update({f"dropin_{which}_ms": t["ms"], f"dropin_{which}_plain_ms": t["plain_ms"],
                                    f"dropin_{which}_bound_ms": t["bound"][0]})
                if "atomics" in t:
                    kernels[-1].update({f"dropin_{which}_atomics": t["atomics"]["runs"],
                                        f"dropin_{which}_atomics_first_design": t["atomics"]["first"]})
        if name == "hash_levels_bwd":
            kernels[-1]["cotangent_zero_share"] = {label: v["values"] for label, v in zero_share.items()}
        if name == "table_grad_scatter":
            kernels[-1]["atomics"] = h["atomics"]["runs"]
            kernels[-1]["atomics_first_design"] = h["atomics"]["first"]
        if name in ("hash_levels_bwd", "table_grad_scatter"):  # ms: net of the caller's zero fill
            kernels[-1].update(with_fill_ms=h["with_fill_ms"], fill_ms=h["fill_ms"])
            for which in ("fine", "coarse"):
                t = dropin_timed[which][name]
                kernels[-1].update({f"dropin_{which}_with_fill_ms": t["with_fill_ms"],
                                    f"dropin_{which}_fill_ms": t["fill_ms"]})
        # the k >= 2 modes: K2 b = 2 at the fast step, K2 b = 2 over 2 levels and K5 b = 2 at the k2 knob step
        # (K1 k = 2 and K4 k = 2 there are among the shapes below)
        lr_calls = {"hash_levels_bwd": {"fast_step": fast["timings"], "k2_knob_step": k2["timings"]},
                    "dense_levels_bwd": {"fast_step": fast["timings"], "k2_knob_step": k2["timings"]},
                    "table_grad_scatter": {"fast_step": fast["timings"]}}.get(name, {})
        for label, timings in lr_calls.items():
            t = timings[name]
            kernels[-1].update({f"{label}_ms": t["ms"], f"{label}_plain_ms": t["plain_ms"],
                                f"{label}_bound_ms": t["bound"][0]})
            if "fill_ms" in t:
                kernels[-1].update({f"{label}_with_fill_ms": t["with_fill_ms"], f"{label}_fill_ms": t["fill_ms"]})
            if "atomics" in t:
                kernels[-1].update({f"{label}_atomics": t["atomics"]["runs"],
                                    f"{label}_atomics_first_design": t["atomics"]["first"]})
        if name == "pack_pairs":  # K4's table pass (its time is in K4's too): the drop-in fine pass's, extra keys
            t = dropin_timed["fine"][name]
            kernels[-1].update(dropin_fine_ms=t["ms"], dropin_fine_plain_ms=t["plain_ms"],
                               dropin_fine_bound_ms=t["bound"][0], dropin_fine_library_ms=t["library_ms"])
        if name == "hash_levels_fwd":  # K1 k = 1's bound with a float32 output; its other calls' times
            kernels[-1]["bound_f32_out_ms"] = h["bound_f32_out"][0]
            for label, t in h["shapes"].items():
                kernels[-1].update({f"{label}_N": t["N"], f"{label}_ms": t["ms"], f"{label}_plain_ms": t["plain_ms"],
                                    f"{label}_bound_ms": t["bound"][0]})
                if "bound_f32_out" in t:
                    kernels[-1][f"{label}_bound_f32_out_ms"] = t["bound_f32_out"][0]
        if name == "dense_levels_fwd":  # every main-path call's time (the pack included): the extra keys
            kernels[-1]["kernel_ms"] = h["kernel_ms"]  # net of the pack
            for label, t in h["shapes"].items():
                kernels[-1].update({f"{label}_N": t["N"], f"{label}_ms": t["ms"], f"{label}_kernel_ms": t["kernel_ms"],
                                    f"{label}_plain_ms": t["plain_ms"], f"{label}_bound_ms": t["bound"][0]})
                if "bound_f32_out" in t:
                    kernels[-1][f"{label}_bound_f32_out_ms"] = t["bound_f32_out"][0]
        if name == "dense_levels_bwd":  # the dgl1 step's call, also with the L2 flushed in front of every call
            t = knobs["dgl1"]["timings"][name]
            kernels[-1].update(dgl1_step_ms=t["ms"], dgl1_step_bound_ms=t["bound"][0],
                               dgl1_step_flushed_ms=t["flushed_timing"]["ms"])
    # the feature-last forward (nerfjax's hashgrid_encode, an XLA op) at nerfjax's eval shape (the pack in front
    # included), its other calls as extra keys; its backward at phase R's fine pass
    t = flast["fwd"]["medium16"]
    kernels.append({
        "name": "hashgrid_fwd", "route": "cuda", "source": "nerfjax_torch/csrc/hash_encode.cu",
        "replaces": "nerfjax/fields/ngp.py:212", "launches": launches["hashgrid_fwd"],
        "max_abs_err": flast["max_abs_err"]["hashgrid_fwd"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": None, "N": t["N"],
        "gathers_bound_ms": t["gathers_bound"][0],
        "launches_by_path": {"feature-last render (R)": flast["launches"].get("hashgrid_fwd", 0),
                             "quality evals": quality["launches"].get("hashgrid_fwd", 0)},
    })
    for label in ("tuned12ed1", "render_fine", "quality_eval_fine"):
        t = flast["fwd"][label]
        kernels[-1].update({f"{label}_N": t["N"], f"{label}_ms": t["ms"], f"{label}_plain_ms": t["plain_ms"],
                            f"{label}_bound_ms": t["bound"][0], f"{label}_gathers_bound_ms": t["gathers_bound"][0]})
    t = flast["bwd"]
    kernels.append({
        "name": "hashgrid_bwd", "route": "cuda", "source": "nerfjax_torch/csrc/hash_encode.cu",
        "replaces": "nerfjax/fields/ngp.py:212", "launches": launches["hashgrid_bwd"],
        "max_abs_err": flast["max_abs_err"]["hashgrid_bwd"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": None,
        "with_fill_ms": t["with_fill_ms"], "fill_ms": t["fill_ms"], "adds": t["adds"],
        "adds_first_design": t["adds_first_design"], "staged_first_design": t["staged_first_design"],
        "peak_gib": flast["peak_gib"],
    })
    # K6's grid route at C3's cloud, launched by C3's colmap2nerf (every grid kernel's launches beside)
    t = front["knn"]
    kernels.append({
        "name": "knn_grid", "route": "cuda", "source": "nerfjax_torch/csrc/knn.cu",
        "replaces": "nerfjax/native/knn.cpp:22", "launches": front["launches"]["knn_grid"],
        "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": None, "n": t["n"], "k": t["k"],
        "launches_by_kernel": {name: front["launches"][name] for name in KNN_GRID_KERNELS},
        "pairs": t["pairs"], "pairs_bound_ms": t["tested_bound"][0], "levels": t["levels"], "tail": t["tail"],
        "split_ms": t["split"],
    })
    t = knn_more["clustered"]
    kernels[-1].update(clustered_n=t["n"], clustered_ms=t["ms"], clustered_plain_ms=t["plain_ms"],
                       clustered_bound_ms=t["bound"][0], clustered_pairs=t["pairs"],
                       clustered_pairs_bound_ms=t["tested_bound"][0], clustered_split_ms=t["split"])
    # the brute kernel (the first design) at C3's cloud; launches: the statistical filter on the coincident cloud
    t = front["knn_brute"]
    kernels.append({
        "name": "knn_mean_dist", "route": "cuda", "source": "nerfjax_torch/csrc/knn.cu",
        "replaces": "nerfjax/native/knn.cpp:22", "launches": knn_more["coincident_launches"]["knn_mean_dist"],
        "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": None, "n": t["n"], "k": t["k"], "pairs": t["pairs"],
        "pairs_bound_ms": t["tested_bound"][0],
    })
    t = knn_more["coincident"]
    kernels[-1].update(coincident_n=t["n"], coincident_ms=t["ms"], coincident_bound_ms=t["bound"][0])
    for name, line in PROBE_LINES.items():
        t = pstats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "nerfjax_torch/csrc/micro_probe.cu",
            "replaces": f"benchmarks/micro_probe.py:{line}", "launches": t["launches"], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"], "launch_floor_ms": t["floor"],
            "bound_or_floor_ms": max(t["bound"][0], t["floor"]),
        })
        if "library_bf16_inputs_ms" in t:  # library_ms: casts + matmul, the function the kernel computes
            kernels[-1]["library_bf16_inputs_ms"] = t["library_bf16_inputs_ms"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
