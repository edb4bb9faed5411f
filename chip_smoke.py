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
     64; bf16 and f32), with per-call times;
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
  H. (after 8c) the chain's head: 100 PNG frames of 800 x 800 in
     nerf_synthetic's train split's shape (precompute_scene) through
     python -m nerfjax_torch.cli.precompute_rays on the card: the rays
     kept, each stage's seconds, the wall and rays/s, the NPZ read back;
     4 frames on the card and on the CPU, masks equal, arrays within 1e-6.

The last two lines are a JSON object with each kernel's launches (summed
over the main paths: the 512^3 extraction, the tuned, drop-in and fast
train() runs, the k2 knob steps, the eval renders, the probe entry point),
error, times and bound (extra keys: the k >= 2 modes at the fast and k2
knob steps' calls; K1, K2 and K3 also their times, bounds and atomics at
the drop-in passes; the head at E = 40 and 64 and at the eval renders'
fine passes), then
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
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
KERNEL_SHAPES = [(n, e, dt) for n in (524_288, 1_000_003) for e in (24, 32, 40, 64) for dt in ("bf16", "f32")]
MAIN_SHAPE = (524_288, 24, "bf16")  # the fine pass's call: 8192 cells x 64 voxels
F32_SHAPE = (524_288, 24, "f32")  # the f32 kernels (--fp32 and precision: fp32 only: on no shipped cfg's path)
# timed beside MAIN_SHAPE: 16, 20 and 32 levels
WIDE_SHAPES = [(524_288, 32, "bf16"), (524_288, 40, "bf16"), (524_288, 64, "bf16")]
# sha-256 prefixes of (rgb, sigma, density sigma) of the MLP kernels at E = 24
# and 32 on _head_inputs, on an H100. f32: as the FP32 kernels computed them
# before the first layer was split into 32-row chunks (W1 staged as one [64,
# 32] block); the chunked kernels run the same sums and must reproduce them
# bit for bit. bf16: as the tensor-core kernels compute them (their order of
# additions is fixed, so any change to it shows here)
HEAD_DIGESTS = {
    (524_288, 24, "bf16"): "50034c4833e3cc25", (524_288, 24, "f32"): "2a21ea1846941ddd",
    (524_288, 32, "bf16"): "460680b3c25de4f7", (524_288, 32, "f32"): "c4fb4edeb8dce1ae",
    (1_000_003, 24, "bf16"): "7edeb9394c4de77c", (1_000_003, 24, "f32"): "276ab8e05a8b9298",
    (1_000_003, 32, "bf16"): "35b7e0b69abc0b0a", (1_000_003, 32, "f32"): "1066bfe6a9dc1cff",
}


def phase(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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
    from nerfjax_torch.ops import fused_mlp, hash_encode

    t0 = time.perf_counter()
    for name, info in _build.build_all().items():
        phase(f"built {info['path'].name} in {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  " + line.strip())
    phase(f"all kernels built in {time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    fused_mlp._lib()
    hash_encode._lib()


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
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key
              and (only is None or only in e.key) and (skip is None or skip not in e.key)]
    return sum(e.count for e in events), sum(e.self_device_time_total for e in events)


def _time_ms(fn, iters: int = 20, only: str | None = None, skip: str | None = None, rest=None) -> float:
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
    out (the pack in front of K4, an L2 flush), timed alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(5):
        per_call, _ = _device_trace(fn, 1, only=only, skip=skip)
        events, us = _device_trace(fn, iters, only=only, skip=skip)
        if per_call > 0 and events == iters * per_call:
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

    stats = {"fused_ngp_head": {"max_abs_err": 0.0, "wide": {}}, "fused_ngp_density": {"max_abs_err": 0.0}}
    lib = fm._lib()
    for dt, flag in (("bf16", 1), ("f32", 0)):
        phase(f"{dt} MLP kernels' dynamic shared memory per block: head " + ", ".join(
            f"E={E} {lib.nerf_fused_smem_bytes(E, flag, 0):,} B" for E in (24, 32, 64, 128))
            + "; density " + ", ".join(f"E={E} {lib.nerf_fused_smem_bytes(E, flag, 1):,} B" for E in (24, 32)))
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
                if dt == "bf16" and name == "fused_ngp_head":
                    shape_eq += int(torch.eq(got, ref).sum())
                    shape_worst = max(shape_worst, float(_ulps(got, ref).max()))
        line = f"N={N} E={E} {dt}: kernel == plain (bf16: <= 1 ulp; f32: <= 2e-5); density sigma == head sigma"
        if dt == "bf16":
            equal, total, worst = equal + shape_eq, total + 4 * N, max(worst, shape_worst)
            line += (f"; head outputs bit-equal to plain {shape_eq / (4 * N):.4%}, largest error "
                     f"{shape_worst:.3f} bf16 ulp")
        if E <= 32:
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
    t["kernel_ms"] = float(np.median([_time_ms(call, only="dense_levels_fwd", rest=pack) for _ in range(2)]))
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
    sets = []
    for _ in range(TIMING_SETS):
        sets.append((_time_ms(plain, skip=skip, rest=flush), _time_ms(kern, skip=skip, rest=flush),
                     _time_ms(kern, skip=skip, rest=flush), _time_ms(plain, skip=skip, rest=flush)))
        if _agree(sets[-1][1], sets[-1][2]) and _agree(sets[-1][0], sets[-1][3]):
            break
    else:
        raise AssertionError(f"{TIMING_SETS} timing sets (p, k, k, p) in a row disagree by more than "
                             f"{TIMING_AGREE}x: " + "; ".join(", ".join(f"{v * 1e3:.1f}" for v in r) for r in sets))
    lib = (_time_ms(library), _time_ms(library)) if library is not None else ()
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
    runs = [_time_ms(lambda: one.add_(1.0)) for _ in range(2)]
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
    that reaches a field pass's outputs, the field's backward (MLP and
    encode, all passes), AdamW with its schedule."""
    import torch

    from nerfjax_torch import train

    field, opt, s = state.field, state.optimizer, state.settings
    apply, update, adamw = field.apply_planar, train.update_occupancy, opt.step
    marks, total = [], {}

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    def backward_reached(_grad):
        if marks[-1][0].startswith("field forward"):  # the step's first gradient at a field pass's outputs
            mark("composite + loss, forward and backward")

    def timed_apply(*args, **kw):
        i = sum(label.startswith("field forward") for label, _ in marks)
        mark(("occupancy sample" if s.use_occupancy else "stratified sample") if i == 0
             else "coarse composite + pdf sample + sort")
        rgb, sigma = apply(*args, **kw)
        mark("field forward" + ("" if s.single_pass else " (coarse)" if i == 0 else " (fine)"))
        rgb.register_hook(backward_reached)
        sigma.register_hook(backward_reached)
        return rgb, sigma

    def timed_update(*args, **kw):
        update(*args, **kw)
        mark("occupancy update")

    def timed_adamw(*args, **kw):
        mark("field backward")
        return adamw(*args, **kw)

    field.apply_planar, opt.step = timed_apply, timed_adamw
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
        del field.apply_planar
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
    launches = dict(he.launch_counts)
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
    launches = dict(he.launch_counts)
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


def extract_trained(cfg: dict, final: Path) -> None:
    """The trained checkpoint extracted at 256^3 with the port; the occupied
    voxels against the analytic ball."""
    from nerfjax_torch.extract import extract_volume

    res = 256
    vol = extract_volume({**cfg, "checkpoint": str(final)}, resolution=res, device="cuda", verbose=False)
    occ = vol["occupancy_volume"].astype(bool)
    c = -1.0 + np.arange(res) * (2.0 / (res - 1))
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    ball = (X - BALL_CENTER[0]) ** 2 + (Y - BALL_CENTER[1]) ** 2 + (Z - BALL_CENTER[2]) ** 2 <= BALL_RADIUS**2
    iou = float((occ & ball).sum() / max((occ | ball).sum(), 1))
    phase(f"trained field at {res}^3: occupied {occ.mean():.2%} of voxels, ball {ball.mean():.2%}, IoU {iou:.3f}; "
          f"threshold {vol['metadata']['threshold']:.4f}; " + _phases(vol["metadata"]))
    if iou < 0.5:
        raise AssertionError(f"IoU with the analytic ball {iou:.3f} < 0.5")


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


def _warm_steps(cfg: dict, data_path: Path, n_warm: int, n_timed: int, label: str):
    """A fresh state for ``cfg`` trained n_warm steps, then n_timed steps
    each timed with a sync (the median printed): (state, batches left
    over, median ms/step). The batches are the NPZ's first, in order."""
    import torch

    from nerfjax_torch.data import RayDataset, batch_to_device
    from nerfjax_torch.train import TrainSettings, make_train_state, train_step

    data = RayDataset(data_path, verbose=False)
    total = n_warm + n_timed + 12
    batches = [batch_to_device(b, "cuda") for _, b in zip(range(total), data.epoch_batches(8192, seed=SEED))]
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
          f"max {max(times):.2f}) = {8192 / med * 1e3:,.0f} rays/s")
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
    launches = dict(he.launch_counts)
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
# steps (12 epochs of 50) on tests/synthetic.py's sphere, eval at uniform
# 64 + 128 on 4,096 held-out rays of seed 9999
PARITY_BATCH = 2048
PARITY_STEPS = 600
PARITY_STEPS_PER_EPOCH = 50  # psnr_parity.STEPS_PER_EPOCH: the training NPZ holds batch * 50 rays
PARITY_EVAL_RAYS = 4096
PARITY_EVAL_SEED = 9999
PARITY_EVAL_SAMPLES = (64, 128)
PARITY_SEEDS = (0, 1, 2)
# nerfjax's eval PSNR in dB for seeds 0, 1, 2 (benchmarks/psnr_parity.json:
# sphere, medium, batch 2048, 600 steps): a quality number of the method,
# not a time
PARITY_NERFJAX_DB = {"spass2": (32.091, 32.010, 31.625), "spass8": (33.117, 31.066, 31.854)}
PARITY_FLOOR_DB = 30.0  # the least mean eval PSNR of an arm's seeds
# the least eval PSNR of every run: a step that does not learn stays near the
# sphere's first PSNR (~7 dB), while a healthy run of this protocol spreads
# over a few dB by seed (on an H100 spass2 seed 1 lands at 29.6-29.7 dB;
# nerfjax's spass8 seeds span 31.07-33.12)
PARITY_RUN_FLOOR_DB = 25.0
PARITY_SEED_SLACK_DB = 0.5  # a run in range lies at most this far below nerfjax's lowest seed


def parity_cfg(arm: str, rays_file: Path, out_dir: Path):
    """The port's copy of psnr_parity._cfg(tag, arm, 2048, 600, rays_file,
    nerf_type="medium") for arms "spass2" (single pass, 16 + 32 samples from
    the 128-segment occupancy CDF, the exact forward, hash_grad_corners 2:
    the fast cfg's estimators) and "spass8" (the same, exact gradient),
    overlaid on the port's base defaults as _cfg overlays nerfjax's;
    tests/test_torch_quality_protocol.py holds it equal to _cfg on every
    key the port reads."""
    from nerfjax_torch.config import ConfigNode, with_defaults

    return with_defaults(ConfigNode({
        "scene_name": out_dir.name, "ngp": True, "nerf_type": "medium", "batch_size": PARITY_BATCH,
        "num_epochs": PARITY_STEPS // PARITY_STEPS_PER_EPOCH, "lr": 5e-4, "N_samples": 16, "N_importance": 32,
        "precision": "bf16", "occupancy_grid": True, "hash_grad_corners": {"spass2": 2, "spass8": 8}[arm],
        "single_pass": True, "hash_n_levels": 16, "hash_extra_dense_levels": 0, "hash_fwd_corners": 8,
        "hash_dense_corners": 8, "hash_grad_levels": 0, "hash_dense_grad_levels": 0, "occ_fast_cdf": False,
        "occ_update_partitions": 1, "occ_segments": 128, "rays_file": str(rays_file), "output_dir": str(out_dir),
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


def _parity_eval_psnr(final: Path, cfg, data: dict) -> float:
    """_eval_psnr on the port: the checkpoint's field renders the held-out
    rays with the two-pass sampler (stratified 64, then 128 from the
    coarse weights, train=False) in the cfg's precision; PSNR =
    -10 log10(MSE) against their rgbs."""
    import torch

    from nerfjax_torch.checkpoint import load_field
    from nerfjax_torch.render import render_rays_planar

    field = load_field(final, cfg, device="cuda")
    ro, rd, tn, tf = (torch.from_numpy(data[k]).cuda() for k in ("rays_o", "rays_d", "t_near", "t_far"))
    with torch.no_grad():
        rgb = render_rays_planar(field, field, ro, rd, tn, tf, *PARITY_EVAL_SAMPLES, train=False,
                                 dtype=torch.bfloat16 if cfg["precision"] == "bf16" else torch.float32,
                                 generator=torch.Generator(device="cuda").manual_seed(0))["rgb_fine"]
    mse = float(np.mean((rgb.cpu().numpy() - data["rgbs"]) ** 2))
    return -10.0 * float(np.log10(mse))


def quality_parity(tmp: Path, seeds=PARITY_SEEDS) -> dict:
    """The fast op point's quality under nerfjax's own protocol: arms spass2
    and spass8 (parity_cfg), each seed trained by nerfjax_torch.train.train
    on the card from tests/synthetic.make_ray_npz rays (batch * 50 rays of
    its seed: one NPZ per seed, shared by both arms) and evaluated on the
    4,096 held-out rays of seed 9999 (_parity_eval_psnr). One line per run
    (the port's eval PSNR beside nerfjax's for the same arm and seed where
    benchmarks/psnr_parity.json has one, wall seconds, steps) and one per
    arm (the mean, the verdict against nerfjax's three-seed range: in range
    if the mean lies within [min, max] and no seed is more than
    PARITY_SEED_SLACK_DB below the min). After every run has printed its
    line, raises on a run that is not finite, misses its steps or lies
    below PARITY_RUN_FLOOR_DB, or an arm whose mean lies below
    PARITY_FLOOR_DB; the verdict itself is only reported."""
    import torch

    from nerfjax_torch.train import train

    syn = _synthetic_module()
    t0 = time.perf_counter()
    eval_data = syn.make_ray_npz(tmp / "parity_eval.npz", n_rays=PARITY_EVAL_RAYS, seed=PARITY_EVAL_SEED,
                                 scene="sphere")
    rays = {}
    for seed in seeds:
        rays[seed] = tmp / f"parity_rays_s{seed}.npz"
        syn.make_ray_npz(rays[seed], n_rays=PARITY_BATCH * PARITY_STEPS_PER_EPOCH, seed=seed, scene="sphere")
    phase(f"quality: tests/synthetic.make_ray_npz sphere NPZs ({len(seeds)} x "
          f"{PARITY_BATCH * PARITY_STEPS_PER_EPOCH:,} training rays, {PARITY_EVAL_RAYS:,} eval rays of seed "
          f"{PARITY_EVAL_SEED}) in {time.perf_counter() - t0:.1f} s")
    result, failed = {}, []
    for arm, ref in PARITY_NERFJAX_DB.items():
        runs = []
        for seed in seeds:
            cfg = parity_cfg(arm, rays[seed], tmp / f"parity_{arm}_s{seed}")
            t1 = time.perf_counter()
            out = train(cfg, seed=seed, log_every=PARITY_STEPS, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            psnr = _parity_eval_psnr(Path(cfg["checkpoint_dir"]) / "nerf_final.pth", cfg, eval_data)
            nerfjax = f"{ref[seed]:.3f}" if seed < len(ref) else "not recorded"
            phase(f"quality {arm} seed {seed}: eval PSNR {psnr:.3f} dB (nerfjax {nerfjax}), {out['steps']} steps in "
                  f"{wall:.1f} s wall, train PSNR of the last 50 steps {np.mean(out['psnr'][-50:]):.2f} dB")
            if not np.isfinite(psnr) or not np.isfinite(out["psnr"]).all() or psnr < PARITY_RUN_FLOOR_DB:
                failed.append(f"{arm} seed {seed}: eval PSNR {psnr:.3f} dB (floor {PARITY_RUN_FLOOR_DB}), training "
                              f"PSNR {'finite' if np.isfinite(out['psnr']).all() else 'not finite'}")
            if out["steps"] != PARITY_STEPS:
                failed.append(f"{arm} seed {seed}: {out['steps']} steps, not {PARITY_STEPS}")
            runs.append({"seed": seed, "psnr": psnr, "wall_s": wall, "steps": out["steps"]})
        psnrs = [r["psnr"] for r in runs]
        mean, lo, hi = float(np.mean(psnrs)), min(ref), max(ref)
        in_range = lo <= mean <= hi and min(psnrs) >= lo - PARITY_SEED_SLACK_DB
        spread = f", sd {np.std(psnrs, ddof=1):.3f}" if len(psnrs) > 1 else ""
        phase(f"quality {arm}: mean eval PSNR {mean:.3f} dB over seeds {tuple(seeds)}{spread}, lowest "
              f"{min(psnrs):.3f} (nerfjax mean {np.mean(ref):.3f} over seeds 0-2, range [{lo:.3f}, {hi:.3f}]): "
              f"{'in' if in_range else 'OUT OF'} nerfjax's range (mean within it, no seed below "
              f"{lo - PARITY_SEED_SLACK_DB:.3f})")
        if mean < PARITY_FLOOR_DB:
            failed.append(f"{arm}: mean eval PSNR {mean:.3f} dB < {PARITY_FLOOR_DB}")
        result[arm] = {"runs": runs, "mean": mean, "in_range": in_range}
    gap = result["spass2"]["mean"] - result["spass8"]["mean"]
    ref_gap = np.mean(PARITY_NERFJAX_DB["spass2"]) - np.mean(PARITY_NERFJAX_DB["spass8"])
    phase(f"quality: the b = 2 gradient's cost, mean spass2 - mean spass8, {gap:+.3f} dB on the port over seeds "
          f"{tuple(seeds)} (nerfjax {ref_gap:+.3f} dB over seeds 0-2)")
    phase(f"quality phase: {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("quality: " + "; ".join(failed))
    return result


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
    launches = dict(he.launch_counts)
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


# the precompute phase's scene: nerf_synthetic's train split (100 frames of
# 800 x 800, camera_angle_x 0.6911112, cameras 4.03 from the origin)
PRECOMPUTE_FRAMES = 100
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


def precompute_phase(tmp: Path) -> dict:
    """The chain's head on the card: precompute_scene's 100 frames through
    ``python -m nerfjax_torch.cli.precompute_rays`` (a JSON cfg naming the
    transforms JSON and the NPZ): the rays kept of those generated, each
    stage's seconds as the CLI reports them (decode; rays + intersection,
    CUDA events; compaction + fetch; the NPZ write), its wall and rays/s;
    the NPZ read back (its rays count, finite, unit directions, t_far >=
    t_near). Then the first PRECOMPUTE_CHECK_FRAMES frames made on the card
    and on the CPU: the hit masks equal (else the count that differ and the
    largest |t_far - t_near| among them, and a failure), the arrays within
    1e-6."""
    import torch

    from nerfjax_torch import rays as R

    t0 = time.perf_counter()
    scene = precompute_scene(tmp / "scene")
    phase(f"precompute scene: {PRECOMPUTE_FRAMES} PNG frames of {PRECOMPUTE_SIZE}^2 written in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")
    npz = tmp / "scene" / "train_ray_data.npz"
    cfg = tmp / "scene" / "precompute.json"
    cfg.write_text(json.dumps({"scene_name": "train", "transforms_json": str(scene), "rays_file": str(npz)}))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "nerfjax_torch.cli.precompute_rays", "--cfg_path", str(cfg)],
                         capture_output=True, text=True, cwd=HERE, timeout=600)
    wall = time.perf_counter() - t0
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
            bf16_in = [_time_ms(lambda: torch.matmul(a16.t(), b16)) for _ in range(2)]
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
    launches = dict(he.launch_counts)
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


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of nerfjax_torch on one CUDA card (every phase by default)")
    ap.add_argument("--only", choices=["quality", "steps"], default=None,
                    help="run only the card, the build and this phase (no kernels line, no final line)")
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
    stats = kernels_vs_plain()
    k4_shapes = {}  # K4 at each main-path call: the kernels line's extra keys
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_path = Path(tmp) / "nerf_final.pth"
        synthetic_checkpoint(ckpt_path)
        extract_launches = extract_full(ckpt_path, Path(tmp), k4_shapes)
        card_vs_cpu_128(ckpt_path)
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
        tail = tail_on_trained(trained["cfg"], trained["final"], Path(tmp))
        head = precompute_phase(Path(tmp))
        evals = {"tuned": eval_render(trained["final"], TUNED_CFG, "tuned", stats, hstats),
                 "drop-in": eval_render(dropin["final"], DROP_IN_TRAIN, "drop-in", stats, hstats)}
        for label in ("tuned", *DENSE_KNOBS, "fast", "fast bf16"):
            step_card_vs_cpu(Path(tmp), label)
        dropin_step_card_vs_cpu(Path(tmp))
        render_card_vs_cpu(trained["final"])
    phase(f"train() wall per step, tuned run: {trained['train_wall_ms_per_step']:.2f} ms; precompute_rays: "
          f"{head['kept']:,} of {head['generated']:,} rays, {head['process_wall']:.2f} s (NPZ write "
          f"{head['write']:.2f} s)")
    phase("warm ms/step: tuned " + f"{trained['ms_per_step']:.2f}, "
          + ", ".join(f"{k} {v['ms_per_step']:.2f}" for k, v in knobs.items())
          + f", drop-in {dropin['ms_per_step']:.2f}, fast {fast['ms_per_step']:.2f}, k2 knob {k2['ms_per_step']:.2f}"
          + f"; fast run PSNR first/last 20 steps {fast['psnr'][0]:.2f}/{fast['psnr'][1]:.2f} dB, device busy "
          + f"{fast['busy_ms']:.2f} of {fast['traced_ms']:.2f} ms per 8 warm steps; tail seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in tail.items()) + "; eval render, 64+128: "
          + ", ".join(f"{k} {v['rays_per_s']:,.0f} rays/s" for k, v in evals.items())
          + "; quality (psnr_parity protocol), mean eval PSNR: "
          + ", ".join(f"{arm} {q['mean']:.3f} dB ({'in' if q['in_range'] else 'out of'} nerfjax's range)"
                      for arm, q in quality.items()))
    # launches on the main paths, each counted from 0 around its run: the
    # 512^3 extraction, the tuned and the drop-in train(), the eval renders
    paths = {"extraction": extract_launches, "tuned train": trained["launches"], "drop-in train": dropin["launches"],
             "fast train": fast["launches"], "k2 knob": k2["launches"],
             **{f"eval render ({k})": v["launches"] for k, v in evals.items()}}
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
        t = stats[name]["f32"]  # the f32 kernel (ngp_head_kernel, ngp_density_kernel): on no main path
        kernels[-1].update(f32_launches=0, f32_ms=t["ms"], f32_plain_ms=t["plain_ms"], f32_bound_ms=t["bound"][0],
                           f32_bound_by=t["bound"][1])
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
