#!/usr/bin/env python3
"""Smoke run of nerfjax_torch on one CUDA card, at the full width of the
tuned model (cfg/blender_scene_tuned.yml): the extraction path (checkpoint
-> 512^3 volume.pth) and the training path (ray NPZ -> tuned single-pass
train steps -> nerf_final.pth).

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero before the
final line:

  1. the card (nvidia-smi name and power limit); no CUDA -> exit 1;
  2. build the CUDA kernels from nerfjax_torch/csrc, one nvcc per source,
     all at once (ptxas report);
  3. the MLP kernels against their plain PyTorch versions at the
     extraction's shapes (N = 524,288 and 1,000,003; E = 24 and 32; bf16
     and f32), with per-call times;
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

The last two lines are a JSON object with each kernel's launches, error,
times and bound, then {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
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
KERNEL_SHAPES = [(n, e, dt) for n in (524_288, 1_000_003) for e in (24, 32) for dt in ("bf16", "f32")]
MAIN_SHAPE = (524_288, 24, "bf16")  # the fine pass's call: 8192 cells x 64 voxels


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


def _ulp_ok(got, ref) -> bool:
    """|got - ref| within one bf16 ulp of ref, elementwise. The ulp is taken
    at no less than 2^-14: near zero (where relu cuts) the two summation
    orders differ by float32 noise of O(1) sums, which lies below 2^-21."""
    import torch

    got, ref = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-14))) - 7)
    return bool(((got - ref).abs() <= ulp).all())


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


def _time_ms(fn, iters: int = 20) -> float:
    """Device ms per call of fn: the summed durations of the kernels (and
    copies) it runs over iters calls, from a torch.profiler trace of the
    card alone; the host's time between them is left out. A trace that
    came back without device events (seen once in ~100 traces) is taken
    again, up to 3 times."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    raise AssertionError("3 profiler traces in a row show no device time")


def kernels_vs_plain() -> dict:
    import torch

    from nerfjax_torch.ops import fused_mlp as fm

    rng = np.random.default_rng(SEED)
    stats = {"fused_ngp_head": {"max_abs_err": 0.0}, "fused_ngp_density": {"max_abs_err": 0.0}}
    for N, E, dt in KERNEL_SHAPES:
        tdt = torch.bfloat16 if dt == "bf16" else torch.float32
        params = _weights(E, rng)
        enc = torch.from_numpy(rng.uniform(-1, 1, (E, N)).astype(np.float32)).cuda().to(tdt)
        sh = torch.from_numpy(rng.uniform(-1, 1, (16, N)).astype(np.float32)).cuda().to(tdt)
        packed = fm.pack_weights(params, tdt, enc.device)  # once per field, as InstantNGP does
        rgb_k, sig_k = fm.fused_ngp_head(params, enc, sh, packed=packed)
        dsig_k = fm.fused_ngp_density(params, enc, packed=packed)
        rgb_p, sig_p = fm.fused_ngp_head_plain(params, enc, sh)
        dsig_p = fm.fused_ngp_density_plain(params, enc)
        torch.cuda.synchronize()
        if not torch.equal(dsig_k, sig_k):
            raise AssertionError(f"density sigma != head sigma at N={N} E={E} {dt}")
        for name, pairs in (("fused_ngp_head", [(rgb_k, rgb_p), (sig_k, sig_p)]),
                            ("fused_ngp_density", [(dsig_k, dsig_p)])):
            for got, ref in pairs:
                err = float((got.float() - ref.float()).abs().max())
                ok = _ulp_ok(got, ref) if dt == "bf16" else err <= 2e-5
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain version at N={N} E={E} {dt}: {err}")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        line = f"N={N} E={E} {dt}: kernel == plain (bf16: <= 1 ulp; f32: <= 2e-5); density sigma == head sigma"
        if (N, E, dt) == MAIN_SHAPE:
            runs = {
                "fused_ngp_head": (lambda: fm.fused_ngp_head(params, enc, sh, packed=packed),
                                   lambda: fm.fused_ngp_head_plain(params, enc, sh)),
                "fused_ngp_density": (lambda: fm.fused_ngp_density(params, enc, packed=packed),
                                      lambda: fm.fused_ngp_density_plain(params, enc)),
            }
            for name, (kern, plain) in runs.items():
                stats[name].update(_time_kernel(kern, plain, None, None))
                line += f"\n  {name}: " + _timing_line(stats[name])
        phase(line)
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


def extract_full(ckpt_path: Path, out_dir: Path) -> dict:
    """The main path: checkpoint -> extract_volume at 512^3 on the card ->
    save_volume -> load_volume, checked."""
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
    t0 = time.perf_counter()
    vol = extract_volume(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = {**fm.launch_counts, **{k: he.launch_counts[k] for k in ("hash_levels_fwd", "dense_levels_fwd")}}
    peak = torch.cuda.max_memory_allocated() / 2**30
    md = vol["metadata"]
    phase(f"{res}^3 extraction: {wall:.2f} s wall; " + _phases(md)
          + f"; peak device memory {peak:.2f} GiB; launches {launches}")

    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
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
    scatters_at_step_shapes."""
    import torch

    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import build_fields

    rng = np.random.default_rng(SEED + 6)
    exact = build_fields(TUNED_CFG)[1].spec
    k1 = build_fields(TUNED_TRAIN, train=True)[1].spec
    _, hashed = he._split_levels(exact)
    Lh, base, total = len(hashed), hashed[0]["offset"], exact.total_table_size
    planes = _rand((2, total), rng)
    stats = {n: {"max_abs_err": 0.0} for n in ("hash_levels_fwd", "hash_levels_bwd", "table_grad_scatter")}

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
            idx = torch.stack(he._hash_level_indices(exact, hashed, x, y, z))
            nbytes = 8 * torch.unique(idx).numel() + 12 * N + 8 * Lh * N
            timed("hash_levels_fwd", f"exact N={N}", lambda: he.hash_levels_fwd(exact, planes, x, y, z),
                  lambda: he.hash_levels_fwd_plain(exact, planes, x, y, z), _bound(nbytes, 110 * Lh * N))

    # K1 k = 1 (the train step's forward) with its plan; K2 in its three modes
    N = 196_608
    x, y, z = _rand((3, N), rng, 0.0, 1.0)
    sel = torch.empty(Lh, N, dtype=torch.int32, device="cuda")
    got = he.hash_levels_fwd(k1, planes, x, y, z, sel=sel)
    ref, plan = he.hash_levels_fwd_plain(k1, planes, x, y, z)
    if not torch.equal(sel.long(), plan) or not torch.equal(got, ref):
        raise AssertionError("hash_levels_fwd k=1: plan or output differs from the plain version")
    phase(f"hash_levels_fwd k=1 N={N}: sel == plain plan, output == plain (torch.equal)")
    nbytes = 8 * torch.unique(plan).numel() + 12 * N + 8 * Lh * N
    timed("hash_levels_fwd", f"k=1 N={N}", lambda: he.hash_levels_fwd(k1, planes, x, y, z),
          lambda: he.hash_levels_fwd_plain(k1, planes, x, y, z), _bound(nbytes, 80 * Lh * N))

    g = _rand((2, Lh, N), rng)
    for label, spec in (("exact", exact), ("k=1", dataclasses.replace(k1, grad_levels=0)), ("k=1 gl=2", k1)):
        got = he.hash_levels_bwd(spec, g, x, y, z, _zeros2(total))
        ref = he.hash_levels_bwd_plain(spec, g, x, y, z, _zeros2(total))
        mass = he.hash_levels_bwd_plain(spec, g.abs(), x, y, z, _zeros2(total))
        count = he.hash_levels_bwd_plain(spec, torch.ones_like(g), x, y, z, _zeros2(total))
        err = _check_scatter(f"hash_levels_bwd {label}", got, ref, mass, count)
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
    """K4's bound: positions in, the touched table entries (both planes) in
    once, the [2, Ld, N] output out once; ops per (level, point)."""
    return _bound(12 * N + 8 * touched + out_bytes * 2 * Ld * N, ops_per_row * Ld * N)


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
    train step's own inputs (dense_at_step_shapes)."""
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
                         _dense_fwd_bound(Ld, touched, N, 2, 120))
        phase(f"dense_levels_fwd exact N={N}: kernel == plain bit for bit (f32 and bf16); "
              f"{touched:,} of {he._dense_width(dense):,} dense entries touched")
        phase(f"  dense_levels_fwd exact bf16 N={N}: " + _timing_line(t))

    N = 196_608
    x, y, z = _positions(N, rng)
    sel = torch.empty(Ld, N, dtype=torch.int32, device="cuda")
    got = he.dense_levels_fwd(dc1, planes, x, y, z, torch.bfloat16, sel=sel)
    ref, plan = he.dense_levels_fwd_plain(dc1, planes, x, y, z, torch.bfloat16)
    if not torch.equal(sel.long(), plan) or got.dtype != torch.float32 or not torch.equal(got, ref):
        raise AssertionError("dense_levels_fwd k=1: plan or output differs from the plain version")
    t = _time_kernel(lambda: he.dense_levels_fwd(dc1, planes, x, y, z, torch.bfloat16),
                     lambda: he.dense_levels_fwd_plain(dc1, planes, x, y, z, torch.bfloat16), None,
                     _dense_fwd_bound(Ld, torch.unique(plan).numel(), N, 4, 80))
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


def _check_scatter(label: str, got, ref, mass, count) -> float:
    """max |got - ref| of two table gradients summed by atomics in a free
    order, held per entry to 2 * max(n, 8) * 2^-24 * sum|terms|, n the
    entry's terms (counted with unit inputs): an f32 sum of n terms in any
    order lies within (n - 1) * 2^-24 * sum|terms| of the exact sum, so two
    such sums within twice that; n is taken at no less than 8, the exact
    backward's corners, whose unit-input count sums weights."""
    bound = 2.0 * count.clamp_min(8.0) * 2.0**-24 * mass + 1e-30
    err = (got - ref).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"{label}: kernel vs plain max |err| {float(err.max())} beyond the atomic-order bound")
    return float(err.max())


def _time_kernel(kern, plain, library, bound) -> dict:
    """Device ms per call (_time_ms) of a kernel's wrapper and its plain
    version (runs p, k, k, p), of its one-call library yardstick where
    there is one (runs l, l), beside its bound (or None); and the wrapper's
    wall ms per call (_wall_ms, the host's Python included)."""
    runs = (_time_ms(plain), _time_ms(kern), _time_ms(kern), _time_ms(plain))
    lib = (_time_ms(library), _time_ms(library)) if library is not None else ()
    return {"ms": (runs[1] + runs[2]) / 2, "plain_ms": (runs[0] + runs[3]) / 2,
            "library_ms": sum(lib) / 2 if lib else None, "bound": bound, "runs": runs + lib,
            "wall_ms": _wall_ms(kern)}


def _timing_line(t: dict) -> str:
    r = ", ".join(f"{v * 1e3:.1f}" for v in t["runs"])
    lib = "" if t["library_ms"] is None else f", index_add_ {t['library_ms'] * 1e3:.1f} us"
    order = "p,k,k,p,l,l" if t["library_ms"] is not None else "p,k,k,p"
    bound = "" if t["bound"] is None else f", bound {t['bound'][0] * 1e3:.1f} us ({t['bound'][1]})"
    return (f"device: kernel {t['ms'] * 1e3:.1f} us, plain {t['plain_ms'] * 1e3:.1f} us{lib} per call "
            f"(runs {order}: {r}){bound}; wall per kernel call {t['wall_ms'] * 1e3:.1f} us")


STEP_KERNELS = ("dense_levels_fwd", "dense_levels_bwd", "hash_levels_bwd", "table_grad_scatter")


def capture_step_inputs(state, batch) -> dict:
    """The arguments that K4, K5, K2 and K3 get in one warm train step (the
    last call of each): the step's own positions, table, plan and upstream
    gradients."""
    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import train_step

    seen, wrapped = {}, {}
    for name in STEP_KERNELS:
        wrapped[name] = getattr(he, name)

        def record(*args, _name=name, **kw):
            seen[_name] = args
            return wrapped[_name](*args, **kw)

        setattr(he, name, record)
    try:
        train_step(state, batch)
    finally:
        for name, fn in wrapped.items():
            setattr(he, name, fn)
    if seen.keys() != wrapped.keys():
        raise AssertionError(f"the step called {sorted(seen)} of {STEP_KERNELS}")
    return seen


def scatters_at_step_shapes(cap: dict, stats: dict) -> None:
    """K2 and K3 on the inputs of one warm tuned step (capture_step_inputs)
    against their plain versions, and timed. Each timed call zeroes the
    function's own output, the columns its levels own in a [2, total]
    buffer (K3: the dense levels; K2: the hashed levels), and adds into
    it, as the encode's backward does with its one gradient."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    spec, g, x, y, z, step_grad = cap["hash_levels_bwd"]
    idx, v0, v1, _ = cap["table_grad_scatter"]
    total = step_grad.shape[1]
    _, hashed = he._split_levels(spec)
    base, Lh, N, K = hashed[0]["offset"], len(hashed), x.shape[0], idx.shape[0]
    buf = torch.empty(2, total, device="cuda")

    got = he.table_grad_scatter(idx, v0, v1, _zeros2(total))
    ref = he.table_grad_scatter_plain(idx, v0, v1, _zeros2(total))
    one = torch.ones_like(v0)
    mass = he.table_grad_scatter_plain(idx, v0.abs(), v1.abs(), _zeros2(total))
    count = he.table_grad_scatter_plain(idx, one, one, _zeros2(total))
    err = _check_scatter("table_grad_scatter (step)", got, ref, mass, count)
    hits = torch.bincount(idx.long(), minlength=total)[:base]
    if got[:, base:].abs().max() != 0 or int(hits.sum()) != K:
        raise AssertionError("the dense-level gradient reached outside the dense columns")
    stats["table_grad_scatter"]["max_abs_err"] = max(stats["table_grad_scatter"]["max_abs_err"], err)
    dense, vv = buf[:, :base], torch.stack([v0, v1])

    def k3():
        dense.zero_()
        he.table_grad_scatter(idx, v0, v1, buf)

    def p3():
        dense.zero_()
        he.table_grad_scatter_plain(idx, v0, v1, buf)

    def l3():
        dense.zero_()
        buf.index_add_(1, idx, vv)

    t = _time_kernel(k3, p3, l3, _bound(12 * K + 8 * base, 2 * K))
    stats["table_grad_scatter"].update(t)
    phase(f"table_grad_scatter at the step's dense-level gradient (K={K:,} = {K // N} level-corners x {N:,} points "
          f"into {base:,} dense entries; at most {int(hits.max()):,} adds to one entry, median "
          f"{int(hits[hits > 0].median())}): kernel == plain within the atomic-order bound, max |err| {err:.3g}")
    phase("  " + _timing_line(t))

    got = he.hash_levels_bwd(spec, g, x, y, z, _zeros2(total))
    ref = he.hash_levels_bwd_plain(spec, g, x, y, z, _zeros2(total))
    mass = he.hash_levels_bwd_plain(spec, g.abs(), x, y, z, _zeros2(total))
    count = he.hash_levels_bwd_plain(spec, torch.ones_like(g), x, y, z, _zeros2(total))
    err = _check_scatter("hash_levels_bwd (step)", got, ref, mass, count)
    stats["hash_levels_bwd"]["max_abs_err"] = max(stats["hash_levels_bwd"]["max_abs_err"], err)
    ids = he._draw_levels(x, y, z, Lh, spec.grad_levels, he.LEVEL_SALT)
    pairs = torch.unique(ids * N + torch.arange(N, device="cuda")).numel()
    hashed_cols = buf[:, base:]

    def k2():
        hashed_cols.zero_()
        he.hash_levels_bwd(spec, g, x, y, z, buf)

    def p2():
        hashed_cols.zero_()
        he.hash_levels_bwd_plain(spec, g, x, y, z, buf)

    # no one PyTorch call computes it: the indices are computed inside
    t = _time_kernel(k2, p2, None, _bound(12 * N + 8 * pairs + 8 * (total - base), 90 * spec.grad_levels * N))
    stats["hash_levels_bwd"].update(t)
    phase(f"hash_levels_bwd at the step's hashed-level gradient (k=1, {spec.grad_levels} of {Lh} levels, N={N:,}): "
          f"kernel == plain within the atomic-order bound, max |err| {err:.3g}")
    phase("  " + _timing_line(t))


def dense_at_step_shapes(cap: dict, label: str) -> dict:
    """K4 and K5 on the inputs of one warm train step (capture_step_inputs):
    equal to their plain versions (torch.equal) and timed beside their
    bounds. Returns {name: timing}."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    spec, planes, x, y, z, dtype = cap["dense_levels_fwd"]
    planes = planes.detach()  # the field's table: no autograd graph for the plain version
    dense, _ = he._split_levels(spec)
    Ld, N = len(dense), x.shape[0]
    mode, gd = he._dense_mode(spec, Ld)
    got = he.dense_levels_fwd(spec, planes, x, y, z, dtype)
    ref, plan = he.dense_levels_fwd_plain(spec, planes, x, y, z, dtype)
    if got.dtype != ref.dtype or not torch.equal(got, ref):
        raise AssertionError(f"dense_levels_fwd ({label} step): kernel != plain")
    if plan is None:
        touched = torch.unique(he._dense_corner_arrays(dense, x, y, z, torch.float32)[0]).numel()
        bound = _dense_fwd_bound(Ld, touched, N, got.element_size(), 120)
    else:
        bound = _dense_fwd_bound(Ld, torch.unique(plan).numel(), N, 4, 80)
    out = {"dense_levels_fwd": _time_kernel(lambda: he.dense_levels_fwd(spec, planes, x, y, z, dtype),
                                            lambda: he.dense_levels_fwd_plain(spec, planes, x, y, z, dtype),
                                            None, bound)}
    phase(f"dense_levels_fwd at the {label} step's forward ({['exact', 'k=1', 'exact'][mode]} {dtype}, "
          f"N={N:,}, {Ld} levels): kernel == plain (torch.equal)")
    phase("  " + _timing_line(out["dense_levels_fwd"]))

    spec, g, x, y, z, dtype = cap["dense_levels_bwd"]
    got = he.dense_levels_bwd(spec, g, x, y, z, dtype)
    ref = he.dense_levels_bwd_plain(spec, g, x, y, z, dtype)
    if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"dense_levels_bwd ({label} step): kernel != plain")
    K = got[0].numel()
    if K != {0: 8 * Ld, 1: Ld, 2: 8 * gd}[mode] * N or not torch.equal(got[0], cap["table_grad_scatter"][0]):
        raise AssertionError(f"dense_levels_bwd ({label} step): K3 did not get K5's {K:,} staged entries")
    out["dense_levels_bwd"] = _time_kernel(lambda: he.dense_levels_bwd(spec, g, x, y, z, dtype),
                                           lambda: he.dense_levels_bwd_plain(spec, g, x, y, z, dtype), None,
                                           _dense_bwd_bound(spec, g, x, y, z, K))
    phase(f"dense_levels_bwd at the {label} step's gradient ({['exact', 'k=1', f'{gd} of {Ld} levels'][mode]}, "
          f"{dtype}, N={N:,}): K={K:,} staged entries == plain (torch.equal), all handed to K3")
    phase("  " + _timing_line(out["dense_levels_bwd"]))
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
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12)
    print(table)
    m = re.search(r"Self CUDA time total:\s*([\d.]+)(us|ms|s)", table)
    if m is None:
        raise AssertionError("the profiler trace shows no device time")
    busy = float(m.group(1)) * {"us": 1e-3, "ms": 1.0, "s": 1e3}[m.group(2)]
    return busy, wall, 1.0 - busy / wall


def _stage_split(state, batches) -> dict:
    """ms per step by stage, from CUDA events around the pieces of
    train_step run in its order (the occupancy update amortised over the
    steps of the window)."""
    import torch

    from nerfjax_torch.ops.occupancy import occupancy_sample
    from nerfjax_torch.render import raw2outputs_planar
    from nerfjax_torch.train import update_occupancy

    s = state.settings
    spec, S = s.occ_spec(), s.n_samples + s.n_importance
    names = ["occupancy update", "occupancy sample", "field forward", "composite + loss", "backward", "AdamW"]
    total = dict.fromkeys(names, 0.0)
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        state.generator.manual_seed(state.seed * 1_000_003 + state.step)
        update_occupancy(state)
        ev[1].record()
        z = occupancy_sample(spec, state.occ_grid, b["rays_o"], b["rays_d"], b["t_near"], b["t_far"], S,
                             generator=state.generator)
        ev[2].record()
        B = z.shape[0]
        pos3 = tuple((b["rays_o"][:, i, None] + b["rays_d"][:, i, None] * z).reshape(-1) for i in range(3))
        view3 = tuple(b["rays_d"][:, i, None].expand(B, S).reshape(-1) for i in range(3))
        rgb, sigma = state.field.apply_planar(pos3, view3, dtype=s.dtype)
        ev[3].record()
        rgb_map, _ = raw2outputs_planar(rgb.reshape(3, B, S), sigma.reshape(B, S), z, s.white_bg, s.dist_last)
        loss = torch.mean((rgb_map - b["rgb"]) ** 2)
        ev[4].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[5].record()
        state.optimizer.step()
        state.scheduler.step()
        ev[6].record()
        state.step += 1
        torch.cuda.synchronize()
        for k, name in enumerate(names):
            total[name] += ev[k].elapsed_time(ev[k + 1])
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
    phase(f"train(): {out['steps']} steps in {wall:.2f} s wall (checkpoint writes included), "
          f"PSNR first 20 steps {first:.2f} dB, last 20 {last:.2f} dB; peak device memory {peak:.2f} GiB; "
          f"launches {launches}")
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
    phase("split, ms per step (CUDA events, 32 steps, the grid update amortised over them): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f"; sum {sum(split.values()):.3f}")
    state.step = 1  # no grid update inside the traced window
    busy, traced, idle = _idle_share(state, batches[32:40])
    phase(f"profiler, 8 warm steps: device busy {busy:.2f} ms of {traced:.2f} ms traced wall: idle share {idle:.1%}")
    torch.cuda.reset_peak_memory_stats()
    step_inputs = capture_step_inputs(state, batches[40])
    phase(f"one warm step (inputs captured): peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return {"cfg": cfg, "final": final, "launches": launches, "ms_per_step": med, "step_inputs": step_inputs}


def train_dense_knob(tmp: Path, label: str) -> dict:
    """128 steps of the tuned cfg with one dense knob through
    nerfjax_torch.train.train on phase 7's NPZ: PSNR, NaNs, the five hash
    kernels' launches, K5's mode (the size of its staging in one captured
    warm step), a warm-step median; K4 and K5 timed on that step's inputs."""
    import torch

    from nerfjax_torch.data import RayDataset, batch_to_device
    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.train import TrainSettings, make_train_state, train, train_step

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

    settings = TrainSettings.from_cfg(cfg, out["steps"])
    state = make_train_state(cfg, settings, seed=SEED, device="cuda")
    data = RayDataset(cfg["rays_file"], verbose=False)
    batches = [batch_to_device(b, "cuda") for _, b in zip(range(49), data.epoch_batches(8192, seed=SEED))]
    for b in batches[:16]:
        train_step(state, b)
    torch.cuda.synchronize()
    times = []
    for b in batches[16:48]:
        t1 = time.perf_counter()
        train_step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    med = float(np.median(times))
    phase(f"warm train_step {label}: median {med:.2f} ms/step over {len(times)} steps (min {min(times):.2f}, "
          f"max {max(times):.2f}) = {8192 / med * 1e3:,.0f} rays/s")
    mode = he._dense_mode(state.field.spec, len(he._split_levels(state.field.spec)[0]))
    if mode != {"dgl1": (2, 1), "dc1": (1, 0)}[label]:
        raise AssertionError(f"{label}: the field's dense mode is {mode}")
    timings = dense_at_step_shapes(capture_step_inputs(state, batches[48]), label)
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
    and, unless ``label`` is "tuned", one of DENSE_KNOBS: the same
    parameters, batch, update jitter and sampler uniforms. The grid update
    runs first on both (the MLP products sum in another order on each
    device: grids within 1e-5 relative); the step then runs on the CPU's
    grid on both, so the samples and the k = 1 draws are the same bits."""
    import torch

    from nerfjax_torch.data import RayDataset, batch_to_device
    from nerfjax_torch.ops.occupancy import draw_update_jitter
    from nerfjax_torch.train import TrainSettings, make_train_state, train_step, update_occupancy

    cfg = {**SMALL_TRAIN, **DENSE_KNOBS.get(label, {}), "num_epochs": 1}
    settings = TrainSettings.from_cfg(cfg, 100)
    cpu = make_train_state(cfg, settings, seed=SEED, device="cpu")
    card = make_train_state(cfg, settings, seed=SEED, device="cuda")
    batch = next(RayDataset(tmp / "rays.npz", verbose=False).epoch_batches(256, seed=SEED))
    jitter = draw_update_jitter(settings.occ_spec(), torch.Generator().manual_seed(1), "cpu")
    xi = torch.rand(256, 24, generator=torch.Generator().manual_seed(2))
    update_occupancy(cpu, jitter=jitter)
    update_occupancy(card, jitter=jitter.cuda())
    gerr = float(((card.occ_grid.cpu() - cpu.occ_grid).abs() / cpu.occ_grid.abs().clamp_min(1e-30)).max())
    if gerr > 1e-5:
        raise AssertionError(f"grid update card vs cpu: {gerr}")
    card.occ_grid = cpu.occ_grid.cuda()
    cpu.step = card.step = 1
    m_cpu = train_step(cpu, batch_to_device(batch, "cpu"), xi=xi)
    m_card = train_step(card, batch_to_device(batch, "cuda"), xi=xi.cuda())
    lerr = abs(float(m_card["loss_fine"]) - float(m_cpu["loss_fine"])) / float(m_cpu["loss_fine"])
    if lerr > 1e-5:
        raise AssertionError(f"loss card vs cpu: relative {lerr}")
    worst = 0.0
    for (name, pc), pk in zip(cpu.field.named_parameters(), card.field.parameters()):
        gc, gk = pc.grad, pk.grad.cpu()
        if not torch.allclose(gk, gc, rtol=1e-4, atol=1e-4 * float(gc.abs().max())):
            raise AssertionError(f"gradient of {name} card vs cpu")
        sure = gc.abs() > 1e-6
        d = float((pk.detach().cpu() - pc.detach()).abs()[sure].max()) if bool(sure.any()) else 0.0
        if d > 1e-3 * cfg["lr"]:
            raise AssertionError(f"{name} after AdamW card vs cpu: {d}")
        worst = max(worst, d)
    phase(f"train step card vs cpu (fp32, small, {label}): grid rel err {gerr:.2g}, loss rel err {lerr:.2g}, "
          f"gradients within rtol 1e-4, parameters after AdamW within {worst:.2g} (bound {1e-3 * cfg['lr']:.1g})")


def main() -> int:
    if not (HERE / "nerfjax_torch").is_dir():
        raise SystemExit(f"chip_smoke: no nerfjax_torch/ beside {Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(HERE))
    import torch

    smi = card()
    phase(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build()
    stats = kernels_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_path = Path(tmp) / "nerf_final.pth"
        synthetic_checkpoint(ckpt_path)
        extract_launches = extract_full(ckpt_path, Path(tmp))
        card_vs_cpu_128(ckpt_path)
    hstats = hash_kernels_vs_plain()
    dense_kernels_vs_plain(hstats)
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_full(Path(tmp))
        cap = trained.pop("step_inputs")
        scatters_at_step_shapes(cap, hstats)
        for name, t in dense_at_step_shapes(cap, "tuned").items():
            hstats[name].update(t)
        del cap
        knobs = {label: train_dense_knob(Path(tmp), label) for label in DENSE_KNOBS}
        extract_trained(trained["cfg"], trained["final"])
        for label in ("tuned", *DENSE_KNOBS):
            step_card_vs_cpu(Path(tmp), label)
    phase("warm ms/step: tuned " + f"{trained['ms_per_step']:.2f}, "
          + ", ".join(f"{k} {v['ms_per_step']:.2f}" for k, v in knobs.items()))
    kernels = []
    for name, line in (("fused_ngp_head", 28), ("fused_ngp_density", 98)):
        N, E = MAIN_SHAPE[0], MAIN_SHAPE[1]
        macs = E * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 3 if name == "fused_ngp_head" else E * 64 + 64
        nbytes = (2 * E + 2 * 16 + 2 * 4) * N if name == "fused_ngp_head" else (2 * E + 2) * N
        bound, by = _bound(nbytes + 4 * 9408, 2 * macs * N, "bf16")
        kernels.append({
            "name": name, "route": "cuda", "source": "nerfjax_torch/csrc/fused_mlp.cu",
            "replaces": f"nerfjax/ops/pallas_mlp.py:{line}", "launches": extract_launches[name],
            "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
            "plain_ms": stats[name]["plain_ms"], "bound_ms": bound, "bound_by": by, "library_ms": None,
        })
    for name, replaces in (("hash_levels_fwd", "nerfjax/ops/hash_encode.py:304"),
                           ("hash_levels_bwd", "nerfjax/ops/hash_encode.py:335"),
                           ("table_grad_scatter", "benchmarks/micro_onehot.py:99"),
                           ("dense_levels_fwd", "benchmarks/micro_pallas_gather.py:97"),
                           ("dense_levels_bwd", "benchmarks/micro_pallas_gather.py:71")):
        h = hstats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "nerfjax_torch/csrc/hash_encode.cu", "replaces": replaces,
            "launches": trained["launches"][name], "max_abs_err": h["max_abs_err"], "ms": h["ms"],
            "plain_ms": h["plain_ms"], "bound_ms": h["bound"][0], "bound_by": h["bound"][1],
            "library_ms": h.get("library_ms"),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
