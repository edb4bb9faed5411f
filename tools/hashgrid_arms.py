#!/usr/bin/env python3
"""The design arms of the feature-last encode's kernels (hashgrid_fwd,
hashgrid_bwd), timed on one CUDA card in sets of runs (p, k, k, p;
chip_smoke._time_kernel, device time from profiler traces) on the inputs
the port's paths give them. Run from the repository's root:

    python3 tools/hashgrid_arms.py [--quick]

Forward ([N, 3] -> [N, 2L] f32), every arm torch.equal to
hashgrid_encode_plain at every input; p is the first design, each k one of
the others (the pack in front counted in their times):

  first  one thread per (point, level), level innermost, both planes read
         in place: 16 4-byte loads a (point, level)
  pack   the same threads on the float2-pair table (pack_pairs in front)
  tile   the pack, then a block of 64 points x all levels whose warps' lanes
         are 32 points at one level, rows written whole from shared memory
         (the shipped kernel; hashgrid_fwd, the wrapper, is timed beside)
  pairs  the tile, x-neighbour corners served by one 16-byte load where
         they share one

Backward (the table gradient), each arm within the atomic-order bound of
hashgrid_bwd_plain; p is the first design (the terms staged per (level,
corner, point), then K3), k one of: in_place (the fused kernel reading g
[N, 2L] in place) or transposed (g first transposed to [L, N] float2: the
shipped hashgrid_bwd). Beside them, the memory each call allocates.

Inputs: R1's seeded positions (chip_smoke._hashgrid_x01, N = 786,432) at
the medium (16 levels) and tuned (12) specs; the fine pass of one drop-in
render_rays(train=True) (N = 1,572,864) on a field that train() trained
for one epoch of 128 steps on chip_smoke's NPZ; the fine pass of one
quality eval (4,096 rays x 192 = 786,432 points) of spass2 seed 0 trained
600 steps (chip_smoke's protocol). --quick checks every arm at 100,003
seeded points of the small spec and of the medium one and stops.

The arms that the shipped source does not keep are in
tools/hashgrid_arms.cu, built here with the shipped source's flags. One
line per timing, then a summary line per kernel, then the last line: one
JSON object of every timing. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

FWD_ARMS = ("first", "pack", "tile", "pairs")


@functools.cache
def _arms_lib() -> ctypes.CDLL:
    from nerfjax_torch import _build

    out = _build.BUILD_DIR / "libhashgrid_arms.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build._flags("hash_encode"), "-I", str(_build.CSRC), "-o", str(out),
           str(ROOT / "tools" / "hashgrid_arms.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build tools/hashgrid_arms.cu:\n{proc.stderr}{proc.stdout}")
    cs.phase(f"built {out.name} in {time.perf_counter() - t0:.1f} s")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())
    lib = ctypes.CDLL(str(out))
    vp, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
    lib.arms_fwd.argtypes = [i32, vp, vp, i64, vp, i64, i32, vp, vp, vp, vp, u32, vp, vp]
    lib.arms_stage.argtypes = [vp, vp, i64, i32, vp, vp, vp, vp, u32, vp, vp, vp, vp]
    lib.arms_bwd_inplace.argtypes = [vp, vp, i64, i32, vp, vp, vp, vp, u32, i64, vp, vp, vp]
    for fn in (lib.arms_fwd, lib.arms_stage, lib.arms_bwd_inplace):
        fn.restype = i32
    return lib


def _levels(spec):
    from nerfjax_torch.ops import hash_encode as he

    scales, offsets, res, hashed, mask = he._grid_arrays(spec)
    return (scales.ctypes.data, offsets.ctypes.data, res.ctypes.data, hashed.ctypes.data, mask), \
        (scales, offsets, res, hashed)


def fwd_arm(arm: str, spec, planes, x01):
    """The forward by one arm -> [N, 2L] f32 (the pack in front for every
    arm but the first)."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    N, L = x01.shape[0], spec.n_levels
    out = torch.empty(N, 2 * L, device=x01.device)
    pairs = planes if arm == "first" else he.pack_pairs(planes, f32=True)
    args, keep = _levels(spec)
    err = _arms_lib().arms_fwd(FWD_ARMS.index(arm), planes.data_ptr(), pairs.data_ptr(), planes.shape[1],
                               x01.data_ptr(), N, L, *args, out.data_ptr(), he._stream(x01))
    he._raise_if_failed(f"arms_fwd {arm}", err)
    del keep
    return out


def bwd_first(spec, g, x01, out):
    """The first design's backward: the staging kernel, then K3 into out."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    N, L = x01.shape[0], spec.n_levels
    K = L * 8 * N
    idx = torch.empty(K, dtype=torch.int32, device=x01.device)
    v0, v1 = torch.empty(K, device=x01.device), torch.empty(K, device=x01.device)
    args, keep = _levels(spec)
    err = _arms_lib().arms_stage(g.data_ptr(), x01.data_ptr(), N, L, *args, idx.data_ptr(), v0.data_ptr(),
                                 v1.data_ptr(), he._stream(x01))
    he._raise_if_failed("arms_stage", err)
    del keep
    return he.table_grad_scatter(idx, v0, v1, out)


def bwd_in_place(spec, g, x01, out):
    """The fused backward reading g [N, 2L] in place."""
    import torch

    from nerfjax_torch.ops import hash_encode as he

    N, L, total = x01.shape[0], spec.n_levels, spec.total_table_size
    scratch = torch.zeros(total, 2, device=x01.device)
    args, keep = _levels(spec)
    err = _arms_lib().arms_bwd_inplace(g.data_ptr(), x01.data_ptr(), N, L, *args, total, out.data_ptr(),
                                       scratch.data_ptr(), he._stream(x01))
    he._raise_if_failed("arms_bwd_inplace", err)
    del keep
    return out


def check_fwd(spec, planes, x01, label: str) -> None:
    import torch

    from nerfjax_torch.ops import hash_encode as he

    ref = he.hashgrid_encode_plain(spec, planes, x01)
    for arm in FWD_ARMS:
        if not torch.equal(fwd_arm(arm, spec, planes, x01), ref):
            raise AssertionError(f"forward arm {arm} ({label}) != plain")
    if not torch.equal(he.hashgrid_fwd(spec, planes, x01), ref):
        raise AssertionError(f"hashgrid_fwd ({label}) != plain")
    cs.phase(f"{label}: every forward arm and hashgrid_fwd torch.equal to plain")


def check_bwd(spec, g, x01, label: str) -> None:
    import torch

    from nerfjax_torch.ops import hash_encode as he

    total = spec.total_table_size
    idx, v0, v1 = he.hashgrid_bwd_entries_plain(spec, g, x01)
    one = torch.ones_like(v0)
    ref = he.table_grad_scatter_plain(idx, v0, v1, cs._zeros2(total))
    mass = he.table_grad_scatter_plain(idx, v0.abs(), v1.abs(), cs._zeros2(total))
    count = he.table_grad_scatter_plain(idx, one, one, cs._zeros2(total))
    errs = {name: cs._check_scatter(f"{name} ({label})", fn(spec, g, x01, cs._zeros2(total)), ref, mass, count)
            for name, fn in (("first", bwd_first), ("in_place", bwd_in_place), ("transposed", he.hashgrid_bwd))}
    cs.phase(f"{label}: every backward arm within the atomic-order bound, max |err| "
             + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))


def time_fwd(spec, planes, x01, label: str) -> dict:
    from nerfjax_torch.ops import hash_encode as he

    bound, gathers = cs._hashgrid_bounds(spec, x01)
    first = lambda: fwd_arm("first", spec, planes, x01)  # noqa: E731
    out = {}
    for arm in FWD_ARMS[1:]:
        t = cs._time_kernel(lambda a=arm: fwd_arm(a, spec, planes, x01), first, None, bound)
        out[arm] = {"ms": t["ms"], "first_ms": t["plain_ms"], "sets": t["sets"]}
        cs.phase(f"  forward {label}, {arm} (k) against first (p): " + cs._timing_line(t).replace("plain", "first"))
    t = cs._time_kernel(lambda: he.hashgrid_fwd(spec, planes, x01), first, None, bound)
    out["shipped"] = {"ms": t["ms"], "first_ms": t["plain_ms"], "sets": t["sets"]}
    cs.phase(f"  forward {label}, hashgrid_fwd (k) against first (p): " + cs._timing_line(t).replace("plain", "first"))
    out.update(N=x01.shape[0], levels=spec.n_levels, bound_ms=bound[0], gathers_bound_ms=gathers[0])
    return out


def time_bwd(spec, g, x01, label: str) -> dict:
    import torch

    from nerfjax_torch.ops import hash_encode as he

    buf = cs._zeros2(spec.total_table_size)
    first = lambda: bwd_first(spec, g, x01, buf)  # noqa: E731
    out = {"first": {}}
    for name, fn in (("in_place", bwd_in_place), ("transposed", he.hashgrid_bwd)):
        t = cs._time_kernel(lambda f=fn: f(spec, g, x01, buf), first, None, None)
        out[name] = {"ms": t["ms"], "first_ms": t["plain_ms"], "sets": t["sets"]}
        cs.phase(f"  backward {label}, {name} (k) against first (p): " + cs._timing_line(t).replace("plain", "first"))
    for name, fn in (("first", bwd_first), ("in_place", bwd_in_place), ("transposed", he.hashgrid_bwd)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(spec, g, x01, buf)
        torch.cuda.synchronize()
        out[name]["extra_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    cs.phase(f"  backward {label}: memory the call allocates, GiB: "
             + ", ".join(f"{k} {v['extra_gib']:.3f}" for k, v in out.items()))
    out["N"] = x01.shape[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="check every arm at a small size and stop")
    args = ap.parse_args()
    import torch

    from nerfjax_torch.checkpoint import load_field
    from nerfjax_torch.data import RayDataset, batch_to_device
    from nerfjax_torch.ops import hash_encode as he
    from nerfjax_torch.render import render_rays
    from nerfjax_torch.train import build_fields, train

    smi = cs.card()
    cs.build()
    _arms_lib()
    rng = np.random.default_rng(cs.SEED + 18)
    results = {"card": smi, "fwd": {}, "bwd": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        specs = {"medium16": build_fields(cs.parity_cfg("spass2", tmp / "r.npz", tmp / "r"))[1].spec,
                 "tuned12ed1": build_fields(cs.TUNED_CFG)[1].spec}
        if args.quick:
            specs["small6"] = build_fields(cs.R_SMALL)[1].spec
            for label in ("small6", "medium16"):
                spec = specs[label]
                planes = cs._rand((2, spec.total_table_size), rng)
                x01 = cs._hashgrid_x01(100_003, rng)
                check_fwd(spec, planes, x01, f"{label} N=100,003")
                g = cs._rand((100_003, 2 * spec.n_levels), rng)
                g[: 100_003 // 2] = 0.0  # warps whose g are all 0
                check_bwd(spec, g, x01, f"{label} N=100,003")
            cs.phase("--quick: done")
            return 0
        inputs = {}
        for label, spec in specs.items():
            inputs[f"R1 {label}"] = (spec, cs._rand((2, spec.total_table_size), rng), cs._hashgrid_x01(cs.R_EVAL_N, rng))
        # the drop-in field trained one epoch, then one render_rays(train=True) pass and its backward, recorded
        cs.ray_npz(tmp / "rays.npz")
        cfg = {**cs.DROP_IN_TRAIN, "num_epochs": 1, "rays_file": str(tmp / "rays.npz"),
               "output_dir": str(tmp / "dropin"), "checkpoint_dir": str(tmp / "dropin" / "ck")}
        t0 = time.perf_counter()
        train(cfg, seed=cs.SEED, log_every=10**6, device="cuda")
        field = load_field(Path(cfg["checkpoint_dir"]) / "nerf_final.pth", cfg, device="cuda")
        field.requires_grad_(True)
        batch = batch_to_device(next(RayDataset(tmp / "rays.npz", verbose=False).epoch_batches(8192, seed=cs.SEED)),
                                "cuda")
        with cs._recording(he, ("hashgrid_fwd", "hashgrid_bwd")) as seen:
            res = render_rays(field, field, batch["rays_o"], batch["rays_d"], batch["t_near"], batch["t_far"], 64, 128,
                              train=True, generator=torch.Generator(device="cuda").manual_seed(cs.SEED))
            (torch.mean((res["rgb_fine"] - batch["rgb"]) ** 2)
             + torch.mean((res["rgb_coarse"] - batch["rgb"]) ** 2)).backward()
        spec, planes, x01 = max(seen["hashgrid_fwd"], key=lambda a: a[2].shape[0])
        inputs["drop-in fine pass"] = (spec, planes.detach(), x01)
        _, g_fine, x01_fine, _ = max(seen["hashgrid_bwd"], key=lambda a: a[2].shape[0])
        del seen, res, batch
        cs.phase(f"drop-in field trained and its render pass recorded in {time.perf_counter() - t0:.1f} s")
        # one quality run (spass2 seed 0) and its eval's fine pass
        t0 = time.perf_counter()
        syn = cs._synthetic_module()
        eval_data = syn.make_ray_npz(tmp / "eval.npz", n_rays=cs.PARITY_EVAL_RAYS, seed=cs.PARITY_EVAL_SEED,
                                     scene="sphere")
        syn.make_ray_npz(tmp / "q.npz", n_rays=cs.PARITY_BATCH * cs.PARITY_STEPS_PER_EPOCH, seed=0, scene="sphere")
        qcfg = cs.parity_cfg("spass2", tmp / "q.npz", tmp / "q")
        train(qcfg, seed=0, log_every=cs.PARITY_STEPS, device="cuda")
        ev = cs._parity_eval_psnr(Path(qcfg["checkpoint_dir"]) / "nerf_final.pth", qcfg, eval_data, record=True)
        inputs["quality eval fine pass"] = max(ev["fwd_calls"], key=lambda a: a[2].shape[0])
        cs.phase(f"spass2 seed 0 trained and evaluated (PSNR {ev['psnr']:.3f} dB) in {time.perf_counter() - t0:.1f} s")

        for label, (spec, planes, x01) in inputs.items():
            check_fwd(spec, planes, x01, label)
            results["fwd"][label] = time_fwd(spec, planes, x01, label)
        spec = inputs["drop-in fine pass"][0]
        check_bwd(spec, g_fine, x01_fine, "drop-in fine pass")
        results["bwd"]["drop-in fine pass"] = time_bwd(spec, g_fine, x01_fine, "drop-in fine pass")
    cs.phase(f"{smi}: forward, us (first -> pack, tile, pairs; shipped): " + "; ".join(
        f"{label} {r['pack']['first_ms'] * 1e3:.1f} -> {r['pack']['ms'] * 1e3:.1f}, {r['tile']['ms'] * 1e3:.1f}, "
        f"{r['pairs']['ms'] * 1e3:.1f}; {r['shipped']['ms'] * 1e3:.1f}" for label, r in results["fwd"].items()))
    r = results["bwd"]["drop-in fine pass"]
    cs.phase(f"{smi}: backward at the drop-in fine pass, us: first {r['in_place']['first_ms'] * 1e3:.1f}, in_place "
             f"{r['in_place']['ms'] * 1e3:.1f}, transposed (shipped) {r['transposed']['ms'] * 1e3:.1f}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
