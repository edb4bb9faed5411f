#!/usr/bin/env python3
"""Smoke run of nerfjax_torch on one CUDA card: the extraction path,
checkpoint -> 512^3 volume.pth, at the full width of the tuned model.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero before the
final line:

  1. the card (nvidia-smi name and power limit); no CUDA -> exit 1;
  2. build the CUDA kernels from nerfjax_torch/csrc with nvcc (ptxas report);
  3. each kernel against its plain PyTorch version at the extraction's
     shapes (N = 524,288 and 1,000,003; E = 24 and 32; bf16 and f32), with
     per-call times;
  4. a synthetic NGP-large checkpoint (seeded sphere field, written with
     nerfjax_torch.checkpoint.save_field_params) ->
     nerfjax_torch.extract.extract_volume at 512^3 on the card ->
     save_volume -> load_volume; checks the volume and that both kernels
     launched;
  5. the same extraction at 128^3 in float32 on the card (kernels) and on
     the CPU (plain versions), held to the CPU parity tests' rule.

The last two lines are a JSON object with each kernel's launches, error and
times, then {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

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
    from nerfjax_torch.ops import fused_mlp

    info = _build.build("fused_mlp")
    phase(f"built {info['path'].name} in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())
    fused_mlp._lib()


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


def _time_ms(fn, iters: int = 20) -> float:
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
                p1, k1, k2, p2 = _time_ms(plain), _time_ms(kern), _time_ms(kern), _time_ms(plain)
                stats[name]["ms"] = (k1 + k2) / 2
                stats[name]["plain_ms"] = (p1 + p2) / 2
                line += (f"\n  {name}: kernel {stats[name]['ms'] * 1e3:.1f} us, plain "
                         f"{stats[name]['plain_ms'] * 1e3:.1f} us per call (runs p,k,k,p: "
                         f"{p1 * 1e3:.1f}, {k1 * 1e3:.1f}, {k2 * 1e3:.1f}, {p2 * 1e3:.1f})")
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

    res = 512
    cfg = {**TUNED_CFG, "checkpoint": str(ckpt_path), "volume_resolution": res}
    warm = extract_volume(cfg, device="cuda", verbose=False)  # first use: allocator, cuBLAS
    phase(f"{res}^3 warm-up run: " + _phases(warm["metadata"]))
    del warm
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    vol = extract_volume(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = dict(fm.launch_counts)
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
        launches = extract_full(ckpt_path, Path(tmp))
        card_vs_cpu_128(ckpt_path)
    kernels = []
    for name, line in (("fused_ngp_head", 28), ("fused_ngp_density", 98)):
        kernels.append({
            "name": name, "route": "cuda", "source": "nerfjax_torch/csrc/fused_mlp.cu",
            "replaces": f"nerfjax/ops/pallas_mlp.py:{line}", "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
            "plain_ms": stats[name]["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
