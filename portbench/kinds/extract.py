"""Extraction traffic: ``extract.extract_volume`` at the workload's
resolution (hierarchical, sparse fetch: the defaults), volume after
volume, on a field that holds a seeded sphere; each volume comes back to
the host as the function returns it.

The check compares one volume of the window, drawn from the seed, with the
reference's extraction of the same weights (``numbers``; the cell's limits
file names the ones it compares)."""

from __future__ import annotations

import gc
import time

import torch

from portbench import faults
from portbench import traffic as gen
from portbench.reference.extract import extract as ref_extract
from portbench.reference.precision import no_tf32

# The CPU tests' sizes, and the faults the check has to catch (the tests and calibrate.py plant them).
TINY = {"cfg": {"nerf_type": "small", "hash_n_levels": 8}, "traffic": {"resolution": 128}}
FAULTS = [faults.altered_volume, faults.dropped_voxels]


def setup(run) -> None:
    from nerfjax_torch import _build
    from nerfjax_torch.extract import extract_volume

    cfg, tr, dev = run.cfg, run.traffic, run.device
    if dev.type == "cuda":
        _build.build_all(("hash_encode", "fused_mlp"))
        _build.load("hash_encode")
        _build.load("fused_mlp")
    run.mark("extensions")
    params = gen.sphere_field(cfg, run.seed, tr["field"], dev)
    run.mark("data")
    res = int(tr["resolution"])

    def volume() -> dict:
        return extract_volume(cfg, params={"model": params}, resolution=res, device=dev, dtype=torch.bfloat16,
                              verbose=False)

    run.mark("program")
    volume()
    run.mark("warmup")
    run.extra.update(volume=volume, params=params, metadata=[], kept=None, rng=gen.host_rng(run.seed, 5))


def window(run, seconds: float) -> None:
    x = run.extra
    n, ends = 0, []
    t0 = time.perf_counter()
    while True:
        with run.spans.span("volume"):
            vol = x["volume"]()
        n += 1
        x["metadata"].append(vol["metadata"])
        if x["rng"].random() * len(x["metadata"]) < 1.0:  # one volume of the run, drawn uniformly
            x["kept"] = vol
        run.attempted += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    t = ends[-1] - t0
    run.extra["unit_ends"] = (t0, ends)
    run.units.update(volumes=n, window_s=t)
    run.e2e["extract_s"] = t / n


def numbers(prog: dict, refr: dict) -> dict:
    """Every number an extraction cell can compare (its limits file names
    those it does): rgb_gap, the largest color gap in uint8 levels over the
    voxels both call occupied; sigma_mean_gap / sigma_std_gap, the relative
    gaps of the sigma volume's mean and spread (the program's
    ``density_stats``); occupancy_gap, the share of voxels whose occupancy
    differs over the reference's occupied ones, and threshold_gap, Otsu's
    threshold's relative gap (both move with the threshold's 256-bin
    quantization; see PERF.md)."""
    occ_p, occ_r = prog["occupancy"], refr["occupancy"]
    both = (occ_p > 0) & (occ_r > 0)
    rgb_gap = (prog["rgb"].to(torch.int16) - refr["rgb"].to(torch.int16)).abs().amax(dim=1)
    return {"rgb_gap": float(rgb_gap[both].max()) if bool(both.any()) else 255.0,
            "sigma_mean_gap": abs(prog["stats"]["mean"] - refr["stats"]["mean"]) / abs(refr["stats"]["mean"]),
            "sigma_std_gap": abs(prog["stats"]["std"] - refr["stats"]["std"]) / abs(refr["stats"]["std"]),
            "occupancy_gap": float((occ_p != occ_r).sum()) / max(1.0, float(occ_r.sum())),
            "threshold_gap": abs(prog["threshold"] - refr["threshold"]) / abs(refr["threshold"])}


def check(run) -> None:
    x, dev = run.extra, run.device
    res = int(run.traffic["resolution"])
    kept = x.pop("kept")
    x.pop("volume", None)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    refr = ref_extract(run.cfg, x["params"], res, prec="f32")
    if run.mode == "program":
        prog = {"occupancy": torch.from_numpy(kept["occupancy_volume"]).to(dev).reshape(-1),
                "rgb": torch.from_numpy(kept["rgb_volume"]).to(dev).reshape(-1, 3),
                "threshold": float(kept["metadata"]["threshold"]), "stats": kept["metadata"]["density_stats"]}
    else:
        prog = ref_extract(run.cfg, x["params"], res, prec="fp8")
    values = numbers(prog, refr)
    run.extra["notes"] = {"numbers": values}
    run.checks += [(name, value, float(run.limits[name])) for name, value in values.items() if name in run.limits]
