"""GUI logic of the port (counterpart of ``nerfjax/gui/logic.py``): config
round trip, the pipeline's commands and the loop that runs them, volume
loading and the viewer's slicing. No widget toolkit is imported here, so the
tests and ``chip_smoke.py`` drive the same code the GUI runs.

  * ``generate_config_dict`` / ``values_from_config``: the full scene-config
    schema the config creator round-trips;
  * ``PIPELINE_STEPS`` / ``build_pipeline_commands``: the nine CLIs of the
    port in the pipeline's order, each run as ``python -m
    nerfjax_torch.cli.<tool> --cfg_path <cfg>`` (on the card by default);
  * ``run_commands``: the launcher's loop (``FinalGui._run_commands``);
  * ``load_volume_any``: both volume formats (``volume.pth``,
    ``volume_sliced.pth``) as points and colours;
  * ``slice_z`` / ``clip_aabb_band`` / ``aabb_band_from_transforms``: the
    viewer's z band and the scene's AABB band.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from typing import Callable

import numpy as np

from nerfjax_torch.checkpoint import load_pth


def generate_config_dict(values: dict) -> dict:
    """Build the full scene-config dict from GUI field values, with the same
    key set (and defaults) as the reference's config creator."""
    scene = values.get("scene_name", "my_scene")
    cfg = {
        "scene_name": scene,
        "output_dir": values.get("output_dir", "./outputs/${scene_name}"),
        "checkpoint_dir": values.get("checkpoint_dir", "${output_dir}/checkpoints"),
        "transforms_json": values.get("transforms_json", "transforms_${scene_name}.json"),
        "rays_file": values.get("rays_file", "${scene_name}_ray_data.npz"),
        "volume_resolution": int(values.get("volume_resolution", 512)),
        "remove_below_aabb": bool(values.get("remove_below_aabb", True)),
        "remove_upper_aabb": bool(values.get("remove_upper_aabb", True)),
        "visualize": bool(values.get("visualize", False)),
        "workspace": values.get("workspace", "data/${scene_name}"),
        "image_dir": values.get("image_dir", "${workspace}/images"),
        "image_dir_resize": values.get("image_dir_resize", "${workspace}/images_resized"),
        "tmp_image_dir": values.get("tmp_image_dir", "${workspace}/images_resized"),
        "resize_images": bool(values.get("resize_images", False)),
        "newSize": list(values.get("newSize", [512, 512])),
        "shift": list(values.get("shift", [0, 0, 0])),
        "scale": float(values.get("scale", 0.9)),
        "target_retention": float(values.get("target_retention", 0.95)),
        "outlier_nb_neighbors": int(values.get("outlier_nb_neighbors", 20)),
        "outlier_std_ratio": float(values.get("outlier_std_ratio", 2.0)),
        "percentile_bbox": {
            "lower": float(values.get("pb_lower", 1.0)),
            "upper": float(values.get("pb_upper", 99.0)),
            "padding": float(values.get("pb_padding", 0.05)),
        },
        "aabb_adjust": {
            "aabb_min": list(values.get("aabb_adjust_min", [0, 0, 0])),
            "aabb_max": list(values.get("aabb_adjust_max", [0, 0, 0])),
        },
        "checkpoint": values.get("checkpoint", "${checkpoint_dir}/nerf_final.pth"),
        "volume_output_path": values.get("volume_output_path", "${output_dir}/volume.pth"),
        "aabb_slice": bool(values.get("aabb_slice", True)),
        "sliced_vol_path": values.get("sliced_vol_path", "${output_dir}/volume_sliced.pth"),
        "colmap_dir": values.get("colmap_dir", "./data/${scene_name}"),
        "batch_size": int(values.get("batch_size", 4096)),
        "num_epochs": int(values.get("num_epochs", 1)),
        "lr": float(values.get("lr", 0.0005)),
        "ngp": bool(values.get("ngp", True)),
        "nerf_type": values.get("nerf_type", "large"),
        "hidden_dim": int(values.get("hidden_dim", 256)),
        "pos_L": int(values.get("pos_L", 10)),
        "dir_L": int(values.get("dir_L", 4)),
        "N_samples": int(values.get("N_samples", 64)),
        "N_importance": int(values.get("N_importance", 128)),
        "white_bg": bool(values.get("white_bg", False)),
        "chunk_size": int(values.get("chunk_size", 32768)),
        "use_memmap": bool(values.get("use_memmap", False)),
    }
    # Optional keys: included only when set, so a YAML that omits them
    # (e.g. one written by the reference's own creator, which comments out
    # the rotation block) round-trips without gaining keys.
    for key, cast in (
        ("rotation", bool),
        ("rotation_initial", lambda v: v),
        ("rot_order", list),
        ("angles", list),
        ("normalization_method", str),
        ("radius_filter", bool),
        ("radius_radius", float),
        ("radius_nb_points", int),
        ("occupancy_grid", bool),
        ("occ_resolution", int),
        ("occ_update_every", int),
        ("precision", str),
        ("hash_grad_corners", int),
        ("hash_fwd_corners", int),
        ("hash_n_levels", int),
        ("hash_extra_dense_levels", int),
        ("single_pass", bool),
        ("shard_hash_table", bool),
        ("dist_last", float),
        ("grad_clip", float),
    ):
        if key in values and values[key] is not None:
            cfg[key] = cast(values[key])
        elif key in values:  # explicit null (rotation_initial: None)
            cfg[key] = None
    return cfg


def values_from_config(cfg: dict) -> dict:
    """Inverse of generate_config_dict: flatten a loaded scene YAML (any
    superset of the reference schema, e.g. one written by the reference's
    own config creator, final_gui.py:1127-1184) into the flat GUI value
    dict. Nested percentile_bbox/aabb_adjust map to pb_*/aabb_adjust_*.
    ${} interpolations stay raw (unresolved) so the round-trip is lossless."""
    if hasattr(cfg, "to_dict"):
        cfg = cfg.to_dict(resolve=False)
    values = dict(cfg)
    pb = cfg.get("percentile_bbox", {}) or {}
    for k in ("lower", "upper", "padding"):
        if k in pb:
            values[f"pb_{k}"] = pb[k]
    values.pop("percentile_bbox", None)
    aj = cfg.get("aabb_adjust", {}) or {}
    if "aabb_min" in aj:
        values["aabb_adjust_min"] = list(aj["aabb_min"])
    if "aabb_max" in aj:
        values["aabb_adjust_max"] = list(aj["aabb_max"])
    values.pop("aabb_adjust", None)
    return values


def aabb_band_from_transforms(path: str | Path) -> dict:
    """Read the viewer's AABB clip band straight from a transforms JSON
    (reference final_gui.py:359-361 reads scene_aabb.aabb_remove_below/above)."""
    import json

    with open(path) as f:
        data = json.load(f)
    sa = data.get("scene_aabb", {}) or {}
    return {
        "aabb_remove_below": float(sa.get("aabb_remove_below", -1.0)),
        "aabb_remove_above": float(sa.get("aabb_remove_above", 1.0)),
        "aabb_min": sa.get("aabb_min", [-1.0, -1.0, -1.0]),
        "aabb_max": sa.get("aabb_max", [1.0, 1.0, 1.0]),
    }


PIPELINE_STEPS = [
    ("Resize images", "nerfjax_torch.cli.resize_images"),
    ("Run COLMAP", "nerfjax_torch.cli.run_colmap"),
    ("Transform COLMAP", "nerfjax_torch.cli.transform_colmap"),
    ("COLMAP -> NeRF", "nerfjax_torch.cli.colmap2nerf"),
    ("Precompute rays", "nerfjax_torch.cli.precompute_rays"),
    ("Train", "nerfjax_torch.cli.train"),
    ("Extract volume", "nerfjax_torch.cli.extract_vol"),
    ("Post-process volume", "nerfjax_torch.cli.post_process_vol"),
    ("Write formats", "nerfjax_torch.cli.write_format"),
]


def build_pipeline_commands(cfg_path: str, selected: list[bool]) -> list[list[str]]:
    """Commands for the checked pipeline steps, in the pipeline's order."""
    cmds = []
    for (_, module), on in zip(PIPELINE_STEPS, selected):
        if on:
            cmds.append([sys.executable, "-m", module, "--cfg_path", str(cfg_path)])
    return cmds


def run_commands(cmds: list[list[str]], log: Callable[[str], None]) -> bool:
    """Run ``cmds`` in turn, each with its standard output and error merged
    and handed to ``log`` line by line as it comes; stop at the first that
    exits non-zero. True when every command exited 0."""
    for cmd in cmds:
        log("$ " + " ".join(cmd))
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            log(line.rstrip())
        if proc.wait() != 0:
            log(f"Step FAILED (exit {proc.returncode}); stopping chain.")
            return False
    log("All selected steps completed.")
    return True


def load_volume_any(path: str | Path) -> tuple[np.ndarray, np.ndarray, dict | None]:
    """Load either volume format into (points [-1,1], rgbs [0,1], aabb_meta).

    Accepts volume.pth (dense occupancy+rgb grids) and volume_sliced.pth
    (point list), written by either package."""
    # mmap=True: volume.pth at 512^3 is ~0.5 GB; everything below only reads
    data = load_pth(path, mmap=True)
    if "points_normalized" in data:
        pts = np.asarray(data["points_normalized"], np.float32)
        rgbs = np.asarray(data["rgbs"], np.float32)
        if rgbs.size and rgbs.max() > 1.0:
            rgbs = rgbs / 255.0
        return pts, rgbs, data.get("aabb_meta")
    if "occupancy_volume" in data:
        from nerfjax_torch.postprocess import volume_to_points

        # sparse-fetched volumes zero unoccupied RGB; the recorded global
        # max keeps the normalizer identical to a dense fetch
        pts, rgbs = volume_to_points(
            data["occupancy_volume"],
            data["rgb_volume"],
            data.get("metadata", {}).get("rgb_global_max"),
        )
        return pts.astype(np.float32), rgbs.astype(np.float32), None
    raise ValueError(f"Unrecognized volume file format: {path}")


def slice_z(points: np.ndarray, rgbs: np.ndarray, z_min: float, z_max: float):
    """The points with z_min <= z <= z_max (the viewer's z band)."""
    m = (points[:, 2] >= z_min) & (points[:, 2] <= z_max)
    return points[m], rgbs[m]


def clip_aabb_band(points: np.ndarray, rgbs: np.ndarray, aabb_meta: dict):
    """Clip to the scene's aabb_remove_below/above band."""
    lo = float(aabb_meta.get("aabb_remove_below", -1.0))
    hi = float(aabb_meta.get("aabb_remove_above", 1.0))
    return slice_z(points, rgbs, lo, hi)
