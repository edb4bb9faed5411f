"""COLMAP -> NeRF scene conversion: poses, coordinate flips, scene AABB,
transforms JSON; the port's copy of ``nerfjax/colmap/convert.py``, whose
JSON it writes byte for byte (``tests/test_torch_colmap.py``). The outlier
filters run on the ``device`` that ``colmap_to_nerf`` is given (the card
unless the caller asks for the CPU).

Covers both reference pipelines behind one entry point:
  * mode="auto"  — the canonical corrected pipeline: auto-rotate so the mean
    camera forward (-Z of c2w) aligns with world -Z, then the OpenCV->OpenGL
    flip, validation pass, AABB (reference: colmap2nerf_corrected.py:938-1010).
  * mode="euler" — the normalize_with_aabb variant: flip first, then config
    Euler rotations (angles/rot_order/rotation_initial), plus near/far bounds
    (reference: normalize_with_aabb.py:800-907).

The output transforms_<scene>.json follows the exact schema of SURVEY.md §7.3.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from nerfjax_torch.colmap.model_io import read_cameras_txt, read_images_txt, read_points3d_txt
from nerfjax_torch.colmap.normalize import (
    compute_near_far_bounds,
    normalize_with_reference_fallback,
    scene_normalization,
)
from nerfjax_torch.colmap.outliers import filter_radius_outliers, filter_stats, reset_filter_stats
from nerfjax_torch.colmap.quaternion import (
    quat_to_matrix,
    rotation_between_vectors,
    rotation_x,
    rotation_y,
    rotation_z,
)


# ---------------------------------------------------------------------------
# Pose loading
# ---------------------------------------------------------------------------


def poses_to_frames(
    poses: list[dict],
    image_dir: str | Path,
    scale: float | None = None,
    center: np.ndarray | None = None,
) -> list[dict]:
    """COLMAP w2c records -> c2w frames with normalized translations
    (reference: colmap2nerf_corrected.py:321-372)."""
    frames = []
    for p in poses:
        R_w2c = quat_to_matrix(p["quat"])
        w2c = np.eye(4)
        w2c[:3, :3] = R_w2c
        w2c[:3, 3] = p["trans"]
        c2w = np.linalg.inv(w2c)
        if scale is not None and center is not None:
            c2w[:3, 3] = scale * (c2w[:3, 3] - center)
        frames.append(
            {
                "file_path": str(Path(image_dir) / p["image_name"]),
                "transform_matrix": c2w.tolist(),
            }
        )
    return frames


# ---------------------------------------------------------------------------
# World transforms
# ---------------------------------------------------------------------------


def compute_mean_forward_direction(frames: list[dict]) -> np.ndarray:
    """Mean camera forward = mean of -Z axes of c2w
    (reference: colmap2nerf_corrected.py:539-547)."""
    fwd = np.array([-np.array(f["transform_matrix"])[:3, 2] for f in frames])
    m = fwd.mean(axis=0)
    return m / np.linalg.norm(m)


def apply_world_rotation(frames, points, R_align):
    """T <- R4x4 @ T, pts <- pts @ R^T (reference: colmap2nerf_corrected.py:583-601)."""
    R4 = np.eye(4)
    R4[:3, :3] = R_align
    new_frames = [
        {**f, "transform_matrix": (R4 @ np.array(f["transform_matrix"])).tolist()}
        for f in frames
    ]
    return new_frames, points @ np.asarray(R_align).T


def flip_colmap_to_nerf(points, frames, shift=(0, 0, 0)):
    """OpenCV -> OpenGL flip: T' = F T F^T, t' = F t + shift
    (reference: colmap2nerf_corrected.py:604-627)."""
    F = np.diag([1.0, -1.0, -1.0])
    shift = np.asarray(shift, np.float64)
    points_t = points @ F.T + shift
    new_frames = []
    for f in frames:
        T = np.array(f["transform_matrix"])
        Tn = np.eye(4)
        Tn[:3, :3] = F @ T[:3, :3] @ F.T
        Tn[:3, 3] = F @ T[:3, 3] + shift
        new_frames.append({**f, "transform_matrix": Tn.tolist()})
    return points_t, new_frames


def euler_world_rotation(angles, rot_order, rotation_initial=None) -> np.ndarray:
    """Composite rotation from config Euler angles applied in rot_order
    (reference: normalize_with_aabb.py:242-264)."""
    funcs = [
        rotation_x(np.radians(angles[0])),
        rotation_y(np.radians(angles[1])),
        rotation_z(np.radians(angles[2])),
    ]
    Rot = np.eye(3) if rotation_initial is None else np.array(rotation_initial, np.float64)
    for axis in rot_order:
        Rot = funcs[int(axis)] @ Rot
    return Rot


# ---------------------------------------------------------------------------
# Validation (reference: colmap2nerf_corrected.py:399-515)
# ---------------------------------------------------------------------------


def validate_camera_orientations(frames, points, verbose: bool = True) -> dict:
    """Check >=80% of cameras face the scene and mean viewing . mean(+Z) < -0.8."""
    scene_center = np.mean(points, axis=0)
    viewing, z_axes, toward = [], [], 0
    for f in frames:
        T = np.array(f["transform_matrix"])
        cam_z = T[:3, 2]
        view = -cam_z
        to_scene = scene_center - T[:3, 3]
        to_scene = to_scene / np.linalg.norm(to_scene)
        if float(np.dot(view, to_scene)) > 0:
            toward += 1
        viewing.append(view)
        z_axes.append(cam_z)
    mean_view = np.mean(viewing, axis=0)
    mean_z = np.mean(z_axes, axis=0)
    dot = float(np.dot(mean_view, mean_z))
    ratio = toward / max(len(frames), 1)
    ok = (dot < -0.8) and (ratio > 0.8)
    if verbose:
        print("=== Camera Orientation Validation ===")
        print(f"Cameras oriented toward scene: {toward}/{len(frames)} ({ratio:.1%})")
        print(f"Dot product (viewing . +Z): {dot:.3f}")
        print(f"Validation {'PASSED' if ok else 'FAILED'}")
    return {"passed": ok, "orientation_ratio": ratio, "view_z_dot": dot}


# ---------------------------------------------------------------------------
# Scene AABB (reference: colmap2nerf_corrected.py:630-711)
# ---------------------------------------------------------------------------


def compute_scene_aabb(
    points: np.ndarray,
    aabb_adjust,
    percentile_bounds=(1.0, 99.0),
    padding: float = 0.02,
    cfg=None,
    verbose: bool = True,
) -> dict:
    if len(points) == 0:
        raise ValueError("Cannot compute AABB for empty point cloud")
    lo, hi = percentile_bounds
    aabb_min = np.percentile(points, lo, axis=0)
    aabb_max = np.percentile(points, hi, axis=0)
    if padding > 0:
        pad = (aabb_max - aabb_min) * padding
        aabb_min -= pad
        aabb_max += pad
    aabb_min = np.maximum(aabb_min, -1.0)
    aabb_max = np.minimum(aabb_max, 1.0)

    center = (aabb_min + aabb_max) / 2.0
    size = aabb_max - aabb_min
    volume = float(np.prod(size))
    remove_below = float(aabb_min[2])
    remove_above = float(aabb_max[2])

    adj_min = np.asarray(list(aabb_adjust["aabb_min"]), np.float64)
    adj_max = np.asarray(list(aabb_adjust["aabb_max"]), np.float64)
    if cfg is not None and cfg.get("remove_below_aabb", True):
        aabb_min = np.array([-1.0, -1.0, aabb_min[2]]) + adj_min
    else:
        aabb_min = np.array([-1.0, -1.0, -1.0]) + adj_min
    if cfg is not None and cfg.get("remove_upper_aabb", True):
        z_axis = min(aabb_max[2] + 0.1, 1.0)
        aabb_max = np.array([1.0, 1.0, z_axis]) + adj_max
    else:
        aabb_max = np.array([1.0, 1.0, 1.0]) + adj_max

    info = {
        "aabb_remove_below": remove_below,
        "aabb_remove_above": remove_above,
        "aabb_min": aabb_min.tolist(),
        "aabb_max": aabb_max.tolist(),
        "aabb_center": center.tolist(),
        "aabb_size": size.tolist(),
        "aabb_volume": volume,
        "volume_efficiency": volume / 8.0,
        "percentile_bounds": list(percentile_bounds),
        "padding": float(padding),
        "num_points": len(points),
    }
    if verbose:
        print("Scene AABB computed:")
        print(f"  Min bounds: {np.round(aabb_min, 3).tolist()}")
        print(f"  Max bounds: {np.round(aabb_max, 3).tolist()}")
        print(f"  Volume efficiency: {info['volume_efficiency']:.1%} of full cube")
    return info


# ---------------------------------------------------------------------------
# Normalization routing
# ---------------------------------------------------------------------------


def resolve_normalization(points, cfg, verbose: bool = True, *, device):
    """Route cfg.normalization_method to the matching normalizer.

    * absent / "original": the canonical config-driven normalizer
      (colmap2nerf_corrected.py:169-205).
    * "adaptive" | "percentile" | "statistical" | "hybrid": the robust
      4-strategy machinery with the reference's fallback behavior — if the
      <=2.1 self-check fails, retry with adaptive(0.9, 0.15); if the whole
      computation raises, fall back to a simple 1/99 percentile bbox
      (normalize_with_aabb_improved.py:838-886).

    An optional radius pre-filter runs first when cfg.radius_filter is set
    (normalize_with_aabb_improved.py:485 exposes it; nb_points/radius keys
    override the 16 / 0.05 defaults).

    Both filters run on ``device``.

    Returns (scale, center, info).
    """
    pts = points
    if cfg.get("radius_filter", False):
        pts, _ = filter_radius_outliers(
            points,
            radius=float(cfg.get("radius_radius", 0.05)),
            min_neighbors=int(cfg.get("radius_nb_points", 16)),
            device=device,
        )
        if verbose:
            print(f"Radius filter kept {len(pts)}/{len(points)} points")
        if len(pts) == 0:
            pts = points

    method = cfg.get("normalization_method", None)
    valid = (None, "original", "adaptive", "percentile", "statistical", "hybrid")
    if method not in valid:
        raise ValueError(
            f"unknown normalization_method {method!r}; expected one of "
            f"{[m for m in valid if m]}"
        )
    if method in (None, "original"):
        scale, center = scene_normalization(pts, cfg, device=device)
        return scale, center, {"method": "original"}

    center, scale, info = normalize_with_reference_fallback(
        pts,
        method=method,
        device=device,
        target_retention=float(cfg.get("target_retention", 0.95)),
        padding=float(cfg.percentile_bbox.get("padding", 0.1)),
        nb_neighbors=int(cfg.get("outlier_nb_neighbors", 20)),
        std_ratio=float(cfg.get("outlier_std_ratio", 2.0)),
    )
    scale = float(scale) * float(cfg.get("scale", 1.0))
    return scale, center, info


# ---------------------------------------------------------------------------
# Full pipelines
# ---------------------------------------------------------------------------


def colmap_paths(cfg) -> dict:
    """Scene file layout. The canonical reference reads tmp/<scene>/colmap_text
    (colmap2nerf_corrected.py:17-33), the variants read data/<scene>/colmap_text
    (normalize_with_aabb.py:811-815); we honour cfg.colmap_dir when set."""
    base = Path(cfg.get("colmap_dir", f"data/{cfg.scene_name}"))
    workdir = base / "colmap_text"
    return {
        "workdir": workdir,
        "cameras": workdir / "cameras.txt",
        "images": workdir / "images.txt",
        "points3d": workdir / "points3D.txt",
        "image_dir": base / "images",
    }


def colmap_to_nerf(cfg, mode: str = "auto", verbose: bool = True, *, device) -> dict:
    """COLMAP text model -> transforms dict (not yet written to disk).

    mode="auto": corrected pipeline (align mean forward with -Z, then flip).
    mode="auto+z": the earlier colmap2nerf.py variant — identical, but the
      mean forward aligns with +Z (reference: colmap2nerf.py:758-763).
    mode="euler": flip, then config Euler rotation; adds near/far.

    Normalization strategy is routed through cfg.normalization_method
    (original | adaptive | percentile | statistical | hybrid) with the
    reference's fallback chain; see resolve_normalization.

    The outlier filters run on ``device`` (the card unless the caller asks
    for the CPU; a missing card raises). Besides nerfjax's keys the result
    holds "stages": the stages' seconds, "read" (the three text files),
    "outlier_filter" and "knn" (the statistical filter, and its kNN alone:
    CUDA events on the card), "normalize_convert" (the rest of the
    normalization, the poses and the world transforms), "aabb", and the
    points "points_read" and "points_kept" (by the statistical filter; all
    points where it did not run).
    """
    from nerfjax_torch.extract import resolve_device

    device = resolve_device(device)
    reset_filter_stats()
    times = {"read": 0.0}
    t0 = time.perf_counter()
    paths = colmap_paths(cfg)
    intrinsics = read_cameras_txt(paths["cameras"])
    points, rgbs = read_points3d_txt(paths["points3d"])
    times["read"] += time.perf_counter() - t0
    if verbose:
        print(f"Loaded {len(points)} 3D points from {paths['points3d']}")

    t0 = time.perf_counter()
    scale, center, norm_info = resolve_normalization(points, cfg, verbose=verbose, device=device)
    normalize_s = time.perf_counter() - t0 - filter_stats["outlier_filter"]
    t1 = time.perf_counter()
    poses = read_images_txt(paths["images"])
    times["read"] += time.perf_counter() - t1
    t1 = time.perf_counter()
    frames = poses_to_frames(poses, paths["image_dir"], scale, center)
    if verbose:
        print(f"Loaded {len(frames)} camera poses from {paths['images']}")
    points_norm = (points - center) * scale

    if mode in ("auto", "auto+z"):
        target = np.array([0.0, 0.0, 1.0 if mode == "auto+z" else -1.0])
        mean_forward = compute_mean_forward_direction(frames)
        R_align = rotation_between_vectors(mean_forward, target)
        frames, points_norm = apply_world_rotation(frames, points_norm, R_align)
        points_norm, frames = flip_colmap_to_nerf(
            points_norm, frames, cfg.get("shift", [0, 0, 0])
        )
        if mode == "auto":
            validation = validate_camera_orientations(frames, points_norm, verbose=verbose)
        else:
            # colmap2nerf.py (+Z variant) runs no orientation validation —
            # with +Z alignment the corrected check would fail by design.
            validation = {"passed": True}
    elif mode == "euler":
        points_norm, frames = flip_colmap_to_nerf(points_norm, frames, (0, 0, 0))
        if cfg.get("rotation", True):
            Rot = euler_world_rotation(
                cfg.get("angles", [0, 0, 0]),
                cfg.get("rot_order", [0, 1, 2]),
                cfg.get("rotation_initial", None),
            )
            frames, points_norm = apply_world_rotation(frames, points_norm, Rot)
        shift = np.asarray(list(cfg.get("shift", [0, 0, 0])), np.float64)
        points_norm = points_norm + shift
        for f in frames:
            T = np.array(f["transform_matrix"])
            T[:3, 3] += shift
            f["transform_matrix"] = T.tolist()
        validation = {"passed": True}
    else:
        raise ValueError(f"unknown mode {mode!r}")
    times["normalize_convert"] = normalize_s + time.perf_counter() - t1

    t0 = time.perf_counter()
    aabb_info = compute_scene_aabb(
        points_norm,
        aabb_adjust=cfg.aabb_adjust,
        percentile_bounds=(1.0, 99.0),
        padding=0.02,
        cfg=cfg,
        verbose=verbose,
    )

    transform = {
        **intrinsics,
        "frames": frames,
        "scene_aabb": aabb_info,
        "normalization": {"center": np.asarray(center).tolist(), "scale": float(scale)},
    }
    if norm_info.get("method", "original") != "original":
        transform["normalization"]["info"] = {
            k: v for k, v in norm_info.items() if not isinstance(v, np.ndarray)
        }
    if mode == "euler":
        near, far = compute_near_far_bounds(points_norm, frames, max_percentile=99)
        transform["near"] = near
        transform["far"] = far
    times["aabb"] = time.perf_counter() - t0
    kept = filter_stats["points_kept"]
    stages = {"read": times["read"], "outlier_filter": filter_stats["outlier_filter"], "knn": filter_stats["knn"],
              "normalize_convert": times["normalize_convert"], "aabb": times["aabb"], "points_read": len(points),
              "points_kept": len(points) if kept is None else kept}

    return {
        "transform": transform,
        "points": points_norm,
        "rgbs": rgbs,
        "validation": validation,
        "stages": stages,
    }


def write_transforms_json(transform: dict, output_path: str | Path) -> None:
    with open(output_path, "w") as f:
        json.dump(transform, f, indent=4)
    print(f"Transform saved to {output_path}")
