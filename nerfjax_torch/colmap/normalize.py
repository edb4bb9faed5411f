"""Scene normalization: robust bounding boxes -> (center, scale); the port's
copy of ``nerfjax/colmap/normalize.py``, with the device of the outlier
filter's kNN passed down to every call of it (``device``, no default).

Covers both reference normalizers:
  * the canonical config-driven one (reference: colmap2nerf_corrected.py:
    150-205 SceneNormalizer — outlier filter, percentile bbox, padding,
    user scale), and
  * the 4-strategy robust_bbox_computation (adaptive / percentile /
    statistical / hybrid) with the normalization self-check used by the
    normalize_with_aabb variants (reference: normalize_with_aabb.py:479-658).
"""

from __future__ import annotations

import numpy as np

from nerfjax_torch.colmap.outliers import remove_statistical_outliers
from nerfjax_torch.ops.knn import KernelLimitError


def compute_percentile_bbox(
    points: np.ndarray, lower: float = 1.0, upper: float = 99.8, padding: float = 0.17
) -> tuple[np.ndarray, float]:
    """(center, scale) fitting the percentile bbox into [-1,1]^3 with padding
    (reference: normalize_with_aabb.py:665-684)."""
    assert 0.0 <= padding < 1.0, "Padding must be in [0, 1)"
    mins = np.percentile(points, lower, axis=0)
    maxs = np.percentile(points, upper, axis=0)
    center = (mins + maxs) / 2.0
    scene_size = float(np.max(maxs - mins))
    scale = (2.0 * (1.0 - padding)) / scene_size
    return center, float(scale)


def scene_normalization(points: np.ndarray, cfg, *, device) -> tuple[float, np.ndarray]:
    """Canonical normalizer: outlier filter -> percentile bbox -> scale with
    padding -> user scale multiplier. Returns (scale, center). The
    outlier filter runs on ``device``.

    Parity: reference colmap2nerf_corrected.py:169-205 (SceneNormalizer.compute).
    """
    filtered, _ = remove_statistical_outliers(
        points,
        nb_neighbors=int(cfg.get("outlier_nb_neighbors", 20)),
        std_ratio=float(cfg.get("outlier_std_ratio", 2.0)),
        device=device,
    )
    pb = cfg.percentile_bbox
    mins = np.percentile(filtered, pb.lower, axis=0)
    maxs = np.percentile(filtered, pb.upper, axis=0)
    center = (mins + maxs) / 2.0
    max_range = float(np.max(maxs - mins))
    scale = (2.0 * (1.0 - pb.padding)) / max_range
    scale *= float(cfg.get("scale", 1.0))

    test = (points - center) * scale
    max_test_range = float(np.max(np.max(test, axis=0) - np.min(test, axis=0)))
    print("Robust bbox computation (config-driven)")
    print(f"Center: [{center[0]:.3f}, {center[1]:.3f}, {center[2]:.3f}]")
    print(f"Scale: {scale:.6f}")
    print(f"Test max range: {max_test_range:.3f}")
    return float(scale), center


def adaptive_percentile_bounds(
    points: np.ndarray, target_retention: float = 0.95
) -> tuple[float, float]:
    """MAD-driven percentile selection (reference: normalize_with_aabb.py:479-511)."""
    if len(points) < 100:
        margin = (1.0 - target_retention) / 2.0
        return margin * 100, (1.0 - margin) * 100
    center = np.mean(points, axis=0)
    distances = np.linalg.norm(points - center, axis=1)
    median_dist = np.median(distances)
    mad = np.median(np.abs(distances - median_dist))
    if mad < median_dist * 0.1:
        margin = (1.0 - target_retention) / 2.0
    else:
        margin = (1.0 - min(target_retention + 0.02, 0.99)) / 2.0
    return margin * 100, (1.0 - margin) * 100


def robust_bbox_computation(
    points: np.ndarray, method: str = "adaptive", *, device, **kwargs
) -> tuple[np.ndarray, float, dict]:
    """4-strategy robust bbox with the <=2.1 self-check; returns
    (center, scale, info). Parity: reference normalize_with_aabb.py:514-658.
    device: that of ``remove_statistical_outliers``."""
    if len(points) == 0:
        raise ValueError("Cannot compute bounding box for empty point cloud")
    info: dict = {"method": method, "original_points": len(points)}
    padding = kwargs.get("padding", 0.1)

    if method == "adaptive":
        lower, upper = adaptive_percentile_bounds(
            points, kwargs.get("target_retention", 0.95)
        )
        mins = np.percentile(points, lower, axis=0)
        maxs = np.percentile(points, upper, axis=0)
        info["percentile_bounds"] = (lower, upper)
    elif method == "statistical":
        filtered, _ = remove_statistical_outliers(
            points, kwargs.get("nb_neighbors", 20), kwargs.get("std_ratio", 2.0), device=device
        )
        if len(filtered) < len(points) * 0.5:
            print(
                f"Warning: Statistical filtering removed {len(points) - len(filtered)} points"
            )
        mins = np.min(filtered, axis=0)
        maxs = np.max(filtered, axis=0)
        info["filtered_points"] = len(filtered)
        info["removed_points"] = len(points) - len(filtered)
    elif method == "hybrid":
        filtered, _ = remove_statistical_outliers(
            points, kwargs.get("nb_neighbors", 20), kwargs.get("std_ratio", 2.5), device=device
        )
        lower, upper = adaptive_percentile_bounds(
            filtered, kwargs.get("target_retention", 0.95)
        )
        mins = np.percentile(filtered, lower, axis=0)
        maxs = np.percentile(filtered, upper, axis=0)
        info["filtered_points"] = len(filtered)
        info["percentile_bounds"] = (lower, upper)
    else:  # percentile
        mins = np.percentile(points, kwargs.get("lower", 1.0), axis=0)
        maxs = np.percentile(points, kwargs.get("upper", 99.0), axis=0)
        info["percentile_bounds"] = (kwargs.get("lower", 1.0), kwargs.get("upper", 99.0))

    center = (mins + maxs) / 2.0
    ranges = maxs - mins
    max_range = float(np.max(ranges))
    scale = (2.0 * (1.0 - padding)) / max_range
    info.update(
        {"padding": padding, "ranges": ranges.tolist(), "max_range": max_range}
    )

    if scale <= 0 or not np.isfinite(scale):
        raise ValueError(f"Invalid scale computed: {scale}")
    if not np.all(np.isfinite(center)):
        raise ValueError(f"Invalid center computed: {center}")

    test = (points - center) * scale
    max_test_range = float(np.max(np.max(test, axis=0) - np.min(test, axis=0)))
    info.update(
        {
            "final_scale": float(scale),
            "final_center": center.tolist(),
            "test_max_range": max_test_range,
            "normalization_success": bool(max_test_range <= 2.1),
        }
    )
    print(f"Robust bbox computation ({method}):")
    print(f"  Center: [{center[0]:.3f}, {center[1]:.3f}, {center[2]:.3f}]")
    print(f"  Scale: {scale:.6f}")
    print(f"  Test max range: {max_test_range:.3f}")
    return center, float(scale), info


def robust_bbox_with_fallback(points: np.ndarray, method: str = "hybrid", *, device, **kwargs):
    """Fallback CHAIN hybrid -> adaptive -> percentile when the self-check
    fails (the normalize_with_aabb.py variant's retry pattern). See also
    normalize_with_reference_fallback for the _improved.py policy that the
    colmap_to_nerf pipeline uses."""
    chain = [method] + [m for m in ("adaptive", "percentile") if m != method]
    last = None
    for m in chain:
        center, scale, info = robust_bbox_computation(points, method=m, device=device, **kwargs)
        last = (center, scale, info)
        if info["normalization_success"]:
            return last
        print(f"Normalization check failed for '{m}', trying fallback...")
    return last


def normalize_with_reference_fallback(points: np.ndarray, method: str, *, device, **kwargs):
    """The _improved.py fallback policy (normalize_with_aabb_improved.py:
    838-886): run the requested strategy; if its <=2.1 self-check fails,
    retry once with adaptive(target_retention=0.9, padding=0.15); if the
    whole computation raises, degrade loudly to a simple 1/99 percentile
    bbox. Returns (center, scale, info)."""
    try:
        center, scale, info = robust_bbox_computation(points, method=method, device=device, **kwargs)
        if not info["normalization_success"]:
            print("Warning: Normalization validation failed, trying fallback method...")
            center, scale, info = robust_bbox_computation(
                points, method="adaptive", device=device, target_retention=0.9, padding=0.15
            )
    except (RuntimeError, KernelLimitError):
        raise  # the card's errors (remove_statistical_outliers raises them all so): never a fallback
    except Exception as e:  # noqa: BLE001 — reference behavior: degrade loudly
        print(f"Error in robust normalization: {e}")
        print("Falling back to simple percentile method...")
        center, scale = compute_percentile_bbox(points, lower=1.0, upper=99.0, padding=0.15)
        info = {"method": "fallback", "error": str(e)}
    return center, scale, info


def compute_near_far_bounds(
    points: np.ndarray,
    frames: list[dict],
    min_percentile: float = 0.1,
    max_percentile: float = 99.9,
) -> tuple[float, float]:
    """Near/far from camera-to-point distance percentiles
    (reference: normalize_with_aabb.py:777-787)."""
    near, far = float("inf"), float("-inf")
    for frame in frames:
        c2w = np.array(frame["transform_matrix"])
        cam = c2w[:3, 3]
        dists = np.linalg.norm(points - cam, axis=1)
        near = min(near, float(np.percentile(dists, min_percentile)))
        far = max(far, float(np.percentile(dists, max_percentile)))
    return near, far
