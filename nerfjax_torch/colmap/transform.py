"""COLMAP model re-centering: rewrite points3D.txt / images.txt in place; the
port's copy of ``nerfjax/colmap/transform.py``, whose files it writes byte
for byte (``tests/test_torch_colmap.py``).

Reimplements scripts/transform_colmap.py: center the world at a
percentile-clipped centroid and optionally rotate so +Z aligns with the mean
camera viewing direction; w2c<->c2w quaternion round trip preserved
(reference: transform_colmap.py:88-233).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from nerfjax_torch.colmap.model_io import (
    read_images_txt,
    read_points3d_txt,
    write_images_txt,
    write_points3d_txt,
)
from nerfjax_torch.colmap.quaternion import matrix_to_quat, quat_to_matrix, rotation_between_vectors


def compute_centroid(
    points: np.ndarray, lower_percentile: float = 2.0, upper_percentile: float = 98.0
) -> np.ndarray:
    """Percentile-clipped centroid (reference: transform_colmap.py:88-105)."""
    if len(points) == 0:
        raise ValueError("Cannot compute centroid for empty point cloud")
    mins = np.percentile(points, lower_percentile, axis=0)
    maxs = np.percentile(points, upper_percentile, axis=0)
    mask = np.all((points >= mins) & (points <= maxs), axis=1)
    filtered = points[mask]
    if len(filtered) == 0:
        raise ValueError("No points left after filtering for centroid computation")
    return filtered.mean(axis=0)


def compute_average_camera_direction(poses: list[dict]) -> np.ndarray:
    """Mean of camera +Z axes in world coords (reference: transform_colmap.py:108-139).

    NOTE: mirrors the reference's convention, where the 'camera-to-world'
    rotation is taken directly from the stored (w2c) quaternion — kept
    identical for behavioral parity."""
    dirs = [quat_to_matrix(p["quat"])[:, 2] for p in poses]
    avg = np.mean(dirs, axis=0)
    return avg / np.linalg.norm(avg)


def compute_rotation_to_align_z(target_direction: np.ndarray) -> np.ndarray:
    """Rotation aligning +Z with target (reference: transform_colmap.py:142-180)."""
    return rotation_between_vectors(np.array([0.0, 0.0, 1.0]), target_direction)


def transform_camera_poses(
    poses: list[dict], translation: np.ndarray, rotation: np.ndarray | None = None
) -> list[dict]:
    """Re-center (and optionally rotate) the world for every w2c pose
    (reference: transform_colmap.py:183-233)."""
    out = []
    for p in poses:
        R_wc = quat_to_matrix(p["quat"])
        R_cw = R_wc.T
        C = -R_cw @ p["trans"]

        C_new = C - translation
        if rotation is not None:
            C_new = rotation @ C_new
            R_cw_new = rotation @ R_cw
            U, _, Vt = np.linalg.svd(R_cw_new)
            R_cw_new = U @ Vt
        else:
            R_cw_new = R_cw

        R_wc_new = R_cw_new.T
        t_new = -R_wc_new @ C_new
        out.append({**p, "quat": matrix_to_quat(R_wc_new), "trans": t_new})
    return out


def transform_points(
    points: np.ndarray, translation: np.ndarray, rotation: np.ndarray | None = None
) -> np.ndarray:
    t = points - translation
    if rotation is not None:
        t = (rotation @ t.T).T
    return t


def recenter_colmap_model(
    workdir: str | Path,
    rotate_to_mean_view: bool = True,
    lower_percentile: float = 2.0,
    upper_percentile: float = 98.0,
    verbose: bool = True,
) -> dict:
    """Full re-centering pass over a colmap_text directory, rewriting
    points3D.txt and images.txt in place (reference: transform_colmap.py:295+)."""
    workdir = Path(workdir)
    pts_path = workdir / "points3D.txt"
    img_path = workdir / "images.txt"

    points, _, records = read_points3d_txt(pts_path, full=True)
    poses = read_images_txt(img_path)

    centroid = compute_centroid(points, lower_percentile, upper_percentile)
    if verbose:
        print(f"Centroid: {np.round(centroid, 4).tolist()}")

    rotation = None
    if rotate_to_mean_view:
        avg_dir = compute_average_camera_direction(poses)
        rotation = compute_rotation_to_align_z(avg_dir)

    new_points = transform_points(points, centroid, rotation)
    for rec, xyz in zip(records, new_points):
        rec["xyz"] = xyz
    new_poses = transform_camera_poses(poses, centroid, rotation)

    write_points3d_txt(records, pts_path)
    write_images_txt(new_poses, img_path)
    if verbose:
        print(f"Rewrote {pts_path} and {img_path}")
    return {"centroid": centroid, "rotation": rotation}
