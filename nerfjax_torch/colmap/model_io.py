"""COLMAP text model IO: cameras.txt / images.txt / points3D.txt; the port's
copy of ``nerfjax/colmap/model_io.py``, whose files it writes byte for byte
(``tests/test_torch_colmap.py``).

Standard COLMAP TXT parsing (contract per SURVEY.md §7.2) plus writers for
the re-centering tool. Camera parsing covers the 9 models the reference
handles (reference: scripts/colmap2nerf_corrected.py:238-318).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _data_lines(path: Path):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            yield line


def read_cameras_txt(path: str | Path) -> dict:
    """Parse the first camera of cameras.txt into the transforms-JSON
    intrinsics dict {w,h,fl_x,fl_y,k1..k4,p1,p2,cx,cy,is_fisheye,K}."""
    line = next(_data_lines(Path(path)))
    els = line.split()
    model = els[1]
    cam = {
        "w": int(els[2]),
        "h": int(els[3]),
        "fl_x": float(els[4]),
        "fl_y": float(els[4]),
        "k1": 0.0,
        "k2": 0.0,
        "k3": 0.0,
        "k4": 0.0,
        "p1": 0.0,
        "p2": 0.0,
        "cx": int(els[2]) / 2,
        "cy": int(els[3]) / 2,
        "is_fisheye": False,
    }
    p = [float(v) for v in els[5:]]
    if model == "SIMPLE_PINHOLE":
        cam["cx"], cam["cy"] = p[0], p[1]
    elif model == "PINHOLE":
        cam["fl_y"], cam["cx"], cam["cy"] = p[0], p[1], p[2]
    elif model == "SIMPLE_RADIAL":
        cam["cx"], cam["cy"], cam["k1"] = p[0], p[1], p[2]
    elif model == "RADIAL":
        cam["cx"], cam["cy"], cam["k1"], cam["k2"] = p[0], p[1], p[2], p[3]
    elif model == "OPENCV":
        (cam["fl_y"], cam["cx"], cam["cy"], cam["k1"], cam["k2"], cam["p1"], cam["p2"]) = p[:7]
    elif model == "SIMPLE_RADIAL_FISHEYE":
        cam["is_fisheye"] = True
        cam["cx"], cam["cy"], cam["k1"] = p[0], p[1], p[2]
    elif model == "RADIAL_FISHEYE":
        cam["is_fisheye"] = True
        cam["cx"], cam["cy"], cam["k1"], cam["k2"] = p[0], p[1], p[2], p[3]
    elif model == "OPENCV_FISHEYE":
        cam["is_fisheye"] = True
        (cam["fl_y"], cam["cx"], cam["cy"], cam["k1"], cam["k2"], cam["k3"], cam["k4"]) = p[:7]
    # any other model: keep SIMPLE_RADIAL-ish defaults, like the reference

    cam["K"] = [
        [cam["fl_x"], 0.0, cam["cx"]],
        [0.0, cam["fl_y"], cam["cy"]],
        [0.0, 0.0, 1.0],
    ]
    return cam


def read_points3d_txt(path: str | Path, full: bool = False):
    """points3D.txt -> (points [N,3] f64, rgbs [N,3] in [0,1]).

    With full=True returns the complete records (id/xyz/rgb/error/track) for
    lossless rewriting (transform_colmap path).
    """
    points, rgbs, records = [], [], []
    for line in _data_lines(Path(path)):
        els = line.split()
        if len(els) < 7:
            continue
        xyz = [float(v) for v in els[1:4]]
        rgb = [int(v) for v in els[4:7]]
        points.append(xyz)
        rgbs.append([c / 255.0 for c in rgb])
        if full:
            records.append(
                {
                    "id": int(els[0]),
                    "xyz": np.array(xyz),
                    "rgb": rgb,
                    "error": float(els[7]) if len(els) > 7 else 0.0,
                    "track": els[8:],
                }
            )
    pts = np.array(points)
    cols = np.array(rgbs)
    return (pts, cols, records) if full else (pts, cols)


def read_images_txt(path: str | Path) -> list[dict]:
    """images.txt -> list of {image_id, quat [qw,qx,qy,qz], trans [3],
    camera_id, image_name, points2d_line} (w2c convention, as stored).

    Robust to EMPTY points2D lines (images with zero observations) — the
    physical line after each pose line is its points2D record even when
    blank, unlike the reference parser which skips blanks and de-syncs
    (reference: colmap2nerf_corrected.py:335-343)."""
    poses = []
    expecting_points2d = False
    pending = None
    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if line.startswith("#"):
                continue
            if expecting_points2d:
                if pending is not None:
                    pending["points2d_line"] = line
                expecting_points2d = False
                continue
            if not line:
                continue
            els = line.split()
            pending = {
                "image_id": int(els[0]),
                "quat": np.array([float(v) for v in els[1:5]]),  # wxyz
                "trans": np.array([float(v) for v in els[5:8]]),
                "camera_id": int(els[8]),
                "image_name": els[9] if len(els) > 9 else "",
                "points2d_line": "",
            }
            poses.append(pending)
            expecting_points2d = True
    return poses


def write_points3d_txt(records: list[dict], path: str | Path) -> None:
    """Write points3D.txt (reference: transform_colmap.py:258-269)."""
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write(
            "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        f.write(f"# Number of points: {len(records)}\n")
        for p in records:
            x, y, z = p["xyz"]
            r, g, b = p["rgb"]
            track = " ".join(p["track"])
            f.write(f"{p['id']} {x:.6f} {y:.6f} {z:.6f} {r} {g} {b} {p['error']:.6f} {track}\n")


def write_images_txt(poses: list[dict], path: str | Path) -> None:
    """Write images.txt (reference: transform_colmap.py:272-292)."""
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        f.write(f"# Number of images: {len(poses)}\n")
        for p in poses:
            qw, qx, qy, qz = p["quat"]
            tx, ty, tz = p["trans"]
            f.write(
                f"{p['image_id']} {qw:.6f} {qx:.6f} {qy:.6f} {qz:.6f} "
                f"{tx:.6f} {ty:.6f} {tz:.6f} {p['camera_id']} {p['image_name']}\n"
            )
            f.write((p.get("points2d_line") or "") + "\n")
