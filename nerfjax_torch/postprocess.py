"""Post-processing: occupancy volume -> point list -> AABB slice ->
voxelize -> tif/vti (the port's own copy of ``nerfjax/postprocess.py``:
``volume_to_points`` :19-59, ``slice_aabb``, ``save_sliced``,
``post_process``, ``voxelize_points`` and ``write_formats`` :62-187; the
CLIs ``post_process_vol`` and ``write_format`` call it). The ``.pth`` files
go through ``checkpoint.save_pth``/``load_pth``, which read and write the
files of both packages. Host code: numpy, no card.

``voxelize_points`` reproduces nerfjax's C++ voxelizer (``voxelize_native``,
the path nerfjax takes when its native library loads), not its numpy
fallback: the scale ``(p + 1) * (0.5 * (g - 1))`` in float32, the colour
clamped to [0, 255] before it is truncated, and the last point written
into a voxel wins. ``tests/test_torch_postprocess.py`` holds the files
byte-equal to nerfjax's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def volume_to_points(
    occupancy: np.ndarray, rgb_volume: np.ndarray, global_max: float | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Occupied voxels -> (points_normalized [N,3] in [-1,1], rgbs [N,3]).

    Parity: reference scripts/post_process_vol.py:78,87-93 — the reference
    divides the WHOLE rgb_volume by its global max before gathering, so the
    normalizer must be the global max, not the max over occupied voxels.
    Sparse-fetched volumes (extract.py) zero unoccupied RGB but record the
    true pre-compaction max in metadata["rgb_global_max"]; pass it here to
    keep the normalizer identical to a dense fetch.
    """
    occ = np.asarray(occupancy)
    vol = np.asarray(rgb_volume)
    if global_max is None:
        global_max = float(vol.max()) if vol.size else 0.0
    # Flat-index path: ~4x faster than argwhere + 3-axis fancy indexing at
    # 512^3 / ~20M occupied voxels (the viewer-stress workload). int64
    # divmod is pathologically slow in numpy (no SIMD integer division), so
    # power-of-two resolutions — the standard 128/256/512 grids — decompose
    # the flat index with shifts/masks instead.
    res = occ.shape[0]
    ny, nz = occ.shape[1], occ.shape[2]
    flat_idx = np.flatnonzero(occ.reshape(-1))
    if (ny & (ny - 1)) == 0 and (nz & (nz - 1)) == 0:
        yb, zb = ny.bit_length() - 1, nz.bit_length() - 1
        i = flat_idx >> (yb + zb)
        j = (flat_idx >> zb) & (ny - 1)
        k = flat_idx & (nz - 1)
    else:
        i, j, k = np.unravel_index(flat_idx, occ.shape)
    rgbs = vol.reshape(-1, 3)[flat_idx].astype(np.float32)
    if global_max > 0:
        rgbs *= np.float32(1.0 / global_max)
    points = np.empty((flat_idx.shape[0], 3), np.float32)
    scale = np.float32(2.0 / (res - 1)) if res > 1 else np.float32(0.0)
    np.multiply(i, scale, out=points[:, 0])
    np.multiply(j, scale, out=points[:, 1])
    np.multiply(k, scale, out=points[:, 2])
    points -= 1.0
    return points, rgbs


def slice_aabb(points: np.ndarray, rgbs: np.ndarray, aabb_meta) -> tuple[np.ndarray, np.ndarray]:
    """Keep points inside the scene AABB (reference: post_process_vol.py:37-50)."""
    aabb_min = np.asarray(list(aabb_meta["aabb_min"]), np.float32)
    aabb_max = np.asarray(list(aabb_meta["aabb_max"]), np.float32)
    mask = np.all((points >= aabb_min) & (points <= aabb_max), axis=1)
    return points[mask], rgbs[mask]


def save_sliced(points, rgbs, aabb_meta, path: str | Path) -> None:
    """volume_sliced.pth contract (reference: post_process_vol.py:11-15)."""
    from nerfjax_torch import checkpoint as ckpt

    meta = dict(aabb_meta) if aabb_meta is not None else None
    if meta is not None:
        meta = {k: (list(v) if isinstance(v, (list, tuple, np.ndarray)) else v) for k, v in meta.items()}
    ckpt.save_pth(
        {"points_normalized": np.asarray(points, np.float32), "rgbs": np.asarray(rgbs, np.float32),
         "aabb_meta": meta},
        path,
    )


def post_process(cfg, verbose: bool = True) -> dict:
    """Full post-process stage (reference: post_process_vol.py:67-110):
    volume.pth -> points -> AABB slice -> volume_sliced.pth."""
    from nerfjax_torch import checkpoint as ckpt
    from nerfjax_torch.config import load_config

    data = ckpt.load_pth(cfg.volume_output_path)
    volume = data["occupancy_volume"]
    rgb_volume = data["rgb_volume"]
    if verbose:
        print(f"Volume shape: {volume.shape}")
        print(f"RGB volume shape: {rgb_volume.shape}")

    points, rgbs = volume_to_points(volume, rgb_volume, (data.get("metadata") or {}).get("rgb_global_max"))
    if verbose:
        print(f"Points shape: {points.shape}")
        print(f"RGB shape: {rgbs.shape}")

    aabb_meta = None
    if cfg.get("aabb_slice", True):
        transforms = load_config(cfg.transforms_json)
        aabb_meta = transforms.scene_aabb.to_dict()
        points, rgbs = slice_aabb(points, rgbs, aabb_meta)
        save_sliced(points, rgbs, aabb_meta, cfg.sliced_vol_path)
        if verbose:
            print(f"Sliced volume saved to: {cfg.sliced_vol_path}")
    return {"points": points, "rgbs": rgbs, "aabb_meta": aabb_meta}


def voxelize_points(
    points: np.ndarray, rgbs: np.ndarray, grid_size: int, fill_value: int = 255
) -> tuple[np.ndarray, np.ndarray]:
    """Points in [-1,1] -> (binary uint8 [G,G,G], rgb uint8 [G,G,G,3]).

    Parity: reference scripts/write_format.py:19-38, as nerfjax's C++
    voxelizer computes it: index trunc((p + 1) * (0.5 * (G - 1))) in
    float32, clamped to [0, G-1]; colour trunc(clamp(rgb * 255, 0, 255));
    where several points land in one voxel, the last one's colour.
    """
    g = int(grid_size)
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    cols = np.ascontiguousarray(rgbs, np.float32).reshape(-1, 3)
    binary = np.zeros((g,) * 3, np.uint8)
    rgb_vol = np.zeros((g,) * 3 + (3,), np.uint8)
    s = np.float32(0.5) * np.float32(g - 1)
    idx = np.clip(((pts + np.float32(1.0)) * s).astype(np.int64), 0, g - 1)
    flat = (idx[:, 0] * g + idx[:, 1]) * g + idx[:, 2]
    _, first_from_end = np.unique(flat[::-1], return_index=True)
    last = flat.shape[0] - 1 - first_from_end  # each voxel's last point
    binary.reshape(-1)[flat[last]] = fill_value
    rgb_vol.reshape(-1, 3)[flat[last]] = np.clip(cols[last] * np.float32(255.0), 0.0, 255.0).astype(np.uint8)
    return binary, rgb_vol


def write_formats(cfg, grid_size: int = 512, verbose: bool = True) -> dict:
    """Export the sliced volume to napari tiffs, ParaView tiffs, and VTI.

    Output layout and conventions per reference scripts/write_format.py:
    173-233 — napari/ gets XYZ-order tiffs, paraview/ gets ZYX-transposed
    tiffs without metadata, vti/ gets cell-data VTI (RGB -> grayscale mean).
    """
    from nerfjax_torch import checkpoint as ckpt
    from nerfjax_torch.formats import write_tiff_volume, write_vti_volume

    data = ckpt.load_pth(cfg.sliced_vol_path)
    points = np.asarray(data["points_normalized"])
    rgbs = np.asarray(data["rgbs"])
    if verbose:
        print(f"Points shape: {points.shape}")
        print(f"Grid size: {grid_size}")

    binary, rgb_vol = voxelize_points(points, rgbs, grid_size)
    if verbose:
        occ = int((binary > 0).sum())
        print(f"Occupied voxels: {occ} / {binary.size}")
        print(f"Occupancy ratio: {occ / binary.size * 100:.2f}%")

    base = Path(cfg.sliced_vol_path).stem
    out_dir = Path(cfg.output_dir)
    napari_dir = out_dir / "napari"
    paraview_dir = out_dir / "paraview"
    vti_dir = out_dir / "vti"
    for d in (napari_dir, paraview_dir, vti_dir):
        d.mkdir(parents=True, exist_ok=True)

    # napari: XYZ order as stored
    write_tiff_volume(binary, napari_dir / f"{base}_binary.tif")
    write_tiff_volume(rgb_vol, napari_dir / f"{base}_rgb.tif")
    # paraview: ZYX transpose, no extra metadata
    write_tiff_volume(np.transpose(binary, (2, 1, 0)), paraview_dir / f"{base}_binary.tiff")
    write_tiff_volume(np.transpose(rgb_vol, (2, 1, 0, 3)), paraview_dir / f"{base}_rgb.tiff")
    # vti: cell data, RGB -> grayscale mean
    write_vti_volume(binary, vti_dir / f"{base}_binary.vti")
    write_vti_volume(rgb_vol, vti_dir / f"{base}_rgb.vti")
    return {
        "binary_volume": binary,
        "rgb_volume": rgb_vol,
        "dirs": {"napari": napari_dir, "paraview": paraview_dir, "vti": vti_dir},
    }
