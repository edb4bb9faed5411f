"""Occupancy volume -> colored points (the port's own copy of
``nerfjax/postprocess.py:19-59``, ``volume_to_points``, for
``extract_vol --visualize``; ``tests/test_torch_imports.py`` holds the two
equal)."""

from __future__ import annotations

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
