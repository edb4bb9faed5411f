"""Statistical and radius outlier removal on point clouds (counterpart of
``nerfjax/colmap/outliers.py``).

``remove_statistical_outliers`` is open3d's remove_statistical_outlier, as
nerfjax runs it (reference: colmap2nerf_corrected.py:157-167): each point's
mean distance to its k nearest neighbours (``ops.knn``: the K6 kernel on a
card, its plain version on the CPU), then a global threshold. nerfjax takes
the distances from its native C++ kernel and quietly from numpy when that
is missing; the port has no fallback: a card run runs the kernel or raises
a RuntimeError (whatever the card's transfer, build, load or launch
raised), which the normalizers' degrade-to-percentiles path lets through.

The threshold is formed on the host with numpy, exactly as nerfjax forms it
(outliers.py:59-62): the float32 distances are fetched, then ``mean()``,
``std()`` and ``np.where(d <= mu + r * sigma)``. A torch reduction on the
card adds in another order and moves points across the threshold.

``filter_stats`` accumulates what the statistical filter did since
``reset_filter_stats``: the wall seconds of its calls ("outlier_filter"),
of their kNN alone ("knn": CUDA events on a card) and the points the last
call kept ("points_kept", None before one ran). ``colmap_to_nerf`` reads it
for its stages.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nerfjax_torch.ops.knn import KernelLimitError, knn_mean_distances

filter_stats: dict = {"outlier_filter": 0.0, "knn": 0.0, "points_kept": None}


def reset_filter_stats() -> None:
    filter_stats.update(outlier_filter=0.0, knn=0.0, points_kept=None)


def _mean_distances(points: np.ndarray, k: int, dev: torch.device) -> tuple[np.ndarray, float]:
    """The kNN's float32 mean distances on dev, fetched, and its seconds."""
    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        mean_d = knn_mean_distances(pts, k).cpu().numpy()
        return mean_d, time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    mean_d = knn_mean_distances(pts, k)
    end.record()
    mean_d = mean_d.cpu().numpy()
    return mean_d, start.elapsed_time(end) / 1e3


def remove_statistical_outliers(
    points: np.ndarray, nb_neighbors: int = 20, std_ratio: float = 2.0, *, device
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (filtered_points, keep_indices), open3d-compatible semantics.

    The kNN runs on ``device``; off the CPU any error of it is raised as a
    RuntimeError (the kernel's k limit as its ValueError)."""
    t0 = time.perf_counter()
    points = np.asarray(points)
    if len(points) <= nb_neighbors:
        return points, np.arange(len(points))
    dev = torch.device(device)
    try:
        mean_d, knn_s = _mean_distances(points, nb_neighbors, dev)
    except Exception as e:
        if dev.type == "cpu" or isinstance(e, (RuntimeError, KernelLimitError)):
            raise
        raise RuntimeError(f"the statistical filter's kNN on {dev} raised {type(e).__name__}: {e}") from e
    mu = mean_d.mean()
    sigma = mean_d.std()
    keep = np.where(mean_d <= mu + std_ratio * sigma)[0]
    filter_stats["knn"] += knn_s
    filter_stats["outlier_filter"] += time.perf_counter() - t0
    filter_stats["points_kept"] = len(keep)
    return points[keep], keep


def filter_radius_outliers(
    points: np.ndarray, radius: float, min_neighbors: int = 5, chunk: int = 2048, *, device
) -> tuple[np.ndarray, np.ndarray]:
    """Radius outlier removal: keep points with >= min_neighbors within
    `radius` (reference: normalize_with_aabb_improved.py:485 uses open3d's
    remove_radius_outlier). nerfjax's float64 expansion form,
    sq_i + sq_j - 2 p_i.p_j <= r^2, in chunks of queries as plain torch on
    ``device``. The dot product is three products added in order, each
    operation its own torch call and so rounded on its own on any device:
    the card keeps the CPU's points bit for bit. (nerfjax's ``block @ pts.T``
    is a BLAS call that may fuse them; a pair within a few ulps of r^2 may
    count otherwise there.)"""
    n = len(points)
    if n == 0:
        return points, np.arange(0)
    pts = torch.from_numpy(np.asarray(points, np.float64)).to(device)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    sq = x * x + y * y + z * z
    r2 = radius * radius
    counts = torch.empty(n, dtype=torch.int64, device=pts.device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        dot = x[start:stop, None] * x[None, :]
        dot += y[start:stop, None] * y[None, :]
        dot += z[start:stop, None] * z[None, :]
        d2 = sq[start:stop, None] + sq[None, :] - 2.0 * dot
        counts[start:stop] = (d2 <= r2).sum(dim=1) - 1  # minus self
    keep = np.where(counts.cpu().numpy() >= min_neighbors)[0]
    return points[keep], keep
