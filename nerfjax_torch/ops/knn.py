"""Each point's mean distance to its k nearest neighbours (K6), the kNN of
the statistical outlier filter (counterpart of ``knn_mean_distances`` in
``nerfjax/native/knn.cpp:22-48``, which ``nerfjax/colmap/outliers.py``
runs on the host).

``knn_mean_distances`` launches the CUDA kernel of
``nerfjax_torch/csrc/knn.cu`` (built by ``nerfjax_torch._build`` with
``-fmad=false``, called through ctypes on PyTorch's current stream) for a
CUDA tensor, and its plain PyTorch version ``knn_mean_distances_plain``
for a CPU tensor; nothing falls back. ``launch_counts`` counts the kernel's
launches.

Semantics are nerfjax's native path's: k = min(k, n - 1), n <= 1 or k <= 0
gives zeros; the point's own index is excluded, duplicates of it count at
distance 0; d2 = dx*dx + dy*dy + dz*dz in float32, each operation rounded
on its own; the k smallest d2, their square roots summed in float64 in
ascending order, divided by k and rounded to float32. The kernel and the
plain version agree bit for bit. nerfjax's native build (``g++ -O3
-march=native``) may contract d2 into FMAs, so it can differ from both by a
few float32 ulps.

The kernel keeps a sorted list of at most ``K_MAX`` = 256 distances a
thread and raises a ``KernelLimitError`` (a ``ValueError``) above it; the
plain version has no limit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

K_MAX = 256
ELEMENTS_PER_CHUNK = 1 << 26  # query rows x points of one chunk of the plain version

launch_counts = {"knn_mean_dist": 0}


class KernelLimitError(ValueError):
    """k above the kernel's K_MAX on a CUDA tensor."""


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check(points: torch.Tensor) -> None:
    if points.dim() != 2 or points.shape[1] != 3 or points.dtype != torch.float32:
        raise ValueError(f"points must be a float32 [n, 3] tensor, got {points.dtype} {tuple(points.shape)}")


def knn_mean_distances_plain(points: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's arithmetic in torch on points' device: chunks of queries
    against all points, explicit differences, ``torch.topk(largest=False)``
    of d2 with the query's own column set to +inf, then the square roots
    added one column at a time in float64 (the ascending order)."""
    _check(points)
    n = points.shape[0]
    k = min(int(k), n - 1)
    if n <= 1 or k <= 0:
        return torch.zeros(n, dtype=torch.float32, device=points.device)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    rows = max(1, ELEMENTS_PER_CHUNK // n)
    for start in range(0, n, rows):
        stop = min(start + rows, n)
        dx = x[None, :] - x[start:stop, None]
        dy = y[None, :] - y[start:stop, None]
        dz = z[None, :] - z[start:stop, None]
        d2 = dx * dx + dy * dy + dz * dz
        r = torch.arange(stop - start, device=points.device)
        d2[r, r + start] = float("inf")
        vals = torch.topk(d2, k, dim=1, largest=False, sorted=True).values
        acc = torch.zeros(stop - start, dtype=torch.float64, device=points.device)
        for j in range(k):
            acc = acc + vals[:, j].double().sqrt()
        out[start:stop] = (acc / k).float()
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (first call only) and load csrc/knn.cu, with typed entries.
    Whatever fails on the way (nvcc missing or refusing to run, the library
    not loading, a symbol missing) is raised as a RuntimeError."""
    from nerfjax_torch import _build

    try:
        lib = _build.load("knn")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.nerf_knn_mean_dist.argtypes = [vp, i32, i32, vp, vp]
        lib.nerf_knn_mean_dist.restype = i32
        lib.nerf_knn_max_k.argtypes, lib.nerf_knn_max_k.restype = [], i32
    except RuntimeError:
        raise
    except Exception as e:
        raise RuntimeError(f"csrc/knn.cu could not be built or loaded: {type(e).__name__}: {e}") from e
    if lib.nerf_knn_max_k() != K_MAX:
        raise RuntimeError(f"csrc/knn.cu takes k up to {lib.nerf_knn_max_k()}, ops/knn.py expects {K_MAX}")
    return lib


def knn_mean_distances(points: torch.Tensor, k: int) -> torch.Tensor:
    """[n] float32 mean distance of each of the float32 [n, 3] ``points`` to
    its k nearest other points, on points' device: the kernel on a CUDA
    tensor (any strides: a view is copied to a contiguous tensor first), the
    plain version on a CPU tensor."""
    if points.device.type == "cpu":
        return knn_mean_distances_plain(points, k)
    if points.device.type != "cuda":
        raise ValueError(f"knn_mean_distances runs on cpu or cuda, not {points.device}")
    _check(points)
    n = points.shape[0]
    k = min(int(k), n - 1)
    if n <= 1 or k <= 0:
        return torch.zeros(n, dtype=torch.float32, device=points.device)
    if k > K_MAX:
        raise KernelLimitError(f"k = {k} exceeds the kernel's limit K_MAX = {K_MAX}")
    if n >= 2**31:
        raise ValueError(f"{n} points: the kernel indexes points with 32-bit integers")
    pts = points.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    err = _lib().nerf_knn_mean_dist(pts.data_ptr(), n, k, out.data_ptr(),
                                    torch.cuda.current_stream(points.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_mean_distances: kernel launch failed with cudaError {err}")
    launch_counts["knn_mean_dist"] += 1
    return out
