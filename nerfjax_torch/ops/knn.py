"""Each point's mean distance to its k nearest neighbours (K6), the kNN of
the statistical outlier filter (counterpart of ``knn_mean_distances`` in
``nerfjax/native/knn.cpp:22-48``, which ``nerfjax/colmap/outliers.py``
runs on the host).

``knn_mean_distances`` launches the CUDA kernels of
``nerfjax_torch/csrc/knn.cu`` (built by ``nerfjax_torch._build`` with
``-fmad=false``, called through ctypes on PyTorch's current stream) for a
CUDA tensor, and its plain PyTorch version ``knn_mean_distances_plain``
for a CPU tensor; nothing falls back. ``launch_counts`` counts each
kernel's launches.

Semantics are nerfjax's native path's: k = min(k, n - 1), n <= 1 or k <= 0
gives zeros; the point's own index is excluded, duplicates of it count at
distance 0; d2 = dx*dx + dy*dy + dz*dz in float32, each operation rounded
on its own; the k smallest d2, their square roots summed in float64 in
ascending order, divided by k and rounded to float32. The result depends
only on the multiset of the k smallest d2, so any search that finds them
gives the plain version's bits. nerfjax's native build (``g++ -O3
-march=native``) may contract d2 into FMAs, so it can differ from both by a
few float32 ulps.

Two routes on the card, chosen by ``knn_plan`` from the cloud's shape:

- **grid** (exact cell-grid search): the points are binned into cubic cells
  of side h, chosen so that a point's cell holds about ``CELL_TARGET`` x k
  points (``cell_load``: the mean over points of the number of points in
  their cell's bucket); cells are hashed into a power-of-two table of
  buckets (the planted outliers of an SfM cloud make a dense grid over its
  bounding box far too sparse) and the points sorted by bucket
  (``knn_bin`` counts, ``torch.cumsum`` offsets, ``knn_scatter``
  places; ``knn_mark`` flags the buckets that hold more than one cell). One
  thread per query, queries in bucket order, grows the searched cube of
  cells ring by ring up to ``R_MAX``: a cell is skipped when the least
  possible d2 to it is at least the current k-th smallest, and the search
  stops when the least possible d2 to any cell outside the cube is. Both
  bounds are computed in float64 from the query's offset to the cell faces,
  less ``h * 2^-20`` for the binning's rounding, times (1 - 2^-16): a point
  they cut off has a rounded d2 of at least the k-th, so it changes nothing.
  A query still open after ``R_MAX`` rings goes to a list that the next
  level searches from scratch with cells ``LEVEL_FACTOR`` times wider (all
  points binned anew), while a level's cells stay within
  ``LEVEL_BUDGET`` and each level settles at least half of what it took;
  what is left (isolated points) ``knn_tail`` finishes, one warp a query,
  over every point whose d2 is at most the k-th the last level found, the
  warp's 32 lists merged at the end.
- **brute** (``knn_mean_dist``, the first design): every query
  against every point through shared-memory tiles. Taken when the grid
  cannot separate the points (a cell would hold more than n / 16 of them:
  all points coincident or in one cell), for clouds of fewer than
  ``GRID_MIN_POINTS`` points, and for clouds with a non-finite coordinate.

``knn_grid_plain`` is the grid search written in torch (the same plan, the
same bounds in the same float64 operations, the same ring order, the same
tail), for the CPU tests of the plan; it counts the pairs it tests as the
kernels do.

The kernels keep sorted lists of at most ``K_MAX`` = 256 distances a thread
and raise a ``KernelLimitError`` (a ``ValueError``) above it; the plain
versions have no limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from nerfjax_torch import tracing

K_MAX = 256
ELEMENTS_PER_CHUNK = 1 << 26  # query rows x points of one chunk of the plain version
CELL_TARGET = 0.5  # points in a point's cell, in units of k (at least CELL_MIN)
CELL_MIN = 8
GRID_MIN_POINTS = 4096  # below this the brute kernel is quicker than the grid's set-up
R_MAX = 2  # rings of cells a grid query searches before it goes to the next level
LEVELS = 8  # grid levels at most, each LEVEL_FACTOR times coarser than the one before
LEVEL_FACTOR = 2
# a coarser level runs only while a point's cube of cells holds at most this many points on average
# (sum of cell counts squared / n x (2 R_MAX + 1)^3): one thread searches a query's cube alone
LEVEL_BUDGET = 131_072
TAIL_PAIRS = 2e8  # open queries x points below which the brute tail beats another level
CELL_BITS = 21  # bits of a cell coordinate in the packed key
BOUND_SHRINK = 1.0 - 2.0**-16
SLACK = 2.0**-20  # of h: the binning's rounding at the faces

launch_counts = {"knn_bin": 0, "knn_scatter": 0, "knn_mark": 0, "knn_grid": 0, "knn_tail": 0, "knn_mean_dist": 0}
# the last card call: {"route", "plan", "pairs" (int64 [1], on the card), "tail" (queries the brute tail took),
# "levels" (grid levels run)}
last_run: dict = {}


class KernelLimitError(ValueError):
    """k above the kernel's K_MAX on a CUDA tensor."""


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


tracing.register_counters("knn", launch_counts)


def _check(points: torch.Tensor) -> None:
    if points.dim() != 2 or points.shape[1] != 3 or points.dtype != torch.float32:
        raise ValueError(f"points must be a float32 [n, 3] tensor, got {points.dtype} {tuple(points.shape)}")


def _mean_of_roots(vals: torch.Tensor, k: int) -> torch.Tensor:
    """[m, >= k] ascending d2 -> the mean of the first k roots: added one
    column at a time in float64 (the ascending order), divided by k."""
    acc = torch.zeros(vals.shape[0], dtype=torch.float64, device=vals.device)
    for j in range(k):
        acc = acc + vals[:, j].double().sqrt()
    return (acc / k).float()


def _dist2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[m, 3] queries, [c, 3] points -> d2 [m, c], each operation rounded on
    its own in float32 (dx = x_j - x_i)."""
    dx = p[None, :, 0] - q[:, 0, None]
    dy = p[None, :, 1] - q[:, 1, None]
    dz = p[None, :, 2] - q[:, 2, None]
    return dx * dx + dy * dy + dz * dz


def knn_mean_distances_plain(points: torch.Tensor, k: int, queries: torch.Tensor | None = None) -> torch.Tensor:
    """The kernels' arithmetic in torch on points' device, by brute force:
    chunks of queries against all points, explicit differences,
    ``torch.topk(largest=False)`` of d2 with the query's own column set to
    +inf, then the square roots added one column at a time in float64.
    ``queries`` (int64 indices) computes only those rows: the result is
    ``knn_mean_distances_plain(points, k)[queries]``."""
    _check(points)
    n = points.shape[0]
    k = min(int(k), n - 1)
    rows_of = torch.arange(n, device=points.device) if queries is None else queries.to(points.device).long()
    m = rows_of.shape[0]
    if n <= 1 or k <= 0:
        return torch.zeros(m, dtype=torch.float32, device=points.device)
    out = torch.empty(m, dtype=torch.float32, device=points.device)
    rows = max(1, ELEMENTS_PER_CHUNK // n)
    for start in range(0, m, rows):
        stop = min(start + rows, m)
        own = rows_of[start:stop]
        d2 = _dist2(points[own], points)
        d2[torch.arange(stop - start, device=points.device), own] = float("inf")
        out[start:stop] = _mean_of_roots(torch.topk(d2, k, dim=1, largest=False, sorted=True).values, k)
    return out


# -- the grid plan ---------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """The grid route's geometry, or ``route == "brute"``.

    ``origin``: the cloud's float32 minimum per axis (as float64); ``h``
    the cell side (float64), ``inv_h`` = 1 / h; a point's cell is
    floor((x - origin) * inv_h) per axis in float64, clamped to
    [0, dims - 1]; ``buckets``: the power-of-two hash table's size;
    ``cell_load``: the mean over points of their bucket's point count;
    ``iterations``: the counts it took to choose h; ``extent``: the cloud's
    float64 extent per axis. The search's depth is the module's constants:
    ``R_MAX`` rings a level, at most ``LEVELS`` levels (level L: h *
    LEVEL_FACTOR^L, ``level``), a level L >= 1 only while its cells hold
    sum(count^2) (2 R_MAX + 1)^3 <= LEVEL_BUDGET n (``level_fits``)."""

    route: str
    k: int
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    h: float = 0.0
    inv_h: float = 0.0
    dims: tuple[int, int, int] = (1, 1, 1)
    buckets: int = 1
    cell_load: float = 0.0
    iterations: int = 0
    extent: tuple[float, float, float] = (0.0, 0.0, 0.0)

    def level(self, L: int) -> tuple[float, float, tuple[int, int, int]]:
        """(h, inv_h, dims) of level L."""
        h = self.h * LEVEL_FACTOR**L
        inv_h = 1.0 / h
        return h, inv_h, tuple(int(math.floor(e * inv_h)) + 1 for e in self.extent)


def _cells(points: torch.Tensor, origin: torch.Tensor, inv_h: float, dims: torch.Tensor) -> torch.Tensor:
    """[n, 3] int64 cell coordinates (the kernels' float64 operations)."""
    c = torch.floor((points.double() - origin) * inv_h).long()
    return torch.minimum(c.clamp_min(0), dims - 1)


def _cell_hash(c: torch.Tensor) -> torch.Tensor:
    """The kernels' 32-bit hash of int64 cell coordinates [..., 3]."""
    m = 0xFFFFFFFF
    h = ((c[..., 0] * 0x9E3779B1) & m) ^ ((c[..., 1] * 0x85EBCA77) & m) ^ ((c[..., 2] * 0xC2B2AE3D) & m)
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & m
    return h ^ (h >> 15)


def _cell_key(c: torch.Tensor) -> torch.Tensor:
    return (c[..., 0] << (2 * CELL_BITS)) | (c[..., 1] << CELL_BITS) | c[..., 2]


def _bin(points: torch.Tensor, origin, inv_h: float, dims, buckets: int):
    """(bucket [n], key [n] int64, points per bucket [buckets] int32) of
    contiguous float32 points: ``knn_bin`` on a CUDA tensor, torch on the
    CPU (the same float64 operations, the same hash)."""
    n, dev = points.shape[0], points.device
    count = torch.zeros(buckets, dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        points = points.contiguous()
        bucket = torch.empty(n, dtype=torch.int32, device=dev)
        key = torch.empty(n, dtype=torch.int64, device=dev)
        _launched("knn_bin", _lib().nerf_knn_bin(
            points.data_ptr(), n, *origin, inv_h, *dims, buckets - 1, bucket.data_ptr(), key.data_ptr(),
            count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
        return bucket, key, count
    cells = _cells(points, torch.tensor(origin, dtype=torch.float64), inv_h, torch.tensor(dims))
    bucket = _cell_hash(cells) & (buckets - 1)
    count += torch.bincount(bucket, minlength=buckets).to(torch.int32)
    return bucket, _cell_key(cells), count


def knn_plan(points: torch.Tensor, k: int, *, route: str = "auto", h: float | None = None) -> GridPlan:
    """Choose the route and, for the grid, the cell side: start from the
    cloud's extent over (n / want)^(1/3) cells, want = CELL_TARGET x k
    (at least CELL_MIN), and scale h by sqrt(want / cell_load) (a surface's
    law; clamped to [1/64, 4]) until the load is within 2x of want, at most
    8 counts, each one host sync (``knn_bin`` counts on the card). h is at
    least the extent over 2^21 - 2, so that a cell coordinate fits the key.
    ``route`` "grid" or "brute" forces one and ``h`` the cell side (the
    tests)."""
    _check(points)
    if route not in ("auto", "grid", "brute"):
        raise ValueError(f"route must be auto, grid or brute, got {route!r}")
    n = points.shape[0]
    k = min(int(k), n - 1)
    brute = GridPlan("brute", k)
    if route == "brute" or n <= 1 or k <= 0 or (route == "auto" and n < GRID_MIN_POINTS):
        return brute
    lo, hi = (v.double().cpu() for v in torch.aminmax(points, dim=0))
    ext = hi - lo
    if not (torch.isfinite(lo).all() and torch.isfinite(hi).all()) or float(ext.max()) <= 0.0:
        if route == "grid":
            raise ValueError("the grid route needs finite points that are not all coincident")
        return brute
    want = max(CELL_TARGET * k, float(CELL_MIN))
    buckets = 1 << max(4, math.ceil(math.log2(2 * n)))
    emax = float(ext.max())
    h_min = emax / (2**CELL_BITS - 2)
    forced = h is not None
    h = float(h) if forced else emax / max(1.0, n / want) ** (1.0 / 3.0)
    if forced and h < h_min:
        raise ValueError(f"h = {h} is below the extent over 2^{CELL_BITS} - 2 ({h_min})")
    for it in range(1, 9):
        h = max(h, h_min)
        inv_h = 1.0 / h
        dims = torch.floor(ext * inv_h).long() + 1
        count = _bin(points, lo.tolist(), inv_h, dims.tolist(), buckets)[2]
        load = float((count.double() ** 2).sum()) / n
        if it == 8 or forced or want / 2 <= load <= 2 * want or (h <= h_min and load > want):
            break
        h *= min(4.0, max(1.0 / 64.0, math.sqrt(want / load)))
    plan = GridPlan("grid", k, tuple(float(v) for v in lo), h, inv_h, tuple(int(v) for v in dims), buckets, load,
                    it, tuple(float(v) for v in ext))
    if route == "auto" and load > n / 16:
        return dataclasses.replace(plan, route="brute")
    return plan


def level_fits(count: torch.Tensor, n: int) -> bool:
    """Whether a coarser level's cells (``count`` points a bucket) are
    small enough for one thread a query: in int64, exactly."""
    return int((count.long() ** 2).sum()) * (2 * R_MAX + 1) ** 3 <= LEVEL_BUDGET * n


def _cube_lb(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, slack: float) -> torch.Tensor:
    """Least d2 from queries q [m, 3] (float64, relative to the origin) to
    the boxes [lo, hi] [m or 1, 3], shrunk for the binning and rounding."""
    g = torch.clamp(torch.maximum(lo - q, q - hi), min=0.0)
    g = torch.clamp(g - slack, min=0.0)
    return (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2]) * BOUND_SHRINK


def _ring_lb(q: torch.Tensor, c: torch.Tensor, r: int, h: float, dims) -> torch.Tensor:
    """Least d2 from queries q [m, 3] in cell c [3] to any cell outside the
    cube of cells within r of c (cells of side h, ``dims`` of them per axis);
    -1 where that cube covers the grid (the search is complete)."""
    best = torch.full((q.shape[0],), float("inf"), dtype=torch.float64, device=q.device)
    for a in range(3):
        ca = int(c[a])
        if ca - r > 0:
            best = torch.minimum(best, q[:, a] - float(ca - r) * h)
        if ca + r + 1 < dims[a]:
            best = torch.minimum(best, float(ca + r + 1) * h - q[:, a])
    g = torch.clamp(torch.clamp(best, min=0.0) - h * SLACK, min=0.0)
    lb = g * g * BOUND_SHRINK
    return torch.where(torch.isinf(best), torch.full_like(lb, -1.0), lb)


def _shell(r: int):
    """The cells at Chebyshev distance r, in the kernels' order."""
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if max(abs(dx), abs(dy), abs(dz)) == r:
                    yield dx, dy, dz


def knn_grid_plain(points: torch.Tensor, k: int, plan: GridPlan) -> tuple[torch.Tensor, int, int]:
    """The grid route in torch: (mean distances [n], pairs tested, queries
    the brute tail took). Equal to ``knn_mean_distances_plain`` on every
    cloud; the pairs are what the kernels count (d2 evaluated, the query's
    own point left out), for the same plan."""
    _check(points)
    if plan.route != "grid":
        raise ValueError("knn_grid_plain runs a grid plan")
    n, k, dev = points.shape[0], plan.k, points.device
    origin = torch.tensor(plan.origin, dtype=torch.float64, device=dev)
    q_all = points.double() - origin
    out = torch.empty(n, dtype=torch.float32, device=dev)
    kth = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)  # an open query's k-th so far
    open_q = torch.arange(n, device=dev)
    pairs = 0
    for L in range(LEVELS):
        h, inv_h, dims_t = plan.level(L)
        dims = torch.tensor(dims_t, device=dev)
        cells = _cells(points, origin, inv_h, dims)
        keys = _cell_key(cells)
        bucket = _cell_hash(cells) & (plan.buckets - 1)
        count = torch.bincount(bucket, minlength=plan.buckets)
        if L > 0 and not level_fits(count, n):
            break
        order = torch.argsort(bucket, stable=True)
        start = torch.zeros(plan.buckets + 1, dtype=torch.int64, device=dev)
        start[1:] = torch.cumsum(count, 0)
        s_key = keys[order]
        still = []
        by_key = open_q[torch.argsort(keys[open_q], stable=True)]
        groups = torch.unique_consecutive(keys[by_key], return_counts=True)[1].tolist()
        first = 0
        for count in groups:
            qi = by_key[first:first + count]
            first += count
            c = cells[qi[0]]
            q, qd = points[qi], q_all[qi]
            best = torch.full((count, k), float("inf"), dtype=torch.float32, device=dev)
            done = torch.zeros(count, dtype=torch.bool, device=dev)
            for r in range(R_MAX + 1):
                for d in _shell(r):
                    cc = c + torch.tensor(d, device=dev)
                    if bool(((cc < 0) | (cc >= dims)).any()):
                        continue
                    lo = cc.double() * h
                    active = ~done & ~(best[:, -1].double() <= _cube_lb(qd, lo[None], (lo + h)[None], h * SLACK))
                    if not bool(active.any()):
                        continue
                    b = int(_cell_hash(cc) & (plan.buckets - 1))
                    span = order[int(start[b]):int(start[b + 1])]
                    span = span[s_key[int(start[b]):int(start[b + 1])] == _cell_key(cc)]
                    if span.numel() == 0:
                        continue
                    d2 = _dist2(q[active], points[span])
                    own = span[None, :] == qi[active][:, None]
                    d2[own] = float("inf")
                    pairs += d2.numel() - int(own.sum())
                    best[active] = torch.topk(torch.cat([best[active], d2], 1), k, dim=1, largest=False,
                                              sorted=True).values
                ring = _ring_lb(qd, c, r, h, dims_t)
                done |= (ring < 0) | (best[:, -1].double() <= ring)
                if bool(done.all()):
                    break
            out[qi[done]] = _mean_of_roots(best[done], k)
            kth[qi] = best[:, -1]
            still.append(qi[~done])
        settled = len(open_q) - sum(len(v) for v in still)
        open_q = torch.cat(still) if still else open_q[:0]
        if len(open_q) == 0 or len(open_q) * n <= TAIL_PAIRS or (L > 0 and settled < len(open_q)):
            break
    for i in open_q.tolist():  # the tail: all points at most the last level run's k-th
        d2 = _dist2(points[i:i + 1], points)[0]
        d2[i] = float("inf")
        d2 = torch.where(d2 <= kth[i], d2, torch.full_like(d2, float("inf")))
        out[i] = _mean_of_roots(torch.topk(d2, k, largest=False, sorted=True).values[None], k)[0]
        pairs += n - 1
    return out, pairs, len(open_q)


# -- the kernels -------------------------------------------------------------------------


# the C entries of csrc/knn.cu: "p" a pointer (or a CUDA stream), "i" an int, "d" a double
SIGNATURES = {
    "nerf_knn_mean_dist": "piipp",
    "nerf_knn_bin": "piddddiiiipppp",
    "nerf_knn_scatter": "pippppppp",
    "nerf_knn_mark": "piipp",
    "nerf_knn_grid": "ppippppiiddddiiiiipppppp",
    "nerf_knn_tail": "ppiipppppp",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "d": ctypes.c_double}


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (first call only) and load csrc/knn.cu, with typed entries.
    Whatever fails on the way (nvcc missing or refusing to run, the library
    not loading, a symbol missing) is raised as a RuntimeError."""
    from nerfjax_torch import _build

    try:
        lib = _build.load("knn")
        for name, args in SIGNATURES.items():
            getattr(lib, name).argtypes = [_CTYPES[a] for a in args]
            getattr(lib, name).restype = ctypes.c_int
        lib.nerf_knn_max_k.argtypes, lib.nerf_knn_max_k.restype = [], ctypes.c_int
    except RuntimeError:
        raise
    except Exception as e:
        raise RuntimeError(f"csrc/knn.cu could not be built or loaded: {type(e).__name__}: {e}") from e
    if lib.nerf_knn_max_k() != K_MAX:
        raise RuntimeError(f"csrc/knn.cu takes k up to {lib.nerf_knn_max_k()}, ops/knn.py expects {K_MAX}")
    return lib


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"knn_mean_distances: {name} launch failed with cudaError {err}")
    launch_counts[name] += 1


def _grid_run(pts: torch.Tensor, plan: GridPlan, out: torch.Tensor, stream: int, marks) -> tuple:
    """The grid route's kernels on a contiguous [n, 3] tensor, level by
    level: the binning and sort at the level's cell side, the ring search
    of the open queries (all points at level 0), until none is open, the
    levels run out, a level's cells grow past ``level_fits``, a coarser
    level settles fewer than half of the queries it took, or the open
    queries x n fall to ``TAIL_PAIRS`` (host syncs a level to read the
    counts); then the brute tail. ``marks`` records
    a CUDA event after the first sort, after the ring searches and after the
    tail. Returns (pairs, tail queries, levels run)."""
    lib, dev, n, T, k = _lib(), pts.device, pts.shape[0], plan.buckets, plan.k
    ox, oy, oz = plan.origin
    i32 = dict(dtype=torch.int32, device=dev)
    start = torch.zeros(T + 1, **i32)
    s_pts = torch.empty(n, 4, dtype=torch.float32, device=dev)
    s_key = torch.empty(n, dtype=torch.int64, device=dev)
    pairs = torch.zeros(1, dtype=torch.int64, device=dev)
    lists = [torch.empty(n, **i32) for _ in range(2)]
    t0 = torch.empty(n, dtype=torch.float32, device=dev)
    queries, n_open = None, n
    for L in range(LEVELS):
        h, inv_h, (gx, gy, gz) = plan.level(L)
        bucket, key, count = _bin(pts, plan.origin, inv_h, (gx, gy, gz), T)
        if L > 0 and not level_fits(count, n):
            break
        flags = torch.zeros(2 * T + 1, **i32)  # cursor, impure flags, the level's open count
        cursor, impure, tail_count = flags[:T], flags[T:2 * T], flags[2 * T:]
        start[1:] = torch.cumsum(count, 0, dtype=torch.int32)
        _launched("knn_scatter", lib.nerf_knn_scatter(pts.data_ptr(), n, bucket.data_ptr(), key.data_ptr(),
                                                      start.data_ptr(), cursor.data_ptr(), s_pts.data_ptr(),
                                                      s_key.data_ptr(), stream))
        _launched("knn_mark", lib.nerf_knn_mark(s_key.data_ptr(), n, T - 1, impure.data_ptr(), stream))
        if L == 0:
            marks("sort")
        tail_idx = lists[L % 2]
        _launched("knn_grid", lib.nerf_knn_grid(
            pts.data_ptr(), None if queries is None else queries.data_ptr(), n_open, s_pts.data_ptr(),
            s_key.data_ptr(), start.data_ptr(), impure.data_ptr(), n, k, ox, oy, oz, h, gx, gy, gz, T - 1,
            R_MAX, out.data_ptr(), tail_idx.data_ptr(), t0.data_ptr(), tail_count.data_ptr(),
            pairs.data_ptr(), stream))
        was_open, (n_open, queries, levels_run) = n_open, (int(tail_count), tail_idx, L + 1)
        if n_open == 0 or n_open * n <= TAIL_PAIRS or (L > 0 and 2 * n_open > was_open):
            break
    marks("search")
    _launched("knn_tail", lib.nerf_knn_tail(pts.data_ptr(), s_pts.data_ptr(), n, k, queries.data_ptr(), t0.data_ptr(),
                                            tail_count.data_ptr(), out.data_ptr(), pairs.data_ptr(), stream))
    return pairs, n_open, levels_run


def knn_mean_distances(points: torch.Tensor, k: int, *, plan: GridPlan | None = None,
                       split: dict | None = None) -> torch.Tensor:
    """[n] float32 mean distance of each of the float32 [n, 3] ``points`` to
    its k nearest other points, on points' device: the kernels on a CUDA
    tensor (any strides: a view is copied to a contiguous tensor first), the
    plain version on a CPU tensor. ``plan``: ``knn_plan``'s for these points
    (the tests and the timings force a route or reuse one), chosen here when
    None.
    ``split``: filled with the milliseconds of the plan, the binning and
    sort, the ring search and the tail (CUDA events, synchronized at the
    end). ``last_run`` holds the route, the plan, the pair count, the grid
    levels run and the queries the brute tail took: a CLI's call leaves
    them there for the caller that ran it (``chip_smoke.py`` phase C)."""
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
    events = []

    def marks(label: str) -> None:
        if split is not None:
            events.append((label, torch.cuda.Event(enable_timing=True)))
            events[-1][1].record()

    marks("start")
    pts = points.contiguous()
    if plan is None:
        plan = knn_plan(pts, k)
    elif plan.k != k:
        raise ValueError(f"the plan is for k = {plan.k}, not {k}")
    marks("plan")
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    last_run.clear()
    if plan.route == "grid":
        pairs, tails, levels = _grid_run(pts, plan, out, stream, marks)
    else:
        marks("sort")
        _launched("knn_mean_dist", _lib().nerf_knn_mean_dist(pts.data_ptr(), n, k, out.data_ptr(), stream))
        marks("search")
        pairs, tails, levels = torch.full((1,), n * (n - 1), dtype=torch.int64, device=points.device), 0, 0
    marks("tail")
    last_run.update(route=plan.route, plan=plan, pairs=pairs, tail=tails, levels=levels)
    if split is not None:
        events[-1][1].synchronize()
        for (_, a), (label, b) in zip(events, events[1:]):
            split[label] = a.elapsed_time(b)
    return out
