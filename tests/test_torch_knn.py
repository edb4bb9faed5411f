"""K6's plain version (nerfjax_torch.ops.knn) and the port's outlier filters
against nerfjax's: its native C++ kNN (within 4 float32 ulps: ``g++ -O3
-march=native`` may contract d2 into FMAs where the port rounds every
operation), its numpy fallback (rtol 1e-5: float64 throughout, d2 by the
expansion sq_i + sq_j - 2 p_i.p_j), and the keep sets of
remove_statistical_outliers and filter_radius_outliers.

The grid route's plan (``knn_plan``: binning, sort, the ring and cell
bounds) runs here in torch (``knn_grid_plain``), held to the brute-force
plain version and to the bounds' own promise on points at cell faces. The
kernels themselves run only on a card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from nerfjax import native
from nerfjax.colmap import outliers as joutliers
from nerfjax_torch.colmap import outliers
from nerfjax_torch.ops import knn
from tests.test_torch_native_ref import nerfjax_native

SIZES = [1, 2, 21, 500, 5_000]
MAX_ULPS = 4


def _cloud(n: int, seed: int, kind: str = "normal") -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    if kind == "duplicates" and n > 4:
        pts[1::4] = pts[0::4][: len(pts[1::4])]  # every fourth point twice, and one point three times
        pts[3] = pts[0]
    elif kind == "coincident":
        pts[:] = np.float32([0.25, -1.5, 3.0])
    return pts


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    big = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / np.spacing(np.maximum(big, np.float32(1e-38)))


@pytest.fixture(scope="module", autouse=True)
def _nerfjax_native_loaded():
    """nerfjax's own calls below (its filter's kNN) take its native path."""
    nerfjax_native()


def _native(pts: np.ndarray, k: int) -> np.ndarray:
    nerfjax_native()
    out = native.knn_mean_distances_native(pts, k)
    assert out is not None, "nerfjax's native library did not load"
    return out


def test_nerfjax_native_library_loaded():
    """The comparisons below are with the native path nerfjax takes wherever
    g++ exists (it builds on first use)."""
    assert nerfjax_native() is not None and native.load() is not None


@pytest.mark.parametrize("kind", ["normal", "duplicates", "coincident"])
@pytest.mark.parametrize("k", [1, 20, "n"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_native_within_4_ulps(n, k, kind):
    k = n if k == "n" else k
    pts = _cloud(n, seed=n + k, kind=kind)
    got = knn.knn_mean_distances_plain(torch.from_numpy(pts), k).numpy()
    want = _native(pts, k)
    assert got.dtype == np.float32 and got.shape == (n,)
    if n <= 1:
        assert np.array_equal(got, np.zeros(n, np.float32)) and np.array_equal(want, got)
        return
    ulps = _ulps(got, want)
    assert ulps.max() <= MAX_ULPS, f"point {int(ulps.argmax())}: {got[ulps.argmax()]} vs native {want[ulps.argmax()]}"
    if kind == "coincident":
        assert not got.any()  # every neighbour is a duplicate at distance 0


@pytest.mark.parametrize("k", [1, 20, "n"])
@pytest.mark.parametrize("n", SIZES[1:])
def test_plain_matches_numpy_fallback(n, k):
    k = n if k == "n" else k
    pts = _cloud(n, seed=3 * n + k)
    got = knn.knn_mean_distances_plain(torch.from_numpy(pts), k).numpy()
    np.testing.assert_allclose(got, joutliers.knn_mean_distances(pts, k), rtol=1e-5, atol=0)


def test_plain_edge_cases():
    pts = torch.from_numpy(_cloud(9, seed=1))
    for k in (0, -3):
        assert torch.equal(knn.knn_mean_distances_plain(pts, k), torch.zeros(9))
    assert torch.equal(knn.knn_mean_distances_plain(pts, 100), knn.knn_mean_distances_plain(pts, 8))
    assert knn.knn_mean_distances_plain(pts[:0], 5).shape == (0,)
    two = torch.tensor([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0]])
    assert torch.equal(knn.knn_mean_distances_plain(two, 5), torch.tensor([5.0, 5.0]))


def test_plain_chunks_agree(monkeypatch):
    """The chunk size (query rows per pass) changes nothing: a chunk of 7
    rows against one of all 500."""
    pts = torch.from_numpy(_cloud(500, seed=2, kind="duplicates"))
    whole = knn.knn_mean_distances_plain(pts, 20)
    monkeypatch.setattr(knn, "ELEMENTS_PER_CHUNK", 7 * 500)
    assert torch.equal(knn.knn_mean_distances_plain(pts, 20), whole)


def test_wrapper_on_the_cpu_is_the_plain_version():
    pts = torch.from_numpy(_cloud(300, seed=5))
    knn.reset_launch_counts()
    assert torch.equal(knn.knn_mean_distances(pts, 20), knn.knn_mean_distances_plain(pts, 20))
    assert torch.equal(knn.knn_mean_distances(pts[:, [2, 0, 1]], 300),
                       knn.knn_mean_distances_plain(pts[:, [2, 0, 1]].contiguous(), 299))
    assert knn.launch_counts == dict.fromkeys(knn.launch_counts, 0) and "knn_grid" in knn.launch_counts
    for bad in (pts.double(), pts[:, :2], pts.reshape(-1)):
        with pytest.raises(ValueError, match="float32 \\[n, 3\\]"):
            knn.knn_mean_distances(bad, 20)
    with pytest.raises(ValueError, match="cpu or cuda"):
        knn.knn_mean_distances(pts.to("meta"), 20)


def test_plain_on_chosen_queries_equals_the_full_call():
    """``queries`` picks rows (in any order, repeated) of the full call."""
    pts = torch.from_numpy(_cloud(700, seed=4, kind="duplicates"))
    q = torch.tensor([5, 3, 699, 0, 3, 1, 350])
    for k in (1, 20, 700):
        assert torch.equal(knn.knn_mean_distances_plain(pts, k, queries=q), knn.knn_mean_distances_plain(pts, k)[q])
    assert knn.knn_mean_distances_plain(pts[:1], 5, queries=torch.tensor([0])).tolist() == [0.0]


# -- the grid plan --------------------------------------------------------------------


def _grid_cloud(kind: str, seed: int) -> np.ndarray:
    """Small clouds of the grid's cases: normal; duplicates; a sphere of
    radius 0.5 with 1 % of points 5-50 radii out (phase C's shape); blobs
    on a surface with outliers (chip_smoke.clustered_cloud); a lattice of
    spacing 0.125; points on the faces of 0.125-cells (some repeated), each
    moved by at most one float32 ulp."""
    rng = np.random.default_rng(seed)
    if kind in ("normal", "duplicates"):
        return _cloud(600, seed, kind)
    if kind == "sphere":
        d = rng.normal(size=(600, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return (d * np.concatenate([np.full(594, 0.5), rng.uniform(2.5, 25.0, 6)])[:, None]).astype(np.float32)
    if kind == "clustered":
        from chip_smoke import clustered_cloud

        return clustered_cloud(600, seed)[0]
    if kind == "lattice":
        g = np.arange(7, dtype=np.float32) * np.float32(0.125) - np.float32(0.5)
        return np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    pts = (np.round(rng.uniform(-0.5, 0.5, (500, 3)) * 8.0) / 8.0).astype(np.float32)
    return np.nextafter(pts, pts + rng.choice([-1.0, 0.0, 1.0], pts.shape).astype(np.float32))


def test_plan_routes():
    """Small clouds, clouds no cell splits, non-finite points and a k of 0
    take the brute kernel; a sphere of 20,000 points takes the grid, with a
    load within 2x of k."""
    rng = np.random.default_rng(0)
    small = torch.from_numpy(_cloud(knn.GRID_MIN_POINTS - 1, 0))
    assert knn.knn_plan(small, 20).route == "brute" and knn.knn_plan(small, 20, route="grid").route == "grid"
    big = torch.from_numpy(_cloud(20_000, 1))
    assert knn.knn_plan(big, 0).route == "brute"
    one = big.clone()
    one[: 15_000] = one[0]
    assert knn.knn_plan(one, 20).route == "brute"
    assert knn.knn_plan(torch.from_numpy(_cloud(20_000, 1, "coincident")), 20).route == "brute"
    with pytest.raises(ValueError, match="not all coincident"):
        knn.knn_plan(torch.from_numpy(_cloud(20_000, 1, "coincident")), 20, route="grid")
    nan = big.clone()
    nan[7, 1] = float("nan")
    assert knn.knn_plan(nan, 20).route == "brute"
    d = rng.normal(size=(20_000, 3))
    sphere = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    plan = knn.knn_plan(sphere, 20)
    assert plan.route == "grid" and 10.0 <= plan.cell_load <= 40.0, plan
    assert plan.iterations <= 8 and 2 ** 14 <= plan.buckets and plan.buckets >= 2 * 20_000
    with pytest.raises(ValueError, match="auto, grid or brute"):
        knn.knn_plan(sphere, 20, route="cells")


@pytest.mark.parametrize("kind", ["normal", "lattice", "faces"])
def test_grid_binning_and_sort(kind):
    """A point's cell is floor((x - origin) / h) in float64 (clamped to the
    grid), its key packs the three coordinates, the hash spreads the keys
    over the buckets, and the sort by bucket keeps every cell's points in
    one bucket."""
    pts = torch.from_numpy(_grid_cloud(kind, 3))
    plan = knn.knn_plan(pts, 20, route="grid", h=None if kind == "normal" else 0.125)
    origin = torch.tensor(plan.origin, dtype=torch.float64)
    cells = knn._cells(pts, origin, plan.inv_h, torch.tensor(plan.dims))
    ref = np.clip(np.floor((pts.numpy().astype(np.float64) - np.array(plan.origin)) * plan.inv_h), 0,
                  np.array(plan.dims) - 1)
    assert np.array_equal(cells.numpy(), ref) and (cells.min(0).values == 0).all()
    keys = knn._cell_key(cells)
    assert torch.equal(keys >> 42, cells[:, 0]) and torch.equal((keys >> 21) & (2**21 - 1), cells[:, 1])
    bucket = knn._cell_hash(cells) & (plan.buckets - 1)
    order = torch.argsort(bucket, stable=True)
    assert (bucket[order][1:] >= bucket[order][:-1]).all()
    per_key = {}
    for key, b in zip(keys.tolist(), bucket.tolist()):
        assert per_key.setdefault(key, b) == b
    shared = np.bincount(np.array(list(per_key.values())))
    assert shared.max() <= 8  # the hash spreads the cells: no bucket holds many
    if kind == "lattice":  # spacing = h: one point a cell
        assert len(per_key) == len(pts)


@pytest.mark.parametrize("k", [1, 20])
@pytest.mark.parametrize("kind", ["normal", "duplicates", "sphere", "clustered", "lattice", "faces"])
def test_grid_search_equals_plain(kind, k, monkeypatch):
    """The grid route in torch equals the brute-force plain version bit for
    bit, with its own cell side and at h = 0.125 (the lattice's spacing,
    the faces' cells), and with one level at r_max = 0 (every query its own
    cell leaves open goes to the tail). The isolated points of the sphere
    reach the tail."""
    pts = torch.from_numpy(_grid_cloud(kind, k))
    want = knn.knn_mean_distances_plain(pts, k)
    h = 0.125 if kind in ("lattice", "faces") else None
    plan = knn.knn_plan(pts, k, route="grid", h=h)
    got, pairs, tails = knn.knn_grid_plain(pts, k, plan)
    assert torch.equal(got, want)
    n = len(pts)
    assert 0 < pairs < n * (n - 1)
    if kind == "sphere":
        assert tails >= 6
    monkeypatch.setattr(knn, "R_MAX", 0)
    monkeypatch.setattr(knn, "LEVELS", 1)
    got0, pairs0, tails0 = knn.knn_grid_plain(pts, k, plan)
    assert torch.equal(got0, want) and tails0 > tails


@pytest.mark.parametrize("kind", ["sphere", "clustered"])
def test_grid_levels_equal_plain(kind, monkeypatch):
    """With TAIL_PAIRS at 0 the open queries go on to the coarser levels
    (cells 2x, 4x, ... wider, all points binned anew, each query searched
    from scratch) while each settles at least half of them; still equal to
    the plain version, and fewer queries reach the tail."""
    pts = torch.from_numpy(_grid_cloud(kind, 2))
    want = knn.knn_mean_distances_plain(pts, 20)
    plan = knn.knn_plan(pts, 20, route="grid")
    monkeypatch.setattr(knn, "R_MAX", 1)
    with pytest.MonkeyPatch.context() as one_level:
        one_level.setattr(knn, "LEVELS", 1)
        _, _, tails_one = knn.knn_grid_plain(pts, 20, plan)
    monkeypatch.setattr(knn, "TAIL_PAIRS", 0)
    got, pairs, tails = knn.knn_grid_plain(pts, 20, plan)
    assert torch.equal(got, want) and tails < tails_one


def test_grid_bounds_are_conservative_at_cell_faces():
    """At points on the faces of 0.125-cells (and one float32 ulp off
    them): the least d2 that _cube_lb gives for a cell is at most the
    rounded d2 to each of its points, and _ring_lb is at most the rounded
    d2 to each point outside the cube of cells within r, for r = 0, 1, 2."""
    pts = torch.from_numpy(_grid_cloud("faces", 11))
    plan = knn.knn_plan(pts, 20, route="grid", h=0.125)
    origin = torch.tensor(plan.origin, dtype=torch.float64)
    cells = knn._cells(pts, origin, plan.inv_h, torch.tensor(plan.dims))
    q = pts.double() - origin
    d2 = knn._dist2(pts, pts)  # [query, point]
    lo = cells.double() * plan.h
    for i in range(0, len(pts), 7):
        cube = knn._cube_lb(q[i:i + 1].expand(len(pts), 3), lo, lo + plan.h, plan.h * knn.SLACK)
        assert (cube <= d2[i].double()).all()
        for r in range(3):
            ring = knn._ring_lb(q[i:i + 1], cells[i], r, plan.h, plan.dims)
            outside = ((cells - cells[i]).abs().amax(1) > r)
            if float(ring) >= 0 and outside.any():
                assert float(ring) <= float(d2[i][outside].min())
    # the margins are needed: without the slack and the shrink, the ring bound
    # of a point on a face would reach the rounded d2 of a point in the next cell
    assert knn.SLACK > 0 and knn.BOUND_SHRINK < 1


def test_ctypes_signatures_match_knn_cu():
    """ops/knn.py's argument types of each C entry of csrc/knn.cu (the
    library itself builds only where nvcc is)."""
    import re
    from pathlib import Path

    src = (Path(knn.__file__).parents[1] / "csrc" / "knn.cu").read_text()
    found = {}
    for name, args in re.findall(r'extern "C" int (nerf_knn_\w+)\((.*?)\)\s*\{', src, re.S):
        kinds = [a.split()[0] for a in args.replace("\n", " ").split(",") if a.strip()]
        found[name] = "".join({"int": "i", "double": "d"}.get(t, "p") for t in kinds)
    assert found == {**knn.SIGNATURES, "nerf_knn_max_k": ""}


def test_lib_types_every_entry(monkeypatch):
    """_lib() gives each entry its argument and result types (a stand-in
    for the built library: the build needs nvcc)."""
    import ctypes
    import types

    from nerfjax_torch import _build

    class Entry:
        def __call__(self):
            return knn.K_MAX

    fake = types.SimpleNamespace(**{name: Entry() for name in (*knn.SIGNATURES, "nerf_knn_max_k")})
    monkeypatch.setattr(_build, "load", lambda name: fake)
    knn._lib.cache_clear()
    try:
        assert knn._lib() is fake
    finally:
        knn._lib.cache_clear()
    for name, args in knn.SIGNATURES.items():
        entry = getattr(fake, name)
        assert entry.restype is ctypes.c_int and len(entry.argtypes) == len(args)
        assert [{"p": ctypes.c_void_p, "i": ctypes.c_int, "d": ctypes.c_double}[a] for a in args] == entry.argtypes


def _threshold(d: np.ndarray, std_ratio: float) -> np.float64:
    return d.mean() + std_ratio * d.std()


@pytest.mark.parametrize("nb, std_ratio", [(20, 2.0), (8, 1.0), (20, 0.5), (50, 2.5)])
@pytest.mark.parametrize("n", [21, 500, 5_000])
def test_statistical_keep_sets_equal_nerfjax(n, nb, std_ratio):
    """The port's keep set (threshold formed on the host with numpy, as
    nerfjax forms it) equals nerfjax's (its native kNN). A point on which
    they differ fails the test unless its distance lies within 4 ulps of
    the threshold; the message names it either way."""
    rng = np.random.default_rng(n + nb)
    pts = rng.normal(size=(n, 3))
    pts[: max(1, n // 50)] += rng.normal(size=(max(1, n // 50), 3)) * 20.0  # planted far points
    got_pts, got = outliers.remove_statistical_outliers(pts, nb, std_ratio, device="cpu")
    want_pts, want = joutliers.remove_statistical_outliers(pts, nb, std_ratio)
    assert got.dtype == want.dtype
    if not np.array_equal(got, want):
        d = knn.knn_mean_distances_plain(torch.from_numpy(pts.astype(np.float32)), nb).numpy()
        thr = np.float32(_threshold(d, std_ratio))
        for i in np.setxor1d(got, want):
            assert _ulps(d[i : i + 1], np.array([thr]))[0] <= MAX_ULPS, (
                f"point {i}: mean distance {d[i]} against threshold {thr}, kept by "
                f"{'the port' if i in got else 'nerfjax'} only")
    else:
        assert np.array_equal(got_pts, want_pts)


def test_statistical_filter_small_clouds_and_stats():
    pts = np.random.default_rng(9).normal(size=(20, 3))
    for fn in (lambda p: outliers.remove_statistical_outliers(p, 20, 2.0, device="cpu"),
               lambda p: joutliers.remove_statistical_outliers(p, 20, 2.0)):
        kept, keep = fn(pts)
        assert kept is pts or np.array_equal(kept, pts)
        assert np.array_equal(keep, np.arange(20))
    outliers.reset_filter_stats()
    stats = outliers.filter_stats
    assert stats == {"outlier_filter": 0.0, "knn": 0.0, "points_kept": None}
    pts = np.random.default_rng(10).normal(size=(400, 3))
    _, keep = outliers.remove_statistical_outliers(pts, 20, 2.0, device="cpu")
    once = stats["knn"]
    _, keep = outliers.remove_statistical_outliers(pts[:300], 20, 2.0, device="cpu")
    assert stats["points_kept"] == len(keep) and 0.0 < once < stats["knn"] <= stats["outlier_filter"]


@pytest.mark.parametrize("radius, min_neighbors, chunk", [(0.5, 5, 2048), (0.25, 3, 100), (2.5, 10, 2048)])
def test_radius_filter_keep_sets_equal_nerfjax(radius, min_neighbors, chunk):
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.normal(scale=0.6, size=(1500, 3)), rng.normal(size=(40, 3)) * 30.0])
    got_pts, got = outliers.filter_radius_outliers(pts, radius, min_neighbors, chunk, device="cpu")
    want_pts, want = joutliers.filter_radius_outliers(pts, radius, min_neighbors, chunk)
    assert np.array_equal(got, want) and np.array_equal(got_pts, want_pts) and 0 < len(got) < len(pts)
    empty = np.zeros((0, 3))
    assert len(outliers.filter_radius_outliers(empty, 0.5, device="cpu")[1]) == 0


def _radius_keep_separate_ops(pts: np.ndarray, radius: float, min_neighbors: int) -> np.ndarray:
    """The port's radius filter in numpy: the dot product as three products
    added in order, every operation rounded on its own (numpy fuses none)."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    sq = x * x + y * y + z * z
    dot = x[:, None] * x[None, :] + y[:, None] * y[None, :] + z[:, None] * z[None, :]
    d2 = sq[:, None] + sq[None, :] - 2.0 * dot
    return np.where((d2 <= radius * radius).sum(axis=1) - 1 >= min_neighbors)[0]


@pytest.mark.parametrize("radius, min_neighbors, chunk", [(0.1, 6, 2048), (0.1, 5, 97), (0.1 * 2**0.5, 12, 500)])
def test_radius_filter_on_a_lattice(radius, min_neighbors, chunk):
    """A lattice whose spacing is the radius (or its face diagonal): every
    pair of neighbours sits on r^2, where one rounding decides. The keep set
    equals the separately rounded form in numpy, the form the card keeps
    bit for bit (tests/test_torch_kernels_cuda.py), and is neither empty nor
    everything."""
    g = np.arange(-6, 7) * 0.1
    pts = np.stack(np.meshgrid(g, g, g[:7], indexing="ij"), axis=-1).reshape(-1, 3) + np.array([0.3, -1.1, 2.7])
    _, got = outliers.filter_radius_outliers(pts, radius, min_neighbors, chunk, device="cpu")
    assert np.array_equal(got, _radius_keep_separate_ops(pts, radius, min_neighbors))
    assert 0 < len(got) < len(pts)
