"""K6's plain version (nerfjax_torch.ops.knn) and the port's outlier filters
against nerfjax's: its native C++ kNN (within 4 float32 ulps: ``g++ -O3
-march=native`` may contract d2 into FMAs where the port rounds every
operation), its numpy fallback (rtol 1e-5: float64 throughout, d2 by the
expansion sq_i + sq_j - 2 p_i.p_j), and the keep sets of
remove_statistical_outliers and filter_radius_outliers.

The kernel itself runs only on a card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from nerfjax import native
from nerfjax.colmap import outliers as joutliers
from nerfjax_torch.colmap import outliers
from nerfjax_torch.ops import knn

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


def _native(pts: np.ndarray, k: int) -> np.ndarray:
    out = native.knn_mean_distances_native(pts, k)
    assert out is not None, "nerfjax's native library did not load"
    return out


def test_nerfjax_native_library_loaded():
    """The comparisons below are with the native path nerfjax takes wherever
    g++ exists (it builds on first use)."""
    assert native.load() is not None


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
    assert knn.launch_counts == {"knn_mean_dist": 0}
    for bad in (pts.double(), pts[:, :2], pts.reshape(-1)):
        with pytest.raises(ValueError, match="float32 \\[n, 3\\]"):
            knn.knn_mean_distances(bad, 20)
    with pytest.raises(ValueError, match="cpu or cuda"):
        knn.knn_mean_distances(pts.to("meta"), 20)


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
