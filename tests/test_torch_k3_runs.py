"""The table-gradient scatter's merged design (K3 on the card: each warp
sums its runs of equal indices and adds each run once, as a float2),
checked on the CPU: ``k3_atomic_count`` on hand-made indices and on the
dense levels' staged gradient of sorted ray samples, and a plain-torch
emulation of the merge against ``table_grad_scatter_plain``. The kernel
itself is held against its plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from nerfjax_torch.fields.ngp import HashGridSpec
from nerfjax_torch.ops import hash_encode as he

SPEC = HashGridSpec(n_levels=8, log2_hashmap_size=15, extra_dense_levels=1)
DENSE = he._split_levels(SPEC)[0]
T = he._dense_width(DENSE)


def _rays(n_rays: int = 5, n_samples: int = 150, seed: int = 0):
    """Ray-major sorted samples along a few rays through [0, 1]^3, as a fine
    pass lays them out: x, y, z [n_rays * n_samples]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.2, 0.8, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(-0.15, 0.15, (n_rays, n_samples)), axis=1)
    p = np.clip(o[:, None, :] + d[:, None, :] * z[:, :, None], 0.0, 1.0).reshape(-1, 3).T
    return [torch.from_numpy(np.ascontiguousarray(c, dtype=np.float32)) for c in p]


def _staged(seed: int = 0):
    """K5's staging of the dense levels' exact gradient at sorted ray
    samples: (idx, v0, v1) in (level, corner, point) order."""
    x, y, z = _rays(seed=seed)
    g = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=(2, len(DENSE), x.shape[0])).astype(np.float32))
    return he.dense_levels_bwd_plain(SPEC, g, x, y, z)


@pytest.mark.parametrize("K", [1, 31, 32, 33, 100])
def test_one_repeated_index_gives_one_add_per_warp(K):
    idx = torch.full((K,), 7, dtype=torch.int32)
    assert he.k3_atomic_count(idx, T) == -(-K // 32)


def test_distinct_indices_give_one_add_per_entry():
    idx = torch.randperm(T, generator=torch.Generator().manual_seed(0))[:1000].to(torch.int32)
    assert he.k3_atomic_count(idx, T) == 1000


def test_out_of_range_indices_add_nothing():
    """Indices outside [0, T) are no adds; a row of them is one no-add run
    whatever their values, and it splits the runs around it."""
    idx = torch.tensor([3, 3, -1, T, T + 5, 3, 3] + [9] * 25, dtype=torch.int32)
    head = he.k3_runs(idx, T)
    assert head.tolist()[:8] == [True, False, True, False, False, True, False, True]
    assert he.k3_atomic_count(idx, T) == 3  # 3 | 3 | 9
    assert he.k3_atomic_count(torch.tensor([-1, T, T + 1], dtype=torch.int32), T) == 0


def test_sorted_ray_samples_merge():
    idx, _, _ = _staged()
    K = idx.shape[0]
    count = he.k3_atomic_count(idx, T)
    assert -(-K // 32) <= count < K // 2  # neighbouring samples of a ray share dense cells
    # the same entries in a random order hardly merge
    perm = torch.randperm(K, generator=torch.Generator().manual_seed(1))
    assert he.k3_atomic_count(idx[perm], T) > 0.9 * K


def _merged_plain(idx, g0, g1, out):
    """The merged design's arithmetic in plain torch: each warp run
    (``k3_runs``) summed in float32, then the run sums of indices in range
    scattered into ``out`` (the float2 add: both planes of a run together)."""
    head = he.k3_runs(idx, out.shape[1])
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    n = int(head.sum())
    sums = [torch.zeros(n).index_add_(0, run, g) for g in (g0, g1)]
    return he.table_grad_scatter_plain(idx[head], sums[0], sums[1], out)


def _inputs(kind: str):
    rng = np.random.default_rng({"one_index": 2, "staged": 3, "uniform": 4, "ragged": 5}[kind])
    if kind == "staged":
        return _staged(seed=3)
    K = {"one_index": 1000, "uniform": 4096, "ragged": 1001}[kind]
    if kind == "one_index":
        idx = np.full(K, 11)
    else:
        idx = rng.integers(0, 64, K)  # few entries: many runs of one index in a row
        idx = np.sort(idx) if kind == "ragged" else idx
        idx[::13] = T + 3  # dropped
        idx[::17] = -2
    g0, g1 = rng.normal(size=(2, K)).astype(np.float32)
    return torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(g0), torch.from_numpy(g1)


@pytest.mark.parametrize("kind", ["one_index", "staged", "uniform", "ragged"])
def test_merged_sums_match_plain(kind):
    """Within the atomic-order bound 2 * max(n, 8) * 2^-24 * sum|terms| per
    entry of n terms: the merge only reorders each entry's f32 sum; indices
    outside [0, T) are dropped, into a column slice of a wider gradient
    (the encode's backward hands K3 the dense columns only)."""
    idx, g0, g1 = _inputs(kind)
    grad = torch.zeros(2, T + 50)
    got = _merged_plain(idx, g0, g1, grad[:, :T])
    ref = he.table_grad_scatter_plain(idx, g0, g1, torch.zeros(2, T))
    mass = he.table_grad_scatter_plain(idx, g0.abs(), g1.abs(), torch.zeros(2, T))
    one = torch.ones_like(g0)
    count = he.table_grad_scatter_plain(idx, one, one, torch.zeros(2, T))
    bound = 2.0 * count.clamp_min(8.0) * 2.0**-24 * mass + 1e-30
    assert bool(((got - ref).abs() <= bound).all())
    assert not grad[:, T:].any() and bool((got != 0).any())
    assert he.k3_atomic_count(idx, T) <= int(((idx >= 0) & (idx < T)).sum())


def test_scatter_rejects_an_out_without_contiguous_rows():
    idx, g0, g1 = _inputs("uniform")
    with pytest.raises(ValueError):
        he.table_grad_scatter(idx, g0, g1, torch.zeros(T, 2).t())
