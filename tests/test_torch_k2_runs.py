"""The exact hashed-level table gradient's merged design (K2 exact on the
card: each warp sums its runs of equal indices and adds each run once),
checked on the CPU: ``k2_atomic_count`` on hand-made positions, and a
plain-torch emulation of the merge against ``hash_levels_bwd_plain``. The
kernel itself is held against its plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from nerfjax_torch.fields.ngp import HashGridSpec
from nerfjax_torch.ops import hash_encode as he

SPEC = HashGridSpec(n_levels=8, log2_hashmap_size=15, extra_dense_levels=1)
LH = len(he._split_levels(SPEC)[1])


def _xyz(a: np.ndarray):
    return [torch.from_numpy(np.ascontiguousarray(c, dtype=np.float32)) for c in a]


def _one_position(N: int):
    return _xyz(np.tile(np.float32([[0.3], [0.6], [0.2]]), (1, N)))


def _rays(n_rays: int = 4, n_samples: int = 192, seed: int = 0):
    """Ray-major sorted samples along a few rays through [0, 1]^3, as a fine
    pass lays them out: [3, n_rays * n_samples]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.2, 0.8, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(-0.15, 0.15, (n_rays, n_samples)), axis=1)
    p = np.clip(o[:, None, :] + d[:, None, :] * z[:, :, None], 0.0, 1.0)
    return _xyz(p.reshape(-1, 3).T)


def _warp_level_pairs(N: int) -> int:
    """The (warp, level) pairs that lanes t = l*N + n form, 32 lanes a warp."""
    t = np.arange(LH * N)
    return len(set(zip(t // 32, t // N)))


def test_one_position_gives_one_run_per_warp_and_corner():
    N = 64
    x, y, z = _one_position(N)
    assert he.k2_atomic_count(SPEC, x, y, z) == 8 * LH * N // 32 == 8 * _warp_level_pairs(N)


def test_warps_that_straddle_a_level_do_not_merge_across_it():
    N = 50
    x, y, z = _one_position(N)
    pairs = _warp_level_pairs(N)
    assert pairs > -(-LH * N // 32)  # some warp holds the end of one level and the start of the next
    assert he.k2_atomic_count(SPEC, x, y, z) == 8 * pairs


def test_sorted_samples_along_rays_merge():
    x, y, z = _rays()
    N = x.shape[0]
    count = he.k2_atomic_count(SPEC, x, y, z)
    assert 8 * _warp_level_pairs(N) <= count < 8 * LH * N


def test_distinct_neighbours_give_one_add_per_corner():
    """Points on a line along x, spaced more than a cell of the coarsest
    hashed level: every lane's cell differs from the previous lane's at
    every level, and (x ^ c) & mask keeps distinct x distinct."""
    N = 48
    x = (np.arange(N) + 0.5) / N
    x, y, z = _xyz(np.stack([x, np.full(N, 0.5), np.full(N, 0.5)]))
    assert he._split_levels(SPEC)[1][0]["scale"] > N
    assert he.k2_atomic_count(SPEC, x, y, z) == 8 * LH * N


def _merged_plain(spec, g, x, y, z, out):
    """The merged design's arithmetic in plain torch: per corner, each run of
    equal indices (``k2_runs``) summed in float32, then the run sums
    scattered into ``out``."""
    _, hashed = he._split_levels(spec)
    idx = torch.stack(he._hash_level_indices(spec, hashed, x, y, z)).reshape(8, -1) + hashed[0]["offset"]
    w = torch.stack(he._corner_weights(hashed, x, y, z)).reshape(8, -1)
    head = he.k2_runs(spec, x, y, z)
    for c in range(8):
        run = torch.cumsum(head[c].to(torch.int64), 0) - 1
        n_runs = int(head[c].sum())
        sums = [torch.zeros(n_runs).index_add_(0, run, g[p].reshape(-1) * w[c]) for p in range(2)]
        he.table_grad_scatter_plain(idx[c][head[c]], sums[0], sums[1], out)
    return out


@pytest.mark.parametrize("inputs", ["one_position", "rays", "uniform"])
def test_merged_sums_match_plain(inputs):
    """Within the atomic-order bound 2 * max(n, 8) * 2^-24 * sum|terms| per
    entry of n terms: the merge only reorders each entry's f32 sum."""
    if inputs == "one_position":
        x, y, z = _one_position(1000)
    elif inputs == "rays":
        x, y, z = _rays(seed=1)
    else:
        x, y, z = _xyz(np.random.default_rng(2).uniform(0.0, 1.0, (3, 2000)))
    N, total = x.shape[0], SPEC.total_table_size
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(2, LH, N)).astype(np.float32))
    got = _merged_plain(SPEC, g, x, y, z, torch.zeros(2, total))
    ref = he.hash_levels_bwd_plain(SPEC, g, x, y, z, torch.zeros(2, total))
    mass = he.hash_levels_bwd_plain(SPEC, g.abs(), x, y, z, torch.zeros(2, total))
    _, hashed = he._split_levels(SPEC)
    idx = (torch.stack(he._hash_level_indices(SPEC, hashed, x, y, z)) + hashed[0]["offset"]).reshape(-1)
    one = torch.ones(idx.shape[0])
    count = he.table_grad_scatter_plain(idx, one, one, torch.zeros(2, total))
    bound = 2.0 * count.clamp_min(8.0) * 2.0**-24 * mass + 1e-30
    assert bool(((got - ref).abs() <= bound).all())
    assert got[:, : hashed[0]["offset"]].abs().max() == 0 and np.count_nonzero(got.numpy()) > 0
