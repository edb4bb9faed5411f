"""The hashed-level table gradient's merged designs (K2 exact and K2 b >= 2
on the card: each warp sums its runs of equal indices and adds each run
once), checked on the CPU: ``k2_atomic_count`` and ``k2_lr_atomic_count``
on hand-made positions, and plain-torch emulations of the merges against
``hash_levels_bwd_plain``. The kernels themselves are held against their
plain version on the card (tests/test_torch_kernels_cuda.py)."""

import dataclasses

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


# -- K2 b >= 2: one run per (row, draw, warp of 32 points in a row of n) -------------


def _lr_spec(b: int, gl: int) -> HashGridSpec:
    return dataclasses.replace(SPEC, fwd_corners=b, grad_corners=b, grad_levels=gl)


def _lr_inputs(inputs: str):
    if inputs == "one_position":
        return _one_position(1000)
    if inputs == "rays":  # the fast step's layout: 48 sorted samples a ray
        return _rays(n_rays=40, n_samples=48, seed=4)
    return _xyz(np.random.default_rng(5).uniform(0.0, 1.0, (3, 2000)))


def _merged_lr_plain(spec, g, x, y, z, out):
    """K2 b >= 2's merged design in plain torch: the plain version's terms
    (``hash_bwd_entries``, laid out [b, rows, N]), each run of
    ``k2_lr_runs`` summed in float32 in lane order, then the run sums
    scattered into ``out``, but for runs whose two sums are 0 (over gl
    drawn levels every term is a run of its own)."""
    idx, v0, v1 = he.hash_bwd_entries(spec, g, x, y, z)
    head = he.k2_lr_runs(spec, x, y, z).reshape(-1)
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    n_runs = int(head.sum())
    s0, s1 = (torch.zeros(n_runs).index_add_(0, run, v) for v in (v0, v1))
    add = (s0 != 0) | (s1 != 0)
    return he.table_grad_scatter_plain(idx[head][add], s0[add], s1[add], out)


def _lr_terms(spec, N: int) -> int:
    """b * rows * N: the terms of a b >= 2 plan."""
    return he._grad_corners(spec) * (spec.grad_levels or LH) * N


def _g(N: int, seed: int, zero_from: int | None = None) -> torch.Tensor:
    """[2, LH, N] float32 normal upstream gradient, 0 at points zero_from.. (a
    ray's samples behind its surface)."""
    g = torch.from_numpy(np.random.default_rng(seed).normal(size=(2, LH, N)).astype(np.float32))
    if zero_from is not None:
        g[..., zero_from:] = 0.0
    return g


@pytest.mark.parametrize("gl", [0, 2])
@pytest.mark.parametrize("b", [2, 3, 7])
@pytest.mark.parametrize("inputs", ["one_position", "rays", "uniform"])
def test_lr_merged_sums_match_plain(inputs, b, gl):
    """Within the atomic-order bound 2 * max(n, 8) * 2^-24 * sum|terms| per
    entry of n terms: the merge only reorders each entry's f32 sum."""
    spec = _lr_spec(b, gl)
    x, y, z = _lr_inputs(inputs)
    N, total = x.shape[0], spec.total_table_size
    g = _g(N, 6)
    g[:, :, 100:300] = 0.0  # a band of zero cotangent: its runs add nothing
    got = _merged_lr_plain(spec, g, x, y, z, torch.zeros(2, total))
    ref = he.hash_levels_bwd_plain(spec, g, x, y, z, torch.zeros(2, total))
    mass = he.hash_levels_bwd_plain(spec, g.abs(), x, y, z, torch.zeros(2, total))
    idx = he.hash_bwd_entries(spec, g, x, y, z)[0]
    one = torch.ones(idx.shape[0])
    count = he.table_grad_scatter_plain(idx, one, one, torch.zeros(2, total))
    bound = 2.0 * count.clamp_min(8.0) * 2.0**-24 * mass + 1e-30
    assert bool(((got - ref).abs() <= bound).all())
    assert got[:, : he._split_levels(spec)[1][0]["offset"]].abs().max() == 0 and np.count_nonzero(got.numpy()) > 0
    runs = int(he.k2_lr_runs(spec, x, y, z).sum())
    # fewer adds than runs: the zero band's runs add nothing
    assert he.k2_lr_atomic_count(spec, g, x, y, z) < runs <= idx.shape[0]
    if gl:  # over gl drawn levels each term is a run of its own
        assert runs == idx.shape[0]


@pytest.mark.parametrize("gl", [0, 2])
@pytest.mark.parametrize("N", [64, 50])
def test_lr_one_position_gives_one_run_per_warp_row_and_draw(N, gl):
    """Every point at one position: over all levels each (level, draw) of a
    warp is one run, a partial last warp (N = 50) one more; over gl drawn
    levels (the same levels at every point: the draws are keyed on the
    position's bits) every term is one add."""
    for b in (2, 7):
        spec = _lr_spec(b, gl)
        x, y, z = _one_position(N)
        expect = b * gl * N if gl else b * LH * -(-N // 32)
        assert he.k2_lr_atomic_count(spec, _g(N, 8), x, y, z) == expect


@pytest.mark.parametrize("gl", [0, 2])
def test_lr_zero_cotangent_adds_nothing(gl):
    """At one position, N = 128 (4 warps): g = 0 from point 64 on leaves,
    over all levels, the first two warps' runs and, over gl drawn levels,
    the first 64 points' terms; g = 0 everywhere adds nothing."""
    spec = _lr_spec(3, gl)
    x, y, z = _one_position(128)
    half, none = (he.k2_lr_atomic_count(spec, _g(128, 9, zero_from=k), x, y, z) for k in (64, 0))
    assert (half, none) == ((3 * gl * 64, 0) if gl else (3 * LH * 2, 0))


def test_lr_sorted_samples_along_rays_merge():
    spec = _lr_spec(2, 0)
    x, y, z = _rays(n_rays=40, n_samples=48, seed=7)
    N = x.shape[0]
    assert 2 * LH * -(-N // 32) < he.k2_lr_atomic_count(spec, _g(N, 10), x, y, z) < 2 * LH * N


def test_lr_distinct_neighbours_give_one_add_per_term():
    """Points on a line along x, three cells of the coarsest hashed level
    apart: neighbouring lanes' planned entries differ at every level and
    draw, so no run merges, and each nonzero term is one add (at levels
    where a point sits on a lattice point the residual mass, and so the
    residual draws' terms, are 0), over all levels and over gl drawn
    levels alike."""
    N = 16
    x = (np.arange(N) * 3 + 0.5) / he._split_levels(SPEC)[1][0]["scale"]
    assert x.max() < 1.0
    x, y, z = _xyz(np.stack([x, np.full(N, 0.5), np.full(N, 0.5)]))
    for b, gl in ((2, 0), (7, 0), (3, 2)):
        spec = _lr_spec(b, gl)
        g = _g(N, 11)
        _, v0, v1 = he.hash_bwd_entries(spec, g, x, y, z)
        assert int(he.k2_lr_runs(spec, x, y, z).sum()) == _lr_terms(spec, N)
        nonzero = int(((v0 != 0) | (v1 != 0)).sum())
        assert 0 < nonzero < _lr_terms(spec, N)
        assert he.k2_lr_atomic_count(spec, g, x, y, z) == nonzero


# -- K2 b >= 2 over gl drawn levels: one thread per point over its draws --------------


def _gl_kernel_plain(spec, g, x, y, z, out):
    """K2 b >= 2 over gl drawn levels as the card runs it, in plain torch:
    per point, per draw r its level l (``_draw_levels``), per planned
    corner j the term (g[l]*coef_j)*scale in float32, added on its own
    unless its two values are 0. Returns (out, the terms added)."""
    _, hashed = he._split_levels(spec)
    Lh, N = len(hashed), x.shape[0]
    gl, b = spec.grad_levels, he._grad_corners(spec)
    scale = float(np.float32(Lh / gl))
    sel, coef = he._hash_plan(spec, hashed, x, y, z, b)  # [b, Lh, N]
    ids = he._draw_levels(x, y, z, Lh, gl, he.LEVEL_SALT)  # [gl, N]
    n = torch.arange(N)
    idx, v0, v1 = [], [], []
    for r in range(gl):
        l = ids[r]
        for j in range(b):
            c = coef[j, l, n]
            idx.append(sel[j, l, n] + hashed[0]["offset"])
            v0.append((g[0, l, n] * c) * scale)
            v1.append((g[1, l, n] * c) * scale)
    idx, v0, v1 = torch.cat(idx), torch.cat(v0), torch.cat(v1)
    add = (v0 != 0) | (v1 != 0)
    return he.table_grad_scatter_plain(idx[add], v0[add], v1[add], out), int(add.sum())


@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("gl", range(1, LH))
def test_gl_kernel_order_matches_plain(gl, b):
    """Every gl of 1..Lh-1: the card's order and zero skip over uniform
    points and one ray's sorted samples, with a band of zero cotangent,
    within the atomic-order bound of hash_levels_bwd_plain; its adds are
    k2_lr_atomic_count's; for gl >= 2 some point draws one level twice,
    and that level's planned entries take both draws' terms."""
    spec = _lr_spec(b, gl)
    a = np.random.default_rng(12).uniform(0.0, 1.0, (3, 600))
    rx, ry, rz = _rays(n_rays=2, n_samples=100, seed=13)
    x, y, z = (torch.cat([torch.from_numpy(a[i].astype(np.float32)), r]) for i, r in enumerate((rx, ry, rz)))
    N, total = x.shape[0], spec.total_table_size
    g = _g(N, 14)
    g[:, :, 200:300] = 0.0
    got, adds = _gl_kernel_plain(spec, g, x, y, z, torch.zeros(2, total))
    ref = he.hash_levels_bwd_plain(spec, g, x, y, z, torch.zeros(2, total))
    mass = he.hash_levels_bwd_plain(spec, g.abs(), x, y, z, torch.zeros(2, total))
    idx = he.hash_bwd_entries(spec, g, x, y, z)[0]
    one = torch.ones(idx.shape[0])
    count = he.table_grad_scatter_plain(idx, one, one, torch.zeros(2, total))
    bound = 2.0 * count.clamp_min(8.0) * 2.0**-24 * mass + 1e-30
    assert bool(((got - ref).abs() <= bound).all()) and np.count_nonzero(got.numpy()) > 0
    assert adds == he.k2_lr_atomic_count(spec, g, x, y, z) < b * gl * N
    ids = he._draw_levels(x, y, z, LH, gl, he.LEVEL_SALT)
    twice = (ids[:, None, :] == ids[None, :, :]).sum((0, 1)) > gl  # a point that drew one level twice
    assert bool(twice.any()) == (gl >= 2)
    if gl >= 2:
        n = int(torch.nonzero(twice)[0])
        one_point = [c[n : n + 1] for c in (x, y, z)]
        _, hashed = he._split_levels(spec)
        level = int(torch.mode(ids[:, n]).values)  # the level drawn twice
        leader = int(he._hash_plan(spec, hashed, *one_point, b)[0][0, level, 0]) + hashed[0]["offset"]
        terms = he.hash_bwd_entries(spec, torch.ones(2, LH, 1), *one_point)[0]
        assert int((terms == leader).sum()) >= 2
