"""The feature-last encode's table gradient as the card computes it
(``hashgrid_bwd_kernel``: one thread per (level, point), each warp 32
points in a row of n at one level, its runs of equal entries summed and
added once unless both sums are 0), checked on the CPU:

  * the plain table gradient (``hashgrid_bwd_plain``, which the wrapper and
    the autograd encode take on the CPU) against ``jax.grad`` of nerfjax's
    ``hashgrid_encode``, at specs with dense levels and positions on the
    domain's faces and edges, within 2 * max(n, 8) * 2^-24 * sum |terms|
    per entry of n terms (the two sum each entry's terms in another order);
  * ``hashgrid_bwd_add_count``, the kernel's float2 adds, against a brute
    count written out loop by loop, with zero rows, zero levels, an all-zero
    cotangent and runs that cross a warp's edge;
  * a plain-torch emulation of the kernel's arithmetic (run sums, then one
    add a run whose sums are not both 0) against ``hashgrid_bwd_plain``
    within the same bound.

The kernel itself is held against its plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax.config import ConfigNode
from nerfjax.fields import ngp as jngp
from nerfjax.train import build_fields as jax_build_fields
from nerfjax_torch.fields.ngp import HashGridSpec
from nerfjax_torch.ops import hash_encode as he
from nerfjax_torch.train import build_fields

SMALL = {"ngp": True, "nerf_type": "small", "hash_n_levels": 6}
CFGS = {"small": SMALL, "small_ed1": {**SMALL, "hash_extra_dense_levels": 1},
        "small8_ed2": {**SMALL, "hash_n_levels": 8, "hash_extra_dense_levels": 2}}
SPEC = HashGridSpec(n_levels=6, log2_hashmap_size=12, extra_dense_levels=1)


def _faces(n: int, seed: int) -> np.ndarray:
    """n uniform points, then every point of the domain's 8 corners, and for
    each axis points with that coordinate 0 or 1 (the faces) and two
    coordinates 0 or 1 (the edges)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 3)).astype(np.float32)
    corners = np.array([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)], np.float32)
    faces = rng.uniform(size=(48, 3)).astype(np.float32)
    rows = np.arange(48)
    faces[rows, rows % 3] = (rows // 3) % 2
    faces[rows[::2], (rows[::2] + 1) % 3] = 1.0
    return np.concatenate([corners, faces, x, np.float32([[0.999999, 0.5, 0.0]])])


def _rays(n_rays: int, n_samples: int, seed: int) -> np.ndarray:
    """Ray-major sorted samples along a few rays through [0, 1]^3 (as a
    render's fine pass lays them out), [n_rays * n_samples, 3]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.2, 0.8, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(-0.15, 0.15, (n_rays, n_samples)), axis=1)
    return np.clip(o[:, None, :] + d[:, None, :] * z[:, :, None], 0.0, 1.0).reshape(-1, 3).astype(np.float32)


def _x01(inputs: str, N: int) -> torch.Tensor:
    if inputs == "one_position":  # off every level's lattice: no corner weight is 0
        return torch.tensor([[0.3137, 0.6071, 0.2219]]).expand(N, 3).contiguous()
    if inputs == "rays":
        return torch.from_numpy(_rays(-(-N // 96), 96, 1)[:N])
    if inputs == "faces":
        return torch.from_numpy(_faces(N, 2)[:N])
    return torch.from_numpy(np.random.default_rng(3).uniform(size=(N, 3)).astype(np.float32))


def _g(N: int, L: int, zero: str, seed: int = 4) -> torch.Tensor:
    g = torch.from_numpy(np.random.default_rng(seed).normal(size=(N, 2 * L)).astype(np.float32))
    if zero == "all":
        g.zero_()
    elif zero == "rows":  # points 0..N/2 (whole warps and a part of one)
        g[: N // 2] = 0.0
    elif zero == "levels":  # levels 0, 2, 4 in both planes
        g[:, 0:L:2] = 0.0
        g[:, L::2] = 0.0
    return g


def _scatter_bound(spec, g, x01) -> torch.Tensor:
    idx, v0, v1 = he.hashgrid_bwd_entries_plain(spec, g.abs(), x01)
    one = torch.ones_like(v0)
    zeros = lambda: torch.zeros(2, spec.total_table_size)  # noqa: E731
    mass = he.table_grad_scatter_plain(idx, v0, v1, zeros())
    count = he.table_grad_scatter_plain(idx, one, one, zeros())
    return 2.0 * count.clamp_min(8.0) * 2.0**-24 * mass + 1e-30


# -- the plain table gradient against nerfjax ---------------------------------------------


@pytest.mark.parametrize("zero", ["none", "rows"])
@pytest.mark.parametrize("cfg", list(CFGS))
def test_plain_table_gradient_matches_jax_grad(cfg, zero):
    js = jax_build_fields(ConfigNode(CFGS[cfg]))[1].spec
    ts = build_fields(CFGS[cfg])[1].spec
    assert any(not lp["use_hash"] for lp in ts.level_params())
    x = _faces(400, 5)
    planes = np.random.default_rng(6).uniform(-1, 1, (2, ts.total_table_size)).astype(np.float32)
    g = _g(len(x), ts.n_levels, zero, seed=7)
    xt = torch.from_numpy(x)
    got = he.hashgrid_bwd(ts, g, xt, torch.zeros(2, ts.total_table_size))
    assert torch.equal(got, he.hashgrid_bwd_plain(ts, g, xt, torch.zeros(2, ts.total_table_size)))
    p = torch.from_numpy(planes).requires_grad_(True)
    (he.hashgrid_encode(ts, p, xt) * g).sum().backward()
    assert torch.equal(p.grad, got)  # the autograd encode's backward is the wrapper's
    gn = g.numpy()
    want = np.asarray(jax.grad(lambda q: jnp.sum(jngp.hashgrid_encode(js, q, jnp.asarray(x)) * gn))(
        jnp.asarray(planes)))
    assert np.abs(want).sum() > 0
    assert np.all(np.abs(got.numpy() - want) <= _scatter_bound(ts, g, xt).numpy())


# -- the float2 adds the kernel issues --------------------------------------------------------


def _brute_add_count(spec, g, x01) -> int:
    """Loop by loop: for each level, corner and warp of 32 points from a
    multiple of 32, the runs of equal entries, counted where a term is not
    0 in either plane."""
    idx, v0, v1 = he.hashgrid_bwd_entries_plain(spec, g, x01)
    L, N = spec.n_levels, x01.shape[0]
    idx, v0, v1 = (t.reshape(L, 8, N).tolist() for t in (idx, v0, v1))
    count = 0
    for l in range(L):
        for c in range(8):
            for w in range(0, N, 32):
                runs = []
                for n in range(w, min(w + 32, N)):
                    nonzero = v0[l][c][n] != 0 or v1[l][c][n] != 0
                    if n == w or idx[l][c][n] != idx[l][c][n - 1]:
                        runs.append(nonzero)
                    else:
                        runs[-1] = runs[-1] or nonzero
                count += sum(runs)
    return count


@pytest.mark.parametrize("zero", ["none", "rows", "levels", "all"])
@pytest.mark.parametrize("inputs", ["one_position", "rays", "faces", "uniform"])
def test_add_count_matches_a_brute_count(inputs, zero):
    x01 = _x01(inputs, 333)  # 10 warps and a part of one
    g = _g(x01.shape[0], SPEC.n_levels, zero)
    assert he.hashgrid_bwd_add_count(SPEC, g, x01) == _brute_add_count(SPEC, g, x01)


@pytest.mark.parametrize("N", [1, 31, 32, 33, 64, 100])
def test_one_position_gives_one_add_per_warp_level_and_corner(N):
    """Every lane holds the same entries: one run per (level, corner, warp),
    and a run that would span lanes 31 and 32 is two."""
    x01 = _x01("one_position", N)
    g = _g(N, SPEC.n_levels, "none")
    assert he.hashgrid_bwd_add_count(SPEC, g, x01) == SPEC.n_levels * 8 * -(-N // 32)
    head, _ = he.hashgrid_bwd_runs(SPEC, g, x01)
    assert torch.equal(head, (torch.arange(N) % 32 == 0).expand_as(head))


def test_zero_cotangent_adds_nothing():
    x01 = _x01("rays", 200)
    assert he.hashgrid_bwd_add_count(SPEC, _g(200, SPEC.n_levels, "all"), x01) == 0


def test_samples_along_rays_merge():
    """Sorted samples of one ray share cells at the coarse levels: fewer
    adds than terms, at least one per (level, corner, warp)."""
    x01 = _x01("rays", 960)
    count = he.hashgrid_bwd_add_count(SPEC, _g(960, SPEC.n_levels, "none"), x01)
    assert SPEC.n_levels * 8 * 30 <= count < SPEC.n_levels * 8 * 960


# -- the kernel's arithmetic, emulated ---------------------------------------------------------


def _fused_plain(spec, g, x01, out):
    """``hashgrid_bwd_kernel``'s arithmetic in plain torch: each run of
    ``hashgrid_bwd_runs`` summed in float32, then every run whose two sums
    are not both 0 scattered into ``out``."""
    idx, v0, v1 = he.hashgrid_bwd_entries_plain(spec, g, x01)
    head, _ = he.hashgrid_bwd_runs(spec, g, x01)
    head = head.reshape(-1)
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    sums = [torch.zeros(int(head.sum())).index_add_(0, run, v) for v in (v0, v1)]
    keep = (sums[0] != 0) | (sums[1] != 0)
    return he.table_grad_scatter_plain(idx[head][keep], sums[0][keep], sums[1][keep], out)


@pytest.mark.parametrize("zero", ["none", "rows", "levels"])
@pytest.mark.parametrize("inputs", ["one_position", "rays", "faces"])
def test_fused_sums_match_plain(inputs, zero):
    x01 = _x01(inputs, 1000)
    g = _g(1000, SPEC.n_levels, zero)
    total = SPEC.total_table_size
    got = _fused_plain(SPEC, g, x01, torch.zeros(2, total))
    ref = he.hashgrid_bwd_plain(SPEC, g, x01, torch.zeros(2, total))
    assert bool(((got - ref).abs() <= _scatter_bound(SPEC, g, x01)).all())
    assert torch.equal(got == 0, ref == 0) and bool(got.any())


def test_no_points():
    """N = 0: an empty encode, a zero gradient and no adds."""
    x01 = torch.zeros(0, 3)
    p = torch.zeros(2, SPEC.total_table_size, requires_grad=True)
    enc = he.hashgrid_encode(SPEC, p, x01)
    assert enc.shape == (0, 2 * SPEC.n_levels)
    enc.sum().backward()
    assert not bool(p.grad.any())
    assert he.hashgrid_bwd_add_count(SPEC, torch.zeros(0, 2 * SPEC.n_levels), x01) == 0
