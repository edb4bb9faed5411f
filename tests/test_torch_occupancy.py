"""nerfjax_torch's occupancy grid and sampler against nerfjax's, with the
same injected jitter and ``xi`` (recomputed from nerfjax's key splits).

The field is a polynomial of the position on both sides, evaluated with the
same float32 operations in the same order, so the update's comparison is
about the grid's bookkeeping (partitions, phase, decay, cell centers), not
the NGP field (tests/test_torch_train_step.py covers that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax.ops import occupancy as jocc
from nerfjax_torch.ops import occupancy as occ

R = 16


class _JaxField:
    def query_density_planar(self, params, pos3, **_):
        x, y, z = pos3
        return x * x + y - 0.5 * z, None


class _TorchField:
    def query_density_planar(self, pos3, **_):
        x, y, z = pos3
        return x * x + y - 0.5 * z, None


def _specs(P: int, M: int = 8):
    kw = dict(resolution=R, update_partitions=P, n_segments=M, fast_cdf=True)
    return jocc.OccupancyGridSpec(**kw), occ.OccupancyGridSpec(**kw)


@pytest.mark.parametrize("P,phase", [(1, 0), (4, 0), (4, 1), (4, 2), (4, 3)])
def test_update_grid_matches_nerfjax(P, phase):
    """Equal bit for bit: the same jitter, cell centers, decay and max."""
    spec_j, spec_t = _specs(P)
    grid = np.random.default_rng(P + phase).uniform(0.0, 0.05, R**3).astype(np.float32)
    key = jax.random.PRNGKey(10 + phase)
    n = R**3 // P
    jitter = np.stack([np.asarray(jax.random.uniform(k, (n,), jnp.float32, -0.5, 0.5))
                       for k in jax.random.split(key, 3)])  # occupancy.py:77,99-101
    want = np.asarray(jocc.update_grid(spec_j, jnp.asarray(grid), _JaxField(), None, key, phase=phase))
    got = occ.update_grid(spec_t, torch.from_numpy(grid.copy()), _TorchField(), phase,
                          jitter=torch.from_numpy(jitter)).numpy()
    np.testing.assert_array_equal(got, want)


def _rays(seed: int, B: int = 512):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(B, 3)).astype(np.float32)
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 2.5).astype(np.float32)
    d = (rng.uniform(-0.3, 0.3, (B, 3)) - o).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    near = rng.uniform(0.8, 1.6, B).astype(np.float32)
    far = (near + rng.uniform(1.5, 2.5, B)).astype(np.float32)
    grid = (rng.uniform(0, 1, R**3) < 0.3).astype(np.float32) * 0.5
    return o, d, near, far, grid


@pytest.mark.parametrize("M", [8, 32])
def test_segment_weights_match_nerfjax(M):
    """Bin edges and weights equal bit for bit."""
    spec_j, spec_t = _specs(1, M)
    o, d, near, far, grid = _rays(M)
    ej, wj = jocc.segment_weights(spec_j, *map(jnp.asarray, (grid, o, d, near, far)))
    et, wt = occ.segment_weights(spec_t, *map(torch.from_numpy, (grid, o, d, near, far)))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("M,atol", [(8, 1e-6), (32, 5e-5)])
def test_sample_cdf_fast_matches_nerfjax(M, atol):
    """Depths sorted per ray, inside [near, far], and near nerfjax's: within
    1e-6 absolute over 8 segments (XLA's CPU cumsum over 8 adds in order, as
    the port does); within 5e-5 over 32, where XLA's cumsum does not add in
    order: a CDF one ulp (6e-8) apart moves a depth by up to
    ulp / pdf_min x segment width = 6e-8 / 6e-4 x 0.08 = 8e-6 per ulp."""
    spec_j, spec_t = _specs(1, M)
    o, d, near, far, grid = _rays(100 + M)
    key = jax.random.PRNGKey(M)
    n = 24
    _, w = jocc.segment_weights(spec_j, *map(jnp.asarray, (grid, o, d, near, far)))
    zj = np.asarray(jocc._sample_cdf_fast(key, jnp.asarray(near), jnp.asarray(far), w, n))
    xi = torch.from_numpy(np.asarray(jax.random.uniform(key, (len(o), n), jnp.float32)))
    zt = occ.occupancy_sample(spec_t, *map(torch.from_numpy, (grid, o, d, near, far)), n, xi=xi).numpy()
    np.testing.assert_allclose(zt, zj, rtol=0, atol=atol)
    assert (np.diff(zt, axis=1) >= 0).all()
    assert (zt >= near[:, None]).all() and (zt <= far[:, None]).all()


def test_slow_cdf_sampler_is_not_ported():
    spec = occ.OccupancyGridSpec(resolution=R, fast_cdf=False)
    o, d, near, far, grid = _rays(1, B=4)
    with pytest.raises(NotImplementedError):
        occ.occupancy_sample(spec, *map(torch.from_numpy, (grid, o, d, near, far)), 8)
