"""nerfjax_torch's Otsu threshold against nerfjax's, and its int64 counts
where nerfjax's float32 histogram stops counting (2^24 per bin)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax.ops.otsu import otsu_threshold as otsu_jax
from nerfjax_torch.ops.otsu import otsu_threshold


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_otsu_matches_nerfjax(seed):
    # bimodal, like a sigma volume: empty space near 0 and a dense mode;
    # float32 throughout on both sides and counts far below 2^24: equal
    rng = np.random.default_rng(seed)
    v = np.concatenate([
        rng.exponential(0.05, 200_000), rng.normal(6.0, 1.5, 30_000).clip(0)
    ]).astype(np.float32)
    t_jax = float(otsu_jax(jnp.asarray(v)))
    t = float(otsu_threshold(torch.from_numpy(v)))
    assert abs(t - t_jax) <= 1e-6 * abs(t_jax)


def _otsu_reference(v: np.ndarray) -> float:
    """skimage's formulation in float64 with exact integer counts."""
    v = v.astype(np.float64)
    vmin, vmax = v.min(), v.max()
    span = max(vmax - vmin, 1e-12)
    idx = np.clip(((v - vmin) / span * 256).astype(np.int64), 0, 255)
    hist = np.bincount(idx, minlength=256).astype(np.float64)
    centers = vmin + (np.arange(256) + 0.5) * span / 256
    w1 = np.cumsum(hist)
    w2 = np.cumsum(hist[::-1])[::-1]
    m1 = np.cumsum(hist * centers) / np.maximum(w1, 1e-12)
    m2 = (np.cumsum((hist * centers)[::-1]) / np.maximum(w2[::-1], 1e-12))[::-1]
    return float(centers[np.argmax(w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2)])


@pytest.fixture(scope="module")
def beyond_2_24():
    """(volume, exact threshold, bin width): 2^25 empty voxels (one bin,
    twice what a float32 count can hold), a low mode of 2M voxels near 1.0
    and a dense mode of 2M near 6.0."""
    rng = np.random.default_rng(7)
    v = np.concatenate([
        np.zeros(1 << 25, np.float32),
        rng.normal(1.0, 0.3, 2_000_000).clip(0.05),
        rng.normal(6.0, 0.5, 2_000_000).clip(0.05),
    ]).astype(np.float32)
    return v, _otsu_reference(v), (v.max() - v.min()) / 256


def test_otsu_counts_beyond_2_24_per_bin(beyond_2_24):
    """A 512^3 sigma volume puts ~1.2e8 empty voxels in one bin. Here 2^25
    zeros fill bin 0 and the port agrees with skimage's formulation under
    exact counting (float64) to well within a bin. (On this volume float32
    class sums, even with exact counts, land 5 bins off.)"""
    v, exact, bin_width = beyond_2_24
    t = float(otsu_threshold(torch.from_numpy(v)))
    assert abs(t - exact) <= 1e-3 * bin_width


def test_nerfjax_otsu_diverges_beyond_2_24(beyond_2_24):
    """Records the reference fault the port does not copy (ROADMAP Queue 3):
    nerfjax's float32 histogram stops counting the empty bin at 2^24, and on
    this volume its threshold lands bins away from the exact one."""
    v, exact, bin_width = beyond_2_24
    t_jax = float(otsu_jax(jnp.asarray(v)))
    assert abs(t_jax - exact) >= 3 * bin_width
