"""nerfjax_torch's coarse->pdf->fine sampler and render against nerfjax's:
``stratified_sample``, ``sample_pdf``, ``merge_z_vals``, the occupancy
sampler with ``occ_fast_cdf: false`` and the two-pass branch of
``render_rays_planar``, on the same seeded inputs and the same uniforms
(nerfjax's, drawn as its render splits its key: ``split(key, 4)`` ->
``k_strat``, ``k_pdf``; ``uniform(k_strat, (B, S))``, ``uniform(k_pdf,
(B, I))``).

Tolerances. The stratified depths and the merge are the same float32 ops
in the same order: equal within 1e-6. ``sample_pdf``'s CDF is a running
sum: the port adds column by column, XLA's CPU cumsum does not add in
order, so the CDFs differ in the last bits and a depth moves by up to
ulp / pdf x bin width; 5e-5 absolute, as the fast-CDF test allows. Where a
uniform falls on a CDF edge, the two sides may take neighbouring bins; the
inverse CDF is continuous there (one bin's top is the next one's bottom),
so the depth agrees all the same, except in a bin of zero weight (pdf
below 1e-5: nerfjax's denominator guard), where the depth stays within
ulp of the edge on both sides. The whole render is held stage by stage
(``test_two_pass_render_matches_nerfjax`` says how).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax import render as jrender
from nerfjax.config import ConfigNode
from nerfjax.ops import occupancy as jocc
from nerfjax.train import build_fields as jax_build_fields
from nerfjax.train import init_params
from nerfjax_torch import render as R
from nerfjax_torch.checkpoint import params_from_jax
from nerfjax_torch.ops import occupancy as occ
from nerfjax_torch.train import build_fields

SMALL = {"ngp": True, "nerf_type": "small", "hash_n_levels": 6}  # 2 dense + 4 hashed levels, E = 12


def _rays(seed: int, B: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(B, 3)).astype(np.float32)
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 2.5).astype(np.float32)
    d = (rng.uniform(-0.4, 0.4, (B, 3)) - o).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    near = rng.uniform(1.0, 1.6, B).astype(np.float32)
    far = (near + rng.uniform(1.5, 2.5, B)).astype(np.float32)
    return o, d, near, far


def _uniforms(key, B: int, S: int, I: int):
    """The uniforms nerfjax's render_rays_planar draws from ``key``."""
    k_strat, k_pdf = jax.random.split(key, 4)[:2]
    return (np.asarray(jax.random.uniform(k_strat, (B, S), jnp.float32)),
            np.asarray(jax.random.uniform(k_pdf, (B, I), jnp.float32)))


def test_stratified_sample_matches_nerfjax():
    o, d, near, far = _rays(1, 128)
    u = np.random.default_rng(2).uniform(size=(128, 64)).astype(np.float32)
    pj, zj = jrender.stratified_sample(None, *map(jnp.asarray, (o, d, near, far)), 64, u=jnp.asarray(u))
    pt, zt = R.stratified_sample(*map(torch.from_numpy, (o, d, near, far)), 64, u=torch.from_numpy(u))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
    assert (np.diff(zt.numpy(), axis=1) >= 0).all()


def test_sample_pdf_matches_nerfjax():
    """Weights with zero rows, zero runs and one dominant bin per row; the
    samples stay inside the bins' span."""
    rng = np.random.default_rng(3)
    B, M, n = 256, 64, 128
    bins = np.sort(rng.uniform(1.0, 4.0, (B, M)), axis=1).astype(np.float32)
    w = rng.uniform(0.0, 1.0, (B, M - 1)).astype(np.float32)
    w[rng.uniform(size=(B, M - 1)) < 0.5] = 0.0  # zero runs
    w[::7] = 0.0  # zero rows
    w[1::5, 10] = 50.0  # a dominant bin
    u = rng.uniform(size=(B, n)).astype(np.float32)
    zj = np.asarray(jrender.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), n, u=jnp.asarray(u)))
    zt = R.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), n, u=torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(zt, zj, rtol=0, atol=5e-5)
    assert (zt >= bins[:, :1] - 1e-6).all() and (zt <= bins[:, -1:] + 1e-6).all()


def test_sample_pdf_draws_from_the_generator():
    bins = torch.linspace(0.0, 1.0, 9).expand(4, 9).contiguous()
    w = torch.ones(4, 8)
    a = R.sample_pdf(bins, w, 16, generator=torch.Generator().manual_seed(5))
    b = R.sample_pdf(bins, w, 16, u=torch.rand(4, 16, generator=torch.Generator().manual_seed(5)))
    assert torch.equal(a, b)


def test_merge_z_vals_matches_nerfjax():
    o, d, _, _ = _rays(4, 64)
    rng = np.random.default_rng(5)
    zc = np.sort(rng.uniform(1, 4, (64, 16)), axis=1).astype(np.float32)
    zi = rng.uniform(1, 4, (64, 32)).astype(np.float32)
    pj, zj = jrender.merge_z_vals(*map(jnp.asarray, (o, d, zc, zi)))
    pt, zt = R.merge_z_vals(*map(torch.from_numpy, (o, d, zc, zi)))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("M", [8, 32])
def test_slow_cdf_occupancy_sampler_matches_nerfjax(M):
    """occ_fast_cdf: false: sample_pdf over the segment weights, sorted."""
    kw = dict(resolution=16, n_segments=M, fast_cdf=False)
    spec_j, spec_t = jocc.OccupancyGridSpec(**kw), occ.OccupancyGridSpec(**kw)
    o, d, near, far = _rays(10 + M, 256)
    grid = (np.random.default_rng(M).uniform(size=16**3) < 0.3).astype(np.float32) * 0.5
    key = jax.random.PRNGKey(M)
    n = 24
    zj = np.asarray(jocc.occupancy_sample(spec_j, jnp.asarray(grid), key, *map(jnp.asarray, (o, d, near, far)), n))
    xi = torch.from_numpy(np.array(jax.random.uniform(key, (len(o), n), jnp.float32)))
    zt = occ.occupancy_sample(spec_t, *map(torch.from_numpy, (grid, o, d, near, far)), n, xi=xi).numpy()
    np.testing.assert_allclose(zt, zj, rtol=0, atol=5e-5)
    assert (np.diff(zt, axis=1) >= 0).all()


# -- the two-pass render -------------------------------------------------------------


@pytest.fixture(scope="module")
def small_ngp():
    """nerfjax's field and params (table redrawn in [-0.2, 0.2] so that
    sigma and the coarse weights vary along a ray), and the port's field
    holding the same weights."""
    fj = jax_build_fields(ConfigNode(SMALL))[1]
    params = jax.device_get(init_params(ConfigNode(SMALL), jax.random.PRNGKey(3))["model"])
    params["table"] = np.random.default_rng(4).uniform(-0.2, 0.2, params["table"].shape).astype(np.float32)
    ft = build_fields(SMALL)[1].load_params(params_from_jax(params))
    return fj, jax.tree_util.tree_map(jnp.asarray, params), ft


def _jax_pass(fj, pj, o, d, z, dtype):
    """nerfjax's field pass and compositing at depths z [B, S] (the body of
    render_rays_planar's eval_field, off the TPU) -> (rgb_map, weights).
    Compiled, XLA may contract o + d*z into an FMA and move a position by an
    ulp; the exact encode is continuous in it, well inside the tolerances."""
    return tuple(np.asarray(v, np.float32) for v in jax.jit(_jax_pass_jit, static_argnums=(0, 5))(
        fj, pj, *map(jnp.asarray, (o, d, z)), dtype))


def _jax_pass_jit(fj, pj, o, d, z, dtype):
    B, S = z.shape
    pos3 = tuple((o[:, i, None] + d[:, i, None] * z).reshape(-1) for i in range(3))
    view3 = tuple(jnp.broadcast_to(d[:, i, None], (B, S)).reshape(-1) for i in range(3))
    rgb, sigma = fj.apply_planar(pj, pos3, view3, dtype=dtype)
    return jrender.raw2outputs_planar(rgb.reshape(3, B, S), sigma.reshape(B, S), z)


# (train, dtype, atol of one field pass): train=True runs apply_planar on
# both sides; train=False runs nerfjax's XLA forward (off the TPU) against
# the port's fused head (its plain version on the CPU), the same math in
# float32. bf16: each side rounds its bf16 products and sums them in its own
# order, so sigma moves by a bf16 ulp at some points.
RENDER_CASES = {"train_f32": (True, "f32", 2e-5), "eval_f32": (False, "f32", 2e-5), "train_bf16": (True, "bf16", 2e-2)}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_two_pass_render_matches_nerfjax(case, small_ngp):
    """Each stage against nerfjax's on the port's own inputs to it, then
    the whole render against nerfjax's whole render.

    The coarse pass (same depths) within the pass tolerance; the importance
    depths equal nerfjax's ``sample_pdf`` of the port's coarse weights with
    the same uniforms, merged and sorted (5e-5); the fine pass at the port's
    depths within the pass tolerance. End to end the coarse weights differ
    by float32 noise (~1e-7 in f32), and an importance depth moves by that
    CDF difference over its bin's pdf times the bin's width: up to 4e-3 in
    bins of pdf ~1e-4. The end-to-end bound on rgb_fine is 1e-3 (f32) and
    2e-2 (bf16).
    """
    train, dt, atol = RENDER_CASES[case]
    fj, pj, ft = small_ngp
    B, S, I = 64, 16, 32
    o, d, near, far = _rays(20, B)
    key = jax.random.PRNGKey(21)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    u_strat, u_pdf = _uniforms(key, B, S, I)
    got = R.render_rays_planar(ft, ft, *map(torch.from_numpy, (o, d, near, far)), S, I, train=train, dtype=tdt,
                               u_strat=torch.from_numpy(u_strat), u_pdf=torch.from_numpy(u_pdf))
    got = {k: v.detach().float().numpy() for k, v in got.items()}
    assert got["z_vals"].shape == (B, S + I) and got["weights_fine"].shape == (B, S + I)
    z = np.asarray(jrender.stratified_sample(None, *map(jnp.asarray, (o, d, near, far)), S,
                                             u=jnp.asarray(u_strat))[1])
    rgb_c, w_c = _jax_pass(fj, pj, o, d, z, jdt)
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    z_imp = jrender.sample_pdf(None, jnp.asarray(z_mid), jnp.asarray(got["weights_coarse"][:, 1:-1]), I,
                               u=jnp.asarray(u_pdf))
    z_comb = np.sort(np.concatenate([z, np.asarray(z_imp)], axis=1), axis=1)
    rgb_f, _ = _jax_pass(fj, pj, o, d, got["z_vals"], jdt)
    want = jax.jit(lambda *a: jrender.render_rays_planar(fj, pj, fj, pj, key, *a, S, I, train=train, dtype=jdt))(
        *map(jnp.asarray, (o, d, near, far)))
    assert w_c.max(axis=1).min() > 1e-3 and w_c.std() > 1e-2, "degenerate coarse weights"
    np.testing.assert_allclose(got["weights_coarse"], w_c, rtol=0, atol=atol)
    np.testing.assert_allclose(got["rgb_coarse"], rgb_c, rtol=0, atol=atol)
    np.testing.assert_allclose(got["z_vals"], z_comb, rtol=0, atol=5e-5)
    np.testing.assert_allclose(got["rgb_fine"], rgb_f, rtol=0, atol=atol)
    np.testing.assert_allclose(got["rgb_coarse"], np.asarray(want["rgb_coarse"], np.float32), rtol=0, atol=atol)
    np.testing.assert_allclose(got["rgb_fine"], np.asarray(want["rgb_fine"], np.float32), rtol=0,
                               atol=1e-3 if dt == "f32" else 2e-2)


def test_two_pass_render_is_differentiable_and_stops_at_the_importance_depths(small_ngp):
    """Under train the table gets a gradient through both passes; the
    importance depths carry none (nerfjax's stop_gradient)."""
    _, _, ft = small_ngp
    field = build_fields(SMALL, train=True)[1].load_params(ft.params())
    o, d, near, far = map(torch.from_numpy, _rays(22, 16))
    out = R.render_rays_planar(field, field, o, d, near, far, 8, 16, train=True, dtype=torch.float32,
                               generator=torch.Generator().manual_seed(0))
    assert not out["z_vals"].requires_grad
    (out["rgb_fine"].sum() + out["rgb_coarse"].sum()).backward()
    assert field.table.grad is not None and field.table.grad.abs().sum() > 0
