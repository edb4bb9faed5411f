"""nerfjax_torch's point-major ("feature-last", [N, C]) path against
nerfjax's: ``sh4_encode``, ``hashgrid_indices_and_weights``,
``hashgrid_encode`` (forward and table gradient), ``InstantNGP`` and
``VanillaNeRF`` ``query_density``/``apply``/``num_params``, ``raw2outputs``
and ``render_rays``, on the same seeded inputs, at the CPU tests' small
spec (``nerf_type: small``, 6 levels: 2 dense + 4 hashed; with
``hash_extra_dense_levels: 1``, 3 + 3). On the CPU every kernel of the path
takes its plain version.

Tolerances, each with its reason:

  * indices equal exactly; weights within 1 ulp (the same f32 ops in the
    same order; the ulp allows a contraction on nerfjax's side);
  * the encode's forward: both are f32 without rounding to bf16; nerfjax
    sums a level's 8 corners by a 0/1 selector matmul, the port in corner
    order, so each output lies within 8 * 2^-24 * sum_c |f_c w_c| of
    nerfjax's (``_sum_bound``); the table gradient, summed into each entry
    in another order, within 2 * max(n, 8) * 2^-24 * sum |terms| for an
    entry of n terms (``_scatter_bound``);
  * the fields' outputs: the same f32 arithmetic, the MLP products summed in
    another order (torch's CPU matmul against XLA's dot): 2e-6 absolute plus
    1e-6 relative (~8 ulps; the vanilla trunk's features reach ~16, where
    one ulp is 1.9e-6);
  * ``raw2outputs``: the same elementwise ops; the cumulative product and
    the sum over samples may group differently: 1e-6;
  * ``render_rays``: held stage by stage, as ``test_torch_render_hier.py``
    holds the planar render (its docstring says why the importance depths
    move by up to ~4e-3 end to end: the coarse weights' float32 noise over
    a bin's pdf); the passes within 2e-5, the depths within 5e-5, the whole
    render's rgb_fine within 1e-3; the gradients of the fine loss at the
    port's own depths within 1e-4 of the largest entry of each gradient
    (f32 backward sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax import render as jrender
from nerfjax.config import ConfigNode
from nerfjax.fields import ngp as jngp
from nerfjax.fields.encodings import sh4_encode as jax_sh4_encode
from nerfjax.fields.vanilla import VanillaNeRF as JaxVanillaNeRF
from nerfjax.train import build_fields as jax_build_fields
from nerfjax.train import init_params
from nerfjax_torch import render as R
from nerfjax_torch.checkpoint import load_field, params_from_jax, save_field_params
from nerfjax_torch.fields.encodings import sh4_encode, sh4_encode_planar
from nerfjax_torch.fields.ngp import InstantNGP, hashgrid_indices_and_weights
from nerfjax_torch.fields.vanilla import VanillaNeRF
from nerfjax_torch.ops import hash_encode as he
from nerfjax_torch.train import build_fields

SMALL = {"ngp": True, "nerf_type": "small", "hash_n_levels": 6}
CFGS = {"small": SMALL, "small_ed1": {**SMALL, "hash_extra_dense_levels": 1}}
VANILLA = {"ngp": False, "pos_L": 4, "dir_L": 2, "hidden_dim": 32}
# tests/test_hash_encode_fast.py:36-42: the domain's corners, edges and centre
BOUNDARY = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5], [0.999999, 0.5, 0.0], [0.5, 0.5, 0.5]],
                    np.float32)
FIELD_TOL = dict(rtol=1e-6, atol=2e-6)
PASS_ATOL = 2e-5
GRAD_RTOL = 1e-4


def _x01(seed: int, n: int = 1000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([BOUNDARY, rng.uniform(size=(n, 3)).astype(np.float32)])


def _units(seed: int, n: int) -> np.ndarray:
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _specs(name: str):
    cfg = ConfigNode(CFGS[name])
    return jax_build_fields(cfg)[1].spec, build_fields(cfg)[1].spec


def _planes(spec, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)


def _sum_bound(spec, planes: np.ndarray, x01: np.ndarray) -> np.ndarray:
    """8 * 2^-24 * sum_c |f_c w_c| for every output: an f32 sum of 8 terms
    in any order lies within 7 * 2^-24 of that mass of the exact sum."""
    t = torch.from_numpy
    return 8 * 2.0**-24 * he.hashgrid_encode_plain(spec, t(np.abs(planes)), t(x01)).numpy() + 1e-30


def _scatter_bound(spec, g: np.ndarray, x01: np.ndarray) -> np.ndarray:
    """2 * max(n, 8) * 2^-24 * sum |terms| per table entry (n its terms)."""
    idx, v0, v1 = he.hashgrid_bwd_entries_plain(spec, torch.from_numpy(np.abs(g)), torch.from_numpy(x01))
    one = torch.ones_like(v0)
    zeros = lambda: torch.zeros(2, spec.total_table_size)  # noqa: E731
    mass = he.table_grad_scatter_plain(idx, v0, v1, zeros())
    count = he.table_grad_scatter_plain(idx, one, one, zeros())
    return (2.0 * count.clamp_min(8.0) * 2.0**-24 * mass).numpy() + 1e-30


# -- encodings ---------------------------------------------------------------------


def test_sh4_encode_matches_nerfjax_and_the_planar_encode():
    """Within 1e-6 of nerfjax's (values up to ~1.1; one rounding of a
    contracted product), and the planar encode's transpose bit for bit."""
    d = _units(1, 4097)
    got = sh4_encode(torch.from_numpy(d))
    assert got.shape == (4097, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_sh4_encode(jnp.asarray(d))), rtol=0, atol=1e-6)
    assert torch.equal(got, sh4_encode_planar(*torch.from_numpy(d).T).T)
    batched = sh4_encode(torch.from_numpy(d[:12].reshape(3, 4, 3)))
    assert torch.equal(batched.reshape(12, 16), got[:12])


@pytest.mark.parametrize("cfg", list(CFGS))
def test_indices_and_weights_match_nerfjax(cfg):
    """idx equal exactly (hashed: the masked uint32 hash; dense: each corner
    coordinate clipped to [0, r-1], the boundary points' corners beyond the
    last cell), w within 1 ulp."""
    js, ts = _specs(cfg)
    x = _x01(2)
    ij, wj = (np.asarray(a) for a in jngp.hashgrid_indices_and_weights(js, jnp.asarray(x)))
    it, wt = hashgrid_indices_and_weights(ts, torch.from_numpy(x))
    L = ts.n_levels
    assert it.dtype == torch.int32 and it.shape == (len(x), L * 8) and wt.shape == (len(x), L * 8)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_max_ulp(wt.numpy(), wj, maxulp=1)
    levels = ts.level_params()
    assert any(not lp["use_hash"] for lp in levels) and any(lp["use_hash"] for lp in levels)
    r0 = levels[0]["res"]  # the point (1, 1, 1): corner 7 of level 0 clipped to entry (r-1)(1 + r + r^2)
    assert it[1, 7] == (r0 - 1) * (1 + r0 + r0 * r0)


@pytest.mark.parametrize("cfg", list(CFGS))
def test_hashgrid_encode_forward_and_table_gradient_match_nerfjax(cfg):
    js, ts = _specs(cfg)
    x = _x01(3)
    planes = _planes(ts, 4)
    g = np.random.default_rng(5).normal(size=(len(x), 2 * ts.n_levels)).astype(np.float32)
    want = np.asarray(jngp.hashgrid_encode(js, jnp.asarray(planes), jnp.asarray(x)))
    p = torch.from_numpy(planes).requires_grad_(True)
    before = dict(he.launch_counts)
    got = he.hashgrid_encode(ts, p, torch.from_numpy(x))
    assert got.shape == (len(x), 2 * ts.n_levels) and got.dtype == torch.float32
    assert np.all(np.abs(got.detach().numpy() - want) <= _sum_bound(ts, planes, x))
    (got * torch.from_numpy(g)).sum().backward()
    assert he.launch_counts == before  # the CPU takes the plain versions
    gj = np.asarray(jax.grad(lambda q: jnp.sum(jngp.hashgrid_encode(js, q, jnp.asarray(x)) * g))(jnp.asarray(planes)))
    assert np.abs(gj).sum() > 0
    assert np.all(np.abs(p.grad.numpy() - gj) <= _scatter_bound(ts, g, x))


def test_hashgrid_encode_plain_is_the_kernels_order():
    """The plain version's backward entries equal the indices and weights
    times g, in (level, corner, point) order."""
    ts = _specs("small")[1]
    x = torch.from_numpy(_x01(6, 50))
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(len(x), 2 * ts.n_levels)).astype(np.float32))
    idx, v0, v1 = he.hashgrid_bwd_entries_plain(ts, g, x)
    i, w = hashgrid_indices_and_weights(ts, x)
    L, N = ts.n_levels, len(x)
    assert idx.dtype == torch.int32 and idx.shape == (L * 8 * N,)
    assert torch.equal(idx.reshape(L, 8, N), i.reshape(N, L, 8).permute(1, 2, 0))
    assert torch.equal(v1.reshape(L, 8, N), g[:, L:].t()[:, None, :] * w.reshape(N, L, 8).permute(1, 2, 0))
    assert torch.equal(v0.reshape(L, 8, N)[3, 5], g[:, 3] * w[:, 3 * 8 + 5])


def test_hashgrid_encode_rejects_other_feature_counts():
    spec = _specs("small")[1]
    with pytest.raises(ValueError, match="2 features"):
        he.hashgrid_encode(dataclasses.replace(spec, n_features=4), torch.zeros(4, spec.total_table_size),
                           torch.zeros(3, 3))


# -- the fields -----------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(CFGS))
def ngp_pair(request):
    """nerfjax's field and params (table redrawn in [-0.2, 0.2] so that sigma
    and the weights vary) and the port's field holding the same weights."""
    cfg = ConfigNode(CFGS[request.param])
    fj = jax_build_fields(cfg)[1]
    params = jax.device_get(init_params(cfg, jax.random.PRNGKey(3))["model"])
    params["table"] = np.random.default_rng(4).uniform(-0.2, 0.2, params["table"].shape).astype(np.float32)
    ft = build_fields(cfg)[1].load_params(params_from_jax(params))
    return fj, jax.tree_util.tree_map(jnp.asarray, params), ft


@pytest.fixture(scope="module")
def vanilla_pair():
    fj = JaxVanillaNeRF(pos_L=4, dir_L=2, hidden_dim=32)
    params = jax.device_get(fj.init(jax.random.PRNGKey(8)))
    # sigma's pre-activation at init is -0.0016 +- 0.0005 here: scaled and shifted to ~N(0, 1), both signs
    params["density"]["w"] = np.asarray(params["density"]["w"]) * 2000.0
    params["density"]["b"] = np.full_like(params["density"]["b"], 3.2)
    ft = VanillaNeRF(pos_L=4, dir_L=2, hidden_dim=32).load_params(params_from_jax(params))
    return fj, jax.tree_util.tree_map(jnp.asarray, params), ft


def _pos_view(seed: int, n: int = 700):
    """Positions in [-1.1, 1.1] (the clip at the domain's faces) and unit views."""
    pos = np.random.default_rng(seed).uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    return pos, _units(seed + 1, n)


def test_ngp_query_density_and_apply_match_nerfjax(ngp_pair):
    fj, pj, ft = ngp_pair
    pos, view = _pos_view(9)
    sj, fj_feat = fj.query_density(pj, jnp.asarray(pos))
    st, ft_feat = ft.query_density(torch.from_numpy(pos), rng="ignored", train=True)
    assert st.shape == (len(pos), 1) and ft_feat.shape == (len(pos), 16)
    np.testing.assert_allclose(ft_feat.numpy(), np.asarray(fj_feat), **FIELD_TOL)
    np.testing.assert_array_equal(st.numpy(), ft_feat.numpy()[:, :1])
    rgb_j, sig_j = fj.apply(pj, jnp.asarray(pos), jnp.asarray(view))
    rgb_t, sig_t = ft.apply(torch.from_numpy(pos), torch.from_numpy(view))
    assert rgb_t.shape == (len(pos), 3) and sig_t.shape == (len(pos), 1)
    assert float(sig_t.std()) > 1e-2, "degenerate sigma"
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), **FIELD_TOL)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), **FIELD_TOL)
    assert ft.num_params() == fj.num_params(pj)


@pytest.mark.parametrize("train", [False, True])
def test_vanilla_query_density_and_apply_match_nerfjax(vanilla_pair, train):
    """With train, nerfjax draws the sigma noise from its rng; the port gets
    the same draw handed over."""
    fj, pj, ft = vanilla_pair
    pos, view = _pos_view(10, 300)
    rng = jax.random.PRNGKey(11)
    noise = torch.from_numpy(np.array(jax.random.normal(rng, (len(pos), 1), jnp.float32)))
    sj, featj = fj.query_density(pj, jnp.asarray(pos), rng=rng, train=train)
    st, featt = ft.query_density(torch.from_numpy(pos), train=train, noise=noise)
    assert st.shape == (len(pos), 1) and featt.shape == (len(pos), 32)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **FIELD_TOL)
    np.testing.assert_allclose(featt.numpy(), np.asarray(featj), **FIELD_TOL)
    rgb_j, sig_j = fj.apply(pj, jnp.asarray(pos), jnp.asarray(view), rng=rng, train=train)
    rgb_t, sig_t = ft.apply(torch.from_numpy(pos), torch.from_numpy(view), train=train, noise=noise)
    assert 0.05 < float((sig_t > 0).float().mean()) < 0.95, "sigma all cut or all positive"
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), **FIELD_TOL)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), **FIELD_TOL)
    assert ft.num_params() == fj.num_params(pj)


def test_vanilla_noise_from_the_generator():
    ft = VanillaNeRF(pos_L=2, dir_L=1, hidden_dim=8).init(torch.Generator().manual_seed(0))
    pos = torch.rand(20, 3)
    a = ft.query_density(pos, train=True, generator=torch.Generator().manual_seed(1))[0]
    b = ft.query_density(pos, train=True, noise=torch.randn(20, 1, generator=torch.Generator().manual_seed(1)))[0]
    assert torch.equal(a, b)
    assert torch.equal(ft.query_density(pos)[0], ft.query_density(pos, noise=torch.ones(20, 1))[0])


# twins of nerfjax's tests/test_hash_encode_fast.py:70, 88 on the port: the
# planar path rounds the hashed levels' table values to bf16 (3e-3, as there)


def test_planar_apply_matches_pointmajor():
    model = InstantNGP("small").init(torch.Generator().manual_seed(0))
    pos = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (130, 3)).astype(np.float32))
    view = pos / pos.norm(dim=-1, keepdim=True)
    rgb_pm, sigma_pm = model.apply(pos, view)
    rgb_fm, sigma_fm = model.apply_planar(pos.T, view.T, dtype=torch.float32)
    np.testing.assert_allclose(rgb_fm.T.numpy(), rgb_pm.numpy(), atol=3e-3)
    np.testing.assert_allclose(sigma_fm.numpy(), sigma_pm[:, 0].numpy(), atol=3e-3)


def test_planar_vanilla_matches_pointmajor():
    model = VanillaNeRF(pos_L=4, dir_L=2, hidden_dim=32).init(torch.Generator().manual_seed(0))
    pos = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (70, 3)).astype(np.float32))
    view = pos / pos.norm(dim=-1, keepdim=True)
    rgb_pm, sigma_pm = model.apply(pos, view)
    rgb_fm, sigma_fm = model.apply_planar(pos.T, view.T)
    np.testing.assert_allclose(rgb_fm.T.numpy(), rgb_pm.numpy(), atol=1e-5)
    np.testing.assert_allclose(sigma_fm.numpy(), sigma_pm[:, 0].numpy(), atol=1e-5)


@pytest.mark.parametrize("cfg", [SMALL, VANILLA], ids=["ngp", "vanilla"])
def test_loaded_checkpoint_fields_agree_on_both_paths(cfg, tmp_path):
    """A nerfjax param dict through params_from_jax, save_field_params and
    load_field gives a field whose apply and apply_planar agree (f32; the
    NGP's hashed levels bf16-rounded on the planar path, 3e-3)."""
    cfg = ConfigNode(cfg)
    params = jax.device_get(init_params(cfg, jax.random.PRNGKey(12)))
    pos, view = (torch.from_numpy(a) for a in _pos_view(13, 200))
    if cfg["ngp"]:
        save_field_params(tmp_path / "ckpt.pth", cfg, params["model"])
    else:
        save_field_params(tmp_path / "ckpt.pth", cfg, {k: params[k] for k in ("coarse", "fine")})
    field = load_field(tmp_path / "ckpt.pth", cfg, device="cpu")
    rgb_pm, sigma_pm = field.apply(pos, view)
    rgb_fm, sigma_fm = field.apply_planar(pos.T, view.T, dtype=torch.float32)
    atol = 3e-3 if cfg["ngp"] else 1e-5
    np.testing.assert_allclose(rgb_fm.T.numpy(), rgb_pm.numpy(), atol=atol)
    np.testing.assert_allclose(sigma_fm.numpy(), sigma_pm[:, 0].numpy(), atol=atol)
    fine = params["model"] if cfg["ngp"] else params["fine"]
    want = jax_build_fields(cfg)[1].apply(fine, jnp.asarray(pos.numpy()), jnp.asarray(view.numpy()))
    np.testing.assert_allclose(rgb_pm.numpy(), np.asarray(want[0]), **FIELD_TOL)


# -- raw2outputs and render_rays -------------------------------------------------------


@pytest.mark.parametrize("white_bg", [False, True])
@pytest.mark.parametrize("sigma_shape", ["BS1", "BS"])
def test_raw2outputs_matches_nerfjax(white_bg, sigma_shape):
    rng = np.random.default_rng(14)
    B, S = 64, 48
    rgb = rng.uniform(size=(B, S, 3)).astype(np.float32)
    sigma = rng.exponential(2.0, (B, S, 1)).astype(np.float32)
    sigma[::5] = 0.0
    if sigma_shape == "BS":
        sigma = sigma[..., 0]
    z = np.sort(rng.uniform(2.0, 6.0, (B, S)), axis=1).astype(np.float32)
    mj, wj = jrender.raw2outputs(jnp.asarray(rgb), jnp.asarray(sigma), jnp.asarray(z), white_bg, 1e10)
    mt, wt = R.raw2outputs(*map(torch.from_numpy, (rgb, sigma, z)), white_bg, 1e10)
    assert mt.shape == (B, 3) and wt.shape == (B, S)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-6)


def _rays(seed: int, B: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(B, 3)).astype(np.float32)
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 2.5).astype(np.float32)
    d = (rng.uniform(-0.4, 0.4, (B, 3)) - o).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    near = rng.uniform(1.0, 1.6, B).astype(np.float32)
    far = (near + rng.uniform(1.5, 2.5, B)).astype(np.float32)
    return o, d, near, far


def _draws(key, B: int, S: int, I: int):
    """The uniforms and noise nerfjax's render_rays draws from ``key``
    (split(key, 4) -> k_strat, k_pdf, k_noise_c, k_noise_f)."""
    k_strat, k_pdf, k_c, k_f = jax.random.split(key, 4)
    return tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(k_strat, (B, S), jnp.float32), jax.random.uniform(k_pdf, (B, I), jnp.float32),
        jax.random.normal(k_c, (B * S, 1), jnp.float32), jax.random.normal(k_f, (B * (S + I), 1), jnp.float32)))


def _jax_fine_half(fj, pj, o, d, z, noise_key, train: bool):
    """nerfjax's field pass and compositing at depths z [B, S] (render_rays'
    fine half): (rgb_map, weights)."""
    B, S = z.shape
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    dirs = jnp.broadcast_to(d[:, None, :], pts.shape)
    rgb, sigma = fj.apply(pj, pts.reshape(-1, 3), dirs.reshape(-1, 3), rng=noise_key, train=train)
    return jrender.raw2outputs(rgb.reshape(B, S, 3), sigma.reshape(B, S), z)


def _render_case(fj, pj, ft, train: bool, seed: int, B=48, S=16, I=32):
    """The port's render_rays and nerfjax's, each stage held on the port's
    own inputs to it; returns what the gradient test needs."""
    o, d, near, far = _rays(seed, B)
    key = jax.random.PRNGKey(seed + 1)
    u_strat, u_pdf, noise_c, noise_f = _draws(key, B, S, I)
    target = torch.from_numpy(np.random.default_rng(seed + 2).uniform(size=(B, 3)).astype(np.float32))
    got = R.render_rays(ft, ft, *map(torch.from_numpy, (o, d, near, far)), S, I, train=train, u_strat=u_strat,
                        u_pdf=u_pdf, noise_coarse=noise_c, noise_fine=noise_f)
    out = {k: v.detach().numpy() for k, v in got.items()}
    assert out["z_vals"].shape == (B, S + I) and out["rgb_fine"].shape == (B, 3)
    k_noise_c, k_noise_f = jax.random.split(key, 4)[2:]
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    z = np.asarray(jrender.stratified_sample(None, jo, jd, jnp.asarray(near), jnp.asarray(far), S,
                                             u=jnp.asarray(u_strat.numpy()))[1])
    rgb_c, w_c = _jax_fine_half(fj, pj, jo, jd, jnp.asarray(z), k_noise_c, train)
    assert np.asarray(w_c).max(axis=1).min() > 1e-3 and np.asarray(w_c).std() > 1e-2, "degenerate coarse weights"
    np.testing.assert_allclose(out["weights_coarse"], np.asarray(w_c), rtol=0, atol=PASS_ATOL)
    np.testing.assert_allclose(out["rgb_coarse"], np.asarray(rgb_c), rtol=0, atol=PASS_ATOL)
    z_imp = jrender.sample_pdf(None, jnp.asarray(0.5 * (z[:, :-1] + z[:, 1:])),
                               jnp.asarray(out["weights_coarse"][:, 1:-1]), I, u=jnp.asarray(u_pdf.numpy()))
    np.testing.assert_allclose(out["z_vals"], np.sort(np.concatenate([z, np.asarray(z_imp)], 1), 1), rtol=0,
                               atol=5e-5)
    zf = jnp.asarray(out["z_vals"])
    rgb_f, w_f = _jax_fine_half(fj, pj, jo, jd, zf, k_noise_f, train)
    np.testing.assert_allclose(out["rgb_fine"], np.asarray(rgb_f), rtol=0, atol=PASS_ATOL)
    np.testing.assert_allclose(out["weights_fine"], np.asarray(w_f), rtol=0, atol=PASS_ATOL)
    want = jrender.render_rays(fj, pj, fj, pj, key, jo, jd, jnp.asarray(near), jnp.asarray(far), S, I, train=train)
    np.testing.assert_allclose(out["rgb_fine"], np.asarray(want["rgb_fine"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["rgb_coarse"], np.asarray(want["rgb_coarse"]), rtol=0, atol=PASS_ATOL)
    return got, target, (jo, jd, zf, k_noise_f)


def _assert_grads_close(got: dict, want: dict):
    for name, g in got.items():
        ref = np.asarray(want[name])
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(g, ref, rtol=0, atol=GRAD_RTOL * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("train", [False, True])
def test_render_rays_ngp_matches_nerfjax(ngp_pair, train):
    """Both train modes (the NGP field ignores train: no noise, the exact
    forward); under train the table and MLP gradients of the fine loss at
    the port's own fine depths against nerfjax's."""
    fj, pj, ft = ngp_pair
    field = build_fields(SMALL if ft.spec.extra_dense_levels == 0 else CFGS["small_ed1"], train=train)[1]
    field.load_params(ft.params())
    got, target, (jo, jd, zf, kf) = _render_case(fj, pj, field, train, 30)
    if not train:
        assert not got["rgb_fine"].requires_grad
        return
    ((got["rgb_fine"] - target) ** 2).mean().backward()

    def loss(p):
        rgb, _ = _jax_fine_half(fj, p, jo, jd, zf, kf, True)
        return jnp.mean((rgb - jnp.asarray(target.numpy())) ** 2)

    gj = jax.grad(loss)(pj)
    ours = {"table": field.table.grad.numpy(), **{f"dmlp{i}": w.grad.numpy() for i, w in enumerate(field.dmlp)},
            **{f"cmlp{i}": w.grad.numpy() for i, w in enumerate(field.cmlp)}}
    theirs = {"table": gj["table"], **{f"dmlp{i}": lay["w"] for i, lay in enumerate(gj["dmlp"])},
              **{f"cmlp{i}": lay["w"] for i, lay in enumerate(gj["cmlp"])}}
    _assert_grads_close(ours, theirs)


@pytest.mark.parametrize("train", [False, True])
def test_render_rays_vanilla_matches_nerfjax(vanilla_pair, train):
    """Vanilla's two passes with nerfjax's sigma noise handed over (train);
    the same field for both passes, as nerfjax's call with one param set."""
    fj, pj, ft = vanilla_pair
    field = VanillaNeRF(pos_L=4, dir_L=2, hidden_dim=32).load_params(ft.params())
    field.requires_grad_(train)
    got, target, (jo, jd, zf, kf) = _render_case(fj, pj, field, train, 40)
    if not train:
        return
    ((got["rgb_fine"] - target) ** 2).mean().backward()

    def loss(p):
        rgb, _ = _jax_fine_half(fj, p, jo, jd, zf, kf, True)
        return jnp.mean((rgb - jnp.asarray(target.numpy())) ** 2)

    gj = jax.grad(loss)(pj)
    ours = {f"{name}{i}.{k}": getattr(layer, k).grad.numpy()
            for name in ("pos_layers", "skip_layers", "color_layers") for i, layer in enumerate(getattr(field, name))
            for k in ("w", "b")}
    theirs = {f"{name}{i}.{k}": layer[k] for name in ("pos_layers", "skip_layers", "color_layers")
              for i, layer in enumerate(gj[name]) for k in ("w", "b")}
    ours.update({f"{n}.{k}": getattr(getattr(field, n), k).grad.numpy() for n in ("density", "feature")
                 for k in ("w", "b")})
    theirs.update({f"{n}.{k}": gj[n][k] for n in ("density", "feature") for k in ("w", "b")})
    _assert_grads_close(ours, theirs)


@pytest.mark.parametrize("kind", ["ngp", "vanilla"])
def test_render_rays_remat_changes_nothing(kind):
    """remat on and off under train: the same outputs and the same
    gradients, bit for bit (the recomputation repeats the forward's ops;
    the noise is drawn once, outside it)."""
    def field():
        if kind == "ngp":
            f = build_fields(SMALL, train=True)[1].init(torch.Generator().manual_seed(15))
            with torch.no_grad():
                f.table.uniform_(-0.2, 0.2, generator=torch.Generator().manual_seed(16))
            return f
        return VanillaNeRF(pos_L=4, dir_L=2, hidden_dim=32).init(torch.Generator().manual_seed(15)).requires_grad_(True)

    o, d, near, far = map(torch.from_numpy, _rays(17, 32))
    runs = []
    for remat in (True, False):
        f = field()
        out = R.render_rays(f, f, o, d, near, far, 8, 16, train=True, remat=remat,
                            generator=torch.Generator().manual_seed(18))
        (out["rgb_fine"].square().mean() + out["rgb_coarse"].square().mean()).backward()
        runs.append((out, [p.grad.clone() for p in f.parameters()]))
    (a, ga), (b, gb) = runs
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert len(ga) == len(gb) and all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert any(float(g.abs().sum()) > 0 for g in ga)


def test_render_rays_draws_from_the_generator():
    """u_strat, coarse noise, u_pdf, fine noise, in that order."""
    f = VanillaNeRF(pos_L=2, dir_L=1, hidden_dim=8).init(torch.Generator().manual_seed(0))
    o, d, near, far = map(torch.from_numpy, _rays(19, 8))
    with torch.no_grad():
        a = R.render_rays(f, f, o, d, near, far, 4, 6, train=True, generator=torch.Generator().manual_seed(20))
        gen = torch.Generator().manual_seed(20)
        u_strat = torch.rand(8, 4, generator=gen)
        nc = torch.randn(32, 1, generator=gen)
        u_pdf = torch.rand(8, 6, generator=gen)
        nf = torch.randn(80, 1, generator=gen)
        b = R.render_rays(f, f, o, d, near, far, 4, 6, train=True, u_strat=u_strat, u_pdf=u_pdf, noise_coarse=nc,
                          noise_fine=nf)
    assert all(torch.equal(a[k], b[k]) for k in a)
