"""nerfjax_torch's InstantNGP against nerfjax's at the tuned shape ("small"
table, 12 levels, 1 promoted dense level), with the same weights carried
over by params_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax.fields.ngp import InstantNGP as JaxNGP
from nerfjax_torch.checkpoint import params_from_jax
from nerfjax_torch.fields.ngp import InstantNGP

SHAPE = dict(n_levels=12, extra_dense_levels=1)


@pytest.fixture(scope="module")
def fields():
    jf = JaxNGP("small", **SHAPE)
    params = jax.device_get(jf.init(jax.random.PRNGKey(0)))
    params["table"] = params["table"] * 2000.0  # a field with structure, not ~0
    tf = InstantNGP("small", **SHAPE).load_params(params_from_jax(params))
    return jf, params, tf


def _points(n: int, seed: int):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, (3, n)).astype(np.float32)
    view = pos / np.linalg.norm(pos, axis=0, keepdims=True)
    return pos, view


def _j(a):
    return tuple(jnp.asarray(c) for c in a)


def _t(a):
    return tuple(torch.from_numpy(c.copy()) for c in a)


def test_apply_planar_fused_matches_nerfjax(fields):
    # f32 end to end: encode identical, MLPs differ in summation order only
    jf, params, tf = fields
    pos, view = _points(1500, seed=1)
    rgb_j, sig_j = jf.apply_planar_fused(params, _j(pos), _j(view), dtype=jnp.float32, interpret=True)
    rgb_t, sig_t = tf.apply_planar_fused(_t(pos), _t(view), dtype=torch.float32)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=0, atol=2e-5)


def test_query_density_planar_fused_matches_nerfjax(fields):
    # bf16, the extraction's dtype: encodes agree bit for bit, the sigma is
    # rounded once to bf16 from f32 sums in another order: one bf16 ulp
    # (taken at no less than 2^-14, see test_torch_fused_mlp._ulp_bound)
    jf, params, tf = fields
    pos, view = _points(1500, seed=2)
    sig_j = np.asarray(jf.query_density_planar_fused(params, _j(pos), interpret=True).astype(jnp.float32))
    sig_t = tf.query_density_planar_fused(_t(pos))
    assert sig_t.dtype == torch.bfloat16
    _, sig_head = tf.apply_planar_fused(_t(pos), _t(view))
    assert torch.equal(sig_t, sig_head)
    bound = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(sig_j), 2.0**-14))) - 7)
    assert (np.abs(sig_t.float().numpy() - sig_j) <= bound).all()


def test_unfused_apply_planar_matches_nerfjax(fields):
    jf, params, tf = fields
    pos, view = _points(700, seed=3)
    rgb_j, sig_j = jf.apply_planar(params, _j(pos), _j(view), dtype=jnp.float32)
    rgb_t, sig_t = tf.apply_planar(_t(pos), _t(view), dtype=torch.float32)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=0, atol=2e-5)


def test_init_draws_tcnn_ranges():
    f = InstantNGP("small", **SHAPE).init(torch.Generator().manual_seed(0))
    assert f.table.abs().max() <= 1e-4
    for w in list(f.dmlp) + list(f.cmlp):
        assert w.abs().max() <= np.sqrt(6.0 / sum(w.shape))
    g = InstantNGP("small", **SHAPE).init(torch.Generator().manual_seed(0))
    assert torch.equal(f.table, g.table)


def test_unknown_nerf_type_raises():
    with pytest.raises(ValueError):
        InstantNGP("huge")


def test_packed_weights_cached_until_load_params(fields):
    """The fused kernels' weight buffer is packed once per dtype and made
    anew when load_params brings other weights."""
    _, params, _ = fields
    f = InstantNGP("small", **SHAPE).load_params(params_from_jax(params))
    bf = f.packed_weights(torch.bfloat16)
    assert f.packed_weights(torch.bfloat16) is bf
    assert not torch.equal(f.packed_weights(torch.float32), bf)
    other = params_from_jax(params)
    other["dmlp"][1]["w"] = other["dmlp"][1]["w"] * 2.0
    f.load_params(other)
    assert not torch.equal(f.packed_weights(torch.bfloat16), bf)
