"""nerfjax_torch's hash-grid encode and its table gradient (through
torch.autograd: the hashed levels' backward and the dense levels' scatter)
against ``jax.vjp`` of nerfjax's ``hash_encode_planar``, exact and with the
train-only k = 1 estimators, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax.fields.ngp import HashGridSpec as JaxSpec
from nerfjax.ops.hash_encode import hash_encode_planar as encode_jax
from nerfjax_torch.fields.ngp import HashGridSpec
from nerfjax_torch.ops import hash_encode as he

BASE = dict(n_levels=8, log2_hashmap_size=15, extra_dense_levels=1)
ESTIMATORS = {
    "exact": {},
    "k1": dict(fwd_corners=1, grad_corners=1),
    "k1_gl2": dict(fwd_corners=1, grad_corners=1, grad_levels=2),
    "exact_fwd_k1_grad": dict(grad_corners=1),
}


def _inputs(spec: HashGridSpec, n: int, seed: int):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.5, 0.5, (2, spec.total_table_size)).astype(np.float32)
    xyz = rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    xyz[:, :3] = [[0.0, 1.0, 0.5], [0.0, 1.0, 1.0], [0.0, 1.0, 0.0]]
    cot = rng.normal(size=(2 * spec.n_levels, n)).astype(np.float32)
    return table, xyz, cot


def _port(spec, table, xyz, cot):
    planes = torch.from_numpy(table).requires_grad_(True)
    enc = he.hash_encode_planar(spec, planes, *[torch.from_numpy(c.copy()) for c in xyz])
    (enc * torch.from_numpy(cot)).sum().backward()
    return enc.detach().numpy(), planes.grad.numpy()


@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_encode_and_table_grad_match_nerfjax(name):
    """nerfjax op by op (compiled, XLA contracts x*scale + 0.5 into an FMA
    and moves floors and weights in the last bit). Forward: equal bit for
    bit under k = 1 (a gather of bf16-rounded values), within 1e-6 exact
    (f32 sums; XLA may order them otherwise).
    Gradient: per table entry within 1e-6 of the sum of the absolute values
    of the contributions scattered there (f32 sums in any order: the port's
    kernels add with atomics, XLA's scatter in its own order)."""
    spec = HashGridSpec(**BASE, **ESTIMATORS[name])
    table, xyz, cot = _inputs(spec, 1024, seed=len(name))
    jspec = JaxSpec(**BASE, **ESTIMATORS[name])
    enc_j, vjp = jax.vjp(lambda p: encode_jax(jspec, p, *(jnp.asarray(c) for c in xyz)), jnp.asarray(table))
    (grad_j,) = vjp(jnp.asarray(cot))
    enc_j, grad_j = np.asarray(enc_j), np.asarray(grad_j)

    enc_t, grad_t = _port(spec, table, xyz, cot)
    if spec.fwd_corners == 1:
        np.testing.assert_array_equal(enc_t, enc_j)
    else:
        np.testing.assert_allclose(enc_t, enc_j, rtol=0, atol=1e-6)
    _, mass = _port(spec, table, xyz, np.abs(cot))  # sum |g * coef| per entry
    assert (np.abs(grad_t - grad_j) <= 1e-6 * mass + 1e-30).all()
    assert np.count_nonzero(grad_t) > 0


def test_level_subset_scatters_only_drawn_levels():
    """gl = 2 of Lh hashed levels: each point reaches at most 2 hashed
    entries per plane, each carrying g * Lh/2."""
    spec = HashGridSpec(**BASE, fwd_corners=1, grad_corners=1, grad_levels=2)
    _, hashed = he._split_levels(spec)
    table, xyz, _ = _inputs(spec, 4, seed=5)
    cot = np.zeros((2 * spec.n_levels, 4), np.float32)
    cot[spec.n_levels - len(hashed):spec.n_levels, 3] = 1.0  # point 3, plane 0, hashed levels
    _, grad = _port(spec, table, xyz, cot)
    hashed_grad = grad[0, hashed[0]["offset"]:]
    assert hashed_grad.sum() == pytest.approx(len(hashed), rel=1e-6)  # 2 draws x Lh/2
    assert set(np.unique(hashed_grad[hashed_grad != 0])) <= {len(hashed) / 2, float(len(hashed))}


def test_table_grad_scatter_plain_matches_drop_scatter():
    """out[p][idx] += g_p with indices past either end dropped, as
    jnp.zeros(T).at[idx].add(v, mode="drop") drops them. (JAX first wraps
    an index in [-T, 0) to idx + T; the port drops every negative index.
    The encode's indices are never negative.)"""
    rng = np.random.default_rng(9)
    T, K = 1000, 20_000
    idx = rng.integers(0, T, K).astype(np.int32)
    idx[::97] = T + rng.integers(0, 50, idx[::97].size)
    idx[::89] = -T - 1 - rng.integers(0, 50, idx[::89].size)
    g0, g1 = rng.normal(size=(2, K)).astype(np.float32)
    got = he.table_grad_scatter(torch.from_numpy(idx), torch.from_numpy(g0), torch.from_numpy(g1), torch.zeros(2, T))
    got = got.numpy()
    for p, g in enumerate((g0, g1)):
        ref = np.asarray(jnp.zeros(T, jnp.float32).at[jnp.asarray(idx)].add(jnp.asarray(g), mode="drop"))
        mass = np.zeros(T, np.float64)
        keep = (idx >= 0) & (idx < T)
        np.add.at(mass, idx[keep], np.abs(g[keep]))
        assert (np.abs(got[p] - ref) <= 1e-6 * mass + 1e-30).all()


@pytest.mark.parametrize("wrapper", ["table_grad_scatter", "hash_levels_bwd"])
def test_scatter_wrappers_add_into_out(wrapper):
    """A wrapper adds into ``out`` and returns it: the encode's backward
    hands K3 and K2 one [2, total] gradient. Into planes that hold values,
    the result is the one into zeros plus those values, within 1e-6 (the
    adds meet the values in another order); an ``out`` of another shape,
    dtype or layout raises."""
    rng = np.random.default_rng(13)
    spec = HashGridSpec(**BASE, fwd_corners=1, grad_corners=1, grad_levels=2)
    total = spec.total_table_size
    if wrapper == "table_grad_scatter":
        K = 5000
        idx = torch.from_numpy(rng.integers(-5, total + 5, K).astype(np.int32))
        g0, g1 = torch.from_numpy(rng.normal(size=(2, K)).astype(np.float32))
        call = lambda out: he.table_grad_scatter(idx, g0, g1, out)  # noqa: E731
    else:
        _, hashed = he._split_levels(spec)
        x, y, z = torch.from_numpy(rng.uniform(0.0, 1.0, (3, 300)).astype(np.float32))
        g = torch.from_numpy(rng.normal(size=(2, len(hashed), 300)).astype(np.float32))
        call = lambda out: he.hash_levels_bwd(spec, g, x, y, z, out)  # noqa: E731
    prior = torch.from_numpy(rng.normal(size=(2, total)).astype(np.float32))
    out = prior.clone()
    assert call(out) is out
    fresh = call(torch.zeros(2, total))
    assert np.count_nonzero(fresh.numpy()) > 0
    np.testing.assert_allclose(out.numpy(), (prior + fresh).numpy(), rtol=1e-6, atol=1e-6)
    for bad in (torch.zeros(3, total), torch.zeros(2, total, dtype=torch.float64), torch.zeros(total, 2).t()):
        with pytest.raises(ValueError):
            call(bad)
