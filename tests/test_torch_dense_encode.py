"""The dense levels of nerfjax_torch's hash-grid encode against nerfjax's, on
the same numpy inputs: the exact forward (``_dense_levels_encode``), the
level-subset backward (``hash_dense_grad_levels``, ``_dense_levels_encode_glv``)
and the k = 1 stochastic encode (``hash_dense_corners: 1``,
``_dense_levels_encode_stoch``), at NGP-small with 8 levels and 1 promoted
dense level: 3 dense levels (res 16, 24, 36) and 5 hashed.

nerfjax runs op by op (eager JAX), so ``x*scale + 0.5`` rounds twice as in
the port (compiled, XLA contracts it into an FMA: ROADMAP Queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax.config import ConfigNode
from nerfjax.fields.ngp import HashGridSpec as JaxSpec
from nerfjax.ops import hash_encode as jhe
from nerfjax.train import build_fields as jax_build_fields
from nerfjax_torch.fields.ngp import HashGridSpec
from nerfjax_torch.ops import hash_encode as he
from nerfjax_torch.train import build_fields

BASE = dict(n_levels=8, log2_hashmap_size=15, extra_dense_levels=1)
# the tuned hashed-level estimators, with each dense knob
TUNED = dict(fwd_corners=1, grad_corners=1, grad_levels=2)
KNOBS = {"dgl1": dict(dense_grad_levels=1), "dgl2": dict(dense_grad_levels=2), "dc1": dict(dense_corners=1)}
BF16_EPS = 2.0**-8  # one bf16 ulp at 1.0
N = 1024


def _dense(spec: HashGridSpec) -> list[dict]:
    return he._split_levels(spec)[0]


def _inputs(spec: HashGridSpec, seed: int):
    """(table [2, total], xyz [3, N], cot [2L, N]) float32: uniform
    positions, the faces 0.0 and 1.0 (where the base cell clamps to r-2),
    and exact lattice points of every dense level (x*scale + 0.5 integral)."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.5, 0.5, (2, spec.total_table_size)).astype(np.float32)
    xyz = rng.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    xyz[:, :4] = [[0.0, 1.0, 1.0, 0.0], [0.0, 1.0, 0.5, 1.0], [0.0, 1.0, 0.0, 0.25]]
    lattice = np.concatenate([(np.arange(12) + 0.5) / lp["scale"] for lp in _dense(spec)]).astype(np.float32)
    xyz[:, 4 : 4 + lattice.size] = lattice[None, :]
    xyz[1, 4 : 4 + lattice.size] = lattice[::-1]
    cot = rng.normal(size=(2 * spec.n_levels, N)).astype(np.float32)
    return table, xyz, cot


def _torch(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _jspec(**kw) -> JaxSpec:
    return JaxSpec(**BASE, **kw)


def test_salts_match_nerfjax():
    assert he.DENSE_SALT == jhe._DENSE_SALT
    assert he.DENSE_GL_SALT == jhe._DENSE_GL_SALT


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_exact_dense_forward_matches_nerfjax(dtype):
    """dense_levels_fwd on the CPU (its plain version) against nerfjax's
    _dense_levels_encode. f32: atol 1e-6 (weights and sums in f32, the same
    order). bf16: 4 bf16 ulps of max|enc| (XLA's CPU may keep a bf16 chain
    in f32 where torch rounds every op; test_torch_hash_encode.py's bound)."""
    spec = HashGridSpec(**BASE)
    table, xyz, _ = _inputs(spec, seed=1)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jspec = _jspec()
    e0, e1 = jhe._dense_levels_encode(jspec, jhe._split_levels(jspec)[0], jnp.asarray(table),
                                      *(jnp.asarray(c) for c in xyz), jdt)
    ref = np.stack([np.asarray(e0.astype(jnp.float32)), np.asarray(e1.astype(jnp.float32))])
    out = he.dense_levels_fwd(spec, *_torch([table, *xyz]), tdt)
    plain, sel = he.dense_levels_fwd_plain(spec, *_torch([table, *xyz]), tdt)
    assert out.dtype == tdt and out.shape == (2, 3, N) and sel is None
    assert torch.equal(out, plain)
    got = out.to(torch.float32).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    else:
        assert np.abs(got - ref).max() <= 4 * BF16_EPS * np.abs(ref).max()


@pytest.mark.parametrize("gd", [1, 2, 3])
def test_dense_level_draws_match_nerfjax(gd):
    """The level-subset draws (_draw_levels with _DENSE_GL_SALT) bit for bit."""
    spec = HashGridSpec(**BASE)
    _, xyz, _ = _inputs(spec, seed=2)
    Ld = len(_dense(spec))
    ref = np.asarray(jhe._draw_levels(*(jnp.asarray(c) for c in xyz), Ld, gd, jhe._DENSE_GL_SALT))
    got = he._draw_levels(*_torch(xyz), Ld, gd, he.DENSE_GL_SALT).numpy()
    np.testing.assert_array_equal(got, ref)
    assert set(np.unique(got)) == set(range(Ld))


def test_dense_k1_plan_matches_nerfjax():
    """The dense k = 1 plan (clamped weights, _DENSE_SALT) equals nerfjax's
    _stochastic_corner_plan(clamp=True, salt=_DENSE_SALT) bit for bit, and
    the plain forward's sel is that plan."""
    spec = HashGridSpec(**BASE, dense_corners=1)
    table, xyz, _ = _inputs(spec, seed=3)
    jspec = _jspec(dense_corners=1)
    dense_j = jhe._split_levels(jspec)[0]
    x, y, z = (jnp.asarray(c) for c in xyz)
    idx3 = jhe._dense_level_indices(jspec, dense_j, x, y, z)
    sel_j, coef = jhe._stochastic_corner_plan(dense_j, x, y, z, idx3, 1, clamp=True, salt=jhe._DENSE_SALT)
    assert np.all(np.asarray(coef) == 1.0)
    plan = he._dense_plan_k1(_dense(spec), *_torch(xyz))
    np.testing.assert_array_equal(plan.numpy(), np.asarray(sel_j)[0])
    _, sel = he.dense_levels_fwd_plain(spec, *_torch([table, *xyz]))
    assert torch.equal(sel, plan)
    sel32 = torch.empty(3, N, dtype=torch.int32)
    he.dense_levels_fwd(spec, *_torch([table, *xyz]), sel=sel32)
    assert torch.equal(sel32.long(), plan)


def _port(spec, table, xyz, cot):
    planes = torch.from_numpy(table).requires_grad_(True)
    enc = he.hash_encode_planar(spec, planes, *_torch(xyz))
    (enc * torch.from_numpy(cot)).sum().backward()
    return enc.detach().numpy(), planes.grad.numpy()


@pytest.mark.parametrize("knob", list(KNOBS))
def test_encode_and_table_grad_match_nerfjax(knob):
    """The whole encode with the tuned hashed estimators and one dense knob,
    against jax.vjp of nerfjax's hash_encode_planar. Forward: dc1 bit for
    bit (gathers of bf16-rounded values on both sides); dgl: the hashed
    rows bit for bit, the dense rows within 1e-6 (exact f32 forward), and
    the whole encode equal bit for bit to the port's own exact-dense encode.
    Gradient: per table entry within 1e-6 of the sum of the absolute values
    of the contributions scattered there (tests/test_torch_hash_grad.py's
    bound: f32 sums in any order)."""
    spec = HashGridSpec(**BASE, **TUNED, **KNOBS[knob])
    table, xyz, cot = _inputs(spec, seed=10 + len(knob))
    jspec = _jspec(**TUNED, **KNOBS[knob])
    enc_j, vjp = jax.vjp(lambda p: jhe.hash_encode_planar(jspec, p, *(jnp.asarray(c) for c in xyz)),
                         jnp.asarray(table))
    (grad_j,) = vjp(jnp.asarray(cot))
    enc_j, grad_j = np.asarray(enc_j), np.asarray(grad_j)

    enc_t, grad_t = _port(spec, table, xyz, cot)
    Ld, L = len(_dense(spec)), spec.n_levels
    if knob == "dc1":
        np.testing.assert_array_equal(enc_t, enc_j)
    else:
        dense_rows = np.r_[0:Ld, L : L + Ld]
        hashed_rows = np.setdiff1d(np.arange(2 * L), dense_rows)
        np.testing.assert_array_equal(enc_t[hashed_rows], enc_j[hashed_rows])
        np.testing.assert_allclose(enc_t[dense_rows], enc_j[dense_rows], rtol=0, atol=1e-6)
        exact, _ = _port(HashGridSpec(**BASE, **TUNED), table, xyz, cot)
        np.testing.assert_array_equal(enc_t, exact)
    _, mass = _port(spec, table, xyz, np.abs(cot))
    assert (np.abs(grad_t - grad_j) <= 1e-6 * mass + 1e-30).all()
    T = sum(lp["size"] for lp in _dense(spec))
    assert np.count_nonzero(grad_t[:, :T]) > 0


@pytest.mark.parametrize("gd", [3, 4])
def test_dense_grad_levels_at_or_above_Ld_is_the_exact_path(gd):
    """gd >= Ld takes the exact dense backward, unscaled: the encode and its
    gradient equal the exact encode's bit for bit."""
    table, xyz, cot = _inputs(HashGridSpec(**BASE), seed=4)
    enc_g, grad_g = _port(HashGridSpec(**BASE, **TUNED, dense_grad_levels=gd), table, xyz, cot)
    enc_e, grad_e = _port(HashGridSpec(**BASE, **TUNED), table, xyz, cot)
    np.testing.assert_array_equal(enc_g, enc_e)
    np.testing.assert_array_equal(grad_g, grad_e)


@pytest.mark.parametrize("mode", ["exact", "k1"])
def test_staging_scattered_is_autograd_of_the_plain_forward(mode):
    """dense_levels_bwd_plain's staging, scattered by table_grad_scatter_plain,
    equals autograd's gradient of dense_levels_fwd_plain (f32): the staged
    entries are the forward's exact VJP. Within 1e-6 of the summed
    |contributions| (the two sum the same terms in another order). Under
    k = 1 autograd also differentiates the forward's rounding of the table
    to bf16 (the cast's backward rounds each entry's summed gradient to
    bf16), which nerfjax's custom VJP and the staging do not: there the
    bound is a bf16 ulp of the summed |contributions|."""
    spec = HashGridSpec(**BASE, **({"dense_corners": 1} if mode == "k1" else {}))
    table, xyz, _ = _inputs(spec, seed=5)
    Ld = len(_dense(spec))
    g = np.random.default_rng(6).normal(size=(2, Ld, N)).astype(np.float32)
    planes = torch.from_numpy(table).requires_grad_(True)
    out, _ = he.dense_levels_fwd_plain(spec, planes, *_torch(xyz))
    (out * torch.from_numpy(g)).sum().backward()
    idx, v0, v1 = he.dense_levels_bwd(spec, torch.from_numpy(g), *_torch(xyz))
    assert idx.dtype == torch.int32 and idx.shape == v0.shape == v1.shape == ((Ld * 8 if mode == "exact" else Ld) * N,)
    staged = he.table_grad_scatter_plain(idx, v0, v1, torch.zeros(2, spec.total_table_size))
    mass = he.table_grad_scatter_plain(idx, v0.abs(), v1.abs(), torch.zeros(2, spec.total_table_size))
    rel = 1e-6 if mode == "exact" else BF16_EPS
    assert bool(((staged - planes.grad).abs() <= rel * mass + 1e-30).all())
    assert int(torch.count_nonzero(staged)) > 0


def test_level_subset_staging_holds_the_drawn_levels():
    """gd = 1 of 3 dense levels: each point stages 8 entries, all inside the
    level it drew, carrying (w*g)*3 with the 8 weights of that level."""
    spec = HashGridSpec(**BASE, dense_grad_levels=1)
    _, xyz, _ = _inputs(spec, seed=7)
    dense = _dense(spec)
    g = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 3, N)).astype(np.float32))
    idx, v0, v1 = he.dense_levels_bwd(spec, g, *_torch(xyz))
    assert idx.shape == (8 * N,)
    ids = he._draw_levels(*_torch(xyz), 3, 1, he.DENSE_GL_SALT)[0]
    lo = torch.tensor([lp["offset"] for lp in dense])[ids]
    hi = torch.tensor([lp["offset"] + lp["res"] ** 3 for lp in dense])[ids]
    i = idx.reshape(8, N).long()
    assert bool(((i >= lo) & (i < hi)).all())
    w_sum = (v0.reshape(8, N) / (g[0].gather(0, ids[None])[0] * 3.0)).sum(0)
    np.testing.assert_allclose(w_sum.numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_build_fields_passes_the_dense_knobs_train_only(train):
    """hash_dense_corners and hash_dense_grad_levels reach the field's spec
    under train=True only, as in nerfjax's build_fields."""
    for knobs in ({"hash_dense_corners": 1}, {"hash_dense_grad_levels": 2}):
        cfg = {"ngp": True, "nerf_type": "small", "hash_n_levels": 8, "hash_extra_dense_levels": 1, **knobs}
        mine = build_fields(cfg, train=train)[1].spec
        ref = jax_build_fields(ConfigNode(cfg), train=train)[1].spec
        assert (mine.dense_corners, mine.dense_grad_levels) == (ref.dense_corners, ref.dense_grad_levels)
        assert (mine.dense_corners, mine.dense_grad_levels) != (8, 0) or not train
