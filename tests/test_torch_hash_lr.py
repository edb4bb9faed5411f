"""The leader + residual estimators (k = 2..7 corners) of nerfjax_torch's
hash-grid encode against nerfjax's, on the same numpy inputs: the plan
(``_stochastic_corner_plan``) bit for bit, hashed and dense; the encode's
forward at ``hash_fwd_corners`` = ``hash_dense_corners`` = k; and its table
gradient through torch.autograd against ``jax.vjp`` for the backward plans
b = min(grad_corners, fwd_corners) over all levels or ``grad_levels`` drawn
ones, and for the dense levels' b = min(grad_corners, dense_corners).

nerfjax runs op by op (eager JAX), so ``x*scale + 0.5`` rounds twice as in
the port (compiled, XLA contracts it into an FMA: ROADMAP Queue 3). NGP
small with 8 levels and 1 promoted dense level: 3 dense levels (res 16, 24,
36) and 5 hashed levels of 2^15 entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax.fields.ngp import HashGridSpec as JaxSpec
from nerfjax.ops import hash_encode as jhe
from nerfjax_torch.fields.ngp import HashGridSpec
from nerfjax_torch.ops import hash_encode as he

BASE = dict(n_levels=8, log2_hashmap_size=15, extra_dense_levels=1)
N = 2048
BF16_EPS = 2.0**-8  # one bf16 ulp at 1.0
# (fwd_corners, grad_corners, grad_levels) of the hashed levels' backward
HASHED_GRADS = [(8, 2, 0), (8, 3, 2), (2, 8, 0), (3, 3, 2), (3, 1, 0), (4, 2, 0)]
# (dense_corners, grad_corners) of the dense levels' backward
DENSE_GRADS = [(dc, gc) for dc in (2, 7) for gc in (8, 1, 3)]


def _levels(kind: str) -> list[dict]:
    dense, hashed = he._split_levels(HashGridSpec(**BASE))
    return dense if kind == "dense" else hashed


def _inputs(seed: int):
    """(table [2, total], xyz [3, N], cot [2L, N]) float32: uniform
    positions, and these, where the plan meets its edge cases:

      * the origin, where x*scale + 0.5 = 0.5 on every axis of every level:
        the 8 weights tie at 0.125 (the leader is corner 0, the first);
      * a face (x = 0) with the rest uniform: pairs of weights tie;
      * (1, 1, 1): the dense levels clamp the base cell to r - 2 and the
        fraction to 1, so one corner weighs 1 (total = 0: every residual
        draw is corner 7 with coef 0);
      * exact lattice points of every hashed level (x*scale + 0.5
        integral on all three axes): total = 0 too.
    """
    spec = HashGridSpec(**BASE)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.5, 0.5, (2, spec.total_table_size)).astype(np.float32)
    xyz = rng.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    xyz[:, 0] = 0.0
    xyz[0, 1:16] = 0.0
    xyz[:, 16] = 1.0
    lattice = np.concatenate([(np.arange(1, 9) - 0.5) / lp["scale"] for lp in _levels("hashed")]).astype(np.float32)
    xyz[:, 32 : 32 + lattice.size] = lattice[None, :]
    cot = rng.normal(size=(2 * spec.n_levels, N)).astype(np.float32)
    return table, xyz, cot


def _jax_plan(kind: str, xyz, k: int):
    levels = _levels(kind)
    x, y, z = (jnp.asarray(c) for c in xyz)
    jspec = JaxSpec(**BASE)
    if kind == "dense":
        idx3 = jhe._dense_level_indices(jspec, levels, x, y, z)
        return jhe._stochastic_corner_plan(levels, x, y, z, idx3, k, clamp=True, salt=jhe._DENSE_SALT)
    idx3 = jhe._hash_level_indices(jspec, levels, x, y, z).reshape(len(levels), 8, -1)
    return jhe._stochastic_corner_plan(levels, x, y, z, idx3, k)


@pytest.mark.parametrize("k", range(2, 8))
@pytest.mark.parametrize("kind", ["hashed", "dense"])
def test_plan_matches_nerfjax_bit_for_bit(kind, k):
    """sel and coef [k, L, N] equal nerfjax's bit for bit: the leader first
    (ties to the first corner), then the k - 1 residual draws; the inputs
    hold 8-way ties and points of total = 0 (residual coef 0, corner 7)."""
    _, xyz, _ = _inputs(k)
    sel_j, coef_j = (np.asarray(a) for a in _jax_plan(kind, xyz, k))
    x, y, z = (torch.from_numpy(c.copy()) for c in xyz)
    if kind == "dense":
        sel, coef = he._dense_plan(_levels(kind), x, y, z, k)
    else:
        sel, coef = he._hash_plan(HashGridSpec(**BASE), _levels(kind), x, y, z, k)
    assert sel.shape == coef.shape == (k, len(_levels(kind)), N)
    np.testing.assert_array_equal(sel.numpy(), sel_j)
    np.testing.assert_array_equal(coef.numpy().view(np.uint32), coef_j.view(np.uint32))
    assert (coef_j[0, :, 0] == np.float32(0.125)).all()  # the 8-way tie at the origin
    vertex = coef_j[1:] == 0.0  # total = 0
    assert vertex.any()
    idx3, _ = (he._dense_corner_arrays(_levels(kind), x, y, z, torch.float32) if kind == "dense" else
               (torch.stack(he._hash_level_indices(HashGridSpec(**BASE), _levels(kind), x, y, z), dim=1), None))
    corner7 = np.broadcast_to(idx3[:, 7, :].numpy(), sel_j[1:].shape)
    np.testing.assert_array_equal(sel_j[1:][vertex], corner7[vertex])


def _encode_both(est: dict, table, xyz, cot, dtype: str):
    """(enc, table gradient) of nerfjax (jax.vjp, op by op) and of the port
    (torch.autograd) for the spec BASE + est; and the port's gradient of
    |cot|, the sum of |terms| per entry."""
    spec, jspec = HashGridSpec(**BASE, **est), JaxSpec(**BASE, **est)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    enc_j, vjp = jax.vjp(lambda p: jhe.hash_encode_planar(jspec, p, *(jnp.asarray(c) for c in xyz), dtype=jdt),
                         jnp.asarray(table))
    (grad_j,) = vjp(jnp.asarray(cot).astype(jdt))

    def port(c):
        planes = torch.from_numpy(table.copy()).requires_grad_(True)
        enc = he.hash_encode_planar(spec, planes, *(torch.from_numpy(a.copy()) for a in xyz), dtype=tdt)
        enc.backward(torch.from_numpy(c).to(tdt))
        return enc.detach(), planes.grad.numpy()

    enc_t, grad_t = port(cot)
    _, mass = port(np.abs(cot))
    return np.asarray(enc_j.astype(jnp.float32)), np.asarray(grad_j), enc_t, grad_t, mass


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [2, 3, 7])
def test_encode_forward_matches_nerfjax(k, dtype):
    """hash_fwd_corners = hash_dense_corners = k: both level kinds'
    k-corner estimates (bf16-rounded table values, f32 sums over k in j
    order), written in the encode's dtype: within 1e-6 relative in f32
    (XLA may sum the k terms in another order) and within one bf16 ulp of
    nerfjax's value in bf16."""
    table, xyz, cot = _inputs(10 + k)
    enc_j, _, enc_t, _, _ = _encode_both(dict(fwd_corners=k, dense_corners=k), table, xyz, cot, dtype)
    assert enc_t.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    enc_t = enc_t.to(torch.float32).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(enc_t, enc_j, rtol=1e-6, atol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(enc_j), 2.0**-126))) - 7)
        assert (np.abs(enc_t - enc_j) <= ulp).all()
    assert np.count_nonzero(enc_t) > 0.9 * enc_t.size


@pytest.mark.parametrize("est", [dict(fwd_corners=f, grad_corners=g, grad_levels=gl) for f, g, gl in HASHED_GRADS]
                         + [dict(dense_corners=dc, grad_corners=gc) for dc, gc in DENSE_GRADS],
                         ids=[f"hashed_fwd{f}_grad{g}_gl{gl}" for f, g, gl in HASHED_GRADS]
                         + [f"dense_dc{dc}_grad{gc}" for dc, gc in DENSE_GRADS])
def test_table_grad_matches_nerfjax(est):
    """The table gradient of the whole encode (f32) per entry within 1e-5 of
    the sum of |terms| added there (nerfjax's .at[].add and the port's
    index_add_ add in other orders), nonzero where nerfjax's is; the
    forward within 1e-6 relative. Hashed: b = min(grad, fwd) corners
    (replaying the forward's plan at b = fwd), over gl drawn levels
    (g*coef)*(Lh/gl). Dense: b = min(grad_corners, dense_corners)."""
    table, xyz, cot = _inputs(20 + sum(est.values()))
    enc_j, grad_j, enc_t, grad_t, mass = _encode_both(est, table, xyz, cot, "f32")
    np.testing.assert_allclose(enc_t.numpy(), enc_j, rtol=1e-6, atol=0)
    assert (np.abs(grad_t - grad_j) <= 1e-5 * mass + 1e-30).all()
    np.testing.assert_array_equal(grad_t != 0, grad_j != 0)
    dense_cols = he._dense_width(_levels("dense"))
    kind = slice(dense_cols, None) if "dense_corners" not in est else slice(None, dense_cols)
    assert np.count_nonzero(grad_t[:, kind]) > 0


@pytest.mark.parametrize("b", [2, 3])
def test_k_corner_backward_terms_per_row(b):
    """One point, one row of cotangent set: the hashed backward adds g*coef
    at b planned corners of each level (the leader's w_m and b - 1 shares
    of 1 - w_m), so the row's terms sum to g per level, through
    hash_bwd_entries, the plain scatter and the wrapper alike."""
    spec = HashGridSpec(**BASE, fwd_corners=8, grad_corners=b)
    _, hashed = he._split_levels(spec)
    Lh = len(hashed)
    _, xyz, _ = _inputs(30)
    x, y, z = (torch.from_numpy(c[100:101].copy()) for c in xyz)
    g = torch.zeros(2, Lh, 1)
    g[0] = 1.0
    idx, v0, v1 = he.hash_bwd_entries(spec, g, x, y, z)
    assert idx.shape == v0.shape == (b * Lh,) and float(v1.abs().sum()) == 0.0
    np.testing.assert_allclose(v0.reshape(b, Lh).sum(0).numpy(), np.ones(Lh), rtol=1e-6)
    got = he.hash_levels_bwd(spec, g, x, y, z, torch.zeros(2, spec.total_table_size))
    np.testing.assert_allclose(float(got[0].sum()), Lh, rtol=1e-6)
    assert float(got[:, : hashed[0]["offset"]].abs().sum()) == 0.0


@pytest.mark.parametrize("N", [1, 33, 2048])
@pytest.mark.parametrize("k", range(2, 8))
def test_k1_packed_words_emulation_equals_plain(k, N):
    """K1 k >= 2 as the card runs it, in plain torch: the hashed columns
    packed into bf16-pair words (pack_pairs_bf16_plain), the k planned
    words gathered together, each widened by a shift and summed e =
    f_0*w_m, e += f_j*coef_r in j order in float32; equal bit for bit to
    hash_levels_fwd_plain at N = 1, 33 (not a multiple of 32) and 2048."""
    spec = HashGridSpec(**BASE, fwd_corners=k)
    hashed = _levels("hashed")
    table, xyz, _ = _inputs(40 + k)
    planes = torch.from_numpy(table)
    x, y, z = (torch.from_numpy(c[:N].copy()) for c in xyz)
    sel, coef = he._hash_plan(spec, hashed, x, y, z, k)
    words = he.pack_pairs_bf16_plain(planes[:, hashed[0]["offset"]:])[sel]  # [k, Lh, N], gathered together
    f0, f1 = he._unpack_pairs_plain(words.reshape(-1))
    f = torch.stack([f0, f1]).reshape(2, *words.shape)
    e = f[:, 0] * coef[0]
    for j in range(1, k):
        e = e + f[:, j] * coef[j]
    ref, plan = he.hash_levels_fwd_plain(spec, planes, x, y, z)
    assert torch.equal(plan, sel)
    assert torch.equal(e.view(torch.int32), ref.view(torch.int32))
