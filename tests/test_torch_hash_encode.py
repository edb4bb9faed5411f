"""nerfjax_torch hash-grid spec, SH encoding and exact hash encode against
nerfjax on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax.fields.encodings import sh4_encode_planar as sh4_jax
from nerfjax.fields.ngp import HashGridSpec as JaxSpec
from nerfjax.ops.hash_encode import hash_encode_planar as encode_jax
from nerfjax_torch.fields.encodings import sh4_encode_planar
from nerfjax_torch.fields.ngp import NERF_TYPE_LOG2, HashGridSpec
from nerfjax_torch.ops.hash_encode import hash_encode_planar

BF16_EPS = 2.0**-8  # one bf16 ulp at 1.0


@pytest.mark.parametrize("nerf_type", ["small", "large"])
@pytest.mark.parametrize("n_levels", [12, 16])
@pytest.mark.parametrize("extra_dense", [0, 1, 2])
def test_level_params_match_nerfjax(nerf_type, n_levels, extra_dense):
    kw = dict(
        n_levels=n_levels,
        log2_hashmap_size=NERF_TYPE_LOG2[nerf_type],
        extra_dense_levels=extra_dense,
    )
    assert HashGridSpec(**kw).level_params() == JaxSpec(**kw).level_params()
    assert HashGridSpec(**kw).total_table_size == JaxSpec(**kw).total_table_size


def test_tuned_spec_shape():
    """NGP-large, 12 levels, 1 promoted dense level: 5 dense + 7 hashed levels,
    a 4,423,504-entry table and a 24-wide encoding."""
    spec = HashGridSpec(n_levels=12, log2_hashmap_size=19, extra_dense_levels=1)
    levels = spec.level_params()
    assert [lp["res"] for lp in levels if not lp["use_hash"]] == [16, 24, 36, 54, 81]
    assert sum(lp["use_hash"] for lp in levels) == 7
    assert spec.total_table_size == 4_423_504
    assert spec.output_dim == 24


def _inputs(spec: HashGridSpec, n: int, seed: int):
    rng = np.random.default_rng(seed)
    table = (rng.uniform(-1.0, 1.0, (2, spec.total_table_size)) * 0.2).astype(np.float32)
    xyz = rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    # the domain's faces (0.0 and 1.0, where dense base cells clamp to r-2)
    # and exact lattice points of the coarsest level (x*scale + 0.5 integral)
    scale0 = spec.level_params()[0]["scale"]
    lattice = ((np.arange(16) + 0.5) / scale0).astype(np.float32)
    xyz[:, :4] = [[0.0, 1.0, 1.0, 0.0], [0.0, 1.0, 0.5, 1.0], [0.0, 1.0, 0.0, 0.25]]
    xyz[:, 4:20] = lattice[None, :]
    return table, xyz


def _both(spec, table, xyz, jdt, tdt):
    enc_j = encode_jax(JaxSpec(**{f: getattr(spec, f) for f in (
        "n_levels", "log2_hashmap_size", "extra_dense_levels")}),
        jnp.asarray(table), *[jnp.asarray(c) for c in xyz], dtype=jdt)
    enc_t = hash_encode_planar(
        spec, torch.from_numpy(table), *[torch.from_numpy(c.copy()) for c in xyz], dtype=tdt
    )
    return np.asarray(enc_j.astype(jnp.float32)), enc_t.to(torch.float32).numpy()


@pytest.mark.parametrize("extra_dense", [0, 1])
def test_hash_encode_f32_matches_nerfjax(extra_dense):
    # hashed-level table values are rounded to bf16 on both sides and every
    # weight and sum is f32, so only summation order can differ: atol 1e-6
    spec = HashGridSpec(n_levels=12, log2_hashmap_size=15, extra_dense_levels=extra_dense)
    table, xyz = _inputs(spec, 1500, seed=0)
    ej, et = _both(spec, table, xyz, jnp.float32, torch.float32)
    assert et.shape == (24, 1500)
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-6)


def test_hash_encode_bf16_matches_nerfjax():
    # dense levels weight and sum in bf16. XLA's CPU may keep a fused bf16
    # chain in f32 and round once where torch rounds every op; the bound is
    # 4 bf16 ulps of max|enc| (observed here: 0, the two round alike).
    spec = HashGridSpec(n_levels=12, log2_hashmap_size=15, extra_dense_levels=1)
    table, xyz = _inputs(spec, 1500, seed=1)
    ej, et = _both(spec, table, xyz, jnp.bfloat16, torch.bfloat16)
    bound = 4 * BF16_EPS * np.abs(ej).max()
    assert np.abs(et - ej).max() <= bound


def test_sh4_matches_nerfjax():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(3, 257)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    sj = np.asarray(sh4_jax(*[jnp.asarray(c) for c in d]))
    st = sh4_encode_planar(*[torch.from_numpy(c.copy()) for c in d]).numpy()
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)  # f32 elementwise, same op order


# f32 bit patterns of the pack's edge cases: NaNs of both signs (quiet,
# signalling, all payload bits), +-0, +-inf, the largest finite value, values
# halfway between two bf16 values (ties to even both ways), values that round
# up across a bf16 exponent, and subnormals
PACK_EDGES = [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FFFFFFF, 0x7F8FFFFF, 0x00000000, 0x80000000,
              0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x3F808000, 0x3F818000, 0x3F7FFFFF, 0xBF7FFFFF,
              0x3F80FFFF, 0x407FFFC0, 0x00000001, 0x807FFFFF, 0x007F8000, 0x3F800000]


def test_pack_pairs_bf16_plain_equals_nerfjax_bit_for_bit():
    """The port's plain pack (the layout K1 exact reads) against nerfjax's
    _pack_pairs_bf16, compared as uint32 words: the edge cases in both
    planes (each paired with every other), then seeded values of every
    magnitude."""
    from nerfjax.ops.hash_encode import _pack_pairs_bf16

    from nerfjax_torch.ops.hash_encode import _unpack_pairs_plain, pack_pairs_bf16_plain

    edges = np.array(PACK_EDGES, np.uint32)
    a, b = np.meshgrid(edges, edges)
    rng = np.random.default_rng(0)
    wide = (rng.uniform(-1, 1, 4000) * 2.0 ** rng.integers(-140, 127, 4000)).astype(np.float32).view(np.uint32)
    bits = np.stack([np.concatenate([a.ravel(), wide]), np.concatenate([b.ravel(), wide[::-1]])])
    planes = bits.view(np.float32)
    want = np.asarray(_pack_pairs_bf16(jnp.asarray(planes))).view(np.uint32)
    got = pack_pairs_bf16_plain(torch.from_numpy(planes.copy()))
    assert got.dtype == torch.int32 and got.shape == (planes.shape[1],)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # unpacked, each half is the bf16 rounding widened to f32 (NaN stays NaN)
    p0, p1 = _unpack_pairs_plain(got)
    for half, plane in ((p0, planes[0]), (p1, planes[1])):
        ref = torch.from_numpy(plane.copy()).to(torch.bfloat16).to(torch.float32)
        assert torch.equal(half.isnan(), ref.isnan())
        keep = ~ref.isnan()
        assert torch.equal(half[keep].view(torch.int32), ref[keep].view(torch.int32))
