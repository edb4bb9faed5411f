"""K4's packed dense columns and K2's bf16 cotangent, on the CPU.

K4 reads the dense levels from a table that a pass in front of it packs at
each call: one entry per dense column holding both planes, a bf16 pair
(plane 0 in the low half: nerfjax's ``_pack_pairs_bf16`` layout, its k = 1
dense forward's choice) in the bf16 modes, a float2 in exact float32.
Here the port's plain pack is held to nerfjax's word for word at the dense
levels of both shipped models, and a forward computed from those words as
the kernel computes it is held to ``dense_levels_fwd_plain`` bit for bit.
(The cell rows of ``_dense_cell_rows`` + ``_pack_rows16``, one row per
cell, were timed too and lost: ``PERF.md``.) K2 reads the hashed levels'
rows of the encode's own cotangent in its dtype (bf16 under mixed
precision), in place: its plain version widens g to float32 first, so a
bf16 slice gives what its float32 copy gives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax.ops import hash_encode as jhe
from nerfjax_torch.fields.ngp import HashGridSpec
from nerfjax_torch.ops import hash_encode as he

SPECS = {"tuned": dict(n_levels=12, log2_hashmap_size=19, extra_dense_levels=1),  # cfg/blender_scene_tuned.yml
         "drop-in": dict(n_levels=16, log2_hashmap_size=19)}  # cfg/blender_scene.yml


def _planes(spec: HashGridSpec, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)


def _positions(N: int, seed: int) -> list[torch.Tensor]:
    """Uniform in [0, 1], the domain's faces 0 and 1 (where the base cell
    clamps to r - 2) at the first points, and samples along a few rays."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    xyz[:, :4] = [[0.0, 1.0, 1.0, 0.0], [0.0, 1.0, 0.5, 1.0], [0.0, 1.0, 0.0, 0.25]]
    t = np.sort(rng.uniform(-0.4, 0.4, (8, 64)), axis=1)
    d = rng.normal(size=(8, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = np.clip(0.5 + d[:, None, :] * t[:, :, None], 0.0, 1.0).reshape(-1, 3).T
    xyz[:, 4 : 4 + ray.shape[1]] = ray
    return [torch.from_numpy(c.copy()) for c in xyz]


@pytest.mark.parametrize("name", list(SPECS))
def test_dense_pack_plain_equals_nerfjax(name):
    """pack_pairs_plain of the dense columns equals nerfjax's _pack_pairs_bf16
    of its dense plane prefix (the k = 1 dense forward's table) word for
    word; in float32 it holds the planes' values as they are."""
    spec = HashGridSpec(**SPECS[name])
    dense, _ = he._split_levels(spec)
    T = he._dense_width(dense)
    planes = _planes(spec, 1)
    got = he.pack_pairs_plain(torch.from_numpy(planes)[:, :T], f32=False).numpy()
    ref = np.asarray(jax.lax.bitcast_convert_type(jhe._pack_pairs_bf16(jnp.asarray(planes[:, :T])), jnp.int32))
    assert got.dtype == np.int32 and got.shape == (T,) and np.array_equal(got, ref)
    pairs = he.pack_pairs_plain(torch.from_numpy(planes)[:, :T], f32=True)
    assert pairs.shape == (T, 2) and pairs.is_contiguous() and np.array_equal(pairs.numpy(), planes[:, :T].T)


def _fwd_from_pairs(spec: HashGridSpec, planes: torch.Tensor, x, y, z, dtype):
    """The dense forward from K4's packed table as the kernel computes it:
    one entry per corner, a bf16 pair's halves widened by a shift (float2:
    the values as they are); exact: the corners' terms summed in CORNERS
    order in ``dtype``; k = 1: the drawn corner's entry, float32 out."""
    dense, _ = he._split_levels(spec)
    k1 = he._dense_mode(spec, len(dense))[0] == 1
    f32 = not k1 and dtype == torch.float32
    table = he.pack_pairs_plain(planes[:, : he._dense_width(dense)], f32)
    p0, p1 = (table[:, 0], table[:, 1]) if f32 else he._unpack_pairs_plain(table)
    if k1:
        sel = he._dense_plan_k1(dense, x, y, z)
        return torch.stack([p0[sel], p1[sel]])
    out = []
    for lp in dense:
        e0 = e1 = torch.zeros(x.shape[0], dtype=dtype)
        for i, w in he._dense_corners(lp, *he._dense_geometry(lp, x, y, z, dtype)):
            e0, e1 = e0 + p0[i].to(dtype) * w, e1 + p1[i].to(dtype) * w
        out.append(torch.stack([e0, e1]))
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("mode", ["exact bf16", "exact f32", "k=1"])
@pytest.mark.parametrize("name", list(SPECS))
def test_forward_from_packed_pairs_equals_plain(name, mode):
    """K4's arithmetic on the packed table equals dense_levels_fwd_plain bit
    for bit, the domain's faces and ray samples included: rounding each
    table value to bf16 once, at the pack, is what the plain version's
    per-corner rounding does."""
    kw = dict(dense_corners=1) if mode == "k=1" else {}
    spec = HashGridSpec(**SPECS[name], **kw)
    dtype = torch.float32 if mode == "exact f32" else torch.bfloat16
    planes = torch.from_numpy(_planes(spec, 2))
    x, y, z = _positions(4096, 3)
    got = _fwd_from_pairs(spec, planes, x, y, z, dtype)
    ref, _ = he.dense_levels_fwd_plain(spec, planes, x, y, z, dtype)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("est", ["exact", "k=1", "k=1 gl=2"])
def test_hash_levels_bwd_plain_takes_a_bf16_slice_of_the_cotangent(est):
    """hash_levels_bwd_plain on the hashed levels' rows of a [2, L, N] bf16
    cotangent, a strided slice, equals it on their float32 copy bit for bit
    (the old backward's argument), in all three modes; and the encode's
    backward on the CPU adds what the float32 copy adds."""
    kw = {"exact": {}, "k=1": dict(fwd_corners=1, grad_corners=1),
          "k=1 gl=2": dict(fwd_corners=1, grad_corners=1, grad_levels=2)}[est]
    spec = HashGridSpec(**SPECS["tuned"], **kw)
    dense, hashed = he._split_levels(spec)
    N, total = 2048, spec.total_table_size
    x, y, z = _positions(N, 4)
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(2, spec.n_levels, N)).astype(np.float32))
    g = g.to(torch.bfloat16)
    sliced = g[:, len(dense) :]
    assert not sliced.is_contiguous()
    got = he.hash_levels_bwd_plain(spec, sliced, x, y, z, torch.zeros(2, total))
    ref = he.hash_levels_bwd_plain(spec, sliced.float().contiguous(), x, y, z, torch.zeros(2, total))
    assert torch.equal(got, ref) and bool((got != 0).any())
    planes = torch.from_numpy(_planes(spec, 6)).requires_grad_()
    enc = he.hash_encode_planar(spec, planes, x, y, z, torch.bfloat16)
    enc.backward(g.reshape(2 * spec.n_levels, N))
    assert torch.equal(planes.grad[:, hashed[0]["offset"] :], ref[:, hashed[0]["offset"] :])


@pytest.mark.parametrize("f32", [False, True], ids=["bf16 pairs", "f32 pairs"])
def test_pack_pairs_on_the_cpu_is_its_plain_version(f32):
    """The pack's wrapper on CPU columns (a column slice of the planes)
    returns its plain version's words and launches nothing."""
    spec = HashGridSpec(**SPECS["drop-in"])
    T = he._dense_width(he._split_levels(spec)[0])
    cols = torch.from_numpy(_planes(spec, 7))[:, :T]
    before = he.launch_counts["pack_pairs"]
    got = he.pack_pairs(cols, f32)
    assert he.launch_counts["pack_pairs"] == before
    assert torch.equal(got.view(torch.int32), he.pack_pairs_plain(cols, f32).view(torch.int32))
