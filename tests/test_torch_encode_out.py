"""The encode's forward as one buffer: K4 and K1 write their rows of the
[2, L, N] output in its dtype through ``out=`` (no float32 part, no cast,
no concat). On the CPU, against nerfjax's ``hash_encode_planar`` (eager,
op by op) on the same numpy inputs, against the plain parts' ``torch.cat``
bit for bit, and the wrappers' ``out=`` path against their own path
without it; then the ``out=`` checks. NGP-small, 8 levels, 1 promoted
dense level: 3 dense levels and 5 hashed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax.fields.ngp import HashGridSpec as JaxSpec
from nerfjax.ops.hash_encode import hash_encode_planar as encode_jax
from nerfjax_torch.fields.ngp import HashGridSpec
from nerfjax_torch.ops import hash_encode as he

BASE = dict(n_levels=8, log2_hashmap_size=15, extra_dense_levels=1)
K1 = dict(fwd_corners=1, grad_corners=1)
BF16_EPS = 2.0**-8  # one bf16 ulp at 1.0
N = 1024
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# the shipped estimator sets: the tuned step's (k = 1 over 2 levels), exact,
# and the tuned one with each dense knob
SPECS = {"tuned": dict(**K1, grad_levels=2), "exact": {}, "dc1": dict(**K1, grad_levels=2, dense_corners=1),
         "dgl1": dict(**K1, grad_levels=2, dense_grad_levels=1)}


def _inputs(spec: HashGridSpec, seed: int):
    """(table [2, total], xyz [3, N]) float32: uniform positions, the
    domain's faces and exact lattice points of the dense levels."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.5, 0.5, (2, spec.total_table_size)).astype(np.float32)
    xyz = rng.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    xyz[:, :4] = [[0.0, 1.0, 1.0, 0.0], [0.0, 1.0, 0.5, 1.0], [0.0, 1.0, 0.0, 0.25]]
    dense, _ = he._split_levels(spec)
    lattice = np.concatenate([(np.arange(12) + 0.5) / lp["scale"] for lp in dense]).astype(np.float32)
    xyz[:, 4 : 4 + lattice.size] = lattice[None, :]
    return table, xyz


def _torch(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


@pytest.mark.parametrize("dc", [8, 1], ids=["dense_exact", "dense_k1"])
@pytest.mark.parametrize("fwd", [8, 1], ids=["hashed_exact", "hashed_k1"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_encode_matches_nerfjax(dt, fwd, dc):
    """The one-buffer encode against nerfjax's hash_encode_planar, per row
    kind: the k = 1 rows bit for bit (gathers of bf16-rounded values, an
    exact cast); the exact hashed rows within 1e-6 in f32 (f32 sums, XLA
    may order them otherwise) and within one bf16 ulp of the value (+1e-6)
    in bf16 (a 1e-6 difference can cross a rounding boundary); the exact
    dense rows within 1e-6 in f32 and 4 bf16 ulps of max|enc| in bf16
    (tests/test_torch_hash_encode.py: XLA may keep a fused bf16 chain in
    f32)."""
    tdt, jdt = DTYPES[dt]
    kw = dict(**BASE, fwd_corners=fwd, grad_corners=fwd, dense_corners=dc)
    spec = HashGridSpec(**kw)
    table, xyz = _inputs(spec, seed=fwd + 10 * dc)
    ej = encode_jax(JaxSpec(**kw), jnp.asarray(table), *(jnp.asarray(c) for c in xyz), dtype=jdt)
    et = he.hash_encode_planar(spec, *_torch([table, *xyz]), dtype=tdt)
    assert et.dtype == tdt and et.shape == (2 * spec.n_levels, N) and ej.dtype == jdt
    ej, et = np.asarray(ej.astype(jnp.float32)), et.to(torch.float32).numpy()
    L, Ld = spec.n_levels, len(he._split_levels(spec)[0])
    dense_rows = np.r_[0:Ld, L : L + Ld]
    hashed_rows = np.setdiff1d(np.arange(2 * L), dense_rows)
    for rows, k1, exact_bound in ((hashed_rows, fwd == 1, lambda a: BF16_EPS * 2 * np.abs(a) + 1e-6),
                                  (dense_rows, dc == 1, lambda a: 4 * BF16_EPS * np.abs(ej).max())):
        got, want = et[rows], ej[rows]
        if k1:
            np.testing.assert_array_equal(got, want)
        elif tdt == torch.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            assert (np.abs(got - want) <= exact_bound(want)).all()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(SPECS))
def test_encode_equals_the_plain_parts_concat(name, dt):
    """The encode's output equals, bit for bit, what the concat of the two
    plain parts, each cast to dtype, gave (the forward before it wrote its
    rows in place), and the plain k = 1 parts' plans fill sel through the
    wrappers' out= path as without it."""
    tdt, _ = DTYPES[dt]
    spec = HashGridSpec(**BASE, **SPECS[name])
    table, xyz = _inputs(spec, seed=len(name))
    planes, x, y, z = _torch([table, *xyz])
    dense_part, _ = he.dense_levels_fwd_plain(spec, planes, x, y, z, tdt)
    hashed_part, _ = he.hash_levels_fwd_plain(spec, planes, x, y, z)
    want = torch.cat([dense_part.to(tdt), hashed_part.to(tdt)], dim=1).reshape(2 * spec.n_levels, N)
    got = he.hash_encode_planar(spec, planes, x, y, z, dtype=tdt)
    assert got.dtype == want.dtype and torch.equal(got.view(torch.int16 if dt == "bf16" else torch.int32),
                                                   want.view(torch.int16 if dt == "bf16" else torch.int32))


def _wrapper(kind: str, spec, planes, x, y, z, dtype, **kw):
    if kind == "hashed":
        return he.hash_levels_fwd(spec, planes, x, y, z, **kw)
    return he.dense_levels_fwd(spec, planes, x, y, z, dtype, **kw)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", ["exact", "k1"])
@pytest.mark.parametrize("kind", ["hashed", "dense"])
def test_out_path_equals_the_path_without_it(kind, mode, dt):
    """Each forward wrapper on the CPU, writing into a plane-strided slice of
    a larger buffer of dtype, equals its result without out= cast to dtype
    bit for bit, returns the slice, leaves the rest of the buffer as it
    was, and fills sel alike."""
    tdt, _ = DTYPES[dt]
    k1 = {"hashed": K1, "dense": dict(dense_corners=1)}[kind] if mode == "k1" else {}
    spec = HashGridSpec(**BASE, **k1)
    table, xyz = _inputs(spec, seed=3)
    planes, x, y, z = _torch([table, *xyz])
    dense, hashed = he._split_levels(spec)
    rows = len(hashed if kind == "hashed" else dense)
    buf = torch.full((2, rows + 3, N), -7.0, dtype=tdt)
    before = buf.clone()
    view = buf[:, 1 : 1 + rows]
    sel_a = torch.zeros(rows, N, dtype=torch.int32) if mode == "k1" else None
    sel_b = torch.zeros(rows, N, dtype=torch.int32) if mode == "k1" else None
    got = _wrapper(kind, spec, planes, x, y, z, tdt, out=view, sel=sel_a)
    want = _wrapper(kind, spec, planes, x, y, z, tdt, sel=sel_b).to(tdt)
    assert got.data_ptr() == view.data_ptr() and got.dtype == tdt
    assert torch.equal(view, want)
    outside = torch.ones_like(buf, dtype=torch.bool)
    outside[:, 1 : 1 + rows] = False
    assert torch.equal(buf[outside], before[outside])
    if mode == "k1":
        assert torch.equal(sel_a, sel_b) and bool((sel_a != 0).any())


def _bad_outs(rows: int):
    """Malformed out= tensors for a [2, rows, N] forward (rows >= 2)."""
    return {
        "shape": torch.empty(2, rows + 1, N),
        "three_planes": torch.empty(3, rows, N),
        "float16": torch.empty(2, rows, N, dtype=torch.float16),
        "float64": torch.empty(2, rows, N, dtype=torch.float64),
        "device": torch.empty(2, rows, N, device="meta"),
        "point_stride": torch.empty(2, rows, 2 * N)[:, :, ::2],
        "level_stride": torch.empty(2, N, rows).transpose(1, 2),
        "overlapping_planes": torch.empty(1, rows, N).expand(2, rows, N),
    }


@pytest.mark.parametrize("bad", list(_bad_outs(3)))
@pytest.mark.parametrize("kind", ["hashed", "dense"])
def test_malformed_out_raises(kind, bad):
    """out= must be [2, rows, N] in float32 or bf16 on the positions'
    device, with contiguous rows and planes that do not overlap; anything
    else raises a ValueError before any work."""
    spec = HashGridSpec(**BASE)
    table, xyz = _inputs(spec, seed=4)
    planes, x, y, z = _torch([table, *xyz])
    dense, hashed = he._split_levels(spec)
    out = _bad_outs(len(hashed if kind == "hashed" else dense))[bad]
    with pytest.raises(ValueError, match="out must be"):
        _wrapper(kind, spec, planes, x, y, z, torch.float32, out=out)


def test_exact_dense_out_must_be_in_the_working_dtype():
    """The exact dense forward computes in dtype, so its out= is of dtype;
    the k = 1 dense forward (an exact cast) takes float32 or bf16."""
    table, xyz = _inputs(HashGridSpec(**BASE), seed=5)
    planes, x, y, z = _torch([table, *xyz])
    exact, dc1 = HashGridSpec(**BASE), HashGridSpec(**BASE, dense_corners=1)
    Ld = len(he._split_levels(exact)[0])
    with pytest.raises(ValueError, match="out must be"):
        he.dense_levels_fwd(exact, planes, x, y, z, torch.float32, out=torch.empty(2, Ld, N, dtype=torch.bfloat16))
    out = torch.empty(2, Ld, N, dtype=torch.bfloat16)
    want, _ = he.dense_levels_fwd_plain(dc1, planes, x, y, z, torch.float32)
    assert torch.equal(he.dense_levels_fwd(dc1, planes, x, y, z, torch.float32, out=out), want.to(torch.bfloat16))
