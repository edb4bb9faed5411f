"""The CUDA kernels of nerfjax_torch against their plain PyTorch versions.

Needs a CUDA card and nvcc (the kernels have no CPU or interpret mode); on a
machine without a card every test here skips. Imports no JAX. The suite's
conftest.py imports jax, so on a machine without jax skip it:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from nerfjax_torch.ops import fused_mlp

DIMS = {"dmlp": [(None, 64), (64, 16)], "cmlp": [(32, 64), (64, 64), (64, 3)]}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are full f32
    return torch.device("cuda")


def _params(E: int, seed: int, device) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, dims in DIMS.items():
        out[name] = []
        for fan_in, fan_out in dims:
            fan_in = fan_in or E
            b = np.sqrt(6.0 / (fan_in + fan_out))
            w = rng.uniform(-b, b, (fan_in, fan_out)).astype(np.float32)
            out[name].append({"w": torch.from_numpy(w).to(device)})
    return out


def _ulp_bound(ref: np.ndarray) -> np.ndarray:
    # one bf16 ulp of each reference value, taken at no less than 2^-14: near
    # zero (where relu cuts) two summation orders differ by float32 noise of
    # O(1) sums, below 2^-21
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0**-14))) - 7)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    # torch.equal on the bits: equal values, and NaN where the other has NaN
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("E", [1, 24, 32, 40, 64, 100, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 15, 17, 4_104, 100_003])
def test_kernels_match_plain(cuda_device, E, dtype, N):
    """Each kernel against its plain version: one bf16 ulp (f32: atol 2e-5,
    summation order only); the density sigma bit-identical to the head's.
    E = 1 and 100 pad the bf16 kernels' first layer to whole k16 steps;
    every f32 block takes more than 48 KB of shared memory. N = 4,104 is a
    multiple of 8 with a ragged last step (16-byte copies in both dtypes);
    the other N stage element by element (bf16) or 4 bytes a copy (f32,
    where N = 100,003 is not a multiple of 4)."""
    params = _params(E, 11, cuda_device)
    rng = np.random.default_rng(12)
    enc = torch.from_numpy(rng.uniform(-1, 1, (E, N)).astype(np.float32)).to(cuda_device, dtype)
    sh = torch.from_numpy(rng.uniform(-1, 1, (16, N)).astype(np.float32)).to(cuda_device, dtype)
    before = dict(fused_mlp.launch_counts)
    rgb_k, sig_k = fused_mlp.fused_ngp_head(params, enc, sh)
    dsig_k = fused_mlp.fused_ngp_density(params, enc)
    rgb_p, sig_p = fused_mlp.fused_ngp_head_plain(params, enc, sh)
    torch.cuda.synchronize()
    assert fused_mlp.launch_counts["fused_ngp_head"] == before["fused_ngp_head"] + 1
    assert fused_mlp.launch_counts["fused_ngp_density"] == before["fused_ngp_density"] + 1
    assert rgb_k.dtype == dtype and rgb_k.shape == (3, N) and sig_k.shape == (N,)
    assert torch.equal(dsig_k, sig_k)
    for got, ref in ((rgb_k, rgb_p), (sig_k, sig_p)):
        got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        else:
            assert (np.abs(got - ref) <= _ulp_bound(ref)).all()


@pytest.mark.parametrize("E", [1, 24, 33, 64, 128])
@pytest.mark.parametrize("N", [1, 127, 129, 1_000_003])
def test_f32_kernels_on_partial_tiles(cuda_device, E, N):
    """The f32 kernels step over 128 points at a time: N = 1 and 127 fill
    part of one step, 129 one whole step and one point of a second, and
    1,000,003 (not a multiple of 4) takes the 4-byte copies and many steps
    per block of the persistent grid. E = 1 and 33 are odd widths of layer
    1's loop, 128 the widest. The density sigma equals the head's
    (torch.equal); both are within atol 2e-5 of plain, rgb too."""
    params = _params(E, 21, cuda_device)
    rng = np.random.default_rng(22)
    enc = torch.from_numpy(rng.uniform(-1, 1, (E, N)).astype(np.float32)).to(cuda_device)
    sh = torch.from_numpy(rng.uniform(-1, 1, (16, N)).astype(np.float32)).to(cuda_device)
    packed = fused_mlp.pack_weights(params, torch.float32, cuda_device)
    rgb_k, sig_k = fused_mlp.fused_ngp_head(params, enc, sh, packed=packed)
    dsig_k = fused_mlp.fused_ngp_density(params, enc, packed=packed)
    rgb_p, sig_p = fused_mlp.fused_ngp_head_plain(params, enc, sh)
    torch.cuda.synchronize()
    assert torch.equal(dsig_k, sig_k)
    for got, ref in ((rgb_k, rgb_p), (sig_k, sig_p), (dsig_k, sig_p)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E", [24, 100])
def test_kernels_place_non_finite_outputs_as_plain(cuda_device, dtype, E):
    """NaN, +inf and -inf in enc and sh (each at its own points): the
    kernels' NaN and +-inf outputs sit exactly where the plain version's
    do, the finite ones within one bf16 ulp (f32: atol 2e-5), and the
    density sigma has the head sigma's bits, NaNs included."""
    N = 1_000
    params = _params(E, 14, cuda_device)
    rng = np.random.default_rng(15)
    enc = rng.uniform(-1, 1, (E, N)).astype(np.float32)
    sh = rng.uniform(-1, 1, (16, N)).astype(np.float32)
    for i, v in enumerate((np.nan, np.inf, -np.inf)):
        enc[rng.integers(0, E, 40), 100 * i + np.arange(40)] = v
        sh[rng.integers(0, 16, 40), 500 + 100 * i + np.arange(40)] = v
    enc, sh = (torch.from_numpy(a).to(cuda_device, dtype) for a in (enc, sh))
    rgb_k, sig_k = fused_mlp.fused_ngp_head(params, enc, sh)
    dsig_k = fused_mlp.fused_ngp_density(params, enc)
    rgb_p, sig_p = fused_mlp.fused_ngp_head_plain(params, enc, sh)
    torch.cuda.synchronize()
    assert _same_bits(dsig_k, sig_k)
    nonfinite = 0
    for got, ref in ((rgb_k, rgb_p), (sig_k, sig_p)):
        got, ref = got.float().cpu(), ref.float().cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert torch.equal(torch.isposinf(got), torch.isposinf(ref))
        assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
        fin = torch.isfinite(ref)
        nonfinite += int((~fin).sum())
        got, ref = got[fin].numpy(), ref[fin].numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        else:
            assert (np.abs(got - ref) <= _ulp_bound(ref)).all()
    assert nonfinite > 0


def test_wrapper_rejects_wide_encoding(cuda_device):
    params = _params(fused_mlp.E_MAX + 2, 13, cuda_device)
    with pytest.raises(ValueError, match="E_MAX = 128"):
        fused_mlp.fused_ngp_density(params, torch.zeros(fused_mlp.E_MAX + 2, 8, device=cuda_device))


# -- the hash-encode kernels ---------------------------------------------------

from nerfjax_torch.fields.ngp import HashGridSpec  # noqa: E402
from nerfjax_torch.ops import hash_encode  # noqa: E402

TUNED = dict(n_levels=12, log2_hashmap_size=19, extra_dense_levels=1)


def _positions(N: int, seed: int, device):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    if N >= 2:
        xyz[:, :2] = [[0.0, 1.0], [0.0, 1.0], [0.0, 1.0]]  # the domain's faces
    return [torch.from_numpy(c.copy()).to(device) for c in xyz]


@pytest.mark.parametrize("fwd", [8, 1])
@pytest.mark.parametrize("N", [1, 100_003])
def test_hash_levels_fwd_matches_plain(cuda_device, fwd, N):
    """K1 equals its plain version bit for bit (no contraction on either
    side); under k = 1 its plan equals the plain plan."""
    spec = HashGridSpec(**TUNED, fwd_corners=fwd)
    rng = np.random.default_rng(21)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)).to(cuda_device)
    x, y, z = _positions(N, 22, cuda_device)
    _, hashed = hash_encode._split_levels(spec)
    sel = torch.empty(len(hashed), N, dtype=torch.int32, device=cuda_device) if fwd == 1 else None
    before = hash_encode.launch_counts["hash_levels_fwd"]
    got = hash_encode.hash_levels_fwd(spec, planes, x, y, z, sel=sel)
    ref, plan = hash_encode.hash_levels_fwd_plain(spec, planes, x, y, z)
    torch.cuda.synchronize()
    assert hash_encode.launch_counts["hash_levels_fwd"] == before + 1
    assert torch.equal(got, ref)
    if fwd == 1:
        assert torch.equal(sel.long(), plan)


@pytest.mark.parametrize("est", [dict(), dict(fwd_corners=1, grad_corners=1), dict(fwd_corners=1, grad_corners=1, grad_levels=2)])
def test_hash_levels_bwd_matches_plain(cuda_device, est):
    """K2 within 1e-6 of the sum of |contributions| per entry (atomic adds
    sum in any order)."""
    spec = HashGridSpec(**TUNED, **est)
    _, hashed = hash_encode._split_levels(spec)
    N, total = 100_003, spec.total_table_size
    x, y, z = _positions(N, 23, cuda_device)
    g = torch.from_numpy(np.random.default_rng(24).normal(size=(2, len(hashed), N)).astype(np.float32)).to(cuda_device)
    zeros = lambda: torch.zeros(2, total, device=cuda_device)  # noqa: E731
    got = hash_encode.hash_levels_bwd(spec, g, x, y, z, zeros())
    ref = hash_encode.hash_levels_bwd_plain(spec, g, x, y, z, zeros())
    mass = hash_encode.hash_levels_bwd_plain(spec, g.abs(), x, y, z, zeros())
    assert bool(((got - ref).abs() <= 1e-6 * mass + 1e-30).all())
    assert got[:, : hashed[0]["offset"]].abs().max() == 0
    # K2 adds into planes that hold values (the encode's one gradient)
    prior = torch.ones(2, total, device=cuda_device)
    into = hash_encode.hash_levels_bwd(spec, g, x, y, z, prior.clone())
    assert bool(((into - (prior + ref)).abs() <= 1e-6 * (mass + 1) + 1e-30).all())


def _ray_samples(n_rays: int, n_samples: int, seed: int, device):
    """Ray-major sorted samples along rays through [0, 1]^3, as the drop-in
    fine pass lays them out (neighbouring lanes share cells)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.2, 0.8, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(-0.4, 0.4, (n_rays, n_samples)), axis=1)
    p = np.clip(o[:, None, :] + d[:, None, :] * z[:, :, None], 0.0, 1.0).reshape(-1, 3).T.astype(np.float32)
    return [torch.from_numpy(c.copy()).to(device) for c in p]


@pytest.mark.parametrize("inputs", ["one_position", "rays", "one_point"])
def test_k2_exact_matches_plain_under_contention(cuda_device, inputs):
    """K2 exact (merged runs, float2 adds into the scratch) within the
    atomic-order bound 2 * max(n, 8) * 2^-24 * sum|terms| per entry of n
    terms, under the worst contention: every point at one position (N =
    100,003: warps straddle levels), ray-major sorted samples, and N = 1;
    also adding into planes that hold values."""
    spec = HashGridSpec(**TUNED)
    _, hashed = hash_encode._split_levels(spec)
    Lh, base, total = len(hashed), hashed[0]["offset"], spec.total_table_size
    if inputs == "one_position":
        x, y, z = (torch.full((100_003,), v, device=cuda_device) for v in (0.3, 0.6, 0.2))
    elif inputs == "rays":
        x, y, z = _ray_samples(521, 192, 32, cuda_device)
    else:
        x, y, z = _positions(1, 33, cuda_device)
    N = x.shape[0]
    g = torch.from_numpy(np.random.default_rng(34).normal(size=(2, Lh, N)).astype(np.float32)).to(cuda_device)
    zeros = lambda: torch.zeros(2, total, device=cuda_device)  # noqa: E731
    before = hash_encode.launch_counts["hash_levels_bwd"]
    got = hash_encode.hash_levels_bwd(spec, g, x, y, z, zeros())
    torch.cuda.synchronize()
    assert hash_encode.launch_counts["hash_levels_bwd"] == before + 1
    ref = hash_encode.hash_levels_bwd_plain(spec, g, x, y, z, zeros())
    mass = hash_encode.hash_levels_bwd_plain(spec, g.abs(), x, y, z, zeros())
    idx = (torch.stack(hash_encode._hash_level_indices(spec, hashed, x, y, z)) + base).reshape(-1)
    one = torch.ones(idx.shape[0], device=cuda_device)
    count = hash_encode.table_grad_scatter_plain(idx, one, one, zeros())
    bound = 2.0 * count.clamp_min(8.0) * 2.0**-24 * mass + 1e-30
    assert bool(((got - ref).abs() <= bound).all())
    assert got[:, :base].abs().max() == 0 and bool((got != 0).any())
    prior = torch.from_numpy(np.random.default_rng(35).normal(size=(2, total)).astype(np.float32)).to(cuda_device)
    into = hash_encode.hash_levels_bwd(spec, g, x, y, z, prior.clone())
    bound = 2.0 * (count + 1).clamp_min(8.0) * 2.0**-24 * (mass + prior.abs()) + 1e-30
    assert bool(((into - (prior + ref)).abs() <= bound).all())


@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("est", [dict(), dict(fwd_corners=1, grad_corners=1), dict(fwd_corners=1, grad_corners=1, grad_levels=2)],
                         ids=["exact", "k1", "k1_gl2"])
def test_hash_levels_bwd_reads_the_cotangent_slice(cuda_device, est, gdt):
    """K2 in each mode on the hashed levels' rows of a [2, L, N] cotangent
    in bf16 or f32, the strided slice g[:, Ld:] the encode's backward hands
    it, adds what the old call on their float32 copy adds (the widening is
    exact), within the atomic-order bound 2 * max(n, 8) * 2^-24 *
    sum|terms| per entry of n terms; both within it of the plain version.
    Ray-major samples."""
    spec = HashGridSpec(**TUNED, **est)
    dense, hashed = hash_encode._split_levels(spec)
    total = spec.total_table_size
    x, y, z = _ray_samples(521, 192, 44, cuda_device)
    N = x.shape[0]
    g_all = torch.from_numpy(np.random.default_rng(45).normal(size=(2, spec.n_levels, N)).astype(np.float32))
    g = g_all.to(cuda_device, gdt)[:, len(dense) :]
    assert not g.is_contiguous()
    zeros = lambda: torch.zeros(2, total, device=cuda_device)  # noqa: E731
    got = hash_encode.hash_levels_bwd(spec, g, x, y, z, zeros())
    old = hash_encode.hash_levels_bwd(spec, g.float().contiguous(), x, y, z, zeros())
    ref = hash_encode.hash_levels_bwd_plain(spec, g, x, y, z, zeros())
    mass = hash_encode.hash_levels_bwd_plain(spec, g.float().abs(), x, y, z, zeros())
    if est:
        count = hash_encode.hash_levels_bwd_plain(spec, torch.ones_like(g, dtype=torch.float32), x, y, z, zeros())
    else:
        idx = (torch.stack(hash_encode._hash_level_indices(spec, hashed, x, y, z)) + hashed[0]["offset"]).reshape(-1)
        one = torch.ones(idx.shape[0], device=cuda_device)
        count = hash_encode.table_grad_scatter_plain(idx, one, one, zeros())
    bound = 2.0 * count.clamp_min(8.0) * 2.0**-24 * mass + 1e-30
    torch.cuda.synchronize()
    assert bool(((got - old).abs() <= bound).all()) and bool(((got - ref).abs() <= bound).all())
    assert bool((got != 0).any()) and got[:, : hashed[0]["offset"]].abs().max() == 0


@pytest.mark.parametrize("inputs", ["one_position", "one_point", "odd_total", "one_level", "32_levels"])
def test_hash_levels_fwd_exact_packed_equals_plain(cuda_device, inputs):
    """K1 exact, which reads the hashed columns packed into bf16-pair words,
    equals its plain version bit for bit: at an odd count of hashed columns
    (planes one column wider than the spec), at N = 1, with 1 and with 32
    hashed levels, and with every point at one position."""
    kw = {"one_level": dict(n_levels=6, log2_hashmap_size=19, extra_dense_levels=1),
          "32_levels": dict(n_levels=33, log2_hashmap_size=12)}.get(inputs, TUNED)
    spec = HashGridSpec(**kw)
    _, hashed = hash_encode._split_levels(spec)
    assert len(hashed) == {"one_level": 1, "32_levels": 32}.get(inputs, 7)
    total = spec.total_table_size + (inputs == "odd_total")
    assert (total - hashed[0]["offset"]) % 2 == (inputs == "odd_total")
    rng = np.random.default_rng(40)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, total)).astype(np.float32)).to(cuda_device)
    if inputs == "one_position":
        x, y, z = (torch.full((100_003,), v, device=cuda_device) for v in (0.3, 0.6, 0.2))
    else:
        x, y, z = _positions(1 if inputs == "one_point" else 100_003, 41, cuda_device)
    before = hash_encode.launch_counts["hash_levels_fwd"]
    got = hash_encode.hash_levels_fwd(spec, planes, x, y, z)
    ref, _ = hash_encode.hash_levels_fwd_plain(spec, planes, x, y, z)
    torch.cuda.synchronize()
    assert hash_encode.launch_counts["hash_levels_fwd"] == before + 1
    assert torch.equal(got, ref)


def test_table_grad_scatter_matches_plain_and_drops(cuda_device):
    rng = np.random.default_rng(25)
    T, K = 1 << 15, 300_001
    idx = rng.integers(0, T, K).astype(np.int32)
    idx[::7] = T + 3
    idx[::11] = -1
    g0, g1 = (torch.from_numpy(rng.normal(size=K).astype(np.float32)).to(cuda_device) for _ in range(2))
    idx = torch.from_numpy(idx).to(cuda_device)
    zeros = lambda: torch.zeros(2, T, device=cuda_device)  # noqa: E731
    got = hash_encode.table_grad_scatter(idx, g0, g1, zeros())
    ref = hash_encode.table_grad_scatter_plain(idx, g0, g1, zeros())
    mass = hash_encode.table_grad_scatter_plain(idx, g0.abs(), g1.abs(), zeros())
    assert bool(((got - ref).abs() <= 1e-6 * mass + 1e-30).all())
    prior = torch.ones(2, T, device=cuda_device)
    into = hash_encode.table_grad_scatter(idx, g0, g1, prior.clone())
    assert bool(((into - (prior + ref)).abs() <= 1e-6 * (mass + 1) + 1e-30).all())
    with pytest.raises(ValueError):
        hash_encode.table_grad_scatter(idx.long(), g0, g1, zeros())
    with pytest.raises(ValueError):
        hash_encode.table_grad_scatter(idx, g0, g1, torch.zeros(T, 2, device=cuda_device).t())


@pytest.mark.parametrize("inputs", ["one_entry", "one_index", "sorted_runs", "ragged"])
def test_table_grad_scatter_matches_plain_under_contention(cuda_device, inputs):
    """K3 (merged warp runs, float2 adds into the scratch) within the
    atomic-order bound 2 * max(n, 8) * 2^-24 * sum|terms| per entry of n
    terms, under the worst contention: K = 1; all K = 100,003 entries on one
    index; the dense levels' staged gradient of ray-major sorted samples
    (runs of one index); a ragged K of sorted indices among a few entries
    with dropped ones. Into a column slice of a wider gradient that holds
    values, as the encode's backward hands it the dense columns; the
    columns past the slice untouched; and K3's adds counted by
    k3_atomic_count."""
    spec = HashGridSpec(**TUNED)
    dense, _ = hash_encode._split_levels(spec)
    T = hash_encode._dense_width(dense)
    rng = np.random.default_rng(42)
    if inputs == "sorted_runs":
        x, y, z = _ray_samples(521, 192, 43, cuda_device)
        g = torch.from_numpy(rng.normal(size=(2, len(dense), x.shape[0])).astype(np.float32)).to(cuda_device)
        idx, g0, g1 = hash_encode.dense_levels_bwd(spec, g, x, y, z)
    else:
        K = {"one_entry": 1, "one_index": 100_003, "ragged": 70_001}[inputs]
        idx = np.full(K, 12_345) if inputs != "ragged" else np.sort(rng.integers(0, 300, K))
        if inputs == "ragged":
            idx[::29] = T + 1
            idx[::31] = -3
        idx = torch.from_numpy(idx.astype(np.int32)).to(cuda_device)
        g0, g1 = (torch.from_numpy(rng.normal(size=K).astype(np.float32)).to(cuda_device) for _ in range(2))
    zeros = lambda: torch.zeros(2, T, device=cuda_device)  # noqa: E731
    prior = torch.from_numpy(rng.normal(size=(2, T + 64)).astype(np.float32)).to(cuda_device)
    before = hash_encode.launch_counts["table_grad_scatter"]
    got = hash_encode.table_grad_scatter(idx, g0, g1, zeros())
    into = prior.clone()
    hash_encode.table_grad_scatter(idx, g0, g1, into[:, :T])
    torch.cuda.synchronize()
    assert hash_encode.launch_counts["table_grad_scatter"] == before + 2
    ref = hash_encode.table_grad_scatter_plain(idx, g0, g1, zeros())
    mass = hash_encode.table_grad_scatter_plain(idx, g0.abs(), g1.abs(), zeros())
    one = torch.ones_like(g0)
    count = hash_encode.table_grad_scatter_plain(idx, one, one, zeros())
    bound = 2.0 * count.clamp_min(8.0) * 2.0**-24 * mass + 1e-30
    assert bool(((got - ref).abs() <= bound).all()) and bool((got != 0).any())
    bound = 2.0 * (count + 1).clamp_min(8.0) * 2.0**-24 * (mass + prior[:, :T].abs()) + 1e-30
    assert bool(((into[:, :T] - (prior[:, :T] + ref)).abs() <= bound).all())
    assert torch.equal(into[:, T:], prior[:, T:])
    adds = hash_encode.k3_atomic_count(idx, T)
    in_range = int(((idx >= 0) & (idx < T)).sum())
    if inputs in ("one_entry", "one_index"):
        assert adds == -(-idx.shape[0] // 32)
    assert adds <= in_range


DENSE_MODES = {"exact": {}, "dgl1": dict(dense_grad_levels=1), "dgl2": dict(dense_grad_levels=2),
               "dc1": dict(dense_corners=1)}


DROP_IN = dict(n_levels=16, log2_hashmap_size=19)  # cfg/blender_scene.yml: 4 dense levels, 12 hashed


def _dense_inputs(inputs: str, N: int, device):
    """x, y, z [N]: uniform with the domain's faces, or the first N of
    ray-major sorted samples (521 rays x 192)."""
    if inputs == "uniform":
        return _positions(N, 28, device)
    return [c[:N].contiguous() for c in _ray_samples(521, 192, 36, device)]


@pytest.mark.parametrize("inputs", ["uniform", "rays"])
@pytest.mark.parametrize("spec_kw", [TUNED, DROP_IN], ids=["tuned", "drop-in"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["exact", "dc1"])
@pytest.mark.parametrize("N", [1, 31, 100_003])
def test_dense_levels_fwd_matches_plain(cuda_device, dtype, mode, N, spec_kw, inputs):
    """K4 (one thread per point over the levels, reading the dense columns
    packed by pack_pairs) equals its plain version bit for bit (every bf16
    op rounded as PyTorch rounds it; no contraction) at both shipped
    models' dense levels, on uniform positions with the faces and on ray
    samples; under k = 1 its plan equals the plain plan. Each call packs
    once and launches K4 once."""
    spec = HashGridSpec(**spec_kw, **DENSE_MODES[mode])
    rng = np.random.default_rng(27)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)).to(cuda_device)
    x, y, z = _dense_inputs(inputs, N, cuda_device)
    Ld = len(hash_encode._split_levels(spec)[0])
    sel = torch.empty(Ld, N, dtype=torch.int32, device=cuda_device) if mode == "dc1" else None
    before = dict(hash_encode.launch_counts)
    got = hash_encode.dense_levels_fwd(spec, planes, x, y, z, dtype, sel=sel)
    ref, plan = hash_encode.dense_levels_fwd_plain(spec, planes, x, y, z, dtype)
    torch.cuda.synchronize()
    assert hash_encode.launch_counts["dense_levels_fwd"] == before["dense_levels_fwd"] + 1
    assert hash_encode.launch_counts["pack_pairs"] == before["pack_pairs"] + 1
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    if mode == "dc1":
        assert torch.equal(sel.long(), plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_levels_fwd_extreme_table_values(cuda_device, dtype):
    """K4 on table values at the ends of the range: most of them scaled
    into the f32 and bf16 subnormals (products and sums underflow), some
    at +-3.4e38 (above the bf16 maximum: inf once rounded to bf16, and inf
    * 0 = NaN at the faces) and zeros of both signs. The outputs other than
    NaN equal the plain version's bit for bit (the kernel rounds two values
    per cvt.rn.bf16x2.f32, the plain version one per cast), and the NaNs
    sit where the plain version's do."""
    spec = HashGridSpec(**TUNED)
    rng = np.random.default_rng(37)
    planes = rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)
    which = rng.integers(0, 6, planes.shape)
    extreme = np.array([0.0, -0.0, 1e-39, -3e-40, 3.4e38, -3.4e38], np.float32)
    planes = np.where(rng.uniform(size=planes.shape) < 0.3, extreme[which], planes * 2.0 ** rng.integers(-140, -100,
                                                                                                       planes.shape))
    planes = torch.from_numpy(planes.astype(np.float32)).to(cuda_device)
    x, y, z = _positions(100_003, 38, cuda_device)
    got = hash_encode.dense_levels_fwd(spec, planes, x, y, z, dtype).float()
    ref = hash_encode.dense_levels_fwd_plain(spec, planes, x, y, z, dtype)[0].float()
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], ref[~nan]) and bool((ref.abs() > 1e38).any())
    assert bool(((ref != 0) & (ref.abs() < 2.0**-126)).any())  # subnormal outputs were formed


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("spec_kw", [TUNED, DROP_IN], ids=["tuned", "drop-in"])
def test_pack_pairs_matches_plain(cuda_device, spec_kw, f32):
    """K4's table: the pack kernel's words equal pack_pairs_plain's word
    for word, from the dense column slice of the planes (rows 4*total bytes
    apart), and from an odd count of columns."""
    spec = HashGridSpec(**spec_kw)
    T = hash_encode._dense_width(hash_encode._split_levels(spec)[0])
    rng = np.random.default_rng(39)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)).to(cuda_device)
    view = torch.int32 if not f32 else torch.float32
    for cols in (planes[:, :T], planes[:, :T - 3]):
        before = hash_encode.launch_counts["pack_pairs"]
        got = hash_encode.pack_pairs(cols, f32)
        ref = hash_encode.pack_pairs_plain(cols, f32)
        torch.cuda.synchronize()
        assert hash_encode.launch_counts["pack_pairs"] == before + 1
        assert got.dtype == ref.dtype == view and got.shape == ref.shape
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", list(DENSE_MODES))
def test_dense_levels_bwd_matches_plain(cuda_device, dtype, mode):
    """K5 equals its plain version with torch.equal (fixed positions, no
    atomics); K3 on its output within the atomic-order bound of the plain
    scatter, 2 * max(n, 8) * 2^-24 * sum|terms| per entry of n terms (two
    f32 sums of the same terms in any order lie within it)."""
    spec = HashGridSpec(**TUNED, **DENSE_MODES[mode])
    Ld = len(hash_encode._split_levels(spec)[0])
    N, total = 100_003, spec.total_table_size
    x, y, z = _positions(N, 29, cuda_device)
    g = torch.from_numpy(np.random.default_rng(30).normal(size=(2, Ld, N)).astype(np.float32)).to(cuda_device, dtype)
    before = hash_encode.launch_counts["dense_levels_bwd"]
    got = hash_encode.dense_levels_bwd(spec, g, x, y, z, dtype)
    ref = hash_encode.dense_levels_bwd_plain(spec, g, x, y, z, dtype)
    torch.cuda.synchronize()
    assert hash_encode.launch_counts["dense_levels_bwd"] == before + 1
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    zeros = lambda: torch.zeros(2, total, device=cuda_device)  # noqa: E731
    idx, v0, v1 = got
    scattered = hash_encode.table_grad_scatter(idx, v0, v1, zeros())
    plain = hash_encode.table_grad_scatter_plain(idx, v0, v1, zeros())
    mass = hash_encode.table_grad_scatter_plain(idx, v0.abs(), v1.abs(), zeros())
    one = torch.ones_like(v0)
    count = hash_encode.table_grad_scatter_plain(idx, one, one, zeros())
    bound = 2.0 * count.clamp_min(8.0) * 2.0**-24 * mass + 1e-30
    assert bool(((scattered - plain).abs() <= bound).all())
    dense_cols = hash_encode._dense_width(hash_encode._split_levels(spec)[0])
    assert scattered[:, dense_cols:].abs().max() == 0


# hashed-level counts of K1 k = 1's sizes: 1 (6 levels, 1 promoted dense),
# 7 (the tuned spec), 12 (the drop-in spec), 32 (33 levels of 2^12 entries)
K1_SPECS = {1: dict(n_levels=6, log2_hashmap_size=19, extra_dense_levels=1), 7: TUNED, 12: DROP_IN,
            32: dict(n_levels=33, log2_hashmap_size=12)}


@pytest.mark.parametrize("Lh", list(K1_SPECS))
@pytest.mark.parametrize("N", [0, 1, 255, 257, 196_608, 524_288])
def test_hash_levels_fwd_k1_matches_plain(cuda_device, N, Lh):
    """K1 k = 1 (one thread per point over its levels, 32-bit entries)
    equals its plain version bit for bit, output and plan (sel), with a
    float32 output and into a bf16 slice of the encode's layout, at N = 0
    (nothing launched), 1, a block's edge and the tuned step's and grid
    update's sizes, over 1, 7, 12 and 32 hashed levels (the last group of
    levels ragged)."""
    spec = HashGridSpec(**K1_SPECS[Lh], fwd_corners=1, grad_corners=1)
    dense, hashed = hash_encode._split_levels(spec)
    assert len(hashed) == Lh
    rng = np.random.default_rng(50 + Lh)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)).to(cuda_device)
    x, y, z = _ray_samples(-(-N // 64), 64, 51, cuda_device) if N > 64 else _positions(N, 51, cuda_device)
    x, y, z = (c[:N].contiguous() for c in (x, y, z))
    ref, plan = hash_encode.hash_levels_fwd_plain(spec, planes, x, y, z)
    for out in (None, torch.empty(2, len(dense) + Lh, N, dtype=torch.bfloat16, device=cuda_device)[:, len(dense) :]):
        sel = torch.full((Lh, N), -1, dtype=torch.int32, device=cuda_device)
        before = hash_encode.launch_counts["hash_levels_fwd"]
        got = hash_encode.hash_levels_fwd(spec, planes, x, y, z, sel=sel, out=out)
        torch.cuda.synchronize()
        assert hash_encode.launch_counts["hash_levels_fwd"] == before + (N > 0)
        assert got.shape == (2, Lh, N) and got.dtype == (torch.float32 if out is None else torch.bfloat16)
        assert torch.equal(got, ref.to(got.dtype)) and torch.equal(sel.long(), plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1 exact", "K1 k=1", "K4 exact", "K4 k=1"])
def test_forward_kernels_write_into_a_plane_strided_slice(cuda_device, kernel, dtype):
    """K1 and K4, each mode, write their rows into a slice of a larger
    buffer (two more rows, a plane stride of (rows + 2) * N), in float32 or
    bf16: the slice equals the plain output cast to the buffer's dtype bit
    for bit, and the sentinels around it are untouched."""
    mode = {"K1 k=1": dict(fwd_corners=1, grad_corners=1), "K4 k=1": dict(dense_corners=1)}.get(kernel, {})
    spec = HashGridSpec(**TUNED, **mode)
    dense, hashed = hash_encode._split_levels(spec)
    rng = np.random.default_rng(52)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)).to(cuda_device)
    x, y, z = _ray_samples(521, 192, 53, cuda_device)
    N, rows = x.shape[0], len(hashed if kernel.startswith("K1") else dense)
    buf = torch.full((2, rows + 2, N), -7.0, dtype=dtype, device=cuda_device)
    before = buf.clone()
    view = buf[:, 1 : 1 + rows]
    if kernel.startswith("K1"):
        got = hash_encode.hash_levels_fwd(spec, planes, x, y, z, out=view)
        ref, _ = hash_encode.hash_levels_fwd_plain(spec, planes, x, y, z)
    else:
        got = hash_encode.dense_levels_fwd(spec, planes, x, y, z, dtype, out=view)
        ref, _ = hash_encode.dense_levels_fwd_plain(spec, planes, x, y, z, dtype)
    torch.cuda.synchronize()
    assert got.data_ptr() == view.data_ptr() and _same_bits(view, ref.to(dtype))
    outside = torch.ones_like(buf, dtype=torch.bool)
    outside[:, 1 : 1 + rows] = False
    assert _same_bits(buf[outside], before[outside])


ENCODE_SPECS = {"tuned": dict(**TUNED, fwd_corners=1, grad_corners=1, grad_levels=2), "drop-in": DROP_IN,
                "dc1": dict(**TUNED, fwd_corners=1, grad_corners=1, grad_levels=2, dense_corners=1),
                "dgl1": dict(**TUNED, fwd_corners=1, grad_corners=1, grad_levels=2, dense_grad_levels=1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ENCODE_SPECS))
def test_encode_on_the_card_equals_the_plain_concat(cuda_device, name, dtype):
    """The encode on the card (K4 and K1 writing their rows of one buffer in
    its dtype) equals, bit for bit, the concat of the plain parts each cast
    to dtype (what the forward computed before), at the tuned, drop-in,
    dc1 and dgl1 specs; one launch each of K4 and K1."""
    spec = HashGridSpec(**ENCODE_SPECS[name])
    rng = np.random.default_rng(54)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)).to(cuda_device)
    x, y, z = _ray_samples(521, 192, 55, cuda_device)
    N = x.shape[0]
    before = dict(hash_encode.launch_counts)
    got = hash_encode.hash_encode_planar(spec, planes, x, y, z, dtype)
    torch.cuda.synchronize()
    assert {k: hash_encode.launch_counts[k] - before[k] for k in ("hash_levels_fwd", "dense_levels_fwd")} == \
        {"hash_levels_fwd": 1, "dense_levels_fwd": 1}
    dense_part, _ = hash_encode.dense_levels_fwd_plain(spec, planes, x, y, z, dtype)
    hashed_part, _ = hash_encode.hash_levels_fwd_plain(spec, planes, x, y, z)
    want = torch.cat([dense_part.to(dtype), hashed_part.to(dtype)], dim=1).reshape(2 * spec.n_levels, N)
    assert _same_bits(got, want)


def test_hash_levels_fwd_k1_raises_on_2_31_columns(cuda_device):
    """K1 k = 1 indexes in 32 bits: planes of 2^31 columns or more raise a
    ValueError before anything else (an expanded view: nothing allocated)."""
    spec = HashGridSpec(**TUNED, fwd_corners=1, grad_corners=1)
    planes = torch.zeros(2, 1, device=cuda_device).expand(2, 2**31)
    x, y, z = _positions(8, 56, cuda_device)
    with pytest.raises(ValueError, match="2\\^31"):
        hash_encode.hash_levels_fwd(spec, planes, x, y, z)


@pytest.mark.parametrize("bad", ["on_the_cpu", "float16", "shape", "level_stride", "overlapping_planes",
                                 "exact_dense_in_another_dtype"])
@pytest.mark.parametrize("kind", ["hashed", "dense"])
def test_forward_wrappers_reject_a_malformed_out(cuda_device, kind, bad):
    """out= on the card: a tensor on the CPU, in float16, of another shape,
    with rows not contiguous, with overlapping planes, or (exact dense) in
    another dtype than the one computed in, raises a ValueError and
    launches nothing."""
    spec = HashGridSpec(**TUNED)
    dense, hashed = hash_encode._split_levels(spec)
    planes = torch.zeros(2, spec.total_table_size, device=cuda_device)
    x, y, z = _positions(1000, 57, cuda_device)
    rows, N = len(hashed if kind == "hashed" else dense), 1000
    out = {"on_the_cpu": lambda: torch.empty(2, rows, N),
           "float16": lambda: torch.empty(2, rows, N, dtype=torch.float16, device=cuda_device),
           "shape": lambda: torch.empty(2, rows, N + 1, device=cuda_device),
           "level_stride": lambda: torch.empty(2, N, rows, device=cuda_device).transpose(1, 2),
           "overlapping_planes": lambda: torch.empty(1, rows, N, device=cuda_device).expand(2, rows, N),
           "exact_dense_in_another_dtype": lambda: torch.empty(2, rows, N, dtype=torch.bfloat16,
                                                               device=cuda_device)}[bad]()
    if bad == "exact_dense_in_another_dtype" and kind == "hashed":
        out = torch.empty(2, rows, N, dtype=torch.float64, device=cuda_device)  # K1 takes float32 or bf16 only
    before = dict(hash_encode.launch_counts)
    with pytest.raises(ValueError, match="out must be"):
        if kind == "hashed":
            hash_encode.hash_levels_fwd(spec, planes, x, y, z, out=out)
        else:
            hash_encode.dense_levels_fwd(spec, planes, x, y, z, torch.float32, out=out)
    assert hash_encode.launch_counts == before


@pytest.mark.parametrize("knob", [{}, {"hash_dense_grad_levels": 1}, {"hash_dense_corners": 1}])
def test_train_step_launches_the_kernels(cuda_device, knob):
    """A tuned-estimator step on the card goes through K1-K5, also with
    either dense knob."""
    from nerfjax_torch.train import TrainSettings, make_train_state, train_step

    cfg = {"ngp": True, "nerf_type": "small", "hash_n_levels": 8, "hash_extra_dense_levels": 1,
           "single_pass": True, "occupancy_grid": True, "occ_fast_cdf": True, "occ_resolution": 16,
           "occ_segments": 8, "occ_update_partitions": 4, "N_samples": 8, "N_importance": 16,
           "hash_fwd_corners": 1, "hash_grad_corners": 1, "hash_grad_levels": 2, **knob}
    state = make_train_state(cfg, TrainSettings.from_cfg(cfg, 10), device=cuda_device)
    rng = np.random.default_rng(26)
    o = rng.normal(size=(64, 3)).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=1, keepdims=True)
    batch = {"rays_o": o, "rays_d": d, "rgb": rng.uniform(size=(64, 3)).astype(np.float32),
             "t_near": np.full(64, 1.5, np.float32), "t_far": np.full(64, 3.5, np.float32)}
    hash_encode.reset_launch_counts()
    m = train_step(state, {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss_fine"]))
    assert all(n >= 1 for n in hash_encode.launch_counts.values()), hash_encode.launch_counts


def test_dropin_step_launches_the_kernels_twice(cuda_device):
    """An exact two-pass step (the drop-in sampler, no grid) runs each hash
    kernel once per field pass: K1 and K4 in both forwards, K5, K3 and K2
    in both backwards."""
    from nerfjax_torch.train import TrainSettings, make_train_state, train_step

    cfg = {"ngp": True, "nerf_type": "small", "hash_n_levels": 8, "single_pass": False, "occupancy_grid": False,
           "N_samples": 8, "N_importance": 16}
    state = make_train_state(cfg, TrainSettings.from_cfg(cfg, 10), device=cuda_device)
    rng = np.random.default_rng(31)
    o = rng.normal(size=(64, 3)).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o / np.linalg.norm(o, axis=1, keepdims=True)
    batch = {"rays_o": o, "rays_d": d, "rgb": rng.uniform(size=(64, 3)).astype(np.float32),
             "t_near": np.full(64, 1.5, np.float32), "t_far": np.full(64, 3.5, np.float32)}
    hash_encode.reset_launch_counts()
    m = train_step(state, {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss_fine"])) and float(m["loss_coarse"]) > 0
    assert hash_encode.launch_counts == {k: 2 for k in hash_encode.launch_counts}, hash_encode.launch_counts


def test_render_image_runs_the_head_kernel(cuda_device):
    """Eval rendering on the card goes through the fused head in both
    passes (one launch per pass and chunk)."""
    from nerfjax_torch.render_image import orbit_poses, render_image
    from nerfjax_torch.train import build_fields

    field = build_fields({"ngp": True, "nerf_type": "small", "hash_n_levels": 8}, device=cuda_device)[1]
    field.init(torch.Generator().manual_seed(0))
    K = np.array([[25.6, 0.0, 16.0], [0.0, 25.6, 16.0], [0.0, 0.0, 1.0]], np.float32)
    fused_mlp.reset_launch_counts()
    img = render_image(field, K, orbit_poses(2)[0], 32, 32, n_samples=8, n_importance=16, chunk_rays=256)
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert fused_mlp.launch_counts["fused_ngp_head"] >= 2 and fused_mlp.launch_counts["fused_ngp_head"] % 2 == 0


# -- leader + residual (k >= 2) ------------------------------------------------------

DROP_IN_LR = dict(n_levels=16, log2_hashmap_size=19)  # cfg/blender_scene_fast.yml's model: 4 dense + 12 hashed


def _lr_positions(spec, N: int, seed: int, device):
    """x, y, z [N] on ``device``: ray samples (neighbouring lanes share
    cells), then the plan's edge cases at the front: the origin (the 8
    weights tie), (1, 1, 1) (a dense corner of weight 1: total = 0) and
    lattice points of every hashed level (total = 0)."""
    x, y, z = (c[:N].contiguous() for c in _ray_samples(-(-N // 64), 64, seed, device))
    _, hashed = hash_encode._split_levels(spec)
    lattice = torch.tensor(np.concatenate([(np.arange(1, 5) - 0.5) / lp["scale"] for lp in hashed]),
                           dtype=torch.float32, device=device)
    for c in (x, y, z):
        c[0], c[1] = 0.0, 1.0
        c[2 : 2 + lattice.numel()] = lattice
    return x, y, z


def _scatter_bound(idx, v0, v1, total: int, device, prior: float = 0.0):
    """2 * max(n, 8) * 2^-24 * (|prior| + sum|terms|) per entry of n terms
    added into ``prior``: two f32 sums of the same terms in any order lie
    within it."""
    zeros = lambda: torch.zeros(2, total, device=device)  # noqa: E731
    one = torch.ones_like(v0)
    mass = hash_encode.table_grad_scatter_plain(idx, v0.abs(), v1.abs(), zeros())
    count = hash_encode.table_grad_scatter_plain(idx, one, one, zeros())
    return 2.0 * count.clamp_min(8.0) * 2.0**-24 * (mass + abs(prior)) + 1e-30


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 3, 7])
@pytest.mark.parametrize("kind", ["hashed", "dense"])
@pytest.mark.parametrize("spec_kw", [TUNED, DROP_IN_LR], ids=["tuned", "fast"])
def test_lr_forward_matches_plain(cuda_device, spec_kw, kind, k, dtype):
    """K1 (hash_fwd_corners = k) and K4 (hash_dense_corners = k) at k >= 2
    equal their plain versions with torch.equal, output (into a slice of the
    encode's layout in dtype) and plan (sel [k, L, N]), at the tuned and the
    fast cfg's specs; one launch each."""
    spec = HashGridSpec(**spec_kw, **({"fwd_corners": k} if kind == "hashed" else {"dense_corners": k}))
    dense, hashed = hash_encode._split_levels(spec)
    rows = len(hashed if kind == "hashed" else dense)
    rng = np.random.default_rng(60 + k)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)).to(cuda_device)
    N = 100_003
    x, y, z = _lr_positions(spec, N, 61, cuda_device)
    buf = torch.empty(2, len(dense) + len(hashed), N, dtype=dtype, device=cuda_device)
    out = buf[:, len(dense):] if kind == "hashed" else buf[:, : len(dense)]
    sel = torch.full((k, rows, N), -1, dtype=torch.int32, device=cuda_device)
    name = "hash_levels_fwd" if kind == "hashed" else "dense_levels_fwd"
    before = hash_encode.launch_counts[name]
    if kind == "hashed":
        got = hash_encode.hash_levels_fwd(spec, planes, x, y, z, sel=sel, out=out)
        ref, plan = hash_encode.hash_levels_fwd_plain(spec, planes, x, y, z)
    else:
        got = hash_encode.dense_levels_fwd(spec, planes, x, y, z, dtype, sel=sel, out=out)
        ref, plan = hash_encode.dense_levels_fwd_plain(spec, planes, x, y, z, dtype)
    torch.cuda.synchronize()
    assert hash_encode.launch_counts[name] == before + 1
    assert plan.shape == (k, rows, N) and torch.equal(sel.long(), plan)
    assert got.data_ptr() == out.data_ptr() and _same_bits(got, ref.to(dtype))


LR_BWD = [(8, 2, 0), (8, 3, 2), (2, 8, 0), (3, 3, 2), (7, 7, 0), (7, 2, 2), (3, 1, 0)]


@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fwd,grad,gl", LR_BWD)
def test_lr_hash_levels_bwd_matches_plain(cuda_device, fwd, grad, gl, gdt):
    """K2 with b = min(grad, fwd) planned corners per row (b >= 2: leader +
    residual; b = 1 under a k >= 2 forward: the k = 1 plan), over all levels
    or gl drawn levels ((g*coef)*(Lh/gl)), from a bf16 or f32 cotangent,
    within the atomic-order bound of the plain scatter of the same terms,
    and adding into planes that hold values; one launch."""
    spec = HashGridSpec(**DROP_IN_LR, fwd_corners=fwd, grad_corners=grad, grad_levels=gl)
    _, hashed = hash_encode._split_levels(spec)
    N, total = 100_003, spec.total_table_size
    x, y, z = _lr_positions(spec, N, 62, cuda_device)
    g = torch.from_numpy(np.random.default_rng(63).normal(size=(2, len(hashed), N)).astype(np.float32))
    g = g.to(cuda_device, gdt)
    terms = hash_encode.hash_bwd_entries(spec, g, x, y, z)
    assert terms[0].numel() == min(grad, fwd) * (gl or len(hashed)) * N
    zeros = lambda: torch.zeros(2, total, device=cuda_device)  # noqa: E731
    before = hash_encode.launch_counts["hash_levels_bwd"]
    got = hash_encode.hash_levels_bwd(spec, g, x, y, z, zeros())
    ref = hash_encode.hash_levels_bwd_plain(spec, g, x, y, z, zeros())
    torch.cuda.synchronize()
    assert hash_encode.launch_counts["hash_levels_bwd"] == before + 1
    assert bool(((got - ref).abs() <= _scatter_bound(*terms, total, cuda_device)).all())
    assert got[:, : hashed[0]["offset"]].abs().max() == 0
    prior = torch.ones(2, total, device=cuda_device)  # K2 adds into planes that hold values
    into = hash_encode.hash_levels_bwd(spec, g, x, y, z, prior.clone())
    ref = hash_encode.hash_levels_bwd_plain(spec, g, x, y, z, prior.clone())
    assert bool(((into - ref).abs() <= _scatter_bound(*terms, total, cuda_device, prior=1.0)).all())


@pytest.mark.parametrize("b,gl", [(2, 0), (7, 0), (2, 2)])
@pytest.mark.parametrize("inputs", ["one_position", "rays", "one_point"])
def test_k2_lr_matches_plain_under_contention(cuda_device, inputs, b, gl):
    """K2 b >= 2 (over all levels each warp's runs of equal indices merged
    per (level, draw), one add of both sums per run) within the
    atomic-order bound under the worst contention: every point at one
    position (N = 100,003: the last warp of each level is partial), the
    fast step's layout of 48 sorted samples a ray, and N = 1; over all
    levels and over gl drawn levels; also adding into planes that hold
    values; one launch."""
    spec = HashGridSpec(**DROP_IN_LR, fwd_corners=b, grad_corners=b, grad_levels=gl)
    _, hashed = hash_encode._split_levels(spec)
    total = spec.total_table_size
    if inputs == "one_position":
        x, y, z = (torch.full((100_003,), v, device=cuda_device) for v in (0.3, 0.6, 0.2))
    elif inputs == "rays":
        x, y, z = _ray_samples(2083, 48, 64, cuda_device)
    else:
        x, y, z = _positions(1, 65, cuda_device)
    N = x.shape[0]
    g = torch.from_numpy(np.random.default_rng(66).normal(size=(2, len(hashed), N)).astype(np.float32))
    g = g.to(cuda_device, torch.bfloat16)
    terms = hash_encode.hash_bwd_entries(spec, g, x, y, z)
    zeros = lambda: torch.zeros(2, total, device=cuda_device)  # noqa: E731
    before = hash_encode.launch_counts["hash_levels_bwd"]
    got = hash_encode.hash_levels_bwd(spec, g, x, y, z, zeros())
    torch.cuda.synchronize()
    assert hash_encode.launch_counts["hash_levels_bwd"] == before + 1
    ref = hash_encode.hash_levels_bwd_plain(spec, g, x, y, z, zeros())
    assert bool(((got - ref).abs() <= _scatter_bound(*terms, total, cuda_device)).all())
    assert got[:, : hashed[0]["offset"]].abs().max() == 0 and bool((got != 0).any())
    if inputs == "one_position" and not gl:  # every lane of a level adds to one entry per draw: whole warps
        assert hash_encode.k2_lr_atomic_count(spec, g, x, y, z) == b * len(hashed) * -(-N // 32)
    prior = torch.from_numpy(np.random.default_rng(67).normal(size=(2, total)).astype(np.float32)).to(cuda_device)
    into = hash_encode.hash_levels_bwd(spec, g, x, y, z, prior.clone())
    ref = hash_encode.hash_levels_bwd_plain(spec, g, x, y, z, prior.clone())
    idx, v0, _ = terms
    one = torch.ones_like(v0)
    count = hash_encode.table_grad_scatter_plain(idx, one, one, zeros())
    mass = hash_encode.hash_levels_bwd_plain(spec, g.abs(), x, y, z, zeros())
    bound = 2.0 * (count + 1).clamp_min(8.0) * 2.0**-24 * (mass + prior.abs()) + 1e-30
    assert bool(((into - ref).abs() <= bound).all())


@pytest.mark.parametrize("N", [1, 31, 33, 257, 100_003])
@pytest.mark.parametrize("k", range(2, 8))
def test_lr_hash_levels_fwd_on_packed_words_at_ragged_n(cuda_device, k, N):
    """K1 k >= 2 (the hashed columns packed into bf16-pair words in front,
    k planned words loaded together, k a template parameter) equals its
    plain version with torch.equal, output and plan, in f32 and bf16, at
    every k of 2..7 and at N that are not multiples of the block or the
    warp; one launch a call."""
    spec = HashGridSpec(**DROP_IN_LR, fwd_corners=k)
    _, hashed = hash_encode._split_levels(spec)
    rng = np.random.default_rng(70 + k)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)).to(cuda_device)
    x, y, z = _lr_positions(spec, N, 71, cuda_device) if N > 64 else _positions(N, 72, cuda_device)
    ref, plan = hash_encode.hash_levels_fwd_plain(spec, planes, x, y, z)
    for dtype in (torch.float32, torch.bfloat16):
        sel = torch.full((k, len(hashed), N), -1, dtype=torch.int32, device=cuda_device)
        before = hash_encode.launch_counts["hash_levels_fwd"]
        got = hash_encode.hash_levels_fwd(spec, planes, x, y, z, sel=sel,
                                          out=torch.empty(2, len(hashed), N, dtype=dtype, device=cuda_device))
        torch.cuda.synchronize()
        assert hash_encode.launch_counts["hash_levels_fwd"] == before + 1
        assert _same_bits(got, ref.to(dtype)) and torch.equal(sel.long(), plan)


@pytest.mark.parametrize("N", [1, 33, 257, 100_003])
@pytest.mark.parametrize("k", range(2, 8))
def test_lr_dense_levels_fwd_at_ragged_n(cuda_device, k, N):
    """K4 k >= 2 (one thread per (level, point), k a template parameter, the
    k planned words of the pack loaded together) equals its plain version
    with torch.equal, output and plan, in f32 and bf16, at every k of 2..7,
    at N that are not multiples of the block or the warp, into a view of
    the encode's layout that starts one element off its buffer; one launch
    and one pack a call."""
    spec = HashGridSpec(**TUNED, dense_corners=k)
    Ld = len(hash_encode._split_levels(spec)[0])
    rng = np.random.default_rng(80 + k)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)).to(cuda_device)
    x, y, z = _lr_positions(spec, N, 81, cuda_device) if N > 64 else _positions(N, 82, cuda_device)
    ref, plan = hash_encode.dense_levels_fwd_plain(spec, planes, x, y, z, torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.full((2 * (Ld + 1) * N + 1,), -7.0, dtype=dtype, device=cuda_device)
        view = flat[1:].view(2, Ld + 1, N)[:, :Ld]
        sel = torch.full((k, Ld, N), -1, dtype=torch.int32, device=cuda_device)
        before = dict(hash_encode.launch_counts)
        got = hash_encode.dense_levels_fwd(spec, planes, x, y, z, torch.bfloat16, sel=sel, out=view)
        torch.cuda.synchronize()
        assert hash_encode.launch_counts["dense_levels_fwd"] == before["dense_levels_fwd"] + 1
        assert hash_encode.launch_counts["pack_pairs"] == before["pack_pairs"] + 1
        assert got.data_ptr() == view.data_ptr() and _same_bits(got, ref.to(dtype))
        assert torch.equal(sel.long(), plan)
        assert bool((flat[0] == -7.0).all()) and bool((flat[1:].view(2, Ld + 1, N)[:, Ld] == -7.0).all())


@pytest.mark.parametrize("k", [2, 7])
def test_lr_dense_levels_fwd_extreme_table_values(cuda_device, k):
    """K4 k >= 2 on subnormal tables, +-3.4e38 (inf once rounded to bf16 by
    the pack) and zeros of both signs: the outputs other than NaN equal
    the plain version's bit for bit and the NaNs sit where its do."""
    spec = HashGridSpec(**TUNED, dense_corners=k)
    rng = np.random.default_rng(83)
    planes = rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)
    which = rng.integers(0, 6, planes.shape)
    extreme = np.array([0.0, -0.0, 1e-39, -3e-40, 3.4e38, -3.4e38], np.float32)
    planes = np.where(rng.uniform(size=planes.shape) < 0.3, extreme[which], planes * 2.0 ** rng.integers(-140, -100,
                                                                                                       planes.shape))
    planes = torch.from_numpy(planes.astype(np.float32)).to(cuda_device)
    x, y, z = _lr_positions(spec, 100_003, 84, cuda_device)
    got = hash_encode.dense_levels_fwd(spec, planes, x, y, z, torch.bfloat16)
    ref = hash_encode.dense_levels_fwd_plain(spec, planes, x, y, z, torch.bfloat16)[0]
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], ref[~nan]) and bool((ref.abs() > 1e38).any())
    assert bool(((ref != 0) & (ref.abs() < 2.0**-126)).any())


@pytest.mark.parametrize("T", [1, 3, 4, 5, 1027, 753_489])
@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "misaligned"])
def test_pack_pairs_bf16_four_a_thread_and_the_rest(cuda_device, T, shift):
    """The bf16-pair pack (four entries a thread from 16-byte loads where
    both planes and the words are 16-byte aligned, else one at a time; the
    T % 4 left over one at a time) equals pack_pairs_plain word for word,
    from columns that start on and off a 16-byte boundary."""
    rng = np.random.default_rng(73)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, T + 8)).astype(np.float32)).to(cuda_device)
    cols = planes[:, shift : shift + T]
    got = hash_encode.pack_pairs(cols, False)
    torch.cuda.synchronize()
    assert torch.equal(got, hash_encode.pack_pairs_plain(cols, False))


@pytest.mark.parametrize("gl", [1, 2, 3])
@pytest.mark.parametrize("inputs", ["one_position", "rays"])
def test_k2_gl_skips_zero_terms_under_contention(cuda_device, inputs, gl):
    """K2 b = 2 over gl drawn levels (one thread per point over its draws,
    terms of 0 left out) within the atomic-order bound under contention
    (every point at one position; 48 sorted samples a ray), with a band of
    zero cotangent and, for gl >= 2, points that draw one level twice; an
    all-zero cotangent adds nothing: planes holding -0.0 keep their bits
    (an add of +0.0 would make them +0.0)."""
    spec = HashGridSpec(**DROP_IN_LR, fwd_corners=2, grad_corners=2, grad_levels=gl)
    _, hashed = hash_encode._split_levels(spec)
    Lh, total = len(hashed), spec.total_table_size
    if inputs == "one_position":
        x, y, z = (torch.full((100_003,), v, device=cuda_device) for v in (0.3, 0.6, 0.2))
    else:
        x, y, z = _ray_samples(2083, 48, 74, cuda_device)
    N = x.shape[0]
    ids = hash_encode._draw_levels(x, y, z, Lh, gl, hash_encode.LEVEL_SALT)
    if gl >= 2 and inputs == "rays":
        assert bool((ids[0] == ids[1]).any())
    g = torch.from_numpy(np.random.default_rng(75).normal(size=(2, Lh, N)).astype(np.float32))
    g[..., N // 3 : N // 2] = 0.0
    g = g.to(cuda_device, torch.bfloat16)
    terms = hash_encode.hash_bwd_entries(spec, g, x, y, z)
    zeros = lambda: torch.zeros(2, total, device=cuda_device)  # noqa: E731
    got = hash_encode.hash_levels_bwd(spec, g, x, y, z, zeros())
    ref = hash_encode.hash_levels_bwd_plain(spec, g, x, y, z, zeros())
    torch.cuda.synchronize()
    assert bool(((got - ref).abs() <= _scatter_bound(*terms, total, cuda_device)).all())
    assert got[:, : hashed[0]["offset"]].abs().max() == 0 and bool((got != 0).any())
    assert hash_encode.k2_lr_atomic_count(spec, g, x, y, z) < 2 * gl * N
    negzero = torch.full((2, total), -0.0, device=cuda_device)
    out = hash_encode.hash_levels_bwd(spec, torch.zeros_like(g), x, y, z, negzero.clone())
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), negzero.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dc,grad", [(2, 8), (3, 3), (7, 8), (7, 2), (3, 1)])
def test_lr_dense_levels_bwd_matches_plain(cuda_device, dc, grad, dtype):
    """K5 with b = min(grad, dense_corners) planned corners (b >= 2: leader
    + residual, entries in (level, draw, point) order) equals its plain
    version with torch.equal; K3 on its output within the atomic-order
    bound, inside the dense columns."""
    spec = HashGridSpec(**DROP_IN_LR, dense_corners=dc, grad_corners=grad)
    dense, _ = hash_encode._split_levels(spec)
    N, total, b = 100_003, spec.total_table_size, min(grad, dc)
    x, y, z = _lr_positions(spec, N, 64, cuda_device)
    g = torch.from_numpy(np.random.default_rng(65).normal(size=(2, len(dense), N)).astype(np.float32))
    g = g.to(cuda_device, dtype)
    before = hash_encode.launch_counts["dense_levels_bwd"]
    got = hash_encode.dense_levels_bwd(spec, g, x, y, z, dtype)
    ref = hash_encode.dense_levels_bwd_plain(spec, g, x, y, z, dtype)
    torch.cuda.synchronize()
    assert hash_encode.launch_counts["dense_levels_bwd"] == before + 1
    assert got[0].numel() == b * len(dense) * N
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype and torch.equal(a, r)
    zeros = lambda: torch.zeros(2, total, device=cuda_device)  # noqa: E731
    scattered = hash_encode.table_grad_scatter(*got, zeros())
    plain = hash_encode.table_grad_scatter_plain(*got, zeros())
    assert bool(((scattered - plain).abs() <= _scatter_bound(*got, total, cuda_device)).all())
    assert scattered[:, hash_encode._dense_width(dense):].abs().max() == 0


def _small_step(cfg: dict, device):
    """A fresh train state for ``cfg`` on ``device`` with its grid updated
    once (fixed jitter), and a batch of 256 seeded rays aimed through the
    [-0.5, 0.5]^3 cube: (state, settings, batch)."""
    from nerfjax_torch.ops.occupancy import draw_update_jitter
    from nerfjax_torch.train import TrainSettings, make_train_state, update_occupancy

    settings = TrainSettings.from_cfg(cfg, 100)
    state = make_train_state(cfg, settings, seed=0, device=device)
    rng = np.random.default_rng(66)
    o = rng.normal(size=(256, 3)).astype(np.float32)
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    batch = {"rays_o": o, "rays_d": d, "rgb": rng.uniform(size=(256, 3)).astype(np.float32),
             "t_near": np.full(256, 1.0, np.float32), "t_far": np.full(256, 4.0, np.float32)}
    jitter = draw_update_jitter(settings.occ_spec(), torch.Generator().manual_seed(1), "cpu")
    update_occupancy(state, jitter=jitter.to(device))
    return state, settings, {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def test_fast_step_on_the_card_matches_the_cpu(cuda_device):
    """One step of cfg/blender_scene_fast.yml's estimators (exact forward,
    the k = 2 table gradient) at a small size in float32, card (kernels)
    against CPU (plain versions), with the CPU's grid and the same sampler
    uniforms: losses within 1e-5 relative, every gradient within rtol 1e-4
    (atol 1e-4 x its largest entry); K2 ran with b = 2."""
    from nerfjax_torch.train import train_step

    cfg = {"ngp": True, "nerf_type": "small", "hash_n_levels": 8, "single_pass": True, "occupancy_grid": True,
           "occ_resolution": 16, "occ_segments": 8, "N_samples": 16, "N_importance": 32, "precision": "fp32",
           "hash_grad_corners": 2, "lr": 5e-3}
    cpu, settings, batch_c = _small_step(cfg, "cpu")
    card, _, batch_k = _small_step(cfg, cuda_device)
    card.occ_grid = cpu.occ_grid.to(cuda_device)
    xi = torch.rand(256, 48, generator=torch.Generator().manual_seed(2))
    cpu.step = card.step = 1
    m_cpu = train_step(cpu, batch_c, u_strat=xi)
    hash_encode.reset_launch_counts()
    m_card = train_step(card, batch_k, u_strat=xi.to(cuda_device))
    torch.cuda.synchronize()
    assert hash_encode._grad_corners(card.field.spec) == 2 and hash_encode.launch_counts["hash_levels_bwd"] == 1
    assert abs(float(m_card["loss_fine"]) - float(m_cpu["loss_fine"])) <= 1e-5 * float(m_cpu["loss_fine"])
    for (name, pc), pk in zip(cpu.field.named_parameters(), card.field.parameters()):
        gc, gk = pc.grad, pk.grad.cpu()
        assert torch.allclose(gk, gc, rtol=1e-4, atol=1e-4 * float(gc.abs().max())), name


@pytest.mark.parametrize("knob", [{"hash_grad_corners": 2, "hash_fwd_corners": 8, "hash_grad_levels": 0},
                                  {"hash_fwd_corners": 2, "hash_grad_corners": 2, "hash_grad_levels": 2,
                                   "hash_dense_corners": 2}], ids=["fast", "k2"])
def test_lr_train_step_launches_the_kernels(cuda_device, knob):
    """A step with k >= 2 estimators on the card goes through K1-K5 (each
    launched once in the step) with no NaN."""
    from nerfjax_torch.train import train_step

    cfg = {"ngp": True, "nerf_type": "small", "hash_n_levels": 8, "hash_extra_dense_levels": 1,
           "single_pass": True, "occupancy_grid": True, "occ_resolution": 16, "occ_segments": 8,
           "N_samples": 8, "N_importance": 16, **knob}
    state, _, batch = _small_step(cfg, cuda_device)
    hash_encode.reset_launch_counts()
    m = train_step(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss_fine"]))
    assert all(n >= 1 for n in hash_encode.launch_counts.values()), hash_encode.launch_counts


# -- the chain's head: ray precompute and the batch feed -------------------------------


def test_precompute_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """The ray precompute on the card (rays and intersection there, the
    kept rays fetched once a chunk) gives the CPU path's arrays bit for
    bit: get_rays forms its products and sums as an exact chain of fused
    multiply-adds, the same on both."""
    import json

    from PIL import Image

    from nerfjax_torch import rays as R
    from nerfjax_torch.render_image import orbit_poses

    rng = np.random.default_rng(91)
    frames = []
    for i, c2w in enumerate(orbit_poses(5, radius=2.4, height=0.9)):
        path = tmp_path / f"f{i}.png"
        Image.fromarray(rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)).save(path)
        frames.append({"file_path": str(path), "transform_matrix": c2w.tolist()})
    scene = tmp_path / "transforms_c.json"
    scene.write_text(json.dumps({"h": 96, "w": 128, "K": [[100.0, 0.0, 64.0], [0.0, 100.0, 48.0], [0.0, 0.0, 1.0]],
                                 "frames": frames}))
    stats = {}
    got = R.precompute_rays_for_scene(scene, batch_frames=2, device=cuda_device, stats=stats)
    want = R.precompute_rays_for_scene(scene, device="cpu")
    assert 0 < stats["kept"] < stats["generated"] == 5 * 96 * 128
    for k in R.RAY_KEYS:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_on_the_card_yields_the_host_batches(cuda_device, depth):
    """prefetch_to_device on the card: each batch, read on the current
    stream after work queued in front of it, equals the host's bit for bit,
    and stays so while later batches refill the pinned buffers (every
    batch is held until the end)."""
    from nerfjax_torch.data import prefetch_to_device

    rng = np.random.default_rng(90 + depth)
    host = [{k: rng.normal(size=shape).astype(np.float32) for k, shape in
             (("rays_o", (8192, 3)), ("rgb", (8192, 3)), ("t_far", (8192,)))} for _ in range(9)]
    held, work = [], torch.ones(2048, 2048, device=cuda_device)
    for b in prefetch_to_device(iter(host), cuda_device, depth=depth):
        work = work @ work / 2048.0  # the step's stream is busy when the batch arrives
        held.append({k: v * 1.0 for k, v in b.items()})
        held.append(b)
    torch.cuda.synchronize()
    assert len(held) == 2 * len(host)
    for i, h in enumerate(host):
        for b in held[2 * i : 2 * i + 2]:
            for k, v in h.items():
                assert b[k].device.type == "cuda" and torch.equal(b[k].cpu(), torch.from_numpy(v)), (i, k)


# -- the feature-last encode (pack_pairs + hashgrid_fwd, hashgrid_bwd) ---------------------

GRID_SPECS = {"tuned": TUNED, "medium16": dict(n_levels=16, log2_hashmap_size=17),
              "small6_ed1": dict(n_levels=6, log2_hashmap_size=15, extra_dense_levels=1)}


def _grid_x01(inputs: str, N: int, device):
    """x01 [N, 3]: uniform with the domain's corners first; ray-major samples
    (neighbouring points share cells); or one position repeated."""
    if inputs == "one_position":
        return torch.tensor([[0.3, 0.6, 0.2]], device=device).expand(N, 3).contiguous()
    if inputs == "rays":
        return torch.stack(_ray_samples(N // 192, 192, 51, device), dim=1).contiguous()
    return torch.stack(_positions(N, 52, device), dim=1).contiguous()


def _grid_bwd_bound(spec, g, x01, device):
    return _scatter_bound(*hash_encode.hashgrid_bwd_entries_plain(spec, g, x01), spec.total_table_size, device)


@pytest.mark.parametrize("inputs", ["uniform", "rays", "one_position"])
@pytest.mark.parametrize("spec", list(GRID_SPECS))
def test_hashgrid_encode_kernels_match_plain(cuda_device, spec, inputs):
    """hashgrid_fwd torch.equal to hashgrid_encode_plain (it sums a level's
    8 corners in the plain version's order, each product and sum rounded on
    its own); hashgrid_bwd and the autograd encode's table gradient within
    the atomic-order bound of hashgrid_bwd_plain; each wrapper launched once
    per call, the pack once in front of each forward, K3 never."""
    spec = HashGridSpec(**GRID_SPECS[spec])
    N = 100_032 if inputs == "rays" else 100_003
    rng = np.random.default_rng(53)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)).to(cuda_device)
    x01 = _grid_x01(inputs, N, cuda_device)
    before = dict(hash_encode.launch_counts)
    got = hash_encode.hashgrid_fwd(spec, planes, x01)
    ref = hash_encode.hashgrid_encode_plain(spec, planes, x01)
    torch.cuda.synchronize()
    assert got.shape == (x01.shape[0], 2 * spec.n_levels) and got.dtype == torch.float32
    assert torch.equal(got, ref)
    g = torch.from_numpy(rng.normal(size=tuple(got.shape)).astype(np.float32)).to(cuda_device)
    zeros = lambda: torch.zeros(2, spec.total_table_size, device=cuda_device)  # noqa: E731
    gref = hash_encode.hashgrid_bwd_plain(spec, g, x01, zeros())
    bound = _grid_bwd_bound(spec, g, x01, cuda_device)
    assert bool(((hash_encode.hashgrid_bwd(spec, g, x01, zeros()) - gref).abs() <= bound).all())
    p = planes.clone().requires_grad_(True)
    (hash_encode.hashgrid_encode(spec, p, x01) * g).sum().backward()
    assert bool(((p.grad - gref).abs() <= bound).all())
    counts = {k: hash_encode.launch_counts[k] - before[k] for k in before}
    assert counts == {**{k: 0 for k in before}, "hashgrid_fwd": 2, "pack_pairs": 2, "hashgrid_bwd": 2}


@pytest.mark.parametrize("N", [0, 1, 31, 63, 64, 65, 1_000])
@pytest.mark.parametrize("spec", ["medium16", "small6_ed1"])
def test_hashgrid_fwd_at_ragged_n_and_the_faces(cuda_device, spec, N):
    """N not a multiple of the block's 64 points, and every point on a face
    or an edge of the domain (dense corners clipped to [0, r-1]): torch.equal
    to plain; N = 0 launches nothing."""
    spec = HashGridSpec(**GRID_SPECS[spec])
    rng = np.random.default_rng(55)
    planes = torch.from_numpy(rng.uniform(-1, 1, (2, spec.total_table_size)).astype(np.float32)).to(cuda_device)
    x01 = rng.uniform(size=(N, 3)).astype(np.float32)
    x01[np.arange(N), np.arange(N) % 3] = (np.arange(N) // 3) % 2  # one coordinate 0 or 1
    rows = np.arange(0, N, 7)
    x01[rows, (rows + 1) % 3] = 1.0  # and every 7th on an edge
    x01 = torch.from_numpy(x01).to(cuda_device)
    before = hash_encode.launch_counts["hashgrid_fwd"]
    got = hash_encode.hashgrid_fwd(spec, planes, x01)
    torch.cuda.synchronize()
    assert got.shape == (N, 2 * spec.n_levels)
    assert torch.equal(got, hash_encode.hashgrid_encode_plain(spec, planes, x01))
    assert hash_encode.launch_counts["hashgrid_fwd"] == before + (N > 0)


@pytest.mark.parametrize("zero", ["all", "half", "levels"])
def test_hashgrid_bwd_skips_zero_cotangent(cuda_device, zero):
    """A cotangent that is all 0 leaves the gradient exactly as it was (0 +
    nothing); with half of the points' rows 0, or levels 0, 2 and 4 0 in
    both planes, the gradient lies within the atomic-order bound of plain and
    the entries only zero terms reach stay 0."""
    spec = HashGridSpec(**GRID_SPECS["small6_ed1"])
    x01 = _grid_x01("rays", 20_160, cuda_device)
    rng = np.random.default_rng(56)
    g = torch.from_numpy(rng.normal(size=(x01.shape[0], 2 * spec.n_levels)).astype(np.float32)).to(cuda_device)
    if zero == "all":
        g.zero_()
    elif zero == "half":
        g[: x01.shape[0] // 2] = 0.0
    else:
        g[:, ::2] = 0.0
    zeros = lambda: torch.zeros(2, spec.total_table_size, device=cuda_device)  # noqa: E731
    got = hash_encode.hashgrid_bwd(spec, g, x01, zeros())
    ref = hash_encode.hashgrid_bwd_plain(spec, g, x01, zeros())
    torch.cuda.synchronize()
    assert bool(((got - ref).abs() <= _grid_bwd_bound(spec, g, x01, cuda_device)).all())
    assert torch.equal(got == 0, ref == 0)
    if zero == "all":
        assert not bool(got.any())


def test_hashgrid_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    spec = HashGridSpec(**GRID_SPECS["small6_ed1"])
    planes = torch.zeros(2, spec.total_table_size, device=cuda_device)
    x01 = torch.rand(10, 3, device=cuda_device)
    g = torch.zeros(10, 2 * spec.n_levels, device=cuda_device)
    with pytest.raises(ValueError):
        hash_encode.hashgrid_fwd(spec, planes, x01.t().contiguous())
    with pytest.raises(ValueError):
        hash_encode.hashgrid_fwd(spec, planes.double(), x01)
    with pytest.raises(ValueError):
        hash_encode.hashgrid_fwd(spec, planes[:, :-1], x01)
    with pytest.raises(ValueError):
        hash_encode.hashgrid_fwd(spec, planes, x01.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        hash_encode.hashgrid_bwd(spec, torch.zeros(10, 3, device=cuda_device), x01, planes.clone())
    with pytest.raises(ValueError):
        hash_encode.hashgrid_bwd(spec, g.t().contiguous().t(), x01, planes.clone())  # g not contiguous
    with pytest.raises(ValueError):
        hash_encode.hashgrid_bwd(spec, g, x01, planes[:, :-1].clone())
    with pytest.raises(ValueError):
        hash_encode.hashgrid_bwd(spec, g, x01, planes.t().contiguous().t())  # out not contiguous
    with pytest.raises(ValueError):
        hash_encode.hashgrid_bwd(spec, g.double(), x01, planes.clone())
    assert hash_encode.hashgrid_fwd(spec, planes, x01[:0]).shape == (0, 2 * spec.n_levels)


def test_render_rays_on_the_card_runs_the_feature_last_kernels(cuda_device):
    """render_rays(train=True) with remat: each pass's encode twice (the
    forward and its recomputation, each with its pack), its backward once,
    K3 never; the same outputs as the CPU's coarse pass within 2e-5 at the
    same uniforms."""
    from nerfjax_torch import render
    from nerfjax_torch.train import build_fields

    cfg = {"ngp": True, "nerf_type": "small", "hash_n_levels": 6}
    cpu = build_fields(cfg, train=True)[1].init(torch.Generator().manual_seed(0))
    card = build_fields(cfg, train=True, device=cuda_device)[1].load_params(cpu.params())
    rng = np.random.default_rng(54)
    B = 256
    o = rng.normal(size=(B, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 2.5
    d = rng.uniform(-0.4, 0.4, (B, 3)) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    near = rng.uniform(1.0, 1.6, B)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (o, d, near, near + 2.0, rng.uniform(size=(B, 16)),
                                                               rng.uniform(size=(B, 32)))]
    before = dict(hash_encode.launch_counts)
    outs = []
    for dev, f in ((cuda_device, card), ("cpu", cpu)):
        o_, d_, n_, f_, us, up = (a.to(dev) for a in args)
        out = render.render_rays(f, f, o_, d_, n_, f_, 16, 32, train=True, u_strat=us, u_pdf=up)
        (out["rgb_fine"].sum() + out["rgb_coarse"].sum()).backward()
        outs.append({k: v.detach().cpu() for k, v in out.items()})
    torch.cuda.synchronize()
    counts = {k: hash_encode.launch_counts[k] - before[k] for k in before}
    assert counts == {**{k: 0 for k in before}, "hashgrid_fwd": 4, "pack_pairs": 4, "hashgrid_bwd": 2}
    assert float((outs[0]["rgb_coarse"] - outs[1]["rgb_coarse"]).abs().max()) <= 2e-5
    assert float((outs[0]["weights_coarse"] - outs[1]["weights_coarse"]).abs().max()) <= 2e-5
    assert card.table.grad is not None and bool(torch.isfinite(card.table.grad).all())


# -- the probe kernels ---------------------------------------------------------------

from nerfjax_torch import probes  # noqa: E402


@pytest.mark.parametrize("i", range(6), ids=list(probes.launch_counts))
def test_probe_kernel_matches_plain(cuda_device, i):
    """Each probe kernel against its plain version on micro_probe.py's
    inputs: equal (the dots within K * 2^-24 * sum |a||b| per element)."""
    name, kernel, wrapper, plain, args, bound = probes.probes(*probes.probe_inputs(cuda_device))[i]
    before = probes.launch_counts[kernel]
    probes.check(name, wrapper(*args), plain(*args), bound)
    assert probes.launch_counts[kernel] == before + 1


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("K,M,N", [(1, 37, 45), (17, 130, 70), (300, 64, 33), (300, 96, 40), (128, 512, 128)])
def test_dot_ragged_shapes_within_bound(cuda_device, K, M, N, bf16):
    """The dot at shapes off its tiles (M, N not multiples of the tile nor,
    for some, of 4: the 4-byte staging path), K below one mma step, and K
    beyond one stage (300: three chunks through two buffers): within K *
    2^-24 * sum|a||b| per element of the plain version."""
    rng = np.random.default_rng(K * 1000 + M + N)
    a = torch.from_numpy(rng.normal(size=(K, M)).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(cuda_device)
    name = "k_dot_dim0_bf16" if bf16 else "k_dot_dim0"
    plain = probes.k_dot_dim0_bf16_plain if bf16 else probes.k_dot_dim0_plain
    ra, rb = (probes._bf16(a), probes._bf16(b)) if bf16 else (a, b)
    got = probes._dot(name, a, b, bf16)
    torch.cuda.synchronize()
    probes.check(name, got, plain(a, b), probes.dot_bound(ra, rb))


def test_probes_main_on_the_card(cuda_device, capsys):
    assert probes.main(device="cuda") == 0
    assert sum(line.endswith(" OK") for line in capsys.readouterr().out.splitlines()) == 6


# -- K6: the statistical outlier filter's kNN ---------------------------------------

from nerfjax_torch.colmap import outliers  # noqa: E402
from nerfjax_torch.ops import knn  # noqa: E402


GRID_KERNELS = {"knn_bin", "knn_scatter", "knn_mark", "knn_grid", "knn_tail"}
KNN_SUBSET_ABOVE = 200_000  # above this many points the plain version runs on KNN_SUBSET seeded queries
KNN_SUBSET = 4_096


def _knn_cloud(n: int, kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    if kind == "duplicates" and n > 4:
        pts[1::4] = pts[0::4][: len(pts[1::4])]
        pts[3] = pts[0]
    elif kind == "equal":
        pts[:] = np.float32([0.25, -1.5, 3.0])
    elif kind == "one_cell":  # three quarters of the points in one place: no cell size splits them
        pts[: 3 * n // 4] = pts[0]
    elif kind == "clustered":
        from chip_smoke import clustered_cloud

        pts = clustered_cloud(n, seed)[0]
    return pts


def _knn_checked(pts: torch.Tensor, k: int, **kw) -> torch.Tensor:
    """K6 once, with the launches of its route checked, held
    against the plain version with torch.equal (above KNN_SUBSET_ABOVE
    points on KNN_SUBSET seeded queries)."""
    n = pts.shape[0]
    before = dict(knn.launch_counts)
    got = knn.knn_mean_distances(pts, k, **kw)
    torch.cuda.synchronize()
    launched = {name: v - before[name] for name, v in knn.launch_counts.items() if v != before[name]}
    route = knn.last_run["route"]
    # knn_bin also counts the plan's bins (one a cell side it tries, whichever route it then takes) and
    # one a grid level; knn_scatter, knn_mark and knn_grid one a level
    bins = launched.pop("knn_bin", 0)
    if route == "grid":
        levels = knn.last_run["levels"]
        assert 1 <= levels <= knn.LEVELS and bins >= levels
        assert launched == {"knn_scatter": levels, "knn_mark": levels, "knn_grid": levels, "knn_tail": 1}, launched
    else:
        assert launched == {"knn_mean_dist": 1}, launched
    if n > KNN_SUBSET_ABOVE:
        q = torch.from_numpy(np.random.default_rng(n + k).choice(n, KNN_SUBSET, replace=False)).to(pts.device)
        assert torch.equal(got[q], knn.knn_mean_distances_plain(pts, k, queries=q))
    else:
        assert torch.equal(got, knn.knn_mean_distances_plain(pts, k))
    return got


@pytest.mark.parametrize("kind", ["normal", "duplicates", "equal", "one_cell", "clustered"])
@pytest.mark.parametrize("k", [1, 20, 64, 256])
@pytest.mark.parametrize("n", [2, 21, 1_000, 100_003, 1_200_000])
def test_knn_kernel_equals_plain(cuda_device, n, k, kind):
    """K6 against its plain version on the card, bit for bit (torch.equal):
    k >= n is clamped to n - 1; duplicates count at distance 0. Clouds of
    4,096 points or more take the grid unless no cell size splits them
    (all points equal, or three quarters in one place: the brute kernel);
    the clustered cloud is chip_smoke.py's, with its planted outliers."""
    pts = torch.from_numpy(_knn_cloud(n, kind, seed=n + k)).to(cuda_device)
    got = _knn_checked(pts, k)
    grid = n >= knn.GRID_MIN_POINTS and kind not in ("equal", "one_cell")
    assert knn.last_run["route"] == ("grid" if grid else "brute")
    if kind == "equal":
        assert not got.any()


def _sphere(n: int, n_out: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n + n_out, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * np.concatenate([np.full(n, 0.5), rng.uniform(2.5, 25.0, n_out)])[:, None]).astype(np.float32)


@pytest.mark.parametrize("tail_pairs", ["default", 0])
@pytest.mark.parametrize("k", [1, 20])
@pytest.mark.parametrize("cloud", ["normal", "sphere", "clustered"])
def test_knn_grid_counts_the_plain_grids_pairs(cuda_device, cloud, k, tail_pairs, monkeypatch):
    """The grid kernels test exactly the pairs of knn_grid_plain (the plan
    in torch, run on the CPU at the same plan) and send the same queries
    to the tail; both equal the brute-force plain version. TAIL_PAIRS at 0
    sends every open query on through the coarser levels."""
    if tail_pairs != "default":
        monkeypatch.setattr(knn, "TAIL_PAIRS", tail_pairs)
    n = 3_000
    pts = {"normal": lambda: _knn_cloud(n, "normal", 7), "sphere": lambda: _sphere(n - 30, 30, 7),
           "clustered": lambda: _knn_cloud(n, "clustered", 7)}[cloud]()
    pts = torch.from_numpy(pts).to(cuda_device)
    plan = knn.knn_plan(pts, k, route="grid")
    got = _knn_checked(pts, k, plan=plan)
    want, pairs, tails = knn.knn_grid_plain(pts.cpu(), k, plan)
    assert torch.equal(got.cpu(), want)
    assert int(knn.last_run["pairs"]) == pairs and int(knn.last_run["tail"]) == tails
    if cloud == "sphere" and tail_pairs == "default":
        assert tails >= 30  # the isolated points finish in the tail


@pytest.mark.parametrize("k", [1, 20, 64])
@pytest.mark.parametrize("cloud", ["lattice", "faces"])
def test_knn_grid_on_cell_boundaries(cuda_device, cloud, k):
    """Points exactly on cell faces: a lattice whose spacing is the cell
    side (every point on three faces, up to the float64 binning), and
    points snapped to the faces' coordinates and moved by one float32 ulp
    either way."""
    h = 0.125
    if cloud == "lattice":
        g = np.arange(20, dtype=np.float32) * np.float32(h) + np.float32(-1.0)
        pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    else:
        rng = np.random.default_rng(k)
        pts = (np.round(rng.uniform(-1.0, 1.0, (12_000, 3)) / h) * h).astype(np.float32)
        pts = np.nextafter(pts, pts + rng.choice([-1.0, 0.0, 1.0], pts.shape).astype(np.float32))
        pts[0] = -1.0  # the origin on a face
    pts = torch.from_numpy(pts).to(cuda_device)
    plan = knn.knn_plan(pts, k, route="grid", h=h)
    assert plan.h == h
    _knn_checked(pts, k, plan=plan)


@pytest.mark.parametrize("k", [1, 20, 256])
def test_knn_tail_takes_every_open_query(cuda_device, k, monkeypatch):
    """One level at r_max = 0: every query whose own cell does not settle
    it goes to the tail kernel, one warp each."""
    pts = torch.from_numpy(_knn_cloud(20_000, "clustered", 3)).to(cuda_device)
    plan = knn.knn_plan(pts, k, route="grid")
    monkeypatch.setattr(knn, "R_MAX", 0)
    monkeypatch.setattr(knn, "LEVELS", 1)
    _knn_checked(pts, k, plan=plan)
    assert int(knn.last_run["tail"]) > 1_000


def test_knn_grid_forced_on_one_cell(cuda_device):
    """The grid on a cloud it cannot split (three quarters in one cell)
    is slow but exact."""
    pts = torch.from_numpy(_knn_cloud(20_000, "one_cell", 5)).to(cuda_device)
    assert knn.knn_plan(pts, 20).route == "brute"
    _knn_checked(pts, 20, plan=knn.knn_plan(pts, 20, route="grid"))


@pytest.mark.parametrize("k", [3, 20])
def test_knn_kernel_on_a_strided_view(cuda_device, k):
    """A non-contiguous [n, 3] view (every other row of a [2n, 4] tensor)."""
    base = torch.from_numpy(np.random.default_rng(k).normal(size=(2 * 1_037, 4)).astype(np.float32)).to(cuda_device)
    view = base[::2, 1:]
    assert not view.is_contiguous()
    assert torch.equal(knn.knn_mean_distances(view, k), knn.knn_mean_distances_plain(view.contiguous(), k))


def test_knn_kernel_limit(cuda_device):
    pts = torch.from_numpy(_knn_cloud(600, "normal", 1)).to(cuda_device)
    with pytest.raises(ValueError, match="K_MAX = 256"):
        knn.knn_mean_distances(pts, 257)
    small = pts[:200]  # k = 257 clamps to 199, within the limit
    assert torch.equal(knn.knn_mean_distances(small, 257), knn.knn_mean_distances_plain(small, 199))
    assert torch.equal(knn.knn_mean_distances(pts[:1], 20), torch.zeros(1, device=cuda_device))


@pytest.mark.parametrize("nb, std_ratio", [(20, 2.0), (50, 1.0)])
def test_statistical_filter_card_keeps_the_cpu_indices(cuda_device, nb, std_ratio):
    rng = np.random.default_rng(nb)
    pts = rng.normal(size=(20_000, 3))
    pts[:300] += rng.normal(size=(300, 3)) * 25.0
    outliers.reset_filter_stats()
    kept_card, keep_card = outliers.remove_statistical_outliers(pts, nb, std_ratio, device="cuda")
    stats = dict(outliers.filter_stats)
    kept_cpu, keep_cpu = outliers.remove_statistical_outliers(pts, nb, std_ratio, device="cpu")
    assert np.array_equal(keep_card, keep_cpu) and np.array_equal(kept_card, kept_cpu)
    assert 0.0 < stats["knn"] <= stats["outlier_filter"] and stats["points_kept"] == len(keep_card)


@pytest.mark.parametrize("cloud", ["lattice", "shell"])
def test_radius_filter_card_keeps_the_cpu_indices(cuda_device, cloud):
    """filter_radius_outliers on the card keeps the CPU's indices. The
    lattice's spacing is the radius, so every neighbour pair sits on r^2;
    the shell's 30,000 points have ~16 neighbours each within r."""
    if cloud == "lattice":
        g = np.arange(-12, 13) * 0.1
        pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3) + np.array([0.3, -1.1, 2.7])
        radius, nb = 0.1, 6
    else:
        d = np.random.default_rng(5).normal(size=(30_000, 3))
        pts = 0.5 * d / np.linalg.norm(d, axis=1, keepdims=True)
        radius, nb = 0.023, 16
    kept_card, keep_card = outliers.filter_radius_outliers(pts, radius, nb, device="cuda")
    kept_cpu, keep_cpu = outliers.filter_radius_outliers(pts, radius, nb, device="cpu")
    assert np.array_equal(keep_card, keep_cpu) and np.array_equal(kept_card, kept_cpu)
    assert 0 < len(keep_cpu) < len(pts)
