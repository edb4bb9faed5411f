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


@pytest.mark.parametrize("E", [24, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 100_003])
def test_kernels_match_plain(cuda_device, E, dtype, N):
    """Each kernel against its plain version: one bf16 ulp (f32: atol 2e-5,
    summation order only); the density sigma bit-identical to the head's."""
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


def test_wrapper_rejects_wide_encoding(cuda_device):
    params = _params(40, 13, cuda_device)
    with pytest.raises(ValueError):
        fused_mlp.fused_ngp_density(params, torch.zeros(40, 8, device=cuda_device))


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


def test_train_step_launches_the_kernels(cuda_device):
    """A tuned-estimator step on the card goes through K1, K2 and K3."""
    from nerfjax_torch.train import TrainSettings, make_train_state, train_step

    cfg = {"ngp": True, "nerf_type": "small", "hash_n_levels": 8, "hash_extra_dense_levels": 1,
           "single_pass": True, "occupancy_grid": True, "occ_fast_cdf": True, "occ_resolution": 16,
           "occ_segments": 8, "occ_update_partitions": 4, "N_samples": 8, "N_importance": 16,
           "hash_fwd_corners": 1, "hash_grad_corners": 1, "hash_grad_levels": 2}
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
