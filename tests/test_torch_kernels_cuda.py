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
