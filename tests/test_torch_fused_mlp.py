"""The fused MLP kernels' plain PyTorch versions against nerfjax's Pallas
kernels (interpret mode on the CPU, as tests/test_pallas_mlp.py runs them).
The CUDA kernels themselves are held to the plain versions by
tests/test_torch_kernels_cuda.py, on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfjax.ops.pallas_mlp import fused_ngp_density as density_jax
from nerfjax.ops.pallas_mlp import fused_ngp_head as head_jax
from nerfjax_torch.ops import fused_mlp

DIMS = {"dmlp": [(None, 64), (64, 16)], "cmlp": [(32, 64), (64, 64), (64, 3)]}


def _params(E: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, dims in DIMS.items():
        out[name] = []
        for fan_in, fan_out in dims:
            fan_in = fan_in or E
            bound = np.sqrt(6.0 / (fan_in + fan_out))
            out[name].append({"w": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32)})
    return out


def _inputs(E: int, N: int, seed: int):
    rng = np.random.default_rng(seed)
    enc = rng.uniform(-1.0, 1.0, (E, N)).astype(np.float32)
    sh = rng.uniform(-1.0, 1.0, (16, N)).astype(np.float32)
    return enc, sh


def _torch_params(params):
    return {k: [{"w": torch.from_numpy(l["w"])} for l in v] for k, v in params.items()}


def _jax_params(params):
    return {k: [{"w": jnp.asarray(l["w"])} for l in v] for k, v in params.items()}


def _ulp_bound(ref: np.ndarray) -> np.ndarray:
    # one bf16 ulp of each reference value, taken at no less than 2^-14: near
    # zero (where relu cuts) two summation orders differ by float32 noise of
    # O(1) sums, below 2^-21
    mag = np.maximum(np.abs(ref), 2.0**-14)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("E", [24, 32])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_versions_match_pallas(E, dt):
    """N = 1500 is not a multiple of the Pallas tile (1024). f32: atol 2e-5,
    the bound of tests/test_pallas_mlp.py (summation order only). bf16: the
    outputs are rounded once from f32 values that differ in summation order,
    so at most one bf16 ulp."""
    jdt, tdt = DTYPES[dt]
    params = _params(E, seed=E)
    enc, sh = _inputs(E, 1500, seed=E + 1)
    enc_j, sh_j = jnp.asarray(enc).astype(jdt), jnp.asarray(sh).astype(jdt)
    rgb_j, sig_j = head_jax(_jax_params(params), enc_j, sh_j, interpret=True)
    dsig_j = density_jax(_jax_params(params), enc_j, interpret=True)

    tp = _torch_params(params)
    enc_t = torch.from_numpy(enc).to(tdt)
    sh_t = torch.from_numpy(sh).to(tdt)
    rgb_t, sig_t = fused_mlp.fused_ngp_head(tp, enc_t, sh_t)
    dsig_t = fused_mlp.fused_ngp_density(tp, enc_t)
    assert rgb_t.dtype == tdt and rgb_t.shape == (3, 1500) and sig_t.shape == (1500,)

    pairs = [(rgb_t, rgb_j), (sig_t, sig_j), (dsig_t, dsig_j)]
    for got, ref in pairs:
        got = got.to(torch.float32).numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        if dt == "f32":
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        else:
            assert (np.abs(got - ref) <= _ulp_bound(ref)).all()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_density_sigma_equals_head_sigma(dt):
    _, tdt = DTYPES[dt]
    tp = _torch_params(_params(24, seed=5))
    enc, sh = _inputs(24, 3001, seed=6)
    enc_t = torch.from_numpy(enc).to(tdt)
    _, sigma = fused_mlp.fused_ngp_head(tp, enc_t, torch.from_numpy(sh).to(tdt))
    assert torch.equal(fused_mlp.fused_ngp_density(tp, enc_t), sigma)


def test_wrapper_rejects_bad_inputs():
    tp = _torch_params(_params(24, seed=7))
    enc, sh = _inputs(24, 8, seed=8)
    with pytest.raises(ValueError):  # enc width differs from W1's fan-in
        fused_mlp.fused_ngp_density(tp, torch.from_numpy(enc[:20]))
    with pytest.raises(ValueError):  # no kernel and no plain version for 'meta'
        fused_mlp.fused_ngp_head(tp, torch.empty(24, 8, device="meta"), torch.empty(16, 8, device="meta"))
    with pytest.raises(ValueError):
        fused_mlp.fused_ngp_density(tp, torch.from_numpy(enc).to(torch.float16))


def test_plain_path_launches_no_kernel():
    tp = _torch_params(_params(24, seed=9))
    enc, sh = _inputs(24, 64, seed=10)
    fused_mlp.reset_launch_counts()
    fused_mlp.fused_ngp_head(tp, torch.from_numpy(enc), torch.from_numpy(sh))
    assert fused_mlp.launch_counts == {"fused_ngp_head": 0, "fused_ngp_density": 0}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pack_weights_layout(dt):
    """The kernels' buffer (the OFF_W* offsets of csrc/fused_mlp.cu): W1..W5
    row-major [out, in] in float32 holding values rounded to enc's dtype,
    W1's fan-in zero-padded from E = 24 to 32."""
    _, tdt = DTYPES[dt]
    params = _params(24, seed=11)
    buf = fused_mlp.pack_weights(_torch_params(params), tdt, "cpu")
    assert buf.dtype == torch.float32 and buf.shape == (fused_mlp.W_TOTAL,)
    w1 = buf[: 64 * 32].reshape(64, 32)
    assert not w1[:, 24:].any()
    ws = [params["dmlp"][0]["w"], params["dmlp"][1]["w"]] + [l["w"] for l in params["cmlp"]]
    off = 0
    for i, w in enumerate(ws):
        rounded = torch.from_numpy(w.T.copy()).to(tdt).to(torch.float32)
        got = w1[:, :24] if i == 0 else buf[off : off + w.size].reshape(w.shape[1], w.shape[0])
        assert torch.equal(got, rounded)
        off += 64 * 32 if i == 0 else w.size
    assert off == fused_mlp.W_TOTAL


def test_wrapper_rejects_bad_packed_buffer():
    tp = _torch_params(_params(24, seed=12))
    enc = torch.zeros(24, 8)
    bad = fused_mlp.pack_weights(tp, torch.float32, "cpu")[:-1]
    with pytest.raises(ValueError):
        fused_mlp._weight_buffer("fused_ngp_density", tp, enc, bad)
