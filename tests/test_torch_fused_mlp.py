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


@pytest.mark.parametrize("E", [24, 32, 40, 64])
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


def _unfragment(buf: torch.Tensor, fan_in: int, fan_out: int) -> torch.Tensor:
    """W [fan_out, fan_in] from the bf16 kernels' B fragments (k16 step s,
    n8 tile j, in the order s * fan_out / 8 + j): lane 4g + t of fragment
    (s, j) holds w[8j + g, 16s + 2t + (0, 1, 8, 9)]."""
    w = torch.empty(fan_out, fan_in, dtype=buf.dtype)
    frags = buf.reshape(fan_in // 16, fan_out // 8, 32, 4)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for q, dk in enumerate((0, 1, 8, 9)):
            w[g::8, 2 * t + dk :: 16] = frags[:, :, lane, q].T
    return w


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_pack_weights_layout(dt):
    """The kernels' buffer at E = 24. f32 (the OFF_T* offsets of
    csrc/fused_mlp.cu): W1..W5 transposed, row-major [in, out] in float32,
    W5's 3 outputs padded with a zero column to 4. bf16 (the OFF_B*
    offsets): W1..W5 in bf16, each in mma B-fragment order, W1's fan-in
    zero-padded to 32 and W5's 3 outputs to 8."""
    _, tdt = DTYPES[dt]
    params = _params(24, seed=11)
    buf = fused_mlp.pack_weights(_torch_params(params), tdt, "cpu")
    assert buf.dtype == tdt and buf.shape == (fused_mlp.weights_size(24, tdt),)
    ws = [params["dmlp"][0]["w"], params["dmlp"][1]["w"]] + [l["w"] for l in params["cmlp"]]
    off = 0
    if dt == "f32":
        for i, w in enumerate(ws):
            cols = 4 if i == 4 else w.shape[1]
            got = buf[off : off + w.shape[0] * cols].reshape(w.shape[0], cols)
            assert torch.equal(got[:, : w.shape[1]], torch.from_numpy(w))
            assert not got[:, w.shape[1] :].any()
            off += w.shape[0] * cols
        assert off == fused_mlp.weights_size(24, tdt) == 8960
        return
    for w, (fan_in, fan_out) in zip(ws, [(32, 64), (64, 16), (32, 64), (64, 64), (64, 8)]):
        got = _unfragment(buf[off : off + fan_in * fan_out], fan_in, fan_out)
        want = torch.zeros(fan_out, fan_in, dtype=torch.bfloat16)
        want[: w.shape[1], : w.shape[0]] = torch.from_numpy(w.T.copy()).to(torch.bfloat16)
        assert torch.equal(got, want)
        off += fan_in * fan_out
    assert off == fused_mlp.weights_size(24, tdt) == 9728


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("E", [33, 40, 64, 100, 128])
def test_pack_weights_chunks_wide_encodings(E, dt):
    """f32: W1 is packed transposed, [E, 64] with no padding at any E, and
    W2..W5 follow. bf16: W1's fan-in is padded to a multiple of 16
    (ceil(E / 16) k16 steps of fragments), zero past E, and W2..W5
    follow."""
    _, tdt = DTYPES[dt]
    params = _params(E, seed=E)
    buf = fused_mlp.pack_weights(_torch_params(params), tdt, "cpu")
    w1_ref = torch.from_numpy(params["dmlp"][0]["w"].T.copy()).to(tdt)
    w2_ref = torch.from_numpy(params["dmlp"][1]["w"].T.copy()).to(tdt)
    if dt == "f32":
        assert buf.shape == (fused_mlp.weights_size(E, tdt),) == (E * 64 + 7424,)
        full = buf[: E * 64].reshape(E, 64).T
        w2 = buf[E * 64 : E * 64 + 64 * 16].reshape(64, 16).T
    else:
        E16 = -(-E // 16) * 16
        assert buf.shape == (fused_mlp.weights_size(E, tdt),) == (E16 * 64 + 7680,)
        full = _unfragment(buf[: E16 * 64], E16, 64)
        w2 = _unfragment(buf[E16 * 64 : E16 * 64 + 16 * 64], 64, 16)
    assert torch.equal(full[:, :E], w1_ref)
    assert not full[:, E:].any()
    assert torch.equal(w2, w2_ref)


@pytest.mark.parametrize("E", [1, 17, 24, 32, 40, 100, 128])
def test_bf16_pack_decodes_to_the_weights(E):
    """The bf16 buffer decodes back to W1..W5 rounded to bf16, each zero-
    padded as the kernels read it: W1's fan-in to a multiple of 16, W5's 3
    outputs to 8."""
    params = _params(E, seed=E)
    buf = fused_mlp.pack_weights(_torch_params(params), torch.bfloat16, "cpu")
    E16 = -(-E // 16) * 16
    assert buf.dtype == torch.bfloat16 and buf.shape == (fused_mlp.weights_size(E, torch.bfloat16),)
    assert buf.shape == (64 * E16 + 16 * 64 + 64 * 32 + 64 * 64 + 8 * 64,)
    ws = [params["dmlp"][0]["w"], params["dmlp"][1]["w"]] + [l["w"] for l in params["cmlp"]]
    pads = [(E16, 64), (64, 16), (32, 64), (64, 64), (64, 8)]
    off = 0
    for w, (fan_in, fan_out) in zip(ws, pads):
        got = _unfragment(buf[off : off + fan_in * fan_out], fan_in, fan_out)
        want = torch.zeros(fan_out, fan_in, dtype=torch.bfloat16)
        want[: w.shape[1], : w.shape[0]] = torch.from_numpy(w.T.copy()).to(torch.bfloat16)
        assert torch.equal(got, want)
        off += fan_in * fan_out
    assert off == buf.numel()


def _kernel_model_f32(buf: torch.Tensor, enc: torch.Tensor, sh: torch.Tensor):
    """(rgb, sigma) in float64, reading the packed f32 buffer at the offsets
    the f32 kernels read it (W1t at k * 64 + o, then W2t, W3t, W4t, W5t at
    the OFF_T* offsets, W5t's rows 4 wide)."""
    E = enc.shape[0]
    b = buf.to(torch.float64)
    w1t = b[: E * 64].reshape(E, 64)
    rest = b[E * 64 :]
    w2t = rest[:1024].reshape(64, 16)
    w3t = rest[1024:3072].reshape(32, 64)
    w4t = rest[3072:7168].reshape(64, 64)
    w5t = rest[7168:7424].reshape(64, 4)
    h = torch.relu(w1t.T @ enc.to(torch.float64))
    feat = torch.relu(w2t.T @ h)
    h2 = torch.relu(w3t.T @ torch.cat([feat, sh.to(torch.float64)]))
    h3 = torch.relu(w4t.T @ h2)
    return torch.sigmoid(w5t.T @ h3)[:3], feat[0]


@pytest.mark.parametrize("E", [1, 24, 33, 128])
def test_f32_pack_read_as_the_kernels_read_it(E):
    """A float64 model of the f32 kernels that reads the packed buffer at
    their offsets computes the plain version's outputs (atol 2e-5: float32
    rounding only), so the buffer's layout and the kernels' indexing agree."""
    tp = _torch_params(_params(E, seed=40 + E))
    enc, sh = (torch.from_numpy(a) for a in _inputs(E, 257, seed=41 + E))
    buf = fused_mlp.pack_weights(tp, torch.float32, "cpu")
    rgb_m, sig_m = _kernel_model_f32(buf, enc, sh)
    rgb_p, sig_p = fused_mlp.fused_ngp_head_plain(tp, enc, sh)
    np.testing.assert_allclose(rgb_m.numpy(), rgb_p.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(sig_m.numpy(), sig_p.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kernels_shared_memory_fits_a_block(dt):
    """The Python mirror of the kernels' dynamic shared memory (which the
    loader holds equal to the library's nerf_fused_smem_bytes) fits one
    block of an H100, 232,448 bytes, at every E from 1 to 128, for the head
    and the density kernel; the f32 head at E = 24 leaves room for two
    blocks an SM (228 KB, 1 KB of it reserved per block)."""
    _, tdt = DTYPES[dt]
    for E in range(1, fused_mlp.E_MAX + 1):
        for density in (False, True):
            size = fused_mlp.smem_bytes(E, tdt, density)
            assert 0 < size <= 232_448, (E, density, size)
            assert size % 16 == 0
    if dt == "f32":
        assert fused_mlp.smem_bytes(24, tdt) == 4 * (8960 + (24 + 16 + 64 + 16) * 128) == 97_280
        assert 2 * (fused_mlp.smem_bytes(24, tdt) + 1024) <= 228 * 1024
        assert fused_mlp.smem_bytes(128, tdt, density=True) == 4 * (128 * 64 + 1024 + (256 + 64) * 128 + 64)


def test_wrapper_rejects_bad_packed_buffer():
    """A buffer of the wrong length, of the other dtype's layout, or off a
    16-byte boundary."""
    tp = _torch_params(_params(24, seed=12))
    enc = torch.zeros(24, 8)
    f32 = fused_mlp.pack_weights(tp, torch.float32, "cpu")
    bf16 = fused_mlp.pack_weights(tp, torch.bfloat16, "cpu")
    shifted = torch.cat([bf16[:1], bf16])[1:]  # the right size and values, 2 bytes past a 16-byte boundary
    for e, bad in ((enc, f32[:-1]), (enc, bf16), (enc.to(torch.bfloat16), f32), (enc.to(torch.bfloat16), bf16[:-8]),
                   (enc.to(torch.bfloat16), shifted)):
        with pytest.raises(ValueError):
            fused_mlp._weight_buffer("fused_ngp_density", tp, e, bad)
    assert fused_mlp._weight_buffer("fused_ngp_density", tp, enc.to(torch.bfloat16), bf16) is bf16


def test_twenty_level_field_runs_the_fused_heads_like_nerfjax():
    """A 20-level field (E = 40, wider than one 32-row chunk of W1) through
    the port's apply_planar_fused and query_density_planar_fused against
    nerfjax's (Pallas in interpret mode), the same weights carried over by
    params_from_jax: f32 within atol 2e-5 (summation order only); the port's
    bf16 density equal to its head's sigma."""
    import jax

    from nerfjax.fields.ngp import InstantNGP as JaxNGP
    from nerfjax_torch.checkpoint import params_from_jax
    from nerfjax_torch.fields.ngp import InstantNGP

    jf = JaxNGP("small", n_levels=20)
    params = jax.device_get(jf.init(jax.random.PRNGKey(3)))
    params["table"] = params["table"] * 2000.0  # a field with structure, not ~0
    tf = InstantNGP("small", n_levels=20).load_params(params_from_jax(params))
    assert tf.spec.output_dim == 40
    rng = np.random.default_rng(13)
    pos = rng.uniform(-1.0, 1.0, (3, 600)).astype(np.float32)
    view = pos / np.linalg.norm(pos, axis=0, keepdims=True)
    pj, vj = (tuple(jnp.asarray(c) for c in a) for a in (pos, view))
    pt, vt = (tuple(torch.from_numpy(c.copy()) for c in a) for a in (pos, view))

    rgb_j, sig_j = jf.apply_planar_fused(params, pj, vj, dtype=jnp.float32, interpret=True)
    rgb_t, sig_t = tf.apply_planar_fused(pt, vt, dtype=torch.float32)
    assert rgb_t.shape == (3, 600) and sig_t.shape == (600,)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=0, atol=2e-5)

    dsig_j = jf.query_density_planar_fused(params, pj, dtype=jnp.float32, interpret=True)
    dsig_t = tf.query_density_planar_fused(pt, dtype=torch.float32)
    assert torch.equal(dsig_t, sig_t)
    np.testing.assert_allclose(dsig_t.numpy(), np.asarray(dsig_j), rtol=0, atol=2e-5)
    dsig_bf16 = tf.query_density_planar_fused(pt)
    assert dsig_bf16.dtype == torch.bfloat16 and torch.equal(dsig_bf16, tf.apply_planar_fused(pt, vt)[1])
