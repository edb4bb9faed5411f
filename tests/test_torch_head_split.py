"""The bf16 MLP kernels' numerics on the CPU: the three-term bf16 split of
float32 activations (``fused_mlp.split3_bf16``, the arithmetic of ``split3``
in csrc/fused_mlp.cu), and a float64 model of the tensor-core head that
runs the kernel's data flow fragment by fragment (ldmatrix.trans A
fragments, ``pack_weights``' B fragments, m16n8k16 products, C fragments
reused as the next layer's A) with exact products summed in float64. The
bf16 weight layout itself is tested in tests/test_torch_fused_mlp.py; the
kernels are held to the plain version on a card by
tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from nerfjax_torch.ops import fused_mlp

DIMS = {"dmlp": [(None, 64), (64, 16)], "cmlp": [(32, 64), (64, 64), (64, 3)]}


def _params(E: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, dims in DIMS.items():
        out[name] = []
        for fan_in, fan_out in dims:
            fan_in = fan_in or E
            b = np.sqrt(6.0 / (fan_in + fan_out))
            out[name].append({"w": torch.from_numpy(rng.uniform(-b, b, (fan_in, fan_out)).astype(np.float32))})
    return out


def _f64(*ts):
    return [t.to(torch.float64) for t in ts]


# -- the split ---------------------------------------------------------------


def test_split3_is_exact_above_two_to_the_minus_110():
    """Random float32 values over the whole exponent range from 2^-110 up to
    FLT_MAX, both signs: each term is a bf16 value (the cast back to float32
    is exact) and hi + mid + lo == a exactly, with |mid| < 2^-7 |a| and
    |lo| < 2^-15 |a| (hi keeps a's top 8 significant bits, mid the next 8)."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**31, 1 << 20, dtype=np.int64).astype(np.int32)
    a = torch.from_numpy(bits).view(torch.float32)
    a = a[torch.isfinite(a) & (a.abs() >= 2.0**-110)]
    a = torch.cat([a, -a, torch.tensor([2.0**-110, 3.4028235e38, 1.0, 1.0 + 2.0**-23])])
    hi, mid, lo = fused_mlp.split3_bf16(a)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    h, m, l, x = _f64(hi, mid, lo, a)
    assert torch.equal(h + m + l, x)
    assert (m.abs() < x.abs() * 2.0**-7).all() and (l.abs() < x.abs() * 2.0**-15).all()


def test_split3_subnormal_edge():
    """Below 2^-110, lo may need bits under bf16's least subnormal (2^-133)
    and loses them: the split is then within 2^-133 of a, not equal.
    Float32 subnormals split without error while their bits fit: 2^-149
    itself is hi = 0, mid = 0 and lo = 0 (its one bit lies in the low
    half), so the sum is off by that bit."""
    a = torch.tensor([2.0**-111 * (1 + 2.0**-23), 2.0**-126 * (1 + 2.0**-23), 2.0**-149, 2.0**-126], dtype=torch.float32)
    h, m, l, x = _f64(*fused_mlp.split3_bf16(a), a)
    err = (h + m + l - x).abs()
    assert (err <= 2.0**-133).all()
    assert err[0] > 0 and err[1] > 0 and err[2] > 0 and err[3] == 0


def test_split3_non_finite_and_signed_zero():
    """NaN stays NaN as (NaN, 0, 0), also a NaN whose payload lies only in
    its low 16 bits (clearing them would give inf); inf splits as (inf, 0,
    0); -0 as (-0, 0, 0)."""
    low_nan = torch.tensor([0x7F800001, 0xFF800001 - 2**32], dtype=torch.int32).view(torch.float32)
    a = torch.cat([low_nan, torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 0.0])])
    hi, mid, lo = (t.to(torch.float32) for t in fused_mlp.split3_bf16(a))
    assert torch.isnan(a[:3]).all() and torch.isnan(hi[:3]).all()
    assert torch.equal(hi[3:5], a[3:5])
    assert hi[5] == 0 and torch.signbit(hi[5]) and not torch.signbit(hi[6])
    assert not mid.any() and not lo.any() and not torch.isnan(mid).any() and not torch.isnan(lo).any()


# -- a float64 model of the tensor-core head ---------------------------------


def _ldmatrix_a(tile: np.ndarray, k0: int) -> np.ndarray:
    """A fragments [tiles, 32 lanes, 4 regs, 2 halves] of rows k0..k0+15 of
    a k-major tile [tiles, rows, 16 points], as ldmatrix.x4.trans gives them
    for the kernel's addresses: matrix q reads rows k0 + 8 (q // 2) + r at
    points 8 (q % 2).., and lane T gets its rows 2 (T % 4) + h at point T // 4."""
    T = np.arange(32)
    a = np.empty(tile.shape[:1] + (32, 4, 2))
    for q in range(4):
        for h in range(2):
            a[:, :, q, h] = tile[:, k0 + 8 * (q // 2) + 2 * (T % 4) + h, 8 * (q % 2) + T // 4]
    return a


def _mma(c: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """c + A . B for m16n8k16 fragments: a [tiles, 32, 4, 2], b [32, 2, 2]
    (one fragment for every tile), c [tiles, 32, 4]; lane (g, t) = (l // 4,
    l % 4). A[g + 8 (q % 2), 2t + 8 (q // 2) + h] = a[q][h]; B[2t + 8 i + h,
    g] = b[i][h]; C[g + 8 (e // 2), 2t + e % 2] = c[e]. Exact products,
    float64 sums."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    A = np.empty(a.shape[:1] + (16, 16))
    B = np.empty((16, 8))
    for q in range(4):
        for h in range(2):
            A[:, g + 8 * (q % 2), 2 * t + 8 * (q // 2) + h] = a[:, :, q, h]
    for i in range(2):
        for h in range(2):
            B[2 * t + 8 * i + h, g] = b[:, i, h]
    C = np.einsum("pmk,kn->pmn", A, B)
    out = c.copy()
    for e in range(4):
        out[:, :, e] += C[:, g + 8 * (e // 2), 2 * t + e % 2]
    return out


def _bfrag(buf: np.ndarray, f: int) -> np.ndarray:
    return buf[f * 128 : (f + 1) * 128].reshape(32, 2, 2)


def _split_a(x0: np.ndarray, x1: np.ndarray) -> list[np.ndarray]:
    """(lo, mid, hi) A fragments from two n8 tiles' C fragments: a0 = x0[0:2],
    a1 = x0[2:4], a2 = x1[0:2], a3 = x1[2:4], each split by split3_bf16."""
    x = np.stack([x0[..., 0:2], x0[..., 2:4], x1[..., 0:2], x1[..., 2:4]], axis=-2).astype(np.float32)
    terms = fused_mlp.split3_bf16(torch.from_numpy(x))
    return [t.to(torch.float64).numpy() for t in terms[::-1]]


def _layer(x: list, buf: np.ndarray, frag0: int, nt_out: int, c=None) -> list:
    """One split layer: acc[j] += (lo, mid, hi of x's k16 steps) . W, the
    f32 accumulator rounded once per layer (the tensor core's sum modelled
    exactly), as [nt_out] C fragments."""
    acc = c if c is not None else [np.zeros(x[0].shape) for _ in range(nt_out)]
    for s in range(len(x) // 2):
        terms = _split_a(x[2 * s], x[2 * s + 1])
        for j in range(nt_out):
            b = _bfrag(buf, frag0 + s * nt_out + j)
            for a in terms:
                acc[j] = _mma(acc[j], a, b)
    return acc


def _relu32(x: list) -> list:
    return [np.maximum(v.astype(np.float32), 0).astype(np.float64) for v in x]


def _model_head(params: dict, enc: torch.Tensor, sh: torch.Tensor):
    """(rgb [3, N], sigma [N]) bf16 from the kernel's data flow: per tile of
    16 points, layer 1 from ldmatrix fragments of enc (E padded to E_pad
    with zero rows), layers 2-5 on split C fragments, sh as layer 3's
    second k16 step, outputs from C fragment elements e (row g + 8 (e //
    2), column 2t + e % 2)."""
    E, N = enc.shape
    E16 = -(-E // 16) * 16
    P = -(-N // 16) * 16
    buf = fused_mlp.pack_weights(params, torch.bfloat16, "cpu").to(torch.float64).numpy()
    etile = np.zeros((E16, P))
    etile[:E, :N] = enc.to(torch.float64).numpy()
    stile = np.zeros((16, P))
    stile[:, :N] = sh.to(torch.float64).numpy()
    etile = etile.reshape(E16, P // 16, 16).transpose(1, 0, 2)  # [tiles, rows, 16 points]
    stile = stile.reshape(16, P // 16, 16).transpose(1, 0, 2)
    f2 = E16 // 16 * 8  # W1's fragments
    f3, f4, f5 = f2 + 8, f2 + 8 + 16, f2 + 8 + 16 + 32

    h = [np.zeros((P // 16, 32, 4)) for _ in range(8)]
    for s in range(E16 // 16):
        a = _ldmatrix_a(etile, 16 * s)
        h = [_mma(h[j], a, _bfrag(buf, s * 8 + j)) for j in range(8)]
    feat = _relu32(_layer(_relu32(h), buf, f2, 2))
    h2 = _layer(feat, buf, f3, 8)
    a = _ldmatrix_a(stile, 0)
    h2 = [_mma(h2[j], a, _bfrag(buf, f3 + 8 + j)) for j in range(8)]
    h3 = _relu32(_layer(_relu32(h2), buf, f4, 8))
    z = _layer(h3, buf, f5, 1)[0].astype(np.float32)

    g, t = np.arange(32) // 4, np.arange(32) % 4
    out = np.zeros((4, P // 16, 16), np.float32)
    for e in range(4):
        rows, col = g + 8 * (e // 2), 2 * t + e % 2
        for c in range(3):
            sel = col == c
            out[c][:, rows[sel]] = 1.0 / (1.0 + np.exp(-z[:, sel, e]))
        sel = col == 0
        out[3][:, rows[sel]] = feat[0][:, sel, e]
    out = torch.from_numpy(out.reshape(4, P)[:, :N]).to(torch.bfloat16)
    return out[:3], out[3]


def _ulp_bound(ref: torch.Tensor) -> torch.Tensor:
    # one bf16 ulp of each reference value, taken at no less than 2^-14
    return torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-14))) - 7)


@pytest.mark.parametrize("E", [24, 32, 40, 128])
def test_split_head_model_within_one_ulp_of_plain(E):
    """The float64 model of the tensor-core head, fragment by fragment,
    against fused_ngp_head_plain in bf16 (float32 matmuls): within one bf16
    ulp, at N = 200 (a ragged last tile of 8 points). Its differences from
    plain are those of the order of additions, the bound the kernels are
    held to on the card."""
    params = _params(E, seed=100 + E)
    rng = np.random.default_rng(200 + E)
    enc = torch.from_numpy(rng.uniform(-1, 1, (E, 200)).astype(np.float32)).to(torch.bfloat16)
    sh = torch.from_numpy(rng.uniform(-1, 1, (16, 200)).astype(np.float32)).to(torch.bfloat16)
    rgb_m, sig_m = _model_head(params, enc, sh)
    rgb_p, sig_p = fused_mlp.fused_ngp_head_plain(params, enc, sh)
    for got, ref in ((rgb_m, rgb_p), (sig_m, sig_p)):
        got, ref = got.to(torch.float32), ref.to(torch.float32)
        assert ((got - ref).abs() <= _ulp_bound(ref)).all()
    assert (sig_m > 0).any()  # the ReLUs leave a live field
