"""Fused Instant-NGP MLP kernels (counterpart of ``nerfjax/ops/pallas_mlp.py``).

``fused_ngp_head`` and ``fused_ngp_density`` replace the Pallas TPU kernels
``_head_kernel`` (via ``fused_ngp_head``, pallas_mlp.py:28-95) and
``_density_kernel`` (via ``fused_ngp_density``, :98-139). The kernels are
CUDA C++ for sm_90a in ``nerfjax_torch/csrc/fused_mlp.cu``, built by
``nerfjax_torch._build`` and called through ctypes on PyTorch's current
stream.

Beside each kernel stands its plain PyTorch version (``*_plain``): the same
math in float32 matmuls. A wrapper takes the plain version only for tensors
on the CPU. For a CUDA tensor it launches the kernel or raises; nothing
falls back. ``launch_counts`` counts the kernel launches of each wrapper,
so a run can show that its main path went through the kernels.

Numerics (pallas_mlp.py:28-40): weights are rounded to enc's dtype; layer 1
multiplies enc by W1 with float32 accumulation, layers 2-5 multiply float32
activations by the rounded weights; ``sh`` is rounded to enc's dtype before
the concat; rgb and sigma are rounded once to enc's dtype. The density
kernel's sigma equals the head kernel's bit for bit. The kernels take any
encoding width E from 1 to ``E_MAX`` = 128 (32 dense and 32 hashed levels
of 2 features, the most the port's encode produces), as nerfjax's
full-height block takes any E.

The bf16 kernels run on the tensor cores (``mma.sync``, bf16 in, f32
accumulate). A float32 activation ``a`` enters layers 2-5 as three bf16
terms (``split3_bf16``) whose products with the bf16 weights are exact, so
they compute the same function as the plain version with another order of
additions. The f32 kernels run one point per thread on FP32 FMAs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

HIDDEN = 64
GEO = 16
SH = 16
E_MAX = 128
CHUNK = 32  # W1's fan-in columns per chunk of the packed f32 buffer
W_REST = GEO * HIDDEN + (GEO + SH) * HIDDEN + HIDDEN * HIDDEN + 3 * HIDDEN  # W2..W5, f32 buffer
# W2..W5 of the bf16 buffer, each zero-padded to whole m16n8k16 B fragments
# (fan-in a multiple of 16, fan-out of 8): W5's 3 outputs become 8
B_REST = GEO * HIDDEN + (GEO + SH) * HIDDEN + HIDDEN * HIDDEN + 8 * HIDDEN
_WIDTHS = {"dmlp": [(None, HIDDEN), (HIDDEN, GEO)],
           "cmlp": [(GEO + SH, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, 3)]}
_DTYPES = (torch.bfloat16, torch.float32)

launch_counts = {"fused_ngp_head": 0, "fused_ngp_density": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _weights(params: dict, dtype: torch.dtype) -> list[torch.Tensor]:
    """[W1..W5] as [out, in] float32 holding values rounded to ``dtype``."""
    ws = []
    for name in ("dmlp", "cmlp"):
        layers = params[name]
        if len(layers) != len(_WIDTHS[name]):
            raise ValueError(f"{name}: expected {len(_WIDTHS[name])} layers, got {len(layers)}")
        for layer, (fan_in, fan_out) in zip(layers, _WIDTHS[name]):
            w = layer["w"]
            if w.shape[1] != fan_out or (fan_in is not None and w.shape[0] != fan_in):
                raise ValueError(f"{name} weight of shape {tuple(w.shape)}, expected [{fan_in}, {fan_out}]")
            ws.append(w.detach().T.to(dtype).to(torch.float32))
    return ws


def split3_bf16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hi, mid, lo) bf16 with hi + mid + lo == a (float32), the split the
    bf16 kernels apply to each activation of layers 2-5 (``split3`` in
    csrc/fused_mlp.cu), in the same arithmetic: hi is a with its low 16
    bits cleared, mid the same of a - hi, lo = a - hi - mid with its low 16
    bits cleared. Exact for finite |a| >= 2^-110; below that lo is a
    subnormal and loses bits. NaN splits as (NaN, 0, 0) (clearing a NaN
    whose payload lies in its low half would give inf), inf as (inf, 0, 0).
    Plain torch, for the tests: nothing on the card path calls it."""
    a = a.to(torch.float32)
    upper = -65536  # 0xFFFF0000 as int32

    def bits(x):
        return x.view(torch.int32)

    def as_bf16(b):  # the upper half of b's bits, exactly
        return (b >> 16).to(torch.int16).view(torch.bfloat16)

    hi = torch.where(torch.isnan(a), torch.tensor(0x7FC00000, dtype=torch.int32, device=a.device), bits(a) & upper)
    r = torch.where(torch.isfinite(a), a - hi.view(torch.float32), torch.zeros_like(a))
    mid = bits(r) & upper
    lo = bits(r - mid.view(torch.float32)) & upper
    return as_bf16(hi), as_bf16(mid), as_bf16(lo)


def _check_enc(enc: torch.Tensor, w1_in: int) -> None:
    if enc.dim() != 2 or enc.dtype not in _DTYPES:
        raise ValueError(f"enc must be [E, N] bf16 or f32, got {enc.dtype} {tuple(enc.shape)}")
    if enc.shape[0] != w1_in:
        raise ValueError(f"enc has {enc.shape[0]} rows but the density MLP takes {w1_in}")


# -- plain versions ----------------------------------------------------------


def _density_features_plain(ws: list[torch.Tensor], enc: torch.Tensor) -> torch.Tensor:
    # the shared W1 -> W2 stage of both plain versions: one code path, so
    # the two sigmas are the same float32 result
    h = torch.relu(torch.matmul(ws[0], enc.to(torch.float32)))
    return torch.relu(torch.matmul(ws[1], h))


def fused_ngp_head_plain(params: dict, enc: torch.Tensor, sh: torch.Tensor):
    """(rgb [3, N], sigma [N]) in enc's dtype, in plain float32 matmuls.
    On a card, run it with ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    _check_enc(enc, params["dmlp"][0]["w"].shape[0])
    dt = enc.dtype
    ws = [w.to(enc.device) for w in _weights(params, dt)]
    feat = _density_features_plain(ws, enc)
    x2 = torch.cat([feat, sh.to(dt).to(torch.float32)], dim=0)
    h2 = torch.relu(torch.matmul(ws[2], x2))
    h3 = torch.relu(torch.matmul(ws[3], h2))
    rgb = torch.sigmoid(torch.matmul(ws[4], h3))
    return rgb.to(dt), feat[0].to(dt)


def fused_ngp_density_plain(params: dict, enc: torch.Tensor) -> torch.Tensor:
    """sigma [N] in enc's dtype; equal to ``fused_ngp_head_plain``'s sigma."""
    _check_enc(enc, params["dmlp"][0]["w"].shape[0])
    ws = [w.to(enc.device) for w in _weights(params, enc.dtype)[:2]]
    return _density_features_plain(ws, enc)[0].to(enc.dtype)


# -- kernels -----------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (first call only) and load csrc/fused_mlp.cu, with typed entries."""
    from nerfjax_torch import _build

    lib = _build.load("fused_mlp")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.nerf_fused_head.argtypes = [vp, vp, vp, vp, i32, i64, i32, vp]
    lib.nerf_fused_head.restype = i32
    lib.nerf_fused_density.argtypes = [vp, vp, vp, i32, i64, i32, vp]
    lib.nerf_fused_density.restype = i32
    lib.nerf_fused_max_width.argtypes, lib.nerf_fused_max_width.restype = [], i32
    lib.nerf_fused_weights_size.argtypes, lib.nerf_fused_weights_size.restype = [i32, i32], i32
    lib.nerf_fused_smem_bytes.argtypes, lib.nerf_fused_smem_bytes.restype = [i32, i32, i32], i32
    if lib.nerf_fused_max_width() != E_MAX or any(
            lib.nerf_fused_weights_size(E, int(dt == torch.bfloat16)) != weights_size(E, dt)
            for E in (1, 16, 17, 24, 32, 33, 64, 65, E_MAX) for dt in _DTYPES):
        raise RuntimeError("fused_mlp.cu and fused_mlp.py disagree on the weight layout")
    return lib


def _pad16(E: int) -> int:
    return -(-E // 16) * 16


def weights_size(E: int, dtype: torch.dtype) -> int:
    """Elements of the kernels' weight buffer for an encoding of E rows of
    ``dtype``: floats (f32) or bf16 values (bf16); see ``pack_weights``."""
    if dtype == torch.bfloat16:
        return HIDDEN * _pad16(E) + B_REST
    return HIDDEN * CHUNK * -(-E // CHUNK) + W_REST


def _fragments(w: torch.Tensor, fan_in: int, fan_out: int) -> torch.Tensor:
    """w [out, in] zero-padded to [fan_out, fan_in] and cut into the B
    fragments of mma.m16n8k16 (k16 step s, n8 tile j) in the order s *
    fan_out / 8 + j; each fragment is 32 lanes x 4 values, lane 4g + t
    holding w[8j + g, 16s + 2t + (0, 1, 8, 9)]."""
    p = torch.zeros(fan_out, fan_in, dtype=w.dtype, device=w.device)
    p[: w.shape[0], : w.shape[1]] = w
    # [j, g, s, h, t, e] with in = 16s + 8h + 2t + e, out = 8j + g -> [s, j, g, t, h, e]
    return p.reshape(fan_out // 8, 8, fan_in // 16, 2, 4, 2).permute(2, 0, 1, 4, 3, 5).reshape(-1)


def pack_weights(params: dict, dtype: torch.dtype, device) -> torch.Tensor:
    """The kernels' weight buffer for enc of ``dtype`` (``weights_size(E,
    dtype)`` elements), the weights rounded to ``dtype``. The weights of a
    field are constant, so a caller packs them once and passes the buffer
    as the wrappers' ``packed``.

    float32 (the FP32 kernels): W1 [64, E] zero-padded to C = ceil(E / 32)
    chunks of 32 fan-in columns and laid out chunk by chunk, each chunk [64,
    32] row-major (at E <= 32 simply W1 [64, 32]); then W2, W3, W4, W5, each
    row-major [out, in].

    bfloat16 (the tensor-core kernels): each of W1..W5 in m16n8k16 B-fragment
    order (``_fragments``), one after the other: W1 with its fan-in padded
    to a multiple of 16, W5 with its 3 outputs padded to 8, the rest as
    they are; the kernels stage it into shared memory and each lane reads
    its fragment with one 8-byte load."""
    ws = [w.to(device) for w in _weights(params, dtype)]
    E = ws[0].shape[1]
    if dtype == torch.bfloat16:
        pads = [(_pad16(E), HIDDEN), (HIDDEN, GEO), (GEO + SH, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, 8)]
        return torch.cat([_fragments(w.to(torch.bfloat16), *pad) for w, pad in zip(ws, pads)]).contiguous()
    C = -(-E // CHUNK)
    w1 = torch.zeros(HIDDEN, C * CHUNK, dtype=torch.float32, device=device)
    w1[:, :E] = ws[0]
    w1 = w1.reshape(HIDDEN, C, CHUNK).transpose(0, 1)
    return torch.cat([w1.reshape(-1)] + [w.reshape(-1) for w in ws[1:]]).contiguous()


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _weight_buffer(name: str, params: dict, enc: torch.Tensor, packed) -> torch.Tensor:
    if packed is None:
        return pack_weights(params, enc.dtype, enc.device)
    size = weights_size(enc.shape[0], enc.dtype)
    if packed.shape != (size,) or packed.dtype != enc.dtype:
        raise ValueError(f"{name}: packed must be [{size}] {enc.dtype}, got {packed.dtype} {tuple(packed.shape)}")
    if packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed must start on a 16-byte boundary (the kernels copy it 16 bytes at a time)")
    return packed


def _check_width(E: int) -> None:
    if E > E_MAX:
        raise ValueError(f"encoding width {E} exceeds the kernels' limit E_MAX = {E_MAX}")


def _raise_if_failed(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def fused_ngp_head(params: dict, enc: torch.Tensor, sh: torch.Tensor, *, packed=None):
    """(rgb [3, N], sigma [N]) in enc's dtype from enc [E, N] and sh [16, N].

    params: nerfjax's param dict layout ({"dmlp"/"cmlp": [{"w": [in, out]}]}).
    packed: ``pack_weights(params, enc.dtype, enc.device)``, made once by the
    caller; packed here on every call when None. The plain version ignores it.
    E is read from enc (24 for the tuned 12-level model, 32 at 16 levels),
    at most ``E_MAX`` = 128; N is any length.
    """
    if enc.device.type == "cpu":
        return fused_ngp_head_plain(params, enc, sh)
    if enc.device.type != "cuda":
        raise ValueError(f"fused_ngp_head runs on cpu or cuda, not {enc.device}")
    _check_enc(enc, params["dmlp"][0]["w"].shape[0])
    E, N = enc.shape
    _check_width(E)
    if sh.shape != (SH, N) or sh.dtype != enc.dtype:
        raise ValueError(f"sh must be [16, {N}] {enc.dtype}, got {sh.dtype} {tuple(sh.shape)}")
    w = _weight_buffer("fused_ngp_head", params, enc, packed)
    _check_cuda("fused_ngp_head", enc, sh, w)
    out = torch.empty(4, N, dtype=enc.dtype, device=enc.device)
    if N:
        err = _lib().nerf_fused_head(
            enc.data_ptr(), sh.data_ptr(), w.data_ptr(), out.data_ptr(), E, N,
            int(enc.dtype == torch.bfloat16), torch.cuda.current_stream(enc.device).cuda_stream,
        )
        _raise_if_failed("fused_ngp_head", err)
        launch_counts["fused_ngp_head"] += 1
    return out[:3], out[3]


def fused_ngp_density(params: dict, enc: torch.Tensor, *, packed=None) -> torch.Tensor:
    """sigma [N] in enc's dtype from enc [E, N] — the density-only twin of
    ``fused_ngp_head`` (bit-identical sigma, no color MLP); ``packed`` as there."""
    if enc.device.type == "cpu":
        return fused_ngp_density_plain(params, enc)
    if enc.device.type != "cuda":
        raise ValueError(f"fused_ngp_density runs on cpu or cuda, not {enc.device}")
    _check_enc(enc, params["dmlp"][0]["w"].shape[0])
    E, N = enc.shape
    _check_width(E)
    w = _weight_buffer("fused_ngp_density", params, enc, packed)
    _check_cuda("fused_ngp_density", enc, w)
    out = torch.empty(N, dtype=enc.dtype, device=enc.device)
    if N:
        err = _lib().nerf_fused_density(
            enc.data_ptr(), w.data_ptr(), out.data_ptr(), E, N,
            int(enc.dtype == torch.bfloat16), torch.cuda.current_stream(enc.device).cuda_stream,
        )
        _raise_if_failed("fused_ngp_density", err)
        launch_counts["fused_ngp_density"] += 1
    return out
