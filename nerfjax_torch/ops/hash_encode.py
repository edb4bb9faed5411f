"""Multiresolution hash-grid encoding, forward and table gradient
(counterpart of ``nerfjax/ops/hash_encode.py``: ``_split_levels`` :42-48,
``_hash_level_indices`` :72-100, ``_corner_weights`` :103-128, the k = 1
plan ``_draw_corners``/``_select_drawn_indices``/``_draw_levels``/
``_level_subsample``/``_stochastic_corner_plan`` :131-290, the hashed-level
custom VJP :293-409, ``_dense_levels_encode`` :487-530 and
``hash_encode_planar`` :774-814).

Semantics, not layout: nerfjax packs bf16 feature pairs into f32 words and
builds dense-level cell-row tables because the TPU's gather pays per index.
Here the corners are gathered directly from the ``[2, total]`` planes. What
matches nerfjax:

  * hashed levels: uint32 spatial hash ``x*1 ^ y*2654435761 ^ z*805459861``
    masked to the table size, table values rounded to bf16 as
    ``_pack_pairs_bf16`` rounds them, trilinear weights ``(wx*wy)*wz`` and
    sums in float32; the k = 1 plan (one corner per level and point, drawn
    with P = its weight from the f32 bits of the position) bit for bit;
  * dense levels: base cell clamped to ``[0, r-2]``, fraction clipped to
    ``[0, 1]``, table values, weights and the corner sum in ``dtype``.

Kernels (CUDA C++ for sm_90a, ``nerfjax_torch/csrc/hash_encode.cu``, built
by ``nerfjax_torch._build`` and called through ctypes on PyTorch's current
stream):

  * ``hash_levels_fwd`` (K1): the hashed levels' exact or k = 1 forward;
  * ``hash_levels_bwd`` (K2): their table gradient, exact, k = 1, or k = 1
    over ``grad_levels`` drawn levels scaled Lh/gl;
  * ``table_grad_scatter`` (K3): ``out[p][idx_k] += g_p[k]`` into two f32
    planes, out-of-range indices dropped; the function of the Pallas
    kernels ``grad_onehot``/``grad_rowscatter`` (benchmarks/micro_onehot.py).
    The dense levels' table gradient goes through it, into the one
    [2, total] gradient that K2 adds the hashed levels' into.

Beside each kernel stands its plain PyTorch version (``*_plain``). A wrapper
takes the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises. ``launch_counts`` counts the launches.

uint32 arithmetic on the CPU is int64 masked to 32 bits: products with a
32-bit constant are split into 16-bit halves (``_mul32``) so that no partial
product leaves int64, and every ``>>`` acts on a non-negative value, so it
is logical. The CDF of the 8 corner weights is a sequential f32 sum (XLA's
cumsum over 8 on the CPU; ``torch.cumsum`` on the CPU accumulates in double).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from nerfjax_torch.fields.ngp import CORNERS, HASH_PRIMES, HashGridSpec

M32 = 0xFFFFFFFF
LEVEL_SALT = 0x85EBCA6B  # nerfjax _LEVEL_SALT: the level-subset draw family

launch_counts = {"hash_levels_fwd": 0, "hash_levels_bwd": 0, "table_grad_scatter": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _split_levels(spec: HashGridSpec) -> tuple[list[dict], list[dict]]:
    levels = spec.level_params()
    dense = [lp for lp in levels if not lp["use_hash"]]
    hashed = [lp for lp in levels if lp["use_hash"]]
    # tcnn level scales grow monotonically: dense levels are a prefix.
    if dense + hashed != levels:
        raise ValueError("dense levels must precede hashed levels")
    return dense, hashed


def check_supported(spec: HashGridSpec) -> None:
    """Raise for the estimators the port does not have yet."""
    if spec.fwd_corners not in (1, 8) or spec.grad_corners not in (1, 8):
        raise NotImplementedError(
            f"hash_fwd_corners={spec.fwd_corners}, hash_grad_corners={spec.grad_corners}: "
            "only the exact (8) and k = 1 hashed-level estimators are ported; "
            "k >= 2 (leader + residual) is ROADMAP Queue 1 item 'k >= 2'"
        )
    if spec.dense_corners < 8 or spec.dense_grad_levels > 0:
        raise NotImplementedError(
            "hash_dense_corners < 8 and hash_dense_grad_levels > 0 are not ported yet "
            "(ROADMAP Queue 1 item 'the dense stochastic knobs')"
        )


def _bwd_mode(spec: HashGridSpec, Lh: int) -> tuple[int, int]:
    """(mode, gl) of the hashed-level backward: 0 exact, 1 k = 1, 2 k = 1
    over gl drawn levels. Under a k = 1 forward the backward replays its
    plan (nerfjax: b = min(grad_corners, fwd_corners) = 1)."""
    if spec.fwd_corners == 8 and spec.grad_corners == 8:
        return 0, 0
    gl = spec.grad_levels
    return (2, gl) if 0 < gl < Lh else (1, 0)


# -- the plan (plain torch) ---------------------------------------------------


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant c."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _bits(v: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of float32 v, in int64."""
    return v.contiguous().view(torch.int32).to(torch.int64) & M32


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = _mul32(h ^ (h >> 15), 0x2C1B3C6D)
    return h ^ (h >> 12)


def _position_seed(x, y, z, salt: int) -> torch.Tensor:
    return (
        _mul32(_bits(x), 0x9E3779B1) ^ _mul32(_bits(y), 0x85EBCA77) ^ _mul32(_bits(z), 0xC2B2AE3D)
    ) ^ (salt & M32)


def _unit24(h: torch.Tensor) -> torch.Tensor:
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _hash_level_indices(spec: HashGridSpec, hashed: list[dict], x, y, z) -> list[torch.Tensor]:
    """Per corner (``CORNERS`` order) an [Lh, N] int64 index into the
    hashed-level slice of the planes (offsets relative to its first level)."""
    dev = x.device
    base = hashed[0]["offset"]
    mask = spec.hashmap_size - 1
    scales = torch.tensor([lp["scale"] for lp in hashed], dtype=torch.float32, device=dev)[:, None]
    offs = torch.tensor([lp["offset"] - base for lp in hashed], dtype=torch.int64, device=dev)[:, None]
    # positions are in [0, 1], so the floored lattice coordinates are >= 0 and
    # the int64 products below hold the uint32 products in their low 32 bits.
    ix = torch.floor(x[None, :] * scales + 0.5).to(torch.int64)
    iy = torch.floor(y[None, :] * scales + 0.5).to(torch.int64)
    iz = torch.floor(z[None, :] * scales + 0.5).to(torch.int64)
    out = []
    for dx, dy, dz in CORNERS:
        h = (ix + dx) * HASH_PRIMES[0] ^ (iy + dy) * HASH_PRIMES[1] ^ (iz + dz) * HASH_PRIMES[2]
        out.append((h & mask) + offs)
    return out


def _corner_weights(levels: list[dict], x, y, z) -> list[torch.Tensor]:
    """Per corner an [L, N] float32 trilinear weight (nerfjax's ``_corner_weights``
    as the hashed levels call it, unclamped)."""
    scales = torch.tensor([lp["scale"] for lp in levels], dtype=torch.float32, device=x.device)[:, None]
    px = x[None, :] * scales + 0.5
    py = y[None, :] * scales + 0.5
    pz = z[None, :] * scales + 0.5
    tx, ty, tz = px - torch.floor(px), py - torch.floor(py), pz - torch.floor(pz)
    out = []
    for dx, dy, dz in CORNERS:
        wx = tx if dx else (1.0 - tx)
        wy = ty if dy else (1.0 - ty)
        wz = tz if dz else (1.0 - tz)
        out.append(wx * wy * wz)
    return out


def _sequential_cdf(w: list[torch.Tensor]) -> torch.Tensor:
    """[L, 8, N] running sums of the 8 corner weights, added in order."""
    acc = [w[0]]
    for c in range(1, 8):
        acc.append(acc[-1] + w[c])
    return torch.stack(acc, dim=1)


def _draw_corners(x, y, z, cdf: torch.Tensor, Lh: int, k: int, salt: int = 0) -> torch.Tensor:
    """k iid corner draws per (level, point) -> [k, Lh, N] int64 in 0..7
    (nerfjax ``_draw_corners``)."""
    seed = _position_seed(x, y, z, salt)[None, :]
    lvl = (torch.arange(Lh, dtype=torch.int64, device=x.device)[:, None] * 2654435761) & M32
    draws = []
    for j in range(k):
        h = _mix(((seed ^ lvl) + ((j * 0x7F4A7C15) & M32)) & M32)
        u = _unit24(h) * cdf[:, 7, :]
        draws.append((u[:, None, :] >= cdf[:, :7, :]).sum(dim=1))
    return torch.stack(draws)


def _draw_levels(x, y, z, Lh: int, g: int, salt: int) -> torch.Tensor:
    """g iid uniform level draws per point -> [g, N] int64 in 0..Lh-1
    (nerfjax ``_draw_levels``)."""
    seed = _position_seed(x, y, z, salt)
    ids = []
    for j in range(g):
        u = _unit24(_mix((seed + ((j * 0x7F4A7C15) & M32)) & M32))
        ids.append(torch.clamp_max((u * Lh).to(torch.int64), Lh - 1))
    return torch.stack(ids)


def _plan_k1(spec: HashGridSpec, hashed: list[dict], x, y, z) -> torch.Tensor:
    """The k = 1 plan: [Lh, N] int64 index of the drawn corner of each
    (level, point), relative to the first hashed level (nerfjax
    ``_stochastic_corner_plan`` with k = 1; its coef is 1)."""
    idx3 = torch.stack(_hash_level_indices(spec, hashed, x, y, z), dim=1)  # [Lh, 8, N]
    cdf = _sequential_cdf(_corner_weights(hashed, x, y, z))
    c = _draw_corners(x, y, z, cdf, len(hashed), 1)[0]
    return idx3.gather(1, c[:, None, :])[:, 0, :]


# -- plain versions -------------------------------------------------------------


def hash_levels_fwd_plain(spec: HashGridSpec, planes: torch.Tensor, x, y, z):
    """(out [2, Lh, N] float32, sel [Lh, N] int64 or None): the hashed levels'
    exact forward, or (``fwd_corners`` = 1) the k = 1 estimate and its plan."""
    _, hashed = _split_levels(spec)
    tbl = planes[:, hashed[0]["offset"]:].to(torch.bfloat16).to(torch.float32)
    if spec.fwd_corners == 1:
        sel = _plan_k1(spec, hashed, x, y, z)
        return torch.stack([tbl[0][sel], tbl[1][sel]]), sel
    idx = _hash_level_indices(spec, hashed, x, y, z)
    w = _corner_weights(hashed, x, y, z)
    e0 = torch.zeros_like(w[0])
    e1 = torch.zeros_like(w[0])
    for c in range(8):
        e0 = e0 + tbl[0][idx[c]] * w[c]
        e1 = e1 + tbl[1][idx[c]] * w[c]
    return torch.stack([e0, e1]), None


def _check_out(name: str, out: torch.Tensor, device) -> int:
    """T of ``out``, checked to be a contiguous [2, T] float32 tensor on ``device``."""
    if out.dim() != 2 or out.shape[0] != 2 or out.dtype != torch.float32 or not out.is_contiguous() \
            or out.device != device:
        raise ValueError(f"{name}: out must be a contiguous [2, T] float32 tensor on {device}")
    return out.shape[1]


def table_grad_scatter_plain(idx: torch.Tensor, g0: torch.Tensor, g1: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out[p][idx_k] += g_p[k] into the [2, T] float32 planes ``out``,
    returned; indices outside [0, T) are dropped (``mode="drop"``: torch's
    ``index_add_`` would raise)."""
    T = _check_out("table_grad_scatter_plain", out, g0.device)
    keep = (idx >= 0) & (idx < T)
    i = idx[keep].to(torch.int64)
    out[0].index_add_(0, i, g0[keep].to(torch.float32))
    out[1].index_add_(0, i, g1[keep].to(torch.float32))
    return out


def hash_levels_bwd_plain(spec: HashGridSpec, g: torch.Tensor, x, y, z, out: torch.Tensor) -> torch.Tensor:
    """The hashed levels' table gradient from the upstream gradient g
    [2, Lh, N], added into the hashed columns of the [2, total] float32
    planes ``out``, returned."""
    _, hashed = _split_levels(spec)
    base, Lh = hashed[0]["offset"], len(hashed)
    mode, gl = _bwd_mode(spec, Lh)
    if mode == 0:
        idx = torch.stack(_hash_level_indices(spec, hashed, x, y, z))  # [8, Lh, N]
        w = torch.stack(_corner_weights(hashed, x, y, z))
        v0, v1 = g[0][None] * w, g[1][None] * w
    else:
        idx = _plan_k1(spec, hashed, x, y, z)
        v0, v1 = g[0], g[1]
        if mode == 2:
            ids = _draw_levels(x, y, z, Lh, gl, LEVEL_SALT)  # [gl, N]
            scale = float(np.float32(Lh / gl))
            idx = idx.gather(0, ids)
            v0, v1 = v0.gather(0, ids) * scale, v1.gather(0, ids) * scale
    return table_grad_scatter_plain((idx + base).reshape(-1), v0.reshape(-1), v1.reshape(-1), out)


# -- kernels --------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (first call only) and load csrc/hash_encode.cu, with typed entries."""
    from nerfjax_torch import _build

    lib = _build.load("hash_encode")
    vp, i32, i64, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32, ctypes.c_float
    lib.nerf_hash_levels_fwd.argtypes = [vp, i64, i64, vp, vp, vp, i64, i32, vp, vp, u32, i32, vp, vp, vp]
    lib.nerf_hash_levels_bwd.argtypes = [vp, i64, i64, vp, vp, vp, i64, i32, vp, vp, u32, i32, i32, f32, vp, vp]
    lib.nerf_table_grad_scatter.argtypes = [vp, vp, vp, i64, i64, vp, vp]
    for fn in (lib.nerf_hash_levels_fwd, lib.nerf_hash_levels_bwd, lib.nerf_table_grad_scatter):
        fn.restype = i32
    lib.nerf_hash_max_levels.argtypes, lib.nerf_hash_max_levels.restype = [], i32
    return lib


def _raise_if_failed(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, tensors: dict, dtype=torch.float32) -> None:
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _device_kind(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return t.device.type


def _level_arrays(spec: HashGridSpec, hashed: list[dict]):
    """(base, scales f32 [Lh], offsets int64 [Lh], mask) for the kernels."""
    if len(hashed) > _lib().nerf_hash_max_levels():
        raise ValueError(f"{len(hashed)} hashed levels exceed the kernels' maximum")
    base = hashed[0]["offset"]
    scales = np.array([lp["scale"] for lp in hashed], np.float32)
    offsets = np.array([lp["offset"] - base for lp in hashed], np.int64)
    return base, scales, offsets, spec.hashmap_size - 1


def _check_positions(name: str, planes: torch.Tensor, x, y, z) -> int:
    N = x.shape[0]
    if planes.dim() != 2 or planes.shape[0] != 2:
        raise ValueError(f"{name}: planes must be [2, total], got {tuple(planes.shape)}")
    if any(c.shape != (N,) for c in (y, z)) or x.dim() != 1:
        raise ValueError(f"{name}: x, y, z must be [N] each")
    _check_cuda(name, {"planes": planes, "x": x, "y": y, "z": z})
    return N


def hash_levels_fwd(spec: HashGridSpec, planes: torch.Tensor, x, y, z, *, sel: torch.Tensor | None = None):
    """Hashed-level forward -> [2, Lh, N] float32 from the full [2, total]
    float32 planes and x, y, z [N] float32 in [0, 1]: the exact trilinear
    sum, or (``spec.fwd_corners`` = 1) the k = 1 estimate.

    sel: optional [Lh, N] int32 that receives the k = 1 plan (indices
    relative to the first hashed level); the plain version fills it too.
    """
    _, hashed = _split_levels(spec)
    if _device_kind("hash_levels_fwd", x) == "cpu":
        out, plan = hash_levels_fwd_plain(spec, planes, x, y, z)
        if sel is not None and plan is not None:
            sel.copy_(plan)
        return out
    N = _check_positions("hash_levels_fwd", planes, x, y, z)
    Lh = len(hashed)
    k1 = spec.fwd_corners == 1
    if sel is not None:
        if not k1 or sel.shape != (Lh, N) or sel.dtype != torch.int32 or not sel.is_contiguous() \
                or sel.device != x.device:
            raise ValueError(f"hash_levels_fwd: sel must be a contiguous [{Lh}, {N}] int32 on "
                             f"{x.device}, under fwd_corners = 1")
    out = torch.empty(2, Lh, N, dtype=torch.float32, device=x.device)
    if N:
        base, scales, offsets, mask = _level_arrays(spec, hashed)
        err = _lib().nerf_hash_levels_fwd(
            planes.data_ptr(), planes.shape[1], base, x.data_ptr(), y.data_ptr(), z.data_ptr(), N,
            Lh, scales.ctypes.data, offsets.ctypes.data, mask, int(k1), out.data_ptr(),
            0 if sel is None else sel.data_ptr(), _stream(x),
        )
        _raise_if_failed("hash_levels_fwd", err)
        launch_counts["hash_levels_fwd"] += 1
    return out


def hash_levels_bwd(spec: HashGridSpec, g: torch.Tensor, x, y, z, out: torch.Tensor) -> torch.Tensor:
    """Table gradient of the hashed levels from the upstream gradient g
    [2, Lh, N] float32, added into the hashed columns of the [2, total]
    float32 planes ``out`` and returned: exact, k = 1, or k = 1 over
    ``spec.grad_levels`` drawn levels scaled Lh/gl, replaying the forward's
    plan."""
    _, hashed = _split_levels(spec)
    if _device_kind("hash_levels_bwd", x) == "cpu":
        return hash_levels_bwd_plain(spec, g, x, y, z, out)
    Lh = len(hashed)
    N = x.shape[0]
    if g.shape != (2, Lh, N):
        raise ValueError(f"hash_levels_bwd: g must be [2, {Lh}, {N}], got {tuple(g.shape)}")
    _check_cuda("hash_levels_bwd", {"g": g, "x": x, "y": y, "z": z})
    mode, gl = _bwd_mode(spec, Lh)
    total = _check_out("hash_levels_bwd", out, x.device)
    if N:
        base, scales, offsets, mask = _level_arrays(spec, hashed)
        scale = float(np.float32(Lh / gl)) if mode == 2 else 1.0
        err = _lib().nerf_hash_levels_bwd(
            g.data_ptr(), total, base, x.data_ptr(), y.data_ptr(), z.data_ptr(), N, Lh,
            scales.ctypes.data, offsets.ctypes.data, mask, mode, gl, scale, out.data_ptr(),
            _stream(x),
        )
        _raise_if_failed("hash_levels_bwd", err)
        launch_counts["hash_levels_bwd"] += 1
    return out


def table_grad_scatter(idx: torch.Tensor, g0: torch.Tensor, g1: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out[p][idx_k] += g_p[k] into the [2, T] float32 planes ``out``,
    returned, from idx [K] int32 and g0, g1 [K] float32; indices outside
    [0, T) are dropped."""
    if _device_kind("table_grad_scatter", idx) == "cpu":
        return table_grad_scatter_plain(idx, g0, g1, out)
    K = idx.shape[0]
    if idx.dim() != 1 or g0.shape != (K,) or g1.shape != (K,):
        raise ValueError("table_grad_scatter: idx, g0, g1 must be [K] each")
    _check_cuda("table_grad_scatter", {"idx": idx}, torch.int32)
    _check_cuda("table_grad_scatter", {"g0": g0, "g1": g1})
    if g0.device != idx.device:
        raise ValueError(f"table_grad_scatter: g0 on {g0.device}, idx on {idx.device}")
    T = _check_out("table_grad_scatter", out, idx.device)
    if K:
        err = _lib().nerf_table_grad_scatter(
            idx.data_ptr(), g0.data_ptr(), g1.data_ptr(), K, T, out.data_ptr(), _stream(idx)
        )
        _raise_if_failed("table_grad_scatter", err)
        launch_counts["table_grad_scatter"] += 1
    return out


# -- the encode, with its table gradient ----------------------------------------


def _dense_geometry(lp: dict, x, y, z, dtype):
    """(base cell index [N] int64, tx, ty, tz [N] in dtype) of one dense level."""
    r = lp["res"]
    px, py, pz = x * lp["scale"] + 0.5, y * lp["scale"] + 0.5, z * lp["scale"] + 0.5
    bx = torch.floor(px).clamp(0, r - 2)
    by = torch.floor(py).clamp(0, r - 2)
    bz = torch.floor(pz).clamp(0, r - 2)
    tx = (px - bx).clamp(0.0, 1.0).to(dtype)
    ty = (py - by).clamp(0.0, 1.0).to(dtype)
    tz = (pz - bz).clamp(0.0, 1.0).to(dtype)
    base = bx.to(torch.int64) + by.to(torch.int64) * r + bz.to(torch.int64) * (r * r)
    return base, tx, ty, tz


def _dense_corners(lp: dict, base, tx, ty, tz):
    """Per corner (``CORNERS`` order): (flat table index, weight in tx's dtype)."""
    r = lp["res"]
    for dx, dy, dz in CORNERS:
        wx = tx if dx else (1.0 - tx)
        wy = ty if dy else (1.0 - ty)
        wz = tz if dz else (1.0 - tz)
        yield lp["offset"] + base + (dx + dy * r + dz * r * r), wx * wy * wz


def _dense_levels_encode(dense: list[dict], planes: torch.Tensor, x, y, z, dtype: torch.dtype) -> torch.Tensor:
    """Exact dense-level encode -> [2, Ld, N] in ``dtype``."""
    e0_rows, e1_rows = [], []
    for lp in dense:
        g = planes[:, lp["offset"] : lp["offset"] + lp["res"] ** 3].to(dtype)
        base, tx, ty, tz = _dense_geometry(lp, x, y, z, dtype)
        e0 = torch.zeros_like(tx)
        e1 = torch.zeros_like(tx)
        for idx, w in _dense_corners(lp, base, tx, ty, tz):
            idx = idx - lp["offset"]
            e0 = e0 + g[0][idx] * w
            e1 = e1 + g[1][idx] * w
        e0_rows.append(e0)
        e1_rows.append(e1)
    return torch.stack([torch.stack(e0_rows), torch.stack(e1_rows)])


def _dense_scatter_inputs(dense: list[dict], g: torch.Tensor, x, y, z, dtype: torch.dtype):
    """(idx [K] int32, v0, v1 [K] float32) of the dense levels' table
    gradient from their upstream gradient g [2, Ld, N]: each corner's g*w is
    formed in ``dtype`` (the product's VJP in nerfjax) and scattered in
    float32 (ROADMAP Queue 3: nerfjax's bf16 row scatter accumulates in
    bf16). K = Ld * 8 * N, levels and corners outermost."""
    g = g.to(dtype)
    idx, v0, v1 = [], [], []
    for l, lp in enumerate(dense):
        base, tx, ty, tz = _dense_geometry(lp, x, y, z, dtype)
        for i, w in _dense_corners(lp, base, tx, ty, tz):
            idx.append(i.to(torch.int32))
            v0.append((g[0, l] * w).to(torch.float32))
            v1.append((g[1, l] * w).to(torch.float32))
    return torch.cat(idx), torch.cat(v0), torch.cat(v1)


class _HashEncode(torch.autograd.Function):
    """The encode -> [2, L, N] in ``dtype``: dense levels in plain torch,
    hashed levels through K1 in float32, cast at the concat. The backward
    zeroes one [2, total] float32 gradient, and K3 (the dense columns) and
    K2 (the hashed columns) add into it."""

    @staticmethod
    def forward(ctx, planes, x, y, z, spec, dtype):
        ctx.spec, ctx.dtype, ctx.total = spec, dtype, planes.shape[1]
        ctx.save_for_backward(x, y, z)
        dense, hashed = _split_levels(spec)
        parts = []
        if dense:
            parts.append(_dense_levels_encode(dense, planes, x, y, z, dtype))
        if hashed:
            parts.append(hash_levels_fwd(spec, planes, x, y, z).to(dtype))
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        x, y, z = ctx.saved_tensors
        dense, hashed = _split_levels(ctx.spec)
        grad = torch.zeros(2, ctx.total, dtype=torch.float32, device=x.device)
        if dense:
            idx, v0, v1 = _dense_scatter_inputs(dense, g[:, : len(dense)], x, y, z, ctx.dtype)
            table_grad_scatter(idx, v0, v1, grad)
        if hashed:
            g_hashed = g[:, len(dense) :].to(torch.float32).contiguous()
            hash_levels_bwd(ctx.spec, g_hashed, x, y, z, grad)
        return grad, None, None, None, None, None


def hash_encode_planar(
    spec: HashGridSpec,
    planes: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Feature-major hash-grid encoding, differentiable in ``planes``.

    Args:
      planes: [2, total] float32 table planes.
      x, y, z: [N] float32 position components in [0, 1].
    Returns:
      enc [2L, N] in ``dtype``, plane-major: rows 0..L-1 are plane 0 over the
      levels (dense, then hashed), rows L..2L-1 plane 1 — nerfjax's layout.
      The hashed levels are computed in float32 and cast at the concat.
    """
    check_supported(spec)
    if spec.n_features != 2:
        raise ValueError(f"the planar encode needs 2 features, got {spec.n_features}")
    enc = _HashEncode.apply(planes, x, y, z, spec, dtype)
    return enc.reshape(2 * spec.n_levels, x.shape[0])
