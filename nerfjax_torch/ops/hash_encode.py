"""Multiresolution hash-grid encoding, forward and table gradient
(counterpart of ``nerfjax/ops/hash_encode.py``: ``_split_levels`` :42-48,
``_hash_level_indices`` :72-100, ``_corner_weights`` :103-128, the plan
``_draw_corners``/``_select_drawn_indices``/``_draw_levels``/
``_level_subsample``/``_stochastic_corner_plan`` :131-290, the hashed-level
custom VJP :293-409, the dense levels: exact ``_dense_levels_encode``
:487-530, level-subset backward ``_dense_levels_encode_glv`` :538-672,
stochastic ``_dense_levels_encode_stoch`` :679-766; and
``hash_encode_planar`` :774-814).

Semantics, not layout: nerfjax packs bf16 feature pairs into f32 words and
builds dense-level cell-row tables because the TPU's gather pays per index.
Here K1 exact and K4 read the columns packed into bf16 pairs (one word per
entry, both planes in it; float2 in K4's exact float32 mode) and the other
kernels the ``[2, total]`` planes; a cell-row table costs the H100 more to
build than it saves K4 (``PERF.md``). What matches nerfjax:

  * hashed levels: uint32 spatial hash ``x*1 ^ y*2654435761 ^ z*805459861``
    masked to the table size, table values rounded to bf16 as
    ``_pack_pairs_bf16`` rounds them, trilinear weights ``(wx*wy)*wz`` and
    sums in float32; the k-corner plan bit for bit: k = 1, one corner drawn
    with P = its weight from the f32 bits of the position; k = 2..7, the
    leader (largest weight, coef w_m) and k - 1 draws from the residual
    weights (coef (1 - w_m) * f32(1/(k-1))). The backward plans b =
    min(grad_corners, fwd_corners) corners (salt 0), over ``grad_levels``
    drawn levels (g*coef)*(Lh/gl);
  * dense levels: base cell clamped to ``[0, r-2]``, fraction clipped to
    ``[0, 1]``, table values, weights and the corner sum in ``dtype``; under
    ``dense_grad_levels`` = gd (0 < gd < Ld) the same forward and a backward
    over gd levels drawn per point (salt ``_DENSE_GL_SALT``), f32 weights,
    scaled Ld/gd; under ``dense_corners`` = k < 8 the k-corner plan with
    clamped weights (salt ``_DENSE_SALT``), bf16-rounded table values,
    float32 out, and a backward over b = min(grad_corners, k) corners.

Kernels (CUDA C++ for sm_90a, ``nerfjax_torch/csrc/hash_encode.cu``, built
by ``nerfjax_torch._build`` and called through ctypes on PyTorch's current
stream):

  * ``hash_levels_fwd`` (K1): the hashed levels' exact or k-corner
    forward; the exact and k >= 2 ones read the hashed columns packed into
    bf16 pairs (one word per entry, ``pack_pairs_bf16_plain``'s layout) by
    a pass in front of them; the k-corner ones are one thread per (level,
    point) over a 2-D grid, with 32-bit entries;
  * ``hash_levels_bwd`` (K2): their table gradient, exact, or to the b
    planned corners (k = 1 or leader + residual), over all levels or over
    ``grad_levels`` drawn levels scaled Lh/gl;
  * ``table_grad_scatter`` (K3): ``out[p][idx_k] += g_p[k]`` into two f32
    planes, out-of-range indices dropped; the function of the Pallas
    kernels ``grad_onehot``/``grad_rowscatter`` (benchmarks/micro_onehot.py).
    The dense levels' table gradient goes through it, into the dense
    columns of the one [2, total] gradient that K2 adds the hashed levels'
    into;
  * ``dense_levels_fwd`` (K4): the dense levels' exact or k-corner forward,
    the cell-row gather of the Pallas kernel ``_dma_gather_fn``
    (benchmarks/micro_pallas_gather.py) with the blend around it; it reads
    the dense columns packed by ``pack_pairs`` (a pass in front of it: one
    entry per column holding both planes);
  * ``dense_levels_bwd`` (K5): the dense levels' table gradient staged as
    K3's (idx, v0, v1), exact, to the b planned corners, or over gd drawn
    levels, whose cotangent take is the Pallas kernel
    ``_take_along_axis_probe``'s function.

K1 and K4 store in the encode's dtype into an ``out=`` slice of its
[2, L, N] output (rows contiguous, any plane stride), so the encode
allocates that output once and neither casts nor concatenates.

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
DENSE_SALT = 0x5BD1E995  # nerfjax _DENSE_SALT: the dense levels' corner draws
DENSE_GL_SALT = 0x27D4EB2F  # nerfjax _DENSE_GL_SALT: the dense level-subset draws

launch_counts = {"hash_levels_fwd": 0, "hash_levels_bwd": 0, "table_grad_scatter": 0,
                 "pack_pairs": 0, "dense_levels_fwd": 0, "dense_levels_bwd": 0}


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


def _bwd_mode(spec: HashGridSpec, Lh: int) -> tuple[int, int]:
    """(mode, gl) of the hashed-level backward: 0 exact, 1 stochastic (the
    ``_grad_corners`` plan per level), 2 the same over gl drawn levels
    scaled Lh/gl."""
    if _grad_corners(spec) == 8:
        return 0, 0
    gl = spec.grad_levels
    return (2, gl) if 0 < gl < Lh else (1, 0)


def _grad_corners(spec: HashGridSpec) -> int:
    """b, the corners of the hashed levels' backward plan (nerfjax:
    b = min(grad_corners, fwd_corners)): 8 exact; at b = fwd_corners < 8 it
    replays the forward's plan, at b < fwd_corners it plans anew with b."""
    return min(spec.grad_corners, spec.fwd_corners, 8)


def _dense_mode(spec: HashGridSpec, Ld: int) -> tuple[int, int]:
    """(mode, gd) of the dense levels, as ``hash_encode_planar`` branches:
    1 stochastic forward and backward (``dense_corners`` = k < 8; the
    backward plans ``_dense_grad_corners`` corners); else 2, the exact
    forward with the backward over gd drawn levels, for 0 < gd < Ld; else 0
    exact (a gd >= Ld is the exact path, unscaled)."""
    if spec.dense_corners < 8:
        return 1, 0
    gd = spec.dense_grad_levels
    return (2, gd) if 0 < gd < Ld else (0, 0)


def _dense_grad_corners(spec: HashGridSpec) -> int:
    """b of the stochastic dense backward: min(grad_corners, dense_corners)
    (nerfjax ``_dense_stoch_bwd``)."""
    return min(spec.grad_corners, spec.dense_corners)


def _rinv(b: int) -> float:
    """f32(1/(b - 1)), the residual draws' share of the residual mass
    (nerfjax's ``np.float32(1.0 / (k - 1))``); 0 for b < 2."""
    return float(np.float32(1.0 / (b - 1))) if b >= 2 else 0.0


# -- the plan (plain torch) ---------------------------------------------------


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant c."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _bits(v: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of float32 v, in int64."""
    return v.contiguous().view(torch.int32).to(torch.int64) & M32


def _int32(b: torch.Tensor) -> torch.Tensor:
    """int64 b in [0, 2^32) as the int32 of the same 32 bits."""
    return (b - ((b >> 31) << 32)).to(torch.int32)


def _bf16_bits(v: torch.Tensor) -> torch.Tensor:
    """The bf16 pattern (int64 in [0, 2^16)) of float32 v rounded to
    nearest even, a NaN as its sign and the quiet NaN 0x7FC0 (as nerfjax's
    ``astype(jnp.bfloat16)`` rounds; torch's CPU cast makes every NaN 0xFFFF)."""
    b = _bits(v)
    nan = (b & 0x7FFFFFFF) > 0x7F800000
    return torch.where(nan, ((b >> 16) & 0x8000) | 0x7FC0, (b + 0x7FFF + ((b >> 16) & 1)) >> 16)


def pack_pairs_bf16_plain(planes: torch.Tensor) -> torch.Tensor:
    """[2, T] float32 -> [T] int32 words holding (bf16(plane 1) << 16) |
    bf16(plane 0): nerfjax's ``_pack_pairs_bf16`` (its f32 words' bits), the
    layout K1 exact reads (``pack_pairs_bf16_kernel``)."""
    return _int32(_bf16_bits(planes[0]) | (_bf16_bits(planes[1]) << 16))


def pack_pairs_plain(cols: torch.Tensor, f32: bool) -> torch.Tensor:
    """K4's table from the [2, T] float32 dense columns: one entry per
    column holding both planes, [T] int32 bf16 pairs
    (``pack_pairs_bf16_plain``) or, ``f32``, [T, 2] float32 pairs
    (``pack_pairs_f32_kernel``)."""
    return cols.t().contiguous() if f32 else pack_pairs_bf16_plain(cols)


def _unpack_pairs_plain(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[T] int32 bf16-pair words -> (plane 0, plane 1) [T] float32, each half
    widened by a shift as K1 exact widens it."""
    w = words.to(torch.int64) & M32
    return _int32((w << 16) & M32).view(torch.float32), _int32(w & 0xFFFF0000).view(torch.float32)


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


def _plan(levels: list[dict], x, y, z, idx3: torch.Tensor, w, k: int, salt: int = 0):
    """(sel [k, L, N] int64, coef [k, L, N] float32): nerfjax's
    ``_stochastic_corner_plan`` from the corners' indices idx3 [L, 8, N] and
    float32 weights w ([L, 8, N], or a list of 8 [L, N]).

      k = 1: one corner drawn with P = its weight, coef 1;
      k >= 2: the leader m, the first of the largest weights (a strict >
        over corners 0..7, as jnp.argmax breaks ties), with coef w_m, then
        k - 1 draws from the residual weights w * (1 - onehot(m)) (their
        sequential CDF; u scaled by its last entry, total = 1 - w_m), each
        with coef total * f32(1/(k-1)). At total = 0 (a lattice vertex)
        every draw is corner 7 with coef 0.
    """
    w = torch.stack(list(w), dim=1) if isinstance(w, (list, tuple)) else w
    L, _, N = idx3.shape
    if k == 1:
        c = _draw_corners(x, y, z, _sequential_cdf(list(w.unbind(1))), L, 1, salt)
        return idx3.gather(1, c[0][:, None, :]).permute(1, 0, 2), torch.ones(1, L, N, device=w.device)
    m = torch.zeros(L, N, dtype=torch.int64, device=w.device)
    wm = w[:, 0]
    for c in range(1, 8):
        better = w[:, c] > wm
        m = torch.where(better, c, m)
        wm = torch.where(better, w[:, c], wm)
    onehot = (torch.arange(8, device=w.device)[None, :, None] == m[:, None, :]).to(torch.float32)
    cdfr = _sequential_cdf(list((w * (1.0 - onehot)).unbind(1)))
    draws = _draw_corners(x, y, z, cdfr, L, k - 1, salt)  # [k-1, L, N]
    sel = torch.cat([idx3.gather(1, m[:, None, :]).permute(1, 0, 2),
                     torch.stack([idx3.gather(1, d[:, None, :])[:, 0, :] for d in draws])])
    coef_r = cdfr[:, 7, :] * _rinv(k)
    return sel, torch.cat([wm[None], coef_r[None].expand(k - 1, L, N)])


def _hash_plan(spec: HashGridSpec, hashed: list[dict], x, y, z, k: int):
    """The hashed levels' k-corner plan (salt 0; indices relative to the
    first hashed level): ``_plan``'s (sel, coef)."""
    idx3 = torch.stack(_hash_level_indices(spec, hashed, x, y, z), dim=1)  # [Lh, 8, N]
    return _plan(hashed, x, y, z, idx3, _corner_weights(hashed, x, y, z), k)


def _plan_k1(spec: HashGridSpec, hashed: list[dict], x, y, z) -> torch.Tensor:
    """The k = 1 plan: [Lh, N] int64 index of the drawn corner of each
    (level, point), relative to the first hashed level."""
    return _hash_plan(spec, hashed, x, y, z, 1)[0][0]


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


def _dense_corner_arrays(dense: list[dict], x, y, z, dtype):
    """(idx [Ld, 8, N] int64 into the planes, w [Ld, 8, N] in dtype): every
    dense level's corners in ``CORNERS`` order (nerfjax
    ``_dense_level_indices`` and ``_corner_weights(clamp=True)``)."""
    idx, w = [], []
    for lp in dense:
        i, wc = zip(*_dense_corners(lp, *_dense_geometry(lp, x, y, z, dtype)))
        idx.append(torch.stack(i))
        w.append(torch.stack(wc))
    return torch.stack(idx), torch.stack(w)


def _dense_plan(dense: list[dict], x, y, z, k: int):
    """The dense levels' k-corner plan: ``_plan``'s (sel [k, Ld, N] entries
    of the planes, coef) with clamped float32 weights and ``DENSE_SALT``
    (nerfjax ``_stochastic_corner_plan(clamp=True, salt=_DENSE_SALT)``)."""
    idx, w = _dense_corner_arrays(dense, x, y, z, torch.float32)
    return _plan(dense, x, y, z, idx, w, k, DENSE_SALT)


def _dense_plan_k1(dense: list[dict], x, y, z) -> torch.Tensor:
    """The dense levels' k = 1 plan: [Ld, N] int64 entry of the drawn corner."""
    return _dense_plan(dense, x, y, z, 1)[0][0]


def _estimate(tbl: torch.Tensor, sel: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """[2, L, N] float32 sum over j of tbl[:, sel_j] * coef_j, in j order
    (the k-corner estimate; at k = 1 the drawn value itself)."""
    e = tbl[:, sel[0]] * coef[0]
    for j in range(1, sel.shape[0]):
        e = e + tbl[:, sel[j]] * coef[j]
    return e


def _dense_width(dense: list[dict]) -> int:
    """Columns of the planes the dense levels hold (they are a prefix)."""
    return dense[-1]["offset"] + dense[-1]["size"]


# -- plain versions -------------------------------------------------------------


def hash_levels_fwd_plain(spec: HashGridSpec, planes: torch.Tensor, x, y, z):
    """(out [2, Lh, N] float32, sel or None): the hashed levels' exact
    forward, or (``fwd_corners`` = k < 8) the k-corner estimate from
    bf16-rounded table values and its plan, sel [Lh, N] int64 at k = 1,
    [k, Lh, N] at k >= 2 (the leader first)."""
    _, hashed = _split_levels(spec)
    k = spec.fwd_corners
    if k < 8:
        tbl = planes[:, hashed[0]["offset"]:].to(torch.bfloat16).to(torch.float32)
        sel, coef = _hash_plan(spec, hashed, x, y, z, k)
        return _estimate(tbl, sel, coef), sel[0] if k == 1 else sel
    t0, t1 = _unpack_pairs_plain(pack_pairs_bf16_plain(planes[:, hashed[0]["offset"]:]))
    idx = _hash_level_indices(spec, hashed, x, y, z)
    w = _corner_weights(hashed, x, y, z)
    e0 = torch.zeros_like(w[0])
    e1 = torch.zeros_like(w[0])
    for c in range(8):
        e0 = e0 + t0[idx[c]] * w[c]
        e1 = e1 + t1[idx[c]] * w[c]
    return torch.stack([e0, e1]), None


def _check_out(name: str, out: torch.Tensor, device) -> int:
    """T of ``out``, checked to be a contiguous [2, T] float32 tensor on ``device``."""
    if out.dim() != 2 or out.shape[0] != 2 or out.dtype != torch.float32 or not out.is_contiguous() \
            or out.device != device:
        raise ValueError(f"{name}: out must be a contiguous [2, T] float32 tensor on {device}")
    return out.shape[1]


def _check_rows(name: str, out: torch.Tensor, device) -> int:
    """T of ``out``, checked to be a [2, T] float32 tensor on ``device``
    whose rows are contiguous (a column slice of a [2, total] gradient)."""
    if out.dim() != 2 or out.shape[0] != 2 or out.dtype != torch.float32 or out.device != device \
            or out.stride(1) != 1 or out.stride(0) < out.shape[1]:
        raise ValueError(f"{name}: out must be a [2, T] float32 tensor on {device} with contiguous rows")
    return out.shape[1]


def table_grad_scatter_plain(idx: torch.Tensor, g0: torch.Tensor, g1: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out[p][idx_k] += g_p[k] into the [2, T] float32 planes ``out``
    (rows contiguous), returned; indices outside [0, T) are dropped
    (``mode="drop"``: torch's ``index_add_`` would raise)."""
    T = _check_rows("table_grad_scatter_plain", out, g0.device)
    keep = (idx >= 0) & (idx < T)
    i = idx[keep].to(torch.int64)
    out[0].index_add_(0, i, g0[keep].to(torch.float32))
    out[1].index_add_(0, i, g1[keep].to(torch.float32))
    return out


def hash_bwd_entries(spec: HashGridSpec, g: torch.Tensor, x, y, z):
    """(idx [K] int64 into the planes, v0, v1 [K] float32): the terms of the
    hashed levels' table gradient from the upstream gradient g [2, Lh, N]
    (bf16 or float32, widened to float32 first: exact): exact, g*w to the 8
    corners of each (level, point); or g*coef to the b planned corners
    (``_grad_corners``), over gl drawn levels (g*coef)*(Lh/gl)."""
    _, hashed = _split_levels(spec)
    base, Lh = hashed[0]["offset"], len(hashed)
    mode, gl = _bwd_mode(spec, Lh)
    g = g.to(torch.float32)
    if mode == 0:
        idx = torch.stack(_hash_level_indices(spec, hashed, x, y, z))  # [8, Lh, N]
        w = torch.stack(_corner_weights(hashed, x, y, z))
        v0, v1 = g[0][None] * w, g[1][None] * w
    else:
        idx, coef = _hash_plan(spec, hashed, x, y, z, _grad_corners(spec))  # [b, Lh, N]
        v0, v1 = g[0][None] * coef, g[1][None] * coef
        if mode == 2:
            ids = _draw_levels(x, y, z, Lh, gl, LEVEL_SALT)[None].expand(idx.shape[0], -1, -1)  # [b, gl, N]
            scale = float(np.float32(Lh / gl))
            idx = idx.gather(1, ids)
            v0, v1 = v0.gather(1, ids) * scale, v1.gather(1, ids) * scale
    return (idx + base).reshape(-1), v0.reshape(-1), v1.reshape(-1)


def hash_levels_bwd_plain(spec: HashGridSpec, g: torch.Tensor, x, y, z, out: torch.Tensor) -> torch.Tensor:
    """The hashed levels' table gradient (``hash_bwd_entries``' terms) added
    into the hashed columns of the [2, total] float32 planes ``out``,
    returned."""
    return table_grad_scatter_plain(*hash_bwd_entries(spec, g, x, y, z), out)


def k2_runs(spec: HashGridSpec, x, y, z) -> torch.Tensor:
    """[8, Lh*N] bool: True where the exact K2 lane t = l*N + n starts a run
    of its warp for that corner (a warp is 32 lanes in a row of t; a run
    starts at its first lane and wherever the index differs from the
    previous lane's). The design sums each run and adds it once."""
    _, hashed = _split_levels(spec)
    idx = torch.stack(_hash_level_indices(spec, hashed, x, y, z)).reshape(8, -1)  # [8, Lh*N], level-major
    head = torch.ones_like(idx, dtype=torch.bool)
    head[:, 1:] = idx[:, 1:] != idx[:, :-1]
    head[:, ::32] = True
    return head


def k2_atomic_count(spec: HashGridSpec, x, y, z) -> int:
    """The atomic adds the exact K2 issues on the card for positions x, y, z
    (merged runs, one float2 add each): its (level, corner, warp-run)
    groups. The first design issued 16 * Lh * N float adds: one per (level,
    point, corner, plane)."""
    return int(k2_runs(spec, x, y, z).sum())


def k2_lr_runs(spec: HashGridSpec, x, y, z) -> torch.Tensor:
    """[b, rows, N] bool for K2's b >= 2 modes (rows: the Lh levels, or the
    gl drawn levels): True where point n's lane starts a run that the card
    sums and adds once. Over all levels a warp is 32 points in a row of n
    at one level and one draw, and a run starts at its first lane and
    wherever the index differs from the previous lane's; over gl drawn
    levels (one thread per point over its draws) every term is a run of
    its own (all True)."""
    _, hashed = _split_levels(spec)
    N = x.shape[0]
    g = torch.zeros(2, len(hashed), N, device=x.device)
    idx = hash_bwd_entries(spec, g, x, y, z)[0].reshape(_grad_corners(spec), -1, N)
    head = torch.ones_like(idx, dtype=torch.bool)
    if _bwd_mode(spec, len(hashed))[0] == 1:
        head[..., 1:] = idx[..., 1:] != idx[..., :-1]
        head[..., ::32] = True
    return head


def k2_lr_atomic_count(spec: HashGridSpec, g: torch.Tensor, x, y, z) -> int:
    """The adds K2's b >= 2 modes issue on the card for the upstream
    gradient g and positions x, y, z, each one float atomic into each
    plane: the runs of ``k2_lr_runs`` that hold a nonzero term (the card
    skips a run whose two sums are 0, which adds nothing; most of a fast
    train step's cotangent is 0). Over gl drawn levels every term is a run,
    so that is its terms that are not 0. The first designs added every
    term: b * Lh * N over all levels, b * gl * N over gl drawn levels."""
    head = k2_lr_runs(spec, x, y, z).reshape(-1)
    _, v0, v1 = hash_bwd_entries(spec, g, x, y, z)
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    nonzero = torch.zeros(int(head.sum()), dtype=torch.int64, device=head.device)
    nonzero.index_add_(0, run, ((v0 != 0) | (v1 != 0)).to(torch.int64))
    return int((nonzero > 0).sum())


def k3_runs(idx: torch.Tensor, T: int) -> torch.Tensor:
    """[K] bool: True where K3's lane k starts a run of its warp (a warp is
    32 lanes in a row of k; a run starts at its first lane and wherever the
    index differs from the previous lane's, every index outside [0, T)
    counting as one "no add" index). The design sums each run and adds it
    once."""
    key = torch.where((idx >= 0) & (idx < T), idx.to(torch.int64), -1)
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = key[1:] != key[:-1]
    head[::32] = True
    return head


def k3_atomic_count(idx: torch.Tensor, T: int) -> int:
    """The float2 atomic adds K3 issues on the card for indices ``idx``
    into [2, T] planes: its warp runs of an index in [0, T). The first
    design issued two float adds per entry in range."""
    return int((k3_runs(idx, T) & (idx >= 0) & (idx < T)).sum())


def dense_levels_fwd_plain(spec: HashGridSpec, planes: torch.Tensor, x, y, z, dtype=torch.float32):
    """(out [2, Ld, N], sel or None): the dense levels' exact forward in
    ``dtype`` (every op rounds to it), or (``dense_corners`` = k < 8) the
    k-corner estimate in float32 from bf16-rounded table values and its
    plan, sel [Ld, N] int64 at k = 1, [k, Ld, N] at k >= 2."""
    dense, _ = _split_levels(spec)
    mode, _ = _dense_mode(spec, len(dense))
    planes = planes[:, : _dense_width(dense)]
    if mode == 1:
        k = spec.dense_corners
        sel, coef = _dense_plan(dense, x, y, z, k)
        return _estimate(planes.to(torch.bfloat16).to(torch.float32), sel, coef), sel[0] if k == 1 else sel
    tbl = planes.to(dtype)
    idx, w = _dense_corner_arrays(dense, x, y, z, dtype)
    e0 = torch.zeros_like(w[:, 0])
    e1 = torch.zeros_like(w[:, 0])
    for c in range(8):
        e0 = e0 + tbl[0][idx[:, c]] * w[:, c]
        e1 = e1 + tbl[1][idx[:, c]] * w[:, c]
    return torch.stack([e0, e1]), None


def dense_levels_bwd_plain(spec: HashGridSpec, g: torch.Tensor, x, y, z, dtype=torch.float32):
    """(idx [K] int32, v0, v1 [K] float32): K3's inputs for the dense levels'
    table gradient from their upstream gradient g [2, Ld, N] (taken in
    ``dtype``):

      * exact: K = Ld*8*N in (level, corner, point) order, each corner's
        g*w formed in ``dtype`` (the product's VJP in nerfjax; ROADMAP
        Queue 3: nerfjax's bf16 row scatter then accumulates in bf16, K3 in
        float32);
      * stochastic (``dense_corners`` < 8): K = Ld*b*N in (level, draw,
        point) order, g*coef at the b planned corners
        (``_dense_grad_corners``; ``_dense_stoch_bwd``);
      * level subset: K = gd*8*N over gd levels drawn per point, the drawn
        level's cotangent taken along the level axis (nerfjax's
        take_along_axis), float32 weights, (w*g)*(Ld/gd) (``_dense_glv_bwd``).
    """
    dense, _ = _split_levels(spec)
    Ld = len(dense)
    mode, gd = _dense_mode(spec, Ld)
    g = g.to(dtype)
    if mode == 1:
        sel, coef = _dense_plan(dense, x, y, z, _dense_grad_corners(spec))  # [b, Ld, N]
        g32 = g.to(torch.float32)
        idx, v0, v1 = (t.transpose(0, 1) for t in (sel, g32[0][None] * coef, g32[1][None] * coef))
    elif mode == 0:
        idx, w = _dense_corner_arrays(dense, x, y, z, dtype)
        v0 = (g[0][:, None, :] * w).to(torch.float32)
        v1 = (g[1][:, None, :] * w).to(torch.float32)
    else:
        ids = _draw_levels(x, y, z, Ld, gd, DENSE_GL_SALT)  # [gd, N]
        g32 = g.to(torch.float32)
        g0, g1 = g32[0].gather(0, ids), g32[1].gather(0, ids)
        rows = ids[:, None, :].expand(gd, 8, -1)
        idx, w = (t.gather(0, rows) for t in _dense_corner_arrays(dense, x, y, z, torch.float32))
        scale = float(np.float32(Ld / gd))
        v0, v1 = (w * g0[:, None, :]) * scale, (w * g1[:, None, :]) * scale
    return idx.reshape(-1).to(torch.int32), v0.reshape(-1), v1.reshape(-1)


# -- kernels --------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (first call only) and load csrc/hash_encode.cu, with typed entries."""
    from nerfjax_torch import _build

    lib = _build.load("hash_encode")
    vp, i32, i64, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32, ctypes.c_float
    lib.nerf_hash_levels_fwd.argtypes = [vp, i64, i64, vp, vp, vp, i64, i32, vp, vp, u32, i32, f32, vp, i64, i32, vp,
                                         vp, vp]
    lib.nerf_hash_levels_bwd.argtypes = [vp, i64, i32, i64, i64, vp, vp, vp, i64, i32, vp, vp, u32, i32, i32, f32,
                                         i32, f32, vp, vp, vp]
    lib.nerf_table_grad_scatter.argtypes = [vp, vp, vp, i64, i64, i64, vp, vp, vp]
    lib.nerf_pack_pairs.argtypes = [vp, vp, i64, i32, vp, vp]
    lib.nerf_dense_levels_fwd.argtypes = [vp, vp, vp, vp, i64, i32, vp, vp, vp, i32, i32, f32, vp, i64, i32, vp, vp]
    lib.nerf_dense_levels_bwd.argtypes = [vp, i64, i32, vp, vp, vp, i64, i32, vp, vp, vp, i32, i32, f32, i32, f32,
                                          vp, vp, vp, vp]
    for fn in (lib.nerf_hash_levels_fwd, lib.nerf_hash_levels_bwd, lib.nerf_table_grad_scatter,
               lib.nerf_pack_pairs, lib.nerf_dense_levels_fwd, lib.nerf_dense_levels_bwd):
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


def _check_level_out(name: str, out: torch.Tensor, rows: int, N: int, dtypes, device) -> None:
    """Raise unless ``out`` is a [2, rows, N] tensor of one of ``dtypes`` on
    ``device`` whose rows are contiguous (level stride N, point stride 1)
    and whose two planes do not overlap (any plane stride >= rows*N): a
    level kind's rows of the encode's [2, L, N] output will do."""
    ok = tuple(out.shape) == (2, rows, N) and out.dtype in dtypes and out.device == device and (
        N == 0 or ((N == 1 or out.stride(2) == 1) and (rows == 1 or out.stride(1) == N)
                   and out.stride(0) >= rows * N))
    if not ok:
        raise ValueError(f"{name}: out must be [2, {rows}, {N}] in {' or '.join(map(str, dtypes))} on {device} "
                         f"with contiguous rows and a plane stride >= {rows * N}, got {tuple(out.shape)} "
                         f"{out.dtype} strides {out.stride()} on {out.device}")


def _check_sel(name: str, sel: torch.Tensor | None, k: int, rows: int, N: int, device) -> None:
    """Raise unless ``sel`` is None or, under a k-corner plan (k < 8), a
    contiguous int32 on ``device`` of [rows, N] (k = 1) or [k, rows, N]."""
    if sel is None:
        return
    shape = (rows, N) if k == 1 else (k, rows, N)
    if k == 8 or sel.shape != shape or sel.dtype != torch.int32 or not sel.is_contiguous() or sel.device != device:
        raise ValueError(f"{name}: sel must be a contiguous {list(shape)} int32 on {device}, under a "
                         f"k-corner plan (k < 8; here k = {k})")


def hash_levels_fwd(spec: HashGridSpec, planes: torch.Tensor, x, y, z, *, sel: torch.Tensor | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Hashed-level forward -> [2, Lh, N] from the full [2, total] float32
    planes and x, y, z [N] float32 in [0, 1]: the exact trilinear sum, or
    (``spec.fwd_corners`` = k < 8) the k-corner estimate.

    out: optional [2, Lh, N] float32 or bf16 with contiguous rows and any
    plane stride (the hashed rows of the encode's output); the values are
    written into it, rounded as ``.to(out.dtype)`` rounds the float32
    result, and it is returned. Without it a float32 [2, Lh, N] is.

    On the card every mode but k = 1 first packs the hashed columns into
    one bf16-pair word per entry (a [total - base] int32 buffer allocated
    here) and reads one word per corner (exact) or planned entry (k >= 2);
    k = 1 reads both planes of its one entry. The k-corner modes are one
    thread per (level, point) over a 2-D grid, with 32-bit entries (total
    < 2^31).

    sel: optional int32 that receives the plan (indices relative to the
    first hashed level): [Lh, N] at k = 1, [k, Lh, N] at k >= 2 (the leader
    first); the plain version fills it too.
    """
    _, hashed = _split_levels(spec)
    Lh, N, k = len(hashed), x.shape[0], min(spec.fwd_corners, 8)
    if out is not None:
        _check_level_out("hash_levels_fwd", out, Lh, N, (torch.float32, torch.bfloat16), x.device)
    _check_sel("hash_levels_fwd", sel, k, Lh, N, x.device)
    if _device_kind("hash_levels_fwd", x) == "cpu":
        res, plan = hash_levels_fwd_plain(spec, planes, x, y, z)
        if sel is not None:
            sel.copy_(plan)
        return res if out is None else out.copy_(res)
    if k < 8 and planes.dim() == 2 and planes.shape[1] >= 2**31:
        raise ValueError(f"hash_levels_fwd: planes hold {planes.shape[1]} columns; the k-corner kernels take "
                         "fewer than 2^31")
    _check_positions("hash_levels_fwd", planes, x, y, z)
    if out is None:
        out = torch.empty(2, Lh, N, dtype=torch.float32, device=x.device)
    if N:
        base, scales, offsets, mask = _level_arrays(spec, hashed)
        words = None if k == 1 else torch.empty(planes.shape[1] - base, dtype=torch.int32, device=x.device)
        err = _lib().nerf_hash_levels_fwd(
            planes.data_ptr(), planes.shape[1], base, x.data_ptr(), y.data_ptr(), z.data_ptr(), N,
            Lh, scales.ctypes.data, offsets.ctypes.data, mask, k, _rinv(k), out.data_ptr(), out.stride(0),
            int(out.dtype == torch.bfloat16), 0 if sel is None else sel.data_ptr(),
            0 if words is None else words.data_ptr(), _stream(x),
        )
        _raise_if_failed("hash_levels_fwd", err)
        launch_counts["hash_levels_fwd"] += 1
    return out


def hash_levels_bwd(spec: HashGridSpec, g: torch.Tensor, x, y, z, out: torch.Tensor) -> torch.Tensor:
    """Table gradient of the hashed levels from the upstream gradient g
    [2, Lh, N], added into the hashed columns of the [2, total] float32
    planes ``out`` and returned: exact, or g*coef to the b =
    min(grad_corners, fwd_corners) planned corners (replaying the forward's
    plan at b = fwd_corners), over all levels or over ``spec.grad_levels``
    drawn levels scaled Lh/gl. g is bf16 or float32, each plane's [Lh, N] contiguous (a slice of
    the encode's [2, L, N] cotangent will do): the kernel reads it in place
    and widens each value to float32 (exact).

    The exact mode on the card merges each warp's runs of equal indices and
    adds each run's sums with one float2 atomic into a zeroed interleaved
    scratch ``[total - base, 2]`` float32, allocated here and added into
    ``out`` by a second pass; the planned modes add straight into ``out``:
    b >= 2 over all levels one thread per (level, point) (N < 2^31), each
    warp's runs of equal indices merged per draw and a run whose sums are 0
    left out (``k2_lr_runs``); k = 1 and b >= 2 over gl drawn levels one
    thread per point over its rows (b >= 2: a term whose two values are 0
    left out)."""
    _, hashed = _split_levels(spec)
    if _device_kind("hash_levels_bwd", x) == "cpu":
        return hash_levels_bwd_plain(spec, g, x, y, z, out)
    Lh = len(hashed)
    N = x.shape[0]
    _check_dtype("hash_levels_bwd", g.dtype)
    if g.shape != (2, Lh, N) or not g[0].is_contiguous() or g.device != x.device:
        raise ValueError(f"hash_levels_bwd: g must be [2, {Lh}, {N}] on {x.device} with contiguous planes, "
                         f"got {tuple(g.shape)} strides {g.stride()} on {g.device}")
    _check_cuda("hash_levels_bwd", {"x": x, "y": y, "z": z})
    mode, gl = _bwd_mode(spec, Lh)
    total = _check_out("hash_levels_bwd", out, x.device)
    if N:
        base, scales, offsets, mask = _level_arrays(spec, hashed)
        scale = float(np.float32(Lh / gl)) if mode == 2 else 1.0
        scratch = torch.zeros(total - base, 2, dtype=torch.float32, device=x.device) if mode == 0 else None
        b = _grad_corners(spec)
        err = _lib().nerf_hash_levels_bwd(
            g.data_ptr(), g.stride(0), int(g.dtype == torch.bfloat16), total, base, x.data_ptr(), y.data_ptr(),
            z.data_ptr(), N, Lh,
            scales.ctypes.data, offsets.ctypes.data, mask, mode, gl, scale, b, _rinv(b), out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), _stream(x),
        )
        _raise_if_failed("hash_levels_bwd", err)
        launch_counts["hash_levels_bwd"] += 1
    return out


def table_grad_scatter(idx: torch.Tensor, g0: torch.Tensor, g1: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out[p][idx_k] += g_p[k] into the [2, T] float32 planes ``out``
    (rows contiguous: a column slice of a [2, total] gradient will do),
    returned, from idx [K] int32 and g0, g1 [K] float32; indices outside
    [0, T) are dropped.

    On the card each warp merges its runs of equal indices and adds each
    run's sums with one float2 atomic into a zeroed interleaved scratch
    ``[T, 2]`` float32, allocated here and added into ``out`` by a second
    pass."""
    if _device_kind("table_grad_scatter", idx) == "cpu":
        return table_grad_scatter_plain(idx, g0, g1, out)
    K = idx.shape[0]
    if idx.dim() != 1 or g0.shape != (K,) or g1.shape != (K,):
        raise ValueError("table_grad_scatter: idx, g0, g1 must be [K] each")
    _check_cuda("table_grad_scatter", {"idx": idx}, torch.int32)
    _check_cuda("table_grad_scatter", {"g0": g0, "g1": g1})
    if g0.device != idx.device:
        raise ValueError(f"table_grad_scatter: g0 on {g0.device}, idx on {idx.device}")
    T = _check_rows("table_grad_scatter", out, idx.device)
    if K and T:  # T = 0: every index is dropped
        scratch = torch.zeros(T, 2, dtype=torch.float32, device=idx.device)
        err = _lib().nerf_table_grad_scatter(
            idx.data_ptr(), g0.data_ptr(), g1.data_ptr(), K, T, out.stride(0), out.data_ptr(),
            scratch.data_ptr(), _stream(idx)
        )
        _raise_if_failed("table_grad_scatter", err)
        launch_counts["table_grad_scatter"] += 1
    return out


def _dense_level_arrays(dense: list[dict]):
    """(scales f32 [Ld], resolutions int32 [Ld], offsets int64 [Ld]) for the kernels."""
    if len(dense) > _lib().nerf_hash_max_levels():
        raise ValueError(f"{len(dense)} dense levels exceed the kernels' maximum")
    return (np.array([lp["scale"] for lp in dense], np.float32), np.array([lp["res"] for lp in dense], np.int32),
            np.array([lp["offset"] for lp in dense], np.int64))


def _check_dtype(name: str, dtype: torch.dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype must be float32 or bfloat16, got {dtype}")


def pack_pairs(cols: torch.Tensor, f32: bool) -> torch.Tensor:
    """K4's table: the [2, T] float32 dense columns (rows contiguous: a
    column slice of the planes will do) packed into one entry per column
    holding both planes, [T] int32 bf16 pairs (plane 0 in the low half;
    each value rounded to bf16 once, here) or, ``f32``, [T, 2] float32."""
    if _device_kind("pack_pairs", cols) == "cpu":
        return pack_pairs_plain(cols, f32)
    T = _check_rows("pack_pairs", cols, cols.device)
    out = torch.empty((T, 2) if f32 else (T,), dtype=torch.float32 if f32 else torch.int32, device=cols.device)
    if T:
        err = _lib().nerf_pack_pairs(cols[0].data_ptr(), cols[1].data_ptr(), T, int(f32), out.data_ptr(),
                                     _stream(cols))
        _raise_if_failed("pack_pairs", err)
        launch_counts["pack_pairs"] += 1
    return out


def dense_levels_fwd(spec: HashGridSpec, planes: torch.Tensor, x, y, z, dtype=torch.float32, *,
                     sel: torch.Tensor | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """Dense-level forward -> [2, Ld, N] from the full [2, total] float32
    planes and x, y, z [N] float32 in [0, 1]: the exact trilinear sum in
    ``dtype``, or (``spec.dense_corners`` = k < 8) the k-corner estimate in
    float32.

    out: optional [2, Ld, N] with contiguous rows and any plane stride (the
    dense rows of the encode's output), in ``dtype`` (exact) or in float32
    or bf16 (k-corner: each value rounded as ``.to(out.dtype)`` rounds it);
    the values are written into it and it is returned.

    On the card the dense columns are first packed into one entry per
    column (``pack_pairs``: bf16 pairs, float2 in exact float32), and the
    kernel reads one entry per corner: exact and k = 1 one thread per point
    over the levels, k >= 2 one thread per (level, point) with its k loads
    issued together.

    sel: optional int32 that receives the plan (entries of the planes):
    [Ld, N] at k = 1, [k, Ld, N] at k >= 2; the plain version fills it too.
    """
    dense, _ = _split_levels(spec)
    Ld, N = len(dense), x.shape[0]
    k = spec.dense_corners if _dense_mode(spec, Ld)[0] == 1 else 8
    if out is not None:
        _check_level_out("dense_levels_fwd", out, Ld, N, (torch.float32, torch.bfloat16) if k < 8 else (dtype,),
                         x.device)
    _check_sel("dense_levels_fwd", sel, k, Ld, N, x.device)
    if _device_kind("dense_levels_fwd", x) == "cpu":
        res, plan = dense_levels_fwd_plain(spec, planes, x, y, z, dtype)
        if sel is not None:
            sel.copy_(plan)
        return res if out is None else out.copy_(res)
    _check_dtype("dense_levels_fwd", dtype)
    _check_positions("dense_levels_fwd", planes, x, y, z)
    T = _dense_width(dense)
    if planes.shape[1] < T or T >= 2**31:
        raise ValueError(f"dense_levels_fwd: planes hold {planes.shape[1]} columns, the dense levels "
                         f"{T} (the kernel takes fewer than 2^31)")
    if out is None:
        out = torch.empty(2, Ld, N, dtype=torch.float32 if k < 8 else dtype, device=x.device)
    if N:
        scales, res, offsets = _dense_level_arrays(dense)
        mode = int(dtype == torch.bfloat16) if k == 8 else 2 if k == 1 else 3
        pairs = pack_pairs(planes[:, :T], f32=mode == 0)
        err = _lib().nerf_dense_levels_fwd(
            pairs.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(), N, Ld, scales.ctypes.data,
            res.ctypes.data, offsets.ctypes.data, mode, k, _rinv(k), out.data_ptr(), out.stride(0),
            int(out.dtype == torch.bfloat16), 0 if sel is None else sel.data_ptr(), _stream(x),
        )
        _raise_if_failed("dense_levels_fwd", err)
        launch_counts["dense_levels_fwd"] += 1
    return out


def dense_levels_bwd(spec: HashGridSpec, g: torch.Tensor, x, y, z, dtype=torch.float32):
    """K3's inputs (idx [K] int32, v0, v1 [K] float32) for the dense levels'
    table gradient from their upstream gradient g [2, Ld, N] (taken in
    ``dtype``; each plane's [Ld, N] contiguous): exact, to the b planned
    corners (replaying the forward's plan at b = dense_corners) or over
    ``spec.dense_grad_levels`` drawn levels scaled Ld/gd, as
    ``dense_levels_bwd_plain`` describes."""
    dense, _ = _split_levels(spec)
    if _device_kind("dense_levels_bwd", x) == "cpu":
        return dense_levels_bwd_plain(spec, g, x, y, z, dtype)
    _check_dtype("dense_levels_bwd", dtype)
    Ld, N = len(dense), x.shape[0]
    g = g.to(dtype)
    if g.shape != (2, Ld, N) or not g[0].is_contiguous():
        raise ValueError(f"dense_levels_bwd: g must be [2, {Ld}, {N}] with contiguous planes, "
                         f"got {tuple(g.shape)} strides {g.stride()}")
    _check_cuda("dense_levels_bwd", {"x": x, "y": y, "z": z})
    if g.device != x.device:
        raise ValueError(f"dense_levels_bwd: g on {g.device}, x on {x.device}")
    mode, gd = _dense_mode(spec, Ld)
    b = _dense_grad_corners(spec) if mode == 1 else 8
    K = {0: Ld * 8, 1: Ld * b, 2: gd * 8}[mode] * N
    idx = torch.empty(K, dtype=torch.int32, device=x.device)
    v0 = torch.empty(K, dtype=torch.float32, device=x.device)
    v1 = torch.empty(K, dtype=torch.float32, device=x.device)
    if N:
        scales, res, offsets = _dense_level_arrays(dense)
        scale = float(np.float32(Ld / gd)) if mode == 2 else 1.0
        err = _lib().nerf_dense_levels_bwd(
            g.data_ptr(), g.stride(0), int(dtype == torch.bfloat16), x.data_ptr(), y.data_ptr(),
            z.data_ptr(), N, Ld, scales.ctypes.data, res.ctypes.data, offsets.ctypes.data, mode, gd,
            scale, b, _rinv(b), idx.data_ptr(), v0.data_ptr(), v1.data_ptr(), _stream(x),
        )
        _raise_if_failed("dense_levels_bwd", err)
        launch_counts["dense_levels_bwd"] += 1
    return idx, v0, v1


# -- the encode, with its table gradient ----------------------------------------


class _HashEncode(torch.autograd.Function):
    """The encode -> [2, L, N] in ``dtype``, allocated once: K4 writes the
    dense rows ``[:, :Ld]`` and K1 the hashed rows ``[:, Ld:]`` in place,
    each value rounded to ``dtype`` as ``.to(dtype)`` rounds it (no float32
    part, no cast, no concat). The backward zeroes one [2, total] float32
    gradient; K5 stages the dense levels' table gradient, K3 adds it into
    the dense columns (a column slice: its scratch spans them only) and K2
    the hashed levels' into the hashed columns."""

    @staticmethod
    def forward(ctx, planes, x, y, z, spec, dtype):
        ctx.spec, ctx.dtype, ctx.total = spec, dtype, planes.shape[1]
        ctx.save_for_backward(x, y, z)
        dense, hashed = _split_levels(spec)
        Ld = len(dense)
        enc = torch.empty(2, Ld + len(hashed), x.shape[0], dtype=dtype, device=x.device)
        if dense:
            dense_levels_fwd(spec, planes, x, y, z, dtype, out=enc[:, :Ld])
        if hashed:
            hash_levels_fwd(spec, planes, x, y, z, out=enc[:, Ld:])
        return enc

    @staticmethod
    def backward(ctx, g):
        x, y, z = ctx.saved_tensors
        dense, hashed = _split_levels(ctx.spec)
        g = g.contiguous()
        grad = torch.zeros(2, ctx.total, dtype=torch.float32, device=x.device)
        if dense:
            dense_cols = grad[:, : _dense_width(dense)]
            table_grad_scatter(*dense_levels_bwd(ctx.spec, g[:, : len(dense)], x, y, z, ctx.dtype), dense_cols)
        if hashed:  # K2 reads the hashed levels' rows of g in place, in g's dtype
            hash_levels_bwd(ctx.spec, g[:, len(dense) :], x, y, z, grad)
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
      Each level kind's kernel writes its rows in ``dtype`` (the hashed
      levels' float32 values rounded once, as nerfjax's concat casts them).
    """
    if spec.n_features != 2:
        raise ValueError(f"the planar encode needs 2 features, got {spec.n_features}")
    enc = _HashEncode.apply(planes, x, y, z, spec, dtype)
    return enc.reshape(2 * spec.n_levels, x.shape[0])
