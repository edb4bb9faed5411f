"""Exact forward of the multiresolution hash-grid encoding (counterpart of
``nerfjax/ops/hash_encode.py``: ``_split_levels`` :42-48, ``_hash_level_indices``
:72-100, ``_corner_weights`` :103-128, ``_hash_levels_fwd`` :304-318,
``_dense_levels_encode`` :487-530, ``hash_encode_planar`` :774-814).

Semantics, not layout: nerfjax packs bf16 feature pairs into f32 words and
builds dense-level cell-row tables because the TPU's gather pays per index.
Here the eight corners are gathered directly from the ``[2, total]`` planes.
What matches nerfjax:

  * hashed levels: uint32 spatial hash ``x*1 ^ y*2654435761 ^ z*805459861``
    masked to the table size (computed in int64, whose low 32 bits are the
    uint32 product), table values rounded to bf16 as ``_pack_pairs_bf16``
    rounds them, trilinear weights and the corner sum in float32;
  * dense levels: base cell clamped to ``[0, r-2]``, fraction clipped to
    ``[0, 1]`` (so x = 1.0 lands on the last corner), table values, weights
    and the corner sum in ``dtype``.

Only the exact inference forward is here. The train-only estimators
(``fwd_corners``/``dense_corners`` < 8, ``dense_grad_levels`` > 0) and the
backward passes are later work (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

from nerfjax_torch.fields.ngp import CORNERS, HASH_PRIMES, HashGridSpec


def _split_levels(spec: HashGridSpec) -> tuple[list[dict], list[dict]]:
    levels = spec.level_params()
    dense = [lp for lp in levels if not lp["use_hash"]]
    hashed = [lp for lp in levels if lp["use_hash"]]
    # tcnn level scales grow monotonically: dense levels are a prefix.
    if dense + hashed != levels:
        raise ValueError("dense levels must precede hashed levels")
    return dense, hashed


def _check_exact(spec: HashGridSpec) -> None:
    if spec.fwd_corners < 8 or spec.dense_corners < 8 or spec.dense_grad_levels > 0:
        raise NotImplementedError(
            "the stochastic train-only encoders (fwd_corners/dense_corners < 8, "
            "dense_grad_levels > 0) are not ported yet (ROADMAP Queue 1 item 4)"
        )


def _hash_level_indices(
    spec: HashGridSpec, hashed: list[dict], x, y, z
) -> list[torch.Tensor]:
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
        h = (
            (ix + dx) * HASH_PRIMES[0]
            ^ (iy + dy) * HASH_PRIMES[1]
            ^ (iz + dz) * HASH_PRIMES[2]
        )
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


def _hash_levels_encode(spec: HashGridSpec, hash_planes: torch.Tensor, x, y, z) -> torch.Tensor:
    """Exact hashed-level encode -> [2, Lh, N] float32.

    hash_planes: [2, T_hash] float32 slice of the planes covering the hashed
    levels. Values are rounded to bf16 before the gather, as nerfjax packs them.
    """
    _, hashed = _split_levels(spec)
    tbl = hash_planes.to(torch.bfloat16).to(torch.float32)
    idx = _hash_level_indices(spec, hashed, x, y, z)
    w = _corner_weights(hashed, x, y, z)
    e0 = torch.zeros_like(w[0])
    e1 = torch.zeros_like(w[0])
    for c in range(8):
        e0 = e0 + tbl[0][idx[c]] * w[c]
        e1 = e1 + tbl[1][idx[c]] * w[c]
    return torch.stack([e0, e1])


def _dense_levels_encode(
    dense: list[dict], planes: torch.Tensor, x, y, z, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact dense-level encode -> ([Ld, N], [Ld, N]) in ``dtype``."""
    e0_rows, e1_rows = [], []
    for lp in dense:
        r = lp["res"]
        g = planes[:, lp["offset"] : lp["offset"] + r * r * r].to(dtype)
        px, py, pz = x * lp["scale"] + 0.5, y * lp["scale"] + 0.5, z * lp["scale"] + 0.5
        bx = torch.floor(px).clamp(0, r - 2)
        by = torch.floor(py).clamp(0, r - 2)
        bz = torch.floor(pz).clamp(0, r - 2)
        tx = (px - bx).clamp(0.0, 1.0).to(dtype)
        ty = (py - by).clamp(0.0, 1.0).to(dtype)
        tz = (pz - bz).clamp(0.0, 1.0).to(dtype)
        base = bx.to(torch.int64) + by.to(torch.int64) * r + bz.to(torch.int64) * (r * r)
        e0 = torch.zeros_like(tx)
        e1 = torch.zeros_like(tx)
        for dx, dy, dz in CORNERS:
            idx = base + (dx + dy * r + dz * r * r)
            wx = tx if dx else (1.0 - tx)
            wy = ty if dy else (1.0 - ty)
            wz = tz if dz else (1.0 - tz)
            w = wx * wy * wz
            e0 = e0 + g[0][idx] * w
            e1 = e1 + g[1][idx] * w
        e0_rows.append(e0)
        e1_rows.append(e1)
    return torch.stack(e0_rows), torch.stack(e1_rows)


def hash_encode_planar(
    spec: HashGridSpec,
    planes: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Feature-major hash-grid encoding.

    Args:
      planes: [2, total] float32 table planes.
      x, y, z: [N] float32 position components in [0, 1].
    Returns:
      enc [2L, N] in ``dtype``, plane-major: rows 0..L-1 are plane 0 over the
      levels (dense, then hashed), rows L..2L-1 plane 1 — nerfjax's layout.
    """
    _check_exact(spec)
    if spec.n_features != 2:
        raise ValueError(f"the planar encode needs 2 features, got {spec.n_features}")
    dense, hashed = _split_levels(spec)
    parts0, parts1 = [], []
    if dense:
        e0d, e1d = _dense_levels_encode(dense, planes, x, y, z, dtype)
        parts0.append(e0d)
        parts1.append(e1d)
    if hashed:
        eh = _hash_levels_encode(spec, planes[:, hashed[0]["offset"] :], x, y, z)
        parts0.append(eh[0].to(dtype))
        parts1.append(eh[1].to(dtype))
    return torch.cat(parts0 + parts1, dim=0)
