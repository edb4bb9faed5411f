"""Input encodings (counterpart of ``nerfjax/fields/encodings.py``): the
Fourier encodings of the vanilla field (:13-50) and the SH-4 direction
encoding of the NGP field, point-major (``sh4_encode`` :51-85) and
feature-major. Elementwise torch; the float32
frequencies are nerfjax's (2^k * f32(pi), exact scalings of one rounded pi).
"""

from __future__ import annotations

import math

import torch


def fourier_output_dim(L: int, include_input: bool = True) -> int:
    return (3 if include_input else 0) + 3 * 2 * L


def fourier_encode(x: torch.Tensor, L: int, include_input: bool = True) -> torch.Tensor:
    """[..., 3] -> [..., fourier_output_dim(L)]: ``[x, sin(x 2^k pi),
    cos(x 2^k pi)]`` for k < L, each of the sin and cos blocks the flattened
    [..., 3, L] tensor (nerfjax ``fourier_encode``)."""
    freq = (2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)) * math.pi
    xf = x[..., None] * freq
    parts = [x] if include_input else []
    parts.append(torch.sin(xf).reshape(*x.shape[:-1], -1))
    parts.append(torch.cos(xf).reshape(*x.shape[:-1], -1))
    return torch.cat(parts, dim=-1)


def fourier_encode_planar(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor, L: int,
                          include_input: bool = True) -> torch.Tensor:
    """Feature-major Fourier encoding: three [N] components -> [3 + 6L, N],
    rows in ``fourier_encode``'s column order (x, y, z, then the sin block
    x f_0..x f_L-1, y f_0.., z f_0.., then the cos block), so both share a
    first layer's weights (nerfjax ``fourier_encode_planar``)."""
    comps = [px, py, pz]
    rows = list(comps) if include_input else []
    freqs = [float(2.0**k * math.pi) for k in range(L)]
    for fn in (torch.sin, torch.cos):
        for c in comps:
            for f in freqs:
                rows.append(fn(c * f))
    return torch.stack(rows, dim=0)


def _sh4_terms(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> list[torch.Tensor]:
    """The 16 real spherical harmonics to degree 4 of unit directions, each
    of x's shape, with nerfjax's constants and order of operations."""
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return [
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ]


def sh4_encode(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics to degree 4 of unit directions d [..., 3]
    -> [..., 16] (nerfjax ``sh4_encode``: the true unit direction, not
    tcnn's 2x - 1 remap)."""
    return torch.stack(_sh4_terms(d[..., 0], d[..., 1], d[..., 2]), dim=-1)


def sh4_encode_planar(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics to degree 4 of unit directions, feature-major:
    three [N] components -> [16, N] (nerfjax ``sh4_encode_planar``, same
    constants and the same order of operations)."""
    return torch.stack(_sh4_terms(x, y, z), dim=0)
