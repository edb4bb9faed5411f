"""Direction encoding (counterpart of ``nerfjax/fields/encodings.py``).

Only the feature-major SH-4 encoding is needed by the extraction path; the
Fourier encodings belong to the vanilla field, which is not ported yet.
"""

from __future__ import annotations

import torch


def sh4_encode_planar(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics to degree 4 of unit directions, feature-major:
    three [N] components -> [16, N] (nerfjax ``sh4_encode_planar``, same
    constants and the same order of operations)."""
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    rows = [
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
    return torch.stack(rows, dim=0)
