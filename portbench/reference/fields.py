"""The two fields, plain: Instant-NGP (Müller et al. 2022: a multiresolution
hash grid of 2 features a level, tcnn's spatial hash, trilinear
interpolation, a 32 -> 64 -> 16 density MLP and a 32 -> 64 -> 64 -> 3 color
MLP on [features, SH-4 of the view], no biases) and vanilla NeRF
(Mildenhall et al. 2020, arXiv:2003.08934: an 8 x 256 ReLU MLP on the
Fourier-encoded position with a skip after layer 4, sigma from a linear
head with train-time Gaussian noise before its ReLU, a 256 feature layer,
then [features, encoded view] -> 128 -> 3).

Frozen from the repository's nerfjax field definitions, not imported: the
level table (tcnn's 8-entry alignment), the hash primes, the dense levels'
clamped base cell, the SH-4 constants, the Fourier column order and the
weights' [in, out] layout. Point-major: positions [N, 3], activations
[N, C], everything float32 (or the control's fp8 operands).
"""

from __future__ import annotations

import math

import torch

from portbench.reference.precision import mm, rnd

HASH_PRIMES = (1, 2654435761, 805459861)
LOG2_T = {"small": 15, "medium": 17, "large": 19}
CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def level_table(n_levels: int, log2_t: int, base: int = 16, per_level_scale: float = 1.5) -> list[dict]:
    """Each level's scale, resolution, storage (dense or hashed), size and
    offset in the [2, total] table."""
    out, offset, T = [], 0, 1 << log2_t
    for lvl in range(n_levels):
        scale = base * per_level_scale**lvl - 1.0
        res = int(math.ceil(scale)) + 1
        dense_size = -(-(res**3) // 8) * 8
        hashed = dense_size > T
        size = T if hashed else dense_size
        out.append({"scale": float(scale), "res": res, "hashed": hashed, "size": size, "offset": offset})
        offset += size
    return out


def ngp_levels(cfg: dict) -> list[dict]:
    return level_table(int(cfg.get("hash_n_levels", 16)), LOG2_T[cfg.get("nerf_type", "large")],
                       per_level_scale=float(cfg.get("hash_per_level_scale", 1.5)))


def level_corners(x01: torch.Tensor, lv: dict):
    """The 8 corners of each point at one level: [(index into the level,
    trilinear weight [N])]. Hashed levels: corners floor(x*s + 0.5) + {0, 1},
    index (x ^ y*p1 ^ z*p2) mod T, weights of the unclamped fraction. Dense
    levels: base cell clamped to [0, r-2], fraction clipped to [0, 1], index
    x + y r + z r^2."""
    s, r = lv["scale"], lv["res"]
    pos = x01 * s + 0.5
    fl = torch.floor(pos)
    if lv["hashed"]:
        base, t = fl.to(torch.int64), pos - fl
    else:
        b = fl.clamp(0, r - 2)
        base, t = b.to(torch.int64), (pos - b).clamp(0.0, 1.0)
    out = []
    for dx, dy, dz in CORNERS:
        cx, cy, cz = base[:, 0] + dx, base[:, 1] + dy, base[:, 2] + dz
        if lv["hashed"]:
            idx = (cx * HASH_PRIMES[0] ^ cy * HASH_PRIMES[1] ^ cz * HASH_PRIMES[2]) & (lv["size"] - 1)
        else:
            idx = cx + cy * r + cz * (r * r)
        w = ((t[:, 0] if dx else 1.0 - t[:, 0]) * (t[:, 1] if dy else 1.0 - t[:, 1])
             * (t[:, 2] if dz else 1.0 - t[:, 2]))
        out.append((idx, w))
    return out


def hash_encode(table: torch.Tensor, x01: torch.Tensor, levels: list[dict]) -> torch.Tensor:
    """x01 [N, 3] in [0, 1] -> [N, 2L], plane 0 over the levels then plane 1,
    each level the trilinear blend of its 8 corners (``level_corners``)."""
    p = [], []
    for lv in levels:
        acc = 0.0
        for idx, w in level_corners(x01, lv):
            acc = acc + table[:, lv["offset"] + idx] * w
        p[0].append(acc[0])
        p[1].append(acc[1])
    return torch.stack(p[0] + p[1], dim=1)


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics to degree 4 of unit directions [N, 3] -> [N, 16]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814), -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x, 1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999, -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy), 0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z, 0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0), 0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy), 0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=1)


def to01(pos: torch.Tensor) -> torch.Tensor:
    return ((pos + 1.0) * 0.5).clamp(0.0, 1.0)


def ngp_density(params: dict, pos: torch.Tensor, levels: list[dict], prec: str = "f32"):
    """pos [N, 3] in [-1, 1] -> (sigma [N], features [N, 16])."""
    h = hash_encode(params["table"], to01(pos), levels)
    for layer in params["dmlp"]:
        h = torch.relu(mm(h, layer["w"], prec))
    h = rnd(h, prec)
    return h[:, 0], h


def ngp_apply(params: dict, pos: torch.Tensor, view: torch.Tensor, levels: list[dict], prec: str = "f32"):
    """pos, view [N, 3] -> (rgb [N, 3], sigma [N])."""
    sigma, h = ngp_density(params, pos, levels, prec)
    h = torch.cat([h, sh4(view)], dim=1)
    for layer in params["cmlp"][:-1]:
        h = torch.relu(mm(h, layer["w"], prec))
    return rnd(torch.sigmoid(mm(h, params["cmlp"][-1]["w"], prec)), prec), sigma


def fourier(x: torch.Tensor, L: int) -> torch.Tensor:
    """[N, 3] -> [N, 3 + 6L]: x, then sin and cos of x 2^k pi (k < L), each
    block in [3, L] order flattened; the frequencies 2^k * f32(pi)."""
    freq = (2.0 ** torch.arange(L, dtype=torch.float32, device=x.device)) * math.pi
    xf = (x[:, :, None] * freq).reshape(x.shape[0], -1)
    return torch.cat([x, torch.sin(xf), torch.cos(xf)], dim=1)


def _linear(layer: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    return mm(h, layer["w"], prec) + rnd(layer["b"], prec)


def vanilla_apply(params: dict, pos: torch.Tensor, view: torch.Tensor, cfg: dict, noise=None, prec: str = "f32"):
    """One vanilla MLP: pos, view [N, 3] -> (rgb [N, 3], sigma [N]); ``noise``
    [N] is added to sigma before its ReLU (training)."""
    pe = fourier(pos, int(cfg.get("pos_L", 10)))
    h = pe
    for layer in params["pos_layers"]:
        h = torch.relu(_linear(layer, h, prec))
    h = torch.cat([h, pe], dim=1)
    for layer in params["skip_layers"]:
        h = torch.relu(_linear(layer, h, prec))
    sigma = _linear(params["density"], h, prec)[:, 0]
    if noise is not None:
        sigma = sigma + noise.reshape(-1).to(torch.float32)
    feat = _linear(params["feature"], h, prec)
    h = torch.cat([feat, fourier(view, int(cfg.get("dir_L", 4)))], dim=1)
    h = torch.relu(_linear(params["color_layers"][0], h, prec))
    rgb = torch.sigmoid(_linear(params["color_layers"][1], h, prec))
    return rnd(rgb, prec), rnd(torch.relu(sigma), prec)
