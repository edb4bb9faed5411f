"""Instant-NGP field (counterpart of ``nerfjax/fields/ngp.py``).

``HashGridSpec.level_params`` re-implements nerfjax's per-level metadata
(``fields/ngp.py:42-143``: tcnn's 8-entry table alignment and the promotion
of ``extra_dense_levels`` to dense storage) because nerfjax's module imports
jax; ``tests/test_torch_hash_encode.py`` holds the two equal.

``hashgrid_indices_and_weights`` is nerfjax's (:149-206): every level's 8
corner indices and trilinear weights as ``[N, L*8]`` columns.

``InstantNGP`` is an ``nn.Module`` holding the ``[2, total]`` table planes
and the bias-free MLP weights in nerfjax's ``[in, out]`` layout
(``fields/ngp.py:258-436``). ``query_density``/``apply`` are nerfjax's
point-major ("feature-last", ``[N, C]``) forward (:323-346): the exact f32
``hashgrid_encode`` (``nerfjax_torch.ops.hash_encode``), then the MLPs as
``torch.matmul`` in the weights' dtype, as nerfjax's ``_mlp_apply`` leaves
them to XLA. Its feature-major methods keep nerfjax's names:
``query_density_planar``/``apply_planar`` are the unfused, differentiable
path the training step runs (each weight cast to ``dtype`` per matmul, the
product in ``dtype``, as ``jnp.dot(w.T.astype(dtype), h,
preferred_element_type=dtype)``), ``apply_planar_fused``/
``query_density_planar_fused`` the fused MLP kernels of
``nerfjax_torch.ops.fused_mlp`` (inference).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

HASH_PRIMES = (1, 2654435761, 805459861)

NERF_TYPE_LOG2 = {"small": 15, "medium": 17, "large": 19}

CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static hash-grid shape. ``fwd_corners``, ``grad_corners``,
    ``grad_levels``, ``dense_corners`` and ``dense_grad_levels`` name
    nerfjax's train-only estimators (nerfjax ``fields/ngp.py:49-95``); the
    port's encode takes every value: 8 corners exact, 1 the k = 1 draw,
    2..7 the leader + residual plan, any ``grad_levels`` and
    ``dense_grad_levels``."""

    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.5
    grad_corners: int = 8
    fwd_corners: int = 8
    dense_corners: int = 8
    grad_levels: int = 0
    dense_grad_levels: int = 0
    extra_dense_levels: int = 0

    @property
    def hashmap_size(self) -> int:
        return 1 << self.log2_hashmap_size

    def level_params(self) -> list[dict]:
        """Per-level metadata: scale, resolution, table size, offset."""
        out = []
        offset = 0
        promoted = 0
        for lvl in range(self.n_levels):
            scale = self.base_resolution * (self.per_level_scale**lvl) - 1.0
            res = int(math.ceil(scale)) + 1
            # tcnn aligns per-level tables to a multiple of 8 entries.
            dense_size = -(-(res**3) // 8) * 8
            use_hash = dense_size > self.hashmap_size
            if use_hash and promoted < self.extra_dense_levels:
                use_hash = False  # promoted to dense storage
                promoted += 1
            size = self.hashmap_size if use_hash else dense_size
            out.append(
                {"scale": float(scale), "res": res, "use_hash": use_hash,
                 "size": size, "offset": offset}
            )
            offset += size
        return out

    @property
    def total_table_size(self) -> int:
        last = self.level_params()[-1]
        return last["offset"] + last["size"]

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features


def hashgrid_indices_and_weights(spec: HashGridSpec, x01: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather indices and trilinear weights of every level, x01 [N, 3] in
    [0, 1] -> (idx [N, L*8] int32 into the flat table, w [N, L*8] float32),
    column ``level*8 + corner`` (corners in ``CORNERS`` order; nerfjax
    ``hashgrid_indices_and_weights``). A hashed level's index is the uint32
    hash masked to the table size; a dense level's clips each corner
    coordinate to [0, r-1]. The weights are (wx*wy)*wz of the unclamped
    fraction."""
    from nerfjax_torch.ops.hash_encode import _corner_weights, _hash_level_indices

    x, y, z = x01[:, 0], x01[:, 1], x01[:, 2]
    levels = spec.level_params()
    hashed = [lp for lp in levels if lp["use_hash"]]
    hidx = _hash_level_indices(spec, hashed, x, y, z) if hashed else []  # per corner [Lh, N]
    idx, h = [], 0
    for lp in levels:
        if lp["use_hash"]:
            idx.append(torch.stack([hidx[c][h] for c in range(8)]) + hashed[0]["offset"])
            h += 1
            continue
        r, s = lp["res"], torch.tensor(lp["scale"], dtype=torch.float32, device=x.device)
        ix, iy, iz = (torch.floor(c * s + 0.5).to(torch.int64) for c in (x, y, z))
        idx.append(torch.stack([
            (ix + dx).clamp(0, r - 1) + (iy + dy).clamp(0, r - 1) * r + (iz + dz).clamp(0, r - 1) * (r * r)
            for dx, dy, dz in CORNERS
        ]) + lp["offset"])
    N, L8 = x01.shape[0], 8 * len(levels)
    w = torch.stack(_corner_weights(levels, x, y, z), dim=1)  # [L, 8, N]
    return (torch.stack(idx).permute(2, 0, 1).reshape(N, L8).to(torch.int32),
            w.permute(2, 0, 1).reshape(N, L8).contiguous())


def _to01(c: torch.Tensor) -> torch.Tensor:
    return ((c + 1.0) * 0.5).clamp(0.0, 1.0)


class InstantNGP(nn.Module):
    """NGP field; ``nerf_type`` in {small, medium, large} selects 2^{15,17,19}
    hash entries per hashed level."""

    def __init__(
        self,
        nerf_type: str = "small",
        n_levels: int = 16,
        n_features: int = 2,
        base_resolution: int = 16,
        per_level_scale: float = 1.5,
        hidden: int = 64,
        geo_feat_dim: int = 16,
        extra_dense_levels: int = 0,
        grad_corners: int = 8,
        fwd_corners: int = 8,
        grad_levels: int = 0,
        dense_corners: int = 8,
        dense_grad_levels: int = 0,
        device: torch.device | str = "cpu",
    ):
        super().__init__()
        if nerf_type not in NERF_TYPE_LOG2:
            raise ValueError(
                f"Unknown nerf_type={nerf_type!r}; expected one of {sorted(NERF_TYPE_LOG2)}"
            )
        self.nerf_type = nerf_type
        self.hidden = hidden
        self.geo_feat_dim = geo_feat_dim
        self.spec = HashGridSpec(
            n_levels=n_levels,
            n_features=n_features,
            log2_hashmap_size=NERF_TYPE_LOG2[nerf_type],
            base_resolution=base_resolution,
            per_level_scale=per_level_scale,
            grad_corners=grad_corners,
            fwd_corners=fwd_corners,
            dense_corners=dense_corners,
            grad_levels=grad_levels,
            dense_grad_levels=dense_grad_levels,
            extra_dense_levels=extra_dense_levels,
        )
        self.extra_dense_levels = extra_dense_levels
        f32 = dict(dtype=torch.float32, device=device)
        self.table = nn.Parameter(
            torch.empty(n_features, self.spec.total_table_size, **f32), requires_grad=False
        )
        dims = self.mlp_dims()
        self.dmlp = nn.ParameterList(
            [nn.Parameter(torch.empty(i, o, **f32), requires_grad=False) for i, o in dims["dmlp"]]
        )
        self.cmlp = nn.ParameterList(
            [nn.Parameter(torch.empty(i, o, **f32), requires_grad=False) for i, o in dims["cmlp"]]
        )
        self._packed: dict = {}  # (dtype, device) -> the fused kernels' weight buffer

    def mlp_dims(self) -> dict[str, list[tuple[int, int]]]:
        """[in, out] of every MLP layer (nerfjax ``checkpoint._mlp_dims``)."""
        enc, hid, geo = self.spec.output_dim, self.hidden, self.geo_feat_dim
        return {
            "dmlp": [(enc, hid), (hid, geo)],
            "cmlp": [(geo + 16, hid), (hid, hid), (hid, 3)],
        }

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "InstantNGP":
        """tcnn's init: table uniform in [-1e-4, 1e-4], He-uniform MLPs.
        Draws on the CPU from ``generator``, then copies to the field's device."""
        def uniform(shape, bound):
            u = torch.rand(shape, generator=generator, dtype=torch.float32)
            return (u * 2.0 - 1.0) * bound

        self.table.copy_(uniform(self.table.shape, 1e-4))
        for w in list(self.dmlp) + list(self.cmlp):
            fan_in, fan_out = w.shape
            w.copy_(uniform(w.shape, math.sqrt(6.0 / (fan_in + fan_out))))
        self._packed.clear()
        return self

    def params(self) -> dict:
        """The weights as nerfjax's param dict: {"table", "dmlp": [{"w"}], "cmlp": [...]}."""
        return {
            "table": self.table,
            "dmlp": [{"w": w} for w in self.dmlp],
            "cmlp": [{"w": w} for w in self.cmlp],
        }

    @torch.no_grad()
    def load_params(self, params: dict) -> "InstantNGP":
        """Copy a nerfjax-layout param dict of tensors into the field."""
        self.table.copy_(params["table"])
        for name in ("dmlp", "cmlp"):
            mine = getattr(self, name)
            if len(params[name]) != len(mine):
                raise ValueError(f"{name}: {len(params[name])} layers, expected {len(mine)}")
            for w, layer in zip(mine, params[name]):
                w.copy_(layer["w"])
        self._packed.clear()
        return self

    def packed_weights(self, dtype: torch.dtype) -> torch.Tensor:
        """The fused kernels' weight buffer for ``dtype``, packed once after
        each ``init``/``load_params`` (weights changed otherwise need one)."""
        from nerfjax_torch.ops.fused_mlp import pack_weights

        key = (dtype, self.table.device)
        if key not in self._packed:
            self._packed[key] = pack_weights(self.params(), dtype, self.table.device)
        return self._packed[key]

    def num_params(self) -> int:
        """The parameters' element count (table and both MLPs)."""
        return sum(p.numel() for p in self.parameters())

    # -- the point-major path: positions and directions as [N, 3] ----------

    def query_density(self, pos: torch.Tensor, **_) -> tuple[torch.Tensor, torch.Tensor]:
        """pos [N, 3] in [-1, 1] -> (sigma [N, 1], features [N, 16]): sigma is
        the first channel of the ReLU'd density-MLP output. Extra keyword
        arguments (nerfjax's ``rng``, ``train``) are accepted and ignored."""
        from nerfjax_torch.ops.hash_encode import hashgrid_encode

        h = hashgrid_encode(self.spec, self.table, _to01(pos))
        for w in self.dmlp:
            h = torch.relu(torch.matmul(h, w))
        return h[:, :1], h

    def apply(self, pos: torch.Tensor, view: torch.Tensor, **_) -> tuple[torch.Tensor, torch.Tensor]:
        """pos, view [N, 3] -> (rgb [N, 3], sigma [N, 1])."""
        from nerfjax_torch.fields.encodings import sh4_encode

        sigma, feat = self.query_density(pos)
        h = torch.cat([feat, sh4_encode(view).to(feat.dtype)], dim=-1)
        for w in self.cmlp[:-1]:
            h = torch.relu(torch.matmul(h, w))
        return torch.sigmoid(torch.matmul(h, self.cmlp[-1])), sigma

    # -- feature-major paths: positions/directions as three [N] vectors,
    # activations as [C, N] -------------------------------------------------

    def encode(self, pos3, dtype: torch.dtype) -> torch.Tensor:
        from nerfjax_torch.ops.hash_encode import hash_encode_planar

        x, y, z = (_to01(c) for c in pos3)
        return hash_encode_planar(self.spec, self.table, x, y, z, dtype=dtype)

    def query_density_planar(self, pos3, *, dtype=torch.bfloat16):
        """(px,py,pz) [N] in [-1,1] -> (sigma [N], features [16, N]); unfused,
        matmuls in ``dtype`` as nerfjax's XLA path, differentiable in the
        table and the weights."""
        h = self.encode(pos3, dtype)
        for w in self.dmlp[:-1]:
            h = torch.relu(torch.matmul(w.T.to(dtype), h))
        feat = torch.relu(torch.matmul(self.dmlp[-1].T.to(dtype), h))
        return feat[0], feat

    def apply_planar(self, pos3, view3, *, dtype=torch.bfloat16):
        """Unfused feature-major forward -> (rgb [3, N], sigma [N])."""
        from nerfjax_torch.fields.encodings import sh4_encode_planar

        sigma, feat = self.query_density_planar(pos3, dtype=dtype)
        h = torch.cat([feat, sh4_encode_planar(*view3).to(dtype)], dim=0)
        for w in self.cmlp[:-1]:
            h = torch.relu(torch.matmul(w.T.to(dtype), h))
        rgb = torch.sigmoid(torch.matmul(self.cmlp[-1].T.to(dtype), h))
        return rgb, sigma

    def apply_planar_fused(self, pos3, view3, *, dtype=torch.bfloat16):
        """Forward through the fused MLP head kernel -> (rgb [3, N], sigma [N])."""
        from nerfjax_torch.fields.encodings import sh4_encode_planar
        from nerfjax_torch.ops.fused_mlp import fused_ngp_head

        enc = self.encode(pos3, dtype)
        sh = sh4_encode_planar(*view3).to(dtype)
        return fused_ngp_head(self.params(), enc, sh, packed=self.packed_weights(dtype))

    def query_density_planar_fused(self, pos3, *, dtype=torch.bfloat16) -> torch.Tensor:
        """sigma [N] through the density-only kernel, bit-identical to the
        sigma of ``apply_planar_fused``."""
        from nerfjax_torch.ops.fused_mlp import fused_ngp_density

        return fused_ngp_density(
            self.params(), self.encode(pos3, dtype), packed=self.packed_weights(dtype)
        )
