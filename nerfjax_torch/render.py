"""Volume rendering of a ray batch for training (counterpart of
``nerfjax/render.py``: ``raw2outputs_planar`` :151-176 and the single-pass
branch of ``render_rays_planar`` :178-285).

Positions flow as three [N] component vectors and activations as [C, N], as
in nerfjax. Compositing runs in float32 whatever the field's dtype. Only
the single-pass occupancy path (all samples from the occupancy CDF, one
field pass, instant-ngp's design) is ported; the coarse->pdf->fine twin is
ROADMAP Queue 1 item 'the coarse->pdf->fine exact twin'.
"""

from __future__ import annotations

import torch

from nerfjax_torch.ops.occupancy import OccupancyGridSpec, occupancy_sample


def raw2outputs_planar(rgb, sigma, z_vals, white_bg: bool = False, dist_last: float = 1e10):
    """rgb [3, B, S], sigma [B, S], z_vals [B, S] -> (rgb_map [B, 3],
    weights [B, S]), in float32."""
    sigma = sigma.to(torch.float32)
    rgb = rgb.to(torch.float32)
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], dist_last)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1), dim=-1
    )[..., :-1]
    weights = alpha * trans
    rgb_map = torch.einsum("bs,cbs->bc", weights, rgb)
    if white_bg:
        rgb_map = rgb_map + (1.0 - weights.sum(dim=-1)[..., None])
    return rgb_map, weights


def render_rays_planar(
    field,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t_near: torch.Tensor,
    t_far: torch.Tensor,
    n_samples: int,
    n_importance: int,
    *,
    occ_spec: OccupancyGridSpec,
    occ_grid: torch.Tensor,
    white_bg: bool = False,
    dist_last: float = 1e10,
    dtype: torch.dtype = torch.bfloat16,
    single_pass: bool = True,
    xi: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Single-pass render: n_samples + n_importance depths per ray from the
    occupancy CDF (``xi`` as ``occupancy_sample`` takes it), one pass of the
    field, compositing. ``rgb_coarse``/``weights_coarse`` alias the fine
    outputs with the gradient stopped, as nerfjax's do."""
    if not single_pass:
        raise NotImplementedError(
            "the coarse->pdf->fine render (single_pass: false) is not ported yet "
            "(ROADMAP Queue 1 item 'the coarse->pdf->fine exact twin')"
        )
    B = rays_o.shape[0]
    S = n_samples + n_importance
    z = occupancy_sample(occ_spec, occ_grid, rays_o, rays_d, t_near, t_far, S, xi=xi, generator=generator)
    pos3 = tuple((rays_o[:, i, None] + rays_d[:, i, None] * z).reshape(-1) for i in range(3))
    view3 = tuple(rays_d[:, i, None].expand(B, S).reshape(-1) for i in range(3))
    rgb, sigma = field.apply_planar(pos3, view3, dtype=dtype)
    rgb_map, weights = raw2outputs_planar(rgb.reshape(3, B, S), sigma.reshape(B, S), z, white_bg, dist_last)
    return {
        "rgb_coarse": rgb_map.detach(),
        "rgb_fine": rgb_map,
        "weights_coarse": weights.detach(),
        "weights_fine": weights,
        "z_vals": z,
    }
