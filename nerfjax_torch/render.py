"""Volume rendering of a ray batch (counterpart of ``nerfjax/render.py``:
``stratified_sample`` :17-51, ``sample_pdf`` :54-93, ``merge_z_vals``
:96-109, ``raw2outputs_planar`` :151-176 and ``render_rays_planar``
:178-304).

Positions flow as three [N] component vectors and activations as [C, N], as
in nerfjax. Compositing runs in float32 whatever the field's dtype. Two
renders: single pass (all samples from the occupancy CDF, one field pass,
instant-ngp's design) and coarse->pdf->fine (stratified or occupancy
samples through the coarse field, importance samples from its weights,
all of them through the fine field; the reference's sampler).

Random numbers: nerfjax draws from ``jax.random`` keys; here every draw is
an optional argument (the parity tests hand over nerfjax's uniforms), drawn
from a ``torch.Generator`` when absent. Sums along a ray are sequential
float32 additions (``running_sum``), so a CPU run and a card run of a
sampler give the same depths from the same weights.
"""

from __future__ import annotations

import torch

from nerfjax_torch.ops.occupancy import OccupancyGridSpec, linspace01, occupancy_sample, running_sum


def stratified_z(near, far, n_samples: int, u: torch.Tensor) -> torch.Tensor:
    """z [B, S]: S depths linear in [near, far], each jittered by u [B, S]
    within its mid-point bin."""
    t = linspace01(n_samples, near.device)[None, :]
    near, far = near.reshape(-1, 1), far.reshape(-1, 1)
    z = near * (1.0 - t) + far * t
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    return lower + (upper - lower) * u


def stratified_sample(rays_o, rays_d, near, far, n_samples: int, *, u=None, generator=None):
    """Jittered linear-in-depth samples -> (pts [B, S, 3], z_vals [B, S]).
    ``u`` [B, S] uniforms in [0, 1) are drawn from ``generator`` when None."""
    if u is None:
        u = torch.rand(rays_o.shape[0], n_samples, generator=generator, device=rays_o.device)
    z = stratified_z(near, far, n_samples, u)
    return rays_o[:, None, :] + rays_d[:, None, :] * z[..., None], z


def sample_pdf(bins, weights, n_samples: int, *, u=None, generator=None) -> torch.Tensor:
    """Inverse-transform samples [B, n_samples] of the piecewise-constant
    PDF over bin edges ``bins`` [B, M] with ``weights`` [B, M-1] >= 0
    (1e-5 added to each, as nerfjax does). ``u`` [B, n_samples] uniforms
    are drawn from ``generator`` when None. Differentiable in ``bins``;
    callers detach where nerfjax stops the gradient."""
    weights = weights + 1e-5
    pdf = weights / running_sum(weights)[..., -1:]
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), running_sum(pdf)], dim=-1)  # [B, M]
    if u is None:
        u = torch.rand(*cdf.shape[:-1], n_samples, generator=generator, device=cdf.device)
    M = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (inds - 1).clamp(0, M - 1)
    above = inds.clamp(0, M - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_b, bins_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def merge_z_vals(rays_o, rays_d, z_coarse, z_importance):
    """Sort-merge coarse and importance depths -> (pts [B, S+I, 3],
    z_vals [B, S+I])."""
    z = torch.sort(torch.cat([z_coarse, z_importance], dim=-1), dim=-1).values
    return rays_o[:, None, :] + rays_d[:, None, :] * z[..., None], z


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
    field_coarse,
    field_fine,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t_near: torch.Tensor,
    t_far: torch.Tensor,
    n_samples: int,
    n_importance: int,
    *,
    white_bg: bool = False,
    train: bool = False,
    dist_last: float = 1e10,
    dtype: torch.dtype = torch.bfloat16,
    occ_spec: OccupancyGridSpec | None = None,
    occ_grid: torch.Tensor | None = None,
    single_pass: bool = False,
    u_strat: torch.Tensor | None = None,
    u_pdf: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Feature-major render of a ray batch.

    The first depths come from the occupancy CDF when ``occ_spec`` and
    ``occ_grid`` are given, else from stratified sampling; ``u_strat``
    [B, n_first] are their uniforms (nerfjax's ``k_strat`` draw; n_first =
    n_samples + n_importance under ``single_pass``, else n_samples).
    ``single_pass`` evaluates only the fine field at them; ``rgb_coarse``/
    ``weights_coarse`` alias the fine outputs with the gradient stopped.
    Otherwise the coarse field runs at them, ``sample_pdf`` draws
    n_importance depths (uniforms ``u_pdf`` [B, n_importance], nerfjax's
    ``k_pdf`` draw) from its weights without gradient, and the fine field
    runs at all n_samples + n_importance depths sorted. With ``train`` the
    fields run ``apply_planar`` (differentiable), without it
    ``apply_planar_fused`` (the fused head kernel on a card).
    """
    B = rays_o.shape[0]
    n_first = n_samples + n_importance if single_pass else n_samples
    if u_strat is None:
        u_strat = torch.rand(B, n_first, generator=generator, device=rays_o.device)
    if occ_spec is not None and occ_grid is not None:
        z = occupancy_sample(occ_spec, occ_grid, rays_o, rays_d, t_near, t_far, n_first, xi=u_strat)
    else:
        z = stratified_z(t_near, t_far, n_first, u_strat)

    def eval_field(field, z):
        S = z.shape[-1]
        pos3 = tuple((rays_o[:, i, None] + rays_d[:, i, None] * z).reshape(-1) for i in range(3))
        view3 = tuple(rays_d[:, i, None].expand(B, S).reshape(-1) for i in range(3))
        apply = field.apply_planar if train else field.apply_planar_fused
        rgb, sigma = apply(pos3, view3, dtype=dtype)
        return rgb.reshape(3, B, S), sigma.reshape(B, S)

    if single_pass:
        rgb_map, weights = raw2outputs_planar(*eval_field(field_fine, z), z, white_bg, dist_last)
        return {"rgb_coarse": rgb_map.detach(), "rgb_fine": rgb_map, "weights_coarse": weights.detach(),
                "weights_fine": weights, "z_vals": z}

    rgb_map_c, weights_c = raw2outputs_planar(*eval_field(field_coarse, z), z, white_bg, dist_last)
    z_mid = 0.5 * (z[..., :-1] + z[..., 1:])
    z_imp = sample_pdf(z_mid, weights_c[..., 1:-1].detach(), n_importance, u=u_pdf, generator=generator)
    z_comb = torch.sort(torch.cat([z, z_imp], dim=-1), dim=-1).values
    rgb_map_f, weights_f = raw2outputs_planar(*eval_field(field_fine, z_comb), z_comb, white_bg, dist_last)
    return {"rgb_coarse": rgb_map_c, "rgb_fine": rgb_map_f, "weights_coarse": weights_c,
            "weights_fine": weights_f, "z_vals": z_comb}
