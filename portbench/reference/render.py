"""Hierarchical volume rendering, plain (NeRF, Mildenhall et al. 2020 §5.2):
64 stratified depths through the coarse field, 128 importance depths drawn
from its inner weights (+1e-5 each) by inverse transform, all 192 sorted
through the fine field, alpha compositing with the last distance 1e10.
The uniforms are the benchmark's, handed to the program too. Float32."""

from __future__ import annotations

import torch


def linspace01(n: int, device) -> torch.Tensor:
    """i * f32(1/(n-1)), the end point exactly 1."""
    step = float(torch.tensor(1.0) / torch.tensor(float(n - 1)))
    t = torch.arange(n, dtype=torch.float32, device=device) * step
    t[-1] = 1.0
    return t


def stratified_z(near, far, n: int, u: torch.Tensor) -> torch.Tensor:
    """[B, n] depths linear in [near, far], each jittered by u within its
    mid-point bin."""
    t = linspace01(n, near.device)[None, :]
    near, far = near.reshape(-1, 1), far.reshape(-1, 1)
    z = near * (1.0 - t) + far * t
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], dim=1)
    lower = torch.cat([z[:, :1], mids], dim=1)
    return lower + (upper - lower) * u


def composite(rgb: torch.Tensor, sigma: torch.Tensor, z: torch.Tensor, dist_last: float = 1e10):
    """rgb [B, S, 3], sigma [B, S], z [B, S] -> (rgb_map [B, 3], weights [B, S])."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], dist_last)], dim=1)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], dim=1), dim=1)[:, :-1]
    w = alpha * trans
    return torch.sum(w[..., None] * rgb, dim=1), w


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-transform depths [B, n] of the piecewise-constant pdf over the
    bin edges [B, M] with weights [B, M-1] (+1e-5), at the uniforms u [B, n]."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=1)], dim=1)
    M = cdf.shape[1]
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below, above = (inds - 1).clamp(0, M - 1), inds.clamp(0, M - 1)
    cdf_b, cdf_a = cdf.gather(1, below), cdf.gather(1, above)
    bins_b, bins_a = bins.gather(1, below), bins.gather(1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def render_rays(coarse, fine, rays_o, rays_d, near, far, u_strat, u_pdf, noise_c=None, noise_f=None):
    """The two-pass render of a ray batch. ``coarse``/``fine``:
    (pos [N, 3], view [N, 3], noise [N] or None) -> (rgb [N, 3], sigma [N]).
    Returns {"rgb_coarse", "rgb_fine"} [B, 3] and the depths of both passes,
    {"z_coarse"} [B, S] and {"z_fine"} [B, S + I]."""
    B = rays_o.shape[0]

    def run(field, z, noise):
        S = z.shape[1]
        pos = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
        view = rays_d[:, None, :].expand(B, S, 3).reshape(-1, 3)
        rgb, sigma = field(pos, view, noise)
        return composite(rgb.reshape(B, S, 3), sigma.reshape(B, S), z)

    z = stratified_z(near, far, u_strat.shape[1], u_strat)
    rgb_c, w = run(coarse, z, noise_c)
    z_imp = sample_pdf(0.5 * (z[:, :-1] + z[:, 1:]), w[:, 1:-1].detach(), u_pdf).detach()
    z_all = torch.sort(torch.cat([z, z_imp], dim=1), dim=1).values
    rgb_f, _ = run(fine, z_all, noise_f)
    return {"rgb_coarse": rgb_c, "rgb_fine": rgb_f, "z_coarse": z.detach(), "z_fine": z_all}
