"""Occupancy-grid sampling (counterpart of ``nerfjax/ops/occupancy.py:33-224``).

A dense density grid (128^3 by default) kept as an EMA of field queries at
jittered cell centers, per-ray piecewise-constant weights over uniform
segments, and two samplers over them: the stratified arithmetic inverse-CDF
(``occ_fast_cdf: true``) and the reference-shaped one (``fast_cdf: false``:
``render.sample_pdf`` over the segment weights, then a sort).

Random numbers: nerfjax draws the cell jitter and the sampler's ``xi`` from
``jax.random``; here they come from a ``torch.Generator``, or the caller
passes them in (the parity tests hand over nerfjax's draws).

Sums along a ray are sequential float32 additions, column by column, so a
CPU run and a card run of the sampler give the same depths bit for bit
(``torch.cumsum`` on the CPU accumulates in double, on the card in its own
order). XLA's own cumsum over 32 segments does not add in order on the CPU,
so the depths agree with nerfjax's to within float32 rounding (1e-6), not
bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OccupancyGridSpec:
    resolution: int = 128
    decay: float = 0.95
    update_every: int = 16
    threshold: float = 1e-2
    floor: float = 0.02  # uniform exploration mass per segment
    n_segments: int = 128  # piecewise-constant resolution along each ray
    update_partitions: int = 1  # refresh 1/P of the cells per update (rotating)
    fast_cdf: bool = False


def init_grid(spec: OccupancyGridSpec, device="cpu") -> torch.Tensor:
    """Start fully occupied so early training samples everywhere."""
    return torch.ones(spec.resolution**3, dtype=torch.float32, device=device)


def draw_update_jitter(spec: OccupancyGridSpec, generator: torch.Generator, device) -> torch.Tensor:
    """[3, n] uniforms in [-0.5, 0.5): one jitter per axis for each of the
    n = resolution^3 / update_partitions cells an update refreshes."""
    n = spec.resolution**3 // spec.update_partitions
    return torch.rand(3, n, generator=generator, device=device) - 0.5


def update_grid(
    spec: OccupancyGridSpec,
    grid: torch.Tensor,
    field,
    phase: int = 0,
    *,
    jitter: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """EMA density refresh: grid <- max(decay*grid, sigma(jittered centers)).

    With update_partitions = P > 1 only the cells {lin : lin % P == phase}
    are queried; every cell decays. ``jitter`` [3, n] in [-0.5, 0.5) (in
    cell units) is drawn from ``generator`` when None. ``field`` is the
    training field: built with ``train=True`` its hashed levels run the
    k = 1 forward here too, as nerfjax's do (occupancy.py:106).
    """
    r = spec.resolution
    P = int(spec.update_partitions)
    if r**3 % P:
        raise ValueError(f"update_partitions={P} must divide resolution^3")
    n = r**3 // P
    dev = grid.device
    if jitter is None:
        jitter = draw_update_jitter(spec, generator, dev)
    if jitter.shape != (3, n):
        raise ValueError(f"jitter must be [3, {n}], got {tuple(jitter.shape)}")
    cell = 2.0 / r
    centers = (torch.arange(r, dtype=torch.float32, device=dev) + 0.5) * cell - 1.0
    ph = int(phase) % P
    lin = torch.arange(n, dtype=torch.int64, device=dev) * P + ph
    ix, iy, iz = lin % r, (lin // r) % r, lin // (r * r)
    pos3 = tuple(centers[i] + j * cell for i, j in zip((ix, iy, iz), jitter))
    with torch.no_grad():
        sigma, _ = field.query_density_planar(pos3, dtype=dtype)
    sigma = sigma.to(torch.float32)
    decayed = grid * spec.decay
    if P == 1:
        return torch.maximum(decayed, sigma)
    g2 = decayed.reshape(n, P)
    g2[:, ph] = torch.maximum(g2[:, ph], sigma)
    return g2.reshape(-1)


def linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in float32 bit for bit: i times the float32
    reciprocal of n - 1 (XLA turns the division by a constant into that
    product), then the end point 1. ``torch.linspace`` computes its upper
    half from the end and differs in the last bit for many n."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = float(np.float32(1.0) / np.float32(n - 1))
    t = torch.arange(n, dtype=torch.float32, device=device) * step
    t[-1] = 1.0
    return t


def _grid_lookup(spec: OccupancyGridSpec, grid, px, py, pz):
    """Density at positions in [-1, 1] (nearest cell)."""
    r = spec.resolution

    def to_idx(p):
        return ((p + 1.0) * 0.5 * r).to(torch.int64).clamp(0, r - 1)

    return grid[to_idx(px) + to_idx(py) * r + to_idx(pz) * (r * r)]


def segment_weights(spec: OccupancyGridSpec, grid, rays_o, rays_d, t_near, t_far):
    """Per-ray piecewise weights over n_segments uniform bins ->
    (bin_edges [B, M+1], weights [B, M])."""
    B, M = rays_o.shape[0], spec.n_segments
    near, far = t_near.reshape(-1, 1), t_far.reshape(-1, 1)
    t = linspace01(M + 1, rays_o.device)[None, :]
    edges = near * (1.0 - t) + far * t
    mid = 0.5 * (edges[:, 1:] + edges[:, :-1])
    px = rays_o[:, 0:1] + rays_d[:, 0:1] * mid
    py = rays_o[:, 1:2] + rays_d[:, 1:2] * mid
    pz = rays_o[:, 2:3] + rays_d[:, 2:3] * mid
    occ = _grid_lookup(spec, grid, px.reshape(-1), py.reshape(-1), pz.reshape(-1)).reshape(B, M)
    w = (occ > spec.threshold).to(torch.float32) + spec.floor
    return edges, w


def running_sum(a: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along the last axis, added column by column in order."""
    cols = [a[..., 0]]
    for m in range(1, a.shape[-1]):
        cols.append(cols[-1] + a[..., m])
    return torch.stack(cols, dim=-1)


def _sample_cdf_fast(t_near, t_far, w: torch.Tensor, n_samples: int, xi: torch.Tensor) -> torch.Tensor:
    """Stratified arithmetic inverse-CDF over uniform segment bins
    (nerfjax ``_sample_cdf_fast``): u[s] = (s + xi)/n per ray, the segment
    by compare-sum against the CDF, the depth arithmetic in the segment
    index. xi: [B, n] uniforms in [0, 1). Returns sorted depths [B, n]."""
    B, M = w.shape
    w = w + 1e-5
    pdf = w / running_sum(w)[:, -1:]
    cdf = running_sum(pdf)
    s = torch.arange(n_samples, dtype=torch.float32, device=w.device)[None, :]
    u = (s + xi) * (1.0 / n_samples)
    below = (u[:, :, None] >= cdf[:, None, : M - 1]).sum(dim=-1)  # [B, n] in 0..M-1
    cdf_ext = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    cdf_b = cdf_ext.gather(1, below)
    denom = pdf.gather(1, below)
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    near, far = t_near.reshape(-1, 1), t_far.reshape(-1, 1)
    width = (far - near) * (1.0 / M)
    t = (u - cdf_b) / denom
    z = near + (below.to(torch.float32) + t) * width
    return torch.minimum(torch.maximum(z, near), far)


def occupancy_sample(
    spec: OccupancyGridSpec,
    grid,
    rays_o,
    rays_d,
    t_near,
    t_far,
    n_samples: int,
    *,
    xi: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Occupancy-weighted depths z [B, n_samples], sorted. ``xi``
    [B, n_samples] uniforms in [0, 1) are drawn from ``generator`` when
    None: the fast sampler's per-stratum offsets, or ``sample_pdf``'s iid
    uniforms (``fast_cdf: false``)."""
    edges, w = segment_weights(spec, grid, rays_o, rays_d, t_near, t_far)
    if xi is None:
        xi = torch.rand(rays_o.shape[0], n_samples, generator=generator, device=rays_o.device)
    if spec.fast_cdf:
        return _sample_cdf_fast(t_near, t_far, w, n_samples, xi)
    from nerfjax_torch.render import sample_pdf

    return torch.sort(sample_pdf(edges, w, n_samples, u=xi), dim=-1).values
