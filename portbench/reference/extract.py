"""The hierarchical 512^3 extraction, plain: sigma at every 4^3 cell's corner
point of a 128^3 grid over [-1, 1]^3, Otsu's threshold of those (256 bins
over [min, max], the center of the bin of largest between-class variance),
cells above a quarter of it marked and dilated by one cell, the 64 voxels
of each marked cell queried for sigma and color (view (0, 0, -1)), every
other voxel keeping its cell's sigma, Otsu again over the whole volume,
occupancy = sigma above it, color (rounded to uint8) kept where occupied.
Float32, or the control's fp8 operands."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.fields import ngp_apply, ngp_density, ngp_levels

CELL = 4
CHUNK = 1 << 21  # points a query


def otsu(values: torch.Tensor) -> float:
    v = values.reshape(-1).to(torch.float32)
    vmin, vmax = v.min(), v.max()
    span = torch.clamp_min(vmax - vmin, 1e-12)
    idx = ((v - vmin) / span * 256).to(torch.int64).clamp(0, 255)
    hist = torch.bincount(idx, minlength=256).to(torch.float64)
    centers = vmin + (torch.arange(256, dtype=torch.float32, device=v.device) + 0.5) * (span / 256)
    c64 = centers.to(torch.float64)
    w1 = torch.cumsum(hist, 0)
    w2 = hist.sum() - w1 + hist
    m1 = torch.cumsum(hist * c64, 0) / w1.clamp_min(1e-12)
    m2 = (torch.flip(torch.cumsum(torch.flip(hist * c64, [0]), 0), [0])) / w2.clamp_min(1e-12)
    var = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return float(centers[torch.argmax(var)])


def dilate(mask: torch.Tensor) -> torch.Tensor:
    """One-cell 3^3 binary dilation of a [C, C, C] bool mask."""
    m = mask.to(torch.float32)[None, None]
    return torch.nn.functional.max_pool3d(m, 3, stride=1, padding=1)[0, 0] > 0


def extract(cfg: dict, params: dict, res: int = 512, bounds=(-1.0, 1.0), prec: str = "f32") -> dict:
    """{"occupancy" [R^3] uint8, "rgb" [R^3, 3] uint8 (0 where empty),
    "threshold", "marked", "stats" (the sigma volume's mean and std)} on the table's device."""
    levels = ngp_levels(cfg)
    dev = params["table"].device
    lo, hi = bounds
    C = res // CELL
    view = torch.tensor([[0.0, 0.0, -1.0]], device=dev)
    with torch.no_grad():
        g = torch.from_numpy(np.linspace(lo, hi, C, dtype=np.float32)).to(dev)
        cell_sigma = torch.empty(C**3, device=dev)
        pts = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        for s in range(0, pts.shape[0], CHUNK):
            cell_sigma[s : s + CHUNK] = ngp_density(params, pts[s : s + CHUNK], levels, prec)[0]
        cell_sigma = cell_sigma.reshape(C, C, C)
        marked = dilate(cell_sigma > 0.25 * otsu(cell_sigma))
        sigma = cell_sigma.repeat_interleave(CELL, 0).repeat_interleave(CELL, 1).repeat_interleave(CELL, 2)
        sigma = sigma.reshape(-1).clone()
        rgb = torch.zeros(res**3, 3, dtype=torch.uint8, device=dev)
        step = np.float32((hi - lo) / (res - 1))
        coords = torch.from_numpy(np.float32(lo) + np.arange(res, dtype=np.float32) * step).to(dev)
        cells = torch.nonzero(marked)
        ar = torch.arange(CELL, device=dev)
        off = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1).reshape(-1, 3)
        per = CHUNK // CELL**3
        for s in range(0, cells.shape[0], per):
            vox = (cells[s : s + per, None, :] * CELL + off[None]).reshape(-1, 3)
            pos = coords[vox]
            c, sg = ngp_apply(params, pos, view.expand(pos.shape[0], 3), levels, prec)
            flat = (vox[:, 0] * res + vox[:, 1]) * res + vox[:, 2]
            sigma[flat] = sg
            rgb[flat] = torch.round(c * 255.0).clamp(0, 255).to(torch.uint8)
        thr = otsu(sigma)
        occ = (sigma > thr).to(torch.uint8)
        rgb = rgb * occ[:, None]
    stats = {"mean": float(sigma.mean()), "std": float(sigma.std(correction=0))}
    return {"occupancy": occ, "rgb": rgb, "threshold": thr, "marked": int(cells.shape[0]), "stats": stats}
