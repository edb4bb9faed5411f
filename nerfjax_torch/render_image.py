"""Full-frame rendering and held-out PSNR (counterpart of
``nerfjax/render_image.py``): ``render_image`` renders one frame with the
coarse->pdf->fine sampler (``train=False``: on a card every field pass runs
the fused head kernel), ``orbit_poses`` makes turntable poses, and
``eval_psnr`` scores the frames of a transforms JSON against their images.

Random numbers: nerfjax folds each chunk's start into the frame's key
(``fold_in(key, s)``, ``PRNGKey(i)`` for frame i of ``eval_psnr``). Here a
``torch.Generator`` is seeded from (seed, chunk start) for each chunk, or
the caller's ``draws(chunk_start, B)`` hook supplies the chunk's
``(u_strat [B, n_samples], u_pdf [B, n_importance])`` (the parity tests hand
over nerfjax's). The last chunk is padded with copies of the first hit
pixel's ray, as nerfjax pads it, so every chunk has ``chunk_rays`` rays.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import numpy as np
import torch

from nerfjax_torch import tracing
from nerfjax_torch.rays import get_rays, ray_cube_intersection
from nerfjax_torch.render import render_rays_planar

_frame_ids = itertools.count(1)  # the id of each ``render.frame`` span: the frame's number in this process


def render_image(
    field,
    K: np.ndarray,
    c2w: np.ndarray,
    H: int,
    W: int,
    *,
    n_samples: int = 64,
    n_importance: int = 128,
    white_bg: bool = False,
    chunk_rays: int = 16384,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    draws=None,
) -> np.ndarray:
    """Render one [H, W, 3] float32 frame of ``field`` (on its own device)
    from a camera pose; pixels whose rays miss the [-1, 1]^3 cube get the
    background color."""
    dev = next(field.parameters()).device
    with tracing.unit("render.frame", next(_frame_ids)) as frame:
        with tracing.span("render.rays"):
            with tracing.span("wait.upload"):
                pose = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
            rays_o, rays_d = get_rays(H, W, K, pose[None])
            ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
            hit, tn, tf = ray_cube_intersection(ro, rd)
            out = torch.full((H * W, 3), 1.0 if white_bg else 0.0, dtype=torch.float32, device=dev)
        with tracing.span("wait.hit_rays"):
            idx = torch.nonzero(hit).squeeze(1)
        n_hit = idx.shape[0]
        n_pad = -(-n_hit // chunk_rays) * chunk_rays
        frame.count("hit_rays", n_hit)
        frame.count("rays", n_pad)
        frame.count("chunks", n_pad // chunk_rays)
        if n_hit:
            idx_pad = torch.cat([idx, idx[:1].expand(n_pad - n_hit)])
            rendered = torch.empty(n_pad, 3, dtype=torch.float32, device=dev)
            gen = torch.Generator(device=dev)
            with torch.no_grad():
                for s in range(0, n_pad, chunk_rays):
                    with tracing.span("render.chunk", s):
                        sel = idx_pad[s : s + chunk_rays]
                        u_strat = u_pdf = None
                        if draws is None:
                            gen.manual_seed(seed * 1_000_003 + s)
                        else:
                            u_strat, u_pdf = (torch.as_tensor(u, dtype=torch.float32, device=dev)
                                              for u in draws(s, chunk_rays))
                        rendered[s : s + chunk_rays] = render_rays_planar(
                            field, field, ro[sel], rd[sel], tn[sel], tf[sel], n_samples, n_importance,
                            white_bg=white_bg, train=False, dtype=dtype, u_strat=u_strat, u_pdf=u_pdf, generator=gen,
                        )["rgb_fine"]
            out[idx] = rendered[:n_hit]
        with tracing.span("wait.frame_to_host"):
            return out.reshape(H, W, 3).cpu().numpy()


def orbit_poses(n: int, *, radius: float = 2.5, height: float = 1.2, target: np.ndarray | None = None) -> np.ndarray:
    """[n, 4, 4] OpenGL c2w look-at poses on a horizontal circle around the
    scene (camera looks down -Z, +Z world up, as the transforms JSON)."""
    target = np.zeros(3) if target is None else np.asarray(target, np.float64)
    poses = np.empty((n, 4, 4), np.float32)
    for i in range(n):
        ang = 2 * np.pi * i / n
        cam = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        fwd = target - cam
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        if np.linalg.norm(right) < 1e-8:  # looking straight up/down
            right = np.array([1.0, 0.0, 0.0])
        right = right / np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = true_up
        c2w[:3, 2] = -fwd
        c2w[:3, 3] = cam
        poses[i] = c2w
    return poses


def eval_psnr(
    field,
    transforms_path: str | Path,
    *,
    n_frames: int | None = None,
    n_samples: int = 64,
    n_importance: int = 128,
    white_bg: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    verbose: bool = True,
    draws=None,
) -> dict:
    """Render frames of a transforms JSON (frame i seeded with i) and report
    PSNR against their images: {"psnr_mean", "psnr_per_frame"}. ``draws(i,
    chunk_start, B)``, when given, is frame i's ``render_image`` hook."""
    from PIL import Image

    with open(transforms_path, "r") as f:
        meta = json.load(f)
    H, W = int(meta["h"]), int(meta["w"])
    K = np.array(meta["K"], np.float32)
    frames = meta["frames"][:n_frames] if n_frames else meta["frames"]
    psnrs = []
    for i, frame in enumerate(frames):
        gt = np.asarray(Image.open(frame["file_path"]).convert("RGB"), np.float32) / 255.0
        hook = None if draws is None else (lambda s, B, i=i: draws(i, s, B))
        pred = render_image(field, K, np.array(frame["transform_matrix"], np.float32), H, W,
                            n_samples=n_samples, n_importance=n_importance, white_bg=white_bg,
                            seed=i, dtype=dtype, draws=hook)
        psnr = -10.0 * np.log10(max(float(np.mean((pred - gt) ** 2)), 1e-12))
        psnrs.append(psnr)
        if verbose:
            print(f"frame {i}: PSNR {psnr:.2f}")
    result = {"psnr_mean": float(np.mean(psnrs)), "psnr_per_frame": psnrs}
    if verbose:
        print(f"mean PSNR over {len(psnrs)} frames: {result['psnr_mean']:.2f}")
    return result
