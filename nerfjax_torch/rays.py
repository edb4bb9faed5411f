"""Rays (counterpart of ``nerfjax/rays.py``): pinhole rays for every pixel
(``get_rays`` :56-98), their slab intersection with the [-1, 1]^3 cube
(``ray_cube_intersection`` :24-53), and the ray NPZ (:158-177): five float32
arrays ``rays_o`` [N, 3], ``rays_d`` [N, 3], ``rgbs`` [N, 3], ``t_near`` [N]
and ``t_far`` [N]. Ray precompute from posed images is ROADMAP Queue 1 item
'ray precompute'.

Everything is float32 on the device of the poses, so a frame's rays come out
where the field that renders them lives.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

RAY_KEYS = ("rays_o", "rays_d", "rgbs", "t_near", "t_far")


def ray_cube_intersection(rays_o: torch.Tensor, rays_d: torch.Tensor, cube_min: float = -1.0,
                          cube_max: float = 1.0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab intersection of rays [N, 3] with the axis-aligned cube ->
    (intersects [N] bool, t_near [N], t_far [N]); direction components below
    1e-8 in magnitude are pinned to +-1e-8 (+1e-8 for an exact zero), and
    t_near is clamped to >= 0, as nerfjax does."""
    eps = 1e-8
    d = torch.where(rays_d.abs() < eps, torch.sign(rays_d) * eps, rays_d)
    d = torch.where(d == 0.0, torch.full_like(d, eps), d)
    t0 = (cube_min - rays_o) / d
    t1 = (cube_max - rays_o) / d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = (t_near <= t_far) & (t_far >= 0.0)
    return hit, t_near.clamp_min(0.0), t_far


def get_rays(H: int, W: int, K, c2w, opencv_to_opengl: bool = True,
             normalize: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Pinhole rays of every pixel of every camera -> (rays_o, rays_d)
    [M, H, W, 3] float32, from the intrinsics K [3, 3] and the
    camera-to-world poses c2w [M, 4, 4] (on c2w's device). The pixel grid is
    ``meshgrid`` in ``xy`` order (u along W); the flip diag(1, -1, -1) turns
    OpenCV pixel rays into the OpenGL/NeRF convention."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    dev = c2w.device
    K_inv = torch.linalg.inv(torch.as_tensor(K, dtype=torch.float32, device=dev))
    u = torch.arange(W, dtype=torch.float32, device=dev)
    v = torch.arange(H, dtype=torch.float32, device=dev)
    uu, vv = torch.meshgrid(u, v, indexing="xy")  # [H, W] each
    pix = torch.stack([uu.reshape(-1), vv.reshape(-1), torch.ones(H * W, dtype=torch.float32, device=dev)])
    dirs = K_inv @ pix  # [3, H*W], camera frame (OpenCV: +z forward)
    if opencv_to_opengl:
        dirs = dirs * torch.tensor([1.0, -1.0, -1.0], device=dev)[:, None]
    if normalize:
        dirs = dirs / torch.linalg.norm(dirs, dim=0, keepdim=True).clamp_min(1e-8)
    rays_d = torch.einsum("mij,jn->min", c2w[:, :3, :3], dirs)  # [M, 3, H*W]
    rays_d = rays_d.transpose(1, 2).reshape(-1, H, W, 3)
    rays_o = c2w[:, None, None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def save_ray_data(data: dict[str, np.ndarray], filename: str | Path) -> None:
    """Write the compressed ray NPZ, creating its directory."""
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(filename, **{k: data[k] for k in RAY_KEYS})


def load_ray_data(filename: str | Path, use_memmap: bool = False) -> dict[str, np.ndarray]:
    """Read a ray NPZ."""
    data = np.load(filename, mmap_mode="r" if use_memmap else None)
    return {k: data[k] for k in RAY_KEYS}
