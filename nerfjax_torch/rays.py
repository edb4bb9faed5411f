"""Rays (counterpart of ``nerfjax/rays.py``): pinhole rays for every pixel
(``get_rays`` :56-98), their slab intersection with the [-1, 1]^3 cube
(``ray_cube_intersection`` :24-53), the ray precompute from posed images
(``precompute_rays_for_scene`` :101-156) and the ray NPZ (:158-177): five
float32 arrays ``rays_o`` [N, 3], ``rays_d`` [N, 3], ``rgbs`` [N, 3],
``t_near`` [N] and ``t_far`` [N].

Everything is float32 on the device of the poses, so a frame's rays come out
where the field that renders them lives. The card and the CPU give the
same bits: K's inverse is taken on the host, the dot products are a chain
of fused multiply-adds formed exactly, and every float32 division and
square root is formed in float64 and rounded once, which is the correctly
rounded float32 result on any device.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from nerfjax_torch import tracing

RAY_KEYS = ("rays_o", "rays_d", "rgbs", "t_near", "t_far")


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b in float32, correctly rounded on every device (formed in
    float64, rounded once: float64 holds more than twice float32's bits)."""
    return (a.double() / torch.as_tensor(b, dtype=torch.float64, device=a.device)).float()


def ray_cube_intersection(rays_o: torch.Tensor, rays_d: torch.Tensor, cube_min: float = -1.0,
                          cube_max: float = 1.0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab intersection of rays [N, 3] with the axis-aligned cube ->
    (intersects [N] bool, t_near [N], t_far [N]); direction components below
    1e-8 in magnitude are pinned to +-1e-8 (+1e-8 for an exact zero), and
    t_near is clamped to >= 0, as nerfjax does."""
    eps = 1e-8
    d = torch.where(rays_d.abs() < eps, torch.sign(rays_d) * eps, rays_d)
    d = torch.where(d == 0.0, torch.full_like(d, eps), d)
    t0 = _div(cube_min - rays_o, d)
    t1 = _div(cube_max - rays_o, d)
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = (t_near <= t_far) & (t_far >= 0.0)
    return hit, t_near.clamp_min(0.0), t_far


def _fma_chain(pairs) -> torch.Tensor:
    """sum_j a_j*b_j over float32 pairs (a_j, b_j) as a chain of fused
    multiply-adds in j order (what the CPU's matmul and XLA's dot compute):
    each step a_j*b_j + acc is formed in float64, where the product is
    exact, and rounded once to float32, so the card and the CPU give the
    same bits."""
    acc = None
    for a, b in pairs:
        p = a.double() * b.double()
        acc = (p if acc is None else p + acc.double()).float()
    return acc


def _dot3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a @ v for a [..., 3, 3] and v [3, N] float32 -> [..., 3, N] (_fma_chain)."""
    return _fma_chain((a[..., :, j, None], v[j]) for j in range(3))


def get_rays(H: int, W: int, K, c2w, opencv_to_opengl: bool = True,
             normalize: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Pinhole rays of every pixel of every camera -> (rays_o, rays_d)
    [M, H, W, 3] float32, from the intrinsics K [3, 3] and the
    camera-to-world poses c2w [M, 4, 4] (on c2w's device). The pixel grid is
    ``meshgrid`` in ``xy`` order (u along W); the flip diag(1, -1, -1) turns
    OpenCV pixel rays into the OpenGL/NeRF convention."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    dev = c2w.device
    K_inv = torch.linalg.inv(torch.as_tensor(K, dtype=torch.float32).cpu())
    with tracing.span("wait.upload"):
        K_inv = K_inv.to(dev)
        flip = torch.tensor([1.0, -1.0, -1.0], device=dev)
    u = torch.arange(W, dtype=torch.float32, device=dev)
    v = torch.arange(H, dtype=torch.float32, device=dev)
    uu, vv = torch.meshgrid(u, v, indexing="xy")  # [H, W] each
    pix = torch.stack([uu.reshape(-1), vv.reshape(-1), torch.ones(H * W, dtype=torch.float32, device=dev)])
    dirs = _dot3(K_inv, pix)  # [3, H*W], camera frame (OpenCV: +z forward)
    if opencv_to_opengl:
        dirs = dirs * flip[:, None]
    if normalize:
        dirs = _div(dirs, _fma_chain((d, d) for d in dirs).double().sqrt().float().clamp_min(1e-8))
    rays_d = _dot3(c2w[:, :3, :3], dirs)  # [M, 3, H*W]
    rays_d = rays_d.transpose(1, 2).reshape(-1, H, W, 3)
    rays_o = c2w[:, None, None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def _load_rgb(path: str) -> np.ndarray:
    """An image as [H, W, 3] float32 in [0, 1] (PIL RGB / 255)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0


def precompute_rays_for_scene(transforms_path: str | Path, image_loader=None, batch_frames: int = 16, *,
                              device="cuda", stats: dict | None = None) -> dict[str, np.ndarray]:
    """Transforms JSON -> the NPZ's five arrays, the rays that hit the
    [-1, 1]^3 cube (nerfjax ``precompute_rays_for_scene``). Reads ``h``,
    ``w``, ``K`` and each frame's ``file_path`` and ``transform_matrix``;
    decodes the images on the host (``image_loader(path)`` -> [H, W, 3]
    float32, by default PIL RGB / 255); for each chunk of ``batch_frames``
    frames makes the rays and intersects them on ``device`` (the card
    unless the caller asks for the CPU; a missing card raises), keeps those
    that hit and fetches them to the host once.

    stats: an optional dict that receives the stages' seconds, "decode",
    "rays" (the rays and their intersection: CUDA events on the card),
    "compact_fetch" (the kept rays gathered and fetched), and the rays
    "generated" and "kept"."""
    from nerfjax_torch.extract import resolve_device

    dev = resolve_device(device)
    meta = json.loads(Path(transforms_path).read_text())
    H, W = int(meta["h"]), int(meta["w"])
    K = np.array(meta["K"], dtype=np.float32)
    image_loader = image_loader or _load_rgb
    frames = meta["frames"]
    times = {"decode": 0.0, "rays": 0.0, "compact_fetch": 0.0}
    events = []
    out = {k: [] for k in RAY_KEYS}
    for start in range(0, len(frames), batch_frames):
        chunk = frames[start : start + batch_frames]
        t0 = time.perf_counter()
        rgb = np.stack([image_loader(f["file_path"]) for f in chunk]).reshape(-1, 3).astype(np.float32)
        times["decode"] += time.perf_counter() - t0
        poses = torch.from_numpy(np.array([f["transform_matrix"] for f in chunk], dtype=np.float32)).to(dev)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        rays_o, rays_d = get_rays(H, W, K, poses)
        ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        hit, t_near, t_far = ray_cube_intersection(ro, rd)
        if dev.type == "cuda":
            events[-1][1].record()
        else:
            times["rays"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = torch.cat([ro, rd, t_near[:, None], t_far[:, None]], dim=1)[hit]
        mask = hit.cpu().numpy()
        rows = rows.cpu().numpy()
        times["compact_fetch"] += time.perf_counter() - t0
        for key, part in (("rays_o", rows[:, 0:3]), ("rays_d", rows[:, 3:6]), ("rgbs", rgb[mask]),
                          ("t_near", rows[:, 6]), ("t_far", rows[:, 7])):
            out[key].append(part)
    times["rays"] += sum(a.elapsed_time(b) for a, b in events) / 1e3
    data = {k: np.ascontiguousarray(np.concatenate(v), dtype=np.float32) for k, v in out.items()}
    if stats is not None:
        stats.update(times, generated=len(frames) * H * W, kept=len(data["rays_o"]))
    return data


def save_ray_data(data: dict[str, np.ndarray], filename: str | Path) -> None:
    """Write the compressed ray NPZ, creating its directory."""
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(filename, **{k: data[k] for k in RAY_KEYS})


def load_ray_data(filename: str | Path, use_memmap: bool = False) -> dict[str, np.ndarray]:
    """Read a ray NPZ."""
    data = np.load(filename, mmap_mode="r" if use_memmap else None)
    return {k: data[k] for k in RAY_KEYS}
