"""The ray NPZ (counterpart of ``nerfjax/rays.py:158-177``): five float32
arrays ``rays_o`` [N, 3], ``rays_d`` [N, 3], ``rgbs`` [N, 3], ``t_near`` [N]
and ``t_far`` [N]. Ray precompute from posed images is ROADMAP Queue 1 item
'ray precompute'."""

from __future__ import annotations

from pathlib import Path

import numpy as np

RAY_KEYS = ("rays_o", "rays_d", "rgbs", "t_near", "t_far")


def save_ray_data(data: dict[str, np.ndarray], filename: str | Path) -> None:
    """Write the compressed ray NPZ, creating its directory."""
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(filename, **{k: data[k] for k in RAY_KEYS})


def load_ray_data(filename: str | Path, use_memmap: bool = False) -> dict[str, np.ndarray]:
    """Read a ray NPZ."""
    data = np.load(filename, mmap_mode="r" if use_memmap else None)
    return {k: data[k] for k in RAY_KEYS}
