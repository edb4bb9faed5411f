"""Host-side ray batches (counterpart of ``nerfjax/data.py:20-140``).

The whole NPZ sits in host memory; an epoch is a permutation of the rays
from ``np.random.default_rng(seed)``, as nerfjax draws it, cut into full
batches, so the port's batches equal nerfjax's for the same seed. A batch
goes to the card with ``batch_to_device``, a plain copy: one card, no mesh.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from nerfjax_torch.rays import load_ray_data


class RayDataset:
    """In-memory (or memmapped) ray dataset over the precomputed NPZ."""

    def __init__(self, data_path: str | Path, use_memmap: bool = False, verbose: bool = True):
        self.data_path = Path(data_path)
        if not self.data_path.exists():
            raise FileNotFoundError(f"Data file not found: {self.data_path}")
        if verbose:
            print(f"Loading ray from: {self.data_path}")
        d = load_ray_data(self.data_path, use_memmap=use_memmap)
        self.rays_o, self.rays_d, self.rgbs = d["rays_o"], d["rays_d"], d["rgbs"]
        self.t_near, self.t_far = d["t_near"], d["t_far"]
        self.num_rays = len(self.rays_o)
        if verbose:
            print(f"Loaded {self.num_rays} rays")
            print(f"t_near range: [{float(np.min(self.t_near)):.3f}, {float(np.max(self.t_near)):.3f}]")
            print(f"t_far range: [{float(np.min(self.t_far)):.3f}, {float(np.max(self.t_far)):.3f}]")

    def __len__(self) -> int:
        return self.num_rays

    def epoch_batches(self, batch_size: int, seed: int, drop_last: bool = True) -> Iterator[dict[str, np.ndarray]]:
        """Shuffled full-epoch batches: {rays_o, rays_d, rgb, t_near, t_far}."""
        perm = np.random.default_rng(seed).permutation(self.num_rays)
        end = (self.num_rays // batch_size) * batch_size if drop_last else self.num_rays
        for start in range(0, end, batch_size):
            idx = perm[start : start + batch_size]
            yield {
                "rays_o": np.ascontiguousarray(self.rays_o[idx]),
                "rays_d": np.ascontiguousarray(self.rays_d[idx]),
                "rgb": np.ascontiguousarray(self.rgbs[idx]),
                "t_near": np.ascontiguousarray(self.t_near[idx]),
                "t_far": np.ascontiguousarray(self.t_far[idx]),
            }

    def steps_per_epoch(self, batch_size: int, drop_last: bool = True) -> int:
        return self.num_rays // batch_size if drop_last else -(-self.num_rays // batch_size)


def batch_to_device(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in batch.items()}
