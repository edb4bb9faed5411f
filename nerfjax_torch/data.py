"""Host-side ray batches (counterpart of ``nerfjax/data.py:20-159``).

The whole NPZ sits in host memory; an epoch is a permutation of the rays
from ``np.random.default_rng(seed)``, as nerfjax draws it, cut into full
batches, so the port's batches equal nerfjax's for the same seed. The
training loop feeds them through ``prefetch_to_device``: ``depth`` batches
in flight, each copied from pinned host buffers on a copy stream.
``batch_to_device`` is a plain copy. One card, no mesh.
"""

from __future__ import annotations

import collections
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


def prefetch_to_device(iterator: Iterator[dict[str, np.ndarray]], device, depth: int = 2
                       ) -> Iterator[dict[str, torch.Tensor]]:
    """The batches of ``iterator``, in order and unchanged, on ``device``,
    with ``depth`` batches in flight (nerfjax ``prefetch_to_device``).

    On a card each batch is copied into pinned host buffers and from there
    with ``non_blocking=True`` on a copy stream, so the copy overlaps the
    steps before it; the consumer's stream waits on the copy's event before
    the batch is yielded, and each tensor is marked as used by that stream
    (``record_stream``), so its memory is not reused while the step reads
    it. The ``depth`` sets of pinned buffers are used in turn, and one is
    refilled only after the copy out of it has ended (its event). On the
    CPU the batches are yielded as ``batch_to_device`` gives them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        for batch in iterator:
            yield batch_to_device(batch, dev)
        return
    copy_stream = torch.cuda.Stream(dev)
    pinned: list[dict[str, torch.Tensor]] = [{} for _ in range(depth)]
    copied: list[torch.cuda.Event | None] = [None] * depth
    queue: collections.deque = collections.deque()
    for i, batch in enumerate(iterator):
        slot = i % depth
        if copied[slot] is not None:
            copied[slot].synchronize()  # the copy out of this slot's buffers has ended
        host = pinned[slot]
        for k, v in batch.items():
            src = torch.from_numpy(v)
            if k not in host or host[k].shape != src.shape or host[k].dtype != src.dtype:
                host[k] = torch.empty_like(src, pin_memory=True)
            host[k].copy_(src)
        with torch.cuda.stream(copy_stream):
            on_dev = {k: host[k].to(dev, non_blocking=True) for k in batch}
            copied[slot] = torch.cuda.Event()
            copied[slot].record(copy_stream)
        queue.append((on_dev, copied[slot]))
        if len(queue) >= depth:
            yield _handed_over(*queue.popleft(), dev)
    while queue:
        yield _handed_over(*queue.popleft(), dev)


def _handed_over(batch: dict[str, torch.Tensor], copied, dev) -> dict[str, torch.Tensor]:
    """The batch made safe to read on the current stream: that stream waits
    on the copy's event, and each tensor is marked as used by it."""
    stream = torch.cuda.current_stream(dev)
    stream.wait_event(copied)
    for t in batch.values():
        t.record_stream(stream)
    return batch
