"""Volume extraction: checkpoint -> colored 512^3 occupancy volume (counterpart
of ``nerfjax/extract.py:34-570``).

``device`` names where the field, the volumes and every query live. Over
several ranks (``nerfjax_torch.parallel.init_distributed`` first; one
process per card) every rank loads the same parameters, the exact sweep's
x-slabs, the coarse pass's slabs and the fine pass's chunks of marked cells
are split across the ranks in contiguous blocks, and the results are
gathered, so every rank holds the volume, the threshold and the metadata a
world of one computes (every call keeps its shape). Only rank 0 prints and
saves. The field runs through the fused MLP kernels
(``nerfjax_torch.ops.fused_mlp``): on a CUDA device those are the CUDA
kernels, on the CPU their plain PyTorch versions.

Grid coordinates are computed once on the host, so a CPU run and a card run
query the same points: ``np.linspace`` in float32 for the exact sweep and the
coarse pass (nerfjax: ``jnp.linspace``, extract.py:61,75), ``lo + i*step`` in
float32 for the fine pass (extract.py:454,471-473). Both differ from JAX's in
the last bit at some entries (ROADMAP Queue 3).

File contract (unchanged): volume.pth = {occupancy_volume uint8 [R,R,R],
rgb_volume uint8 [R,R,R,3], metadata{resolution, bounds, threshold,
occupied_ratio, total_voxels, occupied_voxels, timestamp, ...}}.
"""

from __future__ import annotations

import itertools
import time
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from nerfjax_torch import checkpoint as ckpt
from nerfjax_torch import tracing
from nerfjax_torch.ops.otsu import otsu_threshold
from nerfjax_torch.train import build_fields

B = 4  # fine voxels per coarse cell per axis
FINE_CHUNK_CELLS = 8192  # marked cells per fine-pass call: 524,288 points
COARSE_SLAB = 8  # x-slices per coarse-pass call
_volume_ids = itertools.count(1)  # the id of each ``extract.volume`` span: the volume's number in this process


def resolve_device(device) -> torch.device:
    """The device to extract on; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain PyTorch versions on the CPU)"
        )
    return dev


class _PhaseClock:
    """Wall seconds per phase on the tracing clock (``time.time_ns``), each
    lap from the end of the one before: "coarse" (the coarse pass and the
    mark), "fine", "otsu", "fetch". Each lap first waits for a CUDA device
    (a ``wait.phase`` span)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.seconds: dict[str, float] = {}
        self._t = time.time_ns()

    def lap(self, name: str) -> None:
        if self.dev.type == "cuda":
            with tracing.span("wait.phase"):
                torch.cuda.synchronize(self.dev)
        now = time.time_ns()
        self.seconds[name] = self.seconds.get(name, 0.0) + (now - self._t) / 1e9
        self._t = now


def _world() -> tuple[int, int]:
    from nerfjax_torch.parallel import rank, world_size

    return rank(), world_size()


def _split(sizes: list[int]) -> tuple[range, list[int]]:
    """This rank's contiguous block of the work items whose row counts are
    ``sizes`` (the items split as evenly as np.array_split splits them),
    and the rows of every rank's block."""
    r, w = _world()
    blocks = [range(k * len(sizes) // w, (k + 1) * len(sizes) // w) for k in range(w)]
    return blocks[r], [sum(sizes[i] for i in b) for b in blocks]


def _gathered(local: torch.Tensor, counts: list[int]) -> torch.Tensor:
    """Every rank's ``local`` rows (counts[r] of them on rank r), joined in
    rank order along dim 0; ``local`` itself at a world of one."""
    if len(counts) == 1:
        return local
    from nerfjax_torch.parallel import all_gather

    most = max(counts)
    padded = local.new_zeros((most, *local.shape[1:]))
    padded[: local.shape[0]] = local
    parts = all_gather(padded)
    return torch.cat([part[:n] for part, n in zip(parts, counts)])


def _linspace(lo: float, hi: float, res: int, dev) -> torch.Tensor:
    with tracing.span("wait.upload"):
        return torch.from_numpy(np.linspace(lo, hi, res, dtype=np.float32)).to(dev)


def _step_coords(lo: float, hi: float, res: int, dev) -> torch.Tensor:
    step = np.float32((hi - lo) / (res - 1))
    c = np.float32(lo) + np.arange(res, dtype=np.float32) * step
    with tracing.span("wait.upload"):
        return torch.from_numpy(c).to(dev)


def _slab_points(xs: torch.Tensor, coords: torch.Tensor):
    """x-major grid points of the slices ``xs`` -> (px, py, pz), each [nz*R*R]
    (meshgrid "ij" over (x, y, z): x is the slowest axis)."""
    nz, r = xs.shape[0], coords.shape[0]
    px = xs[:, None, None].expand(nz, r, r).reshape(-1)
    py = coords[None, :, None].expand(nz, r, r).reshape(-1)
    pz = coords[None, None, :].expand(nz, r, r).reshape(-1)
    return px, py, pz


def _view3(view, like: torch.Tensor):
    return tuple(torch.full_like(like, v) for v in view)


def _to_u8(rgb: torch.Tensor) -> torch.Tensor:
    """[3, N] in [0, 1] -> [N, 3] uint8 (round half to even, as jnp.round)."""
    return torch.round(rgb.to(torch.float32) * 255.0).clamp(0, 255).to(torch.uint8).T


def _dilate_mask(mask: np.ndarray) -> np.ndarray:
    """3^3 binary max-filter (one-cell dilation)."""
    out = mask.copy()
    p = np.pad(mask, 1)
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                out |= p[dx : dx + mask.shape[0], dy : dy + mask.shape[1], dz : dz + mask.shape[2]]
    return out


def _packbits(occ_flat: torch.Tensor) -> torch.Tensor:
    """np.packbits on the device: uint8 0/1 [T] -> [ceil(T/8)], MSB first."""
    pad = (-occ_flat.numel()) % 8
    if pad:
        occ_flat = torch.cat([occ_flat, occ_flat.new_zeros(pad)])
    with tracing.span("wait.upload"):
        weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=occ_flat.device)
    return (occ_flat.reshape(-1, 8) * weights).sum(1).to(torch.uint8)


def _fetch_volumes(occupancy_dev: torch.Tensor, rgb_dev: torch.Tensor, res: int, sparse: bool):
    """Bring the finished uint8 volumes to the host (nerfjax extract.py:248-301).

    Returns (occupancy [R,R,R], rgb [R,R,R,3], sparse_used, rgb_global_max).
    rgb_global_max is the max over the whole device RGB volume, taken before
    compaction (post_process_vol divides by it). sparse=True fetches the
    occupancy bit-packed and the RGB of occupied voxels only; unoccupied RGB
    comes back as zeros. It falls back to the dense fetch when the sparse one
    would move more bytes (K*7 >= 4*R^3, K the occupied count rounded up to a
    power of two >= 4096, as nerfjax pads it), and reports that as
    sparse_used=False.
    """
    occ_flat = occupancy_dev.reshape(-1)
    rgb_flat = rgb_dev.reshape(-1, 3)
    with tracing.span("wait.fetch_copy"):
        rgb_global_max = float(rgb_dev.max())
    total = res**3
    if sparse:
        packed = _packbits(occ_flat)
        with tracing.span("wait.fetch_copy"):
            packed = packed.cpu().numpy()
        with tracing.span("extract.fetch.unpack"):
            occ_host = np.unpackbits(packed)[:total]
            count = int(occ_host.sum())
        K = 1 << max(12, (max(count, 1) - 1).bit_length())
        if K * 7 < total * 4:
            with tracing.span("wait.fetch_copy"):
                idx = torch.nonzero(occ_flat).squeeze(1)  # ascending, as np.flatnonzero
                rgb_occupied = rgb_flat[idx].cpu().numpy()
            with tracing.span("extract.fetch.unpack"):
                occupied = np.flatnonzero(occ_host)
                occupancy = occ_host.reshape(res, res, res).astype(np.uint8)
            with tracing.span("extract.fetch.scatter"):
                rgb_host = np.zeros((total, 3), np.uint8)
                rgb_host[occupied] = rgb_occupied
            return occupancy, rgb_host.reshape(res, res, res, 3), True, rgb_global_max
    with tracing.span("wait.fetch_copy"):
        occupancy = occupancy_dev.cpu().numpy().reshape(res, res, res)
        rgb = rgb_dev.cpu().numpy().reshape(res, res, res, 3)
    return occupancy, rgb, False, rgb_global_max


def _finish(sigma_vol, rgb_vol, res, sparse_fetch, clock, verbose, queries):
    """Otsu on the full-resolution sigma volume, occupancy, fetch, metadata."""
    with tracing.span("extract.otsu"):
        sigma_flat = sigma_vol.reshape(-1)
        threshold_dev = otsu_threshold(sigma_flat)
        occupancy_dev = (sigma_flat > threshold_dev).to(torch.uint8)
        with tracing.span("wait.stats"):
            stats = {
                "min": float(sigma_flat.min()),
                "max": float(sigma_flat.max()),
                "mean": float(sigma_flat.mean()),
                "std": float(sigma_flat.std(correction=0)),
            }
            threshold = float(threshold_dev)
        clock.lap("otsu")
    with tracing.span("extract.fetch"):
        occupancy, rgb_out, sparse_used, rgb_global_max = _fetch_volumes(
            occupancy_dev, rgb_vol, res, sparse_fetch
        )
        clock.lap("fetch")
    with tracing.span("extract.count"):
        occupied = int(occupancy.sum())
    total = res**3
    s = clock.seconds
    query_time = s.get("coarse", 0.0) + s.get("fine", 0.0) + s["otsu"]
    if verbose:
        print(f"Otsu threshold: {threshold:.6f}")
        print(f"Occupied voxels: {occupied / total:.1%} ({occupied:,}/{total:,})")
        print(
            f"Query time: {query_time:.1f}s ({queries:,} queries, "
            f"+{s['fetch']:.1f}s host transfer)"
        )
    metadata = {
        "threshold": threshold,
        "occupied_ratio": occupied / total,
        "total_voxels": total,
        "occupied_voxels": occupied,
        "density_stats": stats,
        "query_seconds": query_time,
        "transfer_seconds": s["fetch"],
        "phase_seconds": dict(s),
        "sparse_fetch": bool(sparse_used),
        "rgb_global_max": rgb_global_max,
    }
    return occupancy, rgb_out, metadata


@torch.inference_mode()
def extract_volume(
    cfg: Mapping,
    *,
    params: dict | None = None,
    resolution: int | None = None,
    bounds: tuple[float, float] = (-1.0, 1.0),
    view_direction=(0.0, 0.0, -1.0),
    slab: int = 8,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
    verbose: bool = True,
    hierarchical: bool | None = None,
    sparse_fetch: bool | None = None,
    coarse_density_only: bool | None = None,
    coarse_supersample: int | None = None,
) -> dict:
    """Full extraction: checkpoint -> colored occupancy volume dict.

    cfg: any mapping with ``.get`` (a dict or the port's ``ConfigNode``).
    params: {"model": param dict of tensors} (``checkpoint.load_field_params``
    or ``params_from_jax``); loaded from ``cfg["checkpoint"]`` when None.

    hierarchical (default for resolutions >= 128 divisible by 4): a coarse
    density pass marks 4^3 cells (Otsu on the cell maxima, margin 0.25x the
    threshold, 3^3 dilation) and only marked cells are queried at full
    resolution. hierarchical=False is the exhaustive sweep. sparse_fetch
    (default: on for hierarchical) fetches the occupancy bit-packed and the
    RGB of occupied voxels only. coarse_density_only (default: follows
    sparse_fetch) runs the mark pass through the density-only kernel;
    coarse_supersample (1 or 2; default 1 under sparse_fetch, else 2) sets
    the coarse subsamples per cell per axis.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    verbose = verbose and _world()[0] == 0
    res = int(resolution or cfg.get("volume_resolution", 512))
    with tracing.unit("extract.volume", next(_volume_ids)):
        with tracing.span("extract.build"):
            _, field, _ = build_fields(cfg, device=dev)
            if params is None:
                params = ckpt.load_field_params(cfg["checkpoint"], cfg, which="fine")
            field.load_params(params["model"] if "model" in params else params["fine"])

        view = np.asarray(view_direction, np.float32)
        view = tuple(float(v) for v in view / np.linalg.norm(view))

        if hierarchical is None:
            hierarchical = res >= 128 and res % 4 == 0
        if sparse_fetch is None:
            sparse_fetch = hierarchical
        clock = _PhaseClock(dev)
        if hierarchical:
            sigma_vol, rgb_vol, queries, extra = _query_hierarchical(
                field, res, bounds, view, dev, dtype, verbose, sparse_fetch,
                coarse_density_only, coarse_supersample, clock,
            )
        else:
            with tracing.span("extract.fine"):
                sigma_vol, rgb_vol, queries = _query_exact(field, res, bounds, view, slab, dev, dtype)
                clock.lap("fine")
            extra = {}
        occupancy, rgb_out, metadata = _finish(
            sigma_vol, rgb_vol, res, sparse_fetch, clock, verbose, queries
        )
        return {
            "occupancy_volume": occupancy,
            "rgb_volume": rgb_out,
            "metadata": {
                "resolution": res,
                "bounds": [float(bounds[0]), float(bounds[1])],
                **metadata,
                "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
                "checkpoint_path": str(cfg.get("checkpoint", "")),
                "view_direction": list(view),
                "device": str(dev),
                **extra,
            },
        }


def _query_exact(field, res, bounds, view, slab, dev, dtype):
    """Exhaustive sweep in x-slabs -> (sigma [R,R,R] f32, rgb [R,R,R,3] u8, queries)."""
    coords = _linspace(bounds[0], bounds[1], res, dev)
    starts = list(range(0, res, slab))
    mine, counts = _split([min(res, x0 + slab) - x0 for x0 in starts])
    first = starts[mine[0]] if mine else 0
    rows = counts[_world()[0]]
    sigma_vol = torch.empty(rows, res, res, dtype=torch.float32, device=dev)
    rgb_vol = torch.empty(rows, res, res, 3, dtype=torch.uint8, device=dev)
    for i in mine:
        x0, x1 = starts[i], min(res, starts[i] + slab)
        pos3 = _slab_points(coords[x0:x1], coords)
        rgb, sigma = field.apply_planar_fused(pos3, _view3(view, pos3[0]), dtype=dtype)
        sigma_vol[x0 - first : x1 - first] = sigma.to(torch.float32).reshape(x1 - x0, res, res)
        rgb_vol[x0 - first : x1 - first] = _to_u8(rgb).reshape(x1 - x0, res, res, 3)
    return _gathered(sigma_vol, counts), _gathered(rgb_vol, counts), res**3


def _query_hierarchical(
    field, res, bounds, view, dev, dtype, verbose, sparse_fetch,
    coarse_density_only, coarse_supersample, clock,
):
    """Coarse mark pass, then the fine pass over marked cells.

    Returns (sigma [R,R,R] f32, rgb [R,R,R,3] u8, queries, metadata extras).
    Voxels of unmarked cells keep their cell's coarse sigma (and coarse RGB,
    or zeros after a density-only mark pass).
    """
    if res % B:
        raise ValueError(f"hierarchical extraction needs a resolution divisible by {B}, got {res}")
    C = res // B
    ss = int(coarse_supersample if coarse_supersample is not None else (1 if sparse_fetch else 2))
    if ss not in (1, 2):
        raise ValueError(f"coarse_supersample must be 1 or 2, got {ss}")
    if coarse_density_only is None:
        coarse_density_only = sparse_fetch
    res2 = ss * C
    lo, hi = bounds

    # -- coarse pass ------------------------------------------------------
    with tracing.span("extract.coarse"):
        coords2 = _linspace(lo, hi, res2, dev)
        starts = list(range(0, res2, COARSE_SLAB))
        mine, counts = _split([min(res2, x0 + COARSE_SLAB) - x0 for x0 in starts])
        first, rows = (starts[mine[0]] if mine else 0), counts[_world()[0]]
        sig2 = torch.empty(rows, res2, res2, dtype=torch.float32, device=dev)
        rgb2 = None if coarse_density_only else torch.empty(rows, res2, res2, 3, dtype=torch.float32, device=dev)
        for i in mine:
            x0, x1 = starts[i], min(res2, starts[i] + COARSE_SLAB)
            pos3 = _slab_points(coords2[x0:x1], coords2)
            if coarse_density_only:
                sigma = field.query_density_planar_fused(pos3, dtype=dtype)
            else:
                rgb, sigma = field.apply_planar_fused(pos3, _view3(view, pos3[0]), dtype=dtype)
                rgb2[x0 - first : x1 - first] = rgb.to(torch.float32).T.reshape(x1 - x0, res2, res2, 3)
            sig2[x0 - first : x1 - first] = sigma.to(torch.float32).reshape(x1 - x0, res2, res2)
        sig2 = _gathered(sig2, counts)
        rgb2 = None if rgb2 is None else _gathered(rgb2, counts)

        cell_sigma = sig2 if ss == 1 else sig2.reshape(C, ss, C, ss, C, ss).amax(dim=(1, 3, 5))

        def rep(a):
            return a.repeat_interleave(B, 0).repeat_interleave(B, 1).repeat_interleave(B, 2)

        sigma_vol = rep(cell_sigma)
        if rgb2 is None:
            rgb_vol = torch.zeros(res, res, res, 3, dtype=torch.uint8, device=dev)
        else:
            cell_rgb = rgb2[::ss, ::ss, ::ss]
            rgb_vol = torch.round(rep(cell_rgb) * 255.0).clamp(0, 255).to(torch.uint8)

    # -- the mark: Otsu on the cells, dilated, the marked cells on the device
    with tracing.span("extract.mark"):
        coarse_thresh_dev = otsu_threshold(cell_sigma)
        with tracing.span("wait.mark_to_host"):
            coarse_thresh = float(coarse_thresh_dev)
            cell_sigma_host = cell_sigma.cpu().numpy()
        margin = 0.25 * coarse_thresh
        marked = _dilate_mask(cell_sigma_host > margin)
        n_marked = int(marked.sum())
        if verbose:
            print(
                f"Hierarchical extraction: {n_marked}/{C**3} cells marked "
                f"({n_marked / C**3:.1%}), coarse otsu {coarse_thresh:.4f}"
            )
        # Cells come from argwhere on the [C,C,C] mask, so every voxel index is
        # in range and unique within a call; the last call is simply shorter
        # (nerfjax pads it with copies of its first cell to keep one jit shape).
        cells = torch.from_numpy(np.argwhere(marked))  # [M, 3] int64
        with tracing.span("wait.upload"):
            cells = cells.to(dev)
        clock.lap("coarse")

    # -- fine pass over marked cells --------------------------------------
    with tracing.span("extract.fine"):
        _fine_pass(field, cells, sigma_vol, rgb_vol, res, lo, hi, view, dev, dtype)
        clock.lap("fine")

    extra = {
        "hierarchical": True,
        "marked_cells": n_marked,
        "coarse_density_only": bool(coarse_density_only),
        "coarse_supersample": ss,
    }
    return sigma_vol, rgb_vol, n_marked * B**3 + res2**3, extra


def _fine_pass(field, cells, sigma_vol, rgb_vol, res, lo, hi, view, dev, dtype) -> None:
    """The field at every voxel of the marked ``cells`` [M, 3], written into
    ``sigma_vol`` and ``rgb_vol`` in place (gathered over the ranks)."""
    coords = _step_coords(lo, hi, res, dev)
    ar = torch.arange(B, device=dev)
    off = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1).reshape(-1, 3)  # [64, 3]
    sigma_flat = sigma_vol.reshape(-1)
    rgb_flat = rgb_vol.reshape(-1, 3)
    chunk_cells = FINE_CHUNK_CELLS
    starts = list(range(0, len(cells), chunk_cells))

    def voxels(i):
        chunk = cells[starts[i] : starts[i] + chunk_cells]
        xi = (chunk[:, 0:1] * B + off[None, :, 0]).reshape(-1)
        yi = (chunk[:, 1:2] * B + off[None, :, 1]).reshape(-1)
        zi = (chunk[:, 2:3] * B + off[None, :, 2]).reshape(-1)
        return xi, yi, zi

    alone = _world()[1] == 1
    mine, counts = _split([B**3 * min(chunk_cells, len(cells) - start) for start in starts])
    sig_parts, rgb_parts = [], []
    for i in mine:
        xi, yi, zi = voxels(i)
        pos3 = (coords[xi], coords[yi], coords[zi])
        rgb, sigma = field.apply_planar_fused(pos3, _view3(view, pos3[0]), dtype=dtype)
        if alone:  # straight into the volumes
            flat = (xi * res + yi) * res + zi
            sigma_flat[flat] = sigma.to(torch.float32)
            rgb_flat[flat] = _to_u8(rgb)
        else:
            sig_parts.append(sigma.to(torch.float32))
            rgb_parts.append(_to_u8(rgb))
    if not alone and starts:
        sigma_all = _gathered(torch.cat(sig_parts) if sig_parts else sigma_flat.new_zeros(0), counts)
        rgb_all = _gathered(torch.cat(rgb_parts) if rgb_parts else rgb_flat.new_zeros(0, 3), counts)
        flat = torch.cat([(xi * res + yi) * res + zi for xi, yi, zi in map(voxels, range(len(starts)))])
        sigma_flat[flat] = sigma_all
        rgb_flat[flat] = rgb_all


def save_volume(volume: dict, output_path: str | Path) -> None:
    """Write volume.pth with torch.save (nerfjax's ``pth.load`` reads it:
    same contract)."""
    output_path = Path(output_path)
    if output_path.suffix.lower() != ".pth":
        raise ValueError(f"Unsupported output format: {output_path.suffix}")
    ckpt.save_pth(
        {
            "occupancy_volume": np.asarray(volume["occupancy_volume"], np.uint8),
            "rgb_volume": np.asarray(volume["rgb_volume"], np.uint8),
            "metadata": volume["metadata"],
        },
        output_path,
    )
    print(f"Saved colored occupancy volume with metadata: {output_path}")


def load_volume(path: str | Path) -> dict:
    """Read a volume.pth (nerfjax extract.py:573) into numpy arrays and dicts."""
    return ckpt.load_pth(path)
